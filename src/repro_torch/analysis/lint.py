"""Trace-invariant lint suite: static checks of the port's traced programs
(the port of ``repro/analysis/lint.py``).

The port's performance story rests on structural properties of the round
body that no output test sees:

* **width** — the deployable round body aggregates at cohort width: no
  floating intermediate scales as O(N*D) (client count x parameter
  dimension).  (N,)-vectors (probabilities, feedback, weights) and integer
  index material may be client-sized.
* **scan-safety** — each registry ``Sampler``'s ``probabilities`` /
  ``sample_from`` / ``update`` trace on fake tensors: no host sync
  (``.item()``, ``bool(tensor)``, ``.tolist()``: one device-to-host round
  trip a round), no data-dependent shape, and ``update`` keeps every state
  leaf's shape, dtype and device (the segment carry).
* **dtype** — no float64/complex128 anywhere in the traced graph but the
  two sites that take one by design (``F64_SITES``).
* **compile-once** — the port has no jit: the segment runner is built once
  a run and once a resume, and the numpy round trip a checkpoint applies
  leaves every carry leaf's shape, dtype and device unchanged.

The reference walks jaxprs.  The port reads an ATen graph instead:
``trace`` runs a function under ``torch.fx.experimental.proxy_tensor.
make_fx`` on fake CPU tensors of its arguments' shapes and dtypes
(``meta`` or real ones), recording every ATen call with its output's fake
value (shape, dtype) and the Python source line that made it.  What that
graph cannot see:

* the CUDA kernels: on fake CPU tensors every kernel wrapper takes its plain
  PyTorch version (``kernels/ref.py``), whose shapes and dtypes are the
  kernel's; a kernel's internal scratch (kernel 5's f64 prefixes, kernels
  2-5's partial rows and ticket counters) is outside the graph;
* host work between rounds (the segment loop, checkpoint I/O) and the
  kernels' backwards' own temporaries are in it only as far as they run
  ATen ops inside the traced call;
* values: a graph that traces can still be wrong.  The parity tests hold
  those.

Entry points: ``run_suite(spec)`` lints one ``repro_torch.api``
``ExperimentSpec``; ``sweep_registry()`` every registry sampler x
oracle/deployable x compiled/reference (and the sharded, faulted and
compressed cells) plus the serving decode step; ``python -m
repro_torch.analysis.lint`` is the CLI (exit 1 on any finding).  The
auditors are functions of a traced graph, so tests feed them programs with
a planted defect and pin the one finding each gives.  ``audit_width_hlo``
and ``hlo=True`` are XLA's (the compiled HLO); the port has no counterpart.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import re
import sys
import traceback
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

__all__ = [
    "Finding",
    "LintReport",
    "F64_SITES",
    "trace",
    "iter_nodes",
    "audit_width",
    "audit_replicated_clients",
    "audit_scan_safety",
    "audit_dtypes",
    "audit_compile_once",
    "run_suite",
    "sweep_registry",
    "main",
]

_WIDE_DTYPES = (torch.float64, torch.complex128)

# The float64 sites the port takes by design (ROADMAP.md section 3,
# "Differences by design"), by function name: a 64-bit value introduced
# anywhere else is a finding of ``audit_dtypes``.
F64_SITES = {
    "_rsp_wr_draw": (
        "core/samplers.py: the RSP draw with replacement takes its prefix sums in "
        "f64, rounded to f32, so the card and the CPU search the same values"
    ),
    "_cluster_mean_stats": (
        "core/samplers.py: ClusteredKVib's cluster means sum each cluster's scores "
        "in f64 (prefix differences), so no cluster loses the small ones"
    ),
}

# The op that reads a tensor's value to the host (``.item()``, ``bool``).
_HOST_SYNC_OP = "_local_scalar_dense"
# Ops whose output shape depends on the data.
_DYNAMIC_SHAPE_OPS = ("nonzero", "unique", "masked_select", "_unique2", "unique_consecutive")


# ---------------------------------------------------------------------------
# Findings and reports
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation: which check, where, and the offending op.

    check:      "width" | "replicated_clients" | "scan_safety" | "dtype" |
                "compile_once" | "trace"
    target:     what was linted ("round_body[deployable]", "sampler:kvib.update")
    message:    one sentence stating the defect
    op:         the offending ATen op ("mul"; "" when not op-shaped)
    shape:      the offending value, e.g. "float32[13,60]"
    provenance: the Python source line that made it ("file.py:12 in fn")
    count:      occurrences aggregated into this finding (>= 1)
    """

    check: str
    target: str
    message: str
    op: str = ""
    shape: str = ""
    provenance: str = ""
    count: int = 1

    def render(self) -> str:
        loc = f"  [{self.provenance}]" if self.provenance else ""
        opshape = " ".join(x for x in (self.op, self.shape) if x)
        mult = f" x{self.count}" if self.count > 1 else ""
        head = f"{self.check:<12} {self.target}: "
        return head + (f"{opshape}{mult} — " if opshape else "") + self.message + loc


@dataclasses.dataclass
class LintReport:
    """Findings plus the checks that ran: an empty ``findings`` list
    certifies only the invariants ``checked`` names."""

    findings: list = dataclasses.field(default_factory=list)
    checked: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def add(self, findings: Iterable[Finding], checked: str) -> None:
        self.findings.extend(findings)
        self.checked.append(checked)

    def extend(self, other: "LintReport") -> None:
        self.findings.extend(other.findings)
        self.checked.extend(other.checked)

    def render(self) -> str:
        if self.ok:
            return f"lint clean: {len(self.checked)} checks, no findings"
        lines = [f"lint FAILED: {len(self.findings)} finding(s) across {len(self.checked)} checks"]
        lines += ["  " + f.render() for f in self.findings]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Tracing and graph walking
# ---------------------------------------------------------------------------


def _map_tensors(fn, tree):
    """``tree`` (dicts, lists, tuples, named tuples, dataclasses) with ``fn``
    applied to its tensor leaves."""
    return _map_leaves(lambda x: fn(x) if isinstance(x, torch.Tensor) else x, tree)


def _map_leaves(fn, tree):
    """``tree`` with ``fn`` applied to every leaf, in the checkpointer's
    view of a tree (``checkpoint.checkpointer._children``)."""
    from repro_torch.checkpoint.checkpointer import _children, _is_dataclass, _is_namedtuple

    kids = _children(tree)
    if kids is None:
        return fn(tree)
    values = {k: _map_leaves(fn, v) for k, v in kids[1]}
    if _is_dataclass(tree):
        return dataclasses.replace(tree, **values)
    if isinstance(tree, dict):
        return {k: values[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(**values)
    return type(tree)(values[i] for i in range(len(tree)))


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    # Real tensors a traced function closes over (a dataset) are its data,
    # recorded as constants.
    return FakeTensorMode(allow_non_fake_inputs=True)


def _fakes(mode, tree):
    """``tree`` with every tensor replaced by a fake CPU tensor of its
    shape and dtype (on fake tensors the kernel wrappers take their plain
    versions, as on the CPU)."""
    with mode:
        return _map_tensors(lambda t: torch.empty(t.shape, dtype=t.dtype, device="cpu"), tree)


def trace(fn: Callable, *args) -> torch.fx.GraphModule:
    """``make_fx`` of ``fn(*args)`` on fake CPU tensors of the tensors in
    ``args`` (any device, ``meta`` included; other leaves pass as they
    are), with each node's source line.  Raises what the trace raises."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from torch.fx.proxy import TracerBase

    mode = _fake_mode()
    fake_args = _fakes(mode, args)
    torch_dir = os.path.dirname(torch.__file__)
    keep = TracerBase._filter_traceback_frames

    def frames_outside_torch(self, summary):
        return traceback.StackSummary.from_list(
            [f for f in summary if not f.filename.startswith(torch_dir)])

    # fx keeps a node's stack from the first frame named "forward" (a
    # module's); a function's source lines are the frames outside torch.
    TracerBase._filter_traceback_frames = frames_outside_torch
    try:
        return make_fx(fn, tracing_mode="fake", record_stack_traces=True,
                       _allow_non_fake_inputs=True)(*fake_args)
    finally:
        TracerBase._filter_traceback_frames = keep


def iter_nodes(gm: torch.fx.GraphModule, path: tuple = ()) -> Iterator[tuple]:
    """``(node, path)`` for every ``call_function`` node of ``gm`` and of
    the graph modules it holds (higher-order ops' bodies); ``path`` names
    the enclosing submodules."""
    for node in gm.graph.nodes:
        if node.op == "call_function":
            yield node, path
    for name, sub in gm.named_children():
        if isinstance(sub, torch.fx.GraphModule):
            yield from iter_nodes(sub, path + (name,))


def _data_nodes(gm: torch.fx.GraphModule) -> set:
    """The graph's inputs and constants: data, not intermediates."""
    out = set()
    for g in [gm] + [m for m in gm.modules() if isinstance(m, torch.fx.GraphModule)]:
        out.update(n for n in g.graph.nodes if n.op in ("placeholder", "get_attr"))
    return out


def _values(node) -> list:
    val = node.meta.get("val")
    if isinstance(val, (list, tuple)):
        return [v for v in val if isinstance(v, torch.Tensor)]
    return [val] if isinstance(val, torch.Tensor) else []


def _op_name(node) -> str:
    target = node.target
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(target, "__name__", str(target))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _shape_str(t: torch.Tensor) -> str:
    return f"{_dtype_name(t.dtype)}[{','.join(str(d) for d in t.shape)}]"


_FRAME = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')


def _frames(node) -> list:
    return _FRAME.findall(node.meta.get("stack_trace") or "")


def _provenance(frames) -> str:
    """The innermost frame, ``file.py:line in function``."""
    if not frames:
        return ""
    file, line, fn = frames[-1]
    return f"{os.path.basename(file)}:{line} in {fn}"


def _is_float(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


# ---------------------------------------------------------------------------
# Pass 1: width
# ---------------------------------------------------------------------------


def _offends_width(t, n: int, allow: frozenset) -> bool:
    """An O(N*D) value: a float tensor with an axis of size ``n`` and more
    than one element per client.  (N,)-vectors and integer or boolean
    tensors pass; a shape that is not static offends."""
    if not isinstance(t, torch.Tensor):
        return False
    shape = tuple(t.shape)
    if not shape or shape in allow:
        return False
    if not all(isinstance(d, int) for d in shape):
        return True
    if n not in shape or int(np.prod(shape, dtype=np.int64)) <= n:
        return False
    return _is_float(t)


def _origins(gm, n: int, allow: frozenset) -> dict:
    """(op, shape) -> [count, provenance] of the nodes that introduce an
    offending value: an offending output where no input but the graph's
    data offends (a leaked buffer gives one finding, at its origin)."""
    data = _data_nodes(gm)
    grouped: dict = {}
    for node, _path in iter_nodes(gm):
        if any(i not in data and any(_offends_width(v, n, allow) for v in _values(i))
               for i in node.all_input_nodes):
            continue
        for v in _values(node):
            if _offends_width(v, n, allow):
                key = (_op_name(node), _shape_str(v))
                if key in grouped:
                    grouped[key][0] += 1
                else:
                    grouped[key] = [1, _provenance(_frames(node))]
                break
    return grouped


def audit_width(gm: torch.fx.GraphModule, n: int, *, target: str = "",
                allow: Iterable[tuple] = ()) -> list:
    """No floating intermediate of ``gm`` scales as O(N*D) for client count
    ``n``: one finding per (op, shape) at the op that introduces it
    (``count`` its occurrences).  ``gm`` is ``trace``'s ATen graph of the
    round body, where the reference walks its jaxpr; it cannot see a CUDA
    kernel's own scratch (the kernels' partial rows), only the plain
    versions' tensors, whose shapes are the kernels' inputs and outputs.  The graph's inputs and constants (the
    federated dataset a body closes over) are data, not intermediates: the
    first op that reads them into an N-wide float is the origin.
    ``allow``: exact shapes to permit.  Pick ``n`` distinctive (13 in the
    sweep): the audit cannot tell a client axis from an equal-sized model
    axis."""
    allow = frozenset(tuple(s) for s in allow)
    return [
        Finding(check="width", target=target,
                message=(f"intermediate scales as O(N*D) with N={n} (cohort-width contract: "
                         "only (N,)-vectors may be client-sized)"),
                op=op, shape=shape, provenance=prov, count=count)
        for (op, shape), (count, prov) in _origins(gm, n, allow).items()
    ]


def audit_replicated_clients(gm: torch.fx.GraphModule, n: int, *, target: str = "",
                             check_nd: bool = True, max_unconstrained: int = 80,
                             allow: Iterable[tuple] = ()) -> list:
    """The sharded-sampler contract on one rank's round body (``trace``'s
    ATen graph): nothing replicated scales O(N) a device beyond the
    sampler's (N,)-vectors.

    The port has no ``shard_map`` and no sharding constraints, and the
    lint traces the body of one rank alone (no process group), which holds
    the whole (N,) sampler state (over S > 1 ranks each holds its block,
    ``fed.state.StateLayout``), so every op of the body counts as
    replicated.  Two rules:

    * ``check_nd``: ``audit_width``'s rule, reported as
      ``replicated_clients`` (oracle bodies hold their (N, D) diagnostics
      and pass ``check_nd=False``);
    * the number of ops that make an (N,) float stays at or under
      ``max_unconstrained``.  The count is a property of the program,
      constant in N; the ceiling is a tripwire for a change that starts
      making (N,) temporaries a loop iteration.  The registry sweep's
      bodies make 10 to 55 of them in the ATen graph at N = 13; the
      ceiling is the reference's, 80.
    """
    allow = frozenset(tuple(s) for s in allow)
    findings = []
    if check_nd:
        findings = [
            Finding(check="replicated_clients", target=target,
                    message=(f"replicated O(N*D) float with N={n} (sharded-sampler contract: "
                             "per-client blocks stay (N,)-vectors)"),
                    op=op, shape=shape, provenance=prov, count=count)
            for (op, shape), (count, prov) in _origins(gm, n, allow).items()
        ]
    count, worst = _count_client_vectors(gm, n)
    if count > max_unconstrained:
        top = ", ".join(f"{op} x{c}" for op, c in sorted(worst.items(), key=lambda kv: -kv[1])[:5])
        findings.append(Finding(
            check="replicated_clients", target=target,
            message=(f"{count} ops make a replicated (N,)-float (ceiling {max_unconstrained}; "
                     f"top ops: {top}): the round body is growing per-client material beyond "
                     "the sampler's vectors"),
            op="*", shape=f"float32[{n}]"))
    return findings


def _count_client_vectors(gm: torch.fx.GraphModule, n: int) -> tuple:
    """(number of ops whose output is an (n,) float, per-op counts)."""
    worst: dict = {}
    for node, _path in iter_nodes(gm):
        if any(tuple(v.shape) == (n,) and _is_float(v) for v in _values(node)):
            worst[_op_name(node)] = worst.get(_op_name(node), 0) + 1
    return sum(worst.values()), worst


# ---------------------------------------------------------------------------
# Pass 2: sampler scan-safety
# ---------------------------------------------------------------------------


def _leaf_sigs(tree) -> list:
    """(path, signature) of every leaf: a tensor's (shape, dtype, device),
    any other leaf's type."""
    from repro_torch.checkpoint.checkpointer import _children

    out = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            if isinstance(node, torch.Tensor):
                sig = (tuple(node.shape), _dtype_name(node.dtype), node.device.type)
            else:
                sig = (type(node).__name__,)
            out.append((path or "root", sig))
            return
        for k, v in kids[1]:
            walk(v, f"{path}.{k}" if path else str(k))

    walk(tree, "")
    return out


def _user_frame(exc: BaseException) -> str:
    """The innermost frame of ``exc``'s traceback outside torch."""
    torch_dir = os.path.dirname(torch.__file__)
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if not f.filename.startswith((torch_dir, "<")) and f.filename != __file__]
    if not frames:
        return ""
    f = frames[-1]
    return f"{os.path.basename(f.filename)}:{f.lineno} in {f.name}"


def _trace_failure(exc: BaseException) -> tuple:
    """(op, message) of a trace that raised."""
    from torch._subclasses.fake_tensor import (
        DataDependentOutputException,
        DynamicOutputShapeException,
    )

    text = str(exc).splitlines()[0] if str(exc) else type(exc).__name__
    if isinstance(exc, DataDependentOutputException) or "data-dependent" in text.lower() \
            or _HOST_SYNC_OP in text:
        return _HOST_SYNC_OP, (
            "host sync: a tensor's value read to the host (.item(), bool(tensor), "
            f".tolist(), data-dependent Python control flow): {text}")
    if isinstance(exc, DynamicOutputShapeException):
        return getattr(exc, "func", ""), f"data-dependent shape: {text}"
    return "", f"trace failed: {type(exc).__name__}: {text}"


def audit_scan_safety(sampler, *, target: str = "") -> list:
    """Trace a ``Sampler``'s ``probabilities`` / ``sample_from`` /
    ``update`` with ``trace`` (``make_fx`` where the reference calls
    ``jax.make_jaxpr``) on fake tensors of the state
    ``sampler.init("meta")`` gives (no values, so a Python branch on a
    tensor cannot pass by luck; a CUDA kernel's host work, which the plain
    path on fake CPU tensors does not run, is outside it):

    * a host sync (``.item()``, ``bool(tensor)``, ``.tolist()``: the trace
      raises on it, or ``aten._local_scalar_dense`` in the graph) is a
      finding, at the source line that asked for it;
    * a data-dependent shape (``nonzero``, ``unique``, ``masked_select``)
      is a finding; any other trace failure is one;
    * ``probabilities`` must return one float (n,) tensor;
    * ``update`` must keep the state's structure and every leaf's shape,
      dtype and device (the segment carry: the next round, a checkpoint).
    """
    from repro_torch.core.samplers import draw_input

    name = target or f"sampler:{type(sampler).__name__}"
    n = sampler.n
    mode = _fake_mode()
    state = _fakes(mode, sampler.init("meta"))
    with mode:
        probs = torch.empty(n, dtype=torch.float32)
        u = draw_input(_trace_source(0), sampler.procedure, 0, n, sampler.budget)
        feedback = torch.empty(n, dtype=torch.float32)
        try:
            draw = sampler.sample_from(probs, u)
        except Exception:  # noqa: BLE001 — sample_from's own case reports it
            draw = None
    cases = {
        "probabilities": (sampler.probabilities, (state,)),
        "sample_from": (sampler.sample_from, (probs, u)),
        "update": (sampler.update, (state, draw, feedback)),
    }
    findings: list = []
    for mname, (fn, args) in cases.items():
        mtarget = f"{name}.{mname}"
        if any(a is None for a in args):
            continue
        try:
            gm = trace(lambda *a, fn=fn: fn(*a), *args)
        except Exception as e:  # noqa: BLE001 — a trace failure is the finding
            op, message = _trace_failure(e)
            findings.append(Finding(check="scan_safety", target=mtarget, message=message, op=op,
                                    provenance=_user_frame(e)))
            continue
        for node, _path in iter_nodes(gm):
            op = _op_name(node)
            if op == _HOST_SYNC_OP:
                findings.append(Finding(
                    check="scan_safety", target=mtarget,
                    message="host sync inside a carried method (one device-to-host round trip a "
                            "round)", op=op, provenance=_provenance(_frames(node))))
            elif op in _DYNAMIC_SHAPE_OPS or any(
                    not all(isinstance(d, int) for d in v.shape) for v in _values(node)):
                findings.append(Finding(
                    check="scan_safety", target=mtarget, message="data-dependent shape", op=op,
                    provenance=_provenance(_frames(node))))
        with mode:
            out = fn(*args)
        if mname == "probabilities":
            if not (isinstance(out, torch.Tensor) and tuple(out.shape) == (n,)
                    and out.is_floating_point()):
                got = _shape_str(out) if isinstance(out, torch.Tensor) else type(out).__name__
                findings.append(Finding(
                    check="scan_safety", target=mtarget,
                    message=f"probabilities must return one float (n={n},) tensor, got {got}"))
        if mname == "update":
            before, after = _leaf_sigs(state), _leaf_sigs(out)
            if [p for p, _ in before] != [p for p, _ in after]:
                findings.append(Finding(
                    check="scan_safety", target=mtarget,
                    message="update() changes the state's structure: the carry needs a fixed one"))
            else:
                for (path, a), (_, b) in zip(before, after):
                    if a != b:
                        findings.append(Finding(
                            check="scan_safety", target=mtarget,
                            message=(f"update() drifts state leaf {path}: {a} -> {b}: the carry "
                                     "needs stable (shape, dtype, device)")))
    return findings


# ---------------------------------------------------------------------------
# Pass 3: dtypes
# ---------------------------------------------------------------------------


def audit_dtypes(gm: torch.fx.GraphModule, *, target: str = "",
                 allow_sites: dict | None = None) -> list:
    """No silent 64-bit values in ``gm`` (``trace``'s ATen graph, where the
    reference walks its jaxpr; a kernel's internal f64, kernel 5's prefix
    sums, is outside it): an op that introduces a float64/complex128 (an
    output wide, no input wide) is a finding at that op, once per (op,
    shape), unless a frame of its source is one of ``allow_sites`` (default
    ``F64_SITES``: function name -> the reason).  A 64-bit constant baked
    into the graph is a finding.  Torch has no weak types, the reference's
    other dtype hazard; its nearest (a Python scalar in the carry that a
    numpy round trip turns into a float64 tensor) is
    ``audit_compile_once``'s."""
    allow_sites = F64_SITES if allow_sites is None else allow_sites
    findings: list = []
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            for v in _values(node) or [getattr(gm, str(node.target), None)]:
                if isinstance(v, torch.Tensor) and v.dtype in _WIDE_DTYPES:
                    findings.append(Finding(check="dtype", target=target,
                                            message="a constant bakes 64-bit data into the graph",
                                            shape=_shape_str(v)))
    grouped: dict = {}
    for node, _path in iter_nodes(gm):
        if any(v.dtype in _WIDE_DTYPES for i in node.all_input_nodes for v in _values(i)):
            continue  # propagation: the introduction site is the finding
        wide = [v for v in _values(node) if v.dtype in _WIDE_DTYPES]
        if not wide:
            continue
        frames = _frames(node)
        if any(fn in allow_sites for _, _, fn in frames):
            continue
        key = (_op_name(node), _shape_str(wide[0]))
        if key in grouped:
            grouped[key] = dataclasses.replace(grouped[key], count=grouped[key].count + 1)
        else:
            grouped[key] = Finding(
                check="dtype", target=target,
                message="silent 64-bit promotion (f64/c128 introduced into an f32 graph)",
                op=key[0], shape=key[1], provenance=_provenance(frames))
    findings.extend(grouped.values())
    return findings


# ---------------------------------------------------------------------------
# Pass 4: compile-once (built once; the carry stable under checkpoints)
# ---------------------------------------------------------------------------


def _carry(state) -> dict:
    """The parts of a ``TrainState`` a checkpoint round-trips as arrays
    (``round`` is the step, an int the manifest keeps)."""
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state) if f.name != "round"}


def numpy_round_trip(state, device=None):
    """``state`` through numpy and back, the transport of a checkpoint
    restored without a template (the reference's ``asarray(np.asarray(x))``):
    every leaf to a numpy array (bfloat16 and float8 as raw integers of
    their width, as the checkpointer stores them) and back to a tensor on
    ``device`` (default: the device of the state's first tensor).  A
    Python scalar comes back as a 0-d tensor of numpy's dtype (float64 for
    a float)."""
    from repro_torch.checkpoint.checkpointer import _to_numpy

    if device is None:
        from repro_torch.checkpoint.checkpointer import tree_flatten

        device = next((x.device for x in tree_flatten(state) if isinstance(x, torch.Tensor)), "cpu")

    def leaf(x):
        t = torch.from_numpy(np.array(_to_numpy(x)))
        if isinstance(x, torch.Tensor):
            t = t.view(x.dtype) if t.dtype != x.dtype else t
            return t.to(x.device)
        return t.to(device)

    return _map_leaves(leaf, state)


def audit_compile_once(segment_fn, init_state, n_rounds: int, *, n_segments: int = 2,
                       resume: bool = True, target: str = "") -> list:
    """The segment runner is built once and its carry is stable.

    The port has no jit, so nothing compiles and there is no cache to count;
    this audit reads no graph but runs the segments and compares the carry
    (the kernels' nvcc builds, cached per process, are outside it).  What
    the reference's guard protects is re-expressed as:

    * ``segment_fn`` carries ``make_segment_fn``'s lint handles (``_lint``),
      so it is the one segment function of the run;
    * ``n_segments`` segments of ``n_rounds`` build no other segment
      function (``fed.state.segment_builds`` does not move) and leave every
      carry leaf's shape, dtype and device as the round-0 state has them;
    * ``resume``: the state after them, through a numpy round trip
      (``numpy_round_trip``: what a checkpoint applies), keeps every leaf's
      signature (a Python scalar in the carry comes back a float64
      tensor), and one more segment on it builds nothing and keeps them.

    It runs ``(n_segments + 1) * n_rounds`` real rounds: hand it a reduced
    horizon (``run_suite`` does)."""
    from repro_torch.fed.state import segment_builds

    name = target or "segment_runner"
    findings: list = []
    if getattr(segment_fn, "_lint", None) is None:
        return [Finding(check="compile_once", target=name,
                        message="segment fn carries no lint handles: not built by "
                                "fed.state.make_segment_fn")]
    want = _leaf_sigs(_carry(init_state))

    def drift(state, when: str) -> None:
        got = _leaf_sigs(_carry(state))
        if [p for p, _ in got] != [p for p, _ in want]:
            findings.append(Finding(check="compile_once", target=name,
                                    message=f"{when} changes the carry's structure"))
            return
        for (path, a), (_, b) in zip(want, got):
            if a != b:
                findings.append(Finding(
                    check="compile_once", target=name,
                    message=f"{when} changes carry leaf {path}: {a} -> {b}"))

    builds = segment_builds()
    state = init_state
    for k in range(n_segments):
        state = segment_fn(state, n_rounds)
        drift(state, f"segment {k + 1}")
    if segment_builds() != builds:
        findings.append(Finding(
            check="compile_once", target=name,
            message=(f"{segment_builds() - builds} segment functions built across {n_segments} "
                     f"{n_rounds}-round segments (expected none: one a run)")))
    if resume and not findings:
        restored = numpy_round_trip(state)
        drift(restored, "checkpoint resume (numpy round trip)")
        if not findings:
            builds = segment_builds()
            drift(segment_fn(restored, n_rounds), "the segment after a resume")
            if segment_builds() != builds:
                findings.append(Finding(check="compile_once", target=name,
                                        message="the resumed segment built a segment function"))
    return findings


# ---------------------------------------------------------------------------
# The suite: lint one ExperimentSpec
# ---------------------------------------------------------------------------


def _trace_source(seed: int):
    """The round body's random source for a trace: a CPU ``PhiloxSource``
    whose draws take torch's default generator (``generator=None``).  The
    shapes and dtypes are the source's; a generator argument is what
    ``make_fx`` of some torch versions cannot record, and fake tensors
    refuse one for ``exponential_``."""
    from repro_torch.rng import PhiloxSource

    source = PhiloxSource(seed, "cpu")
    source._gen = {name: None for name in (*source._gen, *PhiloxSource._LATE)}
    return source


def _trace_body(body, carry, t, report: LintReport, target: str):
    """The round body's graph, or None with a ``trace`` finding."""
    try:
        return trace(lambda c: body(t, c), carry)
    except Exception as e:  # noqa: BLE001 — a body that does not trace is a finding
        op, message = _trace_failure(e)
        report.add([Finding(check="trace", target=target, message=message, op=op,
                            provenance=_user_frame(e))], f"trace:{target}")
        return None


def run_suite(spec, *, hlo: bool | None = None, compile_guard: bool | None = None,
              probe_rounds: int = 2) -> LintReport:
    """Lint one ``repro_torch.api.ExperimentSpec``, built on the CPU.

    Passes (each named in ``LintReport.checked``):

    * scan-safety of the spec's sampler (always);
    * dtypes of the traced round body (always);
    * width of the round body where it declares the cohort-width contract:
      deployable simulation bodies (``oracle_metrics=False`` without
      ``exact_oracle_equiv``) and every zoo body (``scan_body_for_lint``);
      oracle bodies hold (N, D) diagnostics by design;
    * replicated clients with a sharded sampler (``execution.sampler_axis``);
    * compile-once on the segment runner: compiled simulation specs by
      default (``compile_guard=False`` skips it), zoo specs only with
      ``compile_guard=True`` (it runs real rounds of the model).

    A round body that does not trace is a ``trace`` finding.  ``hlo=True``
    (the reference's width audit of compiled HLO) raises ``ValueError``:
    the port has no XLA."""
    if hlo:
        raise ValueError(
            "hlo=True audits XLA's compiled HLO (the reference's audit_width_hlo); the port "
            "compiles no HLO, and its width audit reads the traced ATen graph only")
    from repro_torch import api

    built = api.build(spec, "cpu")
    report = LintReport()
    sampler_target = f"sampler:{spec.sampler.name}"
    report.add(audit_scan_safety(built.sampler, target=sampler_target),
               f"scan_safety:{sampler_target}")
    n = built.dataset.n_clients
    sharded = built.sampler.shard is not None
    if built.kind == "task":
        from repro_torch.fed import server as fed_server

        cfg = built.fed_config
        mode = "oracle" if cfg.oracle_metrics else (
            "deployable/scatter" if cfg.exact_oracle_equiv else "deployable")
        body_target = f"round_body[{mode}]"
        body, (carry, t) = fed_server.round_body_for_lint(
            built.task, built.dataset, built.sampler, cfg,
            random_source=_trace_source(cfg.seed))
        width_applies = not cfg.oracle_metrics and not cfg.exact_oracle_equiv
        compile_on = cfg.compiled and compile_guard is not False
        steps, batch = cfg.local_steps, cfg.batch_size
    else:
        from repro_torch.fed import round as fed_round

        body_target = f"scan_body[{spec.task.name}]"
        body, (carry, t) = fed_round.scan_body_for_lint(
            built.arch_config, built.round_spec, built.sampler, built.dataset,
            source=_trace_source(spec.execution.seed))
        width_applies = True
        compile_on = compile_guard is True
        steps, batch = built.round_spec.local_steps, built.round_spec.local_batch
    # The one client-sized float the random source draws by design: every
    # client's (R, B) batch-index uniforms a round, O(N R B) and not O(N D)
    # (the draw order a replayed run follows; the reference draws (N, R)
    # integer keys there).
    allow = [(n, steps, batch)]
    gm = _trace_body(body, carry, t, report, body_target)
    if gm is not None:
        report.add(audit_dtypes(gm, target=body_target), f"dtype:{body_target}")
        if width_applies:
            report.add(audit_width(gm, n, target=body_target, allow=allow),
                       f"width:{body_target}(N={n})")
        if sharded:
            report.add(audit_replicated_clients(gm, n, target=body_target,
                                                check_nd=width_applies, allow=allow),
                       f"replicated_clients:{body_target}(N={n})")
    if compile_on:
        seg_target = f"segment_runner[{body_target.split('[', 1)[1][:-1]}]"
        segment, state, builds = _probe_runner(spec, built, probe_rounds)
        findings = audit_compile_once(segment, state, probe_rounds, target=seg_target)
        if builds != 1:
            findings.append(Finding(check="compile_once", target=seg_target,
                                    message=f"one run built {builds} segment functions (expected 1)"))
        report.add(findings, f"compile_once:{seg_target}")
    return report


def _probe_runner(spec, built, probe_rounds: int):
    """(segment runner, round-0 state, segment functions built) of the spec
    on the CPU, its horizon cut to the rounds the compile-once audit runs,
    built the way ``api.run`` builds it (once)."""
    from repro_torch.api.runner import _zoo_segment_and_state
    from repro_torch.fed.server import build_segment_runner
    from repro_torch.fed.state import segment_builds

    rounds = probe_rounds * 3
    builds = segment_builds()
    if built.kind == "task":
        cfg = dataclasses.replace(built.fed_config, rounds=rounds)
        segment, state = build_segment_runner(built.task, built.dataset, built.sampler, cfg,
                                              device="cpu")
    else:
        short = dataclasses.replace(
            built, spec=dataclasses.replace(
                spec, federation=dataclasses.replace(spec.federation, rounds=rounds)))
        segment, state = _zoo_segment_and_state(short)
    return segment, state, segment_builds() - builds


def _lint_serve_cell(*, fast: bool = False) -> tuple:
    """The serve cell: the decode step under weight swaps.  ``audit_dtypes``
    on ``ServeEngine.decode_graph()``; unless ``fast``,
    ``ServeEngine.compile_once_probe``: decode steps with another weight
    variant installed on every call, a numpy round trip of the probe's
    state, and every cache tensor's address and dtype unchanged."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    cfg = get_config("smollm-360m").reduced(n_layers=2, d_model=64, d_ff=128, vocab=64)
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)
    params = transformer.init_params(cfg, g1, "cpu")
    variant = transformer.init_params(cfg, g2, "cpu")
    engine = ServeEngine(cfg, params, batch=2, max_seq=32, page_size=8, device="cpu")
    findings = list(audit_dtypes(engine.decode_graph(), target="decode step"))
    checked = ["decode step: dtype"]
    if not fast:
        prompts = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(2))
        findings += [Finding(check="compile_once", target="decode step under weight swaps",
                             message=m) for m in engine.compile_once_probe(prompts, [params, variant])]
        checked.append("decode step: cache addresses and dtypes across 2 weight swaps")
    return findings, checked


# ---------------------------------------------------------------------------
# The sweep: registry x metric fidelity x execution mode
# ---------------------------------------------------------------------------


def sweep_registry(*, samplers: Iterable[str] | None = None, n_clients: int = 13,
                   budget: int = 4, rounds: int = 4, fast: bool = False,
                   progress: Callable[[str], None] | None = None) -> LintReport:
    """Lint every registry sampler x oracle/deployable x compiled/reference,
    sharded, faulted and compressed, on the logreg task, then the serve
    cell: the reference's sweep, cell for cell.  ``n_clients=13`` is
    distinctive (prime, unequal to the logreg dimensions 60 and 10 and the
    batch size), so the width audit's client axis cannot collide with a
    model axis.  ``fast=True`` skips the compile-once passes (tracing only:
    seconds a cell)."""
    from repro_torch.api import (
        CompressionSpec,
        ExecutionSpec,
        ExperimentSpec,
        FaultSpec,
        FederationSpec,
        SamplerSpec,
        TaskSpec,
    )
    from repro_torch.core.samplers import sampler_names

    # All three fault axes at once; an async buffer of 3 != n_clients, so the
    # (B, D) ring is not mistaken for a client axis.
    faulted = FaultSpec(
        availability="markov", availability_kwargs={"p_on": 0.7, "p_off": 0.2},
        deadline=1.0, latency="exponential", latency_kwargs={"scale": 0.5},
        async_buffer=3, staleness_discount=0.5,
    )
    report = LintReport()
    for name in (list(samplers) if samplers is not None else sampler_names()):
        kwargs = {"horizon": rounds} if name in ("kvib", "vrb") else {}
        for oracle in (True, False):
            for compiled, axis, fault_on, compressed in (
                (True, None, False, False),
                (False, None, False, False),
                (True, "data", False, False),
                (True, None, True, False),
                (True, None, False, True),
            ):
                cell = (f"{name} x {'oracle' if oracle else 'deployable'} x "
                        f"{'compiled' if compiled else 'reference'}"
                        + (" x sharded" if axis else "") + (" x faulted" if fault_on else "")
                        + (" x compressed" if compressed else ""))
                if progress is not None:
                    progress(cell)
                spec = ExperimentSpec(
                    task=TaskSpec(name="logreg", dataset="synthetic_classification",
                                  dataset_kwargs={"n_clients": n_clients,
                                                  "total": 40 * n_clients, "seed": 0}),
                    sampler=SamplerSpec(name=name, kwargs=kwargs),
                    federation=FederationSpec(rounds=rounds, budget=budget, local_steps=1,
                                              batch_size=8),
                    execution=ExecutionSpec(compiled=compiled, oracle_metrics=oracle,
                                            sampler_axis=axis),
                    fault=faulted if fault_on else FaultSpec(),
                    compression=(CompressionSpec(delta_dtype="int8") if compressed
                                 else CompressionSpec()),
                )
                sub = run_suite(spec, compile_guard=False if fast else None)
                report.extend(_prefixed(sub.findings, sub.checked, cell))
    cell = "serve x paged-decode x swaps"
    if progress is not None:
        progress(cell)
    findings, checked = _lint_serve_cell(fast=fast)
    report.extend(_prefixed(findings, checked, cell))
    return report


def _prefixed(findings, checked, cell: str) -> LintReport:
    return LintReport(
        findings=[dataclasses.replace(f, target=f"{cell}: {f.target}") for f in findings],
        checked=[f"{cell}: {c}" for c in checked],
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Trace-invariant lint of the port: width / scan-safety / dtype / "
        "compile-once checks over the sampler registry and both stacks, on the CPU.  Exits "
        "1 on any finding.",
    )
    ap.add_argument("--spec", default="",
                    help="lint ONE ExperimentSpec JSON file instead of the registry sweep")
    ap.add_argument("--samplers", default="",
                    help="comma-separated sampler names to sweep (default: the whole registry)")
    ap.add_argument("--clients", type=int, default=13)
    ap.add_argument("--budget", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--fast", action="store_true",
                    help="tracing passes only: skip the compile-once runs")
    ap.add_argument("--quiet", action="store_true", help="no per-cell progress lines")
    args = ap.parse_args(argv)

    if args.spec:
        from repro_torch.api import ExperimentSpec

        report = run_suite(ExperimentSpec.load(args.spec))
    else:
        progress = None if args.quiet else (lambda cell: print(f"lint {cell} ...", flush=True))
        report = sweep_registry(
            samplers=[s for s in args.samplers.split(",") if s] or None,
            n_clients=args.clients, budget=args.budget, rounds=args.rounds, fast=args.fast,
            progress=progress,
        )
    print(report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
