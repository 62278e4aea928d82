"""Logical-axis sharding rules for the model code, and the collectives of
one rank's share of a partitioned step (the port of
``repro/models/sharding.py``).

The model functions annotate intermediates with *logical* axis names
(``shard(x, "batch", "seq", "ffn")``), at the reference's lines.  Outside
``use_rules`` nothing is split and ``shard`` returns its input.  Inside
``use_rules(mesh, rules)`` the names map to mesh axes, and the model code
runs one rank's share of the step: its parameters are this rank's blocks
(``launch/sharding.py:param_shardings``) and it splits what the rules split
over ``model`` (``ffn``: the MLP's hidden units, ``experts``: the MoE's
expert stacks, ``vocab``: the embedding rows and the head's columns,
``kv_seq``: the decode caches' sequence, ``state``: the mamba2 and mLSTM
heads, ``models/ssm.py`` and ``models/xlstm.py``), and the batch where the
rules give ``batch`` the batch axes.  Every other leaf is gathered whole at
its use (``models/transformer.py``).  ``shard`` never changes values, as in the
reference; under the rules it checks that each dimension the port splits
has the local size the rules imply (``whole`` gives the dimension's whole
size) and raises ``ValueError`` on a mismatch.

The collectives are ``torch.autograd.Function``s in the functorch form
(``setup_context``, a ``vmap`` staticmethod), so ``torch.func.vmap(grad(...))``
in the client_parallel round passes through them, each with its backward
pair:

  ``all_reduce``      sum forward          identity backward
  ``reduce_grad``     identity forward     sum (all_reduce) backward
  ``all_gather``      gather forward       slice backward (every rank holds
                                           the same whole gradient) or
                                           reduce-scatter (``grad="sum"``:
                                           each rank's gradient is partial)
  ``all_to_all``      exchange forward     the inverse exchange backward

``gather_blocks`` (the whole tensors of several blocks in one
all_gather), ``block`` (this rank's block of a whole tensor),
``redistribute`` (a block along one dimension as the block along another,
one all_to_all) and ``take_columns`` (the columns a rank uses of a tensor
split on its columns, one all_to_all) are built on them.

They run over a ``launch.mesh.AxisGroup`` (a ``torch.distributed`` group,
counted in ``launch.mesh.collective_counts``), or over the dry run's
stand-in that needs no process (``analysis.cost.CountingMesh``).

A batch's rows may also be split without the rules: a split
``cohort_sequential`` round gives each rank its block of every local
batch (``fed/round.py``) inside ``split_rows``.  ``row_split`` names the
rows' line either way, for the functions that couple a batch's rows (the
dense MoE dispatch's capacity, slots and load-balance loss).
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch

__all__ = [
    "shard",
    "use_rules",
    "DEFAULT_RULES",
    "current_mesh",
    "captured",
    "entered",
    "active",
    "axes_of",
    "group_of",
    "all_reduce",
    "reduce_grad",
    "all_gather",
    "all_to_all",
    "PORT_SPLIT",
    "block",
    "row_block_matmul",
    "gather_blocks",
    "redistribute",
    "take_columns",
    "split_rows",
    "row_split",
]

_CTX: contextvars.ContextVar = contextvars.ContextVar("shard_rules", default=None)
_ROWS: contextvars.ContextVar = contextvars.ContextVar("split_rows", default=None)

# logical axis -> mesh axis (or tuple of mesh axes); launch/sharding.py's
# activation_rules overrides them per mesh.
DEFAULT_RULES = {
    "batch": ("data",),
    "clients": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "embed": None,
    "seq": None,
    "kv_seq": ("model",),  # decode-time KV cache sequence sharding
    "state": ("model",),  # SSM recurrent state heads
}

# The logical axes the port's per-rank program holds split ("state": a
# mamba2 or mLSTM block's heads, where the model line divides them); the
# others (heads, kv_heads, seq) are computed whole on gathered weights.
PORT_SPLIT = ("batch", "ffn", "experts", "vocab", "kv_seq", "state")


@contextlib.contextmanager
def use_rules(mesh, rules: dict | None = None, *, fsdp: bool = False):
    """Run the model code as this rank's share of ``mesh`` under ``rules``
    (merged over ``DEFAULT_RULES``); ``fsdp``: the parameters' d_model axes
    are scattered over the batch axes too (``launch/sharding.py``)."""
    token = _CTX.set((mesh, dict(DEFAULT_RULES, **(rules or {})), bool(fsdp)))
    try:
        yield
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def split_rows(group, rows: int):
    """Run the model code on this rank's block of a batch of ``rows`` rows
    split over ``group`` (an ``AxisGroup``): contiguous blocks, lower ranks
    first (``ShardSpec.local_range``), uneven ones too."""
    token = _ROWS.set(None if group is None or group.size == 1 else (group, int(rows)))
    try:
        yield
    finally:
        _ROWS.reset(token)


def row_split(local_rows: int):
    """``(line, whole rows)`` when this rank's ``local_rows`` are its block
    of a batch split over several ranks: ``split_rows``', or the rules'
    batch axes (equal blocks), else None."""
    rows = _ROWS.get()
    if rows is not None:
        return rows
    group = batch_group()
    return None if group is None else (group, int(local_rows) * group.size)


def captured():
    """The rules and the rows' split in force here, for ``entered`` to
    restore elsewhere (None when neither is)."""
    ctx, rows = _CTX.get(), _ROWS.get()
    return None if ctx is None and rows is None else (ctx, rows)


@contextlib.contextmanager
def entered(ctx):
    """Run under ``ctx`` (``captured()``'s value): the autograd engine's
    device thread, which runs a CUDA backward and with it a recomputed
    group (``models/remat.py``), does not inherit this thread's context."""
    rules, rows = (None, None) if ctx is None else ctx
    token, token_rows = _CTX.set(rules), _ROWS.set(rows)
    try:
        yield
    finally:
        _ROWS.reset(token_rows)
        _CTX.reset(token)


def current_mesh():
    ctx = _CTX.get()
    return None if ctx is None else ctx[0]


def active():
    """The (mesh, rules, fsdp) context when it lays the step over more than
    one rank, else None: a mesh of all ones runs today's code unchanged."""
    ctx = _CTX.get()
    if ctx is None or ctx[0].size == 1:
        return None
    return ctx


def _flat(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axes_of(name: str) -> tuple:
    """The mesh axes the rules give logical axis ``name`` (() outside the
    rules or when it is replicated)."""
    ctx = _CTX.get()
    return () if ctx is None else _flat(ctx[1].get(name))


def group_of(axes):
    """This rank's ``AxisGroup`` along ``axes`` (a logical name's mesh axes,
    or mesh axis names), or None when they hold one rank or no rules are
    active."""
    ctx = active()
    axes = _flat(axes)
    if ctx is None or not axes:
        return None
    group = ctx[0].axis_group(axes)
    return None if group.size == 1 else group


def _mesh_axes(logical_axes, rules) -> list:
    """The reference's resolution: each dimension's mesh axes, a mesh axis
    splitting at most one dimension (the first logical axis wins)."""
    out, used = [], set()
    for name in logical_axes:
        axes = _flat(None if name is None else rules.get(name))
        if any(a in used for a in axes):
            axes = ()
        used.update(axes)
        out.append(axes)
    return out


def shard(x: torch.Tensor, *logical_axes, whole=None) -> torch.Tensor:
    """``x`` itself.  Under ``use_rules``: ``logical_axes[i]`` governs
    dimension i; each dimension of ``PORT_SPLIT`` with a whole size in
    ``whole`` (a tuple, None where unknown) must hold that size over the
    product of its mesh axes' sizes on this rank."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, rules, _ = ctx
    if len(logical_axes) != x.dim():
        raise ValueError(f"shard: {len(logical_axes)} logical axes for a {x.dim()}-d tensor")
    if whole is None:
        return x
    for i, (name, axes) in enumerate(zip(logical_axes, _mesh_axes(logical_axes, rules))):
        if name not in PORT_SPLIT or whole[i] is None:
            continue
        n = math.prod(mesh.shape[a] for a in axes)
        want = whole[i] // n if whole[i] % n == 0 else whole[i]
        if x.shape[i] != want:
            raise ValueError(
                f"shard: dimension {i} ({name!r} over {axes or 'no axis'}) holds {x.shape[i]}, "
                f"the rules imply {want} of {whole[i]} on mesh {mesh.shape}"
            )
    return x


# ---------------------------------------------------------------------------
# collectives with their backward pairs
# ---------------------------------------------------------------------------


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(x, group, op):
        return group.all_reduce(x, op)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.op = inputs[2]

    @staticmethod
    def backward(ctx, g):
        if ctx.op != "sum":
            raise RuntimeError("all_reduce(op='max') has no gradient; pass a detached input")
        return g, None, None

    @staticmethod
    def vmap(info, in_dims, x, group, op):
        return _AllReduce.apply(x, group, op), in_dims[0]


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group, "sum"), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _ReduceGrad.apply(x, group), in_dims[0]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(x, group, dim, grad):
        return group.all_gather(x, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.dim, ctx.grad = inputs[1], inputs[2], inputs[3]

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.group, ctx.dim
        if ctx.grad == "sum":
            return _ReduceScatter.apply(g, group, dim), None, None, None
        m = g.shape[dim] // group.size
        return g.narrow(dim, group.rank * m, m), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, group, dim, grad):
        if in_dims[0] is None:
            return _AllGather.apply(x, group, dim, grad), None
        return _AllGather.apply(x.movedim(in_dims[0], 0), group, dim + 1, grad), 0


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(x, group, dim):
        return group.reduce_scatter(x, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.group, ctx.dim, "slice"), None, None

    @staticmethod
    def vmap(info, in_dims, x, group, dim):
        if in_dims[0] is None:
            return _ReduceScatter.apply(x, group, dim), None
        return _ReduceScatter.apply(x.movedim(in_dims[0], 0), group, dim + 1), 0


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return group.all_to_all(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        # Equal blocks: the exchange is its own inverse.
        return _AllToAll.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        if in_dims[0] is None:
            return _AllToAll.apply(x, group), None
        return _AllToAll.apply(x.movedim(in_dims[0], 1), group), 1


def _needs_function(x: torch.Tensor) -> bool:
    return torch._C._are_functorch_transforms_active() or (
        torch.is_grad_enabled() and x.requires_grad)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sum (or max) of ``x`` over ``group``; gradient: identity (every rank
    holds the same gradient of the result).  ``group`` None: ``x``."""
    if group is None:
        return x
    if op == "max":
        x = x.detach()
    return _AllReduce.apply(x, group, op) if _needs_function(x) else group.all_reduce(x, op)


def reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient summed over ``group`` (each rank's use of
    a replicated input gives a partial gradient)."""
    if group is None or not _needs_function(x):
        return x
    return _ReduceGrad.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int, grad: str = "slice") -> torch.Tensor:
    """The blocks of ``group``'s ranks concatenated along ``dim``; gradient:
    this rank's block of it (``grad="slice"``) or the sum of the ranks'
    blocks of it (``"sum"``, a reduce-scatter)."""
    if group is None:
        return x
    if _needs_function(x):
        return _AllGather.apply(x, group, dim % x.dim(), grad)
    return group.all_gather(x, dim % x.dim())


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x (size * m, ...): block i to rank i; the result's block i came from
    rank i.  Gradient: the inverse exchange."""
    if group is None:
        return x
    return _AllToAll.apply(x, group) if _needs_function(x) else group.all_to_all(x)


def block(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """This rank's block of ``x`` (whole on every rank of ``group``) along
    ``dim``: a view; ``x`` itself for no group."""
    if group is None:
        return x
    m = x.shape[dim] // group.size
    return x.narrow(dim, group.rank * m, m)


def row_block_matmul(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """``x @ w`` where ``w`` is this rank's row block of a weight split over
    ``group`` and ``x`` the matching block of its input: the partial
    products all-reduced, in x's dtype.  A low-precision partial product is
    formed and summed in f32 and rounded once, as one GEMM over the whole
    rows rounds its f32 accumulator once.  ``group`` None: ``x @ w``."""
    if group is None:
        return x @ w
    if x.dtype == torch.float32:
        return all_reduce(x @ w, group)
    return all_reduce(x.float() @ w.float(), group).to(x.dtype)


def gather_blocks(parts, group, grad: str = "sum") -> list:
    """The whole tensors of this rank's blocks ``parts`` (each split over
    ``group`` along its last dimension, contiguous blocks in rank order),
    with one all_gather of their concatenation; ``grad`` as
    ``all_gather``'s.  ``parts`` themselves for no group."""
    parts = list(parts)
    if group is None:
        return parts
    if len(parts) == 1:
        return [all_gather(parts[0], group, -1, grad)]
    widths = [p.shape[-1] for p in parts]
    whole = all_gather(torch.cat(parts, -1), group, -1, grad)
    whole = whole.unflatten(-1, (group.size, sum(widths)))
    return [t.flatten(-2) for t in whole.split(widths, -1)]


def redistribute(x: torch.Tensor, group, src: int, dst) -> torch.Tensor:
    """``x``, this rank's block along ``src`` of a tensor split over
    ``group``, as its block along ``dst`` (one all_to_all), or whole
    (``dst`` None: an all_gather)."""
    if group is None or dst == src:
        return x
    if dst is None:
        return all_gather(x, group, src)
    got = all_to_all(torch.stack(x.chunk(group.size, dst)), group)
    return torch.cat(got.unbind(0), src)


def take_columns(x: torch.Tensor, group, need) -> torch.Tensor:
    """The columns ``need(rank)`` names for this rank (a list of (start,
    stop) ranges of the whole tensor's last dimension), in order, from
    ``x``, this rank's block of a tensor split over ``group`` along its last
    dimension (contiguous equal blocks in rank order).  One all_to_all:
    each rank sends every other the columns it holds of that rank's
    ranges, each chunk padded to the widest such chunk (all from shapes,
    the same on every rank); this rank's own columns are taken in place.
    ``need`` is a function of a rank, the same on every rank.  ``group``
    None: ``x``'s columns ``need(0)``."""
    if group is None:
        return torch.cat([x[..., a:b] for a, b in need(0)], -1)
    w, size, me = x.shape[-1], group.size, group.rank

    def held(i, j):  # rank j's ranges that rank i holds, in rank i's columns
        return [(max(a, i * w) - i * w, min(b, (i + 1) * w) - i * w) for a, b in need(j)
                if max(a, i * w) < min(b, (i + 1) * w)]

    def width(ranges):
        return sum(b - a for a, b in ranges)

    m = max(width(held(i, j)) for i in range(size) for j in range(size) if i != j)
    got = None
    if m:
        chunks = []
        for j in range(size):
            parts = [] if j == me else [x[..., a:b] for a, b in held(me, j)]
            pad = m - width(held(me, j)) if j != me else m
            chunks.append(torch.cat(parts + [x.new_zeros(x.shape[:-1] + (pad,))], -1))
        got = all_to_all(torch.stack(chunks), group)  # got[i]: rank i's chunk for this rank
    out, at = [], [0] * size
    for a, b in need(me):
        for i in range(a // w, (b - 1) // w + 1):  # the ranks holding [a, b), in order
            lo, hi = max(a, i * w) - i * w, min(b, (i + 1) * w) - i * w
            if i == me:
                out.append(x[..., lo:hi])
            else:
                out.append(got[i][..., at[i] : at[i] + hi - lo])
                at[i] += hi - lo
    return torch.cat(out, -1)


# ---------------------------------------------------------------------------
# parameters at their use
# ---------------------------------------------------------------------------

# Leaves whose model-split dimension the model code consumes split, by
# (block kind, the dict that holds them); kind None: in every block.  Step
# 6's MLP (``mlp``/``dense`` up, gate, down), step 7's expert stacks, and
# the projections of a mamba2 or mLSTM block whose heads this rank
# computes (``models/ssm.py``, ``models/xlstm.py``).  The sLSTM's leaves
# under the same ``cell`` key are not caught: its block is gathered whole.
CONSUMED = {(None, "mlp"): ("up", "gate", "down"), (None, "dense"): ("up", "gate", "down"),
            (None, "moe"): ("w_gate", "w_up", "w_down"),
            ("mamba2", "ssm"): ("in_proj", "conv_w", "out_proj"),
            ("mlstm", "cell"): ("up", "conv_w", "wq", "wk", "wv", "w_if", "down")}


def consumed(kind, parent: str) -> tuple:
    """The leaves of ``parent`` in a block of ``kind`` consumed split."""
    return CONSUMED.get((None, parent), ()) + (CONSUMED.get((kind, parent), ()) if kind else ())


def batch_group():
    """The group of the batch axes when the rules split the batch over more
    than one rank (this rank's rows are its block), else None."""
    return group_of(axes_of("batch"))


def use_leaf(x: torch.Tensor, spec: tuple, consumed: bool = False) -> torch.Tensor:
    """This rank's block ``x`` of a leaf laid out by ``spec``, gathered
    whole along every split dimension but a consumed ``model`` one.  The
    gather's backward slices over axes whose ranks hold the same whole
    gradient, and reduce-scatters over the batch axes the rules split
    (each rank's rows give a partial gradient); a leaf whole over split
    batch axes has its gradient summed over them."""
    if active() is None:
        return x
    b_axes = set(axes_of("batch")) if batch_group() is not None else set()
    named = set()
    for dim, entry in enumerate(spec):
        axes = _flat(entry)
        named.update(axes)
        if not axes or (consumed and axes == ("model",)):
            continue
        grad = "sum" if set(axes) <= b_axes else "slice"
        x = all_gather(x, group_of(axes), dim, grad)
    rest = tuple(a for a in axes_of("batch") if a in b_axes and a not in named)
    return reduce_grad(x, group_of(rest)) if rest else x


def use_block(tree, specs, parent: str = "", kind=None):
    """``use_leaf`` over a block's tree of blocks and its specs: every leaf
    whole but the model-split dimension of the ``CONSUMED`` leaves (those
    of ``kind``'s own entries only when ``kind`` is given: a block that
    computes its heads split)."""
    if isinstance(tree, dict):
        return {k: (use_block(v, specs[k], k, kind) if isinstance(v, dict)
                    else use_leaf(v, specs[k], k in consumed(kind, parent)))
                for k, v in tree.items()}
    return use_leaf(tree, specs, False)


def drop_lead(specs):
    """The specs of one repeat of a stacked slot (its leading axis gone)."""
    if isinstance(specs, dict):
        return {k: drop_lead(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [drop_lead(v) for v in specs]
    return specs[1:]
