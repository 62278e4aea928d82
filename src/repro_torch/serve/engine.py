"""The batched decode engine: prefill / decode over the paged KV cache (the
port of ``repro/serve/engine.py``).

``ServeEngine`` owns the serving hot path, ``prefill + first-token sample``
and ``single-token decode + sample``, over a paged KV cache
(``models.attention``: a ``(B*P, page_size, KV, hd)`` pool indexed through a
``(B, P)`` page table) and, for the hybrid family, the Mamba2 recurrent
state ({"conv", "ssm"} per block, never paged).  The engine is generic over
the caches ``transformer.prefill`` returns.  The reference pins one jitted
program per entry point; the port runs eagerly and keeps the same contract
in data:

* the parameter signature (names, shapes, dtypes) is pinned at
  construction, and ``swap_params`` validates a candidate against it before
  copying the candidate into the engine's own parameter storage in place,
  so every tensor the hot path reads keeps its address across swaps (what a
  later CUDA-graph capture of the decode step needs);
* the temperature is the engine's, and the first generated token (sampled
  from the prefill logits) goes through the same sampler as every later
  one: argmax at temperature 0, else ``argmax(logits / T + gumbel)``, with
  the noise from the engine's random source (``rng``);
* in-flight sequences keep their caches, positions and last tokens across
  a swap;
* a decode step writes into the caches in place: the new K/V line into the
  pool, the new conv and SSM states into the recurrent caches, so every
  cache tensor too keeps its address from prefill to the last step.

``step`` synchronizes the device once per call, not once per token.  The
lint handles (``repro_torch.analysis.lint``'s serve cell):
``decode_graph`` is the decode step's traced ATen graph, where the
reference hands over its jaxpr (``decode_jaxpr``), and
``compile_once_probe`` checks the contract above under swapped weights.
The reference's ``decode_cache_entries`` (jit cache entries of the decode
program: one) has no counterpart: the port builds no program to count.
"""
from __future__ import annotations

import time

import torch

from repro_torch.device import resolve_device
from repro_torch.fed.tasks import tree_leaves
from repro_torch.models import transformer
from repro_torch.rng import PhiloxSource

__all__ = ["ServeEngine"]


def _leaf_signature(tree, path: str = "") -> list:
    """[(path, shape, dtype)] in ``tree_leaves`` order (dict keys sorted):
    the pinned signature."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_signature(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaf_signature(v, f"{path}[{i}]")]
    if not isinstance(tree, torch.Tensor):
        return [(path, None, type(tree).__name__)]
    return [(path, tuple(tree.shape), str(tree.dtype).removeprefix("torch."))]


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def _sample_token(logits: torch.Tensor, temperature: float, noise) -> torch.Tensor:
    """(B, 1, V) logits -> (B, 1) int32 next tokens: argmax at temperature
    0, else argmax(logits / temperature + noise), noise (B, V) standard
    Gumbel (``jax.random.categorical``'s draw)."""
    lg = logits[:, -1].to(torch.float32)
    if temperature > 0:
        lg = lg / max(temperature, 1e-6) + noise
    return torch.argmax(lg, dim=-1).to(torch.int32)[:, None]


class ServeEngine:
    """Lockstep batched generation with hot-swappable weights.

    Parameters
    ----------
    cfg:
        ``repro_torch.models.common.ArchConfig`` (LM archs; frontend archs
        are rejected: serving traffic is token prompts).
    params:
        Initial weights; the engine copies them to ``device`` into storage
        of its own, and their names, shapes and dtypes become the pinned
        swap contract.
    batch / max_seq / page_size:
        Decode geometry: ``batch`` lockstep sequences, each with a
        ``max_seq``-token paged cache of ``page_size``-token pages.
    temperature:
        Sampling temperature, set per engine.
    seed:
        Seeds the engine's sampling stream only (``rng.PhiloxSource``),
        unless ``random_source`` is given (e.g. ``rng.ReplaySource`` with a
        recorded ``gumbel`` table).
    device:
        The GPU unless the caller asks for the CPU.
    """

    def __init__(
        self,
        cfg,
        params,
        *,
        batch: int,
        max_seq: int,
        page_size: int = 16,
        temperature: float = 0.0,
        seed: int = 0,
        device=None,
        random_source=None,
    ):
        if getattr(cfg, "frontend", None):
            raise ValueError(
                f"ServeEngine serves token-prompt LM archs; {cfg.name!r} has a "
                f"frontend ({cfg.frontend!r}) needing aux embeddings"
            )
        if max_seq < 2:
            raise ValueError(f"max_seq must be >= 2, got {max_seq}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch = int(batch)
        self.max_seq = int(max_seq)
        self.page_size = int(page_size)
        self.temperature = float(temperature)
        self._source = random_source if random_source is not None else PhiloxSource(seed, self.device)
        self._calls = 0

        self._signature = _leaf_signature(params)
        self._structure = _structure(params)
        self._params = self._copy_tree(params)
        self.swaps = 0

        # In-flight generation state (None until start()).
        self._tok = None
        self._caches = None
        self._logits = None
        self._index = 0
        self._out: list = []

        # Decode-side accounting (prefill excluded: tokens/s is the decode
        # steady state).
        self.decode_tokens = 0
        self.decode_seconds = 0.0

    def _copy_tree(self, tree):
        if isinstance(tree, dict):
            return {k: self._copy_tree(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [self._copy_tree(v) for v in tree]
        return tree.to(self.device, copy=True)

    # -- generation ----------------------------------------------------------
    @property
    def params(self):
        return self._params

    @property
    def index(self) -> int:
        """Tokens currently in the cache (= next write position)."""
        return self._index

    @property
    def capacity(self) -> int:
        """Decode steps possible before the paged cache is full."""
        return self.max_seq - self._index

    @property
    def last_logits(self):
        """The (B, 1, V) logits of the latest prefill or decode step."""
        return self._logits

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        noise = None
        if self.temperature > 0:
            noise = self._source.gumbel(self._calls, (self.batch, logits.shape[-1]))
        self._calls += 1
        return _sample_token(logits, self.temperature, noise)

    def start(self, prompts) -> torch.Tensor:
        """Prefill a fresh prompt batch; returns the first sampled tokens
        (B, 1).  Replaces any previous in-flight batch."""
        prompts = torch.as_tensor(prompts).to(self.device, torch.int64)
        if prompts.dim() != 2 or prompts.shape[0] != self.batch:
            raise ValueError(
                f"prompts must be ({self.batch}, prompt_len), got {tuple(prompts.shape)}"
            )
        if prompts.shape[1] >= self.max_seq:
            raise ValueError(
                f"prompt_len {prompts.shape[1]} must leave decode room under "
                f"max_seq={self.max_seq}"
            )
        logits, caches = transformer.prefill(
            self._params, self.cfg, prompts, max_seq=self.max_seq, page_size=self.page_size
        )
        tok = self._sample(logits)
        self._tok, self._caches, self._logits = tok, caches, logits
        self._index = int(prompts.shape[1])
        self._out = [tok]
        return tok

    def step(self, n: int = 1) -> int:
        """Run up to ``n`` decode steps (bounded by cache capacity), with one
        device synchronization at the end.  Returns the steps executed."""
        if self._tok is None:
            raise RuntimeError("no in-flight batch; call start(prompts) first")
        n = min(int(n), self.capacity)
        if n <= 0:
            return 0
        t0 = time.perf_counter()
        tok, caches, logits = self._tok, self._caches, self._logits
        for _ in range(n):
            logits, caches = transformer.decode_step(self._params, self.cfg, tok, caches, self._index)
            tok = self._sample(logits)
            self._index += 1
            self._out.append(tok)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._tok, self._caches, self._logits = tok, caches, logits
        self.decode_seconds += time.perf_counter() - t0
        self.decode_tokens += n * self.batch
        return n

    def generated(self) -> torch.Tensor:
        """All tokens sampled for the current batch, (B, n_generated)."""
        if not self._out:
            return torch.zeros((self.batch, 0), dtype=torch.int32, device=self.device)
        return torch.cat(self._out, dim=1)

    def tokens_per_sec(self) -> float:
        return self.decode_tokens / max(self.decode_seconds, 1e-9)

    # -- the hot swap --------------------------------------------------------
    # -- lint handles --------------------------------------------------------
    def decode_graph(self, prompt_len: int | None = None):
        """The decode step's ATen graph on this engine's pinned shapes and
        dtypes (parameters, paged caches, a (B, 1) token at position
        ``prompt_len``, default ``max_seq // 2``, and the sampler with
        (B, V) Gumbel noise), traced on fake tensors by
        ``analysis.lint.trace``: the input of ``audit_dtypes`` in the serve
        cell."""
        from repro_torch.analysis.lint import trace

        plen = int(prompt_len) if prompt_len is not None else self.max_seq // 2
        caches = transformer.init_caches(self.cfg, self.batch, self.max_seq,
                                         page_size=self.page_size, device="cpu")
        tok = torch.zeros((self.batch, 1), dtype=torch.int64)
        noise = torch.zeros((self.batch, self.cfg.vocab), dtype=torch.float32)

        def step(params, tok, caches, noise):
            logits, caches = transformer.decode_step(params, self.cfg, tok, caches, plen)
            return _sample_token(logits, max(self.temperature, 1.0), noise), caches

        return trace(step, self._params, tok, caches, noise)

    def compile_once_probe(self, prompts, param_variants=None, *, calls: int = 3,
                           steps: int = 2) -> list:
        """The engine's contract under swaps, probed: a fresh batch from
        ``prompts``, then ``calls`` times ``swap_params`` with the next of
        ``param_variants`` (cycling; default the engine's own weights) and
        ``steps`` decode steps.  After every call each cache tensor and each
        parameter keeps its address, shape and dtype, and the in-flight
        state (token, caches) through a numpy round trip (what a checkpoint
        applies) keeps every leaf's shape and dtype.  Returns the
        violations, one sentence each (empty: the contract holds); runs
        ``calls * steps`` decode steps on this engine."""
        variants = list(param_variants or [self._params])

        def addresses(tree):
            return [(t.data_ptr(), tuple(t.shape), t.dtype) for t in tree_leaves(tree)]

        self.start(prompts)
        caches0, params0 = addresses(self._caches), addresses(self._params)
        problems = []
        for k in range(calls):
            self.swap_params(variants[k % len(variants)])
            self.step(steps)
            if addresses(self._caches) != caches0:
                problems.append(f"call {k + 1}: a decode step under swapped weights moved or "
                                "retyped a cache tensor")
            if addresses(self._params) != params0:
                problems.append(f"call {k + 1}: a swap moved or retyped a parameter tensor")
        from repro_torch.analysis.lint import numpy_round_trip

        state = (self._tok, self._caches)
        if [(tuple(t.shape), t.dtype, t.device) for t in tree_leaves(numpy_round_trip(state))] != \
                [(tuple(t.shape), t.dtype, t.device) for t in tree_leaves(state)]:
            problems.append("the in-flight state changes shape or dtype through a numpy round trip")
        return problems

    def swap_params(self, new_params) -> None:
        """Install candidate weights between decode steps.

        Validates the candidate's names, shapes and dtypes against the
        pinned signature FIRST and raises ``ValueError`` on any drift; then
        copies it into the engine's parameter storage in place.  In-flight
        sequences are untouched."""
        if _structure(new_params) != self._structure:
            raise ValueError(
                "swap_params: param treedef changed (names or nesting differ from the "
                "pinned signature)"
            )
        got = _leaf_signature(new_params)
        for (path, shape, dtype), (_, got_shape, got_dtype) in zip(self._signature, got):
            if (shape, dtype) != (got_shape, got_dtype):
                raise ValueError(
                    f"swap_params: param aval drift at {path}: pinned {shape}/{dtype}, "
                    f"candidate {got_shape}/{got_dtype}; a swap must match the pinned "
                    "signature exactly"
                )
        for dst, src in zip(tree_leaves(self._params), tree_leaves(new_params)):
            dst.copy_(src)
        self.swaps += 1
