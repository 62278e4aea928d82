"""The random source of a federated run: every draw the round makes.

The JAX reference derives all randomness from one threefry key chain;
PyTorch's generators give other numbers from the same seed.  So the port
takes each draw from a *random source* passed to the server loop, and a test
can hand it the reference's own draws.  A source supplies:

* ``init_params(task)``: the round-0 parameters;
* ``isp_uniforms(t, n)``: round t's (N,) uniforms of the Bernoulli draw
  (a client is included when its uniform < its marginal);
* ``rsp_uniforms(t, budget)``: round t's (K,) uniforms of the draw with
  replacement: draw k picks the first client whose cumulative probability
  reaches ``total * (1 - u_k)``, as ``jax.random.choice(key, n, (K,), p=p)``
  does with ``u = jax.random.uniform(key, (K,))``;
* ``rsp_wor_indices(t, n, budget)``: round t's (K,) distinct clients of the
  uniform draw without replacement (the reference's first K of
  ``jax.random.permutation(key, n)``);
* ``cohort_priorities(t, n)``: round t's (N,) uniform priorities for the
  deployable cohort's overflow drop;
* ``batch_indices(t, sizes, local_steps, batch_size)``: round t's
  (N, R, B) sample indices, client i's drawn uniformly from
  ``[0, sizes[i])``;
* ``availability_uniforms(t, n)``: round t's (N,) uniforms of the fault
  layer's availability draw (the reference's ``fold_in(k_sample, 101)``);
* ``latencies(t, shape, dist)``: round t's per-client standard latency
  variates for the deadline (``fold_in(k_sample, 102)``; (N,) in oracle
  mode, (C,) in deployable mode);
* ``async_latency(t, dist)``: round t's 0-d standard variate for the
  buffered-async arrival delay (``fold_in(k_sample, 103)``);
* ``gumbel(t, shape)``: the serving engine's t-th sampling call's standard
  Gumbel noise (the prefill's first token is call 0); a token is
  ``argmax(logits / temperature + noise)``, which is how
  ``jax.random.categorical`` samples, so a test can replay the reference
  engine's noise.

A standard variate is one of the latency family ``dist``, before the
spec's parameters are applied (``core.stragglers.latency_draw``): Exp(1)
for ``"exponential"``, U[0, 1) for ``"uniform"``, N(0, 1) for
``"lognormal"``.

``PhiloxSource`` is the default: one ``torch.Generator`` per stream on the
run's device (Philox on CUDA), seeded from the run's seed.  Its draws come
in round order, so its ``state_dict()`` (each stream's
``Generator.get_state()``) is what a checkpoint carries in place of the
reference's PRNG key (``fed.state.TrainState.source``); a resumed run
reloads it with ``load_state_dict``.  ``ReplaySource`` plays back recorded
tables indexed by round and has an empty state.  Draws are made on the device and never read
back, so a round stays free of host syncs.
"""
from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from repro_torch.fed.tasks import params_from_reference

__all__ = ["RandomSource", "PhiloxSource", "ReplaySource"]

_LATENCY_DISTS = ("exponential", "uniform", "lognormal")


class RandomSource(Protocol):
    def init_params(self, task) -> dict: ...

    def isp_uniforms(self, t: int, n: int) -> torch.Tensor: ...

    def rsp_uniforms(self, t: int, budget: int) -> torch.Tensor: ...

    def rsp_wor_indices(self, t: int, n: int, budget: int) -> torch.Tensor: ...

    def cohort_priorities(self, t: int, n: int) -> torch.Tensor: ...

    def batch_indices(
        self, t: int, sizes: torch.Tensor, local_steps: int, batch_size: int
    ) -> torch.Tensor: ...

    def availability_uniforms(self, t: int, n: int) -> torch.Tensor: ...

    def latencies(self, t: int, shape: tuple, dist: str) -> torch.Tensor: ...

    def async_latency(self, t: int, dist: str) -> torch.Tensor: ...

    def gumbel(self, t: int, shape: tuple) -> torch.Tensor: ...

    def state_dict(self) -> dict: ...

    def load_state_dict(self, state: dict) -> None: ...


def _check_dist(dist: str) -> None:
    if dist not in _LATENCY_DISTS:
        raise ValueError(f"unknown latency distribution {dist!r}; options: {list(_LATENCY_DISTS)}")


class PhiloxSource:
    """Independent generator streams seeded from ``seed``; draws are taken
    in round order."""

    _STREAMS = ("init", "sample", "cohort", "data", "avail", "latency", "async")
    _LATE = {"gumbel": 1, "rsp": 2, "rsp_wor": 3}  # stream -> its seed offset k

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self._seed = int(seed)
        self._gen = {}
        for k, name in enumerate(self._STREAMS):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed) * len(self._STREAMS) + k)
            self._gen[name] = gen

    def init_params(self, task) -> dict:
        return task.init(self._gen["init"], self.device)

    def isp_uniforms(self, t: int, n: int) -> torch.Tensor:
        return torch.rand(n, generator=self._gen["sample"], device=self.device)

    def cohort_priorities(self, t: int, n: int) -> torch.Tensor:
        return torch.rand(n, generator=self._gen["cohort"], device=self.device)

    def batch_indices(
        self, t: int, sizes: torch.Tensor, local_steps: int, batch_size: int
    ) -> torch.Tensor:
        u = torch.rand(
            (sizes.shape[0], local_steps, batch_size),
            generator=self._gen["data"],
            device=self.device,
        )
        hi = sizes.reshape(-1, 1, 1)
        # f32 rounding can carry u * size up to size itself: clamp.
        return torch.minimum((u * hi).long(), hi - 1)

    def availability_uniforms(self, t: int, n: int) -> torch.Tensor:
        return torch.rand(n, generator=self._gen["avail"], device=self.device)

    def _standard(self, shape: tuple, dist: str, stream: str) -> torch.Tensor:
        _check_dist(dist)
        gen = self._gen[stream]
        if dist == "exponential":
            return torch.empty(shape, device=self.device).exponential_(generator=gen)
        if dist == "uniform":
            return torch.rand(shape, generator=gen, device=self.device)
        return torch.randn(shape, generator=gen, device=self.device)

    def latencies(self, t: int, shape: tuple, dist: str) -> torch.Tensor:
        return self._standard(tuple(shape), dist, "latency")

    def async_latency(self, t: int, dist: str) -> torch.Tensor:
        return self._standard((), dist, "async")

    def _late_stream(self, name: str, k: int) -> torch.Generator:
        """A stream added after the round's seven, created at first use and
        seeded apart from them (their seeds are seed * 7 + k), so adding it
        moved none of them."""
        if name not in self._gen:
            gen = torch.Generator(device=self.device)
            gen.manual_seed((k << 40) + self._seed)
            self._gen[name] = gen
        return self._gen[name]

    def rsp_uniforms(self, t: int, budget: int) -> torch.Tensor:
        return torch.rand(budget, generator=self._late_stream("rsp", 2), device=self.device)

    def rsp_wor_indices(self, t: int, n: int, budget: int) -> torch.Tensor:
        gen = self._late_stream("rsp_wor", 3)
        return torch.randperm(n, generator=gen, device=self.device)[:budget]

    def state_dict(self) -> dict:
        """Every stream's ``get_state()`` (a CPU uint8 tensor, also for a
        CUDA generator), the late streams included: creating one moves no
        other stream."""
        for name, k in self._LATE.items():
            self._late_stream(name, k)
        return {name: gen.get_state() for name, gen in sorted(self._gen.items())}

    def load_state_dict(self, state: dict) -> None:
        for name, st in state.items():
            gen = self._gen.get(name) or self._late_stream(name, self._LATE[name])
            gen.set_state(st)

    def gumbel(self, t: int, shape: tuple) -> torch.Tensor:
        gen = self._late_stream("gumbel", 1)
        u = torch.rand(tuple(shape), generator=gen, device=self.device)
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(u.clamp_(min=tiny)))


class ReplaySource:
    """Plays back recorded draws.

    ``init_params``: the round-0 parameters as nested dicts of numpy arrays
    (the reference's layout, see ``fed.tasks.params_from_reference``; a
    zoo model's through ``models.transformer.params_from_reference``);
    ``uniforms`` and ``priorities``: (T, N) float32; ``batch_idx``:
    (T, N, R, B) integers.  ``priorities`` may be None for oracle runs.
    The RSP draws' tables, each None when the run does not draw it:
    ``rsp_uniforms`` (T, K) float32 and ``rsp_indices`` (T, K) integers.
    The fault layer's tables, each None when the run does not draw it:
    ``avail_uniforms`` (T, N), ``latencies`` (T, W) standard variates with
    W = N (oracle) or C (deployable), ``async_latencies`` (T,) standard
    variates; the latency tables are of the run's latency family.  The
    serving engine's table, None unless it samples: ``gumbel``
    (T, B, V) standard Gumbel noise, one row per sampling call.  A source
    for the engine alone records only that: the round's tables default to
    None."""

    def __init__(
        self, init_params=None, uniforms=None, priorities=None, batch_idx=None, device="cpu", *,
        avail_uniforms=None, latencies=None, async_latencies=None, gumbel=None,
        rsp_uniforms=None, rsp_indices=None,
    ):
        self.device = torch.device(device)
        self._init = init_params
        self._u = self._table(uniforms)
        self._prio = self._table(priorities)
        self._idx = (
            None if batch_idx is None
            else torch.as_tensor(np.asarray(batch_idx, np.int64), device=self.device)
        )
        self._avail = self._table(avail_uniforms)
        self._lat = self._table(latencies)
        self._async = self._table(async_latencies)
        self._gumbel = self._table(gumbel)
        self._rsp_u = self._table(rsp_uniforms)
        self._rsp_idx = (
            None if rsp_indices is None
            else torch.as_tensor(np.asarray(rsp_indices, np.int64), device=self.device)
        )

    def _table(self, values):
        if values is None:
            return None
        return torch.as_tensor(np.asarray(values, np.float32), device=self.device)

    @staticmethod
    def _recorded(table, what: str):
        if table is None:
            raise ValueError(f"this ReplaySource recorded no {what}")
        return table

    def init_params(self, task) -> dict:
        # A zoo model converts the reference's tree itself (its layout and
        # dtypes are checked against the config's).
        convert = getattr(task, "params_from_reference", None)
        if convert is not None:
            return convert(self._init, self.device)
        return params_from_reference(self._init, self.device)

    def isp_uniforms(self, t: int, n: int) -> torch.Tensor:
        return self._recorded(self._u, "ISP uniforms")[t, :n]

    def rsp_uniforms(self, t: int, budget: int) -> torch.Tensor:
        return self._recorded(self._rsp_u, "RSP uniforms")[t, :budget]

    def rsp_wor_indices(self, t: int, n: int, budget: int) -> torch.Tensor:
        return self._recorded(self._rsp_idx, "RSP indices")[t, :budget]

    def cohort_priorities(self, t: int, n: int) -> torch.Tensor:
        return self._recorded(self._prio, "cohort priorities")[t, :n]

    def batch_indices(
        self, t: int, sizes: torch.Tensor, local_steps: int, batch_size: int
    ) -> torch.Tensor:
        idx = self._recorded(self._idx, "batch indices")[t]
        want = (sizes.shape[0], local_steps, batch_size)
        if tuple(idx.shape) != want:
            raise ValueError(f"recorded batch indices have shape {tuple(idx.shape)}, need {want}")
        return idx

    def availability_uniforms(self, t: int, n: int) -> torch.Tensor:
        return self._recorded(self._avail, "availability uniforms")[t, :n]

    def latencies(self, t: int, shape: tuple, dist: str) -> torch.Tensor:
        _check_dist(dist)
        lat = self._recorded(self._lat, "latencies")[t]
        if tuple(lat.shape) != tuple(shape):
            raise ValueError(
                f"recorded latencies have shape {tuple(lat.shape)}, need {tuple(shape)}"
            )
        return lat

    def async_latency(self, t: int, dist: str) -> torch.Tensor:
        _check_dist(dist)
        return self._recorded(self._async, "async latencies")[t]

    def state_dict(self) -> dict:
        return {}  # every table is indexed by round

    def load_state_dict(self, state: dict) -> None:
        if state:
            raise ValueError(f"a ReplaySource has no state; got keys {sorted(state)}")

    def gumbel(self, t: int, shape: tuple) -> torch.Tensor:
        g = self._recorded(self._gumbel, "Gumbel noise")[t]
        if tuple(g.shape) != tuple(shape):
            raise ValueError(f"recorded Gumbel noise has shape {tuple(g.shape)}, need {tuple(shape)}")
        return g
