"""The random source of a federated run: every draw the round makes.

The JAX reference derives all randomness from one threefry key chain;
PyTorch's generators give other numbers from the same seed.  So the port
takes each draw from a *random source* passed to the server loop, and a test
can hand it the reference's own draws.  A source supplies:

* ``init_params(task)``: the round-0 parameters;
* ``isp_uniforms(t, n)``: round t's (N,) uniforms of the Bernoulli draw
  (a client is included when its uniform < its marginal);
* ``cohort_priorities(t, n)``: round t's (N,) uniform priorities for the
  deployable cohort's overflow drop;
* ``batch_indices(t, sizes, local_steps, batch_size)``: round t's
  (N, R, B) sample indices, client i's drawn uniformly from
  ``[0, sizes[i])``.

``PhiloxSource`` is the default: one ``torch.Generator`` per stream on the
run's device (Philox on CUDA), seeded from the run's seed.  ``ReplaySource``
plays back recorded tables.  Draws are made on the device and never read
back, so a round stays free of host syncs.
"""
from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from repro_torch.fed.tasks import params_from_reference

__all__ = ["RandomSource", "PhiloxSource", "ReplaySource"]


class RandomSource(Protocol):
    def init_params(self, task) -> dict: ...

    def isp_uniforms(self, t: int, n: int) -> torch.Tensor: ...

    def cohort_priorities(self, t: int, n: int) -> torch.Tensor: ...

    def batch_indices(
        self, t: int, sizes: torch.Tensor, local_steps: int, batch_size: int
    ) -> torch.Tensor: ...


class PhiloxSource:
    """Independent generator streams (init, draw, cohort, batches) seeded
    from ``seed``; draws are taken in round order."""

    _STREAMS = ("init", "sample", "cohort", "data")

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
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


class ReplaySource:
    """Plays back recorded draws.

    ``init_params``: the round-0 parameters as nested dicts of numpy arrays
    (the reference's layout, see ``fed.tasks.params_from_reference``);
    ``uniforms`` and ``priorities``: (T, N) float32; ``batch_idx``:
    (T, N, R, B) integers.  ``priorities`` may be None for oracle runs."""

    def __init__(self, init_params, uniforms, priorities, batch_idx, device):
        self.device = torch.device(device)
        self._init = init_params
        self._u = torch.as_tensor(np.asarray(uniforms, np.float32), device=self.device)
        self._prio = (
            None
            if priorities is None
            else torch.as_tensor(np.asarray(priorities, np.float32), device=self.device)
        )
        self._idx = torch.as_tensor(np.asarray(batch_idx, np.int64), device=self.device)

    def init_params(self, task) -> dict:
        return params_from_reference(self._init, self.device)

    def isp_uniforms(self, t: int, n: int) -> torch.Tensor:
        return self._u[t, :n]

    def cohort_priorities(self, t: int, n: int) -> torch.Tensor:
        if self._prio is None:
            raise ValueError("this ReplaySource recorded no cohort priorities")
        return self._prio[t, :n]

    def batch_indices(
        self, t: int, sizes: torch.Tensor, local_steps: int, batch_size: int
    ) -> torch.Tensor:
        idx = self._idx[t]
        want = (sizes.shape[0], local_steps, batch_size)
        if tuple(idx.shape) != want:
            raise ValueError(f"recorded batch indices have shape {tuple(idx.shape)}, need {want}")
        return idx
