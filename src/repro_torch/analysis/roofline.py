"""Three-term roofline of one NVIDIA H100 (the port of
``repro/analysis/roofline.py``, whose ``HW`` holds a TPU v5e's peaks).

  compute    = FLOPs       / (chips x 989e12 FLOP/s dense bf16)
  memory     = bytes       / (chips x 3.35e12 B/s HBM)
  collective = coll. bytes / (chips x 450e9 B/s NVLink, one direction)

The counts come from ``analysis.cost.count`` (``launch.dryrun``): the eager
ops of one step as the card would run them, per device.  As in the
reference, the one compute peak divides every FLOP, whatever its type;
``tf32_flops`` and ``f32_flops`` are the peaks the kernels' bounds use
(``chip_smoke.py``'s bound column: operations over the peak of their type,
bytes over ``hbm_bw``).  MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference),
N the *active* parameters; MODEL_FLOPS / (FLOPs x chips) exposes remat and
other redundant work.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HW", "RooflineTerms", "roofline", "active_params", "model_flops"]


@dataclasses.dataclass(frozen=True)
class HW:
    """Peaks of one NVIDIA H100 80GB HBM3 (SXM, 700 W), NVIDIA's data
    sheet, dense rates without sparsity."""

    peak_flops: float = 989e12  # dense bf16 tensor cores: the roofline's compute peak
    hbm_bw: float = 3.35e12  # B/s
    link_bw: float = 450e9  # B/s, NVLink 4, one direction
    tf32_flops: float = 495e12  # dense TF32 tensor cores
    f32_flops: float = 67e12  # f32 outside the tensor cores


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops_total: float
    useful_ratio: float  # MODEL_FLOPS / (flops x chips)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        return d


def roofline(
    flops_per_device: float,
    bytes_per_device: float,
    coll_bytes_per_device: float,
    n_chips: int,
    model_flops_total: float,
    hw: HW = HW(),
) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_per_device / hw.peak_flops,
        memory_s=bytes_per_device / hw.hbm_bw,
        collective_s=coll_bytes_per_device / hw.link_bw,
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        coll_bytes_per_device=coll_bytes_per_device,
        model_flops_total=model_flops_total,
        useful_ratio=(
            model_flops_total / (flops_per_device * n_chips)
            if flops_per_device
            else 0.0
        ),
    )


def _named_leaves(tree, name=""):
    """``(name, leaf)`` for every leaf of a nest of dicts, lists and tuples,
    ``name`` the innermost dict key above it (the reference's DictKey)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, str(k))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _named_leaves(v, name)
    else:
        yield name, tree


def active_params(cfg, params) -> float:
    """Active parameter count, exactly from the parameter tree (``meta``
    tensors, or anything with a ``.shape``): every leaf counts fully except
    MoE expert stacks, which count scaled by top_k/E."""
    expert_names = {"w_gate", "w_up", "w_down"}
    total = 0.0
    for name, leaf in _named_leaves(params):
        size = 1
        for s in leaf.shape:
            size *= int(s)
        if name in expert_names and cfg.n_experts:
            size *= cfg.top_k / cfg.n_experts
        total += size
    return total


def model_flops(n_active: float, tokens_processed: float, kind: str) -> float:
    """6·N_active·D for training, 2·N_active·D for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens_processed
