"""Architecture registry (the port of ``repro/configs/registry.py``).

Every zoo architecture of the reference is registered by name, and the port
holds its own copy of each config.  ``llama3.2-1b-sw`` (the reference's
``SW_CONFIG``, all layers sliding-window) is registered by name here.
``input_specs`` builds ``meta`` stand-ins for every model input of a given
(arch, shape, step) combination: the dry run (``launch.dryrun``) counts a
step against these without allocating.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.common import ArchConfig

__all__ = ["get_config", "has_arch", "list_archs", "INPUT_SHAPES", "input_specs", "step_kind",
           "ARCH_MODULES"]

ARCH_MODULES = {
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama3_2_vision_11b",
}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def get_config(name: str) -> ArchConfig:
    if name == "llama3.2-1b-sw":
        return importlib.import_module("repro_torch.configs.llama3_2_1b").SW_CONFIG
    if name not in ARCH_MODULES:
        raise ValueError(f"unknown arch {name!r}; options: {list_archs()}")
    return importlib.import_module(ARCH_MODULES[name]).CONFIG


def has_arch(name: str) -> bool:
    """Whether ``name`` is a registered zoo architecture."""
    return name in ARCH_MODULES


def list_archs() -> list[str]:
    return list(ARCH_MODULES)


def step_kind(cfg: ArchConfig, shape: InputShape) -> str | None:
    """Which step a (arch, shape) pair counts; None means 'skip'
    (long_500k only for the sub-quadratic archs, ``cfg.long_context_ok``)."""
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return None
    return shape.kind


def _aux_embed_spec(cfg: ArchConfig, batch: int):
    if not cfg.frontend:
        return None
    fd = cfg.frontend_dim or cfg.d_model
    return torch.empty((batch, cfg.frontend_seq, fd), dtype=torch.float32, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """``meta`` inputs for one step.

    train:   tokens/targets (global_batch, seq) int32 [+ frontend embeds]
    prefill: tokens (global_batch, seq) int32 [+ frontend embeds]
    decode:  token (global_batch, 1) int32 + caches(seq_len), unpaged, + index
             (a host int: the port's ``decode_step`` takes the position on
             the host)
    """
    kind = step_kind(cfg, shape)
    if kind is None:
        raise ValueError(f"{cfg.name} skips {shape.name}")
    b, s = shape.global_batch, shape.seq_len
    tok = dict(dtype=torch.int32, device="meta")
    if kind in ("train", "prefill"):
        specs = {"tokens": torch.empty((b, s), **tok)}
        if kind == "train":
            specs["targets"] = torch.empty((b, s), **tok)
        aux = _aux_embed_spec(cfg, b)
        if aux is not None:
            specs["aux_embeds"] = aux
        return specs
    from repro_torch.models import transformer

    return {
        "token": torch.empty((b, 1), **tok),
        "caches": transformer.init_caches(cfg, b, s, device="meta"),
        "index": 0,
    }
