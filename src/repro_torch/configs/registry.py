"""Architecture registry (the port of ``repro/configs/registry.py``).

Every zoo architecture of the reference is registered by name, and the port
holds its own copy of each config.  ``llama3.2-1b-sw`` (the reference's
``SW_CONFIG``, all layers sliding-window) is registered by name here.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.common import ArchConfig

__all__ = ["get_config", "has_arch", "list_archs", "INPUT_SHAPES", "ARCH_MODULES"]

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
