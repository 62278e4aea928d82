"""Zoo architecture configs for the port (``repro/configs``): the dense,
hybrid, moe and xlstm families' configs; the vlm and audio ones raise
``NotImplementedError``."""
from repro_torch.configs.registry import ARCH_MODULES, INPUT_SHAPES, get_config, has_arch, list_archs

__all__ = ["ARCH_MODULES", "INPUT_SHAPES", "get_config", "has_arch", "list_archs"]
