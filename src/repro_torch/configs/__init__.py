"""Zoo architecture configs for the port (``repro/configs``): the dense and
hybrid families' configs; the other families raise ``NotImplementedError``."""
from repro_torch.configs.registry import ARCH_MODULES, INPUT_SHAPES, get_config, has_arch, list_archs

__all__ = ["ARCH_MODULES", "INPUT_SHAPES", "get_config", "has_arch", "list_archs"]
