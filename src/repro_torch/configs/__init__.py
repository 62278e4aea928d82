"""Zoo architecture configs for the port (``repro/configs``): the port's own
copy of every config of the reference."""
from repro_torch.configs.registry import (
    ARCH_MODULES,
    INPUT_SHAPES,
    get_config,
    has_arch,
    input_specs,
    list_archs,
    step_kind,
)

__all__ = ["ARCH_MODULES", "INPUT_SHAPES", "get_config", "has_arch", "input_specs", "list_archs",
           "step_kind"]
