"""Zoo models for the port (``repro/models``): the dense family (block kinds
``attn`` and ``attn_local``), forward, prefill and paged decode.  RMSNorm
runs kernel 6 and full-sequence attention kernel 7."""
from repro_torch.models import attention, mlp, transformer
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_caches,
    init_params,
    loss_fn,
    param_count,
    params_from_reference,
    prefill,
)

__all__ = [
    "attention",
    "mlp",
    "transformer",
    "ArchConfig",
    "decode_step",
    "forward",
    "init_caches",
    "init_params",
    "loss_fn",
    "param_count",
    "params_from_reference",
    "prefill",
]
