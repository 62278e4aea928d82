"""Zoo models for the port (``repro/models``): the dense family (block kinds
``attn`` and ``attn_local``), the hybrid family (``mamba2`` and
``shared_attn``), the moe family (``moe``), xLSTM (``mlstm`` and
``slstm``), the vlm (``cross_attn``) and whisper (an ``enc`` encoder and
``dec`` blocks), forward, prefill and paged decode.  RMSNorm runs kernel
6, full-sequence attention (self and cross) kernel 7 and the Mamba2
chunked scan kernel 8."""
from repro_torch.models import attention, mlp, moe, ssm, transformer, xlstm
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
    "moe",
    "ssm",
    "transformer",
    "xlstm",
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
