"""zamba2-1.2b [hybrid]: 38 blocks, d_model=2048, a Mamba2 backbone
(ssm_state=64, head dim 64, expand 2: 64 SSM heads over d_in=4096) and a
SHARED attention block (32 heads over 32 KV heads, d_ff=8192) invoked at
fixed positions with one set of weights.  The port's copy of
``repro/configs/zamba2_1p2b.py``.  [arXiv:2411.15242]

Pattern: a 19-slot group (18 mamba2 + 1 shared_attn) x 2 = 38 blocks; the
shared block's weights are stored once (``params["shared"]``), its KV cache
is per invocation.  1,053,612,800 parameters."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    block_pattern=("mamba2",) * 18 + ("shared_attn",),
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
    round_mode="client_parallel",
    long_context_ok=True,
    source="arXiv:2411.15242",
)
