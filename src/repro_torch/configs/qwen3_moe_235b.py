"""qwen3-moe-235b-a22b [moe]: 94 layers, d_model=4096, 64 query heads over 4
KV heads (explicit head_dim=128, per-head q/k RMSNorm), vocab=151936, an MoE
FFN of 128 experts (expert d_ff=1536), top-8.  The port's copy of
``repro/configs/qwen3_moe_235b.py``.  [hf:Qwen/Qwen3-30B-A3B scaled per
assignment]

One layer holds 3,732,418,816 parameters with the embedding and head
(6,220,173,824 with two)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    block_pattern=("moe",),
    n_experts=128,
    top_k=8,
    moe_d_ff=1536,
    tie_embeddings=False,
    round_mode="cohort_sequential",
    long_context_ok=False,
    source="hf:Qwen/Qwen3-30B-A3B",
)
