"""arctic-480b [moe]: 35 layers, d_model=7168, 56 query heads over 8 KV
heads, vocab=32000, an MoE FFN of 128 experts (expert d_ff=4864), top-2,
PLUS an always-on dense residual MLP (d_ff=4864) beside it.  The port's copy
of ``repro/configs/arctic_480b.py``.  [hf:Snowflake/snowflake-arctic-base]

One layer holds 14,069,945,344 parameters with the embedding and head."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,  # dense residual branch width
    vocab=32000,
    block_pattern=("moe",),
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual=True,
    tie_embeddings=False,
    round_mode="cohort_sequential",
    long_context_ok=False,
    source="hf:Snowflake/snowflake-arctic-base",
)
