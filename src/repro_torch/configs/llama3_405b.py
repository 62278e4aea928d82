"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256.  The port's copy of ``repro/configs/llama3_405b.py``.
[arXiv:2407.21783]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    head_dim=128,
    rope_theta=5e5,
    block_pattern=("attn",),
    tie_embeddings=False,
    round_mode="cohort_sequential",
    long_context_ok=False,
    source="arXiv:2407.21783",
)
