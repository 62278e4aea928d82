"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000; alternating local (4096-window) / global attention, attention
and final logit soft-capping, embedding scaling.  The port's copy of
``repro/configs/gemma2_27b.py``.  [arXiv:2408.00118]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256000,
    head_dim=128,
    block_pattern=("attn_local", "attn"),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    scale_embed=True,
    act="gelu",
    tie_embeddings=True,
    round_mode="cohort_sequential",
    long_context_ok=False,
    source="arXiv:2408.00118",
)
