"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152,
llama-architecture small model.  The port's copy of
``repro/configs/smollm_360m.py``.  [hf:HuggingFaceTB/SmolLM-135M family]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
    block_pattern=("attn",),
    rope_theta=1e4,
    tie_embeddings=True,
    round_mode="client_parallel",
    long_context_ok=False,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
