"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256.  The port's copy of ``repro/configs/llama3_2_1b.py``, with the
all-sliding-window (8192) sibling ``SW_CONFIG``.  [hf:meta-llama/Llama-3.2-1B]"""
import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    rope_theta=5e5,
    block_pattern=("attn",),
    tie_embeddings=True,
    round_mode="client_parallel",
    long_context_ok=True,  # served long-context via the sliding-window variant
    sliding_window=8192,  # used only by "attn_local" blocks: see SW_CONFIG
    source="hf:meta-llama/Llama-3.2-1B",
)

# Long-context variant: all layers sliding-window (8192).
SW_CONFIG = dataclasses.replace(CONFIG, name="llama3.2-1b-sw", block_pattern=("attn_local",))
