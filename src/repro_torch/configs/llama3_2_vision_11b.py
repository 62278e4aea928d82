"""llama-3.2-vision-11b [vlm]: 40 layers, d_model=4096, 32 heads (GQA kv=8),
d_ff=14336, vocab=128256; every 5th layer is a gated cross-attention block
over image patch embeddings.  The port's copy of
``repro/configs/llama3_2_vision_11b.py``.  [hf:meta-llama/Llama-3.2-11B-Vision]

The ViT vision encoder is stubbed, as in the reference: a caller passes
precomputed patch embeddings (1601 patches of 1280, the projector's input
width, f32) as ``aux_embeds``.  9,780,400,136 parameters."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=5e5,
    block_pattern=("attn", "attn", "attn", "attn", "cross_attn"),
    frontend="vision",
    frontend_seq=1601,
    frontend_dim=1280,
    tie_embeddings=False,
    round_mode="cohort_sequential",
    long_context_ok=False,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
