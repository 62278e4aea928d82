"""whisper-small [audio]: encoder-decoder, 12 encoder and 12 decoder layers,
d_model=768, 12 heads (kv=12), d_ff=3072, vocab=51865.  The port's copy of
``repro/configs/whisper_small.py``.  [arXiv:2212.04356]

The mel-spectrogram and convolution frontend is stubbed, as in the
reference: a caller passes the post-convolution frame embeddings (1500
frames of 768, f32) as ``aux_embeds``, and the encoder transformer consumes
them.  239,802,624 parameters."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,  # decoder depth
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    block_pattern=("dec",),
    encoder_layers=12,
    frontend="audio",
    frontend_seq=1500,
    frontend_dim=768,
    act="gelu",
    tie_embeddings=True,
    round_mode="client_parallel",
    long_context_ok=False,  # full attention enc-dec
    source="arXiv:2212.04356",
)
