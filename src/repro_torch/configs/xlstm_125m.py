"""xlstm-125m [ssm]: 12 blocks, d_model=768, 4 heads, d_ff=0, vocab=50304;
alternating mLSTM and sLSTM blocks, each carrying its own projections.  The
port's copy of ``repro/configs/xlstm_125m.py``.  [arXiv:2405.04517]

The recurrent state is O(1) in the sequence (nothing is paged).
134,337,840 parameters."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    block_pattern=("mlstm", "slstm"),
    tie_embeddings=True,
    round_mode="client_parallel",
    long_context_ok=True,
    source="arXiv:2405.04517",
)
