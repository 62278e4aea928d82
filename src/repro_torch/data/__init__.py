from repro_torch.data.partition import dirichlet_label_partition, power_law_sizes, size_share
from repro_torch.data.pipeline import (
    FederatedDataset,
    synthetic_classification,
    synthetic_tokens,
)

__all__ = [
    "power_law_sizes",
    "dirichlet_label_partition",
    "size_share",
    "FederatedDataset",
    "synthetic_classification",
    "synthetic_tokens",
]
