"""Federated data partitioning: power-law client sizes, Dirichlet label skew.

Numpy-only copy of ``repro/data/partition.py`` (``power_law_sizes``,
``size_share``, ``dirichlet_label_partition``); the generators downstream
depend on it bit for bit, so the arithmetic is the reference's unchanged.
"""
from __future__ import annotations

import numpy as np

__all__ = ["power_law_sizes", "dirichlet_label_partition", "size_share"]


def power_law_sizes(
    n_clients: int,
    total: int,
    alpha: float = 1.5,
    min_size: int = 8,
    seed: int = 0,
) -> np.ndarray:
    """Client dataset sizes following a (Zipf-like) power law, sum == total."""
    rng = np.random.default_rng(seed)
    raw = (np.arange(1, n_clients + 1, dtype=np.float64)) ** (-alpha)
    rng.shuffle(raw)
    sizes = raw / raw.sum() * (total - min_size * n_clients)
    sizes = np.floor(sizes).astype(np.int64) + min_size
    # distribute the rounding remainder
    deficit = total - sizes.sum()
    order = rng.permutation(n_clients)
    sizes[order[: int(abs(deficit))]] += int(np.sign(deficit))
    if sizes.sum() != total or not (sizes >= min_size // 2).all():
        raise ValueError(
            f"cannot split total={total} over {n_clients} clients with "
            f"min_size={min_size}"
        )
    return sizes


def size_share(sizes: np.ndarray, top_frac: float) -> float:
    """Fraction of data held by the top `top_frac` largest clients —
    the paper's unbalance statistic (e.g. FEMNIST v1: top 10% hold 82%)."""
    s = np.sort(sizes)[::-1]
    k = max(1, int(round(top_frac * len(s))))
    return float(s[:k].sum() / s.sum())


def dirichlet_label_partition(
    labels: np.ndarray,
    n_clients: int,
    beta: float = 0.5,
    seed: int = 0,
) -> list[np.ndarray]:
    """Label-skew partition: per-class proportions ~ Dirichlet(beta).

    Returns a list of index arrays, one per client.
    """
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    client_indices: list[list[int]] = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(n_clients, beta))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for client, part in enumerate(np.split(idx, cuts)):
            client_indices[client].extend(part.tolist())
    return [np.asarray(sorted(ix), dtype=np.int64) for ix in client_indices]
