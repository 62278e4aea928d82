"""Federated dataset container + batching.

Clients hold ragged datasets; for batched (vmapped) simulation all clients are
padded to the largest size and carry their valid count.  Batches are drawn
uniformly with replacement from each client's valid region, by indices that
the caller supplies (``repro_torch.rng``), so a run's randomness has one
injection point; ``batch_all_clients`` (the examples' eval batch) takes an
explicit generator or the indices themselves.

The generators are the reference's seeded numpy code, so their arrays equal
``repro.data.pipeline``'s bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.partition import power_law_sizes
from repro_torch.device import resolve_device

__all__ = ["FederatedDataset", "synthetic_classification", "synthetic_tokens"]


@dataclasses.dataclass
class FederatedDataset:
    """Padded per-client data: features (N, S_max, ...), labels (N, S_max)."""

    features: torch.Tensor
    labels: torch.Tensor
    sizes: torch.Tensor  # (N,) int64 valid count per client

    @property
    def n_clients(self) -> int:
        return self.features.shape[0]

    @property
    def device(self) -> torch.device:
        return self.features.device

    @property
    def lam(self) -> torch.Tensor:
        """Client objective weights lambda_i proportional to dataset size
        (the FedAvg weighting of eq. 1)."""
        s = self.sizes.to(torch.float32)
        return s / s.sum()

    def client_batch(self, client: int, idx: torch.Tensor):
        """One client's batch at sample indices ``idx`` (B,), each drawn
        uniformly from ``[0, sizes[client])`` by the caller."""
        return self.features[client, idx], self.labels[client, idx]

    def gather(self, ids: torch.Tensor, idx: torch.Tensor):
        """Batches of several clients at once: ``ids`` (C,) client ids and
        ``idx`` (C, R, B) per-client sample indices -> features
        (C, R, B, ...) and labels (C, R, B)."""
        rows = ids.reshape(-1, 1, 1)
        return self.features[rows, idx], self.labels[rows, idx]

    def batch_all_clients(
        self, batch_size: int, *, generator: torch.Generator | None = None, idx=None
    ):
        """(N, B, ...) features and (N, B) labels, one batch per client:
        client i's indices drawn uniformly from ``[0, sizes[i])`` with
        ``generator`` (on the dataset's device), or taken from ``idx``
        (N, B)."""
        if idx is None:
            u = torch.rand(
                (self.n_clients, int(batch_size)), generator=generator, device=self.device
            )
            hi = self.sizes.reshape(-1, 1)
            # f32 rounding can carry u * size up to size itself: clamp.
            idx = torch.minimum((u * hi).long(), hi - 1)
        else:
            idx = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        rows = torch.arange(self.n_clients, device=self.device).reshape(-1, 1)
        return self.features[rows, idx], self.labels[rows, idx]

    def to(self, device) -> "FederatedDataset":
        """The same dataset on ``device`` (``self`` when already there)."""
        dev = torch.device(device)
        if self.device == dev:
            return self
        return FederatedDataset(self.features.to(dev), self.labels.to(dev), self.sizes.to(dev))


def _to_dataset(feats: np.ndarray, labels: np.ndarray, sizes: np.ndarray, device):
    dev = resolve_device(device)
    return FederatedDataset(
        features=torch.from_numpy(feats).to(dev),
        labels=torch.from_numpy(labels).to(dev),
        sizes=torch.from_numpy(np.asarray(sizes, np.int64)).to(dev),
    )


def synthetic_classification(
    n_clients: int = 100,
    alpha: float = 1.0,
    beta: float = 1.0,
    dim: int = 60,
    n_classes: int = 10,
    total: int = 20000,
    power: float = 1.5,
    seed: int = 0,
    *,
    device=None,
) -> FederatedDataset:
    """Synthetic(alpha, beta) of Li et al. 2020 — the paper's Section 6.1 task.

    Per client i: u_i ~ N(0, alpha); W_i ~ N(u_i, 1) in R^{C x d},
    b_i ~ N(u_i, 1); v_i ~ N(B_i, 1) with B_i ~ N(0, beta);
    x ~ N(v_i, diag(j^-1.2)); y = argmax(W_i x + b_i).  Sizes ~ power law.
    """
    rng = np.random.default_rng(seed)
    sizes = power_law_sizes(n_clients, total, alpha=power, seed=seed)
    s_max = int(sizes.max())
    feats = np.zeros((n_clients, s_max, dim), np.float32)
    labels = np.zeros((n_clients, s_max), np.int32)
    cov_diag = np.arange(1, dim + 1, dtype=np.float64) ** (-1.2)
    for i in range(n_clients):
        u = rng.normal(0, np.sqrt(alpha))
        b_mean = rng.normal(0, np.sqrt(beta))
        w = rng.normal(u, 1.0, size=(n_classes, dim))
        b = rng.normal(u, 1.0, size=(n_classes,))
        v = rng.normal(b_mean, 1.0, size=(dim,))
        x = rng.normal(v, np.sqrt(cov_diag), size=(int(sizes[i]), dim))
        logits = x @ w.T + b
        y = logits.argmax(axis=1)
        feats[i, : sizes[i]] = x.astype(np.float32)
        labels[i, : sizes[i]] = y.astype(np.int32)
        # pad region repeats the first sample (masked out by `sizes`)
        feats[i, sizes[i] :] = feats[i, 0]
        labels[i, sizes[i] :] = labels[i, 0]
    return _to_dataset(feats, labels, sizes, device)


def synthetic_tokens(
    n_clients: int,
    seq_len: int,
    vocab: int,
    total_seqs: int,
    power: float = 1.5,
    n_styles: int = 8,
    seed: int = 0,
    *,
    device=None,
) -> FederatedDataset:
    """Heterogeneous federated token streams (Section 6.3 scaled down).

    Each client draws from one of ``n_styles`` Markov-ish token generators so
    client gradients genuinely differ (heterogeneity drives the sampler).
    """
    rng = np.random.default_rng(seed)
    sizes = power_law_sizes(n_clients, total_seqs, alpha=power, seed=seed)
    s_max = int(sizes.max())
    toks = np.zeros((n_clients, s_max, seq_len), np.int32)
    # style = a biased unigram distribution + shift pattern
    styles = rng.dirichlet(np.full(vocab, 0.1), size=n_styles)
    for i in range(n_clients):
        st = styles[i % n_styles]
        t = rng.choice(vocab, p=st, size=(int(sizes[i]), seq_len))
        # inject determinism: next token correlated with previous (shift+1 mod vocab)
        t[:, 1::2] = (t[:, 0::2][:, : t[:, 1::2].shape[1]] + 1) % vocab
        toks[i, : sizes[i]] = t
        toks[i, sizes[i] :] = toks[i, 0]
    labels = np.roll(toks, -1, axis=-1)
    return _to_dataset(toks, labels, sizes, device)
