"""What the examples share: the ``--device`` flag, the eval batch and the
JSON writer."""
from __future__ import annotations

import argparse
import json
import os

import torch

RESULTS = os.path.join("results", "torch")


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the GPU; 'cpu' for the plain PyTorch path)",
    )


def eval_batch(dataset, seed: int, batch_size: int):
    """Every client's ``batch_size`` samples, flattened to (N * B, ...) and
    (N * B,): the examples' accuracy batch, drawn with a generator seeded
    with ``seed`` on the dataset's device."""
    gen = torch.Generator(device=dataset.device).manual_seed(int(seed))
    x, y = dataset.batch_all_clients(batch_size, generator=gen)
    return x.reshape(-1, x.shape[-1]), y.reshape(-1)


def write_json(path: str, results: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f)
    print("wrote", path)
