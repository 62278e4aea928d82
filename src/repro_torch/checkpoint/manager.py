"""Step-numbered checkpoint management with an atomic JSON manifest.

Port of ``repro/checkpoint/manager.py``.  ``CheckpointManager`` turns the
flat ``save_checkpoint`` / ``restore_checkpoint`` pair into the persistence
layer of ``repro_torch.fed.state.run_segmented``: every segment boundary
publishes a step-numbered checkpoint, the manifest write is the atomic
commit point, and a restarted process finds where to resume with
``latest()`` / ``restore_or_init()``.

Directory layout::

    <dir>/manifest.json                  the commit point (tmp + os.replace)
    <dir>/<name>_<step:08d>.npz          flat arrays, atomic
    <dir>/<name>_<step:08d>.treedef.txt  structure sidecar, atomic

The manifest is written strictly AFTER its checkpoint files, so a crash
anywhere mid-save leaves it pointing at the previous fully published step.
Its fields are the reference's, with ``versions`` naming torch in place of
jax; ``config_fingerprint`` is the reference's algorithm, so the same spec
has the same fingerprint in both packages.

A checkpoint holds the global state.  Over S > 1 ranks
``fed.state.run_segmented`` gathers each split leaf to its global shape
and rank 0 alone saves; a restoring process, at any S, reads the global
arrays and its segments keep its block (``fed.state.StateLayout``), so a
run saved at S = 2 resumes at S = 1 and the reverse.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import time
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import (
    restore_checkpoint,
    save_checkpoint,
    tree_structure,
)

__all__ = ["CheckpointManager", "config_fingerprint"]

_MANIFEST_FORMAT = 1


def config_fingerprint(config: Any) -> str:
    """Stable short fingerprint of a run configuration: sha256 of the
    sorted-key JSON of ``config`` (an ``ExperimentSpec`` through its
    ``to_dict()``, a dataclass through ``dataclasses.asdict``; unknown
    leaves fall back to ``repr``), first 16 hex digits."""
    if hasattr(config, "to_dict"):
        config = config.to_dict()
    elif dataclasses.is_dataclass(config) and not isinstance(config, type):
        config = dataclasses.asdict(config)
    blob = json.dumps(config, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _treedef_hash(state) -> str:
    return hashlib.sha256(tree_structure(state).encode()).hexdigest()[:16]


class CheckpointManager:
    """Step-numbered atomic checkpoints + manifest + retention + discovery.

    ``keep_last``: the newest steps retained (older files are deleted after
    a new step's manifest commit).  ``fingerprint``: an optional
    ``config_fingerprint`` recorded on save and checked on restore.
    ``name``: the checkpoint files' prefix.  ``layout``: the saving run's
    sampler ``ShardSpec``, recorded in the manifest as provenance only (a
    restoring process lays out its state by its own layout)."""

    def __init__(
        self,
        directory: str,
        *,
        keep_last: int = 3,
        fingerprint: str | None = None,
        name: str = "state",
        layout=None,
    ):
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        self.directory = str(directory)
        self.keep_last = int(keep_last)
        self.fingerprint = fingerprint
        self.name = name
        self.layout = layout

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, "manifest.json")

    def checkpoint_path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.name}_{int(step):08d}.npz")

    def read_manifest(self) -> dict | None:
        """The committed manifest dict, or None if nothing was ever published."""
        try:
            with open(self.manifest_path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def _write_manifest(self, manifest: dict) -> None:
        os.makedirs(self.directory, exist_ok=True)
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        os.replace(tmp, self.manifest_path)  # the atomic commit point

    def save(self, state, step: int) -> str:
        """Publish ``state`` as step ``step``: files first, then the
        manifest, then retention.  Returns the checkpoint ``.npz`` path."""
        step = int(step)
        fname = save_checkpoint(self.checkpoint_path(step), state)
        prev = self.read_manifest()
        steps = sorted(set(prev.get("steps", []) if prev else []) | {step})
        retained = steps[-self.keep_last:]
        self._write_manifest({
            "format": _MANIFEST_FORMAT,
            "name": self.name,
            "step": max(retained),
            "file": os.path.basename(fname),
            "steps": retained,
            "treedef_sha256": _treedef_hash(state),
            "config_fingerprint": self.fingerprint,
            "shard_layout": self.layout.to_manifest() if self.layout is not None else None,
            "versions": {
                "torch": torch.__version__,
                "numpy": np.__version__,
                "python": platform.python_version(),
            },
        })
        for stale in steps[: -self.keep_last]:
            path = self.checkpoint_path(stale)
            for p in (path, path[: -len(".npz")] + ".treedef.txt"):
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass
        return fname

    def latest(self) -> int | None:
        """Newest committed step whose checkpoint file exists, else None."""
        manifest = self.read_manifest()
        if manifest is None:
            return None
        for step in sorted(manifest.get("steps", [manifest["step"]]), reverse=True):
            if os.path.exists(self.checkpoint_path(step)):
                return int(step)
        return None

    def wait_for_next(self, after_step: int, timeout: float, *, poll_interval: float = 0.05):
        """Block until a step > ``after_step`` is committed and return it, or
        None after ``timeout`` seconds (``timeout=0``: one check).  A
        reader never sees a partly written step: the manifest is replaced
        atomically and names only steps whose files are on disk."""
        after = int(after_step)
        deadline = time.monotonic() + float(timeout)
        while True:
            step = self.latest()
            if step is not None and step > after:
                return int(step)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            time.sleep(min(float(poll_interval), remaining))

    def restore(self, template, step: int | None = None):
        """Restore step ``step`` (default: ``latest()``) into ``template``,
        checking the config fingerprint, then the manifest's structure hash,
        then the files' structure, shapes and dtypes."""
        manifest = self.read_manifest()
        if manifest is None:
            raise FileNotFoundError(f"no manifest under {self.directory!r}")
        if step is None:
            step = self.latest()
            if step is None:
                raise FileNotFoundError(
                    f"manifest exists but no checkpoint files under {self.directory!r}"
                )
        saved_fp = manifest.get("config_fingerprint")
        if self.fingerprint and saved_fp and saved_fp != self.fingerprint:
            raise ValueError(
                f"config fingerprint mismatch: checkpoint was written by a run with "
                f"fingerprint {saved_fp}, this run has {self.fingerprint} — refusing "
                "to resume under a different configuration"
            )
        if int(step) == manifest["step"]:
            want, have = _treedef_hash(template), manifest.get("treedef_sha256")
            if have and have != want:
                raise ValueError(
                    f"treedef hash mismatch: manifest has {have}, template hashes to "
                    f"{want} — the carry structure changed"
                )
        return restore_checkpoint(self.checkpoint_path(int(step)), template)

    def restore_or_init(self, template):
        """(state, step): the latest committed state, or (template, 0)."""
        step = self.latest()
        if step is None:
            return template, 0
        return self.restore(template, step), int(step)
