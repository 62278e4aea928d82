"""Preemption-safe checkpointing for the segmented federated run.

Port of ``repro/checkpoint``.  K-Vib's value is its online state: a
preempted server that loses it loses the learned sampling probabilities.
``fed.state.run_segmented`` cuts the horizon into segments of
``ckpt_every`` rounds, and ``CheckpointManager`` publishes the whole
``fed.state.TrainState`` at each boundary: parameters, optimizer and
sampler state, the (T, ...) metric buffers, the round, the random source's
generator states, the fault state and the error-feedback residual.

Restore is template-shaped: the reader builds the fresh round-0 state
(``repro_torch.api.restore_template``) and the checkpoint refills it; the
structure, every leaf's shape and every leaf's dtype must match, or
``ValueError`` is raised.
"""
from repro_torch.checkpoint.checkpointer import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.manager import CheckpointManager, config_fingerprint

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "CheckpointManager",
    "config_fingerprint",
]
