"""repro_torch.serve: the train-to-serve subsystem (port of ``repro/serve``).

A paged-KV-cache decode engine (``engine``), a manifest-following
checkpoint watcher (``swap``), an eval-gated promote/rollback decision per
boundary (``gate``) and the loop composing them under traffic
(``session``).  Front doors: ``python -m repro_torch.launch.serve --follow
CKPT_DIR`` (a separate process following ``repro_torch.launch.train
--compiled --ckpt DIR --ckpt-every N``) and ``python -m
repro_torch.examples.fed_lm --serve`` (the closed loop in one process).

The trainer and the server share nothing but a directory, and the manifest
is the whole protocol (``checkpoint.manager``): a step exists iff the
manifest names it (files first, manifest last); the manifest's config
fingerprint must equal the server's, computed from the same
``ExperimentSpec`` (the trainer drops ``spec.json`` beside the manifest);
the manifest's structure hash must equal the server's restore template's
(``api.restore_template(spec)``).  The engine keeps the reference's
compile-once contract in data: ``swap_params`` copies a candidate into the
engine's own parameter storage, so every tensor the decode step reads
keeps its address across swaps (``engine`` module docstring).
"""
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.gate import PromotionGate, PromotionLog, PromotionRecord, heldout_batches
from repro_torch.serve.session import ServeSession, ServeSummary
from repro_torch.serve.swap import Candidate, CheckpointWatcher

__all__ = [
    "ServeEngine",
    "Candidate",
    "CheckpointWatcher",
    "PromotionGate",
    "PromotionLog",
    "PromotionRecord",
    "heldout_batches",
    "ServeSession",
    "ServeSummary",
]
