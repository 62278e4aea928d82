"""repro_torch.serve: the serving engine (``ServeEngine``: prefill and paged
decode with hot-swappable weights).  The reference's checkpoint watcher,
promotion gate and session (``swap.py``, ``gate.py``, ``session.py``) need
the checkpoint manager and wait for it (``ROADMAP.md``)."""
from repro_torch.serve.engine import ServeEngine

__all__ = ["ServeEngine"]
