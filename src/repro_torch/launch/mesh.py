"""The sampler's shard layout (``ShardSpec``), the port's copy of
``repro/launch/mesh.py``'s.

A ``ShardSpec`` describes how a sampler's (N,) client axis is split: ``axes``
is the layout as ``((name, size), ...)`` pairs and ``axis`` names the one the
client dimension is split over.  The reference materializes a JAX mesh from
it; the port has no mesh.  Its shards are the ranks of the default
``torch.distributed`` process group, which ``process_group()`` returns.  The
reference's production meshes (``make_production_mesh`` and friends) belong
to the pod-scale launcher and are not ported.
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist

__all__ = ["ShardSpec"]


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Declarative layout of a sampler's (N,) client axis.

    Frozen and hashable, so the sampler dataclasses that hold it stay so.
    Two processes agreeing on a ``ShardSpec`` agree on the layout, which is
    why checkpoint manifests record ``to_manifest()``."""

    axes: tuple = (("data", 1),)  # ((axis_name, size), ...)
    axis: str = "data"  # which axis carries the (N,) client dimension

    def __post_init__(self):
        object.__setattr__(self, "axes", tuple((str(n), int(s)) for n, s in self.axes))
        names = [n for n, _ in self.axes]
        if self.axis not in names:
            raise ValueError(f"ShardSpec.axis {self.axis!r} is not a mesh axis; have {names}")

    @classmethod
    def from_process_group(cls, axis: str = "data") -> "ShardSpec":
        """The layout of the default process group: ``axis`` over all of its
        ranks, or one shard when ``torch.distributed`` is not initialised
        (the counterpart of the reference's ``from_mesh``)."""
        size = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        return cls(axes=((axis, size),), axis=axis)

    @property
    def num_shards(self) -> int:
        return dict(self.axes)[self.axis]

    def process_group(self):
        """The process group whose ranks hold the shards: ``None`` for one
        shard; for S > 1 the default group, which must be initialised with
        ``world_size == S``.

        Raises:
          ValueError: S > 1 and no process group, or one of another size.
        """
        s = self.num_shards
        if s == 1:
            return None
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(
                f"ShardSpec splits {self.axis!r} over {s} shards, but torch.distributed "
                "is not initialised; call init_process_group with world_size="
                f"{s} first"
            )
        world = dist.get_world_size()
        if world != s:
            raise ValueError(
                f"ShardSpec splits {self.axis!r} over {s} shards, but the default "
                f"process group has world_size={world}"
            )
        return dist.group.WORLD

    def to_manifest(self) -> dict:
        """JSON-ready record for checkpoint manifests (provenance, not a
        restore constraint)."""
        return {"axes": [[n, s] for n, s in self.axes], "axis": self.axis}

    @classmethod
    def from_manifest(cls, data: dict) -> "ShardSpec":
        return cls(axes=tuple((n, s) for n, s in data["axes"]), axis=data["axis"])
