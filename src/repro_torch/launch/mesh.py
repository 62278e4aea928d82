"""Host meshes and the client axis's shard layout (``ShardSpec``), the
port's copy of ``repro/launch/mesh.py``.

A ``Mesh`` is a frozen description of a host mesh: its axis names and sizes,
laid over the ranks of the default ``torch.distributed`` group in row-major
order.  A (1, 1) mesh needs no process group (the tests run there); a
``torch.distributed.device_mesh.DeviceMesh`` is materialised only where the
mesh has more than one rank (``Mesh.device_mesh``).  ``make_host_mesh`` and
``make_production_mesh`` take the reference's ``REPRO_MESH_SHAPE`` override.

Ranks lie on the mesh in row-major order (pod, then data, then model), as
``jax.make_mesh`` orders devices, so the ranks of one ``model`` line are
contiguous.  ``Mesh.coords()`` is a rank's coordinate on each axis and
``Mesh.axis_group(axes)`` the ``AxisGroup`` of the ranks that share its
coordinates on every other axis: one ``dist.new_group`` a line of each axis
(or tuple of axes), every rank making every line's group in the same order
(``_line_groups``); a line of all ranks is the default group itself.

A ``ShardSpec`` describes how the (N,) client axis is split: ``axes`` is the
mesh shape as ``((name, size), ...)`` pairs and ``axis`` names the axis, or
the tuple of axes, the client dimension is split over.  Its S shards are the
ranks of this rank's line along those axes (``process_group()``); the
default process group must hold exactly the mesh's ranks.  Rank r holds the
contiguous block ``local_range(n, r)`` of the client axis: blocks of
``ceil(N/S)``, the last one shorter.

The client axis's collectives go through ``ShardSpec.reduce`` (``sum``,
``max``, ``any``) / ``gather`` / ``broadcast``: ``all_reduce``, ``all_gather`` and
``broadcast`` only, which gloo carries on CPU and CUDA tensors alike.  With
one shard each is the identity.  Each call counts in ``collective_counts``,
so a run can show how many collectives a round took, as do the model
axis's collectives (``AxisGroup``, ``models/sharding.py``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "ShardSpec",
    "make_mesh",
    "make_production_mesh",
    "make_host_mesh",
    "batch_axes",
    "fsdp_axes",
    "world_size",
    "collective_counts",
    "collective_bytes",
    "reset_collective_counts",
    "AxisGroup",
    "is_writer",
    "check_group",
]

_COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "reduce_scatter": 0,
                "all_to_all": 0}
_COLLECTIVE_BYTES = dict.fromkeys(_COLLECTIVES, 0)


def collective_counts() -> dict:
    """Collectives issued through ``ShardSpec`` since the last reset, by kind."""
    return dict(_COLLECTIVES)


def collective_bytes() -> dict:
    """The result payload of those collectives, by kind: the bytes of each
    call's output on this rank (``analysis.cost``'s ``collective_bytes``
    charges the same)."""
    return dict(_COLLECTIVE_BYTES)


def reset_collective_counts() -> None:
    for k in _COLLECTIVES:
        _COLLECTIVES[k] = 0
        _COLLECTIVE_BYTES[k] = 0


def world_size() -> int:
    """Ranks of the default process group, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def global_rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_writer() -> bool:
    """Whether this process writes a run's files: rank 0 of the default
    group (mesh coordinate 0 on every axis), or the only process.  Ranks
    that replicate its work never race on one path."""
    return global_rank() == 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A host mesh: axis names and sizes over the default group's ranks
    (row-major).  ``shape`` maps names to sizes, as a JAX mesh's does."""

    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        object.__setattr__(self, "axis_names", tuple(str(n) for n in self.axis_names))
        object.__setattr__(self, "sizes", tuple(int(s) for s in self.sizes))
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} and sizes {self.sizes} differ in length")
        if any(s < 1 for s in self.sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {self.sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def device_mesh(self, device_type: str = "cpu"):
        """The ``DeviceMesh`` over the default group's ranks, or None for a
        one-rank mesh.  Raises ``ValueError`` if the group does not hold
        exactly ``size`` ranks."""
        if self.size == 1:
            return None
        if world_size() != self.size:
            raise ValueError(
                f"mesh {self.shape} needs {self.size} ranks; the default process group "
                f"holds {world_size()}"
            )
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(device_type, self.sizes, mesh_dim_names=self.axis_names)

    def coords(self, rank: int | None = None) -> dict:
        """Rank ``rank``'s (default this process's) coordinate on each axis,
        row-major."""
        r = global_rank() if rank is None else int(rank)
        out = {}
        for name, size in zip(reversed(self.axis_names), reversed(self.sizes)):
            out[name] = r % size
            r //= size
        return {n: out[n] for n in self.axis_names}

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"{a!r} is not an axis of the mesh {self.shape}")
        return axes

    def line(self, axes, rank: int | None = None) -> list:
        """The global ranks that share ``rank``'s coordinates off ``axes``,
        in row-major order over ``axes`` (the block order of a dimension
        split over them)."""
        axes = self._axes(axes)
        base = self.coords(rank)
        ranks = []
        for pos in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(base, **dict(zip(axes, pos)))
            ranks.append(self._rank_of(c))
        return ranks

    def _rank_of(self, coords: dict) -> int:
        r = 0
        for name, size in zip(self.axis_names, self.sizes):
            r = r * size + coords[name]
        return r

    def index(self, axes, rank: int | None = None) -> int:
        """``rank``'s block index along ``axes`` (row-major over them)."""
        axes = self._axes(axes)
        c = self.coords(rank)
        i = 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_group(self, axes) -> "AxisGroup":
        """This rank's ``AxisGroup`` along ``axes`` (a name or a tuple).
        Raises ``ValueError`` when the line holds several ranks and the
        default process group does not hold exactly the mesh's."""
        axes = self._axes(axes)
        size = self.axis_size(axes)
        if size == 1:
            return AxisGroup(None, axes, 1, 0)
        pg = _process_group(self, axes, f"mesh axes {axes}")
        return AxisGroup(pg, axes, size, self.index(axes))


# (mesh sizes, names, axes) -> (the default group, {line: its group}): every
# rank makes every line's group once, in the same order.
_LINE_GROUPS: dict = {}


def _line_groups(mesh: Mesh, axes: tuple) -> dict:
    key = (mesh.sizes, mesh.axis_names, axes)
    world = dist.group.WORLD
    hit = _LINE_GROUPS.get(key)
    if hit is not None and hit[0] is world:
        return hit[1]
    others = [a for a in mesh.axis_names if a not in axes]
    lines = {}
    for pos in itertools.product(*(range(mesh.shape[a]) for a in others)):
        rank0 = mesh._rank_of(dict(dict.fromkeys(mesh.axis_names, 0), **dict(zip(others, pos))))
        line = tuple(mesh.line(axes, rank0))
        lines[line] = world if len(line) == mesh.size else dist.new_group(list(line))
    _LINE_GROUPS[key] = (world, lines)
    return lines


def check_group(mesh: Mesh, what: str = "the run") -> None:
    """Raise ``ValueError`` unless the default process group holds exactly
    the ranks of ``mesh`` (nothing to check for a one-rank mesh): no rank
    runs a mesh's share without its group."""
    if mesh.size == 1:
        return
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"{what} lies on the mesh {mesh.shape} of {mesh.size} ranks, but torch.distributed "
            f"is not initialised; call init_process_group with world_size={mesh.size} first"
        )
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(
            f"{what} lies on the mesh {mesh.shape} of {mesh.size} ranks, but the default "
            f"process group has world_size={world}"
        )


def _process_group(mesh: Mesh, axes: tuple, what: str):
    """The process group of this rank's line along ``axes``."""
    check_group(mesh, what)
    return _line_groups(mesh, axes)[tuple(mesh.line(axes))]


def _host_staged(x: torch.Tensor, group) -> bool:
    """gloo carries all_reduce, all_gather and broadcast on CUDA tensors; the
    other collectives go through the host (the transport, not a fallback)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The ranks of one mesh line as this rank sees them: ``size`` ranks,
    this one at ``rank`` (its block index along ``axes``).  Each collective
    returns a new tensor and leaves its input alone, counts in
    ``collective_counts`` and is the identity for one rank.  ``pg`` is the
    ``torch.distributed`` group (None for one rank)."""

    pg: object
    axes: tuple
    size: int
    rank: int

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        if self.size == 1:
            return x
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.pg)
        _count("all_reduce", y)
        return y

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The blocks of every rank concatenated along ``dim``."""
        if self.size == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.pg)
        out = torch.cat(parts, dim)
        _count("all_gather", out)
        return out

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over the ranks of ``x``, this rank's block along ``dim``."""
        if self.size == 1:
            return x
        xs = x.movedim(dim, 0).contiguous()
        staged = _host_staged(xs, self.pg)
        src = xs.cpu() if staged else xs
        out = src.new_empty((src.shape[0] // self.size,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=self.pg)
        _count("reduce_scatter", out)
        return (out.to(x.device) if staged else out).movedim(0, dim)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x (size * m, ...): rows ``[i m, (i+1) m)`` go to rank i; the
        result's rows ``[i m, (i+1) m)`` came from rank i."""
        if self.size == 1:
            return x
        src = x.contiguous()
        staged = _host_staged(src, self.pg)
        if staged:
            src = src.cpu()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.pg)
        _count("all_to_all", out)
        return out.to(x.device) if staged else out


def make_mesh(shape, axes=None) -> Mesh:
    """A ``Mesh`` of ``shape``; ``axes`` default ("data", "model"), or
    ("pod", "data", "model") for three sizes."""
    shape = tuple(int(x) for x in shape)
    if axes is None:
        axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return Mesh(tuple(axes), shape)


def _override_mesh() -> Mesh | None:
    """REPRO_MESH_SHAPE env override, e.g. "2,1" or "2,4,4"."""
    override = os.environ.get("REPRO_MESH_SHAPE")
    if not override:
        return None
    return make_mesh(tuple(int(x) for x in override.split(",")))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's pod meshes, (16, 16) or (2, 16, 16), as descriptions."""
    mesh = _override_mesh()
    if mesh is not None:
        return mesh
    return make_mesh((2, 16, 16) if multi_pod else (16, 16))


def make_host_mesh(world: int | None = None) -> Mesh:
    """(data, model) mesh over the ranks of the default process group
    (``world``, default its size; 1 without one).  REPRO_MESH_SHAPE
    overrides; otherwise the model axis takes the largest of
    (16, 8, 4, 2, 1) dividing the rank count, the reference's rule, so a
    two-rank host gives (1, 2) and one rank the degenerate (1, 1)."""
    mesh = _override_mesh()
    if mesh is not None:
        return mesh
    n = world_size() if world is None else int(world)
    model = next(cand for cand in (16, 8, 4, 2, 1) if n % cand == 0)
    return make_mesh((n // model, model))


def batch_axes(mesh) -> tuple:
    """Mesh axes carrying the batch/client dimension."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def fsdp_axes(mesh) -> tuple:
    """Mesh axes over which fully-sharded parameters are scattered."""
    return batch_axes(mesh)


def _count(kind: str, out: torch.Tensor) -> None:
    _COLLECTIVES[kind] += 1
    _COLLECTIVE_BYTES[kind] += out.numel() * out.element_size()


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Declarative layout of the (N,) client axis over a mesh.

    Frozen and hashable, so the sampler dataclasses that hold it stay so.
    Two processes agreeing on a ``ShardSpec`` agree on the layout, which is
    why checkpoint manifests record ``to_manifest()``; a checkpoint holds
    global arrays, so a state saved under one layout restores under any."""

    axes: tuple = (("data", 1),)  # ((axis_name, size), ...)
    axis: str | tuple = "data"  # the axis (or axes) carrying the (N,) client dimension

    def __post_init__(self):
        object.__setattr__(self, "axes", tuple((str(n), int(s)) for n, s in self.axes))
        if not isinstance(self.axis, str):
            object.__setattr__(self, "axis", tuple(str(a) for a in self.axis))
        names = [n for n, _ in self.axes]
        for a in self._split_axes:
            if a not in names:
                raise ValueError(f"ShardSpec.axis {a!r} is not a mesh axis; have {names}")

    @property
    def _split_axes(self) -> tuple:
        return (self.axis,) if isinstance(self.axis, str) else self.axis

    @classmethod
    def from_mesh(cls, mesh: Mesh, axis="data") -> "ShardSpec":
        return cls(axes=tuple(zip(mesh.axis_names, mesh.sizes)), axis=axis)

    @classmethod
    def from_process_group(cls, axis: str = "data") -> "ShardSpec":
        """``axis`` over all ranks of the default process group, one shard
        without one."""
        return cls(axes=((axis, world_size()),), axis=axis)

    def mesh(self) -> Mesh:
        """The described mesh."""
        return Mesh(tuple(n for n, _ in self.axes), tuple(s for _, s in self.axes))

    @property
    def num_shards(self) -> int:
        sizes = dict(self.axes)
        return math.prod(sizes[a] for a in self._split_axes)

    @property
    def splits(self) -> bool:
        """True when the client axis is split over more than one rank."""
        return self.num_shards > 1

    def process_group(self):
        """The process group whose ranks hold the shards: ``None`` for one
        shard; for S > 1 the group of this rank's line along the split axes
        (``Mesh.axis_group``; the default group when the line holds every
        rank).  The default group must hold exactly the mesh's ranks.

        Raises:
          ValueError: S > 1 and no process group, or one of another size.
        """
        if self.num_shards == 1:
            return None
        return _process_group(self.mesh(), self._split_axes, f"ShardSpec {self.axis!r}")

    def rank(self) -> int:
        """This process's shard: its block index along the split axes
        (its rank in ``process_group()``), 0 for one shard."""
        if self.process_group() is None:
            return 0
        return self.mesh().index(self._split_axes)

    def local_range(self, n: int, rank: int) -> tuple[int, int]:
        """``[lo, hi)`` of the (n,) axis that shard ``rank`` holds: blocks of
        ``ceil(n / S)``, the last one shorter (or empty)."""
        m = -(-int(n) // self.num_shards)
        lo = min(int(rank) * m, int(n))
        return lo, min(lo + m, int(n))

    def block(self, n: int) -> tuple[int, int]:
        """``local_range(n, rank())``."""
        return self.local_range(n, self.rank())

    def axis_group(self) -> AxisGroup:
        """The shards' line as an ``AxisGroup`` (this rank at ``rank()``;
        one rank for one shard)."""
        if not self.splits:
            return AxisGroup(None, self._split_axes, 1, 0)
        return AxisGroup(self.process_group(), self._split_axes, self.num_shards, self.rank())

    # -- collectives over the shards (identities for one shard) ---------------

    def reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        """``x`` reduced over the shards by ``op`` (``all_reduce``; ``x`` is a
        fresh tensor the call may overwrite)."""
        group = self.process_group()
        if group is None:
            return x
        x = x.contiguous()
        dist.all_reduce(x, op=op, group=group)
        _count("all_reduce", x)
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduce(x, dist.ReduceOp.SUM)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduce(x, dist.ReduceOp.MAX)

    def any(self, x: torch.Tensor) -> torch.Tensor:
        """A 0-d bool: ``x`` true on any shard."""
        return self.max(x.to(torch.int32)) > 0

    def gather(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The (n, ...) whole of the blocks ``x`` (this shard's
        ``block(n)`` rows), by one ``all_gather`` of blocks padded to
        ``ceil(n / S)`` rows."""
        group = self.process_group()
        if group is None:
            return x
        s = self.num_shards
        m = -(-int(n) // s)
        dtype = x.dtype
        x = x.to(torch.uint8) if dtype == torch.bool else x
        pad = m - x.shape[0]
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        parts = [torch.empty_like(x) for _ in range(s)]
        dist.all_gather(parts, x.contiguous(), group=group)
        whole = torch.cat(parts)
        _count("all_gather", whole)
        out = whole[: int(n)]
        return out.to(dtype) if dtype == torch.bool else out

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``x`` as shard ``src`` holds it, on every shard."""
        group = self.process_group()
        if group is None:
            return x
        x = x.contiguous()
        dist.broadcast(x, src=src, group=group)
        _count("broadcast", x)
        return x

    def to_manifest(self) -> dict:
        """JSON-ready record for checkpoint manifests (provenance, not a
        restore constraint)."""
        axis = self.axis if isinstance(self.axis, str) else list(self.axis)
        return {"axes": [[n, s] for n, s in self.axes], "axis": axis}

    @classmethod
    def from_manifest(cls, data: dict) -> "ShardSpec":
        return cls(axes=tuple((n, s) for n, s in data["axes"]), axis=data["axis"])
