"""Dependency-free checkpointing: a nested state -> flat npz + structure.

Port of ``repro/checkpoint/checkpointer.py``.  A state is any nesting of
dicts, lists, tuples (named tuples included) and dataclasses whose leaves
are tensors, numpy arrays or Python scalars — ``fed.state.TrainState`` is
the one the server saves.

Layout:  <dir>/<name>.npz          flat arrays keyed ``leaf_<i>`` in the
                                   flattening order (dict keys sorted,
                                   dataclass fields in declaration order)
         <dir>/<name>.treedef.txt  JSON: the structure string and each
                                   leaf's dtype and shape

Both files are staged as ``.tmp`` and published with ``os.replace``, so a
crash mid-save never leaves a half-written file under the final name.
Restore takes a template of the same structure (the fresh round-0 state):
the saved structure, every leaf's shape AND every leaf's dtype are checked
against it, and a mismatch raises ``ValueError`` — nothing is cast
silently.  Tensors come back on the template leaf's device.  A dtype numpy
lacks (bfloat16, the float8 types) is stored as the integer type of its
width and viewed back on restore.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

__all__ = [
    "save_checkpoint", "restore_checkpoint", "tree_structure", "tree_flatten", "tree_unflatten",
]

# torch dtypes numpy cannot hold, stored as raw integers of their width.
_RAW = {1: torch.uint8, 2: torch.int16}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _is_dataclass(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _children(tree):
    """(kind, [(key, child), ...]) for a container, or None for a leaf."""
    if _is_dataclass(tree):
        return type(tree).__name__, [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return "dict", [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return type(tree).__name__, list(zip(type(tree)._fields, tree))
    if isinstance(tree, (list, tuple)):
        return type(tree).__name__, list(enumerate(tree))
    return None


def tree_structure(tree) -> str:
    """A canonical string of ``tree``'s containers, keys and leaf slots."""
    node = _children(tree)
    if node is None:
        return "*"
    kind, items = node
    return f"{kind}(" + ",".join(f"{k!r}:{tree_structure(v)}" for k, v in items) + ")"


def tree_flatten(tree) -> list:
    """The leaves of ``tree`` in the order ``tree_structure`` lists them."""
    node = _children(tree)
    if node is None:
        return [tree]
    return [leaf for _, v in node[1] for leaf in tree_flatten(v)]


def tree_unflatten(template, leaves: list):
    """``template``'s structure with its leaves replaced by ``leaves``, in
    ``tree_flatten``'s order."""
    return _unflatten(template, list(leaves))


def _unflatten(template, leaves: list):
    node = _children(template)
    if node is None:
        return leaves.pop(0)
    values = {k: _unflatten(v, leaves) for k, v in node[1]}
    if _is_dataclass(template):
        return dataclasses.replace(template, **values)
    if isinstance(template, dict):
        return {k: values[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(**values)
    return type(template)(values[i] for i in range(len(template)))


def _leaf_meta(leaf) -> dict:
    if isinstance(leaf, torch.Tensor):
        return {"dtype": str(leaf.dtype), "shape": list(leaf.shape)}
    arr = np.asarray(leaf)
    return {"dtype": f"numpy.{arr.dtype}", "shape": list(arr.shape)}


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu().contiguous()
    try:
        return t.numpy()
    except TypeError:  # bfloat16, float8: keep the bits
        return t.view(_RAW[t.element_size()]).numpy()


def _sidecar_path(fname: str) -> str:
    return fname[: -len(".npz")] + ".treedef.txt"


def save_checkpoint(path: str, state) -> str:
    """Write ``state`` to ``<path>.npz`` plus its structure sidecar.
    Returns the ``.npz`` file name."""
    leaves = tree_flatten(state)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fname = path if path.endswith(".npz") else path + ".npz"
    sidecar = _sidecar_path(fname)
    meta = {"structure": tree_structure(state), "leaves": [_leaf_meta(x) for x in leaves]}
    # Stage BOTH files before publishing EITHER.
    tmp = fname + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)})
    tmp_sidecar = sidecar + ".tmp"
    with open(tmp_sidecar, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, fname)
    os.replace(tmp_sidecar, sidecar)
    return fname


def _restore_leaf(arr: np.ndarray, template):
    if isinstance(template, torch.Tensor):
        t = torch.from_numpy(np.array(arr))
        if t.dtype != template.dtype:  # a raw-bits dtype: same width, checked above
            t = t.view(template.dtype)
        return t.to(template.device)
    if isinstance(template, np.ndarray):
        return arr
    return type(template)(arr.item())


def restore_checkpoint(path: str, template):
    """Restore into the structure of ``template``.

    The saved structure string, every leaf's shape and every leaf's dtype
    are checked against the template's; any mismatch raises ``ValueError``
    (dtypes are NOT cast)."""
    fname = path if path.endswith(".npz") else path + ".npz"
    leaves_t = tree_flatten(template)
    with open(_sidecar_path(fname)) as f:
        meta = json.load(f)
    want = tree_structure(template)
    if meta["structure"] != want:
        raise ValueError(
            "checkpoint treedef does not match template structure:\n"
            f"  saved:    {meta['structure']}\n  template: {want}"
        )
    with np.load(fname) as data:
        if len(data.files) != len(leaves_t):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, template has {len(leaves_t)}")
        leaves = []
        for i, (saved, t) in enumerate(zip(meta["leaves"], leaves_t)):
            have = _leaf_meta(t)
            arr = data[f"leaf_{i}"]
            if list(arr.shape) != have["shape"] or saved["shape"] != have["shape"]:
                raise ValueError(
                    f"leaf {i}: checkpoint shape {tuple(arr.shape)} != template {tuple(have['shape'])}"
                )
            if saved["dtype"] != have["dtype"]:
                raise ValueError(
                    f"leaf {i}: checkpoint dtype {saved['dtype']} != template "
                    f"{have['dtype']} (refusing to cast silently)"
                )
            leaves.append(_restore_leaf(arr, t))
    return _unflatten(template, leaves)
