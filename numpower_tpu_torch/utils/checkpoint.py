"""Checkpoint and resume of solver state (port of
numpower_tpu/utils/checkpoint.py).

A tree of tensors (dicts, lists, tuples, named tuples and the registered
nodes of ``torch.utils._pytree``, such as models/mpc.MPCState) is saved leaf
by leaf. Typical use: checkpoint a receding-horizon controller's warm-start
state so that a restarted process resumes mid-sweep.

Two formats, as in the JAX package:

 - a path ending in ``.npz``: the JAX package's layout, ``leaf_i`` for the
   i-th leaf plus ``__treedef__`` (JSON of the structure's text and the
   metadata, as uint8). Leaves are numbered in JAX's order, which sorts the
   keys of a dict (torch's pytree keeps insertion order), so either package
   reads the other's files;
 - any other path: a directory (orbax's in the JAX package, which this
   package does not use) holding ``torch.save`` of the CPU leaves and the
   metadata, read back with ``weights_only=True``.

``load_checkpoint`` takes the structure from ``like`` and puts each leaf on
the device of ``like``'s leaf; without ``like`` it returns the list of leaves
on the card (utils.default_device).
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch
import torch.utils._pytree as pytree

from numpower_tpu_torch.utils.device import default_device

_DIR_FILE = "checkpoint.pt"


def _sorted_dict(x) -> bool:
    """A node whose children JAX orders by sorted key."""
    return isinstance(x, dict) and not isinstance(x, OrderedDict)


def _children(tree):
    """(children, rebuild) of one level of ``tree``, or None for a leaf: a
    dict's children in sorted-key order, other nodes' as torch's pytree
    gives them, with every dict below kept whole for the next level; None
    is a node with no children, as in JAX."""
    if tree is None:
        return [], lambda vals: None
    if _sorted_dict(tree):
        keys = sorted(tree)

        def rebuild(vals):
            out = tree.copy()
            out.update(zip(keys, vals))
            return out

        return [tree[k] for k in keys], rebuild
    kids, spec = pytree.tree_flatten(tree, is_leaf=lambda x: x is not tree and _sorted_dict(x))
    if spec.is_leaf():
        return None
    return kids, lambda vals: pytree.tree_unflatten(vals, spec)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in the JAX package's order (dict keys sorted;
    None holds no leaf)."""
    level = _children(tree)
    if level is None:
        return [tree]
    return [leaf for kid in level[0] for leaf in tree_leaves(kid)]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in tree_leaves'
    order)."""
    it = iter(leaves)

    def build(node):
        level = _children(node)
        if level is None:
            return next(it)
        kids, rebuild = level
        return rebuild([build(k) for k in kids])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure of `like` holds")
    return out


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any, metadata: Dict | None = None) -> None:
    """Save a tree of tensors: a ``.npz`` file at a path ending in .npz,
    else a directory."""
    leaves = tree_leaves(tree)
    header = {"treedef": str(pytree.tree_structure(tree)), "meta": metadata or {}}
    if path.endswith(".npz"):
        arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
        arrays["__treedef__"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
        np.savez(path, **arrays)
        return
    os.makedirs(path, exist_ok=True)
    cpu = [torch.from_numpy(np.array(_host(x))) for x in leaves]
    torch.save({"leaves": cpu, "header": json.dumps(header)}, os.path.join(path, _DIR_FILE))


def _placed(arrays, like) -> list:
    """The loaded leaves as tensors, each on the device of ``like``'s leaf
    (the card where that leaf is no tensor, or without ``like``)."""
    targets = [None] * len(arrays) if like is None else tree_leaves(like)
    if len(targets) != len(arrays):
        raise ValueError(f"the checkpoint holds {len(arrays)} leaves, `like` {len(targets)}")
    return [torch.as_tensor(a, device=t.device if isinstance(t, torch.Tensor)
                            else default_device())
            for a, t in zip(arrays, targets)]


def load_checkpoint(path: str, like: Any = None) -> Any:
    """Load a tree saved by save_checkpoint (by either package for .npz);
    ``like`` gives the structure, else the list of leaves is returned."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as data:
            arrays = [data[f"leaf_{i}"] for i in range(len(data.files) - 1)]
    else:
        saved = torch.load(os.path.join(path, _DIR_FILE), weights_only=True)
        arrays = saved["leaves"]
    leaves = _placed(arrays, like)
    return leaves if like is None else tree_unflatten(like, leaves)
