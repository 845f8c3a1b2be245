"""Path-keyed ``.npz`` checkpoints: the JAX package's format, read and
written with numpy alone.

Any tree of arrays (parameters, optimizer state, the trainer's best pair)
is one ``.npz`` whose keys are the leaves' tree paths joined by ``/``
(``params/decoders/layers/0/w``, ``opt_state/0/mu/encoder/layers/0/w``)
plus a JSON ``__meta__`` entry, so each package reads the other's files.
A tree is built from dicts (path element: the key), lists and tuples (the
index) and dataclasses (the field name, as a JAX ``NamedTuple`` gives it);
anything else is a leaf (a tensor, an array or a number), stored as a numpy
array of its own dtype.  :func:`save_train_state` adds the epoch and writes
atomically.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "/"


def _children(node):
    """(path element, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                       prefix: str = "") -> Any:
    """The tree with every leaf replaced by ``fn(path, leaf)``; dicts,
    lists, tuples and dataclasses keep their types."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    mapped = [tree_map_with_path(fn, v, f"{prefix}{_SEP}{k}" if prefix
                                 else k) for k, v in kids]
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), mapped))
    if isinstance(tree, (list, tuple)):
        return type(tree)(mapped)
    return dataclasses.replace(tree, **dict(zip((k for k, _ in kids),
                                                mapped)))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    others = [dict(flatten_with_paths(r)) for r in rest]
    return tree_map_with_path(
        lambda p, x: fn(x, *(o[p] for o in others)), tree)


def flatten_with_paths(tree: Any) -> list:
    """[(path, leaf)] of a tree, in its own order."""
    out = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def tree_leaves(tree: Any) -> list:
    return [x for _, x in flatten_with_paths(tree)]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(tree: Any, path: str, extra_meta: Optional[dict] = None
                ) -> None:
    """Save a tree of arrays to exactly ``path`` (an open handle keeps
    ``np.savez`` from appending ``.npz`` to a suffix-less name)."""
    leaves = {p: _host(x) for p, x in flatten_with_paths(tree)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, __meta__=json.dumps(dict(extra_meta or {})), **leaves)


def read_meta(path: str) -> dict:
    """Only the metadata of a checkpoint (no tree template needed)."""
    with np.load(path, allow_pickle=False) as f:
        return json.loads(str(f["__meta__"])) if "__meta__" in f.files else {}


# callers validating a config stamp before a structured load read the meta
# alone: a foreign checkpoint is refused with the stamp diagnostic, not with
# a shape mismatch from deep inside the tree
load_meta = read_meta


def load_flat(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """(``{tree_path: array}``, meta) of a checkpoint."""
    with np.load(path, allow_pickle=False) as f:
        meta = json.loads(str(f["__meta__"])) if "__meta__" in f.files else {}
        flat = {k: f[k] for k in f.files if k != "__meta__"}
    return flat, meta


def load_pytree(path: str, like: Any) -> Tuple[Any, dict]:
    """A checkpoint's leaves in the structure of ``like`` (paths and shapes
    must match; leaves come back as numpy arrays).  Returns (tree, meta)."""
    stored, meta = load_flat(path)

    def leaf(p, x):
        if p not in stored:
            raise KeyError(f"checkpoint missing leaf {p!r}")
        arr = stored[p]
        if tuple(arr.shape) != tuple(np.shape(x)):
            raise ValueError(f"shape mismatch for {p!r}: checkpoint "
                             f"{arr.shape} vs template {tuple(np.shape(x))}")
        return arr

    return tree_map_with_path(leaf, like), meta


def save_train_state(params: Any, opt_state: Any, path: str, *, epoch: int,
                     extra_meta: Optional[dict] = None,
                     extra_state: Optional[dict] = None) -> None:
    """Persist a whole training state (params, optimizer state, epoch) so a
    resumed run continues the same trajectory.  Written to a per-process
    temp file and renamed: a crash mid-save never corrupts the previous
    checkpoint, and concurrent writers never share a temp file.
    ``extra_state``: more trees stored beside them (keys other than
    'params' and 'opt_state')."""
    meta = {"epoch": int(epoch), **(extra_meta or {})}
    tree = {"params": params, "opt_state": opt_state, **(extra_state or {})}
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    save_pytree(tree, tmp, meta)
    os.replace(tmp, path)


def load_train_state(path: str, params_like: Any, opt_state_like: Any,
                     extra_state_like: Optional[dict] = None) -> tuple:
    """(params, opt_state, meta) saved by :func:`save_train_state`, in the
    structure of the templates; with ``extra_state_like`` (params,
    opt_state, extra_state, meta)."""
    like = {"params": params_like, "opt_state": opt_state_like,
            **(extra_state_like or {})}
    tree, meta = load_pytree(path, like)
    if extra_state_like is not None:
        return (tree["params"], tree["opt_state"],
                {k: tree[k] for k in extra_state_like}, meta)
    return tree["params"], tree["opt_state"], meta


def unflatten(flat: Dict[str, np.ndarray]) -> Any:
    """Nested tree from path-keyed leaves, with no template; a level whose
    keys are all integers becomes a list in index order."""
    root: dict = {}
    for key, arr in flat.items():
        node = root
        *parents, leaf = key.split(_SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return _listify(root)


def _listify(node):
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        idx = sorted(int(k) for k in out)
        if idx != list(range(len(idx))):
            raise ValueError(f"non-contiguous list indices {idx}")
        return [out[str(i)] for i in idx]
    return out


def load_tree(path: str) -> Tuple[Any, dict]:
    """(nested numpy tree, meta) of a checkpoint, with no template."""
    flat, meta = load_flat(path)
    return unflatten(flat), meta
