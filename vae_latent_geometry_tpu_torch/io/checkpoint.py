"""Reader for the path-keyed ``.npz`` checkpoints.

The JAX package saves any parameter tree as one ``.npz`` whose keys are the
leaves' tree paths joined by ``/`` (``decoders/layers/0/w``) plus a JSON
``__meta__`` entry.  This module reads that format with numpy alone and
rebuilds the nested dict/list tree (numeric path elements become list
indices), so the port needs no tree library to load a checkpoint.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np

_SEP = "/"


def load_flat(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """(``{tree_path: array}``, meta) of a checkpoint."""
    with np.load(path, allow_pickle=False) as f:
        meta = json.loads(str(f["__meta__"])) if "__meta__" in f.files else {}
        flat = {k: f[k] for k in f.files if k != "__meta__"}
    return flat, meta


def unflatten(flat: Dict[str, np.ndarray]) -> Any:
    """Nested tree from path-keyed leaves; a level whose keys are all
    integers becomes a list in index order."""
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
    """(nested numpy tree, meta) of a checkpoint."""
    flat, meta = load_flat(path)
    return unflatten(flat), meta
