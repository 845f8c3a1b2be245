"""The dp x ep process mesh and its padding helper.

Mesh axes, as in the JAX package: ``dp`` shards the *pair/batch* axis (data
parallel), ``ep`` shards the *decoder-ensemble* axis (expert parallel).
Where JAX lays a mesh over the devices of one program, here every mesh
position is one ``torch.distributed`` rank (one process, one device):

    rank = dp_index * ep + ep_index

with one process group per dp row (the ranks that share pairs and split the
decoders: axis 'ep') and one per ep column (axis 'dp').  An axis of size 1
needs no communicator, so ``make_mesh(1, 1)`` works in a plain process that
never called ``init_process_group``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

AXES = ("dp", "ep")


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the ('dp', 'ep') mesh."""

    dp: int
    ep: int
    rank: int
    groups: Dict[str, Any]    # axis -> ProcessGroup, None for a size-1 axis

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "ep": self.ep}

    def _check(self, axis: str) -> None:
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r} (the mesh has "
                             f"{', '.join(AXES)})")

    def size(self, axis: str) -> int:
        self._check(axis)
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        self._check(axis)
        return self.rank // self.ep if axis == "dp" else self.rank % self.ep

    def group(self, axis: str):
        """The process group of the ranks that differ from this one only
        along ``axis`` (None when the axis has size 1)."""
        self._check(axis)
        return self.groups[axis]


def make_mesh(dp: Optional[int] = None, ep: int = 1) -> Mesh:
    """Create the ('dp', 'ep') mesh over the ranks of the default process
    group (one rank without one).  ``dp`` defaults to world size // ep; the
    world size must be exactly dp * ep.  Collective: every rank calls it
    with the same arguments."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    if ep < 1:
        raise ValueError(f"ep={ep} must be >= 1")
    if dp is None:
        if world % ep != 0:
            raise ValueError(f"{world} ranks not divisible by ep={ep}")
        dp = world // ep
    if dp < 1 or dp * ep != world:
        raise ValueError(
            f"mesh dp={dp} x ep={ep} needs exactly {dp * ep} ranks but the "
            f"process group has {world}; start one process per mesh position "
            "(parallel.multihost.init_multihost)")
    groups: Dict[str, Any] = {"dp": None, "ep": None}
    # every rank creates every group, in the same order
    if ep > 1:
        for r in range(dp):
            g = dist.new_group([r * ep + e for e in range(ep)])
            if r == rank // ep:
                groups["ep"] = g
    if dp > 1:
        for e in range(ep):
            g = dist.new_group([r * ep + e for r in range(dp)])
            if e == rank % ep:
                groups["dp"] = g
    return Mesh(dp=dp, ep=ep, rank=rank, groups=groups)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``axis`` of x up to a multiple (edge-replication padding keeps all
    computation finite); returns (padded, original_length)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad_idx = np.concatenate([np.arange(n), np.full(rem, n - 1)])
    return np.take(x, pad_idx, axis=axis), n
