"""The screen-tile mesh over a ``torch.distributed`` process group.

PyTorch counterpart of ``paperrenderer_tpu/parallel/mesh.py``. The JAX
package lays its devices out as a 2D ``Mesh`` of (rows, cols) screen
tiles; here each rank of a process group renders one tile, and the ranks
take the tiles in row-major order, as JAX's ``reshape(rows, cols)`` of the
device list does: rank r owns tile (r // cols, r % cols).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch.distributed as dist


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into the most-square (rows, cols) factorization."""
    best = (1, n)
    for r in range(1, int(math.isqrt(n)) + 1):
        if n % r == 0:
            best = (r, n // r)
    return best


@dataclasses.dataclass(frozen=True)
class TileMesh:
    """One rank's view of the (rows, cols) tile mesh."""

    axis_names: Tuple[str, str]
    shape: Tuple[int, int]          # (rows, cols) = _factor2(world size)
    coords: Tuple[int, int]         # this rank's (row, col)
    group: Optional[dist.ProcessGroup] = None   # None: the default group

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def index(self) -> int:
        """The rank's tile in row-major order (its triangle shard too)."""
        return self.coords[0] * self.shape[1] + self.coords[1]

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def make_tile_mesh(group: Optional[dist.ProcessGroup] = None,
                   axes: Tuple[str, str] = ("rows", "cols")) -> TileMesh:
    """The tile mesh of the calling rank over ``group`` (the default process
    group when None), which must be initialized."""
    if not dist.is_initialized():
        raise RuntimeError("make_tile_mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    rows, cols = _factor2(dist.get_world_size(group))
    rank = dist.get_rank(group)
    return TileMesh(tuple(axes), (rows, cols), (rank // cols, rank % cols),
                    group)
