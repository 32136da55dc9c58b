"""Launch shapes shared by the histogram kernels (``csrc/density_grid.cu``
and ``csrc/hist1d.cu``).

Both kernels stream their rows in tiles of :data:`WARP_TILE` rows a warp
(16 a lane), staging each tile's mask bytes in :data:`STAGE_BYTES` of
shared memory, and keep a private histogram in shared memory: in one
block when it fits there, spread over the blocks of a thread-block
cluster (distributed shared memory) when it fits there, and otherwise in
global memory.  :func:`pick_cluster` makes that choice from the
histogram's size and what the card can hold resident; the kernels'
wrappers call it with the card's own occupancy query, the CPU tests with
a model of the card.  Nothing here launches anything.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["THREADS", "WARPS", "WARP_TILE", "BLOCK_ROWS", "STAGE_BYTES",
           "MAX_SHARED_BYTES", "TWO_PER_SM_BYTES", "CLUSTER_SIZES",
           "pick_cluster", "cdiv"]

#: threads per block of both kernels (their ``kThreads``)
THREADS = 256
WARPS = THREADS // 32
#: rows a warp takes per step: 16 a lane, the mask loaded 16 bytes a lane
WARP_TILE = 512
#: rows a block takes per step
BLOCK_ROWS = WARPS * WARP_TILE
#: shared memory holding each warp's staged mask tile (the kernels'
#: ``kStageBytes``), ahead of the private histogram
STAGE_BYTES = WARPS * WARP_TILE
#: shared memory one block may use, after the opt-in (227 KB)
MAX_SHARED_BYTES = 232_448
#: the most one block may use and still leave room for a second block on
#: its SM: (228 KB - 2 x 1 KB reserved per block) / 2
TWO_PER_SM_BYTES = 115_712
#: cluster sizes tried, smallest first (above 8 is the non-portable size
#: the kernels opt in to)
CLUSTER_SIZES = (1, 2, 4, 8, 16)

#: ``resident(cluster, smem_bytes)``: blocks of that shape the card holds
#: at once (a multiple of ``cluster``; 0 when it cannot run that shape)
Resident = Callable[[int, int], int]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pick_cluster(cells: int, cell_bytes: int, resident: Resident,
                 sizes=CLUSTER_SIZES) -> tuple[int, int]:
    """``(cluster, smem_bytes)`` for a private histogram of ``cells``
    cells of ``cell_bytes`` each.

    The smallest cluster of ``sizes`` whose blocks each hold
    ``ceil(cells / cluster)`` cells beside the mask stage within
    :data:`TWO_PER_SM_BYTES` (two blocks an SM), else within
    :data:`MAX_SHARED_BYTES` (one block an SM), and of which the card
    holds at least one at once.  ``cluster`` 1 is one private copy per
    block; 0 means none of ``sizes`` holds the histogram and the kernel
    adds into global memory (``smem_bytes`` is then the mask stage
    alone)."""
    for budget in (TWO_PER_SM_BYTES, MAX_SHARED_BYTES):
        for c in sizes:
            smem = cdiv(cells, c) * cell_bytes + STAGE_BYTES
            if smem <= budget and resident(c, smem) >= c:
                return c, smem
    return 0, STAGE_BYTES
