"""The tile plan of the persistent Hopper GEMM (csrc/gemm_sm90.cuh) that
kernel B's forward, the fused MLP backward and the int8 qkv projection run
after their row passes; and the widths each entry's row passes are built
for (DiT-S/B/L and DiT-XL's D: 384, 768, 1024 and 1152 in every entry).

A GEMM computes C (rows, cols) = A (rows, depth) . B in (GEMM_ROWS, width)
output tiles, B a Linear weight (bf16, or int8 codes upcast on chip).
`gemm_plan` picks the tile width and the number of persistent CTAs; the
kernel and the plan number the tiles the same way.
"""
from __future__ import annotations

from typing import NamedTuple

SERVE_WIDTHS = (384, 768, 1024, 1152)  # the serving forwards' D (rows 7, 10, 11): DiT-S/B/L and DiT-XL
TRAIN_WIDTHS = (384, 768, 1024, 1152)  # the training forward's (row 8)
BWD_WIDTHS = (384, 768, 1024, 1152)  # the fused backward's (rows 9a/9b)
GEMM_ROWS = 128  # rows of an output tile: two consumer warpgroups of 64
GEMM_DEPTH = 64  # the reduction slab each ring stage holds
GEMM_WIDTHS = (256, 128)  # output tile widths the kernel is built for, widest first
TILE_FIXED_COLS = 64  # gemm_plan's fixed cost of a tile, in columns of work (not tuned)


class GemmPlan(NamedTuple):
    """One persistent GEMM of the Hopper bodies: C (rows, cols) = A (rows,
    depth) . B, B a Linear weight read K-major ((cols, depth): the forward
    and the int8 products) or MN-major ((depth, cols), the fused backward),
    in (GEMM_ROWS, width) output tiles, numbered row block-major (tile = row
    block * tiles_n + column block), CTA c of `grid` taking tiles c, c +
    grid, ... (csrc/gemm_sm90.cuh numbers them the same way). The last
    column block is ragged when `width` does not divide `cols`."""
    rows: int
    cols: int
    depth: int
    width: int
    grid: int

    @property
    def tiles_n(self) -> int:
        return -(-self.cols // self.width)

    @property
    def tiles(self) -> int:
        return -(-self.rows // GEMM_ROWS) * self.tiles_n

    def tiles_of(self, cta: int) -> list[tuple[int, int]]:
        """(first row, first column) of each tile CTA `cta` computes, in order."""
        return [(i // self.tiles_n * GEMM_ROWS, i % self.tiles_n * self.width)
                for i in range(cta, self.tiles, self.grid)]


def gemm_plan(rows: int, cols: int, depth: int, sm_count: int,
              widths: tuple[int, ...] = GEMM_WIDTHS, ragged: bool = False) -> GemmPlan:
    """The tile width and grid of one GEMM: of the `widths` that divide
    `cols` (any of them where the epilogue masks a `ragged` last column
    block), the one whose busiest CTA has the least work, counting a tile
    as its width plus TILE_FIXED_COLS columns' worth of fixed cost (its
    pipeline's fill and its epilogue's); the widest on a tie. One
    persistent CTA an SM, at most one per tile."""
    if depth % GEMM_DEPTH:
        raise ValueError(f"reduction depth {depth} is not a multiple of {GEMM_DEPTH}")
    best = None
    for width in widths:
        if cols % width and not ragged:
            continue
        tiles = -(-rows // GEMM_ROWS) * -(-cols // width)
        cost = -(-tiles // sm_count) * (width + TILE_FIXED_COLS)
        if best is None or cost < best[0]:
            best = (cost, GemmPlan(rows, cols, depth, width, min(sm_count, tiles)))
    if best is None:
        raise ValueError(f"no tile width of {widths} divides {cols}")
    return best[1]
