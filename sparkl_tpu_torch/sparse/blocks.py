"""Block-sparse grid geometry (port of the parts of sparkl_tpu/sparse/blocks.py
the fused pipeline uses).

Blocks are 4^d cells; a chunk holds <= C particles of one block; a block's
8^d transfer window is the block plus its 2^d - 1 upper corner neighbours
(ref: sparkl gpu_grid.rs:281-321 `blocks_associated_to_point`).
"""

from dataclasses import dataclass

import numpy as np
import torch

BLOCK_SIDE = 4  # cells per block per axis (ref: NUM_CELL_PER_BLOCK = 4^d)


def cells_per_block(dim):
    return BLOCK_SIDE**dim


def region_side():
    return 2 * BLOCK_SIDE  # the 2^d-corner window is 8 cells per axis


def region_cells(dim):
    return region_side() ** dim


def default_chunk_size(dim):
    # Max particles at nominal 2-per-cell-axis seeding: 4^d cells * 2^d.
    return 128 if dim == 3 else 64


@dataclass(frozen=True)
class BlockConfig:
    """Static capacities. max_blocks: blocks that own particles;
    max_grid_blocks: owner blocks plus their 2^d corner neighbours."""

    max_blocks: int
    max_chunks: int
    chunk_size: int
    max_grid_blocks: int = 0

    def __post_init__(self):
        if self.max_grid_blocks == 0:
            object.__setattr__(self, "max_grid_blocks", self.max_blocks * 2 + 64)


def _compact_flagged(values, flags, capacity, fill):
    """First `capacity` values where flags, in order, padded with `fill`;
    plus the number of flagged values. Prefix sum + searchsorted, as the JAX
    package computes it (so ties and padding come out identical)."""
    n = values.shape[0]
    cf = torch.cumsum(flags.to(torch.int32), dim=0, dtype=torch.int32)
    k = cf[-1]
    ranks = torch.arange(1, capacity + 1, dtype=torch.int32, device=values.device)
    pos = torch.searchsorted(cf, ranks, side="left", out_int32=True)
    out = values[torch.clamp(pos, max=n - 1).long()]
    return torch.where(ranks <= k, out, fill), k


def region_maps(dim):
    """Static maps between the 8^d region index and (corner, cell-in-block):
    region cell r lives in corner block c = sum_ax (r_ax >= 4) * 2^(d-1-ax)
    at block-local cell l = sum_ax (r_ax % 4) * 4^(d-1-ax)."""
    side = region_side()
    rng = np.arange(side)
    mesh = np.stack(np.meshgrid(*([rng] * dim), indexing="ij"), axis=-1).reshape(
        -1, dim
    )
    corner = np.zeros(len(mesh), np.int32)
    cell = np.zeros(len(mesh), np.int32)
    for ax in range(dim):
        corner = corner * 2 + (mesh[:, ax] >= BLOCK_SIDE)
        cell = cell * BLOCK_SIDE + (mesh[:, ax] % BLOCK_SIDE)
    return corner, cell
