"""Window images <-> block node table (port of the merge / window parts of
sparkl_tpu/sparse/transfer.py).

A chunk's window image covers the 8^d cells of its owner block and the
2^d - 1 upper corner blocks. merge_images_to_grid sums images into the
block node table [MAX_GRID_BLOCKS + 1, F * 4^d] (last row = trash);
gather_grid_windows is its inverse read. The per-owner-block segment sum is
the merge kernel (fused/kernels.merge_blocks); the index reorders and the
2^d inverse-corner gather stay torch indexing, as the JAX caller keeps them
(transfer.py:284-297).
"""

import functools

import numpy as np
import torch

from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.sparse.blocks import (
    BlockConfig,
    cells_per_block,
    region_cells,
    region_maps,
)


def _zmajor_order_3d():
    q = np.arange(region_cells(3))
    x, y, z = q // 64, (q // 8) % 8, q % 8
    return z * 64 + x * 8 + y


# ZMAJOR_ORDER_3D[q_row] is the z-major position (q = z*64 + x*8 + y) of
# row-major region cell q_row: the cell order kernels A and B use in 3D.
ZMAJOR_ORDER_3D = _zmajor_order_3d()

# Static bound on chunks per owner block for the segment-sum merge (a block
# holds <= 4 chunks at nominal 3D seeding); denser blocks raise the overflow
# flag and the pipeline retries the span with the scatter merge pinned.
MERGE_KMAX = 8


@functools.lru_cache(maxsize=None)
def _merge_comb(dim, nf, zmajor, device):
    """Flat lane index taking images [D, nf*8^d] to rows [D, 2^d, nf, 4^d]."""
    cpb = cells_per_block(dim)
    corner_of_region, cell_of_region = region_maps(dim)
    perm = np.argsort(corner_of_region * cpb + cell_of_region)
    if zmajor:
        perm = ZMAJOR_ORDER_3D[perm]
    rc = region_cells(dim)
    k_i, f_i, c_i = np.meshgrid(
        np.arange(2**dim), np.arange(nf), np.arange(cpb), indexing="ij"
    )
    comb = (f_i * rc + perm[k_i * cpb + c_i]).reshape(-1)
    return torch.as_tensor(comb, dtype=torch.long, device=device)


@functools.lru_cache(maxsize=None)
def _window_comb(dim, nf, zmajor, device):
    """Flat lane index taking gathered rows [D, 2^d*nf*4^d] to windows
    [D, nf, 8^d]."""
    cpb = cells_per_block(dim)
    corner_of_region, cell_of_region = region_maps(dim)
    inv_perm = np.argsort(np.argsort(corner_of_region * cpb + cell_of_region))
    if zmajor:
        inv_perm = inv_perm[np.argsort(ZMAJOR_ORDER_3D)]
    rc = region_cells(dim)
    f_i, q_i = np.meshgrid(np.arange(nf), np.arange(rc), indexing="ij")
    qp = inv_perm[q_i]
    comb = ((qp // cpb) * nf * cpb + f_i * cpb + qp % cpb).reshape(-1)
    return torch.as_tensor(comb, dtype=torch.long, device=device)


def _merge_scatter(cfg, structure, rows, nf, cpb, ncorners):
    """Duplicate-index row scatter-add: the fallback for blocks denser than
    MERGE_KMAX chunks."""
    dest = structure.nbr_index[structure.chunk_block.long()].reshape(-1).long()
    out = torch.zeros((cfg.max_grid_blocks + 1, nf * cpb), dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, dest, rows.reshape(cfg.max_chunks * ncorners, nf * cpb))


def _merge_gather(cfg, structure, rows, nf, cpb, ncorners):
    """Per-owner-block segment sum over the contiguous chunk range (the
    merge kernel), then the 2^d inverse-corner gather into the node table.
    corner_owner inverts nbr_index; it is unique per (g, k) except on the
    trash row, which the caller zeroes."""
    from sparkl_tpu_torch.fused import kernels as FK

    dev = rows.device
    blk = FK.merge_blocks(
        rows.reshape(cfg.max_chunks, ncorners, nf * cpb),
        structure.block_first_chunk, structure.block_num_chunks,
    )
    blk = torch.cat(
        [blk, torch.zeros((1, ncorners, nf * cpb), dtype=blk.dtype, device=dev)], 0
    )  # pad row cfg.max_blocks = zero

    nbr = structure.nbr_index.long()  # [MB + 1, 2^d]
    co = torch.full((cfg.max_grid_blocks + 1, ncorners), cfg.max_blocks,
                    dtype=torch.long, device=dev)
    bidx = torch.clamp(torch.arange(nbr.shape[0], device=dev), max=cfg.max_blocks)
    kidx = torch.arange(ncorners, device=dev)
    co[nbr, kidx[None, :].expand_as(nbr)] = bidx[:, None].expand_as(nbr)

    out = torch.zeros((cfg.max_grid_blocks + 1, nf * cpb), dtype=torch.float32, device=dev)
    for k in range(ncorners):
        out = out + blk[co[:, k], k]
    return out


def merge_images_to_grid(grid: GridParams, cfg: BlockConfig, structure, images,
                         cell_order=None, force_scatter=False):
    """images [D, F, 8^d] -> (node table [MAX_GRID_BLOCKS + 1, F * 4^d],
    overflow [] bool). The segment-sum form always runs unless
    `force_scatter`; `overflow` flags a block denser than MERGE_KMAX chunks,
    whose sum the segment form truncated (the caller discards the span and
    retries with the scatter pinned). cell_order: ZMAJOR_ORDER_3D for the
    fused 3D kernels' image layout, or None for row-major."""
    dim = grid.dim
    nf = images.shape[1]
    cpb = cells_per_block(dim)
    ncorners = 2**dim
    if cell_order is not None and cell_order is not ZMAJOR_ORDER_3D:
        raise NotImplementedError("cell_order must be None or ZMAJOR_ORDER_3D")
    comb = _merge_comb(dim, nf, cell_order is not None, images.device)
    rows = images.reshape(cfg.max_chunks, -1)[:, comb].reshape(
        cfg.max_chunks, ncorners, nf, cpb
    )
    if force_scatter:
        ovf = torch.zeros((), dtype=torch.bool, device=images.device)
        out = _merge_scatter(cfg, structure, rows, nf, cpb, ncorners)
    else:
        ovf = torch.max(structure.block_num_chunks) > MERGE_KMAX
        out = _merge_gather(cfg, structure, rows, nf, cpb, ncorners)
    out[cfg.max_grid_blocks] = 0.0  # trash block
    return out, ovf


def gather_grid_windows(grid: GridParams, cfg: BlockConfig, structure, node_fields,
                        cell_order=None):
    """Inverse of merge: node_fields [MGB+1, F*4^d] -> windows [D, F, 8^d]."""
    dim = grid.dim
    cpb = cells_per_block(dim)
    nf = node_fields.shape[1] // cpb
    dest_blocks = structure.nbr_index[structure.chunk_block.long()]  # [D, 2^d]
    rows = node_fields[dest_blocks.reshape(-1).long()]  # [D*2^d, F*cpb]
    comb = _window_comb(dim, nf, cell_order is not None, node_fields.device)
    flat = rows.reshape(cfg.max_chunks, -1)
    return flat[:, comb].reshape(cfg.max_chunks, nf, region_cells(dim))
