"""Cell-bucketed particle neighbourhoods with a fixed capacity per cell
(port of sparkl_tpu/sparse/neighbors.py).

The reference sorts particles by cell and walks each cell's (start, end)
range (sparkl `src/dynamics/particle_set.rs`, consumed by eigenerosion.rs).
Here a [num_cells * max_per_cell] bucket table is filled by a counting rank
over one stable sort; particles past a cell's capacity are left out of the
neighbour enumeration (never out of the simulation), and the overflow flag
tells the caller to regrow the capacity and retry. Ids are int32.
"""

import numpy as np
import torch

from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.math import linalg


def _num_nodes(grid: GridParams):
    return int(np.prod(grid.res))


def stencil_offsets(dim):
    """The 3^d offsets {0, 1, 2}^d in the JAX package's order (last axis
    fastest)."""
    rng = [0, 1, 2]
    if dim == 2:
        return np.array([[i, j] for i in rng for j in rng], np.int32)
    return np.array([[i, j, k] for i in rng for j in rng for k in rng], np.int32)


def cell_index(grid: GridParams, position):
    """Cell (floor) index per particle [N, d] int32 and whether it lies in the
    grid. x/h is the product with f32(1/h), as jitted XLA rounds it."""
    origin = torch.tensor(grid.origin, dtype=position.dtype, device=position.device)
    ix = torch.floor(linalg.div_const(position - origin, grid.cell_width)).to(torch.int32)
    res = torch.tensor(grid.res, dtype=torch.int32, device=position.device)
    ok = torch.all((ix >= 0) & (ix < res), dim=-1)
    return ix, ok


def _flat_cell(grid: GridParams, ix):
    """Row-major flat cell id of (clipped) cell indices [..., d]."""
    res = grid.res
    hi = torch.tensor(res, dtype=torch.int32, device=ix.device) - 1
    ix = torch.minimum(torch.clamp(ix, min=0), hi)
    flat = ix[..., 0]
    for ax in range(1, len(res)):
        flat = flat * res[ax] + ix[..., ax]
    return flat


def build_buckets(grid: GridParams, position, valid, max_per_cell: int):
    """Returns (bucket table [num_cells * max_per_cell] of particle ids, -1
    where empty; cell index; in-grid-and-valid mask; overflow flag []). A
    particle's rank in its cell is its place in the stable sort by cell;
    `overflow` is set when a cell holds more than max_per_cell valid
    particles, whose extras the table leaves out."""
    n = position.shape[0]
    dev = position.device
    num_nodes = _num_nodes(grid)
    ix, ok = cell_index(grid, position)
    ok = ok & valid
    flat = torch.where(ok, _flat_cell(grid, ix), num_nodes)
    sorted_cells, order = torch.sort(flat, stable=True)
    first = torch.searchsorted(sorted_cells, sorted_cells, side="left", out_int32=True)
    rank = torch.arange(n, dtype=torch.int32, device=dev) - first
    k = max_per_cell
    in_cell = sorted_cells < num_nodes
    overflow = torch.any(in_cell & (rank >= k))
    slot = torch.where(in_cell & (rank < k), sorted_cells * k + rank, num_nodes * k)
    buckets = torch.full((num_nodes * k + 1,), -1, dtype=torch.int32, device=dev)
    buckets[slot.long()] = order.to(torch.int32)  # only the dropped slot repeats
    return buckets[:-1], ix, ok, overflow


def neighbor_pair_sums(grid: GridParams, position, values, include_mask, radius,
                       max_per_cell: int = 8):
    """For each particle i: the sum over j != i of values[j] [V] where
    |x_i - x_j| <= radius, both in include_mask, j within the 3^d cell
    neighbourhood of i's cell. Returns ([N, V] sums, overflow flag []).
    Each particle's candidates are its 3^d cells' buckets in offset order,
    max_per_cell each (-1 slots empty); the sum runs over them."""
    n, d = position.shape
    k = max_per_cell
    dev = position.device
    buckets, ix, ok, overflow = build_buckets(grid, position, include_mask, k)

    # Candidate payload [N + 1, d + V]: position and values; the last row
    # backs empty slots.
    packed = torch.cat([position, values], dim=1)
    packed = torch.cat([packed, torch.full((1, packed.shape[1]), -1.0, dtype=packed.dtype,
                                           device=dev)], dim=0)

    offsets = torch.as_tensor(stencil_offsets(d) - 1, device=dev)  # {-1, 0, 1}^d
    nbr_cells = ix[:, None, :] + offsets[None, :, :]  # [N, O, d]
    res = torch.tensor(grid.res, dtype=torch.int32, device=dev)
    nbr_ok = torch.all((nbr_cells >= 0) & (nbr_cells < res), dim=-1)  # [N, O]
    nbr_flat = _flat_cell(grid, nbr_cells)  # [N, O]
    slots = nbr_flat[..., None] * k + torch.arange(k, dtype=torch.int32, device=dev)
    cand_id = buckets[slots.reshape(n, -1).long()]  # [N, O*K]
    cand = packed[torch.where(cand_id >= 0, cand_id, n).long()]  # [N, O*K, d+V]

    self_id = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    cand_valid = ((cand_id >= 0) & nbr_ok.repeat_interleave(k, dim=1) & (cand_id != self_id))
    dist2 = torch.sum((cand[..., :d] - position[:, None, :]) ** 2, dim=-1)
    cand_valid = (cand_valid & (dist2 <= radius * radius) & include_mask[:, None]
                  & ok[:, None])
    return torch.sum(cand[..., d:] * cand_valid[..., None], dim=1), overflow
