"""Eigenerosion damage evolution (port of sparkl_tpu/solver/eigenerosion.py).

Ref: sparkl `src/dynamics/solver/eigenerosion.rs`: particles within one
cell width of each other (found through the 3^d cell neighbourhood) pool
m·psi_pos and m; a particle breaks (phase = 0) when factor · h · the pooled
average exceeds its threshold. The block-sparse pipeline runs it on the
cell buckets of sparse/neighbors.py; the fused pipeline pools slots with a
kernel of its own (fused/kernels.eigen_pool_fused).
"""

import torch

from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.sparse.neighbors import neighbor_pair_sums


def default_max_per_cell(dim):
    """Bucket depth: seeding puts 2 particles per cell axis (4 a cell in 2D,
    8 in 3D); twice that for compression. An overflow is detected, and the
    pipeline doubles the depth and retries."""
    return 8 if dim == 2 else 16


def evolve_eigenerosion(grid: GridParams, p, max_per_cell: int | None = None):
    """Returns (particles, bucket overflow []). Eligible particles (a crack
    factor, unbroken, not failed, active) add their eligible neighbours'
    m·psi_pos and m within h to parameter1 and parameter2 (which the
    particle update set to their own), then trip where the pooled energy
    exceeds the threshold; parameter1 becomes that energy where the
    particle has a crack factor. An overflow means a cell held more than
    max_per_cell eligible particles and the pool left some out: the caller
    regrows and retries (the reference never drops a neighbour,
    eigenerosion.rs:9-58)."""
    if max_per_cell is None:
        max_per_cell = default_max_per_cell(p.position.shape[1])
    eligible = (p.crack_propagation_factor != 0.0) & (p.phase > 0.0) & ~p.failed & p.active
    vals = torch.stack([p.mass * p.psi_pos, p.mass], dim=-1)
    pooled, overflow = neighbor_pair_sums(grid, p.position, vals, include_mask=eligible,
                                          radius=grid.cell_width, max_per_cell=max_per_cell)
    parameter1 = p.parameter1 + torch.where(eligible, pooled[:, 0], 0.0)
    parameter2 = p.parameter2 + torch.where(eligible, pooled[:, 1], 0.0)

    has_crack = p.crack_propagation_factor != 0.0
    safe2 = torch.where(parameter2 > 0.0, parameter2, 1.0)
    energy = parameter1 * p.crack_propagation_factor * grid.cell_width / safe2
    trip = has_crack & (energy > p.crack_threshold)
    return p.replace(parameter1=torch.where(has_crack, energy, parameter1),
                     phase=torch.where(trip, 0.0, p.phase)), overflow
