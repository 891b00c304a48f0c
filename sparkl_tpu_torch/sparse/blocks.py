"""Block-sparse grid structure (port of sparkl_tpu/sparse/blocks.py).

Blocks are 4^d cells; a chunk holds <= C particles of one block; a block's
8^d transfer window is the block plus its 2^d - 1 upper corner neighbours
(ref: sparkl gpu_grid.rs:281-321 `blocks_associated_to_point`). A particle
belongs to the block of its base cell round(x/h) - 1. `build_structure`
rebuilds the whole structure from the particle positions with one stable
key sort, compactions and prefix sums; its int tables come out bit-equal
to the JAX package's. Overflowing a capacity shows in the counts
(`num_blocks` etc.), which the pipeline checks on the host before any
kernel sees the structure.
"""

from dataclasses import dataclass, fields

import numpy as np
import torch

from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.math import linalg

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

    @staticmethod
    def for_particles(n, dim, occupancy=8.0, slack=2.0):
        """Heuristic initial capacities: n/occupancy particles per block."""
        c = default_chunk_size(dim)
        blocks = int(n / (cells_per_block(dim) * occupancy / 4) * slack) + 64
        chunks = int(n / c * slack) + blocks
        return BlockConfig(max_blocks=blocks, max_chunks=chunks, chunk_size=c)

    @staticmethod
    def calibrate(grid, position, active, slack=1.5):
        """Size capacities from the actual particle distribution (host-side
        numpy, once at pipeline setup), quantized so that recalibrations
        reuse shapes. The JAX package prefers a C++ counter with the same
        result; this is its numpy path."""
        pos = position.detach().cpu().numpy() if torch.is_tensor(position) else np.asarray(position)
        act = active.detach().cpu().numpy() if torch.is_tensor(active) else np.asarray(active)
        dim = pos.shape[1]
        c = default_chunk_size(dim)

        origin = np.asarray(grid.origin, np.float64)
        base = np.round((pos - origin) / grid.cell_width).astype(np.int64) - 1
        res = np.asarray(grid.res)
        ok = act & np.all((base >= 0) & (base + 2 <= res - 1), axis=-1)
        bc = base[ok] // BLOCK_SIDE
        bspace = _block_space(grid)
        key = bc[:, 0]
        for ax in range(1, dim):
            key = key * bspace[ax] + bc[:, ax]
        uniq, counts = np.unique(key, return_counts=True)
        n_blocks = len(uniq)
        n_chunks = int(np.sum(-(-counts // c)))
        # Grid blocks: owners + corner neighbours.
        coords = np.stack(np.unravel_index(uniq, bspace), axis=-1)
        corners = np.stack(
            np.meshgrid(*([[0, 1]] * dim), indexing="ij"), axis=-1
        ).reshape(-1, dim)
        cand = (coords[:, None, :] + corners[None, :, :]).reshape(-1, dim)
        in_space = np.all(cand < np.asarray(bspace), axis=-1)
        cand_keys = cand[:, 0].astype(np.int64)
        for ax in range(1, dim):
            cand_keys = cand_keys * bspace[ax] + cand[:, ax]
        n_grid = len(np.unique(cand_keys[in_space]))

        def q(x, step):
            return int(-(-int(x) // step) * step)

        return BlockConfig(
            max_blocks=q(n_blocks * slack + 16, 256),
            max_chunks=q(n_chunks * slack + 16, 512),
            chunk_size=c,
            max_grid_blocks=q(n_grid * slack + 16, 256),
        )


@dataclass(frozen=True)
class BlockStructure:
    """Per-substep sparse structure (all int32, fixed shapes). Sorted
    particle space: sorted_ids[i] is the original index of the i-th
    particle in block-key order (invalid and inactive particles sort to the
    end with the sentinel key)."""

    sorted_ids: torch.Tensor  # [N] particle order
    sorted_block: torch.Tensor  # [N] dense block id per sorted particle, or -1
    block_keys: torch.Tensor  # [MAX_BLOCKS] linear block key (sentinel pad)
    block_start: torch.Tensor  # [MAX_BLOCKS] first sorted-particle index
    block_count: torch.Tensor  # [MAX_BLOCKS] particles in block
    grid_keys: torch.Tensor  # [MAX_GRID_BLOCKS] storage-block keys (owners + corners)
    nbr_index: torch.Tensor  # [MAX_BLOCKS, 2^d] grid-table index of the corner blocks
    block_first_chunk: torch.Tensor  # [MAX_BLOCKS] first chunk id of block
    chunk_block: torch.Tensor  # [MAX_CHUNKS] dense block id (MAX_BLOCKS pad)
    chunk_start: torch.Tensor  # [MAX_CHUNKS] start in sorted-particle space
    chunk_count: torch.Tensor  # [MAX_CHUNKS] particles in chunk (<= C)
    num_blocks: torch.Tensor  # [] overflow check against MAX_BLOCKS
    num_grid_blocks: torch.Tensor  # [] overflow check against MAX_GRID_BLOCKS
    num_chunks: torch.Tensor  # []

    def tensors(self):
        return {f.name: getattr(self, f.name) for f in fields(self)}


def _block_space(grid: GridParams):
    """Number of blocks per axis covering the grid's node index space."""
    return tuple(-(-r // BLOCK_SIDE) for r in grid.res)


def _strides(bspace):
    dim = len(bspace)
    strides = [1] * dim
    for ax in range(dim - 2, -1, -1):
        strides[ax] = strides[ax + 1] * bspace[ax + 1]
    return strides


def decode_block_coords(block_keys, bspace):
    """Linear block keys -> ([*, d] block coordinates, strides)."""
    strides = _strides(bspace)
    coords = []
    rem = block_keys
    for s in strides:
        coords.append(rem // s)
        rem = rem % s
    return torch.stack(coords, dim=-1), strides


def _corners(dim, device):
    c = np.stack(np.meshgrid(*([[0, 1]] * dim), indexing="ij"), axis=-1).reshape(-1, dim)
    return torch.as_tensor(c, dtype=torch.int32, device=device)


def grid_tables(cfg: BlockConfig, block_keys, bspace, dim):
    """Grid-storage blocks (every owner block plus its 2^d upper corner
    neighbours, which need node storage even when they own no particles)
    and the neighbour index, from sorted block keys. Returns (coords,
    grid_keys, num_grid_blocks, nbr_index [MAX_BLOCKS, 2^d]); a corner
    outside the table points at MAX_GRID_BLOCKS (the trash row)."""
    dev = block_keys.device
    sentinel = int(np.prod(bspace))
    coords, strides = decode_block_coords(block_keys, bspace)
    nbr_coords = coords[:, None, :] + _corners(dim, dev)[None, :, :]
    bs = torch.tensor(bspace, dtype=torch.int32, device=dev)
    in_space = (
        torch.all(nbr_coords < bs, dim=-1)
        & torch.all(nbr_coords >= 0, dim=-1)
        & (block_keys < sentinel)[:, None]
    )
    st = torch.tensor(strides, dtype=torch.int32, device=dev)
    nbr_keys = (nbr_coords * st).sum(-1, dtype=torch.int32)
    nbr_keys = torch.where(in_space, nbr_keys, sentinel).reshape(-1)

    cand_sorted = torch.sort(nbr_keys).values
    cand_prev = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=dev),
                           cand_sorted[:-1]])
    cand_flag = (cand_sorted != cand_prev) & (cand_sorted < sentinel)
    grid_keys, num_grid_blocks = _compact_flagged(
        cand_sorted, cand_flag, cfg.max_grid_blocks, sentinel
    )

    found = torch.searchsorted(grid_keys, nbr_keys, side="left", out_int32=True)
    found = torch.clamp(found, 0, cfg.max_grid_blocks - 1)
    hit = (grid_keys[found.long()] == nbr_keys) & (nbr_keys < sentinel)
    nbr_index = torch.where(hit, found, cfg.max_grid_blocks).reshape(
        cfg.max_blocks, 2**dim
    )
    return coords, grid_keys, num_grid_blocks, nbr_index


def particle_block_key(grid: GridParams, position, valid):
    """Linear block key per particle, and whether its stencil lies inside
    the grid; the sentinel key for invalid or out-of-grid particles."""
    dev = position.device
    origin = torch.tensor(grid.origin, dtype=position.dtype, device=dev)
    xg = linalg.div_const(position - origin, grid.cell_width)
    base = torch.round(xg).to(torch.int32) - 1
    res = torch.tensor(grid.res, dtype=torch.int32, device=dev)
    ok = torch.all((base >= 0) & (base + 2 <= res - 1), dim=-1) & valid
    bc = base // BLOCK_SIDE
    bspace = _block_space(grid)
    key = bc[..., 0]
    for ax in range(1, len(bspace)):
        key = key * bspace[ax] + bc[..., ax]
    sentinel = int(np.prod(bspace))
    return torch.where(ok, key, sentinel).to(torch.int32), ok


def build_structure(grid: GridParams, cfg: BlockConfig, position, valid) -> BlockStructure:
    """Sort particles by block key (stable, as lax.sort_key_val is: the
    particle order within a block depends on it) and compact the sorted
    keys into the block, grid-block and chunk tables."""
    n, dim = position.shape
    dev = position.device
    c = cfg.chunk_size
    bspace = _block_space(grid)
    sentinel = int(np.prod(bspace))
    i32 = dict(dtype=torch.int32, device=dev)

    key, _ = particle_block_key(grid, position, valid)
    sorted_key, order = torch.sort(key, stable=True)
    sorted_ids = order.to(torch.int32)

    # Run starts in the sorted key sequence.
    prev = torch.cat([torch.full((1,), -1, **i32), sorted_key[:-1]])
    is_valid = sorted_key < sentinel
    flag = (sorted_key != prev) & is_valid
    dense_id = torch.cumsum(flag.to(torch.int32), dim=0, dtype=torch.int32) - 1
    sorted_block = torch.where(is_valid, dense_id, -1)

    block_keys, num_blocks = _compact_flagged(sorted_key, flag, cfg.max_blocks, sentinel)
    block_start, _ = _compact_flagged(torch.arange(n, **i32), flag, cfg.max_blocks, n)
    num_valid = is_valid.sum(dtype=torch.int32)
    next_start = torch.cat([block_start[1:], torch.full((1,), n, **i32)])
    next_start = torch.minimum(next_start, num_valid)
    block_count = torch.clamp(next_start - torch.minimum(block_start, num_valid), min=0)

    _, grid_keys, num_grid_blocks, nbr_index = grid_tables(cfg, block_keys, bspace, dim)

    # Dispatch chunks: block b owns ceil(count / c) chunks.
    nchunks_per_block = -((-block_count) // c)
    chunk_base = torch.cat([
        torch.zeros((1,), **i32),
        torch.cumsum(nchunks_per_block, dim=0, dtype=torch.int32)[:-1],
    ])
    num_chunks = nchunks_per_block.sum(dtype=torch.int32)
    cid = torch.arange(cfg.max_chunks, **i32)
    blk_of_chunk = torch.searchsorted(chunk_base, cid, side="right", out_int32=True) - 1
    blk_of_chunk = torch.clamp(blk_of_chunk, 0, cfg.max_blocks - 1)
    bl = blk_of_chunk.long()
    local_chunk = cid - chunk_base[bl]
    active_chunk = cid < num_chunks
    chunk_start = block_start[bl] + local_chunk * c
    chunk_count = torch.clamp(block_count[bl] - local_chunk * c, 0, c)

    return BlockStructure(
        sorted_ids=sorted_ids,
        sorted_block=sorted_block,
        block_keys=block_keys,
        block_start=block_start,
        block_count=block_count,
        grid_keys=grid_keys,
        nbr_index=nbr_index,
        block_first_chunk=chunk_base,
        chunk_block=torch.where(active_chunk, blk_of_chunk, cfg.max_blocks),
        chunk_start=torch.where(active_chunk, chunk_start, 0),
        chunk_count=torch.where(active_chunk, chunk_count, 0),
        num_blocks=num_blocks,
        num_grid_blocks=num_grid_blocks,
        num_chunks=num_chunks,
    )


def block_node_positions(grid: GridParams, block_keys):
    """World positions of every node of every block: [MAX_BLOCKS, 4^d, d]."""
    dim = grid.dim
    dev = block_keys.device
    bc, _ = decode_block_coords(block_keys, _block_space(grid))
    bc = bc.to(torch.float32)
    rng = np.arange(BLOCK_SIDE)
    local = np.stack(np.meshgrid(*([rng] * dim), indexing="ij"), axis=-1).reshape(-1, dim)
    local = torch.as_tensor(local, dtype=torch.float32, device=dev)
    origin = torch.tensor(grid.origin, dtype=torch.float32, device=dev)
    return origin + (bc[:, None, :] * BLOCK_SIDE + local[None, :, :]) * grid.cell_width


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
