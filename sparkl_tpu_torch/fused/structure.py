"""Off-by-two block structure for the fused pipeline (port of
sparkl_tpu/fused/structure.py; the int tables come out bit-equal).

Block coordinate bc = floor((c - 2)/4) + 1 with c = round(x/h): a sorted
particle's base cell sits at window offset 1..4 of its chunk's 8-cell
window, which leaves +-1 cell of drift before the structure must be
rebuilt (ref: sparkl gpu_grid.rs:271-279, particle.rs
`associated_cell_index_in_block_off_by_two`). Active particles outside the
grid fill tail chunks after the valid ones, routed to the trash grid block.
"""

from dataclasses import dataclass, fields

import numpy as np
import torch

from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.math import linalg
from sparkl_tpu_torch.sparse.blocks import (
    BLOCK_SIDE,
    BlockConfig,
    _compact_flagged,
    decode_block_coords,
    default_chunk_size,
    grid_tables,
)


def block_space_ob2(grid: GridParams):
    """Blocks per axis in the off-by-two space: bc in [0, (res-4)//4 + 1]."""
    return tuple((r - 4) // BLOCK_SIDE + 2 for r in grid.res)


@dataclass(frozen=True)
class SlotStructure:
    """Fixed-shape sparse structure of a slot population (all int32)."""

    block_keys: torch.Tensor  # [MAX_BLOCKS] (sentinel pad)
    grid_keys: torch.Tensor  # [MAX_GRID_BLOCKS] owners + corners
    nbr_index: torch.Tensor  # [MAX_BLOCKS + 1, 2^d] (last row = trash)
    chunk_block: torch.Tensor  # [MAX_CHUNKS] (MAX_BLOCKS for tail/pad)
    chunk_count: torch.Tensor  # [MAX_CHUNKS] particles in chunk
    chunk_origin: torch.Tensor  # [MAX_CHUNKS, d] window origin cell 4(bc-1)
    block_first_chunk: torch.Tensor  # [MAX_BLOCKS]
    block_num_chunks: torch.Tensor  # [MAX_BLOCKS]
    num_blocks: torch.Tensor  # [] overflow check
    num_grid_blocks: torch.Tensor  # []
    num_chunks: torch.Tensor  # [] valid + tail chunks

    def tensors(self):
        return {f.name: getattr(self, f.name) for f in fields(self)}


def particle_block_key_ob2(grid: GridParams, position, valid):
    """Off-by-two linear block key; `ok` = stencil fully inside the grid."""
    dev = position.device
    origin = torch.tensor(grid.origin, dtype=torch.float32, device=dev)
    xg = linalg.div_const(position - origin, grid.cell_width)
    c = torch.round(xg).to(torch.int32)  # base + 1
    res = torch.tensor(grid.res, dtype=torch.int32, device=dev)
    ok = torch.all((c >= 1) & (c <= res - 2), dim=-1) & valid
    bc = (c - 2) // BLOCK_SIDE + 1
    bspace = block_space_ob2(grid)
    key = bc[..., 0]
    for ax in range(1, len(bspace)):
        key = key * bspace[ax] + bc[..., ax]
    sentinel = int(np.prod(bspace))
    return torch.where(ok, key, sentinel), ok


def _grid_tables(cfg: BlockConfig, block_keys, bspace, dim):
    """sparse.blocks.grid_tables with a trash row appended to nbr_index
    (the row of tail and padding chunks)."""
    coords, grid_keys, num_grid_blocks, nbr_index = grid_tables(cfg, block_keys, bspace, dim)
    trash = torch.full((1, 2**dim), cfg.max_grid_blocks, dtype=torch.int32,
                       device=block_keys.device)
    return coords, grid_keys, num_grid_blocks, torch.cat([nbr_index, trash], dim=0)


def build_slot_structure(grid: GridParams, cfg: BlockConfig, position, valid, occupied):
    """Sort + compact the slot population into blocks / chunks.

    position [N, d]; valid = active & in-grid (owns a block); occupied =
    holds a real particle (valid or out-of-grid debris -> tail chunks).
    Returns (structure, sort_order [N] i32, chunk_start [D] i32), with
    sort_order[i] the source index of sorted position i (valid first, tail
    second, empty last). The key sort is stable, as lax.sort_key_val is:
    the slot order depends on it."""
    n, dim = position.shape
    dev = position.device
    c = cfg.chunk_size
    bspace = block_space_ob2(grid)
    sentinel = int(np.prod(bspace))
    i32 = dict(dtype=torch.int32, device=dev)

    key, _ = particle_block_key_ob2(grid, position, valid)
    key = torch.where(
        valid, key, torch.where(occupied, sentinel, sentinel + 1).to(torch.int32)
    )
    sorted_key, order = torch.sort(key, stable=True)
    sort_order = order.to(torch.int32)

    prev = torch.cat([torch.full((1,), -1, **i32), sorted_key[:-1]])
    is_valid = sorted_key < sentinel
    flag = (sorted_key != prev) & is_valid

    block_keys, num_blocks = _compact_flagged(sorted_key, flag, cfg.max_blocks, sentinel)
    pos_idx = torch.arange(n, **i32)
    block_start, _ = _compact_flagged(pos_idx, flag, cfg.max_blocks, n)
    num_valid = is_valid.sum(dtype=torch.int32)
    num_occupied = (sorted_key <= sentinel).sum(dtype=torch.int32)
    next_start = torch.cat([block_start[1:], torch.full((1,), n, **i32)])
    next_start = torch.minimum(next_start, num_valid)
    block_count = torch.clamp(next_start - torch.minimum(block_start, num_valid), min=0)

    coords, grid_keys, num_grid_blocks, nbr_index = _grid_tables(
        cfg, block_keys, bspace, dim
    )

    # Valid chunks (<= C particles of one block) followed by tail chunks.
    nchunks_per_block = -((-block_count) // c)
    chunk_base = torch.cat([
        torch.zeros((1,), **i32),
        torch.cumsum(nchunks_per_block, dim=0, dtype=torch.int32)[:-1],
    ])
    num_valid_chunks = nchunks_per_block.sum(dtype=torch.int32)
    n_tail = num_occupied - num_valid
    num_chunks = num_valid_chunks + (-((-n_tail) // c))

    cid = torch.arange(cfg.max_chunks, **i32)
    blk_of_chunk = torch.searchsorted(chunk_base, cid, side="right", out_int32=True) - 1
    blk_of_chunk = torch.clamp(blk_of_chunk, 0, cfg.max_blocks - 1)
    bl = blk_of_chunk.long()
    local_chunk = cid - chunk_base[bl]
    is_valid_chunk = cid < num_valid_chunks
    is_tail_chunk = (~is_valid_chunk) & (cid < num_chunks)

    v_start = block_start[bl] + local_chunk * c
    v_count = torch.clamp(block_count[bl] - local_chunk * c, 0, c)
    t_local = cid - num_valid_chunks
    t_start = num_valid + t_local * c
    t_count = torch.clamp(n_tail - t_local * c, 0, c)

    chunk_start = torch.where(
        is_valid_chunk, v_start, torch.where(is_tail_chunk, t_start, 0)
    )
    chunk_count = torch.where(
        is_valid_chunk, v_count, torch.where(is_tail_chunk, t_count, 0)
    )
    chunk_block = torch.where(is_valid_chunk, blk_of_chunk, cfg.max_blocks)

    blk_coords = coords[torch.clamp(chunk_block, 0, cfg.max_blocks - 1).long()]
    chunk_origin = torch.where(
        is_valid_chunk[:, None], (blk_coords - 1) * BLOCK_SIDE, 0
    ).to(torch.int32)

    structure = SlotStructure(
        block_keys=block_keys,
        grid_keys=grid_keys,
        nbr_index=nbr_index,
        chunk_block=chunk_block,
        chunk_count=chunk_count,
        chunk_origin=chunk_origin,
        block_first_chunk=chunk_base,
        block_num_chunks=nchunks_per_block,
        num_blocks=num_blocks,
        num_grid_blocks=num_grid_blocks,
        num_chunks=num_chunks,
    )
    return structure, sort_order, chunk_start


def slot_key_rows(grid: GridParams, cfg: BlockConfig, position, valid, occupied):
    """Effective sort keys of a slot population, in slot layout [D, C]."""
    sentinel = int(np.prod(block_space_ob2(grid)))
    key, _ = particle_block_key_ob2(grid, position, valid)
    key = torch.where(
        valid, key, torch.where(occupied, sentinel, sentinel + 1).to(torch.int32)
    )
    return key.reshape(cfg.max_chunks, cfg.chunk_size)


def detect_chunk_relabel(grid: GridParams, cfg: BlockConfig, key_eff, occupied):
    """Would the stable sort of the new keys reproduce the current slot
    order verbatim? Then the resort is a pure relabeling of chunks
    (structure_from_chunk_keys). Conditions: every chunk homogeneous with
    lane 0 occupied, occupied lanes a prefix, chunk keys non-decreasing,
    and equal adjacent non-empty keys only after a full chunk. Returns
    (ok [] bool, chunk_key [D] i32, occ_count [D] i32)."""
    c = cfg.chunk_size
    sentinel = int(np.prod(block_space_ob2(grid)))
    occ_any = torch.any(occupied, dim=1)
    occ_count = occupied.sum(dim=1, dtype=torch.int32)
    lane0 = key_eff[:, 0]
    homog = torch.all(
        torch.where(occupied, key_eff == lane0[:, None], True), dim=1
    ) & (occupied[:, 0] | ~occ_any)
    occ_i = occupied.to(torch.int32)
    prefix = torch.all(occ_i[:, :-1] >= occ_i[:, 1:], dim=1)
    ckey = torch.where(occ_any, lane0, sentinel + 1)
    mono = torch.all(ckey[:-1] <= ckey[1:])
    full_rule = torch.all(
        (ckey[:-1] != ckey[1:]) | (ckey[:-1] > sentinel) | (occ_count[:-1] == c)
    )
    ok = torch.all(homog & prefix) & mono & full_rule
    return ok, ckey, occ_count


def structure_from_chunk_keys(grid: GridParams, cfg: BlockConfig, ckey, occ_count):
    """SlotStructure of a kept slot layout from its per-chunk keys alone;
    valid only when detect_chunk_relabel passed (field for field what
    build_slot_structure would produce)."""
    dim = grid.dim
    dev = ckey.device
    d_ = cfg.max_chunks
    bspace = block_space_ob2(grid)
    sentinel = int(np.prod(bspace))

    is_valid_chunk = ckey < sentinel
    is_tail_chunk = ckey == sentinel
    num_chunks = (is_valid_chunk | is_tail_chunk).sum(dtype=torch.int32)
    num_valid_chunks = is_valid_chunk.sum(dtype=torch.int32)

    prev = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=dev), ckey[:-1]])
    newblk = (ckey != prev) & is_valid_chunk
    block_keys, num_blocks = _compact_flagged(ckey, newblk, cfg.max_blocks, sentinel)
    cid = torch.arange(d_, dtype=torch.int32, device=dev)
    block_first_chunk, _ = _compact_flagged(cid, newblk, cfg.max_blocks, num_valid_chunks)
    nxt = torch.cat([block_first_chunk[1:], num_valid_chunks[None]])
    block_num_chunks = torch.clamp(nxt - block_first_chunk, min=0)

    runidx = torch.cumsum(newblk.to(torch.int32), dim=0, dtype=torch.int32) - 1
    chunk_block = torch.where(
        is_valid_chunk, torch.clamp(runidx, 0, cfg.max_blocks - 1), cfg.max_blocks
    )

    _, grid_keys, num_grid_blocks, nbr_index = _grid_tables(cfg, block_keys, bspace, dim)

    ck_coords, _ = decode_block_coords(ckey, bspace)
    chunk_origin = torch.where(
        is_valid_chunk[:, None], (ck_coords - 1) * BLOCK_SIDE, 0
    ).to(torch.int32)

    return SlotStructure(
        block_keys=block_keys,
        grid_keys=grid_keys,
        nbr_index=nbr_index,
        chunk_block=chunk_block,
        chunk_count=occ_count,
        chunk_origin=chunk_origin,
        block_first_chunk=block_first_chunk,
        block_num_chunks=block_num_chunks,
        num_blocks=num_blocks,
        num_grid_blocks=num_grid_blocks,
        num_chunks=num_chunks,
    )


def slot_source_index(cfg: BlockConfig, sort_order, chunk_start, chunk_count):
    """[D*C] source index (into the pre-sort population) per slot + validity:
    slot (chunk j, lane l) holds sorted position chunk_start[j] + l when
    l < chunk_count[j]; empty slots read source 0 and are masked."""
    lanes = torch.arange(cfg.chunk_size, dtype=torch.int32, device=sort_order.device)[None, :]
    valid = lanes < chunk_count[:, None]
    src_sorted = torch.where(valid, chunk_start[:, None] + lanes, 0)
    return sort_order[src_sorted.reshape(-1).long()], valid.reshape(-1)


def block_node_positions_ob2(grid: GridParams, grid_keys):
    """World positions of every node of every ob2 block: [MGB, 4^d, d].
    Block bc's node storage covers the 4-aligned cells [4(bc-1), 4bc)."""
    dim = grid.dim
    dev = grid_keys.device
    bc, _ = decode_block_coords(grid_keys, block_space_ob2(grid))
    bc = bc.to(torch.float32)
    rng = np.arange(BLOCK_SIDE)
    local = np.stack(np.meshgrid(*([rng] * dim), indexing="ij"), axis=-1).reshape(-1, dim)
    local = torch.as_tensor(local, dtype=torch.float32, device=dev)
    origin = torch.tensor(grid.origin, dtype=torch.float32, device=dev)
    return origin + ((bc[:, None, :] - 1.0) * BLOCK_SIDE + local[None, :, :]) * grid.cell_width


def calibrate_ob2(grid: GridParams, position, active, slack=1.5):
    """Size BlockConfig capacities from the actual distribution, in ob2
    space (host-side numpy, once at setup), with tail-chunk headroom."""
    pos = position.detach().cpu().numpy() if torch.is_tensor(position) else np.asarray(position)
    act = active.detach().cpu().numpy() if torch.is_tensor(active) else np.asarray(active)
    dim = pos.shape[1]
    c = default_chunk_size(dim)
    n = pos.shape[0]

    origin = np.asarray(grid.origin, np.float64)
    cc = np.round((pos - origin) / grid.cell_width).astype(np.int64)
    res = np.asarray(grid.res)
    ok = act & np.all((cc >= 1) & (cc <= res - 2), axis=-1)
    bc = (cc[ok] - 2) // BLOCK_SIDE + 1
    bspace = block_space_ob2(grid)
    key = bc[:, 0]
    for ax in range(1, dim):
        key = key * bspace[ax] + bc[:, ax]
    uniq, counts = np.unique(key, return_counts=True)
    n_blocks = max(len(uniq), 1)
    n_chunks = int(np.sum(-(-counts // c))) if len(counts) else 1
    coords = (np.stack(np.unravel_index(uniq, bspace), axis=-1) if len(uniq)
              else np.zeros((0, dim), np.int64))
    corners = np.stack(np.meshgrid(*([[0, 1]] * dim), indexing="ij"), axis=-1).reshape(-1, dim)
    cand = (coords[:, None, :] + corners[None, :, :]).reshape(-1, dim)
    in_space = np.all(cand < np.asarray(bspace), axis=-1)
    cand_keys = cand[:, 0].astype(np.int64)
    for ax in range(1, dim):
        cand_keys = cand_keys * bspace[ax] + cand[:, ax]
    n_grid = max(len(np.unique(cand_keys[in_space])), 1)

    tail = -(-max(int(0.02 * n), 64) // c) + 2  # debris leaving the grid later

    def q(x, step):
        return int(-(-int(x) // step) * step)

    return BlockConfig(
        max_blocks=q(n_blocks * slack + 16, 256),
        max_chunks=q(n_chunks * slack + tail + 16, 512),
        chunk_size=c,
        max_grid_blocks=q(n_grid * slack + 16, 256),
    )
