"""Block-sparse APIC transfers (port of sparkl_tpu/sparse/transfer.py).

A chunk's window image covers the 8^d cells of its owner block and the
2^d - 1 upper corner blocks. merge_images_to_grid sums images into the
block node table [MAX_GRID_BLOCKS + 1, F * 4^d] (last row = trash) with one
of the two merge kernels, which read the images as the P2G kernels wrote
them and write each node row once (fused/kernels.merge_blocks, the
per-owner-block segment sums and the 2^d inverse-corner gather of the JAX
package's _merge_gather; fused/kernels.merge_scatter, each node row's
updates in a fixed order); gather_grid_windows is its inverse read.

p2g_images and g2p_from_windows are the JAX package's einsum form of the
window transfers: per group of chunks, the dense [C, 8^d] tensor-product
weight matrices, contracted with batched matrix products. The pipeline's
transfers run the window kernels instead (ops/transfer_kernels.py); its
fluid volume pass runs the einsum form, as the JAX package does, and the
tests hold the kernels' plain versions against it as a second, independent
witness. gather_slot_rows maps slot outputs back to particle order.
"""

import functools

import numpy as np
import torch

from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.math import linalg
from sparkl_tpu_torch.math.kernel import inv_d as kernel_inv_d, quadratic_weights_1d
from sparkl_tpu_torch.sparse.blocks import (
    BLOCK_SIDE,
    BlockConfig,
    cells_per_block,
    region_cells,
    region_maps,
    region_side,
)


def gather_chunks(cfg: BlockConfig, structure, *arrays):
    """Gather particle arrays (original order) into chunk-slot layout
    [D, C, ...] through sorted_ids. Returns (slot_valid [D, C] bool,
    gathered arrays...); invalid slots read row 0 (masked by slot_valid)."""
    d_, c = cfg.max_chunks, cfg.chunk_size
    lanes = torch.arange(c, dtype=torch.int32, device=structure.chunk_start.device)[None, :]
    valid = lanes < structure.chunk_count[:, None]
    src = torch.where(valid, structure.chunk_start[:, None] + lanes, 0)
    src = structure.sorted_ids[src.reshape(-1).long()].long()
    return (valid,) + tuple(a[src].reshape((d_, c) + a.shape[1:]) for a in arrays)


def window_coords(grid: GridParams, pos):
    """Per-axis region weights and dpt values for positions [..., d]:
    (w_ax [..., d, 8], dpt_ax [..., d, 8] in world units). w_ax[..., r] is
    the B-spline weight of region coordinate r (zero outside the 3-cell
    stencil); dpt_ax[..., r] = (r - px) * h, px the position in region
    units."""
    h = grid.cell_width
    dev = pos.device
    origin = torch.tensor(grid.origin, dtype=torch.float32, device=dev)
    xg = linalg.div_const(pos - origin, h)
    base = torch.round(xg).to(torch.int32) - 1
    fx = xg - base.to(torch.float32)
    lb = base - (base // BLOCK_SIDE) * BLOCK_SIDE  # 0..3 (floor division)
    px = lb.to(torch.float32) + fx
    w1 = quadratic_weights_1d(fx)  # [..., d, 3]
    r = torch.arange(region_side(), dtype=torch.int32, device=dev)
    rel = r - lb[..., None]  # [..., d, 8]
    w_ax = w1[..., 0:1] * (rel == 0) + w1[..., 1:2] * (rel == 1) + w1[..., 2:3] * (rel == 2)
    dpt_ax = (r.to(torch.float32) - px[..., None]) * h
    return w_ax, dpt_ax


def _outer(parts):
    """Tensor product of per-axis [..., 8] rows -> [..., 8^d], (a*b)*c."""
    if len(parts) == 2:
        w = parts[0][..., :, None] * parts[1][..., None, :]
    else:
        w = parts[0][..., :, None, None] * parts[1][..., None, :, None] * parts[2][..., None, None, :]
    return w.reshape(w.shape[:-len(parts)] + (-1,))


def _outer_weights(w_ax):
    """Tensor-product region weights: [D, C, d, 8] -> [D, C, 8^d]."""
    return _outer([w_ax[:, :, ax, :] for ax in range(w_ax.shape[2])])


def _outer_weights_d(w_ax, dpt_ax, axis):
    """Like _outer_weights but with axis `axis` weighted by dpt."""
    return _outer([w_ax[:, :, ax, :] * dpt_ax[:, :, ax, :] if ax == axis else w_ax[:, :, ax, :]
                   for ax in range(w_ax.shape[2])])


def p2g_images(grid: GridParams, cfg: BlockConfig, structure, position, mass, velocity,
               affine, psi_mass, psi_mom, group_size=256, with_psi=True):
    """Per-chunk 8^d window images [D, F, 8^d] with F = 1+d(+2) channels
    (mass, momentum[, psi_momentum, psi_mass]), row-major cells."""
    dim = grid.dim
    valid, pos, m, v, a_mat, psi_m, psi_mo = gather_chunks(
        cfg, structure, position, mass, velocity, affine, psi_mass, psi_mom
    )
    vf = valid.to(torch.float32)
    m = m * vf  # zero padded slots
    parts = [m[:, None, :], m[:, None, :] * v.permute(0, 2, 1)]
    if with_psi:
        parts += [(psi_mo * vf)[:, None, :], (psi_m * vf)[:, None, :]]
    p0 = torch.cat(parts, dim=1)  # [D, F, C]
    a_fm = a_mat.permute(0, 2, 3, 1)  # [D, d(i), d(j), C]
    out = []
    for g0 in range(0, cfg.max_chunks, group_size):
        sl = slice(g0, g0 + group_size)
        w_ax, dpt_ax = window_coords(grid, pos[sl])
        vg = vf[sl][..., None]
        img = torch.bmm(p0[sl], _outer_weights(w_ax) * vg)
        for j in range(dim):
            wd = _outer_weights_d(w_ax, dpt_ax, j) * vg
            img[:, 1 : 1 + dim] += torch.bmm(a_fm[sl, :, j, :], wd)
        out.append(img)
    return torch.cat(out, dim=0)


def g2p_from_windows(grid: GridParams, cfg: BlockConfig, structure, position, windows,
                     group_size=256, with_psi=True):
    """APIC gather from window images [D, d(+1), 8^d] (velocity [+ psi
    ratio]). Returns per chunk slot (velocity [D, C, d], velocity_gradient
    [D, C, d, d], its trace [D, C], psi [D, C], slot_valid [D, C])."""
    dim = grid.dim
    invd = kernel_inv_d(grid.cell_width)
    valid, pos = gather_chunks(cfg, structure, position)
    vel_psi, grad, det = [], [], []
    for g0 in range(0, cfg.max_chunks, group_size):
        sl = slice(g0, g0 + group_size)
        w_ax, dpt_ax = window_coords(grid, pos[sl])
        win = windows[sl]
        vel_psi.append(torch.bmm(win, _outer_weights(w_ax).transpose(1, 2)))
        grads, tr = [], 0.0
        for j in range(dim):
            wd = _outer_weights_d(w_ax, dpt_ax, j)
            gj = torch.bmm(win[:, :dim], wd.transpose(1, 2))  # [G, d(i), C]
            grads.append(gj)
            tr = tr + gj[:, j, :]
        grad.append(torch.stack(grads, dim=2) * invd)
        det.append(tr * invd)
    vel_psi = torch.cat(vel_psi, dim=0)
    det = torch.cat(det, dim=0)
    psi = vel_psi[:, dim, :] if with_psi else torch.zeros_like(det)
    return (vel_psi[:, :dim, :].permute(0, 2, 1), torch.cat(grad, dim=0).permute(0, 3, 1, 2),
            det, psi, valid)


def slot_flat_index(cfg: BlockConfig, structure, inv_perm):
    """[N] flat chunk-slot index of every particle (original order) and
    whether it has one: particle i sits at sorted position s = inv_perm[i]
    in block b, at slot (block_first_chunk[b] + rank // C, rank % C) with
    rank = s - block_start[b]."""
    c = cfg.chunk_size
    s = inv_perm.long()
    b = structure.sorted_block[s]
    bsafe = torch.clamp(b, 0, cfg.max_blocks - 1).long()
    rank = inv_perm - structure.block_start[bsafe]
    chunk = structure.block_first_chunk[bsafe] + rank // c
    flat = torch.clamp(chunk, 0, cfg.max_chunks - 1) * c + rank % c
    ok = b >= 0
    return torch.where(ok, flat, 0), ok


def gather_slot_rows(cfg: BlockConfig, structure, inv_perm, slot_rows):
    """One row gather mapping packed slot outputs [D*C, F] back to
    particles [N, F] (zero rows for particles without a slot)."""
    flat, ok = slot_flat_index(cfg, structure, inv_perm)
    return torch.where(ok[:, None], slot_rows[flat.long()], 0.0)


def scatter_slots_to_particles(cfg: BlockConfig, structure, inv_perm, *slot_arrays):
    """Chunk-slot arrays [D, C, ...] -> particle order, one gather each
    (zero for particles without a slot)."""
    flat, ok = slot_flat_index(cfg, structure, inv_perm)
    out = []
    for a in slot_arrays:
        val = a.reshape((cfg.max_chunks * cfg.chunk_size,) + a.shape[2:])[flat.long()]
        out.append(torch.where(ok.reshape((-1,) + (1,) * (val.dim() - 1)), val, 0.0))
    return tuple(out)


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


def _chunk_corners(structure):
    """[D, 2^d] node-table rows of every chunk's window blocks. A padding
    chunk's block id (MAX_BLOCKS) is clamped into nbr_index, as an XLA
    gather clamps it: the block-sparse nbr_index has no trash row, and a
    padding chunk adds a zero image / reads a window no slot uses."""
    nbr = structure.nbr_index
    return nbr[torch.clamp(structure.chunk_block, max=nbr.shape[0] - 1).long()]


def scatter_plan(cfg, structure):
    """Index plan of the scatter merge for `structure`: the flat (chunk,
    corner) update ids stably sorted by destination node-table row, so in
    ascending update order within a row ([D·2^d] i32), and each row's
    segment start ([MAX_GRID_BLOCKS + 2] i32). Built once per structure.
    Dead chunks' updates (their images are zero) and the trash row's are
    left out, so the trash row sums to zero, as the merge then sets it: a
    row otherwise gathers the thousands of padding updates alone."""
    dest = _chunk_corners(structure).reshape(-1)
    trash = cfg.max_grid_blocks
    chunk = torch.arange(dest.shape[0], device=dest.device) // (dest.shape[0] // cfg.max_chunks)
    dest = torch.where((chunk < structure.num_chunks) & (dest < trash), dest, trash)
    order = torch.sort(dest, stable=True).indices
    rows = torch.arange(trash + 2, dtype=dest.dtype, device=dest.device)
    starts = torch.searchsorted(dest[order], rows)
    starts[trash + 1] = starts[trash]
    return order.to(torch.int32), starts.to(torch.int32)


def corner_owner(cfg: BlockConfig, structure):
    """[MAX_GRID_BLOCKS + 1, 2^d] i32: the owner block of corner k of each
    node-table row (max_blocks where none), the inverse of nbr_index, as
    the JAX package's _merge_gather builds it (`co`). Unique per (g, k)
    except on the trash row, which the merges zero. Built once per
    structure (the fused pipeline's grid cache)."""
    nbr = structure.nbr_index.long()  # [MB (+ 1), 2^d]
    dev = nbr.device
    ncorners = nbr.shape[1]
    co = torch.full((cfg.max_grid_blocks + 1, ncorners), cfg.max_blocks, dtype=torch.int32,
                    device=dev)
    bidx = torch.clamp(torch.arange(nbr.shape[0], dtype=torch.int32, device=dev),
                       max=cfg.max_blocks)
    kidx = torch.arange(ncorners, device=dev)
    co[nbr, kidx[None, :].expand_as(nbr)] = bidx[:, None].expand_as(nbr)
    return co


def merge_images_to_grid(grid: GridParams, cfg: BlockConfig, structure, images,
                         cell_order=None, force_scatter=False, plan=None, owner=None):
    """images [D, F, 8^d] -> the node table [MAX_GRID_BLOCKS + 1, F * 4^d]
    (the trash row, the last, zero), in one kernel launch on the card. The
    gather form (per-owner-block segment sums, then the 2^d owners of each
    node row in corner order; fused/kernels.merge_blocks) runs unless
    `force_scatter` (each row's updates in ascending flat (chunk, corner)
    order; fused/kernels.merge_scatter). The gather form cuts a block
    denser than MERGE_KMAX chunks; its caller checks for one (the fused
    pipeline at each resort and span start) and pins the scatter form.
    cell_order: ZMAJOR_ORDER_3D for the fused 3D kernels' image layout, or
    None for row-major. plan / owner: the structure's scatter_plan /
    corner_owner, if the caller keeps them (built here otherwise)."""
    from sparkl_tpu_torch.fused import kernels as FK

    if cell_order is not None and cell_order is not ZMAJOR_ORDER_3D:
        raise NotImplementedError("cell_order must be None or ZMAJOR_ORDER_3D")
    zmajor = cell_order is not None
    if force_scatter:
        order, starts = scatter_plan(cfg, structure) if plan is None else plan
        return FK.merge_scatter(images, order, starts, structure.num_grid_blocks, zmajor)
    return FK.merge_blocks(
        images, structure.block_first_chunk, structure.block_num_chunks,
        corner_owner(cfg, structure) if owner is None else owner, structure.num_grid_blocks,
        zmajor,
    )


def gather_grid_windows(grid: GridParams, cfg: BlockConfig, structure, node_fields,
                        cell_order=None):
    """Inverse of merge: node_fields [MGB+1, F*4^d] -> windows [D, F, 8^d]."""
    return windows_from_corners(grid, cfg, _chunk_corners(structure), node_fields, cell_order)


def windows_from_corners(grid: GridParams, cfg: BlockConfig, corners, node_fields,
                         cell_order=None):
    """gather_grid_windows on a chunk corner map [D, 2^d] (_chunk_corners
    of the structure)."""
    dim = grid.dim
    cpb = cells_per_block(dim)
    nf = node_fields.shape[1] // cpb
    rows = node_fields[corners.reshape(-1).long()]  # [D*2^d, F*cpb]
    comb = _window_comb(dim, nf, cell_order is not None, node_fields.device)
    flat = rows.reshape(cfg.max_chunks, -1)
    return flat[:, comb].reshape(cfg.max_chunks, nf, region_cells(dim))
