"""The block-sparse pipeline's window transfers: P2G slot data -> window
images and G2P windows -> per-slot gathers, each a hand-written CUDA kernel
(csrc/window_kernels.cu) with its plain PyTorch version beside it (port of
sparkl_tpu/ops/transfer_kernels.py).

Slot data is packed f-major per chunk, [D, NF_IN, C]: position (d rows),
mass, velocity (d), affine (d*d, row-major), psi_mass, psi_momentum, zero
padding to a multiple of 8 rows (NF_IN = 24 in 3D, 16 in 2D). Padded slots
are zeroed when gathered, so the transfers need no mask. Windows and images
use row-major region cells (q = x*64 + y*8 + z in 3D, q = x*8 + y in 2D).
The kernels take C = 128 slots per chunk in 3D and C = 64 in 2D (the
block structure's default chunk sizes); the wrappers refuse any other.

A wrapper runs the plain version when its tensors lie on the CPU and
launches the kernel when they lie on a CUDA device; anything else raises.
There is no fallback from a kernel to its plain version. Each wrapper
counts its kernel launches in LAUNCHES (the CPU path counts nothing).
"""

import torch

from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.cuda_build import check_tensor, launch, route, stream_ptr
from sparkl_tpu_torch.math import linalg
from sparkl_tpu_torch.math.kernel import inv_d as kernel_inv_d
from sparkl_tpu_torch.sparse.blocks import (
    BLOCK_SIDE,
    default_chunk_size,
    region_cells,
    region_side,
)

# Kernel launches per wrapper since the last reset_launch_counts().
LAUNCHES = {"p2g_windows": 0, "g2p_windows": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def packed_rows(dim):
    """Rows of the packed slot data, rounded up to the f32 sublane tile (8)."""
    n = 2 * dim + dim * dim + 3
    return -(-n // 8) * 8


def pack_p2g_inputs(position, mass, velocity, affine, psi_mass, psi_mom):
    """Packed per-particle transfer fields [N, NF_IN]."""
    n, d = position.shape
    cols = [position[:, ax] for ax in range(d)]
    cols.append(mass)
    cols += [velocity[:, ax] for ax in range(d)]
    cols += [affine[:, i, j] for i in range(d) for j in range(d)]
    cols += [psi_mass, psi_mom]
    cols += [torch.zeros_like(mass)] * (packed_rows(d) - len(cols))
    return torch.stack(cols, dim=1)


def gather_slot_data(cfg, structure, packed):
    """[N, NF] packed fields -> f-major chunk-slot layout [D, NF, C];
    padded slots (past chunk_count) are zeroed."""
    d_, c = cfg.max_chunks, cfg.chunk_size
    lanes = torch.arange(c, dtype=torch.int32, device=packed.device)[None, :]
    valid = lanes < structure.chunk_count[:, None]
    src = torch.where(valid, structure.chunk_start[:, None] + lanes, 0)
    src = structure.sorted_ids[src.reshape(-1).long()]
    slots = packed[src.long()].reshape(d_, c, packed.shape[1])
    slots = slots * valid.to(torch.float32)[..., None]
    return slots.transpose(1, 2).contiguous()


def _grid_args(grid: GridParams):
    origin = [float(o) for o in grid.origin] + [0.0] * (3 - grid.dim)
    return origin + [grid.cell_width, kernel_inv_d(grid.cell_width)]


def _check_slots(grid, cfg, slot_data):
    """The slot data's checks, and the chunk size the kernels take (on the
    CPU too, so that both routes refuse the same configurations)."""
    d_, c = cfg.max_chunks, cfg.chunk_size
    check_tensor("slot_data", slot_data, torch.float32, (d_, packed_rows(grid.dim), c),
                 slot_data.device)
    if grid.dim not in (2, 3):
        raise NotImplementedError(f"window kernels: {grid.dim}D grids")
    if c != default_chunk_size(grid.dim):
        raise NotImplementedError(f"chunk size {c}: the window kernels take "
                                  f"{default_chunk_size(grid.dim)} in {grid.dim}D")
    return slot_data.device


# ---------------------------------------------------------------------------
# Plain versions: the TPU kernel bodies, batched over groups of chunks
# ---------------------------------------------------------------------------


def _axis_weights(grid: GridParams, pos_ax, ax):
    """Region-axis weights and dpt for one axis: pos_ax [G, C] -> ([G, 8, C],
    [G, 8, C]), as the TPU kernel forms them."""
    h = grid.cell_width
    xg = linalg.div_const(pos_ax - grid.origin[ax], h)
    base = torch.round(xg).to(torch.int32) - 1
    fx = xg - base.to(torch.float32)
    lb = base - (base // BLOCK_SIDE) * BLOCK_SIDE  # 0..3 (floor division)
    r = torch.arange(region_side(), dtype=torch.int32, device=pos_ax.device)[None, :, None]
    rel = r - lb[:, None, :]
    w0 = (0.5 * (1.5 - fx) ** 2)[:, None, :]
    w1 = (0.75 - (fx - 1.0) ** 2)[:, None, :]
    w2 = (0.5 * (fx - 0.5) ** 2)[:, None, :]
    w = w0 * (rel == 0) + w1 * (rel == 1) + w2 * (rel == 2)
    px = (lb.to(torch.float32) + fx)[:, None, :]
    dpt = (r.to(torch.float32) - px) * h
    return w, dpt


def _outer3(a, b, c_):
    """[G, 8, C] x3 -> [G, 512, C], (a*b)*c over row-major cells."""
    w = a[:, :, None, None, :] * b[:, None, :, None, :] * c_[:, None, None, :, :]
    return w.reshape(w.shape[0], -1, w.shape[-1])


def _outer2(a, b):
    """[G, 8, C] x2 -> [G, 64, C], a*b over row-major cells (q = x*8 + y)."""
    w = a[:, :, None, :] * b[:, None, :, :]
    return w.reshape(w.shape[0], -1, w.shape[-1])


def _window_tensors(grid, pos_rows):
    """Per-axis weights -> (W, [W_x, W_y(, W_z)]), each [G, 8^d, C], in the
    TPU kernel's operand order (W_x = outer(w_x·dpt_x, w_y, ...))."""
    dim = len(pos_rows)
    ws, dpts = zip(*(_axis_weights(grid, pos_rows[ax], ax) for ax in range(dim)))
    if dim == 2:
        return _outer2(ws[0], ws[1]), [_outer2(ws[0] * dpts[0], ws[1]),
                                       _outer2(ws[0], ws[1] * dpts[1])]
    w_full = _outer3(ws[0], ws[1], ws[2])
    wd = [
        _outer3(ws[0] * dpts[0], ws[1], ws[2]),
        _outer3(ws[0], ws[1] * dpts[1], ws[2]),
        _outer3(ws[0], ws[1], ws[2] * dpts[2]),
    ]
    return w_full, wd


def _ordered_sum(x):
    """x [..., K] -> [...]: the sum over the last axis in ascending k from
    zero (the CPU scatter-add visits its index in order; on CUDA it sums in
    any order)."""
    index = torch.zeros((1,) * x.dim(), dtype=torch.long, device=x.device).expand(x.shape)
    return x.new_zeros(x.shape[:-1] + (1,)).scatter_add_(-1, index, x)[..., 0]


def _stencil_cells_2d(grid, data):
    """The 3x3 stencil cells of each slot of a 2D chunk group, [G, C, 9]
    (q = x*8 + y, taps x-major: ascending cells), from the same block-local
    base as _axis_weights."""
    lbs = []
    for ax in range(2):
        base = torch.round(linalg.div_const(data[:, ax, :] - grid.origin[ax],
                                            grid.cell_width)).to(torch.int32) - 1
        lbs.append(base - (base // BLOCK_SIDE) * BLOCK_SIDE)
    k = torch.arange(3, dtype=torch.int32, device=data.device)
    q = (lbs[0][..., None, None] + k[:, None]) * region_side() + lbs[1][..., None, None] + k
    return q.reshape(q.shape[0], q.shape[1], 9).long()


def _at_cells(w, q):
    """Dense window weights [G, 64, C] at each slot's stencil cells q
    [G, C, 9] -> [G, C, 9]."""
    g, c, _ = q.shape
    return w.gather(1, q.transpose(1, 2).reshape(g, 9, c)).transpose(1, 2)


def _lane_sum(vals, w, q):
    """vals [G, F, C], w [G, 64, C] -> [G, F, 64]: each cell's sum of vals·w
    over the chunk's slots in ascending lane order from zero, the 2D P2G
    kernel's owner-loop order (scattered lane-major: each slot adds to a
    cell at most once)."""
    g, nf, c = vals.shape
    src = (vals[:, :, :, None] * _at_cells(w, q)[:, None]).reshape(g, nf, c * 9)
    out = vals.new_zeros((g, nf, w.shape[1]))
    return out.scatter_add_(2, q.reshape(g, 1, c * 9).expand(g, nf, c * 9), src)


def _cell_sum(win, w, q):
    """win [G, F, 64], w [G, 64, C] -> [G, F, C]: each slot's sum of win·w
    over its 3x3 stencil in ascending cell order from zero, as the 2D G2P
    kernel sums."""
    g, nf, _ = win.shape
    c = q.shape[1]
    v = win.gather(2, q.reshape(g, 1, c * 9).expand(g, nf, c * 9)).reshape(g, nf, c, 9)
    return _ordered_sum(v * _at_cells(w, q)[:, None])


def _live_prefix(*tensors):
    """The number of leading chunks up to the last one where any of
    `tensors` ([D, ...] each) holds a nonzero value. Past it a plain
    version's inputs are all zero (chunks that hold no particle), and so
    are its outputs: every term there is a product with a zero."""
    nz = torch.stack([t.reshape(t.shape[0], -1).ne(0).any(dim=1) for t in tensors]).any(dim=0)
    idx = torch.nonzero(nz)
    return int(idx[-1]) + 1 if idx.numel() else 0


def p2g_windows_reference(grid: GridParams, slot_data, with_psi=True, group_size=256):
    """Plain version of the P2G window kernel: slot_data [D, NF_IN, C] ->
    images [D, 1+d(+2), 8^d]. Per chunk, [m, m*v(, psi_mom, psi_m)] through
    W, momentum plus sum_j affine[:, j] through W_j, each a contraction over
    the chunk's slots; `group_size` chunks at a time, up to the last chunk
    with a particle (zeros past it). In 3D batched matrix products; in 2D
    each cell sums its slots in ascending lane order, the 2D kernel's
    order, so that card and CPU agree to the bit."""
    dim = grid.dim
    a_off = 2 * dim + 1
    live = _live_prefix(slot_data)
    out = [slot_data.new_zeros((0, 1 + dim + (2 if with_psi else 0), region_cells(dim)))]
    for g0 in range(0, live, group_size):
        data = slot_data[g0 : min(g0 + group_size, live)]
        w_full, wd = _window_tensors(grid, [data[:, ax, :] for ax in range(dim)])
        q = _stencil_cells_2d(grid, data) if dim == 2 else None

        def contract(v, w):
            return _lane_sum(v, w, q) if dim == 2 else torch.bmm(v, w.transpose(1, 2))

        m = data[:, dim : dim + 1, :]
        parts = [m, m * data[:, dim + 1 : 2 * dim + 1, :]]
        if with_psi:
            parts += [data[:, a_off + dim * dim + 1 : a_off + dim * dim + 2, :],
                      data[:, a_off + dim * dim : a_off + dim * dim + 1, :]]
        base_img = contract(torch.cat(parts, dim=1), w_full)
        mom = base_img[:, 1 : 1 + dim, :]
        for j in range(dim):
            a_col = data[:, [a_off + i * dim + j for i in range(dim)], :]  # column j, rows i
            mom = mom + contract(a_col, wd[j])
        img = [base_img[:, :1, :], mom]
        if with_psi:
            img.append(base_img[:, 1 + dim :, :])
        out.append(torch.cat(img, dim=1))
    out = torch.cat(out, dim=0)
    return torch.cat([out, out.new_zeros((slot_data.shape[0] - live,) + out.shape[1:])])


def g2p_windows_reference(grid: GridParams, slot_data, windows, with_psi=True, group_size=256):
    """Plain version of the G2P window kernel: slot_data [D, NF_IN, C],
    windows [D, d(+1), 8^d] -> [D, d + d*d (+1), C], rows [vel (d), grad
    columns j-major (d*d)(, psi)]; v = W-weighted window velocity, grad
    column j = invd * W_j-weighted velocity. In 3D batched matrix products;
    in 2D each slot sums the window's cells in ascending cell order, the 2D
    kernel's order. Up to the last chunk with a particle or a nonzero
    window (zeros past it)."""
    dim = grid.dim
    invd = kernel_inv_d(grid.cell_width)
    live = _live_prefix(slot_data, windows)
    out = [slot_data.new_zeros((0, dim + dim * dim + (1 if with_psi else 0),
                                slot_data.shape[2]))]
    for g0 in range(0, live, group_size):
        data = slot_data[g0 : min(g0 + group_size, live)]
        win = windows[g0 : min(g0 + group_size, live)]
        w_full, wd = _window_tensors(grid, [data[:, ax, :] for ax in range(dim)])
        q = _stencil_cells_2d(grid, data) if dim == 2 else None

        def contract(v, w):
            return _cell_sum(v, w, q) if dim == 2 else torch.bmm(v, w)

        win_v = win[:, :dim, :]
        parts = [contract(win_v, w_full)]
        parts += [invd * contract(win_v, wd[j]) for j in range(dim)]
        if with_psi:
            parts.append(contract(win[:, dim : dim + 1, :], w_full))
        out.append(torch.cat(parts, dim=1))
    out = torch.cat(out, dim=0)
    return torch.cat([out, out.new_zeros((slot_data.shape[0] - live,) + out.shape[1:])])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def p2g_windows(grid: GridParams, cfg, slot_data, with_psi=True):
    """The P2G window kernel (replaces sparkl_tpu/ops/transfer_kernels.py:
    p2g_windows_pallas): slot_data [D, 24, 128] (3D) or [D, 16, 64] (2D)
    f32 -> images [D, 1+d(+2), 8^d] f32, row-major cells."""
    dev = _check_slots(grid, cfg, slot_data)
    args = _grid_args(grid)
    if route(dev) == "cpu":
        return p2g_windows_reference(grid, slot_data, with_psi)
    dim = grid.dim
    nf = 1 + dim + (2 if with_psi else 0)
    out = torch.empty((cfg.max_chunks, nf, region_cells(dim)), dtype=torch.float32, device=dev)
    launch("sparkl_p2g_windows", slot_data.data_ptr(), out.data_ptr(),
           cfg.max_chunks, dim, int(bool(with_psi)), *args, stream_ptr(dev))
    LAUNCHES["p2g_windows"] += 1
    return out


def g2p_windows(grid: GridParams, cfg, slot_data, windows, with_psi=True):
    """The G2P window kernel (replaces sparkl_tpu/ops/transfer_kernels.py:
    g2p_windows_pallas): slot_data [D, 24, 128] (3D) or [D, 16, 64] (2D)
    f32, windows [D, d(+1), 8^d] f32 -> [D, d + d*d (+1), C] f32, rows
    [vel (d), grad columns j-major (d*d)(, psi)]."""
    dev = _check_slots(grid, cfg, slot_data)
    dim = grid.dim
    n_win = dim + (1 if with_psi else 0)
    check_tensor("windows", windows, torch.float32,
                 (cfg.max_chunks, n_win, region_cells(dim)), dev)
    args = _grid_args(grid)
    if route(dev) == "cpu":
        return g2p_windows_reference(grid, slot_data, windows, with_psi)
    out = torch.empty((cfg.max_chunks, dim * dim + n_win, cfg.chunk_size), dtype=torch.float32,
                      device=dev)
    launch("sparkl_g2p_windows", slot_data.data_ptr(), windows.data_ptr(),
           out.data_ptr(), cfg.max_chunks, dim, int(bool(with_psi)), *args, stream_ptr(dev))
    LAUNCHES["g2p_windows"] += 1
    return out
