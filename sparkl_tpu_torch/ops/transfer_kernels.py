"""The block-sparse pipeline's window transfers: P2G slot data -> window
images and G2P windows -> per-slot gathers, each a hand-written CUDA kernel
(csrc/window_kernels.cu) with its plain PyTorch version beside it (port of
sparkl_tpu/ops/transfer_kernels.py).

Slot data is packed f-major per chunk, [D, NF_IN, C]: position (d rows),
mass, velocity (d), affine (d*d, row-major), psi_mass, psi_momentum, zero
padding to a multiple of 8 rows. Padded slots are zeroed when gathered, so
the transfers need no mask. Windows and images use row-major region cells
(q = x*64 + y*8 + z in 3D).

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
from sparkl_tpu_torch.sparse.blocks import BLOCK_SIDE, region_cells, region_side

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
    if grid.dim != 3:
        raise NotImplementedError("window kernels: only 3D is ported")
    return [float(o) for o in grid.origin] + [grid.cell_width, kernel_inv_d(grid.cell_width)]


def _check_slots(grid, cfg, slot_data):
    d_, c = cfg.max_chunks, cfg.chunk_size
    check_tensor("slot_data", slot_data, torch.float32, (d_, packed_rows(grid.dim), c),
           slot_data.device)
    return slot_data.device


# ---------------------------------------------------------------------------
# Plain versions: the TPU kernel bodies, batched over groups of chunks
# ---------------------------------------------------------------------------


def _axis_weights(grid: GridParams, pos_ax, ax):
    """Region-axis weights and dpt for one axis: pos_ax [G, C] -> ([G, 8, C],
    [G, 8, C]), as the TPU kernel forms them."""
    h = grid.cell_width
    xg = linalg.div(pos_ax - grid.origin[ax], h)
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


def _window_tensors(grid, pos_rows):
    """Per-axis weights -> (W, [W_x, W_y, W_z]), each [G, 512, C]."""
    ws, dpts = zip(*(_axis_weights(grid, pos_rows[ax], ax) for ax in range(3)))
    w_full = _outer3(ws[0], ws[1], ws[2])
    wd = [
        _outer3(ws[0] * dpts[0], ws[1], ws[2]),
        _outer3(ws[0], ws[1] * dpts[1], ws[2]),
        _outer3(ws[0], ws[1], ws[2] * dpts[2]),
    ]
    return w_full, wd


def p2g_windows_reference(grid: GridParams, slot_data, with_psi=True, group_size=256):
    """Plain version of the P2G window kernel: slot_data [D, NF_IN, C] ->
    images [D, 4(+2), 512]. Per chunk, [m, m*v(, psi_mom, psi_m)] through W,
    momentum plus sum_j affine[:, j] through W_j, each a contraction over
    the chunk's slots; `group_size` chunks at a time."""
    dim = 3
    a_off = 2 * dim + 1
    out = []
    for g0 in range(0, slot_data.shape[0], group_size):
        data = slot_data[g0 : g0 + group_size]
        w_full, wd = _window_tensors(grid, [data[:, ax, :] for ax in range(dim)])
        m = data[:, dim : dim + 1, :]
        parts = [m, m * data[:, dim + 1 : 2 * dim + 1, :]]
        if with_psi:
            parts += [data[:, a_off + dim * dim + 1 : a_off + dim * dim + 2, :],
                      data[:, a_off + dim * dim : a_off + dim * dim + 1, :]]
        base_img = torch.bmm(torch.cat(parts, dim=1), w_full.transpose(1, 2))
        mom = base_img[:, 1 : 1 + dim, :]
        for j in range(dim):
            a_col = data[:, [a_off + i * dim + j for i in range(dim)], :]  # column j, rows i
            mom = mom + torch.bmm(a_col, wd[j].transpose(1, 2))
        img = [base_img[:, :1, :], mom]
        if with_psi:
            img.append(base_img[:, 1 + dim :, :])
        out.append(torch.cat(img, dim=1))
    return torch.cat(out, dim=0)


def g2p_windows_reference(grid: GridParams, slot_data, windows, with_psi=True, group_size=256):
    """Plain version of the G2P window kernel: slot_data [D, NF_IN, C],
    windows [D, 3(+1), 512] -> [D, 12(+1), C], rows [vel (3), grad columns
    j-major (9)(, psi)]; v = W-weighted window velocity, grad column j =
    invd * W_j-weighted velocity."""
    dim = 3
    invd = kernel_inv_d(grid.cell_width)
    out = []
    for g0 in range(0, slot_data.shape[0], group_size):
        data = slot_data[g0 : g0 + group_size]
        win = windows[g0 : g0 + group_size]
        w_full, wd = _window_tensors(grid, [data[:, ax, :] for ax in range(dim)])
        win_v = win[:, :dim, :]
        parts = [torch.bmm(win_v, w_full)]
        parts += [invd * torch.bmm(win_v, wd[j]) for j in range(dim)]
        if with_psi:
            parts.append(torch.bmm(win[:, dim : dim + 1, :], w_full))
        out.append(torch.cat(parts, dim=1))
    return torch.cat(out, dim=0)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def p2g_windows(grid: GridParams, cfg, slot_data, with_psi=True):
    """The P2G window kernel (replaces sparkl_tpu/ops/transfer_kernels.py:
    p2g_windows_pallas): slot_data [D, 24, 128] f32 -> images [D, 4(+2),
    512] f32, row-major cells."""
    dev = _check_slots(grid, cfg, slot_data)
    args = _grid_args(grid)
    if route(dev) == "cpu":
        return p2g_windows_reference(grid, slot_data, with_psi)
    if cfg.chunk_size != 128:
        raise NotImplementedError(f"chunk size {cfg.chunk_size}: the P2G window kernel takes 128")
    nf = 6 if with_psi else 4
    out = torch.empty((cfg.max_chunks, nf, region_cells(3)), dtype=torch.float32, device=dev)
    launch("sparkl_p2g_windows", slot_data.data_ptr(), out.data_ptr(),
           cfg.max_chunks, int(bool(with_psi)), *args, stream_ptr(dev))
    LAUNCHES["p2g_windows"] += 1
    return out


def g2p_windows(grid: GridParams, cfg, slot_data, windows, with_psi=True):
    """The G2P window kernel (replaces sparkl_tpu/ops/transfer_kernels.py:
    g2p_windows_pallas): slot_data [D, 24, 128] f32, windows [D, 3(+1),
    512] f32 -> [D, 12(+1), 128] f32, rows [vel (3), grad columns j-major
    (9)(, psi)]."""
    dev = _check_slots(grid, cfg, slot_data)
    n_win = 4 if with_psi else 3
    check_tensor("windows", windows, torch.float32, (cfg.max_chunks, n_win, region_cells(3)), dev)
    args = _grid_args(grid)
    if route(dev) == "cpu":
        return g2p_windows_reference(grid, slot_data, windows, with_psi)
    if cfg.chunk_size != 128:
        raise NotImplementedError(f"chunk size {cfg.chunk_size}: the G2P window kernel takes 128")
    out = torch.empty((cfg.max_chunks, 9 + n_win, cfg.chunk_size), dtype=torch.float32,
                      device=dev)
    launch("sparkl_g2p_windows", slot_data.data_ptr(), windows.data_ptr(),
           out.data_ptr(), cfg.max_chunks, int(bool(with_psi)), *args, stream_ptr(dev))
    LAUNCHES["g2p_windows"] += 1
    return out
