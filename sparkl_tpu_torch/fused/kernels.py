"""The fused substep's kernels: kernel A (P2G images), the block merge,
the scatter merge, kernel B (G2P + particle update), the fluid volume
pass's mass-only P2G and G2P, and the resort's source-row and permute
kernels, each a hand-written CUDA kernel (csrc/fused_kernels.cu) with its
plain PyTorch version beside it.

Port of sparkl_tpu/fused/kernels.py for the configurations the port
carries: 3D, corotated elasticity with optional Drucker-Prager and the
Monaghan EOS fluid (alone or mixed with solids), the stress cache on, no
damage channels, no failure models. A wrapper runs the plain version when
its tensors lie on the CPU and launches the kernel when they lie on a CUDA
device; anything else raises. There is no fallback from a kernel to its
plain version. Each wrapper counts its kernel launches in LAUNCHES (the CPU
path counts nothing).
"""

import numpy as np
import torch

from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.cuda_build import check_tensor, launch, route, stream_ptr
from sparkl_tpu_torch.math import cmat, linalg
from sparkl_tpu_torch.math.kernel import inv_d as kernel_inv_d, quadratic_weights_1d
from sparkl_tpu_torch.math.svd import svd_c
from sparkl_tpu_torch.models import constitutive as con
from sparkl_tpu_torch.models import plasticity as plas
from sparkl_tpu_torch.sparse.blocks import region_cells
from sparkl_tpu_torch.fused import layout as L

# Packed model-table columns: f32 [M, 16] = cparams(0:4) | pparams(4:12) |
# fparams(12:14) | pad; i32 [M, 4] = ctype | ptype | ftype | pad.
TAB_C = 0
TAB_P = 4
TAB_F = 12

# Kernel launches per wrapper since the last reset_launch_counts().
LAUNCHES = {"p2g_fused": 0, "merge_blocks": 0, "merge_scatter": 0, "g2p_fused": 0,
            "mass_p2g_fused": 0, "mass_g2p_fused": 0, "src_rows_from_order": 0,
            "permute_slots": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_model_tables(models):
    """ModelSet -> (tab_f f32 [M, 16], tab_i i32 [M, 4])."""
    tab_f = torch.cat([models.cparams, models.pparams, models.fparams], dim=1)
    pad = 16 - tab_f.shape[1]
    if pad > 0:
        tab_f = torch.cat([tab_f, tab_f.new_zeros((tab_f.shape[0], pad))], dim=1)
    tab_i = torch.stack(
        [models.ctype, models.ptype, models.ftype, torch.zeros_like(models.ctype)], dim=1
    )
    return tab_f.to(torch.float32).contiguous(), tab_i.to(torch.int32).contiguous()


def kernel_meta(models, params):
    """Static description of a scene for the kernels (the JAX package's
    `meta` dict); _check_meta says which of them the port carries."""
    return dict(
        with_psi=False,
        m_count=models.num_models,
        present_c=models.present_c,
        present_p=models.present_p,
        present_f=models.present_f,
        damage_model=int(params.damage_model),
        stress_cache=True,
    )


def _check_meta(meta):
    why = []
    if meta["with_psi"]:
        why.append("damage (psi) channels")
    if meta["damage_model"] != 0:
        why.append(f"damage model {meta['damage_model']}")
    if not meta["stress_cache"]:
        why.append("stress cache off")
    if set(meta["present_c"]) - {con.COROTATED, con.EOS_MONAGHAN_SPH}:
        why.append(f"constitutive types {meta['present_c']}")
    if set(meta["present_p"]) - {plas.DRUCKER_PRAGER}:
        why.append(f"plastic types {meta['present_p']}")
    if meta["present_f"]:
        why.append(f"failure models {meta['present_f']}")
    if why:
        raise NotImplementedError("fused kernels do not carry: " + ", ".join(why))


def _grid_args(grid: GridParams):
    if grid.dim != 3:
        raise NotImplementedError("fused kernels: only 3D is ported")
    h = grid.cell_width
    # Constants derived from h in double, as the JAX kernels fold them.
    return ([float(o) for o in grid.origin] + [h, kernel_inv_d(h), (h * h) / 4.0]
            + [int(r) for r in grid.res])


# ---------------------------------------------------------------------------
# Shared per-slot geometry of both kernels
# ---------------------------------------------------------------------------


def _slot_geometry(grid: GridParams, slots, ints):
    """Per axis: base cell, fx, window-relative base `rel`, and the masks
    in_window (rel in [0, 5]) and in_bounds (stencil inside the grid)."""
    h = grid.cell_width
    r = L.Rows(3)
    base, fx, rel = [], [], []
    in_window = in_bounds = None
    for ax in range(3):
        xg = linalg.div(slots[:, r.pos + ax, :] - grid.origin[ax], h)
        b = torch.round(xg).to(torch.int32) - 1
        f = xg - b.to(torch.float32)
        rl = b - ints[:, L.I_ORIGIN + ax, :]
        okw = (rl >= 0) & (rl <= 5)
        okb = (b >= 0) & (b + 2 <= grid.res[ax] - 1)
        in_window = okw if in_window is None else in_window & okw
        in_bounds = okb if in_bounds is None else in_bounds & okb
        base.append(b)
        fx.append(f)
        rel.append(rl)
    return base, fx, rel, in_window, in_bounds


def _taps(grid: GridParams, fx, rel):
    """Per axis, per tap k in {0, 1, 2}: weight w[ax][k] and
    dpt[ax][k] = (cell - px) * h, px = rel + fx (the JAX kernels' order
    of operations)."""
    h = grid.cell_width
    w, dpt = [], []
    for ax in range(3):
        f = fx[ax]
        px = rel[ax].to(torch.float32) + f
        w.append(list(quadratic_weights_1d(f).unbind(-1)))
        dpt.append([((rel[ax] + k).to(torch.float32) - px) * h for k in range(3)])
    return w, dpt


_TAPS = [(a, b, c) for a in range(3) for b in range(3) for c in range(3)]


def _tap_cells(rel, contrib):
    """[D, 27, C] z-major cell of every tap (0 where the slot does not
    contribute)."""
    q = torch.stack(
        [(rel[2] + c) * 64 + (rel[0] + a) * 8 + (rel[1] + b) for a, b, c in _TAPS], dim=1
    )
    return torch.where(contrib[:, None, :], q, 0).long()


def _live_count(nchunks, d_):
    """Chunks the plain versions compute: [0, nchunks). A host read, which
    the plain versions may make (they are not on the card's main path)."""
    return min(max(int(nchunks), 0), d_)


def _has_eos(meta):
    return con.EOS_MONAGHAN_SPH in meta["present_c"]


def _eos_stress_c(p, mass, vol0, fluid_j, g):
    """Kernel A's fresh EOS stress (the JAX package's
    _cached_stress_read_c overlay): J from F00, the density from the mass,
    vol0 and J, the viscous part from the carried velocity gradient."""
    density_fluid = (mass / torch.clamp(vol0, min=1e-30)) / torch.clamp(fluid_j, min=1e-20)
    return con.eos_kirchhoff_stress_c(p[0], p[1], p[2], p[3], mass, vol0, density_fluid,
                                      fluid_j, g)


def timestep_bound_c(ct, p, eh, f, mass, vol0, vel, h, present_c):
    """Per-slot constitutive dt bound (the JAX package's _timestep_bound_c):
    the corotated sound-speed bound, the EOS bound from J = F00, +inf for
    other model types. ct [D, C] model types, p the four constitutive
    parameter rows, vel the three velocity rows; present_c the model set's
    types (only their bounds are formed, with no host read)."""
    vnorm, vsq = _vnorm(vel)
    density0 = mass / torch.clamp(vol0, min=1e-30)
    out = torch.full_like(mass, float("inf"))
    if con.COROTATED in present_c:
        b = con.corotated_timestep_bound_c(p[0], p[1], p[2], eh, density0, vnorm, h)
        out = torch.where(ct == con.COROTATED, b, out)
    if con.EOS_MONAGHAN_SPH in present_c:
        fluid_j = f[0][0]
        density_fluid = density0 / torch.clamp(fluid_j, min=1e-20)
        b = con.eos_timestep_bound_c(p[0], p[1], p[3], fluid_j, mass, vol0, density_fluid,
                                     vsq, h, 3)
        out = torch.where(ct == con.EOS_MONAGHAN_SPH, b, out)
    return out


def _vnorm(vel):
    vsq = sum(x * x for x in vel)
    return torch.sqrt(vsq), vsq


def dt_bound_row(h, vel, g, con_bound, failed, active):
    """The carried dt-bound row: min of the velocity/APIC bound and the
    constitutive one (+inf for failed slots), +inf on inactive slots,
    clipped to BIGF (slot rows are inf-free). Ref: timestep_estimator.rs."""
    norm_b = (h * h) / 4.0 * torch.sqrt(cmat.frob2_c(g))
    apic_v = linalg.div(norm_b * 6.0 * float(np.sqrt(3)), h)
    vtot = _vnorm(vel)[0] + apic_v
    vel_bound = torch.where(vtot > 0.0, linalg.rdiv(h, torch.clamp(vtot, min=1e-20)),
                            float("inf"))
    con_bound = torch.where(failed, float("inf"), con_bound)
    bound = torch.where(active, torch.minimum(vel_bound, con_bound), float("inf"))
    return torch.clamp(bound, max=L.BIGF)


def model_columns(tab_f, tab_i, ints, f_cols, i_cols=(0,)):
    """Per slot [D, C]: the model table's int columns `i_cols` and f32
    columns `f_cols`, one select per model (a row gather of the table is
    several times slower on the card); a model id outside the table reads
    zeros, as the kernels do. Returns (int columns, f32 columns), lists."""
    mid = ints[:, L.I_MODEL, :]
    ti = [torch.zeros_like(mid) for _ in i_cols]
    tf = [torch.zeros(mid.shape, dtype=torch.float32, device=mid.device) for _ in f_cols]
    for m in range(tab_f.shape[0]):
        sel = mid == m
        ti = [torch.where(sel, tab_i[m, k], x) for k, x in zip(i_cols, ti)]
        tf = [torch.where(sel, tab_f[m, k], x) for k, x in zip(f_cols, tf)]
    return ti, tf


# ---------------------------------------------------------------------------
# Kernel A: cached stress + APIC affine -> window images
# ---------------------------------------------------------------------------


def p2g_fused_reference(grid: GridParams, slots, ints, dt, nchunks, tables=None):
    """Plain version of kernel A: slots [D, 56, C] -> images [D, 4, 512]
    (mass, momentum), z-major cells. Chunks >= nchunks are zero. Each slot
    scatters its 27 taps, w·(m v + A·dpt) with the APIC affine
    A = m ∇v − V0 D⁻¹ dt σ (σ from the stress-cache rows, or fresh from J =
    F00 for EOS slots when the model `tables` (tab_f, tab_i) are given;
    zero for failed particles), masked by active & in-window & in-grid."""
    r = L.Rows(3)
    d_all = slots.shape[0]
    n_live = _live_count(nchunks, d_all)
    slots, ints = slots[:n_live], ints[:n_live]
    d_, _, c = slots.shape
    invd = kernel_inv_d(grid.cell_width)

    def row(k):
        return slots[:, k, :]

    active = (ints[:, L.I_FLAGS, :] & L.ACTIVE) != 0
    failed = row(r.failed) != 0.0
    mass = row(r.mass)
    g = [[row(r.grad + 3 * i + j) for j in range(3)] for i in range(3)]
    st = [row(r.stress + k) for k in range(6)]
    stress = [[st[0], st[1], st[2]], [st[1], st[3], st[4]], [st[2], st[4], st[5]]]
    if tables is not None:
        (ct,), p = model_columns(*tables, ints, range(TAB_C, TAB_C + 4))
        fluid = ct == con.EOS_MONAGHAN_SPH
        if bool(fluid.any()):
            s_eos = _eos_stress_c(p, mass, row(r.vol0), row(r.defgrad), g)
            stress = cmat.where_mat(fluid, s_eos, stress)
    coeff = row(r.vol0) * invd * dt
    _, fx, rel, in_window, in_bounds = _slot_geometry(grid, slots, ints)
    contrib = active & in_window & in_bounds
    cf = contrib.to(torch.float32)
    # where, not a product with the mask: an empty lane's EOS stress is NaN
    # (0/0 densities), and the scatter below sends masked lanes to cell 0.
    a = [
        [torch.where(contrib, mass * g[i][j] - torch.where(failed, 0.0, coeff * stress[i][j]),
                     0.0)
         for j in range(3)]
        for i in range(3)
    ]
    m_c = mass * cf
    p0 = [m_c] + [m_c * row(r.vel + ax) for ax in range(3)]
    w, dpt = _taps(grid, fx, rel)

    vals = []
    for ta, tb, tc in _TAPS:
        wxy = w[0][ta] * w[1][tb]
        wz = w[2][tc]
        wdx_y = (w[0][ta] * dpt[0][ta]) * w[1][tb]
        wx_dy = w[0][ta] * (w[1][tb] * dpt[1][tb])
        wdz = wz * dpt[2][tc]
        ch = [(p0[0] * wz) * wxy]
        for i in range(3):
            ch.append((p0[1 + i] * wz) * wxy + (a[i][2] * wdz) * wxy
                      + (a[i][0] * wz) * wdx_y + (a[i][1] * wz) * wx_dy)
        vals.append(torch.stack(ch, dim=1))  # [D, 4, C]
    vals = torch.stack(vals, dim=2).reshape(d_, 4, 27 * c)
    q = _tap_cells(rel, contrib).reshape(d_, 1, 27 * c).expand(d_, 4, 27 * c)
    out = torch.zeros((d_all, 4, region_cells(3)), dtype=torch.float32, device=slots.device)
    out[:n_live].scatter_add_(2, q, vals)
    return out


def _check_tables(tables, dev):
    tab_f, tab_i = tables
    m = tab_f.shape[0]
    check_tensor("tab_f", tab_f, torch.float32, (m, 16), dev)
    check_tensor("tab_i", tab_i, torch.int32, (m, 4), dev)
    return tab_f, tab_i, m


def p2g_fused(grid: GridParams, cfg, meta, slots, ints, dt, nchunks, tables=None):
    """Kernel A (replaces sparkl_tpu/fused/kernels.py:p2g_fused): slots
    [D, 56, 128] f32, ints [D, 8, 128] i32, dt (python float), nchunks []
    i32, the model tables (tab_f f32 [M, 16], tab_i i32 [M, 4]; needed when
    the scene has EOS fluids, whose stress kernel A forms fresh) -> images
    [D, 4, 512] f32, z-major cells (q = z*64 + x*8 + y)."""
    _check_meta(meta)
    d_, c = cfg.max_chunks, cfg.chunk_size
    dev = slots.device
    r = L.Rows(3)
    check_tensor("slots", slots, torch.float32, (d_, r.nf, c), dev)
    check_tensor("ints", ints, torch.int32, (d_, L.NI, c), dev)
    check_tensor("nchunks", nchunks, torch.int32, (), dev)
    if c != 128:
        raise NotImplementedError(f"chunk size {c}: kernel A takes 128")
    if _has_eos(meta) and tables is None:
        raise ValueError("kernel A needs the model tables for EOS fluids")
    tab_f, tab_i, m = _check_tables(tables, dev) if tables is not None else (None, None, 0)
    args = _grid_args(grid)
    if route(dev) == "cpu":
        return p2g_fused_reference(grid, slots, ints, dt, nchunks, tables=tables)
    out = torch.empty((d_, 4, region_cells(3)), dtype=torch.float32, device=dev)
    launch("sparkl_p2g_fused", slots.data_ptr(), ints.data_ptr(),
           nchunks.data_ptr(), tab_f.data_ptr() if m else None,
           tab_i.data_ptr() if m else None, m, out.data_ptr(), d_, float(dt), *args,
           stream_ptr(dev))
    LAUNCHES["p2g_fused"] += 1
    return out


# ---------------------------------------------------------------------------
# Block merge: per owner block, the sum of its contiguous chunk rows
# ---------------------------------------------------------------------------


def merge_blocks_reference(rows, first, nchunks, kmax):
    """Plain version of the merge: rows [D, K, W], first/nchunks [MB] ->
    [MB, K, W], block b = sum of rows[first[b] + k] for k < min(nchunks[b],
    kmax), accumulated in ascending k from zero (bit-equal to the kernel and
    to sparkl_tpu's merge_blocks_dma)."""
    d_ = rows.shape[0]
    pad = torch.cat([rows, rows.new_zeros((1,) + rows.shape[1:])], dim=0)
    acc = rows.new_zeros((first.shape[0],) + rows.shape[1:])
    for k in range(kmax):
        idx = torch.where(k < nchunks, first + k, d_).long()
        acc = acc + pad[idx]
    return acc


def merge_blocks(rows, first, nchunks, kmax=8):
    """The merge kernel (replaces sparkl_tpu/fused/kernels.py:merge_blocks_dma):
    rows [D, ncorners, W] f32, first/nchunks [MB] i32 -> [MB, ncorners, W]."""
    dev = rows.device
    d_, ncorners, w = rows.shape
    mb = first.shape[0]
    check_tensor("rows", rows, torch.float32, (d_, ncorners, w), dev)
    check_tensor("first", first, torch.int32, (mb,), dev)
    check_tensor("nchunks", nchunks, torch.int32, (mb,), dev)
    if route(dev) == "cpu":
        return merge_blocks_reference(rows, first, nchunks, kmax)
    out = torch.empty((mb, ncorners, w), dtype=torch.float32, device=dev)
    launch("sparkl_merge_blocks", rows.data_ptr(), first.data_ptr(),
           nchunks.data_ptr(), out.data_ptr(), mb, ncorners * w, kmax,
           stream_ptr(dev))
    LAUNCHES["merge_blocks"] += 1
    return out


# ---------------------------------------------------------------------------
# Scatter merge: per node-table row, the sum of its updates in a fixed order
# ---------------------------------------------------------------------------


def merge_scatter_reference(rows, order, starts):
    """Plain version of the scatter merge: rows [U, W] (one per flat (chunk,
    corner) update), order [U] update ids sorted by destination row,
    starts [G + 1] each row's segment in `order` -> [G, W], row g = the sum
    of rows[order[k]] for k in [starts[g], starts[g + 1]), accumulated in
    ascending k from zero (bit-equal to the kernel, and to the JAX
    package's CPU scatter-add when `order` is stable). Step k adds the k-th
    update of every row that has one; rows are visited by descending count
    so that step k touches a prefix."""
    g = starts.shape[0] - 1
    first = starts[:-1].long()
    n = starts[1:].long() - first
    n_sorted, by_count = torch.sort(n, descending=True, stable=True)
    src = rows[order.long()]
    acc = rows.new_zeros((g, rows.shape[1]))
    counts = n_sorted.tolist()  # a host read: the plain version is off the main path
    m = g
    for k in range(counts[0] if g else 0):
        while counts[m - 1] <= k:
            m -= 1
        acc[:m] += src[first[by_count[:m]] + k]
    out = torch.empty_like(acc)
    out[by_count] = acc
    return out


def merge_scatter(rows, order, starts):
    """The scatter merge kernel (replaces the XLA scatter-add
    sparkl_tpu/sparse/transfer.py:237 _merge_scatter, which is glue, not a
    TPU kernel): rows [U, W] f32, order [U] i32, starts [G + 1] i32 ->
    [G, W] f32. Deterministic: no atomics."""
    dev = rows.device
    u, w = rows.shape
    g = starts.shape[0] - 1
    check_tensor("rows", rows, torch.float32, (u, w), dev)
    check_tensor("order", order, torch.int32, (u,), dev)
    check_tensor("starts", starts, torch.int32, (g + 1,), dev)
    if route(dev) == "cpu":
        return merge_scatter_reference(rows, order, starts)
    out = torch.empty((g, w), dtype=torch.float32, device=dev)
    launch("sparkl_merge_scatter", rows.data_ptr(), order.data_ptr(), starts.data_ptr(),
           out.data_ptr(), g, w, stream_ptr(dev))
    LAUNCHES["merge_scatter"] += 1
    return out


# ---------------------------------------------------------------------------
# Fluid volume pass: mass-only window images and the per-slot mass gather
# ---------------------------------------------------------------------------


def _mass_geometry(grid, slots, ints):
    _, fx, rel, in_window, in_bounds = _slot_geometry(grid, slots, ints)
    contrib = ((ints[:, L.I_FLAGS, :] & L.ACTIVE) != 0) & in_window & in_bounds
    w, _ = _taps(grid, fx, rel)
    return contrib, rel, w


def mass_p2g_fused_reference(grid: GridParams, slots, ints, nchunks):
    """Plain version of the mass P2G: slots [D, 56, C] -> [D, 1, 512]
    mass images, z-major cells; each contributing slot adds (m·wz)·(wx·wy)
    to its 27 cells, in ascending lane order per cell (as the kernel sums
    them). Chunks >= nchunks are zero."""
    r = L.Rows(3)
    d_all = slots.shape[0]
    n_live = _live_count(nchunks, d_all)
    slots, ints = slots[:n_live], ints[:n_live]
    d_, _, c = slots.shape
    contrib, rel, w = _mass_geometry(grid, slots, ints)
    m_c = slots[:, r.mass, :] * contrib.to(torch.float32)
    vals = torch.stack([(m_c * w[2][tc]) * (w[0][ta] * w[1][tb]) for ta, tb, tc in _TAPS],
                       dim=2)  # [D, C, 27]: lane-major, so each cell sums in lane order
    q = _tap_cells(rel, contrib).transpose(1, 2)
    out = torch.zeros((d_all, 1, region_cells(3)), dtype=torch.float32, device=slots.device)
    out[:n_live, 0].scatter_add_(1, q.reshape(d_, 27 * c), vals.reshape(d_, 27 * c))
    return out


def mass_p2g_fused(grid: GridParams, cfg, slots, ints, nchunks):
    """The mass P2G kernel (replaces sparkl_tpu/fused/kernels.py:
    mass_p2g_fused): slots [D, 56, 128] f32, ints [D, 8, 128] i32, nchunks
    [] i32 -> [D, 1, 512] f32 mass images, z-major cells."""
    d_, c = cfg.max_chunks, cfg.chunk_size
    dev = slots.device
    check_tensor("slots", slots, torch.float32, (d_, L.Rows(3).nf, c), dev)
    check_tensor("ints", ints, torch.int32, (d_, L.NI, c), dev)
    check_tensor("nchunks", nchunks, torch.int32, (), dev)
    if c != 128:
        raise NotImplementedError(f"chunk size {c}: the mass P2G kernel takes 128")
    args = _grid_args(grid)
    if route(dev) == "cpu":
        return mass_p2g_fused_reference(grid, slots, ints, nchunks)
    out = torch.empty((d_, 1, region_cells(3)), dtype=torch.float32, device=dev)
    launch("sparkl_mass_p2g_fused", slots.data_ptr(), ints.data_ptr(), nchunks.data_ptr(),
           out.data_ptr(), d_, *args, stream_ptr(dev))
    LAUNCHES["mass_p2g_fused"] += 1
    return out


def mass_g2p_fused_reference(grid: GridParams, slots, ints, windows, nchunks):
    """Plain version of the mass gather: windows [D, 1, 512] (z-major) ->
    [D, 1, C], each contributing slot's Σ w·m over its 27 cells (per z tap
    the xy sheet first, then the z weight, as the kernel sums), zero
    elsewhere. Chunks >= nchunks are zero."""
    d_all = slots.shape[0]
    n_live = _live_count(nchunks, d_all)
    slots, ints, windows = slots[:n_live], ints[:n_live], windows[:n_live]
    d_, _, c = slots.shape
    contrib, rel, w = _mass_geometry(grid, slots, ints)
    win = torch.gather(windows[:, 0], 1, _tap_cells(rel, contrib).reshape(d_, 27 * c))
    win = win.reshape(d_, 27, c)
    acc = 0.0
    for tc in range(3):
        sheet = 0.0
        for ta in range(3):
            for tb in range(3):
                t = _TAPS.index((ta, tb, tc))
                sheet = sheet + win[:, t] * (w[0][ta] * w[1][tb])
        acc = acc + sheet * w[2][tc]
    out = torch.zeros((d_all, 1, c), dtype=torch.float32, device=slots.device)
    out[:n_live, 0] = contrib.to(torch.float32) * acc
    return out


def mass_g2p_fused(grid: GridParams, cfg, slots, ints, windows, nchunks):
    """The mass gather kernel (replaces sparkl_tpu/fused/kernels.py:
    mass_g2p_fused): slots [D, 56, 128] f32, ints [D, 8, 128] i32, windows
    [D, 1, 512] f32 z-major, nchunks [] i32 -> [D, 1, 128] f32."""
    d_, c = cfg.max_chunks, cfg.chunk_size
    dev = slots.device
    check_tensor("slots", slots, torch.float32, (d_, L.Rows(3).nf, c), dev)
    check_tensor("ints", ints, torch.int32, (d_, L.NI, c), dev)
    check_tensor("windows", windows, torch.float32, (d_, 1, region_cells(3)), dev)
    check_tensor("nchunks", nchunks, torch.int32, (), dev)
    if c != 128:
        raise NotImplementedError(f"chunk size {c}: the mass gather kernel takes 128")
    args = _grid_args(grid)
    if route(dev) == "cpu":
        return mass_g2p_fused_reference(grid, slots, ints, windows, nchunks)
    out = torch.empty((d_, 1, c), dtype=torch.float32, device=dev)
    launch("sparkl_mass_g2p_fused", slots.data_ptr(), ints.data_ptr(), windows.data_ptr(),
           nchunks.data_ptr(), out.data_ptr(), d_, *args, stream_ptr(dev))
    LAUNCHES["mass_g2p_fused"] += 1
    return out


# ---------------------------------------------------------------------------
# Resort: each destination chunk's source slots, and the slot permute
# ---------------------------------------------------------------------------


def src_rows_from_order_reference(order2, shifts):
    """Plain version of the source-row kernel: order2 [D, 2, C] (the two
    rows of the sorted order a destination chunk's slice spans) + shifts
    [D] -> [D, C], out[i, k] = concat(order2[i, 0], order2[i, 1])[shifts[i]
    + k], 0 where that falls outside the two rows."""
    d_, _, c = order2.shape
    j = shifts[:, None].long() + torch.arange(c, device=order2.device)[None, :]
    vals = torch.gather(order2.reshape(d_, 2 * c), 1, torch.clamp(j, 0, 2 * c - 1))
    return torch.where((j >= 0) & (j < 2 * c), vals, 0)


def src_rows_from_order(order2, shifts):
    """The source-row kernel (replaces sparkl_tpu/fused/kernels.py:
    src_rows_from_order, which returns [D, 1, C]): order2 [D, 2, 128] i32,
    shifts [D] i32 -> [D, 128] i32."""
    dev = order2.device
    d_, _, c = order2.shape
    check_tensor("order2", order2, torch.int32, (d_, 2, c), dev)
    check_tensor("shifts", shifts, torch.int32, (d_,), dev)
    if route(dev) == "cpu":
        return src_rows_from_order_reference(order2, shifts)
    if c != 128:
        raise NotImplementedError(f"chunk size {c}: the source-row kernel takes 128")
    out = torch.empty((d_, c), dtype=torch.int32, device=dev)
    launch("sparkl_src_rows_from_order", order2.data_ptr(), shifts.data_ptr(),
           out.data_ptr(), d_, stream_ptr(dev))
    LAUNCHES["src_rows_from_order"] += 1
    return out


def permute_slots_reference(slots, ints, src, origin, r_cumd):
    """Plain version of the permute kernel, the JAX package's `slow` form:
    destination slot (chunk d, lane l) takes every row of source slot
    src[d, l] (flat index chunk·C + lane; -1 leaves the slot zero). The
    drift row `r_cumd` is zeroed and the window-origin int rows are set
    from origin [D, dim]."""
    d_, nf, c = slots.shape
    ni = ints.shape[1]
    dim = origin.shape[1]
    ok = ((src >= 0) & (src < d_ * c)).reshape(-1)[:, None]
    flat = torch.where(ok[:, 0], src.reshape(-1), 0).long()
    out_f = torch.where(ok, slots.transpose(1, 2).reshape(-1, nf)[flat], 0.0)
    out_i = torch.where(ok, ints.transpose(1, 2).reshape(-1, ni)[flat], 0)
    out_f = out_f.reshape(d_, c, nf).transpose(1, 2).contiguous()
    out_i = out_i.reshape(d_, c, ni).transpose(1, 2).contiguous()
    out_f[:, r_cumd, :] = 0.0
    out_i[:, L.I_ORIGIN : L.I_ORIGIN + dim, :] = origin[:, :, None]
    return out_f, out_i


def permute_slots(slots, ints, src, origin, r_cumd):
    """The permute kernel (replaces sparkl_tpu/fused/kernels.py:
    permute_chunks_dma): slots [D, 56, 128] f32, ints [D, 8, 128] i32,
    src [D, 128] i32 source slot per destination slot (-1: empty), origin
    [D, 3] i32 -> new (slots, ints), drift row zeroed and origin rows
    written.

    The TPU kernel takes the same permute as at most K = 8 whole source
    chunks per destination (DMA) and a per-lane routing among them (MXU),
    so its package computes that routing and falls back to a per-slot
    gather past K. On the card each thread copies its own source slot, so
    the kernel takes `src` directly and has no K limit."""
    dev = slots.device
    d_, nf, c = slots.shape
    dim = origin.shape[1]
    check_tensor("slots", slots, torch.float32, (d_, nf, c), dev)
    check_tensor("ints", ints, torch.int32, (d_, L.NI, c), dev)
    check_tensor("src", src, torch.int32, (d_, c), dev)
    check_tensor("origin", origin, torch.int32, (d_, dim), dev)
    if route(dev) == "cpu":
        return permute_slots_reference(slots, ints, src, origin, r_cumd)
    if (nf, c, dim) != (L.Rows(3).nf, 128, 3):
        raise NotImplementedError(f"slots {tuple(slots.shape)}, dim {dim}: the permute "
                                  "kernel takes 3D slots [D, 56, 128]")
    out_f = torch.empty_like(slots)
    out_i = torch.empty_like(ints)
    launch("sparkl_permute_slots", slots.data_ptr(), ints.data_ptr(),
           src.data_ptr(), origin.data_ptr(), out_f.data_ptr(), out_i.data_ptr(),
           d_, dim, int(r_cumd), stream_ptr(dev))
    LAUNCHES["permute_slots"] += 1
    return out_f, out_i


# ---------------------------------------------------------------------------
# Kernel B: G2P + particle update + next dt bound
# ---------------------------------------------------------------------------


def g2p_fused_reference(grid: GridParams, slots, ints, windows, dt, tab_f, tab_i,
                        nchunks, velocity_clamp=False):
    """Plain version of kernel B: returns the new slot tensor [D, 56, C]
    (chunks >= nchunks pass through). Gathers v and ∇v from the windows,
    advects, updates F (for EOS fluids only J = F00, by tr(∇v)), runs one
    SVD shared by the Drucker-Prager return map, the pos energy and the
    stress-cache epilogue (zero stress rows for fluids), applies the static
    and failure guards (no |F00| guard for fluids) and the out-of-grid mark,
    and writes the next dt bound and the accumulated drift."""
    r = L.Rows(3)
    n_live = _live_count(nchunks, slots.shape[0])
    slots_all = slots
    slots, ints, windows = slots[:n_live], ints[:n_live], windows[:n_live]
    d_, _, c = slots.shape
    h = grid.cell_width
    invd = kernel_inv_d(h)

    def row(k):
        return slots[:, k, :]

    flags = ints[:, L.I_FLAGS, :]
    active = (flags & L.ACTIVE) != 0
    is_static = (flags & L.STATIC) != 0
    kinematic = (flags & L.KINEMATIC) != 0

    # --- gather ---
    _, fx, rel, in_window, in_bounds = _slot_geometry(grid, slots, ints)
    contrib = active & in_window & in_bounds
    cf = contrib.to(torch.float32)
    w, dpt = _taps(grid, fx, rel)
    q = _tap_cells(rel, contrib).reshape(d_, 1, 27 * c).expand(d_, 3, 27 * c)
    win = torch.gather(windows, 2, q).reshape(d_, 3, 27, c)
    sv = [0.0] * 3
    sg = [[0.0] * 3 for _ in range(3)]
    for t, (ta, tb, tc) in enumerate(_TAPS):
        wz = w[2][tc]
        wxy = w[0][ta] * w[1][tb]
        wdx_y = (w[0][ta] * dpt[0][ta]) * w[1][tb]
        wx_dy = w[0][ta] * (w[1][tb] * dpt[1][tb])
        wdz = wz * dpt[2][tc]
        for i in range(3):
            v = win[:, i, t, :]
            sv[i] = sv[i] + (v * wxy) * wz
            sg[i][0] = sg[i][0] + (v * wdx_y) * wz
            sg[i][1] = sg[i][1] + (v * wx_dy) * wz
            sg[i][2] = sg[i][2] + (v * wxy) * wdz
    vel = [cf * sv[i] for i in range(3)]
    g = [[cf * (invd * sg[i][j]) for j in range(3)] for i in range(3)]

    # --- particle update ---
    (ct, pt), cols = model_columns(tab_f, tab_i, ints, range(TAB_C, TAB_P + 8), (0, 1))
    is_fluid = ct == con.EOS_MONAGHAN_SPH
    p, pp = cols[TAB_C : TAB_C + 4], cols[TAB_P : TAB_P + 8]
    phase = row(r.phase)
    failed = row(r.failed) != 0.0
    mass, vol0, eh = row(r.mass), row(r.vol0), row(r.eh)
    f = [[row(r.defgrad + 3 * i + j) for j in range(3)] for i in range(3)]
    kin = [row(r.kinvel + ax) for ax in range(3)]

    vel = [torch.where(kinematic, kin[i], vel[i]) for i in range(3)]
    if velocity_clamp:
        over = (torch.abs(vel[0]) * dt >= h) | (torch.abs(vel[1]) * dt >= h) | (
            torch.abs(vel[2]) * dt >= h)
        vel = [torch.where(over, torch.sign(v) * (h / dt), v) for v in vel]
    pos = [row(r.pos + ax) + vel[ax] * dt for ax in range(3)]

    gf = cmat.matmul_c(g, f)
    f_solid = [[f[i][j] + dt * gf[i][j] for j in range(3)] for i in range(3)]
    # Fluids: J = F00 += tr(∇v)·dt·F00, the rest of F kept.
    det = sum(g[j][j] for j in range(3))
    f00_fluid = f[0][0] + det * dt * f[0][0]
    f = cmat.where_mat(is_fluid, f, f_solid)
    f[0][0] = torch.where(is_fluid, f00_fluid, f[0][0])

    u, s, v = svd_c(f)
    pdd, ph, lvg = row(r.pdd), row(r.ph), row(r.lvg)
    # Every lane runs the return map; lanes of other plastic types keep
    # their values (their zero DP parameters give NaN, which is masked).
    f2, pdd2, ph2, lvg2, s_sel = plas.drucker_prager_update_with_svd_c(
        pp, phase, f, pdd, ph, lvg, (u, s, v)
    )
    m = pt == plas.DRUCKER_PRAGER
    s = [torch.where(m, a, b) for a, b in zip(s_sel, s)]
    f = cmat.where_mat(m, f2, f)
    pdd = torch.where(m, pdd2, pdd)
    ph = torch.where(m, ph2, ph)
    lvg = torch.where(m, lvg2, lvg)

    vel = [torch.where(is_static, 0.0, x) for x in vel]
    g = cmat.where_mat(is_static, cmat.zeros_like_mat(g), g)

    broken = (cmat.det_c(f) == 0.0) | failed | (~is_fluid & (torch.abs(f[0][0]) > 1.0e4))
    f = cmat.where_mat(broken, cmat.identity_c(3, mass), f)
    g = cmat.where_mat(broken, cmat.zeros_like_mat(g), g)
    failed_new = failed | broken
    s = [torch.where(broken, 1.0, x) for x in s]

    corot = ct == con.COROTATED
    energy = torch.where(corot, con.corotated_pos_energy_from_s_c(p[0], p[1], eh, f, s), 0.0)
    psi_pos = torch.maximum(row(r.psi_pos), energy)

    oob = None
    for ax in range(3):
        b = torch.round(linalg.div(pos[ax] - grid.origin[ax], h)).to(torch.int32) - 1
        o = ~((b >= 0) & (b + 2 <= grid.res[ax] - 1))
        oob = o if oob is None else oob | o
    failed_new = failed_new | (active & oob)

    con_bound = timestep_bound_c(ct, p, eh, f, mass, vol0, vel, h, tab_i[:, 0].tolist())
    bound = dt_bound_row(h, vel, g, con_bound, failed_new, active)

    step_disp = torch.maximum(
        torch.maximum(torch.abs(vel[0]) * dt, torch.abs(vel[1]) * dt), torch.abs(vel[2]) * dt
    )
    cumd = row(r.cumd) + step_disp

    st = con.corotated_kirchhoff_stress_from_svd_c(p[0], p[1], p[3], phase, eh, f, u, s, v)
    st = [torch.where(corot, st[i][j], 0.0) for i in range(3) for j in range(i, 3)]

    rows = list(pos) + vel
    rows += [g[i][j] for i in range(3) for j in range(3)]
    rows += [f[i][j] for i in range(3) for j in range(3)]
    rows += [mass, vol0, phase, psi_pos, pdd, ph, eh, lvg, row(r.nacc)]
    rows += kin
    rows += [row(r.cpf), row(r.cthr), bound, failed_new.to(torch.float32), row(r.radius0),
             psi_pos * mass, mass, row(r.m_c), row(r.g), row(r.debug), cumd]
    rows += [torch.clamp(x, -L.BIGF, L.BIGF) for x in st]
    zero = torch.zeros_like(mass)
    rows += [zero] * (r.nf - len(rows))
    # Dead chunks pass through unchanged.
    return torch.cat([torch.stack(rows, dim=1), slots_all[n_live:]], dim=0)


def g2p_fused(grid: GridParams, cfg, meta, kparams, slots, ints, windows, dt,
              tab_f, tab_i, nchunks):
    """Kernel B (replaces sparkl_tpu/fused/kernels.py:g2p_fused): slots
    [D, 56, 128] f32 (updated IN PLACE on the card; the CPU path returns a
    new tensor), ints [D, 8, 128] i32, windows [D, 3, 512] f32 z-major,
    dt (python float), tables f32 [M, 16] / i32 [M, 4], nchunks [] i32.
    Returns the new slot tensor."""
    _check_meta(meta)
    d_, c = cfg.max_chunks, cfg.chunk_size
    dev = slots.device
    r = L.Rows(3)
    check_tensor("slots", slots, torch.float32, (d_, r.nf, c), dev)
    check_tensor("ints", ints, torch.int32, (d_, L.NI, c), dev)
    check_tensor("windows", windows, torch.float32, (d_, 3, region_cells(3)), dev)
    tab_f, tab_i, m = _check_tables((tab_f, tab_i), dev)
    check_tensor("nchunks", nchunks, torch.int32, (), dev)
    if c != 128:
        raise NotImplementedError(f"chunk size {c}: kernel B takes 128")
    args = _grid_args(grid)
    clamp = bool(kparams["gpu_velocity_clamp"])
    if route(dev) == "cpu":
        return g2p_fused_reference(grid, slots, ints, windows, dt, tab_f, tab_i,
                                   nchunks, velocity_clamp=clamp)
    launch("sparkl_g2p_fused", slots.data_ptr(), ints.data_ptr(),
           windows.data_ptr(), nchunks.data_ptr(), tab_f.data_ptr(),
           tab_i.data_ptr(), m, d_, float(dt), *args, int(clamp), stream_ptr(dev))
    LAUNCHES["g2p_fused"] += 1
    return slots
