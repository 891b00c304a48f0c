"""The fused substep's kernels: kernel A (P2G images), the block merge,
the scatter merge, kernel B (G2P + particle update), the fluid volume
pass's mass-only P2G and G2P, the eigenerosion pooling (with its lane-group
boxes), and the resort's source-row and permute kernels, each a
hand-written CUDA kernel
(csrc/fused_kernels.cu) with its plain PyTorch version beside it.

Port of sparkl_tpu/fused/kernels.py for the configurations the port
carries: corotated or neo-Hookean elasticity with optional Drucker-Prager,
NACC, Rankine or Snow plasticity, and the Monaghan EOS fluid with its
volume pass, in 3D and 2D (in 2D chunks of 64 slots with row-major window
cells); with the stress cache on (no damage, no failure) or off (kernel A
forms the stress from F: eigenerosion or modified eigenerosion with the
psi channels, maximum-stress failure; kernel B trips maximum stress, and
under modified eigenerosion the crack energy of the gathered psi).
Neo-Hookean and NACC, and Rankine and Snow in 3D, run in the kernels'
material instances (mats_form), so that the other scenes keep their code. `permute_chunks`,
the JAX package's older resort lane router, comes with its kernel too,
though no path calls it.
A wrapper runs the plain version when its tensors lie on the CPU and
launches the kernel when they lie on a CUDA device; anything else raises.
There is no fallback from a kernel to its plain version. Each wrapper
counts its kernel launches in LAUNCHES (the CPU path counts nothing).
"""

import numpy as np
import torch

from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.core.params import DamageModel
from sparkl_tpu_torch.cuda_build import check_tensor, launch, raw_stream, route, stream_ptr
from sparkl_tpu_torch.math import cmat, linalg
from sparkl_tpu_torch.math.kernel import inv_d as kernel_inv_d, quadratic_weights_1d
from sparkl_tpu_torch.math.svd import svd_c
from sparkl_tpu_torch.models import constitutive as con
from sparkl_tpu_torch.models import failure as fail
from sparkl_tpu_torch.models import plasticity as plas
from sparkl_tpu_torch.sparse import transfer as T
from sparkl_tpu_torch.sparse.blocks import default_chunk_size, region_cells
from sparkl_tpu_torch.fused import layout as L

# Packed model-table columns: f32 [M, 16] = cparams(0:4) | pparams(4:12) |
# fparams(12:14) | pad; i32 [M, 4] = ctype | ptype | ftype | pad.
TAB_C = 0
TAB_P = 4
TAB_F = 12

# Kernel launches per wrapper since the last reset_launch_counts().
LAUNCHES = {"p2g_fused": 0, "merge_blocks": 0, "merge_scatter": 0, "g2p_fused": 0,
            "mass_p2g_fused": 0, "mass_g2p_fused": 0, "src_rows_from_order": 0,
            "permute_slots": 0, "eigen_pool_fused": 0, "eigen_boxes": 0, "permute_chunks": 0}

_I32 = torch.int32

# Rows of the packed eigen tensor: pos (d), m·psi_pos, m, eligible; row 7
# of the candidate tensor flags "candidate == own chunk".
EIG_ROWS = 8
EIG_SELF = 7
# The pooling's lane groups (one warp each) and their boxes [D, C/32, 8]:
# lo x, y, z, 0, hi x, y, z, 0 of the group's eligible positions.
EIG_GROUP = 32
EIG_BOX = 8


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
    `meta` dict, sparkl_tpu/fused/pipeline.py:102-119); meta_unsupported
    says which of them the port carries. The stress cache is off for damage
    and failure scenes, whose phase changes between the kernels."""
    damage = params.damage_model
    return dict(
        with_psi=damage in (DamageModel.EIGENEROSION, DamageModel.MODIFIED_EIGENEROSION),
        m_count=models.num_models,
        present_c=models.present_c,
        present_p=models.present_p,
        present_f=models.present_f,
        damage_model=int(damage),
        stress_cache=damage == DamageModel.NONE and not models.present_f,
    )


def meta_unsupported(meta, dim):
    """Why the fused kernels cannot run this scene in `dim` dimensions: a
    list of reasons, empty if they can. Both dimensions run corotated and
    neo-Hookean solids with Drucker-Prager, NACC, Rankine or Snow
    plasticity, with the stress cache on or off (eigenerosion, modified
    eigenerosion, maximum-stress failure), and Monaghan EOS fluids. CD-MPM,
    custom models and other failure types are refused."""
    why = []
    if meta["damage_model"] not in (DamageModel.NONE, DamageModel.EIGENEROSION,
                                    DamageModel.MODIFIED_EIGENEROSION):
        why.append(f"damage model {DamageModel(meta['damage_model']).name}")
    if set(meta["present_c"]) - {con.COROTATED, con.NEO_HOOKEAN, con.EOS_MONAGHAN_SPH}:
        why.append(f"constitutive types {meta['present_c']}")
    if set(meta["present_p"]) - {plas.DRUCKER_PRAGER, plas.NACC, plas.RANKINE, plas.SNOW}:
        why.append(f"plastic types {meta['present_p']}")
    if set(meta["present_f"]) - {fail.MAXIMUM_STRESS}:
        why.append(f"failure types {meta['present_f']}")
    if dim not in (2, 3):
        why.append(f"{dim}D")
    return why


def mats_form(meta, dim):
    """Whether kernels A and B take their material instances: neo-Hookean
    or NACC present, or Rankine or Snow in 3D (the 2D instances without it
    carry Rankine and Snow already). The instances without it are the
    code of the scenes that need none of these, with their registers."""
    return bool(con.NEO_HOOKEAN in meta["present_c"] or plas.NACC in meta["present_p"]
                or (dim == 3 and set(meta["present_p"]) & {plas.RANKINE, plas.SNOW}))


def fluid_form(meta, dim):
    """Whether kernel B takes its fluid instance: every model the EOS fluid
    (no damage, no material instance), so that it compiles the fluid
    branch alone, with no SVD and no return map. It runs every lane as a
    fluid: a model id outside the table (which reads zeros, corotated)
    would differ there, and no pack writes one."""
    return (set(meta["present_c"]) == {con.EOS_MONAGHAN_SPH} and bool(meta["stress_cache"])
            and not mats_form(meta, dim))


def svd_reuse(stress_cache, present_c, present_p):
    """Kernel B's one-SVD path (sparkl_tpu/fused/kernels.py:1351-1356): with
    the stress cache on, corotated models present and Drucker-Prager the
    only plastic model, one SVD of the updated F serves the return map, the
    energy and the cached stress (DP only rescales singular values). Any
    other plastic model decomposes the F it receives, and the energy and
    the cache take one more SVD of the final F; the extra SVDs change the
    last bits, so the kernel follows the same choice."""
    return (bool(stress_cache) and con.COROTATED in present_c
            and set(present_p) <= {plas.DRUCKER_PRAGER})


def _check_meta(meta, dim):
    why = meta_unsupported(meta, dim)
    if why:
        raise NotImplementedError("fused kernels do not carry: " + ", ".join(why))


def _grid_args(grid: GridParams):
    """The kernels' grid constants, padded to three axes (a 2D grid passes
    z origin 0 and resolution 1)."""
    h = grid.cell_width
    pad = 3 - grid.dim
    # Constants derived from h in double, as the JAX kernels fold them.
    return ([float(o) for o in grid.origin] + [0.0] * pad
            + [h, kernel_inv_d(h), (h * h) / 4.0]
            + [int(r) for r in grid.res] + [1] * pad)


def _check_shape_route(name, dim, c):
    """The CUDA kernels are built for the two layouts the port carries:
    3D chunks of 128 slots and 2D chunks of 64."""
    if c != default_chunk_size(dim):
        raise NotImplementedError(
            f"{name}: chunk size {c} in {dim}D (the kernel takes {default_chunk_size(dim)})")


# ---------------------------------------------------------------------------
# Shared per-slot geometry of both kernels
# ---------------------------------------------------------------------------


def _slot_geometry(grid: GridParams, slots, ints):
    """Per axis: base cell, fx, window-relative base `rel`, and the masks
    in_window (rel in [0, 5]) and in_bounds (stencil inside the grid)."""
    h = grid.cell_width
    r = L.Rows(grid.dim)
    base, fx, rel = [], [], []
    in_window = in_bounds = None
    for ax in range(grid.dim):
        xg = linalg.div_const(slots[:, r.pos + ax, :] - grid.origin[ax], h)
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
    for ax in range(grid.dim):
        f = fx[ax]
        px = rel[ax].to(torch.float32) + f
        w.append(list(quadratic_weights_1d(f).unbind(-1)))
        dpt.append([((rel[ax] + k).to(torch.float32) - px) * h for k in range(3)])
    return w, dpt


_TAPS = [(a, b, c) for a in range(3) for b in range(3) for c in range(3)]
_TAPS2 = [(a, b) for a in range(3) for b in range(3)]


def _tap_cells(rel, contrib):
    """[D, 3^d, C] window cell of every tap (0 where the slot does not
    contribute): z-major q = z*64 + x*8 + y in 3D, row-major q = x*8 + y
    in 2D."""
    if len(rel) == 3:
        q = [(rel[2] + c) * 64 + (rel[0] + a) * 8 + (rel[1] + b) for a, b, c in _TAPS]
    else:
        q = [(rel[0] + a) * 8 + (rel[1] + b) for a, b in _TAPS2]
    return torch.where(contrib[:, None, :], torch.stack(q, dim=1), 0).long()


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
    the sound-speed bound for corotated and neo-Hookean solids, the EOS
    bound from J = F00, +inf for other model types. ct [D, C] model types, p the four constitutive
    parameter rows, vel the d velocity rows; present_c the model set's
    types (only their bounds are formed, with no host read)."""
    vnorm, vsq = _vnorm(vel)
    density0 = mass / torch.clamp(vol0, min=1e-30)
    out = torch.full_like(mass, float("inf"))
    if con.COROTATED in present_c or con.NEO_HOOKEAN in present_c:
        # The same sound-speed bound for both solids.
        b = con.corotated_timestep_bound_c(p[0], p[1], p[2], eh, density0, vnorm, h)
        out = torch.where((ct == con.COROTATED) | (ct == con.NEO_HOOKEAN), b, out)
    if con.EOS_MONAGHAN_SPH in present_c:
        fluid_j = f[0][0]
        density_fluid = density0 / torch.clamp(fluid_j, min=1e-20)
        b = con.eos_timestep_bound_c(p[0], p[1], p[3], fluid_j, mass, vol0, density_fluid,
                                     vsq, h, len(vel))
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
    apic_v = linalg.div_const(norm_b * 6.0 * float(np.sqrt(len(vel))), h)
    vtot = _vnorm(vel)[0] + apic_v
    vel_bound = torch.where(vtot > 0.0, linalg.rdiv(h, torch.clamp(vtot, min=1e-20)),
                            float("inf"))
    con_bound = torch.where(failed, float("inf"), con_bound)
    bound = torch.where(active, torch.minimum(vel_bound, con_bound), float("inf"))
    return torch.clamp(bound, max=L.BIGF)


def kirchhoff_stress_c(ct, p, phase, eh, f, g, mass, vol0, present_c, usv=None):
    """Fresh per-slot Kirchhoff stress (the JAX package's
    _kirchhoff_stress_c): corotated from an SVD of f (`usv`, if the caller
    has one), neo-Hookean in closed form, EOS from J = F00, zero for other
    model types. ct [D, C] model types, p the four constitutive parameter
    rows."""
    out = cmat.zeros_like_mat(f)
    if con.COROTATED in present_c:
        u, s, v = svd_c(f) if usv is None else usv
        st = con.corotated_kirchhoff_stress_from_svd_c(p[0], p[1], p[3], phase, eh, f, u, s, v)
        out = cmat.where_mat(ct == con.COROTATED, st, out)
    if con.NEO_HOOKEAN in present_c:
        st = con.neo_hookean_kirchhoff_stress_c(p[0], p[1], phase, eh, f)
        out = cmat.where_mat(ct == con.NEO_HOOKEAN, st, out)
    if con.EOS_MONAGHAN_SPH in present_c:
        out = cmat.where_mat(ct == con.EOS_MONAGHAN_SPH,
                             _eos_stress_c(p, mass, vol0, f[0][0], g), out)
    return out


def _sym_expand(st, dim):
    """Upper-triangle stress rows -> the full nested-list matrix."""
    if dim == 2:
        return [[st[0], st[1]], [st[1], st[2]]]
    return [[st[0], st[1], st[2]], [st[1], st[3], st[4]], [st[2], st[4], st[5]]]


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


def p2g_fused_reference(grid: GridParams, slots, ints, dt, nchunks, tables=None,
                        stress_cache=True, with_psi=False):
    """Plain version of kernel A: slots [D, NF, C] -> images [D, nf, 8^d]
    (mass, momentum d, and with `with_psi` the psi momentum and psi mass),
    z-major cells in 3D, row-major in 2D. Chunks >= nchunks are zero. Each
    slot scatters its 3^d taps (each cell summing its slots in ascending
    lane order, as the kernel does), w·(m v + A·dpt) with the APIC affine
    A = m ∇v − V0 D⁻¹ dt σ (zero stress for failed particles), masked by
    active & in-window & in-grid. σ comes from the stress-cache rows (with
    a fresh EOS stress for EOS slots when the model `tables` (tab_f, tab_i)
    are given), or, with `stress_cache` off, fresh from F through the
    tables (corotated through the SVD of F, neo-Hookean in closed form)."""
    dim = grid.dim
    r = L.Rows(dim)
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
    g = [[row(r.grad + dim * i + j) for j in range(dim)] for i in range(dim)]
    if stress_cache:
        stress = _sym_expand([row(r.stress + k) for k in range(r.nstress)], dim)
        if tables is not None:
            (ct,), p = model_columns(*tables, ints, range(TAB_C, TAB_C + 4))
            fluid = ct == con.EOS_MONAGHAN_SPH
            if bool(fluid.any()):
                s_eos = _eos_stress_c(p, mass, row(r.vol0), row(r.defgrad), g)
                stress = cmat.where_mat(fluid, s_eos, stress)
    else:
        (ct,), p = model_columns(*tables, ints, range(TAB_C, TAB_C + 4))
        f = [[row(r.defgrad + dim * i + j) for j in range(dim)] for i in range(dim)]
        stress = kirchhoff_stress_c(ct, p, row(r.phase), row(r.eh), f, g, mass, row(r.vol0),
                                    tables[1][:, 0].tolist())
    coeff = row(r.vol0) * invd * dt
    _, fx, rel, in_window, in_bounds = _slot_geometry(grid, slots, ints)
    contrib = active & in_window & in_bounds
    cf = contrib.to(torch.float32)
    # where, not a product with the mask: an empty lane's EOS stress is NaN
    # (0/0 densities), and the scatter below sends masked lanes to cell 0.
    a = [
        [torch.where(contrib, mass * g[i][j] - torch.where(failed, 0.0, coeff * stress[i][j]),
                     0.0)
         for j in range(dim)]
        for i in range(dim)
    ]
    m_c = mass * cf
    p0 = [m_c] + [m_c * row(r.vel + ax) for ax in range(dim)]
    if with_psi:
        phase, cpf = row(r.phase), row(r.cpf)
        psi_mass = torch.where((phase > 0.0) & (cpf != 0.0) & ~failed, mass, 0.0)
        p0 += [psi_mass * row(r.psi_pos) * cf, psi_mass * cf]
    w, dpt = _taps(grid, fx, rel)

    vals = []
    for tap in _TAPS if dim == 3 else _TAPS2:
        if dim == 3:
            ta, tb, tc = tap
            wxy = w[0][ta] * w[1][tb]
            wz = w[2][tc]
            wdx_y = (w[0][ta] * dpt[0][ta]) * w[1][tb]
            wx_dy = w[0][ta] * (w[1][tb] * dpt[1][tb])
            wdz = wz * dpt[2][tc]
            ch = [(p0[0] * wz) * wxy]
            for i in range(3):
                ch.append((p0[1 + i] * wz) * wxy + (a[i][2] * wdz) * wxy
                          + (a[i][0] * wz) * wdx_y + (a[i][1] * wz) * wx_dy)
            ch += [(x * wz) * wxy for x in p0[4:]]
        else:
            # Rows x, lanes y, as the JAX kernel's 2D form contracts them:
            # the affine x column rides the x taps, the y column the y taps.
            ta, tb = tap
            wx, wy = w[0][ta], w[1][tb]
            wdx, wdy = wx * dpt[0][ta], wy * dpt[1][tb]
            ch = [(p0[0] * wx) * wy]
            for i in range(2):
                ch.append((p0[1 + i] * wx + a[i][0] * wdx) * wy + (a[i][1] * wx) * wdy)
            ch += [(x * wx) * wy for x in p0[3:]]
        vals.append(torch.stack(ch, dim=1))  # [D, nf, C]
    nf, ntaps = len(p0), len(vals)
    # Lane-major [D, nf, C, 3^d], so that the scatter-add (in index order
    # on the CPU) sums each cell's slots in ascending lane order, as the
    # kernel's owner loop does: the same sum to the bit, term for term.
    vals = torch.stack(vals, dim=3).reshape(d_, nf, c * ntaps)
    q = _tap_cells(rel, contrib).transpose(1, 2).reshape(d_, 1, c * ntaps)
    q = q.expand(d_, nf, c * ntaps)
    out = torch.zeros((d_all, nf, region_cells(dim)), dtype=torch.float32, device=slots.device)
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
    [D, NF, C] f32 (3D: NF 56, C 128; 2D: 40, 64), ints [D, 8, C] i32, dt
    (python float), nchunks [] i32, the model tables (tab_f f32 [M, 16],
    tab_i i32 [M, 4]; needed when the scene has EOS fluids or the stress
    cache is off, when kernel A forms the stress itself) -> images
    [D, 1+d(+2), 8^d] f32, z-major cells in 3D (q = z*64 + x*8 + y),
    row-major in 2D (q = x*8 + y); the psi channels with meta["with_psi"]."""
    dim = grid.dim
    _check_meta(meta, dim)
    d_, c = cfg.max_chunks, cfg.chunk_size
    dev = slots.device
    r = L.Rows(dim)
    check_tensor("slots", slots, torch.float32, (d_, r.nf, c), dev)
    check_tensor("ints", ints, torch.int32, (d_, L.NI, c), dev)
    check_tensor("nchunks", nchunks, torch.int32, (), dev)
    stress_cache, with_psi = bool(meta["stress_cache"]), bool(meta["with_psi"])
    if (_has_eos(meta) or not stress_cache) and tables is None:
        raise ValueError("kernel A needs the model tables for EOS fluids or fresh stress")
    tab_f, tab_i, m = _check_tables(tables, dev) if tables is not None else (None, None, 0)
    args = _grid_args(grid)
    nf = 1 + dim + (2 if with_psi else 0)
    if route(dev) == "cpu":
        return p2g_fused_reference(grid, slots, ints, dt, nchunks, tables=tables,
                                   stress_cache=stress_cache, with_psi=with_psi)
    _check_shape_route("kernel A", dim, c)
    out = torch.empty((d_, nf, region_cells(dim)), dtype=torch.float32, device=dev)
    launch("sparkl_p2g_fused", slots.data_ptr(), ints.data_ptr(),
           nchunks.data_ptr(), tab_f.data_ptr() if m else None,
           tab_i.data_ptr() if m else None, m, out.data_ptr(), d_, float(dt), *args,
           dim, int(with_psi) | 2 * int(stress_cache) | 16 * int(mats_form(meta, dim)),
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
    """Plain version of the mass P2G: slots [D, NF, C] -> [D, 1, 8^d] mass
    images; each contributing slot adds to its 3^d cells the JAX kernel's
    factored product, (m·wz)·(wx·wy) in 3D (z-major cells) and (m·wx)·wy in
    2D (row-major), in ascending lane order per cell (as the kernel sums
    them). Chunks >= nchunks are zero."""
    dim = grid.dim
    r = L.Rows(dim)
    d_all = slots.shape[0]
    n_live = _live_count(nchunks, d_all)
    slots, ints = slots[:n_live], ints[:n_live]
    d_, _, c = slots.shape
    contrib, rel, w = _mass_geometry(grid, slots, ints)
    m_c = slots[:, r.mass, :] * contrib.to(torch.float32)
    if dim == 3:
        vals = [(m_c * w[2][tc]) * (w[0][ta] * w[1][tb]) for ta, tb, tc in _TAPS]
    else:
        vals = [(m_c * w[0][ta]) * w[1][tb] for ta, tb in _TAPS2]
    ntaps = len(vals)
    vals = torch.stack(vals, dim=2)  # [D, C, 3^d]: lane-major, so each cell sums in lane order
    q = _tap_cells(rel, contrib).transpose(1, 2)
    out = torch.zeros((d_all, 1, region_cells(dim)), dtype=torch.float32, device=slots.device)
    out[:n_live, 0].scatter_add_(1, q.reshape(d_, ntaps * c), vals.reshape(d_, ntaps * c))
    return out


def _check_mass_args(grid, cfg, slots, ints, nchunks):
    d_, c = cfg.max_chunks, cfg.chunk_size
    dev = slots.device
    check_tensor("slots", slots, torch.float32, (d_, L.Rows(grid.dim).nf, c), dev)
    check_tensor("ints", ints, torch.int32, (d_, L.NI, c), dev)
    check_tensor("nchunks", nchunks, torch.int32, (), dev)
    return d_, c, dev


def mass_p2g_fused(grid: GridParams, cfg, slots, ints, nchunks):
    """The mass P2G kernel (replaces sparkl_tpu/fused/kernels.py:
    mass_p2g_fused): slots [D, NF, C] f32 (3D: NF 56, C 128; 2D: 40, 64),
    ints [D, 8, C] i32, nchunks [] i32 -> [D, 1, 8^d] f32 mass images,
    z-major cells in 3D, row-major in 2D."""
    dim = grid.dim
    d_, c, dev = _check_mass_args(grid, cfg, slots, ints, nchunks)
    args = _grid_args(grid)
    if route(dev) == "cpu":
        return mass_p2g_fused_reference(grid, slots, ints, nchunks)
    _check_shape_route("the mass P2G kernel", dim, c)
    out = torch.empty((d_, 1, region_cells(dim)), dtype=torch.float32, device=dev)
    launch("sparkl_mass_p2g_fused", slots.data_ptr(), ints.data_ptr(), nchunks.data_ptr(),
           out.data_ptr(), d_, *args, dim, stream_ptr(dev))
    LAUNCHES["mass_p2g_fused"] += 1
    return out


def mass_g2p_fused_reference(grid: GridParams, slots, ints, windows, nchunks):
    """Plain version of the mass gather: windows [D, 1, 8^d] -> [D, 1, C],
    each contributing slot's Σ w·m over its 3^d cells in the JAX kernel's
    contraction order (3D, z-major: per z tap the xy sheet first, then the
    z weight; 2D, row-major: per x tap the y taps first, then the x
    weight), as the kernel sums; zero elsewhere. Chunks >= nchunks are
    zero."""
    dim = grid.dim
    d_all = slots.shape[0]
    n_live = _live_count(nchunks, d_all)
    slots, ints, windows = slots[:n_live], ints[:n_live], windows[:n_live]
    d_, _, c = slots.shape
    contrib, rel, w = _mass_geometry(grid, slots, ints)
    ntaps = 3**dim
    win = torch.gather(windows[:, 0], 1, _tap_cells(rel, contrib).reshape(d_, ntaps * c))
    win = win.reshape(d_, ntaps, c)
    acc = 0.0
    if dim == 3:
        for tc in range(3):
            sheet = 0.0
            for ta in range(3):
                for tb in range(3):
                    t = _TAPS.index((ta, tb, tc))
                    sheet = sheet + win[:, t] * (w[0][ta] * w[1][tb])
            acc = acc + sheet * w[2][tc]
    else:
        for ta in range(3):
            row = 0.0
            for tb in range(3):
                row = row + win[:, ta * 3 + tb] * w[1][tb]
            acc = acc + row * w[0][ta]
    out = torch.zeros((d_all, 1, c), dtype=torch.float32, device=slots.device)
    out[:n_live, 0] = contrib.to(torch.float32) * acc
    return out


def mass_g2p_fused(grid: GridParams, cfg, slots, ints, windows, nchunks):
    """The mass gather kernel (replaces sparkl_tpu/fused/kernels.py:
    mass_g2p_fused): slots [D, NF, C] f32 (3D: NF 56, C 128; 2D: 40, 64),
    ints [D, 8, C] i32, windows [D, 1, 8^d] f32 (z-major in 3D, row-major
    in 2D), nchunks [] i32 -> [D, 1, C] f32."""
    dim = grid.dim
    d_, c, dev = _check_mass_args(grid, cfg, slots, ints, nchunks)
    check_tensor("windows", windows, torch.float32, (d_, 1, region_cells(dim)), dev)
    args = _grid_args(grid)
    if route(dev) == "cpu":
        return mass_g2p_fused_reference(grid, slots, ints, windows, nchunks)
    _check_shape_route("the mass gather kernel", dim, c)
    out = torch.empty((d_, 1, c), dtype=torch.float32, device=dev)
    launch("sparkl_mass_g2p_fused", slots.data_ptr(), ints.data_ptr(), windows.data_ptr(),
           nchunks.data_ptr(), out.data_ptr(), d_, *args, dim, stream_ptr(dev))
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
    src_rows_from_order, which returns [D, 1, C]): order2 [D, 2, C] i32,
    shifts [D] i32 -> [D, C] i32, C = 128 (3D) or 64 (2D). On the card
    order2 must start on a 16-byte boundary: the kernel reads it in int4s.

    The kernel takes a few microseconds, less than the host takes to issue
    it, so the common case (CUDA operands that pass every check) is tested
    in one expression; anything else goes through check_tensor's raises."""
    d_, two, c = order2.shape
    if (order2.is_cuda and two == 2 and order2.dtype == _I32 and shifts.dtype == _I32
            and shifts.shape == (d_,) and shifts.device == order2.device
            and order2.is_contiguous() and shifts.is_contiguous() and (c == 64 or c == 128)):
        ptr = order2.data_ptr()
        if not ptr & 15:
            out = order2.new_empty(d_, c)
            launch("sparkl_src_rows_from_order", ptr, shifts.data_ptr(), out.data_ptr(), d_, c,
                   raw_stream(order2.get_device()))
            LAUNCHES["src_rows_from_order"] += 1
            return out
    dev = order2.device
    check_tensor("order2", order2, torch.int32, (d_, 2, c), dev)
    check_tensor("shifts", shifts, torch.int32, (d_,), dev)
    if not order2.is_cuda:
        route(dev)
        return src_rows_from_order_reference(order2, shifts)
    if c != 64 and c != 128:
        raise NotImplementedError(f"chunk size {c}: the source-row kernel takes 64 or 128")
    raise ValueError("order2: the source-row kernel needs a 16-byte aligned tensor")


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


# The permute kernel's instances: dim -> (NF, C).
_PERMUTE_FORMS = {dim: (L.Rows(dim).nf, default_chunk_size(dim)) for dim in (2, 3)}


def permute_slots(slots, ints, src, origin, r_cumd):
    """The permute kernel (replaces sparkl_tpu/fused/kernels.py:
    permute_chunks_dma): slots [D, NF, C] f32 (3D: NF 56, C 128; 2D: 40,
    64), ints [D, 8, C] i32, src [D, C] i32 source slot per destination
    slot (-1: empty), origin [D, d] i32 -> new (slots, ints), drift row
    zeroed and origin rows written.

    The TPU kernel takes the same permute as at most K = 8 whole source
    chunks per destination (DMA) and a per-lane routing among them (MXU),
    so its package computes that routing and falls back to a per-slot
    gather past K. On the card each lane copies its own source slot, so
    the kernel takes `src` directly and has no K limit."""
    dev = slots.device
    d_, nf, c = slots.shape
    dim = origin.shape[1]
    check_tensor("slots", slots, torch.float32, (d_, nf, c), dev)
    check_tensor("ints", ints, torch.int32, (d_, L.NI, c), dev)
    check_tensor("src", src, torch.int32, (d_, c), dev)
    check_tensor("origin", origin, torch.int32, (d_, dim), dev)
    if not slots.is_cuda:
        route(dev)
        return permute_slots_reference(slots, ints, src, origin, r_cumd)
    if (nf, c) != _PERMUTE_FORMS.get(dim):
        raise NotImplementedError(f"slots {tuple(slots.shape)}, dim {dim}: the permute "
                                  "kernel takes slots [D, 56, 128] in 3D, [D, 40, 64] in 2D")
    out_f = torch.empty_like(slots)
    out_i = torch.empty_like(ints)
    launch("sparkl_permute_slots", slots.data_ptr(), ints.data_ptr(), src.data_ptr(),
           origin.data_ptr(), out_f.data_ptr(), out_i.data_ptr(), d_, dim, int(r_cumd),
           stream_ptr(dev))
    LAUNCHES["permute_slots"] += 1
    return out_f, out_i



def permute_chunks_operands(slots, ints, src):
    """The JAX package's pre-gathered operands of permute_chunks from a
    per-slot source index src [D, C] (flat chunk·C + lane, -1 for empty),
    as its resort builds them (sparkl_tpu/fused/layout.py:519-539): each
    destination chunk's distinct source chunks in ascending order, their
    rows gathered[d, k] = slots[uniq[d, k]] (zero past the list), and the
    lane routing target[d, l] = k·C + source lane (K·C for empty), K the
    most distinct source chunks any destination has (a host read; the JAX
    package fixes K = 8 and falls back past it). Returns (gathered [D, K,
    NF, C] f32, gathered_i [D, K, NI, C] i32, target [D, C] i32)."""
    d_, c = src.shape
    valid = src >= 0
    sentinel = d_  # sorts after every chunk id
    src_chunk = torch.where(valid, src // c, sentinel)
    sc_sorted = torch.sort(src_chunk, dim=1).values
    prev = torch.cat([torch.full((d_, 1), -1, dtype=src.dtype, device=src.device),
                      sc_sorted[:, :-1]], dim=1)
    flag = (sc_sorted != prev) & (sc_sorted < sentinel)
    k = max(int(flag.sum(dim=1).max()), 1)
    rank = torch.cumsum(flag.to(torch.int32), dim=1) - 1
    uniq = torch.full((d_, k + 1), -1, dtype=torch.int32, device=src.device)
    uniq.scatter_(1, torch.where(flag, rank, k).long(), sc_sorted.to(torch.int32))
    uniq = uniq[:, :k]
    eq = src_chunk[:, :, None] == uniq[:, None, :]  # [D, C, K]
    k_of = torch.argmax(eq.to(torch.int32), dim=2).to(torch.int32)
    has = eq.any(dim=2) & valid
    target = torch.where(has, k_of * c + src % c, k * c).to(torch.int32)
    pad_f = torch.cat([slots, slots.new_zeros((1,) + slots.shape[1:])], dim=0)
    pad_i = torch.cat([ints, ints.new_zeros((1,) + ints.shape[1:])], dim=0)
    pick = torch.where(uniq >= 0, uniq, d_).long()
    return pad_f[pick].contiguous(), pad_i[pick].contiguous(), target.contiguous()


def permute_chunks_reference(gathered, gathered_i, target):
    """Plain version of permute_chunks: an indexed gather. Lane l of
    destination d takes column target[d, l] % C of gathered source chunk
    target[d, l] // C, f32 rows and int rows alike; target >= K·C gives
    zeros."""
    d_, k, nf, c = gathered.shape
    ni = gathered_i.shape[2]
    ok = (target >= 0) & (target < k * c)
    t = torch.where(ok, target, 0).long()[:, None, :]  # the column of [D, ., K·C]
    flat_f = gathered.permute(0, 2, 1, 3).reshape(d_, nf, k * c)
    flat_i = gathered_i.permute(0, 2, 1, 3).reshape(d_, ni, k * c)
    out_f = torch.gather(flat_f, 2, t.expand(d_, nf, c))
    out_i = torch.gather(flat_i, 2, t.expand(d_, ni, c))
    return (torch.where(ok[:, None, :], out_f, 0.0),
            torch.where(ok[:, None, :], out_i, 0))


def permute_chunks(gathered, gathered_i, target):
    """The lane-router kernel (replaces sparkl_tpu/fused/kernels.py:
    permute_chunks, the older resort permute; no path of either package
    calls it): gathered [D, K, F, C] f32, gathered_i [D, K, NI, C] i32,
    target [D, C] i32 -> (permuted f32 [D, F, C], permuted i32 [D, NI,
    C]), bit for bit. Any K; C = 64 or 128. The TPU kernel routes lanes
    with 0/1 selection matmuls and splits the ints into exact 16-bit
    halves for the MXU; each thread here copies its own lane's column."""
    dev = gathered.device
    d_, k, nf, c = gathered.shape
    ni = gathered_i.shape[2]
    check_tensor("gathered", gathered, torch.float32, (d_, k, nf, c), dev)
    check_tensor("gathered_i", gathered_i, torch.int32, (d_, k, ni, c), dev)
    check_tensor("target", target, torch.int32, (d_, c), dev)
    if route(dev) == "cpu":
        return permute_chunks_reference(gathered, gathered_i, target)
    if c not in (64, 128):
        raise NotImplementedError(f"chunk size {c}: the lane-router kernel takes 64 or 128")
    out_f = torch.empty((d_, nf, c), dtype=torch.float32, device=dev)
    out_i = torch.empty((d_, ni, c), dtype=torch.int32, device=dev)
    launch("sparkl_permute_chunks", gathered.data_ptr(), gathered_i.data_ptr(),
           target.data_ptr(), out_f.data_ptr(), out_i.data_ptr(), d_, k, nf, ni, c,
           stream_ptr(dev))
    LAUNCHES["permute_chunks"] += 1
    return out_f, out_i


# ---------------------------------------------------------------------------
# Kernel B: G2P + particle update + next dt bound
# ---------------------------------------------------------------------------


# Kernel B's row table (csrc/fused_kernels.cu SPARKL_B_ROWS holds the same,
# and the CPU tests parse it against this one): per slot field, the lane
# classes that read it for their physics and those whose physics can change
# it. A warp loads a row where some lane reads it or may change it and
# stores it where some lane may change it; a row no lane may change is one
# the kernel would write back as the bits it read.
LC_ALL = 1          # every lane
LC_SOLID = 2        # constitutive type not the EOS fluid
LC_BROKEN = 4       # the failure guard broke (det F = 0, already failed, |F00| blowup)
LC_DP = 8           # plastic type Drucker-Prager
LC_NACC = 16        # plastic type NACC
LC_RANKINE = 32     # plastic type Rankine
LC_SNOW = 64        # plastic type Snow
LC_TRIP = 128       # the damage form: modified eigenerosion, or maximum-stress failure
LC_KINEMATIC = 256  # the kinematic flag
LC_MODIFIED = 512   # the damage form under modified eigenerosion

# field: (readers, writers). defgrad_j is F00 (a fluid's J), defgrad_off the
# other d² - 1 entries of F, pad the rows past the stress rows.
B_ROWS = {
    "pos": (LC_ALL, LC_ALL),
    "vel": (0, LC_ALL),
    "grad": (0, LC_ALL),
    "defgrad_j": (LC_ALL, LC_ALL),
    "defgrad_off": (LC_ALL, LC_SOLID | LC_BROKEN),
    "mass": (LC_ALL, 0),
    "vol0": (LC_ALL, 0),
    "phase": (LC_SOLID | LC_MODIFIED, LC_TRIP),
    "psi_pos": (LC_ALL, LC_ALL),
    "pdd": (LC_DP | LC_SNOW, LC_DP | LC_SNOW),
    "ph": (LC_DP | LC_RANKINE, LC_DP | LC_RANKINE),
    "eh": (LC_SOLID, LC_SNOW),
    "lvg": (LC_DP, LC_DP),
    "nacc": (LC_NACC, LC_NACC),
    "kinvel": (LC_KINEMATIC, 0),
    "cpf": (LC_MODIFIED, 0),
    "cthr": (LC_MODIFIED, 0),
    "dtb": (0, LC_ALL),
    "failed": (LC_ALL, LC_ALL),
    "radius0": (0, 0),
    "par1": (0, LC_ALL),
    "par2": (0, LC_ALL),
    "m_c": (0, 0),
    "g": (0, 0),
    "debug": (0, 0),
    "cumd": (LC_ALL, LC_ALL),
    "stress": (0, LC_ALL),
    "pad": (0, LC_ALL),
}


def b_field_rows(dim):
    """B_ROWS's fields -> their slot rows in `dim` dimensions."""
    r = L.Rows(dim)
    rows = {"defgrad_j": [r.defgrad],
            "defgrad_off": list(range(r.defgrad + 1, r.defgrad + dim * dim)),
            "stress": list(range(r.stress, r.stress + r.nstress)),
            "pad": list(range(r.stress + r.nstress, r.nf))}
    for name, n in (("pos", dim), ("vel", dim), ("grad", dim * dim), ("kinvel", dim)):
        rows[name] = list(range(getattr(r, name), getattr(r, name) + n))
    for name in B_ROWS:
        if name not in rows:
            rows[name] = [getattr(r, name)]
    return rows


def b_lane_classes(meta, tab_i, ints, slots_out):
    """Per lane [D, C] i32: its classes in B_ROWS's terms, as kernel B forms
    them (a model id outside the table reads zeros). LC_BROKEN is read off
    the output's failed row, a superset of the lanes the guard broke (it
    also holds the lanes marked out of the grid)."""
    dim = 3 if ints.shape[2] == default_chunk_size(3) else 2
    (ct, pt, ft), _ = model_columns(tab_i, tab_i, ints, (), (0, 1, 2))
    flags = ints[:, L.I_FLAGS, :]
    damage = not meta["stress_cache"]
    modified = damage and meta["damage_model"] == DamageModel.MODIFIED_EIGENEROSION
    cls = torch.full_like(ct, LC_ALL)
    cls |= torch.where(ct != con.EOS_MONAGHAN_SPH, LC_SOLID, 0)
    cls |= torch.where(slots_out[:, L.Rows(dim).failed, :] != 0.0, LC_BROKEN, 0)
    for code, bit in ((plas.DRUCKER_PRAGER, LC_DP), (plas.NACC, LC_NACC),
                      (plas.RANKINE, LC_RANKINE), (plas.SNOW, LC_SNOW)):
        cls |= torch.where(pt == code, bit, 0)
    if damage:
        cls |= LC_TRIP if modified else torch.where(ft == fail.MAXIMUM_STRESS, LC_TRIP, 0)
    if modified:
        cls |= LC_MODIFIED
    cls |= torch.where((flags & L.KINEMATIC) != 0, LC_KINEMATIC, 0)
    return cls.to(torch.int32)


def b_unchanged(meta, tab_i, ints, slots_out, nchunks, table=None):
    """[D, NF, C] bool: the slot rows that kernel B leaves as they were, by
    the row table (`table`, B_ROWS by default): on a live lane each row
    that none of the lane's classes may change, on a dead chunk every row.
    The kernel's own rows are a superset: a warp writes a row back where
    any of its lanes may change it."""
    table = B_ROWS if table is None else table
    d_, nf, c = slots_out.shape
    dim = 3 if c == default_chunk_size(3) else 2
    cls = b_lane_classes(meta, tab_i, ints, slots_out)
    out = torch.ones((d_, nf, c), dtype=torch.bool, device=slots_out.device)
    live = torch.arange(d_, device=slots_out.device) < int(nchunks)
    for name, rows in b_field_rows(dim).items():
        kept = ~live[:, None] | ((cls & table[name][1]) == 0)
        out[:, rows, :] = kept[:, None, :]
    return out


def _gather(grid: GridParams, w, dpt, win, cf):
    """Kernel B's gather: velocity [d] and gradient [d][d] rows from the
    window values at each tap, win [D, n, 3^d, C] (n >= d channels), in
    the kernel's order of sums, and with n > d the psi channel (channel d)
    gathered as a velocity component is (else None)."""
    dim = grid.dim
    invd = kernel_inv_d(grid.cell_width)
    nv = win.shape[1]  # velocity channels, then the psi channel
    if dim == 3:
        sv = [0.0] * nv
        sg = [[0.0] * 3 for _ in range(3)]
        for t, (ta, tb, tc) in enumerate(_TAPS):
            wz = w[2][tc]
            wxy = w[0][ta] * w[1][tb]
            wdx_y = (w[0][ta] * dpt[0][ta]) * w[1][tb]
            wx_dy = w[0][ta] * (w[1][tb] * dpt[1][tb])
            wdz = wz * dpt[2][tc]
            for i in range(nv):
                v = win[:, i, t, :]
                sv[i] = sv[i] + (v * wxy) * wz
                if i < 3:
                    sg[i][0] = sg[i][0] + (v * wdx_y) * wz
                    sg[i][1] = sg[i][1] + (v * wx_dy) * wz
                    sg[i][2] = sg[i][2] + (v * wxy) * wdz
    else:
        # Per x tap the y taps first (the lanes of the JAX kernel's
        # [n*8, 8] @ [8, C] contraction), then the x weights.
        sv = [0.0] * nv
        sg = [[0.0] * 2 for _ in range(2)]
        for ta in range(3):
            wx = w[0][ta]
            wdx = wx * dpt[0][ta]
            for i in range(nv):
                tv = ty = 0.0
                for tb in range(3):
                    v = win[:, i, ta * 3 + tb, :]
                    tv = tv + v * w[1][tb]
                    if i < 2:
                        ty = ty + v * (w[1][tb] * dpt[1][tb])
                sv[i] = sv[i] + tv * wx
                if i < 2:
                    sg[i][0] = sg[i][0] + tv * wdx
                    sg[i][1] = sg[i][1] + ty * wx
    vel = [cf * sv[i] for i in range(dim)]
    g = [[cf * (invd * sg[i][j]) for j in range(dim)] for i in range(dim)]
    return vel, g, (cf * sv[dim] if nv > dim else None)


def g2p_fused_reference(grid: GridParams, slots, ints, windows, dt, tab_f, tab_i,
                        nchunks, velocity_clamp=False, stress_cache=True, modified=False):
    """Plain version of kernel B: returns the new slot tensor [D, NF, C]
    (chunks >= nchunks pass through). Gathers v and ∇v from the windows
    [D, n_win, 8^d]; with `modified` (modified eigenerosion) also the psi
    channel after the velocity, and a crack slot (cpf != 0, unbroken) whose
    cpf·h·psi exceeds its threshold breaks (phase 0) before the return map
    (sparkl_tpu/fused/kernels.py:1306-1310). It then advects,
    updates F (for EOS fluids only J = F00, by tr(∇v)), applies the static
    and failure guards (no |F00| guard for fluids), accumulates the
    positive energy and par1 = psi_pos·m, par2 = m, trips maximum-stress
    failure (phase = 0) on a fresh stress of the final F, marks particles
    out of the grid, and writes the next dt bound and the accumulated
    drift. The return maps run in the JAX order, Drucker-Prager, NACC
    (with the nacc row), Rankine, Snow, each on every lane and kept where
    the model's plastic type is its own. Under svd_reuse one SVD serves the
    Drucker-Prager return map, the energy and the stress-cache epilogue
    (zero stress rows for fluids); otherwise each return map decomposes its
    own F, and one SVD of the final F serves the corotated energy and
    either the cached stress or, with the cache off, the failure stress
    (the stress rows then zero). Neo-Hookean slots take their energy,
    cached or failure stress and dt bound in closed form."""
    dim = grid.dim
    r = L.Rows(dim)
    n_live = _live_count(nchunks, slots.shape[0])
    slots_all = slots
    slots, ints, windows = slots[:n_live], ints[:n_live], windows[:n_live]
    d_, _, c = slots.shape
    h = grid.cell_width

    def row(k):
        return slots[:, k, :]

    flags = ints[:, L.I_FLAGS, :]
    active = (flags & L.ACTIVE) != 0
    is_static = (flags & L.STATIC) != 0
    kinematic = (flags & L.KINEMATIC) != 0

    # --- gather ---
    _, fx, rel, in_window, in_bounds = _slot_geometry(grid, slots, ints)
    contrib = active & in_window & in_bounds
    w, dpt = _taps(grid, fx, rel)
    ntaps = 3**dim
    nw = dim + 1 if modified else dim
    q = _tap_cells(rel, contrib).reshape(d_, 1, ntaps * c).expand(d_, nw, ntaps * c)
    win = torch.gather(windows[:, :nw], 2, q).reshape(d_, nw, ntaps, c)
    vel, g, psi_mom = _gather(grid, w, dpt, win, contrib.to(torch.float32))

    # --- particle update ---
    # Host reads: the plain version is off the main path.
    present_c = tab_i[:, 0].tolist()
    present_p = set(tab_i[:, 1].tolist()) - {plas.PLASTIC_NONE}
    reuse = svd_reuse(stress_cache, present_c, present_p)
    (ct, pt, ft), cols = model_columns(tab_f, tab_i, ints, range(16), (0, 1, 2))
    is_fluid = ct == con.EOS_MONAGHAN_SPH
    p, pp, fp = cols[TAB_C : TAB_C + 4], cols[TAB_P : TAB_P + 8], cols[TAB_F : TAB_F + 2]
    phase = row(r.phase)
    failed = row(r.failed) != 0.0
    mass, vol0, eh = row(r.mass), row(r.vol0), row(r.eh)
    f = [[row(r.defgrad + dim * i + j) for j in range(dim)] for i in range(dim)]
    kin = [row(r.kinvel + ax) for ax in range(dim)]
    if modified:
        cpf = row(r.cpf)
        crack_energy = cpf * h * psi_mom
        trip = (cpf != 0.0) & (phase > 0.0) & (crack_energy > row(r.cthr))
        phase = torch.where(trip, 0.0, phase)

    vel = [torch.where(kinematic, kin[i], vel[i]) for i in range(dim)]
    if velocity_clamp:
        over = torch.abs(vel[0]) * dt >= h
        for v in vel[1:]:
            over = over | (torch.abs(v) * dt >= h)
        vel = [torch.where(over, torch.sign(v) * (h / dt), v) for v in vel]
    pos = [row(r.pos + ax) + vel[ax] * dt for ax in range(dim)]

    gf = cmat.matmul_c(g, f)
    f_solid = [[f[i][j] + dt * gf[i][j] for j in range(dim)] for i in range(dim)]
    # Fluids: J = F00 += tr(∇v)·dt·F00, the rest of F kept.
    det = sum(g[j][j] for j in range(dim))
    f00_fluid = f[0][0] + det * dt * f[0][0]
    f = cmat.where_mat(is_fluid, f, f_solid)
    f[0][0] = torch.where(is_fluid, f00_fluid, f[0][0])

    pdd, ph, lvg, nacc = row(r.pdd), row(r.ph), row(r.lvg), row(r.nacc)
    # Every lane runs each present return map; lanes of other plastic
    # types keep their values (their parameters may give NaN, masked).
    if reuse:
        u, s, v = svd_c(f)
    if plas.DRUCKER_PRAGER in present_p:
        m = pt == plas.DRUCKER_PRAGER
        if reuse:
            f2, pdd2, ph2, lvg2, s_sel = plas.drucker_prager_update_with_svd_c(
                pp, phase, f, pdd, ph, lvg, (u, s, v))
            s = [torch.where(m, a, b) for a, b in zip(s_sel, s)]
        else:
            f2, pdd2, ph2, lvg2 = plas.drucker_prager_update_c(pp, phase, f, pdd, ph, lvg)
        f = cmat.where_mat(m, f2, f)
        pdd = torch.where(m, pdd2, pdd)
        ph = torch.where(m, ph2, ph)
        lvg = torch.where(m, lvg2, lvg)
    if plas.NACC in present_p:
        m = pt == plas.NACC
        f2, na2 = plas.nacc_update_c(pp[:6], f, nacc)
        f = cmat.where_mat(m, f2, f)
        nacc = torch.where(m, na2, nacc)
    if plas.RANKINE in present_p:
        m = pt == plas.RANKINE
        f2, ph2 = plas.rankine_update_c(pp[:4], f, ph)
        f = cmat.where_mat(m, f2, f)
        ph = torch.where(m, ph2, ph)
    if plas.SNOW in present_p:
        m = pt == plas.SNOW
        f2, eh2, pdd2 = plas.snow_update_c(pp[:3], f, eh, pdd)
        f = cmat.where_mat(m, f2, f)
        eh = torch.where(m, eh2, eh)
        pdd = torch.where(m, pdd2, pdd)

    vel = [torch.where(is_static, 0.0, x) for x in vel]
    g = cmat.where_mat(is_static, cmat.zeros_like_mat(g), g)

    broken = (cmat.det_c(f) == 0.0) | failed | (~is_fluid & (torch.abs(f[0][0]) > 1.0e4))
    f = cmat.where_mat(broken, cmat.identity_c(dim, mass), f)
    g = cmat.where_mat(broken, cmat.zeros_like_mat(g), g)
    failed_new = failed | broken
    if reuse:
        s = [torch.where(broken, 1.0, x) for x in s]
    else:
        u, s, v = svd_c(f)

    corot = ct == con.COROTATED
    neo = ct == con.NEO_HOOKEAN
    energy = torch.where(corot, con.corotated_pos_energy_from_s_c(p[0], p[1], eh, f, s), 0.0)
    if con.NEO_HOOKEAN in present_c:
        energy = torch.where(neo, con.neo_hookean_pos_energy_c(p[0], p[1], phase, eh, f), energy)
    psi_pos = torch.maximum(row(r.psi_pos), energy)

    if bool((ft == fail.MAXIMUM_STRESS).any()):
        st_f = kirchhoff_stress_c(ct, p, phase, eh, f, g, mass, vol0, present_c, (u, s, v))
        trip = (ft == fail.MAXIMUM_STRESS) & fail.maximum_stress_failed_c(fp[0], fp[1], st_f)
        phase = torch.where(trip, 0.0, phase)

    oob = None
    for ax in range(dim):
        b = torch.round(linalg.div_const(pos[ax] - grid.origin[ax], h)).to(torch.int32) - 1
        o = ~((b >= 0) & (b + 2 <= grid.res[ax] - 1))
        oob = o if oob is None else oob | o
    failed_new = failed_new | (active & oob)

    con_bound = timestep_bound_c(ct, p, eh, f, mass, vol0, vel, h, present_c)
    bound = dt_bound_row(h, vel, g, con_bound, failed_new, active)

    step_disp = torch.abs(vel[0]) * dt
    for x in vel[1:]:
        step_disp = torch.maximum(step_disp, torch.abs(x) * dt)
    cumd = row(r.cumd) + step_disp

    rows = list(pos) + vel
    rows += [g[i][j] for i in range(dim) for j in range(dim)]
    rows += [f[i][j] for i in range(dim) for j in range(dim)]
    rows += [mass, vol0, phase, psi_pos, pdd, ph, eh, lvg, nacc]
    rows += kin
    rows += [row(r.cpf), row(r.cthr), bound, failed_new.to(torch.float32), row(r.radius0),
             psi_pos * mass, mass, row(r.m_c), row(r.g), row(r.debug), cumd]
    if stress_cache:
        st = con.corotated_kirchhoff_stress_from_svd_c(p[0], p[1], p[3], phase, eh, f, u, s, v)
        st = cmat.where_mat(corot, st, cmat.zeros_like_mat(st))
        if con.NEO_HOOKEAN in present_c:
            st = cmat.where_mat(neo, con.neo_hookean_kirchhoff_stress_c(p[0], p[1], phase, eh, f),
                                st)
        rows += [torch.clamp(st[i][j], -L.BIGF, L.BIGF) for i in range(dim) for j in range(i, dim)]
    zero = torch.zeros_like(mass)
    rows += [zero] * (r.nf - len(rows))
    # Dead chunks pass through unchanged.
    return torch.cat([torch.stack(rows, dim=1), slots_all[n_live:]], dim=0)


def g2p_fused_plain(grid: GridParams, cfg, slots, ints, fields, corners, dt, tab_f, tab_i,
                    nchunks, **kw):
    """Kernel B's plain version on its wrapper's arguments: the windows
    gathered from the window fields at the chunks' corner blocks (the
    port's gather_grid_windows), then g2p_fused_reference (keywords
    passed on)."""
    windows = T.windows_from_corners(grid, cfg, corners, fields,
                                     T.ZMAJOR_ORDER_3D if grid.dim == 3 else None)
    return g2p_fused_reference(grid, slots, ints, windows, dt, tab_f, tab_i, nchunks, **kw)


def g2p_fused(grid: GridParams, cfg, meta, kparams, slots, ints, fields, corners, dt,
              tab_f, tab_i, nchunks):
    """Kernel B (replaces sparkl_tpu/fused/kernels.py:g2p_fused): slots
    [D, NF, C] f32 (3D: NF 56, C 128; 2D: 40, 64; updated IN PLACE on the
    card, the CPU path returns a new tensor), ints [D, 8, C] i32, the window
    fields [MAX_GRID_BLOCKS + 1, d(+1) · 4^d] f32 (per node-table block the
    grid velocity, channel-major, and the psi ratio with meta["with_psi"];
    16-byte aligned), corners [D, 2^d] i32 (each chunk's corner blocks'
    rows in it: the structure's _chunk_corners), dt (python float), tables
    f32 [M, 16] / i32 [M, 4], nchunks [] i32. Returns the new slot tensor.
    The JAX kernel takes the windows that XLA gathers ([D, d(+1), 8^d]);
    the CUDA kernel reads the fields at the corners itself, and on the CPU
    g2p_fused_plain gathers them. Under modified eigenerosion the kernel
    reads the psi channel and trips the crack energy; under eigenerosion
    the channel is not read (the pooling trips)."""
    dim = grid.dim
    _check_meta(meta, dim)
    d_, c = cfg.max_chunks, cfg.chunk_size
    dev = slots.device
    r = L.Rows(dim)
    n_win = dim + (1 if meta["with_psi"] else 0)
    check_tensor("slots", slots, torch.float32, (d_, r.nf, c), dev)
    check_tensor("ints", ints, torch.int32, (d_, L.NI, c), dev)
    check_tensor("fields", fields, torch.float32,
                 (cfg.max_grid_blocks + 1, n_win * region_cells(dim) // 2**dim), dev)
    check_tensor("corners", corners, torch.int32, (d_, 2**dim), dev)
    tab_f, tab_i, m = _check_tables((tab_f, tab_i), dev)
    check_tensor("nchunks", nchunks, torch.int32, (), dev)
    args = _grid_args(grid)
    clamp = bool(kparams["gpu_velocity_clamp"])
    stress_cache = bool(meta["stress_cache"])
    modified = meta["damage_model"] == DamageModel.MODIFIED_EIGENEROSION
    if route(dev) == "cpu":
        return g2p_fused_plain(grid, cfg, slots, ints, fields, corners, dt, tab_f, tab_i,
                               nchunks, velocity_clamp=clamp, stress_cache=stress_cache,
                               modified=modified)
    _check_shape_route("kernel B", dim, c)
    reuse = svd_reuse(stress_cache, meta["present_c"], meta["present_p"])
    launch("sparkl_g2p_fused", slots.data_ptr(), ints.data_ptr(), fields.data_ptr(),
           corners.data_ptr(), nchunks.data_ptr(), tab_f.data_ptr(),
           tab_i.data_ptr(), m, d_, float(dt), *args, dim, n_win,
           int(clamp) | 2 * int(stress_cache) | 4 * int(reuse) | 8 * int(modified)
           | 16 * int(mats_form(meta, dim)) | 32 * int(fluid_form(meta, dim)), stream_ptr(dev))
    LAUNCHES["g2p_fused"] += 1
    return slots


# ---------------------------------------------------------------------------
# Eigenerosion pooling: per eligible slot, the sums of m·psi_pos and m over
# the eligible slots of its candidate chunks within one cell width
# ---------------------------------------------------------------------------


def eigen_candidate_rows(e, cand):
    """The JAX package's candidate tensor g [D, KN, 8, C] from the eigen
    rows e [D, 8, C] and the candidate chunk ids cand [D, KN] (D = none):
    each candidate chunk's rows, zero for none, and row EIG_SELF = 1 where
    the candidate is the own chunk (sparkl_tpu/fused/pipeline.py:416-429)."""
    d_, _, c = e.shape
    e_pad = torch.cat([e, e.new_zeros((1, EIG_ROWS, c))], dim=0)
    g = e_pad[cand.long()]
    own = torch.arange(d_, dtype=cand.dtype, device=cand.device)[:, None]
    g[:, :, EIG_SELF, :] = (cand == own).to(torch.float32)[:, :, None]
    return g


def eigen_pool_fused_reference(grid: GridParams, e, g, group=None):
    """Plain version of the pooling, with the JAX package's signature
    (sparkl_tpu/fused/kernels.py:eigen_pool_fused): e [D, 8, C] own rows
    (pos d, m·psi_pos, m, eligible), g [D, KN, 8, C] candidate rows ->
    [D, 8, C], rows 0 and 1 the pooled m·psi_pos and m of each eligible own
    lane over the eligible candidate lanes with squared distance <= h²,
    the lane itself excluded; zero elsewhere. Each candidate's lanes are
    summed first, then the candidates in ascending order, as the TPU
    kernel's loop does. Runs `group` chunks at a time (by default as many as
    hold 64 chunks of the 2D list, 18 candidates of 64 lanes: 4 in 3D), and
    skips a group with no eligible lane on either side (its pool is zero)."""
    dim = grid.dim
    d_, kn, _, c = g.shape
    if group is None:
        group = max(1, 64 * 18 * 64 * 64 // (kn * c * c))
    r2 = float(np.float32(grid.cell_width * grid.cell_width))  # h² rounded to f32, as JAX compares
    eye = torch.eye(c, dtype=torch.float32, device=e.device)
    out = torch.zeros_like(e)
    for g0 in range(0, d_, group):
        eg, gg = e[g0 : g0 + group], g[g0 : g0 + group]
        if not (bool(eg[:, dim + 2].any()) and bool(gg[:, :, dim + 2].any())):
            continue
        d2 = None
        for ax in range(dim):
            diff = gg[:, :, ax, :, None] - eg[:, None, ax, None, :]  # [G, KN, C cand, C own]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        pf = ((d2 <= r2).to(torch.float32) * eg[:, None, None, dim + 2, :]
              * gg[:, :, dim + 2, :, None])
        pf = pf * (1.0 - eye * gg[:, :, EIG_SELF, 0][:, :, None, None])
        for ch in range(2):
            part = (pf * gg[:, :, dim + ch, :, None]).sum(dim=2)  # [G, KN, C own]
            acc = torch.zeros_like(part[:, 0])
            for k in range(kn):
                acc = acc + part[:, k]
            out[g0 : g0 + group, ch] = acc
    return out


def eigen_boxes_reference(e, dim):
    """Plain version of the box kernel: e [D, 8, C] eigen rows -> [D, C/32,
    8] f32, per group of 32 lanes the bounding box of its eligible lanes'
    positions (lo x, y(, z), hi x, y(, z), the other entries 0); +inf / -inf
    for a group with none. NaN positions are left out: they pair with
    nothing."""
    d_, _, c = e.shape
    g = c // EIG_GROUP
    pos = e[:, :dim, :].reshape(d_, dim, g, EIG_GROUP)
    ok = (e[:, dim + 2, :] != 0.0).reshape(d_, 1, g, EIG_GROUP) & ~torch.isnan(pos)
    out = torch.zeros((d_, g, EIG_BOX), dtype=torch.float32, device=e.device)
    out[:, :, 0:dim] = torch.where(ok, pos, float("inf")).amin(dim=3).transpose(1, 2)
    out[:, :, 4 : 4 + dim] = torch.where(ok, pos, float("-inf")).amax(dim=3).transpose(1, 2)
    return out


def eigen_group_pairs(grid: GridParams, e, cand):
    """The pooling kernel's cull, in plain PyTorch: [D, KN, G, G] bool,
    True where own group go and group gc of candidate k may hold a pair
    (their boxes' gap² is not over h²); False for no candidate. A
    candidate with none is skipped, and a warp tests only the candidate's
    groups that pair with it. The gap² is formed as the pair test forms
    d2: per axis the difference candidate minus own of the nearer faces (0
    where the boxes overlap), its square, and the sum over axes in order.
    Rounding is monotone, so it is never more than the d2 of any pair of
    lanes in the boxes: the cull drops no pair."""
    dim = grid.dim
    d_, kn = cand.shape
    boxes = eigen_boxes_reference(e, dim)
    pad = torch.cat([boxes, torch.full_like(boxes[:1], float("nan"))])
    cb = pad[torch.clamp(cand.long(), 0, d_)][:, :, None, :, :]  # [D, KN, 1, G, 8]
    ob = boxes[:, None, :, None, :]  # [D, 1, G, 1, 8]
    gap2 = None
    for ax in range(dim):
        clo, chi, olo, ohi = cb[..., ax], cb[..., 4 + ax], ob[..., ax], ob[..., 4 + ax]
        diff = torch.where(clo > ohi, clo - ohi, torch.where(chi < olo, chi - olo, 0.0))
        gap2 = diff * diff if gap2 is None else gap2 + diff * diff
    r2 = torch.tensor(float(np.float32(grid.cell_width * grid.cell_width)))
    valid = ((cand >= 0) & (cand < d_))[:, :, None, None]
    return valid & ~(gap2 > r2)


def eigen_pool_work(grid: GridParams, e, cand):
    """What the pooling kernel's cull leaves, by eigen_group_pairs: chunks
    skipped (no eligible lane), candidates kept, and pair tests run (each
    eligible lane of a warp tests 32 lanes of every candidate group near
    its own group's box), of a chunk that is not skipped."""
    dim = grid.dim
    d_, _, c = e.shape
    el = e[:, dim + 2, :] != 0.0
    live = el.any(dim=1)
    pairs = eigen_group_pairs(grid, e, cand) & live[:, None, None, None]
    per_group = el.reshape(d_, c // EIG_GROUP, EIG_GROUP).sum(dim=2)  # [D, G]
    tests = (pairs.sum(dim=3) * per_group[:, None, :]).sum() * EIG_GROUP
    return dict(skipped=int((~live).sum()), kept=int(pairs.any(dim=3).any(dim=2).sum()),
                tests=int(tests))


def eigen_boxes(grid: GridParams, cfg, e):
    """The box kernel alone (the pooling's launcher runs it before the
    pooling): e [D, 8, C] f32 -> [D, C/32, 8] f32."""
    dim = grid.dim
    d_, c = cfg.max_chunks, cfg.chunk_size
    dev = e.device
    check_tensor("e", e, torch.float32, (d_, EIG_ROWS, c), dev)
    if route(dev) == "cpu":
        return eigen_boxes_reference(e, dim)
    _check_shape_route("the box kernel", dim, c)
    out = torch.empty((d_, c // EIG_GROUP, EIG_BOX), dtype=torch.float32, device=dev)
    launch("sparkl_eigen_boxes", e.data_ptr(), out.data_ptr(), d_, dim, stream_ptr(dev))
    LAUNCHES["eigen_boxes"] += 1
    return out


def eigen_pool_fused(grid: GridParams, cfg, e, cand, work=None):
    """The pooling kernel (replaces sparkl_tpu/fused/kernels.py:
    eigen_pool_fused): e [D, 8, C] f32 eigen rows (3D: C 128, 2D: 64),
    cand [D, KN] i32 candidate chunk ids (D = none; KN = 3^d times the
    chunks per block) -> [D, 2, C] f32, the pooled m·psi_pos and m. The TPU
    kernel takes the candidates' rows gathered in XLA
    ([D, KN, 8, C]); the CUDA launcher forms the lane-group boxes (the box
    kernel) and pools from e and cand directly, and on the CPU
    eigen_candidate_rows builds that tensor for the plain version. `work`,
    an int64 [3] tensor on e's device, takes the counts of chunks skipped,
    candidates kept and pair tests run (added to it): the kernel's own, and
    on the CPU the plain cull's (eigen_pool_work)."""
    dim = grid.dim
    d_, c = cfg.max_chunks, cfg.chunk_size
    dev = e.device
    kn = cand.shape[1]
    check_tensor("e", e, torch.float32, (d_, EIG_ROWS, c), dev)
    check_tensor("cand", cand, torch.int32, (d_, kn), dev)
    if work is not None:
        check_tensor("work", work, torch.int64, (3,), dev)
    if route(dev) == "cpu":
        if work is not None:
            w = eigen_pool_work(grid, e, cand)
            work += torch.tensor([w["skipped"], w["kept"], w["tests"]], dtype=torch.int64)
        pooled = eigen_pool_fused_reference(grid, e, eigen_candidate_rows(e, cand))
        return pooled[:, :2].contiguous()
    _check_shape_route("the pooling kernel", dim, c)
    boxes = torch.empty((d_, c // EIG_GROUP, EIG_BOX), dtype=torch.float32, device=dev)
    out = torch.empty((d_, 2, c), dtype=torch.float32, device=dev)
    r2 = float(np.float32(grid.cell_width * grid.cell_width))
    launch("sparkl_eigen_pool", e.data_ptr(), cand.data_ptr(), boxes.data_ptr(),
           out.data_ptr(), d_, kn, r2, dim, None if work is None else work.data_ptr(),
           stream_ptr(dev))
    LAUNCHES["eigen_pool_fused"] += 1
    LAUNCHES["eigen_boxes"] += 1
    return out
