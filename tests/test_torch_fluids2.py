"""The port's 2D fluid path (fluids2 on the fused pipeline) on the CPU
against the JAX package: the 2D EOS stress and dt bound, both 2D mass
kernels, kernel A's 2D EOS form and kernel B's 2D fluid branch (plain
versions) against the Pallas kernels in interpret mode, the 2D volume pass,
the scene build, one frame through both fused pipelines, the golden's ten
frames, and the dt-bound row of the packs (sand3 reduced, fluids3, fluids2)
bit for bit.

The reduced scene is fluids2(n=40): 1,600 EOS particles, cell width 0.1,
chunks of 64 slots. Its JAX packed state (F00 = J set from a numpy seed
below, at and above 1, and numpy-seeded velocities and gradients) is
carried across with interop.slot_state_from_numpy. Where a check is not
bit for bit, the reason is jitted XLA's rounding on the CPU, which the
port does not follow everywhere: it contracts a·b + c into one FMA,
computes exp and log its own way, and rewrites a division by the cell
width as a product with f32(1/h) (ROADMAP queue 3).
"""

import json
import os
from dataclasses import fields, replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparkl_tpu.scenes as jscenes
from sparkl_tpu.fused import kernels as JK
from sparkl_tpu.fused.pipeline import FusedMpmPipeline as JPipeline
from sparkl_tpu.models import constitutive as jcon
from sparkl_tpu.sparse import transfer as JT

import sparkl_tpu_torch as tsk
import sparkl_tpu_torch.scenes as tscenes
from sparkl_tpu_torch import interop
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.fused import kernels as TK
from sparkl_tpu_torch.fused import layout as TL
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
from sparkl_tpu_torch.fused.structure import SlotStructure
from sparkl_tpu_torch.models import constitutive as tcon
from sparkl_tpu_torch.sparse.pipeline import SparseMpmPipeline

torch.set_num_threads(1)

GOLD = json.load(open(os.path.join(os.path.dirname(__file__), "golden_scenes.json")))
R2 = TL.Rows(2)
DT = 1.0e-3
N = GOLD["fluids2"]["config"]["n"]  # 40


def _np(x):
    return np.asarray(x)


def _state_to_port(js, pipe):
    arrays = {f.name: _np(getattr(js.structure, f.name)) for f in fields(SlotStructure)}
    arrays.update(slots=_np(js.slots), ints=_np(js.ints), cum_disp=_np(js.cum_disp))
    return interop.slot_state_from_numpy(arrays, cache_fn=pipe._grid_cache, device="cpu")


@pytest.fixture(scope="module")
def scene():
    """fluids2(n=40) from both packages, and both fused pipelines (the JAX
    one with its Pallas kernels in interpret mode) packed."""
    jb = jscenes.build("fluids2", n=N)
    tb = tscenes.build("fluids2", n=N, device="cpu")
    jpipe = JPipeline(jb.grid, jb.models, jb.colliders, jb.params, jb.gravity,
                      use_pallas="interpret")
    jpipe._ensure_cfg(jb.particles)
    js = jpipe._jit_pack(jb.particles)
    tpipe = tsk.auto_pipeline(tb, device="cpu")
    ts = tpipe.pack_state(tb.particles)
    return SimpleNamespace(jb=jb, tb=tb, jpipe=jpipe, js=js, tpipe=tpipe, ts=ts)


@pytest.fixture(scope="module")
def moved(scene):
    """The packed scene with F00 = J in [0.85, 1.15], velocities of 0.5,
    velocity gradients of 2 and position offsets of up to 0.4 of the
    particle spacing (within the window's one-cell tolerance; the volume
    pass then finds J spread around 1), all from a numpy seed: JAX and port
    states of the same slots."""
    k = scene
    rng = np.random.default_rng(29)
    slots = _np(k.js.slots).copy()
    occ = (_np(k.js.ints)[:, TL.I_FLAGS, :] & TL.OCCUPIED) != 0
    shape = slots[:, 0].shape
    j = rng.uniform(0.85, 1.15, size=shape).astype(np.float32)
    slots[:, R2.defgrad] = np.where(occ, j, slots[:, R2.defgrad])
    spacing = 2.0 * k.jb.grid.cell_width / 4.0
    for ax in range(2):
        off = rng.uniform(-0.4 * spacing, 0.4 * spacing, size=shape).astype(np.float32)
        slots[:, R2.pos + ax] = np.where(occ, slots[:, R2.pos + ax] + off, 0.0)
    for ax in range(2):
        slots[:, R2.vel + ax] = np.where(occ, rng.normal(scale=0.5, size=shape), 0.0)
    for k4 in range(4):
        slots[:, R2.grad + k4] = np.where(occ, rng.normal(scale=2.0, size=shape), 0.0)
    js = k.js.replace(slots=jnp.asarray(slots))
    return SimpleNamespace(js=js, ts=_state_to_port(js, k.tpipe), occ=occ)


def test_scene_builds_bit_equal(scene):
    """Particles, grid, model table, colliders and parameters of the port's
    fluids2, bit for bit the JAX package's, at n = 40 and as published."""
    for n in (N, 300):
        jb = scene.jb if n == N else jscenes.build("fluids2")
        tb = scene.tb if n == N else tscenes.build("fluids2", device="cpu")
        assert tb.particles.capacity == n * n
        for f in fields(tb.particles):
            a, b = getattr(tb.particles, f.name).numpy(), _np(getattr(jb.particles, f.name))
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        assert tb.grid == GridParams(jb.grid.origin, jb.grid.cell_width, jb.grid.res)
        for k in ("ctype", "cparams", "ptype", "pparams", "ftype", "fparams"):
            np.testing.assert_array_equal(getattr(tb.models, k).numpy(),
                                          _np(getattr(jb.models, k)))
        assert len(tb.colliders) == len(jb.colliders) == 3
        for tc, jc in zip(tb.colliders, jb.colliders):
            assert tc.shape_type == jc.shape_type
            for a, b in zip((*tc.data, tc.translation, tc.rotation),
                            (*jc.data, jc.translation, jc.rotation)):
                np.testing.assert_array_equal(a, b)
        for f in ("dt", "max_num_substeps", "force_fluids_volume_recomputation",
                  "boundary_handling"):
            assert getattr(tb.params, f) == getattr(jb.params, f), f
        assert tb.params.force_fluids_volume_recomputation
        assert tuple(tb.gravity) == tuple(jb.gravity)


@pytest.mark.parametrize("name", ["sand3", "fluids3", "fluids2"])
def test_pack_dt_bound_row_bit_equal(name):
    """The fused pipeline's pack, every slot row and the dt-bound row among
    them, bit for bit the JAX package's: a corotated + Drucker-Prager pack
    (sand3 at 12 x 6 x 6) and the EOS packs (fluids3 as published, fluids2
    at n = 40). The bound forms K = λ + 2µ/3 and the EOS CFL bound h/√c² as
    jitted XLA does (the product with f32(1/3) contracted into one FMA, the
    product with 1/√c²)."""
    kw = dict(sand3=dict(nx=12, ny=6, nz=6), fluids3={}, fluids2=dict(n=N))[name]
    jb, tb = jscenes.build(name, **kw), tscenes.build(name, device="cpu", **kw)
    jpipe = JPipeline(jb.grid, jb.models, jb.colliders, jb.params, jb.gravity,
                      use_pallas="interpret")
    jpipe._ensure_cfg(jb.particles)
    js = jpipe._jit_pack(jb.particles)
    tpipe = FusedMpmPipeline(tb.grid, tb.models, tb.colliders, tb.params, tb.gravity,
                             device="cpu")
    ts = tpipe.pack_state(tb.particles)
    np.testing.assert_array_equal(ts.ints.numpy(), _np(js.ints))
    np.testing.assert_array_equal(ts.slots.numpy(), _np(js.slots))
    occ = (ts.ints.numpy()[:, TL.I_FLAGS] & TL.OCCUPIED) != 0
    dtb = ts.slots.numpy()[:, TL.Rows(tb.grid.dim).dtb][occ]
    assert occ.sum() == tb.particles.capacity and (dtb > 0).all() and (dtb < 1.0).all()


def test_jitted_xla_rounding_the_port_follows():
    """What the port's dt bound and base cell follow, on this CPU, as jitted
    XLA computes the JAX package's expressions (numpy-seeded f32 values):
    a tensor divided by a constant (3, 6, 0.1, a Python-float cell width)
    is the product with f32(1/c) (linalg.div_const), where a true division
    is off by an ulp on some values; a·b + c is one FMA (linalg.fma); h /
    sqrt(c²) at c² = 10 (an EOS lane at rest) is h·(1/sqrt(10))."""
    from sparkl_tpu_torch.math import linalg

    rng = np.random.default_rng(41)
    x, y, z = (rng.uniform(0.5, 2.0, 10_000).astype(np.float32) for _ in range(3))
    t = torch.from_numpy
    for c in (3.0, 6.0, 0.1):
        got = _np(jax.jit(lambda a, c=c: a / c)(x))
        np.testing.assert_array_equal(got, linalg.div_const(t(x), c).numpy())
        assert (got != x / np.float32(c)).any()
    got = _np(jax.jit(lambda a: (a - 0.5) / 0.1)(x))
    np.testing.assert_array_equal(got, linalg.div_const(t(x) - 0.5, 0.1).numpy())
    got = _np(jax.jit(lambda a, b, c: a * b + c)(x, y, z))
    np.testing.assert_array_equal(got, linalg.fma(t(x), t(y), t(z)).numpy())
    assert (got != x * y + z).any()
    ten = np.full(8, 10.0, np.float32)
    for h in (0.1, 0.8):
        got = _np(jax.jit(lambda a, h=h: h / jnp.sqrt(a))(ten))
        np.testing.assert_array_equal(got, (h * linalg.rdiv(1.0, torch.sqrt(t(ten)))).numpy())


def test_eos_functions_2d_match_jax():
    """The 2D EOS Kirchhoff stress and dt bound (dim = 2: the trace over 2,
    k·p·2) against the JAX package's, jitted, on J below, at and above 1.
    Bit for bit where J = 1 (zero pressure): the viscous stress, and the
    CFL bound where |v| <= 1 (c² = 10; at |v| > 1, XLA's CPU rsqrt of c²
    differs from 1/sqrt on some lanes). Elsewhere the pressure goes through
    exp and log, which XLA and PyTorch round differently: stress within
    2e-6 of p0 (test_torch_fluids.py's bound), dt bound within rtol 1e-5."""
    rng = np.random.default_rng(31)
    n = 768
    j = rng.uniform(0.8, 1.2, n).astype(np.float32)
    j[::3] = 1.0
    g = rng.normal(scale=2.0, size=(n, 2, 2)).astype(np.float32)
    v = rng.normal(scale=1.0, size=(n, 2)).astype(np.float32)
    mass = np.full(n, 2.5, np.float32)
    vol0 = np.full(n, 2.5e-3, np.float32)
    p0, gamma, visc, neg = 1.0e4, 7.0, 1.01e-3, 1.0
    dens = (mass / vol0) / j

    def jfn(j_, g_, v_):
        gc = [[g_[:, a, b] for b in range(2)] for a in range(2)]
        st = jcon.eos_kirchhoff_stress_c(p0, gamma, visc, neg, mass, vol0, dens, j_, gc)
        bound = jcon.eos_timestep_bound(p0, gamma, neg, j_, mass, vol0, dens, v_, 0.1)
        return [x for r in st for x in r], bound

    sj, bj = jax.jit(jfn)(jnp.asarray(j), jnp.asarray(g), jnp.asarray(v))
    sj, bj = np.stack([_np(x) for x in sj], -1), _np(bj)
    t = torch.from_numpy
    gc = [[t(g[:, a, b].copy()) for b in range(2)] for a in range(2)]
    st = tcon.eos_kirchhoff_stress_c(torch.tensor(p0), torch.tensor(gamma), torch.tensor(visc),
                                     torch.tensor(neg), t(mass), t(vol0), t(dens), t(j), gc)
    st = torch.stack([x for r in st for x in r], -1).numpy()
    bt = tcon.eos_timestep_bound(torch.tensor(p0), torch.tensor(gamma), torch.tensor(neg), t(j),
                                 t(mass), t(vol0), t(dens), t(v), 0.1).numpy()
    at1 = j == 1.0
    slow = (v * v).sum(-1) <= 1.0
    np.testing.assert_array_equal(st[at1], sj[at1])
    np.testing.assert_array_equal(bt[at1 & slow], bj[at1 & slow])
    assert (at1 & slow).sum() > 20
    np.testing.assert_allclose(st / p0, sj / p0, rtol=0, atol=2e-6)
    np.testing.assert_allclose(bt, bj, rtol=1e-5)
    assert np.abs(sj[~at1]).max() > 0.1 * p0  # pressures of a tenth of p0 and more
    # 2D is not 3D: the trace divides by 2 and the bound takes k·p·2.
    g3 = [[t(np.pad(g, ((0, 0), (0, 1), (0, 1)))[:, a, b].copy()) for b in range(3)]
          for a in range(3)]
    st3 = tcon.eos_kirchhoff_stress_c(torch.tensor(p0), torch.tensor(gamma), torch.tensor(visc),
                                      torch.tensor(neg), t(mass), t(vol0), t(dens), t(j), g3)
    assert not torch.equal(st3[0][0], torch.from_numpy(st[:, 0]))
    # Compressed lanes take the single-particle bound, below the CFL one.
    below = j < 0.99
    assert (bt[below] < bt[at1].max()).all()


def test_mass_kernels_2d_match_pallas(scene, moved):
    """mass_p2g_fused and mass_g2p_fused (plain, 2D, C = 64, row-major
    cells) against the Pallas kernels on the moved fluids2 state; the gather
    on numpy-seeded positive mass windows. Within 3e-6 of the largest value:
    the same f32 products, but XLA contracts the weights' and the sums'
    multiply-adds into FMAs and takes the base cell as x·f32(1/h)."""
    k = scene
    cfg, tcfg = k.jpipe._cfg, k.tpipe._cfg
    nch_j, nch = moved.js.structure.num_chunks, moved.ts.structure.num_chunks
    img_j = _np(JK.mass_p2g_fused(k.jb.grid, cfg, moved.js.slots, moved.js.ints,
                                  interpret=True, nchunks=nch_j))
    TK.reset_launch_counts()
    img_t = TK.mass_p2g_fused(k.tpipe.grid, tcfg, moved.ts.slots, moved.ts.ints, nch).numpy()
    assert img_t.shape == img_j.shape == (tcfg.max_chunks, 1, 64)
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=3e-6 * np.abs(img_j).max())
    live = int(nch)
    assert img_t[:live].sum() > 0 and not img_t[live:].any()
    win = np.random.default_rng(5).uniform(0.0, 50.0, size=(tcfg.max_chunks, 1, 64))
    win = win.astype(np.float32)
    out_j = _np(JK.mass_g2p_fused(k.jb.grid, cfg, moved.js.slots, moved.js.ints,
                                  jnp.asarray(win), interpret=True, nchunks=nch_j))
    out_t = TK.mass_g2p_fused(k.tpipe.grid, tcfg, moved.ts.slots, moved.ts.ints,
                              torch.tensor(win), nch).numpy()
    assert out_t.shape == out_j.shape == (tcfg.max_chunks, 1, 64)
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=3e-6 * np.abs(out_j).max())
    assert TK.LAUNCHES["mass_p2g_fused"] == TK.LAUNCHES["mass_g2p_fused"] == 0
    assert (out_t[:, 0][moved.occ] > 0).all()


def test_kernel_a_2d_eos_matches_pallas(scene, moved):
    """Kernel A (plain) in its 2D EOS form against the JAX p2g_fused: the
    stress formed fresh from J = F00 (the cache rows, which kernel B leaves
    zero, are ignored), the 2D contraction of the affine term. Images within
    rtol 1e-5, atol 1e-6 of their scale (test_torch_fluids.py's bound)."""
    k = scene
    img_j = _np(JK.p2g_fused(
        k.jb.grid, k.jpipe._cfg, k.jpipe._meta, moved.js.slots, moved.js.ints,
        jnp.float32(DT), k.jpipe._tab_f, k.jpipe._tab_i, interpret=True,
        nchunks=moved.js.structure.num_chunks))
    tp = k.tpipe
    img_t = TK.p2g_fused(tp.grid, tp._cfg, tp._meta, moved.ts.slots, moved.ts.ints, DT,
                         moved.ts.structure.num_chunks, tables=(tp._tab_f, tp._tab_i)).numpy()
    assert img_t.shape == (tp._cfg.max_chunks, 3, 64)
    np.testing.assert_allclose(img_t, img_j, rtol=1e-5, atol=1e-6 * np.abs(img_j).max())
    # The EOS stress dominates the momentum channels: without it they differ.
    plain = TK.p2g_fused_reference(tp.grid, moved.ts.slots, moved.ts.ints, DT,
                                   moved.ts.structure.num_chunks).numpy()
    assert np.abs(plain[:, 1:] - img_j[:, 1:]).max() > 0.1 * np.abs(img_j[:, 1:]).max()


def test_kernel_a_plain_sums_cells_in_lane_order(scene, moved):
    """Kernel A's plain version sums each cell's slots in ascending lane
    order, as the kernel's owner loop does, so that the card's images and
    the CPU's are the same sums (a substep on the card then agrees with the
    CPU's through kernel A bit for bit where the stress is formed alike):
    bit-equal to the images built one lane at a time, lane 0 first, each
    lane alone active."""
    tp = scene.tpipe
    slots, ints, nch = moved.ts.slots, moved.ts.ints, moved.ts.structure.num_chunks
    tables = (tp._tab_f, tp._tab_i)
    full = TK.p2g_fused_reference(tp.grid, slots, ints, DT, nch, tables)
    acc = torch.zeros_like(full)
    lane = torch.arange(ints.shape[2])
    for s in range(ints.shape[2]):
        alone = ints.clone()
        alone[:, TL.I_FLAGS] = torch.where(lane == s, alone[:, TL.I_FLAGS],
                                           alone[:, TL.I_FLAGS] & ~TL.ACTIVE)
        acc = acc + TK.p2g_fused_reference(tp.grid, slots, alone, DT, nch, tables)
    assert torch.equal(acc, full)
    assert full[:, 1:].abs().max() > 0


def test_kernel_b_2d_fluid_matches_pallas(scene, moved):
    """Kernel B (plain) in its 2D fluid branch against the JAX g2p_fused on
    the windows of numpy-seeded node fields (the JAX side gathers them, the
    wrapper reads them at the chunks' corners), on occupied lanes: F00 += tr(∇v)·dt·F00 with the
    rest of F kept, no SVD, no |F00| guard, the 2D EOS dt bound, zero stress
    rows. test_torch_fluids.py's tolerances: kinematics, dt bound and drift
    1e-5 of each row's scale, F00 within 1e-6 (strain units), the failed
    row exact; the dt bound is held off the lanes whose new J lies within
    1e-3 of 1 (at most 2% of them), where the EOS bound divides two
    quantities near zero whose rounding (exp and log) differs between the
    libraries, as the volume pass's check does."""
    k = scene
    tp = k.tpipe
    rng = np.random.default_rng(9)
    fields = rng.normal(scale=0.5, size=(tp._cfg.max_grid_blocks + 1, 2 * 16)).astype(np.float32)
    windows = JT.gather_grid_windows(k.jb.grid, k.jpipe._cfg, moved.js.structure,
                                     jnp.asarray(fields))
    out_j = _np(JK.g2p_fused(
        k.jb.grid, k.jpipe._cfg, k.jpipe._meta, k.jpipe._kparams, moved.js.slots, moved.js.ints,
        windows, jnp.float32(DT), k.jpipe._tab_f, k.jpipe._tab_i,
        interpret=True, nchunks=moved.js.structure.num_chunks))
    before = moved.ts.slots.numpy()
    out_t = TK.g2p_fused(tp.grid, tp._cfg, tp._meta, tp._kparams, moved.ts.slots.clone(),
                         moved.ts.ints, torch.tensor(fields), tp._corners(moved.ts), DT,
                         tp._tab_f, tp._tab_i, moved.ts.structure.num_chunks).numpy()
    occ = moved.occ
    out_t = np.where(occ[:, None, :], out_t, 0.0)
    out_j = np.where(occ[:, None, :], out_j, 0.0)
    np.testing.assert_array_equal(out_t[:, R2.failed], out_j[:, R2.failed])
    near1 = occ & (np.abs(out_t[:, R2.defgrad] - 1.0) < 1e-3)
    assert near1.sum() <= 0.02 * occ.sum()
    for row in range(R2.nf):
        if row == R2.failed:
            continue
        held = ~near1 if row == R2.dtb else np.ones_like(occ)
        scale = max(np.abs(out_j[:, row]).max(), 1e-30)
        err = np.abs(out_t[:, row] - out_j[:, row])[held].max() / scale
        assert err <= 1e-5, (row, err)
    f00 = out_t[:, R2.defgrad]
    np.testing.assert_allclose(f00[occ], out_j[:, R2.defgrad][occ], rtol=0, atol=1e-6)
    assert np.abs(f00[occ] - before[:, R2.defgrad][occ]).max() > 1e-4  # J moved
    for k4 in (1, 2, 3):  # the rest of F is kept
        np.testing.assert_array_equal(out_t[:, R2.defgrad + k4][occ],
                                      before[:, R2.defgrad + k4][occ])
    assert not out_t[:, R2.stress : R2.stress + 3].any()  # fluids leave the cache rows zero
    dtb = out_t[:, R2.dtb][occ]
    assert (dtb > 0).all() and (dtb < TL.BIGF).all()


def test_volume_pass_2d_matches_jax(scene, moved):
    """_recompute_fluids and _refresh_dtb_rows in 2D (row-major windows, h²)
    against the JAX methods on the moved state: F00 = V/V0 of active fluid
    slots within 2e-6 relative (the mass images sum in another order, with
    FMAs), the refreshed dt-bound row within rtol 1e-4 except on slots whose
    new J lies within 1e-3 of 1 (there the EOS bound divides two rounded
    quantities near zero; at most 2% of them), every other row untouched."""
    k = scene
    js, _ = jax.jit(k.jpipe._recompute_fluids)(moved.js)
    ts = moved.ts.replace(slots=moved.ts.slots.clone())
    before = ts.slots.clone()
    ts = k.tpipe._recompute_fluids(ts)
    occ = moved.occ
    out_j, out_t = _np(js.slots), ts.slots.numpy()
    np.testing.assert_allclose(out_t[:, R2.defgrad][occ], out_j[:, R2.defgrad][occ], rtol=2e-6)
    near1 = occ & (np.abs(out_t[:, R2.defgrad] - 1.0) < 1e-3)
    assert near1.sum() <= 0.02 * occ.sum()
    held = occ & ~near1
    np.testing.assert_allclose(out_t[:, R2.dtb][held], out_j[:, R2.dtb][held], rtol=1e-4)
    others = [row for row in range(R2.nf) if row not in (R2.defgrad, R2.dtb)]
    assert torch.equal(ts.slots[:, others], before[:, others])
    # The packed lattice at rest: 4 particles per cell of h², J ~ 1 inside.
    f00 = out_t[:, R2.defgrad][occ]
    assert 0.5 < np.median(f00) < 1.5


def test_one_frame_matches_jax_fused_pipeline(scene):
    """One frame of fluids2(n=40), port fused against JAX fused: equal
    substeps, and the particles within tests/test_torch_fluids.py's
    one-frame bounds (tests/test_fused.py::_compare)."""
    k = scene
    pj, nj = k.jpipe.step_with_stats(k.jb.particles)
    state, nt = k.tpipe.run_frames_state(k.tpipe.pack_state(k.tb.particles), 1)
    pt = k.tpipe.unpack_state(state)
    assert nt == int(nj) == GOLD["fluids2"]["frames"][0]["substeps"]
    act = _np(pj.active)
    np.testing.assert_array_equal(pt.active.numpy(), act)
    np.testing.assert_allclose(pt.position.numpy()[act], _np(pj.position)[act], atol=5e-5)
    np.testing.assert_allclose(pt.velocity.numpy()[act], _np(pj.velocity)[act], atol=5e-4)
    np.testing.assert_allclose(pt.deformation_gradient.numpy()[act],
                               _np(pj.deformation_gradient)[act], atol=5e-4)
    np.testing.assert_array_equal(pt.failed.numpy()[act], _np(pj.failed)[act])
    assert np.abs(pt.velocity.numpy()[act]).max() > 0.1  # the column falls


def test_golden_fluids2_frames():
    """Replays the ten frames of tests/golden_scenes.json's fluids2 (n = 40,
    made by the JAX dense pipeline) on the port's fused pipeline through
    auto_pipeline -> pack_state -> run_frames_state -> unpack_state, with
    tests/test_regression.py's bounds for fused pipelines (substeps within
    one, centre of mass atol 3e-3, box 8e-3, kinetic energy rtol 3e-2,
    failed and broken counts within 2%) and mass conservation to rtol 1e-6."""
    gold = GOLD["fluids2"]
    b = tscenes.build("fluids2", device="cpu", **gold["config"])
    pipe = tsk.auto_pipeline(b, device="cpu")
    assert isinstance(pipe, FusedMpmPipeline)
    state = pipe.pack_state(b.particles)
    act0 = b.particles.active.numpy()
    per_mass = b.particles.mass.numpy()
    mass0 = float(per_mass[act0].sum())
    n0 = int(act0.sum())
    for rec in gold["frames"]:
        state, substeps = pipe.run_frames_state(state, 1)
        p = pipe.unpack_state(state)
        frame = rec["frame"]
        assert abs(substeps - rec["substeps"]) <= 1, f"frame {frame} substeps"
        act = p.active.numpy()
        pos, vel, mass = p.position.numpy()[act], p.velocity.numpy()[act], p.mass.numpy()[act]
        deact = float(per_mass[act0 & ~act].sum())
        np.testing.assert_allclose(float(mass.sum()), mass0 - deact, rtol=1e-6)
        np.testing.assert_allclose(pos.mean(0), rec["com"], atol=3e-3, rtol=1e-3)
        np.testing.assert_allclose(pos.min(0), rec["pos_min"], atol=8e-3, rtol=1e-3)
        np.testing.assert_allclose(pos.max(0), rec["pos_max"], atol=8e-3, rtol=1e-3)
        ke = float(0.5 * np.sum(mass[:, None] * vel**2))
        np.testing.assert_allclose(ke, rec["ke"], rtol=3e-2, atol=1e-8)
        slack = max(2, int(0.02 * n0))
        assert abs(int(p.failed.numpy()[act].sum()) - rec["failed"]) <= slack
        assert abs(int((p.phase.numpy()[act] == 0.0).sum()) - rec["broken"]) <= slack


def test_what_stays_refused(scene):
    """The sparse pipeline carries fluids2 since the 2D slice (with
    auto_pipeline's sparse preference; tests/test_torch_sparse2d.py holds
    its path); both pipelines refuse a 2D fluid set with a 3D heightfield
    and GPU boundary semantics."""
    b = scene.tb
    SparseMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity, device="cpu")
    assert isinstance(tsk.auto_pipeline(b, prefer="sparse", device="cpu"), SparseMpmPipeline)
    from sparkl_tpu_torch.geometry.colliders import heightfield
    for over in (dict(colliders=(heightfield(np.zeros((3, 3)), (1.0, 1.0, 1.0)),)),
                 dict(params=replace(b.params, gpu_boundary_semantics=True))):
        kw = dict(grid=b.grid, models=b.models, colliders=b.colliders, params=b.params,
                  gravity=b.gravity, device="cpu")
        for pipeline in (FusedMpmPipeline, SparseMpmPipeline):
            with pytest.raises(NotImplementedError):
                pipeline(**dict(kw, **over))
