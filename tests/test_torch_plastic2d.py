"""The port's 2D plastic scenes (elasticity2 and basic2 on the fused
pipeline) on the CPU against the JAX package: the Rankine, Snow and 2D
Drucker-Prager return maps (and Rankine and Snow in 3D), the registry's
plastic dispatch, the 2D heightfield, both scene builds and elasticity2's
pack with its stress-cache seed, kernel A's 2D stress-cache read and kernel
B's plastic branches (plain versions) against the Pallas kernels in
interpret mode, permute_chunks (plain) against the Pallas kernel and
against permute_slots, and frame 0 of both scenes against the goldens.

Inputs come from numpy seeds; the JAX kernels run in interpret mode, the
port's kernels through their plain versions. No JAX pipeline is stepped
(the goldens hold the trajectories). Each comparison states its
tolerance.
"""

import json
import os
import re
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparkl_tpu as jsk
import sparkl_tpu.scenes as jscenes
from sparkl_tpu.core.grid import GridParams as JGridParams
from sparkl_tpu.core.particles import Particles as JParticles
from sparkl_tpu.fused import kernels as JK
from sparkl_tpu.fused.pipeline import FusedMpmPipeline as JPipeline
from sparkl_tpu.geometry import colliders as jcol
from sparkl_tpu.models import plasticity as jplas
from sparkl_tpu.models import registry as jreg
from sparkl_tpu.sparse.blocks import BlockConfig as JBlockConfig

import sparkl_tpu_torch as tsk
import sparkl_tpu_torch.scenes as tscenes
from sparkl_tpu_torch import interop
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.core.params import SolverParameters
from sparkl_tpu_torch.fused import kernels as TK
from sparkl_tpu_torch.fused import layout as TL
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
from sparkl_tpu_torch.math import svd as tsvd
from sparkl_tpu_torch.models import plasticity as tplas
from sparkl_tpu_torch.models import registry as treg
from sparkl_tpu_torch.sparse.blocks import BlockConfig
from sparkl_tpu_torch.sparse.pipeline import SparseMpmPipeline

torch.set_num_threads(2)

GOLD = json.load(open(os.path.join(os.path.dirname(__file__), "golden_scenes.json")))
R2 = TL.Rows(2)
DT = 1.0e-3
E, NU = 2.0e4, 0.35
SMALL_CFG = dict(max_blocks=32, max_chunks=32, chunk_size=64, max_grid_blocks=64)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Return maps
# ---------------------------------------------------------------------------


def _deformations(dim, n, seed):
    """F on n lanes: near-identity at strains from 1e-4 to 0.3 (random
    signs, so both tension and compression), then the near-degenerate
    cases: the identity (Rankine's rank ties), scaled identities (equal
    singular values), strong rotated compressions (singular values 0.3 to
    0.9), reflections and tiny matrices. (Rank-deficient F is left out:
    there the sign of a noise-level singular value picks the singular
    vectors that a map inflating it rebuilds F with, so no two
    implementations agree, and kernel B's det(F) = 0 guard covers it.)"""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-4.0, np.log10(0.3), size=(n, 1, 1))
    f = np.eye(dim) + scale * rng.normal(size=(n, dim, dim))
    k = n // 16
    refl = np.eye(dim)
    refl[-1, -1] = -1.0
    rot = np.linalg.qr(rng.normal(size=(k, dim, dim)))[0]
    f[:k] = np.eye(dim)
    f[k : 2 * k] = np.eye(dim) * rng.uniform(0.9, 1.1, size=(k, 1, 1))
    f[2 * k : 3 * k] = rot * rng.uniform(0.3, 0.9, size=(k, 1, dim))
    f[3 * k : 4 * k] = refl + 1e-6 * rng.normal(size=(k, dim, dim))
    f[4 * k : 5 * k] = 1e-8 * rng.normal(size=(k, dim, dim))
    return f.astype(np.float32)


def _rankine_cases(params, f, ph):
    """Per lane, the Rankine case taken (0 elastic, 1 the largest capped,
    2 the two largest (3D), 3 uniform), from the port's singular values."""
    mu, lam, ts = (params[:, k] for k in range(3))
    s = tsvd.svd(f)[1]
    eig = torch.log(torch.clamp(s, min=1e-20))
    es = torch.sort(eig, dim=1, stable=True).values
    e_sum = eig.sum(1)
    e1, e2, e3 = es[:, -1], es[:, -2], es[:, 0]
    soft = ts - (ph - 1.0)
    case0 = lam * e_sum + 2.0 * mu * e1 <= soft
    cond1 = (2.0 * mu + lam) * e2 + lam * (e_sum - e1) <= soft
    cond2 = ((2.0 * mu + 3.0 * lam) * e3 <= soft) if f.shape[-1] == 3 else torch.zeros_like(case0)
    return torch.where(case0, 0, torch.where(cond1, 1, torch.where(cond2, 2, 3)))


@pytest.mark.parametrize("dim,model", [(2, "drucker_prager"), (2, "rankine"), (2, "snow"),
                                       (3, "rankine"), (3, "snow")])
def test_return_map_matches_jax(dim, model):
    """The port's return map against the JAX package's on 4096 lanes of
    _deformations with per-lane parameters around each map's yield: F to
    4e-6 in 2D and 2e-5 in 3D of max(|F|, 1) (both recompose the same 2x2
    closed-form or cardano SVD, whose f32 floors these are, through CPU
    exp/log that differ by an ulp), the plastic state to 1e-5 relative
    (the same floor through the map's logs). Every Rankine case and both
    Snow clamps occur, and are counted; Drucker-Prager projects and keeps
    lanes."""
    n = 4096
    rng = np.random.default_rng(40 + dim)
    f = _deformations(dim, n, 41 + dim)
    if model == "rankine":
        lam, mu = treg.lame_lambda_mu(E, NU)
        params = np.stack([np.full(n, mu), np.full(n, lam), 10.0 ** rng.uniform(0, 4, n),
                           rng.uniform(0, 10, n)], -1)
        ph = rng.uniform(1.0, 2.0, n)
        state = (ph,)
    elif model == "snow":
        params = np.stack([rng.uniform(0.01, 0.05, n), rng.uniform(0.002, 0.01, n),
                           np.full(n, 10.0)], -1)
        state = (rng.uniform(0.5, 1.5, n), rng.uniform(0.8, 1.2, n))  # eh, pdd
    else:
        params = np.tile(np.asarray(treg.drucker_prager_plasticity(1.0e5, 0.2)[1]), (n, 1))
        params[:, 6] = rng.uniform(size=n) < 0.1  # only when failed, on a tenth
        state = (rng.uniform(0.8, 1.2, n), rng.uniform(0.0, 0.5, n), rng.uniform(-0.1, 0.1, n))
        phase = np.where(rng.uniform(size=n) < 0.5, 0.0, 1.0).astype(np.float32)
    params = params.astype(np.float32)
    state = tuple(x.astype(np.float32) for x in state)
    jfn, tfn = getattr(jplas, model + "_update"), getattr(tplas, model + "_update")
    jargs = [jnp.asarray(params), jnp.asarray(f), *map(jnp.asarray, state)]
    targs = [_t(params), _t(f), *map(_t, state)]
    if model == "drucker_prager":
        jargs.insert(1, jnp.asarray(phase))
        targs.insert(1, _t(phase))
    out_j = [_np(x) for x in jax.jit(jfn)(*jargs)]
    out_t = [x.numpy() for x in tfn(*targs)]
    scale = np.maximum(np.abs(out_j[0]).max(axis=(1, 2)), 1.0)
    np.testing.assert_array_less(np.abs(out_t[0] - out_j[0]).max(axis=(1, 2)),
                                 (4e-6 if dim == 2 else 2e-5) * scale)
    for a, b in zip(out_t[1:], out_j[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    changed = np.abs(out_t[0] - f).max(axis=(1, 2)) > 0
    if model == "rankine":
        cases = _rankine_cases(_t(params), _t(f), _t(state[0])).numpy()
        counts = np.bincount(cases, minlength=4)
        assert (counts[[0, 1, 3]] > 50).all() and (dim == 2 or counts[2] > 50), counts
        assert not changed[cases == 0].any() and changed[cases != 0].mean() > 0.9
        # F = I (the tie case) with a large strength stays elastic and exact.
        ident = slice(0, n // 16)
        assert np.array_equal(out_t[0][ident][cases[ident] == 0], f[ident][cases[ident] == 0])
    elif model == "snow":
        s = tsvd.svd(_t(f))[1].numpy()
        below = (s < 1.0 - params[:, :1]).any(1)
        above = (s > 1.0 + params[:, 1:2]).any(1)
        assert below.sum() > 200 and above.sum() > 200 and (~below & ~above).sum() > 50
    else:
        assert changed.sum() > 200 and (~changed).sum() > 200


def test_apply_plasticity_matches_jax():
    """registry.apply_plasticity on a 2D model set with Drucker-Prager,
    Rankine and Snow (and a model without plasticity), ids drawn per lane:
    each lane takes its own model's map, F and the plastic state to
    test_return_map_matches_jax's floors."""
    lam_e = jreg.corotated_linear_elasticity(E, NU)
    specs = [None, jreg.drucker_prager_plasticity(1.0e5, 0.2),
             jreg.rankine_plasticity(E, NU, 1.0e2, 5.0), jreg.snow_plasticity()]
    jm = jreg.ModelSet.pack([jreg.ParticleModel(lam_e, sp) for sp in specs])
    tm = treg.ModelSet.pack([treg.ParticleModel(lam_e, sp) for sp in specs], "cpu")
    assert not tm.unsupported() and tm.present_p == (1, 3, 4)
    rng = np.random.default_rng(45)
    for dim in (2,):
        n = 2048
        f = _deformations(dim, n, 46 + dim)
        ids = rng.integers(0, 4, n).astype(np.int32)
        st = [rng.uniform(0.8, 1.2, n).astype(np.float32) for _ in range(5)]  # pdd ph eh lvg nacc
        phase = np.ones(n, np.float32)
        out_j = [_np(x) for x in jax.jit(lambda *a: jreg.apply_plasticity(jm, *a))(
            jnp.asarray(ids), jnp.asarray(phase), jnp.asarray(f), *map(jnp.asarray, st))]
        out_t = [x.numpy() for x in treg.apply_plasticity(tm, _t(ids), _t(phase), _t(f),
                                                          *map(_t, st))]
        np.testing.assert_array_less(np.abs(out_t[0] - out_j[0]).max(axis=(1, 2)),
                                     4e-6 * np.maximum(np.abs(out_j[0]).max(axis=(1, 2)), 1.0))
        for a, b in zip(out_t[1:], out_j[1:]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(out_t[0][ids == 0], f[ids == 0])  # no plasticity


# ---------------------------------------------------------------------------
# Collider, scenes, pack
# ---------------------------------------------------------------------------


def test_heightfield2_projection_matches_jax():
    """basic2's field (41 samples of -sin, scale (2, 1), at (0.5, 1.5): a
    valley) on points above, below and beyond both ends: projections to
    2e-6 (the segment parameter's division rounds in both), containment
    equal; points past either end project onto the end segments."""
    n = 41
    heights = -np.sin(np.arange(n, dtype=np.float32) * np.pi / (n - 1))
    jc = jcol.heightfield(heights, scale=(2.0, 1.0), translation=(0.5, 1.5))
    tc = interop.collider_from_numpy(jc.shape_type, jc.data, jc.translation, jc.rotation)
    rng = np.random.default_rng(47)
    pts = np.concatenate([
        np.stack([rng.uniform(-0.5, 1.5, 4096), rng.uniform(0.3, 1.8, 4096)], -1),
        np.stack([rng.uniform(-1.5, -0.5, 256), rng.uniform(0.5, 2.5, 256)], -1),  # x < left end
        np.stack([rng.uniform(1.5, 2.5, 256), rng.uniform(0.5, 2.5, 256)], -1),  # x > right end
    ]).astype(np.float32)
    pj, ij = (_np(x) for x in jax.jit(jc.project_point)(jnp.asarray(pts)))
    pt, it = tc.project_point(_t(pts))
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_allclose(pt.numpy(), pj, atol=2e-6)
    assert 0.2 < ij[:4096].mean() < 0.8 and ij[4096:].any() and not ij[4096:].all()
    # Beyond either end the query's three segments are the field's first
    # (last) two: the projections land there.
    left, right = pt.numpy()[4096:4352], pt.numpy()[4352:]
    assert (left[:, 0] <= -0.4 + 1e-6).all() and (right[:, 0] >= 1.4 - 1e-6).all()


@pytest.fixture(scope="module", params=["elasticity2", "basic2"])
def scene(request):
    return request.param, jscenes.build(request.param), tscenes.build(request.param, device="cpu")


def test_scene_builds_bit_equal(scene):
    """Particles, grid, model tables, colliders and parameters of the port's
    build, bit for bit the JAX package's (elasticity2's star centres from
    the same numpy generator at seed 42)."""
    name, jb, tb = scene
    assert tb.particles.capacity == {"elasticity2": 16000, "basic2": 11204}[name]
    for f in fields(tb.particles):
        a, b = getattr(tb.particles, f.name).numpy(), _np(getattr(jb.particles, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert tb.grid == GridParams(jb.grid.origin, jb.grid.cell_width, jb.grid.res)
    for k in ("ctype", "cparams", "ptype", "pparams", "ftype", "fparams"):
        np.testing.assert_array_equal(getattr(tb.models, k).numpy(), _np(getattr(jb.models, k)))
    assert len(tb.colliders) == len(jb.colliders)
    for tc, jc in zip(tb.colliders, jb.colliders):
        assert tc.shape_type == jc.shape_type
        for a, b in zip((*tc.data, tc.translation, tc.rotation),
                        (*jc.data, jc.translation, jc.rotation)):
            np.testing.assert_array_equal(a, b)
    assert (tb.params.dt, tb.params.max_num_substeps) == (jb.params.dt, jb.params.max_num_substeps)
    assert tuple(tb.gravity) == tuple(jb.gravity)


def test_pack_with_stress_cache_matches_jax(scene):
    """The fused pipeline's pack: ints, structure and slots bit-equal, the
    2D stress-cache rows (elasticity2 seeds them from F = I, basic2 has the
    cache off) and the dt-bound row too (the corotated bound's λ + 2µ/3
    formed as jitted XLA forms it: the product with f32(1/3), contracted
    into one FMA); and the grid cache's heightfield projections of every
    node (basic2) to 2e-6."""
    name, jb, tb = scene
    jpipe = JPipeline(jb.grid, jb.models, jb.colliders, jb.params, jb.gravity,
                      use_pallas="interpret")
    jpipe._ensure_cfg(jb.particles)
    jstate = jpipe._jit_pack(jb.particles)
    tpipe = tsk.auto_pipeline(tb, device="cpu")
    assert isinstance(tpipe, FusedMpmPipeline)
    assert tpipe._meta["stress_cache"] == jpipe._meta["stress_cache"] == (name == "elasticity2")
    tstate = tpipe.pack_state(tb.particles)
    assert tpipe._cfg == BlockConfig(**vars(jpipe._cfg))
    np.testing.assert_array_equal(tstate.ints.numpy(), _np(jstate.ints))
    a, b = tstate.slots.numpy(), _np(jstate.slots)
    np.testing.assert_array_equal(a, b)
    assert (a[:, R2.dtb] > 0).sum() == tb.particles.capacity
    for k, v in tstate.structure.tensors().items():
        np.testing.assert_array_equal(v.numpy(), _np(getattr(jstate.structure, k)), err_msg=k)
    if name == "basic2":
        (proj_j, in_j), = jstate.grid_cache[1]
        (proj_t, in_t), = tstate.grid_cache[1]
        np.testing.assert_array_equal(in_t.numpy(), _np(in_j))
        np.testing.assert_allclose(proj_t.numpy(), _np(proj_j), atol=2e-6)
        assert 0 < in_t.sum() < in_t.numel()


# ---------------------------------------------------------------------------
# Kernels A and B on a small 2D scene with all three plastic models
# ---------------------------------------------------------------------------


def _small_models(failure, dp_only):
    """Drucker-Prager, two Rankine strengths, Snow (E = 2e4), and with
    `failure` a fifth model failing by maximum stress (the cache off);
    with `dp_only` the Drucker-Prager model alone."""
    el = jreg.corotated_linear_elasticity(E, NU)
    models = [jreg.ParticleModel(el, jreg.drucker_prager_plasticity(E, NU)),
              jreg.ParticleModel(el, jreg.rankine_plasticity(E, NU, 1.0e2, 5.0)),
              jreg.ParticleModel(el, jreg.rankine_plasticity(E, NU, 2.0e3, 5.0)),
              jreg.ParticleModel(el, jreg.snow_plasticity())]
    if dp_only:
        return jreg.ModelSet.pack(models[:1])
    if failure:
        models.append(jreg.ParticleModel(el, failure=jreg.maximum_stress_failure(300.0, 1.0e6)))
    return jreg.ModelSet.pack(models)


@pytest.fixture(scope="module")
def small_states():
    """The three small states of _small_state, built once: "cache_on",
    "cache_off" and "dp_only"."""
    return {"cache_on": _small_state(False), "cache_off": _small_state(True),
            "dp_only": _small_state(False, dp_only=True)}


def _small_state(failure, dp_only=False):
    """A packed 2D state: four 10 x 10 blocks (one per model, a fifth with
    `failure`) with F = I + 0.05·N, random velocities, velocity gradients
    and hardening; with the cache on, random symmetric stress rows on every
    occupied lane (so kernel A must read the rows, not form the stress).
    `dp_only`: four Drucker-Prager blocks (kernel B's one-SVD path).
    Returns (jpipe, port pipeline, port state)."""
    h = 0.05
    grid = JGridParams(origin=(0.0, 0.0), cell_width=h, res=(64, 64))
    models = _small_models(failure, dp_only)
    nm = models.num_models
    kw = dict(counts=(10, 10), particle_radius=h / 4, density0=1000.0)
    p = JParticles.concatenate(tuple(
        jsk.cube_particles(origin=(0.6 + 0.45 * m, 0.8), model_id=m % nm, **kw)
        for m in range(max(nm, 4))))
    rng = np.random.default_rng(48 + nm)
    n = p.capacity
    p = p.replace(
        velocity=jnp.asarray(rng.normal(scale=0.5, size=(n, 2)).astype(np.float32)),
        velocity_gradient=jnp.asarray(rng.normal(scale=2.0, size=(n, 2, 2)).astype(np.float32)),
        deformation_gradient=jnp.asarray((np.eye(2) + 0.05 * rng.normal(size=(n, 2, 2)))
                                         .astype(np.float32)),
        plastic_hardening=jnp.asarray(rng.uniform(1.0, 1.5, n).astype(np.float32)),
        plastic_def_det=jnp.asarray(rng.uniform(0.9, 1.1, n).astype(np.float32)),
    )
    colliders = (jcol.cuboid((100.0, 0.5), translation=(0.0, 0.25), friction=0.3),)
    jpipe = JPipeline(grid, models, colliders, jsk.SolverParameters(dt=DT), (0.0, -9.81),
                      config=JBlockConfig(**SMALL_CFG), use_pallas="interpret")
    tm = interop.modelset_from_numpy(models.ctype, models.cparams, models.ptype,
                                     models.pparams, models.ftype, models.fparams, device="cpu")
    tpipe = FusedMpmPipeline(GridParams(grid.origin, grid.cell_width, grid.res), tm,
                             tuple(interop.collider_from_numpy(c.shape_type, c.data,
                                                               c.translation, c.rotation,
                                                               c.friction) for c in colliders),
                             SolverParameters(dt=DT), (0.0, -9.81),
                             config=BlockConfig(**SMALL_CFG), device="cpu")
    # The port's pack (bit-equal to the JAX package's on both scenes but
    # for the dt-bound row, which the kernels do not read), fed to both.
    state = tpipe.pack_state(interop.particles_from_numpy(
        {f.name: _np(getattr(p, f.name)) for f in fields(p)}, device="cpu"))
    if tpipe._meta["stress_cache"]:
        occ = (state.ints[:, TL.I_FLAGS] & TL.OCCUPIED) != 0
        st = _t(rng.normal(scale=50.0, size=(SMALL_CFG["max_chunks"], 3, 64)).astype(np.float32))
        state.slots[:, R2.stress : R2.stress + 3] = torch.where(occ[:, None], st, 0.0)
    return jpipe, tpipe, state


def test_kernel_a_2d_stress_cache_matches_pallas(small_states):
    """Kernel A's 2D cache-on form (three symmetric stress rows read, no
    SVD) against the Pallas kernel: images [D, 3, 64] within rtol 1e-5,
    atol 1e-6 of the image's scale (the same terms summed in another
    order). Stress rows are random, so a kernel that formed the stress
    from F would miss by far more."""
    jpipe, tpipe, state = small_states["cache_on"]
    assert tpipe._meta["stress_cache"] and not tpipe._meta["with_psi"]
    nch = state.structure.num_chunks
    img_j = _np(JK.p2g_fused(jpipe.grid, jpipe._cfg, jpipe._meta, jnp.asarray(state.slots),
                             jnp.asarray(state.ints), jnp.float32(DT), jpipe._tab_f,
                             jpipe._tab_i, interpret=True, nchunks=jnp.asarray(nch)))
    tables = (tpipe._tab_f, tpipe._tab_i)
    img_t = TK.p2g_fused(tpipe.grid, tpipe._cfg, tpipe._meta, state.slots, state.ints, DT, nch,
                         tables=tables).numpy()
    assert img_t.shape == img_j.shape == (SMALL_CFG["max_chunks"], 3, 64)
    np.testing.assert_allclose(img_t, img_j, rtol=1e-5, atol=1e-6 * np.abs(img_j).max())
    fresh = TK.p2g_fused_reference(tpipe.grid, state.slots, state.ints, DT, nch, tables=tables,
                                   stress_cache=False)
    assert np.abs(fresh.numpy() - img_j).max() > 100 * 1e-6 * np.abs(img_j).max()


@pytest.mark.parametrize("form", ["dp_only", "cache_on", "cache_off"])
def test_kernel_b_2d_plastic_matches_pallas(small_states, form):
    """Kernel B in 2D with plasticity, on occupied lanes, on the windows of
    the kernel-A images: dp_only the one-SVD path (the stress cache on,
    Drucker-Prager alone); cache_on Drucker-Prager, Rankine and Snow with
    the cache on (each map decomposes its own F, the epilogue one more
    SVD); cache_off the same and a maximum-stress model (the cache off).
    Rows to 1e-5 of their scale, those that pass through the SVDs and the
    maps' exp/log (F, the plastic state, the hardening, energy, par1, the
    stress rows) to 2e-5; failed and phase equal (the trip's stress lies
    far from its threshold on these lanes: checked)."""
    jpipe, tpipe, state = small_states[form]
    meta = tpipe._meta
    assert meta["stress_cache"] == (form != "cache_off")
    reuse = TK.svd_reuse(meta["stress_cache"], meta["present_c"], meta["present_p"])
    assert reuse == (form == "dp_only")
    nch = state.structure.num_chunks
    images = TK.p2g_fused(tpipe.grid, tpipe._cfg, meta, state.slots, state.ints, DT, nch,
                          tables=(tpipe._tab_f, tpipe._tab_i))
    windows = tpipe._grid_windows(state, images, DT)
    out_j = _np(JK.g2p_fused(jpipe.grid, jpipe._cfg, jpipe._meta, jpipe._kparams,
                             jnp.asarray(state.slots), jnp.asarray(state.ints),
                             jnp.asarray(windows.numpy()), jnp.float32(DT), jpipe._tab_f,
                             jpipe._tab_i, interpret=True, nchunks=jnp.asarray(nch)))
    out_t = TK.g2p_fused(tpipe.grid, tpipe._cfg, meta, tpipe._kparams, state.slots, state.ints,
                         windows, DT, tpipe._tab_f, tpipe._tab_i, nch).numpy()
    slots_in, ints = state.slots.numpy(), state.ints.numpy()
    occ = (ints[:, TL.I_FLAGS, :] & TL.OCCUPIED) != 0
    a = np.where(occ[:, None, :], out_t, 0.0)
    b = np.where(occ[:, None, :], out_j, 0.0)
    r = R2
    loose = (set(range(r.defgrad, r.defgrad + 4)) | set(range(r.stress, r.stress + 3))
             | {r.psi_pos, r.par1, r.pdd, r.ph, r.eh, r.lvg})
    for k in range(r.nf):
        if k in (r.failed, r.phase):
            continue
        scale = max(np.abs(b[:, k]).max(), 1e-30)
        tol = 2e-5 if k in loose else 1e-5
        assert np.abs(a[:, k] - b[:, k]).max() / scale <= tol, k
    np.testing.assert_array_equal(a[:, r.failed], b[:, r.failed])
    np.testing.assert_array_equal(a[:, r.phase], b[:, r.phase])
    # Each model's map acted on some of its lanes: Drucker-Prager and
    # Rankine harden (ph), Snow's hardening eh moves with its clamps.
    mid = ints[:, TL.I_MODEL]
    for m, k in ([(0, r.ph)] if form == "dp_only"
                 else [(0, r.ph), (1, r.ph), (2, r.ph), (3, r.eh)]):
        lanes = occ & (mid == m)
        moved = b[:, k] != slots_in[:, k]
        assert lanes.sum() >= 100 and 0 < (moved & lanes).sum(), (m, k)
    if form != "cache_off":
        assert np.abs(b[:, r.stress : r.stress + 3]).max() > 0
    else:
        tripped = occ & (b[:, r.phase] == 0.0) & (slots_in[:, r.phase] != 0.0)
        assert tripped.sum() > 0


# ---------------------------------------------------------------------------
# permute_chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [2, 3])
def test_permute_chunks_matches_pallas_and_permute_slots(dim):
    """A resort-like routing (each destination chunk draws its slots from
    its own and its two neighbouring chunks, some lanes empty) on random
    slot rows: the plain lane router bit-equal to the Pallas kernel in
    interpret mode (0/1 selection matmuls, ints in exact 16-bit halves;
    the random rows hold no -0.0, which the matmul would turn into +0.0)
    and to permute_slots on the same per-slot source index (but the drift
    row and the window-origin rows, which only permute_slots finalizes),
    at C = 64 (2D) and C = 128 (3D)."""
    c = 64 if dim == 2 else 128
    r = TL.Rows(dim)
    d_ = 12
    rng = np.random.default_rng(49 + dim)
    slots = rng.normal(size=(d_, r.nf, c)).astype(np.float32)
    ints = rng.integers(-2**31, 2**31 - 1, size=(d_, TL.NI, c), dtype=np.int64).astype(np.int32)
    src = np.empty((d_, c), np.int64)
    for d in range(d_):
        chunks = np.clip(d + rng.integers(-1, 2, c), 0, d_ - 1)
        src[d] = chunks * c + rng.permutation(c)
    src[rng.uniform(size=src.shape) < 0.1] = -1
    src = _t(src.astype(np.int32))
    g, gi, tgt = TK.permute_chunks_operands(_t(slots), _t(ints), src)
    assert g.shape[1] == 3 and int((tgt < 3 * c).sum()) == int((src >= 0).sum())
    out_f, out_i = TK.permute_chunks(g, gi, tgt)
    jf, ji = JK.permute_chunks(JBlockConfig(max_blocks=16, max_chunks=d_, chunk_size=c,
                                            max_grid_blocks=16),
                               jnp.asarray(g.numpy()), jnp.asarray(gi.numpy()),
                               jnp.asarray(tgt.numpy()), interpret=True)
    assert torch.equal(out_f.view(torch.int32), _t(jf).view(torch.int32))
    assert torch.equal(out_i, _t(ji))
    origin = torch.zeros((d_, dim), dtype=torch.int32)
    ps_f, ps_i = TK.permute_slots(_t(slots), _t(ints), src, origin, r.cumd)
    keep = [k for k in range(r.nf) if k != r.cumd]
    assert torch.equal(out_f[:, keep].view(torch.int32), ps_f[:, keep].view(torch.int32))
    other = [k for k in range(TL.NI) if not TL.I_ORIGIN <= k < TL.I_ORIGIN + dim]
    assert torch.equal(out_i[:, other], ps_i[:, other])
    empty = (src < 0)[:, None, :]
    assert not out_f.masked_select(empty).any() and out_f.abs().sum() > 0
    # Any K: the same routing with two more (zero) source chunks, K = 5.
    g5 = torch.cat([g, torch.zeros_like(g[:, :2])], dim=1)
    gi5 = torch.cat([gi, torch.zeros_like(gi[:, :2])], dim=1)
    out5 = TK.permute_chunks(g5, gi5, torch.where(tgt < 3 * c, tgt, 5 * c))
    assert torch.equal(out5[0], out_f) and torch.equal(out5[1], out_i)


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["elasticity2", "basic2"])
def test_frame0_matches_golden(name):
    """Frame 0 of each scene as published (elasticity2: 16,000 particles,
    47 substeps; basic2: 11,204, 25) through auto_pipeline -> pack_state ->
    run_frames_state -> unpack_state on the CPU, against
    tests/golden_scenes.json with tests/test_regression.py's tolerances for
    the fused pipeline (substeps within one, centre of mass atol 3e-3, box
    8e-3, kinetic energy rtol 3e-2, failed and broken counts within 2%) and
    its mass conservation (rtol 1e-6)."""
    gold = GOLD[name]
    assert gold["config"] == {}
    rec = gold["frames"][0]
    b = tscenes.build(name, device="cpu")
    pipe = tsk.auto_pipeline(b, device="cpu")
    state = pipe.pack_state(b.particles)
    state, substeps = pipe.run_frames_state(state, 1)
    p = pipe.unpack_state(state)
    assert abs(substeps - rec["substeps"]) <= 1
    act0, act = b.particles.active.numpy(), p.active.numpy()
    mass0 = float(b.particles.mass.numpy()[act0].sum())
    deact = float(b.particles.mass.numpy()[act0 & ~act].sum())
    mass = float(p.mass.numpy()[act].sum())
    np.testing.assert_allclose(mass, mass0 - deact, rtol=1e-6)
    pos, vel = p.position.numpy()[act], p.velocity.numpy()[act]
    np.testing.assert_allclose(pos.mean(0), rec["com"], atol=3e-3, rtol=1e-3)
    np.testing.assert_allclose(pos.min(0), rec["pos_min"], atol=8e-3, rtol=1e-3)
    np.testing.assert_allclose(pos.max(0), rec["pos_max"], atol=8e-3, rtol=1e-3)
    ke = float(0.5 * np.sum(p.mass.numpy()[act][:, None] * vel**2))
    np.testing.assert_allclose(ke, rec["ke"], rtol=3e-2, atol=1e-8)
    slack = max(2, int(0.02 * int(act0.sum())))
    assert abs(int(p.failed.numpy()[act].sum()) - rec["failed"]) <= slack
    assert abs(int((p.phase.numpy()[act] == 0.0).sum()) - rec["broken"]) <= slack


def test_pipelines_refuse_what_they_do_not_carry():
    """The fused pipeline refuses NACC in 2D and Rankine or Snow in 3D; the
    sparse pipeline refuses Rankine and Snow (and 2D)."""
    b = tscenes.build("sand3", nx=4, ny=2, nz=2, device="cpu")
    el = treg.corotated_linear_elasticity(E, NU)
    for spec in (treg.rankine_plasticity(E, NU, 1.0e2, 5.0), treg.snow_plasticity()):
        ms = treg.ModelSet.pack([treg.ParticleModel(el, spec)], "cpu")
        for cls in (FusedMpmPipeline, SparseMpmPipeline):
            with pytest.raises(NotImplementedError):
                cls(b.grid, ms, b.colliders, b.params, device="cpu")
    e2 = tscenes.build("elasticity2", device="cpu")
    nacc = treg.ModelSet.from_tables([0], [[1.0, 1.0, 0.5, 1.0]], [2], np.ones((1, 8)), [0],
                                     np.zeros((1, 2)), "cpu")
    with pytest.raises(NotImplementedError):
        FusedMpmPipeline(e2.grid, nacc, e2.colliders, e2.params, device="cpu")
    with pytest.raises(NotImplementedError):
        tsk.auto_pipeline(e2, prefer="sparse", device="cpu")


def test_cuda_model_codes_match():
    """The type codes and kernel B's option bits the CUDA source branches
    on are the Python modules' (the wrapper passes clamp | 2·cache |
    4·svd_reuse)."""
    from sparkl_tpu_torch.models import constitutive as tcon
    from sparkl_tpu_torch.models import failure as tfail

    path = os.path.join(os.path.dirname(TK.__file__), "..", "csrc", "fused_kernels.cu")
    with open(path) as fh:
        consts = dict((k, int(v)) for k, v in
                      re.findall(r"constexpr int (\w+) = (\d+);", fh.read()))
    assert (consts["COROTATED"], consts["EOS_MONAGHAN_SPH"]) == (tcon.COROTATED,
                                                                 tcon.EOS_MONAGHAN_SPH)
    assert (consts["DRUCKER_PRAGER"], consts["RANKINE"], consts["SNOW"]) == (
        tplas.DRUCKER_PRAGER, tplas.RANKINE, tplas.SNOW)
    assert consts["MAXIMUM_STRESS"] == tfail.MAXIMUM_STRESS
    assert (consts["OPT_CLAMP"], consts["OPT_STRESS_CACHE"], consts["OPT_SVD_REUSE"]) == (1, 2, 4)
