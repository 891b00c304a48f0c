"""The port's 2D plastic scenes (elasticity2 and basic2 on the fused
pipeline) on the CPU against the JAX package: the Rankine, Snow and 2D
Drucker-Prager return maps (and Rankine and Snow in 3D), the registry's
plastic dispatch, the 2D heightfield, and kernel A's 2D stress-cache read
and kernel B's plastic branches (plain versions) against the Pallas kernels
in interpret mode. (test_torch_plastic2d_scenes.py holds both scene builds
and packs, permute_chunks and frame 0 of both scenes against the goldens.)

Inputs come from numpy seeds; the JAX kernels run in interpret mode, the
port's kernels through their plain versions. No JAX pipeline is stepped
(the goldens hold the trajectories). Each comparison states its
tolerance.
"""

from dataclasses import fields
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparkl_tpu as jsk
from sparkl_tpu.core.grid import GridParams as JGridParams
from sparkl_tpu.core.particles import Particles as JParticles
from sparkl_tpu.fused import kernels as JK
from sparkl_tpu.fused.pipeline import FusedMpmPipeline as JPipeline
from sparkl_tpu.geometry import colliders as jcol
from sparkl_tpu.models import plasticity as jplas
from sparkl_tpu.models import registry as jreg
from sparkl_tpu.sparse import transfer as JT
from sparkl_tpu.sparse.blocks import BlockConfig as JBlockConfig

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

torch.set_num_threads(1)

R2 = TL.Rows(2)
DT = 1.0e-3
E, NU = 2.0e4, 0.35
SMALL_CFG = dict(max_blocks=32, max_chunks=32, chunk_size=64, max_grid_blocks=64)


def jax_windows(jpipe, state, fields):
    """The JAX package's window gather (the windows its g2p_fused takes) of
    the port's node fields over the port state's structure."""
    structure = SimpleNamespace(nbr_index=jnp.asarray(state.structure.nbr_index.numpy()),
                                chunk_block=jnp.asarray(state.structure.chunk_block.numpy()))
    return JT.gather_grid_windows(jpipe.grid, jpipe._cfg, structure, jnp.asarray(fields.numpy()),
                                  cell_order=JT.ZMAJOR_ORDER_3D if jpipe.grid.dim == 3 else None)


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
# Collider
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
    fields = tpipe._node_fields(state, images, DT)
    windows = jax_windows(jpipe, state, fields)
    out_j = _np(JK.g2p_fused(jpipe.grid, jpipe._cfg, jpipe._meta, jpipe._kparams,
                             jnp.asarray(state.slots), jnp.asarray(state.ints),
                             windows, jnp.float32(DT), jpipe._tab_f,
                             jpipe._tab_i, interpret=True, nchunks=jnp.asarray(nch)))
    out_t = TK.g2p_fused(tpipe.grid, tpipe._cfg, meta, tpipe._kparams, state.slots, state.ints,
                         fields, tpipe._corners(state), DT, tpipe._tab_f, tpipe._tab_i,
                         nch).numpy()
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
