"""The remaining material models on the port's fused pipeline (neo-Hookean
elasticity, NACC plasticity, and Rankine and Snow in 3D), on the CPU
against the JAX package, their 3D forms: NACC's return map on random F,
kernels A and B's material forms (their plain versions) against the
Pallas kernels in interpret mode on reduced materials3 with the stress
cache on and off, the materials3 build and pack, and three substeps of
reduced materials3 through both fused pipelines.
(test_torch_materials2d.py holds the 2D forms on reduced materials2,
neo-Hookean's functions, a JAX model set carried across, and what the
kernels and both pipelines carry and refuse.)

The port builds materials3 and materials2 with chip_smoke.py's builders
(the port's API); this file builds them again with the JAX package's API.
Inputs come from numpy seeds; the JAX functions run jitted (XLA contracts
a·b + c into FMAs and divides by constants as products, as on every JAX
path), the kernels in interpret mode, the port through its plain
versions. Each comparison states its tolerance. NACC decides its case by
comparisons (the tips p_tr against p0 and -β p0, the yield function y
against 1e-4, the hardening gate), and two roundings of one lane may
decide differently where a compared quantity lies within TIE of its
threshold (plasticity.nacc_margin): such lanes are counted, and left out
of the comparisons they decide.
"""

import dataclasses
import math
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparkl_tpu.scenes as jscenes
from sparkl_tpu.core.particles import Particles as JParticles
from sparkl_tpu.fused import kernels as JK
from sparkl_tpu.fused.pipeline import FusedMpmPipeline as JPipeline
from sparkl_tpu.math import cmat as jcmat
from sparkl_tpu.math.svd import svd_c as jsvd_c
from sparkl_tpu.models import plasticity as jplas
from sparkl_tpu.models import registry as jreg
from sparkl_tpu.sparse import transfer as JT
from sparkl_tpu.sparse.blocks import BlockConfig as JBlockConfig

import chip_smoke
from test_torch_plastic2d import jax_windows
from sparkl_tpu_torch import interop
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.fused import kernels as TK
from sparkl_tpu_torch.fused import layout as TL
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
from sparkl_tpu_torch.models import constitutive as tcon
from sparkl_tpu_torch.models import plasticity as tplas
from sparkl_tpu_torch.models import registry as treg
from sparkl_tpu_torch.sparse.blocks import BlockConfig

torch.set_num_threads(1)

TIE = 1e-5
DT = 1e-4
# Capacities of the reduced scenes' kernel and pipeline runs (the
# calibrated ones hold 512 chunks, which the interpret-mode kernels would
# all walk): reduced materials3 packs 8 chunks in 8 blocks, reduced
# materials2 16 in 16.
# The material forms this file holds (test_torch_materials2d.py the 2D ones).
FORMS = ("3", "3-failure")
CFG = {3: dict(max_blocks=16, max_chunks=16, chunk_size=128, max_grid_blocks=64),
       2: dict(max_blocks=32, max_chunks=32, chunk_size=64, max_grid_blocks=64)}


def _np(x):
    return np.asarray(x)


def _c(a, lib):
    """[n, d, d] numpy -> nested list of lib arrays."""
    d = a.shape[-1]
    if lib == "jax":
        return [[jnp.asarray(a[:, i, j]) for j in range(d)] for i in range(d)]
    return [[torch.from_numpy(np.ascontiguousarray(a[:, i, j])) for j in range(d)]
            for i in range(d)]


def _stack(m):
    return np.stack([np.stack([_np(x) for x in row], -1) for row in m], -2)


# ---------------------------------------------------------------------------
# The constitutive functions and the NACC return map
# ---------------------------------------------------------------------------


def _jax_nacc_case(params, f, alpha):
    """NACC's case (0 A, 1 B, 2 C, 3 D) as the JAX package decides it: the
    trial state from its own SVD of f under jit (plasticity.py:173-231)."""
    mu, kappa, _, xi, beta, m = params
    d = float(len(f))
    _, s, _ = jsvd_c(f)
    sq = [si * si for si in s]
    sq_trace = sum(sq)
    p0 = kappa * (1.0e-5 + jcmat.sinh_c(xi * jnp.maximum(-alpha, 0.0)))
    j = s[0]
    for si in s[1:]:
        j = j * si
    safe_j = jnp.maximum(j, 1e-20)
    s_tr = [mu * jcmat.pow_pos(safe_j, -2.0 / d) * (q - sq_trace / d) for q in sq]
    p_tr = -(kappa / 2.0 * (j - 1.0 / safe_j)) * j
    y = ((1.0 + 2.0 * beta) * ((6.0 - d) / 2.0) * sum(x * x for x in s_tr)
         + m * m * (p_tr + beta * p0) * (p_tr - p0))
    case_a = p_tr > p0
    case_b = ~case_a & (p_tr < -beta * p0)
    case_c = ~case_a & ~case_b & (y < 1.0e-4)
    return jnp.where(case_a, 0, jnp.where(case_b, 1, jnp.where(case_c, 2, 3)))


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("hardening", [True, False])
def test_nacc_matches_jax(d, hardening):
    """nacc_update (the reference's NACC, its own SVD of F) on random F
    (I + 0.01 N, scaled to J uniform in [0.97, 1.03]) and α uniform in
    [-0.05, 0], with the sand-like parameters of materials3 (E = 1e7, ν =
    0.2, β 0.5, ξ 0.8, 35°): the case (A–D) equal to the JAX package's on
    every lane whose decisions are not within TIE of a threshold (at most
    1% of the lanes are), and on those lanes F within 1e-5 relative and α
    within 1e-5; each case occurs, and with hardening α moves on the lanes
    of cases A, B and D."""
    rng = np.random.default_rng(90 + 2 * d + int(hardening))
    n = 4096
    f = np.eye(d) + 0.01 * rng.normal(size=(n, d, d))
    j = rng.uniform(0.97, 1.03, n)
    f = (f * (j / np.linalg.det(f))[:, None, None] ** (1.0 / d)).astype(np.float32)
    alpha = rng.uniform(-0.05, 0.0, n).astype(np.float32)
    spec = jreg.nacc_plasticity(1.0e7, 0.2, 0.5, hardening, 0.8, math.radians(35.0), dim=d)[1]
    assert spec == treg.nacc_plasticity(1.0e7, 0.2, 0.5, hardening, 0.8, math.radians(35.0),
                                        dim=d)[1]
    pp = np.array(spec, np.float32)
    pj = [jnp.float32(x) for x in pp]
    fj, aj = jax.jit(jplas.nacc_update_c)(pj, _c(f, "jax"), jnp.asarray(alpha))
    case_j = _np(jax.jit(_jax_nacc_case)(pj, _c(f, "jax"), jnp.asarray(alpha)))
    ft, at, case_t, margin = tplas.nacc_project_c([torch.tensor(x) for x in pp], _c(f, "torch"),
                                                  torch.from_numpy(alpha))
    fj, ft, case_t = _stack(fj), _stack(ft), case_t.numpy()
    tie = margin.numpy() <= TIE
    clear = ~tie
    assert tie.mean() <= 0.01
    np.testing.assert_array_equal(case_t[clear], case_j[clear])
    np.testing.assert_array_less(np.abs(ft - fj).max((1, 2))[clear],
                                 1e-5 * np.maximum(np.abs(fj).max((1, 2)), 1.0)[clear])
    np.testing.assert_array_less(np.abs(at.numpy() - _np(aj))[clear], 1e-5)
    counts = np.bincount(case_t, minlength=4)
    assert (counts > 0).all(), counts
    moved = at.numpy() != alpha
    if hardening:
        assert moved[(case_t == tplas.NACC_TIP_MAX) | (case_t == tplas.NACC_TIP_MIN)].all()
        assert moved[case_t == tplas.NACC_PROJECT].any()
    else:
        assert not moved.any()
    assert not (ft[case_t == tplas.NACC_INSIDE] != f[case_t == tplas.NACC_INSIDE]).any()


# ---------------------------------------------------------------------------
# materials3 and materials2 with the JAX package's API
# ---------------------------------------------------------------------------


def _jax_models3(failure):
    e, nu = chip_smoke.MATERIALS_E, chip_smoke.MATERIALS_NU
    nh = jreg.neo_hookean_elasticity(e, nu)
    co = jreg.corotated_linear_elasticity(e, nu)
    return jreg.ModelSet.pack([
        jreg.ParticleModel(nh, jreg.nacc_plasticity(e, nu, 0.5, True, 0.8, math.radians(35.0))),
        jreg.ParticleModel(co, jreg.rankine_plasticity(e, nu, 5.0e4, 5.0)),
        jreg.ParticleModel(co, jreg.snow_plasticity()),
        jreg.ParticleModel(co, jreg.drucker_prager_plasticity(e, nu)),
        jreg.ParticleModel(nh, failure=jreg.maximum_stress_failure(*chip_smoke.MATERIALS3_FAILURE)
                           if failure else None),
    ])


def jax_materials3(scale=1.0, failure=False):
    """chip_smoke.materials3 built with the JAX package's API."""
    nx, ny, nz = (int(round(c * scale)) for c in chip_smoke.MATERIALS3_COUNTS)
    b = jscenes.build("sand3", nx=nx, ny=ny, nz=nz)
    idx = np.arange(b.particles.capacity)
    mid = np.where(idx < nx * ny * nz, (idx // (ny * nz)) // (nx // 4), 4).astype(np.int32)
    return dataclasses.replace(b, models=_jax_models3(failure),
                               particles=b.particles.replace(model_id=jnp.asarray(mid)))


def jax_materials2(scale=1.0, failure=False):
    """chip_smoke.materials2 built with the JAX package's API."""
    b = jscenes.build("basic2")
    e, nu = 1.0e5, 0.2
    nh = jreg.neo_hookean_elasticity(e, nu)
    models = jreg.ModelSet.pack([
        jreg.ParticleModel(nh, jreg.nacc_plasticity(e, nu, 0.5, True, 0.8, math.radians(35.0),
                                                    dim=2)),
        jreg.ParticleModel(nh, failure=jreg.maximum_stress_failure(*chip_smoke.MATERIALS2_FAILURE)
                           if failure else None),
        jreg.ParticleModel(jreg.corotated_linear_elasticity(e, nu),
                           jreg.rankine_plasticity(e, nu, 500.0, 5.0)),
    ])
    side = int(round(chip_smoke.PLASTIC_BLOCK * scale))
    r = b.grid.cell_width / 4.0
    cols = np.array_split(np.arange(side, dtype=np.float32), 3)
    ys = 0.6 + r + 2.0 * r * np.arange(side, dtype=np.float32)
    parts = []
    for m, (xi, rho) in enumerate(zip(cols, (1000.0, 1000.0, 4000.0))):
        gx, gy = np.meshgrid(-0.55 + r + 2.0 * r * xi, ys, indexing="ij")
        pts = np.stack([gx.reshape(-1), gy.reshape(-1)], -1).astype(np.float32)
        parts.append(JParticles.from_positions(pts, m, r, rho))
    return dataclasses.replace(b, models=models, particles=JParticles.concatenate(tuple(parts)))


def _pipelines(dim, failure):
    """The reduced scene (materials3 in 3D, materials2 in 2D) from both
    packages: (JAX bundle, port bundle, JAX pipeline in interpret mode and
    port pipeline, both at CFG[dim] and one substep a frame)."""
    if dim == 3:
        jb = jax_materials3(chip_smoke.MATERIALS3_SMALL, failure)
        tb = chip_smoke.materials3(chip_smoke.MATERIALS3_SMALL, failure, device="cpu")
    else:
        jb = jax_materials2(chip_smoke.MATERIALS2_SMALL, failure)
        tb = chip_smoke.materials2(chip_smoke.MATERIALS2_SMALL, failure, device="cpu")
    jp = dataclasses.replace(jb.params, stop_after_one_substep=True)
    jpipe = JPipeline(jb.grid, jb.models, jb.colliders, jp, jb.gravity,
                      config=JBlockConfig(**CFG[dim]), use_pallas="interpret")
    tpipe = FusedMpmPipeline(tb.grid, tb.models, tb.colliders,
                             dataclasses.replace(tb.params, stop_after_one_substep=True),
                             tb.gravity, config=BlockConfig(**CFG[dim]), device="cpu")
    return jb, tb, jpipe, tpipe


def pipelines_by_form(forms):
    """Per form ("3", "3-failure", "2", "2-failure"): _pipelines."""
    return {form: _pipelines(int(form[0]), form.endswith("failure")) for form in forms}


@pytest.fixture(scope="module")
def scenes():
    """The 3D forms' _pipelines (test_torch_materials2d.py builds the 2D
    forms')."""
    return pipelines_by_form(FORMS)


def check_materials_builds_bit_equal(scenes, form):
    """The body of test_materials_builds_bit_equal (this file's cases and another file's)."""
    jb, tb, _, _ = scenes[form]
    for f in fields(tb.particles):
        a, b = getattr(tb.particles, f.name).numpy(), _np(getattr(jb.particles, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert tb.grid == GridParams(jb.grid.origin, jb.grid.cell_width, jb.grid.res)
    for k in ("ctype", "cparams", "ptype", "pparams", "ftype", "fparams"):
        np.testing.assert_array_equal(getattr(tb.models, k).numpy(), _np(getattr(jb.models, k)))
    mid = tb.particles.model_id.numpy()
    if form.startswith("3"):
        assert tb.particles.capacity == 512 and np.bincount(mid).tolist() == [64] * 4 + [256]
        assert tb.models.present_c == (tcon.COROTATED, tcon.NEO_HOOKEAN)
        assert tb.models.present_p == (tplas.DRUCKER_PRAGER, tplas.NACC, tplas.RANKINE,
                                       tplas.SNOW)
    else:
        assert tb.particles.capacity == 576 and np.bincount(mid).tolist() == [192] * 3
    assert bool(tb.models.present_f) == form.endswith("failure")


@pytest.mark.parametrize("form", FORMS)
def test_materials_builds_bit_equal(scenes, form):
    """chip_smoke.materials3 and materials2 (the port's API), reduced, and
    with their failure forms, against the same configurations built with
    the JAX package's API: every particle field, the grid and the model
    tables bit for bit; materials3's bands hold 2 lattice columns each
    (models 0-3), the lower lattice model 4."""
    check_materials_builds_bit_equal(scenes, form)


def check_materials_pack_bit_equal(scenes, dim):
    """The body of test_materials_pack_bit_equal (this file's cases and another file's)."""
    jb, tb, _, _ = scenes[str(dim)]
    jpipe = JPipeline(jb.grid, jb.models, jb.colliders, jb.params, jb.gravity,
                      use_pallas="interpret")
    jpipe._ensure_cfg(jb.particles)
    js = jpipe._jit_pack(jb.particles)
    tpipe = FusedMpmPipeline(tb.grid, tb.models, tb.colliders, tb.params, tb.gravity,
                             device="cpu")
    ts = tpipe.pack_state(tb.particles)
    assert tpipe._cfg == BlockConfig(**vars(jpipe._cfg)) and tpipe._meta["stress_cache"]
    np.testing.assert_array_equal(ts.ints.numpy(), _np(js.ints))
    np.testing.assert_array_equal(ts.slots.numpy(), _np(js.slots))
    for name, v in ts.structure.tensors().items():
        np.testing.assert_array_equal(v.numpy(), _np(getattr(js.structure, name)), err_msg=name)
    arrays = {name: _np(getattr(js.structure, name)) for name in ts.structure.tensors()}
    arrays.update(slots=_np(js.slots), ints=_np(js.ints), cum_disp=_np(js.cum_disp))
    carried = interop.slot_state_from_numpy(arrays, device="cpu")
    np.testing.assert_array_equal(carried.slots.numpy(), ts.slots.numpy())
    r = TL.Rows(dim)
    occ = (ts.ints.numpy()[:, TL.I_FLAGS] & TL.OCCUPIED) != 0
    assert (carried.slots.numpy()[:, r.nacc][occ] == np.float32(-0.01)).all()


@pytest.mark.parametrize("dim", [3])
def test_materials_pack_bit_equal(scenes, dim):
    """The fused pack of the reduced materials3 and materials2 (the stress
    cache on: its rows seeded from registry.kirchhoff_stress, neo-Hookean
    and corotated): the structure, every slot row (the stress and dt-bound
    rows among them) and the ints, bit for bit, at the JAX pipeline's
    calibration; the JAX pack carried across by interop.slot_state_from_numpy
    keeps every row, the nacc row among them."""
    check_materials_pack_bit_equal(scenes, dim)


# ---------------------------------------------------------------------------
# Kernels A and B's material forms against the Pallas kernels
# ---------------------------------------------------------------------------


def _perturbed_state(tpipe, tb, seed):
    """The port's pack of the reduced scene with, on occupied lanes, F = I +
    s_m N per model m (MATERIALS_PERTURB's scales for the full-size check,
    doubled), random velocities (0.3 N) and velocity gradients (N), NACC's
    α uniform in [-0.05, 0], and with the cache on random symmetric stress
    rows (50 kPa N, so that kernel A must read them)."""
    dim = tpipe.grid.dim
    r = TL.Rows(dim)
    state = tpipe.pack_state(tb.particles)
    slots = state.slots.numpy().copy()
    ints = state.ints.numpy()
    occ = (ints[:, TL.I_FLAGS] & TL.OCCUPIED) != 0
    mid = ints[:, TL.I_MODEL]
    rng = np.random.default_rng(seed)
    shape = slots[:, 0].shape
    name = f"materials{dim}" + ("-failure" if tpipe.models.present_f else "")
    scale = np.zeros(shape, np.float32)
    for m, sc in chip_smoke.MATERIALS_PERTURB[name].items():
        scale = np.where(mid == m, 2.0 * sc, scale)
    for i in range(dim):
        slots[:, r.vel + i] = np.where(occ, rng.normal(scale=0.3, size=shape), 0.0)
        for j in range(dim):
            eye = 1.0 if i == j else 0.0
            slots[:, r.defgrad + dim * i + j] = np.where(
                occ, eye + scale * rng.normal(size=shape), 0.0)
            slots[:, r.grad + dim * i + j] = np.where(occ, rng.normal(size=shape), 0.0)
    slots[:, r.nacc] = np.where(occ, rng.uniform(-0.05, 0.0, size=shape), slots[:, r.nacc])
    if tpipe._meta["stress_cache"]:
        for k in range(r.nstress):
            slots[:, r.stress + k] = np.where(occ, rng.normal(scale=5e4, size=shape), 0.0)
    return state.replace(slots=torch.from_numpy(slots.astype(np.float32)))


# The perturbed states' numpy seeds, per form.
SEEDS = {"3": 100, "3-failure": 101, "2": 102, "2-failure": 103}


def states_by_form(scenes):
    return {form: _perturbed_state(s[3], s[1], SEEDS[form]) for form, s in scenes.items()}


@pytest.fixture(scope="module")
def kernel_states(scenes):
    return states_by_form(scenes)


def check_kernel_a_materials_matches_pallas(scenes, kernel_states, form):
    """The body of test_kernel_a_materials_matches_pallas (this file's cases and another file's)."""
    _, _, jpipe, tpipe = scenes[form]
    state = kernel_states[form]
    dim = tpipe.grid.dim
    assert tpipe._meta["stress_cache"] == (not form.endswith("failure"))
    assert TK.mats_form(tpipe._meta, dim)
    nch = state.structure.num_chunks
    img_j = _np(JK.p2g_fused(jpipe.grid, jpipe._cfg, jpipe._meta, jnp.asarray(state.slots),
                             jnp.asarray(state.ints), jnp.float32(DT), jpipe._tab_f,
                             jpipe._tab_i, interpret=True, nchunks=jnp.asarray(nch)))
    TK.reset_launch_counts()
    img_t = TK.p2g_fused(tpipe.grid, tpipe._cfg, tpipe._meta, state.slots, state.ints, DT, nch,
                         tables=(tpipe._tab_f, tpipe._tab_i)).numpy()
    assert TK.LAUNCHES["p2g_fused"] == 0
    cells = 512 if dim == 3 else 64
    assert img_t.shape == img_j.shape == (CFG[dim]["max_chunks"], 1 + dim, cells)
    np.testing.assert_allclose(img_t, img_j, rtol=1e-5, atol=1e-6 * np.abs(img_j).max())


@pytest.mark.parametrize("form", FORMS)
def test_kernel_a_materials_matches_pallas(scenes, kernel_states, form):
    """Kernel A's material forms on the perturbed reduced states: the
    stress-cache read (materials3, materials2) and the fresh corotated and
    neo-Hookean stress (the failure forms, the cache off): images [D, 1 +
    d, 8^d] within rtol 1e-5, atol 1e-6 of the image's scale
    (test_torch_plastic2d's bound: the same terms summed in another
    order)."""
    check_kernel_a_materials_matches_pallas(scenes, kernel_states, form)


def check_kernel_b_materials_matches_pallas(scenes, kernel_states, form):
    """The body of test_kernel_b_materials_matches_pallas (this file's cases and another file's)."""
    _, _, jpipe, tpipe = scenes[form]
    state = kernel_states[form]
    dim = tpipe.grid.dim
    r = TL.Rows(dim)
    meta = tpipe._meta
    assert not TK.svd_reuse(meta["stress_cache"], meta["present_c"], meta["present_p"])
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
                         fields, tpipe._corners(state), DT, tpipe._tab_f, tpipe._tab_i, nch)
    counts, tie, _ = chip_smoke.material_counts(tpipe, state, out_t, DT)
    out_t, tie = out_t.numpy(), tie.numpy()
    slots_in, ints = state.slots.numpy(), state.ints.numpy()
    occ = (ints[:, TL.I_FLAGS, :] & TL.OCCUPIED) != 0
    nacc_lanes = occ & (tpipe._tab_i[:, 1].numpy()[ints[:, TL.I_MODEL]] == tplas.NACC)
    assert tie.sum() <= 0.02 * nacc_lanes.sum()
    keep = (occ & ~tie)[:, None, :]
    a = np.where(keep, out_t, 0.0)
    b = np.where(keep, out_j, 0.0)
    mu = float(tpipe.models.cparams[:, 1].max())
    m_max = np.abs(b[:, r.mass]).max()
    escale = 2.0 * np.sqrt(mu * np.abs(b[:, r.psi_pos]).max())
    loose = set(range(r.defgrad, r.defgrad + dim * dim)) | {r.pdd, r.ph, r.eh, r.lvg, r.nacc}
    lam = float(tpipe.models.cparams[:, 0].max())
    for k in range(r.nf):
        err = np.abs(a[:, k] - b[:, k]).max()
        if k in (r.failed, r.phase):
            np.testing.assert_array_equal(a[:, k], b[:, k], err_msg=str(k))
        elif r.stress <= k < r.stress + r.nstress:
            assert err <= 2e-5 * (lam + 2.0 * mu), k
        elif k == r.psi_pos:
            assert err <= 2e-5 * escale, k
        elif k == r.par1:
            assert err <= 2e-5 * escale * m_max, k
        else:
            tol = 2e-5 if k in loose else 1e-5
            assert err <= tol * max(np.abs(b[:, k]).max(), 1e-30), k
    need = ["nacc_a_tip_max", "nacc_b_tip_min", "nacc_d_project", "rankine_cap_largest"]
    for key in need + ([] if form.endswith("failure") else ["nacc_c_inside"]):
        assert counts[key] > 0, (key, counts)
    if dim == 3:
        assert min(counts["snow_below"], counts["snow_above"], counts["dp_flow"],
                   counts["rankine_cap_two"]) > 0, counts
    if form.endswith("failure"):
        assert counts["max_stress_trips"] > 0
    else:
        assert np.abs(b[:, r.stress : r.stress + r.nstress]).max() > 0


@pytest.mark.parametrize("form", FORMS)
def test_kernel_b_materials_matches_pallas(scenes, kernel_states, form):
    """Kernel B's material forms on occupied lanes of the perturbed reduced
    states, on the windows of the port's kernel-A images: NACC (with the
    nacc row), neo-Hookean's energy, cached stress (cache on) or failure
    stress (cache off) and dt bound, Rankine and Snow in 3D with
    Drucker-Prager beside them (3D), and NACC, neo-Hookean and Rankine in 2D.
    test_torch_plastic2d's row tolerances: rows to 1e-5 of their scale,
    those that pass through the SVDs and the maps' exp/log (F, the plastic
    state, nacc, the hardening) to 2e-5; the energy rows psi_pos and par1
    to 2e-5 of the strain-equivalent scale 2 sqrt(µ e_max) (times m for
    par1), as test_torch_fracture3d holds them (neo-Hookean's energy
    cancels near F = I); the stress rows to 2e-5 of λ + 2µ, chip_smoke's
    g2p_errors measure (the cardano SVD's f32 floor as a strain: Snow's
    clamp and Rankine's caps set singular values equal, and the epilogue's
    SVD of such an F is degenerate; measured 1.5e-5 here); on every lane
    but the NACC ties (counted, at most 2% of the NACC lanes). failed equal; phase equal (the failure
    forms trip maximum stress on the neo-Hookean lanes: checked). NACC's
    tips and projection occur in every form (its inside case too without
    failure), and the Rankine caps; in 3D also Snow's two clamps,
    Rankine's two-strain cap and Drucker-Prager flow."""
    check_kernel_b_materials_matches_pallas(scenes, kernel_states, form)


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------


def _perturbed_particles(p, dim, seed):
    """JAX particles perturbed as chip_smoke.perturbed_particles perturbs the
    port's (F = I + 0.005 N, velocities 0.2 N, numpy seed), so that the
    first substeps load every model."""
    rng = np.random.default_rng(seed)
    n = p.capacity
    f = (np.eye(dim) + 0.005 * rng.normal(size=(n, dim, dim))).astype(np.float32)
    v = rng.normal(scale=0.2, size=(n, dim)).astype(np.float32)
    return p.replace(deformation_gradient=jnp.asarray(f), velocity=jnp.asarray(v))


def test_reduced_materials3_substeps_match_jax_fused(scenes):
    """Three substeps of reduced materials3 (F and velocities perturbed from
    a numpy seed, each substep from the JAX particles of the one before)
    through the port's fused pipeline on the CPU against the JAX fused
    pipeline in interpret mode, at the JAX run's dts: |dx| <= 1e-6, |dv| <=
    1e-4, |dF| <= 1e-5 and |d alpha| <= 1e-5 on every particle but those
    whose NACC decision in that substep lay within TIE of a threshold (at
    most 2 a substep), the same substep counts, flags and phases equal; NACC
    α moves."""
    jb, _, jpipe, tpipe = scenes["3"]
    pj = _perturbed_particles(jb.particles, 3, 110)
    alpha0 = _np(pj.nacc_alpha)
    dts = []
    min_dtb = tpipe._min_dtb
    tpipe._min_dtb = lambda st: dts.append(min_dtb(st)) or dts[-1]
    for step in range(1, 4):
        pj2, nj = jpipe.step_with_stats(pj)
        pt_in = interop.particles_from_numpy({f.name: _np(getattr(pj, f.name)) for f in
                                              fields(pj)}, device="cpu")
        pt2, nt = tpipe.step_with_stats(pt_in)
        assert int(nj) == nt == 1
        act = _np(pj2.active)
        np.testing.assert_array_equal(pt2.active.numpy(), act)
        np.testing.assert_array_equal(pt2.failed.numpy(), _np(pj2.failed))
        np.testing.assert_array_equal(pt2.phase.numpy(), _np(pj2.phase))
        ties = _nacc_ties(tpipe, pt_in, pt2, float(dts[-1]))
        assert ties.sum() <= 2, (step, ties.sum())
        keep = act & ~ties
        for name, tol in (("position", 1e-6), ("velocity", 1e-4),
                          ("deformation_gradient", 1e-5), ("nacc_alpha", 1e-5)):
            err = np.abs(getattr(pt2, name).numpy()[keep] - _np(getattr(pj2, name))[keep]).max()
            assert err <= tol, (step, name, err)
        pj = pj2
    del tpipe._min_dtb
    assert (_np(pj.nacc_alpha) != alpha0).any()


def _nacc_ties(tpipe, p_in, p_out, dt):
    """Particles of NACC models whose decisions in the substep of `dt` from
    p_in to p_out lie within TIE of a threshold: nacc_margin of the map's
    input, p_in's F updated with p_out's velocity gradient as kernel B's
    plain version updates it."""
    from sparkl_tpu_torch.math import cmat

    ms = tpipe.models
    mid = p_in.model_id.long()
    f = cmat.unpack(p_in.deformation_gradient)
    gf = cmat.matmul_c(cmat.unpack(p_out.velocity_gradient), f)
    fu = [[f[i][j] + dt * gf[i][j] for j in range(3)] for i in range(3)]
    pp = ms.pparams[mid]
    margin = tplas.nacc_project_c([pp[:, k] for k in range(6)], fu, p_in.nacc_alpha)[3]
    return ((ms.ptype[mid] == tplas.NACC) & (margin <= TIE)).numpy()


