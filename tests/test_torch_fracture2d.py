"""The port's 2D fracture path (l_panel2 on the fused pipeline) on the CPU
against the JAX package: the 2x2 SVD, maximum-stress failure, the cuboid
projection, the Dirichlet velocity hook, the l_panel2 scene, its 2D
structure and pack at C = 64, the eigenerosion candidates and pooling,
and three substeps of the full l_panel2 against the JAX dense pipeline.
(test_torch_fracture2d_fused.py holds kernels A and B's 2D damage forms
and a small two-panel scene against the JAX fused pipeline.)

Inputs come from numpy seeds; the JAX kernels run in interpret mode, the
port's kernels through their plain versions. The l_panel2 golden is not
replayed: at its reduced cell width the second panel lies outside the grid
(ROADMAP queue 3). Each comparison states its tolerance.
"""

import importlib
import json
import os
from dataclasses import fields, replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparkl_tpu.scenes as jscenes
from sparkl_tpu.core.grid import GridState as JGridState
from sparkl_tpu.fused import kernels as JK
from sparkl_tpu.fused import layout as JL
from sparkl_tpu.fused.pipeline import FusedMpmPipeline as JPipeline
from sparkl_tpu.geometry import colliders as jcol
from sparkl_tpu.models import failure as jfail
from sparkl_tpu.solver import dense as jdense
from sparkl_tpu.solver.pipeline import DirichletVelocityHook as JHook
from sparkl_tpu.solver.pipeline import MpmPipeline as JDense

import sparkl_tpu_torch.scenes as tscenes
from sparkl_tpu_torch import interop
from sparkl_tpu_torch.core.grid import GridParams, GridState
from sparkl_tpu_torch.fused import kernels as TK
from sparkl_tpu_torch.fused import layout as TL
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
from sparkl_tpu_torch.math import svd as tsvd
from sparkl_tpu_torch.models import failure as tfail
from sparkl_tpu_torch.solver import dense as tdense
from sparkl_tpu_torch.sparse.blocks import BlockConfig

torch.set_num_threads(1)

jsvd = importlib.import_module("sparkl_tpu.math.svd")  # the package re-exports a function `svd`
R2 = TL.Rows(2)
DT = 2.0e-3
# Trip decisions may differ only where the decided quantity lies within
# this relative distance of its threshold (rounding of the pooled and
# stress sums, which the two packages take in other orders).
TIE = 1e-5


def _jnp(x):
    return np.asarray(x)


def _compare(pj, pt, msg=""):
    """tests/test_fused.py::_compare's tolerances (fused against dense)."""
    act = _jnp(pj.active)
    np.testing.assert_array_equal(pt.active.numpy(), act)
    np.testing.assert_allclose(pt.position.numpy()[act], _jnp(pj.position)[act], atol=5e-5,
                               err_msg=msg)
    np.testing.assert_allclose(pt.velocity.numpy()[act], _jnp(pj.velocity)[act], atol=5e-4,
                               err_msg=msg)
    np.testing.assert_allclose(pt.deformation_gradient.numpy()[act],
                               _jnp(pj.deformation_gradient)[act], atol=5e-4, err_msg=msg)
    np.testing.assert_array_equal(pt.failed.numpy()[act], _jnp(pj.failed)[act], err_msg=msg)


# ---------------------------------------------------------------------------
# Math, models, collider
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "near_degenerate"])
def test_svd2x2_matches_jax(kind):
    """The closed form against the JAX package's. random (I + 0.3 N): u, s
    and v, atol 2e-6 (of the scale for s; the port's CPU sqrt differs from
    XLA's by up to an ulp, which the rotations carry into u and v).
    near_degenerate (zero, rank one, scaled identity (no Givens rotation),
    reflections with a + d ~ 0, near-identity, tiny entries): there the
    rotations turn on noise-level entries, so any orthonormal u, v are
    right; s to 2e-6 of the scale, F rebuilt to 4e-6 of it, u and v
    orthonormal to 2e-6, on every lane."""
    rng = np.random.default_rng(21)
    n = 512
    if kind == "random":
        f = np.eye(2) + 0.3 * rng.normal(size=(n, 2, 2))
    else:
        a = rng.normal(size=(n, 2, 1))
        f = np.concatenate([
            np.zeros((8, 2, 2)),
            (a @ rng.normal(size=(n, 1, 2)))[:128],  # rank one
            np.eye(2) * rng.uniform(0.5, 2.0, size=(64, 1, 1)),
            np.diag([1.0, -1.0]) + 1e-7 * rng.normal(size=(64, 2, 2)),
            np.eye(2) + 1e-7 * rng.normal(size=(128, 2, 2)),
            1e-12 * rng.normal(size=(64, 2, 2)),
        ])
    f = f.astype(np.float32)
    uj, sj, vj = (np.asarray(x) for x in jax.jit(jsvd.svd2x2)(jnp.asarray(f)))
    ut, st, vt = (x.numpy() for x in tsvd.svd2x2(torch.from_numpy(f)))
    scale = np.maximum(np.abs(f).max(axis=(1, 2)), 1e-30)
    np.testing.assert_array_less(np.abs(np.sort(st, 1) - np.sort(sj, 1)).max(1), 2e-6 * scale)
    if kind == "random":
        np.testing.assert_allclose(ut, uj, atol=2e-6)
        np.testing.assert_allclose(vt, vj, atol=2e-6)
    rebuilt = ut * st[:, None, :] @ vt.transpose(0, 2, 1)
    np.testing.assert_array_less(np.abs(rebuilt - f).max(axis=(1, 2)), 4e-6 * scale)
    for q in (ut, vt):
        np.testing.assert_allclose(q @ q.transpose(0, 2, 1), np.broadcast_to(np.eye(2), q.shape),
                                   atol=2e-6)
    assert (st >= 0).all()
    # The singular values alone and the dispatch go through the same form.
    fc = [[torch.from_numpy(f[:, i, j].copy()) for j in range(2)] for i in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(tsvd.svd_values_c(fc), tsvd.svd_c(fc)[1]))


@pytest.mark.parametrize("dim", [2, 3])
def test_maximum_stress_failed_matches_jax(dim):
    """The failure flag on random non-symmetric stresses and thresholds:
    equal to the JAX package's on every lane whose principal or shear
    margin is not within TIE of its threshold (none here: the eigenvalues
    agree to f32 rounding)."""
    rng = np.random.default_rng(22 + dim)
    n = 4096
    stress = (rng.normal(size=(n, dim, dim)) * 100.0).astype(np.float32)
    params = np.stack([rng.uniform(50.0, 300.0, n), rng.uniform(50.0, 300.0, n)],
                      -1).astype(np.float32)
    fj = np.asarray(jfail.maximum_stress_failed(jnp.asarray(params), jnp.asarray(stress)))
    ft = tfail.maximum_stress_failed(torch.from_numpy(params), torch.from_numpy(stress)).numpy()
    sym = 0.5 * (stress + stress.transpose(0, 2, 1)).astype(np.float64)
    eig = np.linalg.eigvalsh(sym)
    margin = np.minimum(np.abs(eig[:, -1] - params[:, 0]) / params[:, 0],
                        np.abs((eig[:, -1] - eig[:, 0]) / 2 - params[:, 1]) / params[:, 1])
    clear = margin > TIE
    np.testing.assert_array_equal(ft[clear], fj[clear])
    assert 0.2 < ft.mean() < 0.8 and clear.mean() > 0.99


def test_cuboid_projection_matches_jax():
    """l_panel2's ground (a 1000 x 10h cuboid, translated) and a rotated
    box, on points inside, outside and on the faces: projections to 1e-6
    (the rotated box's pose products round in both), containment equal."""
    rng = np.random.default_rng(23)
    pts = rng.uniform(-1.0, 1.0, size=(4096, 2)).astype(np.float32)
    pts[:64, 1] = 0.15  # on the ground's top face
    c, s = np.cos(0.3), np.sin(0.3)
    for he, t, r in (((1000.0, 0.05), (0.0, 0.1), None),
                     ((0.3, 0.2), (0.1, -0.2), np.array([[c, -s], [s, c]], np.float32))):
        jc = jcol.cuboid(he, translation=t, rotation=r)
        tc = interop.collider_from_numpy(jc.shape_type, jc.data, jc.translation, jc.rotation)
        pj, ij = (np.asarray(x) for x in jc.project_point(jnp.asarray(pts)))
        pt, it = tc.project_point(torch.from_numpy(pts))
        np.testing.assert_array_equal(it.numpy(), ij)
        np.testing.assert_allclose(pt.numpy(), pj, atol=1e-6)
        assert 0 < ij.sum() < len(pts)


# ---------------------------------------------------------------------------
# l_panel2 at the reference settings: scene, structure, hook, candidates, pooling
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def panel():
    """The JAX l_panel2 (60,000 particles) packed at its calibrated
    capacities, the port's build of it, and both pipelines' objects."""
    jb = jscenes.build("l_panel2")
    tb = tscenes.build("l_panel2", device="cpu")
    jpipe = JPipeline(jb.grid, jb.models, jb.colliders, jb.params, jb.gravity, jb.hooks,
                      use_pallas="interpret")
    jpipe._ensure_cfg(jb.particles)
    jcfg = jpipe._cfg
    dtb = jdense.particle_dt_bounds(jb.grid, jb.particles, jb.models)
    jstate = jax.jit(lambda q, d: JL.pack(jb.grid, jcfg, q, d))(jb.particles, dtb)
    tpipe = FusedMpmPipeline(tb.grid, tb.models, tb.colliders, tb.params, tb.gravity, tb.hooks,
                             device="cpu")
    tpipe._ensure_cfg(tb.particles)
    tstate = TL.pack(tb.grid, tpipe._cfg, tb.particles, torch.from_numpy(np.asarray(dtb)),
                     cache_fn=tpipe._grid_cache)
    return jb, tb, jpipe, jstate, tpipe, tstate


def test_l_panel2_builds_bit_equal(panel):
    jb, tb, *_ = panel
    assert tb.particles.capacity == 60000 and tb.grid.dim == 2
    for f in fields(tb.particles):
        a, b = getattr(tb.particles, f.name).numpy(), _jnp(getattr(jb.particles, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    cpf = tb.particles.crack_propagation_factor.numpy()
    assert (cpf == 4.5).sum() == 30000 and (cpf == 0.0).sum() == 30000
    assert tb.grid == GridParams(jb.grid.origin, jb.grid.cell_width, jb.grid.res)
    for k in ("ctype", "cparams", "ptype", "pparams", "ftype", "fparams"):
        np.testing.assert_array_equal(getattr(tb.models, k).numpy(), _jnp(getattr(jb.models, k)))
    (tc,), (jc,) = tb.colliders, jb.colliders
    assert tc.shape_type == jc.shape_type == jcol.CUBOID
    for a, b in zip((*tc.data, tc.translation, tc.rotation), (*jc.data, jc.translation,
                                                               jc.rotation)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tb.hooks.points, jb.hooks.points)
    np.testing.assert_array_equal(tb.hooks.velocities, jb.hooks.velocities)
    assert (tb.params.dt, int(tb.params.boundary_handling), int(tb.params.damage_model)) == (
        jb.params.dt, int(jb.params.boundary_handling), int(jb.params.damage_model))
    assert tuple(tb.gravity) == tuple(jb.gravity)
    # The reduced golden's configuration is degenerate (ROADMAP queue 3):
    # the panels sit at 40h and 320h but the grid stops at x = 2.2, so at
    # cell width 0.02 all of panel 2 and the top of panel 1 start outside
    # it, which is every particle the golden records as failed.
    gold = json.load(open(os.path.join(os.path.dirname(__file__), "golden_scenes.json")))
    small = tscenes.build("l_panel2", device="cpu", **gold["l_panel2"]["config"])
    out = tdense.mark_out_of_grid_failed(small.grid, small.particles)
    counts = [int((out.failed & (out.model_id == m)).sum()) for m in (0, 1)]
    assert (small.particles.capacity, counts) == (3750, [1350, 1875])
    assert sum(counts) == gold["l_panel2"]["frames"][0]["failed"] == 3225


def test_structure_and_pack_bit_equal(panel):
    """The 2D structure, slots and ints at C = 64 (the stress cache is off,
    so no stress rows are seeded), bit for bit, and the calibration."""
    jb, tb, jpipe, jstate, tpipe, tstate = panel
    assert tpipe._cfg == BlockConfig(**vars(jpipe._cfg)) and tpipe._cfg.chunk_size == 64
    np.testing.assert_array_equal(tstate.slots.numpy(), _jnp(jstate.slots))
    np.testing.assert_array_equal(tstate.ints.numpy(), _jnp(jstate.ints))
    for k, v in tstate.structure.tensors().items():
        np.testing.assert_array_equal(v.numpy(), _jnp(getattr(jstate.structure, k)), err_msg=k)
    assert tstate.slots.shape[1:] == (R2.nf, 64) == (40, 64)


def test_dirichlet_hook_matches_jax(panel):
    """The hook on l_panel2's block node table (its node positions, the
    trash row far outside included) at its two loading points: bit-equal
    velocities, and exactly one node pinned per point."""
    _, tb, _, _, _, tstate = panel
    node_pos = tstate.grid_cache[0].numpy()
    vel = np.random.default_rng(24).normal(size=node_pos.shape).astype(np.float32)
    zero = np.zeros(node_pos.shape[:-1], np.float32)
    jh = JHook(tb.hooks.points, tb.hooks.velocities)
    jz = jnp.asarray(zero)
    out_j = jh.post_grid_update(
        JGridState(mass=jz, momentum=jnp.asarray(vel), velocity=jnp.asarray(vel),
                   psi_momentum=jz, psi_mass=jz),
        tb.grid, DT, jnp.asarray(node_pos))
    th = interop.dirichlet_hook_from_numpy(tb.hooks.points, tb.hooks.velocities)
    z = torch.from_numpy(zero)
    out_t = th.post_grid_update(GridState(z, torch.from_numpy(vel), torch.from_numpy(vel), z, z),
                                tb.grid, DT, torch.from_numpy(node_pos))
    np.testing.assert_array_equal(out_t.velocity.numpy(), np.asarray(out_j.velocity))
    pinned = (out_t.velocity.numpy() != vel).any(-1)
    assert pinned.sum() == 2


def test_eigen_candidates_bit_equal(panel):
    """Candidate chunk ids of the pooling (3^2 neighbour blocks x 2 chunks),
    and the overflow flag when the list takes one chunk per block."""
    _, _, jpipe, jstate, tpipe, tstate = panel
    for mcb in (2, 1):
        tpipe._eigen_mcb = jpipe._eigen_mcb = mcb
        try:
            cj, oj = jax.jit(jpipe._eigen_candidates)(jstate.structure)
            ct, ot = tpipe._eigen_candidates(tstate.structure)
        finally:
            tpipe._eigen_mcb = jpipe._eigen_mcb = 2
        np.testing.assert_array_equal(ct.numpy(), _jnp(cj))
        assert ct.shape[1] == 9 * mcb and bool(ot) == bool(oj)


def _eigen_rows(slots, ints, perturb):
    """The pooling's eigen rows [D, 8, C] as the JAX pipeline builds them
    (sparkl_tpu/fused/pipeline.py:401-414); `perturb` jitters positions by
    up to 0.4 h, draws psi_pos and makes a third of the lanes ineligible."""
    s = np.array(slots)
    r = R2
    if perturb:
        rng = np.random.default_rng(25)
        s[:, r.pos : r.pos + 2] += rng.uniform(-0.002, 0.002, size=s[:, :2].shape)
        s[:, r.psi_pos] = rng.uniform(0.0, 100.0, size=s[:, 0].shape)
        s[:, r.phase] = np.where(rng.uniform(size=s[:, 0].shape) < 0.33, 0.0, s[:, r.phase])
    active = (np.asarray(ints)[:, TL.I_FLAGS] & TL.ACTIVE) != 0
    elig = (s[:, r.cpf] != 0) & (s[:, r.phase] > 0) & (s[:, r.failed] == 0) & active
    mass = s[:, r.mass]
    e = np.zeros((s.shape[0], TK.EIG_ROWS, s.shape[2]), np.float32)
    e[:, 0:2] = s[:, r.pos : r.pos + 2]
    e[:, 2], e[:, 3], e[:, 4] = mass * s[:, r.psi_pos], mass, elig
    return e


@pytest.mark.parametrize("perturb", [False, True])
def test_eigen_pool_matches_pallas(panel, perturb):
    """The plain pooling against the Pallas kernel in interpret mode on 40
    chunks of the first panel (their candidates drawn from the whole
    state), and the wrapper's CPU route on the whole state: the same mask,
    sums of non-negative terms in other orders within 2e-6 relative."""
    jb, _, jpipe, jstate, tpipe, tstate = panel
    e = _eigen_rows(_jnp(jstate.slots), _jnp(jstate.ints), perturb)
    cand_t, _ = tpipe._eigen_candidates(tstate.structure)
    g = TK.eigen_candidate_rows(torch.from_numpy(e), cand_t)
    elig = e[:, 4].sum(axis=1)
    c0 = int(np.argmax(elig > 32)) + 8  # inside the first panel
    sub = slice(c0, c0 + 40)
    out_j = np.asarray(JK.eigen_pool_fused(jb.grid, jpipe._cfg, jnp.asarray(e[sub]),
                                           jnp.asarray(g[sub].numpy()), interpret=True))
    out_t = TK.eigen_pool_fused_reference(jb.grid, torch.from_numpy(e[sub]), g[sub]).numpy()
    np.testing.assert_array_equal(out_t != 0, out_j != 0)
    np.testing.assert_allclose(out_t, out_j, rtol=2e-6, atol=0)
    assert not out_t[:, 2:].any() and (out_t[:, 1] > 0).mean() > (0.4 if perturb else 0.9)
    full = TK.eigen_pool_fused(jb.grid, jpipe._cfg, torch.from_numpy(e), cand_t).numpy()
    assert full.shape == (e.shape[0], 2, 64)
    np.testing.assert_array_equal(full[sub], out_t[:, :2])


# ---------------------------------------------------------------------------
# The small scene: kernels A and B, two substeps against JAX fused
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------


def test_l_panel2_three_substeps_match_jax_dense(panel):
    """Full l_panel2 (60,000 particles), three substeps through the port's
    fused pipeline on the CPU against the JAX dense pipeline with
    stop_after_one_substep (as tests/test_damage.py runs it), with
    test_fused's tolerances; no trip in either."""
    jb, tb, *_ = panel
    params = jb.params.__class__(dt=jb.params.dt, boundary_handling=jb.params.boundary_handling,
                                 damage_model=jb.params.damage_model, stop_after_one_substep=True)
    dpipe = JDense(jb.grid, jb.models, jb.colliders, params, jb.gravity, jb.hooks)
    tpipe = FusedMpmPipeline(tb.grid, tb.models, tb.colliders,
                             replace(tb.params, stop_after_one_substep=True), tb.gravity,
                             tb.hooks, device="cpu")
    pj, pt = jb.particles, tb.particles
    state = tpipe.pack_state(pt)
    for _ in range(3):
        pj, nj = dpipe.step_with_stats(pj)
        state, nt = tpipe.run_frames_state(state, 1)
        assert int(nj) == nt == 1
    pt = tpipe.unpack_state(state)
    _compare(pj, pt)
    act = _jnp(pj.active)
    assert np.abs(_jnp(pj.velocity)[act]).max() > 0.05  # the loading moved the panels
    np.testing.assert_array_equal(pt.phase.numpy(), _jnp(pj.phase))
