"""The port's block-sparse pipeline (sparse sand3) on the CPU beyond its
kernels: the matrix forms of the transfer against the JAX package's,
the golden's first four sand3 frames, what the constructor refuses,
auto_pipeline's routes and the entry points' CUDA default.
(test_torch_sparse.py holds the structure, the window transfers and one
frame against the JAX sparse pipeline.)
"""

import inspect
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparkl_tpu.math import linalg as jlinalg
from sparkl_tpu.models import registry as jreg

import sparkl_tpu_torch as tsk
import sparkl_tpu_torch.scenes as tscenes
from sparkl_tpu_torch import interop
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.core.params import DamageModel, SolverParameters
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
from sparkl_tpu_torch.geometry.colliders import heightfield
from sparkl_tpu_torch.math import linalg as tlinalg
from sparkl_tpu_torch.math import svd as tsvd
from sparkl_tpu_torch.models import registry as treg
from sparkl_tpu_torch.scenes import scenes3d
from sparkl_tpu_torch.solver.pipeline import MpmHooks
from sparkl_tpu_torch.sparse import blocks as TB
from sparkl_tpu_torch.sparse.pipeline import SparseMpmPipeline

torch.set_num_threads(1)

CFG12 = dict(max_blocks=32, max_chunks=32, chunk_size=128, max_grid_blocks=64)
GOLD = json.load(open(os.path.join(os.path.dirname(__file__), "golden_scenes.json")))


@pytest.mark.parametrize("name", ["svd", "det", "model_tables"])
def test_matrix_forms_match_jax(name):
    """The [..., 3, 3] forms and model queries of the sparse path, against
    the JAX package's on numpy-seeded F near the Drucker-Prager cone. The
    matrix-form return map and pos energy run in
    test_particle_update_matches_jax."""
    rng = np.random.default_rng(31)
    n = 256
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    s_ = rng.uniform(0.97, 1.02, size=(n, 3))
    f = (q * s_[:, None, :] @ np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]).astype(np.float32)
    fj, ft = jnp.asarray(f), torch.from_numpy(f)
    if name == "svd":
        # The wrapper only stacks svd3x3_c, which test_torch_math_models.py
        # holds to the JAX package; here, against numpy's singular values.
        ut, st, vt = tsvd.svd(ft)
        np.testing.assert_allclose(np.sort(st.numpy(), axis=1),
                                   np.sort(np.linalg.svd(f, compute_uv=False), axis=1), atol=2e-5)
        rebuilt = ut * st[:, None, :] @ vt.transpose(1, 2)
        np.testing.assert_allclose(rebuilt.numpy(), f, atol=2e-5)
        # 2x2 dispatches to the closed form (held to the JAX package in
        # test_torch_fracture2d.py); other sizes are refused.
        f2 = torch.from_numpy(f[:, :2, :2].copy())
        u2, s2, v2 = tsvd.svd(f2)
        np.testing.assert_allclose((u2 * s2[:, None, :] @ v2.transpose(1, 2)).numpy(),
                                   f2.numpy(), atol=2e-5)
        with pytest.raises(NotImplementedError):
            tsvd.svd(torch.eye(4)[None])
    elif name == "det":
        np.testing.assert_allclose(tlinalg.det(ft).numpy(), np.asarray(jlinalg.det(fj)), rtol=1e-6)
    else:
        # Per-particle model queries on a table with a fluid among solids:
        # is_fluid reads the table, pos_energy is the corotated energy and 0
        # for fluids (f32 rounding of the singular values: rtol 1e-5 of the
        # largest energy), apply_failure trips maximum stress as the JAX
        # package does (F stands in for the stress, thresholds inside its
        # range), and a model set with another failure type is refused.
        models = [jreg.ParticleModel(jreg.corotated_linear_elasticity(1.0e7, 0.2)),
                  jreg.ParticleModel(jreg.monaghan_sph_eos(1.0e5, 7, 0.1))]
        jm = jreg.ModelSet.pack(models)
        tm = treg.ModelSet.pack([treg.ParticleModel(m.constitutive) for m in models], "cpu")
        ids = rng.integers(0, 2, n).astype(np.int32)
        np.testing.assert_array_equal(tm.is_fluid(torch.from_numpy(ids)).numpy(),
                                      np.asarray(jm.is_fluid(jnp.asarray(ids))))
        phase = torch.ones(n)
        e_t = treg.pos_energy(tm, torch.from_numpy(ids), phase, phase, ft).numpy()
        e_j = np.asarray(jreg.pos_energy(jm, jnp.asarray(ids), jnp.ones(n), jnp.ones(n), fj))
        np.testing.assert_allclose(e_t, e_j, rtol=1e-5, atol=1e-5 * np.abs(e_j).max())
        assert not e_t[ids == 1].any() and e_t[ids == 0].max() > 0
        elastic = jreg.corotated_linear_elasticity(1.0e7, 0.2)
        jfailing = jreg.ModelSet.pack(
            [jreg.ParticleModel(elastic, failure=jreg.maximum_stress_failure(1.0, 0.8))])
        failing = treg.ModelSet.pack(
            [treg.ParticleModel(elastic, failure=treg.maximum_stress_failure(1.0, 0.8))], "cpu")
        zeros = torch.zeros(n, dtype=torch.int32)
        ph_t = treg.apply_failure(failing, zeros, phase, ft).numpy()
        ph_j = np.asarray(jreg.apply_failure(jfailing, jnp.zeros(n, jnp.int32), jnp.ones(n), fj))
        np.testing.assert_array_equal(ph_t, ph_j)
        assert 0 < (ph_t == 0.0).sum() < n
        other = treg.ModelSet.from_tables([0], [[1.0, 1.0, 0.5, 0.0]], [0], np.zeros((1, 8)),
                                          [2], [[1.0, 1.0]], "cpu")
        with pytest.raises(NotImplementedError):
            treg.apply_failure(other, zeros, phase, ft)
        solid = treg.ModelSet.pack(models[:1], "cpu")
        assert torch.equal(treg.apply_failure(solid, zeros, phase, ft), phase)


def _stats(p):
    act = p.active.numpy()
    pos = p.position.numpy()[act]
    vel = p.velocity.numpy()[act]
    mass = p.mass.numpy()[act]
    ke = float(0.5 * np.sum(mass[:, None] * vel**2))
    failed = int(p.failed.numpy()[act].sum())
    broken = int((p.phase.numpy()[act] == 0.0).sum())
    return pos.mean(axis=0), pos.min(axis=0), pos.max(axis=0), ke, failed, broken, float(mass.sum())


def test_golden_sand3_four_frames():
    """Replays tests/golden_scenes.json (made by the JAX dense pipeline) with
    the bounds of tests/test_regression.py::_replay for non-dense pipelines."""
    gold = GOLD["sand3"]
    b = tscenes.build("sand3", device="cpu", **gold["config"])
    pipe = SparseMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity,
                             config=TB.BlockConfig(**CFG12), device="cpu")
    p = b.particles
    act0 = p.active.numpy()
    per_mass = p.mass.numpy()
    mass0 = float(per_mass[act0].sum())
    n0 = int(act0.sum())
    for rec in gold["frames"][:4]:
        p, niter = pipe.step_with_stats(p)
        frame = rec["frame"]
        assert abs(int(niter) - rec["substeps"]) <= 1, f"frame {frame} substeps"
        com, lo, hi, ke, failed, broken, mass = _stats(p)
        deact = float(per_mass[act0 & ~p.active.numpy()].sum())
        np.testing.assert_allclose(mass, mass0 - deact, rtol=1e-6, err_msg=f"{frame} mass")
        np.testing.assert_allclose(com, rec["com"], atol=3e-3, rtol=1e-3, err_msg=f"{frame} com")
        np.testing.assert_allclose(lo, rec["pos_min"], atol=8e-3, rtol=1e-3, err_msg=f"{frame} min")
        np.testing.assert_allclose(hi, rec["pos_max"], atol=8e-3, rtol=1e-3, err_msg=f"{frame} max")
        np.testing.assert_allclose(ke, rec["ke"], rtol=3e-2, atol=1e-8, err_msg=f"{frame} ke")
        slack = max(2, int(0.02 * n0))
        assert abs(failed - rec["failed"]) <= slack
        assert abs(broken - rec["broken"]) <= slack


def test_constructor_refuses_what_the_port_does_not_carry():
    """What the sparse pipeline carries since the 2D slice (2D grids,
    neo-Hookean, eigenerosion, fluids and the volume pass, grid hooks) it
    constructs; what it does not (CD-MPM, boundary particle projection, GPU
    boundary semantics, penalty colliders, other collider shapes, runtime
    poses) it refuses, with no fallback."""
    b = tscenes.build("sand3", nx=4, ny=2, nz=2, device="cpu")
    base = dict(grid=b.grid, models=b.models, colliders=b.colliders, params=b.params,
                device="cpu")
    grid2 = GridParams(origin=(0.0, 0.0), cell_width=0.1, res=(32, 32))
    neo = treg.ModelSet.pack([treg.ParticleModel((1, (1.0, 1.0, 0.5, 0.0)))], "cpu")
    carried = [
        dict(grid=grid2, colliders=()),
        dict(models=neo),
        dict(params=SolverParameters(damage_model=DamageModel.EIGENEROSION)),
        dict(params=SolverParameters(damage_model=DamageModel.MODIFIED_EIGENEROSION)),
        dict(params=SolverParameters(force_fluids_volume_recomputation=True)),
        dict(models=treg.ModelSet.pack([treg.ParticleModel(treg.monaghan_sph_eos(1e6, 7, 1e-3))],
                                       "cpu")),
        dict(hooks=MpmHooks()),
    ]
    for over in carried:
        SparseMpmPipeline(**dict(base, **over))
    cases = [
        dict(params=SolverParameters(damage_model=DamageModel.CD_MPM)),
        dict(params=SolverParameters(enable_boundary_particle_projection=True)),
        dict(params=SolverParameters(gpu_boundary_semantics=True)),
        dict(colliders=(heightfield(np.zeros((3, 3)), (1.0, 1.0, 1.0), penalty_stiffness=1.0),)),
        dict(grid=grid2),  # a 3D heightfield in a 2D grid
    ]
    for over in cases:
        with pytest.raises(NotImplementedError):
            SparseMpmPipeline(**dict(base, **over))
    pipe = SparseMpmPipeline(**base)
    with pytest.raises(NotImplementedError):
        pipe.step_with_stats(b.particles, poses=(None,))


def test_auto_pipeline_routes():
    b = tscenes.build("sand3", nx=4, ny=2, nz=2, device="cpu")
    assert isinstance(tsk.auto_pipeline(b, prefer="sparse", device="cpu"), SparseMpmPipeline)
    for prefer in ("auto", "fused"):
        assert isinstance(tsk.auto_pipeline(b, prefer=prefer, device="cpu"), FusedMpmPipeline)
    with pytest.raises(NotImplementedError):
        tsk.auto_pipeline(b, prefer="dense", device="cpu")
    with pytest.raises(ValueError):
        tsk.auto_pipeline(b, prefer="fastest", device="cpu")


def test_entry_points_default_to_cuda():
    """Every entry point that takes a device defaults to the card (read from
    the signatures: nothing is built on CUDA here); without a CUDA device the
    default raises a clear error instead of running on the CPU."""
    entry_points = [
        FusedMpmPipeline.__init__, SparseMpmPipeline.__init__, tsk.auto_pipeline,
        tscenes.build, scenes3d.sand3, interop.particles_from_numpy,
        interop.modelset_from_numpy, interop.slot_state_from_numpy,
    ]
    for fn in entry_points:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tscenes.build("sand3", nx=2, ny=1, nz=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            interop.particles_from_numpy({})
