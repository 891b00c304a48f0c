"""The port's fused sand3 slice end to end on the CPU (plain kernel
versions): one frame against the JAX FusedMpmPipeline in interpret mode,
a 4-frame replay of the sand3 golden, a state-resident run through the
first lazy resort, and the constructor's refusals and acceptances.
"""

import json
import os

import numpy as np
import pytest
import torch

import sparkl_tpu.scenes as jscenes
from sparkl_tpu.fused.pipeline import FusedMpmPipeline as JPipeline
from sparkl_tpu.sparse.blocks import BlockConfig as JBlockConfig

import sparkl_tpu_torch as tsk
import sparkl_tpu_torch.scenes as tscenes
from sparkl_tpu_torch import interop
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.core.params import DamageModel, SolverParameters
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
from sparkl_tpu_torch.geometry.colliders import heightfield
from sparkl_tpu_torch.models import registry as treg
from sparkl_tpu_torch.sparse.blocks import BlockConfig

torch.set_num_threads(2)

CFG = dict(max_blocks=64, max_chunks=32, chunk_size=128, max_grid_blocks=128)
GOLD = json.load(open(os.path.join(os.path.dirname(__file__), "golden_scenes.json")))


def _port_of(b):
    """The JAX scene bundle carried across to the port through numpy."""
    m = b.models
    models = interop.modelset_from_numpy(m.ctype, m.cparams, m.ptype, m.pparams,
                                         m.ftype, m.fparams, device="cpu")
    colliders = tuple(
        heightfield(c.data[0], c.data[1], translation=c.translation, rotation=c.rotation,
                    friction=c.friction)
        for c in b.colliders
    )
    grid = GridParams(origin=b.grid.origin, cell_width=b.grid.cell_width, res=b.grid.res)
    particles = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in vars(b.particles).items()}, device="cpu")
    return grid, models, colliders, particles


def test_one_frame_matches_jax_fused_pipeline():
    b = jscenes.build("sand3", nx=12, ny=6, nz=6)
    jpipe = JPipeline(b.grid, b.models, b.colliders, b.params, b.gravity,
                      config=JBlockConfig(**CFG), use_pallas="interpret")
    pj, nj = jpipe.step_with_stats(b.particles)

    grid, models, colliders, particles = _port_of(b)
    tpipe = FusedMpmPipeline(grid, models, colliders, SolverParameters(dt=b.params.dt),
                             b.gravity, config=BlockConfig(**CFG), device="cpu")
    pt, nt = tpipe.step_with_stats(particles)
    assert nt == int(nj)

    # The tolerances of tests/test_fused.py::_compare (fused vs dense).
    act = np.asarray(pj.active)
    np.testing.assert_array_equal(pt.active.numpy(), act)
    np.testing.assert_allclose(pt.position.numpy()[act], np.asarray(pj.position)[act], atol=5e-5)
    np.testing.assert_allclose(pt.velocity.numpy()[act], np.asarray(pj.velocity)[act], atol=5e-4)
    np.testing.assert_allclose(pt.deformation_gradient.numpy()[act],
                               np.asarray(pj.deformation_gradient)[act], atol=5e-4)
    np.testing.assert_array_equal(pt.failed.numpy()[act], np.asarray(pj.failed)[act])
    assert np.abs(pt.velocity.numpy()[act]).max() > 0.1  # the column is falling


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
    the bounds of tests/test_regression.py::_replay for fused pipelines."""
    gold = GOLD["sand3"]
    b = tscenes.build("sand3", device="cpu", **gold["config"])
    pipe = FusedMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity, device="cpu")
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


def test_state_resident_run_takes_the_lazy_resort():
    b = tscenes.build("sand3", nx=12, ny=6, nz=6, device="cpu")
    pipe = FusedMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity,
                            config=BlockConfig(**CFG), device="cpu")
    state = pipe.pack_state(b.particles)
    mass0 = float(b.particles.mass.sum())
    resorts = substeps = 0
    for _ in range(13):
        state, n = pipe.run_frames_state(state, 1)
        substeps += n
        resorts += pipe.last_resorts
    assert resorts >= 1 and substeps >= 13 * 5
    # The fall mixes particles across blocks: the resort takes the permute.
    assert sum(pipe.resort_branches.values()) == resorts and pipe.resort_branches["mixed"] >= 1
    p = pipe.unpack_state(state)
    assert torch.isfinite(p.position).all()
    np.testing.assert_allclose(float(p.mass[p.active].sum()), mass0, rtol=1e-6)


def test_constructor_refuses_what_the_slice_does_not_carry():
    b = tscenes.build("sand3", nx=4, ny=2, nz=2, device="cpu")
    base = dict(grid=b.grid, models=b.models, colliders=b.colliders, params=b.params,
                device="cpu")
    neo = treg.ModelSet.pack([treg.ParticleModel((1, (1.0, 1.0, 0.5, 0.0)))], "cpu")

    other_failure = treg.ModelSet.from_tables([0], [[1.0, 1.0, 0.5, 0.0]], [0], np.zeros((1, 8)),
                                              [2], [[1.0, 1.0]], "cpu")  # not maximum stress

    # 3D: CD-MPM, other models and failure types stay refused, as do the
    # options no path carries.
    cases = [
        dict(models=neo),
        dict(models=other_failure),
        dict(params=SolverParameters(damage_model=DamageModel.CD_MPM)),
        dict(params=SolverParameters(enable_boundary_particle_projection=True)),
        dict(params=SolverParameters(gpu_boundary_semantics=True)),
        dict(colliders=(heightfield(np.zeros((3, 3)), (1.0, 1.0, 1.0), penalty_stiffness=1.0),)),
        dict(collider_pose_fn=lambda t: (None,)),
    ]
    for over in cases:
        with pytest.raises(NotImplementedError):
            FusedMpmPipeline(**dict(base, **over))
    # 3D damage and failure are carried (the stress cache off): eigenerosion,
    # modified eigenerosion and maximum-stress failure.
    max_stress = treg.ModelSet.from_tables([0], [[1.0, 1.0, 0.5, 0.0]], [0], np.zeros((1, 8)),
                                           [1], [[1.0, 1.0]], "cpu")
    for over in (dict(params=SolverParameters(damage_model=DamageModel.EIGENEROSION)),
                 dict(models=max_stress),
                 dict(params=SolverParameters(damage_model=DamageModel.MODIFIED_EIGENEROSION))):
        assert not FusedMpmPipeline(**dict(base, **over))._meta["stress_cache"]
    # Fluids are carried: EOS models and fluid volume recomputation (the
    # sparse pipeline still refuses both, tests/test_torch_sparse.py).
    fluid = treg.ModelSet.pack([treg.ParticleModel(treg.monaghan_sph_eos(1e6, 7, 1e-3))], "cpu")
    FusedMpmPipeline(**dict(base, models=fluid,
                            params=SolverParameters(force_fluids_volume_recomputation=True)))

    # 2D: l_panel2's configuration is carried (eigenerosion, maximum-stress
    # failure, the cuboid ground under STICK, the Dirichlet hook), through
    # the constructor and auto_pipeline, and so are 2D solids without damage
    # or failure (the stress cache on), the 2D heightfield (elasticity2,
    # basic2), 2D fluids with the volume pass (fluids2) and modified
    # eigenerosion; CD-MPM, another failure type and a 3D heightfield in a
    # 2D grid are refused.
    lp = tscenes.build("l_panel2", cell_width=0.02, device="cpu")
    base2 = dict(grid=lp.grid, models=lp.models, colliders=lp.colliders, params=lp.params,
                 gravity=lp.gravity, hooks=lp.hooks, device="cpu")
    assert FusedMpmPipeline(**base2).hooks is lp.hooks
    assert tsk.auto_pipeline(lp, device="cpu").hooks is lp.hooks
    FusedMpmPipeline(**dict(base2, models=treg.ModelSet.pack([treg.ParticleModel(
        treg.corotated_linear_elasticity(1e7, 0.2))], "cpu"), params=SolverParameters()))
    for name, kw in (("elasticity2", {}), ("basic2", {}), ("fluids2", dict(n=40))):
        assert isinstance(tsk.auto_pipeline(tscenes.build(name, device="cpu", **kw),
                                            device="cpu"), FusedMpmPipeline)
    FusedMpmPipeline(**dict(base2, params=SolverParameters(
        damage_model=DamageModel.MODIFIED_EIGENEROSION)))
    cases2 = [
        dict(params=SolverParameters(damage_model=DamageModel.CD_MPM)),
        dict(models=other_failure),
        dict(colliders=(heightfield(np.zeros((3, 3)), (1.0, 1.0, 1.0)),)),
    ]
    for over in cases2:
        with pytest.raises(NotImplementedError):
            FusedMpmPipeline(**dict(base2, **over))
