"""The port's block-sparse pipeline on the 2D scenes (and the 3D forms the
same slice opens) on the CPU against the JAX package, as whole substeps: a
few substeps of the port's SparseMpmPipeline against the JAX
SparseMpmPipeline's XLA path (elasticity2, basic2, fluids2(n=40), a small
two-panel l_panel2, a reduced fluids3 blob with the volume pass, a reduced
l_panel3 under modified eigenerosion); the eigenerosion buckets' regrow;
and the first two frames of the elasticity2 golden.
(test_torch_sparse2d.py holds the 2D window transfers, the neighbour sums,
eigenerosion and the particle update's branches.)

Every port call passes device="cpu". The JAX sparse pipeline runs its XLA
path (use_pallas=False), which tests/test_sparse.py holds bit for bit to
the interpret-mode kernels, so no JAX pipeline runs in interpret mode. Each
comparison states its tolerance.
"""

import json
import os
from dataclasses import fields, replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparkl_tpu.scenes as jscenes
from sparkl_tpu.core.params import SolverParameters as JParams
from sparkl_tpu.sparse import blocks as JB
from sparkl_tpu.sparse.pipeline import SparseMpmPipeline as JSparse

import chip_smoke
import sparkl_tpu_torch.scenes as tscenes
from sparkl_tpu_torch import interop
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.core.params import (
    BoundaryHandling,
    DamageModel,
    SimulationDofs,
    SolverParameters,
)
from sparkl_tpu_torch.ops import transfer_kernels as TK
from sparkl_tpu_torch.solver import dense as tdense
from sparkl_tpu_torch.sparse import blocks as TB
from sparkl_tpu_torch.sparse.pipeline import SparseMpmPipeline

from test_torch_fluids import _blob
from test_torch_fracture2d_fused import _port_models, _port_particles, _small_scene
from test_torch_fracture3d import jax_l_panel3
from test_torch_sparse2d import _np

torch.set_num_threads(1)


def _port_params(p):
    kw = {f.name: getattr(p, f.name) for f in fields(p)}
    kw.update(boundary_handling=BoundaryHandling(int(p.boundary_handling)),
              damage_model=DamageModel(int(p.damage_model)),
              simulation_dofs=SimulationDofs(int(p.simulation_dofs)))
    return SolverParameters(**kw)

GOLD = json.load(open(os.path.join(os.path.dirname(__file__), "golden_scenes.json")))


def _port_pipeline(grid, models, colliders, params, gravity, hooks, cfg):
    """A JAX configuration carried across: the port's SparseMpmPipeline on
    the CPU with the same BlockConfig."""
    tc = tuple(interop.collider_from_numpy(c.shape_type, c.data, c.translation, c.rotation,
                                           c.friction) for c in colliders)
    th = None if hooks is None else interop.dirichlet_hook_from_numpy(hooks.points,
                                                                      hooks.velocities)
    return SparseMpmPipeline(GridParams(grid.origin, grid.cell_width, grid.res),
                             _port_models(models), tc, _port_params(params), gravity, th,
                             config=TB.BlockConfig(**vars(cfg)), device="cpu")


def _case(name):
    """(JAX grid, models, colliders, particles, params, gravity, hooks,
    substeps) of one comparison. Fluids run at a pinned dt: the EOS dt
    bound turns on the last bits of J near 1, where the two packages round
    the volume pass and the pressure differently (ROADMAP hazard "The EOS
    bound's last bit"), so their trajectories are compared at the same
    dts."""
    if name in ("elasticity2", "basic2", "fluids2"):
        b = jscenes.build(name, **({"n": 40} if name == "fluids2" else {}))
        params = replace(b.params, stop_after_one_substep=True)
        if name == "fluids2":
            params = replace(params, max_substep_dt=2.0e-3)
        return b.grid, b.models, b.colliders, b.particles, params, b.gravity, b.hooks, 3
    if name == "l_panel2":
        grid, models, colliders, p, params, gravity, hook = _small_scene()
        return grid, models, colliders, p, params, gravity, hook, 3
    if name == "fluids3":
        grid, jm, jp = _blob(False)
        params = JParams(dt=1.0 / 60.0, max_substep_dt=1.0e-3, stop_after_one_substep=True,
                         force_fluids_volume_recomputation=True)
        return grid, jm, (), jp, params, None, None, 2
    grid, models, colliders, p, params, gravity, hooks = jax_l_panel3(
        "modified", scale=chip_smoke.LPANEL3_SMALL, layers=chip_smoke.LPANEL3_SMALL_LAYERS)
    return grid, models, colliders, p, replace(params, stop_after_one_substep=True), gravity, \
        hooks, 2


@pytest.mark.parametrize("name", ["elasticity2", "basic2", "fluids2", "l_panel2", "fluids3",
                                  "l_panel3-modified"])
def test_sparse_substeps_match_jax(name, monkeypatch):
    """A few substeps (each from the JAX particles of the one before)
    through the port's SparseMpmPipeline on the CPU against the JAX
    SparseMpmPipeline's XLA path with the same BlockConfig: positions to
    5e-5, velocities and F to 5e-4 (tests/test_fused.py's tolerances),
    active and failed equal, phase equal but on lanes whose trip decision
    lies within TIE of its threshold (counted, at most two a substep); the
    window kernels' plain versions are the path (no launch here). Covers
    2D (no psi: elasticity2, basic2, fluids2 with the volume pass; psi:
    l_panel2's two panels with eigenerosion, maximum stress, a STICK cuboid
    and the hook) and 3D (the fluids3 blob with the volume pass, l_panel3
    under modified eigenerosion)."""
    grid, models, colliders, p, params, gravity, hooks, nsub = _case(name)
    cfg = JB.BlockConfig.calibrate(grid, _np(p.position), _np(p.active), slack=1.4)
    jpipe = JSparse(grid, models, colliders, params, gravity, hooks, config=cfg,
                    use_pallas=False, group_size=16 if grid.dim == 3 else 256)
    tpipe = _port_pipeline(grid, models, colliders, params, gravity, hooks, cfg)
    gathered = {}
    update = tdense.particle_update_after_gather

    def record(grid_, p_, models_, dt, velocity, vgrad, det, psi, **kw):
        gathered["psi"] = psi
        return update(grid_, p_, models_, dt, velocity, vgrad, det, psi, **kw)

    monkeypatch.setattr(tdense, "particle_update_after_gather", record)
    TK.reset_launch_counts()
    pj = p
    for step in range(nsub):
        pj2, nj = jpipe.step_with_stats(pj)
        pin = _port_particles(pj)
        pt, nt = tpipe.step_with_stats(pin)
        assert int(nj) == nt == 1
        act = _np(pj2.active)
        np.testing.assert_array_equal(pt.active.numpy(), act)
        for k, tol in (("position", 5e-5), ("velocity", 5e-4), ("deformation_gradient", 5e-4)):
            np.testing.assert_allclose(getattr(pt, k).numpy()[act], _np(getattr(pj2, k))[act],
                                       rtol=0, atol=tol, err_msg=f"{name} substep {step} {k}")
        np.testing.assert_array_equal(pt.failed.numpy()[act], _np(pj2.failed)[act])
        differ = act & (pt.phase.numpy() != _np(pj2.phase))
        if differ.any():  # the ties only matter where the phases differ
            ties = chip_smoke.sparse_trip_ties(tpipe, pin, pt, gathered["psi"]).numpy()
            assert not (differ & ~ties).any() and int(differ.sum()) <= 2, (name, step)
        pj = pj2
    assert TK.LAUNCHES == {"p2g_windows": 0, "g2p_windows": 0}
    act = _np(pj.active)
    assert np.abs(_np(pj.velocity)[act]).max() > 1e-3  # something moved
    if name in ("fluids2", "fluids3"):
        j = _np(pj.deformation_gradient)[act, 0, 0]
        assert np.abs(j - 1.0).max() > 1e-3  # the volume pass set J
    if name == "l_panel2":
        # Both mechanisms tripped: maximum stress on panel 2, eigenerosion on panel 1.
        mid, ph = _np(pj.model_id), _np(pj.phase)
        assert (ph[mid == 1] == 0).any() and (ph[mid == 0] == 0).any()


def test_eigen_bucket_overflow_regrows_and_retries():
    """The small two-panel scene with eigenerosion's bucket depth cut to 1
    (4 particles a cell): the first substep overflows, the pipeline doubles
    the depth until the cells fit (1 -> 2 -> 4) and retries the frame, and
    the result is bit-equal to a run that had the depth from the start."""
    grid, models, colliders, p, params, gravity, hook = _small_scene()
    cfg = JB.BlockConfig.calibrate(grid, _np(p.position), _np(p.active), slack=1.4)
    ref = _port_pipeline(grid, models, colliders, params, gravity, hook, cfg)
    cut = _port_pipeline(grid, models, colliders, params, gravity, hook, cfg)
    cut._eigen_k = 1
    pr = ref.step(_port_particles(p))
    pc = cut.step(_port_particles(p))
    assert cut.eigen_regrows == 2 and cut._eigen_k == 4 and ref.eigen_regrows == 0
    for f in fields(pr):
        assert torch.equal(getattr(pc, f.name), getattr(pr, f.name)), f.name


def test_golden_elasticity2_first_frames():
    """Frames 0-1 of tests/golden_scenes.json's elasticity2 (made by the JAX
    dense pipeline) through auto_pipeline(prefer="sparse") on the CPU, with
    tests/test_regression.py::_replay's bounds for non-dense pipelines;
    the card runs all 6 frames (chip_smoke.py)."""
    import sparkl_tpu_torch as tsk

    gold = GOLD["elasticity2"]
    b = tscenes.build("elasticity2", device="cpu", **gold["config"])
    pipe = tsk.auto_pipeline(b, prefer="sparse", device="cpu")
    assert isinstance(pipe, SparseMpmPipeline)
    p = b.particles
    act0 = p.active.numpy()
    per_mass = p.mass.numpy()
    mass0 = float(per_mass[act0].sum())
    for rec in gold["frames"][:2]:
        p, niter = pipe.step_with_stats(p)
        assert abs(int(niter) - rec["substeps"]) <= 1, rec["frame"]
        act = p.active.numpy()
        pos, vel = p.position.numpy()[act], p.velocity.numpy()[act]
        deact = float(per_mass[act0 & ~act].sum())
        np.testing.assert_allclose(float(p.mass.numpy()[act].sum()), mass0 - deact, rtol=1e-6)
        np.testing.assert_allclose(pos.mean(0), rec["com"], atol=3e-3, rtol=1e-3)
        np.testing.assert_allclose(pos.min(0), rec["pos_min"], atol=8e-3, rtol=1e-3)
        np.testing.assert_allclose(pos.max(0), rec["pos_max"], atol=8e-3, rtol=1e-3)
        ke = float(0.5 * np.sum(p.mass.numpy()[act][:, None] * vel**2))
        np.testing.assert_allclose(ke, rec["ke"], rtol=3e-2, atol=1e-8)
        slack = max(2, int(0.02 * int(act0.sum())))
        assert abs(int(p.failed.numpy()[act].sum()) - rec["failed"]) <= slack
        assert abs(int((p.phase.numpy()[act] == 0.0).sum()) - rec["broken"]) <= slack
