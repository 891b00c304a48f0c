"""The port's last two 3D reference scenes, cube_through_sand3 (a kinematic
block driven through sand) and sand_penetration3 (sand dropped through
four heightfields, three of them rotated), on the CPU against the JAX
package: the builds at the published size and the golden's, both JAX
bundles carried across by interop, the packs, and substeps of each scene
against the JAX fused pipeline in interpret mode.
(test_torch_scenes3d_paths.py holds the rotated fields' projections, one
grid update on the four cached projections, and the goldens' first
frames on the port's fused and sparse paths.)

The reduced scenes are the goldens' (nx=12, ny=6, nz=6,
tests/make_goldens.py): cube_through_sand3 432 sand particles and the
15,625 of the block, whose size the scene fixes; sand_penetration3 432.
The JAX kernels run in interpret mode, the port's through their plain
versions. Each comparison states its tolerance.
"""

import json
import os
from dataclasses import fields, replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import sparkl_tpu.scenes as jscenes
from sparkl_tpu.fused.pipeline import FusedMpmPipeline as JPipeline
from sparkl_tpu.sparse.blocks import BlockConfig as JBlockConfig

import sparkl_tpu_torch.scenes as tscenes
from sparkl_tpu_torch import interop
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.core.params import SolverParameters
from sparkl_tpu_torch.fused import layout as TL
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
from sparkl_tpu_torch.fused.structure import SlotStructure
from sparkl_tpu_torch.sparse.blocks import BlockConfig

torch.set_num_threads(1)

GOLD = json.load(open(os.path.join(os.path.dirname(__file__), "golden_scenes.json")))
SCENES = ("cube_through_sand3", "sand_penetration3")
R3 = TL.Rows(3)
# Capacities of the reduced scenes' runs (against the JAX fused pipeline,
# and the goldens'): cube_through_sand3 packs 155 chunks in 72 blocks of
# 152 grid blocks (the block's 15,625 particles and the bed),
# sand_penetration3 6 chunks in 4 blocks of 18. The calibrated tables hold
# 512 chunks, which the interpret-mode kernels would all walk.
CFG = {"cube_through_sand3": dict(max_blocks=96, max_chunks=192, chunk_size=128,
                                  max_grid_blocks=192),
       "sand_penetration3": dict(max_blocks=16, max_chunks=16, chunk_size=128,
                                 max_grid_blocks=32)}
# Substeps of each scene against the JAX fused pipeline, one a frame.
SUBSTEPS = 3


def _np(x):
    return np.asarray(x)


def _port_particles(p):
    return interop.particles_from_numpy({f.name: _np(getattr(p, f.name)) for f in fields(p)},
                                        device="cpu")


def _state_to_port(js, pipe):
    arrays = {f.name: _np(getattr(js.structure, f.name)) for f in fields(SlotStructure)}
    arrays.update(slots=_np(js.slots), ints=_np(js.ints), cum_disp=_np(js.cum_disp))
    return interop.slot_state_from_numpy(arrays, cache_fn=pipe._grid_cache, device="cpu")


def _jax_reduced(name):
    return jscenes.build(name, **GOLD[name]["config"])


@pytest.fixture(scope="module", params=SCENES)
def reduced(request):
    """One scene at the golden's size from both packages; both fused
    pipelines (the JAX one in interpret mode, one substep a frame, CFG) and
    both packs; and SUBSTEPS substeps of the JAX pipeline, each from the
    JAX state of the one before, run once for every test that reads them."""
    name = request.param
    jb = _jax_reduced(name)
    tb = tscenes.build(name, device="cpu", **GOLD[name]["config"])
    params = replace(jb.params, stop_after_one_substep=True)
    jpipe = JPipeline(jb.grid, jb.models, jb.colliders, params, jb.gravity,
                      config=JBlockConfig(**CFG[name]), donate=False, use_pallas="interpret")
    tpipe = FusedMpmPipeline(tb.grid, tb.models, tb.colliders,
                             SolverParameters(dt=tb.params.dt, stop_after_one_substep=True),
                             tb.gravity, config=BlockConfig(**CFG[name]), device="cpu")
    js = jpipe.pack_state(jb.particles)
    states, counts, resorts = [js], [], []
    for _ in range(SUBSTEPS):
        nxt, n = jpipe.run_frames_state(states[-1], 1)
        states.append(nxt)
        counts.append(n)
        resorts.append(jpipe.last_resorts)
    return SimpleNamespace(name=name, jb=jb, tb=tb, jpipe=jpipe, tpipe=tpipe, js=js,
                           jstates=states, jcounts=counts, jresorts=resorts)


# ---------------------------------------------------------------------------
# The builds, interop and the packs
# ---------------------------------------------------------------------------


def _port_bundle(jb):
    """A JAX scene bundle carried across to the port by interop, field by
    field: particles, model tables, colliders (with their poses), grid."""
    m = jb.models
    colliders = tuple(
        interop.collider_from_numpy(c.shape_type, c.data, c.translation, c.rotation,
                                    c.friction, c.penalty_stiffness, c.boundary_handling,
                                    c.flip_interior)
        for c in jb.colliders)
    return SimpleNamespace(
        grid=GridParams(jb.grid.origin, jb.grid.cell_width, jb.grid.res),
        models=interop.modelset_from_numpy(m.ctype, m.cparams, m.ptype, m.pparams, m.ftype,
                                           m.fparams, device="cpu"),
        colliders=colliders, particles=_port_particles(jb.particles))


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("name", SCENES)
def test_builds_bit_equal(name, size):
    """The port's build against the JAX package's, at the published size
    (265,625 and 250,000 particles) and the golden's: every particle field
    (the kinematic flag and velocity among them), the grid, the model
    tables, and each collider's heights, scale, translation and rotation
    (the rotations formed in float64 and cast, so that their off-axis terms
    are 1.2e-16 and 6.1e-17, not 0), bit for bit. The JAX bundle carried
    across by interop is the port's build, field by field."""
    kw = GOLD[name]["config"] if size == "reduced" else {}
    jb = jscenes.build(name, **kw)
    tb = tscenes.build(name, device="cpu", **kw)
    carried = _port_bundle(jb)
    n = jb.particles.capacity
    assert tb.particles.capacity == n
    if size == "full":
        assert n == {"cube_through_sand3": 265625, "sand_penetration3": 250000}[name]
    for f in fields(tb.particles):
        a, b = getattr(tb.particles, f.name).numpy(), _np(getattr(jb.particles, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
        np.testing.assert_array_equal(getattr(carried.particles, f.name).numpy(), b)
    kin = tb.particles.kinematic_enabled.numpy()
    if name == "cube_through_sand3":
        assert kin.sum() == 25**3 and (tb.particles.model_id.numpy()[kin] == 1).all()
        np.testing.assert_array_equal(tb.particles.kinematic_vel.numpy()[kin],
                                      np.tile(np.float32([10.0, 0.0, 0.0]), (25**3, 1)))
    else:
        assert not kin.any()
    assert tb.grid == carried.grid and tb.grid.res == tuple(jb.grid.res)
    for k in ("ctype", "cparams", "ptype", "pparams", "ftype", "fparams"):
        np.testing.assert_array_equal(getattr(tb.models, k).numpy(), _np(getattr(jb.models, k)))
        np.testing.assert_array_equal(getattr(carried.models, k).numpy(),
                                      _np(getattr(jb.models, k)))
    assert len(tb.colliders) == len(jb.colliders) == (4 if name == "sand_penetration3" else 1)
    for tc, cc, jc in zip(tb.colliders, carried.colliders, jb.colliders):
        for c in (tc, cc):
            assert c.shape_type == jc.shape_type and c.friction == jc.friction
            assert c.flip_interior == jc.flip_interior and c.boundary_handling is None
            for a, b in zip((*c.data, c.translation, c.rotation),
                            (*jc.data, jc.translation, jc.rotation)):
                assert a.dtype == np.float32
                np.testing.assert_array_equal(a, b)
    if name == "sand_penetration3":
        off = [abs(float(c.rotation[1, 2])) for c in tb.colliders]
        assert off == [0.0, float(np.float32(np.sin(np.pi))),
                       1.0, 1.0] and tb.colliders[2].rotation[1, 1] == np.float32(6.123234e-17)
    assert tb.params.dt == jb.params.dt and tuple(tb.gravity) == tuple(jb.gravity)


def test_packs_bit_equal(reduced):
    """The reduced scene's pack through the port's fused pipeline against
    the JAX package's: every slot row (the dt-bound row among them, each
    package forming its own; the stress-cache rows; the kinematic velocity
    rows), the ints (the kinematic flag among them) and the structure, bit
    for bit."""
    k = reduced
    ts = k.tpipe.pack_state(k.tb.particles)
    js = k.js
    assert k.tpipe._meta["stress_cache"]
    np.testing.assert_array_equal(ts.ints.numpy(), _np(js.ints))
    np.testing.assert_array_equal(ts.slots.numpy(), _np(js.slots))
    for name, v in ts.structure.tensors().items():
        np.testing.assert_array_equal(v.numpy(), _np(getattr(js.structure, name)), err_msg=name)
    occ = (ts.ints.numpy()[:, TL.I_FLAGS] & TL.OCCUPIED) != 0
    kin = (ts.ints.numpy()[:, TL.I_FLAGS] & TL.KINEMATIC) != 0
    assert occ.sum() == k.tb.particles.capacity
    assert kin.sum() == (25**3 if k.name == "cube_through_sand3" else 0)
    assert (ts.slots.numpy()[:, R3.kinvel][kin] == 10.0).all()


# ---------------------------------------------------------------------------
# The scenes against the JAX fused pipeline, and the goldens
# ---------------------------------------------------------------------------


def _compare(pj, pt, msg=""):
    """tests/test_fused.py::_compare's tolerances (fused against dense)."""
    act = _np(pj.active)
    np.testing.assert_array_equal(pt.active.numpy(), act)
    np.testing.assert_allclose(pt.position.numpy()[act], _np(pj.position)[act], atol=5e-5,
                               err_msg=msg)
    np.testing.assert_allclose(pt.velocity.numpy()[act], _np(pj.velocity)[act], atol=5e-4,
                               err_msg=msg)
    np.testing.assert_allclose(pt.deformation_gradient.numpy()[act],
                               _np(pj.deformation_gradient)[act], atol=5e-4, err_msg=msg)
    np.testing.assert_array_equal(pt.failed.numpy()[act], _np(pj.failed)[act], err_msg=msg)


def test_substeps_match_jax_fused(reduced):
    """SUBSTEPS substeps of the reduced scene, the port's fused pipeline on
    the CPU from each JAX state (carried across by interop) against the JAX
    fused pipeline in interpret mode: one substep each; the unpacked
    particles within test_fused's tolerances (positions 5e-5, velocities
    and F 5e-4), flags equal; the dt-bound row bit-equal on every occupied
    lane (on the block's lanes too, whose velocity is the kinematic one);
    and the kinematic block's positions and velocities bit-equal, which
    advance by exactly dt times 10 m/s along x."""
    k = reduced
    for step in range(SUBSTEPS):
        js, js2 = k.jstates[step], k.jstates[step + 1]
        ts = _state_to_port(js, k.tpipe)
        ts2, nt = k.tpipe.run_frames_state(ts, 1)
        assert nt == int(k.jcounts[step]) == 1
        assert k.tpipe.last_resorts == k.jresorts[step]
        occ = (_np(js2.ints)[:, TL.I_FLAGS] & TL.OCCUPIED) != 0
        np.testing.assert_array_equal(ts2.ints.numpy(), _np(js2.ints))
        np.testing.assert_array_equal(ts2.slots.numpy()[:, R3.dtb][occ],
                                      _np(js2.slots)[:, R3.dtb][occ], err_msg=f"{step} dtb")
        pj = k.jpipe.unpack_state(js2)
        pt = k.tpipe.unpack_state(ts2)
        _compare(pj, pt, f"{k.name} substep {step}")
        kin = _np(pj.kinematic_enabled) & _np(pj.active)
        if k.name == "cube_through_sand3":
            assert kin.sum() == 25**3
            np.testing.assert_array_equal(pt.position.numpy()[kin], _np(pj.position)[kin])
            np.testing.assert_array_equal(pt.velocity.numpy()[kin], _np(pj.velocity)[kin])
            p0 = k.jpipe.unpack_state(js)
            adv = _np(pj.position)[kin] - _np(p0.position)[kin]
            assert (adv[:, 1:] == 0).all() and (adv[:, 0] > 0).all()
    assert np.abs(pt.velocity.numpy()[pt.active.numpy()]).max() > 0.01
