"""cube_through_sand3 and sand_penetration3 on the CPU beyond their builds,
packs and substeps (test_torch_scenes3d.py holds those), against the JAX
package: sand_penetration3's rotated fields' projections, one grid update
on its four cached projections, and the goldens' first frames of both
scenes on the port's fused and sparse paths. The reduced scenes and their
tables are test_torch_scenes3d.py's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparkl_tpu.core.grid import GridState as JGridState
from sparkl_tpu.solver import dense as jdense

import sparkl_tpu_torch as tsk
import sparkl_tpu_torch.scenes as tscenes
from sparkl_tpu_torch.core.grid import GridState
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
from sparkl_tpu_torch.solver import dense as tdense
from sparkl_tpu_torch.sparse.blocks import BlockConfig
from sparkl_tpu_torch.sparse.pipeline import SparseMpmPipeline

from test_torch_scenes3d import CFG, GOLD, SCENES, _jax_reduced, _np

torch.set_num_threads(1)

# Golden frames replayed on each of the port's paths.
GOLDEN_FRAMES = {"fused": 3, "sparse": 2}


def _tie_split(pt, pj, q, atol):
    """The tie mask: queries where the port's projection lies more than
    atol from the jitted JAX one; each must be a genuine tie, as near the
    query as the JAX point (float64 distances, rtol 1e-6)."""
    tie = np.abs(pt - pj).max(-1) > atol
    qd = q[tie].astype(np.float64)
    np.testing.assert_allclose(np.linalg.norm(qd - pt[tie], axis=-1),
                               np.linalg.norm(qd - pj[tie], axis=-1), rtol=1e-6)
    return tie


def test_rotated_projections_match_jax():
    """sand_penetration3's four heightfields (one unrotated, one rotated by
    pi about x, two by ∓pi/2), each projected from 4096 queries around it
    (numpy seed), against jax.jit of the JAX projection (the pipelines
    call it jitted): the containment bit-equal; the points within 2 ulps
    at the fields' |x| <= 22 (4e-6; the world transform's f32 product
    rounds as XLA's dot does, the local triangle arithmetic as in
    test_torch_math_models.py) except on near-ties, where the port may take
    another triangle as near the query. Ties measured: 3, 2, 1 and 3 of
    4096 per field; at most 4 per field allowed, as for sand3's field."""
    jb = _jax_reduced("sand_penetration3")
    tb = tscenes.build("sand_penetration3", device="cpu", **GOLD["sand_penetration3"]["config"])
    rng = np.random.default_rng(5)
    m = 4096
    for ci, (cj, ct) in enumerate(zip(jb.colliders, tb.colliders)):
        t = cj.translation
        if ci < 2:  # horizontal plates: queries within 3 m of their plane
            q = np.stack([rng.uniform(-22, 22, m), t[1] + rng.uniform(-3, 3, m),
                          rng.uniform(-22, 22, m)], -1)
        else:  # upright plates: within 3 m of z = t_z
            q = np.stack([rng.uniform(-22, 22, m), rng.uniform(-22, 22, m),
                          t[2] + rng.uniform(-3, 3, m)], -1)
        q = q.astype(np.float32)
        pj, ij = (_np(x) for x in jax.jit(cj.project_point)(jnp.asarray(q)))
        pt, it = (x.numpy() for x in ct.project_point(torch.from_numpy(q)))
        np.testing.assert_array_equal(it, ij, err_msg=f"collider {ci}")
        assert 0.1 < it.mean() < 0.9
        tie = _tie_split(pt, pj, q, 4e-6)
        assert tie.sum() <= 4, (ci, int(tie.sum()))
        np.testing.assert_allclose(pt[~tie], pj[~tie], atol=4e-6, err_msg=f"collider {ci}")
        # The local frame: (q - t) @ r bit-equal to the jitted JAX to_local.
        lt = _port_local(ct, q)
        np.testing.assert_array_equal(lt, _np(jax.jit(cj.to_local)(jnp.asarray(q))))


def _port_local(collider, q):
    """The port's local coordinates of q: the translation, then the f32
    product with the rotation."""
    t = torch.as_tensor(collider.translation)
    return ((torch.from_numpy(q) - t) @ torch.as_tensor(collider.rotation)).numpy()


def test_grid_update_on_four_cached_projections():
    """One grid update of sand_penetration3's reduced block node table, and
    of 20,000 more nodes around the plates (numpy seed), each field applied
    in turn, against the jitted JAX grid_update (dt traced, as in the JAX
    pipelines' frame loop) on the same nodes and velocities (numpy seed, 4
    m/s). The fused pipeline's cache holds the port's projections of its
    node table, each of the four equal to collider.project_point there.
    Both updates read the JAX package's projections, so that this holds
    the update alone: the velocities within 2e-6 m/s (measured 1.4e-6;
    jitted XLA contracts the friction and margin terms into FMAs). The
    port's own projections differ from those by the few ulps of
    test_rotated_projections_match_jax, which the margin term's division
    by dt amplifies (to 7e-5 m/s at dt = 1e-3 s on 9 of 20,000 nodes), and
    the update moved many nodes."""
    jb = _jax_reduced("sand_penetration3")
    tb = tscenes.build("sand_penetration3", device="cpu", **GOLD["sand_penetration3"]["config"])
    tpipe = tsk.auto_pipeline(tb, device="cpu")
    ts = tpipe.pack_state(tb.particles)
    node_pos, cached = ts.grid_cache[:2]
    assert len(cached) == 4
    for c, (pc, ic) in zip(tb.colliders, cached):
        pn, inn = c.project_point(node_pos)
        assert torch.equal(pc, pn) and torch.equal(ic, inn)
    rng = np.random.default_rng(11)
    extra = np.stack([rng.uniform(-8, 8, 20000), rng.uniform(-1, 13, 20000),
                      rng.uniform(-6, 6, 20000)], -1).astype(np.float32)
    nodes = np.concatenate([node_pos.numpy().reshape(-1, 3), extra])
    vel = rng.normal(scale=4.0, size=nodes.shape).astype(np.float32)
    mass = np.ones(len(nodes), np.float32)
    dt = np.float32(1e-3)

    @jax.jit
    def jupdate(pos, v, dt):
        proj = jdense.grid_node_projections(jb.colliders, pos)
        g = JGridState(mass=jnp.asarray(mass), momentum=v, velocity=v,
                       psi_momentum=jnp.asarray(mass), psi_mass=jnp.asarray(mass))
        out = jdense.grid_update(jb.grid, g, jb.colliders, dt, jb.params.boundary_handling,
                                 jb.params.simulation_dofs, node_positions=pos,
                                 projections=proj)
        return out.velocity, proj

    vj, proj_j = jupdate(jnp.asarray(nodes), jnp.asarray(vel), jnp.float32(dt))
    proj_j = tuple((torch.tensor(_np(pp)), torch.tensor(_np(ii))) for pp, ii in proj_j)
    z = torch.from_numpy(mass)
    v = torch.from_numpy(vel)
    out = tdense.grid_update(tb.grid, GridState(z, v, v, z, z), tb.colliders, float(dt),
                             tb.params.boundary_handling, tb.params.simulation_dofs,
                             node_positions=torch.from_numpy(nodes), projections=proj_j)
    vt = out.velocity.numpy()
    np.testing.assert_allclose(vt, _np(vj), atol=2e-6)
    assert (np.abs(vt - vel).max(-1) > 1e-3).sum() > 5000


def _stats(p):
    act = p.active.numpy()
    pos = p.position.numpy()[act]
    vel = p.velocity.numpy()[act]
    mass = p.mass.numpy()[act]
    ke = float(0.5 * np.sum(mass[:, None] * vel**2))
    failed = int(p.failed.numpy()[act].sum())
    broken = int((p.phase.numpy()[act] == 0.0).sum())
    return pos.mean(axis=0), pos.min(axis=0), pos.max(axis=0), ke, failed, broken, float(mass.sum())


@pytest.mark.parametrize("path", ["fused", "sparse"])
@pytest.mark.parametrize("name", SCENES)
def test_golden_first_frames(name, path):
    """The golden's first frames (GOLDEN_FRAMES: 3 fused, 2 sparse) of the
    scene at its reduced size through the port's path on the CPU: the
    fused one by auto_pipeline -> pack_state -> run_frames_state ->
    unpack_state, the sparse one by auto_pipeline(prefer="sparse") ->
    run_frames, both with the tables of CFG; tests/test_regression.py::
    _replay's bounds for non-dense pipelines and its mass check."""
    gold = GOLD[name]
    b = tscenes.build(name, device="cpu", **gold["config"])
    pipe = tsk.auto_pipeline(b, device="cpu", prefer=path, config=BlockConfig(**CFG[name]))
    assert isinstance(pipe, FusedMpmPipeline if path == "fused" else SparseMpmPipeline)
    p = b.particles
    act0 = p.active.numpy()
    per_mass = p.mass.numpy()
    mass0 = float(per_mass[act0].sum())
    n0 = int(act0.sum())
    state = pipe.pack_state(p) if path == "fused" else None
    for rec in gold["frames"][: GOLDEN_FRAMES[path]]:
        if path == "fused":
            state, niter = pipe.run_frames_state(state, 1)
            p = pipe.unpack_state(state)
        else:
            p, niter = pipe.run_frames(p, 1)
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
