"""The port's 2D fracture path on a small two-panel scene (both fracture
models) on the CPU against the JAX fused pipeline in interpret mode:
kernels A and B in their 2D damage forms (plain versions) against the
Pallas kernels, two substeps through both fused pipelines, and the
eigenerosion candidate list's overflow, regrow and retry.
(test_torch_fracture2d.py holds the SVD, failure, collider, hook, the
l_panel2 scene and pack, the candidates and pooling, and l_panel2 against
the JAX dense pipeline.)

Inputs come from numpy seeds; the JAX kernels run in interpret mode, the
port's kernels through their plain versions. Each comparison states its
tolerance.
"""

from dataclasses import fields

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
from sparkl_tpu.models import registry as jreg
from sparkl_tpu.solver.pipeline import DirichletVelocityHook as JHook
from sparkl_tpu.sparse import transfer as JT
from sparkl_tpu.sparse.blocks import BlockConfig as JBlockConfig

from sparkl_tpu_torch import interop
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.core.params import BoundaryHandling, DamageModel, SolverParameters
from sparkl_tpu_torch.fused import kernels as TK
from sparkl_tpu_torch.fused import layout as TL
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
from sparkl_tpu_torch.math import svd as tsvd
from sparkl_tpu_torch.models import registry as treg
from sparkl_tpu_torch.sparse.blocks import BlockConfig

from test_torch_fracture2d import DT, R2, TIE, _compare, _jnp

torch.set_num_threads(1)

# The small scene: two 12 x 12 panels of E = 2e4 elastic (the first with a
# crack factor, the second failing by maximum stress) over a STICK cuboid,
# a pinned node, random velocities; thresholds low enough that both trip.
E, NU = 2.0e4, 0.35
CRACK_FACTOR, CRACK_THRESHOLD = 0.5, 2.0e-4
MAX_PRINCIPAL = 60.0

SMALL_CFG = dict(max_blocks=32, max_chunks=32, chunk_size=64, max_grid_blocks=64)


def _port_models(m):
    return interop.modelset_from_numpy(m.ctype, m.cparams, m.ptype, m.pparams, m.ftype,
                                       m.fparams, device="cpu")


def _port_colliders(cs):
    return tuple(interop.collider_from_numpy(c.shape_type, c.data, c.translation, c.rotation,
                                             c.friction) for c in cs)


def _port_params(p):
    return SolverParameters(dt=p.dt, boundary_handling=BoundaryHandling(int(p.boundary_handling)),
                            damage_model=DamageModel(int(p.damage_model)),
                            stop_after_one_substep=p.stop_after_one_substep)


def _port_particles(p):
    return interop.particles_from_numpy({f.name: _jnp(getattr(p, f.name)) for f in fields(p)},
                                        device="cpu")


def _small_scene():
    """JAX pieces of the small two-panel scene (see SMALL_CFG)."""
    h = 0.05
    grid = JGridParams(origin=(0.0, 0.0), cell_width=h, res=(64, 64))
    elastic = jreg.corotated_linear_elasticity(E, NU)
    models = jreg.ModelSet.pack([
        jreg.ParticleModel(elastic),
        jreg.ParticleModel(elastic, failure=jreg.maximum_stress_failure(MAX_PRINCIPAL, 1.0e6)),
    ])
    kw = dict(counts=(12, 12), particle_radius=h / 4, density0=1000.0)
    p = JParticles.concatenate((
        jsk.cube_particles(origin=(0.8, 0.76), model_id=0, crack_propagation_factor=CRACK_FACTOR,
                           crack_threshold=CRACK_THRESHOLD, **kw),
        jsk.cube_particles(origin=(1.6, 0.76), model_id=1, **kw),
    ))
    rng = np.random.default_rng(26)
    p = p.replace(velocity=jnp.asarray(rng.normal(scale=1.0, size=(p.capacity, 2))
                                       .astype(np.float32)))
    colliders = (jcol.cuboid((100.0, 0.5), translation=(0.0, 0.25), friction=0.3),)
    hook = JHook(points=[[1.0, 0.95]], velocities=[[0.0, 0.5]])
    params = jsk.SolverParameters(dt=DT, boundary_handling=jsk.BoundaryHandling.STICK,
                                  damage_model=jsk.DamageModel.EIGENEROSION,
                                  stop_after_one_substep=True)
    return grid, models, colliders, p, params, (0.0, -9.81), hook


@pytest.fixture(scope="module")
def small():
    grid, models, colliders, p, params, gravity, hook = _small_scene()
    jpipe = JPipeline(grid, models, colliders, params, gravity, hook,
                      config=JBlockConfig(**SMALL_CFG), use_pallas="interpret")
    tgrid = GridParams(grid.origin, grid.cell_width, grid.res)
    tpipe = FusedMpmPipeline(tgrid, _port_models(models), _port_colliders(colliders),
                             _port_params(params), gravity,
                             interop.dirichlet_hook_from_numpy(hook.points, hook.velocities),
                             config=BlockConfig(**SMALL_CFG), device="cpu")
    # Two substeps, each from the JAX particles of the one before.
    ps_j, ps_t = [p], [None]
    for _ in range(2):
        ps_j.append(jpipe.step(ps_j[-1]))
        ps_t.append(tpipe.step(_port_particles(ps_j[-2])))
    return jpipe, tpipe, ps_j, ps_t


def _kernel_state(jpipe):
    """A packed state of the small scene with F = I + 0.02 N, a random
    velocity gradient and psi_pos, a quarter of the lanes broken (phase 0)
    and a few failed: the stress is fresh and non-trivial, its split and
    the failed-debris rule both apply."""
    grid, models, colliders, p, *_ = _small_scene()
    rng = np.random.default_rng(27)
    n = p.capacity
    p = p.replace(
        deformation_gradient=jnp.asarray((np.eye(2) + 0.02 * rng.normal(size=(n, 2, 2)))
                                         .astype(np.float32)),
        velocity_gradient=jnp.asarray(rng.normal(scale=2.0, size=(n, 2, 2)).astype(np.float32)),
        psi_pos=jnp.asarray(rng.uniform(0.0, 5.0, n).astype(np.float32)),
        phase=jnp.asarray(np.where(rng.uniform(size=n) < 0.25, 0.0, 1.0).astype(np.float32)),
        failed=jnp.asarray(rng.uniform(size=n) < 0.05),
    )
    jpipe._ensure_cfg(p)
    return jpipe._jit_pack(p)


def test_kernel_a_2d_matches_pallas(small):
    """Kernel A with fresh stress (SVD of F, the phase split), the psi
    channels and failed debris: images [D, 5, 64] within rtol 1e-5, atol
    1e-6 of the image's scale (the same terms summed in another order)."""
    jpipe, tpipe, _, _ = small
    js = _kernel_state(jpipe)
    nch = js.structure.num_chunks
    img_j = np.asarray(JK.p2g_fused(jpipe.grid, jpipe._cfg, jpipe._meta, js.slots, js.ints,
                                    jnp.float32(DT), jpipe._tab_f, jpipe._tab_i, interpret=True,
                                    nchunks=nch))
    TK.reset_launch_counts()
    img_t = TK.p2g_fused(tpipe.grid, tpipe._cfg, tpipe._meta, torch.from_numpy(_jnp(js.slots)),
                         torch.from_numpy(_jnp(js.ints)), DT, torch.from_numpy(_jnp(nch)),
                         tables=(tpipe._tab_f, tpipe._tab_i)).numpy()
    assert TK.LAUNCHES["p2g_fused"] == 0
    assert img_t.shape == img_j.shape == (SMALL_CFG["max_chunks"], 5, 64)
    np.testing.assert_allclose(img_t, img_j, rtol=1e-5, atol=1e-6 * np.abs(img_j).max())
    assert np.abs(img_t[:, 3:]).max() > 0  # the psi channels carry mass


def test_kernel_b_2d_matches_pallas(small):
    """Kernel B in 2D with the stress cache off: gather, F update, the 2x2
    SVD, energy, par rows, maximum-stress trips and the dt bound, on
    occupied lanes, on the windows of the kernel-A images. Rows to 1e-5 of
    their scale (F, energy and par1 to 2e-5: they pass through the SVD);
    failed equal; phase equal off the TIE lanes of the stress envelope."""
    jpipe, tpipe, _, _ = small
    js = _kernel_state(jpipe)
    nch = js.structure.num_chunks
    slots_t = torch.from_numpy(_jnp(js.slots))
    ints_t = torch.from_numpy(_jnp(js.ints))
    tstate = interop.slot_state_from_numpy(
        dict({k: _jnp(v) for k, v in vars(js.structure).items()}, slots=_jnp(js.slots),
             ints=_jnp(js.ints), cum_disp=0.0), cache_fn=tpipe._grid_cache, device="cpu")
    images = TK.p2g_fused(tpipe.grid, tpipe._cfg, tpipe._meta, slots_t, ints_t, DT,
                          tstate.structure.num_chunks, tables=(tpipe._tab_f, tpipe._tab_i))
    fields = tpipe._node_fields(tstate, images, DT)
    windows = JT.gather_grid_windows(jpipe.grid, jpipe._cfg, js.structure,
                                     jnp.asarray(fields.numpy()))
    assert windows.shape == (SMALL_CFG["max_chunks"], 3, 64)
    out_j = np.asarray(JK.g2p_fused(jpipe.grid, jpipe._cfg, jpipe._meta, jpipe._kparams,
                                    js.slots, js.ints, windows,
                                    jnp.float32(DT), jpipe._tab_f, jpipe._tab_i, interpret=True,
                                    nchunks=nch))
    out_t = TK.g2p_fused(tpipe.grid, tpipe._cfg, tpipe._meta, tpipe._kparams, slots_t, ints_t,
                         fields, tpipe._corners(tstate), DT, tpipe._tab_f, tpipe._tab_i,
                         tstate.structure.num_chunks).numpy()
    occ = (_jnp(js.ints)[:, TL.I_FLAGS, :] & TL.OCCUPIED) != 0
    a = np.where(occ[:, None, :], out_t, 0.0)
    b = np.where(occ[:, None, :], out_j, 0.0)
    r = R2
    loose = set(range(r.defgrad, r.defgrad + 4)) | {r.psi_pos, r.par1}
    for k in range(r.nf):
        if k in (r.failed, r.phase):
            continue
        scale = max(np.abs(b[:, k]).max(), 1e-30)
        tol = 2e-5 if k in loose else 1e-5
        assert np.abs(a[:, k] - b[:, k]).max() / scale <= tol, k
    np.testing.assert_array_equal(a[:, r.failed], b[:, r.failed])
    # Phase: tripped by the stress of the final F; ties are lanes whose
    # largest principal stress lies within TIE of the threshold.
    f = [[torch.from_numpy(out_t[:, r.defgrad + 2 * i + j]) for j in range(2)] for i in range(2)]
    ct, p = TK.model_columns(tpipe._tab_f, tpipe._tab_i, ints_t, range(4))
    st = TK.kirchhoff_stress_c(ct[0], p, torch.from_numpy(_jnp(js.slots)[:, r.phase]),
                               torch.ones_like(f[0][0]), f, None, None, None, (0,))
    emax = tsvd.sym_eigvals2x2_c([[0.5 * (st[i][j] + st[j][i]) for j in range(2)]
                                  for i in range(2)])[1].numpy()
    tie = np.abs(emax - MAX_PRINCIPAL) <= TIE * MAX_PRINCIPAL
    differ = (a[:, r.phase] != b[:, r.phase]) & occ
    assert not (differ & ~tie).any()
    tripped = occ & (b[:, r.phase] == 0.0) & (_jnp(js.slots)[:, r.phase] != 0.0)
    assert tripped.sum() > 0


def _tie_lanes(tpipe, p_in, p_out):
    """Particles whose trip decision in the substep from p_in to p_out lies
    within TIE of its threshold: the eigenerosion energy the port pools
    from p_in against the crack threshold, or the largest principal stress
    of p_out's F against the maximum-stress envelope."""
    state = tpipe.pack_state(p_in)
    e, elig = tpipe._eigen_rows(state)
    cand, _ = tpipe._eigen_candidates(state.structure)
    energy, _ = tpipe._eigen_update(
        state, TK.eigen_pool_fused(tpipe.grid, tpipe._cfg, e, cand), elig)
    state.slots[:, R2.par1] = energy
    energy = tpipe.unpack_state(state).parameter1
    cthr = p_in.crack_threshold
    eigen_tie = (p_in.crack_propagation_factor != 0) & ((energy - cthr).abs() <= TIE * cthr)
    st = treg.kirchhoff_stress(tpipe.models, p_in.model_id, p_in.phase,
                               p_in.elastic_hardening, p_out.deformation_gradient,
                               p_out.velocity_gradient, p_in.mass, p_in.volume0)
    emax = torch.linalg.eigvalsh(0.5 * (st + st.transpose(1, 2)).double())[:, -1]
    stress_tie = (p_in.model_id == 1) & ((emax - MAX_PRINCIPAL).abs() <= TIE * MAX_PRINCIPAL)
    return (eigen_tie | stress_tie).numpy()


def test_small_scene_substeps_match_jax_fused(small):
    """Two substeps (each from the JAX particles of the one before) with
    eigenerosion and maximum-stress trips, a STICK cuboid and the hook,
    against the JAX fused pipeline in interpret mode: test_fused's
    tolerances, failed equal, phase equal but on lanes whose decision lies
    within TIE of its threshold (counted)."""
    jpipe, tpipe, ps_j, ps_t = small
    ties = 0
    for k in (1, 2):
        pj, pt = ps_j[k], ps_t[k]
        _compare(pj, pt, f"substep {k}")
        act = _jnp(pj.active)
        differ = act & (pt.phase.numpy() != _jnp(pj.phase))
        tie = _tie_lanes(tpipe, _port_particles(ps_j[k - 1]), pt)
        assert not (differ & ~tie).any(), k
        ties += int((differ & tie).sum())
    before, after = _jnp(ps_j[1].phase), _jnp(ps_j[2].phase)
    mid = _jnp(ps_j[0].model_id)
    # Both mechanisms tripped: max stress in substep 1 (kernel B on panel
    # 2), eigenerosion in substep 2 (the pool needs substep 1's energy).
    assert (before[mid == 1] == 0).sum() > 0
    assert ((before != 0) & (after == 0) & (mid == 0)).sum() > 0
    assert ties <= 2  # decisions on ties, if any, are rare


def test_eigen_overflow_regrows_and_retries(small):
    """A scene seeded at 9 particles per cell (r = h/6) packs 3 chunks into
    a block, past the candidate list's 2: the span overflows, the list
    doubles and the span is retried, and the result is bit-equal to a run
    whose list held 4 from the start."""
    jpipe, tpipe, _, _ = small
    h = 0.05
    jp = jsk.cube_particles(origin=(0.8, 0.76), counts=(18, 18), model_id=0,
                            particle_radius=h / 6, density0=1000.0,
                            crack_propagation_factor=CRACK_FACTOR, crack_threshold=1.0e-6)
    rng = np.random.default_rng(28)
    n = jp.capacity
    jp = jp.replace(velocity=jnp.asarray(rng.normal(size=(n, 2)).astype(np.float32)),
                    psi_pos=jnp.asarray(rng.uniform(0.0, 1.0e-3, n).astype(np.float32)))
    outs = []
    for mcb in (2, 4):
        pipe = FusedMpmPipeline(tpipe.grid, tpipe.models, tpipe.colliders, tpipe.params,
                                (0.0, -9.81), tpipe.hooks, device="cpu")
        pipe._eigen_mcb = mcb
        p = pipe.step(_port_particles(jp))
        outs.append((p, pipe.eigen_regrows, pipe._eigen_mcb))
    (p2, regrows2, mcb2), (p4, regrows4, mcb4) = outs
    assert (regrows2, mcb2, regrows4, mcb4) == (1, 4, 0, 4)
    for f in fields(p2):
        assert torch.equal(getattr(p2, f.name), getattr(p4, f.name)), f.name
    assert (p2.phase[p2.active] == 0).any()  # the pool ran: some lanes tripped
