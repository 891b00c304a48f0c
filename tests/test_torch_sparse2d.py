"""The port's block-sparse pipeline on the 2D scenes (and the 3D forms the
same slice opens) on the CPU against the JAX package: the 2D window
transfers' plain versions, with and without the psi channels, against the
Pallas kernels in interpret mode; the cell-bucket neighbour sums and
eigenerosion; the particle update's fluid J update, failure model and
modified-eigenerosion trip; and that the sparse pipeline keeps the
caller's hooks. (test_torch_sparse2d_paths.py holds the substeps against
the JAX SparseMpmPipeline, the buckets' regrow and the elasticity2
golden.)

Every port call passes device="cpu". Each comparison states its
tolerance. chip_smoke.py holds the CUDA kernels to these plain versions on
the card.
"""

from dataclasses import fields, replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparkl_tpu as jsk
import sparkl_tpu.scenes as jscenes
from sparkl_tpu.core.grid import GridParams as JGridParams
from sparkl_tpu.core.params import DamageModel as JDM
from sparkl_tpu.models import registry as jreg
from sparkl_tpu.ops import transfer_kernels as JK
from sparkl_tpu.solver import dense as jdense
from sparkl_tpu.solver import eigenerosion as jeig
from sparkl_tpu.sparse import blocks as JB
from sparkl_tpu.sparse import neighbors as jnb

import sparkl_tpu_torch.scenes as tscenes
from sparkl_tpu_torch import interop
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.core.params import DamageModel
from sparkl_tpu_torch.geometry.colliders import BALL
from sparkl_tpu_torch.models import registry as treg
from sparkl_tpu_torch.ops import transfer_kernels as TK
from sparkl_tpu_torch.solver import dense as tdense
from sparkl_tpu_torch.solver import eigenerosion as teig
from sparkl_tpu_torch.sparse import blocks as TB
from sparkl_tpu_torch.sparse import neighbors as tnb
from sparkl_tpu_torch.sparse.pipeline import SparseMpmPipeline

from test_torch_fracture2d_fused import _port_models, _port_particles

torch.set_num_threads(1)

# Trip decisions may differ only where the decided quantity lies within
# this relative distance of its threshold (the two packages sum the pools
# and form the stress in other orders).
TIE = 1e-5


def _np(x):
    return np.array(x)


# ---------------------------------------------------------------------------
# The 2D window transfers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slots2d():
    """fluids2(n=40)'s particles with numpy-seeded payloads, packed into
    chunk slots by the JAX package; the first 5 chunks (one partly filled)
    and 2 padding chunks."""
    b = jscenes.build("fluids2", n=40)
    pos = _np(b.particles.position)
    n = pos.shape[0]
    rng = np.random.default_rng(41)
    f = dict(position=pos, mass=rng.uniform(0.5, 2.0, n), velocity=rng.normal(size=(n, 2)),
             affine=rng.normal(scale=3.0, size=(n, 2, 2)), psi_mass=rng.uniform(0.0, 1.0, n),
             psi_mom=rng.normal(size=n))
    f = {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in f.items()}
    cfg = JB.BlockConfig.calibrate(b.grid, pos, _np(b.particles.active), slack=1.0)

    def structure_and_slots(act, *f):
        js = JB.build_structure(b.grid, cfg, f[0], act)
        return js, JK.gather_slot_data(cfg, js, JK.pack_p2g_inputs(*f))

    js, slot_data = jax.jit(structure_and_slots)(b.particles.active, *(f[k] for k in (
        "position", "mass", "velocity", "affine", "psi_mass", "psi_mom")))
    slot_data = _np(slot_data)
    count = _np(js.chunk_count)
    partly = int(np.flatnonzero((count > 0) & (count < 64))[0])
    keep = [0, 1, 2, 3, partly, int(js.num_chunks), int(js.num_chunks) + 1]
    cfg_k = JB.BlockConfig(max_blocks=cfg.max_blocks, max_chunks=len(keep), chunk_size=64,
                           max_grid_blocks=cfg.max_grid_blocks)
    return b.grid, cfg_k, np.ascontiguousarray(slot_data[keep]), count[keep]


def _assert_channels_close(t, j, what):
    """Per channel, |port - JAX| <= 1e-5 of the channel's largest magnitude:
    the same products summed in another order (the Pallas kernel's dense
    dots over all 64 cells and 64 slots against the plain version's
    ordered sums)."""
    for ch in range(j.shape[1]):
        scale = np.abs(j[:, ch]).max()
        assert scale > 0, f"{what} channel {ch} is all zero"
        np.testing.assert_allclose(t[:, ch], j[:, ch], rtol=0, atol=1e-5 * scale,
                                   err_msg=f"{what} channel {ch}")


@pytest.mark.parametrize("kernel,with_psi", [("p2g", False), ("p2g", True), ("g2p", False),
                                             ("g2p", True)])
def test_window_references_2d_match_pallas(slots2d, kernel, with_psi):
    """The 2D plain versions (C = 64, row-major cells q = x*8 + y) against
    the Pallas kernels in interpret mode, per channel to 1e-5 of its scale;
    padding chunks give zero images; the CPU path launches no kernel. The
    wrappers refuse the other dimension's chunk size."""
    grid, cfg, slot_data, count = slots2d
    tgrid = GridParams(grid.origin, grid.cell_width, grid.res)
    tcfg = TB.BlockConfig(**vars(cfg))
    sd = torch.from_numpy(slot_data)
    TK.reset_launch_counts()
    if kernel == "p2g":
        out_j = _np(JK.p2g_windows_pallas(grid, cfg, jnp.asarray(slot_data), interpret=True,
                                          with_psi=with_psi))
        out_t = TK.p2g_windows(tgrid, tcfg, sd, with_psi=with_psi).numpy()
        assert out_t.shape == out_j.shape == (cfg.max_chunks, 5 if with_psi else 3, 64)
        assert not out_t[count == 0].any()
        _assert_channels_close(out_t, out_j, "p2g images")
    else:
        n_win = 3 if with_psi else 2
        win = np.random.default_rng(42).normal(size=(cfg.max_chunks, n_win, 64)) \
            .astype(np.float32)
        out_j = _np(JK.g2p_windows_pallas(grid, cfg, jnp.asarray(slot_data), jnp.asarray(win),
                                          interpret=True, with_psi=with_psi))
        out_t = TK.g2p_windows(tgrid, tcfg, sd, torch.from_numpy(win),
                               with_psi=with_psi).numpy()
        assert out_t.shape == out_j.shape == (cfg.max_chunks, 6 + (1 if with_psi else 0), 64)
        # Valid slots only: padded slots hold no particle, and no caller reads them.
        valid = (np.arange(64)[None, :] < count[:, None])[:, None, :]
        _assert_channels_close(np.where(valid, out_t, 0.0), np.where(valid, out_j, 0.0),
                               "g2p rows")
    assert TK.LAUNCHES == {"p2g_windows": 0, "g2p_windows": 0}
    with pytest.raises(NotImplementedError, match="chunk size 128"):
        TK.p2g_windows(tgrid, replace(tcfg, chunk_size=128),
                       torch.zeros(cfg.max_chunks, 16, 128), with_psi=with_psi)


# ---------------------------------------------------------------------------
# Neighbour sums and eigenerosion
# ---------------------------------------------------------------------------


def _damage_particles(dim):
    """A jittered lattice at 2 particles per cell axis (h = 0.05), with
    numpy-seeded psi_pos, crack factors (zero on a tenth), thresholds
    around the pooled energies, a fifth broken, a few failed, inactive or
    outside the grid: (JAX grid, JAX particles)."""
    h = 0.05
    counts = (24, 20) if dim == 2 else (10, 8, 8)
    grid = JGridParams(origin=(0.0,) * dim, cell_width=h, res=(32,) * dim if dim == 2
                       else (16,) * dim)
    p = jsk.cube_particles(origin=(0.1,) * dim, counts=counts, model_id=0,
                           particle_radius=h / 4, density0=1000.0)
    n = p.capacity
    rng = np.random.default_rng(50 + dim)
    pos = _np(p.position) + rng.uniform(-0.1, 0.1, size=(n, dim)).astype(np.float32) * h
    pos[:3] = [[-0.5] * dim, [5.0] * dim, [0.2] * (dim - 1) + [-0.3]]
    psi = rng.uniform(0.0, 2.0, n).astype(np.float32)
    mass = _np(p.mass)
    cpf = np.where(rng.uniform(size=n) < 0.1, 0.0, 0.5).astype(np.float32)
    p = p.replace(
        position=jnp.asarray(pos), psi_pos=jnp.asarray(psi),
        crack_propagation_factor=jnp.asarray(cpf),
        crack_threshold=jnp.asarray(rng.uniform(0.02, 0.03, n).astype(np.float32)),
        phase=jnp.asarray(np.where(rng.uniform(size=n) < 0.2, 0.0, 1.0).astype(np.float32)),
        failed=jnp.asarray(rng.uniform(size=n) < 0.03),
        active=jnp.asarray(rng.uniform(size=n) > 0.03),
        parameter1=jnp.asarray(psi * mass), parameter2=jnp.asarray(mass),
    )
    return grid, p


@pytest.mark.parametrize("dim", [2, 3])
def test_neighbor_pair_sums_match_jax(dim):
    """neighbor_pair_sums on a jittered lattice: the pooled sums to rtol 1e-5
    of each column's largest (the same terms summed in another order), the
    bucket table and cell indices equal, every eligible particle pooling
    neighbours; at a bucket depth of 2 the overflow flag is set in both."""
    grid, p = _damage_particles(dim)
    n = p.capacity
    vals = np.random.default_rng(60).uniform(0.5, 1.5, size=(n, 2)).astype(np.float32)
    mask = _np(p.active) & (np.random.default_rng(61).uniform(size=n) > 0.2)
    tgrid = GridParams(grid.origin, grid.cell_width, grid.res)
    k = 8 if dim == 2 else 16
    sums_j, ov_j = jax.jit(lambda x, v, m: jnb.neighbor_pair_sums(
        grid, x, v, m, grid.cell_width, k))(p.position, jnp.asarray(vals), jnp.asarray(mask))
    sums_t, ov_t = tnb.neighbor_pair_sums(tgrid, torch.from_numpy(_np(p.position)),
                                          torch.from_numpy(vals), torch.from_numpy(mask),
                                          grid.cell_width, k)
    sums_j = _np(sums_j)
    assert not bool(ov_j) and not bool(ov_t)
    for col in range(2):
        np.testing.assert_allclose(sums_t.numpy()[:, col], sums_j[:, col], rtol=0,
                                   atol=1e-5 * np.abs(sums_j[:, col]).max())
    assert (sums_j[mask & (np.arange(n) >= 3)][:, 1] > 0).mean() > 0.95

    bj, ixj, okj, _ = jnb.build_buckets(grid, p.position, jnp.asarray(mask), k)
    bt, ixt, okt, _ = tnb.build_buckets(tgrid, torch.from_numpy(_np(p.position)),
                                        torch.from_numpy(mask), k)
    np.testing.assert_array_equal(bt.numpy(), _np(bj))
    np.testing.assert_array_equal(ixt.numpy(), _np(ixj))
    np.testing.assert_array_equal(okt.numpy(), _np(okj))
    _, _, _, ov_j2 = jnb.build_buckets(grid, p.position, jnp.asarray(mask), 2)
    _, _, _, ov_t2 = tnb.build_buckets(tgrid, torch.from_numpy(_np(p.position)),
                                       torch.from_numpy(mask), 2)
    assert bool(ov_j2) and bool(ov_t2)


@pytest.mark.parametrize("dim", [2, 3])
def test_evolve_eigenerosion_matches_jax(dim):
    """evolve_eigenerosion against the jitted JAX function: parameter1 (the
    pooled energy) to rtol 1e-5, parameter2 unchanged, phase equal but on
    lanes whose energy lies within TIE of the threshold (counted, at most
    one), trips on at least a tenth of the eligible lanes."""
    grid, p = _damage_particles(dim)
    tgrid = GridParams(grid.origin, grid.cell_width, grid.res)
    pj, ov_j = jax.jit(lambda q: jeig.evolve_eigenerosion(grid, q))(p)
    pt, ov_t = teig.evolve_eigenerosion(tgrid, _port_particles(p))
    assert not bool(ov_j) and not bool(ov_t)
    assert teig.default_max_per_cell(dim) == jeig.default_max_per_cell(dim)
    e_j, e_t = _np(pj.parameter1), pt.parameter1.numpy()
    np.testing.assert_allclose(e_t, e_j, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(pt.parameter2.numpy(), _np(pj.parameter2))
    thr = _np(p.crack_threshold)
    tie = (_np(p.crack_propagation_factor) != 0) & (np.abs(e_j - thr) <= TIE * thr)
    differ = pt.phase.numpy() != _np(pj.phase)
    assert not (differ & ~tie).any() and int((differ & tie).sum()) <= 1
    eligible = (_np(p.crack_propagation_factor) != 0) & (_np(p.phase) > 0) \
        & ~_np(p.failed) & _np(p.active)
    tripped = eligible & (_np(pj.phase) == 0)
    assert tripped.sum() > 0.1 * eligible.sum() and (~tripped & eligible).any()


# ---------------------------------------------------------------------------
# The particle update's new branches
# ---------------------------------------------------------------------------


def _update_case(case):
    """(JAX grid, models, particles, gathered velocity, gradient, det, psi,
    damage model) of a 2D numpy-seeded state for one branch of the update."""
    rng = np.random.default_rng({"fluid": 70, "failure": 71, "modified": 72}[case])
    h = 0.05
    grid = JGridParams(origin=(0.0, 0.0), cell_width=h, res=(32, 32))
    elastic = jreg.corotated_linear_elasticity(2.0e4, 0.35)
    if case == "fluid":
        models = [jreg.ParticleModel(elastic), jreg.ParticleModel(jreg.monaghan_sph_eos(
            1.0e4, 7, 1.0e-3))]
    elif case == "failure":
        models = [jreg.ParticleModel(elastic, failure=jreg.maximum_stress_failure(600.0, 1.0e6))]
    else:
        models = [jreg.ParticleModel(elastic)]
    jm = jreg.ModelSet.pack(models)
    p = jsk.cube_particles(origin=(0.4, 0.4), counts=(20, 20), model_id=0,
                           particle_radius=h / 4, density0=1000.0)
    n = p.capacity
    mid = (rng.uniform(size=n) < 0.5).astype(np.int32) if case == "fluid" else np.zeros(n,
                                                                                       np.int32)
    f = (np.eye(2) + 0.02 * rng.normal(size=(n, 2, 2))).astype(np.float32)
    fluid = mid == 1
    f[fluid] = np.eye(2, dtype=np.float32)
    f[fluid, 0, 0] = rng.uniform(0.9, 1.1, size=fluid.sum())
    if case == "fluid":
        # A fluid and a solid past |F00| = 1e4: the guard breaks the solid only.
        f[np.flatnonzero(fluid)[0], 0, 0] = 2.0e4
        f[np.flatnonzero(~fluid)[0], 0, 0] = 2.0e4
    p = p.replace(
        model_id=jnp.asarray(mid), deformation_gradient=jnp.asarray(f),
        psi_pos=jnp.asarray(rng.uniform(0.0, 5.0, n).astype(np.float32)),
        crack_propagation_factor=jnp.asarray(np.where(rng.uniform(size=n) < 0.1, 0.0, 0.5)
                                             .astype(np.float32)),
        crack_threshold=jnp.asarray(rng.uniform(0.02, 0.05, n).astype(np.float32)),
        phase=jnp.asarray(np.where(rng.uniform(size=n) < 0.1, 0.0, 1.0).astype(np.float32)),
        failed=jnp.asarray(rng.uniform(size=n) < 0.03),
    )
    vel = rng.normal(scale=0.5, size=(n, 2)).astype(np.float32)
    grad = rng.normal(scale=2.0, size=(n, 2, 2)).astype(np.float32)
    det = np.trace(grad, axis1=1, axis2=2).astype(np.float32)
    psi = rng.uniform(0.0, 2.0, n).astype(np.float32)
    dm = JDM.MODIFIED_EIGENEROSION if case == "modified" else JDM.NONE
    return grid, jm, p, vel, grad, det, psi, dm


@pytest.mark.parametrize("case", ["fluid", "failure", "modified"])
def test_particle_update_new_branches_match_jax(case):
    """particle_update_after_gather's fluid J update (F00 += det·dt·F00, the
    |F00| > 1e4 guard for solids only), failure model on the updated stress
    and modified-eigenerosion trip (cpf·h·psi over the threshold, before
    the update), against the jitted JAX function on a 2D numpy-seeded
    state: positions, velocities and gradients to 1e-6, F and the plastic
    state to 2e-5 (the SVD's f32 floor; jitted XLA fuses), energy to 1e-4
    of its largest, failed equal, phase equal but on lanes whose decision
    lies within TIE of its threshold (counted, at most one); each branch
    acts on some lanes."""
    grid, jm, p, vel, grad, det, psi, dm = _update_case(case)
    dt = np.float32(2.0e-3)
    oj = jax.jit(lambda q, v, g, d, s: jdense.particle_update_after_gather(
        grid, q, jm, dt, v, g, d, s, damage_model=dm))(
        p, jnp.asarray(vel), jnp.asarray(grad), jnp.asarray(det), jnp.asarray(psi))
    tm = _port_models(jm)
    ot = tdense.particle_update_after_gather(
        GridParams(grid.origin, grid.cell_width, grid.res), _port_particles(p), tm, float(dt),
        torch.from_numpy(vel), torch.from_numpy(grad), torch.from_numpy(det),
        torch.from_numpy(psi), damage_model=DamageModel(int(dm)))
    oj = {f.name: _np(getattr(oj, f.name)) for f in fields(oj)}
    ot = interop.particles_to_numpy(ot)
    for k in ("position", "velocity", "velocity_gradient"):
        np.testing.assert_allclose(ot[k], oj[k], rtol=1e-6, atol=1e-6, err_msg=k)
    for k in ("deformation_gradient", "plastic_def_det", "plastic_hardening", "log_vol_gain"):
        np.testing.assert_allclose(ot[k], oj[k], atol=2e-5, err_msg=k)
    np.testing.assert_array_equal(ot["failed"], oj["failed"])
    for k in ("psi_pos", "parameter1"):
        np.testing.assert_allclose(ot[k], oj[k], atol=1e-4 * np.abs(oj[k]).max(), err_msg=k)

    p0 = {f.name: _np(getattr(p, f.name)) for f in fields(p)}
    if case == "fluid":
        fluid = p0["model_id"] == 1
        big = p0["deformation_gradient"][:, 0, 0] > 1e4
        assert oj["failed"][big & ~fluid].all() and not oj["failed"][big & fluid].any()
        live = fluid & ~p0["failed"] & ~big
        expect = p0["deformation_gradient"][live, 0, 0] * (1.0 + det[live] * dt)
        np.testing.assert_allclose(ot["deformation_gradient"][live, 0, 0], expect, rtol=2e-6)
        tie = np.zeros_like(fluid)
    elif case == "failure":
        tp = interop.particles_from_numpy(ot, device="cpu")
        st = treg.kirchhoff_stress(tm, tp.model_id, torch.from_numpy(p0["phase"]),
                                   tp.elastic_hardening, tp.deformation_gradient,
                                   tp.velocity_gradient, tp.mass, tp.volume0)
        emax = torch.linalg.eigvalsh(0.5 * (st + st.transpose(1, 2)).double())[:, -1].numpy()
        tie = np.abs(emax - 600.0) <= TIE * 600.0
    else:
        energy = p0["crack_propagation_factor"] * grid.cell_width * psi
        tie = np.abs(energy - p0["crack_threshold"]) <= TIE * p0["crack_threshold"]
    differ = ot["phase"] != oj["phase"]
    assert not (differ & ~tie).any() and int((differ & tie).sum()) <= 1
    if case != "fluid":
        tripped = (p0["phase"] > 0) & (oj["phase"] == 0)
        assert 0 < tripped.sum() < (p0["phase"] > 0).sum()


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


def test_sparse_pipeline_keeps_hooks_and_gravity_by_dimension():
    """The caller's hooks are kept and run (a hook that pins every node's
    velocity moves every particle at it), and gravity defaults to the
    grid's dimension; CD-MPM, penalty colliders, other collider shapes,
    boundary projection, GPU boundary semantics and runtime poses are
    refused, never carried by another path."""
    b = tscenes.build("fluids2", n=40, device="cpu")
    hook = interop.dirichlet_hook_from_numpy(np.zeros((0, 2)), np.zeros((0, 2)))
    pipe = SparseMpmPipeline(b.grid, b.models, b.colliders, b.params, None, hook, device="cpu")
    assert pipe.hooks is hook
    assert pipe.gravity.tolist() == pytest.approx([0.0, -9.81])

    class Pin:
        def post_grid_update(self, state, grid, dt, node_positions=None):
            return state.replace(velocity=torch.zeros_like(state.velocity) + 0.25)

    params = replace(b.params, stop_after_one_substep=True, force_fluids_volume_recomputation=False)
    pinned = SparseMpmPipeline(b.grid, b.models, b.colliders, params, None, Pin(), device="cpu")
    p = pinned.step(b.particles)
    act = p.active
    assert torch.allclose(p.velocity[act], torch.full_like(p.velocity[act], 0.25), atol=1e-6)

    base = dict(grid=b.grid, models=b.models, colliders=b.colliders, params=b.params,
                device="cpu")
    refused = [
        dict(params=replace(b.params, damage_model=DamageModel.CD_MPM)),
        dict(params=replace(b.params, enable_boundary_particle_projection=True)),
        dict(params=replace(b.params, gpu_boundary_semantics=True)),
        dict(colliders=(interop.collider_from_numpy(BALL, (np.array([1.0]),), (0.0, 0.0),
                                                    0.0),)),
        dict(colliders=(replace(b.colliders[0], penalty_stiffness=1.0),)),
    ]
    for over in refused:
        with pytest.raises(NotImplementedError):
            SparseMpmPipeline(**dict(base, **over))
    with pytest.raises(NotImplementedError):
        pipe.step_with_stats(b.particles, poses=(None,) * len(b.colliders))


