"""The port's block-sparse pipeline on the CPU (plain kernel versions)
against the JAX package: the block structure bit for bit, the two window
transfers' plain versions against the Pallas kernels in interpret mode and
against the einsum form, the window wrappers' argument checks, the
particle update the path calls, and one sand3 frame against the JAX
SparseMpmPipeline (its XLA path, which tests/test_sparse.py holds to the
interpret-mode kernels). tests/test_torch_sparse_paths.py holds the matrix
forms, the sand3 golden, the constructor's refusals, auto_pipeline's
routing and the entry points' device defaults;
tests/test_torch_sparse2d.py the 2D path.

Every port call passes device="cpu"; small BlockConfigs keep the JAX
references cheap. The CUDA kernels run only on the card, where
chip_smoke.py holds each against its plain version at sand3@1M.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparkl_tpu.scenes as jscenes
from sparkl_tpu import native as jnative
from sparkl_tpu.solver import dense as jdense
from sparkl_tpu.ops import transfer_kernels as JK
from sparkl_tpu.sparse import blocks as JB
from sparkl_tpu.sparse.pipeline import SparseMpmPipeline as JSparse

from sparkl_tpu_torch import interop
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.core.params import SolverParameters
from sparkl_tpu_torch.geometry.colliders import heightfield
from sparkl_tpu_torch.ops import transfer_kernels as TK
from sparkl_tpu_torch.solver import dense as tdense
from sparkl_tpu_torch.sparse import blocks as TB
from sparkl_tpu_torch.sparse import transfer as TT
from sparkl_tpu_torch.sparse.pipeline import SparseMpmPipeline

torch.set_num_threads(1)

# Capacities that fit sand3 at nx=8 (8 blocks, 8 chunks at rest; the
# kernels' inputs keep 2 padding chunks) and at nx=12 (the golden's 19
# chunks), with room for the fall.
CFG_K = dict(max_blocks=16, max_chunks=10, chunk_size=128, max_grid_blocks=48)
CFG8 = dict(max_blocks=16, max_chunks=16, chunk_size=128, max_grid_blocks=48)


def _t(a):
    return torch.tensor(np.asarray(a))


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


@pytest.fixture(scope="module")
def scene():
    """sand3 at nx=8 with 3 particles moved out of the grid and 3 made
    inactive, its JAX structure, and numpy-seeded transfer payloads packed
    into chunk slots by the JAX package."""
    b = jscenes.build("sand3", nx=8, ny=4, nz=4)
    pos = np.asarray(b.particles.position).copy()
    act = np.asarray(b.particles.active).copy()
    pos[[5, 77, 200]] = [[1.0e3, 3.0, 0.2], [0.3, -50.0, 0.2], [0.4, 3.0, 40.0]]
    act[[9, 100, 150]] = False
    cfg = JB.BlockConfig(**CFG_K)
    n = pos.shape[0]
    rng = np.random.default_rng(11)
    fields = dict(
        position=pos,
        mass=rng.uniform(0.5, 2.0, n).astype(np.float32),
        velocity=rng.normal(scale=0.5, size=(n, 3)).astype(np.float32),
        affine=rng.normal(scale=3.0, size=(n, 3, 3)).astype(np.float32),
        psi_mass=rng.uniform(0.0, 1.0, n).astype(np.float32),
        psi_mom=rng.normal(size=n).astype(np.float32),
    )

    def structure_and_slots(act, *f):
        js = JB.build_structure(b.grid, cfg, f[0], act)
        return js, JK.gather_slot_data(cfg, js, JK.pack_p2g_inputs(*f))

    js, slot_data = jax.jit(structure_and_slots)(jnp.asarray(act), *(jnp.asarray(fields[k]) for k in (
        "position", "mass", "velocity", "affine", "psi_mass", "psi_mom")))
    return b, cfg, js, pos, act, fields, np.asarray(slot_data)


def _tstructure(js):
    return TB.BlockStructure(**{k: _t(getattr(js, k)) for k in TB.BlockStructure.__dataclass_fields__})


def test_build_structure_bit_equal(scene):
    b, cfg, js, pos, act, _, _ = scene
    ts = TB.build_structure(b.grid, TB.BlockConfig(**CFG_K), torch.tensor(pos), torch.tensor(act))
    assert int(ts.num_chunks) > 1 and int(ts.num_blocks) > 1
    # Out-of-grid and inactive particles sort to the end, outside any block.
    assert int((ts.sorted_block >= 0).sum()) == act.sum() - 3
    for name, t in ts.tensors().items():
        j = np.asarray(getattr(js, name))
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


def test_block_node_positions_and_calibrate_match_jax(scene, monkeypatch):
    b, cfg, js, pos, act, _, _ = scene
    np.testing.assert_array_equal(
        TB.block_node_positions(b.grid, _t(js.grid_keys)).numpy(),
        np.asarray(JB.block_node_positions(b.grid, js.grid_keys)))

    # The port's calibrate is the JAX package's numpy path, which that
    # package takes where its C++ counter is not available.
    def no_native(*args, **kw):
        raise RuntimeError("numpy path")

    monkeypatch.setattr(jnative, "calibrate_blocks", no_native)
    for slack in (1.0, 1.4):
        jcal = JB.BlockConfig.calibrate(b.grid, pos, act, slack=slack)
        tcal = TB.BlockConfig.calibrate(b.grid, torch.tensor(pos), torch.tensor(act), slack=slack)
        assert vars(tcal) == vars(jcal)
    assert vars(TB.BlockConfig.for_particles(1000, 3)) == vars(JB.BlockConfig.for_particles(1000, 3))


def test_gather_slot_data_bit_equal(scene):
    _, cfg, js, _, _, f, slot_data = scene
    packed = TK.pack_p2g_inputs(*(torch.tensor(f[k]) for k in (
        "position", "mass", "velocity", "affine", "psi_mass", "psi_mom")))
    out = TK.gather_slot_data(TB.BlockConfig(**CFG_K), _tstructure(js), packed)
    np.testing.assert_array_equal(out.numpy(), slot_data)


def _assert_channels_close(t, j, what):
    """Per channel, |port - JAX| <= 1e-5 of the channel's largest magnitude:
    the same products summed in another order (the Pallas kernel's dense
    dots over all 512 cells and 128 slots against batched matrix products
    of other shapes)."""
    for ch in range(j.shape[1]):
        scale = np.abs(j[:, ch]).max()
        assert scale > 0, f"{what} channel {ch} is all zero"
        np.testing.assert_allclose(t[:, ch], j[:, ch], rtol=0, atol=1e-5 * scale,
                                   err_msg=f"{what} channel {ch}")


@pytest.mark.parametrize("with_psi", [False, True])
def test_p2g_windows_reference_matches_pallas(scene, with_psi):
    b, cfg, _, _, _, _, slot_data = scene
    img_j = np.asarray(JK.p2g_windows_pallas(b.grid, cfg, jnp.asarray(slot_data),
                                             interpret=True, with_psi=with_psi))
    TK.reset_launch_counts()
    img_t = TK.p2g_windows(b.grid, TB.BlockConfig(**CFG_K), torch.tensor(slot_data),
                           with_psi=with_psi).numpy()
    assert TK.LAUNCHES["p2g_windows"] == 0  # the CPU path launches no kernel
    assert img_t.shape == img_j.shape == (CFG_K["max_chunks"], 6 if with_psi else 4, 512)
    _assert_channels_close(img_t, img_j, "p2g images")


@pytest.mark.parametrize("with_psi", [False, True])
def test_g2p_windows_reference_matches_pallas(scene, with_psi):
    b, cfg, js, _, _, _, slot_data = scene
    n_win = 4 if with_psi else 3
    win = np.random.default_rng(12).normal(size=(CFG_K["max_chunks"], n_win, 512)) \
        .astype(np.float32)
    out_j = np.asarray(JK.g2p_windows_pallas(b.grid, cfg, jnp.asarray(slot_data),
                                             jnp.asarray(win), interpret=True,
                                             with_psi=with_psi))
    out_t = TK.g2p_windows(b.grid, TB.BlockConfig(**CFG_K), torch.tensor(slot_data),
                           torch.tensor(win), with_psi=with_psi).numpy()
    assert out_t.shape == out_j.shape == (CFG_K["max_chunks"], 9 + n_win, 128)
    # Valid slots only: padded slots hold no particle, and no caller reads them.
    valid = np.arange(128)[None, :] < np.asarray(js.chunk_count)[:, None]
    _assert_channels_close(np.where(valid[:, None], out_t, 0.0),
                           np.where(valid[:, None], out_j, 0.0), "g2p rows")


def test_window_wrappers_check_arguments(scene):
    """The window wrappers refuse what their kernels do not take, on the CPU
    as on the card: wrong dtype, shape or device, a window of the other
    psi width, a grid other than 3D, and a device with no kernel route."""
    b, _, _, _, _, _, slot_data = scene
    cfg, sd = TB.BlockConfig(**CFG_K), torch.tensor(slot_data)
    win = torch.zeros(CFG_K["max_chunks"], 3, 512)
    with pytest.raises(TypeError):
        TK.p2g_windows(b.grid, cfg, sd.double())
    with pytest.raises(ValueError):
        TK.p2g_windows(b.grid, cfg, sd[:-1].contiguous())
    with pytest.raises(ValueError):
        TK.g2p_windows(b.grid, cfg, sd, win, with_psi=True)  # psi needs a 4th channel
    with pytest.raises(ValueError):
        TK.g2p_windows(b.grid, cfg, sd, win.transpose(1, 2).contiguous().transpose(1, 2))
    grid2 = GridParams(origin=(0.0, 0.0), cell_width=0.1, res=(32, 32))
    with pytest.raises(NotImplementedError):
        TK.p2g_windows(grid2, cfg, sd[:, :16].contiguous())  # 2D slot rows
    with pytest.raises(NotImplementedError):
        TK.g2p_windows(b.grid, cfg, sd.to("meta"), win.to("meta"), with_psi=False)


@pytest.mark.parametrize("with_psi", [False, True])
def test_window_references_match_einsum_path(scene, with_psi):
    """The second witness: the JAX package's einsum form of both transfers
    (sparse/transfer.py), ported, on the same particles."""
    b, _, js, _, _, f, slot_data = scene
    cfg, ts = TB.BlockConfig(**CFG_K), _tstructure(js)
    tf = {k: torch.tensor(v) for k, v in f.items()}
    img_e = TT.p2g_images(b.grid, cfg, ts, tf["position"], tf["mass"], tf["velocity"],
                          tf["affine"], tf["psi_mass"], tf["psi_mom"], with_psi=with_psi)
    img_k = TK.p2g_windows_reference(b.grid, torch.tensor(slot_data), with_psi)
    _assert_channels_close(img_k.numpy(), img_e.numpy(), "p2g images vs einsum")

    n_win = 4 if with_psi else 3
    win = torch.tensor(np.random.default_rng(13).normal(
        size=(CFG_K["max_chunks"], n_win, 512)).astype(np.float32))
    vel, grad, det, psi, valid = TT.g2p_from_windows(b.grid, cfg, ts, tf["position"], win,
                                                     with_psi=with_psi)
    rows = [vel.permute(0, 2, 1)] + [grad[..., j].permute(0, 2, 1) for j in range(3)]
    rows += [psi[:, None, :]] if with_psi else []
    out_e = torch.cat(rows, dim=1)
    out_k = TK.g2p_windows_reference(b.grid, torch.tensor(slot_data), win, with_psi)
    m = valid[:, None, :]
    _assert_channels_close(torch.where(m, out_k, 0.0).numpy(),
                           torch.where(m, out_e, 0.0).numpy(), "g2p rows vs einsum")
    tr = grad[..., 0, 0] + grad[..., 1, 1] + grad[..., 2, 2]
    np.testing.assert_allclose(det[valid].numpy(), tr[valid].numpy(), rtol=1e-5, atol=1e-3)

    # Back to particle order: the per-array scatter and the pipeline's one
    # row gather agree, and each particle reads its own slot.
    inv_perm = torch.empty_like(ts.sorted_ids)
    inv_perm[ts.sorted_ids.long()] = torch.arange(inv_perm.shape[0], dtype=torch.int32)
    (v_p,) = TT.scatter_slots_to_particles(cfg, ts, inv_perm, vel)
    rows = TT.gather_slot_rows(cfg, ts, inv_perm, vel.reshape(-1, 3))
    assert torch.equal(v_p, rows)
    _, pos_slots = TT.gather_chunks(cfg, ts, tf["position"])
    (pos_p,) = TT.scatter_slots_to_particles(cfg, ts, inv_perm, pos_slots)
    has_slot = (ts.sorted_block >= 0)[inv_perm.long()]
    assert torch.equal(pos_p[has_slot], tf["position"][has_slot])
    assert not pos_p[~has_slot].any()


def test_particle_update_matches_jax(scene):
    """dense.particle_update_after_gather with the GPU velocity clamp and the
    next substep's dt bounds, on sand3 particles with numpy-seeded gathered
    velocities and gradients and F past the Drucker-Prager cone on some,
    plus a kinematic, a static, a failed and a blown-up (|F00| > 1e4)
    particle, and four that move faster than a cell per substep. The JAX
    side is one jitted program: XLA's fusions move the SVD's f32 rounding,
    within the stated SVD floor."""
    b = scene[0]
    rng = np.random.default_rng(21)
    a = {k: np.asarray(v).copy() for k, v in vars(b.particles).items()}
    n = a["position"].shape[0]
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    s_ = rng.uniform(0.97, 1.02, size=(n, 3))
    a["deformation_gradient"] = (q * s_[:, None, :] @ np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
                                 ).astype(np.float32)
    blk = np.flatnonzero(np.asarray(b.models.ptype)[a["model_id"]] == 0)[0]  # no return map
    a["deformation_gradient"][blk, 0, 0] = 2.0e4
    a["kinematic_enabled"][0] = True
    a["kinematic_vel"][0] = [0.5, -1.0, 0.25]
    a["is_static"][1] = True
    a["failed"][2] = True
    vel = rng.normal(scale=2.0, size=(n, 3)).astype(np.float32)
    vel[4:8, 0] = 150.0  # |v| dt > h at dt = 2e-3, h = 0.2
    grad = rng.normal(scale=0.5, size=(n, 3, 3)).astype(np.float32)
    det = np.trace(grad, axis1=1, axis2=2).astype(np.float32)
    dt = np.float32(2.0e-3)
    pj = b.particles.replace(**{k: jnp.asarray(v) for k, v in a.items()})
    oj, dtb_j = jax.jit(lambda q, v, g, d: jdense.particle_update_after_gather(
        b.grid, q, b.models, dt, v, g, d, jnp.zeros(n, jnp.float32), colliders=b.colliders,
        gpu_velocity_clamp=True, compute_dt_bound=True))(
        pj, jnp.asarray(vel), jnp.asarray(grad), jnp.asarray(det))

    grid, models, colliders, _ = _port_of(b)
    pt = interop.particles_from_numpy(a, device="cpu")
    ot, dtb_t = tdense.particle_update_after_gather(
        grid, pt, models, float(dt), torch.from_numpy(vel), torch.from_numpy(grad),
        torch.from_numpy(det), torch.zeros(n), colliders=colliders, gpu_velocity_clamp=True,
        compute_dt_bound=True)

    oj = {k: np.asarray(v) for k, v in vars(oj).items()}
    ot = interop.particles_to_numpy(ot)
    for k in ("position", "velocity", "velocity_gradient"):
        np.testing.assert_allclose(ot[k], oj[k], rtol=1e-6, atol=1e-6, err_msg=k)
    for k in ("deformation_gradient", "plastic_def_det", "plastic_hardening", "log_vol_gain"):
        np.testing.assert_allclose(ot[k], oj[k], atol=2e-5, err_msg=k)
    for k in ("failed", "phase", "elastic_hardening"):
        np.testing.assert_array_equal(ot[k], oj[k], err_msg=k)
    for k in ("psi_pos", "parameter1"):
        np.testing.assert_allclose(ot[k], oj[k], atol=1e-4 * np.abs(oj[k]).max(), err_msg=k)
    np.testing.assert_allclose(dtb_t.numpy(), np.asarray(dtb_j), rtol=1e-6)
    assert ot["failed"][[2, blk]].all() and not ot["failed"][[0, 1]].any()
    assert np.array_equal(ot["velocity"][0], a["kinematic_vel"][0]) and not ot["velocity"][1].any()
    moved = np.any(ot["plastic_hardening"] != a["plastic_hardening"])
    assert moved  # the return map projected
    np.testing.assert_array_equal(np.abs(ot["velocity"][4:8]), 100.0)  # h / dt, every component


def test_one_frame_matches_jax_sparse_pipeline(scene):
    b = scene[0]
    jpipe = JSparse(b.grid, b.models, b.colliders, b.params, b.gravity,
                    config=JB.BlockConfig(**CFG8), use_pallas=False, group_size=16)
    pj, nj = jpipe.step_with_stats(b.particles)

    grid, models, colliders, particles = _port_of(b)
    tpipe = SparseMpmPipeline(grid, models, colliders, SolverParameters(dt=b.params.dt),
                              b.gravity, config=TB.BlockConfig(**CFG8), device="cpu")
    TK.reset_launch_counts()
    pt, nt = tpipe.step_with_stats(particles)
    assert nt == int(nj)
    assert TK.LAUNCHES == {"p2g_windows": 0, "g2p_windows": 0}

    # The tolerances of tests/test_fused.py::_compare (fused vs dense).
    act = np.asarray(pj.active)
    np.testing.assert_array_equal(pt.active.numpy(), act)
    np.testing.assert_allclose(pt.position.numpy()[act], np.asarray(pj.position)[act], atol=5e-5)
    np.testing.assert_allclose(pt.velocity.numpy()[act], np.asarray(pj.velocity)[act], atol=5e-4)
    np.testing.assert_allclose(pt.deformation_gradient.numpy()[act],
                               np.asarray(pj.deformation_gradient)[act], atol=5e-4)
    np.testing.assert_array_equal(pt.failed.numpy()[act], np.asarray(pj.failed)[act])
    assert np.abs(pt.velocity.numpy()[act]).max() > 0.1  # the column is falling


