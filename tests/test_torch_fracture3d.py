"""The port's 3D fracture path (l_panel3: l_panel2's two damage mechanisms
in a 3D slab, on the fused pipeline) and the modified-eigenerosion trip, on
the CPU against the JAX package: the l_panel3 builds and the 3D pack, the
3D hook, kernel A's 3D fresh-stress form with the psi channels, kernel B's
3D failure and psi forms and the modified trip (2D and 3D), the 3D pooling
at KN = 108, its cull and its candidate list's regrow, and three substeps
of the reduced l_panel3 against the JAX fused pipeline.
(test_torch_fracture_models.py holds the 3D eigenvalues and failure
envelope, the kernels' meta and the JAX package's own 2D
modified-eigenerosion scene on the port.)

The port builds l_panel3 with chip_smoke.py's `l_panel3` (the port's API);
this file builds it again with the JAX package's API and carries the JAX
objects across with sparkl_tpu_torch/interop.py. Inputs come from numpy
seeds; the JAX kernels run in interpret mode, the port's through their
plain versions. Each comparison states its tolerance.
"""

import functools
from dataclasses import fields
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparkl_tpu.scenes as jscenes
from sparkl_tpu.core.grid import GridParams as JGridParams
from sparkl_tpu.core.params import BoundaryHandling as JBH, DamageModel as JDM
from sparkl_tpu.core.params import SolverParameters as JParams
from sparkl_tpu.core.particles import Particles as JParticles
from sparkl_tpu.fused import kernels as JK
from sparkl_tpu.fused.pipeline import FusedMpmPipeline as JPipeline
from sparkl_tpu.geometry import colliders as jcol
from sparkl_tpu.models import registry as jreg
from sparkl_tpu.solver.pipeline import DirichletVelocityHook as JHook
from sparkl_tpu.sparse import transfer as JT
from sparkl_tpu.sparse.blocks import BlockConfig as JBlockConfig

import chip_smoke
from sparkl_tpu_torch import interop
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.core.params import BoundaryHandling, DamageModel, SolverParameters
from sparkl_tpu_torch.fused import kernels as TK
from sparkl_tpu_torch.fused import layout as TL
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
from sparkl_tpu_torch.fused.structure import SlotStructure
from sparkl_tpu_torch.math import svd as tsvd
from sparkl_tpu_torch.sparse.blocks import BlockConfig

torch.set_num_threads(1)

R3 = TL.Rows(3)
SMALL, LAYERS = chip_smoke.LPANEL3_SMALL, chip_smoke.LPANEL3_SMALL_LAYERS
# Capacities of the reduced scenes' kernel and pipeline runs (the
# calibrated ones hold 512 chunks, which the interpret-mode kernels would
# all walk): the reduced l_panel3 packs 42 chunks in 32 blocks of 60 grid
# blocks, the reduced 2D panels 12 chunks.
CFG3 = dict(max_blocks=64, max_chunks=64, chunk_size=128, max_grid_blocks=128)
CFG2 = dict(max_blocks=32, max_chunks=32, chunk_size=64, max_grid_blocks=64)
# Trip decisions may differ only where the decided quantity lies within
# this relative distance of its threshold (rounding of the pooled and
# stress sums, which the two packages take in other orders).
TIE = 1e-5


def _np(x):
    return np.asarray(x)


def _port_particles(p):
    return interop.particles_from_numpy({f.name: _np(getattr(p, f.name)) for f in fields(p)},
                                        device="cpu")


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


# ---------------------------------------------------------------------------
# l_panel3 with the JAX package's API
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _jax_l_panel2():
    """jscenes.build("l_panel2"), built once a process (its eager build
    compiles an op per shape): the reduced scenes, the full one and
    test_torch_sparse2d's cases take their rows from it."""
    return jscenes.build("l_panel2")


def _jax_panels(scale, layers=None):
    """l_panel2's particle rows (JAX build) inside the panel polygon scaled
    by `scale` about each panel's origin, as particles: 2D with `layers`
    None, else extruded into `layers` layers at z = (2k + 1) h/4. Returns
    (particles, h, origins, z_top)."""
    b2 = _jax_l_panel2()
    h = b2.grid.cell_width
    r = h / 4.0
    gs = h * 40.0
    origins = [(gs, gs), (gs * 8.0, gs)]
    pos2, mid2 = _np(b2.particles.position), _np(b2.particles.model_id)
    zs = None if layers is None else ((2.0 * np.arange(layers) + 1.0) * r).astype(np.float32)
    parts = []
    for m, (ox, oy) in enumerate(origins):
        u, v = pos2[:, 0] - np.float32(ox), pos2[:, 1] - np.float32(oy)
        size = np.float32(0.5 * scale)
        keep = (mid2 == m) & (u < size) & (v < size) & ~((u > size / 2) & (v < size / 2))
        pos = pos2[keep]
        reps = 1
        if zs is not None:
            pos = np.concatenate([np.concatenate([pos, np.full((len(pos), 1), z, np.float32)], 1)
                                  for z in zs])
            reps = layers
        rows = {k: jnp.tile(jnp.asarray(getattr(b2.particles, k))[keep], reps)
                for k in ("crack_propagation_factor", "crack_threshold", "m_c", "g")}
        parts.append(JParticles.from_positions(pos, m, r, 2500.0, **rows))
    z_top = None if zs is None else float(zs[-1] + r)
    return JParticles.concatenate(tuple(parts)), h, origins, z_top


def _jax_models():
    e, nu = 25.85e9, 0.18
    return jreg.ModelSet.pack([
        jreg.ParticleModel(jreg.corotated_linear_elasticity(e, nu)),
        jreg.ParticleModel(jreg.corotated_linear_elasticity(e, nu),
                           failure=jreg.maximum_stress_failure(2.7e6, np.finfo(np.float32).max)),
    ])


def jax_l_panel3(damage="eigenerosion", scale=1.0, layers=chip_smoke.LPANEL3_LAYERS,
                 load_speed=chip_smoke.LPANEL_LOAD_SPEED):
    """chip_smoke.l_panel3's configuration built with the JAX package's
    API: (grid, models, colliders, particles, params, gravity, hooks)."""
    particles, h, origins, z_top = _jax_panels(scale, layers)
    gh, gs = h * 10.0, h * 40.0
    grid = JGridParams.for_domain((0.05, 0.05, 0.0), (2.2, 0.95, z_top), h, pad=3)
    colliders = (jcol.cuboid((1000.0, gh, 1000.0), translation=(0.0, gs - gh, 0.0)),)
    planes = [k * h for k in range(int(round(z_top / h)) + 1)]
    load = [(ox + 0.47 * scale, oy + 0.25 * scale) for ox, oy in origins]
    hooks = JHook(points=[[x, y, z] for x, y in load for z in planes],
                  velocities=[[0.0, load_speed, 0.0]] * (len(load) * len(planes)))
    dm = JDM.MODIFIED_EIGENEROSION if damage == "modified" else JDM.EIGENEROSION
    params = JParams(dt=1.0 / 6000.0, boundary_handling=JBH.STICK, damage_model=dm)
    return grid, _jax_models(), colliders, particles, params, (0.0, 0.0, 0.0), hooks


def _port_pipeline(grid, models, colliders, params, gravity, hooks, config=None):
    """The JAX objects carried across: a port FusedMpmPipeline on the CPU."""
    tm = interop.modelset_from_numpy(models.ctype, models.cparams, models.ptype, models.pparams,
                                     models.ftype, models.fparams, device="cpu")
    tc = tuple(interop.collider_from_numpy(c.shape_type, c.data, c.translation, c.rotation,
                                           c.friction) for c in colliders)
    th = None if hooks is None else interop.dirichlet_hook_from_numpy(hooks.points,
                                                                      hooks.velocities)
    tp = SolverParameters(dt=params.dt, boundary_handling=BoundaryHandling(
        int(params.boundary_handling)), damage_model=DamageModel(int(params.damage_model)),
        stop_after_one_substep=params.stop_after_one_substep)
    return FusedMpmPipeline(GridParams(grid.origin, grid.cell_width, grid.res), tm, tc, tp,
                            gravity, th, config=None if config is None else BlockConfig(**config),
                            device="cpu")


def _port_state(pipe, js):
    """A JAX SlotState carried to the port (the grid cache rebuilt)."""
    arrays = {f.name: _np(getattr(js.structure, f.name)) for f in fields(SlotStructure)}
    arrays.update(slots=_np(js.slots), ints=_np(js.ints), cum_disp=_np(js.cum_disp))
    return interop.slot_state_from_numpy(arrays, cache_fn=pipe._grid_cache, device="cpu")


@pytest.fixture(scope="module")
def small():
    """The reduced l_panel3 from both packages, JAX and port pipelines on
    it (the JAX one in interpret mode, one substep a frame, CFG3), and the
    JAX pack."""
    j = jax_l_panel3(scale=SMALL, layers=LAYERS)
    grid, models, colliders, p, params, gravity, hooks = j
    params = JParams(dt=params.dt, boundary_handling=params.boundary_handling,
                     damage_model=params.damage_model, stop_after_one_substep=True)
    jpipe = JPipeline(grid, models, colliders, params, gravity, hooks,
                      config=JBlockConfig(**CFG3), use_pallas="interpret")
    tpipe = _port_pipeline(grid, models, colliders, params, gravity, hooks, CFG3)
    tb = chip_smoke.l_panel3(scale=SMALL, layers=LAYERS, device="cpu")
    jpipe._ensure_cfg(p)
    return SimpleNamespace(j=j, p=p, jpipe=jpipe, tpipe=tpipe, tb=tb,
                           js=jpipe._jit_pack(p))


@pytest.fixture(scope="module")
def full():
    """l_panel3 at full size (600,000 particles) from both packages, with
    the full-size paths' load speed."""
    speed = chip_smoke.LPANEL3_LOAD_SPEED
    return SimpleNamespace(j=jax_l_panel3(load_speed=speed),
                           tb=chip_smoke.l_panel3(device="cpu", load_speed=speed))


# ---------------------------------------------------------------------------
# The builds and the pack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_l_panel3_builds_bit_equal(size, request):
    """chip_smoke.l_panel3 (the port's API) against the same configuration
    built with the JAX package's API: every particle field, the grid, the
    model tables, the cuboid, the hook's points and velocities and the
    parameters, bit for bit; full size 600,000 particles (10 layers), the
    reduced form at most ~3,000, every particle inside the grid."""
    k = request.getfixturevalue("full" if size == "full" else "small")
    grid, models, colliders, p, params, gravity, hooks = k.j
    tb = k.tb
    n = p.capacity
    assert tb.particles.capacity == n and (n == 600000 if size == "full" else n <= 3000)
    for f in fields(tb.particles):
        a, b = getattr(tb.particles, f.name).numpy(), _np(getattr(p, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    cpf = tb.particles.crack_propagation_factor.numpy()
    assert (cpf == 4.5).sum() == (cpf == 0.0).sum() == n // 2
    assert tb.grid == GridParams(grid.origin, grid.cell_width, grid.res) and tb.grid.dim == 3
    for k in ("ctype", "cparams", "ptype", "pparams", "ftype", "fparams"):
        np.testing.assert_array_equal(getattr(tb.models, k).numpy(), _np(getattr(models, k)))
    (tc,), (jc,) = tb.colliders, colliders
    for a, b in zip((*tc.data, tc.translation, tc.rotation), (*jc.data, jc.translation,
                                                               jc.rotation)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tb.hooks.points, np.asarray(hooks.points, np.float32))
    np.testing.assert_array_equal(tb.hooks.velocities, np.asarray(hooks.velocities, np.float32))
    assert len(tb.hooks.points) == 2 * 6 if size == "full" else True
    assert (tb.params.dt, int(tb.params.boundary_handling), int(tb.params.damage_model)) == (
        params.dt, int(params.boundary_handling), int(params.damage_model))
    assert tuple(tb.gravity) == tuple(gravity)
    pos = tb.particles.position.numpy()
    lo = np.asarray(grid.origin) + 2 * grid.cell_width
    hi = np.asarray(grid.origin) + (np.asarray(grid.res) - 3) * grid.cell_width
    assert ((pos > lo) & (pos < hi)).all()  # every stencil inside the grid


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_pack_bit_equal(size, request):
    """l_panel3's 3D pack with the stress cache off (no stress rows seeded),
    at full size and reduced: the structure, every slot row (the dt-bound
    row among them, each package forming its own) and the ints, bit for
    bit, and the calibration."""
    k = request.getfixturevalue("full" if size == "full" else "small")
    tpipe = FusedMpmPipeline(k.tb.grid, k.tb.models, k.tb.colliders, k.tb.params, k.tb.gravity,
                             k.tb.hooks, device="cpu")
    ts = tpipe.pack_state(k.tb.particles)
    grid, models, colliders, p, params, gravity, hooks = k.j
    jpipe = JPipeline(grid, models, colliders, params, gravity, hooks, use_pallas="interpret")
    jpipe._ensure_cfg(p)
    js = jpipe._jit_pack(p)
    assert tpipe._cfg == BlockConfig(**vars(jpipe._cfg))
    assert not tpipe._meta["stress_cache"] and tpipe._meta["with_psi"]
    np.testing.assert_array_equal(ts.ints.numpy(), _np(js.ints))
    np.testing.assert_array_equal(ts.slots.numpy(), _np(js.slots))
    for name, v in ts.structure.tensors().items():
        np.testing.assert_array_equal(v.numpy(), _np(getattr(js.structure, name)), err_msg=name)
    occ = (ts.ints.numpy()[:, TL.I_FLAGS] & TL.OCCUPIED) != 0
    dtb = ts.slots.numpy()[:, R3.dtb][occ]
    assert occ.sum() == p.capacity and (dtb > 0).all() and (dtb < 1e-5).all()


def test_dirichlet_hook_3d_matches_jax(small):
    """The hook on the reduced l_panel3's block node table (its node
    positions, the trash row far outside included) at its 2 x 4 load points
    (each panel's load point at every node plane across the slab):
    bit-equal velocities, exactly one node pinned per point."""
    from sparkl_tpu.core.grid import GridState as JGridState
    from sparkl_tpu_torch.core.grid import GridState

    k = small
    ts = _port_state(k.tpipe, k.js)
    node_pos = ts.grid_cache[0].numpy()
    vel = np.random.default_rng(76).normal(size=node_pos.shape).astype(np.float32)
    zero = np.zeros(node_pos.shape[:-1], np.float32)
    hooks = k.j[-1]
    jz = jnp.asarray(zero)
    out_j = hooks.post_grid_update(
        JGridState(mass=jz, momentum=jnp.asarray(vel), velocity=jnp.asarray(vel),
                   psi_momentum=jz, psi_mass=jz), k.jpipe.grid, 1e-6, jnp.asarray(node_pos))
    z = torch.from_numpy(zero)
    out_t = k.tpipe.hooks.post_grid_update(
        GridState(z, torch.from_numpy(vel), torch.from_numpy(vel), z, z), k.tpipe.grid, 1e-6,
        torch.from_numpy(node_pos))
    np.testing.assert_array_equal(out_t.velocity.numpy(), _np(out_j.velocity))
    pinned = (out_t.velocity.numpy() != vel).any(-1)
    assert pinned.sum() == len(k.tb.hooks.points) == 2 * 4


# ---------------------------------------------------------------------------
# 3D eigenvalues and the failure envelope
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _perturbed(js, dim, seed, modified_psi):
    """A packed state's slots [D, NF, C] with F = I + 2e-4 N (maximum
    stress trips on about half of panel 2's lanes), a random velocity
    gradient, positions moved by up to 0.3 of the particle spacing, a tenth
    of the lanes broken (phase 0) and a few failed; with `modified_psi`,
    psi_pos uniform in [0, 2 cthr/(cpf h)] so that the crack energies of
    the gathered psi straddle the threshold."""
    r = TL.Rows(dim)
    slots = _np(js.slots).copy()
    occ = (_np(js.ints)[:, TL.I_FLAGS] & TL.OCCUPIED) != 0
    rng = np.random.default_rng(seed)
    shape = slots[:, 0].shape
    h = 0.005
    for i in range(dim):
        for j in range(dim):
            f = (1.0 if i == j else 0.0) + 2e-4 * rng.normal(size=shape)
            slots[:, r.defgrad + dim * i + j] = np.where(occ, f, 0.0)
            slots[:, r.grad + dim * i + j] = np.where(occ, rng.normal(scale=0.5, size=shape),
                                                      0.0)
        slots[:, r.pos + i] += np.where(occ, rng.uniform(-0.3, 0.3, size=shape) * h / 2, 0.0)
    slots[:, r.phase] = np.where(occ & (rng.uniform(size=shape) < 0.1), 0.0,
                                 slots[:, r.phase])
    slots[:, r.failed] = np.where(occ & (rng.uniform(size=shape) < 0.02), 1.0, 0.0)
    psi_max = 2.0 * 89.0 / (4.5 * h) if modified_psi else 5.0e3
    slots[:, r.psi_pos] = np.where(occ, rng.uniform(0.0, psi_max, size=shape), 0.0)
    return slots.astype(np.float32)


def _pipelines_2d_modified():
    """The reduced 2D panels under modified eigenerosion: (JAX pipeline,
    port pipeline, JAX pack), CFG2."""
    p, h, origins, _ = _jax_panels(SMALL)
    b2 = _jax_l_panel2()
    load = [(ox + 0.47 * SMALL, oy + 0.25 * SMALL) for ox, oy in origins]
    hooks = JHook(points=load, velocities=[[0.0, 0.1]] * 2)
    params = JParams(dt=b2.params.dt, boundary_handling=JBH.STICK,
                     damage_model=JDM.MODIFIED_EIGENEROSION)
    args = (b2.grid, b2.models, b2.colliders, params, (0.0, 0.0), hooks)
    jpipe = JPipeline(*args, config=JBlockConfig(**CFG2), use_pallas="interpret")
    tpipe = _port_pipeline(*args, CFG2)
    jpipe._ensure_cfg(p)
    return jpipe, tpipe, jpipe._jit_pack(p)


@pytest.fixture(scope="module")
def kernel_states(small):
    """Per form: (JAX pipeline, port pipeline, JAX pack, perturbed slots):
    the reduced l_panel3 under eigenerosion and under modified
    eigenerosion, and the reduced 2D panels under modified eigenerosion."""
    k = small
    out = {"3d": (k.jpipe, k.tpipe, k.js, _perturbed(k.js, 3, 72, False))}
    grid, models, colliders, p, _, gravity, hooks = k.j
    params = JParams(dt=1.0 / 6000.0, boundary_handling=JBH.STICK,
                     damage_model=JDM.MODIFIED_EIGENEROSION)
    jm = JPipeline(grid, models, colliders, params, gravity, hooks,
                   config=JBlockConfig(**CFG3), use_pallas="interpret")
    tm = _port_pipeline(grid, models, colliders, params, gravity, hooks, CFG3)
    out["3d-modified"] = (jm, tm, k.js, _perturbed(k.js, 3, 73, True))
    j2, t2, js2 = _pipelines_2d_modified()
    out["2d-modified"] = (j2, t2, js2, _perturbed(js2, 2, 74, True))
    return out


def test_kernel_a_3d_psi_matches_pallas(kernel_states):
    """Kernel A's 3D form with the stress cache off: fresh corotated stress
    through the cardano SVD with the phase split, the psi channels, failed
    debris: images [D, 6, 512] within rtol 1e-5, atol 1e-6 of the image's
    scale (the same terms summed in another order)."""
    jpipe, tpipe, js, slots = kernel_states["3d"]
    nch = js.structure.num_chunks
    img_j = _np(JK.p2g_fused(jpipe.grid, jpipe._cfg, jpipe._meta, jnp.asarray(slots), js.ints,
                             jnp.float32(1e-6), jpipe._tab_f, jpipe._tab_i, interpret=True,
                             nchunks=nch))
    TK.reset_launch_counts()
    img_t = TK.p2g_fused(tpipe.grid, tpipe._cfg, tpipe._meta, torch.from_numpy(slots),
                         torch.from_numpy(_np(js.ints)), 1e-6, torch.from_numpy(_np(nch)),
                         tables=(tpipe._tab_f, tpipe._tab_i)).numpy()
    assert TK.LAUNCHES["p2g_fused"] == 0
    assert img_t.shape == img_j.shape == (CFG3["max_chunks"], 6, 512)
    np.testing.assert_allclose(img_t, img_j, rtol=1e-5, atol=1e-6 * np.abs(img_j).max())
    assert np.abs(img_t[:, 4:]).max() > 0  # the psi channels carry mass


@pytest.mark.parametrize("form", ["3d", "3d-modified", "2d-modified"])
def test_kernel_b_damage_matches_pallas(kernel_states, form):
    """Kernel B's damage forms on occupied lanes, on the windows of the
    port's kernel-A images of the perturbed state: 3D with the maximum-stress
    trip (eigenerosion: the psi channel not read), and the crack-energy trip
    of modified eigenerosion (cpf·h·psi over the threshold) in 3D and 2D.
    Rows to 1e-5 of their scale (F to 2e-5: it passes the SVD), the energy
    rows psi_pos and par1 = psi_pos·m to 2e-5 of the strain-equivalent
    scale 2 sqrt(mu e_max) (times m for par1): near F = I the cardano
    singular values carry an f32 floor of ~3e-8 that the energy mu·Σ(s-1)²
    turns into up to a few percent of its own size; failed equal; phase
    equal off the lanes whose largest principal stress (of the output F)
    lies within TIE of the envelope or whose crack energy lies within TIE of
    the threshold. Both trips must occur."""
    jpipe, tpipe, js, slots = kernel_states[form]
    dim = jpipe.grid.dim
    r = TL.Rows(dim)
    dt = 1e-6
    nch = js.structure.num_chunks
    tstate = _port_state(tpipe, js)
    tstate = tstate.replace(slots=torch.from_numpy(slots))
    ints_t = tstate.ints
    images = TK.p2g_fused(tpipe.grid, tpipe._cfg, tpipe._meta, tstate.slots, ints_t, dt,
                          tstate.structure.num_chunks, tables=(tpipe._tab_f, tpipe._tab_i))
    fields = tpipe._node_fields(tstate, images, dt)
    windows = JT.gather_grid_windows(jpipe.grid, jpipe._cfg, js.structure,
                                     jnp.asarray(fields.numpy()),
                                     cell_order=JT.ZMAJOR_ORDER_3D if dim == 3 else None)
    assert windows.shape[1] == dim + 1
    out_j = _np(JK.g2p_fused(jpipe.grid, jpipe._cfg, jpipe._meta, jpipe._kparams,
                             jnp.asarray(slots), js.ints, windows,
                             jnp.float32(dt), jpipe._tab_f, jpipe._tab_i, interpret=True,
                             nchunks=nch))
    out_t = TK.g2p_fused(tpipe.grid, tpipe._cfg, tpipe._meta, tpipe._kparams,
                         torch.from_numpy(slots), ints_t, fields, tpipe._corners(tstate), dt,
                         tpipe._tab_f, tpipe._tab_i, tstate.structure.num_chunks).numpy()
    occ = (_np(js.ints)[:, TL.I_FLAGS, :] & TL.OCCUPIED) != 0
    a = np.where(occ[:, None, :], out_t, 0.0)
    b = np.where(occ[:, None, :], out_j, 0.0)
    mu = float(tpipe.models.cparams[:, 1].max())
    m_max = np.abs(b[:, r.mass]).max()
    escale = 2.0 * np.sqrt(mu * np.abs(b[:, r.psi_pos]).max())
    for row in range(r.nf):
        if row in (r.failed, r.phase):
            continue
        err = np.abs(a[:, row] - b[:, row]).max()
        if row == r.psi_pos:
            assert err / escale <= 2e-5, row
        elif row == r.par1:
            assert err / (escale * m_max) <= 2e-5, row
        else:
            tol = 2e-5 if r.defgrad <= row < r.defgrad + dim * dim else 1e-5
            assert err / max(np.abs(b[:, row]).max(), 1e-30) <= tol, row
    np.testing.assert_array_equal(a[:, r.failed], b[:, r.failed])
    # Ties: the envelope on the output F's stress (the input phase), and
    # the crack energy of the gathered psi.
    f = [[torch.from_numpy(out_t[:, r.defgrad + dim * i + j]) for j in range(dim)]
         for i in range(dim)]
    (ct,), p = TK.model_columns(tpipe._tab_f, tpipe._tab_i, ints_t, range(16))
    st = TK.kirchhoff_stress_c(ct, p[0:4], torch.from_numpy(slots[:, r.phase]),
                               torch.from_numpy(slots[:, r.eh]), f, None, None, None, (0,))
    sym = [[0.5 * (st[i][j] + st[j][i]) for j in range(dim)] for i in range(dim)]
    eig = tsvd.sym_eigvals2x2_c(sym) if dim == 2 else tsvd.sym_eigvals3x3_c(sym)
    emax = torch.stack(eig).max(0).values.numpy()
    mp = p[TK.TAB_F].numpy()
    tie = (mp > 0) & (np.abs(emax - mp) <= TIE * np.abs(mp))
    modified = form.endswith("modified")
    cpf, cthr = slots[:, r.cpf], slots[:, r.cthr]
    crack_trips = 0
    if modified:
        psi = chip_smoke.psi_gathered(tpipe, tstate, fields, tpipe._corners(tstate)).numpy()
        crack = cpf * np.float32(tpipe.grid.cell_width) * psi
        tie |= (cpf != 0) & (np.abs(crack - cthr) <= TIE * np.abs(cthr))
        crack_trips = int((occ & (slots[:, r.phase] > 0) & (cpf != 0) & (crack > cthr)).sum())
    differ = (a[:, r.phase] != b[:, r.phase]) & occ
    assert not (differ & ~tie).any()
    stress_trips = occ & (b[:, r.phase] == 0.0) & (slots[:, r.phase] != 0.0) & (mp > 0)
    assert stress_trips.sum() > 0
    assert crack_trips > 0 if modified else True


def _jittered_pool_inputs(k):
    """The reduced l_panel3's packed state with positions jittered by up to
    0.3 of the spacing, psi_pos drawn and a third of the lanes broken, and
    the pooling's inputs on it: (state, e, eligible, cand, overflow)."""
    slots = _np(k.js.slots).copy()
    occ = (_np(k.js.ints)[:, TL.I_FLAGS] & TL.OCCUPIED) != 0
    rng = np.random.default_rng(75)
    shape = slots[:, 0].shape
    for ax in range(3):
        slots[:, R3.pos + ax] += np.where(occ, rng.uniform(-7.5e-4, 7.5e-4, size=shape), 0.0)
    slots[:, R3.psi_pos] = np.where(occ, rng.uniform(0.0, 100.0, size=shape), 0.0)
    slots[:, R3.phase] = np.where(occ & (rng.uniform(size=shape) < 0.33), 0.0, slots[:, R3.phase])
    tstate = _port_state(k.tpipe, k.js).replace(slots=torch.from_numpy(slots.astype(np.float32)))
    e, elig = k.tpipe._eigen_rows(tstate)
    cand, overflow = k.tpipe._eigen_candidates(tstate.structure)
    return tstate, e, elig, cand, overflow


def test_pool_3d_matches_pallas(small):
    """The 3D pooling's plain version against the Pallas kernel in
    interpret mode, on the reduced l_panel3's live chunks (positions jittered
    by up to 0.3 of the spacing, psi_pos drawn, a third of the lanes
    broken), each with its KN = 27 x 4 = 108 candidates: the same mask,
    sums of non-negative terms in other orders within 2e-6 relative; the
    candidate list bit-equal to the JAX pipeline's."""
    k = small
    tstate, e, elig, cand_t, ov_t = _jittered_pool_inputs(k)
    cand_j, ov_j = jax.jit(k.jpipe._eigen_candidates)(k.js.structure)
    np.testing.assert_array_equal(cand_t.numpy(), _np(cand_j))
    assert cand_t.shape[1] == 108 and not bool(ov_t) and not bool(ov_j)
    g = TK.eigen_candidate_rows(e, cand_t)
    live = slice(0, int(k.js.structure.num_chunks))
    out_j = _np(JK.eigen_pool_fused(k.jpipe.grid, k.jpipe._cfg, jnp.asarray(e[live].numpy()),
                                    jnp.asarray(g[live].numpy()), interpret=True))
    out_t = TK.eigen_pool_fused_reference(k.tpipe.grid, e[live], g[live]).numpy()
    np.testing.assert_array_equal(out_t != 0, out_j != 0)
    np.testing.assert_allclose(out_t, out_j, rtol=2e-6, atol=0)
    assert not out_t[:, 2:].any() and (out_t[:, 1] > 0).sum() > 0.5 * int(elig.sum())
    counters = torch.zeros(3, dtype=torch.int64)
    full = TK.eigen_pool_fused(k.tpipe.grid, k.tpipe._cfg, e, cand_t, work=counters).numpy()
    np.testing.assert_array_equal(full[live], out_t[:, :2])
    # On the CPU the wrapper adds the plain cull's counts to `work`.
    work = TK.eigen_pool_work(k.tpipe.grid, e, cand_t)
    assert counters.tolist() == [work["skipped"], work["kept"], work["tests"]]


def test_pool_cull_is_exact(small):
    """The pooling kernel's cull (csrc/fused_kernels.cu eigen_pool_kernel)
    on the jittered reduced l_panel3: the lane-group boxes' plain version
    equals a direct min / max over each group's eligible lanes; dropping
    every candidate chunk whose group boxes all lie farther than h from the
    own chunk's (gap² over h², formed as the pair test forms d2) leaves the
    plain pooling bit-identical; and no culled (own group, candidate
    group) pair holds two eligible lanes within h. The cull must take a
    real share of the candidates and of the pair tests."""
    k = small
    _, e, elig, cand, _ = _jittered_pool_inputs(k)
    grid = k.tpipe.grid
    d_, kn = cand.shape
    c, gs = e.shape[2], TK.EIG_GROUP
    live = int(k.js.structure.num_chunks)

    boxes = TK.eigen_boxes_reference(e, 3)
    pos = e[:, 0:3].numpy().reshape(d_, 3, c // gs, gs)
    el = elig.numpy().reshape(d_, 1, c // gs, gs)
    np.testing.assert_array_equal(boxes[..., 0:3].numpy(),
                                  np.where(el, pos, np.inf).min(axis=3).transpose(0, 2, 1))
    np.testing.assert_array_equal(boxes[..., 4:7].numpy(),
                                  np.where(el, pos, -np.inf).max(axis=3).transpose(0, 2, 1))
    assert not boxes[..., 3].any() and not boxes[..., 7].any()

    pairs = TK.eigen_group_pairs(grid, e, cand)  # [D, KN, own group, candidate group]
    keep = pairs.any(dim=3).any(dim=2)
    culled = torch.where(keep, cand, d_)
    sl = slice(0, live)
    out = TK.eigen_pool_fused_reference(grid, e[sl], TK.eigen_candidate_rows(e, cand)[sl])
    out_c = TK.eigen_pool_fused_reference(grid, e[sl], TK.eigen_candidate_rows(e, culled)[sl])
    assert torch.equal(out.view(torch.int32), out_c.view(torch.int32))
    assert (out[:, 1] > 0).sum() > 0.5 * int(elig.sum())

    # Every pair of eligible lanes within h lies in a kept group pair.
    g = TK.eigen_candidate_rows(e, cand)[sl]
    r2 = np.float32(grid.cell_width * grid.cell_width)
    d2 = None
    for ax in range(3):
        diff = g[:, :, ax, :, None] - e[sl, None, ax, None, :]  # [L, KN, C cand, C own]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    near = (d2 <= float(r2)) & (g[:, :, 5, :, None] != 0) & elig[sl, None, None, :]
    near = near.reshape(live, kn, c // gs, gs, c // gs, gs).any(dim=5).any(dim=3)
    assert not (near.transpose(2, 3) & ~pairs[sl]).any()

    valid = cand[sl] < d_
    work = TK.eigen_pool_work(grid, e, cand)
    all_tests = int((elig[sl].sum(dim=1) * valid.sum(dim=1)).sum()) * c
    assert int((valid & ~keep[sl]).sum()) > 0.3 * int(valid.sum())
    assert 0 < work["tests"] < 0.5 * all_tests


def test_eigen_overflow_regrows_and_retries_3d(small):
    """A 3D cube seeded at 27 particles per cell (r = h/6) filling one block
    packs 14 chunks into it, past the candidate list's 4 per block: the span
    overflows at its start, the list doubles twice (to 16) and the span is
    retried, and the substep is bit-equal to one whose list held 16 from
    the start."""
    from sparkl_tpu_torch.core.particles import cube_particles

    k = small
    grid = k.tpipe.grid
    h = grid.cell_width
    # Block b holds the base cells 4b + 1 .. 4b + 4 per axis (off by two):
    # positions (4b + 1.5 .. 4b + 5.5) h from the origin.
    corner = np.asarray(grid.origin) + (4 * np.array([10, 10, 0]) + 1.5 + 1 / 6) * h
    p = cube_particles(corner.astype(np.float32), (12, 12, 12), 0, h / 6, 2500.0, "cpu")
    rng = np.random.default_rng(77)
    n = p.capacity
    p.velocity[:] = torch.from_numpy(rng.normal(scale=0.01, size=(n, 3)).astype(np.float32))
    p.psi_pos[:] = torch.from_numpy(rng.uniform(0.0, 1e-3, n).astype(np.float32))
    p.crack_propagation_factor[:] = 4.5
    p.crack_threshold[:] = 1e-6
    outs = []
    for mcb in (4, 16):
        pipe = FusedMpmPipeline(grid, k.tpipe.models, k.tpipe.colliders, k.tpipe.params,
                                (0.0, 0.0, 0.0), device="cpu")
        pipe._eigen_mcb = mcb
        kmax = int(pipe.pack_state(p).structure.block_num_chunks.max())
        q = pipe.step(p)
        outs.append((q, pipe.eigen_regrows, pipe._eigen_mcb))
    (q4, regrows4, mcb4), (q16, regrows16, mcb16) = outs
    assert kmax == 14 and (regrows4, mcb4, regrows16, mcb16) == (2, 16, 0, 16)
    for f in fields(q4):
        assert torch.equal(getattr(q4, f.name), getattr(q16, f.name)), f.name
    assert (q4.phase[q4.active] == 0).any()  # the pool ran: some lanes tripped


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------


def test_reduced_l_panel3_substeps_match_jax_fused(small):
    """Three substeps of the reduced l_panel3 (each from the JAX particles
    of the one before) through the port's fused pipeline on the CPU against
    the JAX fused pipeline in interpret mode: test_fused's tolerances
    (positions 5e-5, velocities and F 5e-4), failed equal, the same substep
    counts, phase equal off the particles whose trip decision lies within
    TIE of its threshold; maximum stress trips on panel 2 near the load."""
    k = small
    pj = k.p
    for step in range(1, 4):
        pj2, nj = k.jpipe.step_with_stats(pj)
        pt2, nt = k.tpipe.step_with_stats(_port_particles(pj))
        assert int(nj) == nt == 1
        _compare(pj2, pt2, f"substep {step}")
        act = _np(pj2.active)
        differ = act & (pt2.phase.numpy() != _np(pj2.phase))
        if differ.any():  # the ties only matter where the phases differ
            ties = chip_smoke.trip_ties(k.tpipe, _port_particles(pj), pt2).numpy()
            assert not (differ & ~ties).any(), step
        pj = pj2
    assert np.abs(_np(pj.velocity)[_np(pj.active)]).max() > 0.04  # the load moved the panels


