"""The port's fluid path on the CPU (plain kernel versions) against the JAX
package: the deterministic scatter merge on window images bit-equal to the
JAX package's scatter-add, the EOS model functions, the mass kernels, kernels A and B on
an all-fluid and a mixed corotated + EOS model set, the fluid volume pass,
one frame of a fluid blob through both fused pipelines, and a replay of the
fluids3 golden's first frames.

The blob is 512 EOS particles on a numpy-jittered lattice of spacing 0.18
(radius 0.1, so compressed to J ~ 0.75 inside and expanded at its edges,
with few particles near J = 1, where the EOS dt bound turns on the last
bits) in cells of 0.4. Its JAX packed state is carried across with
interop.slot_state_from_numpy; the JAX kernels run in interpret mode.
"""

import json
import os
from dataclasses import fields
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparkl_tpu.scenes as jscenes
from sparkl_tpu.core.grid import GridParams as JGridParams
from sparkl_tpu.core.params import SolverParameters as JSolverParameters
from sparkl_tpu.core.particles import Particles as JParticles
from sparkl_tpu.fused import kernels as JK
from sparkl_tpu.fused.pipeline import FusedMpmPipeline as JPipeline
from sparkl_tpu.models import constitutive as jcon
from sparkl_tpu.models import registry as jreg
from sparkl_tpu.sparse import transfer as JT
from sparkl_tpu.sparse.blocks import BlockConfig as JBlockConfig

import sparkl_tpu_torch.scenes as tscenes
from sparkl_tpu_torch import interop
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.core.params import SolverParameters
from sparkl_tpu_torch.fused import kernels as TK
from sparkl_tpu_torch.fused import layout as TL
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
from sparkl_tpu_torch.fused.structure import SlotStructure
from sparkl_tpu_torch.models import constitutive as tcon
from sparkl_tpu_torch.models import registry as treg
from sparkl_tpu_torch.sparse import transfer as TT
from sparkl_tpu_torch.sparse.blocks import BlockConfig

torch.set_num_threads(1)

CFG = dict(max_blocks=64, max_chunks=32, chunk_size=128, max_grid_blocks=128)
DT = 1.0e-3
P0 = 1.0e6
GOLD = json.load(open(os.path.join(os.path.dirname(__file__), "golden_scenes.json")))
EOS = jreg.monaghan_sph_eos(P0, 7, 1.01e-3, 1.0)
SOLID = jreg.corotated_linear_elasticity(1.0e6, 0.3)
BOX = ((-2.0, -4.0, -2.0), (5.0, 4.0, 5.0), 0.4)


def _blob_positions():
    rng = np.random.default_rng(3)
    g = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return (1.0 + g * 0.18 + rng.normal(scale=0.01, size=g.shape)).astype(np.float32), g


def _port_models(jm):
    return interop.modelset_from_numpy(jm.ctype, jm.cparams, jm.ptype, jm.pparams, jm.ftype,
                                       jm.fparams, device="cpu")


def _blob(mixed):
    """(JAX grid, models, particles) of the blob; `mixed` makes the half
    with x index >= 4 corotated solid (model 1)."""
    pos, g = _blob_positions()
    models = [jreg.ParticleModel(EOS)] + ([jreg.ParticleModel(SOLID)] if mixed else [])
    jm = jreg.ModelSet.pack(models)
    jp = JParticles.from_positions(pos, 0, 0.1, 1000.0)
    if mixed:
        jp = jp.replace(model_id=jnp.asarray((g[:, 0] >= 4).astype(np.int32)))
    grid = JGridParams.for_domain(*BOX, pad=2)
    return grid, jm, jp


def _port_grid(grid):
    return GridParams(origin=grid.origin, cell_width=grid.cell_width, res=grid.res)


def _state_to_port(js, pipe=None):
    arrays = {f.name: np.asarray(getattr(js.structure, f.name)) for f in fields(SlotStructure)}
    arrays.update(slots=np.asarray(js.slots), ints=np.asarray(js.ints),
                  cum_disp=np.asarray(js.cum_disp, np.float32))
    return interop.slot_state_from_numpy(arrays, cache_fn=pipe._grid_cache if pipe else None,
                                         device="cpu")


@pytest.fixture(scope="module", params=["fluid", "mixed"])
def packed(request):
    """The blob packed by the JAX fused pipeline, with numpy-seeded
    velocities, velocity gradients and deformation gradients (F00 = J in
    [0.85, 1.15] for fluids), as JAX and port states and pipelines."""
    mixed = request.param == "mixed"
    grid, jm, jp = _blob(mixed)
    n = jp.capacity
    rng = np.random.default_rng(7)
    f = (np.eye(3) + 0.02 * rng.normal(size=(n, 3, 3))).astype(np.float32)
    fluid = np.asarray(jm.ctype)[np.asarray(jp.model_id)] == jcon.EOS_MONAGHAN_SPH
    f[fluid] = np.eye(3, dtype=np.float32)
    f[fluid, 0, 0] = rng.uniform(0.85, 1.15, size=fluid.sum())
    jp = jp.replace(
        velocity=jnp.asarray(rng.normal(scale=0.5, size=(n, 3)).astype(np.float32)),
        velocity_gradient=jnp.asarray(rng.normal(scale=2.0, size=(n, 3, 3)).astype(np.float32)),
        deformation_gradient=jnp.asarray(f),
    )
    params = JSolverParameters(force_fluids_volume_recomputation=True)
    jpipe = JPipeline(grid, jm, (), params, config=JBlockConfig(**CFG), use_pallas="interpret")
    jpipe._ensure_cfg(jp)
    js = jpipe._jit_pack(jp)
    tm = _port_models(jm)
    tpipe = FusedMpmPipeline(_port_grid(grid), tm, (),
                             SolverParameters(force_fluids_volume_recomputation=True),
                             config=BlockConfig(**CFG), device="cpu")
    ts = _state_to_port(js, tpipe)
    return SimpleNamespace(grid=grid, jpipe=jpipe, js=js, tpipe=tpipe, ts=ts, mixed=mixed,
                           fluid=fluid)


def _occupied(js):
    return (np.asarray(js.ints)[:, TL.I_FLAGS, :] & TL.OCCUPIED) != 0


def test_scatter_merge_bit_equal_to_jax_scatter_add():
    """The scatter merge's plain version on z-major window images (the
    cell permutation, then each row's updates in order) against the JAX
    package's `.at[dest].add` (sparkl_tpu/sparse/transfer.py:_merge_scatter)
    on the same images' (chunk, corner) rows over fluids3's packed
    structure, whose blocks hold 32 chunks (past MERGE_KMAX = 8), for the
    image width (nf = 4) and the mass width (nf = 1): bit-equal, both
    summing each row in ascending update order from zero. Dead chunks'
    images are zero, as kernel A and the mass kernel write them; the trash
    row, which the merge zeroes, is left out."""
    b = tscenes.build("fluids3", device="cpu")
    pipe = FusedMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity, device="cpu")
    st = pipe.pack_state(b.particles).structure
    cfg = pipe._cfg
    assert int(st.block_num_chunks.max()) > TT.MERGE_KMAX and pipe._merge_force_scatter
    jst = SimpleNamespace(nbr_index=jnp.asarray(st.nbr_index.numpy()),
                          chunk_block=jnp.asarray(st.chunk_block.numpy()))
    rng = np.random.default_rng(17)
    plan = TT.scatter_plan(cfg, st)
    for nf in (4, 1):
        images = rng.normal(size=(cfg.max_chunks, nf, 512)).astype(np.float32)
        images[int(st.num_chunks):] = 0.0
        comb = TT._merge_comb(3, nf, True, torch.device("cpu")).numpy()
        rows = images.reshape(cfg.max_chunks, -1)[:, comb].reshape(cfg.max_chunks, 8, nf, 64)
        out_j = np.asarray(JT._merge_scatter(cfg, jst, jnp.asarray(rows), nf, 64, 8))
        TK.reset_launch_counts()
        out_t = TK.merge_scatter(torch.tensor(images), *plan, st.num_grid_blocks, True).numpy()
        assert TK.LAUNCHES["merge_scatter"] == 0
        np.testing.assert_array_equal(out_t[:-1], out_j[:-1])
        assert not out_t[-1].any()
    # Some node-table row sums far more than 8 updates.
    assert int((plan[1][1:] - plan[1][:-1]).max()) > 8 * TT.MERGE_KMAX


def test_eos_functions_match_jax():
    """Pressure, Kirchhoff stress and dt bound of the Monaghan EOS, and the
    registry's dispatch on a fluid + solid table, on numpy-seeded J in
    [0.8, 1.2] and velocity gradients. Stress in units of p0 within 2e-6:
    (ρ/ρ₀)^7 goes through exp and log, whose f32 rounding differs between
    the libraries, and p0 = 1e6 scales it; dt bounds within rtol 1e-5."""
    rng = np.random.default_rng(23)
    n = 512
    j = rng.uniform(0.8, 1.2, n).astype(np.float32)
    g = rng.normal(scale=2.0, size=(n, 3, 3)).astype(np.float32)
    v = rng.normal(scale=2.0, size=(n, 3)).astype(np.float32)
    mass = np.full(n, 8.0, np.float32)
    vol0 = np.full(n, 8e-3, np.float32)
    f = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    f[:, 0, 0] = j
    ids = rng.integers(0, 2, n).astype(np.int32)
    jm = jreg.ModelSet.pack([jreg.ParticleModel(EOS), jreg.ParticleModel(SOLID)])
    tm = _port_models(jm)
    ones = np.ones(n, np.float32)
    sj = np.asarray(jreg.kirchhoff_stress(jm, jnp.asarray(ids), jnp.asarray(ones),
                                          jnp.asarray(ones), jnp.asarray(f), jnp.asarray(g),
                                          jnp.asarray(mass), jnp.asarray(vol0)))
    st = treg.kirchhoff_stress(tm, torch.tensor(ids), torch.tensor(ones), torch.tensor(ones),
                               torch.tensor(f), torch.tensor(g), torch.tensor(mass),
                               torch.tensor(vol0)).numpy()
    fl = ids == 0
    np.testing.assert_allclose(st[fl] / P0, sj[fl] / P0, rtol=0, atol=2e-6)
    assert np.abs(sj[fl]).max() > 0.1 * P0  # pressures of a tenth of p0 and more
    # Solid rows: corotated stress through the cardano SVD (its f32 floor).
    lam_2mu = float(jm.cparams[1, 0] + 2 * jm.cparams[1, 1])
    np.testing.assert_allclose(st[~fl] / lam_2mu, sj[~fl] / lam_2mu, rtol=0, atol=2e-5)
    bj = np.asarray(jreg.timestep_bound(jm, jnp.asarray(ids), jnp.asarray(ones), jnp.asarray(ones),
                                        jnp.asarray(f), jnp.asarray(mass), jnp.asarray(vol0),
                                        jnp.asarray(v), 0.4))
    bt = treg.timestep_bound(tm, torch.tensor(ids), torch.tensor(ones), torch.tensor(ones),
                             torch.tensor(f), torch.tensor(mass), torch.tensor(vol0),
                             torch.tensor(v), 0.4).numpy()
    np.testing.assert_allclose(bt, bj, rtol=1e-5)
    # The single-particle bound is +inf where J >= 1 (no positive argument).
    pj = np.asarray(jcon.eos_timestep_bound(P0, 7.0, 1.0, jnp.asarray(j), jnp.asarray(mass),
                                            jnp.asarray(vol0), jnp.asarray(1000.0 / j),
                                            jnp.asarray(v), 0.4))
    pt = tcon.eos_timestep_bound(torch.tensor(P0), torch.tensor(7.0), torch.tensor(1.0),
                                 torch.tensor(j), torch.tensor(mass), torch.tensor(vol0),
                                 torch.tensor(1000.0 / j), torch.tensor(v), 0.4).numpy()
    np.testing.assert_allclose(pt, pj, rtol=1e-5)
    assert np.isfinite(pt).all()
    e_t = treg.pos_energy(tm, torch.tensor(ids), torch.tensor(ones), torch.tensor(ones),
                          torch.tensor(f)).numpy()
    assert not e_t[fl].any()


def test_mass_kernels_match_pallas(packed):
    """mass_p2g_fused and mass_g2p_fused (plain) against the JAX kernels on
    the packed blob; the gather on numpy-seeded positive mass windows.
    Relative 2e-6 of the largest value: the same f32 products summed in
    another order (lane order against the factored dots)."""
    k = packed
    cfg = BlockConfig(**CFG)
    nch = k.ts.structure.num_chunks
    img_j = np.asarray(JK.mass_p2g_fused(k.grid, k.jpipe._cfg, k.js.slots, k.js.ints,
                                         interpret=True, nchunks=k.js.structure.num_chunks))
    TK.reset_launch_counts()
    img_t = TK.mass_p2g_fused(k.tpipe.grid, cfg, k.ts.slots, k.ts.ints, nch).numpy()
    assert img_t.shape == img_j.shape == (CFG["max_chunks"], 1, 512)
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=2e-6 * np.abs(img_j).max())
    live = int(nch)
    assert img_t[:live].sum() > 0 and not img_t[live:].any()

    win = np.random.default_rng(5).uniform(0.0, 50.0, size=(CFG["max_chunks"], 1, 512))
    win = win.astype(np.float32)
    out_j = np.asarray(JK.mass_g2p_fused(k.grid, k.jpipe._cfg, k.js.slots, k.js.ints,
                                         jnp.asarray(win), interpret=True,
                                         nchunks=k.js.structure.num_chunks))
    out_t = TK.mass_g2p_fused(k.tpipe.grid, cfg, k.ts.slots, k.ts.ints, torch.tensor(win),
                              nch).numpy()
    assert out_t.shape == out_j.shape == (CFG["max_chunks"], 1, 128)
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=2e-6 * np.abs(out_j).max())
    assert TK.LAUNCHES["mass_p2g_fused"] == TK.LAUNCHES["mass_g2p_fused"] == 0
    assert (out_t[:, 0][_occupied(k.js)] > 0).all()


def test_kernel_a_matches_pallas(packed):
    """Kernel A (plain) against the JAX p2g_fused: fluid slots' stress
    formed fresh from J = F00 (the cache rows are ignored), solid slots'
    read from the cache. Images within rtol 1e-5, atol 1e-6 of their scale
    (tests/test_torch_kernels.py's bound); the stress term dominates the
    momentum channels (EOS pressures of ~0.1-2 p0)."""
    k = packed
    # Fluid cache rows zeroed, as kernel B leaves them (pack seeds them).
    r = TL.Rows(3)
    slots = np.asarray(k.js.slots).copy()
    fl = np.asarray(k.js.ints)[:, TL.I_MODEL, :] == 0
    slots[:, r.stress : r.stress + 6] *= ~fl[:, None, :]
    img_j = np.asarray(JK.p2g_fused(
        k.grid, k.jpipe._cfg, k.jpipe._meta, jnp.asarray(slots), k.js.ints, jnp.float32(DT),
        k.jpipe._tab_f, k.jpipe._tab_i, interpret=True, nchunks=k.js.structure.num_chunks))
    tp = k.tpipe
    meta = TK.kernel_meta(tp.models, tp.params)
    ts = torch.tensor(slots)
    img_t = TK.p2g_fused(tp.grid, BlockConfig(**CFG), meta, ts, k.ts.ints, DT,
                         k.ts.structure.num_chunks, tables=(tp._tab_f, tp._tab_i)).numpy()
    np.testing.assert_allclose(img_t, img_j, rtol=1e-5, atol=1e-6 * np.abs(img_j).max())
    # Without the EOS overlay the images differ: the overlay is what is held.
    plain = TK.p2g_fused_reference(tp.grid, ts, k.ts.ints, DT, k.ts.structure.num_chunks)
    assert np.abs(plain.numpy() - img_j).max() > 0.1 * np.abs(img_j).max()
    with pytest.raises(ValueError):
        TK.p2g_fused(tp.grid, BlockConfig(**CFG), meta, ts, k.ts.ints, DT,
                     k.ts.structure.num_chunks)


def test_kernel_b_matches_pallas(packed):
    """Kernel B (plain) against the JAX g2p_fused on the windows of
    numpy-seeded node fields (the JAX side gathers them, the wrapper reads
    them at the chunks' corners), on occupied lanes. Fluids: F00 += tr(∇v)·dt·F00 and the rest of F kept,
    no SVD, no |F00| guard, the EOS dt bound, zero stress rows. Tolerances
    of tests/test_torch_kernels.py: kinematics, dt bound and drift 1e-5 of
    each row's scale; F, stress, energy and plastic rows 2e-5 (the cardano
    SVD's floor on solid lanes); the failed row exact. F00 of fluids in
    strain units within 1e-6."""
    k = packed
    rng = np.random.default_rng(9)
    fields = rng.normal(scale=0.5, size=(CFG["max_grid_blocks"] + 1, 3 * 64)).astype(np.float32)
    windows = JT.gather_grid_windows(k.grid, k.jpipe._cfg, k.js.structure, jnp.asarray(fields),
                                     cell_order=JT.ZMAJOR_ORDER_3D)
    out_j = np.asarray(JK.g2p_fused(
        k.grid, k.jpipe._cfg, k.jpipe._meta, k.jpipe._kparams, k.js.slots, k.js.ints,
        windows, jnp.float32(DT), k.jpipe._tab_f, k.jpipe._tab_i,
        interpret=True, nchunks=k.js.structure.num_chunks))
    tp = k.tpipe
    out_t = TK.g2p_fused(tp.grid, BlockConfig(**CFG), TK.kernel_meta(tp.models, tp.params),
                         tp._kparams, k.ts.slots, k.ts.ints, torch.tensor(fields),
                         tp._corners(k.ts), DT, tp._tab_f, tp._tab_i,
                         k.ts.structure.num_chunks).numpy()
    occ = _occupied(k.js)
    out_t = np.where(occ[:, None, :], out_t, 0.0)
    out_j = np.where(occ[:, None, :], out_j, 0.0)
    r = TL.Rows(3)
    loose = set(range(r.defgrad, r.defgrad + 9)) | set(range(r.stress, r.stress + 6)) | {
        r.psi_pos, r.par1, r.pdd, r.ph, r.lvg}
    np.testing.assert_array_equal(out_t[:, r.failed], out_j[:, r.failed])
    for row in range(r.nf):
        if row == r.failed:
            continue
        scale = max(np.abs(out_j[:, row]).max(), 1e-30)
        err = np.abs(out_t[:, row] - out_j[:, row]).max() / scale
        assert err <= (2e-5 if row in loose else 1e-5), (row, err)

    mid = np.asarray(k.js.ints)[:, TL.I_MODEL, :]
    fluid = occ & (mid == 0)
    f00 = out_t[:, r.defgrad]
    np.testing.assert_allclose(f00[fluid], out_j[:, r.defgrad][fluid], rtol=0, atol=1e-6)
    assert np.abs(f00[fluid] - k.ts.slots.numpy()[:, r.defgrad][fluid]).max() > 1e-4  # J moved
    assert not out_t[:, r.stress : r.stress + 6][np.broadcast_to(fluid[:, None], (
        fluid.shape[0], 6, fluid.shape[1]))].any()  # fluids leave the cache rows zero
    if k.mixed:
        solid = occ & (mid == 1)
        assert np.abs(out_t[:, r.stress][solid]).max() > 0


def test_volume_pass_matches_jax(packed):
    """_recompute_fluids + _refresh_dtb_rows against the JAX methods on the
    same state: F00 = V/V0 of active fluid slots in strain units (relative
    to J) within 3e-6 (the mass images sum in another order), the refreshed
    dt-bound row within rtol 1e-4 except on fluid slots with J within 1e-3
    of 1 (at most 2% of them; there the EOS bound divides two rounded
    quantities near zero and its rounding is unbounded), every other row
    untouched."""
    k = packed
    js, _ = jax.jit(k.jpipe._recompute_fluids)(k.js)
    before = k.ts.slots.clone()
    ts = k.tpipe._recompute_fluids(k.ts)
    r = TL.Rows(3)
    occ = _occupied(k.js)
    out_j, out_t = np.asarray(js.slots), ts.slots.numpy()
    f00_j, f00_t = out_j[:, r.defgrad][occ], out_t[:, r.defgrad][occ]
    np.testing.assert_allclose(f00_t, f00_j, rtol=3e-6, atol=0)
    assert f00_t.min() < 0.9 and f00_t.max() > 1.1
    fluid = occ & (np.asarray(k.js.ints)[:, TL.I_MODEL, :] == 0)
    near1 = fluid & (np.abs(out_t[:, r.defgrad] - 1.0) < 1e-3)
    assert near1.sum() <= 0.02 * occ.sum()
    held = occ & ~near1
    np.testing.assert_allclose(out_t[:, r.dtb][held], out_j[:, r.dtb][held], rtol=1e-4)
    others = [row for row in range(r.nf) if row not in (r.defgrad, r.dtb)]
    assert torch.equal(ts.slots[:, others], before[:, others])


def test_fluid_substep_across_a_resort_keeps_the_reference_order(packed):
    """A fluid substep that resorts. The pipeline runs the volume pass
    before its one host read, then, as the read calls for a resort, the
    resort and the volume pass again; the result must be bit-equal to the
    JAX package's order run by hand on a copy (resort, volume pass, dt from
    the refreshed bound, substep). Every particle is moved 1.5 cells in x
    first, so that the resort changes the structure and the first volume
    pass, on the old windows, is wrong."""
    k = packed
    pipe = k.tpipe
    r = TL.Rows(3)
    f32 = np.float32

    def moved():
        slots = k.ts.slots.clone()
        slots[:, r.pos] += 1.5 * pipe.grid.cell_width
        return k.ts.replace(slots=slots, cum_disp=torch.tensor(1.0e3))

    remaining = f32(pipe.params.dt)
    got, rem, resorted, flags = pipe._step_body(moved(), remaining)
    assert resorted and flags == 0
    ref, flags = pipe._resort(moved())
    assert flags == 0
    assert not torch.equal(ref.structure.chunk_origin, k.ts.structure.chunk_origin)
    ref = pipe._recompute_fluids(ref)
    dt = min(f32(pipe._min_dtb(ref)), remaining, f32(pipe.params.max_substep_dt))
    min_dt = f32(pipe.params.dt / pipe.params.max_num_substeps)
    if dt < min_dt and remaining > min_dt:
        dt = min_dt
    ref = pipe._substep(ref, float(dt))
    assert rem == f32(remaining - dt)
    assert torch.equal(got.ints, ref.ints)
    assert torch.equal(got.slots, ref.slots)


def test_one_blob_frame_matches_jax_fused_pipeline():
    """One frame of the (fluid) blob, port fused against JAX fused (scatter
    merge not pinned: no block holds more than 8 chunks), with the
    tolerances of tests/test_torch_slice.py (tests/test_fused.py::_compare)
    and equal substeps."""
    grid, jm, jp = _blob(False)
    params = JSolverParameters(dt=1.0 / 60.0, force_fluids_volume_recomputation=True)
    jpipe = JPipeline(grid, jm, (), params, config=JBlockConfig(**CFG), use_pallas="interpret")
    pj, nj = jpipe.step_with_stats(jp)
    particles = interop.particles_from_numpy({k: np.asarray(v) for k, v in vars(jp).items()},
                                             device="cpu")
    tparams = SolverParameters(dt=1.0 / 60.0, force_fluids_volume_recomputation=True)
    tpipe = FusedMpmPipeline(_port_grid(grid), _port_models(jm), (), tparams,
                             config=BlockConfig(**CFG), device="cpu")
    pt, nt = tpipe.step_with_stats(particles)
    assert nt == int(nj) and nt > 5
    act = np.asarray(pj.active)
    np.testing.assert_array_equal(pt.active.numpy(), act)
    np.testing.assert_allclose(pt.position.numpy()[act], np.asarray(pj.position)[act], atol=5e-5)
    np.testing.assert_allclose(pt.velocity.numpy()[act], np.asarray(pj.velocity)[act], atol=5e-4)
    np.testing.assert_allclose(pt.deformation_gradient.numpy()[act],
                               np.asarray(pj.deformation_gradient)[act], atol=5e-4)
    np.testing.assert_array_equal(pt.failed.numpy()[act], np.asarray(pj.failed)[act])
    assert np.abs(pt.velocity.numpy()[act]).max() > 0.5  # the blob expands


def test_golden_fluids3_first_frames():
    """Replays frames 0-2 of tests/golden_scenes.json's fluids3 (made by the
    JAX dense pipeline; the JAX fused pipeline meets frames 0-2 too) on the
    port's fused pipeline, with the bounds of
    tests/test_regression.py::_replay for fused pipelines and mass
    conservation to rtol 1e-6."""
    gold = GOLD["fluids3"]
    b = tscenes.build("fluids3", device="cpu", **gold["config"])
    pipe = FusedMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity, device="cpu")
    p = b.particles
    act0 = p.active.numpy()
    per_mass = p.mass.numpy()
    mass0 = float(per_mass[act0].sum())
    n0 = int(act0.sum())
    for rec in gold["frames"][:3]:
        p, niter = pipe.step_with_stats(p)
        frame = rec["frame"]
        assert abs(int(niter) - rec["substeps"]) <= 1, f"frame {frame} substeps"
        act = p.active.numpy()
        pos = p.position.numpy()[act]
        vel = p.velocity.numpy()[act]
        mass = p.mass.numpy()[act]
        deact = float(per_mass[act0 & ~act].sum())
        np.testing.assert_allclose(float(mass.sum()), mass0 - deact, rtol=1e-6)
        np.testing.assert_allclose(pos.mean(0), rec["com"], atol=3e-3, rtol=1e-3)
        np.testing.assert_allclose(pos.min(0), rec["pos_min"], atol=8e-3, rtol=1e-3)
        np.testing.assert_allclose(pos.max(0), rec["pos_max"], atol=8e-3, rtol=1e-3)
        ke = float(0.5 * np.sum(mass[:, None] * vel**2))
        np.testing.assert_allclose(ke, rec["ke"], rtol=3e-2, atol=1e-8)
        slack = max(2, int(0.02 * n0))
        assert abs(int(p.failed.numpy()[act].sum()) - rec["failed"]) <= slack
        assert abs(int((p.phase.numpy()[act] == 0.0).sum()) - rec["broken"]) <= slack
    assert pipe._merge_force_scatter  # the 32-chunk blocks pinned the scatter merge
