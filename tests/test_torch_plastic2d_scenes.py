"""The port's 2D plastic scenes (elasticity2 and basic2) on the CPU against
the JAX package: both scene builds and the fused pipeline's pack with its
stress-cache seed, bit for bit; permute_chunks (plain) against the Pallas
kernel and against permute_slots; frame 0 of both scenes against the
goldens; the refusals of what the pipelines do not carry, and the CUDA
source's type codes and option bits against the Python modules'.
(test_torch_plastic2d.py holds the return maps and kernels A and B's 2D
plastic forms.)
"""

import json
import os
import re
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparkl_tpu.scenes as jscenes
from sparkl_tpu.fused import kernels as JK
from sparkl_tpu.fused.pipeline import FusedMpmPipeline as JPipeline
from sparkl_tpu.sparse.blocks import BlockConfig as JBlockConfig

import sparkl_tpu_torch as tsk
import sparkl_tpu_torch.scenes as tscenes
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.fused import kernels as TK
from sparkl_tpu_torch.fused import layout as TL
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
from sparkl_tpu_torch.models import plasticity as tplas
from sparkl_tpu_torch.models import registry as treg
from sparkl_tpu_torch.sparse.blocks import BlockConfig
from sparkl_tpu_torch.sparse.pipeline import SparseMpmPipeline

from test_torch_plastic2d import E, NU, R2, _np, _t

torch.set_num_threads(1)

GOLD = json.load(open(os.path.join(os.path.dirname(__file__), "golden_scenes.json")))


@pytest.fixture(scope="module", params=["elasticity2", "basic2"])
def scene(request):
    return request.param, jscenes.build(request.param), tscenes.build(request.param, device="cpu")


def test_scene_builds_bit_equal(scene):
    """Particles, grid, model tables, colliders and parameters of the port's
    build, bit for bit the JAX package's (elasticity2's star centres from
    the same numpy generator at seed 42)."""
    name, jb, tb = scene
    assert tb.particles.capacity == {"elasticity2": 16000, "basic2": 11204}[name]
    for f in fields(tb.particles):
        a, b = getattr(tb.particles, f.name).numpy(), _np(getattr(jb.particles, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert tb.grid == GridParams(jb.grid.origin, jb.grid.cell_width, jb.grid.res)
    for k in ("ctype", "cparams", "ptype", "pparams", "ftype", "fparams"):
        np.testing.assert_array_equal(getattr(tb.models, k).numpy(), _np(getattr(jb.models, k)))
    assert len(tb.colliders) == len(jb.colliders)
    for tc, jc in zip(tb.colliders, jb.colliders):
        assert tc.shape_type == jc.shape_type
        for a, b in zip((*tc.data, tc.translation, tc.rotation),
                        (*jc.data, jc.translation, jc.rotation)):
            np.testing.assert_array_equal(a, b)
    assert (tb.params.dt, tb.params.max_num_substeps) == (jb.params.dt, jb.params.max_num_substeps)
    assert tuple(tb.gravity) == tuple(jb.gravity)


def test_pack_with_stress_cache_matches_jax(scene):
    """The fused pipeline's pack: ints, structure and slots bit-equal, the
    2D stress-cache rows (elasticity2 seeds them from F = I, basic2 has the
    cache off) and the dt-bound row too (the corotated bound's λ + 2µ/3
    formed as jitted XLA forms it: the product with f32(1/3), contracted
    into one FMA); and the grid cache's heightfield projections of every
    node (basic2) to 2e-6."""
    name, jb, tb = scene
    jpipe = JPipeline(jb.grid, jb.models, jb.colliders, jb.params, jb.gravity,
                      use_pallas="interpret")
    jpipe._ensure_cfg(jb.particles)
    jstate = jpipe._jit_pack(jb.particles)
    tpipe = tsk.auto_pipeline(tb, device="cpu")
    assert isinstance(tpipe, FusedMpmPipeline)
    assert tpipe._meta["stress_cache"] == jpipe._meta["stress_cache"] == (name == "elasticity2")
    tstate = tpipe.pack_state(tb.particles)
    assert tpipe._cfg == BlockConfig(**vars(jpipe._cfg))
    np.testing.assert_array_equal(tstate.ints.numpy(), _np(jstate.ints))
    a, b = tstate.slots.numpy(), _np(jstate.slots)
    np.testing.assert_array_equal(a, b)
    assert (a[:, R2.dtb] > 0).sum() == tb.particles.capacity
    for k, v in tstate.structure.tensors().items():
        np.testing.assert_array_equal(v.numpy(), _np(getattr(jstate.structure, k)), err_msg=k)
    if name == "basic2":
        (proj_j, in_j), = jstate.grid_cache[1]
        (proj_t, in_t), = tstate.grid_cache[1]
        np.testing.assert_array_equal(in_t.numpy(), _np(in_j))
        np.testing.assert_allclose(proj_t.numpy(), _np(proj_j), atol=2e-6)
        assert 0 < in_t.sum() < in_t.numel()


@pytest.mark.parametrize("dim", [2, 3])
def test_permute_chunks_matches_pallas_and_permute_slots(dim):
    """A resort-like routing (each destination chunk draws its slots from
    its own and its two neighbouring chunks, some lanes empty) on random
    slot rows: the plain lane router bit-equal to the Pallas kernel in
    interpret mode (0/1 selection matmuls, ints in exact 16-bit halves;
    the random rows hold no -0.0, which the matmul would turn into +0.0)
    and to permute_slots on the same per-slot source index (but the drift
    row and the window-origin rows, which only permute_slots finalizes),
    at C = 64 (2D) and C = 128 (3D)."""
    c = 64 if dim == 2 else 128
    r = TL.Rows(dim)
    d_ = 12
    rng = np.random.default_rng(49 + dim)
    slots = rng.normal(size=(d_, r.nf, c)).astype(np.float32)
    ints = rng.integers(-2**31, 2**31 - 1, size=(d_, TL.NI, c), dtype=np.int64).astype(np.int32)
    src = np.empty((d_, c), np.int64)
    for d in range(d_):
        chunks = np.clip(d + rng.integers(-1, 2, c), 0, d_ - 1)
        src[d] = chunks * c + rng.permutation(c)
    src[rng.uniform(size=src.shape) < 0.1] = -1
    src = _t(src.astype(np.int32))
    g, gi, tgt = TK.permute_chunks_operands(_t(slots), _t(ints), src)
    assert g.shape[1] == 3 and int((tgt < 3 * c).sum()) == int((src >= 0).sum())
    out_f, out_i = TK.permute_chunks(g, gi, tgt)
    jf, ji = JK.permute_chunks(JBlockConfig(max_blocks=16, max_chunks=d_, chunk_size=c,
                                            max_grid_blocks=16),
                               jnp.asarray(g.numpy()), jnp.asarray(gi.numpy()),
                               jnp.asarray(tgt.numpy()), interpret=True)
    assert torch.equal(out_f.view(torch.int32), _t(jf).view(torch.int32))
    assert torch.equal(out_i, _t(ji))
    origin = torch.zeros((d_, dim), dtype=torch.int32)
    ps_f, ps_i = TK.permute_slots(_t(slots), _t(ints), src, origin, r.cumd)
    keep = [k for k in range(r.nf) if k != r.cumd]
    assert torch.equal(out_f[:, keep].view(torch.int32), ps_f[:, keep].view(torch.int32))
    other = [k for k in range(TL.NI) if not TL.I_ORIGIN <= k < TL.I_ORIGIN + dim]
    assert torch.equal(out_i[:, other], ps_i[:, other])
    empty = (src < 0)[:, None, :]
    assert not out_f.masked_select(empty).any() and out_f.abs().sum() > 0
    # Any K: the same routing with two more (zero) source chunks, K = 5.
    g5 = torch.cat([g, torch.zeros_like(g[:, :2])], dim=1)
    gi5 = torch.cat([gi, torch.zeros_like(gi[:, :2])], dim=1)
    out5 = TK.permute_chunks(g5, gi5, torch.where(tgt < 3 * c, tgt, 5 * c))
    assert torch.equal(out5[0], out_f) and torch.equal(out5[1], out_i)


@pytest.mark.parametrize("name", ["elasticity2", "basic2"])
def test_frame0_matches_golden(name):
    """Frame 0 of each scene as published (elasticity2: 16,000 particles,
    47 substeps; basic2: 11,204, 25) through auto_pipeline -> pack_state ->
    run_frames_state -> unpack_state on the CPU, against
    tests/golden_scenes.json with tests/test_regression.py's tolerances for
    the fused pipeline (substeps within one, centre of mass atol 3e-3, box
    8e-3, kinetic energy rtol 3e-2, failed and broken counts within 2%) and
    its mass conservation (rtol 1e-6)."""
    gold = GOLD[name]
    assert gold["config"] == {}
    rec = gold["frames"][0]
    b = tscenes.build(name, device="cpu")
    pipe = tsk.auto_pipeline(b, device="cpu")
    state = pipe.pack_state(b.particles)
    state, substeps = pipe.run_frames_state(state, 1)
    p = pipe.unpack_state(state)
    assert abs(substeps - rec["substeps"]) <= 1
    act0, act = b.particles.active.numpy(), p.active.numpy()
    mass0 = float(b.particles.mass.numpy()[act0].sum())
    deact = float(b.particles.mass.numpy()[act0 & ~act].sum())
    mass = float(p.mass.numpy()[act].sum())
    np.testing.assert_allclose(mass, mass0 - deact, rtol=1e-6)
    pos, vel = p.position.numpy()[act], p.velocity.numpy()[act]
    np.testing.assert_allclose(pos.mean(0), rec["com"], atol=3e-3, rtol=1e-3)
    np.testing.assert_allclose(pos.min(0), rec["pos_min"], atol=8e-3, rtol=1e-3)
    np.testing.assert_allclose(pos.max(0), rec["pos_max"], atol=8e-3, rtol=1e-3)
    ke = float(0.5 * np.sum(p.mass.numpy()[act][:, None] * vel**2))
    np.testing.assert_allclose(ke, rec["ke"], rtol=3e-2, atol=1e-8)
    slack = max(2, int(0.02 * int(act0.sum())))
    assert abs(int(p.failed.numpy()[act].sum()) - rec["failed"]) <= slack
    assert abs(int((p.phase.numpy()[act] == 0.0).sum()) - rec["broken"]) <= slack


def test_pipelines_refuse_what_they_do_not_carry():
    """Both pipelines carry Rankine and Snow in 3D and the 2D plastic scenes
    (the fused one since the material slice, the sparse one since the 2D
    slice: tests/test_torch_sparse2d.py holds its path) and 2D NACC, and
    both refuse an unknown plastic type."""
    b = tscenes.build("sand3", nx=4, ny=2, nz=2, device="cpu")
    el = treg.corotated_linear_elasticity(E, NU)
    for spec in (treg.rankine_plasticity(E, NU, 1.0e2, 5.0), treg.snow_plasticity()):
        ms = treg.ModelSet.pack([treg.ParticleModel(el, spec)], "cpu")
        SparseMpmPipeline(b.grid, ms, b.colliders, b.params, device="cpu")
        FusedMpmPipeline(b.grid, ms, b.colliders, b.params, device="cpu")
    e2 = tscenes.build("elasticity2", device="cpu")
    nacc = treg.ModelSet.from_tables([0], [[1.0, 1.0, 0.5, 1.0]], [2], np.ones((1, 8)), [0],
                                     np.zeros((1, 2)), "cpu")
    for pipeline in (FusedMpmPipeline, SparseMpmPipeline):
        pipeline(e2.grid, nacc, e2.colliders, e2.params, device="cpu")
    unknown = treg.ModelSet.from_tables([0], [[1.0, 1.0, 0.5, 1.0]], [7], np.ones((1, 8)), [0],
                                        np.zeros((1, 2)), "cpu")
    for pipeline in (FusedMpmPipeline, SparseMpmPipeline):
        with pytest.raises(NotImplementedError):
            pipeline(e2.grid, unknown, e2.colliders, e2.params, device="cpu")
    for name in ("elasticity2", "basic2"):
        b2 = tscenes.build(name, device="cpu")
        assert isinstance(tsk.auto_pipeline(b2, prefer="sparse", device="cpu"),
                          SparseMpmPipeline)


def test_cuda_model_codes_match():
    """The type codes and kernel B's option bits the CUDA source branches
    on are the Python modules' (the wrapper passes clamp | 2·cache |
    4·svd_reuse | 8·modified | 16·material form)."""
    from sparkl_tpu_torch.models import constitutive as tcon
    from sparkl_tpu_torch.models import failure as tfail

    path = os.path.join(os.path.dirname(TK.__file__), "..", "csrc", "fused_kernels.cu")
    with open(path) as fh:
        consts = dict((k, int(v)) for k, v in
                      re.findall(r"constexpr int (\w+) = (\d+);", fh.read()))
    assert (consts["COROTATED"], consts["EOS_MONAGHAN_SPH"]) == (tcon.COROTATED,
                                                                 tcon.EOS_MONAGHAN_SPH)
    assert (consts["DRUCKER_PRAGER"], consts["RANKINE"], consts["SNOW"]) == (
        tplas.DRUCKER_PRAGER, tplas.RANKINE, tplas.SNOW)
    assert (consts["NEO_HOOKEAN"], consts["NACC"]) == (tcon.NEO_HOOKEAN, tplas.NACC)
    assert consts["MAXIMUM_STRESS"] == tfail.MAXIMUM_STRESS
    assert (consts["OPT_CLAMP"], consts["OPT_STRESS_CACHE"], consts["OPT_SVD_REUSE"]) == (1, 2, 4)
    assert (consts["OPT_MODIFIED"], consts["OPT_MATS"]) == (8, 16)
