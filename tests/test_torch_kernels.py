"""The plain versions of the port's five kernels against the JAX package's
Pallas kernels in interpret mode (p2g_fused, merge_blocks_dma with the
inverse-corner gather after it, g2p_fused,
src_rows_from_order, and permute_chunks_dma for the port's permute_slots),
on sand3 at nx=12, ny=6, nz=6 with an explicit small BlockConfig; plus the
wrappers' CPU routing, launch counting and argument checks.

The CUDA kernels themselves run only on the card: chip_smoke.py holds
each against its plain version there at the main path's shapes.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparkl_tpu.scenes as jscenes
from sparkl_tpu.fused import kernels as JK
from sparkl_tpu.fused.pipeline import FusedMpmPipeline as JPipeline
from sparkl_tpu.sparse import transfer as JT
from sparkl_tpu.sparse.blocks import BlockConfig as JBlockConfig

from sparkl_tpu_torch import interop
from sparkl_tpu_torch.core.params import DamageModel, SolverParameters
from sparkl_tpu_torch.fused import kernels as TK
from sparkl_tpu_torch.fused import layout as TL
from sparkl_tpu_torch.sparse import transfer as TT
from sparkl_tpu_torch.sparse.blocks import BlockConfig

torch.set_num_threads(1)

CFG = dict(max_blocks=64, max_chunks=32, chunk_size=128, max_grid_blocks=128)
DT = 1.0e-3


@pytest.fixture(scope="module")
def state():
    """A packed JAX state of sand3 with random (numpy-seeded) velocities,
    velocity gradients and deformation gradients, so that stress, affine
    transfer and plastic flow are all non-trivial; as numpy and torch."""
    b = jscenes.build("sand3", nx=12, ny=6, nz=6)
    rng = np.random.default_rng(7)
    n = b.particles.capacity
    p = b.particles.replace(
        velocity=jnp.asarray(rng.normal(scale=0.5, size=(n, 3)).astype(np.float32)),
        velocity_gradient=jnp.asarray(rng.normal(scale=2.0, size=(n, 3, 3)).astype(np.float32)),
        deformation_gradient=jnp.asarray(
            (np.eye(3) + 0.02 * rng.normal(size=(n, 3, 3))).astype(np.float32)),
    )
    jcfg = JBlockConfig(**CFG)
    pipe = JPipeline(b.grid, b.models, b.colliders, b.params, b.gravity,
                     config=jcfg, use_pallas="interpret")
    pipe._ensure_cfg(p)
    js = pipe._jit_pack(p)
    m = b.models
    models_t = interop.modelset_from_numpy(m.ctype, m.cparams, m.ptype, m.pparams, m.ftype,
                                           m.fparams, device="cpu")
    t = dict(
        slots=torch.tensor(np.asarray(js.slots)),
        ints=torch.tensor(np.asarray(js.ints)),
        nchunks=torch.tensor(np.asarray(js.structure.num_chunks)),
        first=torch.tensor(np.asarray(js.structure.block_first_chunk)),
        nblk=torch.tensor(np.asarray(js.structure.block_num_chunks)),
        meta=TK.kernel_meta(models_t, SolverParameters()),
        corners=TT._chunk_corners(SimpleNamespace(
            nbr_index=torch.tensor(np.asarray(js.structure.nbr_index)),
            chunk_block=torch.tensor(np.asarray(js.structure.chunk_block)))).contiguous(),
    )
    t["tab_f"], t["tab_i"] = TK.pack_model_tables(models_t)
    return b, pipe, js, t


def test_p2g_fused_reference_matches_pallas(state):
    b, pipe, js, t = state
    img_j = np.asarray(JK.p2g_fused(
        b.grid, pipe._cfg, pipe._meta, js.slots, js.ints, jnp.float32(DT),
        pipe._tab_f, pipe._tab_i, interpret=True, nchunks=js.structure.num_chunks,
    ))
    TK.reset_launch_counts()
    img_t = TK.p2g_fused(b.grid, BlockConfig(**CFG), t["meta"], t["slots"], t["ints"],
                         DT, t["nchunks"]).numpy()
    assert TK.LAUNCHES["p2g_fused"] == 0  # the CPU path launches no kernel
    assert img_t.shape == img_j.shape == (CFG["max_chunks"], 4, 512)
    # Same per-slot terms summed in another order (27 taps per slot vs the
    # kernel's factored dots): rtol 1e-5, atol 1e-6 of the image's scale.
    np.testing.assert_allclose(img_t, img_j, rtol=1e-5, atol=1e-6 * np.abs(img_j).max())
    live = int(t["nchunks"])
    assert np.abs(img_t[:live, 1:]).max() > 0 and not img_t[live:].any()


def test_merge_blocks_reference_bit_equal_to_pallas(state):
    """The gather-form merge on z-major window images (merge_blocks' plain
    version: the cell permutation, the segment sums, the inverse-corner
    gather) against the JAX package's Pallas merge_blocks_dma in interpret
    mode on the same images' (chunk, corner) rows, then its inverse-corner
    gather (sparkl_tpu/sparse/transfer.py:_merge_gather), over the JAX
    package's own packed structure: bit-equal on every row but the trash
    row, which the port zeroes."""
    _, pipe, js, t = state
    cfg = BlockConfig(**CFG)
    rng = np.random.default_rng(8)
    images = rng.normal(size=(CFG["max_chunks"], 4, 512)).astype(np.float32)
    images[int(t["nchunks"]):] = 0.0
    jst = js.structure
    comb = TT._merge_comb(3, 4, True, torch.device("cpu")).numpy()
    rows = images.reshape(CFG["max_chunks"], -1)[:, comb].reshape(CFG["max_chunks"], 8, 256)
    blk = np.asarray(JK.merge_blocks_dma(
        pipe._cfg, jnp.asarray(rows), jst.block_first_chunk, jst.block_num_chunks, 8,
        interpret=True,
    ))
    blk = np.concatenate([blk, np.zeros((1, 8, 256), np.float32)])
    structure = SimpleNamespace(nbr_index=torch.tensor(np.asarray(jst.nbr_index)))
    owner = TT.corner_owner(cfg, structure)
    out_j = np.zeros((CFG["max_grid_blocks"] + 1, 256), np.float32)
    for k in range(8):
        out_j = out_j + blk[owner[:, k].numpy(), k]
    TK.reset_launch_counts()
    out_t = TK.merge_blocks(torch.tensor(images), t["first"], t["nblk"], owner,
                            torch.tensor(np.asarray(jst.num_grid_blocks)), True).numpy()
    assert TK.LAUNCHES["merge_blocks"] == 0
    # Both sum each block's chunk rows in ascending order from zero, then
    # the corners in ascending order from zero.
    np.testing.assert_array_equal(out_t[:-1], out_j[:-1])
    assert not out_t[-1].any() and np.abs(out_t).max() > 0
    assert int(t["nblk"].max()) > 1  # some block sums several chunks


@pytest.mark.parametrize("c", [64, 128])
def test_src_rows_from_order_reference_matches_pallas(state, c):
    """At both chunk sizes (2D and 3D), on slices at shifts 0, 1 and C - 1,
    whole rows, and the last chunk clamped to the last row (both operand
    rows the last: source_order_rows clamps a start past D·C - C), among
    random slices of a random order."""
    _, pipe, _, _ = state
    d_ = CFG["max_chunks"]
    rng = np.random.default_rng(10 + c)
    order = rng.permutation(d_ * c).astype(np.int32).reshape(d_, c)
    start = rng.integers(0, d_ * c - c + 1, size=d_).astype(np.int32)
    start[:6] = [0, 1, c - 1, c, d_ * c - c, d_ * c - 1]
    start = np.minimum(start, d_ * c - c)  # the clamp of source_order_rows
    r0 = start // c
    order2 = order[np.stack([r0, np.minimum(r0 + 1, d_ - 1)], axis=1)]  # [D, 2, C]
    shifts = start % c
    assert {0, 1, c - 1} <= set(shifts.tolist()) and (r0 == d_ - 1).sum() >= 2
    out_j = np.asarray(JK.src_rows_from_order(
        pipe._cfg, jnp.asarray(order2), jnp.asarray(shifts), interpret=True))[:, 0, :]
    TK.reset_launch_counts()
    out_t = TK.src_rows_from_order(torch.tensor(order2), torch.tensor(shifts)).numpy()
    assert TK.LAUNCHES["src_rows_from_order"] == 0
    # Integer slot indices: exact, and equal to the slice of the flat order.
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(out_t, order.reshape(-1)[start[:, None] + np.arange(c)])


def _resort_args(d_=8, dim=2):
    """Valid CPU operands of the two resort wrappers: (src_rows_from_order's,
    permute_slots')."""
    c, nf = (64, TL.Rows(2).nf) if dim == 2 else (128, TL.Rows(3).nf)
    order2 = torch.arange(d_ * 2 * c, dtype=torch.int32).reshape(d_, 2, c)
    shifts = torch.arange(d_, dtype=torch.int32) % c
    slots = torch.arange(d_ * nf * c, dtype=torch.float32).reshape(d_, nf, c)
    ints = torch.arange(d_ * TL.NI * c, dtype=torch.int32).reshape(d_, TL.NI, c)
    src = torch.arange(d_ * c, dtype=torch.int32).flip(0).reshape(d_, c)
    origin = torch.zeros((d_, dim), dtype=torch.int32)
    return [order2, shifts], [slots, ints, src, origin, TL.Rows(dim).cumd]


def _faulty(t, fault):
    """`t` with one fault: another dtype, shape or device, or not contiguous
    (same shape and dtype)."""
    if fault == "dtype":
        return t.double() if t.is_floating_point() else t.long()
    if fault == "shape":
        return torch.cat([t, t[:1]])
    if fault == "device":
        return t.to("meta")
    return torch.stack([t, t], dim=-1)[..., 0]


def check_resort_wrapper(wrapper, arg, fault):
    """The body of test_resort_wrappers_check_arguments, whose cases this
    file (src_rows_from_order) and test_torch_resort_wrappers.py
    (permute_slots) share."""
    fn = getattr(TK, wrapper)
    args = _resort_args()[wrapper == "permute_slots"]
    TK.reset_launch_counts()
    ok = fn(*args)
    plain = getattr(TK, wrapper + "_reference")(*args)
    for a, b in zip(ok if isinstance(ok, tuple) else (ok,),
                    plain if isinstance(plain, tuple) else (plain,)):
        assert torch.equal(a, b)
    bad = list(args)
    bad[arg] = _faulty(args[arg], fault)
    if fault == "contiguous":
        assert not bad[arg].is_contiguous() and bad[arg].shape == args[arg].shape
    with pytest.raises(TypeError if fault == "dtype" else ValueError):
        fn(*bad)
    assert TK.LAUNCHES[wrapper] == 0


@pytest.mark.parametrize("fault", ["dtype", "shape", "device", "contiguous"])
@pytest.mark.parametrize("wrapper,arg", [("src_rows_from_order", 1)])
def test_resort_wrappers_check_arguments(wrapper, arg, fault):
    """The two resort wrappers (after their launch path was made cheaper)
    still raise on an operand of another dtype (TypeError), shape, device or
    a non-contiguous one (ValueError), and on the CPU run their plain
    versions and count no launch."""
    check_resort_wrapper(wrapper, arg, fault)


def _dma_routing(src, valid, k_src=8):
    """The JAX resort's routing of a mixed permute, in numpy: per
    destination its distinct source chunks (ascending, -1 unused) and per
    lane target = k·C + source lane (K·C: empty)."""
    d_, c = src.shape
    uniq = np.full((d_, k_src), -1, np.int32)
    target = np.full((d_, c), k_src * c, np.int32)
    for d in range(d_):
        chunks = np.unique(src[d][valid[d]] // c)
        uniq[d, : len(chunks)] = chunks
        k = np.searchsorted(chunks, src[d] // c)
        target[d] = np.where(valid[d], k * c + src[d] % c, k_src * c)
    return uniq, target


def test_permute_slots_reference_matches_pallas(state):
    _, pipe, _, _ = state
    d_, c = CFG["max_chunks"], CFG["chunk_size"]
    rng = np.random.default_rng(11)
    slots = rng.normal(size=(d_, TL.Rows(3).nf, c)).astype(np.float32)
    ints = rng.integers(-2**31, 2**31, size=(d_, TL.NI, c), dtype=np.int64).astype(np.int32)
    # Each destination draws its lanes from 1-4 random source chunks, with
    # a random count of valid lanes (some destinations empty).
    src = np.stack([rng.choice(rng.choice(d_, size=rng.integers(1, 5), replace=False), size=c)
                    * c + rng.integers(0, c, size=c) for _ in range(d_)]).astype(np.int32)
    count = rng.integers(0, c + 1, size=d_)
    count[:2] = [c, 0]
    valid = np.arange(c)[None, :] < count[:, None]
    origin = rng.integers(-4, 200, size=(d_, 3)).astype(np.int32)
    r_cumd = TL.Rows(3).cumd
    uniq, target = _dma_routing(src, valid)
    out_j = JK.permute_chunks_dma(
        pipe._cfg, jnp.asarray(slots), jnp.asarray(ints), jnp.asarray(uniq),
        jnp.asarray(target), jnp.asarray(origin), r_cumd, interpret=True)
    TK.reset_launch_counts()
    out_t = TK.permute_slots(torch.tensor(slots), torch.tensor(ints),
                             torch.tensor(np.where(valid, src, -1)), torch.tensor(origin), r_cumd)
    assert TK.LAUNCHES["permute_slots"] == 0
    # A lane permute moves values unchanged: bit-equal, f32 and int32 rows.
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (uniq >= 0).sum(axis=1).max() > 1  # some destination mixes chunks
    assert not out_t[0][1].any() and not out_t[1][1, TL.I_FLAGS].any()  # empty stays zero


def _row_groups():
    r = TL.Rows(3)
    f_rows = list(range(r.defgrad, r.defgrad + 9))
    stress_rows = list(range(r.stress, r.stress + 6))
    energy_rows = [r.psi_pos, r.par1]
    loose = set(f_rows + stress_rows + energy_rows + [r.pdd, r.ph, r.lvg])
    exact_rows = [r.failed]
    tight = [k for k in range(r.nf) if k not in loose and k not in exact_rows]
    return tight, sorted(loose), exact_rows


def test_g2p_fused_reference_matches_pallas(state):
    b, pipe, js, t = state
    rng = np.random.default_rng(9)
    # Node fields seeded per node-table block; the JAX side gathers its
    # windows from them, the wrapper reads them at the chunks' corners.
    fields = rng.normal(scale=0.5, size=(CFG["max_grid_blocks"] + 1, 3 * 64)).astype(np.float32)
    windows = JT.gather_grid_windows(b.grid, pipe._cfg, js.structure, jnp.asarray(fields),
                                     cell_order=JT.ZMAJOR_ORDER_3D)
    out_j = np.asarray(JK.g2p_fused(
        b.grid, pipe._cfg, pipe._meta, pipe._kparams, js.slots, js.ints,
        windows, jnp.float32(DT), pipe._tab_f, pipe._tab_i,
        interpret=True, nchunks=js.structure.num_chunks,
    ))
    slots_in = t["slots"].clone()
    TK.reset_launch_counts()
    out_t = TK.g2p_fused(b.grid, BlockConfig(**CFG), t["meta"], dict(gpu_velocity_clamp=False),
                         t["slots"], t["ints"], torch.tensor(fields), t["corners"], DT,
                         t["tab_f"], t["tab_i"], t["nchunks"]).numpy()
    assert TK.LAUNCHES["g2p_fused"] == 0
    assert torch.equal(t["slots"], slots_in)  # the CPU path writes a new tensor

    # Compared on occupied lanes. Empty lanes hold no particle: unpack,
    # resort and both kernels mask them, and their degenerate F = 0 return
    # map turns on the last bit of trace/3 (XLA and PyTorch round it
    # differently), so their scratch rows may differ.
    occ = (np.asarray(js.ints)[:, TL.I_FLAGS, :] & TL.OCCUPIED) != 0
    out_t = np.where(occ[:, None, :], out_t, 0.0)
    out_j = np.where(occ[:, None, :], out_j, 0.0)
    tight, loose, exact = _row_groups()
    np.testing.assert_array_equal(out_t[:, exact], out_j[:, exact])
    for rows, tol in ((tight, 1e-5), (loose, 2e-5)):
        for k in rows:
            scale = max(np.abs(out_j[:, k]).max(), 1e-30)
            err = np.abs(out_t[:, k] - out_j[:, k]).max() / scale
            # tight: kinematics, dt bound, drift (f32 rounding of sums in
            # another order); loose: F, stress, energy and the plastic state,
            # which pass through the cardano SVD (its f32 floor ~2e-5).
            assert err <= tol, (k, err)
    r = TL.Rows(3)
    live = int(t["nchunks"])
    moved = np.abs(out_t[:live, r.ph] - slots_in.numpy()[:live, r.ph]).max()
    assert moved > 0  # the Drucker-Prager return map applied somewhere


def test_wrappers_check_arguments(state):
    b, _, _, t = state
    cfg = BlockConfig(**CFG)
    with pytest.raises(TypeError):
        TK.p2g_fused(b.grid, cfg, t["meta"], t["slots"].double(), t["ints"], DT, t["nchunks"])
    with pytest.raises(TypeError):
        TK.p2g_fused(b.grid, cfg, t["meta"], t["slots"], t["ints"].long(), DT, t["nchunks"])
    owner = torch.zeros(CFG["max_grid_blocks"] + 1, 8, dtype=torch.int32)
    ngb = torch.zeros((), dtype=torch.int32)
    images = torch.zeros(CFG["max_chunks"], 4, 512)
    with pytest.raises(ValueError):
        TK.merge_blocks(images, t["first"][:-1], t["nblk"], owner, ngb, True)
    with pytest.raises(ValueError):  # z-major cells only in 3D
        TK.merge_scatter(torch.zeros(CFG["max_chunks"], 4, 64), torch.zeros(
            CFG["max_chunks"] * 4, dtype=torch.int32), torch.zeros(
            CFG["max_grid_blocks"] + 2, dtype=torch.int32), ngb, True)
    # The 3D cache-off form is carried, and forms the stress from the
    # model tables; CD-MPM and an unknown plastic type are not carried (3D
    # Rankine and NACC are, since the material slice).
    with pytest.raises(ValueError):
        TK.p2g_fused(b.grid, cfg, dict(t["meta"], stress_cache=False), t["slots"],
                     t["ints"], DT, t["nchunks"])
    with pytest.raises(NotImplementedError):
        TK.p2g_fused(b.grid, cfg, dict(t["meta"], present_p=(7,)), t["slots"],
                     t["ints"], DT, t["nchunks"])
    with pytest.raises(NotImplementedError):
        TK.g2p_fused(b.grid, cfg, dict(t["meta"], damage_model=int(DamageModel.CD_MPM)),
                     dict(gpu_velocity_clamp=False),
                     t["slots"], t["ints"], torch.zeros(CFG["max_grid_blocks"] + 1, 3 * 64),
                     t["corners"], DT, t["tab_f"], t["tab_i"], t["nchunks"])
    with pytest.raises(NotImplementedError):
        TK.merge_blocks(images.to("meta"), t["first"].to("meta"), t["nblk"].to("meta"),
                        owner.to("meta"), ngb.to("meta"), True)
    d_ = CFG["max_chunks"]
    with pytest.raises(TypeError):
        TK.src_rows_from_order(torch.zeros(d_, 2, 128, dtype=torch.int64),
                               torch.zeros(d_, dtype=torch.int32))
    with pytest.raises(ValueError):
        TK.permute_slots(t["slots"], t["ints"], torch.zeros(d_, 64, dtype=torch.int32),
                         torch.zeros(d_, 3, dtype=torch.int32), TL.Rows(3).cumd)
