"""Kernel B's window read and row table (csrc/fused_kernels.cu
g2p_fused_kernel), on the CPU.

The kernel reads the window fields [MAX_GRID_BLOCKS + 1, n · 4^d] at each
chunk's 2^d corner blocks itself: its prologue copies the corner rows into
shared memory block-major, and each tap reads window coordinate (x, y, z)
at corner block (x>>2, y>>2, z>>2), cell (x&3, y&3, z&3). Its warps move
only the slot rows their lanes' classes read or may change (the row table,
fused/kernels.py B_ROWS, the same as the source's SPARKL_B_ROWS). These
tests mirror the addressing in plain torch against the window gathers, hold
the row table against the plain version's outputs on reduced scenes (and
show that a wrong entry fails), check the source's table against the
Python one, and hold the wrapper's CPU route on fields and corners to the
JAX package's gather and g2p_fused in interpret mode.
"""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sparkl_tpu.scenes as jscenes
from sparkl_tpu.fused import kernels as JK
from sparkl_tpu.fused.pipeline import FusedMpmPipeline as JPipeline
from sparkl_tpu.sparse import transfer as JT
from sparkl_tpu.sparse.blocks import BlockConfig as JBlockConfig

import chip_smoke
import sparkl_tpu_torch as tsk
import sparkl_tpu_torch.scenes as tscenes
from sparkl_tpu_torch.fused import kernels as TK
from sparkl_tpu_torch.fused import layout as TL
from sparkl_tpu_torch.sparse import transfer as TT
from sparkl_tpu_torch.sparse.blocks import BlockConfig

torch.set_num_threads(1)

CFG3 = dict(max_blocks=64, max_chunks=32, chunk_size=128, max_grid_blocks=128)


def prologue_windows(dim, fields, corners, nw):
    """Kernel B's prologue and tap addressing in plain torch: each chunk's
    corner rows' first nw channels staged one after another (a corner
    block's stride nw · 4^d), then every window cell, in the kernels' cell
    order (z-major q = z·64 + x·8 + y in 3D, q = x·8 + y in 2D), read at its
    block-major offset. Returns [D, nw, 8^d]."""
    cpb = 4**dim
    stride = nw * cpb
    stage = fields[corners.long()][:, :, :stride].reshape(corners.shape[0], -1)
    q = np.arange(8**dim)
    if dim == 3:
        x, y, z = (q >> 3) & 7, q & 7, q >> 6
        off = ((x >> 2) * 4 * stride + (x & 3) * 16 + (y >> 2) * 2 * stride + (y & 3) * 4
               + (z >> 2) * stride + (z & 3))
    else:
        x, y = q >> 3, q & 7
        off = (x >> 2) * 2 * stride + (x & 3) * 4 + (y >> 2) * stride + (y & 3)
    idx = torch.from_numpy(off[None, :] + cpb * np.arange(nw)[:, None])
    return stage[:, idx]


def _substep_inputs(pipe, state):
    """(fields, corners, dt) of the state's next substep, as the fused
    path forms them on the CPU."""
    dt = float(pipe._min_dtb(state))
    images = TK.p2g_fused(pipe.grid, pipe._cfg, pipe._meta, state.slots, state.ints, dt,
                          state.structure.num_chunks, (pipe._tab_f, pipe._tab_i))
    return pipe._node_fields(state, images, dt), pipe._corners(state), dt


@pytest.fixture(scope="module")
def states():
    """Reduced scenes on the fused path, packed (the solids' F and
    velocities perturbed so that their maps and trips act): sand3
    (Drucker-Prager), fluids3 (EOS), materials3 (a lattice a band:
    neo-Hookean + NACC, Rankine, Snow, Drucker-Prager; and its failure form)
    and l_panel3 (eigenerosion with maximum stress; and modified
    eigenerosion)."""
    out = {}
    builders = {
        "sand3": lambda: tscenes.build("sand3", nx=12, ny=6, nz=6, device="cpu"),
        "fluids3": lambda: tscenes.build("fluids3", device="cpu"),
        "materials3": lambda: chip_smoke.materials3(scale=chip_smoke.MATERIALS3_SMALL,
                                                    device="cpu"),
        "materials3-failure": lambda: chip_smoke.materials3(
            scale=chip_smoke.MATERIALS3_SMALL, failure=True, device="cpu"),
        "l_panel3": lambda: chip_smoke.l_panel3(scale=chip_smoke.LPANEL3_SMALL,
                                                layers=chip_smoke.LPANEL3_SMALL_LAYERS,
                                                device="cpu"),
        "l_panel3-modified": lambda: chip_smoke.l_panel3(
            "modified", scale=chip_smoke.LPANEL3_SMALL, layers=chip_smoke.LPANEL3_SMALL_LAYERS,
            device="cpu"),
    }
    for name, build in builders.items():
        b = build()
        pipe = tsk.auto_pipeline(b, device="cpu")
        p = b.particles
        if name != "fluids3":
            p = chip_smoke.perturbed_particles(p, f_scale=0.02)
        out[name] = (pipe, pipe.pack_state(p))
    return out


def test_prologue_addressing_matches_window_gathers(states):
    """The kernel's block-major addressing gives the port's and the JAX
    package's gather_grid_windows bit for bit: 3D z-major with the velocity
    channels and with the psi channel, and 2D, on numpy-seeded fields over
    packed structures."""
    rng = np.random.default_rng(3)
    pipe, state = states["l_panel3"]
    b2 = tscenes.build("fluids2", n=40, device="cpu")
    pipe2 = tsk.auto_pipeline(b2, device="cpu")
    state2 = pipe2.pack_state(b2.particles)
    for pipe, state, nw in ((pipe, state, 3), (pipe, state, 4), (pipe2, state2, 2)):
        dim, cfg, st = pipe.grid.dim, pipe._cfg, state.structure
        fields = torch.from_numpy(rng.normal(size=(cfg.max_grid_blocks + 1, nw * 4**dim))
                                  .astype(np.float32))
        order = TT.ZMAJOR_ORDER_3D if dim == 3 else None
        port = TT.gather_grid_windows(pipe.grid, cfg, st, fields, order)
        jst = SimpleNamespace(nbr_index=jnp.asarray(st.nbr_index.numpy()),
                              chunk_block=jnp.asarray(st.chunk_block.numpy()))
        jax_w = np.asarray(JT.gather_grid_windows(
            pipe.grid, JBlockConfig(**vars(cfg)), jst, jnp.asarray(fields.numpy()),
            cell_order=JT.ZMAJOR_ORDER_3D if dim == 3 else None))
        mirror = prologue_windows(dim, fields, pipe._corners(state), nw)
        live = int(st.num_chunks)
        assert live > 0 and mirror.shape == port.shape == (cfg.max_chunks, nw, 8**dim)
        assert torch.equal(mirror[:live].view(torch.int32), port[:live].view(torch.int32))
        np.testing.assert_array_equal(port.numpy().view(np.int32), jax_w.view(np.int32))
        assert torch.equal(pipe._corners(state), TT._chunk_corners(st))


def test_row_table_holds_on_plain_version(states):
    """Every slot row that the row table marks unchanged for a lane's
    classes is bit-equal to its input after the plain version, on every
    lane of the reduced scenes (and every row of a dead chunk); the rows it
    marks for the maps, the trips and the solids do change somewhere. A
    deliberately wrong entry (ph unchanged under Drucker-Prager, F's off-J
    entries unchanged on solids) fails the check."""
    changed = {}
    for name, (pipe, state) in states.items():
        fields, corners, dt = _substep_inputs(pipe, state)
        out = TK.g2p_fused(pipe.grid, pipe._cfg, pipe._meta, pipe._kparams, state.slots,
                           state.ints, fields, corners, dt, pipe._tab_f, pipe._tab_i,
                           state.structure.num_chunks)
        nch = state.structure.num_chunks
        same = out.view(torch.int32) == state.slots.view(torch.int32)
        kept = TK.b_unchanged(pipe._meta, pipe._tab_i, state.ints, out, nch)
        assert bool(same[kept].all()), name
        r = TL.Rows(pipe.grid.dim)
        for field in ("ph", "pdd", "eh", "nacc", "phase", "defgrad_off"):
            rows = TK.b_field_rows(pipe.grid.dim)[field]
            changed[field] = changed.get(field, 0) + int((~same[:, rows]).sum())
        if name == "sand3":
            for wrong in ({"ph": (TK.LC_DP, TK.LC_RANKINE)},
                          {"defgrad_off": (TK.LC_ALL, TK.LC_BROKEN)}):
                table = dict(TK.B_ROWS, **wrong)
                bad = TK.b_unchanged(pipe._meta, pipe._tab_i, state.ints, out, nch, table)
                assert not bool(same[bad].all()), wrong
        if name == "fluids3":
            # EOS lanes keep F's off-J entries, phase and the plastic rows.
            assert bool(same[:, r.defgrad + 1].all()) and bool(same[:, r.ph].all())
    assert all(v > 0 for v in changed.values()), changed


def test_cuda_row_table_matches_python():
    """The source's SPARKL_B_ROWS and lane-class bits are B_ROWS and the
    LC_* constants of fused/kernels.py."""
    path = os.path.join(os.path.dirname(TK.__file__), "..", "csrc", "fused_kernels.cu")
    with open(path) as fh:
        src = fh.read()
    consts = dict((k, int(v)) for k, v in re.findall(r"constexpr int (LC_\w+) = (\d+);", src))
    for k, v in consts.items():
        assert v == (0 if k == "LC_NONE" else getattr(TK, k)), k
    table = src[src.index("#define SPARKL_B_ROWS(X)"):]
    table = table[:table.index("\n\n")]
    rows = re.findall(r"X\((\w+), ([\w| ]+), ([\w| ]+)\)", table)

    def bits(expr):
        return sum(consts[t.strip()] for t in expr.split("|"))

    assert {name.lower(): (bits(rd), bits(wr)) for name, rd, wr in rows} == {
        "mc" if k == "m_c" else k: v for k, v in TK.B_ROWS.items()}


def test_wrapper_cpu_route_matches_jax(states):
    """The wrapper's CPU route on window fields and corners (numpy-seeded
    fields over reduced sand3's packed structure) against the JAX package's
    gather_grid_windows and g2p_fused in interpret mode on the same slots:
    the rows within test_torch_kernels.py's tolerances on occupied lanes
    (kinematics, dt bound and drift 1e-5 of each row's scale; F, stress,
    energy and plastic rows 2e-5, the cardano SVD's floor), failed equal;
    F and the velocities perturbed from a numpy seed, as there."""
    b = jscenes.build("sand3", nx=12, ny=6, nz=6)
    jpipe = JPipeline(b.grid, b.models, b.colliders, b.params, b.gravity,
                      config=JBlockConfig(**CFG3), use_pallas="interpret")
    tb = tscenes.build("sand3", nx=12, ny=6, nz=6, device="cpu")
    tpipe = tsk.FusedMpmPipeline(tb.grid, tb.models, tb.colliders, tb.params, tb.gravity,
                                 config=BlockConfig(**CFG3), device="cpu")
    state = tpipe.pack_state(chip_smoke.perturbed_particles(tb.particles, f_scale=0.02,
                                                            v_scale=0.5))
    rng = np.random.default_rng(9)
    fields = rng.normal(scale=0.5, size=(CFG3["max_grid_blocks"] + 1, 3 * 64)).astype(np.float32)
    st = state.structure
    jst = SimpleNamespace(nbr_index=jnp.asarray(st.nbr_index.numpy()),
                          chunk_block=jnp.asarray(st.chunk_block.numpy()))
    windows = JT.gather_grid_windows(b.grid, jpipe._cfg, jst, jnp.asarray(fields),
                                     cell_order=JT.ZMAJOR_ORDER_3D)
    dt = 1e-3
    out_j = np.asarray(JK.g2p_fused(
        b.grid, jpipe._cfg, jpipe._meta, jpipe._kparams, jnp.asarray(state.slots.numpy()),
        jnp.asarray(state.ints.numpy()), windows, jnp.float32(dt), jpipe._tab_f, jpipe._tab_i,
        interpret=True, nchunks=jnp.asarray(st.num_chunks.numpy())))
    out_t = TK.g2p_fused(tpipe.grid, tpipe._cfg, tpipe._meta, tpipe._kparams, state.slots,
                         state.ints, torch.from_numpy(fields), tpipe._corners(state), dt,
                         tpipe._tab_f, tpipe._tab_i, st.num_chunks).numpy()
    occ = ((state.ints[:, TL.I_FLAGS, :] & TL.OCCUPIED) != 0).numpy()
    a = np.where(occ[:, None, :], out_t, 0.0)
    j = np.where(occ[:, None, :], out_j, 0.0)
    r = TL.Rows(3)
    loose = (set(range(r.defgrad, r.defgrad + 9)) | set(range(r.stress, r.stress + 6))
             | {r.psi_pos, r.par1, r.pdd, r.ph, r.lvg})
    np.testing.assert_array_equal(a[:, r.failed], j[:, r.failed])
    for k in range(r.nf):
        scale = max(np.abs(j[:, k]).max(), 1e-30)
        assert np.abs(a[:, k] - j[:, k]).max() / scale <= (2e-5 if k in loose else 1e-5), k
