"""The two merges on window images (fused/kernels.merge_blocks, the gather
form, and merge_scatter, the scatter form) against the JAX package's
merge_images_to_grid, on the CPU: each plain version bit-equal to it on
every node-table row but the trash row (which both zero), in the cell
orders and widths the paths merge:

- z-major 3D (kernel A's images, nf = 4 and, with the psi channels, 6; the
  mass images, nf = 1) on reduced sand3 packed by the fused pipeline;
- row-major 3D (the sparse path's images, nf = 4) on the sparse
  structure of the same particles;
- 2D (nf = 3 and, with the psi channels, 5; the mass images, nf = 1) on
  fluids2(n=40) packed by the fused pipeline;
- fluids3 as published, whose blocks hold 32 chunks (past MERGE_KMAX = 8),
  in the scatter form, which the fused pipeline pins for it.

The JAX side runs the gather form as the fused pipeline does (`gather=True,
dma=True`, the Pallas merge_blocks_dma in interpret mode) and the scatter
form with `force_scatter=True`. Images are numpy-seeded, with dead chunks'
images zero, as the P2G kernels write them. Also: the corner-owner table
the fused pipeline caches equals the JAX package's `co`, and a row whose
only terms are -0.0 comes out +0.0 in both forms, as in the JAX package.
The CUDA kernels run only on the card (chip_smoke.py holds them to these
plain versions there).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparkl_tpu.sparse import transfer as JT
from sparkl_tpu.sparse.blocks import BlockConfig as JBlockConfig

import sparkl_tpu_torch.scenes as tscenes
from sparkl_tpu_torch.fused import kernels as TK
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
from sparkl_tpu_torch.sparse import blocks as TB
from sparkl_tpu_torch.sparse import transfer as TT
from sparkl_tpu_torch.sparse.blocks import BlockConfig

torch.set_num_threads(1)

CFG = dict(max_blocks=64, max_chunks=32, chunk_size=128, max_grid_blocks=128)


def _fused(b, config=None):
    pipe = FusedMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity,
                            config=config, device="cpu")
    return pipe, pipe.pack_state(b.particles)


# The channel groups each state's images hold, one JAX run a state and form
# on all of them at once (the merge sums each channel alone): the widths
# its paths merge and, on fused3, one channel whose live entries are -0.0.
GROUPS = {"fused3": (4, 6, 1, "-0"), "sparse3": (4,), "fused2": (3, 5, 1), "dense": (4,)}


@pytest.fixture(scope="module")
def states():
    """{name: SimpleNamespace(grid, cfg, structure, cache (the fused
    pipeline's grid cache, or None), images [D, sum of GROUPS, 8^d], the
    JAX results by form (filled on first use))} for reduced sand3 packed
    by the fused pipeline and its sparse structure, fluids2(n=40) with its
    positions drawn 0.6x toward their mean (so that blocks hold several
    64-slot chunks) packed by the fused pipeline, and fluids3 as published
    (dense)."""
    out = {}
    b3 = tscenes.build("sand3", nx=12, ny=6, nz=6, device="cpu")
    pipe, st = _fused(b3, BlockConfig(**CFG))
    out["fused3"] = (b3.grid, pipe._cfg, st.structure, st.grid_cache)
    p = b3.particles
    out["sparse3"] = (b3.grid, pipe._cfg,
                      TB.build_structure(b3.grid, pipe._cfg, p.position, p.active), None)
    b2 = tscenes.build("fluids2", n=40, device="cpu")
    pos = b2.particles.position
    mean = pos[b2.particles.active].mean(dim=0)
    b2 = dataclasses.replace(b2, particles=b2.particles.replace(
        position=mean + 0.6 * (pos - mean)))
    pipe, st = _fused(b2)
    out["fused2"] = (b2.grid, pipe._cfg, st.structure, st.grid_cache)
    bf = tscenes.build("fluids3", device="cpu")
    pipe, st = _fused(bf)
    assert pipe._merge_force_scatter  # its 32-chunk blocks pin the scatter form
    out["dense"] = (bf.grid, pipe._cfg, st.structure, st.grid_cache)
    rng = np.random.default_rng(31)
    for name, (grid, cfg, structure, cache) in out.items():
        nch = _channels(name, len(GROUPS[name]) - 1)[1]
        img = rng.normal(size=(cfg.max_chunks, nch, 8**grid.dim)).astype(np.float32)
        if "-0" in GROUPS[name]:
            img[:, -1] = -0.0
        img[int(structure.num_chunks):] = 0.0  # dead chunks, as the P2G kernels write them
        out[name] = SimpleNamespace(grid=grid, cfg=cfg, structure=structure, cache=cache,
                                    images=img, jax={})
    return out


def _channels(name, group):
    """The image channels [c0, c1) of GROUPS[name][group]."""
    widths = [1 if g == "-0" else g for g in GROUPS[name]]
    c0 = sum(widths[:group])
    return c0, c0 + widths[group]


def _jax(s, zmajor, scatter):
    """The JAX package's merge_images_to_grid on the port's structure and
    every channel of the state's images, run once a state and form."""
    if scatter in s.jax:
        return s.jax[scatter]
    structure, cfg = s.structure, s.cfg
    keys = ("nbr_index", "chunk_block", "block_first_chunk", "num_chunks") + (
        ("block_num_chunks",) if hasattr(structure, "block_num_chunks") else ())
    tables = {k: jnp.asarray(getattr(structure, k).numpy()) for k in keys}
    jcfg = JBlockConfig(max_blocks=cfg.max_blocks, max_chunks=cfg.max_chunks,
                        chunk_size=cfg.chunk_size, max_grid_blocks=cfg.max_grid_blocks)
    order = JT.ZMAJOR_ORDER_3D if zmajor else None

    def merge(images, tables):
        jst = SimpleNamespace(**tables)
        if scatter:
            return JT.merge_images_to_grid(s.grid, jcfg, jst, images, cell_order=order,
                                           force_scatter=True)
        return JT.merge_images_to_grid(s.grid, jcfg, jst, images, cell_order=order,
                                       gather=True, dma=True, interpret=True,
                                       overflow_out=True)[0]

    # One compiled program (the eager form compiles each of its ~30 ops).
    s.jax[scatter] = np.asarray(jax.jit(merge)(jnp.asarray(s.images), tables))
    return s.jax[scatter]


def _block_num_chunks(structure):
    """The sparse structure's per-block chunk counts (the exclusive prefix
    sum block_first_chunk, closed by num_chunks), as the JAX merge forms
    them."""
    first = structure.block_first_chunk
    return torch.cat([first[1:], structure.num_chunks[None]]) - first


def _port(s, images, zmajor, scatter):
    """The port's merge on the CPU (the plain version, no launch), through
    merge_images_to_grid with the grid cache's plan and owners where the
    state has them."""
    structure, cache = s.structure, s.cache
    TK.reset_launch_counts()
    if cache is None and not scatter:
        structure = SimpleNamespace(**structure.tensors(),
                                    block_num_chunks=_block_num_chunks(structure))
    plan, owner = (cache[2], cache[4]) if cache is not None else (None, None)
    out = TT.merge_images_to_grid(s.grid, s.cfg, structure, torch.tensor(images),
                                  cell_order=TT.ZMAJOR_ORDER_3D if zmajor else None,
                                  force_scatter=scatter, plan=plan, owner=owner).numpy()
    assert TK.LAUNCHES["merge_blocks"] == TK.LAUNCHES["merge_scatter"] == 0
    return out


def _case(s, name, group, zmajor, scatter):
    """(port, JAX) node tables of channel group `group` of the state."""
    c0, c1 = _channels(name, group)
    cpb = 4**s.grid.dim
    out_t = _port(s, np.ascontiguousarray(s.images[:, c0:c1]), zmajor, scatter)
    return out_t, _jax(s, zmajor, scatter)[:, c0 * cpb : c1 * cpb]


CASES = [
    # (state, channel group, zmajor, scatter)
    ("fused3", 0, True, False),
    ("fused3", 1, True, False),
    ("fused3", 2, True, False),
    ("fused3", 0, True, True),
    ("fused3", 2, True, True),
    ("sparse3", 0, False, False),
    ("sparse3", 0, False, True),
    ("fused2", 0, False, False),
    ("fused2", 1, False, False),
    ("fused2", 2, False, False),
    ("fused2", 1, False, True),
    ("dense", 0, True, True),
]


@pytest.mark.parametrize("name,group,zmajor,scatter", CASES,
                         ids=[f"{s}-nf{GROUPS[s][g]}-{'scatter' if sc else 'gather'}"
                              for s, g, _, sc in CASES])
def test_merge_plain_bit_equal_to_jax(states, name, group, zmajor, scatter):
    s = states[name]
    nf, cfg = GROUPS[name][group], s.cfg
    out_t, out_j = _case(s, name, group, zmajor, scatter)
    assert out_t.shape == out_j.shape == (cfg.max_grid_blocks + 1, nf * 4**s.grid.dim)
    # Both sum each element's terms in the same order from zero.
    np.testing.assert_array_equal(out_t[:-1], out_j[:-1])
    assert not out_t[-1].any()
    ngb = int(s.structure.num_grid_blocks)
    assert np.abs(out_t[:ngb]).max() > 0 and not out_t[ngb:].any()
    if name == "dense":
        starts = s.cache[2][1]
        assert int((starts[1:] - starts[:-1]).max()) > 8 * TT.MERGE_KMAX
    elif not scatter:
        nblk = getattr(s.structure, "block_num_chunks", None)
        nblk = _block_num_chunks(s.structure) if nblk is None else nblk
        assert 1 < int(nblk.max()) <= TT.MERGE_KMAX  # some block sums several chunks


def test_corner_owner_equals_jax_co(states):
    """The cached corner_owner against the JAX package's `co`
    (sparkl_tpu/sparse/transfer.py:_merge_gather, built there per merge) on
    every non-trash row, for the fused 3D and 2D states and the sparse one
    (built by corner_owner)."""
    for name in ("fused3", "fused2", "sparse3"):
        s = states[name]
        cfg = s.cfg

        def jax_co(nbr):
            ncorners = nbr.shape[1]
            co = jnp.full((cfg.max_grid_blocks + 1, ncorners), cfg.max_blocks, jnp.int32)
            bidx = jnp.minimum(jnp.arange(nbr.shape[0], dtype=jnp.int32),
                               cfg.max_blocks)[:, None]
            kidx = jnp.arange(ncorners, dtype=jnp.int32)[None, :]
            return co.at[nbr, jnp.broadcast_to(kidx, nbr.shape)].set(
                jnp.broadcast_to(bidx, nbr.shape))

        co = np.asarray(jax.jit(jax_co)(jnp.asarray(s.structure.nbr_index.numpy())))
        owner = TT.corner_owner(cfg, s.structure) if s.cache is None else s.cache[4]
        assert owner.dtype == torch.int32 and owner.shape == co.shape
        np.testing.assert_array_equal(owner.numpy()[:-1], co[:-1])
        assert (co[:-1] < cfg.max_blocks).any()


def test_negative_zero_terms_sum_to_positive_zero(states):
    """A channel whose live image entries are all -0.0: each node row with
    a term sums from +0.0, so it comes out +0.0 in both forms, as the JAX
    package's does."""
    s = states["fused3"]
    for scatter in (False, True):
        out_t, out_j = _case(s, "fused3", GROUPS["fused3"].index("-0"), True, scatter)
        assert not np.signbit(out_t).any() and not np.signbit(out_j[:-1]).any()
        np.testing.assert_array_equal(out_t[:-1], out_j[:-1])
