"""sparkl_tpu_torch slot structure, pack/unpack and resort against the JAX
package, bit for bit, on sand3 at nx=12, ny=6, nz=6 (864 particles) with
an explicit small BlockConfig.

The JAX resort runs as its tests run it (interpret=True). A 4-frame run
from rest never resorts (the first resort comes near frame 12), so the
resort cases displace packed positions with numpy: by whole blocks
(chunk relabel), by whole blocks in a different order (pure chunk
reorder), and by about one cell at random (mixed).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparkl_tpu.scenes as jscenes
from sparkl_tpu.fused import layout as JL
from sparkl_tpu.fused import structure as JS
from sparkl_tpu.solver import dense as jdense
from sparkl_tpu.models import registry as jreg
from sparkl_tpu.sparse.blocks import BlockConfig as JBlockConfig

from sparkl_tpu_torch import interop
from sparkl_tpu_torch.fused import layout as TL
from sparkl_tpu_torch.fused import structure as TS
from sparkl_tpu_torch.sparse.blocks import BlockConfig

torch.set_num_threads(1)

CFG = dict(max_blocks=64, max_chunks=32, chunk_size=128, max_grid_blocks=128)


@pytest.fixture(scope="module")
def packed():
    """The JAX scene, its packed state, and the same inputs as numpy."""
    b = jscenes.build("sand3", nx=12, ny=6, nz=6)
    jcfg, tcfg = JBlockConfig(**CFG), BlockConfig(**CFG)
    p = b.particles
    dtb = jdense.particle_dt_bounds(b.grid, p, b.models)
    stress = jreg.kirchhoff_stress(
        b.models, p.model_id, p.phase, p.elastic_hardening, p.deformation_gradient,
        p.velocity_gradient, p.mass, p.volume0,
    )
    jstate = jax.jit(lambda q, d, s: JL.pack(b.grid, jcfg, q, d, stress=s))(p, dtb, stress)
    arrays = {k: np.asarray(v) for k, v in vars(p).items()}
    return b, jcfg, tcfg, jstate, arrays, np.asarray(dtb), np.asarray(stress)


def _structure_np(s):
    return {k: np.asarray(v) for k, v in vars(s).items()}


def _assert_structure_equal(tstruct, jstruct):
    j = _structure_np(jstruct)
    for k, v in tstruct.tensors().items():
        np.testing.assert_array_equal(v.numpy(), j[k], err_msg=k)
        assert v.dtype == torch.int32, k


def test_build_slot_structure_bit_equal(packed):
    b, jcfg, tcfg, _, arrays, _, _ = packed
    pos, act = arrays["position"], arrays["active"]
    js, jorder, jstart = jax.jit(
        lambda x, a: JS.build_slot_structure(b.grid, jcfg, x, a, a)
    )(pos, act)
    ts, torder, tstart = TS.build_slot_structure(
        b.grid, tcfg, torch.tensor(pos), torch.tensor(act), torch.tensor(act)
    )
    _assert_structure_equal(ts, js)
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(tstart.numpy(), np.asarray(jstart))
    assert int(ts.num_chunks) > 1 and int(ts.num_blocks) > 1


def test_calibrate_ob2_matches_jax(packed):
    b, _, _, _, arrays, _, _ = packed
    assert TS.calibrate_ob2(
        b.grid, torch.tensor(arrays["position"]), torch.tensor(arrays["active"])
    ) == BlockConfig(**vars(JS.calibrate_ob2(b.grid, arrays["position"], arrays["active"])))


def test_pack_unpack_bit_equal(packed):
    b, _, tcfg, jstate, arrays, dtb, stress = packed
    p = interop.particles_from_numpy(arrays, device="cpu")
    tstate = TL.pack(b.grid, tcfg, p, torch.tensor(dtb), stress=torch.tensor(stress))
    np.testing.assert_array_equal(tstate.slots.numpy(), np.asarray(jstate.slots))
    np.testing.assert_array_equal(tstate.ints.numpy(), np.asarray(jstate.ints))
    _assert_structure_equal(tstate.structure, jstate.structure)

    q = interop.particles_to_numpy(TL.unpack(b.grid, tcfg, tstate, p.capacity, 3))
    qj = JL.unpack(b.grid, JBlockConfig(**CFG), jstate, p.capacity, 3)
    for k, v in q.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(qj, k)), err_msg=k)
    for k in ("position", "velocity", "deformation_gradient", "mass", "model_id", "active"):
        np.testing.assert_array_equal(q[k], arrays[k], err_msg=k)


def _displaced(jstate, grid, kind, seed=6):
    """Packed slots with positions moved: 'relabel' shifts everything one
    block down; 'pure' mirrors the two z-block layers onto each other;
    'mixed' jitters every particle by up to ~0.6 cell per axis."""
    slots = np.array(jstate.slots)
    h = grid.cell_width
    pos = slots[:, 0:3, :]
    if kind == "relabel":
        pos[:, 1, :] -= 4.0 * h
    elif kind == "pure":
        cz = np.round((pos[:, 2, :] - grid.origin[2]) / h).astype(np.int64)
        bz = (cz - 2) // 4 + 1
        lo = bz[np.asarray(jstate.ints)[:, JL.I_FLAGS, :] != 0].min()
        pos[:, 2, :] += np.where(bz == lo, 4.0 * h, -4.0 * h).astype(np.float32)
    else:
        rng = np.random.default_rng(seed)
        pos += rng.uniform(-0.6 * h, 0.6 * h, size=pos.shape).astype(np.float32)
    slots[:, 0:3, :] = pos
    return slots


@functools.lru_cache(maxsize=None)
def _jax_resort(grid, cfg):
    """One jitted JAX resort shared by the three cases (one compile)."""
    return jax.jit(lambda s: JL.resort(grid, cfg, s, 3, interpret=True))


@pytest.mark.parametrize("kind", ["relabel", "pure", "mixed"])
def test_resort_bit_equal(packed, kind):
    b, jcfg, tcfg, jstate, _, _, _ = packed
    slots = _displaced(jstate, b.grid, kind)
    js = jstate.replace(slots=jnp.asarray(slots))
    jout, jov = _jax_resort(b.grid, jcfg)(js)

    arrays = _structure_np(jstate.structure)
    arrays.update(slots=slots, ints=np.asarray(jstate.ints), cum_disp=np.float32(0.5))
    ts = interop.slot_state_from_numpy(arrays, device="cpu")
    tout, tov, branch = TL.resort(b.grid, tcfg, ts, 3)

    # "mixed" runs the permute kernel's plain version; the JAX resort takes
    # its DMA permute kernel (at most 8 source chunks per destination here).
    assert branch == kind
    assert bool(tov) == bool(jov) == False
    np.testing.assert_array_equal(tout.slots.numpy(), np.asarray(jout.slots))
    np.testing.assert_array_equal(tout.ints.numpy(), np.asarray(jout.ints))
    _assert_structure_equal(tout.structure, jout.structure)
    assert float(tout.cum_disp) == 0.0

    out = interop.slot_state_to_numpy(tout)
    back = interop.slot_state_from_numpy(out, device="cpu")
    np.testing.assert_array_equal(back.slots.numpy(), out["slots"])
