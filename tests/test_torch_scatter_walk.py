"""The premise of the scatter kernels' lane-mask walk (csrc/scatter_walk.cuh),
which the mass P2G (mass_p2g_kernel) and the sparse P2G (p2g_windows_kernel)
run on the card: on the CPU, from the port's own states,

- the per-axis lane masks built as the kernels' warp ballots build them
  (per axis and window coordinate v, the lanes that pass the kernel's hit
  predicate and whose lowest tap lies in v-2..v), ANDed per cell, are
  exactly the lanes whose 3^d stencil holds the cell;
- a fold over each cell's lanes in ascending order, with the kernels'
  products, is bit-equal to the plain version (the mass images in 2D and
  3D, the window images in 2D, where the plain versions sum in the kernels'
  order), and within p2g_errors's bound of the 3D window plain version (a
  batched matrix product, which sums in another order);
- for the window kernel, restricting the walk to the lanes with a nonzero
  payload changes no bit of the fold over the lanes below nlive: a left
  fold from +0.0 never reaches -0.0, so the padded lanes' finite ±0 terms
  leave every sum as it is.

States: fluids3 as published (15,200 particles) and fluids2(n=40) packed by
the fused pipeline; the sparse pipeline's slot data of reduced sand3 and of
elasticity2 one substep in, with numpy-seeded psi rows for the psi form.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import sparkl_tpu_torch.scenes as tscenes
from sparkl_tpu_torch.fused import kernels as TK
from sparkl_tpu_torch.fused import layout as TL
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
from sparkl_tpu_torch.math import linalg
from sparkl_tpu_torch.ops import transfer_kernels as WK
from sparkl_tpu_torch.sparse.blocks import BLOCK_SIDE

torch.set_num_threads(1)


def _axis_masks(base, pred):
    """Per axis, [D, 8, C]: the lanes with `pred` whose base lies in
    v-2..v, for v in 0..7 (one warp ballot per axis and v)."""
    v = torch.arange(8)[None, :, None]
    return [pred[:, None, :] & (v - b[:, None, :] >= 0) & (v - b[:, None, :] <= 2) for b in base]


def _cell_masks(masks, cells):
    """[D, RC, C]: each cell's lane mask, the AND of its coordinates' axis
    masks; `cells` gives per axis the coordinate of every cell."""
    out = None
    for m, coord in zip(masks, cells):
        part = m[:, coord, :]
        out = part if out is None else out & part
    return out


def _stencil_hits(taps, ok, rc):
    """[D, RC, C]: whether cell q lies in lane s's stencil; `taps` [D, K, C]
    the stencil's cells, `ok` [D, C] the lanes that scatter."""
    d_, k, c = taps.shape
    hits = torch.zeros((d_, rc, c), dtype=torch.int32)
    hits.scatter_add_(1, taps.long(), ok[:, None, :].expand(d_, k, c).to(torch.int32))
    assert int(hits.max()) <= 1  # a lane adds to a cell at most once
    return hits.bool()


def _fold(mask, terms):
    """Per cell, the left fold from +0.0 over the set lanes in ascending
    order: mask [D, RC, C], terms(s) -> list of [D, RC] f32 per sum."""
    acc = None
    for s in range(mask.shape[2]):
        t = terms(s)
        if acc is None:
            acc = [torch.zeros_like(x) for x in t]
        on = mask[:, :, s]
        acc = [torch.where(on, a + x, a) for a, x in zip(acc, t)]
    return acc


def _window_rows(w_taps, base):
    """Per axis [D, 8, C]: the 3 taps' values at their window coordinates
    base + k, zero elsewhere (the kernels' shared-memory rows)."""
    v = torch.arange(8)[None, :, None]
    out = []
    for taps, b in zip(w_taps, base):
        row = torch.zeros(b.shape[0], 8, b.shape[1])
        for k in range(3):
            row = torch.where(v == (b + k)[:, None, :], taps[k][:, None, :], row)
        out.append(row)
    return out


def _bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.fixture(scope="module")
def fused_states():
    """Per dimension, (grid, slots, ints, nchunks) of a fused pack:
    fluids3 as published in 3D, fluids2(n=40) in 2D."""
    out = {}
    for dim, b in ((3, tscenes.build("fluids3", device="cpu")),
                   (2, tscenes.build("fluids2", n=40, device="cpu"))):
        pipe = FusedMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity,
                                device="cpu")
        st = pipe.pack_state(b.particles)
        out[dim] = (b.grid, st.slots, st.ints, st.structure.num_chunks)
    return out


@pytest.mark.parametrize("dim", [3, 2])
def test_mass_walk_matches_plain_version(fused_states, dim):
    """The mass P2G's walk: the ballots' masks (the contributing lanes
    whose window-relative base lies in v-2..v) ANDed per cell are the lanes
    whose stencil (fused.kernels._tap_cells) holds the cell, and the fold
    over them with (m·wz)·(wx·wy) in 3D (z-major cells) and (m·wx)·wy in 2D
    is bit-equal to mass_p2g_fused_reference."""
    grid, slots, ints, nchunks = fused_states[dim]
    n = int(nchunks)
    s_, i_ = slots[:n], ints[:n]
    contrib, rel, w = TK._mass_geometry(grid, s_, i_)
    rc = 8**dim
    q = torch.arange(rc)
    cells = [(q >> 3) & 7, q & 7, q >> 6] if dim == 3 else [q >> 3, q & 7]
    mask = _cell_masks(_axis_masks(rel, contrib), cells)
    assert torch.equal(mask, _stencil_hits(TK._tap_cells(rel, contrib), contrib, rc))
    assert int(mask.sum()) == 3**dim * int(contrib.sum())
    m_c = s_[:, TL.Rows(dim).mass, :] * contrib.to(torch.float32)
    rows = _window_rows(w, rel)
    if dim == 3:
        def terms(s):
            return [(m_c[:, None, s] * rows[2][:, cells[2], s])
                    * (rows[0][:, cells[0], s] * rows[1][:, cells[1], s])]
    else:
        def terms(s):
            return [(m_c[:, None, s] * rows[0][:, cells[0], s]) * rows[1][:, cells[1], s]]
    (img,) = _fold(mask, terms)
    plain = TK.mass_p2g_fused_reference(grid, slots, ints, nchunks)
    assert _bits(img, plain[:n, 0])
    assert int((img != 0).sum()) > 0


@pytest.fixture(scope="module")
def window_inputs():
    """Per dimension, (grid, slot data) of the sparse pipeline one substep
    in: reduced sand3 in 3D, elasticity2 in 2D; and the same slot data
    with numpy-seeded psi rows on the occupied slots."""
    out = {}
    rng = np.random.default_rng(23)
    for dim, b in ((3, tscenes.build("sand3", nx=12, ny=6, nz=6, device="cpu")),
                   (2, tscenes.build("elasticity2", device="cpu"))):
        _, sd, _ = chip_smoke.sparse_inputs(b, 1)
        row = 2 * dim + 1 + dim * dim
        valid = sd[:, dim, :] != 0.0
        psi = sd.clone()
        noise = rng.uniform(0.5, 1.5, size=(sd.shape[0], 2, sd.shape[2])).astype(np.float32)
        psi[:, row:row + 2] = torch.from_numpy(noise) * valid[:, None, :]
        out[dim] = (b.grid, sd, psi)
    return out


def _window_fold(grid, data, with_psi, live):
    """The window kernel's walk on slot data [D, NF_IN, C] over the lanes
    in `live` [D, C]: (image [D, 1+d(+2), 8^d], cell masks)."""
    dim = grid.dim
    d_, _, c = data.shape
    lb = []
    for ax in range(dim):
        base = torch.round(linalg.div_const(data[:, ax, :] - grid.origin[ax],
                                            grid.cell_width)).to(torch.int32) - 1
        lb.append(base - (base // BLOCK_SIDE) * BLOCK_SIDE)
    rc = 8**dim
    q = torch.arange(rc)
    cells = [q >> 6, (q >> 3) & 7, q & 7] if dim == 3 else [q >> 3, q & 7]
    mask = _cell_masks(_axis_masks(lb, torch.ones_like(live)), cells) & live[:, None, :]
    k = torch.arange(3, dtype=torch.int32)
    if dim == 3:
        taps = ((lb[0][:, None, None, None, :] + k[:, None, None, None]) * 64
                + (lb[1][:, None, None, None, :] + k[None, :, None, None]) * 8
                + lb[2][:, None, None, None, :] + k[None, None, :, None]).reshape(d_, 27, c)
    else:
        taps = WK._stencil_cells_2d(grid, data).transpose(1, 2)
    assert torch.equal(mask, _stencil_hits(taps, live, rc))
    w, wd = [], []
    for ax in range(dim):
        wa, dpt = WK._axis_weights(grid, data[:, ax, :], ax)
        w.append(wa)
        wd.append(wa * dpt)
    m = data[:, dim, :]
    p0 = [m] + [m * data[:, dim + 1 + i, :] for i in range(dim)]
    a_off = 2 * dim + 1
    if with_psi:
        p0 += [data[:, a_off + dim * dim + 1, :], data[:, a_off + dim * dim, :]]
    aff = [data[:, a_off + e, :] for e in range(dim * dim)]

    def terms(s):
        wx, wy = w[0][:, cells[0], s], w[1][:, cells[1], s]
        if dim == 3:
            wz = w[2][:, cells[2], s]
            wxy = wx * wy
            wq = wxy * wz
            wdj = [(wd[0][:, cells[0], s] * wy) * wz, (wx * wd[1][:, cells[1], s]) * wz,
                   wxy * wd[2][:, cells[2], s]]
        else:
            wq = wx * wy
            wdj = [wd[0][:, cells[0], s] * wy, wx * wd[1][:, cells[1], s]]
        base = [p[:, None, s] * wq for p in p0]
        jterms = [aff[i * dim + j][:, None, s] * wdj[j] for i in range(dim) for j in range(dim)]
        return base + jterms

    acc = _fold(mask, terms)
    base, acc_j = acc[: len(p0)], acc[len(p0):]
    mom = []
    for i in range(dim):
        v = base[1 + i]
        for j in range(dim):
            v = v + acc_j[i * dim + j]
        mom.append(v)
    return torch.stack([base[0], *mom, *base[1 + dim:]], dim=1), mask


@pytest.mark.parametrize("dim,with_psi", [(3, False), (3, True), (2, False), (2, True)])
def test_window_walk_matches_plain_version(window_inputs, dim, with_psi):
    """The sparse P2G's walk: over the lanes below nlive (one past the last
    slot with a nonzero payload), the ballots' masks (per axis the lanes
    whose block-local base lb lies in v-2..v) ANDed per cell are the lanes
    whose stencil holds the cell; the fold with the kernel's products and
    per-term sums, momentum closed as acc_b + acc_j0 + acc_j1 (+ acc_j2),
    is bit-equal to p2g_windows_reference in 2D and within p2g_errors's
    bound of it in 3D; the fold over the lanes with a nonzero payload
    alone is bit-equal to it."""
    grid, sd, sd_psi = window_inputs[dim]
    data = sd_psi if with_psi else sd
    data = data[(data != 0.0).any(dim=2).any(dim=1)]  # the chunks that hold a slot
    c = data.shape[2]
    rows = list(range(dim, 2 * dim + 1 + dim * dim)) + ([2 * dim + 1 + dim * dim,
                                                         2 * dim + 2 + dim * dim]
                                                        if with_psi else [])
    payload = data[:, rows, :]
    nonzero = (payload != 0.0).any(dim=1)
    lane = torch.arange(c)[None, :]
    nlive = torch.where(nonzero, lane + 1, 0).max(dim=1).values
    img, mask = _window_fold(grid, data, with_psi, lane < nlive[:, None])
    plain = WK.p2g_windows_reference(grid, data, with_psi)
    if dim == 2:
        assert _bits(img, plain)
    else:
        errs = chip_smoke.p2g_errors(img, plain)
        assert all(e <= 1.0 for e, _ in errs), errs
    img_nz, _ = _window_fold(grid, data, with_psi, nonzero)
    assert _bits(img_nz, img)
    assert bool(nonzero.any()) and int(mask.sum()) >= 3**dim * int(nonzero.sum())

