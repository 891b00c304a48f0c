#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: its two sand3 paths (the
fused pipeline and the block-sparse pipeline) and its fluid path (fluids3
on the fused pipeline, with fluid volume recomputation).

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It needs one CUDA device (written for an H100, sm_90a) and nvcc, and exits
non-zero on any failure: no CUDA device, a kernel that does not build,
launch or agree with its plain PyTorch version, a main path that does not
run through the kernels, or results that are not right.

Phases (one line each, longer logs under chiprun_out/):
  1. card and toolchain;
  2. build of the CUDA kernels from sparkl_tpu_torch/csrc;
  3. the substep kernels against their plain versions on the card, at the
     main path's shapes (sand3 at nx=100, ny=50, nz=100: ~1.02M particles),
     with times, the scatter merge bit-equal to its plain version and to a
     second launch; and a small sand3 frame on the card against the port's
     CPU path;
  4. the main path: FusedMpmPipeline.pack_state -> 15 frames of
     run_frames_state -> unpack_state, with the kernels' launch counts
     held against the substeps and the resort branches taken;
  5. after the main path: the resort kernels against their plain versions
     on the state the main path's first resort started from, that whole
     resort on the card against the same resort of a CPU copy, and kernel
     B on the landed final state and on that state with perturbed F, both
     with Drucker-Prager plastic flow;
  6. the block-sparse path's two window kernels against their plain
     versions on the card, on the inputs of a substep one frame into the
     fall at sand3@1M, without and with the psi channels, with times;
  7. the sparse main path: SparseMpmPipeline.step_with_stats, then
     run_frames, 6 frames at sand3@1M, with the kernels' launch counts held
     against the substeps; one more frame timed, then under torch.profiler (the
     frame's device-time split, written to chiprun_out/sparse_profile.txt);
  8. one frame of sand3@1M through each path, sparse against fused, two
     sparse frames from the same particles bit-equal, and a small sand3
     frame through the sparse path on the card against the port's CPU path;
  9. the fluid path's kernels (mass P2G and G2P, kernels A and B with their
     fluid branches, the scatter merge on both kinds of images) against
     their plain versions on the card, on the packed state of fluids3 with
     each axis of its particle counts x4 (972,800 particles) after its
     first volume pass, with times;
 10. the fluid main path: pack_state -> 30 frames of run_frames_state
     (through a lazy resort) -> unpack_state, launch counts against the
     substeps, mass conservation, one profiled frame (written to
     chiprun_out/fluid_profile.txt); then the fluid kernels again on the
     state one frame into the run;
 11. fluids3 as published (15,200 particles), 3 frames on the card against
     the port's CPU path, and two card runs bit-equal; the fluid kernels on
     a mixed fluid/solid set;
 12. a JSON line of per-kernel results, the card's nvidia-smi line, and
     the final {"ok": true, "device": ...} line.

Each kernel's bound_ms is the least time the card could take for its work
at this run's shapes: the larger of the bytes it must move (each input read
once, each output written once) over 3.35 TB/s and the f32 operations this
run's data needs over 67 TFLOP/s (the H100 SXM's published peaks at 700 W).
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
REPLACES = {
    "p2g_fused": "sparkl_tpu/fused/kernels.py:548",
    "merge_blocks": "sparkl_tpu/fused/kernels.py:1098",
    "g2p_fused": "sparkl_tpu/fused/kernels.py:1510",
    "src_rows_from_order": "sparkl_tpu/fused/kernels.py:775",
    "permute_slots": "sparkl_tpu/fused/kernels.py:1008",
    "p2g_windows": "sparkl_tpu/ops/transfer_kernels.py:198",
    "g2p_windows": "sparkl_tpu/ops/transfer_kernels.py:245",
    "mass_p2g_fused": "sparkl_tpu/fused/kernels.py:686",
    "mass_g2p_fused": "sparkl_tpu/fused/kernels.py:716",
    # XLA glue, not a TPU kernel: the scatter-add merge.
    "merge_scatter": "sparkl_tpu/sparse/transfer.py:237",
}
# The main path each kernel's launch count is read from.
PATH_OF = dict.fromkeys(("p2g_fused", "merge_blocks", "g2p_fused", "src_rows_from_order",
                         "permute_slots"), "fused")
PATH_OF.update(p2g_windows="sparse", g2p_windows="sparse", mass_p2g_fused="fluid",
               mass_g2p_fused="fluid", merge_scatter="fluid")
FUSED_SOURCE = "sparkl_tpu_torch/csrc/fused_kernels.cu"
WINDOW_SOURCE = "sparkl_tpu_torch/csrc/window_kernels.cu"
SPARSE_KERNELS = ("p2g_windows", "g2p_windows")
FRAMES, TIMED_FRAMES = 15, 3
SPARSE_FRAMES, SPARSE_TIMED = 6, 2
FLUID_FRAMES, FLUID_TIMED = 30, 5
# fluids3 with each axis of its particle counts x4, the grid box grown by
# the published margins (phases 9-10).
FLUID_COUNTS = (152, 80, 80)
FLUID_BOX = ((-8.0, -40.0, -8.0), (41.0, 20.0, 26.0))
# Sparse against fused after one frame at sand3@1M (phase 8).
# Measured 9.5e-7 and 6.7e-6 (NVIDIA H100 80GB HBM3, 700 W): summation-order
# rounding over 6 substeps (the paths merge in other orders and form the
# stress in other places), the same in every run now that no merge uses
# float atomics; the bounds leave 10x.
SPARSE_FUSED_DX, SPARSE_FUSED_DV = 1e-5, 1e-4
# fluids3 after 3 frames, card against CPU (phase 11): the two sum kernel
# A's images in other orders, and near J = 1 the EOS dt bound turns on the
# last bits, so the substep counts may differ by one and the trajectories
# by the splitting of a frame into substeps (~g dt^2 ~ 5e-5 m at dt ~
# 2.25e-3 s); the bounds leave 20x for positions and allow 1e-3 in J.
FLUIDS3_DX, FLUIDS3_DJ = 1e-3, 1e-3
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Useful f32 operations per stencil tap (27 per slot), counted from the
# kernels' arithmetic: P2G forms W, W_x, W_y, W_z (7 products) and adds
# mass, 3 momenta and 9 affine terms (2 each); G2P forms the same weights
# and adds v and 3 gradient terms per velocity channel (2 each). Kernel A
# adds the affine matrix per slot (~45); kernel B's particle update (F
# update, cardano SVD, Drucker-Prager, stress, energy, dt bound) is
# counted as 1500 per lane, a lower estimate.
P2G_TAP_FLOPS, G2P_TAP_FLOPS = 7 + 2 * 13, 7 + 2 * 12
A_SLOT_FLOPS, B_LANE_FLOPS = 45, 1500
# The fluid path: kernel A's EOS stress ~40 more per slot (exp and log
# counted as one each); kernel B's fluid lane ~200 (J update, EOS bound);
# the mass kernels 4 per tap (w products, the product with m or the window
# value, the sum).
EOS_SLOT_FLOPS, B_FLUID_LANE_FLOPS, MASS_TAP_FLOPS = 40, 200, 4
# Tolerances of the kernel-vs-plain checks (the plain versions run on the
# same card on the same tensors); p2g_errors and g2p_errors state each one.


class SmokeError(RuntimeError):
    pass


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def nvcc_release():
    from sparkl_tpu_torch.cuda_build import _nvcc

    out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                         timeout=60, check=True)
    return next(ln for ln in out.stdout.splitlines() if "release" in ln).strip()


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the card's memory rate
    and f32 operations over its peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_median_ms(fn, reps=20):
    """Median of `reps` launches of fn(), each between two CUDA events."""
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def p2g_errors(img_k, img_p):
    """Per image channel (mass, momentum x3): max |kernel - plain| over the
    bound 2e-5 * max|channel| + 1e-5 * |plain|. Both sum the same f32 terms
    (up to 27 taps x 128 slots per cell) in different orders, and the plain
    version's scatter-add on the card takes an arbitrary one; momentum
    cells sum terms much larger than the result (stress against inertia),
    so the floor follows the channel's scale. Returns [(err/bound, max|err|)]."""
    out = []
    for c in range(img_p.shape[1]):
        d = (img_k[:, c] - img_p[:, c]).abs()
        bound = 2e-5 * img_p[:, c].abs().max() + 1e-5 * img_p[:, c].abs()
        out.append(((d / bound.clamp(min=1e-30)).max().item(), d.max().item()))
    return out


def g2p_errors(out_k, out_p, ints, cparams, cell_width, skip_dtb=None):
    """Kernel B against its plain version, row by row, on occupied lanes
    (empty lanes hold no particle; every consumer masks them). Returns
    [(row, group, measure, tol)] with measure <= tol required:
      kinematic (pos, vel, dt bound, drift, and copied rows): |err| over the
        row's largest magnitude, tol 1e-5 (f32 rounding of the gather sums);
      grad (velocity gradient): |err| over max(row max, invd·h·max|v|),
        tol 2e-5: the gather sums w·dpt·v terms of size invd·h·|v| that
        cancel, and f32 error follows their size;
      F: |err| over the largest |F| entry (~1: F stays near the identity,
        so an off-diagonal row's own maximum can be ~1e-7), tol 2e-5: where
        the return map projects, F is rebuilt from the cardano SVD and
        carries its f32 floor;
      stress: |err| / (lambda + 2 mu), tol 2e-5: a strain-equivalent error
        of the cardano SVD's f32 floor (~2e-5 relative on s). At rest
        |s - 1| ~ 1e-4, so eigenvectors turn on ~1e-7 changes of F and the
        stress, a product of (s - 1) and them, is not closer than that;
      energy (psi_pos, par1 = psi_pos·m): |err| / (2 sqrt(mu·e_max)·m_max),
        tol 2e-5: the same strain-equivalent floor through e = mu·Σ(s-1)²;
      plastic (pdd, ph, lvg, all in strain units): |err|, tol 2e-5;
      failed: equal (measure 0 or 1, tol 0).
    skip_dtb [D, C] leaves lanes out of the dt-bound row: EOS lanes near J
    = 1, which check_g2p holds to their own bound (eos_dtb_errors)."""
    import torch
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.math.kernel import inv_d

    r = L.Rows(3)
    occ = ((ints[:, L.I_FLAGS, :] & L.OCCUPIED) != 0)[:, None, :]
    a = torch.where(occ, out_k, 0.0)
    b = torch.where(occ, out_p, 0.0)
    if skip_dtb is not None:
        a[:, r.dtb] = torch.where(skip_dtb, 0.0, a[:, r.dtb])
        b[:, r.dtb] = torch.where(skip_dtb, 0.0, b[:, r.dtb])
    err = (a - b).abs().amax(dim=(0, 2))
    rmax = b.abs().amax(dim=(0, 2)).clamp(min=1e-30)
    lam = cparams[:, 0].max().item()
    mu = cparams[:, 1].max().item()
    vmax = b[:, r.vel : r.vel + 3].abs().max().item()
    mmax = b[:, r.mass].abs().max().item()
    emax = b[:, r.psi_pos].abs().max().item()
    escale = max(2.0 * (mu * emax) ** 0.5, 1e-30)
    fscale = b[:, r.defgrad : r.defgrad + 9].abs().max().item()
    out = []
    for k in range(r.nf):
        e = err[k].item()
        if k == r.failed:
            out.append((k, "failed", float(not torch.equal(a[:, k], b[:, k])), 0.0))
        elif r.grad <= k < r.grad + 9:
            scale = max(rmax[k].item(), inv_d(cell_width) * cell_width * vmax)
            out.append((k, "grad", e / scale, 2e-5))
        elif r.defgrad <= k < r.defgrad + 9:
            out.append((k, "F", e / fscale, 2e-5))
        elif r.stress <= k < r.stress + r.nstress:
            out.append((k, "stress", e / (lam + 2.0 * mu), 2e-5))
        elif k == r.psi_pos:
            out.append((k, "energy", e / escale, 2e-5))
        elif k == r.par1:
            out.append((k, "energy", e / (escale * max(mmax, 1e-30)), 2e-5))
        elif k in (r.pdd, r.ph, r.lvg):
            out.append((k, "plastic", e, 2e-5))
        else:
            out.append((k, "kinematic", e / rmax[k].item(), 1e-5))
    return out


def phase_kernels(pipe, state, dt):
    """Each kernel against its plain version on the main path's tensors.
    Returns {name: {max_abs_err, ms, plain_ms}}."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.sparse import transfer as T

    grid, cfg = pipe.grid, pipe._cfg
    nchunks = state.structure.num_chunks
    tables = (pipe._tab_f, pipe._tab_i)
    res = {}

    # Kernel A.
    img_k = K.p2g_fused(grid, cfg, pipe._meta, state.slots, state.ints, dt, nchunks, tables)
    img_p = K.p2g_fused_reference(grid, state.slots, state.ints, dt, nchunks, tables)
    torch.cuda.synchronize()
    err = (img_k - img_p).abs().max().item()
    per_ch = p2g_errors(img_k, img_p)
    res["p2g_fused"] = dict(max_abs_err=err)
    say(3, f"p2g_fused images {tuple(img_k.shape)}: max|err| {err:.3e}; per channel "
           f"max|err|/bound {[f'{m:.2e}' for m, _ in per_ch]} (pass <= 1)")
    failures = []
    if not (all(m <= 1.0 for m, _ in per_ch) and torch.isfinite(img_k).all().item()):
        failures.append("p2g_fused disagrees with its plain version")
    res["p2g_fused"]["ms"] = cuda_median_ms(
        lambda: K.p2g_fused(grid, cfg, pipe._meta, state.slots, state.ints, dt, nchunks,
                            tables))
    res["p2g_fused"]["plain_ms"] = cuda_median_ms(
        lambda: K.p2g_fused_reference(grid, state.slots, state.ints, dt, nchunks, tables))

    # Merge, on the rows the main path hands it.
    rows = image_rows(cfg, img_k)
    first, nblk = state.structure.block_first_chunk, state.structure.block_num_chunks
    m_k = K.merge_blocks(rows, first, nblk)
    m_p = K.merge_blocks_reference(rows, first, nblk, T.MERGE_KMAX)
    torch.cuda.synchronize()
    err = (m_k - m_p).abs().max().item()
    res["merge_blocks"] = dict(max_abs_err=err)
    say(3, f"merge_blocks {tuple(m_k.shape)}: bit-equal {torch.equal(m_k, m_p)}, max|err| {err:.3e}")
    if not torch.equal(m_k, m_p):
        failures.append("merge_blocks is not bit-equal to its plain version")
    res["merge_blocks"]["ms"] = cuda_median_ms(lambda: K.merge_blocks(rows, first, nblk))
    res["merge_blocks"]["plain_ms"] = cuda_median_ms(
        lambda: K.merge_blocks_reference(rows, first, nblk, T.MERGE_KMAX))
    # The library yardstick: one segment sum over the valid chunks' rows
    # (blocks own contiguous chunk ranges; none here holds more than kmax).
    n_valid = int(nblk.sum())
    require(int(nblk.max()) <= T.MERGE_KMAX, "a block holds more than MERGE_KMAX chunks")
    flat, lengths = rows.reshape(cfg.max_chunks, -1)[:n_valid], nblk.long()
    seg = torch.segment_reduce(flat, "sum", lengths=lengths, axis=0)
    seg_err = (seg.reshape(m_k.shape) - m_k).abs().max().item()
    res["merge_blocks"]["library_ms"] = cuda_median_ms(
        lambda: torch.segment_reduce(flat, "sum", lengths=lengths, axis=0))
    say(3, f"merge_blocks against torch.segment_reduce: max|diff| {seg_err:.3e}")

    # The scatter merge (the fluid and sparse paths' merge) on the same rows:
    # each node-table row sums its updates in ascending update order, so the
    # kernel, its plain version and a second launch are bit-equal.
    res["merge_scatter"] = check_merge_scatter(cfg, state.structure, rows, 3, " (sand3)")
    require(not failures, "; ".join(failures))

    # Kernel B, on the windows the main path computes from these images.
    res["g2p_fused"], (slots_in, windows, args) = check_g2p(pipe, state, dt, "one frame", 3)
    scratch = slots_in.clone()
    res["g2p_fused"]["ms"] = cuda_median_ms(
        lambda: K.g2p_fused(grid, cfg, pipe._meta, pipe._kparams, scratch, state.ints,
                            windows, dt, *args))
    res["g2p_fused"]["plain_ms"] = cuda_median_ms(
        lambda: K.g2p_fused_reference(grid, slots_in, state.ints, windows, dt, *args))
    traffic = substep_bytes(state.structure, cfg)
    lanes = int(((state.ints[:, L.I_FLAGS, :] & L.ACTIVE) != 0).sum())
    flops = dict(p2g_fused=lanes * (27 * P2G_TAP_FLOPS + A_SLOT_FLOPS),
                 merge_blocks=traffic["merge_blocks"] // 4,
                 g2p_fused=lanes * (27 * G2P_TAP_FLOPS + B_LANE_FLOPS))
    for name in flops:
        v = res[name]
        v["bytes"], v["flops"] = traffic[name], flops[name]
        v["bound_ms"], v["bound_by"] = bound(v["bytes"], v["flops"])
        v.setdefault("library_ms", None)
        say(3, f"{name}: kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms, library "
               f"{v['library_ms']} ms (median of 20); {traffic[name] / 1e9:.4f} GB counted from "
               f"shapes = {traffic[name] / v['ms'] / 1e6:.1f} GB/s; bound {v['bound_ms']:.4f} ms "
               f"({v['bound_by']})")
    return res


def image_rows(cfg, images):
    """Window images [D, nf, 512] (z-major) -> the merge's (chunk, corner)
    rows [D, 8, nf·64], as merge_images_to_grid forms them."""
    from sparkl_tpu_torch.sparse import transfer as T

    nf = images.shape[1]
    comb = T._merge_comb(3, nf, True, images.device)
    return images.reshape(cfg.max_chunks, -1)[:, comb].reshape(
        cfg.max_chunks, 8, nf * 64).contiguous()


def check_merge_scatter(cfg, structure, rows, phase, label="", timed=True):
    """The scatter merge kernel on `rows` [D, 8, W] (window images in
    (chunk, corner) rows) over `structure`: bit-equal to its plain version
    and to a second launch; with `timed`, times, with index_add (float
    atomics) as the library yardstick. Returns {max_abs_err, ms, plain_ms,
    library_ms, bytes, flops, bound_ms, bound_by}."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.sparse import transfer as T

    d_, ncorners, w = rows.shape
    flat = rows.reshape(d_ * ncorners, w)
    order, starts = T.scatter_plan(cfg, structure)
    out_k = K.merge_scatter(flat, order, starts)
    out_k2 = K.merge_scatter(flat, order, starts)
    out_p = K.merge_scatter_reference(flat, order, starts)
    dest = T._chunk_corners(structure).reshape(-1).long()
    zeros = torch.zeros_like(out_k)
    lib = torch.index_add(zeros, 0, dest, flat)
    torch.cuda.synchronize()
    same_p, same_k = torch.equal(out_k, out_p), torch.equal(out_k, out_k2)
    lib_err = (lib - out_k).abs().max().item()
    per_row = (starts[1:] - starts[:-1]).max().item()
    g = starts.shape[0] - 1
    v = dict(max_abs_err=(out_k - out_p).abs().max().item(), bit_equal_plain=same_p,
             bit_equal_relaunch=same_k, max_updates_per_row=per_row)
    say(phase, f"merge_scatter{label} {tuple(flat.shape)} -> {tuple(out_k.shape)}: bit-equal to "
               f"its plain version {same_p}, to a second launch {same_k}; against index_add "
               f"max|diff| {lib_err:.3e}; at most {per_row} updates per row")
    require(same_p and same_k, "merge_scatter is not bit-equal to its plain version and itself")
    if not timed:
        return v
    v["ms"] = cuda_median_ms(lambda: K.merge_scatter(flat, order, starts))
    v["plain_ms"] = cuda_median_ms(lambda: K.merge_scatter_reference(flat, order, starts))
    v["library_ms"] = cuda_median_ms(lambda: torch.index_add(zeros, 0, dest, flat))
    # Every live update row read once (dead chunks' rows are left out of the
    # plan), each node row written once, and the plan read.
    v["bytes"] = (int(starts[-1]) * w + g * w) * 4 + (order.numel() + starts.numel()) * 4
    v["flops"] = int(starts[-1]) * w
    v["bound_ms"], v["bound_by"] = bound(v["bytes"], v["flops"])
    say(phase, f"merge_scatter{label}: kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms, "
               f"library (index_add) {v['library_ms']:.3f} ms (median of 20); "
               f"{v['bytes'] / 1e9:.4f} GB counted from shapes = "
               f"{v['bytes'] / v['ms'] / 1e6:.1f} GB/s; bound {v['bound_ms']:.4f} ms "
               f"({v['bound_by']})")
    return v


def substep_bytes(structure, cfg):
    """Bytes each substep kernel must move, counted from shapes: the slot
    rows it reads for the live chunks (kernel A: 24 f32 + 4 i32 rows;
    kernel B: 32 f32 + 5 i32 rows and the [3, 512] window), what it writes
    (kernel A: every chunk's [4, 512] image; kernel B: the live chunks' 56
    rows), and for the merge each block's chunk rows (at most 8) read and
    its [8, 256] row written."""
    from sparkl_tpu_torch.sparse import transfer as T

    live, d_ = int(structure.num_chunks), cfg.max_chunks
    row = 4 * cfg.chunk_size
    block = 4 * 8 * 256
    merged = int(structure.block_num_chunks.clamp(max=T.MERGE_KMAX).sum())
    return {
        "p2g_fused": live * (24 + 4) * row + d_ * 4 * 4 * 512,
        "merge_blocks": (merged + structure.block_num_chunks.shape[0]) * block,
        "g2p_fused": live * ((32 + 5 + 56) * row + 4 * 3 * 512),
    }


def eos_dtb_errors(out_k, out_p, own, fluid):
    """Kernel B's dt-bound row on the EOS lanes of `fluid` [D, C], two ways.
    (1) Against the plain version's row, on the lanes whose J (the plain
    version's F00) lies within 1e-3 of 1. There the single-particle bound is
    h/J·sqrt(ρ0(J - 1) / (18 p)) with p ~ 7 p0 (1 - J): two factors near
    zero, each rounded on its own, so a few ulps of J and of ρ/ρ0 (~4e-7
    together) move the bound by ~2e-7/|J - 1| relative. Held to |err| <=
    |plain|·(1e-5 + 2e-6/|J - 1|), 10x that, where |J - 1| >= 1e-5; closer
    to 1 the sign of J - 1 itself turns on the last bits, and with it
    whether that bound is finite, so those lanes are required to hold a
    positive bound in both. (2) On every fluid lane, against `own` [D, C],
    the row the plain functions compute from the kernel's own output rows
    (velocity, gradient, F00, mass, vol0, failed): the same J on both sides,
    so held to 1e-5 relative, near J = 1 too. Returns (the near-1 lanes,
    worst |err|/tol of (1), or inf if a close lane is not positive, worst
    of (2), the count of lanes within 1e-5 of 1)."""
    import torch
    from sparkl_tpu_torch.fused import layout as L

    r = L.Rows(3)
    eps = (out_p[:, r.defgrad] - 1.0).abs()
    near = fluid & (eps < 1e-3)
    held = near & (eps >= 1e-5)
    close = near & ~held
    a, b = out_k[:, r.dtb], out_p[:, r.dtb]
    tol = b.abs() * (1e-5 + 2e-6 / eps.clamp(min=1e-5))
    measure = torch.where(held, (a - b).abs() / tol.clamp(min=1e-30), 0.0).max().item()
    if not bool(((a > 0.0) & (b > 0.0))[close].all()):
        measure = float("inf")
    own_tol = (1e-5 * own.abs()).clamp(min=1e-30)
    own_measure = torch.where(fluid, (a - own).abs() / own_tol, 0.0).max().item()
    return near, measure, own_measure, int(close.sum())


def check_g2p(pipe, state, dt, label, phase, need_plastic=False):
    """Kernel B against its plain version on `state`, with the windows the
    main path computes for it (kernel A, merge, grid update). Fails unless
    every row group is within its tolerance and, with need_plastic, unless
    Drucker-Prager plastic flow (a change of the hardening or plastic-volume
    row) happened on some occupied lane in both. Returns ({max_abs_err, worst_over_tol, plastic_lanes},
    (the input slots, the windows, the table arguments))."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L

    grid, cfg = pipe.grid, pipe._cfg
    r = L.Rows(3)
    nchunks = state.structure.num_chunks
    tables = (pipe._tab_f, pipe._tab_i)
    images = K.p2g_fused(grid, cfg, pipe._meta, state.slots, state.ints, dt, nchunks, tables)
    windows = pipe._grid_windows(state, images, dt)
    args = (pipe._tab_f, pipe._tab_i, nchunks)
    slots_in = state.slots.clone()
    ints_in = state.ints.clone()
    out_p = K.g2p_fused_reference(grid, slots_in, state.ints, windows, dt, *args,
                                  velocity_clamp=pipe._kparams["gpu_velocity_clamp"])
    out_k = K.g2p_fused(grid, cfg, pipe._meta, pipe._kparams, slots_in.clone(), state.ints,
                        windows, dt, *args)
    torch.cuda.synchronize()
    require(torch.equal(state.ints, ints_in), "g2p_fused touched the int rows")
    occ = (state.ints[:, L.I_FLAGS, :] & L.OCCUPIED) != 0
    ct = pipe._tab_i[:, 0][state.ints[:, L.I_MODEL, :].long()]
    # The dt-bound row the plain functions form from the kernel's own rows.
    mirror = state.replace(slots=out_k.clone())
    pipe._refresh_dtb_rows(mirror)
    near_one, eos_measure, own_measure, close = eos_dtb_errors(
        out_k, out_p, mirror.slots[:, r.dtb], occ & (ct == 2))
    row_errs = g2p_errors(out_k, out_p, state.ints, pipe.models.cparams, grid.cell_width,
                          skip_dtb=near_one)
    row_errs.append((r.dtb, "eos dtb", eos_measure, 1.0))
    row_errs.append((r.dtb, "eos dtb own rows", own_measure, 1.0))
    worst = {}
    for k, group, m, tol in row_errs:
        worst[group] = max(worst.get(group, 0.0), m / tol if tol else m)
    with open(os.path.join(OUT_DIR, f"g2p_rows_{label.replace(' ', '_')}.txt"), "w") as f:
        f.write("".join(f"row {k:2d} {g:9s} measure {m:.3e} tol {t:g}\n" for k, g, m, t in row_errs))

    def plastic_lanes(out):
        moved = (out[:, r.ph] != slots_in[:, r.ph]) | (out[:, r.pdd] != slots_in[:, r.pdd])
        return int((moved & occ).sum())

    plastic_k, plastic_p = plastic_lanes(out_k), plastic_lanes(out_p)
    res = dict(max_abs_err=torch.where(occ[:, None, :], out_k - out_p, 0.0).abs().max().item(),
               worst_over_tol=worst, plastic_lanes=plastic_k,
               eos_dtb_lanes=int(near_one.sum()), dtb_lanes_close=close)
    say(phase, f"g2p_fused on the {label} state, slots {tuple(out_k.shape)}: worst measure/tol "
               f"per row group { {g: round(v, 4) for g, v in worst.items()} } (pass <= 1; "
               f"failed row equal: {worst['failed'] == 0}); lanes with plastic flow: kernel "
               f"{plastic_k}, plain {plastic_p} of {int(occ.sum())}; fluid lanes with |J - 1| "
               f"< 1e-3 held to the EOS dt-bound tolerance: {int(near_one.sum())}, of them "
               f"within 1e-5 of 1 (checked positive, and against the bound of the kernel's own "
               f"rows as every fluid lane is): {close}")
    failures = []
    if not all(v <= 1.0 for v in worst.values()):
        failures.append(f"g2p_fused disagrees with its plain version on the {label} state")
    if not torch.isfinite(out_k).all().item():
        failures.append(f"g2p_fused wrote non-finite values on the {label} state")
    if need_plastic and min(plastic_k, plastic_p) == 0:
        failures.append(f"no plastic flow on the {label} state: the return map went unchecked")
    require(not failures, "; ".join(failures))
    return res, (slots_in, windows, args)


def phase_small_agreement():
    """One frame of sand3 at nx=12, ny=6, nz=6 through the kernels on the
    card against the port's CPU path (plain versions), per particle, with
    the JAX package's fused-vs-dense tolerances."""
    import torch
    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline

    out = {}
    for dev in ("cuda", "cpu"):
        b = scenes.build("sand3", nx=12, ny=6, nz=6, device=dev)
        pipe = FusedMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity, device=dev)
        p, n = pipe.step_with_stats(b.particles)
        out[dev] = (p.to("cpu"), n)
    (pg, ng), (pc, nc) = out["cuda"], out["cpu"]
    act = pc.active
    dpos = (pg.position[act] - pc.position[act]).abs().max().item()
    dvel = (pg.velocity[act] - pc.velocity[act]).abs().max().item()
    df = (pg.deformation_gradient[act] - pc.deformation_gradient[act]).abs().max().item()
    say(3, f"small sand3 frame, card vs CPU: substeps {ng}/{nc}, max|dpos| {dpos:.2e} "
           f"(5e-5), max|dvel| {dvel:.2e} (5e-4), max|dF| {df:.2e} (5e-4)")
    require(ng == nc and torch.equal(pg.active, pc.active)
            and torch.equal(pg.failed[act], pc.failed[act]), "small frame: flags differ")
    require(dpos <= 5e-5 and dvel <= 5e-4 and df <= 5e-4, "small frame: card and CPU disagree")


def phase_resort(pipe, pre):
    """The resort kernels against their plain versions on `pre`, the state
    the main path's first resort started from, bit for bit; then that whole
    resort on the card against the same resort of a CPU copy (the plain
    versions and torch on the CPU), bit for bit, slots, ints and structure.
    Returns ({name: {max_abs_err, ms, plain_ms, bytes}}, resort ms)."""
    import torch
    from sparkl_tpu_torch import interop
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.fused import structure as S

    grid, cfg = pipe.grid, pipe._cfg
    r = L.Rows(3)
    c, d_ = cfg.chunk_size, cfg.max_chunks
    dev = pre.slots.device
    pos, active, occupied = L.slot_positions(pre, 3)
    structure, sort_order, chunk_start = S.build_slot_structure(grid, cfg, pos, active, occupied)
    order2, shifts = L.source_order_rows(cfg, sort_order, chunk_start)
    src_k = K.src_rows_from_order(order2, shifts)
    src_p = K.src_rows_from_order_reference(order2, shifts)
    lanes = torch.arange(c, dtype=torch.int32, device=dev)[None, :]
    valid = lanes < structure.chunk_count[:, None]
    own = torch.arange(d_, dtype=torch.int32, device=dev)[:, None] * c + lanes
    moved = int((valid & (src_p != own)).sum())
    n_valid = int(valid.sum())
    res = {"src_rows_from_order": dict(
        max_abs_err=float((src_k - src_p).abs().max().item()), bytes=d_ * 3 * 4 * c)}
    say(5, f"src_rows_from_order {tuple(src_k.shape)}: bit-equal {torch.equal(src_k, src_p)}; "
           f"{moved} of {n_valid} occupied lanes take another slot's particle")
    require(torch.equal(src_k, src_p), "src_rows_from_order is not equal to its plain version")
    require(moved > 0, "the resort state moves no particle: the permute went unchecked")

    src = torch.where(valid, src_k, -1)
    args = (pre.slots, pre.ints, src, structure.chunk_origin, r.cumd)
    out_k = K.permute_slots(*args)
    out_p = K.permute_slots_reference(*args)
    equal = all(torch.equal(x, y) for x, y in zip(out_k, out_p))
    # Source chunks per live destination: the JAX package's DMA permute
    # takes at most 8 and falls back to a per-slot gather past that.
    src_chunk = torch.where(valid, src_k // c, -1)
    sc = torch.sort(src_chunk, dim=1).values
    nsrc = ((sc[:, 1:] != sc[:, :-1]) & (sc[:, 1:] >= 0)).sum(dim=1) + (sc[:, 0] >= 0)
    nsrc = nsrc[structure.chunk_count > 0].float()
    res["permute_slots"] = dict(
        max_abs_err=max((out_k[0] - out_p[0]).abs().max().item(),
                        float((out_k[1] - out_p[1]).abs().max().item())),
        bytes=(n_valid + d_ * c) * 4 * (r.nf + L.NI))
    say(5, f"permute_slots slots {tuple(out_k[0].shape)}: bit-equal to its plain version "
           f"{equal}; source chunks per live destination mean {nsrc.mean().item():.3f}, "
           f"max {int(nsrc.max().item())}, {int((nsrc > 8).sum())} destinations above 8")
    require(equal, "permute_slots is not equal to its plain version")
    # The library yardsticks: one gather each, with the index precomputed.
    j = torch.clamp(shifts[:, None].long() + torch.arange(c, device=dev)[None, :], 0, 2 * c - 1)
    order_rows = order2.reshape(d_, 2 * c)
    src_safe = torch.where(src >= 0, src, 0).long()
    sc, sl = src_safe // c, src_safe % c
    for name, fn, plain, lib in (
            ("src_rows_from_order", lambda: K.src_rows_from_order(order2, shifts),
             lambda: K.src_rows_from_order_reference(order2, shifts),
             lambda: torch.gather(order_rows, 1, j)),
            ("permute_slots", lambda: K.permute_slots(*args),
             lambda: K.permute_slots_reference(*args),
             lambda: (pre.slots[sc, :, sl], pre.ints[sc, :, sl]))):
        v = res[name]
        v["ms"], v["plain_ms"], v["library_ms"] = (
            cuda_median_ms(fn), cuda_median_ms(plain), cuda_median_ms(lib))
        v["flops"] = 0
        v["bound_ms"], v["bound_by"] = bound(v["bytes"], 0)
        say(5, f"{name}: kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms, library (one "
               f"gather) {v['library_ms']:.3f} ms (median of 20); {v['bytes'] / 1e9:.4f} GB counted "
               f"from shapes = {v['bytes'] / v['ms'] / 1e6:.1f} GB/s; bound {v['bound_ms']:.4f} ms")

    def run(state):
        out, ov, branch = L.resort(grid, cfg, state, 3)
        return out, bool(ov), branch

    out_g, ov_g, branch_g = run(pre)
    out_c, ov_c, branch_c = run(interop.slot_state_from_numpy(interop.slot_state_to_numpy(pre),
                                                              device="cpu"))
    pairs = dict(slots=(out_g.slots, out_c.slots), ints=(out_g.ints, out_c.ints))
    pairs.update({k: (v, out_c.structure.tensors()[k])
                  for k, v in out_g.structure.tensors().items()})
    differ = {k: int((g.cpu() != c).sum()) for k, (g, c) in pairs.items()
              if not torch.equal(g.cpu(), c)}
    same = not differ
    resort_ms = cuda_median_ms(lambda: L.resort(grid, cfg, pre, 3), reps=5)
    say(5, f"whole resort, card against a CPU copy: branches {branch_g} / {branch_c}, overflow "
           f"{ov_g} / {ov_c}, slots, ints and structure bit-equal {same}; card {resort_ms:.3f} ms "
           f"(median of 5, host reads included)")
    require(same and branch_g == branch_c and ov_g == ov_c and not ov_g,
            f"the resort on the card differs from the CPU resort (elements differing: {differ})")
    return res, resort_ms


def perturbed_f(state, seed=7):
    """`state` with F += 0.02·N(0, 1) (numpy seed) on occupied lanes: strains
    of a few percent, past the Drucker-Prager cone on many lanes."""
    import numpy as np
    import torch
    from sparkl_tpu_torch.fused import layout as L

    r = L.Rows(3)
    d_, _, c = state.slots.shape
    noise = np.random.default_rng(seed).normal(scale=0.02, size=(d_, 9, c)).astype(np.float32)
    occ = ((state.ints[:, L.I_FLAGS, :] & L.OCCUPIED) != 0)[:, None, :]
    slots = state.slots.clone()
    slots[:, r.defgrad : r.defgrad + 9] += torch.where(
        occ, torch.from_numpy(noise).to(slots.device), 0.0)
    return state.replace(slots=slots)


def capture_window_inputs(pipe, p):
    """The window kernels' inputs (slot data, velocity windows) of the first
    substep of one frame from `p` on the sparse path, recorded as the
    pipeline hands them to the kernels."""
    from sparkl_tpu_torch.ops import transfer_kernels as WK

    got = {}
    p2g, g2p = WK.p2g_windows, WK.g2p_windows

    def rec_p2g(grid, cfg, slot_data, with_psi=True):
        got.setdefault("slot_data", slot_data.clone())
        return p2g(grid, cfg, slot_data, with_psi=with_psi)

    def rec_g2p(grid, cfg, slot_data, windows, with_psi=True):
        got.setdefault("windows", windows.clone())
        return g2p(grid, cfg, slot_data, windows, with_psi=with_psi)

    WK.p2g_windows, WK.g2p_windows = rec_p2g, rec_g2p
    try:
        pipe.step_with_stats(p)
    finally:
        WK.p2g_windows, WK.g2p_windows = p2g, g2p
    return got["slot_data"], got["windows"]


def g2p_window_errors(out_k, out_p, valid, win, cell_width):
    """The G2P window kernel against its plain version, row by row over the
    valid slots (padded slots hold no particle; no caller reads them):
    max|kernel - plain| over the bound 2e-5 * scale + 1e-5 * |plain|. The
    scale is the row's largest magnitude, and for a gradient row at least
    invd·h·max|window velocity|: the gather sums w·dpt·v terms of that
    size, which cancel. Both sum the same 27 products per slot in other
    orders. Returns [(err/bound, max|err|)]."""
    import torch
    from sparkl_tpu_torch.math.kernel import inv_d

    m = valid[:, None, :]
    a, b = torch.where(m, out_k, 0.0), torch.where(m, out_p, 0.0)
    vscale = inv_d(cell_width) * cell_width * win[:, :3].abs().max().item()
    out = []
    for r in range(b.shape[1]):
        d = (a[:, r] - b[:, r]).abs()
        scale = b[:, r].abs().max().item()
        if 3 <= r < 12:
            scale = max(scale, vscale)
        bnd = 2e-5 * scale + 1e-5 * b[:, r].abs()
        out.append(((d / bnd.clamp(min=1e-30)).max().item(), d.max().item()))
    return out


def phase_window_kernels(grid, cfg, slot_data, windows):
    """Both window kernels against their plain versions on the sparse
    path's own inputs, without the psi channels (the path) and with them
    (numpy-seeded psi rows and window channel); times of the path's form.
    Returns {name: {max_abs_err, ms, plain_ms, library_ms, bytes, flops,
    bound_ms, bound_by, with_psi}}."""
    import numpy as np
    import torch
    from sparkl_tpu_torch.ops import transfer_kernels as WK

    dev = slot_data.device
    d_, _, c = slot_data.shape
    valid = slot_data[:, 3, :] != 0.0  # the mass row; padded slots are zero
    n_valid = int(valid.sum())
    rng = np.random.default_rng(5)
    res = {name: {} for name in SPARSE_KERNELS}
    for psi in (False, True):
        sd, win = slot_data, windows
        if psi:
            sd = slot_data.clone()
            noise = rng.uniform(0.5, 1.5, size=(d_, 2, c)).astype(np.float32)
            sd[:, 16:18] = torch.from_numpy(noise).to(dev) * valid[:, None, :]
            extra = rng.normal(size=(d_, 1, 512)).astype(np.float32)
            win = torch.cat([windows, torch.from_numpy(extra).to(dev)], dim=1)
        img_k = WK.p2g_windows(grid, cfg, sd, with_psi=psi)
        img_p = WK.p2g_windows_reference(grid, sd, psi)
        out_k = WK.g2p_windows(grid, cfg, sd, win, with_psi=psi)
        out_p = WK.g2p_windows_reference(grid, sd, win, psi)
        torch.cuda.synchronize()
        per_ch = p2g_errors(img_k, img_p)
        per_row = g2p_window_errors(out_k, out_p, valid, win, grid.cell_width)
        errs = {"p2g_windows": per_ch, "g2p_windows": per_row}
        finite = torch.isfinite(img_k).all().item() and torch.isfinite(
            torch.where(valid[:, None, :], out_k, 0.0)).all().item()
        for name, e in errs.items():
            res[name]["with_psi" if psi else "path"] = dict(
                max_abs_err=max(x for _, x in e), worst_over_bound=max(m for m, _ in e))
            say(6, f"{name} with_psi={psi}: max|err| {max(x for _, x in e):.3e}; per "
                   f"{'channel' if name == 'p2g_windows' else 'row'} max|err|/bound "
                   f"{[f'{m:.2e}' for m, _ in e]} (pass <= 1)")
        require(finite and all(m <= 1.0 for e in errs.values() for m, _ in e),
                f"a window kernel disagrees with its plain version (with_psi={psi})")
    sd0 = slot_data
    res["p2g_windows"].update(
        ms=cuda_median_ms(lambda: WK.p2g_windows(grid, cfg, sd0, with_psi=False)),
        plain_ms=cuda_median_ms(lambda: WK.p2g_windows_reference(grid, sd0, False)),
        bytes=d_ * (16 * c + 4 * 512) * 4, flops=n_valid * 27 * P2G_TAP_FLOPS)
    res["g2p_windows"].update(
        ms=cuda_median_ms(lambda: WK.g2p_windows(grid, cfg, sd0, windows, with_psi=False)),
        plain_ms=cuda_median_ms(lambda: WK.g2p_windows_reference(grid, sd0, windows, False)),
        bytes=d_ * (3 * c + 3 * 512 + 12 * c) * 4, flops=n_valid * 27 * G2P_TAP_FLOPS)
    for name, v in res.items():
        v["max_abs_err"] = v["path"]["max_abs_err"]
        v["library_ms"] = None
        v["bound_ms"], v["bound_by"] = bound(v["bytes"], v["flops"])
        say(6, f"{name}: kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms (median of 20); "
               f"{v['bytes'] / 1e9:.4f} GB counted from shapes = {v['bytes'] / v['ms'] / 1e6:.1f} "
               f"GB/s; bound {v['bound_ms']:.4f} ms ({v['bound_by']}); {d_} chunks, "
               f"{n_valid} valid slots")
    return res


def phase_sparse_main(b):
    """The sparse main path: SPARSE_FRAMES frames of sand3@1M through
    step_with_stats and then run_frames, the last SPARSE_TIMED timed, with
    the window kernels' launches held against the substeps. Returns (the
    pipeline, the particles, the window kernels' launches, results)."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.ops import transfer_kernels as WK
    from sparkl_tpu_torch.sparse.pipeline import SparseMpmPipeline

    n_active = int(b.particles.active.sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pipe = SparseMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity, device="cuda")
    mass0 = b.particles.mass[b.particles.active].double().sum().item()
    p = b.particles
    substeps = 0
    WK.reset_launch_counts()
    K.reset_launch_counts()
    for _ in range(SPARSE_FRAMES - SPARSE_TIMED):
        p, n = pipe.step_with_stats(p)
        substeps += n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, timed = pipe.run_frames(p, SPARSE_TIMED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(WK.LAUNCHES, merge_scatter=K.LAUNCHES["merge_scatter"])
    substeps += timed
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    act = p.active
    deact = b.particles.mass[b.particles.active & ~act].double().sum().item()
    mass = p.mass[act].double().sum().item()
    pups = n_active * timed / seconds
    say(7, f"sparse path, {SPARSE_FRAMES} frames: {substeps} substeps, {pipe._cfg}; last "
           f"{SPARSE_TIMED} frames {timed} substeps in {seconds:.3f} s = {pups:.4g} "
           f"particle-updates/s; peak memory {peak_gib:.2f} GiB; launches {launches}; mass "
           f"{mass:.6e} (initial {mass0:.6e}, deactivated {deact:.3e})")
    require(bool(torch.isfinite(p.position[act]).all()), "sparse path: non-finite positions")
    require(abs(mass - (mass0 - deact)) <= 1e-6 * mass0, "sparse path: active mass not conserved")
    # The window kernels and the scatter merge once per substep.
    expect = {name: substeps for name in SPARSE_KERNELS + ("merge_scatter",)}
    require(launches == expect, f"sparse path launch counts {launches}, expected {expect}")
    return pipe, p, launches, dict(substeps=substeps, timed_substeps=timed, seconds=seconds,
                                   pups=pups, peak_gib=peak_gib, config=str(pipe._cfg))


def profile_sparse_frame(pipe, p):
    """One sparse frame under torch.profiler, with a named range around each
    stage (set here, not in the library). Writes the table to
    chiprun_out/sparse_profile.txt; returns {stage: device ms}, the device's
    busy and wall ms and its idle share."""
    import importlib
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    stages = [
        ("sparkl_tpu_torch.solver.dense", "mark_out_of_grid_failed", "mark out of grid"),
        ("sparkl_tpu_torch.sparse.blocks", "build_structure", "build_structure"),
        ("sparkl_tpu_torch.solver.dense", "adaptive_timestep", "adaptive dt"),
        ("sparkl_tpu_torch.models.registry", "kirchhoff_stress", "stress (SVD)"),
        ("sparkl_tpu_torch.ops.transfer_kernels", "pack_p2g_inputs", "pack"),
        ("sparkl_tpu_torch.ops.transfer_kernels", "gather_slot_data", "slot gather"),
        ("sparkl_tpu_torch.ops.transfer_kernels", "p2g_windows", "p2g_windows kernel"),
        ("sparkl_tpu_torch.sparse.transfer", "merge_images_to_grid", "scatter merge"),
        ("sparkl_tpu_torch.solver.dense", "grid_update", "grid update"),
        ("sparkl_tpu_torch.geometry.colliders", "Collider.project_point",
         "heightfield projection (in grid update)"),
        ("sparkl_tpu_torch.sparse.transfer", "gather_grid_windows", "window gather"),
        ("sparkl_tpu_torch.ops.transfer_kernels", "g2p_windows", "g2p_windows kernel"),
        ("sparkl_tpu_torch.sparse.transfer", "gather_slot_rows", "slot rows to particles"),
        ("sparkl_tpu_torch.solver.dense", "particle_update_after_gather", "particle update"),
        ("sparkl_tpu_torch.models.registry", "apply_plasticity",
         "SVD + return map (in particle update)"),
        ("sparkl_tpu_torch.models.registry", "pos_energy", "pos energy (in particle update)"),
    ]
    saved = []
    for mod_name, attr, label in stages:
        owner = importlib.import_module(mod_name)
        if "." in attr:
            cls, attr = attr.split(".")
            owner = getattr(owner, cls)
        fn = getattr(owner, attr)

        def wrapped(*a, _fn=fn, _label=label, **kw):
            with record_function(_label):
                return _fn(*a, **kw)

        saved.append((owner, attr, fn))
        setattr(owner, attr, wrapped)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, _ = pipe.step_with_stats(p)  # the same frame's wall time without the profiler
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, n = pipe.step_with_stats(p)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)

    # Device time from the device's own timeline. Each named range has
    # device-side spans, each the hull of the kernels launched directly in
    # it (a nested range's kernels lie outside its parent's hull when the
    # parent launches nothing after them). So a kernel goes to the innermost
    # range whose span holds its midpoint, and a stage's time adds its nested
    # stages' (`nested`). The port's own kernels, launched through ctypes,
    # belong to no torch op, so the host-side op tree would miss them.
    nested = {"heightfield projection (in grid update)": "grid update",
              "SVD + return map (in particle update)": "particle update",
              "pos energy (in particle update)": "particle update"}
    labels = [label for _, _, label in stages]
    spans = {label: [] for label in labels}
    kernels = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name in spans:
            spans[e.name].append((e.time_range.start, e.time_range.end))
        else:
            us = e.time_range.elapsed_us()
            kernels.append((e.time_range.start + us / 2, us, e.name))
    require(all(spans.values()), "the profiler recorded no device spans for the named ranges")
    flat = sorted((b - a, a, b, label) for label, ss in spans.items() for a, b in ss)
    split = dict.fromkeys(labels + ["other"], 0.0)
    for t, us, _ in kernels:
        label = next((lb for _, a, b, lb in flat if a <= t <= b), "other")
        while label:
            split[label] += us / 1e3
            label = nested.get(label)
    busy_ms = sum(us for _, us, _ in kernels) / 1e3
    split["of which sort kernels (in build_structure)"] = sum(
        us for _, us, name in kernels if "sort" in name.lower()) / 1e3
    idle = 1.0 - busy_ms / wall_ms
    idle_plain = 1.0 - busy_ms / plain_wall_ms
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60)
    with open(os.path.join(OUT_DIR, "sparse_profile.txt"), "w") as f:
        f.write(f"{n} substeps; wall {wall_ms:.3f} ms profiled, {plain_wall_ms:.3f} ms not; "
                f"device busy {busy_ms:.3f} ms; idle share {idle:.3f} profiled, "
                f"{idle_plain:.3f} against the unprofiled wall\n")
        f.write("".join(f"{k:45s} {v:9.3f} ms\n" for k, v in split.items()))
        f.write(table)
    say(7, f"profiled sparse frame: {n} substeps, wall {wall_ms:.2f} ms ({plain_wall_ms:.2f} ms "
           f"unprofiled), device busy {busy_ms:.2f} ms, idle share {idle:.3f} "
           f"({idle_plain:.3f} of the unprofiled wall); device ms per frame "
           f"{ {k: round(v, 3) for k, v in split.items()} }")
    require(busy_ms > 0.0, "the profiler saw no device time")
    return dict(substeps=n, wall_ms=wall_ms, plain_wall_ms=plain_wall_ms, busy_ms=busy_ms,
                idle_share=idle, idle_share_unprofiled=idle_plain, split_ms=split)


def phase_sparse_vs_fused(b):
    """One frame of sand3@1M from the same scene through each path on the
    card. Both compute the same physics; they differ in summation orders
    (the sparse merge sums each node row in update order, the fused one
    per owner block and corner) and in where the stress is formed (per
    substep, or cached by kernel B), so positions and velocities agree to
    rounding that grows over the frame's substeps. The sparse frame runs
    twice, and the two are bit-equal: no kernel or torch op on the path
    sums with float atomics."""
    import torch
    from sparkl_tpu_torch import interop
    from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
    from sparkl_tpu_torch.sparse.pipeline import SparseMpmPipeline

    args = (b.grid, b.models, b.colliders, b.params, b.gravity)
    pf, nf = FusedMpmPipeline(*args, device="cuda").step_with_stats(b.particles)
    ps, ns = SparseMpmPipeline(*args, device="cuda").step_with_stats(b.particles)
    ps2, ns2 = SparseMpmPipeline(*args, device="cuda").step_with_stats(b.particles)
    a, a2 = interop.particles_to_numpy(ps), interop.particles_to_numpy(ps2)
    differ = [k for k in a if not (a[k] == a2[k]).all()]
    say(8, f"sand3@1M one sparse frame twice: substeps {ns}/{ns2}, bit-equal in every particle "
           f"field {not differ} (differ: {differ})")
    require(not differ and ns == ns2,
            f"two sparse frames from the same particles differ in {differ}")
    act = pf.active
    dx = (ps.position[act] - pf.position[act]).abs().max().item()
    dv = (ps.velocity[act] - pf.velocity[act]).abs().max().item()
    vmax = pf.velocity[act].abs().max().item()
    same = torch.equal(ps.active, pf.active) and torch.equal(ps.failed[act], pf.failed[act])
    say(8, f"sand3@1M one frame, sparse against fused: substeps {ns}/{nf}, max|dx| {dx:.3e} "
           f"({SPARSE_FUSED_DX:g}), max|dv| {dv:.3e} ({SPARSE_FUSED_DV:g}; max|v| {vmax:.3f}), "
           f"active and failed equal {same}")
    require(ns == nf and same, "sparse and fused paths: substeps or flags differ")
    require(dx <= SPARSE_FUSED_DX and dv <= SPARSE_FUSED_DV, "sparse and fused paths disagree")
    return dict(substeps=(ns, nf), max_dx=dx, max_dv=dv, repeat_bit_equal=not differ)


def phase_small_sparse():
    """One frame of sand3 at nx=12, ny=6, nz=6 through the sparse path on
    the card against the port's CPU path (plain versions), per particle,
    with the JAX package's fused-vs-dense tolerances."""
    import torch
    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch.sparse.blocks import BlockConfig
    from sparkl_tpu_torch.sparse.pipeline import SparseMpmPipeline

    cfg = BlockConfig(max_blocks=32, max_chunks=32, chunk_size=128, max_grid_blocks=64)
    out = {}
    for dev in ("cuda", "cpu"):
        b = scenes.build("sand3", nx=12, ny=6, nz=6, device=dev)
        pipe = SparseMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity,
                                 config=cfg, device=dev)
        p, n = pipe.step_with_stats(b.particles)
        out[dev] = (p.to("cpu"), n)
    (pg, ng), (pc, nc) = out["cuda"], out["cpu"]
    act = pc.active
    dpos = (pg.position[act] - pc.position[act]).abs().max().item()
    dvel = (pg.velocity[act] - pc.velocity[act]).abs().max().item()
    df = (pg.deformation_gradient[act] - pc.deformation_gradient[act]).abs().max().item()
    say(8, f"small sand3 frame, sparse path, card vs CPU: substeps {ng}/{nc}, max|dpos| "
           f"{dpos:.2e} (5e-5), max|dvel| {dvel:.2e} (5e-4), max|dF| {df:.2e} (5e-4)")
    require(ng == nc and torch.equal(pg.active, pc.active)
            and torch.equal(pg.failed[act], pc.failed[act]), "small sparse frame: flags differ")
    require(dpos <= 5e-5 and dvel <= 5e-4 and df <= 5e-4,
            "small sparse frame: card and CPU disagree")
    return dict(max_dpos=dpos, max_dvel=dvel, max_df=df)


def fluid_blob(device="cuda"):
    """fluids3 with each axis of its particle counts x4: 972,800 particles,
    the same origin, radius, density and Monaghan EOS (p0 = 1e6, gamma 7,
    viscosity 1.01e-3), cell width 0.8, fluid volume recomputation, the grid
    box grown by fluids3's own margins around the larger blob. Built from
    the port's public pieces; scenes.build("fluids3") keeps the published
    size."""
    import sparkl_tpu_torch as sk
    from sparkl_tpu_torch import device as _device
    from sparkl_tpu_torch.models import registry as reg
    from sparkl_tpu_torch.scenes import SceneBundle

    device = _device.resolve(device)
    models = reg.ModelSet.pack(
        [reg.ParticleModel(reg.monaghan_sph_eos(1.0e6, 7, 1.01e-3, 1.0))], device)
    particles = sk.cube_particles(origin=(1.6, 1.6, 1.6), counts=FLUID_COUNTS, model_id=0,
                                  particle_radius=0.1, density0=1000.0, device=device)
    return SceneBundle(
        name="fluids3x4", grid=sk.GridParams.for_domain(*FLUID_BOX, 0.8, pad=2), models=models,
        colliders=(), particles=particles,
        params=sk.SolverParameters(dt=1.0 / 60.0, force_fluids_volume_recomputation=True),
        gravity=(0.0, -9.81, 0.0))


def phase_fluid_kernels(pipe, state, dt, label, phase, timed):
    """The fluid path's kernels against their plain versions on `state`:
    the mass P2G (images), the mass gather (on the windows the volume pass
    builds from the kernel's images), kernel A (fresh EOS stress) and
    kernel B (fluid branch). With `timed`, each kernel's and plain
    version's median time. Returns {name: {...}}."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.sparse import transfer as T

    grid, cfg = pipe.grid, pipe._cfg
    nch = state.structure.num_chunks
    tables = (pipe._tab_f, pipe._tab_i)
    sl, ints = state.slots, state.ints
    m_k = K.mass_p2g_fused(grid, cfg, sl, ints, nch)
    m_p = K.mass_p2g_fused_reference(grid, sl, ints, nch)
    node, _ = T.merge_images_to_grid(grid, cfg, state.structure, m_k,
                                     cell_order=T.ZMAJOR_ORDER_3D,
                                     force_scatter=pipe._merge_force_scatter,
                                     plan=state.grid_cache[2])
    win = T.gather_grid_windows(grid, cfg, state.structure, node,
                                cell_order=T.ZMAJOR_ORDER_3D).contiguous()
    g_k = K.mass_g2p_fused(grid, cfg, sl, ints, win, nch)
    g_p = K.mass_g2p_fused_reference(grid, sl, ints, win, nch)
    a_k = K.p2g_fused(grid, cfg, pipe._meta, sl, ints, dt, nch, tables)
    a_p = K.p2g_fused_reference(grid, sl, ints, dt, nch, tables)
    torch.cuda.synchronize()
    # Mass images: the same positive f32 terms summed in other orders (the
    # plain version's scatter-add takes an arbitrary one on the card):
    # p2g_errors's bound. The gather: the same products summed in the same
    # order, so within 1e-6 of the largest value (f32 rounding only).
    res = {}
    m_err = p2g_errors(m_k, m_p)[0]
    g_scale = g_p.abs().max().item()
    g_err = (g_k - g_p).abs().max().item()
    a_err = p2g_errors(a_k, a_p)
    res["mass_p2g_fused"] = dict(max_abs_err=m_err[1], over_bound=m_err[0])
    res["mass_g2p_fused"] = dict(max_abs_err=g_err, bit_equal=torch.equal(g_k, g_p),
                                 rel_err=g_err / max(g_scale, 1e-30))
    res["p2g_fused"] = dict(max_abs_err=max(e for _, e in a_err),
                            over_bound=max(m for m, _ in a_err))
    say(phase, f"fluid kernels on the {label} state: mass_p2g_fused max|err| {m_err[1]:.3e} "
               f"({m_err[0]:.2e} of its bound); mass_g2p_fused max|err| {g_err:.3e} (relative "
               f"{g_err / max(g_scale, 1e-30):.2e}, pass <= 1e-6; bit-equal "
               f"{torch.equal(g_k, g_p)}); p2g_fused (EOS stress) per channel max|err|/bound "
               f"{[f'{m:.2e}' for m, _ in a_err]} (pass <= 1)")
    finite = all(torch.isfinite(x).all().item() for x in (m_k, g_k, a_k))
    require(finite and m_err[0] <= 1.0 and g_err <= 1e-6 * g_scale
            and all(m <= 1.0 for m, _ in a_err),
            f"a fluid kernel disagrees with its plain version on the {label} state")
    res["g2p_fused"], (slots_in, windows, args) = check_g2p(pipe, state, dt, label, phase)
    # The scatter merge on the path's two kinds of rows: kernel A's images
    # (nf = 4, the row the kernels line reports) and the mass images (nf = 1).
    res["merge_scatter"] = check_merge_scatter(cfg, state.structure, image_rows(cfg, a_k),
                                               phase, " (fluid, kernel A images)", timed)
    res["merge_scatter"]["mass"] = check_merge_scatter(
        cfg, state.structure, image_rows(cfg, m_k), phase, " (fluid, mass images)", timed)
    if not timed:
        return res
    live = int(nch)
    row = 4 * cfg.chunk_size
    lanes = int(((ints[:, L.I_FLAGS, :] & L.ACTIVE) != 0).sum())
    # Bytes counted from what the fluid branches need on the blob's
    # all-fluid lanes, per live chunk: kernel A reads pos 3, vel 3, mass,
    # vol0, grad 9, F00 and failed (19 f32 rows; no stress-cache row) and
    # flags and the origin (4 i32 rows), and writes every chunk's [4, 512]
    # image; kernel B reads pos 3, F00, mass, vol0, failed and the drift (8
    # f32 rows), flags, model and origin (5 i32 rows) and the [3, 512]
    # window, and changes pos 3, vel 3, grad 9, F00, the dt bound, failed
    # and the drift (19 rows; the rest of F, the plastic, energy and
    # stress-cache rows stay as they are for fluids).
    a_rows, b_read, b_written = 19 + 4, 8 + 5, 19
    for name, fn, plain, nbytes, flops in (
            ("mass_p2g_fused", lambda: K.mass_p2g_fused(grid, cfg, sl, ints, nch),
             lambda: K.mass_p2g_fused_reference(grid, sl, ints, nch),
             live * 8 * row + cfg.max_chunks * 512 * 4, lanes * 27 * MASS_TAP_FLOPS),
            ("mass_g2p_fused", lambda: K.mass_g2p_fused(grid, cfg, sl, ints, win, nch),
             lambda: K.mass_g2p_fused_reference(grid, sl, ints, win, nch),
             live * (8 * row + 512 * 4) + cfg.max_chunks * row, lanes * 27 * MASS_TAP_FLOPS),
            ("p2g_fused", lambda: K.p2g_fused(grid, cfg, pipe._meta, sl, ints, dt, nch, tables),
             lambda: K.p2g_fused_reference(grid, sl, ints, dt, nch, tables),
             live * a_rows * row + cfg.max_chunks * 4 * 4 * 512,
             lanes * (27 * P2G_TAP_FLOPS + A_SLOT_FLOPS + EOS_SLOT_FLOPS))):
        v = res[name]
        v["ms"], v["plain_ms"] = cuda_median_ms(fn), cuda_median_ms(plain)
        v["bytes"], v["flops"], v["library_ms"] = nbytes, flops, None
        v["bound_ms"], v["bound_by"] = bound(nbytes, flops)
    scratch = slots_in.clone()
    v = res["g2p_fused"]
    v["ms"] = cuda_median_ms(lambda: K.g2p_fused(grid, cfg, pipe._meta, pipe._kparams, scratch,
                                                 ints, windows, dt, *args))
    v["plain_ms"] = cuda_median_ms(
        lambda: K.g2p_fused_reference(grid, slots_in, ints, windows, dt, *args))
    v["bytes"] = live * ((b_read + b_written) * row + 4 * 3 * 512)
    v["flops"] = lanes * (27 * G2P_TAP_FLOPS + B_FLUID_LANE_FLOPS)
    v["library_ms"] = None
    v["bound_ms"], v["bound_by"] = bound(v["bytes"], v["flops"])
    for name, v in res.items():
        if name == "merge_scatter":
            continue
        say(phase, f"{name} (fluid): kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms "
                   f"(median of 20); {v['bytes'] / 1e9:.4f} GB counted from shapes = "
                   f"{v['bytes'] / v['ms'] / 1e6:.1f} GB/s; bound {v['bound_ms']:.4f} ms "
                   f"({v['bound_by']})")
    return res


def phase_fluid_main(b):
    """The fluid main path: pack_state -> FLUID_FRAMES frames of
    run_frames_state (the last FLUID_TIMED timed) -> unpack_state on the
    blob, with the kernels' launches held against the substeps and the
    resort branches. Returns (the pipeline, a copy of the state after the
    first frame, the final state, the launches, results)."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline

    n_active = int(b.particles.active.sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pipe = FusedMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity, device="cuda")
    state = pipe.pack_state(b.particles)
    mass0 = b.particles.mass[b.particles.active].double().sum().item()
    K.reset_launch_counts()
    substeps = resorts = 0
    first = None
    for i in range(FLUID_FRAMES - FLUID_TIMED):
        state, n = pipe.run_frames_state(state, 1)
        substeps += n
        resorts += pipe.last_resorts
        if first is None:
            first = state.replace(slots=state.slots.clone())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = 0
    for _ in range(FLUID_TIMED):
        state, n = pipe.run_frames_state(state, 1)
        timed += n
        resorts += pipe.last_resorts
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    substeps += timed
    launches = dict(K.LAUNCHES)
    branches = dict(pipe.resort_branches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    p = pipe.unpack_state(state)
    act = p.active
    deact = b.particles.mass[b.particles.active & ~act].double().sum().item()
    mass = p.mass[act].double().sum().item()
    pups = n_active * timed / seconds
    say(10, f"fluid path, {FLUID_FRAMES} frames: {substeps} substeps, {resorts} resorts "
            f"{branches}; scatter merge pinned {pipe._merge_force_scatter}; {pipe._cfg}; peak "
            f"memory {peak_gib:.2f} GiB; launches {launches}; mass {mass:.6e} (initial "
            f"{mass0:.6e}, deactivated {deact:.3e})")
    say(10, f"fluid path: last {FLUID_TIMED} frames {timed} substeps in {seconds:.3f} s = "
            f"{pups:.4g} particle-updates/s")
    require(bool(torch.isfinite(p.position[act]).all()), "fluid path: non-finite positions")
    require(abs(mass - (mass0 - deact)) <= 1e-6 * mass0, "fluid path: active mass not conserved")
    require(resorts >= 1 and sum(branches.values()) == resorts,
            f"the fluid path took {resorts} lazy resorts, branches {branches}")
    # Per substep: A, B and the two mass kernels once, the scatter merge
    # twice (kernel A's images and the mass images: 4^3-cell blocks of 4096
    # particles hold 32 chunks, past MERGE_KMAX, so the merge is pinned to
    # the scatter and merge_blocks never runs); per resort the resort
    # kernels, and the volume pass (two mass kernels, one merge) once more.
    expect = dict(p2g_fused=substeps, merge_blocks=0, merge_scatter=2 * substeps + resorts,
                  g2p_fused=substeps, mass_p2g_fused=substeps + resorts,
                  mass_g2p_fused=substeps + resorts,
                  src_rows_from_order=resorts - branches["relabel"],
                  permute_slots=branches["mixed"])
    require(launches == expect, f"fluid path launch counts {launches}, expected {expect}")
    com = p.position[act].mean(0).tolist()
    say(10, f"fluid path: centre of mass {[round(x, 4) for x in com]}")
    return pipe, first, state, launches, dict(
        substeps=substeps, resorts=resorts, branches=branches, timed_substeps=timed,
        seconds=seconds, pups=pups, peak_gib=peak_gib, config=str(pipe._cfg))


def profile_fluid_frame(pipe, state):
    """One frame of the fluid path under torch.profiler: device busy time
    against the wall, and device ms per kernel name (the port's kernels and
    torch's), written to chiprun_out/fluid_profile.txt. Returns the state
    and {substeps, wall_ms, busy_ms, idle_share, top}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, n = pipe.run_frames_state(state, 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    with open(os.path.join(OUT_DIR, "fluid_profile.txt"), "w") as f:
        f.write(f"{n} substeps; wall {wall_ms:.3f} ms profiled; device busy {busy_ms:.3f} ms; "
                f"idle share {1.0 - busy_ms / wall_ms:.3f}\n")
        f.write("".join(f"{v:9.3f} ms  {k}\n" for k, v in top))
    short = [(k[:60], round(v, 3)) for k, v in top[:8]]
    say(10, f"profiled fluid frame: {n} substeps, wall {wall_ms:.2f} ms, device busy "
            f"{busy_ms:.2f} ms, idle share {1.0 - busy_ms / wall_ms:.3f}; top device ms {short}")
    require(busy_ms > 0.0, "the profiler saw no device time on the fluid path")
    return state, dict(substeps=n, wall_ms=wall_ms, busy_ms=busy_ms,
                       idle_share=1.0 - busy_ms / wall_ms, top=top[:20])


def phase_fluids3():
    """fluids3 as published (15,200 particles), 3 frames through the fused
    pipeline twice on the card and once on the CPU (plain versions): the
    two card runs bit-equal in every particle field; card against CPU,
    substeps equal or one apart per frame, equal flags, positions within
    FLUIDS3_DX and J = F00 within FLUIDS3_DJ."""
    import torch
    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch import interop
    from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline

    out = {}
    for run, dev in (("card", "cuda"), ("card again", "cuda"), ("cpu", "cpu")):
        b = scenes.build("fluids3", device=dev)
        pipe = FusedMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity, device=dev)
        p, subs = b.particles, []
        for _ in range(3):
            p, n = pipe.step_with_stats(p)
            subs.append(n)
        out[run] = (p.to("cpu"), subs)
    (pg, sg), (pg2, sg2), (pc, sc) = out["card"], out["card again"], out["cpu"]
    a, a2 = interop.particles_to_numpy(pg), interop.particles_to_numpy(pg2)
    differ = [k for k in a if not (a[k] == a2[k]).all()]
    act = pc.active
    dx = (pg.position[act] - pc.position[act]).abs().max().item()
    j_cpu = pc.deformation_gradient[act, 0, 0]
    dj_all = (pg.deformation_gradient[act, 0, 0] - j_cpu).abs()
    dj, at = dj_all.max().item(), int(dj_all.argmax())
    flags = torch.equal(pg.active, pc.active) and torch.equal(pg.failed[act], pc.failed[act])
    say(11, f"fluids3, 3 frames: substeps card {sg}, again {sg2}, CPU {sc}; two card runs "
            f"bit-equal {not differ and sg == sg2}; card against CPU max|dx| {dx:.3e} "
            f"({FLUIDS3_DX:g}), max|dJ| {dj:.3e} ({FLUIDS3_DJ:g}) at J {j_cpu[at].item():.4f} "
            f"(J over the blob {j_cpu.min().item():.4f}-{j_cpu.max().item():.4f}), flags equal "
            f"{flags}")
    require(not differ and sg == sg2, f"two card runs of fluids3 differ in {differ}")
    require(all(abs(x - y) <= 1 for x, y in zip(sg, sc)) and flags,
            "fluids3: card and CPU substeps or flags differ")
    require(dx <= FLUIDS3_DX and dj <= FLUIDS3_DJ, "fluids3: card and CPU disagree")
    return dict(substeps_card=sg, substeps_cpu=sc, max_dx=dx, max_dj=dj)


def phase_mixed():
    """A mixed fluid/solid set on the card: a corotated cube (model 1) beside
    a fluid cube (model 0), touching, so that blocks and chunks hold both.
    Kernels A and B branch per slot on the model's type; they, the mass
    kernels and the scatter merge are held against their plain versions on
    the packed state after its first volume pass and again one frame in."""
    import sparkl_tpu_torch as sk
    from sparkl_tpu_torch.core.particles import Particles
    from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
    from sparkl_tpu_torch import device as _device
    from sparkl_tpu_torch.models import registry as reg

    dev = _device.resolve("cuda")
    models = reg.ModelSet.pack(
        [reg.ParticleModel(reg.monaghan_sph_eos(1.0e6, 7, 1.01e-3, 1.0)),
         reg.ParticleModel(reg.corotated_linear_elasticity(1.0e6, 0.3))], dev)
    cube = dict(counts=(16, 16, 16), particle_radius=0.1, density0=1000.0, device=dev)
    p = Particles.concatenate((sk.cube_particles(origin=(1.6, 1.6, 1.6), model_id=1, **cube),
                               sk.cube_particles(origin=(4.8, 1.6, 1.6), model_id=0, **cube)))
    pipe = FusedMpmPipeline(sk.GridParams.for_domain((-8.0, -40.0, -8.0), (18.0, 8.0, 14.0),
                                                     0.8, pad=2),
                            models, (), sk.SolverParameters(
                                dt=1.0 / 60.0, force_fluids_volume_recomputation=True),
                            (0.0, -9.81, 0.0), device=dev)
    state = pipe.pack_state(p)
    res = {}
    for label in ("packed mixed", "one-frame mixed"):
        if label == "one-frame mixed":
            state, _ = pipe.run_frames_state(state, 1)
        st = pipe._recompute_fluids(state.replace(slots=state.slots.clone()))
        res[label] = phase_fluid_kernels(pipe, st, float(pipe._min_dtb(st)), label, 11,
                                         timed=False)
    return res


def main():
    if not os.path.isdir(os.path.join(HERE, "sparkl_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on the GPU", file=sys.stderr)
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. Card and toolchain.
    smi = card_line()
    say(1, f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
           f"nvcc: {nvcc_release()}")

    # 2. Build.
    from sparkl_tpu_torch import cuda_build

    t0 = time.perf_counter()
    path, log = cuda_build.build()
    cuda_build.library()
    build_s = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "nvcc_ptxas.log"), "w") as f:
        f.write(log)
    usage = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    say(2, f"built {os.path.relpath(path, HERE)} in {build_s:.1f} s; ptxas: " + " | ".join(usage))

    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline

    # 3. Kernels against their plain versions at the main path's shapes,
    # on a state one frame into the fall (non-zero velocity and stress).
    t0 = time.perf_counter()
    b = scenes.build("sand3", nx=100, ny=50, nz=100, device="cuda")
    n_active = int(b.particles.active.sum())
    pipe = FusedMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity, device="cuda")
    state = pipe.pack_state(b.particles)
    state, _ = pipe.run_frames_state(state, 1)
    _, min_dtb = pipe._probe(state)
    dt = float(min_dtb)
    say(3, f"sand3 {n_active} particles, {pipe._cfg}, set-up {time.perf_counter() - t0:.1f} s, dt {dt:.3e}")
    kres = phase_kernels(pipe, state, dt)
    del state
    phase_small_agreement()

    # 4. The main path. A copy of the state the first resort starts from is
    # kept for phase 5 (taken inside an untimed frame).
    pre_resort = []
    resort = L.resort

    def keep_first(grid, cfg, st, dim, cache_fn=None):
        if not pre_resort:
            pre_resort.append(st.replace(slots=st.slots.clone(), ints=st.ints.clone()))
        return resort(grid, cfg, st, dim, cache_fn=cache_fn)

    L.resort = keep_first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pipe = FusedMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity, device="cuda")
    state = pipe.pack_state(b.particles)
    mass0 = b.particles.mass[b.particles.active].double().sum().item()
    K.reset_launch_counts()
    substeps = resorts = 0
    for _ in range(FRAMES - TIMED_FRAMES):
        state, n = pipe.run_frames_state(state, 1)
        substeps += n
        resorts += pipe.last_resorts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = 0
    for _ in range(TIMED_FRAMES):
        state, n = pipe.run_frames_state(state, 1)
        timed += n
        resorts += pipe.last_resorts
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    substeps += timed
    launches = dict(K.LAUNCHES)
    branches = dict(pipe.resort_branches)
    L.resort = resort
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    p = pipe.unpack_state(state)
    act = p.active
    pos_ok = bool(torch.isfinite(p.position[act]).all())
    deact = b.particles.mass[b.particles.active & ~act].double().sum().item()
    mass = p.mass[act].double().sum().item()
    pups = n_active * timed / seconds
    say(4, f"{FRAMES} frames: {substeps} substeps, {resorts} resorts {branches}; last "
           f"{TIMED_FRAMES} frames {timed} substeps in {seconds:.3f} s = {pups:.4g} "
           f"particle-updates/s; peak memory {peak_gib:.2f} GiB; launches {launches}")
    require(pos_ok, "non-finite positions")
    require(abs(mass - (mass0 - deact)) <= 1e-6 * mass0, "active mass not conserved")
    require(resorts >= 1 and sum(branches.values()) == resorts,
            f"the main path took {resorts} lazy resorts, branches {branches}")
    # Each substep launches A, the merge and B once; each resort that
    # rebuilds the structure launches the source-row kernel once, and each
    # mixed one the permute kernel once. The fluid pass's kernels and the
    # scatter merge are not on this path.
    expect = dict(p2g_fused=substeps, merge_blocks=substeps, merge_scatter=0,
                  g2p_fused=substeps, mass_p2g_fused=0, mass_g2p_fused=0,
                  src_rows_from_order=resorts - branches["relabel"],
                  permute_slots=branches["mixed"])
    require(launches == expect, f"launch counts {launches}, expected {expect}")
    missing = [k for k in K.LAUNCHES if PATH_OF[k] == "fused" and launches[k] == 0]
    require(not missing, f"kernels the main path never launched: {missing}")
    com = p.position[act].mean(0).tolist()
    say(4, f"mass {mass:.6e} (initial {mass0:.6e}, deactivated {deact:.3e}); "
           f"centre of mass {[round(x, 4) for x in com]}")

    # 5. After the main path: the resort kernels and the whole resort on the
    # state the first resort started from; kernel B with plastic flow.
    rres, resort_ms = phase_resort(pipe, pre_resort[0])
    kres.update(rres)
    del pre_resort[:]
    _, min_dtb = pipe._probe(state)
    for label, st in (("landed", state), ("perturbed-F", perturbed_f(state))):
        kres["g2p_fused"][label], _ = check_g2p(pipe, st, float(min_dtb), label, 5,
                                                need_plastic=True)

    del pipe, state, pre_resort, p

    # 6. The sparse path's window kernels against their plain versions, on
    # the inputs of a substep one frame into the fall.
    from sparkl_tpu_torch.sparse.pipeline import SparseMpmPipeline

    spipe = SparseMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity, device="cuda")
    p1, _ = spipe.step_with_stats(b.particles)
    slot_data, windows = capture_window_inputs(spipe, p1)
    kres.update(phase_window_kernels(b.grid, spipe._cfg, slot_data, windows))
    del spipe, p1, slot_data, windows

    # 7. The sparse main path, then one profiled frame.
    spipe, sp, sparse_launches, sparse_res = phase_sparse_main(b)
    sparse_res["profile"] = profile_sparse_frame(spipe, sp)
    del spipe, sp

    # 8. Sparse against fused at full size; the sparse path card vs CPU.
    sparse_res["vs_fused"] = phase_sparse_vs_fused(b)
    sparse_res["small_card_vs_cpu"] = phase_small_sparse()

    # 9. The fluid kernels at full size, on the blob's packed state.
    t0 = time.perf_counter()
    fb = fluid_blob()
    fpipe = FusedMpmPipeline(fb.grid, fb.models, fb.colliders, fb.params, fb.gravity,
                             device="cuda")
    # The packed state after its first volume pass, as the first substep
    # starts: at pack J = 1, so the EOS stress and bound would be trivial.
    fstate = fpipe._recompute_fluids(fpipe.pack_state(fb.particles))
    fdt = float(fpipe._min_dtb(fstate))
    say(9, f"fluid blob {int(fb.particles.active.sum())} particles, {fpipe._cfg}, scatter merge "
           f"pinned {fpipe._merge_force_scatter}, set-up {time.perf_counter() - t0:.1f} s, "
           f"dt {fdt:.3e}")
    fluid_res = {"packed": phase_fluid_kernels(fpipe, fstate, fdt, "packed fluid", 9,
                                               timed=True)}
    del fpipe, fstate

    # 10. The fluid main path; then the fluid kernels one frame into it.
    fpipe, first, fstate, fluid_launches, fluid_res["main"] = phase_fluid_main(fb)
    _, fluid_res["profile"] = profile_fluid_frame(fpipe, fstate)
    del fstate
    first = fpipe._recompute_fluids(first)  # as the next substep starts
    fdt = float(fpipe._min_dtb(first))
    fluid_res["one frame"] = phase_fluid_kernels(fpipe, first, fdt, "one-frame fluid", 10,
                                                 timed=False)
    # The fluid kernels' numbers, and the scatter merge's, from the fluid
    # blob: the path its launches are counted on (phase 3's sand3 check kept).
    for name in ("mass_p2g_fused", "mass_g2p_fused"):
        kres[name] = fluid_res["packed"][name]
    kres["merge_scatter"] = dict(fluid_res["packed"]["merge_scatter"],
                                 sand3=kres["merge_scatter"])
    del fpipe, first, fb

    # 11. fluids3 as published: card against CPU, two card runs bit-equal;
    # a mixed fluid/solid set's kernels against their plain versions.
    fluid_res["fluids3"] = phase_fluids3()
    fluid_res["mixed"] = phase_mixed()

    by_path = dict(fused=launches, sparse=sparse_launches, fluid=fluid_launches)
    launches = {name: by_path[PATH_OF[name]][name] for name in REPLACES}
    missing = [k for k in REPLACES if launches[k] == 0]
    require(not missing, f"kernels their main paths never launched: {missing}")

    # 12. Results.
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        dict(name=name, route="cuda",
             source=WINDOW_SOURCE if name in SPARSE_KERNELS else FUSED_SOURCE,
             replaces=REPLACES[name], launches=launches[name],
             **{k: kres[name][k] for k in keys})
        for name in REPLACES
    ]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, kernels=kernels, launches_by_path=by_path, substeps=substeps,
                       resorts=resorts, timed_substeps=timed, seconds=seconds, pups=pups,
                       resort_branches=branches, resort_ms=resort_ms, peak_gib=peak_gib,
                       build_s=build_s, kernel_checks=kres, sparse=sparse_res,
                       fluid=fluid_res), f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke failed: {e}", file=sys.stderr)
        sys.exit(1)
