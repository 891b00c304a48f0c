#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: its two sand3 paths (the
fused pipeline and the block-sparse pipeline), its fluid path (fluids3 on
the fused pipeline, with fluid volume recomputation), its 2D fracture
path (l_panel2 on the fused pipeline: eigenerosion, maximum-stress
failure, a STICK cuboid ground and a Dirichlet velocity hook), its two
2D plastic paths (elasticity2: corotated + Rankine stars in a cuboid box,
the stress cache on; basic2: Snow, Drucker-Prager and a maximum-stress
star on a 2D heightfield, the stress cache off), its 2D fluid path
(fluids2: a Monaghan EOS dam break between cuboid walls, with fluid
volume recomputation) and its 3D fracture path (l_panel3: l_panel2's two
damage mechanisms in a 3D slab of 600,000 particles, built here by
`l_panel3`; also under modified eigenerosion, and l_panel2 under it).

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
     resort on the card against the same resort of a CPU copy, the older
     lane router permute_chunks (on no path) on that resort's pre-gathered
     operands against its plain version and permute_slots, bit for bit,
     timed against one indexed gather, and kernel B on the landed final
     state and on that state with perturbed F, both with Drucker-Prager
     plastic flow;
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
     the port's CPU path taking the card's dts, and two card runs
     bit-equal; the fluid kernels on a mixed fluid/solid set;
 12. l_panel2's kernels against their plain versions, at the reference
     settings (60,000 particles) and at cell width 0.0025 (240,000), on the
     path's state 20 substeps in, with times: the eigenerosion pooling (and
     on a perturbed state whose crack energies straddle the threshold),
     kernels A and B in their 2D damage forms and the merge at C = 64
     (kernel B also on a state with F perturbed so that maximum stress
     trips), and the resort's source-row and permute kernels (and
     permute_chunks) at C = 64 (the whole resort on the card against a CPU
     copy);
 13. the fracture main path: scenes.build("l_panel2") -> auto_pipeline ->
     pack_state -> 10 frames of run_frames_state (~124 substeps each) ->
     unpack_state, launch counts against the substeps, per frame the broken
     and failed counts per panel, candidate-list regrows and mass; one
     profiled frame (fracture_profile.txt in the output directory); then on, frame by
     frame, through the frame that holds l_panel2's first resort, and the
     candidate list (bit-equal to the CPU's) and the pooling (against its
     plain version) on the state that resort left;
 14. l_panel2, 3 substeps on the card against the port's CPU path, and one
     frame twice on the card, bit-equal; the eigenerosion candidate list's
     regrow and retry on a denser crack panel, bit-equal to a run that
     needed none;
 15. the 2D plastic kernels against their plain versions: kernel A's
     stress-cache read and kernel B's Rankine branch and stress epilogue on
     elasticity2, A's fresh stress and B's Snow, Drucker-Prager and
     maximum-stress branches on basic2, each 20 substeps in and with F
     perturbed so that every Rankine case, both Snow clamps,
     Drucker-Prager flow and maximum-stress trips occur (lanes counted);
     then, timed, a 250,000-particle block under basic2's models, also in
     the cache-on form and under Drucker-Prager alone (the one-SVD path);
 16. the two plastic main paths: scenes.build -> auto_pipeline ->
     pack_state -> 10 frames of run_frames_state -> unpack_state each,
     launch counts against the substeps, per frame (the three timed ones
     too, after their clock) the substeps beside the goldens' and the golden
     statistics within tests/test_regression.py's fused tolerances, mass;
     one profiled basic2 frame
     (plastic2d_profile.txt in the output directory);
 17. each plastic scene, 5 substeps on the card against the port's CPU
     path, and one frame twice on the card, bit-equal; one more
     elasticity2 substep stage by stage, each stage on the card against
     the CPU on that stage's own input (grid cache, kernel A, merge, grid
     side, window gather, kernel B), to name the first that differs;
 18. fluids2's kernel forms against their plain versions: the 2D mass
     kernels, kernel A's 2D EOS form and kernel B's 2D fluid branch (and
     the merges), on fluids2 as published (90,000 particles) 20 substeps
     in and, timed, on a 500 x 500 column (250,000 particles);
 19. the 2D fluid main path: scenes.build("fluids2") -> auto_pipeline ->
     pack_state -> 10 frames of run_frames_state -> unpack_state, launch
     counts against the substeps and volume passes, per-frame substeps
     and mass; one profiled frame (fluids2_profile.txt in the output
     directory);
 20. fluids2 at the golden's size (n = 40), 10 frames on the card against
     tests/golden_scenes.json with tests/test_regression.py's fused
     tolerances;
 21. fluids2, 5 substeps on the card against the port's CPU path, one
     frame twice on the card, bit-equal, and one substep stage by stage
     (as in 17, with the volume pass);
 22. the 3D damage forms against their plain versions at l_panel3's full
     size, 20 substeps in: the 3D pooling (C = 128, 108 candidate chunks;
     also on a perturbed state where eigenerosion trips), kernel A's 3D
     fresh-stress form with the psi channels and kernel B's 3D
     maximum-stress trip (also with F perturbed so that it trips), kernel
     B's crack-energy trip of modified eigenerosion on l_panel3-modified
     (also with psi_pos perturbed so that it trips) and in 2D on l_panel2
     under modified eigenerosion, with times, bounds and the pooling's
     library yardstick;
 23. the l_panel3 main path: l_panel3() -> auto_pipeline -> pack_state ->
     10 frames of run_frames_state -> unpack_state, launch counts against
     the substeps (A, B and the pooling once per substep), per frame the
     substeps, broken and failed counts per panel and mass; one profiled
     frame (lpanel3_profile.txt in the output directory);
 24. reduced l_panel3 (2,304 particles), 3 substeps on the card against
     the port's CPU path at the card's dts, phase mismatches net of ties;
 25. l_panel3-modified (3 frames) and l_panel2 under modified eigenerosion
     (1 frame) as main paths: kernel B's crack-energy trip launched every
     substep, no pooling, trips per panel;
 26. a JSON line of per-kernel results (the 2D fluid forms of kernels A
     and B and the mass kernels under "fluids2"; the 3D damage forms of A,
     B and the pooling under "l_panel3", B's crack-energy trip under
     "l_panel3-modified" and "l_panel2-modified"), the card's nvidia-smi
     line, and the final {"ok": true, "device": ...} line.

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
    "eigen_pool_fused": "sparkl_tpu/fused/kernels.py:851",
    "permute_chunks": "sparkl_tpu/fused/kernels.py:1156",
}
# The main path each kernel's launch count is read from.
PATH_OF = dict.fromkeys(("p2g_fused", "merge_blocks", "g2p_fused", "src_rows_from_order",
                         "permute_slots"), "fused")
PATH_OF.update(p2g_windows="sparse", g2p_windows="sparse", mass_p2g_fused="fluid",
               mass_g2p_fused="fluid", merge_scatter="fluid", eigen_pool_fused="fracture",
               permute_chunks=None)
# permute_chunks is on no path: no path of the JAX package calls it (its
# one caller is tests/test_lowering.py), and the port's resort permutes with
# permute_slots. Its launches are those of its checks on the resorts of
# phases 5 and 12.
NO_PATH = ("none: no path of the JAX package calls it (its only caller is "
           "tests/test_lowering.py:100); launches from its checks on the phase 5 and 12 resorts")
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
# fluids3 after 3 frames, card against CPU (phase 11). Near J = 1 the EOS
# dt bound turns on the last bits: a lane at J = 1 + 1 ulp bounds dt at
# 2.25e-3 s, one at 1 + 2 ulps at 2.9e-3 s, so the frame's substep count
# (8, 6 or 5) is drawn by whether any of 15,200 lanes lands on such a J,
# and the card's expf/logf and the CPU's differ in the last bits. The CPU
# run therefore takes the card's dt at every substep (lockstep); the bounds
# on positions and J are the free-running ones (~g dt^2 ~ 5e-5 m at dt ~
# 2.25e-3 s, 20x, and 1e-3 in J).
FLUIDS3_DX, FLUIDS3_DJ = 1e-3, 1e-3
# l_panel2 (phases 12-14): frames of the main path (~124 substeps each at
# dt 1/6000 s), the finer configuration of the kernel checks, the substeps
# run before them, and the card-against-CPU tolerances after 3 substeps
# (the JAX package's fused-vs-dense ones, tests/test_fused.py::_compare).
FRACTURE_FRAMES, FRACTURE_TIMED = 10, 3
FRACTURE_FINE_CELL = 0.0025
FRACTURE_SUBSTEPS_IN = 20
FRACTURE_DX, FRACTURE_DV, FRACTURE_DF = 5e-5, 5e-4, 5e-4
# l_panel2 runs on past the main path until a frame holds its first lazy
# resort, at most this many more frames.
FRACTURE_RESORT_FRAMES = 600
# Trip decisions (eigenerosion energy, the maximum-stress envelope) may
# differ between a kernel and its plain version only where the decided
# quantity lies within this relative distance of its threshold.
TIE = 1e-5
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
# The 2D damage forms: P2G per tap (9 per slot) the x/y weight products and
# mass, 2 momenta (with the affine columns) and 2 psi channels; kernel A per
# slot the 2x2 SVD, the corotated stress and the affine (~100); G2P per tap
# the y-sheet and x sums of 2 velocity channels; kernel B per lane the F
# update, SVD, energy, fresh stress, its eigenvalues and the dt bound
# (~200, a lower estimate); the pooling ~10 per pair test (2 differences, 2
# products, a sum, the compare and 2 adds).
P2G2_TAP_FLOPS, A2_SLOT_FLOPS, G2P2_TAP_FLOPS, B2_LANE_FLOPS = 27, 100, 14, 200
EIG_PAIR_FLOPS = 10
# The 2D plastic forms: kernel A with the cache on reads the stress and
# forms the affine per slot (~20, no SVD); kernel B's plastic lane adds one
# more 2x2 SVD, the map (logs, exps, the rank network or clamps) and the
# rebuild of F (~150, transcendentals counted as one each).
A2_CACHED_SLOT_FLOPS, B2_PLASTIC_FLOPS = 20, 150
# The 3D damage forms (phases 22-25): kernel A's fresh stress (the cardano
# SVD, the corotated stress with its phase split) and the affine per slot
# (~600, a lower estimate), and per tap 2 more channels (psi momentum and
# mass, a product and a sum each); kernel B's lane adds to the 3D lane
# (B_LANE_FLOPS) the failure stress and its cardano eigenvalues (~300), and
# with the modified trip the psi channel's gather (2 per tap).
A3_FRESH_SLOT_FLOPS, P2G3_PSI_TAP_FLOPS, B3_FAILURE_FLOPS = 600, 4, 300
# l_panel3: substeps run before the kernel checks, frames of the main path
# (the last timed) and of the modified run, substeps of the card-against-CPU
# check on the reduced form.
LPANEL3_SUBSTEPS_IN = 20
LPANEL3_FRAMES, LPANEL3_TIMED = 10, 3
LPANEL3_MODIFIED_FRAMES = 3
LPANEL3_AGREE_SUBSTEPS = 3
# elasticity2 and basic2 (phases 15-17): substeps run before the kernel
# checks, frames of the main paths (the last timed), a 500 x 500 block for
# the timed checks, and the substeps of the card-against-CPU check.
PLASTIC_SUBSTEPS_IN = 20
PLASTIC_FRAMES, PLASTIC_TIMED = 10, 3
PLASTIC_BLOCK = 500
PLASTIC_AGREE_SUBSTEPS = 5
# fluids2 (phases 18-21): substeps run before the kernel checks, and the
# side of the 2D fluid block the kernels are timed on (250,000 particles).
FLUIDS2_SUBSTEPS_IN = 20
FLUID2_BLOCK = 500
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


def g2p_errors(out_k, out_p, ints, cparams, cell_width, skip_dtb=None, skip_rows=()):
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
    skip_dtb [D, C] leaves lanes out of the dt-bound row: the EOS lanes,
    which check_g2p holds to their own bound (eos_dtb_errors);
    skip_rows leaves rows out (the 2D phase row, held to its trips). 3D
    (56 rows) or 2D (40)."""
    import torch
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.math.kernel import inv_d

    dim = 3 if out_k.shape[1] == L.Rows(3).nf else 2
    r = L.Rows(dim)
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
    vmax = b[:, r.vel : r.vel + dim].abs().max().item()
    mmax = b[:, r.mass].abs().max().item()
    emax = b[:, r.psi_pos].abs().max().item()
    escale = max(2.0 * (mu * emax) ** 0.5, 1e-30)
    fscale = b[:, r.defgrad : r.defgrad + dim * dim].abs().max().item()
    out = []
    for k in range(r.nf):
        e = err[k].item()
        if k in skip_rows:
            continue
        if k == r.failed:
            out.append((k, "failed", float(not torch.equal(a[:, k], b[:, k])), 0.0))
        elif r.grad <= k < r.grad + dim * dim:
            scale = max(rmax[k].item(), inv_d(cell_width) * cell_width * vmax)
            out.append((k, "grad", e / scale, 2e-5))
        elif r.defgrad <= k < r.defgrad + dim * dim:
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
    """Window images [D, nf, 8^d] (z-major in 3D, row-major in 2D) -> the
    merge's (chunk, corner) rows [D, 2^d, nf·4^d], as merge_images_to_grid
    forms them."""
    from sparkl_tpu_torch.sparse import transfer as T

    nf = images.shape[1]
    dim = 3 if images.shape[2] == 512 else 2
    comb = T._merge_comb(dim, nf, dim == 3, images.device)
    return images.reshape(cfg.max_chunks, -1)[:, comb].reshape(
        cfg.max_chunks, 2**dim, nf * 4**dim).contiguous()


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
    (1) Against the plain version's row. Where the single-particle bound
    h/J·sqrt(ρ0(J - 1) / (6 d p)) with p ~ 7 p0 (1 - J) is the smaller,
    it is the quotient of two factors that vanish at J = 1, each rounded on
    its own, so a few ulps of J and of ρ/ρ0 (~4e-7 together; the kernel's
    and the plain version's J differ by an ulp where their gathered
    gradients do) move it by ~2e-7/|J - 1| relative. Held to |err| <=
    |plain|·(1e-5 + 2e-6/|J - 1|), 10x that, where |J - 1| >= 1e-5 (1e-5
    relative far from 1); closer to 1 the sign of J - 1 itself turns on the
    last bits, and with it whether that bound is finite, so those lanes are
    required to hold a positive bound in both. (2) On every fluid lane,
    against `own` [D, C], the row the plain functions compute from the
    kernel's own output rows (velocity, gradient, F00, mass, vol0, failed):
    the same J on both sides, so held to 1e-5 relative, near J = 1 too.
    Returns (the fluid lanes, worst |err|/tol of (1), or inf if a close
    lane is not positive, worst of (2), the count of lanes within 1e-5 of
    1, the count within 1e-3 of 1, |J - 1| on (1)'s worst lane)."""
    import torch
    from sparkl_tpu_torch.fused import layout as L

    r = L.Rows(3 if out_k.shape[1] == L.Rows(3).nf else 2)
    eps = (out_p[:, r.defgrad] - 1.0).abs()
    held = fluid & (eps >= 1e-5)
    close = fluid & ~held
    a, b = out_k[:, r.dtb], out_p[:, r.dtb]
    tol = b.abs() * (1e-5 + 2e-6 / eps.clamp(min=1e-5))
    ratio = torch.where(held, (a - b).abs() / tol.clamp(min=1e-30), 0.0)
    measure, worst_eps = ratio.max().item(), eps.reshape(-1)[ratio.argmax()].item()
    if not bool(((a > 0.0) & (b > 0.0))[close].all()):
        measure = float("inf")
    own_tol = (1e-5 * own.abs()).clamp(min=1e-30)
    own_measure = torch.where(fluid, (a - own).abs() / own_tol, 0.0).max().item()
    return (fluid, measure, own_measure, int(close.sum()), int((fluid & (eps < 1e-3)).sum()),
            worst_eps)


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
    r = L.Rows(grid.dim)
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
    fluid, eos_measure, own_measure, close, near_one, worst_eps = eos_dtb_errors(
        out_k, out_p, mirror.slots[:, r.dtb], occ & (ct == 2))
    row_errs = g2p_errors(out_k, out_p, state.ints, pipe.models.cparams, grid.cell_width,
                          skip_dtb=fluid)
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
               worst_over_tol=worst, plastic_lanes=plastic_k, fluid_lanes=int(fluid.sum()),
               eos_dtb_lanes_near_one=near_one, dtb_lanes_close=close,
               eos_dtb_worst_lane_j_minus_1=worst_eps)
    say(phase, f"g2p_fused on the {label} state, slots {tuple(out_k.shape)}: worst measure/tol "
               f"per row group { {g: round(v, 4) for g, v in worst.items()} } (pass <= 1; "
               f"failed row equal: {worst['failed'] == 0}); lanes with plastic flow: kernel "
               f"{plastic_k}, plain {plastic_p} of {int(occ.sum())}; fluid lanes held to the "
               f"EOS dt-bound tolerance: {int(fluid.sum())} ({near_one} with |J - 1| < 1e-3, "
               f"the worst at |J - 1| {worst_eps:.3e}), of them within 1e-5 of 1 (checked "
               f"positive, and against the bound of the kernel's own rows as every fluid lane "
               f"is): {close}")
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


def phase_resort(pipe, pre, phase=5):
    """The resort kernels against their plain versions on `pre`, the state
    the main path's first resort started from, bit for bit; then that whole
    resort on the card against the same resort of a CPU copy (the plain
    versions and torch on the CPU), bit for bit, slots, ints and structure.
    3D or 2D (the pipeline's grid). Returns ({name: {max_abs_err, ms,
    plain_ms, bytes}}, resort ms)."""
    import torch
    from sparkl_tpu_torch import interop
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.fused import structure as S

    grid, cfg = pipe.grid, pipe._cfg
    dim = grid.dim
    r = L.Rows(dim)
    c, d_ = cfg.chunk_size, cfg.max_chunks
    dev = pre.slots.device
    pos, active, occupied = L.slot_positions(pre, dim)
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
    say(phase, f"src_rows_from_order {tuple(src_k.shape)}: bit-equal {torch.equal(src_k, src_p)}; "
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
    say(phase, f"permute_slots slots {tuple(out_k[0].shape)}: bit-equal to its plain version "
           f"{equal}; source chunks per live destination mean {nsrc.mean().item():.3f}, "
           f"max {int(nsrc.max().item())}, {int((nsrc > 8).sum())} destinations above 8")
    require(equal, "permute_slots is not equal to its plain version")
    # The older lane router on the same resort: its pre-gathered operands
    # (each destination's distinct source chunks, K = the most any has) and
    # lane targets from the per-slot source index, as the JAX package's
    # resort built them. No path calls it; these launches are its check.
    gathered, gathered_i, target = K.permute_chunks_operands(pre.slots, pre.ints, src)
    n0 = K.LAUNCHES["permute_chunks"]
    pc_k = K.permute_chunks(gathered, gathered_i, target)
    pc_p = K.permute_chunks_reference(gathered, gathered_i, target)
    keep_f = [k for k in range(r.nf) if k != r.cumd]
    keep_i = [k for k in range(L.NI) if not L.I_ORIGIN <= k < L.I_ORIGIN + dim]
    bits = [x.view(torch.int32) if x.dtype == torch.float32 else x for x in (*pc_k, *pc_p)]
    same_plain = torch.equal(bits[0], bits[2]) and torch.equal(bits[1], bits[3])
    same_slots = (torch.equal(bits[0][:, keep_f], out_k[0][:, keep_f].view(torch.int32))
                  and torch.equal(pc_k[1][:, keep_i], out_k[1][:, keep_i]))
    res["permute_chunks"] = dict(
        max_abs_err=max((pc_k[0] - pc_p[0]).abs().max().item(),
                        float((pc_k[1] - pc_p[1]).abs().max().item())),
        k_src=gathered.shape[1], operand_gib=(gathered.numel() + gathered_i.numel()) * 4 / 2**30,
        bytes=(n_valid + d_ * c) * 4 * (r.nf + L.NI) + d_ * c * 4)
    say(phase, f"permute_chunks on the same resort: K = {gathered.shape[1]} source chunks, "
               f"operands {res['permute_chunks']['operand_gib']:.2f} GiB; bit-equal to its plain "
               f"version {same_plain}, to permute_slots (but the drift and origin rows) "
               f"{same_slots}")
    require(same_plain and same_slots,
            "permute_chunks is not bit-equal to its plain version and to permute_slots")
    # The library yardsticks: one gather each, with the index precomputed.
    j = torch.clamp(shifts[:, None].long() + torch.arange(c, device=dev)[None, :], 0, 2 * c - 1)
    order_rows = order2.reshape(d_, 2 * c)
    src_safe = torch.where(src >= 0, src, 0).long()
    sc, sl = src_safe // c, src_safe % c
    tgt = torch.where(target < gathered.shape[1] * c, target, 0).long()
    gd = torch.arange(d_, device=dev)[:, None].expand(d_, c)
    gk, gl = tgt // c, tgt % c
    for name, fn, plain, lib in (
            ("src_rows_from_order", lambda: K.src_rows_from_order(order2, shifts),
             lambda: K.src_rows_from_order_reference(order2, shifts),
             lambda: torch.gather(order_rows, 1, j)),
            ("permute_slots", lambda: K.permute_slots(*args),
             lambda: K.permute_slots_reference(*args),
             lambda: (pre.slots[sc, :, sl], pre.ints[sc, :, sl])),
            ("permute_chunks", lambda: K.permute_chunks(gathered, gathered_i, target),
             lambda: K.permute_chunks_reference(gathered, gathered_i, target),
             lambda: (gathered[gd, gk, :, gl], gathered_i[gd, gk, :, gl]))):
        v = res[name]
        v["ms"], v["plain_ms"], v["library_ms"] = (
            cuda_median_ms(fn), cuda_median_ms(plain), cuda_median_ms(lib))
        v["flops"] = 0
        v["bound_ms"], v["bound_by"] = bound(v["bytes"], 0)
        say(phase, f"{name}: kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms, library (one "
               f"gather) {v['library_ms']:.3f} ms (median of 20); {v['bytes'] / 1e9:.4f} GB counted "
               f"from shapes = {v['bytes'] / v['ms'] / 1e6:.1f} GB/s; bound {v['bound_ms']:.4f} ms")

    res["permute_chunks"]["launches"] = K.LAUNCHES["permute_chunks"] - n0
    del gathered, gathered_i, pc_k, pc_p, bits

    def run(state):
        out, ov, branch = L.resort(grid, cfg, state, dim)
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
    resort_ms = cuda_median_ms(lambda: L.resort(grid, cfg, pre, dim), reps=5)
    say(phase, f"whole resort, card against a CPU copy: branches {branch_g} / {branch_c}, overflow "
           f"{ov_g} / {ov_c}, slots, ints and structure bit-equal {same}; card {resort_ms:.3f} ms "
           f"(median of 5, host reads included)")
    require(same and branch_g == branch_c and ov_g == ov_c and not ov_g,
            f"the resort on the card differs from the CPU resort (elements differing: {differ})")
    return res, resort_ms


def slot_dim(state):
    """3 or 2: the dimension of a slot state's rows."""
    from sparkl_tpu_torch.fused import layout as L

    return 3 if state.slots.shape[1] == L.Rows(3).nf else 2


def perturbed_f(state, seed=7, scale=0.02):
    """`state` with F += scale·N(0, 1) (numpy seed) on occupied lanes: at
    0.02, strains of a few percent, past the Drucker-Prager cone on many
    lanes of sand3. 3D or 2D slots."""
    import numpy as np
    import torch
    from sparkl_tpu_torch.fused import layout as L

    d_, _, c = state.slots.shape
    dim = slot_dim(state)
    r = L.Rows(dim)
    noise = np.random.default_rng(seed).normal(scale=scale, size=(d_, dim * dim, c))
    occ = ((state.ints[:, L.I_FLAGS, :] & L.OCCUPIED) != 0)[:, None, :]
    slots = state.slots.clone()
    slots[:, r.defgrad : r.defgrad + dim * dim] += torch.where(
        occ, torch.from_numpy(noise.astype(np.float32)).to(slots.device), 0.0)
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
    """The fluid path's kernels against their plain versions on `state`, 3D
    (fluids3) or 2D (fluids2): the mass P2G (images), the mass gather (on
    the windows the volume pass builds from the kernel's images), kernel A
    (fresh EOS stress) and kernel B (fluid branch); the scatter merge on
    both kinds of images, and in 2D also the block merge. With `timed`,
    each kernel's and plain version's median time. Returns {name: {...}}."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.sparse import transfer as T

    grid, cfg = pipe.grid, pipe._cfg
    dim = grid.dim
    nch = state.structure.num_chunks
    tables = (pipe._tab_f, pipe._tab_i)
    sl, ints = state.slots, state.ints
    m_k = K.mass_p2g_fused(grid, cfg, sl, ints, nch)
    m_p = K.mass_p2g_fused_reference(grid, sl, ints, nch)
    node, _ = T.merge_images_to_grid(grid, cfg, state.structure, m_k,
                                     cell_order=pipe._cell_order(),
                                     force_scatter=pipe._merge_force_scatter,
                                     plan=state.grid_cache[2])
    win = T.gather_grid_windows(grid, cfg, state.structure, node,
                                cell_order=pipe._cell_order()).contiguous()
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
    res["mass_p2g_fused"] = dict(max_abs_err=m_err[1], over_bound=m_err[0],
                                 bit_equal=torch.equal(m_k, m_p))
    if dim == 2:
        # On the CPU the plain version's scatter-add sums each cell's slots
        # in ascending lane order, as the kernel does: there the same sums
        # to the bit (on the card its scatter-add takes atomics' order).
        m_cpu = K.mass_p2g_fused_reference(grid, sl.cpu(), ints.cpu(), nch.cpu())
        res["mass_p2g_fused"]["bit_equal_cpu"] = torch.equal(m_k.cpu(), m_cpu)
        require(res["mass_p2g_fused"]["bit_equal_cpu"],
                f"mass_p2g_fused differs from its plain version on the CPU ({label})")
    res["mass_g2p_fused"] = dict(max_abs_err=g_err, bit_equal=torch.equal(g_k, g_p),
                                 rel_err=g_err / max(g_scale, 1e-30))
    res["p2g_fused"] = dict(max_abs_err=max(e for _, e in a_err),
                            over_bound=max(m for m, _ in a_err))
    say(phase, f"fluid kernels on the {label} state: mass_p2g_fused max|err| {m_err[1]:.3e} "
               f"({m_err[0]:.2e} of its bound; bit-equal {res['mass_p2g_fused']['bit_equal']}, "
               f"to the plain version on the CPU "
               f"{res['mass_p2g_fused'].get('bit_equal_cpu', 'not checked in 3D')}); "
               f"mass_g2p_fused max|err| {g_err:.3e} (relative "
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
    # (Timed at the 3D fluid path's shapes, where it is the path's merge.)
    res["merge_scatter"] = check_merge_scatter(cfg, state.structure, image_rows(cfg, a_k),
                                               phase, " (fluid, kernel A images)",
                                               timed and dim == 3)
    res["merge_scatter"]["mass"] = check_merge_scatter(
        cfg, state.structure, image_rows(cfg, m_k), phase, " (fluid, mass images)",
        timed and dim == 3)
    if dim == 2:
        # The 2D path merges with merge_blocks (a block of 4 x 4 cells holds
        # one or two chunks): bit-equal to its plain version on both kinds.
        first, nblk = state.structure.block_first_chunk, state.structure.block_num_chunks
        same = [torch.equal(K.merge_blocks(rows, first, nblk),
                            K.merge_blocks_reference(rows, first, nblk, T.MERGE_KMAX))
                for rows in (image_rows(cfg, a_k), image_rows(cfg, m_k))]
        res["merge_blocks"] = dict(bit_equal=all(same), max_chunks_per_block=int(nblk.max()))
        say(phase, f"merge_blocks on the {label} state's images and mass images bit-equal "
                   f"{same}; at most {int(nblk.max())} chunks a block")
        require(all(same), f"merge_blocks disagrees with its plain version on the {label} state")
    if not timed:
        return res
    live = int(nch)
    row = 4 * cfg.chunk_size
    lanes = int(((ints[:, L.I_FLAGS, :] & L.ACTIVE) != 0).sum())
    cells, taps = 8**dim, 3**dim
    # Bytes counted from what the fluid branches need on the all-fluid
    # lanes, per live chunk: kernel A reads pos d, vel d, mass, vol0, grad
    # d², F00 and failed (3D 19, 2D 12 f32 rows; no stress-cache row) and
    # flags, model and the origin (3D 5, 2D 4 i32 rows), and writes every
    # chunk's [1 + d, 8^d] image; kernel B reads pos d, F00, mass, vol0,
    # failed and the drift (3D 8, 2D 7 f32 rows), flags, model and origin
    # and the [d, 8^d] window, and changes pos d, vel d, grad d², F00, the
    # dt bound, failed and the drift (3D 19, 2D 12 rows; the rest of F, the
    # plastic, energy and stress-cache rows stay as they are for fluids);
    # the mass kernels read pos d and the mass and flags and the origin
    # (3D 8, 2D 6 rows).
    i_rows = 2 + dim
    a_rows, b_read = 4 + 2 * dim + dim * dim + i_rows, 5 + dim + i_rows
    b_written = 4 + 2 * dim + dim * dim
    m_rows = 2 + 2 * dim
    if dim == 3:
        a_flops = 27 * P2G_TAP_FLOPS + A_SLOT_FLOPS + EOS_SLOT_FLOPS
        b_flops = 27 * G2P_TAP_FLOPS + B_FLUID_LANE_FLOPS
    else:
        a_flops = 9 * P2G2_TAP_FLOPS + A2_CACHED_SLOT_FLOPS + EOS_SLOT_FLOPS
        b_flops = 9 * G2P2_TAP_FLOPS + B_FLUID_LANE_FLOPS
    for name, fn, plain, nbytes, flops in (
            ("mass_p2g_fused", lambda: K.mass_p2g_fused(grid, cfg, sl, ints, nch),
             lambda: K.mass_p2g_fused_reference(grid, sl, ints, nch),
             live * m_rows * row + cfg.max_chunks * cells * 4, lanes * taps * MASS_TAP_FLOPS),
            ("mass_g2p_fused", lambda: K.mass_g2p_fused(grid, cfg, sl, ints, win, nch),
             lambda: K.mass_g2p_fused_reference(grid, sl, ints, win, nch),
             live * (m_rows * row + cells * 4) + cfg.max_chunks * row,
             lanes * taps * MASS_TAP_FLOPS),
            ("p2g_fused", lambda: K.p2g_fused(grid, cfg, pipe._meta, sl, ints, dt, nch, tables),
             lambda: K.p2g_fused_reference(grid, sl, ints, dt, nch, tables),
             live * a_rows * row + cfg.max_chunks * (1 + dim) * cells * 4, lanes * a_flops)):
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
    v["bytes"] = live * ((b_read + b_written) * row + 4 * dim * cells)
    v["flops"] = lanes * b_flops
    v["library_ms"] = None
    v["bound_ms"], v["bound_by"] = bound(v["bytes"], v["flops"])
    for name, v in res.items():
        if name.startswith("merge"):
            continue
        say(phase, f"{name} ({dim}D fluid, {label}): kernel {v['ms']:.3f} ms, plain "
                   f"{v['plain_ms']:.3f} ms "
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
                  permute_slots=branches["mixed"], eigen_pool_fused=0, permute_chunks=0)
    require(launches == expect, f"fluid path launch counts {launches}, expected {expect}")
    com = p.position[act].mean(0).tolist()
    say(10, f"fluid path: centre of mass {[round(x, 4) for x in com]}")
    return pipe, first, state, launches, dict(
        substeps=substeps, resorts=resorts, branches=branches, timed_substeps=timed,
        seconds=seconds, pups=pups, peak_gib=peak_gib, config=str(pipe._cfg))


def plastic_block(device="cuda"):
    """One 2D block of 250,000 particles under basic2's models, grid and
    heightfield: a 500 x 500 lattice at r = h/4 (h = 1/128), its thirds in
    x the snow, the sand and the star's model (densities 1000, 1000,
    4000), from x = -0.55, y = 0.6 (its lower part inside the valley's
    collider)."""
    from dataclasses import replace
    import numpy as np
    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch.core.particles import Particles

    b = scenes.build("basic2", device=device)
    r = b.grid.cell_width / 4.0
    cols = np.array_split(np.arange(PLASTIC_BLOCK, dtype=np.float32), 3)
    ys = 0.6 + r + 2.0 * r * np.arange(PLASTIC_BLOCK, dtype=np.float32)
    parts = []
    for m, (xi, rho) in enumerate(zip(cols, (1000.0, 1000.0, 4000.0))):
        gx, gy = np.meshgrid(-0.55 + r + 2.0 * r * xi, ys, indexing="ij")
        pts = np.stack([gx.reshape(-1), gy.reshape(-1)], -1).astype(np.float32)
        parts.append(Particles.from_positions(pts, m, r, rho, b.particles.device))
    return replace(b, name="basic2 block", particles=Particles.concatenate(tuple(parts)))


def perturbed_by_model(state, scales, seed=19):
    """`state` with F += scale_m·N(0, 1) on the occupied lanes of model m
    (numpy seed), for each model m in `scales`."""
    import numpy as np
    import torch
    from sparkl_tpu_torch.fused import layout as L

    r = L.Rows(2)
    d_, _, c = state.slots.shape
    noise = torch.from_numpy(np.random.default_rng(seed).normal(size=(d_, 4, c))
                             .astype(np.float32)).to(state.slots.device)
    occ = (state.ints[:, L.I_FLAGS, :] & L.OCCUPIED) != 0
    mid = state.ints[:, L.I_MODEL, :]
    scale = torch.zeros_like(noise[:, 0])
    for m, sc in scales.items():
        scale = torch.where(occ & (mid == m), sc, scale)
    slots = state.slots.clone()
    slots[:, r.defgrad : r.defgrad + 4] += scale[:, None, :] * noise
    return state.replace(slots=slots)


def plastic_counts(pipe, state, out, dt):
    """Lanes of each plastic branch kernel B took on `state` (its output
    `out`): each return map's input F is the slot's F after the F update
    with the gathered gradient (out's gradient rows); Rankine lanes by case
    (elastic, the largest eigenvalue capped, the uniform cap; 2D has no
    two-eigenvalue case), Snow lanes with a singular value clamped below
    1 - min_eps or above 1 + max_eps, Drucker-Prager lanes whose hardening
    moved (plastic flow), and maximum-stress trips (phase 1 -> 0)."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.math import cmat, svd
    from sparkl_tpu_torch.models import failure as fail
    from sparkl_tpu_torch.models import plasticity as plas

    r = L.Rows(2)
    slots = state.slots
    occ = (state.ints[:, L.I_FLAGS, :] & L.OCCUPIED) != 0
    (pt, ft), cols = K.model_columns(pipe._tab_f, pipe._tab_i, state.ints, range(16), (1, 2))
    pp = cols[K.TAB_P : K.TAB_P + 8]
    f = [[slots[:, r.defgrad + 2 * i + j] for j in range(2)] for i in range(2)]
    g = [[out[:, r.grad + 2 * i + j] for j in range(2)] for i in range(2)]
    gf = cmat.matmul_c(g, f)
    s = svd.svd_c([[f[i][j] + dt * gf[i][j] for j in range(2)] for i in range(2)])[1]
    eig = [torch.log(torch.clamp(x, min=1e-20)) for x in s]
    e1, e2 = torch.maximum(eig[0], eig[1]), torch.minimum(eig[0], eig[1])
    mu, lam, ts = pp[0], pp[1], pp[2]
    soft = ts - (slots[:, r.ph] - 1.0)
    case0 = lam * (eig[0] + eig[1]) + 2.0 * mu * e1 <= soft
    cond1 = (2.0 * mu + lam) * e2 + lam * e2 <= soft
    rk = occ & (pt == plas.RANKINE)
    sn = occ & (pt == plas.SNOW)
    below = (s[0] < 1.0 - pp[0]) | (s[1] < 1.0 - pp[0])
    above = (s[0] > 1.0 + pp[1]) | (s[1] > 1.0 + pp[1])
    return dict(
        rankine_elastic=int((rk & case0).sum()),
        rankine_cap_largest=int((rk & ~case0 & cond1).sum()),
        rankine_uniform=int((rk & ~case0 & ~cond1).sum()), snow_below=int((sn & below).sum()),
        snow_above=int((sn & above).sum()),
        dp_flow=int((occ & (pt == plas.DRUCKER_PRAGER) & (out[:, r.ph] != slots[:, r.ph])).sum()),
        max_stress_trips=int((occ & (ft == fail.MAXIMUM_STRESS) & (out[:, r.phase] == 0.0)
                              & (slots[:, r.phase] != 0.0)).sum()))


def check_kernels_2d(pipe, state, dt, label, phase, meta=None, timed=False):
    """Kernel A (the stress-cache read, or fresh from F with the cache off;
    the psi channels with eigenerosion), the merge on its images and kernel
    B (the return maps in the SVD sequence of meta's form, the stress
    epilogue or the maximum-stress trip) against their plain versions on
    the 2D `state`, on the windows the path computes; `meta` a form of the
    pipeline's meta to run instead (e.g. without the psi channels, B then
    on the velocity windows alone). A: p2g_errors's bound; the merge
    bit-equal; B: g2p_errors's row tolerances on occupied lanes, the phase
    row equal but on lanes whose largest principal stress (from B's own
    output F) lies within TIE of the envelope, or under modified
    eigenerosion whose crack energy cpf·h·psi lies within TIE of the
    threshold. The lanes of each plastic branch, the maximum-stress trips
    and the crack-energy trips are counted (plastic_counts). With `timed`,
    times and bounds. Returns {name: {...}}."""
    import torch
    from sparkl_tpu_torch.core.params import DamageModel
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.math import svd
    from sparkl_tpu_torch.models import failure as fail
    from sparkl_tpu_torch.sparse import transfer as T

    meta = pipe._meta if meta is None else meta
    cache, psi = bool(meta["stress_cache"]), bool(meta["with_psi"])
    modified = meta["damage_model"] == DamageModel.MODIFIED_EIGENEROSION
    grid, cfg = pipe.grid, pipe._cfg
    r = L.Rows(2)
    nch = state.structure.num_chunks
    tables = (pipe._tab_f, pipe._tab_i)
    img_k = K.p2g_fused(grid, cfg, meta, state.slots, state.ints, dt, nch, tables)
    img_p = K.p2g_fused_reference(grid, state.slots, state.ints, dt, nch, tables,
                                  stress_cache=cache, with_psi=psi)
    rows = image_rows(cfg, img_k)
    first, nblk = state.structure.block_first_chunk, state.structure.block_num_chunks
    m_k = K.merge_blocks(rows, first, nblk)
    m_p = K.merge_blocks_reference(rows, first, nblk, T.MERGE_KMAX)
    # The windows the path computes (from its own form's images), cut to
    # the channels this form reads.
    img_path = img_k if psi == pipe._meta["with_psi"] else K.p2g_fused(
        grid, cfg, pipe._meta, state.slots, state.ints, dt, nch, tables)
    windows = pipe._grid_windows(state, img_path, dt)[:, :2 + psi].contiguous()
    slots_in = state.slots.clone()
    args = (pipe._tab_f, pipe._tab_i, nch)
    out_p = K.g2p_fused_reference(grid, slots_in, state.ints, windows, dt, *args,
                                  velocity_clamp=pipe._kparams["gpu_velocity_clamp"],
                                  stress_cache=cache, modified=modified)
    out_k = K.g2p_fused(grid, cfg, meta, pipe._kparams, slots_in.clone(), state.ints, windows,
                        dt, *args)
    torch.cuda.synchronize()
    per_ch = p2g_errors(img_k, img_p)
    occ = (state.ints[:, L.I_FLAGS, :] & L.OCCUPIED) != 0
    row_errs = g2p_errors(out_k, out_p, state.ints, pipe.models.cparams, grid.cell_width,
                          skip_rows=(r.phase,))
    worst = {}
    for _, grp, m, tol in row_errs:
        worst[grp] = max(worst.get(grp, 0.0), m / tol if tol else m)
    (ct, ft), p = K.model_columns(pipe._tab_f, pipe._tab_i, state.ints, range(16), (0, 2))
    f = [[out_k[:, r.defgrad + 2 * i + j] for j in range(2)] for i in range(2)]
    st = K.kirchhoff_stress_c(ct, p[0:4], slots_in[:, r.phase], out_k[:, r.eh], f, None, None,
                              None, (0,))
    emax = svd.sym_eigvals2x2_c([[0.5 * (st[i][j] + st[j][i]) for j in range(2)]
                                 for i in range(2)])[1]
    mp = p[K.TAB_F]
    tie = (ft == fail.MAXIMUM_STRESS) & ((emax - mp).abs() <= TIE * mp.abs())
    counts = plastic_counts(pipe, state, out_p, dt)
    if modified:
        cpf, cthr = slots_in[:, r.cpf], slots_in[:, r.cthr]
        crack = cpf * grid.cell_width * psi_gathered(pipe, state, windows)
        tie = tie | ((cpf != 0.0) & ((crack - cthr).abs() <= TIE * cthr.abs()))
        counts["crack_trips"] = int((occ & (slots_in[:, r.phase] > 0.0) & (cpf != 0.0)
                                     & (crack > cthr)).sum())
    differ = occ & (out_k[:, r.phase] != out_p[:, r.phase])
    same_bits = torch.equal(torch.where(occ[:, None, :], out_k, 0.0),
                            torch.where(occ[:, None, :], out_p, 0.0))
    res = {
        "p2g_fused": dict(max_abs_err=max(e for _, e in per_ch),
                          over_bound=max(m for m, _ in per_ch), stress_cache=cache,
                          with_psi=psi),
        "merge_blocks": dict(max_abs_err=(m_k - m_p).abs().max().item(),
                             bit_equal=torch.equal(m_k, m_p)),
        "g2p_fused": dict(max_abs_err=torch.where(occ[:, None, :], out_k - out_p,
                                                  0.0).abs().max().item(),
                          worst_over_tol=worst, bit_equal=same_bits, counts=counts,
                          trips=counts["max_stress_trips"], trips_differ=int(differ.sum()),
                          tie_lanes=int((tie & occ).sum()),
                          svd_reuse=K.svd_reuse(cache, meta["present_c"], meta["present_p"])),
    }
    say(phase, f"2D kernels on the {label} state (stress cache {cache}, psi {psi}, SVD reuse "
               f"{res['g2p_fused']['svd_reuse']}): p2g_fused images {tuple(img_k.shape)} max|err|"
               f"/bound {[f'{m:.2e}' for m, _ in per_ch]} (pass <= 1); merge_blocks "
               f"{tuple(m_k.shape)} bit-equal {res['merge_blocks']['bit_equal']}; g2p_fused "
               f"worst measure/tol {({g: round(v, 4) for g, v in worst.items()})}, bit-equal on "
               f"occupied lanes {same_bits}; lanes per branch {counts}; phase differing "
               f"{res['g2p_fused']['trips_differ']} (lanes within {TIE:g} of the envelope "
               f"{res['g2p_fused']['tie_lanes']})")
    failures = []
    if not (all(m <= 1.0 for m, _ in per_ch) and torch.isfinite(img_k).all().item()):
        failures.append("p2g_fused")
    if not res["merge_blocks"]["bit_equal"]:
        failures.append("merge_blocks")
    if not (all(v <= 1.0 for v in worst.values()) and not bool((differ & ~tie).any())
            and torch.isfinite(torch.where(occ[:, None, :], out_k, 0.0)).all().item()):
        failures.append("g2p_fused")
    require(not failures, f"{failures} disagree with their plain versions on the {label} state")
    if not timed:
        return res
    live, row = int(nch), 4 * cfg.chunk_size
    lanes = int(((state.ints[:, L.I_FLAGS, :] & L.ACTIVE) != 0).sum())
    plastic = int((occ & (K.model_columns(pipe._tab_f, pipe._tab_i, state.ints, (),
                                          (1,))[0][0] != 0)).sum())
    merged = int(nblk.clamp(max=T.MERGE_KMAX).sum())
    block = 4 * 4 * img_k.shape[1] * 16
    scratch = slots_in.clone()
    # The library yardstick of the merge: one segment sum over the valid
    # chunks' rows (blocks own contiguous chunk ranges).
    require(int(nblk.max()) <= T.MERGE_KMAX, "a block holds more than MERGE_KMAX chunks")
    flat, lengths = rows.reshape(cfg.max_chunks, -1)[:int(nblk.sum())], nblk.long()
    # Bytes counted from what the 2D forms read and write per live chunk: A
    # reads pos 2, vel 2, grad 4, mass, vol0, failed, then the 3 stress rows
    # (cache on) or F 4, phase and eh (fresh), with psi cpf and psi_pos, and
    # flags, model, origin 2 (4 i32 rows), and writes every chunk's [nf, 64]
    # image; B reads 26 f32 rows (pos, F, the scalar state, kinematic
    # velocity, crack and bookkeeping rows), 4 i32 rows and the [2, 64]
    # velocity window, and writes all 40 rows.
    a_rows = 11 + (3 if cache else 6) + (2 if psi else 0)
    a_slot = A2_CACHED_SLOT_FLOPS if cache else A2_SLOT_FLOPS
    for name, fn, plain, lib, nbytes, flops in (
            ("p2g_fused", lambda: K.p2g_fused(grid, cfg, meta, state.slots, state.ints, dt, nch,
                                              tables),
             lambda: K.p2g_fused_reference(grid, state.slots, state.ints, dt, nch, tables,
                                           stress_cache=cache, with_psi=psi), None,
             live * (a_rows + 4) * row + cfg.max_chunks * img_k.shape[1] * 64 * 4,
             lanes * (9 * P2G2_TAP_FLOPS + a_slot)),
            ("merge_blocks", lambda: K.merge_blocks(rows, first, nblk),
             lambda: K.merge_blocks_reference(rows, first, nblk, T.MERGE_KMAX),
             lambda: torch.segment_reduce(flat, "sum", lengths=lengths, axis=0),
             (merged + nblk.shape[0]) * block, merged * block // 4),
            ("g2p_fused", lambda: K.g2p_fused(grid, cfg, meta, pipe._kparams, scratch,
                                              state.ints, windows, dt, *args),
             lambda: K.g2p_fused_reference(grid, slots_in, state.ints, windows, dt, *args,
                                           stress_cache=cache, modified=modified), None,
             live * ((26 + 4 + 40) * row + 2 * 64 * 4),
             lanes * (9 * G2P2_TAP_FLOPS + B2_LANE_FLOPS) + plastic * B2_PLASTIC_FLOPS)):
        v = res[name]
        v["ms"], v["plain_ms"] = cuda_median_ms(fn), cuda_median_ms(plain)
        v["library_ms"] = cuda_median_ms(lib) if lib else None
        v["bytes"], v["flops"] = nbytes, flops
        v["bound_ms"], v["bound_by"] = bound(nbytes, flops)
        say(phase, f"{name} (2D, {label}): kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms, "
                   f"library {v['library_ms']} ms (median of 20); {nbytes / 1e9:.4f} GB and "
                   f"{flops / 1e9:.4f} GFLOP counted; bound {v['bound_ms']:.4f} ms "
                   f"({v['bound_by']})")
    return res


def phase_plastic_kernels():
    """The 2D plastic kernels against their plain versions on the card:
    elasticity2 (kernel A's cache read, kernel B's Rankine branch and
    stress epilogue) and basic2 (A's fresh stress, B's Snow and
    Drucker-Prager branches and the maximum-stress trip) PLASTIC_SUBSTEPS_IN
    substeps in, each also with F perturbed per model so that every
    Rankine case, both Snow clamps, Drucker-Prager flow and maximum-stress
    trips occur (counted, each required); then a 250,000-particle block
    under basic2's models, with times: as basic2 runs it (the cache off),
    in the cache-on form, and under Drucker-Prager alone (the one-SVD
    path). Returns {label: {name: {...}}}."""
    from dataclasses import replace
    import torch
    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch.models import registry as reg

    out = {}
    perturb = {"elasticity2": {0: 0.01}, "basic2": {0: 0.02, 1: 0.02, 2: 1.5}}
    for name in ("elasticity2", "basic2"):
        t0 = time.perf_counter()
        b = scenes.build(name)
        pipe, state = substep_state(b, PLASTIC_SUBSTEPS_IN)
        dt = float(pipe._min_dtb(state))
        say(15, f"{name}: {int(b.particles.active.sum())} particles, {pipe._cfg}, grid "
                f"{b.grid.res}, {PLASTIC_SUBSTEPS_IN} substeps in, dt {dt:.3e}, set-up "
                f"{time.perf_counter() - t0:.1f} s")
        res = check_kernels_2d(pipe, state, dt, name, 15, timed=True)
        pres = check_kernels_2d(pipe, perturbed_by_model(state, perturb[name]), dt,
                                f"{name} perturbed-F", 15)
        res["g2p_fused"]["perturbed"] = pres["g2p_fused"]
        res["p2g_fused"]["perturbed"] = pres["p2g_fused"]
        out[name] = res
        del pipe, state
    c_e = out["elasticity2"]["g2p_fused"]["perturbed"]["counts"]
    c_b = out["basic2"]["g2p_fused"]["perturbed"]["counts"]
    need = dict(rankine_elastic=c_e, rankine_cap_largest=c_e, rankine_uniform=c_e,
                snow_below=c_b, snow_above=c_b, dp_flow=c_b, max_stress_trips=c_b)
    unchecked = [k for k, c in need.items() if c[k] == 0]
    require(not unchecked, f"branches no lane took on the perturbed states: {unchecked}")

    t0 = time.perf_counter()
    b = plastic_block()
    pipe, state = substep_state(b, 3)
    dt = float(pipe._min_dtb(state))
    say(15, f"block: {int(b.particles.active.sum())} particles under basic2's models, "
            f"{pipe._cfg}, 3 substeps in, dt {dt:.3e}, set-up {time.perf_counter() - t0:.1f} s")
    out["block"] = check_kernels_2d(pipe, state, dt, "block", 15, timed=True)
    out["block cache-on"] = check_kernels_2d(pipe, state, dt, "block, cache-on form", 15,
                                             meta=dict(pipe._meta, stress_cache=True),
                                             timed=True)
    del pipe, state
    e, nu = 1.0e5, 0.2
    dp = reg.ModelSet.pack([reg.ParticleModel(reg.corotated_linear_elasticity(e, nu),
                                              reg.drucker_prager_plasticity(e, nu))],
                            b.particles.device)
    p = b.particles.replace(model_id=torch.zeros_like(b.particles.model_id))
    pipe, state = substep_state(replace(b, models=dp, particles=p), 3)
    dt = float(pipe._min_dtb(state))
    out["block DP only"] = check_kernels_2d(pipe, perturbed_by_model(state, {0: 0.02}), dt,
                                            "block, Drucker-Prager only", 15, timed=True)
    require(out["block DP only"]["g2p_fused"]["svd_reuse"]
            and out["block DP only"]["g2p_fused"]["counts"]["dp_flow"] > 0,
            "the Drucker-Prager-only block did not take the one-SVD path with flow")
    del pipe, state
    torch.cuda.empty_cache()
    return out


def phase_plastic_main(name, phase=16, golden=True, timed_frames=PLASTIC_TIMED, **kw):
    """One 2D main path (the plastic scenes, fluids2): scenes.build(name,
    **kw) -> auto_pipeline -> pack_state -> PLASTIC_FRAMES frames of
    run_frames_state (the last `timed_frames` timed, each frame clocked
    alone) -> unpack_state, with the kernels' launches held against the
    substeps run, the resort branches and, with fluid volume recomputation,
    the volume passes (one per substep and one more per resort); per frame
    (the timed ones after their clock) the substeps, the failed and broken
    counts and the mass held to 1e-6, and with
    `golden` (the goldens' configuration) the substeps beside the goldens'
    (within one, as tests/test_regression.py holds the fused pipeline) and
    the centre of mass, box and kinetic energy within its fused tolerances
    (the worst measure over tolerance reported). Returns (pipeline, state,
    launches, results)."""
    import json as _json
    import torch
    import sparkl_tpu_torch as sk
    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch.fused import kernels as K

    gold = None
    if golden:
        with open(os.path.join(HERE, "tests", "golden_scenes.json")) as fh:
            rec = _json.load(fh)[name]
        require(rec["config"] == kw, f"{name}: the golden's configuration is {rec['config']}")
        gold = rec["frames"]
    b = scenes.build(name, **kw)
    n_active = int(b.particles.active.sum())
    mass0 = b.particles.mass[b.particles.active].double().sum().item()
    pipe = sk.auto_pipeline(b)
    state = pipe.pack_state(b.particles)
    ran = [0]
    substep = pipe._substep

    def counted(st, dt):
        ran[0] += 1
        return substep(st, dt)

    pipe._substep = counted
    K.reset_launch_counts()
    substeps = resorts = 0
    frames, worst = [], 0.0
    timed, seconds = 0, 0.0
    first_timed = PLASTIC_FRAMES - timed_frames
    for i in range(PLASTIC_FRAMES):
        # A timed frame is clocked alone; its checks run after the clock.
        if i >= first_timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, n = pipe.run_frames_state(state, 1)
        if i >= first_timed:
            torch.cuda.synchronize()
            seconds += time.perf_counter() - t0
            timed += n
        substeps += n
        resorts += pipe.last_resorts
        p = pipe.unpack_state(state)
        act = p.active
        pos, vel = p.position[act].double(), p.velocity[act].double()
        mass = p.mass[act].double().sum().item()
        ke = 0.5 * (p.mass[act].double()[:, None] * vel**2).sum().item()
        failed = int(p.failed[act].sum())
        broken = int((p.phase[act] == 0.0).sum())
        frames.append(dict(frame=i, substeps=n, mass=mass, failed=failed, broken=broken,
                           ke=ke))
        require(abs(mass - mass0) <= 1e-6 * mass0, f"{name} frame {i}: mass {mass} vs {mass0}")
        if gold is None:
            continue
        rec = gold[i]
        ratios = []
        for got, want, atol, rtol in ((pos.mean(0), rec["com"], 3e-3, 1e-3),
                                      (pos.min(0).values, rec["pos_min"], 8e-3, 1e-3),
                                      (pos.max(0).values, rec["pos_max"], 8e-3, 1e-3),
                                      (torch.tensor([ke]), [rec["ke"]], 1e-8, 3e-2)):
            want = torch.tensor(want, dtype=torch.float64)
            ratios.append(((got.cpu() - want).abs() / (atol + rtol * want.abs())).max().item())
        slack = max(2, int(0.02 * n_active))
        frames[-1].update(golden_substeps=rec["substeps"], worst_over_tol=max(ratios))
        worst = max(worst, max(ratios))
        require(abs(n - rec["substeps"]) <= 1 and max(ratios) <= 1.0
                and abs(failed - rec["failed"]) <= slack and abs(broken - rec["broken"]) <= slack,
                f"{name} frame {i} against the golden: {frames[-1]}")
    pipe._substep = substep
    launches = dict(K.LAUNCHES)
    branches = dict(pipe.resort_branches)
    p = pipe.unpack_state(state)
    act = p.active
    mass = p.mass[act].double().sum().item()
    pups = n_active * timed / seconds if timed else None
    for fr in frames:
        say(phase, f"{name} frame {fr['frame']}: " + ", ".join(
            f"{k} {v}" for k, v in fr.items() if k != "frame"))
    against = (f"frames 0-{PLASTIC_FRAMES - 1} against the golden: worst measure/tol "
               f"{worst:.3e}; " if gold else "")
    rate = (f"last {timed_frames} frames {timed} substeps in {seconds:.3f} s = {pups:.4g} "
            f"particle-updates/s; " if timed else "")
    say(phase, f"{name} path, {PLASTIC_FRAMES} frames: {substeps} substeps, {ran[0]} run, "
               f"{resorts} resorts {branches}; {against}{rate}{pipe._cfg}; launches {launches}")
    require(bool(torch.isfinite(p.position[act]).all()), f"{name} path: non-finite positions")
    require(abs(mass - mass0) <= 1e-6 * mass0, f"{name} path: active mass not conserved")
    require(sum(branches.values()) == resorts and ran[0] == substeps,
            f"{name}: resorts {resorts}, branches {branches}, substeps {substeps} run {ran[0]}")
    # Per substep A, B and the merge of A's images; with the volume pass
    # (one per substep, one more per resort) the two mass kernels and the
    # merge of the mass images.
    merge = "merge_scatter" if pipe._merge_force_scatter else "merge_blocks"
    passes = substeps + resorts if b.params.force_fluids_volume_recomputation else 0
    expect = dict.fromkeys(K.LAUNCHES, 0)
    expect.update(p2g_fused=substeps, g2p_fused=substeps, mass_p2g_fused=passes,
                  mass_g2p_fused=passes, src_rows_from_order=resorts - branches["relabel"],
                  permute_slots=branches["mixed"])
    expect[merge] = substeps + passes
    require(launches == expect, f"{name} path launch counts {launches}, expected {expect}")
    return pipe, state, launches, dict(
        substeps=substeps, resorts=resorts, branches=branches, timed_substeps=timed,
        seconds=seconds, pups=pups, worst_over_tol=worst, frames=frames, config=str(pipe._cfg))


def phase_plastic_agreement(name, phase=17):
    """One 2D scene as published (a plastic scene, fluids2):
    PLASTIC_AGREE_SUBSTEPS single substeps on the card against the port's
    CPU path (plain versions), with the JAX package's fused-vs-dense
    tolerances and equal flags and phase; and one frame run twice on the
    card, bit-equal in every particle field."""
    from dataclasses import replace
    import torch
    import sparkl_tpu_torch as sk
    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch import interop

    out = {}
    for dev in ("cuda", "cpu"):
        b = scenes.build(name, device=dev)
        pipe = sk.auto_pipeline(replace(b, params=replace(b.params, stop_after_one_substep=True)),
                                device=dev)
        state = pipe.pack_state(b.particles)
        for _ in range(PLASTIC_AGREE_SUBSTEPS):
            state, _ = pipe.run_frames_state(state, 1)
        out[dev] = pipe.unpack_state(state).to("cpu")
    pg, pc = out["cuda"], out["cpu"]
    act = pc.active
    dx = (pg.position[act] - pc.position[act]).abs().max().item()
    dv = (pg.velocity[act] - pc.velocity[act]).abs().max().item()
    df = (pg.deformation_gradient[act] - pc.deformation_gradient[act]).abs().max().item()
    flags = (torch.equal(pg.active, pc.active) and torch.equal(pg.failed[act], pc.failed[act])
             and torch.equal(pg.phase[act], pc.phase[act]))
    say(phase, f"{name}, {PLASTIC_AGREE_SUBSTEPS} substeps, card against CPU: max|dx| {dx:.3e} "
               f"({FRACTURE_DX:g}), max|dv| {dv:.3e} ({FRACTURE_DV:g}; max|v| "
               f"{pc.velocity[act].abs().max().item():.4f}), max|dF| {df:.3e} ({FRACTURE_DF:g}), "
               f"active, failed and phase equal {flags}")
    require(flags, f"{name} card and CPU: flags or phase differ")
    require(dx <= FRACTURE_DX and dv <= FRACTURE_DV and df <= FRACTURE_DF,
            f"{name} card and CPU disagree")
    runs = []
    for _ in range(2):
        b = scenes.build(name)
        p, n = sk.auto_pipeline(b).step_with_stats(b.particles)
        runs.append((interop.particles_to_numpy(p), n))
    (a, na), (a2, na2) = runs
    differ = [k for k in a if not (a[k] == a2[k]).all()]
    say(phase, f"{name} one frame twice on the card: substeps {na}/{na2}, bit-equal in every "
               f"particle field {not differ} (differ: {differ})")
    require(not differ and na == na2, f"two card frames of {name} differ in {differ}")
    return dict(max_dx=dx, max_dv=dv, max_df=df, frame_substeps=na, repeat_bit_equal=not differ)


def phase_stage_bisect(name, phase):
    """Where a 2D substep on the card first leaves the CPU's: `name` as
    published, PLASTIC_AGREE_SUBSTEPS substeps in on the card, then one more
    substep stage by stage. Each stage runs on the card, its output is
    copied to the CPU and held against the CPU running the same stage on
    the card stage's own input (copied), so each difference is that stage's
    alone: the grid cache (node positions and collider projections, per
    structure), for fluids the volume pass (the mass P2G kernel against
    plain, the merge and window gather of the mass images, the mass gather
    kernel against plain, then J = V/V0 and the dt-bound row), kernel A's
    images (kernel against plain), the merge into the node table, the grid
    side (velocity from momentum and mass with gravity, the colliders'
    boundary conditions and the hook), the window gather, and kernel B
    (kernel against plain; per slot row on occupied lanes, the worst row
    named). Returns {stage: max |card - CPU|}, the worst rows and the first
    stage that differs."""
    from dataclasses import replace
    import sparkl_tpu_torch as sk
    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch import interop
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L

    b = scenes.build(name)
    pipe, state = substep_state(b, PLASTIC_AGREE_SUBSTEPS)
    bc = scenes.build(name, device="cpu")
    cpipe = sk.auto_pipeline(replace(bc, params=replace(bc.params, stop_after_one_substep=True)),
                             device="cpu")
    cpipe._cfg, cpipe._merge_force_scatter = pipe._cfg, pipe._merge_force_scatter

    def on_cpu(st):
        return interop.slot_state_from_numpy(interop.slot_state_to_numpy(st),
                                             cache_fn=cpipe._grid_cache, device="cpu")

    diffs, rows = {}, {}

    def held(stage, card, cpu):
        diffs[stage] = max(((a.cpu().float() - c.float()).abs().max().item() if a.numel()
                            else 0.0) for a, c in zip(card, cpu))

    def held_rows(stage, card, cpu, occ):
        """Slot tensors on occupied lanes: the worst row's |diff| over its
        largest magnitude."""
        full = ((card.cpu() - cpu) * occ).abs()
        d = full.amax(dim=(0, 2))
        scale = (cpu * occ).abs().amax(dim=(0, 2)).clamp(min=1e-30)
        diffs[stage] = d.max().item()
        k = int((d / scale).argmax())
        rows[stage] = dict(row=k, rel=(d[k] / scale[k]).item(), rows_differing=int((d > 0).sum()),
                           lanes_differing=int((full.amax(dim=1) > 0).sum()))

    cstate = on_cpu(state)
    occ = ((cstate.ints[:, L.I_FLAGS, :] & L.OCCUPIED) != 0)[:, None, :]
    held("grid cache", [state.grid_cache[0]] + [t for pr in state.grid_cache[1] for t in pr],
         [cstate.grid_cache[0]] + [t for pr in cstate.grid_cache[1] for t in pr])
    grid, cfg, nch = pipe.grid, pipe._cfg, state.structure.num_chunks
    if b.params.force_fluids_volume_recomputation:
        m_img = K.mass_p2g_fused(grid, cfg, state.slots, state.ints, nch)
        held("mass P2G", [m_img], [K.mass_p2g_fused(grid, cfg, cstate.slots, cstate.ints,
                                                     cstate.structure.num_chunks)])
        node = pipe._merge_nodes(state, m_img)
        win = pipe._gather_windows(state, node.reshape(node.shape[0], -1))
        cnode = cpipe._merge_nodes(cstate, m_img.cpu())
        held("mass merge and gather", [win],
             [cpipe._gather_windows(cstate, cnode.reshape(cnode.shape[0], -1))])
        new_mass = K.mass_g2p_fused(grid, cfg, state.slots, state.ints, win, nch)
        held("mass G2P", [new_mass], [K.mass_g2p_fused(grid, cfg, cstate.slots, cstate.ints,
                                                       win.cpu(), cstate.structure.num_chunks)])
        pipe._set_fluid_volumes(state, new_mass[:, 0, :])
        cpipe._set_fluid_volumes(cstate, new_mass[:, 0, :].cpu())
        held_rows("J and dt bound", state.slots, cstate.slots, occ)
    dt = float(pipe._min_dtb(state))
    cstate = on_cpu(state)
    tables = (pipe._tab_f, pipe._tab_i)
    images = K.p2g_fused(pipe.grid, pipe._cfg, pipe._meta, state.slots, state.ints, dt, nch,
                         tables)
    held("kernel A", [images], [K.p2g_fused(cpipe.grid, cpipe._cfg, cpipe._meta, cstate.slots,
                                            cstate.ints, dt, cstate.structure.num_chunks,
                                            (cpipe._tab_f, cpipe._tab_i))])
    node = pipe._merge_nodes(state, images)
    held("merge", [node], [cpipe._merge_nodes(cstate, images.cpu())])
    fields = pipe._grid_fields(state, node, dt)
    held("grid side", [fields], [cpipe._grid_fields(cstate, node.cpu(), dt)])
    windows = pipe._gather_windows(state, fields)
    held("window gather", [windows], [cpipe._gather_windows(cstate, fields.cpu())])
    out = K.g2p_fused(pipe.grid, pipe._cfg, pipe._meta, pipe._kparams, state.slots.clone(),
                      state.ints, windows, dt, pipe._tab_f, pipe._tab_i, nch)
    out_c = K.g2p_fused(cpipe.grid, cpipe._cfg, cpipe._meta, cpipe._kparams,
                        cstate.slots.clone(), cstate.ints, windows.cpu(), dt, cpipe._tab_f,
                        cpipe._tab_i, cstate.structure.num_chunks)
    held_rows("kernel B", out, out_c, occ)
    first = next((k for k, v in diffs.items() if v > 0.0), None)
    say(phase, f"{name}, one substep stage by stage, card against CPU on each stage's own "
               f"input: max|diff| {({k: float(f'{v:.3e}') for k, v in diffs.items()})}; slot "
               f"rows {rows}; first stage that differs: {first}")
    return dict(max_abs_diff=diffs, rows=rows, first_differing=first)


def fluid2_block(device="cuda"):
    """fluids2's dam break with a 500 x 500 column, 250,000 particles: the
    published model, colliders, cell width and spacing, the grid's top
    raised by the taller column (to y = 34, fluids2's margin of ~4.8 m
    above it)."""
    from dataclasses import replace
    import sparkl_tpu_torch as sk
    import sparkl_tpu_torch.scenes as scenes

    b = scenes.build("fluids2", n=FLUID2_BLOCK, device=device)
    return replace(b, name="fluids2 block",
                   grid=sk.GridParams.for_domain((2.5, 2.5), (36.5, 34.0), b.grid.cell_width,
                                                 pad=3))


def phase_fluids2_kernels():
    """fluids2's kernel forms against their plain versions on the card: the
    2D mass kernels, kernel A's 2D EOS form and kernel B's 2D fluid branch
    (and the merges), on fluids2 as published FLUIDS2_SUBSTEPS_IN substeps
    in, and, timed, on fluid2_block 3 substeps in, each after the volume
    pass the next substep starts with. Returns {label: {name: {...}}}."""
    import sparkl_tpu_torch.scenes as scenes

    out = {}
    for label, make, n_in, timed in (("fluids2", lambda: scenes.build("fluids2"),
                                      FLUIDS2_SUBSTEPS_IN, False),
                                     ("fluids2 block", fluid2_block, 3, True)):
        t0 = time.perf_counter()
        b = make()
        pipe, state = substep_state(b, n_in)
        state = pipe._recompute_fluids(state.replace(slots=state.slots.clone()))
        dt = float(pipe._min_dtb(state))
        say(18, f"{label}: {int(b.particles.active.sum())} particles, {pipe._cfg}, grid "
                f"{b.grid.res}, {n_in} substeps in, dt {dt:.3e}, set-up "
                f"{time.perf_counter() - t0:.1f} s")
        out[label] = phase_fluid_kernels(pipe, state, dt, label, 18, timed)
        del pipe, state
    return out


def kernel_group(name):
    """A device kernel's group in a frame's split: the port's kernels by
    name, torch's by kind."""
    port = ("p2g_fused", "g2p_fused", "merge_blocks", "merge_scatter", "mass_p2g",
            "mass_g2p", "eigen_pool", "src_rows", "permute_slots", "permute_chunks")
    for k in port:
        if f"{k}_kernel" in name:
            return k
    if "Memcpy" in name or "Memset" in name:
        return "host copies"
    if any(k in name for k in ("index_elementwise", "gather", "scatter", "index_put")):
        return "torch gathers and scatters"
    if "reduce_kernel" in name or "sort" in name.lower() or "scan" in name.lower():
        return "torch reductions, sorts and scans"
    return "torch elementwise ops and copies"


def profile_frame(pipe, state, fname, phase, label):
    """One frame of a fused path under torch.profiler: device busy time
    against the wall, and device ms per kernel name (the port's kernels and
    torch's), written to <fname> in OUT_DIR. Returns the state and
    {substeps, wall_ms, busy_ms, idle_share, top}."""
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
    launched = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            launched += 1
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    split = {}
    for k, v in top:
        group = kernel_group(k)
        split[group] = split.get(group, 0.0) + v
    with open(os.path.join(OUT_DIR, fname), "w") as f:
        f.write(f"{n} substeps; wall {wall_ms:.3f} ms profiled; device busy {busy_ms:.3f} ms; "
                f"idle share {1.0 - busy_ms / wall_ms:.3f}; {launched} device operations\n")
        f.write("".join(f"{v:9.3f} ms  {k}\n" for k, v in split.items()))
        f.write("".join(f"{v:9.3f} ms  {k}\n" for k, v in top))
    short = [(k[:60], round(v, 3)) for k, v in top[:8]]
    say(phase, f"profiled {label} frame: {n} substeps, wall {wall_ms:.2f} ms, device busy "
               f"{busy_ms:.2f} ms, idle share {1.0 - busy_ms / wall_ms:.3f}, {launched} device "
               f"operations ({launched / max(n, 1):.1f} per substep); top device ms {short}")
    require(busy_ms > 0.0, f"the profiler saw no device time on the {label} path")
    say(phase, f"{label} frame device ms by group: { {k: round(v, 3) for k, v in split.items()} }")
    return state, dict(substeps=n, wall_ms=wall_ms, busy_ms=busy_ms,
                       idle_share=1.0 - busy_ms / wall_ms, device_ops=launched, split=split,
                       top=top[:20])


def phase_fluids3():
    """fluids3 as published (15,200 particles), 3 frames through the fused
    pipeline twice on the card and twice on the CPU (plain versions): the
    two card runs bit-equal in every particle field; card against the CPU
    run that takes the card's dt at every substep (FLUIDS3_DX says why),
    substeps equal or one apart per frame, equal flags, positions within
    FLUIDS3_DX and J = F00 within FLUIDS3_DJ; the free-running CPU run's
    substeps are reported."""
    import torch
    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch import interop
    from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline

    out, dts = {}, []
    for run, dev in (("card", "cuda"), ("card again", "cuda"), ("cpu", "cpu"),
                     ("cpu free", "cpu")):
        b = scenes.build("fluids3", device=dev)
        pipe = FusedMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity, device=dev)
        min_dtb = pipe._min_dtb
        if run == "card":
            # Every minimum dt bound the substeps read, in turn.
            pipe._min_dtb = lambda st: dts.append(min_dtb(st)) or dts[-1]
        elif run == "cpu":
            replay = iter([float(x) for x in dts])
            pipe._min_dtb = lambda st: torch.tensor(next(replay), dtype=torch.float32)
        p, subs = b.particles, []
        for _ in range(3):
            p, n = pipe.step_with_stats(p)
            subs.append(n)
        out[run] = (p.to("cpu"), subs)
    (pg, sg), (pg2, sg2), (pc, sc) = out["card"], out["card again"], out["cpu"]
    sc_free = out["cpu free"][1]
    a, a2 = interop.particles_to_numpy(pg), interop.particles_to_numpy(pg2)
    differ = [k for k in a if not (a[k] == a2[k]).all()]
    act = pc.active
    dx = (pg.position[act] - pc.position[act]).abs().max().item()
    j_cpu = pc.deformation_gradient[act, 0, 0]
    dj_all = (pg.deformation_gradient[act, 0, 0] - j_cpu).abs()
    dj, at = dj_all.max().item(), int(dj_all.argmax())
    flags = torch.equal(pg.active, pc.active) and torch.equal(pg.failed[act], pc.failed[act])
    say(11, f"fluids3, 3 frames: substeps card {sg}, again {sg2}, CPU at the card's dts {sc}, "
            f"CPU free-running {sc_free}; two card runs "
            f"bit-equal {not differ and sg == sg2}; card against CPU max|dx| {dx:.3e} "
            f"({FLUIDS3_DX:g}), max|dJ| {dj:.3e} ({FLUIDS3_DJ:g}) at J {j_cpu[at].item():.4f} "
            f"(J over the blob {j_cpu.min().item():.4f}-{j_cpu.max().item():.4f}), flags equal "
            f"{flags}")
    require(not differ and sg == sg2, f"two card runs of fluids3 differ in {differ}")
    require(all(abs(x - y) <= 1 for x, y in zip(sg, sc)) and flags,
            "fluids3: card and CPU substeps or flags differ")
    require(dx <= FLUIDS3_DX and dj <= FLUIDS3_DJ, "fluids3: card and CPU disagree")
    return dict(substeps_card=sg, substeps_cpu=sc, substeps_cpu_free=sc_free, max_dx=dx,
                max_dj=dj)


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


def fracture_bundle(cell_width=None, device="cuda"):
    """scenes.build("l_panel2") at the reference settings (60,000
    particles), or at a finer cell width (0.0025: 240,000)."""
    import sparkl_tpu_torch.scenes as scenes

    kw = {} if cell_width is None else dict(cell_width=cell_width)
    return scenes.build("l_panel2", device=device, **kw)


# l_panel3 (phases 23-27): l_panel2's particle rows extruded into a slab of
# LPANEL3_LAYERS layers at the in-plane spacing h/2 (the reduced form of
# the CPU tests and phase 25: the panels cut to LPANEL3_SMALL of their size
# and LPANEL3_SMALL_LAYERS layers).
LPANEL3_LAYERS = 10
LPANEL3_SMALL, LPANEL3_SMALL_LAYERS = 0.08, 6
# The load point of each panel, from its origin (l_panel2's), and the
# panel polygon's corner, in units of the panel's size.
LPANEL_LOAD = (0.47, 0.25)


def l_panel3(damage="eigenerosion", scale=1.0, layers=LPANEL3_LAYERS, device="cuda"):
    """l_panel2's two damage mechanisms in a 3D slab, built with the port's
    API: the particle rows of scenes.build("l_panel2") as published (cell
    width h = 0.005, r = h/4, density 2500) extruded into `layers` layers at
    z = (2k + 1) h/4 (the in-plane spacing h/2; 10 layers: a slab 0.025 m
    thick, 600,000 particles), each 3D particle made by
    Particles.from_positions with the crack data (cpf, threshold, m_c, g)
    of its 2D row; l_panel2's models (corotated, E = 25.85e9, nu = 0.18;
    panel 1 eigenerosion, panel 2 maximum stress 2.7e6); a cuboid ground of
    half-extent 1000 in x and z placed as in 2D; STICK, no gravity, frame
    dt 1/6000; GridParams.for_domain over l_panel2's x/y domain and the
    slab's z range, pad 3; the load as l_panel2's Dirichlet hook, each
    panel's load point (0.47, 0.25) from its origin repeated at every grid
    node plane z = k h across the slab, velocity (0, 0.1, 0). `damage`
    "modified" runs modified eigenerosion instead. `scale` < 1 keeps the 2D
    rows inside the panel polygon scaled by it (about each panel's origin;
    the load point scales with it): the reduced form, every particle inside
    the grid."""
    import numpy as np
    import torch
    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch.core.grid import GridParams
    from sparkl_tpu_torch.core.params import BoundaryHandling, DamageModel, SolverParameters
    from sparkl_tpu_torch.core.particles import Particles
    from sparkl_tpu_torch.geometry.colliders import cuboid
    from sparkl_tpu_torch.models import registry as reg
    from sparkl_tpu_torch.solver.pipeline import DirichletVelocityHook

    b2 = scenes.build("l_panel2", device=device)
    h = b2.grid.cell_width
    r = h / 4.0
    ground_height, ground_shift = h * 10.0, h * 40.0
    origins = [(ground_shift, ground_shift), (ground_shift * 8.0, ground_shift)]
    p2 = b2.particles
    pos2 = p2.position.cpu().numpy()
    mid2 = p2.model_id.cpu().numpy()
    zs = ((2.0 * np.arange(layers) + 1.0) * r).astype(np.float32)
    panels = []
    for m, (ox, oy) in enumerate(origins):
        u, v = pos2[:, 0] - np.float32(ox), pos2[:, 1] - np.float32(oy)
        size = np.float32(0.5 * scale)
        keep = (mid2 == m) & (u < size) & (v < size) & ~((u > size / 2) & (v < size / 2))
        xy = pos2[keep]
        pos3 = np.concatenate([np.concatenate([xy, np.full((len(xy), 1), z, np.float32)], 1)
                               for z in zs])
        sel = torch.from_numpy(keep).to(device)
        rows = {k: getattr(p2, k)[sel].repeat(layers)
                for k in ("crack_propagation_factor", "crack_threshold", "m_c", "g")}
        panels.append(Particles.from_positions(pos3, m, r, 2500.0, device, **rows))
    particles = Particles.concatenate(tuple(panels))

    z_top = float(zs[-1] + r)
    grid = GridParams.for_domain((0.05, 0.05, 0.0), (2.2, 0.95, z_top), h, pad=3)
    colliders = (cuboid((1000.0, ground_height, 1000.0),
                        translation=(0.0, ground_shift - ground_height, 0.0)),)
    e, nu = 25.85e9, 0.18
    models = reg.ModelSet.pack([
        reg.ParticleModel(reg.corotated_linear_elasticity(e, nu)),
        reg.ParticleModel(reg.corotated_linear_elasticity(e, nu),
                          failure=reg.maximum_stress_failure(2.7e6, np.finfo(np.float32).max)),
    ], device)
    planes = [k * h for k in range(int(round(z_top / h)) + 1)]
    load = [(ox + LPANEL_LOAD[0] * scale, oy + LPANEL_LOAD[1] * scale) for ox, oy in origins]
    hooks = DirichletVelocityHook(
        points=[[x, y, z] for x, y in load for z in planes],
        velocities=[[0.0, 0.1, 0.0]] * (len(load) * len(planes)))
    model = DamageModel.MODIFIED_EIGENEROSION if damage == "modified" else DamageModel.EIGENEROSION
    return scenes.SceneBundle(
        name="l_panel3" + ("-modified" if damage == "modified" else ""), grid=grid,
        models=models, colliders=colliders, particles=particles,
        params=SolverParameters(dt=b2.params.dt, boundary_handling=BoundaryHandling.STICK,
                                damage_model=model),
        gravity=(0.0, 0.0, 0.0), hooks=hooks)


def substep_state(b, substeps):
    """(pipeline, state): `b` packed through auto_pipeline and advanced by
    `substeps` single substeps (so that psi_pos, the velocities and the
    stress are the path's own, not the packed zeros)."""
    from dataclasses import replace
    import sparkl_tpu_torch as sk

    pipe = sk.auto_pipeline(replace(b, params=replace(b.params, stop_after_one_substep=True)))
    state = pipe.pack_state(b.particles)
    for _ in range(substeps):
        state, _ = pipe.run_frames_state(state, 1)
    return pipe, state


def perturbed_eigen(state, h, seed=13):
    """`state` with positions jittered by up to 0.3 h, psi_pos drawn so that
    crack energies straddle the threshold (energy ~ cpf·h·mean psi, so psi
    uniform in [0, 2·threshold/(cpf·h)]), and a quarter of the lanes broken
    (ineligible). 3D or 2D slots."""
    import numpy as np
    import torch
    from sparkl_tpu_torch.fused import layout as L

    dim = slot_dim(state)
    r = L.Rows(dim)
    d_, _, c = state.slots.shape
    rng = np.random.default_rng(seed)
    occ = (state.ints[:, L.I_FLAGS, :] & L.OCCUPIED) != 0
    crack = occ & (state.slots[:, r.cpf] != 0.0)
    psi_max = 2.0 * (state.slots[:, r.cthr][crack].max()
                     / (state.slots[:, r.cpf][crack].max() * h)).item()
    slots = state.slots.clone()

    def dev(x):
        return torch.from_numpy(x.astype(np.float32)).to(slots.device)

    slots[:, r.pos : r.pos + dim] += torch.where(
        occ[:, None, :], dev(rng.uniform(-0.3 * h, 0.3 * h, size=(d_, dim, c))), 0.0)
    slots[:, r.psi_pos] = torch.where(occ, dev(rng.uniform(0.0, psi_max, size=(d_, c))), 0.0)
    slots[:, r.phase] = torch.where(occ & dev(rng.uniform(size=(d_, c)) < 0.25).bool(), 0.0,
                                    slots[:, r.phase])
    return state.replace(slots=slots)


def jittered(state, h, seed=17):
    """`state` with positions moved by up to one cell at random: its resort
    takes the mixed branch (every kernel of the resort runs)."""
    import numpy as np
    import torch
    from sparkl_tpu_torch.fused import layout as L

    d_, _, c = state.slots.shape
    occ = (state.ints[:, L.I_FLAGS, :] & L.OCCUPIED) != 0
    noise = np.random.default_rng(seed).uniform(-h, h, size=(d_, 2, c)).astype(np.float32)
    slots = state.slots.clone()
    slots[:, 0:2] += torch.where(occ[:, None, :], torch.from_numpy(noise).to(slots.device), 0.0)
    return state.replace(slots=slots)


def check_eigen(pipe, state, label, phase, timed=False):
    """The pooling kernel against its plain version on `state`: the same
    mask (the distance tests round alike), sums of non-negative terms in
    other orders within 2e-6 relative, bit-equal to a second launch; the
    eigenerosion trips each pool gives equal but on lanes whose energy
    lies within TIE of the threshold (counted). With `timed`, times, the
    library yardstick (torch.cdist and a masked torch.bmm over the same
    candidate tiles) and the bound. 3D or 2D."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L

    grid, cfg = pipe.grid, pipe._cfg
    dim = grid.dim
    r = L.Rows(dim)
    e, elig = pipe._eigen_rows(state)
    cand, _ = pipe._eigen_candidates(state.structure)
    out_k = K.eigen_pool_fused(grid, cfg, e, cand)
    out_k2 = K.eigen_pool_fused(grid, cfg, e, cand)
    g = K.eigen_candidate_rows(e, cand)
    out_p = K.eigen_pool_fused_reference(grid, e, g)[:, :2]
    torch.cuda.synchronize()
    same_mask = torch.equal(out_k != 0, out_p != 0)
    rel = torch.where(out_p > 0, (out_k - out_p).abs() / out_p.clamp(min=1e-30), 0.0).max().item()
    par1_k, trip_k = pipe._eigen_update(state, out_k, elig)
    _, trip_p = pipe._eigen_update(state, out_p, elig)
    cthr = state.slots[:, r.cthr]
    tie = (par1_k - cthr).abs() <= TIE * cthr.abs()
    differ = trip_k != trip_p
    res = dict(max_abs_err=(out_k - out_p).abs().max().item(), rel_err=rel,
               bit_equal_relaunch=torch.equal(out_k, out_k2), eligible=int(elig.sum()),
               pooled_lanes=int((out_k[:, 1] > 0).sum()), trips_kernel=int(trip_k.sum()),
               trips_plain=int(trip_p.sum()), tie_lanes=int((tie & elig).sum()),
               trips_differ=int(differ.sum()))
    say(phase, f"eigen_pool_fused on the {label} state: {res['eligible']} eligible lanes, "
               f"{res['pooled_lanes']} with neighbours; mask equal {same_mask}, max rel err "
               f"{rel:.2e} (2e-6), bit-equal to a second launch {res['bit_equal_relaunch']}; "
               f"trips kernel {res['trips_kernel']} / plain {res['trips_plain']}, differing "
               f"{res['trips_differ']}, lanes within {TIE:g} of the threshold {res['tie_lanes']}")
    require(same_mask and rel <= 2e-6 and res["bit_equal_relaunch"]
            and not bool((differ & ~tie).any()),
            f"eigen_pool_fused disagrees with its plain version on the {label} state")
    if not timed:
        return res
    d_, kn = cand.shape
    c = cfg.chunk_size
    own = e[:, 0:dim].transpose(1, 2).contiguous()  # [D, C, d]
    cpos = g[:, :, 0:dim, :].permute(0, 1, 3, 2).reshape(d_, kn * c, dim)
    vals = g[:, :, dim : dim + 2, :].permute(0, 1, 3, 2).reshape(d_, kn * c, 2)
    c_el = g[:, :, dim + 2, :].reshape(d_, 1, kn * c) != 0
    self_lane = (g[:, :, K.EIG_SELF, :].reshape(d_, 1, kn * c) != 0) & (
        torch.arange(kn * c, device=e.device) % c == torch.arange(c, device=e.device)[:, None])

    # The [C, KN·C] distance tiles of ~2^28 pairs at a time (all of 2D's
    # chunks; ~150 chunks in 3D, where all of them would take ~40 GB).
    group = max(1, 2**28 // (c * kn * c))

    def library():
        out = []
        for g0 in range(0, d_, group):
            sl = slice(g0, g0 + group)
            near = torch.cdist(own[sl], cpos[sl]) <= grid.cell_width
            mask = near & c_el[sl] & elig[sl, :, None] & ~self_lane[sl]
            out.append(torch.bmm(mask.to(torch.float32), vals[sl]))
        return torch.cat(out)

    lib_err = (library().transpose(1, 2) - out_k).abs().max().item()
    # The plain version walks 3D's candidates 4 chunks at a time (~1 s a
    # call at l_panel3's size): fewer repetitions.
    reps = 20 if dim == 2 else 5
    res["ms"] = cuda_median_ms(lambda: K.eigen_pool_fused(grid, cfg, e, cand))
    res["plain_ms"] = cuda_median_ms(
        lambda: K.eigen_pool_fused_reference(grid, e, K.eigen_candidate_rows(e, cand)), reps)
    res["library_ms"] = cuda_median_ms(library, reps)
    live = int(state.structure.num_chunks)
    valid = (cand < d_).sum(dim=1)
    res["pairs"] = int((elig.sum(dim=1) * valid).sum()) * c
    res["bytes"] = live * K.EIG_ROWS * c * 4 + d_ * kn * 4 + d_ * 2 * c * 4
    res["flops"] = res["pairs"] * EIG_PAIR_FLOPS
    res["bound_ms"], res["bound_by"] = bound(res["bytes"], res["flops"])
    say(phase, f"eigen_pool_fused ({label}): kernel {res['ms']:.3f} ms, plain "
               f"{res['plain_ms']:.3f} ms, library (cdist + masked bmm) {res['library_ms']:.3f} ms "
               f"(medians of 20, {reps} and {reps}; library max|diff| {lib_err:.2e}); "
               f"{res['pairs']} pair tests; "
               f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    return res


def phase_fracture_kernels():
    """l_panel2's kernels against their plain versions on the card, at the
    reference settings and at cell width 0.0025, on the path's state
    FRACTURE_SUBSTEPS_IN substeps in: the pooling (and on a perturbed state
    whose energies straddle the threshold), kernels A and B and the merge
    (and B on a state with F perturbed so that maximum stress trips), and
    the resort's source-row and permute kernels at C = 64 on a state
    jittered by a cell (their resort on the card against a CPU copy).
    Returns {config: {name: {...}}}."""
    import torch

    out = {}
    for label, cell in (("reference", None), ("fine", FRACTURE_FINE_CELL)):
        t0 = time.perf_counter()
        b = fracture_bundle(cell)
        pipe, state = substep_state(b, FRACTURE_SUBSTEPS_IN)
        dt = float(pipe._min_dtb(state))
        h = b.grid.cell_width
        say(12, f"l_panel2 {label}: {int(b.particles.active.sum())} particles, {pipe._cfg}, grid "
                f"{b.grid.res}, {FRACTURE_SUBSTEPS_IN} substeps in, dt {dt:.3e}, set-up "
                f"{time.perf_counter() - t0:.1f} s")
        res = {"eigen_pool_fused": check_eigen(pipe, state, label, 12, timed=True)}
        res["eigen_pool_fused"]["perturbed"] = check_eigen(
            pipe, perturbed_eigen(state, h), f"{label} perturbed", 12)
        res.update(check_kernels_2d(pipe, state, dt, label, 12, timed=True))
        perturbed = perturbed_f(state, seed=11, scale=2e-4)
        res["g2p_fused"]["perturbed"] = check_kernels_2d(pipe, perturbed, dt,
                                                         f"{label} perturbed-F", 12)["g2p_fused"]
        # The forms without the psi channels (2D failure without
        # eigenerosion): kernel A's 3-channel instance, B on the velocity
        # windows alone.
        meta0 = dict(pipe._meta, with_psi=False)
        res["without psi"] = {lab: check_kernels_2d(pipe, st, dt, f"{lab} without psi", 12,
                                                    meta=meta0)
                              for lab, st in ((label, state), (f"{label} perturbed-F",
                                                               perturbed))}
        require(res["g2p_fused"]["perturbed"]["trips"] > 0,
                "no maximum-stress trip on the perturbed-F state: the trip went unchecked")
        require(res["eigen_pool_fused"]["perturbed"]["trips_kernel"] > 0,
                "no eigenerosion trip on the perturbed state: the trip went unchecked")
        rres, _ = phase_resort(pipe, jittered(state, h), phase=12)
        res.update(rres)
        out[label] = res
        del pipe, state, b
        torch.cuda.empty_cache()
    return out


def phase_fracture_first_resort(pipe, state):
    """l_panel2 past its first resort: from the main path's state, frame by
    frame until a frame holds the first lazy resort (at most
    FRACTURE_RESORT_FRAMES more frames); then, on the state that resort left
    (before that substep's pooling), the eigenerosion candidate list
    bit-equal to the same torch code on a CPU copy of the structure, and
    the pooling against its plain version (check_eigen). Returns
    results."""
    import torch
    from sparkl_tpu_torch.fused.pipeline import DRIFT_FRACTION
    from sparkl_tpu_torch.fused.structure import SlotStructure

    kept = []
    resort = pipe._resort

    def keep(st):
        st, flags = resort(st)
        if not kept and not flags:
            kept.append(st.replace(slots=st.slots.clone(), ints=st.ints.clone()))
        return st, flags

    pipe._resort = keep
    frames = substeps = 0
    t0 = time.perf_counter()
    while not kept and frames < FRACTURE_RESORT_FRAMES:
        state, n = pipe.run_frames_state(state, 1)
        frames += 1
        substeps += n
    pipe._resort = resort
    seconds = time.perf_counter() - t0
    say(13, f"l_panel2 on to its first resort: {frames} more frames ({substeps} substeps) in "
            f"{seconds:.1f} s; resort branches {pipe.resort_branches}; drift now "
            f"{float(state.cum_disp) / pipe.grid.cell_width:.3f} cells (a resort at "
            f"{DRIFT_FRACTION})")
    require(kept, f"no resort within {FRACTURE_RESORT_FRAMES} frames past the main path")
    st = kept[0]
    cand_k, ov_k = pipe._eigen_candidates(st.structure)
    cpu = SlotStructure(**{k: v.cpu() for k, v in st.structure.tensors().items()})
    cand_c, ov_c = pipe._eigen_candidates(cpu)
    same = torch.equal(cand_k.cpu(), cand_c) and bool(ov_k) == bool(ov_c)
    say(13, f"after l_panel2's first resort: candidate list {tuple(cand_k.shape)} bit-equal to "
            f"the CPU's {same} (overflow {bool(ov_k)})")
    require(same, "the candidate list after the resort differs from its CPU version")
    res = check_eigen(pipe, st, "l_panel2 after its first resort", 13)
    return dict(frames_more=frames, substeps_more=substeps, seconds=seconds,
                candidates_bit_equal=same, pooling=res, branches=dict(pipe.resort_branches))


def phase_fracture_agreement():
    """l_panel2 at the reference settings: three single substeps on the
    card against the port's CPU path (plain versions), with the JAX
    package's fused-vs-dense tolerances, equal flags and phase; and one
    frame run twice on the card, bit-equal in every particle field."""
    from dataclasses import replace
    import torch
    import sparkl_tpu_torch as sk
    from sparkl_tpu_torch import interop

    out = {}
    for dev in ("cuda", "cpu"):
        b = fracture_bundle(device=dev)
        pipe = sk.auto_pipeline(replace(b, params=replace(b.params, stop_after_one_substep=True)),
                                device=dev)
        state = pipe.pack_state(b.particles)
        for _ in range(3):
            state, _ = pipe.run_frames_state(state, 1)
        out[dev] = pipe.unpack_state(state).to("cpu")
    pg, pc = out["cuda"], out["cpu"]
    act = pc.active
    dx = (pg.position[act] - pc.position[act]).abs().max().item()
    dv = (pg.velocity[act] - pc.velocity[act]).abs().max().item()
    df = (pg.deformation_gradient[act] - pc.deformation_gradient[act]).abs().max().item()
    flags = (torch.equal(pg.active, pc.active) and torch.equal(pg.failed[act], pc.failed[act])
             and torch.equal(pg.phase[act], pc.phase[act]))
    say(14, f"l_panel2, 3 substeps, card against CPU: max|dx| {dx:.3e} ({FRACTURE_DX:g}), "
            f"max|dv| {dv:.3e} ({FRACTURE_DV:g}; max|v| "
            f"{pc.velocity[act].abs().max().item():.4f}), max|dF| {df:.3e} ({FRACTURE_DF:g}), "
            f"active, failed and phase equal {flags}")
    require(flags, "l_panel2 card and CPU: flags or phase differ")
    require(dx <= FRACTURE_DX and dv <= FRACTURE_DV and df <= FRACTURE_DF,
            "l_panel2 card and CPU disagree")
    runs = []
    for _ in range(2):
        b = fracture_bundle()
        p, n = sk.auto_pipeline(b).step_with_stats(b.particles)
        runs.append((interop.particles_to_numpy(p), n))
    (a, na), (a2, na2) = runs
    differ = [k for k in a if not (a[k] == a2[k]).all()]
    say(14, f"l_panel2 one frame twice on the card: substeps {na}/{na2}, bit-equal in every "
            f"particle field {not differ} (differ: {differ})")
    require(not differ and na == na2, f"two card frames of l_panel2 differ in {differ}")
    return dict(max_dx=dx, max_dv=dv, max_df=df, frame_substeps=na, repeat_bit_equal=not differ)


def psi_gathered(pipe, state, windows):
    """The psi channel of `windows` [D, d + 1, 8^d] at each slot, gathered
    as kernel B's plain version gathers it (the crack energy of the
    modified trip is cpf·h times it)."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L

    grid = pipe.grid
    dim = grid.dim
    d_, _, c = state.slots.shape
    _, fx, rel, in_window, in_bounds = K._slot_geometry(grid, state.slots, state.ints)
    contrib = ((state.ints[:, L.I_FLAGS, :] & L.ACTIVE) != 0) & in_window & in_bounds
    w, dpt = K._taps(grid, fx, rel)
    ntaps = 3**dim
    q = K._tap_cells(rel, contrib).reshape(d_, 1, ntaps * c).expand(d_, dim + 1, ntaps * c)
    win = torch.gather(windows[:, : dim + 1], 2, q).reshape(d_, dim + 1, ntaps, c)
    return K._gather(grid, w, dpt, win, contrib.to(torch.float32))[2]


def check_kernels_3d(pipe, state, dt, label, phase, timed=False):
    """The 3D damage forms against their plain versions on the l_panel3
    `state`: kernel A's fresh-stress form with the psi channels
    (p2g_errors's bound), the merge on its images (bit-equal), and kernel B's
    damage form on the windows the path computes: the maximum-stress trip on
    the fresh stress of the final F, and under modified eigenerosion the
    psi gather and the crack-energy trip (g2p_errors's row tolerances on
    occupied lanes; the phase row equal but on lanes whose largest
    principal stress lies within TIE of the envelope or whose crack energy
    lies within TIE of the threshold). Trips are counted. With `timed`,
    times and bounds. Returns {name: {...}}."""
    import torch
    from sparkl_tpu_torch.core.params import DamageModel
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.math import svd
    from sparkl_tpu_torch.models import failure as fail
    from sparkl_tpu_torch.sparse import transfer as T

    meta = pipe._meta
    modified = meta["damage_model"] == DamageModel.MODIFIED_EIGENEROSION
    grid, cfg = pipe.grid, pipe._cfg
    r = L.Rows(3)
    nch = state.structure.num_chunks
    tables = (pipe._tab_f, pipe._tab_i)
    img_k = K.p2g_fused(grid, cfg, meta, state.slots, state.ints, dt, nch, tables)
    img_p = K.p2g_fused_reference(grid, state.slots, state.ints, dt, nch, tables,
                                  stress_cache=False, with_psi=True)
    rows = image_rows(cfg, img_k)
    first, nblk = state.structure.block_first_chunk, state.structure.block_num_chunks
    m_k = K.merge_blocks(rows, first, nblk)
    m_p = K.merge_blocks_reference(rows, first, nblk, T.MERGE_KMAX)
    windows = pipe._grid_windows(state, img_k, dt)
    slots_in = state.slots.clone()
    args = (pipe._tab_f, pipe._tab_i, nch)
    out_p = K.g2p_fused_reference(grid, slots_in, state.ints, windows, dt, *args,
                                  velocity_clamp=pipe._kparams["gpu_velocity_clamp"],
                                  stress_cache=False, modified=modified)
    out_k = K.g2p_fused(grid, cfg, meta, pipe._kparams, slots_in.clone(), state.ints, windows,
                        dt, *args)
    torch.cuda.synchronize()
    per_ch = p2g_errors(img_k, img_p)
    occ = (state.ints[:, L.I_FLAGS, :] & L.OCCUPIED) != 0
    row_errs = g2p_errors(out_k, out_p, state.ints, pipe.models.cparams, grid.cell_width,
                          skip_rows=(r.phase,))
    worst = {}
    for _, grp, m, tol in row_errs:
        worst[grp] = max(worst.get(grp, 0.0), m / tol if tol else m)
    (ct, ft), p = K.model_columns(pipe._tab_f, pipe._tab_i, state.ints, range(16), (0, 2))
    f = [[out_k[:, r.defgrad + 3 * i + j] for j in range(3)] for i in range(3)]
    st = K.kirchhoff_stress_c(ct, p[0:4], slots_in[:, r.phase], out_k[:, r.eh], f, None, None,
                              None, (0,))
    emax = svd.sym_eigvals3x3_c([[0.5 * (st[i][j] + st[j][i]) for j in range(3)]
                                 for i in range(3)])[0]
    mp = p[K.TAB_F]
    stress_tie = (ft == fail.MAXIMUM_STRESS) & ((emax - mp).abs() <= TIE * mp.abs())
    live = occ & (slots_in[:, r.phase] > 0.0)
    stress_trips = int((live & (ft == fail.MAXIMUM_STRESS) & (out_p[:, r.phase] == 0.0)).sum())
    cpf, cthr = slots_in[:, r.cpf], slots_in[:, r.cthr]
    crack_tie = torch.zeros_like(occ)
    crack_trips = 0
    if modified:
        crack = cpf * grid.cell_width * psi_gathered(pipe, state, windows)
        crack_tie = (cpf != 0.0) & ((crack - cthr).abs() <= TIE * cthr.abs())
        crack_trips = int((live & (cpf != 0.0) & (crack > cthr)).sum())
    tie = (stress_tie | crack_tie) & occ
    differ = occ & (out_k[:, r.phase] != out_p[:, r.phase])
    same_bits = torch.equal(torch.where(occ[:, None, :], out_k, 0.0),
                            torch.where(occ[:, None, :], out_p, 0.0))
    res = {
        "p2g_fused": dict(max_abs_err=max(e for _, e in per_ch),
                          over_bound=max(m for m, _ in per_ch)),
        "merge_blocks": dict(max_abs_err=(m_k - m_p).abs().max().item(),
                             bit_equal=torch.equal(m_k, m_p)),
        "g2p_fused": dict(max_abs_err=torch.where(occ[:, None, :], out_k - out_p,
                                                  0.0).abs().max().item(),
                          worst_over_tol=worst, bit_equal=same_bits, modified=modified,
                          stress_trips=stress_trips, crack_trips=crack_trips,
                          trips_differ=int(differ.sum()), tie_lanes=int(tie.sum())),
    }
    say(phase, f"3D damage kernels on the {label} state: p2g_fused images {tuple(img_k.shape)} "
               f"max|err|/bound {[f'{m:.2e}' for m, _ in per_ch]} (pass <= 1); merge_blocks "
               f"{tuple(m_k.shape)} bit-equal {res['merge_blocks']['bit_equal']}; g2p_fused "
               f"(modified trip {modified}) worst measure/tol "
               f"{({g: round(v, 4) for g, v in worst.items()})}, bit-equal on occupied lanes "
               f"{same_bits}; trips: maximum stress {stress_trips}, crack energy {crack_trips}; "
               f"phase differing {res['g2p_fused']['trips_differ']} (lanes within {TIE:g} of a "
               f"threshold {res['g2p_fused']['tie_lanes']})")
    failures = []
    if not (all(m <= 1.0 for m, _ in per_ch) and torch.isfinite(img_k).all().item()):
        failures.append("p2g_fused")
    if not res["merge_blocks"]["bit_equal"]:
        failures.append("merge_blocks")
    if not (all(v <= 1.0 for v in worst.values()) and not bool((differ & ~tie).any())
            and torch.isfinite(torch.where(occ[:, None, :], out_k, 0.0)).all().item()):
        failures.append("g2p_fused")
    require(not failures, f"{failures} disagree with their plain versions on the {label} state")
    if not timed:
        return res
    live_chunks, row = int(nch), 4 * cfg.chunk_size
    lanes = int(((state.ints[:, L.I_FLAGS, :] & L.ACTIVE) != 0).sum())
    n_win = windows.shape[1]
    scratch = slots_in.clone()
    # Bytes counted from what the 3D damage forms read and write per live
    # chunk: A reads pos 3, vel 3, grad 9, F 9, mass, vol0, phase, eh,
    # failed, cpf and psi_pos (31 rows) and 5 i32 rows (model, flags,
    # origin 3), and writes every chunk's [6, 512] image; B reads 34 f32
    # rows (pos, F, the scalar state, kinematic velocity, crack and
    # bookkeeping rows), 5 i32 rows and the [d (+1), 512] window, and writes
    # all 56 rows.
    for name, fn, plain, nbytes, flops in (
            ("p2g_fused", lambda: K.p2g_fused(grid, cfg, meta, state.slots, state.ints, dt, nch,
                                              tables),
             lambda: K.p2g_fused_reference(grid, state.slots, state.ints, dt, nch, tables,
                                           stress_cache=False, with_psi=True),
             live_chunks * (31 + 5) * row + cfg.max_chunks * img_k.shape[1] * 512 * 4,
             lanes * (27 * (P2G_TAP_FLOPS + P2G3_PSI_TAP_FLOPS) + A3_FRESH_SLOT_FLOPS)),
            ("g2p_fused", lambda: K.g2p_fused(grid, cfg, meta, pipe._kparams, scratch,
                                              state.ints, windows, dt, *args),
             lambda: K.g2p_fused_reference(grid, slots_in, state.ints, windows, dt, *args,
                                           stress_cache=False, modified=modified),
             live_chunks * ((34 + 5 + 56) * row + (4 if modified else 3) * 512 * 4),
             lanes * (27 * (G2P_TAP_FLOPS + (2 if modified else 0)) + B_LANE_FLOPS
                      + B3_FAILURE_FLOPS))):
        v = res[name]
        v["ms"], v["plain_ms"] = cuda_median_ms(fn), cuda_median_ms(plain)
        v["library_ms"] = None
        v["bytes"], v["flops"] = nbytes, flops
        v["bound_ms"], v["bound_by"] = bound(nbytes, flops)
        say(phase, f"{name} (3D damage, {label}): kernel {v['ms']:.3f} ms, plain "
                   f"{v['plain_ms']:.3f} ms (median of 20); window channels {n_win}; "
                   f"{nbytes / 1e9:.4f} GB and {flops / 1e9:.4f} GFLOP counted; bound "
                   f"{v['bound_ms']:.4f} ms ({v['bound_by']})")
    return res


def phase_lpanel3_kernels():
    """The four 3D damage forms against their plain versions on the card, at
    l_panel3's full size (600,000 particles) LPANEL3_SUBSTEPS_IN substeps
    in: the 3D pooling (and on a perturbed state whose crack energies
    straddle the threshold), kernel A's fresh-stress form with the psi
    channels and kernel B's maximum-stress trip (and on a state with F
    perturbed so that maximum stress trips), with times; then on
    l_panel3-modified kernel B's crack-energy trip (and on a state with
    psi_pos perturbed so that it trips), timed; and the same trip in 2D on
    l_panel2 under modified eigenerosion (check_kernels_2d). Returns
    {config: {name: {...}}}."""
    import torch

    out = {}
    for damage in ("eigenerosion", "modified"):
        t0 = time.perf_counter()
        b = l_panel3(damage)
        pipe, state = substep_state(b, LPANEL3_SUBSTEPS_IN)
        dt = float(pipe._min_dtb(state))
        h = b.grid.cell_width
        say(22, f"{b.name}: {int(b.particles.active.sum())} particles, {pipe._cfg}, grid "
                f"{b.grid.res}, {LPANEL3_SUBSTEPS_IN} substeps in, dt {dt:.3e}, live chunks "
                f"{int(state.structure.num_chunks)}, set-up {time.perf_counter() - t0:.1f} s")
        res = {}
        if damage == "eigenerosion":
            res["eigen_pool_fused"] = check_eigen(pipe, state, b.name, 22, timed=True)
            res["eigen_pool_fused"]["perturbed"] = check_eigen(
                pipe, perturbed_eigen(state, h), f"{b.name} perturbed", 22)
            require(res["eigen_pool_fused"]["perturbed"]["trips_kernel"] > 0,
                    "no eigenerosion trip on the perturbed l_panel3 state: the trip went "
                    "unchecked")
        res.update(check_kernels_3d(pipe, state, dt, b.name, 22, timed=True))
        res["g2p_fused"]["perturbed-F"] = check_kernels_3d(
            pipe, perturbed_f(state, seed=11, scale=2e-4), dt, f"{b.name} perturbed-F",
            22)["g2p_fused"]
        require(res["g2p_fused"]["perturbed-F"]["stress_trips"] > 0,
                "no 3D maximum-stress trip on the perturbed-F state: the trip went unchecked")
        if damage == "modified":
            res["g2p_fused"]["perturbed-psi"] = check_kernels_3d(
                pipe, perturbed_eigen(state, h), dt, f"{b.name} perturbed-psi",
                22)["g2p_fused"]
            require(res["g2p_fused"]["perturbed-psi"]["crack_trips"] > 0,
                    "no modified-eigenerosion trip on the perturbed-psi state: the trip went "
                    "unchecked")
        out[b.name] = res
        del pipe, state, b
        torch.cuda.empty_cache()
    # The crack-energy trip in 2D: l_panel2 under modified eigenerosion.
    b = l_panel2_modified()
    pipe, state = substep_state(b, FRACTURE_SUBSTEPS_IN)
    dt = float(pipe._min_dtb(state))
    res = check_kernels_2d(pipe, state, dt, b.name, 22, timed=True)
    res["g2p_fused"]["perturbed-psi"] = check_kernels_2d(
        pipe, perturbed_eigen(state, b.grid.cell_width), dt, f"{b.name} perturbed-psi",
        22)["g2p_fused"]
    require(res["g2p_fused"]["perturbed-psi"]["counts"]["crack_trips"] > 0,
            "no 2D modified-eigenerosion trip on the perturbed-psi state: the trip went "
            "unchecked")
    out[b.name] = res
    return out


def l_panel2_modified(device="cuda"):
    """scenes.build("l_panel2") under modified eigenerosion."""
    from dataclasses import replace
    from sparkl_tpu_torch.core.params import DamageModel

    b = fracture_bundle(device=device)
    return replace(b, name="l_panel2-modified", params=replace(
        b.params, damage_model=DamageModel.MODIFIED_EIGENEROSION))


def panel_stats(state):
    """Per model id (panel) of a 3D or 2D state: [broken, failed] counts of
    the occupied slots (phase 0: eigenerosion, crack-energy or
    maximum-stress trips; the failed flag), and the active mass in
    double."""
    import torch
    from sparkl_tpu_torch.fused import layout as L

    r = L.Rows(slot_dim(state))
    flags = state.ints[:, L.I_FLAGS, :]
    occ = (flags & L.OCCUPIED) != 0
    act = (flags & L.ACTIVE) != 0
    mid = state.ints[:, L.I_MODEL, :]
    per = [[int((occ & (mid == m) & (state.slots[:, r.phase] == 0.0)).sum()),
            int((occ & (mid == m) & (state.slots[:, r.failed] != 0.0)).sum())] for m in (0, 1)]
    mass = torch.where(act, state.slots[:, r.mass], 0.0).double().sum().item()
    return per, mass


def phase_damage_main(b, frames, timed_frames, phase):
    """A damage main path (l_panel2, l_panel3, and both under modified
    eigenerosion): the bundle `b` -> auto_pipeline -> pack_state -> `frames`
    frames of run_frames_state (the last `timed_frames` timed, each frame
    clocked alone) -> unpack_state, with
    each kernel's launches held against the substeps the pipeline ran
    (retried spans included): A, the merge and B once per substep, the
    pooling once per substep under eigenerosion and never under modified
    eigenerosion, the resort kernels by branch; per frame the substeps, the
    broken and failed counts per panel, the candidate-list regrows and the
    mass (held to 1e-6). Returns (the pipeline, the final state, the
    launches, results)."""
    import torch
    import sparkl_tpu_torch as sk
    from sparkl_tpu_torch.fused import kernels as K

    n_active = int(b.particles.active.sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pipe = sk.auto_pipeline(b)
    state = pipe.pack_state(b.particles)
    mass0 = b.particles.mass[b.particles.active].double().sum().item()
    ran = [0]
    substep = pipe._substep

    def counted(st, dt):
        ran[0] += 1
        return substep(st, dt)

    pipe._substep = counted
    K.reset_launch_counts()
    substeps = resorts = timed = 0
    seconds = 0.0
    out_frames = []
    for i in range(frames):
        regrows = pipe.eigen_regrows
        clock = i >= frames - timed_frames
        if clock:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, n = pipe.run_frames_state(state, 1)
        if clock:
            torch.cuda.synchronize()
            seconds += time.perf_counter() - t0
            timed += n
        substeps += n
        resorts += pipe.last_resorts
        per, mass = panel_stats(state)
        out_frames.append(dict(frame=i, substeps=n, broken_failed_per_panel=per, mass=mass,
                               eigen_regrow=pipe.eigen_regrows > regrows))
        require(abs(mass - mass0) <= 1e-6 * mass0, f"{b.name} frame {i}: mass {mass} "
                                                   f"against {mass0}")
    pipe._substep = substep
    launches = dict(K.LAUNCHES)
    branches = dict(pipe.resort_branches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    p = pipe.unpack_state(state)
    act = p.active
    pups = n_active * timed / seconds if timed else None
    for fr in out_frames:
        say(phase, f"{b.name} frame {fr['frame']}: " + ", ".join(
            f"{k} {v}" for k, v in fr.items() if k != "frame"))
    rate = (f"last {timed_frames} frames {timed} substeps in {seconds:.3f} s = {pups:.4g} "
            f"particle-updates/s; " if timed else "")
    say(phase, f"{b.name} path, {frames} frames, {n_active} particles: {substeps} substeps "
               f"({substeps / frames:.1f} per frame), {ran[0]} run (with aborted spans), "
               f"{resorts} resorts {branches}; {rate}eigen candidate list {pipe._eigen_mcb} per "
               f"block, regrown {pipe.eigen_regrows} times; scatter merge pinned "
               f"{pipe._merge_force_scatter}; {pipe._cfg}; peak memory {peak_gib:.2f} GiB; "
               f"launches {launches}")
    require(bool(torch.isfinite(p.position[act]).all()), f"{b.name} path: non-finite positions")
    require(sum(branches.values()) == resorts, f"resorts {resorts}, branches {branches}")
    require(ran[0] >= substeps and (ran[0] == substeps or pipe.eigen_regrows > 0),
            f"the pipeline ran {ran[0]} substeps for {substeps} kept, with no regrow")
    merge = "merge_scatter" if pipe._merge_force_scatter else "merge_blocks"
    expect = dict.fromkeys(K.LAUNCHES, 0)
    expect.update(p2g_fused=ran[0], g2p_fused=ran[0],
                  eigen_pool_fused=ran[0] if pipe._eigen else 0,
                  src_rows_from_order=resorts - branches["relabel"],
                  permute_slots=branches["mixed"])
    expect[merge] = ran[0]
    require(launches == expect, f"{b.name} path launch counts {launches}, expected {expect}")
    per, _ = panel_stats(state)
    return pipe, state, launches, dict(
        particles=n_active, substeps=substeps, substeps_run=ran[0], resorts=resorts,
        branches=branches, timed_substeps=timed, seconds=seconds, pups=pups, peak_gib=peak_gib,
        eigen_regrows=pipe.eigen_regrows, broken_failed_per_panel=per, frames=out_frames,
        config=str(pipe._cfg))


def trip_ties(pipe, p_in, p_out):
    """Particles whose trip decision in the substep from p_in to p_out lies
    within TIE of its threshold, on the pipeline's device: the eigenerosion
    energy pooled from p_in against the crack threshold (under
    eigenerosion), and the largest principal stress of p_out's F (p_in's
    phase) against the maximum-stress envelope. 3D or 2D."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.models import registry as reg

    state = pipe.pack_state(p_in)
    r = L.Rows(pipe.grid.dim)
    tie = torch.zeros_like(p_in.active)
    if pipe._eigen:
        e, elig = pipe._eigen_rows(state)
        cand, _ = pipe._eigen_candidates(state.structure)
        energy, _ = pipe._eigen_update(
            state, K.eigen_pool_fused(pipe.grid, pipe._cfg, e, cand), elig)
        state.slots[:, r.par1] = energy
        energy = pipe.unpack_state(state).parameter1
        cthr = p_in.crack_threshold
        tie = tie | ((p_in.crack_propagation_factor != 0) & ((energy - cthr).abs()
                                                              <= TIE * cthr.abs()))
    st = reg.kirchhoff_stress(pipe.models, p_in.model_id, p_in.phase, p_in.elastic_hardening,
                              p_out.deformation_gradient, p_out.velocity_gradient, p_in.mass,
                              p_in.volume0)
    emax = torch.linalg.eigvalsh(0.5 * (st + st.transpose(1, 2)).double())[:, -1]
    mp = pipe.models.fparams[p_in.model_id.long(), 0].double()
    failing = pipe.models.ftype[p_in.model_id.long()] != 0
    return tie | (failing & ((emax - mp).abs() <= TIE * mp.abs()))


def phase_lpanel3_agreement():
    """l_panel3 reduced (the panels at LPANEL3_SMALL of their size,
    LPANEL3_SMALL_LAYERS layers): LPANEL3_AGREE_SUBSTEPS single substeps on
    the card against the port's CPU path taking the card's dt at every
    substep, with the JAX package's fused-vs-dense tolerances on x, v and
    F; the phase equal but on particles whose trip decision in some substep
    lay within TIE of its threshold (trip_ties, on the CPU run); flags
    equal."""
    from dataclasses import replace
    import torch
    import sparkl_tpu_torch as sk

    runs, dts = {}, []
    for dev in ("cuda", "cpu"):
        b = l_panel3(scale=LPANEL3_SMALL, layers=LPANEL3_SMALL_LAYERS, device=dev)
        pipe = sk.auto_pipeline(replace(b, params=replace(b.params, stop_after_one_substep=True)),
                                device=dev)
        min_dtb = pipe._min_dtb
        if dev == "cuda":
            pipe._min_dtb = lambda st: dts.append(min_dtb(st)) or dts[-1]
        else:
            replay = iter([float(x) for x in dts])
            pipe._min_dtb = lambda st: torch.tensor(next(replay), dtype=torch.float32)
        state = pipe.pack_state(b.particles)
        ps = [b.particles.to("cpu")]
        for _ in range(LPANEL3_AGREE_SUBSTEPS):
            state, _ = pipe.run_frames_state(state, 1)
            ps.append(pipe.unpack_state(state).to("cpu"))
        runs[dev] = (pipe, ps)
    cpipe, pc = runs["cpu"]
    pg = runs["cuda"][1]
    del cpipe._min_dtb  # the replay is spent: trip_ties packs afresh
    ties = torch.zeros_like(pc[0].active)
    worst = dict(dx=0.0, dv=0.0, df=0.0)
    mismatch = net = 0
    for k in range(1, LPANEL3_AGREE_SUBSTEPS + 1):
        a, c = pg[k], pc[k]
        act = c.active
        worst["dx"] = max(worst["dx"], (a.position[act] - c.position[act]).abs().max().item())
        worst["dv"] = max(worst["dv"], (a.velocity[act] - c.velocity[act]).abs().max().item())
        worst["df"] = max(worst["df"], (a.deformation_gradient[act]
                                        - c.deformation_gradient[act]).abs().max().item())
        ties = ties | trip_ties(cpipe, pc[k - 1], c)
        differ = act & (a.phase != c.phase)
        mismatch = int(differ.sum())
        net = int((differ & ~ties).sum())
        require(torch.equal(a.active, c.active) and torch.equal(a.failed[act], c.failed[act]),
                f"reduced l_panel3 substep {k}: active or failed flags differ")
    act = pc[-1].active
    broken = int((act & (pc[-1].phase == 0)).sum())
    say(24, f"reduced l_panel3 ({int(act.sum())} particles), {LPANEL3_AGREE_SUBSTEPS} substeps "
            f"at the card's dts {[f'{float(x):.3e}' for x in dts]}, card against CPU: max|dx| "
            f"{worst['dx']:.3e} ({FRACTURE_DX:g}), max|dv| {worst['dv']:.3e} ({FRACTURE_DV:g}; "
            f"max|v| {pc[-1].velocity[act].abs().max().item():.4f}), max|dF| {worst['df']:.3e} "
            f"({FRACTURE_DF:g}); phase differing {mismatch}, net of {int(ties.sum())} tie "
            f"particles {net}; broken {broken}")
    require(net == 0, "reduced l_panel3: card and CPU phases differ off the ties")
    require(worst["dx"] <= FRACTURE_DX and worst["dv"] <= FRACTURE_DV
            and worst["df"] <= FRACTURE_DF, "reduced l_panel3: card and CPU disagree")
    return dict(worst, phase_differ=mismatch, phase_differ_net_of_ties=net,
                tie_particles=int(ties.sum()), dts=[float(x) for x in dts], broken=broken)



def phase_fracture_regrow():
    """The eigenerosion candidate list's regrow and retry on the card:
    l_panel2's crack panel sampled at r = h/6 (9 particles per cell, 3
    chunks to a block, past the list's 2) overflows at the span's start,
    doubles the list and retries; one frame of it is bit-equal to the same
    frame of a pipeline whose list held 4 from the start."""
    from dataclasses import replace
    import numpy as np
    import sparkl_tpu_torch as sk
    from sparkl_tpu_torch import interop
    from sparkl_tpu_torch.scenes import scenes2d

    b = fracture_bundle()
    h = b.grid.cell_width
    poly = np.array([[0.0, 0.0], [0.25, 0.0], [0.25, 0.25], [0.5, 0.25], [0.5, 0.5],
                     [0.0, 0.5]], np.float32)
    p = scenes2d._sample_polygon(poly, (40.0 * h, 40.0 * h), 0, h / 6.0, 2500.0,
                                 b.particles.device, crack_propagation_factor=4.5,
                                 crack_threshold=89.0, m_c=0.0, g=10.0)
    b = replace(b, particles=p)
    runs = []
    for mcb in (2, 4):
        pipe = sk.auto_pipeline(b)
        pipe._eigen_mcb = mcb
        q, n = pipe.step_with_stats(b.particles)
        runs.append((interop.particles_to_numpy(q), n, pipe.eigen_regrows, pipe._eigen_mcb))
    (a2, n2, g2, m2), (a4, n4, g4, m4) = runs
    differ = [k for k in a2 if not (a2[k] == a4[k]).all()]
    kmax = int(pipe.pack_state(b.particles).structure.block_num_chunks.max())
    say(14, f"eigenerosion regrow on the card: {p.capacity} crack particles at r = h/6, up to "
            f"{kmax} chunks per block; list of 2: regrown {g2} time(s) to {m2}, {n2} substeps; "
            f"list of 4 from the start: regrown {g4} times, {n4} substeps; bit-equal in every "
            f"particle field {not differ} (differ: {differ}); broken "
            f"{int((a2['phase'] == 0).sum())}")
    require(kmax > 2 and (g2, m2, g4, m4) == (1, 4, 0, 4),
            "the eigenerosion candidate list did not regrow as required")
    require(not differ and n2 == n4, f"the regrown run differs from the unregrown one in {differ}")
    return dict(particles=p.capacity, kmax=kmax, regrows=g2, substeps=n2, bit_equal=not differ)


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
    # mixed one the permute kernel once. The fluid pass's kernels, the
    # scatter merge and the pooling are not on this path.
    expect = dict(p2g_fused=substeps, merge_blocks=substeps, merge_scatter=0,
                  g2p_fused=substeps, mass_p2g_fused=0, mass_g2p_fused=0,
                  src_rows_from_order=resorts - branches["relabel"],
                  permute_slots=branches["mixed"], eigen_pool_fused=0, permute_chunks=0)
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
    _, fluid_res["profile"] = profile_frame(fpipe, fstate, "fluid_profile.txt", 10, "fluid")
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

    # 12. The l_panel2 kernels against their plain versions, at the
    # reference settings and at cell width 0.0025.
    fracture_res = {"kernels": phase_fracture_kernels()}
    ref = fracture_res["kernels"]["reference"]
    kres["eigen_pool_fused"] = ref["eigen_pool_fused"]

    # 13. The l_panel2 main path; one profiled frame; on to the first
    # resort, and the candidates and the pooling after it.
    frpipe, frstate, fracture_launches, fracture_res["main"] = phase_damage_main(
        fracture_bundle(), FRACTURE_FRAMES, FRACTURE_TIMED, 13)
    frstate, fracture_res["profile"] = profile_frame(frpipe, frstate, "fracture_profile.txt", 13,
                                                     "fracture")
    fracture_res["first_resort"] = phase_fracture_first_resort(frpipe, frstate)
    missing = [k for k in ("eigen_pool_fused", "p2g_fused", "g2p_fused") if
               fracture_launches[k] == 0]
    require(not missing, f"kernels the fracture path never launched: {missing}")
    del frpipe, frstate

    # 14. l_panel2 card against CPU, and card against card; the candidate
    # list's regrow and retry.
    fracture_res["agreement"] = phase_fracture_agreement()
    fracture_res["regrow"] = phase_fracture_regrow()
    fine = fracture_res["kernels"]["fine"]
    kres["permute_chunks"] = dict(
        kres["permute_chunks"], fracture=ref["permute_chunks"], fine=fine["permute_chunks"],
        launches=sum(x["permute_chunks"]["launches"] for x in (kres, ref, fine)))

    # 15. The 2D plastic kernels against their plain versions: elasticity2,
    # basic2 and perturbed states of both, and a 250,000-particle block.
    plastic_res = {"kernels": phase_plastic_kernels()}

    # 16. The two 2D plastic main paths; one profiled frame of basic2.
    plastic_launches = {}
    for name in ("elasticity2", "basic2"):
        ppipe, pstate, plastic_launches[name], plastic_res[name] = phase_plastic_main(name)
    _, plastic_res["profile"] = profile_frame(ppipe, pstate, "plastic2d_profile.txt", 16,
                                              "basic2")
    del ppipe, pstate

    # 17. Each scene card against CPU, and card against card; elasticity2's
    # substep stage by stage, card against CPU.
    for name in ("elasticity2", "basic2"):
        plastic_res[name]["agreement"] = phase_plastic_agreement(name)
    plastic_res["elasticity2"]["bisect"] = phase_stage_bisect("elasticity2", 17)

    # 18. fluids2's kernel forms against their plain versions, on fluids2 as
    # published and, timed, on a 250,000-particle column.
    fluid2_res = {"kernels": phase_fluids2_kernels()}

    # 19. fluids2 as published, 10 frames; one profiled frame.
    f2pipe, f2state, fluid2_launches, fluid2_res["main"] = phase_plastic_main(
        "fluids2", 19, golden=False)
    _, fluid2_res["profile"] = profile_frame(f2pipe, f2state, "fluids2_profile.txt", 19,
                                             "fluids2")
    del f2pipe, f2state
    forms = ("p2g_fused", "g2p_fused", "mass_p2g_fused", "mass_g2p_fused")
    missing = [k for k in forms if fluid2_launches[k] == 0]
    require(not missing, f"kernels the fluids2 path never launched: {missing}")

    # 20. fluids2 at the golden's size (n = 40), every frame against it.
    fluid2_res["golden"] = phase_plastic_main("fluids2", 20, golden=True, timed_frames=0,
                                              n=40)[3]

    # 21. fluids2 card against CPU and card against card; its substep stage
    # by stage, card against CPU.
    fluid2_res["agreement"] = phase_plastic_agreement("fluids2", 21)
    fluid2_res["bisect"] = phase_stage_bisect("fluids2", 21)

    # 22. The 3D damage forms against their plain versions at l_panel3's
    # full size; the crack-energy trip in 3D and in 2D.
    damage_res = {"kernels": phase_lpanel3_kernels()}

    # 23. The l_panel3 main path; one profiled frame.
    l3pipe, l3state, lp3_launches, damage_res["l_panel3"] = phase_damage_main(
        l_panel3(), LPANEL3_FRAMES, LPANEL3_TIMED, 23)
    _, damage_res["profile"] = profile_frame(l3pipe, l3state, "lpanel3_profile.txt", 23,
                                             "l_panel3")
    del l3pipe, l3state
    forms3 = ("p2g_fused", "g2p_fused", "eigen_pool_fused")
    missing = [k for k in forms3 if lp3_launches[k] == 0]
    require(not missing, f"kernels the l_panel3 path never launched: {missing}")

    # 24. Reduced l_panel3, card against CPU.
    damage_res["agreement"] = phase_lpanel3_agreement()

    # 25. l_panel3 and l_panel2 under modified eigenerosion: kernel B's
    # crack-energy trip on a main path, no pooling.
    mod_launches = {}
    for name, b, frames in (("l_panel3-modified", l_panel3("modified"), LPANEL3_MODIFIED_FRAMES),
                            ("l_panel2-modified", l_panel2_modified(), 1)):
        mpipe, _, mod_launches[name], damage_res[name] = phase_damage_main(b, frames, 1, 25)
        require(mod_launches[name]["g2p_fused"] > 0 and
                mod_launches[name]["eigen_pool_fused"] == 0,
                f"{name}: kernel B not launched, or the pooling launched")
        del mpipe, b

    by_path = dict(fused=launches, sparse=sparse_launches, fluid=fluid_launches,
                   fracture=fracture_launches, elasticity2=plastic_launches["elasticity2"],
                   basic2=plastic_launches["basic2"], fluids2=fluid2_launches)
    launches = {name: by_path[PATH_OF[name]][name] if PATH_OF[name] else
                kres[name]["launches"] for name in REPLACES}
    missing = [k for k in REPLACES if launches[k] == 0]
    require(not missing, f"kernels their main paths (or checks) never launched: {missing}")

    # 26. Results. The 2D fluid forms of four kernels carry their own
    # numbers (the fluids2 path's launches, times on the 2D column), and so
    # do the damage forms (their paths' launches, times at their size).
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    block = fluid2_res["kernels"]["fluids2 block"]
    dk = damage_res["kernels"]
    forms_of = {name: {} for name in REPLACES}
    for name in forms:
        forms_of[name]["fluids2"] = dict(launches=fluid2_launches[name],
                                         **{k: block[name].get(k) for k in keys})
    for name in forms3:
        forms_of[name]["l_panel3"] = dict(launches=lp3_launches[name],
                                          **{k: dk["l_panel3"][name].get(k) for k in keys})
    for label in ("l_panel3-modified", "l_panel2-modified"):
        forms_of["g2p_fused"][label] = dict(launches=mod_launches[label]["g2p_fused"],
                                            **{k: dk[label]["g2p_fused"].get(k) for k in keys})
    kernels = [
        dict(name=name, route="cuda",
             source=WINDOW_SOURCE if name in SPARSE_KERNELS else FUSED_SOURCE,
             replaces=REPLACES[name], launches=launches[name],
             path=PATH_OF[name] or NO_PATH, **{k: kres[name][k] for k in keys},
             **forms_of[name])
        for name in REPLACES
    ]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, kernels=kernels, launches_by_path=by_path, substeps=substeps,
                       resorts=resorts, timed_substeps=timed, seconds=seconds, pups=pups,
                       resort_branches=branches, resort_ms=resort_ms, peak_gib=peak_gib,
                       build_s=build_s, kernel_checks=kres, sparse=sparse_res,
                       fluid=fluid_res, fracture=fracture_res, plastic2d=plastic_res,
                       fluids2=fluid2_res, damage=damage_res), f,
                  indent=1, default=str)
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
