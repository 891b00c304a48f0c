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
volume recomputation), its 3D fracture path (l_panel3: l_panel2's two
damage mechanisms in a 3D slab of 600,000 particles, built here by
`l_panel3`; also under modified eigenerosion, and l_panel2 under it) and
its material paths (materials3: sand3@1M's lattices under neo-Hookean +
NACC, Rankine, Snow, Drucker-Prager and neo-Hookean alone; materials2:
the 2D block under neo-Hookean + NACC, neo-Hookean and Rankine; both built
here, and their failure forms with the stress cache off), and the
block-sparse pipeline on the four 2D scenes (elasticity2, basic2, fluids2
and l_panel2, through the 2D forms of the window kernels, l_panel2's with
the psi channels); and the two probe microbenchmarks, the counterparts of
the JAX package's TPU probe scripts.

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
     with times; the merge stage (check_merge) in both forms on kernel A's
     images, each bit-equal to its plain version, to a second launch and
     to the parent's form (parent_merge), held to one index_add within
     float atomics' reordering, with its byte bound and the parent stage's
     glue timed beside it; kernel A bit-equal to its plain version run on the CPU
     on 256 live chunks (and its hits per CTA); and a small sand3 frame on
     the card against the port's CPU path;
  4. the main path: FusedMpmPipeline.pack_state -> 15 frames of
     run_frames_state -> unpack_state, with the kernels' launch counts
     held against the substeps and the resort branches taken; then one
     more frame under torch.profiler (chiprun_out/sand3_profile.txt), and
     the merge stage of the landed state, one CUDA kernel in each form
     (counted under torch.profiler);
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
     fall at sand3@1M, without and with the psi channels, with times; the
     scatter merge on that substep's images (row-major), with times;
  7. the sparse main path: auto_pipeline(prefer="sparse") ->
     step_with_stats, then run_frames, 6 frames at sand3@1M, with the
     kernels' launch counts (and their 3D form) held against the substeps;
     one more frame timed, then under torch.profiler (the frame's
     device-time split, written to chiprun_out/sparse_profile.txt);
  8. one frame of sand3@1M through each path, sparse against fused, two
     sparse frames from the same particles bit-equal, and a small sand3
     frame through the sparse path on the card against the port's CPU path;
  9. the fluid path's kernels (mass P2G and G2P, kernels A and B with their
     fluid branches, the merge stage in the path's form (the scatter form,
     pinned by the blob's dense blocks) on both kinds of images, the mass
     node table also against its plain version run on the CPU) against
     their plain versions on the card, on the packed state of fluids3 with
     each axis of its particle counts x4 (972,800 particles) after its
     first volume pass, with times; kernel A's mass channel bit-equal to
     its plain version run on the CPU (its momentum channels take the EOS
     stress through expf and logf);
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
     on a perturbed state whose crack energies straddle the threshold; its
     box kernel equal to its plain version, and the chunks its cull skips,
     the candidates it keeps and the pair tests it runs, counted by the
     kernel and equal to the plain cull's),
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
     elasticity2's kernel A bit-equal to its plain version run on the CPU;
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
     also on a perturbed state where eigenerosion trips; its cull counted
     as in 12), kernel A's 3D
     fresh-stress form with the psi channels and kernel B's 3D
     maximum-stress trip (also with F perturbed so that it trips), kernel
     B's crack-energy trip of modified eigenerosion on l_panel3-modified
     (also with psi_pos perturbed so that it trips) and in 2D on l_panel2
     under modified eigenerosion, with times, bounds and the pooling's
     library yardstick;
 23. the l_panel3 main path: l_panel3(load_speed=LPANEL3_LOAD_SPEED) ->
     auto_pipeline -> pack_state -> 10 frames of run_frames_state ->
     unpack_state, launch counts against the substeps (A, B and the pooling
     once per substep), per frame the substeps, broken and failed counts
     per panel and mass, at least one eigenerosion trip required; one
     profiled frame (lpanel3_profile.txt in the output directory);
 24. reduced l_panel3 (2,304 particles), 3 substeps on the card against
     the port's CPU path at the card's dts, phase mismatches net of ties;
 25. l_panel3-modified (3 frames) and l_panel2 under modified eigenerosion
     (1 frame) as main paths: kernel B's crack-energy trip launched every
     substep, no pooling, trips per panel;
 26. kernels A and B's material forms against their plain versions at
     full size, one frame in and with F perturbed per model: materials3
     (1,000,000 particles; A's cache read, B's material instance),
     materials3-failure (A's fresh corotated and neo-Hookean stress, B's
     damage and material instance), materials2 and materials2-failure
     (250,000; the 2D forms), every NACC case, the Rankine and Snow maps
     and the maximum-stress trips counted and required, NACC's ties within
     1e-5 of a threshold counted, with times and bounds;
 27. the materials3 main path: materials3() -> auto_pipeline ->
     pack_state -> 20 frames of run_frames_state -> unpack_state, launch
     counts against the substeps, per frame the lanes per model whose
     plastic state moved and NACC's alpha range, mass, Rankine flow
     required; one profiled frame (materials3_profile.txt in the output
     directory);
 28. materials2 (3 frames), materials3-failure (4 frames, a maximum-stress
     trip required) and materials2-failure (a frame) as main paths, with
     the same checks;
 29. reduced materials3 and materials2 (from perturbed particles), 3
     substeps on the card against the port's CPU path at the card's dts:
     |dx|, |dv|, |dF|, |d alpha|, flags and phases equal;
 30. the window kernels' 2D forms against their plain versions (and,
     in 2D, against the plain versions run on the CPU, bit for bit):
     elasticity2 and basic2 20 substeps into the sparse path (without psi,
     and with seeded psi rows), l_panel2 as far in (its psi form, and
     without), timed on the 250,000-particle block (without psi) and on
     l_panel2 at cell width 0.0025 (with psi); the 3D psi forms on the
     reduced l_panel3's sparse path; the scatter merge on each state's
     images (in 2D also against its plain version run on the CPU);
 31. the four 2D sparse main paths at published size: scenes.build ->
     auto_pipeline(prefer="sparse") -> step_with_stats / run_frames,
     elasticity2 and basic2 6 frames against the goldens, fluids2 5 frames
     as published and 10 at n = 40 against its golden, l_panel2 2 frames
     with its broken and failed counts per panel beside the fused path's;
     the window kernels' launches held against the substeps and their
     forms (2D; with psi on l_panel2 only), mass, particle-updates/s; one
     profiled elasticity2 frame (chiprun_out/sparse2d_profile.txt);
 32. the sparse path card against CPU, 3 substeps at the card's dts
     (elasticity2, basic2, fluids2 at n = 40, l_panel2, fluids3 as
     published, reduced l_panel3), and one frame of each 2D scene twice on
     the card, bit-equal;
 33. the probes, the TPU probe scripts' kernels (sparkl_tpu_torch/scripts/,
     on no path): the serial chain at 8192 x 128 and N_OPS = 1024, fma and
     exp kinds, at every R of the sweep, and the two layout kernels at D =
     6656 in both layouts, against their plain versions (the fma chain and
     the layout kernels bit-equal, the exp chain within EXP_CHAIN_ULPS);
     then both probes' main(), which print the scripts' tables (their
     launches are the kernels' counts); plain and library times, bounds,
     and each chain instance's registers and spill from ptxas;
 34. a JSON line of per-kernel results (the 2D fluid forms of kernels A
     and B and the mass kernels under "fluids2"; the 3D damage forms of A,
     B, the pooling and its box kernel under "l_panel3", B's crack-energy trip under
     "l_panel3-modified" and "l_panel2-modified"; A and B's material forms
     under "materials3", "materials3-failure", "materials2" and
     "materials2-failure"; the window kernels' 2D forms under "sparse2d"
     and "sparse2d-psi"; the probes' kinds, R and layouts under their own
     labels), the card's nvidia-smi line, and the final {"ok": true,
     "device": ...} line.

Each kernel's bound_ms is the least time the card could take for its work
at this run's shapes: the larger of the bytes it must move (each input read
once, each output written once) over 3.35 TB/s and the f32 operations this
run's data needs over 67 TFLOP/s (the H100 SXM's published peaks at 700 W).

Each kernel and library call is timed three ways (sparkl_tpu_torch/scripts):
ms, batches of 10 calls between two CUDA events (what a path pays a call:
the device's time, or the host's where the host cannot keep the device
fed); device_ms, 10 calls captured in a CUDA graph and replayed between two
events (the device alone); and host_us, the host's time to issue one call.
A library call that reads the host has no device_ms.

Every check of a state with kernel A's images (phases 3, 9-12, 15, 18,
22, 26) also runs the merge stage there (check_merge), in the path's form;
the 2D and mass node tables also against the plain version run on the CPU.
"""

import contextlib
import json
import os
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
    # The pooling's lane-group boxes, the first of its launcher's two kernels.
    "eigen_boxes": "sparkl_tpu/fused/kernels.py:851",
    "permute_chunks": "sparkl_tpu/fused/kernels.py:1156",
    "vreg_chain": "scripts/vreg_probe.py:47",
    "layout_read": "scripts/layout_probe.py:23",
    "layout_rw": "scripts/layout_probe.py:82",
}
# The main path each kernel's launch count is read from.
PATH_OF = dict.fromkeys(("p2g_fused", "merge_blocks", "g2p_fused", "src_rows_from_order",
                         "permute_slots"), "fused")
PATH_OF.update(p2g_windows="sparse", g2p_windows="sparse", mass_p2g_fused="fluid",
               mass_g2p_fused="fluid", merge_scatter="fluid", eigen_pool_fused="fracture",
               eigen_boxes="fracture",
               permute_chunks=None, vreg_chain=None, layout_read=None, layout_rw=None)
# permute_chunks is on no path: no path of the JAX package calls it (its
# one caller is tests/test_lowering.py), and the port's resort permutes with
# permute_slots. Its launches are those of its checks on the resorts of
# phases 5 and 12.
# The probes (phase 33) are the TPU probe scripts' kernels: microbenchmarks
# on no path, whose launches are those of their sweeps.
PROBES = ("vreg_chain", "layout_read", "layout_rw")
NO_PATH = {"permute_chunks": "none: no path of the JAX package calls it (its only caller is "
                             "tests/test_lowering.py:100); launches from its checks on the "
                             "phase 5 and 12 resorts (a graph of the device timer counts its "
                             "captured calls, not its replays)",
           **dict.fromkeys(PROBES, "none: a microbenchmark; launches from its sweep "
                                   "(phase 33)")}
FUSED_SOURCE = "sparkl_tpu_torch/csrc/fused_kernels.cu"
WINDOW_SOURCE = "sparkl_tpu_torch/csrc/window_kernels.cu"
PROBE_SOURCE = "sparkl_tpu_torch/csrc/probe_kernels.cu"
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
# The main-path resorts whose kernels phases 16, 19 and 20 hold to their
# plain versions, at most, per kernel and path (in the untimed frames: the
# spy copies their operands on the card).
RESORT_SPY_CALLS = 4
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
# materials3 and materials2 (phases 26-29): sand3@1M's lattices and the
# 2D block with the remaining material models, their reduced forms (the CPU
# tests' and phase 29's), the maximum-stress envelopes of their failure
# forms (max principal, max shear; Pa), chosen below the stresses of the
# perturbed states so that the trip is exercised, the per-model F
# perturbations of phase 26 (scales picked so that every NACC case, the
# Rankine and Snow maps and the trips occur), the frames of the main paths
# (the last timed), and the card-against-CPU bounds after 3 substeps (the
# JAX-against-port bounds of tests/test_torch_materials.py).
MATERIALS3_COUNTS = (100, 50, 100)
MATERIALS_E, MATERIALS_NU = 1.0e7, 0.2
MATERIALS3_SMALL, MATERIALS2_SMALL = 0.08, 0.048
MATERIALS3_FAILURE = (5.0e4, 5.0e4)
MATERIALS2_FAILURE = (5.0e3, 5.0e3)
MATERIALS_PERTURB = {"materials3": {0: 0.005, 1: 0.01, 2: 0.02, 3: 0.02},
                     "materials3-failure": {0: 0.005, 1: 0.01, 2: 0.02, 3: 0.02, 4: 0.01},
                     "materials2": {0: 0.02, 2: 0.02},
                     "materials2-failure": {0: 0.02, 1: 0.05, 2: 0.02}}
MATERIALS3_FRAMES, MATERIALS3_TIMED = 20, 3
MATERIALS2_FRAMES, MATERIALS3_FAILURE_FRAMES = 3, 4
MATERIALS_AGREE_SUBSTEPS = 3
MATERIALS_DX, MATERIALS_DV, MATERIALS_DF, MATERIALS_DA = 1e-6, 1e-4, 1e-5, 1e-5
# Operations of the material forms, lower estimates: neo-Hookean's closed
# form per slot (F Fᵀ, J, J^(-2/d) by exp and log, the scaling; its energy
# alike), and per 3D NACC, Rankine or Snow lane one more cardano SVD and
# the map (logs, exps, the rebuild of F).
NH_SLOT_FLOPS, MAT_MAP3_FLOPS = 80, 450
# The probes (phase 33): the exp chain may differ from its plain version by
# this many f32 ulps. The kernel's expf is CUDA's, built here with
# -fmad=false, torch.exp on the card CUDA's in PyTorch's own build, so the
# two may round an exp differently in the last bit; near its fixed point the
# chain contracts (|d/dx| < 0.5), so a difference does not grow. The fma
# chain and the layout kernels must be bit-equal. Operations of one exp step:
# |x|, the exp of its negation (one) and the FMA (two).
EXP_CHAIN_ULPS = 4
EXP_STEP_FLOPS = 4
# Tolerances of the kernel-vs-plain checks (the plain versions run on the
# same card on the same tensors); p2g_errors and g2p_errors state each one.
# Kernel A is also held to its plain version run on the CPU, on this many
# live chunks of a state (p2g_cpu_bits).
P2G_CPU_CHUNKS = 256
# Calls of the merge stage under torch.profiler, each required to run its
# one kernel and nothing else; the sessions' counts (check_merge).
MERGE_PROFILED_CALLS = 5
MERGE_PROFILES = []


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


def add_split(v, fn, lib=None, lib_captured=True):
    """Add to the result v the device/host split of a kernel's wrapper fn()
    and of its library call lib() (scripts.split_times): device_ms, host_us,
    library_device_ms (None where lib reads the host and cannot be
    captured) and library_host_us."""
    from sparkl_tpu_torch.scripts import split_times

    v.update(split_times(fn, lib, lib_captured))
    return v


def split_text(v):
    """The split of add_split as text."""
    if "device_ms" not in v:
        return ""
    lib = v.get("library_host_us")
    lib_dev = v.get("library_device_ms")
    return (f"; device {v['device_ms']:.4f} ms, host {v['host_us']:.1f} us a call" +
            ("" if lib is None else
             f"; library device {'-' if lib_dev is None else f'{lib_dev:.4f}'} ms, host "
             f"{lib:.1f} us"))


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


def p2g_cpu_bits(grid, meta, slots, ints, dt, nchunks, tables, img_k, label, phase,
                 need=None):
    """Kernel A's images against its plain version run on the CPU, on
    P2G_CPU_CHUNKS live chunks spread over the state: the plain version
    scatters lane-major, so each cell sums its slots in the kernel's order,
    and where the stress is formed alike (the cache read; not expf, logf or
    acosf) the images agree to the bit (±0 alike). `need`: the channels
    that must agree to the bit (all by default). Returns {channel_equal
    (per channel), cells_differ, max_abs_err, chunks}."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K

    live = int(nchunks)
    idx = torch.linspace(0, live - 1, min(P2G_CPU_CHUNKS, live)).round().long().unique()
    cpu = torch.device("cpu")
    ref = K.p2g_fused_reference(
        grid, slots[idx].to(cpu), ints[idx].to(cpu), dt,
        torch.tensor(len(idx), dtype=torch.int32), tables=tuple(x.to(cpu) for x in tables),
        stress_cache=bool(meta["stress_cache"]), with_psi=bool(meta["with_psi"]))
    got = img_k[idx.to(img_k.device)].to(cpu)
    eq = got == ref
    res = dict(channel_equal=[bool(eq[:, c].all()) for c in range(eq.shape[1])],
               cells_differ=int((~eq).sum()), max_abs_err=(got - ref).abs().max().item(),
               chunks=len(idx))
    need = range(eq.shape[1]) if need is None else need
    say(phase, f"p2g_fused ({label}) against its plain version on the CPU, {len(idx)} live "
               f"chunks: equal per channel {res['channel_equal']} (channels {list(need)} "
               f"held to the bit), cells differing {res['cells_differ']} of {eq.numel()}, "
               f"max|err| {res['max_abs_err']:.3e}")
    require(all(res["channel_equal"][c] for c in need),
            f"p2g_fused ({label}) is not bit-equal to its plain version on the CPU")
    return res


def a_hits(grid, state):
    """Kernel A's hits per CTA on `state`: 3^d a contributing slot (active,
    in its window and in the grid), over the live chunks: (mean, max)."""
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L

    live = int(state.structure.num_chunks)
    slots, ints = state.slots[:live], state.ints[:live]
    _, _, _, in_window, in_bounds = K._slot_geometry(grid, slots, ints)
    contrib = ((ints[:, L.I_FLAGS, :] & L.ACTIVE) != 0) & in_window & in_bounds
    hits = contrib.sum(dim=1) * 3**grid.dim
    return hits.double().mean().item(), int(hits.max())


def g2p_errors(out_k, out_p, ints, cparams, cell_width, skip_dtb=None, skip_rows=(),
               skip_lanes=None, energy_floor=None):
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
      plastic (pdd, ph, lvg, nacc, all in strain units): |err|, tol 2e-5;
      failed: equal (measure 0 or 1, tol 0).
    skip_dtb [D, C] leaves lanes out of the dt-bound row: the EOS lanes,
    which check_g2p holds to their own bound (eos_dtb_errors);
    skip_rows leaves rows out (the 2D phase row, held to its trips);
    skip_lanes [D, C] leaves lanes out of every row (NACC lanes whose case
    decision lies within TIE of a threshold, counted by the caller);
    energy_floor [D, C] is an absolute error each lane's energy may carry
    beyond the measure (par1 times the lane's mass): neo-Hookean's, whose
    tr(F Fᵀ) J^(-2/d) - d cancels near F = I to the f32 rounding of
    J^(-2/d) (exp and log, which the card and its plain version round
    differently) times µh d/2, so that near rest (the free fall of a
    frame in) the strain-equivalent measure alone would hold it to less
    than its floor. 3D (56 rows) or 2D (40)."""
    import torch
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.math.kernel import inv_d

    dim = 3 if out_k.shape[1] == L.Rows(3).nf else 2
    r = L.Rows(dim)
    occ = ((ints[:, L.I_FLAGS, :] & L.OCCUPIED) != 0)[:, None, :]
    if skip_lanes is not None:
        occ = occ & ~skip_lanes[:, None, :]
    a = torch.where(occ, out_k, 0.0)
    b = torch.where(occ, out_p, 0.0)
    if skip_dtb is not None:
        a[:, r.dtb] = torch.where(skip_dtb, 0.0, a[:, r.dtb])
        b[:, r.dtb] = torch.where(skip_dtb, 0.0, b[:, r.dtb])
    diff = (a - b).abs()
    if energy_floor is not None:
        diff[:, r.psi_pos] = torch.clamp(diff[:, r.psi_pos] - energy_floor, min=0.0)
        diff[:, r.par1] = torch.clamp(diff[:, r.par1] - energy_floor * b[:, r.mass], min=0.0)
    err = diff.amax(dim=(0, 2))
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
        elif k in (r.pdd, r.ph, r.lvg, r.nacc):
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
    from sparkl_tpu_torch.scripts import median_ms
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
    # The cache read: every channel bit-equal to the plain version on the CPU.
    res["p2g_fused"]["cpu"] = p2g_cpu_bits(grid, pipe._meta, state.slots, state.ints, dt,
                                           nchunks, tables, img_k, "sand3@1M", 3)
    res["p2g_fused"]["hits_per_cta"] = a_hits(grid, state)
    res["p2g_fused"]["ms"] = median_ms(
        lambda: K.p2g_fused(grid, cfg, pipe._meta, state.slots, state.ints, dt, nchunks,
                            tables))
    add_split(res["p2g_fused"], lambda: K.p2g_fused(grid, cfg, pipe._meta, state.slots,
                                                    state.ints, dt, nchunks, tables))
    res["p2g_fused"]["plain_ms"] = median_ms(
        lambda: K.p2g_fused_reference(grid, state.slots, state.ints, dt, nchunks, tables), reps=5)

    # The merge stage, on the images the main path hands it, in the path's
    # gather form and in the scatter form (the fluid and sparse paths').
    # (Its launches counted under torch.profiler after phase 4's profiled
    # frame: a profiler session slows the host, and phase 4 times the path.)
    res["merge_blocks"] = check_merge(grid, cfg, state.structure, img_k, True, False, 3,
                                      "sand3@1M", owner=state.grid_cache[4], profiled=False)
    res["merge_scatter"] = check_merge(grid, cfg, state.structure, img_k, True, True, 3,
                                       "sand3@1M", plan=state.grid_cache[2], profiled=False)
    require(not failures, "; ".join(failures))

    # Kernel B, on the window fields the main path computes from these images.
    res["g2p_fused"], (slots_in, fc, args) = check_g2p(pipe, state, dt, "one frame", 3)
    scratch = slots_in.clone()

    def b_call():
        return K.g2p_fused(grid, cfg, pipe._meta, pipe._kparams, scratch, state.ints, *fc, dt,
                           *args)

    res["g2p_fused"]["ms"] = median_ms(b_call)
    add_split(res["g2p_fused"], b_call)
    res["g2p_fused"]["plain_ms"] = median_ms(
        lambda: K.g2p_fused_plain(grid, cfg, slots_in, state.ints, *fc, dt, *args), reps=5)
    traffic = substep_bytes(state.structure, cfg)
    # B's bound from the rows its lanes need (the former count, every row
    # of every lane, kept beside it).
    all_rows = traffic["g2p_fused"]
    traffic["g2p_fused"] = res["g2p_fused"]["bytes"]
    lanes = int(((state.ints[:, L.I_FLAGS, :] & L.ACTIVE) != 0).sum())
    flops = dict(p2g_fused=lanes * (27 * P2G_TAP_FLOPS + A_SLOT_FLOPS),
                 g2p_fused=lanes * (27 * G2P_TAP_FLOPS + B_LANE_FLOPS))
    res["g2p_fused"]["former_bound_ms"] = bound(all_rows, flops["g2p_fused"])[0]
    for name in flops:
        v = res[name]
        v["bytes"], v["flops"] = traffic[name], flops[name]
        v["bound_ms"], v["bound_by"] = bound(v["bytes"], v["flops"])
        v.setdefault("library_ms", None)
        hits = (f"; hits per CTA mean {v['hits_per_cta'][0]:.1f}, max {v['hits_per_cta'][1]}"
                if "hits_per_cta" in v else "")
        say(3, f"{name}: kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms, library "
               f"{v['library_ms']} ms (batched medians); {traffic[name] / 1e9:.4f} GB counted from "
               f"shapes = {traffic[name] / v['ms'] / 1e6:.1f} GB/s; bound {v['bound_ms']:.4f} ms "
               f"({v['bound_by']}){split_text(v)}{hits}{former_bound_text(v)}")
    return res


def former_bound_text(v):
    """Kernel B's bound by its former count of bytes (every row of every
    lane; on the fluid path the rows the fluid branch was taken to need),
    as text."""
    return (f"; bound by the former count {v['former_bound_ms']:.4f} ms"
            if "former_bound_ms" in v else "")


def parent_merge(cfg, structure, images, zmajor, scatter, plan):
    """The parent's merge stage on window images, kept here as the plain
    reference the new kernels are held to: the comb gather into (chunk,
    corner) rows, then the scatter form's ordered row sums, or the gather
    form's segment sums (the parent's rows kernel summed in this order),
    the inverse-corner table built from nbr_index on the call, the 2^d
    corner adds from zero; the trash row zeroed."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.sparse import transfer as T

    dim = 3 if images.shape[2] == 512 else 2
    nf, ncorners, cpb = images.shape[1], 2**dim, 4**dim
    comb = T._merge_comb(dim, nf, zmajor, images.device)
    rows = images.reshape(cfg.max_chunks, -1)[:, comb].reshape(cfg.max_chunks, ncorners,
                                                                nf * cpb)
    if scatter:
        out = K.merge_scatter_reference(rows.reshape(-1, nf * cpb), *plan)
    else:
        blk = K.merge_blocks_reference(rows, structure.block_first_chunk,
                                       structure.block_num_chunks, T.MERGE_KMAX)
        blk = torch.cat([blk, blk.new_zeros((1,) + blk.shape[1:])], 0)
        nbr = structure.nbr_index.long()
        co = torch.full((cfg.max_grid_blocks + 1, ncorners), cfg.max_blocks, dtype=torch.long,
                        device=images.device)
        bidx = torch.clamp(torch.arange(nbr.shape[0], device=images.device), max=cfg.max_blocks)
        kidx = torch.arange(ncorners, device=images.device)
        co[nbr, kidx[None, :].expand_as(nbr)] = bidx[:, None].expand_as(nbr)
        out = images.new_zeros((cfg.max_grid_blocks + 1, nf * cpb))
        for k in range(ncorners):
            out = out + blk[co[:, k], k]
    out[cfg.max_grid_blocks] = 0.0
    return out


def parent_glue(cfg, structure, images, zmajor, scatter, blk):
    """The parent's merge stage without its rows kernel (timed beside the
    new kernel: what the kernel took off the path): the comb gather, and
    for the gather form the cat, the inverse-corner table's build, the 2^d
    corner gathers and adds (on `blk`, a stand-in for the kernel's output)
    and the overflow max; the trash write."""
    import torch
    from sparkl_tpu_torch.sparse import transfer as T

    dim = 3 if images.shape[2] == 512 else 2
    nf, ncorners, cpb = images.shape[1], 2**dim, 4**dim
    comb = T._merge_comb(dim, nf, zmajor, images.device)
    rows = images.reshape(cfg.max_chunks, -1)[:, comb]
    if scatter:
        out = rows.new_zeros((cfg.max_grid_blocks + 1, nf * cpb))  # the kernel's output
    else:
        ovf = torch.max(structure.block_num_chunks) > T.MERGE_KMAX
        b = torch.cat([blk, blk.new_zeros((1,) + blk.shape[1:])], 0)
        nbr = structure.nbr_index.long()
        co = torch.full((cfg.max_grid_blocks + 1, ncorners), cfg.max_blocks, dtype=torch.long,
                        device=images.device)
        bidx = torch.clamp(torch.arange(nbr.shape[0], device=images.device), max=cfg.max_blocks)
        kidx = torch.arange(ncorners, device=images.device)
        co[nbr, kidx[None, :].expand_as(nbr)] = bidx[:, None].expand_as(nbr)
        out = images.new_zeros((cfg.max_grid_blocks + 1, nf * cpb))
        for k in range(ncorners):
            out = out + b[co[:, k], k]
        del ovf
    out[cfg.max_grid_blocks] = 0.0
    return rows, out


def merge_destinations(cfg, structure, images, zmajor):
    """[D · nf · 8^d] i64: the flat node-table element each image element
    adds to (its chunk's corner row, channel, block cell), for the library
    yardstick's index_add."""
    import numpy as np
    import torch
    from sparkl_tpu_torch.sparse import transfer as T

    dim = 3 if images.shape[2] == 512 else 2
    nf, cpb = images.shape[1], 4**dim
    q = np.arange(8**dim)
    if dim == 3:
        if zmajor:
            z, x, y = q // 64, (q // 8) % 8, q % 8
        else:
            x, y, z = q // 64, (q // 8) % 8, q % 8
        corner = (x >= 4) * 4 + (y >= 4) * 2 + (z >= 4)
        cell = (x % 4) * 16 + (y % 4) * 4 + z % 4
    else:
        x, y = q // 8, q % 8
        corner, cell = (x >= 4) * 2 + (y >= 4), (x % 4) * 4 + y % 4
    dev = images.device
    rows = T._chunk_corners(structure).long()[:, torch.as_tensor(corner, device=dev)]
    col = (torch.arange(nf, device=dev)[:, None] * cpb
           + torch.as_tensor(cell, device=dev)[None, :])
    return (rows[:, None, :] * (nf * cpb) + col[None]).reshape(-1)


def merge_bytes(cfg, structure, images, scatter, plan, owner):
    """(bytes, f32 adds, most terms of one node-table element) the merge
    must move and do on these inputs: each live source run of 4^d cells
    read once (the gather form: per live node row and corner, the owner's
    chunks up to MERGE_KMAX; the scatter form: every planned update), the
    node table written once, and the index tables it reads (the owners and
    the blocks' chunk ranges; the plan)."""
    import torch
    from sparkl_tpu_torch.sparse import transfer as T

    dim = 3 if images.shape[2] == 512 else 2
    w = images.shape[1] * 4**dim
    n_rows = cfg.max_grid_blocks + 1
    ngb = int(structure.num_grid_blocks)
    if scatter:
        starts = plan[1]
        terms = int(starts[ngb])
        per_row = int((starts[1:] - starts[:-1]).max())
        index = terms * 4 + (ngb + 1) * 4
    else:
        own = owner[:ngb].long()
        live = own < cfg.max_blocks
        nblk = structure.block_num_chunks.clamp(max=T.MERGE_KMAX).long()
        n = torch.where(live, torch.cat([nblk, nblk.new_zeros(1)])[own.clamp(
            max=cfg.max_blocks)], 0)
        terms = int(n.sum())
        per_row = int(n.sum(dim=1).max())
        index = own.numel() * 4 + int(live.sum()) * 8
    return terms * w * 4 + n_rows * w * 4 + index, terms * w, per_row


def check_merge(grid, cfg, structure, images, zmajor, scatter, phase, label, plan=None,
                owner=None, timed=True, cpu=False, profiled=None):
    """The merge stage as the paths call it (merge_images_to_grid: one
    kernel, the gather form's merge_blocks or the scatter form's
    merge_scatter) on window images over `structure`, with the structure's
    plan or corner owners (built here if not given): bit-equal to its plain
    version, to a second launch and to the parent's form (parent_merge);
    with `cpu`, to its plain version run on the CPU; within float
    atomics' reordering of the library yardstick (one index_add of the
    images, each element to its node-table element); with `profiled`
    (default: `timed`), one CUDA kernel under torch.profiler (after the
    timing: a profiler session slows the host's later calls). With
    `timed`, the stage's batched, device and host
    times, its plain version's, the library call's and the parent's glue's
    (the parent stage without its rows kernel), and the byte bound.
    Returns {max_abs_err, bit_equal_*, ..., ms, bound_ms, ...}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.sparse import transfer as T

    name = "merge_scatter" if scatter else "merge_blocks"
    plan = T.scatter_plan(cfg, structure) if plan is None else plan
    owner = T.corner_owner(cfg, structure) if owner is None else owner
    order = T.ZMAJOR_ORDER_3D if zmajor else None

    def stage(img=images):
        return T.merge_images_to_grid(grid, cfg, structure, img, cell_order=order,
                                      force_scatter=scatter, plan=plan, owner=owner)

    def plain(img=images, st=structure, pl=plan, ow=owner):
        if scatter:
            return K.merge_scatter_plain(img, *pl, zmajor)
        return K.merge_blocks_plain(img, st.block_first_chunk, st.block_num_chunks, ow, zmajor)

    before = K.LAUNCHES[name]
    out_k, out_k2 = stage(), stage()
    require(K.LAUNCHES[name] == before + 2, f"{name} was not launched ({label})")
    out_p = plain()
    out_par = parent_merge(cfg, structure, images, zmajor, scatter, plan)
    dest = merge_destinations(cfg, structure, images, zmajor)
    zeros = torch.zeros(out_k.numel(), dtype=torch.float32, device=images.device)
    flat = images.reshape(-1)

    def lib():
        return torch.index_add(zeros, 0, dest, flat)

    out_l = lib().reshape(out_k.shape)
    abs_sum = stage(images.abs())
    nbytes, adds, per_row = merge_bytes(cfg, structure, images, scatter, plan, owner)
    torch.cuda.synchronize()
    v = dict(form="scatter" if scatter else "gather", nf=images.shape[1], zmajor=zmajor,
             max_abs_err=(out_k - out_p).abs().max().item(),
             bit_equal_plain=torch.equal(out_k, out_p),
             bit_equal_relaunch=torch.equal(out_k, out_k2),
             bit_equal_parent=torch.equal(out_k, out_par), terms_per_row=per_row)
    # Float atomics sum in any order: two orders of n terms differ by at
    # most 2 (n - 1) u · sum|terms| (u = 2^-24), counted per element; held
    # to that bound plus 1e-6 of the table's largest magnitude (on
    # l_panel3's tables up to 18,000 elements came out past the per-element
    # bound, by at most 3.6e-7, the kernel bit-equal to its plain version
    # there). The trash row is left out.
    diff = (out_l[:-1] - out_k[:-1]).abs()
    tol = 2.0 * max(per_row, 1) * 2.0**-24 * abs_sum[:-1]
    v["library_max_abs_diff"] = diff.max().item()
    v["library_past_reorder_bound"] = int((diff > tol).sum())
    lib_over = (diff - tol - 1e-6 * out_k.abs().max()).max().item()
    if cpu:
        cpu_dev = torch.device("cpu")
        st_c = type(structure)(**{k: t.to(cpu_dev) for k, t in structure.tensors().items()})
        out_c = plain(images.cpu(), st_c, tuple(t.cpu() for t in plan), owner.cpu())
        v["bit_equal_cpu"] = torch.equal(out_k.cpu(), out_c)
    say(phase, f"{name} ({label}, nf {v['nf']}, {'z-major' if zmajor else 'row-major'}) "
               f"{tuple(images.shape)} -> {tuple(out_k.shape)}: bit-equal to its plain version "
               f"{v['bit_equal_plain']}, to a second launch {v['bit_equal_relaunch']}, to the "
               f"parent's form {v['bit_equal_parent']}"
               + (f", to its plain version on the CPU {v['bit_equal_cpu']}" if cpu else "")
               + f"; index_add max|diff| {v['library_max_abs_diff']:.3e} (elements past the "
               f"reorder bound: {v['library_past_reorder_bound']}); at most {per_row} terms a "
               f"node element")
    require(v["bit_equal_plain"] and v["bit_equal_relaunch"] and v["bit_equal_parent"]
            and v.get("bit_equal_cpu", True),
            f"{name} ({label}) is not bit-equal to its plain version, itself and the parent's form")
    require(lib_over <= 0.0, f"{name} ({label}) disagrees with index_add past its tolerance")
    if timed:
        time_merge(v, cfg, structure, images, zmajor, scatter, stage, plain, lib, nbytes, adds,
                   phase, label)
    if timed if profiled is None else profiled:
        # A short profiler session may drop device events (seen: 4 of 5, 1
        # of 5, none): every event seen must be the merge kernel, at most
        # one a call; main() requires each form seen at least once. The
        # launch count above holds the kernel to one a call.
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(MERGE_PROFILED_CALLS):
                stage()
            torch.cuda.synchronize()
        events = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        v["stage_device_events"] = [len(events), MERGE_PROFILED_CALLS]
        MERGE_PROFILES.append(dict(form=name, label=label, events=len(events),
                                   calls=MERGE_PROFILED_CALLS))
        say(phase, f"the merge stage ({label}) under torch.profiler: {len(events)} device "
                   f"events seen in {MERGE_PROFILED_CALLS} calls, all of {sorted(set(events))}")
        require(len(events) <= MERGE_PROFILED_CALLS and all(name in k for k in events),
                f"the merge stage ({label}) ran other device work than its kernel: "
                f"{len(events)} events in {MERGE_PROFILED_CALLS} calls, {sorted(set(events))}")
    return v


def time_merge(v, cfg, structure, images, zmajor, scatter, stage, plain, lib, nbytes, adds,
               phase, label):
    """check_merge's times, added to its result v."""
    import torch
    from sparkl_tpu_torch.scripts import device_ms, median_ms

    name = "merge_scatter" if scatter else "merge_blocks"
    dim = 3 if images.shape[2] == 512 else 2
    blk = torch.zeros((cfg.max_blocks, 2**dim, images.shape[1] * 4**dim), device=images.device)
    v["ms"] = median_ms(stage)
    v["plain_ms"] = median_ms(plain, reps=5)
    v["library_ms"] = median_ms(lib)
    add_split(v, stage, lib)
    v["parent_glue_device_ms"] = device_ms(
        lambda: parent_glue(cfg, structure, images, zmajor, scatter, blk))
    v["bytes"], v["flops"] = nbytes, adds
    v["bound_ms"], v["bound_by"] = bound(nbytes, adds)
    say(phase, f"{name} ({label}): stage {v['ms']:.4f} ms, plain {v['plain_ms']:.3f} ms, "
               f"library (index_add) {v['library_ms']:.4f} ms (batched medians); "
               f"{nbytes / 1e9:.4f} GB counted from these inputs = "
               f"{nbytes / v['ms'] / 1e6:.1f} GB/s batched, "
               f"{nbytes / v['device_ms'] / 1e6:.1f} GB/s on the device; bound "
               f"{v['bound_ms']:.4f} ms ({v['bound_by']}), device time at "
               f"{v['bound_ms'] / v['device_ms']:.0%} of it{split_text(v)}; the parent stage's "
               f"glue (without its rows kernel) {v['parent_glue_device_ms']:.4f} ms on the device")


def substep_bytes(structure, cfg):
    """Bytes each substep kernel must move, counted from shapes: the slot
    rows it reads for the live chunks (kernel A: 24 f32 + 4 i32 rows;
    kernel B, every row of every lane: 32 f32 + 5 i32 rows and the [3,
    512] window; b_bytes counts the rows its lanes need) and what it writes
    (kernel A: every chunk's [4, 512] image; kernel B: the live chunks' 56
    rows). The merge counts its own (merge_bytes)."""
    live, d_ = int(structure.num_chunks), cfg.max_chunks
    row = 4 * cfg.chunk_size
    return {
        "p2g_fused": live * (24 + 4) * row + d_ * 4 * 4 * 512,
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


def b_inputs(pipe, state, images, dt, channels=None):
    """Kernel B's inputs on the path: (the window fields [MG + 1, n · 4^d]
    the path computes from `images` (merge, grid update), cut to their
    first `channels` channels, the chunks' corner map [D, 2^d])."""
    fields = pipe._node_fields(state, images, dt)
    if channels is not None:
        g, cpb = fields.shape[0], 4**pipe.grid.dim
        fields = fields.reshape(g, -1, cpb)[:, :channels].reshape(g, -1).contiguous()
    return fields, pipe._corners(state)


def b_unchanged(pipe, state, slots_in, out_k, label, phase, meta=None):
    """Kernel B's rows that its row table (fused/kernels.py B_ROWS) says no
    class of a lane may change, held bit-equal to the kernel's input on
    every lane (and every row of a dead chunk). Fails otherwise; returns
    {rows_lanes_held, rows_lanes_differing}."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K

    meta = pipe._meta if meta is None else meta
    kept = K.b_unchanged(meta, pipe._tab_i, state.ints, out_k, state.structure.num_chunks)
    differ = kept & (out_k.view(torch.int32) != slots_in.view(torch.int32))
    v = dict(rows_lanes_held=int(kept.sum()), rows_lanes_differing=int(differ.sum()))
    say(phase, f"g2p_fused on the {label} state: the rows its row table leaves unchanged, "
               f"{v['rows_lanes_held']} (row, lane) pairs, bit-equal to its input: "
               f"{v['rows_lanes_differing'] == 0}")
    require(v["rows_lanes_differing"] == 0,
            f"g2p_fused changed rows its row table leaves unchanged on the {label} state")
    return v


def b_bytes(pipe, state, out_k, meta=None):
    """Bytes kernel B must move on `state`, counted from its row table: on
    each live lane the f32 rows its classes read and those they may change
    (each read once and written once), the lane's 2 + d int rows (model,
    flags, origin), and the window fields' rows of the live chunks' corner
    blocks, each node-table row once, in the channels the form reads."""
    from sparkl_tpu_torch.core.params import DamageModel
    from sparkl_tpu_torch.fused import kernels as K

    meta = pipe._meta if meta is None else meta
    dim = pipe.grid.dim
    nch = int(state.structure.num_chunks)
    cls = K.b_lane_classes(meta, pipe._tab_i, state.ints, out_k)[:nch]
    rows = K.b_field_rows(dim)
    n = (2 + dim) * cls.numel()
    for name, (readers, writers) in K.B_ROWS.items():
        n += len(rows[name]) * int(((cls & readers) != 0).sum() + ((cls & writers) != 0).sum())
    modified = (not meta["stress_cache"]
                and meta["damage_model"] == DamageModel.MODIFIED_EIGENEROSION)
    blocks = int(pipe._corners(state)[:nch].unique().numel())
    return 4 * (n + blocks * (dim + int(modified)) * 4**dim)


def check_g2p(pipe, state, dt, label, phase, need_plastic=False):
    """Kernel B against its plain version on `state`, with the window fields
    the main path computes for it (kernel A, merge, grid update) and the
    corner map. Fails unless every row group is within its tolerance, the
    rows its row table leaves unchanged are bit-equal to its input, and,
    with need_plastic, unless Drucker-Prager plastic flow (a change of the
    hardening or plastic-volume row) happened on some occupied lane in
    both. Returns ({max_abs_err, worst_over_tol, plastic_lanes, unchanged,
    bytes}, (the input slots, (the fields, the corners), the table
    arguments))."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L

    grid, cfg = pipe.grid, pipe._cfg
    r = L.Rows(grid.dim)
    nchunks = state.structure.num_chunks
    tables = (pipe._tab_f, pipe._tab_i)
    images = K.p2g_fused(grid, cfg, pipe._meta, state.slots, state.ints, dt, nchunks, tables)
    fc = b_inputs(pipe, state, images, dt)
    args = (pipe._tab_f, pipe._tab_i, nchunks)
    slots_in = state.slots.clone()
    ints_in = state.ints.clone()
    out_p = K.g2p_fused_plain(grid, cfg, slots_in, state.ints, *fc, dt, *args,
                              velocity_clamp=pipe._kparams["gpu_velocity_clamp"])
    out_k = K.g2p_fused(grid, cfg, pipe._meta, pipe._kparams, slots_in.clone(), state.ints,
                        *fc, dt, *args)
    torch.cuda.synchronize()
    require(torch.equal(state.ints, ints_in), "g2p_fused touched the int rows")
    unchanged = b_unchanged(pipe, state, slots_in, out_k, label, phase)
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
               eos_dtb_worst_lane_j_minus_1=worst_eps, unchanged=unchanged,
               bytes=b_bytes(pipe, state, out_k))
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
    return res, (slots_in, fc, args)


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
    from sparkl_tpu_torch.scripts import median_ms

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
            median_ms(fn), median_ms(plain, reps=5), median_ms(lib))
        add_split(v, fn, lib)
        v["flops"] = 0
        v["bound_ms"], v["bound_by"] = bound(v["bytes"], 0)
        say(phase, f"{name}: kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.3f} ms, library (one "
               f"gather) {v['library_ms']:.4f} ms (batched medians); {v['bytes'] / 1e9:.4f} GB "
               f"counted from shapes = {v['bytes'] / v['ms'] / 1e6:.1f} GB/s; bound "
               f"{v['bound_ms']:.4f} ms{split_text(v)}")

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
    resort_ms = median_ms(lambda: L.resort(grid, cfg, pre, dim), reps=5)
    say(phase, f"whole resort, card against a CPU copy: branches {branch_g} / {branch_c}, overflow "
           f"{ov_g} / {ov_c}, slots, ints and structure bit-equal {same}; card {resort_ms:.3f} ms "
           f"(median of 5 batches of 10, host reads included)")
    require(same and branch_g == branch_c and ov_g == ov_c and not ov_g,
            f"the resort on the card differs from the CPU resort (elements differing: {differ})")
    return res, resort_ms


class ResortSpy:
    """While entered, keeps copies of the inputs and outputs of the resort
    kernels' wrappers (K.src_rows_from_order, K.permute_slots) on a main
    path, at most RESORT_SPY_CALLS calls each; check() then holds each
    output to the plain version on the same inputs, bit for bit. The
    wrappers launch their kernels and count as without the spy; the plain
    versions run after the path."""

    def __init__(self):
        self.calls = {"src_rows_from_order": [], "permute_slots": []}
        self._orig = {}

    def __enter__(self):
        import torch
        from sparkl_tpu_torch.fused import kernels as K

        def copy(x):
            if isinstance(x, torch.Tensor):
                return x.clone()
            return tuple(copy(y) for y in x) if isinstance(x, tuple) else x

        for name, kept in self.calls.items():
            fn = self._orig[name] = getattr(K, name)

            def spy(*args, _fn=fn, _kept=kept):
                out = _fn(*args)
                if len(_kept) < RESORT_SPY_CALLS:
                    _kept.append((copy(args), copy(out)))
                return out

            setattr(K, name, spy)
        return self

    def __exit__(self, *exc):
        from sparkl_tpu_torch.fused import kernels as K

        for name, fn in self._orig.items():
            setattr(K, name, fn)

    def check(self, phase, label):
        """Each kept call against its plain version; returns {name: calls}."""
        import torch
        from sparkl_tpu_torch.fused import kernels as K

        plain = dict(src_rows_from_order=K.src_rows_from_order_reference,
                     permute_slots=K.permute_slots_reference)
        for name, kept in self.calls.items():
            for args, out in kept:
                ref = plain[name](*args)
                outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
                same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                           for a, b in zip(outs, refs))
                require(same, f"{label}: {name} on a main-path resort differs from its plain "
                              "version")
        n = {name: len(kept) for name, kept in self.calls.items()}
        say(phase, f"{label}: the resort kernels on the path's own resorts bit-equal to their "
                   f"plain versions ({n} calls checked)")
        return n


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


def capture_window_inputs(pipe, p, merge_in=False):
    """The window kernels' inputs (slot data, velocity windows) of the first
    substep of one frame from `p` on the sparse path, and with `merge_in`
    its merge's (structure, images, plan), recorded as the pipeline hands
    them on."""
    from sparkl_tpu_torch.ops import transfer_kernels as WK
    from sparkl_tpu_torch.sparse import transfer as T

    got = {}
    p2g, g2p, merge = WK.p2g_windows, WK.g2p_windows, T.merge_images_to_grid

    def rec_p2g(grid, cfg, slot_data, with_psi=True):
        got.setdefault("slot_data", slot_data.clone())
        return p2g(grid, cfg, slot_data, with_psi=with_psi)

    def rec_g2p(grid, cfg, slot_data, windows, with_psi=True):
        got.setdefault("windows", windows.clone())
        return g2p(grid, cfg, slot_data, windows, with_psi=with_psi)

    def rec_merge(grid, cfg, structure, images, **kw):
        if "slot_data" in got:  # the substep's merge (not the volume pass's)
            got.setdefault("merge", (structure, images.clone(), kw["plan"]))
        return merge(grid, cfg, structure, images, **kw)

    WK.p2g_windows, WK.g2p_windows, T.merge_images_to_grid = rec_p2g, rec_g2p, rec_merge
    try:
        pipe.step_with_stats(p)
    finally:
        WK.p2g_windows, WK.g2p_windows, T.merge_images_to_grid = p2g, g2p, merge
    return (got["slot_data"], got["windows"]) + ((got["merge"],) if merge_in else ())


def g2p_window_errors(out_k, out_p, valid, win, cell_width):
    """The G2P window kernel against its plain version, row by row over the
    valid slots (padded slots hold no particle; no caller reads them):
    max|kernel - plain| over the bound 2e-5 * scale + 1e-5 * |plain|. The
    scale is the row's largest magnitude, and for a gradient row at least
    invd·h·max|window velocity|: the gather sums w·dpt·v terms of that
    size, which cancel. Both sum the same 3^d products per slot in other
    orders. 3D or 2D (from the window's 8^d cells). Returns [(err/bound,
    max|err|)]."""
    import torch
    from sparkl_tpu_torch.math.kernel import inv_d

    dim = 3 if win.shape[2] == 512 else 2
    m = valid[:, None, :]
    a, b = torch.where(m, out_k, 0.0), torch.where(m, out_p, 0.0)
    vscale = inv_d(cell_width) * cell_width * win[:, :dim].abs().max().item()
    out = []
    for r in range(b.shape[1]):
        d = (a[:, r] - b[:, r]).abs()
        scale = b[:, r].abs().max().item()
        if dim <= r < dim + dim * dim:
            scale = max(scale, vscale)
        bnd = 2e-5 * scale + 1e-5 * b[:, r].abs()
        out.append(((d / bnd.clamp(min=1e-30)).max().item(), d.max().item()))
    return out


def profile_sparse_frame(pipe, p, fname="sparse_profile.txt", phase=7):
    """One sparse frame under torch.profiler, with a named range around each
    stage (set here, not in the library). Writes the table to
    chiprun_out/<fname>; returns {stage: device ms}, the device's busy and
    wall ms and its idle share."""
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
    with open(os.path.join(OUT_DIR, fname), "w") as f:
        f.write(f"{n} substeps; wall {wall_ms:.3f} ms profiled, {plain_wall_ms:.3f} ms not; "
                f"device busy {busy_ms:.3f} ms; idle share {idle:.3f} profiled, "
                f"{idle_plain:.3f} against the unprofiled wall\n")
        f.write("".join(f"{k:45s} {v:9.3f} ms\n" for k, v in split.items()))
        f.write(table)
    say(phase, f"profiled sparse frame: {n} substeps, wall {wall_ms:.2f} ms ({plain_wall_ms:.2f} "
               f"ms unprofiled), device busy {busy_ms:.2f} ms, idle share {idle:.3f} "
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
    from sparkl_tpu_torch.scripts import median_ms
    from sparkl_tpu_torch.sparse import transfer as T

    grid, cfg = pipe.grid, pipe._cfg
    dim = grid.dim
    nch = state.structure.num_chunks
    tables = (pipe._tab_f, pipe._tab_i)
    sl, ints = state.slots, state.ints
    m_k = K.mass_p2g_fused(grid, cfg, sl, ints, nch)
    m_p = K.mass_p2g_fused_reference(grid, sl, ints, nch)
    node = pipe._merge_nodes(state, m_k).reshape(cfg.max_grid_blocks + 1, -1)
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
    # On the CPU the plain version's scatter-add sums each cell's slots in
    # ascending lane order, as the kernel's walk does: there the same sums
    # to the bit, in 3D and in 2D (on the card its scatter-add takes
    # atomics' order).
    m_cpu = K.mass_p2g_fused_reference(grid, sl.cpu(), ints.cpu(), nch.cpu())
    res["mass_p2g_fused"]["bit_equal_cpu"] = torch.equal(m_k.cpu(), m_cpu)
    require(res["mass_p2g_fused"]["bit_equal_cpu"],
            f"mass_p2g_fused differs from its plain version on the CPU ({label})")
    res["mass_g2p_fused"] = dict(max_abs_err=g_err, bit_equal=torch.equal(g_k, g_p),
                                 rel_err=g_err / max(g_scale, 1e-30))
    res["p2g_fused"] = dict(max_abs_err=max(e for _, e in a_err),
                            over_bound=max(m for m, _ in a_err))
    if timed and dim == 3:
        # The EOS stress goes through expf and logf, which the card and the
        # CPU round apart: the mass channel is held to the bit, the
        # momentum channels to p2g_errors's bound.
        res["p2g_fused"]["cpu"] = p2g_cpu_bits(grid, pipe._meta, sl, ints, dt, nch, tables,
                                               a_k, label, phase, need=(0,))
    say(phase, f"fluid kernels on the {label} state: mass_p2g_fused max|err| {m_err[1]:.3e} "
               f"({m_err[0]:.2e} of its bound; bit-equal {res['mass_p2g_fused']['bit_equal']}, "
               f"to the plain version on the CPU {res['mass_p2g_fused']['bit_equal_cpu']}); "
               f"mass_g2p_fused max|err| {g_err:.3e} (relative "
               f"{g_err / max(g_scale, 1e-30):.2e}, pass <= 1e-6; bit-equal "
               f"{torch.equal(g_k, g_p)}); p2g_fused (EOS stress) per channel max|err|/bound "
               f"{[f'{m:.2e}' for m, _ in a_err]} (pass <= 1)")
    finite = all(torch.isfinite(x).all().item() for x in (m_k, g_k, a_k))
    require(finite and m_err[0] <= 1.0 and g_err <= 1e-6 * g_scale
            and all(m <= 1.0 for m, _ in a_err),
            f"a fluid kernel disagrees with its plain version on the {label} state")
    res["g2p_fused"], (slots_in, fc, args) = check_g2p(pipe, state, dt, label, phase)
    # The merge stage on the path's two kinds of images, kernel A's (the
    # row the kernels line reports) and the mass images, in the path's form
    # (3D: the scatter form, pinned by fluids3's dense blocks; 2D: the
    # gather form); the mass and 2D node tables also against the plain
    # version on the CPU.
    # (Timed at the 3D fluid path's shapes and on the 2D column.)
    name = "merge_scatter" if pipe._merge_force_scatter else "merge_blocks"
    zm = dim == 3
    merge_at = dict(plan=state.grid_cache[2], owner=state.grid_cache[4])
    res[name] = check_merge(grid, cfg, state.structure, a_k, zm, name == "merge_scatter",
                            phase, f"{label}, kernel A images", timed=timed, cpu=dim == 2,
                            **merge_at)
    res[name]["mass"] = check_merge(grid, cfg, state.structure, m_k, zm,
                                    name == "merge_scatter", phase, f"{label}, mass images",
                                    timed=timed, cpu=True, **merge_at)
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
    # chunk's [1 + d, 8^d] image; kernel B's former count: it reads pos d,
    # F00, mass, vol0, failed and the drift (3D 8, 2D 7 f32 rows), flags,
    # model and origin and the [d, 8^d] window, and changes pos d, vel d,
    # grad d², F00, the dt bound, failed and the drift (3D 19, 2D 12 rows);
    # its bound counts the rows its row table gives the lanes (b_bytes: det
    # F reads all of F, and psi_pos, par1, par2 and the stress rows' zeros
    # are written); the mass kernels read pos d and the mass and flags and
    # the origin (3D 8, 2D 6 rows).
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
        v["ms"], v["plain_ms"] = median_ms(fn), median_ms(plain, reps=5)
        add_split(v, fn)
        v["bytes"], v["flops"], v["library_ms"] = nbytes, flops, None
        v["bound_ms"], v["bound_by"] = bound(nbytes, flops)
    scratch = slots_in.clone()
    v = res["g2p_fused"]

    def b_call():
        return K.g2p_fused(grid, cfg, pipe._meta, pipe._kparams, scratch, ints, *fc, dt, *args)

    v["ms"] = median_ms(b_call)
    add_split(v, b_call)
    v["plain_ms"] = median_ms(
        lambda: K.g2p_fused_plain(grid, cfg, slots_in, ints, *fc, dt, *args), reps=5)
    # v["bytes"]: the rows the fluid lanes need, by the row table (b_bytes).
    v["flops"] = lanes * b_flops
    v["library_ms"] = None
    v["bound_ms"], v["bound_by"] = bound(v["bytes"], v["flops"])
    v["former_bound_ms"] = bound(live * ((b_read + b_written) * row + 4 * dim * cells),
                                   v["flops"])[0]
    for name, v in res.items():
        if name.startswith("merge"):
            continue
        say(phase, f"{name} ({dim}D fluid, {label}): kernel {v['ms']:.3f} ms, plain "
                   f"{v['plain_ms']:.3f} ms "
                   f"(batched medians); {v['bytes'] / 1e9:.4f} GB counted from shapes = "
                   f"{v['bytes'] / v['ms'] / 1e6:.1f} GB/s; bound {v['bound_ms']:.4f} ms "
                   f"({v['bound_by']}){split_text(v)}{former_bound_text(v)}")
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
                  permute_slots=branches["mixed"], eigen_pool_fused=0, eigen_boxes=0,
                  permute_chunks=0)
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
    import sparkl_tpu_torch.scenes as scenes

    b = scenes.build("basic2", device=device)
    return replace(b, name="basic2 block",
                   particles=_block_thirds(b, PLASTIC_BLOCK, (1000.0, 1000.0, 4000.0)))


def perturbed_by_model(state, scales, seed=19):
    """`state` with F += scale_m·N(0, 1) on the occupied lanes of model m
    (numpy seed), for each model m in `scales`. 2D or 3D slots."""
    import numpy as np
    import torch
    from sparkl_tpu_torch.fused import layout as L

    dim = slot_dim(state)
    r = L.Rows(dim)
    d_, _, c = state.slots.shape
    noise = torch.from_numpy(np.random.default_rng(seed).normal(size=(d_, dim * dim, c))
                             .astype(np.float32)).to(state.slots.device)
    occ = (state.ints[:, L.I_FLAGS, :] & L.OCCUPIED) != 0
    mid = state.ints[:, L.I_MODEL, :]
    scale = torch.zeros_like(noise[:, 0])
    for m, sc in scales.items():
        scale = torch.where(occ & (mid == m), sc, scale)
    slots = state.slots.clone()
    slots[:, r.defgrad : r.defgrad + dim * dim] += scale[:, None, :] * noise
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
    from sparkl_tpu_torch.scripts import median_ms
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
    # The window fields the path computes (from its own form's images), cut
    # to the channels this form reads.
    img_path = img_k if psi == pipe._meta["with_psi"] else K.p2g_fused(
        grid, cfg, pipe._meta, state.slots, state.ints, dt, nch, tables)
    fc = b_inputs(pipe, state, img_path, dt, 2 + psi)
    slots_in = state.slots.clone()
    args = (pipe._tab_f, pipe._tab_i, nch)
    out_p = K.g2p_fused_plain(grid, cfg, slots_in, state.ints, *fc, dt, *args,
                              velocity_clamp=pipe._kparams["gpu_velocity_clamp"],
                              stress_cache=cache, modified=modified)
    out_k = K.g2p_fused(grid, cfg, meta, pipe._kparams, slots_in.clone(), state.ints, *fc,
                        dt, *args)
    torch.cuda.synchronize()
    unchanged = b_unchanged(pipe, state, slots_in, out_k, label, phase, meta)
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
        crack = cpf * grid.cell_width * psi_gathered(pipe, state, *fc)
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
        "g2p_fused": dict(max_abs_err=torch.where(occ[:, None, :], out_k - out_p,
                                                  0.0).abs().max().item(),
                          worst_over_tol=worst, bit_equal=same_bits, counts=counts,
                          trips=counts["max_stress_trips"], trips_differ=int(differ.sum()),
                          tie_lanes=int((tie & occ).sum()),
                          svd_reuse=K.svd_reuse(cache, meta["present_c"], meta["present_p"]),
                          unchanged=unchanged),
    }
    say(phase, f"2D kernels on the {label} state (stress cache {cache}, psi {psi}, SVD reuse "
               f"{res['g2p_fused']['svd_reuse']}): p2g_fused images {tuple(img_k.shape)} max|err|"
               f"/bound {[f'{m:.2e}' for m, _ in per_ch]} (pass <= 1); g2p_fused "
               f"worst measure/tol {({g: round(v, 4) for g, v in worst.items()})}, bit-equal on "
               f"occupied lanes {same_bits}; lanes per branch {counts}; phase differing "
               f"{res['g2p_fused']['trips_differ']} (lanes within {TIE:g} of the envelope "
               f"{res['g2p_fused']['tie_lanes']})")
    failures = []
    if not (all(m <= 1.0 for m, _ in per_ch) and torch.isfinite(img_k).all().item()):
        failures.append("p2g_fused")
    if not (all(v <= 1.0 for v in worst.values()) and not bool((differ & ~tie).any())
            and torch.isfinite(torch.where(occ[:, None, :], out_k, 0.0)).all().item()):
        failures.append("g2p_fused")
    require(not failures, f"{failures} disagree with their plain versions on the {label} state")
    # The merge stage on A's images, in the path's form (2D: the gather
    # form unless a block holds more than MERGE_KMAX chunks), also against
    # its plain version on the CPU.
    scatter = pipe._merge_force_scatter
    res["merge_scatter" if scatter else "merge_blocks"] = check_merge(
        grid, cfg, state.structure, img_k, False, scatter, phase, label,
        plan=state.grid_cache[2], owner=state.grid_cache[4], timed=timed, cpu=True)
    if not timed:
        return res
    live, row = int(nch), 4 * cfg.chunk_size
    lanes = int(((state.ints[:, L.I_FLAGS, :] & L.ACTIVE) != 0).sum())
    plastic = int((occ & (K.model_columns(pipe._tab_f, pipe._tab_i, state.ints, (),
                                          (1,))[0][0] != 0)).sum())
    scratch = slots_in.clone()
    # Bytes counted from what the 2D forms read and write per live chunk: A
    # reads pos 2, vel 2, grad 4, mass, vol0, failed, then the 3 stress rows
    # (cache on) or F 4, phase and eh (fresh), with psi cpf and psi_pos, and
    # flags, model, origin 2 (4 i32 rows), and writes every chunk's [nf, 64]
    # image; B counts the rows its row table gives each lane (b_bytes; the
    # former count, beside it: 26 f32 rows read (pos, F, the scalar state,
    # kinematic velocity, crack and bookkeeping rows), 4 i32 rows and the
    # [2, 64] velocity window, and all 40 rows written).
    a_rows = 11 + (3 if cache else 6) + (2 if psi else 0)
    a_slot = A2_CACHED_SLOT_FLOPS if cache else A2_SLOT_FLOPS
    for name, fn, plain, lib, nbytes, flops in (
            ("p2g_fused", lambda: K.p2g_fused(grid, cfg, meta, state.slots, state.ints, dt, nch,
                                              tables),
             lambda: K.p2g_fused_reference(grid, state.slots, state.ints, dt, nch, tables,
                                           stress_cache=cache, with_psi=psi), None,
             live * (a_rows + 4) * row + cfg.max_chunks * img_k.shape[1] * 64 * 4,
             lanes * (9 * P2G2_TAP_FLOPS + a_slot)),
            ("g2p_fused", lambda: K.g2p_fused(grid, cfg, meta, pipe._kparams, scratch,
                                              state.ints, *fc, dt, *args),
             lambda: K.g2p_fused_plain(grid, cfg, slots_in, state.ints, *fc, dt, *args,
                                       stress_cache=cache, modified=modified), None,
             b_bytes(pipe, state, out_k, meta),
             lanes * (9 * G2P2_TAP_FLOPS + B2_LANE_FLOPS) + plastic * B2_PLASTIC_FLOPS)):
        v = res[name]
        v["ms"], v["plain_ms"] = median_ms(fn), median_ms(plain, reps=5)
        v["library_ms"] = median_ms(lib) if lib else None
        add_split(v, fn, lib)
        v["bytes"], v["flops"] = nbytes, flops
        v["bound_ms"], v["bound_by"] = bound(nbytes, flops)
        if name == "g2p_fused":
            v["former_bound_ms"] = bound(live * ((26 + 4 + 40) * row + 2 * 64 * 4), flops)[0]
        say(phase, f"{name} (2D, {label}): kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.3f} ms, "
                   f"library {v['library_ms']} ms (batched medians); {nbytes / 1e9:.4f} GB and "
                   f"{flops / 1e9:.4f} GFLOP counted; bound {v['bound_ms']:.4f} ms "
                   f"({v['bound_by']}){split_text(v)}{former_bound_text(v)}")
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
    from sparkl_tpu_torch.fused import kernels as K
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
        # Kernel A against its plain version on the CPU: elasticity2's cache
        # read to the bit; basic2's fresh stress (the 2x2 SVD) reported.
        img = K.p2g_fused(pipe.grid, pipe._cfg, pipe._meta, state.slots, state.ints, dt,
                          state.structure.num_chunks, (pipe._tab_f, pipe._tab_i))
        res["p2g_fused"]["cpu"] = p2g_cpu_bits(
            pipe.grid, pipe._meta, state.slots, state.ints, dt, state.structure.num_chunks,
            (pipe._tab_f, pipe._tab_i), img, name, 15,
            need=None if name == "elasticity2" else ())
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
    import torch
    import sparkl_tpu_torch as sk
    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch.fused import kernels as K

    gold = golden_frames(name, **kw) if golden else None
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
    spy = ResortSpy()
    for i in range(PLASTIC_FRAMES):
        # A timed frame is clocked alone; its checks run after the clock.
        if i >= first_timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        with spy if i < first_timed else contextlib.nullcontext():
            state, n = pipe.run_frames_state(state, 1)
        if i >= first_timed:
            torch.cuda.synchronize()
            seconds += time.perf_counter() - t0
            timed += n
        substeps += n
        resorts += pipe.last_resorts
        p = pipe.unpack_state(state)
        act = p.active
        mass = p.mass[act].double().sum().item()
        vel = p.velocity[act].double()
        ke = 0.5 * (p.mass[act].double()[:, None] * vel**2).sum().item()
        failed = int(p.failed[act].sum())
        broken = int((p.phase[act] == 0.0).sum())
        frames.append(dict(frame=i, substeps=n, mass=mass, failed=failed, broken=broken,
                           ke=ke))
        require(abs(mass - mass0) <= 1e-6 * mass0, f"{name} frame {i}: mass {mass} vs {mass0}")
        if gold is None:
            continue
        rec = gold[i]
        measure = golden_measures(p, rec)[0]
        slack = max(2, int(0.02 * n_active))
        frames[-1].update(golden_substeps=rec["substeps"], worst_over_tol=measure)
        worst = max(worst, measure)
        require(abs(n - rec["substeps"]) <= 1 and measure <= 1.0
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
    resort_checks = spy.check(phase, f"{name} path")
    return pipe, state, launches, dict(
        substeps=substeps, resorts=resorts, branches=branches, timed_substeps=timed,
        seconds=seconds, pups=pups, worst_over_tol=worst, frames=frames, config=str(pipe._cfg),
        resort_checks=resort_checks)


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
    held("corner map", [pipe._corners(state)], [cpipe._corners(cstate)])
    out = K.g2p_fused(pipe.grid, pipe._cfg, pipe._meta, pipe._kparams, state.slots.clone(),
                      state.ints, fields, pipe._corners(state), dt, pipe._tab_f, pipe._tab_i, nch)
    out_c = K.g2p_fused(cpipe.grid, cpipe._cfg, cpipe._meta, cpipe._kparams,
                        cstate.slots.clone(), cstate.ints, fields.cpu(), cpipe._corners(cstate),
                        dt, cpipe._tab_f, cpipe._tab_i, cstate.structure.num_chunks)
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
            "mass_g2p", "eigen_pool", "eigen_box", "src_rows", "permute_slots",
            "permute_chunks", "p2g_windows", "g2p_windows")
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
# The load's speed (m/s): l_panel2's 0.1 in the reduced form (the CPU
# tests' and phase 24's), and ten times that at full size (phases 22, 23,
# 25), where at 0.1 no eigenerosion trip comes within the main path's 10
# frames (measured: the maximum-stress panel breaks from frame 0, the
# eigenerosion panel not at all; at 1.0 465 trips in frame 0; NVIDIA H100
# 80GB HBM3, 700 W).
LPANEL_LOAD_SPEED, LPANEL3_LOAD_SPEED = 0.1, 1.0


def l_panel3(damage="eigenerosion", scale=1.0, layers=LPANEL3_LAYERS, device="cuda",
             load_speed=LPANEL_LOAD_SPEED):
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
    node plane z = k h across the slab, velocity (0, load_speed, 0) (l_panel2's
    0.1 by default; the full-size paths take LPANEL3_LOAD_SPEED). `damage`
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
        velocities=[[0.0, load_speed, 0.0]] * (len(load) * len(planes)))
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
    lies within TIE of the threshold (counted). Its box kernel equal to
    the boxes' plain version, and the work the kernel's cull leaves
    (chunks skipped, candidates kept, pair tests run; its own counters)
    equal to the plain cull's (eigen_pool_work). With `timed`, times, the
    library yardstick (torch.cdist and a masked torch.bmm over the same
    candidate tiles) and the bound: the bytes, or the operations of the
    pair tests the cull leaves and of the boxes, the larger (beside it the
    bound had every eligible lane tested all its candidates' lanes,
    all_pairs_bound_ms); and the box kernel's times and bound under
    res["boxes"]. 3D or 2D."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.scripts import median_ms

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
    # The cull: the box kernel against its plain version, and the kernel's
    # work counters against the plain cull's.
    boxes_k = K.eigen_boxes(grid, cfg, e)
    boxes_p = K.eigen_boxes_reference(e, dim)
    counters = torch.zeros(3, dtype=torch.int64, device=e.device)
    K.eigen_pool_fused(grid, cfg, e, cand, work=counters)
    work = dict(zip(("skipped", "kept", "tests"), counters.tolist()))
    plain_work = K.eigen_pool_work(grid, e, cand)
    d_, kn = cand.shape
    c = cfg.chunk_size
    live = int(state.structure.num_chunks)
    valid = (cand < d_).sum(dim=1)
    res["pairs"] = int((elig.sum(dim=1) * valid).sum()) * c
    res["work"] = work
    res["boxes"] = dict(max_abs_err=torch.where(boxes_k == boxes_p, 0.0,
                                                (boxes_k - boxes_p).abs()).max().item(),
                        equal=torch.equal(boxes_k, boxes_p))
    say(phase, f"eigen_pool_fused's cull on the {label} state: chunks skipped {work['skipped']} "
               f"of {d_} ({live} live), candidates kept {work['kept']} of {int(valid.sum())}, "
               f"pair tests {work['tests']} of {res['pairs']} "
               f"({work['tests'] / max(res['pairs'], 1):.3f}); equal to the plain cull's "
               f"{work == plain_work}; eigen_boxes equal to its plain version "
               f"{res['boxes']['equal']}")
    require(res["boxes"]["equal"] and work == plain_work,
            f"the pooling's cull disagrees with its plain version on the {label} state")
    if not timed:
        return res
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
    # The plain version walks 3D's candidates 4 chunks at a time (~5 s a
    # call at l_panel3's size) and the library call takes ~0.3 s there: in
    # 3D both are timed alone, where a batch hides nothing.
    reps, batch = (20, 10) if dim == 2 else (5, 1)
    res["ms"] = median_ms(lambda: K.eigen_pool_fused(grid, cfg, e, cand))
    res["plain_ms"] = median_ms(
        lambda: K.eigen_pool_fused_reference(grid, e, K.eigen_candidate_rows(e, cand)), reps=5,
        batch=batch)
    res["library_ms"] = median_ms(library, reps=reps, batch=batch)
    # In 3D the library call takes ~0.3 s: its split is not taken.
    add_split(res, lambda: K.eigen_pool_fused(grid, cfg, e, cand),
              library if dim == 2 else None)
    res["bytes"] = live * K.EIG_ROWS * c * 4 + d_ * kn * 4 + d_ * 2 * c * 4
    # The work this run's data needs: the pair tests the exact cull leaves
    # (the plain cull's count, equal to the kernel's) and the boxes.
    res["flops"] = plain_work["tests"] * EIG_PAIR_FLOPS + live * c * 2 * dim
    res["bound_ms"], res["bound_by"] = bound(res["bytes"], res["flops"])
    res["all_pairs_bound_ms"] = bound(res["bytes"], res["pairs"] * EIG_PAIR_FLOPS)[0]
    res["byte_bound_ms"] = bound(res["bytes"], 0)[0]
    say(phase, f"eigen_pool_fused ({label}): kernel {res['ms']:.4f} ms, plain "
               f"{res['plain_ms']:.3f} ms, library (cdist + masked bmm) {res['library_ms']:.3f} ms "
               f"(medians of 20 batches of 10, 5 and {reps} batches of {batch}; library "
               f"max|diff| {lib_err:.2e}); {res['pairs']} pair tests of the eligible lanes, "
               f"{plain_work['tests']} run; bound {res['bound_ms']:.4f} ms ({res['bound_by']}; "
               f"the bytes alone {res['byte_bound_ms']:.4f} ms, all pairs tested "
               f"{res['all_pairs_bound_ms']:.4f} ms){split_text(res)}")
    # The box kernel alone: it reads the position and eligible rows of the
    # live chunks and writes every chunk's boxes; 2 compares an axis a lane.
    v = res["boxes"]
    v["ms"] = median_ms(lambda: K.eigen_boxes(grid, cfg, e))
    v["plain_ms"] = median_ms(lambda: K.eigen_boxes_reference(e, dim), reps=5)
    v["library_ms"] = None
    add_split(v, lambda: K.eigen_boxes(grid, cfg, e))
    v["bytes"] = live * (dim + 1) * c * 4 + d_ * (c // K.EIG_GROUP) * K.EIG_BOX * 4
    v["flops"] = live * c * 2 * dim
    v["bound_ms"], v["bound_by"] = bound(v["bytes"], v["flops"])
    say(phase, f"eigen_boxes ({label}): kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.3f} ms "
               f"(batched medians); bound {v['bound_ms']:.4f} ms ({v['bound_by']})"
               f"{split_text(v)}")
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
        res["eigen_boxes"] = res["eigen_pool_fused"].pop("boxes")
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


def psi_gathered(pipe, state, fields, corners):
    """The psi channel of the window fields [MG + 1, (d + 1) · 4^d] at each
    slot, gathered at the chunks' corners as kernel B's plain version
    gathers it (the crack energy of the modified trip is cpf·h times it)."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.sparse import transfer as T

    grid = pipe.grid
    dim = grid.dim
    windows = T.windows_from_corners(grid, pipe._cfg, corners, fields, pipe._cell_order())
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
    from sparkl_tpu_torch.scripts import median_ms
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
    fc = b_inputs(pipe, state, img_k, dt)
    slots_in = state.slots.clone()
    args = (pipe._tab_f, pipe._tab_i, nch)
    out_p = K.g2p_fused_plain(grid, cfg, slots_in, state.ints, *fc, dt, *args,
                              velocity_clamp=pipe._kparams["gpu_velocity_clamp"],
                              stress_cache=False, modified=modified)
    out_k = K.g2p_fused(grid, cfg, meta, pipe._kparams, slots_in.clone(), state.ints, *fc,
                        dt, *args)
    torch.cuda.synchronize()
    unchanged = b_unchanged(pipe, state, slots_in, out_k, label, phase, meta)
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
        crack = cpf * grid.cell_width * psi_gathered(pipe, state, *fc)
        crack_tie = (cpf != 0.0) & ((crack - cthr).abs() <= TIE * cthr.abs())
        crack_trips = int((live & (cpf != 0.0) & (crack > cthr)).sum())
    tie = (stress_tie | crack_tie) & occ
    differ = occ & (out_k[:, r.phase] != out_p[:, r.phase])
    same_bits = torch.equal(torch.where(occ[:, None, :], out_k, 0.0),
                            torch.where(occ[:, None, :], out_p, 0.0))
    res = {
        "p2g_fused": dict(max_abs_err=max(e for _, e in per_ch),
                          over_bound=max(m for m, _ in per_ch)),
        "g2p_fused": dict(max_abs_err=torch.where(occ[:, None, :], out_k - out_p,
                                                  0.0).abs().max().item(),
                          worst_over_tol=worst, bit_equal=same_bits, modified=modified,
                          stress_trips=stress_trips, crack_trips=crack_trips,
                          trips_differ=int(differ.sum()), tie_lanes=int(tie.sum()),
                          unchanged=unchanged),
    }
    say(phase, f"3D damage kernels on the {label} state: p2g_fused images {tuple(img_k.shape)} "
               f"max|err|/bound {[f'{m:.2e}' for m, _ in per_ch]} (pass <= 1); g2p_fused "
               f"(modified trip {modified}) worst measure/tol "
               f"{({g: round(v, 4) for g, v in worst.items()})}, bit-equal on occupied lanes "
               f"{same_bits}; trips: maximum stress {stress_trips}, crack energy {crack_trips}; "
               f"phase differing {res['g2p_fused']['trips_differ']} (lanes within {TIE:g} of a "
               f"threshold {res['g2p_fused']['tie_lanes']})")
    failures = []
    if not (all(m <= 1.0 for m, _ in per_ch) and torch.isfinite(img_k).all().item()):
        failures.append("p2g_fused")
    if not (all(v <= 1.0 for v in worst.values()) and not bool((differ & ~tie).any())
            and torch.isfinite(torch.where(occ[:, None, :], out_k, 0.0)).all().item()):
        failures.append("g2p_fused")
    require(not failures, f"{failures} disagree with their plain versions on the {label} state")
    # The merge stage on A's images (z-major, nf = 6), in the path's form.
    scatter = pipe._merge_force_scatter
    res["merge_scatter" if scatter else "merge_blocks"] = check_merge(
        grid, cfg, state.structure, img_k, True, scatter, phase, label,
        plan=state.grid_cache[2], owner=state.grid_cache[4], timed=timed)
    if not timed:
        return res
    # Kernel A's fresh stress (the cardano SVD) against the CPU: reported.
    res["p2g_fused"]["cpu"] = p2g_cpu_bits(grid, meta, state.slots, state.ints, dt, nch, tables,
                                           img_k, label, phase, need=())
    res["p2g_fused"]["hits_per_cta"] = a_hits(grid, state)
    live_chunks, row = int(nch), 4 * cfg.chunk_size
    lanes = int(((state.ints[:, L.I_FLAGS, :] & L.ACTIVE) != 0).sum())
    n_win = fc[0].shape[1] // 64
    scratch = slots_in.clone()
    # Bytes counted from what the 3D damage forms read and write per live
    # chunk: A reads pos 3, vel 3, grad 9, F 9, mass, vol0, phase, eh,
    # failed, cpf and psi_pos (31 rows) and 5 i32 rows (model, flags,
    # origin 3), and writes every chunk's [6, 512] image; B counts the rows
    # its row table gives each lane (b_bytes; the former count, beside it:
    # 34 f32 rows read (pos, F, the scalar state, kinematic velocity, crack
    # and bookkeeping rows), 5 i32 rows and the [d (+1), 512] window, and
    # all 56 rows written).
    for name, fn, plain, nbytes, flops in (
            ("p2g_fused", lambda: K.p2g_fused(grid, cfg, meta, state.slots, state.ints, dt, nch,
                                              tables),
             lambda: K.p2g_fused_reference(grid, state.slots, state.ints, dt, nch, tables,
                                           stress_cache=False, with_psi=True),
             live_chunks * (31 + 5) * row + cfg.max_chunks * img_k.shape[1] * 512 * 4,
             lanes * (27 * (P2G_TAP_FLOPS + P2G3_PSI_TAP_FLOPS) + A3_FRESH_SLOT_FLOPS)),
            ("g2p_fused", lambda: K.g2p_fused(grid, cfg, meta, pipe._kparams, scratch,
                                              state.ints, *fc, dt, *args),
             lambda: K.g2p_fused_plain(grid, cfg, slots_in, state.ints, *fc, dt, *args,
                                       stress_cache=False, modified=modified),
             b_bytes(pipe, state, out_k),
             lanes * (27 * (G2P_TAP_FLOPS + (2 if modified else 0)) + B_LANE_FLOPS
                      + B3_FAILURE_FLOPS))):
        v = res[name]
        v["ms"], v["plain_ms"] = median_ms(fn), median_ms(plain, reps=5)
        add_split(v, fn)
        v["library_ms"] = None
        v["bytes"], v["flops"] = nbytes, flops
        v["bound_ms"], v["bound_by"] = bound(nbytes, flops)
        if name == "g2p_fused":
            v["former_bound_ms"] = bound(
                live_chunks * ((34 + 5 + 56) * row + (4 if modified else 3) * 512 * 4), flops)[0]
        hits = (f"; hits per CTA mean {v['hits_per_cta'][0]:.1f}, max {v['hits_per_cta'][1]}"
                if "hits_per_cta" in v else "")
        say(phase, f"{name} (3D damage, {label}): kernel {v['ms']:.4f} ms, plain "
                   f"{v['plain_ms']:.3f} ms (batched medians); window channels {n_win}; "
                   f"{nbytes / 1e9:.4f} GB and {flops / 1e9:.4f} GFLOP counted; bound "
                   f"{v['bound_ms']:.4f} ms ({v['bound_by']}){split_text(v)}{hits}"
                   f"{former_bound_text(v)}")
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
        b = l_panel3(damage, load_speed=LPANEL3_LOAD_SPEED)
        pipe, state = substep_state(b, LPANEL3_SUBSTEPS_IN)
        dt = float(pipe._min_dtb(state))
        h = b.grid.cell_width
        say(22, f"{b.name}: {int(b.particles.active.sum())} particles, {pipe._cfg}, grid "
                f"{b.grid.res}, {LPANEL3_SUBSTEPS_IN} substeps in, dt {dt:.3e}, live chunks "
                f"{int(state.structure.num_chunks)}, set-up {time.perf_counter() - t0:.1f} s")
        res = {}
        if damage == "eigenerosion":
            res["eigen_pool_fused"] = check_eigen(pipe, state, b.name, 22, timed=True)
            res["eigen_boxes"] = res["eigen_pool_fused"].pop("boxes")
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


def phase_damage_main(b, frames, timed_frames, phase, stats=None):
    """A fused main path (l_panel2, l_panel3, both under modified
    eigenerosion, and materials3 and materials2): the bundle `b` ->
    auto_pipeline -> pack_state -> `frames` frames of run_frames_state (the
    last `timed_frames` timed, each frame clocked alone) -> unpack_state,
    with each kernel's launches held against the substeps the pipeline ran
    (retried spans included): A, the merge and B once per substep, the
    pooling once per substep under eigenerosion and never under modified
    eigenerosion or without damage, the resort kernels by branch; per frame
    the substeps, `stats(state)` (by default panel_stats: the broken and
    failed counts per panel) and the mass it returns (held to 1e-6), and the
    candidate-list regrows. Returns (the pipeline, the final state, the
    launches, results)."""
    import torch
    import sparkl_tpu_torch as sk
    from sparkl_tpu_torch.fused import kernels as K

    stats = panel_stats if stats is None else stats
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
        per, mass = stats(state)
        out_frames.append(dict(frame=i, substeps=n, per_model=per, mass=mass,
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
                  eigen_boxes=ran[0] if pipe._eigen else 0,
                  src_rows_from_order=resorts - branches["relabel"],
                  permute_slots=branches["mixed"])
    expect[merge] = ran[0]
    require(launches == expect, f"{b.name} path launch counts {launches}, expected {expect}")
    per, _ = stats(state)
    return pipe, state, launches, dict(
        particles=n_active, substeps=substeps, substeps_run=ran[0], resorts=resorts,
        branches=branches, timed_substeps=timed, seconds=seconds, pups=pups, peak_gib=peak_gib,
        eigen_regrows=pipe.eigen_regrows, per_model=per, frames=out_frames,
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
    return tie | stress_ties(pipe.models, p_in, p_out)


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


# ---------------------------------------------------------------------------
# The remaining material models (phases 26-29): materials3 and materials2
# ---------------------------------------------------------------------------


def materials3(scale=1.0, failure=False, device="cuda"):
    """sand3@1M with the remaining material models, built with the port's
    API: scenes.build("sand3", nx=100, ny=50, nz=100)'s grid, heightfield,
    gravity, dt 1/60 and two 100 x 50 x 100 lattices (density 2700, E =
    1e7, nu = 0.2 throughout). The upper lattice is split along x into four
    bands of 25 lattice columns: model 0 neo-Hookean + NACC (cohesion β
    0.5, hardening on, ξ 0.8, friction angle 35°, sand3's Drucker-Prager
    h0), model 1 corotated + Rankine (tensile strength 5e4, elasticity2's
    ratio to E, softening 5), model 2 corotated + Snow (the registry's
    defaults), model 3 corotated + Drucker-Prager (sand3's sand). The lower
    lattice, model 4, is neo-Hookean alone; with `failure` it also fails by
    maximum stress at MATERIALS3_FAILURE, which turns the stress cache off.
    `scale` < 1 cuts each lattice's counts by it (0.08: 8 x 4 x 8 each,
    1,024 particles; the x count must stay a multiple of 4)."""
    import math
    from dataclasses import replace
    import torch
    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch.models import registry as reg

    nx, ny, nz = (int(round(c * scale)) for c in MATERIALS3_COUNTS)
    require(nx % 4 == 0 and min(nx, ny, nz) > 0, f"materials3 lattice {nx} x {ny} x {nz}")
    b = scenes.build("sand3", nx=nx, ny=ny, nz=nz, device=device)
    e, nu = MATERIALS_E, MATERIALS_NU
    nh = reg.neo_hookean_elasticity(e, nu)
    co = reg.corotated_linear_elasticity(e, nu)
    models = reg.ModelSet.pack([
        reg.ParticleModel(nh, reg.nacc_plasticity(e, nu, 0.5, True, 0.8, math.radians(35.0))),
        reg.ParticleModel(co, reg.rankine_plasticity(e, nu, 5.0e4, 5.0)),
        reg.ParticleModel(co, reg.snow_plasticity()),
        reg.ParticleModel(co, reg.drucker_prager_plasticity(e, nu)),
        reg.ParticleModel(nh, failure=reg.maximum_stress_failure(*MATERIALS3_FAILURE)
                          if failure else None),
    ], device)
    # cube_particles orders the lattice x-major: the upper lattice's
    # particle i sits in x column i // (ny nz).
    n_up = nx * ny * nz
    idx = torch.arange(b.particles.capacity, device=b.particles.position.device)
    band = (idx // (ny * nz)) // (nx // 4)
    mid = torch.where(idx < n_up, band, 4).to(torch.int32)
    return replace(b, name="materials3" + ("-failure" if failure else ""), models=models,
                   particles=b.particles.replace(model_id=mid))


def _block_thirds(b, side, densities):
    """A 2D lattice of side x side particles at r = h/4 over `b`'s grid
    (basic2's), its thirds in x models 0, 1, 2 with `densities`, from x =
    -0.55, y = 0.6."""
    import numpy as np
    from sparkl_tpu_torch.core.particles import Particles

    r = b.grid.cell_width / 4.0
    cols = np.array_split(np.arange(side, dtype=np.float32), 3)
    ys = 0.6 + r + 2.0 * r * np.arange(side, dtype=np.float32)
    parts = []
    for m, (xi, rho) in enumerate(zip(cols, densities)):
        gx, gy = np.meshgrid(-0.55 + r + 2.0 * r * xi, ys, indexing="ij")
        pts = np.stack([gx.reshape(-1), gy.reshape(-1)], -1).astype(np.float32)
        parts.append(Particles.from_positions(pts, m, r, rho, b.particles.device))
    return Particles.concatenate(tuple(parts))


def materials2(scale=1.0, failure=False, device="cuda"):
    """The 2D forms' scene: plastic_block (basic2's grid and heightfield, a
    500 x 500 lattice at r = h/4, 250,000 particles, densities 1000, 1000,
    4000 by thirds in x) with its thirds' models swapped to neo-Hookean +
    NACC (2D M), neo-Hookean alone and corotated + Rankine (tensile
    strength 500, the same 5e-3 of E), at basic2's E = 1e5, nu = 0.2. With
    `failure` the neo-Hookean third also fails by maximum stress at
    MATERIALS2_FAILURE (the stress cache off). `scale` < 1 cuts the
    lattice's side by it (0.048: 24 x 24, 576 particles)."""
    import math
    from dataclasses import replace
    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch.models import registry as reg

    b = scenes.build("basic2", device=device)
    e, nu = 1.0e5, 0.2
    nh = reg.neo_hookean_elasticity(e, nu)
    models = reg.ModelSet.pack([
        reg.ParticleModel(nh, reg.nacc_plasticity(e, nu, 0.5, True, 0.8, math.radians(35.0),
                                                  dim=2)),
        reg.ParticleModel(nh, failure=reg.maximum_stress_failure(*MATERIALS2_FAILURE)
                          if failure else None),
        reg.ParticleModel(reg.corotated_linear_elasticity(e, nu),
                          reg.rankine_plasticity(e, nu, 500.0, 5.0)),
    ], device)
    side = int(round(PLASTIC_BLOCK * scale))
    return replace(b, name="materials2" + ("-failure" if failure else ""), models=models,
                   particles=_block_thirds(b, side, (1000.0, 1000.0, 4000.0)))


def materials_stats(state):
    """Per model id of a materials state: the occupied lanes, and those whose
    plastic state moved from the pack's (NACC α off -0.01, Rankine and
    Drucker-Prager hardening off 1, Snow's plastic volume off 1), the broken
    (phase 0) and failed lanes, and NACC's α range; with the deactivated
    mass. The mass returned is that of every occupied slot, active or not
    (a slot lost or doubled by a resort shows)."""
    import torch
    from sparkl_tpu_torch.fused import layout as L

    r = L.Rows(slot_dim(state))
    flags = state.ints[:, L.I_FLAGS, :]
    occ = (flags & L.OCCUPIED) != 0
    act = (flags & L.ACTIVE) != 0
    mid = state.ints[:, L.I_MODEL, :]
    s = state.slots
    moved = ((s[:, r.nacc] != -0.01) | (s[:, r.ph] != 1.0) | (s[:, r.pdd] != 1.0))
    per = {}
    for m in range(int(mid[occ].max()) + 1 if bool(occ.any()) else 0):
        sel = occ & (mid == m)
        alpha = s[:, r.nacc][sel]
        per[m] = dict(lanes=int(sel.sum()), plastic=int((sel & moved).sum()),
                      broken=int((sel & (s[:, r.phase] == 0.0)).sum()),
                      failed=int((sel & (s[:, r.failed] != 0.0)).sum()),
                      alpha=[round(alpha.min().item(), 6), round(alpha.max().item(), 6)]
                      if alpha.numel() else None)
    mass = torch.where(occ, s[:, r.mass], 0.0).double().sum().item()
    per["deactivated_mass"] = torch.where(occ & ~act, s[:, r.mass], 0.0).double().sum().item()
    return per, mass


def material_counts(pipe, state, out, dt):
    """Lanes of each branch kernel B takes on `state` (its output `out`),
    from each return map's input F (the slot's F updated with out's
    gradient rows): NACC by case (A the max tip, B the min tip, C inside, D
    projected) and the lanes whose α hardened, Rankine by case (elastic,
    the largest, the two largest (3D) or every principal strain capped),
    Snow lanes with a singular value clamped below or above, Drucker-Prager
    lanes with flow, and maximum-stress trips (phase 1 -> 0). Returns
    (counts, the NACC lanes whose decisions lie within TIE of a threshold
    (plasticity.nacc_margin), NACC's α range in out)."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.math import cmat, svd
    from sparkl_tpu_torch.models import failure as fail
    from sparkl_tpu_torch.models import plasticity as plas

    dim = slot_dim(state)
    r = L.Rows(dim)
    slots = state.slots
    occ = (state.ints[:, L.I_FLAGS, :] & L.OCCUPIED) != 0
    (pt, ft), cols = K.model_columns(pipe._tab_f, pipe._tab_i, state.ints, range(16), (1, 2))
    pp = cols[K.TAB_P : K.TAB_P + 8]
    f = [[slots[:, r.defgrad + dim * i + j] for j in range(dim)] for i in range(dim)]
    g = [[out[:, r.grad + dim * i + j] for j in range(dim)] for i in range(dim)]
    gf = cmat.matmul_c(g, f)
    fu = [[f[i][j] + dt * gf[i][j] for j in range(dim)] for i in range(dim)]
    counts = {}
    na = occ & (pt == plas.NACC)
    _, _, case, margin = plas.nacc_project_c(pp[:6], fu, slots[:, r.nacc])
    for code, name in ((plas.NACC_TIP_MAX, "nacc_a_tip_max"), (plas.NACC_TIP_MIN, "nacc_b_tip_min"),
                       (plas.NACC_INSIDE, "nacc_c_inside"), (plas.NACC_PROJECT, "nacc_d_project")):
        counts[name] = int((na & (case == code)).sum())
    counts["nacc_hardened"] = int((na & (out[:, r.nacc] != slots[:, r.nacc])).sum())
    tie = na & (margin <= TIE)
    alpha = out[:, r.nacc][na]
    s = svd.svd_c(fu)[1]
    srt = torch.sort(torch.stack([torch.log(torch.clamp(x, min=1e-20)) for x in s]),
                     dim=0).values  # ascending principal Hencky strains
    e_sum = srt.sum(0)
    e1, e2, e3 = srt[-1], srt[-2], srt[0]
    mu, lam, ts = pp[0], pp[1], pp[2]
    soft = ts - (slots[:, r.ph] - 1.0)
    case0 = lam * e_sum + 2.0 * mu * e1 <= soft
    cond1 = (2.0 * mu + lam) * e2 + lam * (e_sum - e1) <= soft
    cond2 = ((2.0 * mu + 3.0 * lam) * e3 <= soft) if dim == 3 else torch.zeros_like(case0)
    rk = occ & (pt == plas.RANKINE)
    sn = occ & (pt == plas.SNOW)
    below = torch.zeros_like(occ)
    above = torch.zeros_like(occ)
    for x in s:
        below = below | (x < 1.0 - pp[0])
        above = above | (x > 1.0 + pp[1])
    counts.update(
        rankine_elastic=int((rk & case0).sum()),
        rankine_cap_largest=int((rk & ~case0 & cond1).sum()),
        rankine_cap_two=int((rk & ~case0 & ~cond1 & cond2).sum()),
        rankine_uniform=int((rk & ~case0 & ~cond1 & ~cond2).sum()),
        snow_below=int((sn & below).sum()), snow_above=int((sn & above).sum()),
        dp_flow=int((occ & (pt == plas.DRUCKER_PRAGER) & (out[:, r.ph] != slots[:, r.ph])).sum()),
        max_stress_trips=int((occ & (ft == fail.MAXIMUM_STRESS) & (out[:, r.phase] == 0.0)
                              & (slots[:, r.phase] != 0.0)).sum()))
    return counts, tie, ([alpha.min().item(), alpha.max().item()] if alpha.numel() else None)


def envelope_ties(pipe, ints, slots_in, out):
    """Lanes failing by maximum stress whose envelope decision on the fresh
    stress of out's F (the input phase) lies within TIE of a threshold: the
    largest principal stress against max_principal, half the spread
    against max_shear."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.math import svd
    from sparkl_tpu_torch.models import failure as fail

    dim = 3 if out.shape[1] == L.Rows(3).nf else 2
    r = L.Rows(dim)
    (ct, ft), p = K.model_columns(pipe._tab_f, pipe._tab_i, ints, range(16), (0, 2))
    f = [[out[:, r.defgrad + dim * i + j] for j in range(dim)] for i in range(dim)]
    st = K.kirchhoff_stress_c(ct, p[0:4], slots_in[:, r.phase], out[:, r.eh], f, None, None,
                              None, tuple(int(x) for x in pipe.models.present_c))
    sym = [[0.5 * (st[i][j] + st[j][i]) for j in range(dim)] for i in range(dim)]
    eig = torch.stack(svd.sym_eigvals2x2_c(sym) if dim == 2 else svd.sym_eigvals3x3_c(sym))
    emax, emin = eig.max(0).values, eig.min(0).values
    mp, ms = p[K.TAB_F], p[K.TAB_F + 1]
    near = (((emax - mp).abs() <= TIE * mp.abs())
            | (((emax - emin) / 2.0 - ms).abs() <= TIE * ms.abs()))
    return (ft == fail.MAXIMUM_STRESS) & near


def check_materials(pipe, state, dt, label, phase, timed=False):
    """Kernels A and B in their material forms against their plain versions
    on the 2D or 3D `state`, on the windows the path computes: A's stress-
    cache read (materials3, materials2) or its fresh corotated and
    neo-Hookean stress (the failure forms), p2g_errors's bound; the merge
    on its images, bit-equal; B's material instance (NACC, neo-Hookean's
    energy, cached or failure stress and dt bound, Rankine and Snow, and in
    the failure forms the damage instance with the maximum-stress trip),
    g2p_errors's row tolerances on occupied lanes but those whose NACC
    decision lies within TIE of a threshold (counted: there the case, and
    so F and α, may differ), the phase row equal but on lanes whose
    envelope decision lies within TIE (counted). Each branch's lanes are
    counted (material_counts). With `timed`, times and bounds. Returns
    {name: {...}}."""
    import torch
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused import layout as L
    from sparkl_tpu_torch.models import constitutive as con
    from sparkl_tpu_torch.models import plasticity as plas
    from sparkl_tpu_torch.scripts import median_ms
    from sparkl_tpu_torch.sparse import transfer as T

    meta = pipe._meta
    cache = bool(meta["stress_cache"])
    grid, cfg = pipe.grid, pipe._cfg
    dim = grid.dim
    r = L.Rows(dim)
    nch = state.structure.num_chunks
    tables = (pipe._tab_f, pipe._tab_i)
    img_k = K.p2g_fused(grid, cfg, meta, state.slots, state.ints, dt, nch, tables)
    img_p = K.p2g_fused_reference(grid, state.slots, state.ints, dt, nch, tables,
                                  stress_cache=cache)
    fc = b_inputs(pipe, state, img_k, dt)
    slots_in = state.slots.clone()
    args = (pipe._tab_f, pipe._tab_i, nch)
    out_p = K.g2p_fused_plain(grid, cfg, slots_in, state.ints, *fc, dt, *args,
                              velocity_clamp=pipe._kparams["gpu_velocity_clamp"],
                              stress_cache=cache)
    out_k = K.g2p_fused(grid, cfg, meta, pipe._kparams, slots_in.clone(), state.ints, *fc,
                        dt, *args)
    if out_k.is_cuda:
        torch.cuda.synchronize()
    unchanged = b_unchanged(pipe, state, slots_in, out_k, label, phase, meta)
    per_ch = p2g_errors(img_k, img_p)
    occ = (state.ints[:, L.I_FLAGS, :] & L.OCCUPIED) != 0
    counts, nacc_tie, alpha = material_counts(pipe, state, out_p, dt)
    # neo-Hookean's energy floor: µh d/2 times 4 ulp(1) of J^(-2/d), within
    # 1e-6 µh in 2D and 3D.
    (ct,), cp = K.model_columns(pipe._tab_f, pipe._tab_i, state.ints, (K.TAB_C + 1,))
    floor = torch.where(ct == con.NEO_HOOKEAN, 1e-6 * cp[0] * out_p[:, r.eh], 0.0)
    row_errs = g2p_errors(out_k, out_p, state.ints, pipe.models.cparams, grid.cell_width,
                          skip_rows=(r.phase,), skip_lanes=nacc_tie, energy_floor=floor)
    worst = {}
    for _, grp, m, tol in row_errs:
        worst[grp] = max(worst.get(grp, 0.0), m / tol if tol else m)
    trip_tie = envelope_ties(pipe, state.ints, slots_in, out_k) & occ
    differ = occ & (out_k[:, r.phase] != out_p[:, r.phase])
    mid = state.ints[:, L.I_MODEL, :]
    lanes_per_model = {m: int((occ & (mid == m)).sum()) for m in range(pipe.models.num_models)}
    # Warps (32 lanes) whose occupied lanes hold more than one model: where
    # kernel B's branches diverge.
    w_mid = torch.where(occ, mid, -1).reshape(mid.shape[0], -1, 32)
    w_occ = occ.reshape(mid.shape[0], -1, 32)
    big = torch.where(w_occ, w_mid, -1).amax(-1)
    small = torch.where(w_occ, w_mid, 1 << 20).amin(-1)
    mixed_warps = int((w_occ.any(-1) & (big != small)).sum())
    res = {
        "p2g_fused": dict(max_abs_err=max(e for _, e in per_ch),
                          over_bound=max(m for m, _ in per_ch), stress_cache=cache,
                          mats_form=K.mats_form(meta, dim)),
        "g2p_fused": dict(max_abs_err=torch.where((occ & ~nacc_tie)[:, None, :], out_k - out_p,
                                                  0.0).abs().max().item(),
                          worst_over_tol=worst, counts=counts, nacc_alpha=alpha,
                          nacc_tie_lanes=int(nacc_tie.sum()), trips_differ=int(differ.sum()),
                          trip_tie_lanes=int(trip_tie.sum()), lanes_per_model=lanes_per_model,
                          mixed_warps=mixed_warps,
                          warps=int(w_occ.any(-1).sum()), unchanged=unchanged),
    }
    say(phase, f"material kernels on the {label} state ({dim}D, stress cache {cache}, material "
               f"form {K.mats_form(meta, dim)}): p2g_fused images {tuple(img_k.shape)} "
               f"max|err|/bound {[f'{m:.2e}' for m, _ in per_ch]} (pass <= 1); g2p_fused "
               f"worst measure/tol "
               f"{({g: round(v, 4) for g, v in worst.items()})} off {int(nacc_tie.sum())} NACC "
               f"tie lanes; lanes per model {lanes_per_model}, warps with more than one model "
               f"{mixed_warps} of {res['g2p_fused']['warps']}; lanes per branch {counts}; NACC "
               f"alpha range {alpha}; phase differing {int(differ.sum())} (envelope ties "
               f"{int(trip_tie.sum())})")
    failures = []
    if not (all(m <= 1.0 for m, _ in per_ch) and torch.isfinite(img_k).all().item()):
        failures.append("p2g_fused")
    if not (all(v <= 1.0 for v in worst.values()) and not bool((differ & ~trip_tie).any())
            and torch.isfinite(torch.where(occ[:, None, :], out_k, 0.0)).all().item()):
        failures.append("g2p_fused")
    require(not failures, f"{failures} disagree with their plain versions on the {label} state")
    # The merge stage on A's images, in the path's form (2D: also against
    # its plain version on the CPU).
    scatter = pipe._merge_force_scatter
    res["merge_scatter" if scatter else "merge_blocks"] = check_merge(
        grid, cfg, state.structure, img_k, dim == 3, scatter, phase, label,
        plan=state.grid_cache[2], owner=state.grid_cache[4], timed=timed, cpu=dim == 2)
    if not timed:
        return res
    live, row = int(nch), 4 * cfg.chunk_size
    act = (state.ints[:, L.I_FLAGS, :] & L.ACTIVE) != 0
    lanes = int(act.sum())
    (ct, pt), _ = K.model_columns(pipe._tab_f, pipe._tab_i, state.ints, (), (0, 1))
    neo = int((act & (ct == con.NEO_HOOKEAN)).sum())
    mapped = int((act & ((pt == plas.NACC) | (pt == plas.RANKINE) | (pt == plas.SNOW))).sum())
    scratch = slots_in.clone()
    # Bytes counted from what the forms read and write per live chunk. A
    # reads pos, vel, grad, mass, vol0 and failed, then the stress rows
    # (cache on) or F, phase and eh (fresh), and flags, model and the origin
    # (d + 2 i32 rows), and writes every chunk's [1 + d, 8^d] image. B
    # counts the rows its row table gives each lane (b_bytes; the former
    # count, beside it: the rows check_kernels_3d and check_kernels_2d count,
    # 3D 34 f32 and 5 i32, 2D 26 and 4, the [d, 8^d] velocity window, and
    # every row written). Operations: per tap as the other forms; per slot A's affine (and
    # fresh, the corotated SVD stress or neo-Hookean's NH_SLOT_FLOPS), B's
    # lane, and per NACC, Rankine or Snow lane one more SVD and its map.
    cells = 512 if dim == 3 else 64
    a_rows = (3 * dim + 3 + (6 if dim == 3 else 3)) if cache else (
        2 * dim + dim * dim + 5 + dim * dim)
    a_bytes = live * (a_rows + dim + 2) * row + cfg.max_chunks * img_k.shape[1] * cells * 4
    b_nbytes = b_bytes(pipe, state, out_k)
    former = live * ((34 + 5 + r.nf) * row + 3 * 512 * 4 if dim == 3 else
                     (26 + 4 + r.nf) * row + 2 * 64 * 4)
    if dim == 3:
        a_slot = A_SLOT_FLOPS if cache else A3_FRESH_SLOT_FLOPS
        a_flops = lanes * (27 * P2G_TAP_FLOPS + a_slot)
        b_flops = (lanes * (27 * G2P_TAP_FLOPS + B_LANE_FLOPS) + mapped * MAT_MAP3_FLOPS
                   + (0 if cache else lanes * B3_FAILURE_FLOPS))
    else:
        a_slot = A2_CACHED_SLOT_FLOPS if cache else A2_SLOT_FLOPS
        a_flops = lanes * (9 * P2G2_TAP_FLOPS + a_slot)
        b_flops = lanes * (9 * G2P2_TAP_FLOPS + B2_LANE_FLOPS) + mapped * B2_PLASTIC_FLOPS
    a_flops += 0 if cache else neo * NH_SLOT_FLOPS
    b_flops += neo * NH_SLOT_FLOPS
    for name, fn, plain, nbytes, flops in (
            ("p2g_fused", lambda: K.p2g_fused(grid, cfg, meta, state.slots, state.ints, dt, nch,
                                              tables),
             lambda: K.p2g_fused_reference(grid, state.slots, state.ints, dt, nch, tables,
                                           stress_cache=cache), a_bytes, a_flops),
            ("g2p_fused", lambda: K.g2p_fused(grid, cfg, meta, pipe._kparams, scratch,
                                              state.ints, *fc, dt, *args),
             lambda: K.g2p_fused_plain(grid, cfg, slots_in, state.ints, *fc, dt, *args,
                                       stress_cache=cache), b_nbytes, b_flops)):
        v = res[name]
        v["ms"], v["plain_ms"] = median_ms(fn), median_ms(plain, reps=5)
        add_split(v, fn)
        v["library_ms"] = None
        v["bytes"], v["flops"] = nbytes, flops
        v["bound_ms"], v["bound_by"] = bound(nbytes, flops)
        if name == "g2p_fused":
            v["former_bound_ms"] = bound(former, flops)[0]
        say(phase, f"{name} ({label}): kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.3f} ms "
                   f"(batched medians); {nbytes / 1e9:.4f} GB and {flops / 1e9:.4f} GFLOP counted; "
                   f"bound {v['bound_ms']:.4f} ms ({v['bound_by']}){split_text(v)}"
                   f"{former_bound_text(v)}")
    return res


def perturbed_particles(p, seed=110, f_scale=0.005, v_scale=0.2):
    """`p` with F = I + f_scale N and velocities v_scale N (numpy seed, F
    drawn first), so that the first substeps of a scene that starts at rest
    in free fall load every model."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n, d = p.capacity, p.dim
    f = (np.eye(d) + f_scale * rng.normal(size=(n, d, d))).astype(np.float32)
    v = rng.normal(scale=v_scale, size=(n, d)).astype(np.float32)
    return p.replace(deformation_gradient=torch.from_numpy(f).to(p.device),
                     velocity=torch.from_numpy(v).to(p.device))


def material_state(b, frames=1):
    """(pipeline, state): `b` through auto_pipeline and pack_state, run
    `frames` frames in (so that velocities, stress and plastic state are the
    path's own)."""
    import sparkl_tpu_torch as sk

    pipe = sk.auto_pipeline(b)
    state = pipe.pack_state(b.particles)
    if frames:
        state, _ = pipe.run_frames_state(state, frames)
    return pipe, state


def phase_materials_kernels():
    """Kernels A and B in their material forms against their plain versions
    on the card, at full size, one frame in: materials3 (A's cache read, B's
    material instance), materials3-failure (A's fresh corotated and
    neo-Hookean stress, B's damage and material instance with the
    maximum-stress trip), materials2 and materials2-failure (the 2D forms);
    each also with F perturbed per model (MATERIALS_PERTURB) so that every
    NACC case, the Rankine and Snow maps and, in the failure forms, the
    maximum-stress trips occur (counted, each required over a form's two
    states); with times and bounds. Returns {config: {name: {...}}}."""
    import torch

    out = {}
    builders = (("materials3", lambda: materials3()),
                ("materials3-failure", lambda: materials3(failure=True)),
                ("materials2", lambda: materials2()),
                ("materials2-failure", lambda: materials2(failure=True)))
    for name, builder in builders:
        t0 = time.perf_counter()
        b = builder()
        pipe, state = material_state(b)
        dt = float(pipe._min_dtb(state))
        say(26, f"{name}: {int(b.particles.active.sum())} particles, {pipe._cfg}, grid "
                f"{b.grid.res}, one frame in, dt {dt:.3e}, live chunks "
                f"{int(state.structure.num_chunks)}, set-up {time.perf_counter() - t0:.1f} s")
        res = check_materials(pipe, state, dt, name, 26, timed=True)
        pres = check_materials(pipe, perturbed_by_model(state, MATERIALS_PERTURB[name]), dt,
                               f"{name} perturbed-F", 26)
        res["g2p_fused"]["perturbed"] = pres["g2p_fused"]
        res["p2g_fused"]["perturbed"] = pres["p2g_fused"]
        both = {k: v + pres["g2p_fused"]["counts"][k]
                for k, v in res["g2p_fused"]["counts"].items()}
        need = ["nacc_a_tip_max", "nacc_b_tip_min", "nacc_c_inside", "nacc_d_project",
                "nacc_hardened"]
        need += ["rankine_cap_largest"] if name.startswith("materials2") else [
            "rankine_cap_largest", "snow_below", "snow_above", "dp_flow"]
        if name.endswith("failure"):
            need.append("max_stress_trips")
        missing = [k for k in need if both[k] == 0]
        require(not missing, f"{name}: branches no lane took on its two states: {missing}")
        out[name] = res
        del pipe, state, b
        torch.cuda.empty_cache()
    return out


def phase_materials_agreement(name, phase=29):
    """Reduced materials3 or materials2 (MATERIALS3_SMALL, MATERIALS2_SMALL),
    from perturbed_particles (the reduced lattices start at rest in free
    fall, where no model would act), MATERIALS_AGREE_SUBSTEPS single
    substeps on the card against the port's CPU path taking the card's dt
    at every substep: |dx|, |dv|, |dF| and |d alpha| within MATERIALS_DX,
    _DV, _DF, _DA, phases and flags equal."""
    from dataclasses import replace
    import torch
    import sparkl_tpu_torch as sk

    build = materials3 if name == "materials3" else materials2
    small = MATERIALS3_SMALL if name == "materials3" else MATERIALS2_SMALL
    runs, dts = {}, []
    for dev in ("cuda", "cpu"):
        b = build(scale=small, device=dev)
        pipe = sk.auto_pipeline(replace(b, params=replace(b.params, stop_after_one_substep=True)),
                                device=dev)
        min_dtb = pipe._min_dtb
        if dev == "cuda":
            pipe._min_dtb = lambda st: dts.append(min_dtb(st)) or dts[-1]
        else:
            replay = iter([float(x) for x in dts])
            pipe._min_dtb = lambda st: torch.tensor(next(replay), dtype=torch.float32)
        state = pipe.pack_state(perturbed_particles(b.particles))
        ps = []
        for _ in range(MATERIALS_AGREE_SUBSTEPS):
            state, _ = pipe.run_frames_state(state, 1)
            ps.append(pipe.unpack_state(state).to("cpu"))
        runs[dev] = ps
    worst = dict(dx=0.0, dv=0.0, df=0.0, dalpha=0.0)
    for k, (a, c) in enumerate(zip(runs["cuda"], runs["cpu"])):
        act = c.active
        for key, fa, fc in (("dx", a.position, c.position), ("dv", a.velocity, c.velocity),
                            ("df", a.deformation_gradient, c.deformation_gradient),
                            ("dalpha", a.nacc_alpha, c.nacc_alpha)):
            worst[key] = max(worst[key], (fa[act] - fc[act]).abs().max().item())
        require(torch.equal(a.active, c.active) and torch.equal(a.failed[act], c.failed[act])
                and torch.equal(a.phase[act], c.phase[act]),
                f"reduced {name} substep {k + 1}: flags or phases differ")
    c = runs["cpu"][-1]
    moved = int((c.active & (c.nacc_alpha != -0.01)).sum())
    say(phase, f"reduced {name} ({int(c.active.sum())} particles), {MATERIALS_AGREE_SUBSTEPS} "
               f"substeps at the card's dts {[f'{float(x):.3e}' for x in dts]}, card against "
               f"CPU: max|dx| {worst['dx']:.3e} ({MATERIALS_DX:g}), max|dv| {worst['dv']:.3e} "
               f"({MATERIALS_DV:g}), max|dF| {worst['df']:.3e} ({MATERIALS_DF:g}), max|d alpha| "
               f"{worst['dalpha']:.3e} ({MATERIALS_DA:g}); flags and phases equal; NACC alpha "
               f"moved on {moved}")
    require(worst["dx"] <= MATERIALS_DX and worst["dv"] <= MATERIALS_DV
            and worst["df"] <= MATERIALS_DF and worst["dalpha"] <= MATERIALS_DA,
            f"reduced {name}: card and CPU disagree")
    return dict(worst, dts=[float(x) for x in dts], alpha_moved=moved)


# ---------------------------------------------------------------------------
# The block-sparse pipeline on the 2D scenes (phases 30-32)
# ---------------------------------------------------------------------------

# Substeps run before the window-kernel checks; frames of the main paths
# (elasticity2 and basic2 against the goldens, fluids2 as published and at
# the golden's n = 40, l_panel2); substeps of the card-against-CPU checks.
SPARSE2D_SUBSTEPS_IN = 20
SPARSE2D_FRAMES, SPARSE2D_TIMED = 6, 2
SPARSE2D_FLUIDS2_FRAMES, SPARSE2D_GOLDEN_FLUIDS2_FRAMES = 5, 10
SPARSE2D_LPANEL2_FRAMES = 2
SPARSE2D_AGREE_SUBSTEPS = 3
# Useful f32 operations per stencil tap of the 2D window kernels (9 taps a
# slot): P2G forms W, W_x and W_y (3 products) and adds the mass and 2
# momenta with their 2 affine terms each (2 + 2 x 6), the psi channels 4
# more; G2P forms the same 3 weights and adds v and 2 gradient terms per
# velocity channel (2 x 6), the psi channel 2 more. The 3D psi forms add 4
# (P2G, P2G3_PSI_TAP_FLOPS) and 2 (G2P) to the 3D taps.
WIN2_P2G_TAP_FLOPS, WIN2_G2P_TAP_FLOPS = 17, 15
WIN_PSI_P2G_TAP_FLOPS, WIN_PSI_G2P_TAP_FLOPS = 4, 2


def window_flops(dim, psi):
    """(P2G, G2P) f32 operations per stencil tap of the window kernels."""
    p2g, g2p = (WIN2_P2G_TAP_FLOPS, WIN2_G2P_TAP_FLOPS) if dim == 2 else (P2G_TAP_FLOPS,
                                                                         G2P_TAP_FLOPS)
    if psi:
        p2g, g2p = p2g + WIN_PSI_P2G_TAP_FLOPS, g2p + WIN_PSI_G2P_TAP_FLOPS
    return p2g, g2p


def window_bytes(dim, psi, d_, c):
    """(P2G, G2P) bytes each window kernel must move at D chunks: P2G reads
    the position, mass, velocity and affine rows (and the two psi rows) of
    the slot data and writes the image; G2P reads the position rows and the
    window and writes its rows."""
    rc = 8**dim
    n_in = 2 * dim + 1 + dim * dim + (2 if psi else 0)
    nf = 1 + dim + (2 if psi else 0)
    n_win = dim + (1 if psi else 0)
    return (d_ * (n_in * c + nf * rc) * 4,
            d_ * (dim * c + n_win * rc + (dim + dim * dim + (1 if psi else 0)) * c) * 4)


def check_windows(grid, cfg, slot_data, windows, path_psi, phase, label, timed=True, seed=5):
    """Both window kernels against their plain versions on a sparse path's
    inputs (3D or 2D): the path's form (`path_psi`) on its own inputs, and
    the other form, without the psi channels (the path's with them
    dropped) or with them (numpy-seeded psi rows and window channel);
    times of the path's form (20 CUDA-event-timed launches). In 2D also
    whether each kernel's output is bit-equal to its plain version on the
    CPU (the plain versions sum in the kernels' order there): required of
    the P2G image, reported of the gather.
    Returns {name: {max_abs_err, ms, plain_ms, library_ms, bytes, flops,
    bound_ms, bound_by, path, other}}."""
    import numpy as np
    import torch
    from sparkl_tpu_torch.ops import transfer_kernels as WK
    from sparkl_tpu_torch.scripts import median_ms

    dev = slot_data.device
    dim = grid.dim
    d_, _, c = slot_data.shape
    psi_row = 2 * dim + 1 + dim * dim
    valid = slot_data[:, dim, :] != 0.0  # the mass row; padded slots are zero
    n_valid = int(valid.sum())
    rng = np.random.default_rng(seed)
    res = {name: {} for name in SPARSE_KERNELS}
    inputs = {}
    for psi in (path_psi, not path_psi):
        sd, win = slot_data, windows
        if psi and not path_psi:
            sd = slot_data.clone()
            noise = rng.uniform(0.5, 1.5, size=(d_, 2, c)).astype(np.float32)
            sd[:, psi_row : psi_row + 2] = torch.from_numpy(noise).to(dev) * valid[:, None, :]
            extra = rng.normal(size=(d_, 1, 8**dim)).astype(np.float32)
            win = torch.cat([windows, torch.from_numpy(extra).to(dev)], dim=1)
        elif not psi:
            win = windows[:, :dim].contiguous()
        inputs[psi] = (sd, win)
        img_k = WK.p2g_windows(grid, cfg, sd, with_psi=psi)
        img_p = WK.p2g_windows_reference(grid, sd, psi)
        out_k = WK.g2p_windows(grid, cfg, sd, win, with_psi=psi)
        out_p = WK.g2p_windows_reference(grid, sd, win, psi)
        torch.cuda.synchronize()
        errs = {"p2g_windows": p2g_errors(img_k, img_p),
                "g2p_windows": g2p_window_errors(out_k, out_p, valid, win, grid.cell_width)}
        finite = torch.isfinite(img_k).all().item() and torch.isfinite(
            torch.where(valid[:, None, :], out_k, 0.0)).all().item()
        cpu_equal = {}
        if dim == 2:
            sd_c, win_c = sd.cpu(), win.cpu()
            cpu_equal = {
                "p2g_windows": torch.equal(img_k.cpu(), WK.p2g_windows_reference(grid, sd_c, psi)),
                "g2p_windows": torch.equal(
                    torch.where(valid[:, None, :], out_k, 0.0).cpu(),
                    torch.where(valid[:, None, :].cpu(),
                                WK.g2p_windows_reference(grid, sd_c, win_c, psi), 0.0))}
        for name, e in errs.items():
            res[name]["path" if psi == path_psi else "other"] = dict(
                with_psi=psi, max_abs_err=max(x for _, x in e),
                worst_over_bound=max(m for m, _ in e), cpu_bit_equal=cpu_equal.get(name))
            say(phase, f"{label} {name} with_psi={psi}: max|err| {max(x for _, x in e):.3e}; per "
                       f"{'channel' if name == 'p2g_windows' else 'row'} max|err|/bound "
                       f"{[f'{m:.2e}' for m, _ in e]} (pass <= 1)"
                       + (f"; bit-equal to its plain version on the CPU {cpu_equal[name]}"
                          if cpu_equal else ""))
        require(finite and all(m <= 1.0 for e in errs.values() for m, _ in e),
                f"{label}: a window kernel disagrees with its plain version (with_psi={psi})")
        # The 2D P2G plain version sums each cell's slots in the kernel's
        # walk order on the CPU: the same image to the bit.
        require(dim == 3 or cpu_equal["p2g_windows"],
                f"{label}: the 2D P2G window image differs from its plain version on the CPU "
                f"(with_psi={psi})")
    taps = 3**dim
    f_p2g, f_g2p = window_flops(dim, path_psi)
    b_p2g, b_g2p = window_bytes(dim, path_psi, d_, c)
    res["p2g_windows"].update(bytes=b_p2g, flops=n_valid * taps * f_p2g)
    res["g2p_windows"].update(bytes=b_g2p, flops=n_valid * taps * f_g2p)
    sd0, win0 = inputs[path_psi]
    if timed:
        res["p2g_windows"].update(
            ms=median_ms(lambda: WK.p2g_windows(grid, cfg, sd0, with_psi=path_psi)),
            plain_ms=median_ms(lambda: WK.p2g_windows_reference(grid, sd0, path_psi), reps=5))
        res["g2p_windows"].update(
            ms=median_ms(lambda: WK.g2p_windows(grid, cfg, sd0, win0, with_psi=path_psi)),
            plain_ms=median_ms(lambda: WK.g2p_windows_reference(grid, sd0, win0, path_psi),
                               reps=5))
        add_split(res["p2g_windows"], lambda: WK.p2g_windows(grid, cfg, sd0, with_psi=path_psi))
        add_split(res["g2p_windows"],
                  lambda: WK.g2p_windows(grid, cfg, sd0, win0, with_psi=path_psi))
    for name, v in res.items():
        v["max_abs_err"] = v["path"]["max_abs_err"]
        v["library_ms"] = None
        v["bound_ms"], v["bound_by"] = bound(v["bytes"], v["flops"])
        if timed:
            say(phase, f"{label} {name} (with_psi={path_psi}): kernel {v['ms']:.3f} ms, plain "
                       f"{v['plain_ms']:.3f} ms (batched medians); {v['bytes'] / 1e9:.4f} GB "
                       f"counted from shapes = {v['bytes'] / v['ms'] / 1e6:.1f} GB/s; bound "
                       f"{v['bound_ms']:.4f} ms ({v['bound_by']}); {d_} chunks, {n_valid} valid "
                       f"slots{split_text(v)}")
    return res


def sparse_inputs(b, substeps, merge_in=False):
    """The pipeline (on the bundle's device) and the window kernels' (and
    with `merge_in` the merge's) inputs (capture_window_inputs) of the
    substep after `substeps` single substeps of the sparse pipeline on
    bundle `b`."""
    from dataclasses import replace
    import sparkl_tpu_torch as sk

    pipe = sk.auto_pipeline(replace(b, params=replace(b.params, stop_after_one_substep=True)),
                            prefer="sparse", device=b.particles.device)
    p = b.particles
    for _ in range(substeps):
        p = pipe.step(p)
    return (pipe,) + capture_window_inputs(pipe, p, merge_in)


def phase_sparse2d_kernels(phase=30):
    """The window kernels' 2D forms (and the 3D psi forms) against their
    plain versions: elasticity2 and basic2 SPARSE2D_SUBSTEPS_IN substeps
    into the sparse path (their form without psi, and with seeded psi),
    l_panel2 as far in (its psi form, and without psi); timed on the
    250,000-particle block under basic2's models (without psi) and on
    l_panel2 at cell width 0.0025 (240,000 particles, with psi), and the
    3D psi forms on the reduced l_panel3's sparse path. Returns {label:
    check_windows result}."""
    import sparkl_tpu_torch.scenes as scenes

    out = {}
    cases = (("elasticity2", lambda: scenes.build("elasticity2"), SPARSE2D_SUBSTEPS_IN, False),
             ("basic2", lambda: scenes.build("basic2"), SPARSE2D_SUBSTEPS_IN, False),
             ("l_panel2", fracture_bundle, SPARSE2D_SUBSTEPS_IN, False),
             ("block", plastic_block, 3, True),
             ("l_panel2 fine", lambda: fracture_bundle(FRACTURE_FINE_CELL), 3, True),
             ("l_panel3 reduced", lambda: l_panel3(scale=LPANEL3_SMALL,
                                                   layers=LPANEL3_SMALL_LAYERS),
              SPARSE2D_SUBSTEPS_IN, True))
    for label, build, substeps, timed in cases:
        b = build()
        pipe, slot_data, windows, merge_in = sparse_inputs(b, substeps, merge_in=True)
        say(phase, f"{label}: {int(b.particles.active.sum())} particles, {pipe._cfg}, "
                   f"{substeps} substeps in, psi channels on the path {pipe._with_psi}")
        out[label] = check_windows(b.grid, pipe._cfg, slot_data, windows, pipe._with_psi,
                                   phase, label, timed=timed)
        structure, images, plan = merge_in
        out[label]["merge_scatter"] = check_merge(
            b.grid, pipe._cfg, structure, images, False, True, phase, f"sparse {label}",
            plan=plan, timed=timed, cpu=b.grid.dim == 2)
        del pipe, slot_data, windows, merge_in, b
    return out


def sparse_panel_stats(p):
    """[broken, failed] counts of the active particles of model ids 0 and 1
    (l_panel2's two panels)."""
    act = p.active
    return [[int((act & (p.model_id == m) & (p.phase == 0.0)).sum()),
             int((act & (p.model_id == m) & p.failed).sum())] for m in (0, 1)]


def golden_measures(p, rec):
    """A frame of particles `p` against its golden record: the worst of the
    centre of mass, box and kinetic energy over tests/test_regression.py's
    non-dense tolerances (pass <= 1), and the failed and broken counts of
    the active particles."""
    import torch

    act = p.active
    pos, vel = p.position[act].double(), p.velocity[act].double()
    ke = 0.5 * (p.mass[act].double()[:, None] * vel**2).sum().item()
    ratios = []
    for got, want, atol, rtol in ((pos.mean(0), rec["com"], 3e-3, 1e-3),
                                  (pos.min(0).values, rec["pos_min"], 8e-3, 1e-3),
                                  (pos.max(0).values, rec["pos_max"], 8e-3, 1e-3),
                                  (torch.tensor([ke]), [rec["ke"]], 1e-8, 3e-2)):
        want = torch.tensor(want, dtype=torch.float64)
        ratios.append(((got.cpu() - want).abs() / (atol + rtol * want.abs())).max().item())
    return max(ratios), int(p.failed[act].sum()), int((p.phase[act] == 0.0).sum()), ke


def phase_sparse_main(b, frames, timed_frames, phase, gold=None, profile=None):
    """A sparse main path: bundle `b` -> auto_pipeline(prefer="sparse") ->
    step_with_stats per frame, the last `timed_frames` through run_frames
    and timed (each frame clocked alone), with the window kernels' launches
    held against the substeps run (the scatter merge once more per fluid
    volume pass) and every launch in the path's form (the grid's dimension,
    with the psi channels exactly when the path carries them); per frame
    the substeps, the mass held to 1e-6 (net of deactivated particles),
    the broken and failed counts of model ids 0 and 1 (l_panel2's panels),
    and with `gold` (the golden's frame records) the golden statistics
    within tests/test_regression.py's non-dense tolerances. With `profile`, one
    more frame under torch.profiler written there. Returns (pipeline,
    particles, launches, results)."""
    import torch
    import sparkl_tpu_torch as sk
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.ops import transfer_kernels as WK

    label = b.name
    n_active = int(b.particles.active.sum())
    act0 = b.particles.active
    mass0 = b.particles.mass[act0].double().sum().item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pipe = sk.auto_pipeline(b, prefer="sparse")
    require(isinstance(pipe, sk.SparseMpmPipeline), f"{label}: not the sparse pipeline")
    ran = dict(substeps=0, passes=0)
    substep, fluid_pass = pipe._substep, pipe._recompute_fluids_sparse

    def counted(*a):
        ran["substeps"] += 1
        return substep(*a)

    def counted_pass(*a):
        ran["passes"] += 1
        return fluid_pass(*a)

    forms = {}
    p2g, g2p = WK.p2g_windows, WK.g2p_windows

    def spy_p2g(grid, cfg, slot_data, with_psi=True):
        key = ("p2g_windows", grid.dim, with_psi)
        forms[key] = forms.get(key, 0) + 1
        return p2g(grid, cfg, slot_data, with_psi=with_psi)

    def spy_g2p(grid, cfg, slot_data, windows, with_psi=True):
        key = ("g2p_windows", grid.dim, with_psi)
        forms[key] = forms.get(key, 0) + 1
        return g2p(grid, cfg, slot_data, windows, with_psi=with_psi)

    pipe._substep, pipe._recompute_fluids_sparse = counted, counted_pass
    WK.p2g_windows, WK.g2p_windows = spy_p2g, spy_g2p
    WK.reset_launch_counts()
    K.reset_launch_counts()
    p = b.particles
    substeps = timed = 0
    seconds, worst = 0.0, 0.0
    out_frames = []
    try:
        for i in range(frames):
            if i >= frames - timed_frames:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, n = pipe.run_frames(p, 1)
                torch.cuda.synchronize()
                seconds += time.perf_counter() - t0
                timed += n
            else:
                p, n = pipe.step_with_stats(p)
            substeps += n
            act = p.active
            deact = b.particles.mass[act0 & ~act].double().sum().item()
            mass = p.mass[act].double().sum().item()
            fr = dict(frame=i, substeps=n, mass=mass, per_panel=sparse_panel_stats(p))
            out_frames.append(fr)
            require(abs(mass - (mass0 - deact)) <= 1e-6 * mass0,
                    f"{label} frame {i}: mass {mass} against {mass0 - deact}")
            if gold is None:
                continue
            rec = gold[i]
            measure, failed, broken, _ = golden_measures(p, rec)
            slack = max(2, int(0.02 * n_active))
            fr.update(golden_substeps=rec["substeps"], worst_over_tol=measure)
            worst = max(worst, measure)
            require(abs(n - rec["substeps"]) <= 1 and measure <= 1.0
                    and abs(failed - rec["failed"]) <= slack
                    and abs(broken - rec["broken"]) <= slack,
                    f"{label} frame {i} against the golden: {fr}")
    finally:
        pipe._substep, pipe._recompute_fluids_sparse = substep, fluid_pass
        WK.p2g_windows, WK.g2p_windows = p2g, g2p
    launches = dict(WK.LAUNCHES, merge_scatter=K.LAUNCHES["merge_scatter"])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    act = p.active
    pups = n_active * timed / seconds if timed else None
    for fr in out_frames:
        say(phase, f"{label} sparse frame {fr['frame']}: " + ", ".join(
            f"{k} {v}" for k, v in fr.items() if k != "frame"))
    against = (f"frames 0-{frames - 1} against the golden: worst measure/tol {worst:.3e}; "
               if gold else "")
    rate = (f"last {timed_frames} frames {timed} substeps in {seconds:.3f} s = {pups:.4g} "
            f"particle-updates/s; " if timed else "")
    say(phase, f"{label} sparse path, {frames} frames, {n_active} particles: {substeps} "
               f"substeps, {ran['substeps']} run, {ran['passes']} volume passes; {against}{rate}"
               f"{pipe._cfg}; eigenerosion buckets {pipe._eigen_k} deep, regrown "
               f"{pipe.eigen_regrows} times; peak memory {peak_gib:.2f} GiB; launches "
               f"{launches}; forms {forms}")
    require(bool(torch.isfinite(p.position[act]).all()), f"{label} sparse path: non-finite "
                                                         f"positions")
    require(ran["substeps"] >= substeps and (ran["substeps"] == substeps
                                             or pipe.eigen_regrows > 0),
            f"{label}: ran {ran['substeps']} substeps for {substeps} kept, with no regrow")
    expect = dict(p2g_windows=ran["substeps"], g2p_windows=ran["substeps"],
                  merge_scatter=ran["substeps"] + ran["passes"])
    require(launches == expect, f"{label} sparse path launch counts {launches}, expected "
                                f"{expect}")
    dim, psi = b.grid.dim, pipe._with_psi
    require(forms == {("p2g_windows", dim, psi): ran["substeps"],
                      ("g2p_windows", dim, psi): ran["substeps"]},
            f"{label}: window kernel forms {forms}, expected {dim}D with_psi={psi} only")
    res = dict(particles=n_active, substeps=substeps, substeps_run=ran["substeps"],
               volume_passes=ran["passes"], timed_substeps=timed, seconds=seconds, pups=pups,
               peak_gib=peak_gib, worst_over_tol=worst if gold else None, with_psi=psi,
               frames=out_frames, eigen_regrows=pipe.eigen_regrows, config=str(pipe._cfg))
    if profile:
        res["profile"] = profile_sparse_frame(pipe, p, profile, phase)
    return pipe, p, launches, res


def golden_frames(name, **kw):
    """tests/golden_scenes.json's frame records of `name`, whose
    configuration must be `kw`."""
    import json as _json

    with open(os.path.join(HERE, "tests", "golden_scenes.json")) as fh:
        rec = _json.load(fh)[name]
    require(rec["config"] == kw, f"{name}: the golden's configuration is {rec['config']}")
    return rec["frames"]


def phase_sparse2d_paths(phase=31):
    """The four 2D sparse main paths at their published sizes (elasticity2
    and basic2 SPARSE2D_FRAMES frames against the goldens, fluids2 as
    published and at the golden's n = 40, l_panel2 with its per-panel
    counts beside the fused path's over the same frames), one profiled
    elasticity2 frame. Returns (launches per path, results per path)."""
    from dataclasses import replace
    import sparkl_tpu_torch.scenes as scenes

    launches, res = {}, {}
    for label, build, frames, timed, gold, profile in (
            ("elasticity2", lambda: scenes.build("elasticity2"), SPARSE2D_FRAMES,
             SPARSE2D_TIMED, golden_frames("elasticity2"), "sparse2d_profile.txt"),
            ("basic2", lambda: scenes.build("basic2"), SPARSE2D_FRAMES, SPARSE2D_TIMED,
             golden_frames("basic2"), None),
            ("fluids2", lambda: scenes.build("fluids2"), SPARSE2D_FLUIDS2_FRAMES,
             SPARSE2D_TIMED, None, None),
            ("fluids2-n40", lambda: scenes.build("fluids2", n=40),
             SPARSE2D_GOLDEN_FLUIDS2_FRAMES, 0, golden_frames("fluids2", n=40), None),
            ("l_panel2", fracture_bundle, SPARSE2D_LPANEL2_FRAMES, 1, None, None)):
        b = replace(build(), name=label)
        _, _, launches[label], res[label] = phase_sparse_main(b, frames, timed, phase, gold,
                                                              profile)
    fpipe, fstate, _, fused = phase_damage_main(fracture_bundle(), SPARSE2D_LPANEL2_FRAMES, 0,
                                                phase)
    del fpipe, fstate
    sparse = [fr["per_panel"] for fr in res["l_panel2"]["frames"]]
    fused_per = [fr["per_model"] for fr in fused["frames"]]
    say(phase, f"l_panel2 per frame [broken, failed] per panel, sparse {sparse}, fused "
               f"{fused_per}; substeps sparse "
               f"{[fr['substeps'] for fr in res['l_panel2']['frames']]}, fused "
               f"{[fr['substeps'] for fr in fused['frames']]}")
    res["l_panel2"]["fused_per_panel"] = fused_per
    return launches, res


def stress_ties(models, p_in, p_out):
    """Particles of a maximum-stress model whose largest principal stress,
    from p_out's F at p_in's phase, lies within TIE of the envelope."""
    import torch
    from sparkl_tpu_torch.models import registry as reg

    st = reg.kirchhoff_stress(models, p_in.model_id, p_in.phase, p_in.elastic_hardening,
                              p_out.deformation_gradient, p_out.velocity_gradient, p_in.mass,
                              p_in.volume0)
    emax = torch.linalg.eigvalsh(0.5 * (st + st.transpose(1, 2)).double())[:, -1]
    mp = models.fparams[p_in.model_id.long(), 0].double()
    failing = models.ftype[p_in.model_id.long()] != 0
    return failing & ((emax - mp).abs() <= TIE * mp.abs())


def sparse_trip_ties(pipe, p_in, p_out, psi=None):
    """Particles whose trip decision in the sparse substep from p_in to p_out
    lies within TIE of its threshold, on the pipeline's device: the
    eigenerosion energy pooled from p_in (eigenerosion), the crack energy of
    the gathered psi (modified eigenerosion; `psi` [N]), and the largest
    principal stress (stress_ties)."""
    from sparkl_tpu_torch.core.params import DamageModel
    from sparkl_tpu_torch.solver import dense
    from sparkl_tpu_torch.solver.eigenerosion import evolve_eigenerosion

    grid, dm = pipe.grid, pipe.params.damage_model
    tie = stress_ties(pipe.models, p_in, p_out)
    cthr = p_in.crack_threshold
    if dm == DamageModel.EIGENEROSION:
        energy = evolve_eigenerosion(grid, dense.mark_out_of_grid_failed(grid, p_in),
                                     pipe._eigen_k)[0].parameter1
        tie = tie | ((p_in.crack_propagation_factor != 0)
                     & ((energy - cthr).abs() <= TIE * cthr.abs()))
    if dm == DamageModel.MODIFIED_EIGENEROSION:
        energy = p_in.crack_propagation_factor * grid.cell_width * psi
        tie = tie | ((energy - cthr).abs() <= TIE * cthr.abs())
    return tie


def phase_sparse2d_agreement(phase=32):
    """The sparse path card against CPU: elasticity2, basic2, fluids2 at the
    golden's n = 40, l_panel2, fluids3 as published (3D, the volume pass)
    and the reduced l_panel3 (3D psi forms and the bucket pooling),
    SPARSE2D_AGREE_SUBSTEPS single substeps each, the CPU taking the
    card's dt at every substep (the EOS bound turns on J's last bits): the
    JAX package's fused-vs-dense tolerances on x, v and F, flags equal, the
    phase equal but on particles whose trip decision in some substep lay
    within TIE of its threshold (sparse_trip_ties); then one frame of each
    2D scene as published run twice on the card, bit-equal in every
    particle field. Returns {name: results}."""
    from dataclasses import replace
    import torch
    import sparkl_tpu_torch as sk
    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch import interop
    from sparkl_tpu_torch.solver import dense

    cases = (("elasticity2", lambda dev: scenes.build("elasticity2", device=dev)),
             ("basic2", lambda dev: scenes.build("basic2", device=dev)),
             ("fluids2(n=40)", lambda dev: scenes.build("fluids2", n=40, device=dev)),
             ("l_panel2", lambda dev: fracture_bundle(device=dev)),
             ("fluids3", lambda dev: scenes.build("fluids3", device=dev)),
             ("l_panel3 reduced", lambda dev: l_panel3(scale=LPANEL3_SMALL,
                                                       layers=LPANEL3_SMALL_LAYERS, device=dev)))
    adaptive = dense.adaptive_timestep
    out = {}
    for name, build in cases:
        runs, dts = {}, []
        for dev in ("cuda", "cpu"):
            b = build(dev)
            pipe = sk.auto_pipeline(replace(b, params=replace(b.params,
                                                              stop_after_one_substep=True)),
                                    prefer="sparse", device=dev)
            if dev == "cuda":
                dense.adaptive_timestep = lambda *a: dts.append(adaptive(*a)) or dts[-1]
            else:
                replay = iter([float(x) for x in dts])
                dense.adaptive_timestep = lambda *a: torch.tensor(next(replay),
                                                                  dtype=torch.float32)
            try:
                ps = [b.particles.to("cpu")]
                p = b.particles
                for _ in range(SPARSE2D_AGREE_SUBSTEPS):
                    p = pipe.step(p)
                    ps.append(p.to("cpu"))
            finally:
                dense.adaptive_timestep = adaptive
            runs[dev] = (pipe, ps)
        cpipe, pc = runs["cpu"]
        pg = runs["cuda"][1]
        ties = torch.zeros_like(pc[0].active)
        worst = dict(dx=0.0, dv=0.0, df=0.0)
        mismatch = net = 0
        for k in range(1, SPARSE2D_AGREE_SUBSTEPS + 1):
            a, c = pg[k], pc[k]
            act = c.active
            for key, fa, fc in (("dx", a.position, c.position), ("dv", a.velocity, c.velocity),
                                ("df", a.deformation_gradient, c.deformation_gradient)):
                worst[key] = max(worst[key], (fa[act] - fc[act]).abs().max().item())
            ties = ties | sparse_trip_ties(cpipe, pc[k - 1], c)
            differ = act & (a.phase != c.phase)
            mismatch = int(differ.sum())
            net = int((differ & ~ties).sum())
            require(torch.equal(a.active, c.active) and torch.equal(a.failed[act], c.failed[act]),
                    f"{name} substep {k}: active or failed flags differ, card against CPU")
        act = pc[-1].active
        say(phase, f"{name} ({int(act.sum())} particles, sparse), {SPARSE2D_AGREE_SUBSTEPS} "
                   f"substeps at the card's dts {[f'{float(x):.3e}' for x in dts]}, card "
                   f"against CPU: max|dx| {worst['dx']:.3e} ({FRACTURE_DX:g}), max|dv| "
                   f"{worst['dv']:.3e} ({FRACTURE_DV:g}; max|v| "
                   f"{pc[-1].velocity[act].abs().max().item():.4f}), max|dF| {worst['df']:.3e} "
                   f"({FRACTURE_DF:g}); phase differing {mismatch}, net of {int(ties.sum())} tie "
                   f"particles {net}")
        require(net == 0, f"{name}: card and CPU phases differ off the ties")
        require(worst["dx"] <= FRACTURE_DX and worst["dv"] <= FRACTURE_DV
                and worst["df"] <= FRACTURE_DF, f"{name}: card and CPU disagree (sparse)")
        out[name] = dict(worst, phase_differ=mismatch, phase_differ_net_of_ties=net,
                         dts=[float(x) for x in dts])
    for name in ("elasticity2", "basic2", "fluids2", "l_panel2"):
        runs = []
        for _ in range(2):
            b = scenes.build(name)
            p, n = sk.auto_pipeline(b, prefer="sparse").step_with_stats(b.particles)
            runs.append((interop.particles_to_numpy(p), n))
        (a, na), (a2, na2) = runs
        differ = [k for k in a if not (a[k] == a2[k]).all()]
        say(phase, f"{name} one sparse frame twice on the card: substeps {na}/{na2}, bit-equal "
                   f"in every particle field {not differ} (differ: {differ})")
        require(not differ and na == na2, f"two sparse card frames of {name} differ in {differ}")
        out.setdefault(name, {})["repeat_bit_equal"] = not differ
    return out


def max_ulps(a, b):
    """Largest distance between a and b in f32 units in the last place."""
    import torch

    def key(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i >= 0, i, -(i & 0x7FFFFFFF))

    return int((key(a) - key(b)).abs().max())


def chain_registers(log):
    """{(R, exp kind): (registers, spill bytes stored + loaded)} of each
    chain_kernel instance, from the build's ptxas -v log."""
    import re

    out = {}
    for entry in log.split("Compiling entry function")[1:]:
        m = re.search(r"chain_kernelILi(\d+)ELb([01])E", entry.splitlines()[0])
        if not m:
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
        require(regs and spill, f"no ptxas register line for {m.group(0)}")
        out[(int(m.group(1)), m.group(2) == "1")] = (
            int(regs.group(1)), int(spill.group(1)) + int(spill.group(2)))
    return out


def phase_probes(log, phase=33):
    """The probes' kernels against their plain versions at the published
    sizes, then both sweeps through the probes' main(), with times, bounds
    and the chain instances' registers. Returns {name: {max_abs_err, ms,
    plain_ms, bound_ms, bound_by, library_ms, launches, forms}}."""
    import torch
    from sparkl_tpu_torch.scripts import layout_probe as LP
    from sparkl_tpu_torch.scripts import median_ms
    from sparkl_tpu_torch.scripts import vreg_probe as VP

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(33)
    failures = []

    # Row 12: every R against one plain chain per kind (the chain's values
    # do not depend on R), on seeded input in [-2, 2).
    regs = chain_registers(log)
    require(sorted(regs) == sorted((r, e) for r in VP.ROWS for e in (False, True)),
            f"ptxas lines for the chain instances: {sorted(regs)}")
    x = (torch.rand((VP.TOTAL_ROWS, VP.C), generator=gen) * 4.0 - 2.0).to(dev)
    chain_forms = {}
    for transcend in (False, True):
        kind = "exp" if transcend else "fma"
        plain = VP.chain_plain(x, VP.N_OPS, transcend)
        for r in VP.ROWS:
            y = VP.chain(x, r, VP.N_OPS, transcend)
            torch.cuda.synchronize()
            err, ulps = (y - plain).abs().max().item(), max_ulps(y, plain)
            n_reg, n_spill = regs[(r, transcend)]
            chain_forms[f"{kind} R={r}"] = dict(max_abs_err=err, max_ulps=ulps,
                                                registers=n_reg, spill_bytes=n_spill)
            say(phase, f"chain {kind} R={r}: max|err| {err:.3e}, {ulps} ulps; {n_reg} "
                       f"registers, {n_spill} bytes spilled")
            if not torch.isfinite(y).all().item() or ulps > (EXP_CHAIN_ULPS if transcend else 0):
                failures.append(f"chain {kind} R={r}: {ulps} ulps from its plain version")
    del x, y, plain

    # Rows 13-14: both layouts hold the same values, so the two read kernels
    # (and the two written tensors, transposed) must agree with each other too.
    xc = torch.randn((LP.D, LP.NF, LP.C), generator=gen).to(dev)
    xf = xc.transpose(0, 1).contiguous()
    layout_out = {}
    for name, kernel, plain, x_, fm in (
            ("read chunk-major", LP.read_chunk_major, LP.read_plain, xc, False),
            ("read field-major", LP.read_field_major, LP.read_plain, xf, True),
            ("rw chunk-major", LP.rw_chunk_major, LP.rw_plain, xc, False),
            ("rw field-major", LP.rw_field_major, LP.rw_plain, xf, True)):
        y, p = kernel(x_), plain(x_, fm)
        torch.cuda.synchronize()
        err = (y - p).abs().max().item()
        say(phase, f"{name} {tuple(y.shape)}: bit-equal {torch.equal(y, p)}, max|err| {err:.3e}")
        if not torch.equal(y, p):
            failures.append(f"{name} is not bit-equal to its plain version")
        layout_out[name] = (y, err)
    same = (torch.equal(layout_out["read chunk-major"][0], layout_out["read field-major"][0])
            and torch.equal(layout_out["rw chunk-major"][0].transpose(0, 1),
                            layout_out["rw field-major"][0]))
    say(phase, f"chunk-major and field-major kernels agree bit for bit: {same}")
    if not same:
        failures.append("the two layouts' kernels differ")
    require(not failures, "; ".join(failures))

    # The sweeps: the probes' own entry points, which print the TPU scripts'
    # tables; their launches are the kernels' counts.
    VP.reset_launch_counts()
    LP.reset_launch_counts()
    chain_ms = VP.main()
    layout_ms = LP.main()
    launches = dict(VP.LAUNCHES, **LP.LAUNCHES)
    say(phase, f"launches from the sweeps {launches}")
    require(all(launches[k] > 0 for k in PROBES), f"probe kernels never launched: {launches}")

    # Plain and library times, bounds. The chain's plain version takes about
    # a quarter of a second: 3 single calls, where a batch hides nothing.
    ones = torch.ones((VP.TOTAL_ROWS, VP.C), dtype=torch.float32, device=dev)
    elems = VP.TOTAL_ROWS * VP.C
    for transcend in (False, True):
        kind = "exp" if transcend else "fma"
        plain_ms = median_ms(lambda: VP.chain_plain(ones, VP.N_OPS, transcend), reps=3,
                             batch=1)
        flops = (EXP_STEP_FLOPS * (VP.N_OPS // 16) if transcend else 2 * VP.N_OPS) * elems
        b_ms, b_by = bound(2 * 4 * elems, flops)
        for r in VP.ROWS:
            f = chain_forms[f"{kind} R={r}"]
            f.update(ms=chain_ms[(f"{kind}-chain", r)], plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None, bytes=2 * 4 * elems, flops=flops)
            add_split(f, lambda: VP.chain(ones, r, VP.N_OPS, transcend))
        say(phase, f"chain {kind}: {flops:.4g} operations, bound {b_ms:.4f} ms ({b_by}); plain "
                   f"{plain_ms:.3f} ms; kernel " + ", ".join(
                       f"R={r} {chain_forms[f'{kind} R={r}']['ms']:.4f}" for r in VP.ROWS))
    w = LP.weights(dev)
    rows_c, rows_f = xc[:, :LP.NROWS], xf[:LP.NROWS]
    d, c, n = LP.D, LP.C, LP.NROWS
    layout_forms = {}
    for name, x_, fm, key, kernel, lib in (
            ("read chunk-major", xc, False, "chunk-major [D,NF,C]", LP.read_chunk_major,
             lambda: torch.einsum("dkc,k->dc", rows_c, w)),
            ("read field-major", xf, True, "field-major [NF,D,C]", LP.read_field_major,
             lambda: torch.einsum("kdc,k->dc", rows_f, w)),
            ("rw chunk-major", xc, False, "r+w chunk-major", LP.rw_chunk_major,
             lambda: torch.mul(rows_c, LP.RW_SCALE)),
            ("rw field-major", xf, True, "r+w field-major", LP.rw_field_major,
             lambda: torch.mul(rows_f, LP.RW_SCALE))):
        rw = name.startswith("rw")
        plain = LP.rw_plain if rw else LP.read_plain
        nbytes = 2 * d * n * c * 4 if rw else d * n * c * 4 + d * c * 4
        flops = d * n * c if rw else 2 * d * n * c
        b_ms, b_by = bound(nbytes, flops)
        lib_err = (lib() - layout_out[name][0]).abs().max().item()
        layout_forms[name] = dict(
            max_abs_err=layout_out[name][1], ms=layout_ms[key],
            plain_ms=median_ms(lambda: plain(x_, fm), reps=5),
            bound_ms=b_ms, bound_by=b_by, library_ms=median_ms(lib), library_err=lib_err,
            bytes=nbytes, flops=flops)
        v = add_split(layout_forms[name], lambda: kernel(x_), lib)
        say(phase, f"{name}: kernel {v['ms']:.4f} ms = {nbytes / v['ms'] / 1e9:.3f} TB/s, plain "
                   f"{v['plain_ms']:.3f}, library {v['library_ms']:.4f} (max|diff| {lib_err:.2e}), "
                   f"bound {b_ms:.4f} ms ({b_by}){split_text(v)}")
    del xc, xf, layout_out

    def row(forms, main_form, count):
        top = forms[main_form]
        return dict(max_abs_err=max(f["max_abs_err"] for f in forms.values()),
                    **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms", "device_ms", "host_us",
                                           "library_device_ms", "library_host_us")
                       if k in top},
                    launches=count, forms={k: v for k, v in forms.items() if k != main_form})

    return {
        "vreg_chain": row(chain_forms, "fma R=8", launches["vreg_chain"]),
        "layout_read": row({k[5:]: v for k, v in layout_forms.items() if k.startswith("read")},
                           "chunk-major", launches["layout_read"]),
        "layout_rw": row({k[3:]: v for k, v in layout_forms.items() if k.startswith("rw")},
                         "chunk-major", launches["layout_rw"]),
    }


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

    from dataclasses import replace
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
                  permute_slots=branches["mixed"], eigen_pool_fused=0, eigen_boxes=0,
                  permute_chunks=0)
    require(launches == expect, f"launch counts {launches}, expected {expect}")
    missing = [k for k in K.LAUNCHES if PATH_OF[k] == "fused" and launches[k] == 0]
    require(not missing, f"kernels the main path never launched: {missing}")
    com = p.position[act].mean(0).tolist()
    say(4, f"mass {mass:.6e} (initial {mass0:.6e}, deactivated {deact:.3e}); "
           f"centre of mass {[round(x, 4) for x in com]}")
    # One more frame of the path, profiled (its launches are not counted).
    state, fused_profile = profile_frame(pipe, state, "sand3_profile.txt", 4, "fused sand3@1M")
    # The merge stage of that state, one CUDA kernel in both forms.
    _, min_dtb = pipe._probe(state)
    img = K.p2g_fused(b.grid, pipe._cfg, pipe._meta, state.slots, state.ints, float(min_dtb),
                      state.structure.num_chunks, (pipe._tab_f, pipe._tab_i))
    for scatter in (False, True):
        check_merge(b.grid, pipe._cfg, state.structure, img, True, scatter, 4, "landed sand3@1M",
                    plan=state.grid_cache[2], owner=state.grid_cache[4], timed=False,
                    profiled=True)
    del img

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
    slot_data, windows, (structure, images, plan) = capture_window_inputs(spipe, p1, True)
    kres.update(check_windows(b.grid, spipe._cfg, slot_data, windows, False, 6, "sand3@1M"))
    sparse_merge = check_merge(b.grid, spipe._cfg, structure, images, False, True, 6,
                               "sparse sand3@1M", plan=plan)
    del spipe, p1, slot_data, windows, structure, images, plan

    # 7. The sparse main path, then one profiled frame.
    _, _, sparse_launches, sparse_res = phase_sparse_main(
        replace(b, name="sand3@1M"), SPARSE_FRAMES, SPARSE_TIMED, 7,
        profile="sparse_profile.txt")

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
                                 sand3=kres["merge_scatter"], sparse=sparse_merge)
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
    kres["eigen_boxes"] = ref["eigen_boxes"]

    # 13. The l_panel2 main path; one profiled frame; on to the first
    # resort, and the candidates and the pooling after it.
    frpipe, frstate, fracture_launches, fracture_res["main"] = phase_damage_main(
        fracture_bundle(), FRACTURE_FRAMES, FRACTURE_TIMED, 13)
    frstate, fracture_res["profile"] = profile_frame(frpipe, frstate, "fracture_profile.txt", 13,
                                                     "fracture")
    fracture_res["first_resort"] = phase_fracture_first_resort(frpipe, frstate)
    missing = [k for k in ("eigen_pool_fused", "eigen_boxes", "p2g_fused", "g2p_fused") if
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
        l_panel3(load_speed=LPANEL3_LOAD_SPEED), LPANEL3_FRAMES, LPANEL3_TIMED, 23)
    _, damage_res["profile"] = profile_frame(l3pipe, l3state, "lpanel3_profile.txt", 23,
                                             "l_panel3")
    del l3pipe, l3state
    forms3 = ("p2g_fused", "g2p_fused", "eigen_pool_fused", "eigen_boxes")
    missing = [k for k in forms3 if lp3_launches[k] == 0]
    require(not missing, f"kernels the l_panel3 path never launched: {missing}")
    # The eigenerosion panel (model 0, no failure model: every phase 0 there
    # is an eigenerosion trip) must break on the main path.
    trips = damage_res["l_panel3"]["per_model"][0][0]
    say(23, f"l_panel3 main path: {trips} eigenerosion trips (panel 0 broken)")
    require(trips > 0, "l_panel3's main path took no eigenerosion trip")

    # 24. Reduced l_panel3, card against CPU.
    damage_res["agreement"] = phase_lpanel3_agreement()

    # 25. l_panel3 and l_panel2 under modified eigenerosion: kernel B's
    # crack-energy trip on a main path, no pooling.
    mod_launches = {}
    for name, b, frames in (("l_panel3-modified",
                             l_panel3("modified", load_speed=LPANEL3_LOAD_SPEED),
                             LPANEL3_MODIFIED_FRAMES),
                            ("l_panel2-modified", l_panel2_modified(), 1)):
        mpipe, _, mod_launches[name], damage_res[name] = phase_damage_main(b, frames, 1, 25)
        require(mod_launches[name]["g2p_fused"] > 0 and
                mod_launches[name]["eigen_pool_fused"] == mod_launches[name]["eigen_boxes"] == 0,
                f"{name}: kernel B not launched, or the pooling launched")
        del mpipe, b

    # 26. The material forms of kernels A and B against their plain
    # versions at full size (materials3, materials2 and their failure forms).
    mat_res = {"kernels": phase_materials_kernels()}

    # 27. The materials3 main path, 20 frames (Rankine flow from about
    # frame 16 on); one profiled frame.
    mpipe, mstate, mat_launches, mat_res["materials3"] = phase_damage_main(
        materials3(), MATERIALS3_FRAMES, MATERIALS3_TIMED, 27, stats=materials_stats)
    _, mat_res["profile"] = profile_frame(mpipe, mstate, "materials3_profile.txt", 27,
                                          "materials3")
    mat_launches = {"materials3": mat_launches}
    del mpipe, mstate
    rankine = mat_res["materials3"]["per_model"][1]["plastic"]
    say(27, f"materials3 main path: {rankine} Rankine lanes with plastic flow")
    require(rankine > 0, "materials3's main path took no Rankine flow")

    # 28. materials2 (3 frames), materials3-failure (MATERIALS3_FAILURE_FRAMES:
    # the lower lattice lands and trips maximum stress from frame 2 on) and
    # materials2-failure (a frame) as main paths: the damage and material
    # instances launched every substep.
    for name, b, frames in (("materials2", materials2(), MATERIALS2_FRAMES),
                            ("materials3-failure", materials3(failure=True),
                             MATERIALS3_FAILURE_FRAMES),
                            ("materials2-failure", materials2(failure=True), 1)):
        mpipe, _, mat_launches[name], mat_res[name] = phase_damage_main(
            b, frames, 1, 28, stats=materials_stats)
        del mpipe, b
    for name, ml in mat_launches.items():
        missing = [k for k in ("p2g_fused", "g2p_fused") if ml[k] == 0]
        require(not missing, f"kernels the {name} path never launched: {missing}")
    # The lower lattice (model 4) alone fails by maximum stress.
    trips = mat_res["materials3-failure"]["per_model"][4]["broken"]
    say(28, f"materials3-failure main path: {trips} maximum-stress trips")
    require(trips > 0, "materials3-failure's main path took no maximum-stress trip")

    # 29. Reduced materials3 and materials2, card against CPU.
    for name in ("materials3", "materials2"):
        mat_res[name]["agreement"] = phase_materials_agreement(name)

    # 30. The window kernels' 2D forms (and 3D psi forms) against their
    # plain versions; timed on the 250,000-particle block and l_panel2 fine.
    sparse2d_res = {"kernels": phase_sparse2d_kernels()}

    # 31. The four 2D sparse main paths at published size; one profiled
    # elasticity2 frame.
    sparse2d_launches, paths = phase_sparse2d_paths()
    sparse2d_res.update(paths)

    # 32. The sparse path card against CPU (2D, fluids3, reduced l_panel3),
    # and card against card.
    sparse2d_res["agreement"] = phase_sparse2d_agreement()

    # 33. The probes: each kernel against its plain version at the published
    # sizes, then both sweeps (their tables), times, bounds and registers.
    kres.update(phase_probes(log))

    # Each merge form's stage seen under torch.profiler at least once.
    seen = {f: sum(p["events"] for p in MERGE_PROFILES if p["form"] == f)
            for f in ("merge_blocks", "merge_scatter")}
    say(33, f"merge stages under torch.profiler: {len(MERGE_PROFILES)} sessions, device "
            f"events seen per form {seen} (each the form's kernel)")
    require(all(seen.values()), f"a merge form never seen under torch.profiler: {seen}")

    by_path = dict(fused=launches, sparse=sparse_launches, fluid=fluid_launches,
                   fracture=fracture_launches, elasticity2=plastic_launches["elasticity2"],
                   basic2=plastic_launches["basic2"], fluids2=fluid2_launches)
    launches = {name: by_path[PATH_OF[name]][name] if PATH_OF[name] else
                kres[name]["launches"] for name in REPLACES}
    missing = [k for k in REPLACES if launches[k] == 0]
    require(not missing, f"kernels their main paths (or checks) never launched: {missing}")

    # 34. Results. The 2D fluid forms of four kernels carry their own
    # numbers (the fluids2 path's launches, times on the 2D column), and so
    # do the damage forms, the material forms (their paths' launches, times
    # at their size) and the window kernels' 2D forms (the 2D sparse paths'
    # launches, times on the block and on l_panel2 fine).
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "host_us", "library_device_ms", "library_host_us")
    # The pooling's bound beside the bytes alone and all pairs tested.
    extra = ("byte_bound_ms", "all_pairs_bound_ms")
    block = fluid2_res["kernels"]["fluids2 block"]
    dk = damage_res["kernels"]
    forms_of = {name: {} for name in REPLACES}
    for name in forms:
        forms_of[name]["fluids2"] = dict(launches=fluid2_launches[name],
                                         **{k: block[name].get(k) for k in keys})
    for name in forms3:
        forms_of[name]["l_panel3"] = dict(launches=lp3_launches[name],
                                          **{k: dk["l_panel3"][name].get(k) for k in keys},
                                          **{k: dk["l_panel3"][name][k] for k in extra
                                             if k in dk["l_panel3"][name]})
    for label in ("l_panel3-modified", "l_panel2-modified"):
        forms_of["g2p_fused"][label] = dict(launches=mod_launches[label]["g2p_fused"],
                                            **{k: dk[label]["g2p_fused"].get(k) for k in keys})
    for label, ml in mat_launches.items():
        for name in ("p2g_fused", "g2p_fused"):
            forms_of[name][label] = dict(launches=ml[name],
                                         **{k: mat_res["kernels"][label][name].get(k)
                                            for k in keys})
    sk2 = sparse2d_res["kernels"]
    for name in SPARSE_KERNELS:
        forms_of[name]["sparse2d"] = dict(
            launches=sum(sparse2d_launches[path][name] for path in
                         ("elasticity2", "basic2", "fluids2", "fluids2-n40")),
            **{k: sk2["block"][name].get(k) for k in keys})
        forms_of[name]["sparse2d-psi"] = dict(
            launches=sparse2d_launches["l_panel2"][name],
            **{k: sk2["l_panel2 fine"][name].get(k) for k in keys})
    # The merges on the other paths: each state's merge in its path's form,
    # with that path's launches of it.
    merges = (("l_panel3", lp3_launches, dk["l_panel3"]),
              ("materials3", mat_launches["materials3"], mat_res["kernels"]["materials3"]),
              ("l_panel2", fracture_launches, fracture_res["kernels"]["reference"]),
              ("sparse", sparse_launches, dict(merge_scatter=sparse_merge)),
              ("sparse2d", {"merge_scatter": sum(
                  sparse2d_launches[path]["merge_scatter"] for path in
                  ("elasticity2", "basic2", "fluids2", "fluids2-n40"))},
               {"merge_scatter": sk2["block"]["merge_scatter"]}))
    for label, ml, checks in merges:
        for name in ("merge_blocks", "merge_scatter"):
            if name in checks:
                forms_of[name][label] = dict(launches=ml[name],
                                             **{k: checks[name].get(k) for k in keys})
    for name in PROBES:
        forms_of[name] = kres[name]["forms"]
    source_of = dict.fromkeys(SPARSE_KERNELS, WINDOW_SOURCE)
    source_of.update(dict.fromkeys(PROBES, PROBE_SOURCE))
    kernels = [
        dict(name=name, route="cuda", source=source_of.get(name, FUSED_SOURCE),
             replaces=REPLACES[name], launches=launches[name],
             path=PATH_OF[name] or NO_PATH[name], **{k: kres[name].get(k) for k in keys},
             **{k: kres[name][k] for k in extra if k in kres[name]}, **forms_of[name])
        for name in REPLACES
    ]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, kernels=kernels, launches_by_path=by_path, substeps=substeps,
                       fused_profile=fused_profile,
                       resorts=resorts, timed_substeps=timed, seconds=seconds, pups=pups,
                       resort_branches=branches, resort_ms=resort_ms, peak_gib=peak_gib,
                       build_s=build_s, kernel_checks=kres, sparse=sparse_res,
                       fluid=fluid_res, fracture=fracture_res, plastic2d=plastic_res,
                       fluids2=fluid2_res, damage=damage_res, materials=mat_res,
                       sparse2d=sparse2d_res, sparse2d_launches=sparse2d_launches,
                       merge_profiles=MERGE_PROFILES), f,
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
