"""Why fluids3's substep counts turn on the last bits of the volume pass.

Replays tests/golden_scenes.json's fluids3 frames 0-4 on the CPU through
the JAX dense pipeline, the JAX fused pipeline (Pallas in interpret mode,
~80 s) and the port's fused pipeline, and prints each frame's substeps
beside the goldens'. At the start of frames 3 and 4 it runs one volume
pass on each (the dense pipeline's recompute_fluids_volumes, or the fused
pipelines' _recompute_fluids on a fresh pack of the frame's particles) and
dumps the per-particle dt bound: its minimum, the J - 1 of the particle
that sets it, and how many particles lie below, at and just above J = 1.

The Monaghan EOS bound h/J·sqrt(ρ0(J - 1) / (-6·p·d)) is +inf at J = 1
exactly (p = 0). Below 1, p ≈ 7·p0·(1 - J) and the bound tends to
h·sqrt(ρ0 / (42·d·p0)) ≈ 2.254e-3 s for fluids3. Above 1 the pressure is
clamped at -max_neg from J - 1 ≈ 1.4e-7 on (about one f32 ulp of 1), and
the bound h/J·sqrt(ρ0(J - 1) / (6·d·max_neg)) grows with J - 1. The
blob falls freely at J within a few ulps of 1, so whether any particle's
volume pass rounds to J < 1 or J = 1 + 1 ulp decides between that 2.254e-3
s and a dt growing as the square root of the smallest J - 1: the last bits
of the grid-mass sums set the substep count.

    JAX_PLATFORMS=cpu python tests/fluids3_dt_bound_dump.py [dense] [jax] [port]
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import sparkl_tpu.scenes as jscenes  # noqa: E402
import sparkl_tpu_torch.scenes as tscenes  # noqa: E402
from sparkl_tpu.fused.pipeline import FusedMpmPipeline as JFused  # noqa: E402
from sparkl_tpu.solver import dense as jdense  # noqa: E402
from sparkl_tpu.solver.pipeline import MpmPipeline  # noqa: E402
from sparkl_tpu_torch.fused import layout as TL  # noqa: E402
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline as TFused  # noqa: E402

GOLD = json.load(open(os.path.join(HERE, "golden_scenes.json")))["fluids3"]
FRAMES = 5
DUMP_AT = (3, 4)


def dump(tag, j, dtb):
    j, dtb = np.asarray(j, np.float64), np.asarray(dtb, np.float64)
    k = int(np.argmin(dtb))
    near = (j > 1.0) & (j - 1.0 < 2e-7)
    above = j - 1.0 >= 2e-7
    print(f"  {tag}: min dt bound {dtb.min():.6e} at J - 1 = {j[k] - 1.0:.3e}; particles with "
          f"J < 1: {int((j < 1.0).sum())}, J == 1: {int((j == 1.0).sum())}, 0 < J - 1 < 2e-7: "
          f"{int(near.sum())} of {j.size}; min bound over J - 1 >= 2e-7 "
          f"{dtb[above].min():.4e}", flush=True)


def slot_dump(tag, slots, ints):
    r = TL.Rows(3)
    slots, ints = np.asarray(slots), np.asarray(ints)
    occ = (ints[:, TL.I_FLAGS] & TL.OCCUPIED) != 0
    dump(tag, slots[:, r.defgrad][occ], slots[:, r.dtb][occ])


def frame_line(tag, i, n, pos, act):
    rec = GOLD["frames"][i]
    com = pos[act].mean(axis=0)  # as tests/test_regression.py::_stats forms it
    print(f"{tag} frame {i}: substeps {int(n)} (golden {rec['substeps']}), centre of mass y "
          f"{com[1]:.7f} (golden {rec['com'][1]:.7f})", flush=True)


def run_dense():
    b = jscenes.build("fluids3", **GOLD["config"])
    pipe = MpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity, b.hooks)
    p = b.particles
    for i in range(FRAMES):
        if i in DUMP_AT:
            q = jdense.recompute_fluids_volumes(b.grid, jdense.mark_out_of_grid_failed(b.grid, p),
                                                b.models)
            act = np.asarray(q.active)
            dump(f"JAX dense, frame {i} start", np.asarray(q.deformation_gradient)[act, 0, 0],
                 np.asarray(jdense.particle_dt_bounds(b.grid, q, b.models))[act])
        p, n = pipe.step_with_stats(p)
        frame_line("JAX dense", i, n, np.asarray(p.position), np.asarray(p.active))


def run_jax_fused():
    b = jscenes.build("fluids3", **GOLD["config"])
    pipe = JFused(b.grid, b.models, b.colliders, b.params, b.gravity, b.hooks,
                  use_pallas="interpret")
    recompute = jax.jit(pipe._recompute_fluids)
    p = jax.tree_util.tree_map(jnp.array, b.particles)
    for i in range(FRAMES):
        if i in DUMP_AT:
            pipe._ensure_cfg(p)
            st, _ = recompute(pipe._jit_pack(p))
            slot_dump(f"JAX fused, frame {i} start", st.slots, st.ints)
        p, n = pipe.step_with_stats(p)
        frame_line("JAX fused", i, n, np.asarray(p.position), np.asarray(p.active))


def run_port():
    b = tscenes.build("fluids3", device="cpu", **GOLD["config"])
    pipe = TFused(b.grid, b.models, b.colliders, b.params, b.gravity, device="cpu")
    p = b.particles
    for i in range(FRAMES):
        if i in DUMP_AT:
            st = pipe._recompute_fluids(pipe.pack_state(p))
            slot_dump(f"port fused, frame {i} start", st.slots, st.ints)
        p, n = pipe.step_with_stats(p)
        frame_line("port fused", i, n, p.position.numpy(), p.active.numpy())


if __name__ == "__main__":
    torch.set_num_threads(4)
    runs = dict(dense=run_dense, jax=run_jax_fused, port=run_port)
    print("golden substeps", [f["substeps"] for f in GOLD["frames"][:FRAMES]])
    for name in sys.argv[1:] or list(runs):
        t0 = time.perf_counter()
        runs[name]()
        print(f"({name}: {time.perf_counter() - t0:.1f} s)", flush=True)
