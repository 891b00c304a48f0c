"""Particle-updates/s of chip_smoke.py's main paths, this checkout against
another one (the parent commit unpacked with `git archive`, say), in turns
on one card: other, this, this, other, other, this, ... (PAIRS pairs). Each
run is a fresh process that builds its own checkout's kernels and drives,
as chip_smoke.py does and with its functions: fused sand3@1M (15 frames,
the last 3 timed), elasticity2, basic2 and fluids2 (phase 16), l_panel3 at
full size with its load at LPANEL3_LOAD_SPEED (phase 23), materials3
(phase 27), materials2 (phase 28), the sparse basic2 path (phase 31), and
the two paths that carry the 3D scatter kernels of the fluid pass and the
sparse pipeline: fluids3x4 (phase 10: 30 frames, the last 5 timed) and
sparse sand3 (phase 7: sand3@1M on the sparse pipeline, 6 frames, the last
2 timed). These two and fused sand3 also profile one more frame each
(torch.profiler, as chip_smoke.py does) and report its device busy ms
beside the rate ("... busy ms"), and the two fused ones its device
operations a substep and its torch gathers' and scatters' device ms.
The card's host sets most of these rates and differs between machines, so
two trees are compared only within one call; against a copy of this
checkout the same run measures how far the rates spread between
processes of one tree.

Run on the GPU from the repository root:
`python -m sparkl_tpu_torch.scripts.compare_paths OTHER_CHECKOUT [PAIRS [PATHS]]`
(PAIRS 2 by default; PATHS a comma-separated subset of the names above,
e.g. `elasticity2,basic2` or `"fluids3x4,sparse sand3"`, all by default)."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Run in a fresh interpreter with the checkout first on sys.path; prints one
# line "RATES {path: particle-updates/s, ...}" for the paths named in
# argv[2] (all if empty), with "<path> busy ms" for the profiled paths.
CHILD = r'''
import contextlib, io, json, os, sys, time
from dataclasses import replace
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
import sparkl_tpu_torch.scenes as scenes
from sparkl_tpu_torch import cuda_build
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline

want = set(filter(None, sys.argv[2].split(",")))


def on(name):
    return not want or name in want


def sand3_fused():
    b = scenes.build("sand3", nx=100, ny=50, nz=100)
    pipe = FusedMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity)
    state = pipe.pack_state(b.particles)
    for _ in range(cs.FRAMES - cs.TIMED_FRAMES):
        state, _ = pipe.run_frames_state(state, 1)
    torch.cuda.synchronize()
    t0, n = time.perf_counter(), 0
    for _ in range(cs.TIMED_FRAMES):
        state, k = pipe.run_frames_state(state, 1)
        n += k
    torch.cuda.synchronize()
    rate = int(b.particles.active.sum()) * n / (time.perf_counter() - t0)
    profiled("sand3 fused", pipe, state, "sand3_profile.txt", 4)
    return rate


def profiled(name, pipe, state, fname, phase):
    """One more frame of a fused path under torch.profiler: its device busy
    ms, device operations a substep and torch gathers' and scatters' ms."""
    _, prof = cs.profile_frame(pipe, state, fname, phase, name)
    busy[f"{name} busy ms"] = prof["busy_ms"]
    busy[f"{name} device ops a substep"] = prof["device_ops"] / max(prof["substeps"], 1)
    busy[f"{name} gathers ms"] = prof["split"].get("torch gathers and scatters", 0.0)


def fluids3x4():
    pipe, _, state, _, res = cs.phase_fluid_main(cs.fluid_blob())
    profiled("fluids3x4", pipe, state, "fluid_profile.txt", 10)
    return res["pups"]


def sparse_sand3():
    b = scenes.build("sand3", nx=100, ny=50, nz=100)
    res = cs.phase_sparse_main(replace(b, name="sand3@1M"), cs.SPARSE_FRAMES, cs.SPARSE_TIMED,
                               7, profile="sparse_profile.txt")[3]
    busy["sparse sand3 busy ms"] = res["profile"]["busy_ms"]
    return res["pups"]


busy = {}
paths = {
    "sand3 fused": sand3_fused,
    "elasticity2": lambda: cs.phase_plastic_main("elasticity2", 16)[3]["pups"],
    "basic2": lambda: cs.phase_plastic_main("basic2", 16)[3]["pups"],
    "fluids2": lambda: cs.phase_plastic_main("fluids2", 16, golden=False)[3]["pups"],
    "l_panel3": lambda: cs.phase_damage_main(cs.l_panel3(load_speed=cs.LPANEL3_LOAD_SPEED),
                                             cs.LPANEL3_FRAMES, cs.LPANEL3_TIMED, 23)[3]["pups"],
    "materials3": lambda: cs.phase_damage_main(cs.materials3(), cs.MATERIALS3_FRAMES,
                                               cs.MATERIALS3_TIMED, 27,
                                               stats=cs.materials_stats)[3]["pups"],
    "materials2": lambda: cs.phase_damage_main(cs.materials2(), cs.MATERIALS2_FRAMES, 1, 28,
                                               stats=cs.materials_stats)[3]["pups"],
    "sparse basic2": lambda: cs.phase_sparse_main(
        scenes.build("basic2"), cs.SPARSE2D_FRAMES, cs.SPARSE2D_TIMED, 31,
        cs.golden_frames("basic2"), None)[3]["pups"],
    "fluids3x4": fluids3x4,
    "sparse sand3": sparse_sand3,
}
cuda_build.build()
cuda_build.library()
os.makedirs(cs.OUT_DIR, exist_ok=True)
rates = {}
with contextlib.redirect_stdout(io.StringIO()):
    for name, fn in paths.items():
        if on(name):
            rates[name] = fn()
print("RATES " + json.dumps({**rates, **busy}))
'''


def turns(other, pairs):
    """The order of the runs, (tag, checkout): other, this, this, other,
    other, this, ... (`pairs` of each)."""
    return [(("other", other), ("this", HERE))[(i + i // 2) % 2] for i in range(2 * pairs)]


def child(code, checkout, args, key):
    """Run `code` in a fresh interpreter in `checkout`, with argv[1] the
    checkout (which the code puts first on sys.path) and `args` after it;
    returns the JSON its output prints after `key` on a line of its own."""
    p = subprocess.run([sys.executable, "-c", code, checkout, *args], capture_output=True,
                       text=True, cwd=checkout)
    line = [ln for ln in p.stdout.splitlines() if ln.startswith(key + " ")]
    if p.returncode != 0 or not line:
        raise RuntimeError(f"{checkout}: exit {p.returncode}\n{p.stderr[-4000:]}")
    return json.loads(line[0][len(key) + 1:])


def main(other, pairs=2, paths=""):
    runs = []
    for tag, checkout in turns(other, pairs):
        r = child(CHILD, checkout, [paths], "RATES")
        runs.append((tag, r))
        print(f"{tag} ({checkout}): " + ", ".join(f"{k} {v:.6g}" for k, v in r.items()),
              flush=True)
    return runs


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3, 4):
        sys.exit("usage: python -m sparkl_tpu_torch.scripts.compare_paths OTHER_CHECKOUT "
                 "[PAIRS [PATHS]]")
    main(os.path.abspath(sys.argv[1]), int(sys.argv[2]) if len(sys.argv) >= 3 else 2,
         sys.argv[3] if len(sys.argv) == 4 else "")
