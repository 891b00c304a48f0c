"""Particle-updates/s of chip_smoke.py's main paths, this checkout against
another one (the parent commit unpacked with `git archive`, say), in turns
on one card: other, this, this, other, other, this, ... (PAIRS pairs). Each
run is a fresh process that builds its own checkout's kernels and drives,
as chip_smoke.py does and with its functions: fused sand3@1M (15 frames,
the last 3 timed), elasticity2, basic2 and fluids2 (phase 16), materials2
(phase 28) and the sparse basic2 path (phase 31). The card's host sets
most of these rates and differs between machines, so two trees are
compared only within one call.

Run on the GPU from the repository root:
`python -m sparkl_tpu_torch.scripts.compare_paths OTHER_CHECKOUT [PAIRS]`
(PAIRS 2 by default)."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Run in a fresh interpreter with the checkout first on sys.path; prints one
# line "RATES {path: particle-updates/s}".
CHILD = r'''
import contextlib, io, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
import sparkl_tpu_torch.scenes as scenes
from sparkl_tpu_torch import cuda_build
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline

cuda_build.build()
cuda_build.library()
rates = {}
with contextlib.redirect_stdout(io.StringIO()):
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
    rates["sand3 fused"] = int(b.particles.active.sum()) * n / (time.perf_counter() - t0)
    del pipe, state, b
    for name in ("elasticity2", "basic2", "fluids2"):
        rates[name] = cs.phase_plastic_main(name, 16, golden=name != "fluids2")[3]["pups"]
    rates["materials2"] = cs.phase_damage_main(cs.materials2(), cs.MATERIALS2_FRAMES, 1, 28,
                                               stats=cs.materials_stats)[3]["pups"]
    rates["sparse basic2"] = cs.phase_sparse_main(
        scenes.build("basic2"), cs.SPARSE2D_FRAMES, cs.SPARSE2D_TIMED, 31,
        cs.golden_frames("basic2"), None)[3]["pups"]
print("RATES " + json.dumps(rates))
'''


def rates(checkout):
    """{path: particle-updates/s} of one run of `checkout`'s main paths."""
    p = subprocess.run([sys.executable, "-c", CHILD, checkout], capture_output=True,
                       text=True, cwd=checkout)
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("RATES ")]
    if p.returncode != 0 or not line:
        raise RuntimeError(f"{checkout}: exit {p.returncode}\n{p.stderr[-4000:]}")
    return json.loads(line[0][len("RATES "):])


def main(other, pairs=2):
    runs = []
    order = [(("other", other), ("this", HERE))[(i + i // 2) % 2] for i in range(2 * pairs)]
    for tag, checkout in order:
        r = rates(checkout)
        runs.append((tag, r))
        print(f"{tag} ({checkout}): " + ", ".join(f"{k} {v:.4g}" for k, v in r.items()),
              flush=True)
    return runs


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        sys.exit("usage: python -m sparkl_tpu_torch.scripts.compare_paths OTHER_CHECKOUT "
                 "[PAIRS]")
    main(os.path.abspath(sys.argv[1]), int(sys.argv[2]) if len(sys.argv) == 3 else 2)
