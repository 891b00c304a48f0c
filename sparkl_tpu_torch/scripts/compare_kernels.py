"""Kernel A and the eigenerosion pooling, this checkout against another one
(the parent commit unpacked with `git archive`, say), on the same inputs on
one card: their outputs bit for bit, and their device and host times in
turns (other, this, this, other, ...; ROUNDS pairs).

This checkout builds the inputs once, with chip_smoke.py's functions, and
writes them under build/compare_kernels/: kernel A's on sand3@1M one frame
in (the fused path), on fluids3 x4 after its first volume pass, on
materials3 one frame in, on l_panel3 at full size LPANEL3_SUBSTEPS_IN
substeps in (its 3D psi form), and on elasticity2 and l_panel2 (its 2D psi
form) 20 substeps in, with the pooling's e and candidate list on the
l_panel3 and l_panel2 states. Each run is then a fresh process that builds its own
checkout's kernels, launches both wrappers on these inputs and times them
(scripts.device_ms, host_us). Every output must be bit-equal across runs
and checkouts.

Run on the GPU from the repository root:
`python -m sparkl_tpu_torch.scripts.compare_kernels OTHER_CHECKOUT [ROUNDS]`
(ROUNDS 1 by default)."""

import os
import sys

import torch

from sparkl_tpu_torch.scripts.compare_paths import HERE, child, turns

INPUTS = os.path.join(HERE, "build", "compare_kernels")

# Run in a fresh interpreter with the checkout first on sys.path: launches
# each case's kernels, saves their outputs (argv[3] = 1) and prints one line
# "TIMES {case: {device_ms, host_us}}".
CHILD = r'''
import json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
from sparkl_tpu_torch import cuda_build
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.fused import kernels as K
from sparkl_tpu_torch.scripts import device_ms, host_us
from sparkl_tpu_torch.sparse.blocks import BlockConfig

cuda_build.build()
cuda_build.library()
inputs, save = sys.argv[2], sys.argv[3] == "1"
times, outs = {}, {}
for name in sorted(os.listdir(inputs)):
    if not name.endswith(".pt") or name.startswith("outputs_"):
        continue
    case = torch.load(os.path.join(inputs, name), weights_only=False)
    grid, cfg = GridParams(*case["grid"]), BlockConfig(**case["cfg"])
    t = {k: v.cuda() if isinstance(v, torch.Tensor) else v for k, v in case.items()}
    tables = (t["tab_f"], t["tab_i"])
    fns = {"p2g_fused": lambda: K.p2g_fused(grid, cfg, t["meta"], t["slots"], t["ints"],
                                            t["dt"], t["nchunks"], tables)}
    if "e" in t:
        fns["eigen_pool_fused"] = lambda: K.eigen_pool_fused(grid, cfg, t["e"], t["cand"])
    for kname, fn in fns.items():
        key = f"{name[:-3]} {kname}"
        out = fn()
        torch.cuda.synchronize()
        outs[key] = out.cpu()
        times[key] = dict(device_ms=device_ms(fn), host_us=host_us(fn))
if save:
    torch.save(outs, os.path.join(inputs, "outputs_" + sys.argv[4] + ".pt"))
print("TIMES " + json.dumps(times))
'''


def write_inputs():
    """Build the cases with this checkout and save them under INPUTS."""
    from dataclasses import asdict

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline

    os.makedirs(INPUTS, exist_ok=True)

    def save(name, pipe, state, dt, eigen=False):
        case = dict(grid=(pipe.grid.origin, pipe.grid.cell_width, pipe.grid.res),
                    cfg=asdict(pipe._cfg), meta=pipe._meta, slots=state.slots.cpu(),
                    ints=state.ints.cpu(), nchunks=state.structure.num_chunks.cpu(), dt=dt,
                    tab_f=pipe._tab_f.cpu(), tab_i=pipe._tab_i.cpu())
        if eigen:
            e, _ = pipe._eigen_rows(state)
            cand, _ = pipe._eigen_candidates(state.structure)
            case.update(e=e.cpu(), cand=cand.cpu())
        torch.save(case, os.path.join(INPUTS, name + ".pt"))
        print(f"{name}: {int(state.structure.num_chunks)} live chunks, {pipe._cfg}, dt {dt:.3e}",
              flush=True)

    b = scenes.build("sand3", nx=100, ny=50, nz=100)
    pipe = FusedMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity)
    state, _ = pipe.run_frames_state(pipe.pack_state(b.particles), 1)
    save("sand3", pipe, state, float(pipe._probe(state)[1]))
    del b, pipe, state

    fb = cs.fluid_blob()
    pipe = FusedMpmPipeline(fb.grid, fb.models, fb.colliders, fb.params, fb.gravity)
    state = pipe._recompute_fluids(pipe.pack_state(fb.particles))
    save("fluid", pipe, state, float(pipe._min_dtb(state)))
    del fb, pipe, state

    pipe, state = cs.material_state(cs.materials3())
    save("materials3", pipe, state, float(pipe._min_dtb(state)))
    del pipe, state

    pipe, state = cs.substep_state(cs.l_panel3(load_speed=cs.LPANEL3_LOAD_SPEED),
                                   cs.LPANEL3_SUBSTEPS_IN)
    save("l_panel3", pipe, state, float(pipe._min_dtb(state)), eigen=True)
    del pipe, state

    pipe, state = cs.substep_state(scenes.build("elasticity2"), cs.PLASTIC_SUBSTEPS_IN)
    save("elasticity2", pipe, state, float(pipe._min_dtb(state)))
    pipe, state = cs.substep_state(cs.fracture_bundle(), cs.FRACTURE_SUBSTEPS_IN)
    save("l_panel2", pipe, state, float(pipe._min_dtb(state)), eigen=True)
    del pipe, state
    torch.cuda.empty_cache()


def main(other, rounds=1):
    write_inputs()
    saved = set()
    for tag, checkout in turns(other, rounds):
        times = child(CHILD, checkout, [INPUTS, "0" if tag in saved else "1", tag], "TIMES")
        saved.add(tag)
        for key, v in times.items():
            print(f"{tag}: {key}: device {v['device_ms']:.4f} ms, host {v['host_us']:.1f} us "
                  f"a call", flush=True)
    a = torch.load(os.path.join(INPUTS, "outputs_other.pt"))
    b = torch.load(os.path.join(INPUTS, "outputs_this.pt"))
    for key in sorted(a):
        same = torch.equal(a[key].view(torch.int32), b[key].view(torch.int32))
        print(f"{key}: {tuple(b[key].shape)} bit-equal to the other checkout's {same}; "
              f"max|diff| {(a[key] - b[key]).abs().max().item():.3e}", flush=True)
    return all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)) for k in a)


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        sys.exit("usage: python -m sparkl_tpu_torch.scripts.compare_kernels OTHER_CHECKOUT "
                 "[ROUNDS]")
    ok = main(os.path.abspath(sys.argv[1]), int(sys.argv[2]) if len(sys.argv) == 3 else 1)
    sys.exit(0 if ok else 1)
