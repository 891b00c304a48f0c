"""The scatter kernels, this checkout against another one (the parent
commit unpacked with `git archive`, say), on the same inputs on one card:
their outputs bit for bit, and their device and host times in turns
(other, this, this, other, ...; ROUNDS pairs).

This checkout builds the inputs once, with chip_smoke.py's functions, and
writes them under build/compare_kernels/, one file a case:

- kernel A (`p2g_fused`) on sand3@1M one frame in (the fused path), on
  fluids3 x4 after its first volume pass, on materials3 one frame in, on
  l_panel3 at full size LPANEL3_SUBSTEPS_IN substeps in (its 3D psi form),
  and on elasticity2 and l_panel2 (its 2D psi form) 20 substeps in; the
  pooling's e and candidate list on the l_panel3 and l_panel2 states;
- the mass P2G (`mass_p2g_fused`) on the fluids3 x4 state and on the
  250,000-particle fluids2 column 3 substeps in, after the volume pass the
  next substep starts with (chip_smoke.py phases 9 and 18);
- the sparse P2G (`p2g_windows`) on its slot data at sparse sand3@1M one
  frame in (phase 6), on the 250,000-particle block 3 substeps in and on
  l_panel2 at cell width 0.0025 (its psi form) 3 substeps in (phase 30):
  each in both forms, without the psi channels and with them (on the paths
  without psi, numpy-seeded psi rows on the occupied slots, as phase 30
  seeds them);
- kernel B (`g2p_fused`) on its slots, ints, window fields and corner map
  (and the structure's corner tables) on sand3@1M one frame in, fluids3 x4
  after its volume pass, materials3 and its failure form one frame in,
  l_panel3 at full size in both damage forms LPANEL3_SUBSTEPS_IN substeps
  in, elasticity2, basic2 and l_panel2 20 substeps in and the
  250,000-particle fluids2 column 3 substeps in, the fields formed by this
  checkout's kernel A, merge and grid update. A checkout whose g2p_fused
  takes windows gathers them with its own gather_grid_windows (its
  substep's gather), and is timed for its B alone and for gather + B.

Each run is then a fresh process that builds its own checkout's kernels,
launches the wrappers on these inputs and times them (scripts.device_ms,
host_us). Every output must be bit-equal across runs and checkouts (B's
output from the input slots; it updates them in place, so its timed calls
then run on from there). The mass images and the 2D window images are also
held to their plain versions run on the CPU (they sum each cell in the
kernels' order there), for both checkouts; that is reported.

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
# "TIMES {case kernel: {device_ms, host_us}}".
CHILD = r'''
import inspect, json, os, sys
from types import SimpleNamespace
sys.path.insert(0, sys.argv[1])
import torch
from sparkl_tpu_torch import cuda_build
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.fused import kernels as K
from sparkl_tpu_torch.ops import transfer_kernels as WK
from sparkl_tpu_torch.scripts import device_ms, host_us
from sparkl_tpu_torch.sparse import transfer as T
from sparkl_tpu_torch.sparse.blocks import BlockConfig

# Kernel B reads the window fields at the corners itself, or takes the
# windows that the checkout's gather forms from them.
B_READS_FIELDS = "corners" in inspect.signature(K.g2p_fused).parameters


def b_calls(grid, cfg, t):
    """{name: fn} of kernel B on the case (on a scratch copy of its slots,
    reset before the output is taken): B alone, and for a checkout whose B
    takes windows, its gather + B."""
    scratch = t["slots"].clone()
    t["scratch"] = scratch
    args = (t["dt"], t["tab_f"], t["tab_i"], t["nchunks"])
    if B_READS_FIELDS:
        return {"g2p_fused": lambda: K.g2p_fused(grid, cfg, t["meta"], t["kparams"], scratch,
                                                 t["ints"], t["fields"], t["corners"], *args)}
    structure = SimpleNamespace(nbr_index=t["nbr_index"], chunk_block=t["chunk_block"])
    order = T.ZMAJOR_ORDER_3D if grid.dim == 3 else None

    def gather():
        return T.gather_grid_windows(grid, cfg, structure, t["fields"],
                                     cell_order=order).contiguous()

    windows = gather()
    return {"g2p_fused": lambda: K.g2p_fused(grid, cfg, t["meta"], t["kparams"], scratch,
                                             t["ints"], windows, *args),
            "gather + g2p_fused": lambda: K.g2p_fused(grid, cfg, t["meta"], t["kparams"],
                                                      scratch, t["ints"], gather(), *args)}


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
    fns = {
        "p2g_fused": lambda: K.p2g_fused(grid, cfg, t["meta"], t["slots"], t["ints"], t["dt"],
                                         t["nchunks"], (t["tab_f"], t["tab_i"])),
        "eigen_pool_fused": lambda: K.eigen_pool_fused(grid, cfg, t["e"], t["cand"]),
        "mass_p2g_fused": lambda: K.mass_p2g_fused(grid, cfg, t["slots"], t["ints"],
                                                   t["nchunks"]),
        "p2g_windows": lambda: WK.p2g_windows(grid, cfg, t["slot_data"], with_psi=False),
        "p2g_windows psi": lambda: WK.p2g_windows(grid, cfg, t["slot_data_psi"],
                                                  with_psi=True),
    }
    if "g2p_fused" in case["kernels"]:
        fns.update(b_calls(grid, cfg, t))
    for kname in case["kernels"]:
        names = [kname] + (["gather + g2p_fused"] if "gather + g2p_fused" in fns
                           and kname == "g2p_fused" else [])
        for i, kn in enumerate(names):
            fn = fns[kn]
            key = f"{name[:-3]} {kn}"
            if i == 0:
                if kn == "g2p_fused":
                    t["scratch"].copy_(t["slots"])
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

    import numpy as np

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import sparkl_tpu_torch.scenes as scenes
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
    from sparkl_tpu_torch.sparse.pipeline import SparseMpmPipeline

    os.makedirs(INPUTS, exist_ok=True)

    def geometry(grid, cfg):
        return dict(grid=(grid.origin, grid.cell_width, grid.res), cfg=asdict(cfg))

    def save(name, pipe, state, dt, kernels=("p2g_fused", "g2p_fused")):
        case = dict(geometry(pipe.grid, pipe._cfg), kernels=list(kernels), meta=pipe._meta,
                    slots=state.slots.cpu(), ints=state.ints.cpu(),
                    nchunks=state.structure.num_chunks.cpu(), dt=dt, tab_f=pipe._tab_f.cpu(),
                    tab_i=pipe._tab_i.cpu())
        if "eigen_pool_fused" in kernels:
            e, _ = pipe._eigen_rows(state)
            cand, _ = pipe._eigen_candidates(state.structure)
            case.update(e=e.cpu(), cand=cand.cpu())
        if "g2p_fused" in kernels:
            # Kernel B's inputs: the window fields of this checkout's kernel A,
            # merge and grid update at dt, and the corner tables.
            images = K.p2g_fused(pipe.grid, pipe._cfg, pipe._meta, state.slots, state.ints, dt,
                                 state.structure.num_chunks, (pipe._tab_f, pipe._tab_i))
            st = state.structure
            case.update(kparams=pipe._kparams,
                        fields=pipe._node_fields(state, images, dt).cpu(),
                        corners=pipe._corners(state).cpu(), nbr_index=st.nbr_index.cpu(),
                        chunk_block=st.chunk_block.cpu())
        torch.save(case, os.path.join(INPUTS, name + ".pt"))
        print(f"{name}: {int(state.structure.num_chunks)} live chunks, {pipe._cfg}, dt {dt:.3e}",
              flush=True)

    def save_windows(name, grid, cfg, slot_data, path_psi, seed=5):
        # The form the path does not run: its psi rows dropped (with_psi
        # off), or seeded on the occupied slots as chip_smoke.check_windows
        # seeds them.
        sd_psi = slot_data
        if not path_psi:
            dim = grid.dim
            d_, _, c = slot_data.shape
            row = 2 * dim + 1 + dim * dim
            valid = slot_data[:, dim, :] != 0.0
            noise = np.random.default_rng(seed).uniform(0.5, 1.5, size=(d_, 2, c))
            sd_psi = slot_data.clone()
            sd_psi[:, row:row + 2] = (torch.from_numpy(noise.astype(np.float32)).to(
                slot_data.device) * valid[:, None, :])
        case = dict(geometry(grid, cfg), kernels=["p2g_windows", "p2g_windows psi"],
                    slot_data=slot_data.cpu(), slot_data_psi=sd_psi.cpu(), path_psi=path_psi)
        torch.save(case, os.path.join(INPUTS, name + ".pt"))
        print(f"{name}: {slot_data.shape[0]} chunks, {cfg}, psi on the path {path_psi}",
              flush=True)

    b = scenes.build("sand3", nx=100, ny=50, nz=100)
    pipe = FusedMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity)
    state, _ = pipe.run_frames_state(pipe.pack_state(b.particles), 1)
    save("sand3", pipe, state, float(pipe._probe(state)[1]))
    del pipe, state
    spipe = SparseMpmPipeline(b.grid, b.models, b.colliders, b.params, b.gravity)
    p1, _ = spipe.step_with_stats(b.particles)
    slot_data, _ = cs.capture_window_inputs(spipe, p1)
    save_windows("sparse_sand3", b.grid, spipe._cfg, slot_data, False)
    del b, spipe, p1, slot_data

    fb = cs.fluid_blob()
    pipe = FusedMpmPipeline(fb.grid, fb.models, fb.colliders, fb.params, fb.gravity)
    state = pipe._recompute_fluids(pipe.pack_state(fb.particles))
    save("fluid", pipe, state, float(pipe._min_dtb(state)),
         ("p2g_fused", "mass_p2g_fused", "g2p_fused"))
    del fb, pipe, state

    pipe, state = cs.substep_state(cs.fluid2_block(), 3)
    state = pipe._recompute_fluids(state.replace(slots=state.slots.clone()))
    save("fluids2_block", pipe, state, float(pipe._min_dtb(state)),
         ("mass_p2g_fused", "g2p_fused"))
    del pipe, state

    pipe, state = cs.material_state(cs.materials3())
    save("materials3", pipe, state, float(pipe._min_dtb(state)))
    pipe, state = cs.material_state(cs.materials3(failure=True))
    save("materials3_failure", pipe, state, float(pipe._min_dtb(state)), ("g2p_fused",))
    del pipe, state

    pipe, state = cs.substep_state(cs.l_panel3(load_speed=cs.LPANEL3_LOAD_SPEED),
                                   cs.LPANEL3_SUBSTEPS_IN)
    save("l_panel3", pipe, state, float(pipe._min_dtb(state)),
         ("p2g_fused", "eigen_pool_fused", "g2p_fused"))
    pipe, state = cs.substep_state(cs.l_panel3("modified", load_speed=cs.LPANEL3_LOAD_SPEED),
                                   cs.LPANEL3_SUBSTEPS_IN)
    save("l_panel3_modified", pipe, state, float(pipe._min_dtb(state)), ("g2p_fused",))
    del pipe, state

    pipe, state = cs.substep_state(scenes.build("elasticity2"), cs.PLASTIC_SUBSTEPS_IN)
    save("elasticity2", pipe, state, float(pipe._min_dtb(state)))
    pipe, state = cs.substep_state(scenes.build("basic2"), cs.PLASTIC_SUBSTEPS_IN)
    save("basic2", pipe, state, float(pipe._min_dtb(state)), ("g2p_fused",))
    pipe, state = cs.substep_state(cs.fracture_bundle(), cs.FRACTURE_SUBSTEPS_IN)
    save("l_panel2", pipe, state, float(pipe._min_dtb(state)),
         ("p2g_fused", "eigen_pool_fused", "g2p_fused"))
    del pipe, state

    for name, bundle in (("block", cs.plastic_block()),
                         ("l_panel2_fine", cs.fracture_bundle(cs.FRACTURE_FINE_CELL))):
        pipe, slot_data, _ = cs.sparse_inputs(bundle, 3)
        save_windows(name, bundle.grid, pipe._cfg, slot_data, pipe._with_psi)
        del pipe, slot_data
    torch.cuda.empty_cache()


def cpu_plain(name, kname):
    """The plain version on the CPU of a case's mass images or 2D window
    images (which sum each cell in the kernels' order there), else None."""
    from sparkl_tpu_torch.core.grid import GridParams
    from sparkl_tpu_torch.fused import kernels as K
    from sparkl_tpu_torch.ops import transfer_kernels as WK

    case = torch.load(os.path.join(INPUTS, name + ".pt"), weights_only=False)
    grid = GridParams(*case["grid"])
    if kname == "mass_p2g_fused":
        return K.mass_p2g_fused_reference(grid, case["slots"], case["ints"], case["nchunks"])
    if kname.startswith("p2g_windows") and grid.dim == 2:
        psi = kname.endswith("psi")
        return WK.p2g_windows_reference(grid, case["slot_data_psi" if psi else "slot_data"],
                                        psi)
    return None


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
        line = (f"{key}: {tuple(b[key].shape)} bit-equal to the other checkout's {same}; "
                f"max|diff| {(a[key] - b[key]).abs().max().item():.3e}")
        plain = cpu_plain(*key.split(" ", 1))
        if plain is not None:
            line += "; bit-equal to its plain version on the CPU: " + ", ".join(
                f"{tag} {first_difference(out, plain)}" for tag, out in (("other", a[key]),
                                                                          ("this", b[key])))
        print(line, flush=True)
    return all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)) for k in a)


def first_difference(out, plain):
    """'True', or how many elements differ and the first one's index and
    values."""
    diff = (out.view(torch.int32) != plain.view(torch.int32)).nonzero()
    if len(diff) == 0:
        return "True"
    i = tuple(diff[0].tolist())
    return (f"False ({len(diff)} elements differ; first {i}: {out[i].item()!r} against "
            f"{plain[i].item()!r})")


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        sys.exit("usage: python -m sparkl_tpu_torch.scripts.compare_kernels OTHER_CHECKOUT "
                 "[ROUNDS]")
    ok = main(os.path.abspath(sys.argv[1]), int(sys.argv[2]) if len(sys.argv) == 3 else 1)
    sys.exit(0 if ok else 1)
