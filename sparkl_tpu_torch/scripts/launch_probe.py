"""Where a kernel wrapper's host time goes, beside one PyTorch call: the
host microseconds per call of the source-row kernel's wrapper
(fused.kernels.src_rows_from_order), of its parts (the argument checks,
the output allocation, the ctypes launch, the raw stream), of torch.gather
computing the same function, and of a one-op PyTorch launch, at the main
paths' shapes (3D sand3@1M, 2D l_panel2), in a fresh process and again
after a torch.profiler session (chip_smoke.py profiles frames between its
kernel checks). Each line also gives both calls' batched and device times.

Run on the GPU from the repository root:
`python -m sparkl_tpu_torch.scripts.launch_probe`. Without a CUDA device it
raises."""

import torch

from sparkl_tpu_torch import cuda_build
from sparkl_tpu_torch.fused import kernels as K
from sparkl_tpu_torch.scripts import HOST_CALLS, _host_us, card, device_ms, median_ms

# (chunks, chunk size): sand3@1M's resort, l_panel2's.
SHAPES = ((12800, 128), (1536, 64))
REPS = 15


def parts(d_, c, dev, gen):
    """{name: fn} for one shape: the wrapper, its parts and the yardsticks."""
    order2 = torch.randint(0, d_ * c, (d_, 2, c), generator=gen, dtype=torch.int32).to(dev)
    shifts = torch.randint(0, c, (d_,), generator=gen, dtype=torch.int32).to(dev)
    j = torch.clamp(shifts[:, None].long() + torch.arange(c, device=dev)[None, :], 0, 2 * c - 1)
    rows = order2.reshape(d_, 2 * c)
    out = torch.empty((d_, c), dtype=torch.int32, device=dev)
    one = torch.zeros(16, device=dev)
    args = (order2.data_ptr(), shifts.data_ptr(), out.data_ptr(), d_, c,
            cuda_build.stream_ptr(dev))

    def checks():
        cuda_build.check_tensor("order2", order2, torch.int32, (d_, 2, c), dev)
        cuda_build.check_tensor("shifts", shifts, torch.int32, (d_,), dev)

    return {
        "wrapper": lambda: K.src_rows_from_order(order2, shifts),
        "torch.gather": lambda: torch.gather(rows, 1, j),
        "checks": checks,
        "allocation": lambda: order2.new_empty(d_, c),
        "launch": lambda: cuda_build.launch("sparkl_src_rows_from_order", *args),
        "raw stream": lambda: cuda_build.raw_stream(dev.index),
        "one-op torch launch": lambda: one.add_(1.0),
    }


def table(tag, dev):
    gen = torch.Generator().manual_seed(11)
    out = {}
    for d_, c in SHAPES:
        fns = parts(d_, c, dev, gen)
        names = list(fns)
        us = dict(zip(names, _host_us([fns[n] for n in names], HOST_CALLS, REPS)))
        out[(d_, c)] = us
        print(f"{tag}, D = {d_}, C = {c}: host us a call " +
              ", ".join(f"{n} {u:.2f}" for n, u in us.items()), flush=True)
        for n in ("wrapper", "torch.gather"):
            print(f"    {n}: batched {median_ms(fns[n]):.4f} ms, device "
                  f"{device_ms(fns[n]):.4f} ms", flush=True)
    return out


def main():
    dev = card()
    cuda_build.build()
    cuda_build.library()
    before = table("fresh process", dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        x = torch.ones(1000, device=dev)
        for _ in range(10):
            x = x + 1.0
        torch.cuda.synchronize()
    after = table("after a torch.profiler session", dev)
    return before, after


if __name__ == "__main__":
    main()
