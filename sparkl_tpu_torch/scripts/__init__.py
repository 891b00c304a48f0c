"""Microbenchmarks of the card, the counterparts of the JAX package's TPU
probe scripts (scripts/vreg_probe.py, scripts/layout_probe.py): each a
hand-written CUDA kernel (csrc/probe_kernels.cu) with its plain PyTorch
version. Run on the GPU: `python -m sparkl_tpu_torch.scripts.vreg_probe`,
`python -m sparkl_tpu_torch.scripts.layout_probe`."""

import statistics

import torch

from sparkl_tpu_torch.device import resolve

REPS, BATCH = 20, 10


def card():
    """The CUDA device the probes measure on; raises without one (they
    never fall back to the CPU)."""
    return resolve("cuda")


def median_ms(fn, reps=REPS, batch=BATCH):
    """ms per call of fn(): the median over `reps` of a batch of calls
    between two CUDA events on the current stream, divided by the batch,
    after one warm-up batch. Many of the port's kernels take tens of
    microseconds, about what the host takes to enqueue one: in a batch the
    host runs ahead and the events time the device, where around a single
    call they would time the host's enqueue too. The probes and
    chip_smoke.py time every kernel, plain version and library call with
    it."""
    for _ in range(batch):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)
