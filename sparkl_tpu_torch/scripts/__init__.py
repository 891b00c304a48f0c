"""Microbenchmarks of the card, the counterparts of the JAX package's TPU
probe scripts (scripts/vreg_probe.py, scripts/layout_probe.py): each a
hand-written CUDA kernel (csrc/probe_kernels.cu) with its plain PyTorch
version. Run on the GPU: `python -m sparkl_tpu_torch.scripts.vreg_probe`,
`python -m sparkl_tpu_torch.scripts.layout_probe`."""

import statistics
import time

import torch

from sparkl_tpu_torch.device import resolve

REPS, BATCH = 20, 10
HOST_CALLS, HOST_REPS = 100, 9
# Cycles the card spins before a timed graph replay, so that the host has
# enqueued the replay and its closing event before the first event runs.
SPIN_CYCLES = 2_000_000


def card():
    """The CUDA device the probes measure on; raises without one (they
    never fall back to the CPU)."""
    return resolve("cuda")


def median_ms(fn, reps=REPS, batch=BATCH):
    """ms per call of fn(): the median over `reps` of a batch of calls
    between two CUDA events on the current stream, divided by the batch,
    after one warm-up batch. It is what a path pays per call: the device
    time where the host runs ahead, but where a wrapper takes longer to
    enqueue than its kernel takes to run (many of the port's kernels take a
    few microseconds) the device waits on the host and this times the
    host. device_ms and host_us split it. The probes and chip_smoke.py time
    every kernel, plain version and library call with it."""
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


def device_ms(fn, reps=REPS, batch=BATCH):
    """ms per call of fn() on the device alone: `batch` calls captured in
    one CUDA graph, whose replays are timed between two events (the median
    over `reps`), each replay enqueued behind a spin of the card, so that
    no enqueue falls inside the interval. The port's launchers enqueue on
    the current stream, which is the capture stream inside the capture.
    fn must not read the host (.item(), bool(...)): such a call cannot be
    captured, and stays on median_ms."""
    fn()
    torch.cuda.synchronize()
    # Captured on a side stream as torch.cuda.graph does, but without its
    # empty_cache(): the allocator's cache stays as the paths left it.
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            for _ in range(batch):
                fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    del graph
    return statistics.median(times)


def host_us(fn, calls=HOST_CALLS, reps=HOST_REPS):
    """µs of the host per call of fn(): time.perf_counter around `calls`
    calls (the median over `reps`), from an idle device, without waiting on
    it. Each call only enqueues work, so this is what the host spends to
    issue one: the wrapper's checks, allocations and launches."""
    return _host_us((fn,), calls, reps)[0]


def _host_us(fns, calls, reps):
    """host_us of each of `fns`, their batches taken in turns, so that a
    change in the host's load falls on all of them alike."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, t in zip(fns, times):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            t.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return [statistics.median(t) for t in times]


def split_times(fn, lib=None, lib_captured=True):
    """The device/host split of a kernel's wrapper fn() and of its library
    call lib(): {"device_ms", "host_us"} and, with lib,
    {"library_device_ms", "library_host_us"}; the two host times are taken
    in turns. lib_captured=False leaves the library call's device time out
    (None): a call that reads the host cannot be captured in a graph."""
    out = dict(device_ms=device_ms(fn))
    if lib is None:
        out["host_us"] = host_us(fn)
        return out
    out["library_device_ms"] = device_ms(lib) if lib_captured else None
    out["host_us"], out["library_host_us"] = _host_us((fn, lib), HOST_CALLS, HOST_REPS)
    return out
