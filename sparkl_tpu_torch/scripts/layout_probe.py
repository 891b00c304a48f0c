"""Slot-row access cost of the two candidate slot layouts (port of
scripts/layout_probe.py).

Chunk-major [D, NF, C] is the layout every port kernel keeps (the JAX
package's); field-major [NF, D, C] puts row k of every chunk together. The
read probe sums NROWS rows of each chunk with weights f32(1 + 0.001k); the
read-write probe writes the same rows times f32(1.001) back out, to [D,
NROWS, C] or [NROWS, D, C]. On the TPU a chunk-major row is a sublane
shuffle; here one block of C threads takes each chunk, as the port's slot
kernels do, and a warp reads 128 contiguous bytes of a row in either
layout, so the question is what the layouts' address patterns cost in
device memory.

Each wrapper is the kernel (csrc/probe_kernels.cu) for a CUDA tensor and
its plain version for a CPU tensor. Importing this module runs nothing.
Run on the GPU: `python -m sparkl_tpu_torch.scripts.layout_probe` (raises
without one). PyTorch does not hoist a launch out of a loop, so the TPU
script's carry trick (`x + c` in a scan) has no counterpart: the kernel is
timed alone.
"""

import torch

from sparkl_tpu_torch.cuda_build import check_tensor, launch, route, stream_ptr
from sparkl_tpu_torch.math import linalg
from sparkl_tpu_torch.scripts import card, median_ms

D, NF, C = 6656, 56, 128
NR = 8  # chunks per TPU program; a block here takes one chunk
NROWS = 48  # rows read per chunk (the fused kernels' physics-section scale)
RW_SCALE = 1.001

# Kernel launches since the last reset_launch_counts().
LAUNCHES = {"layout_read": 0, "layout_rw": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def weights(device="cpu"):
    """f32(1 + 0.001k) for k < NROWS: the Python literal, formed in double."""
    return torch.tensor([1.0 + 0.001 * k for k in range(NROWS)], dtype=torch.float32,
                        device=device)


def _rows(x, field_major):
    """Row k of every chunk, [NROWS] views of [D, C]."""
    return [x[k] if field_major else x[:, k] for k in range(NROWS)]


def read_plain(x, field_major):
    """acc[d] = sum_k row_k[d] * w_k in row order, each step one FMA as
    jitted XLA contracts it: [D, C]."""
    w = weights().tolist()
    d = x.shape[1] if field_major else x.shape[0]
    acc = torch.zeros((d, C), dtype=torch.float32, device=x.device)
    for k, row in enumerate(_rows(x, field_major)):
        acc = linalg.fma(row, w[k], acc)
    return acc


def rw_plain(x, field_major):
    """The NROWS rows times f32(1.001): [D, NROWS, C] or [NROWS, D, C]."""
    rows = x[:NROWS] if field_major else x[:, :NROWS]
    return (rows * RW_SCALE).contiguous()


def _check(x, field_major):
    """(D, NF) of x, [NF, D, C] field-major or [D, NF, C] chunk-major."""
    check_tensor("x", x, torch.float32, (*x.shape[:2], C), x.device)
    nf, d = x.shape[:2] if field_major else x.shape[1::-1]
    if nf < NROWS or d == 0:
        raise ValueError(f"x: shape {tuple(x.shape)}: needs {NROWS} rows per chunk and a chunk")
    return d, nf


def _read(x, field_major):
    d, nf = _check(x, field_major)
    if route(x.device) == "cpu":
        return read_plain(x, field_major)
    out = torch.empty((d, C), dtype=torch.float32, device=x.device)
    launch("sparkl_layout_read", x.data_ptr(), out.data_ptr(), d, nf, int(field_major),
           stream_ptr(x.device))
    LAUNCHES["layout_read"] += 1
    return out


def _rw(x, field_major):
    d, nf = _check(x, field_major)
    if route(x.device) == "cpu":
        return rw_plain(x, field_major)
    shape = (NROWS, d, C) if field_major else (d, NROWS, C)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    launch("sparkl_layout_rw", x.data_ptr(), out.data_ptr(), d, nf, int(field_major),
           stream_ptr(x.device))
    LAUNCHES["layout_rw"] += 1
    return out


def read_chunk_major(x):
    """x [D, NF, C] -> [D, C] (replaces scripts/layout_probe.py: bench's
    pallas_call, k_chunk_major)."""
    return _read(x, False)


def read_field_major(x):
    """x [NF, D, C] -> [D, C] (k_field_major)."""
    return _read(x, True)


def rw_chunk_major(x):
    """x [D, NF, C] -> [D, NROWS, C] (replaces scripts/layout_probe.py:
    bench_w's pallas_call, kw_chunk_major)."""
    return _rw(x, False)


def rw_field_major(x):
    """x [NF, D, C] -> [NROWS, D, C] (kw_field_major)."""
    return _rw(x, True)


def _ones(field_major):
    shape = (NF, D, C) if field_major else (D, NF, C)
    return torch.ones(shape, dtype=torch.float32, device=card())


def bench(field_major):
    """ms per call of the read kernel in one layout, on ones (the TPU
    probe's input): the median of CUDA-event-timed batches."""
    x = _ones(field_major)
    fn = read_field_major if field_major else read_chunk_major
    return median_ms(lambda: fn(x))


def bench_w(field_major):
    """ms per call of the read-write kernel in one layout."""
    x = _ones(field_major)
    fn = rw_field_major if field_major else rw_chunk_major
    return median_ms(lambda: fn(x))


def main():
    """Print the TPU script's four lines; return {name: ms}."""
    out = {}
    for name, fn, field_major in (("chunk-major [D,NF,C]", bench, False),
                                  ("field-major [NF,D,C]", bench, True),
                                  ("r+w chunk-major", bench_w, False),
                                  ("r+w field-major", bench_w, True)):
        out[name] = fn(field_major)
        print(f"{name:24s} {out[name]:7.3f} ms", flush=True)
    return out


if __name__ == "__main__":
    main()
