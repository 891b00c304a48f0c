"""Serial dependency chains against the number of independent chains per
thread (port of scripts/vreg_probe.py).

The TPU probe times an N_OPS-step chain on [R, 128] tiles at several R,
holding the total constant: at R = 8 each op is one vreg and pays its full
latency; larger R pipelines R/8 vregs per op. Here one block of 128
threads takes each [R, 128] tile, one thread per lane, so each thread
carries R independent chains, and the grid has TOTAL_ROWS / R blocks (64 at
R = 128, fewer than the H100's 132 SMs). The sweep asks whether a thread
gains from more independent chains (ILP) or filling the card matters more.

`chain` is the kernel (csrc/probe_kernels.cu, chain_kernel) for a CUDA
tensor and the plain version for a CPU tensor. Run on the GPU:
`python -m sparkl_tpu_torch.scripts.vreg_probe` (raises without one).
"""

import numpy as np
import torch

from sparkl_tpu_torch.cuda_build import check_tensor, launch, route, stream_ptr
from sparkl_tpu_torch.math import linalg
from sparkl_tpu_torch.scripts import card, median_ms

TOTAL_ROWS = 8192  # rows of work, constant across R
C = 128
N_OPS = 1024  # serial chain length
ROWS = (8, 16, 32, 64, 128)  # the R sweep

# The chains' f32 constants, as JAX rounds the script's Python literals.
_A, _B, _K = (float(np.float32(v)) for v in (0.999, 0.001, 0.1))

# Kernel launches since the last reset_launch_counts().
LAUNCHES = {"vreg_chain": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def chain_plain(x, n_ops=N_OPS, transcend=False):
    """The chain in torch ops: n_ops steps of x*0.999 + 0.001, or n_ops // 16
    steps of exp(-|x|) + 0.1*x. Each step is one FMA, as jitted XLA
    contracts it (linalg.fma)."""
    if transcend:
        for _ in range(n_ops // 16):
            x = linalg.fma(x, _K, torch.exp(-torch.abs(x)))
    else:
        for _ in range(n_ops):
            x = linalg.fma(x, _A, _B)
    return x


def _check(x, r, n_ops):
    check_tensor("x", x, torch.float32, (x.shape[0], C), x.device)
    if r not in ROWS:
        raise ValueError(f"R = {r}: the kernel has instances for R in {ROWS}")
    if x.shape[0] == 0 or x.shape[0] % r:
        raise ValueError(f"R = {r} does not divide the {x.shape[0]} rows")
    if n_ops < 0:
        raise ValueError(f"n_ops = {n_ops}")


def chain(x, r, n_ops=N_OPS, transcend=False):
    """The chain over x [rows, 128] f32 in tiles of R rows (replaces
    scripts/vreg_probe.py: probe's pallas_call, _chain_kernel)."""
    _check(x, r, n_ops)
    if route(x.device) == "cpu":
        return chain_plain(x, n_ops, transcend)
    out = torch.empty_like(x)
    launch("sparkl_vreg_chain", x.data_ptr(), out.data_ptr(), x.shape[0], r, n_ops,
           int(bool(transcend)), stream_ptr(x.device))
    LAUNCHES["vreg_chain"] += 1
    return out


def probe(r, transcend):
    """ms per call of the chain kernel at R = r on ones [TOTAL_ROWS, 128]
    (the TPU probe's input): the median of CUDA-event-timed batches."""
    x = torch.ones((TOTAL_ROWS, C), dtype=torch.float32, device=card())
    return median_ms(lambda: chain(x, r, N_OPS, transcend))


def main():
    """Print the TPU script's table; return {(kind, R): ms}."""
    out = {}
    for transcend in (False, True):
        name = "exp-chain" if transcend else "fma-chain"
        base = None
        for r in ROWS:
            ms = probe(r, transcend)
            out[(name, r)] = ms
            base = base or ms
            print(f"{name} R={r:3d}: {ms * 1e3:8.1f} us/call  speedup vs R=8: {base / ms:5.2f}x",
                  flush=True)
    return out


if __name__ == "__main__":
    main()
