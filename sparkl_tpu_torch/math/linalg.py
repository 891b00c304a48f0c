"""Batched small-matrix helpers (port of the part of sparkl_tpu/math/linalg.py
the slice uses)."""

import numpy as np
import torch


def det(m):
    """Closed-form determinant of batched [..., d, d] matrices (d = 2, 3)."""
    d = m.shape[-1]
    if d == 2:
        return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    if d == 3:
        return (
            m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
        )
    raise ValueError(f"unsupported dim {d}")


def inv_exact(e):
    """1/e with the exact-zero convention 1/0 := 0 (ref: physics.rs
    `inv_exact`): normalizes grid momentum by mass without NaNs on empty
    nodes."""
    zero = e == 0.0
    return torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, e))


def div(x, s):
    """x / s for a Python number s, rounded as one division on every
    device. PyTorch on CUDA divides by a Python number as a product with
    its reciprocal, which can differ in the last bit from the division the
    CPU takes. For a constant of the JAX function the port mirrors (a
    literal, the cell width), div_const is the reference's rounding."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def div_const(x, c):
    """x / c for a constant c of the JAX function this mirrors, rounded as
    jitted XLA rounds it: its algebraic simplifier rewrites a tensor divided
    by a compile-time constant as the product with the f32 reciprocal
    1.0f / f32(c), which differs in the last bit from a true division on
    many inputs (on none when c is a power of two).
    The JAX package runs its pipelines and its Pallas kernels (interpret
    mode too) under jit, so the port takes that product wherever the
    reference divides a tensor by a literal or by a scene constant on a
    substep's rows (kernels A and B's CUDA sources do the same)."""
    return x * float(np.float32(1.0) / np.float32(c))


def fma(a, b, c):
    """a·b + c rounded once, bit for bit a hardware FMA: CUDA's fmaf, and
    what jitted XLA on an x86 CPU with FMA computes for the JAX package's
    a * b + c (its LLVM backend contracts every such pair; measured on
    100,000 of 100,000 random f32 triples). The product of two f32 is exact
    in f64; the sum is formed in f64 with its rounding error (two-sum) and
    rounded to odd, so the f64 result then rounds to f32 correctly. a is an
    f32 tensor; b and c f32 tensors or Python floats taken as they are
    (pass f32 values). The port contracts where a result must match the
    reference to the bit (the corotated dt bound, the heightfield's
    coordinates, the probes' chains) or where a difference cancels
    (neo-Hookean's J² - 1 and tr(F Fᵀ) J^(-2/d) - d); elsewhere it rounds
    each operation, as the CUDA kernels do."""
    s = a.double() * (b.double() if torch.is_tensor(b) else float(b))
    if not torch.is_tensor(c):
        c = torch.full((), float(c), dtype=torch.float64, device=a.device)
    c = c.double()
    t = s + c
    bv = t - s
    err = (s - (t - bv)) + (c - bv)
    even = (t.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, float("inf"), float("-inf")).to(torch.float64)
    t = torch.where((err != 0) & even, torch.nextafter(t, away), t)
    return t.to(a.dtype)


def rdiv(s, x):
    """s / x for a Python number s, as one division (`s / x` on a tensor is
    x.reciprocal() * s in PyTorch, which rounds twice)."""
    return torch.full((), s, dtype=x.dtype, device=x.device) / x
