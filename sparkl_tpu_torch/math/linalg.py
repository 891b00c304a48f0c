"""Batched small-matrix helpers (port of the part of sparkl_tpu/math/linalg.py
the slice uses)."""

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
    CPU, the JAX package and the CUDA kernels take; a base cell or a block
    key then changes where x / s lies within an ulp of a rounding edge."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def rdiv(s, x):
    """s / x for a Python number s, as one division (`s / x` on a tensor is
    x.reciprocal() * s in PyTorch, which rounds twice)."""
    return torch.full((), s, dtype=x.dtype, device=x.device) / x
