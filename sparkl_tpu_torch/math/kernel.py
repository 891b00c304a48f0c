"""Quadratic B-spline interpolation kernel (port of sparkl_tpu/math/kernel.py).

Ref: sparkl `src_core/dynamics/solver/kernel.rs:6-136`. The stencil is
anchored at the associated node round(x/h) - 1, so fx lies in [0.5, 1.5)
and the per-axis weights are w0 = 0.5 (1.5 - fx)^2, w1 = 0.75 - (fx - 1)^2,
w2 = 0.5 (fx - 0.5)^2.
"""

import torch


def inv_d(cell_width):
    """APIC inertia-tensor inverse D^-1 = 4/h^2 (ref: kernel.rs `inv_d`)."""
    return 4.0 / (cell_width * cell_width)


def quadratic_weights_1d(fx):
    """(...,) -> (..., 3) weights for stencil offsets {0, 1, 2}."""
    w0 = 0.5 * (1.5 - fx) ** 2
    w1 = 0.75 - (fx - 1.0) ** 2
    w2 = 0.5 * (fx - 0.5) ** 2
    return torch.stack([w0, w1, w2], dim=-1)
