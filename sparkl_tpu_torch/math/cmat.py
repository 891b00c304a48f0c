"""Component-matrix helpers: small matrices as nested lists of tensors
(port of sparkl_tpu/math/cmat.py).

`m[i][j]` is a tensor of any batch shape. The plain versions of the fused
kernels work on [D, C] slot rows in this form, the same way the JAX kernels
do; the CUDA kernels hold the same components in registers.
"""

import torch

from sparkl_tpu_torch.math import linalg


def unpack(m):
    """[..., d, d] tensor -> nested list of [...] tensors."""
    d = m.shape[-1]
    return [[m[..., i, j] for j in range(d)] for i in range(d)]


def pack(rows):
    """Nested list -> [..., d, d] tensor."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def zeros_like_mat(m):
    z = torch.zeros_like(m[0][0])
    d = len(m)
    return [[z for _ in range(d)] for _ in range(d)]


def identity_c(d, like):
    one = torch.ones_like(like)
    zero = torch.zeros_like(like)
    return [[one if i == j else zero for j in range(d)] for i in range(d)]


def det_c(m):
    d = len(m)
    if d == 2:
        return m[0][0] * m[1][1] - m[0][1] * m[1][0]
    return (
        m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
        - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
        + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0])
    )


def matmul_c(a, b):
    d = len(a)
    return [
        [sum(a[i][k] * b[k][j] for k in range(d)) for j in range(d)]
        for i in range(d)
    ]


def matmul_nt_c(a, b):
    """a @ b^T."""
    d = len(a)
    return [
        [sum(a[i][k] * b[j][k] for k in range(d)) for j in range(d)]
        for i in range(d)
    ]


def recompose_c(u, s, v):
    """u @ diag(s) @ v^T."""
    d = len(u)
    return [
        [sum(u[i][k] * s[k] * v[j][k] for k in range(d)) for j in range(d)]
        for i in range(d)
    ]


def aat_c(a):
    """a @ a^T."""
    return matmul_nt_c(a, a)


def scale_c(m, k):
    return [[mij * k for mij in row] for row in m]


def add_c(a, b):
    d = len(a)
    return [[a[i][j] + b[i][j] for j in range(d)] for i in range(d)]


def add_diag_c(m, k):
    d = len(m)
    return [
        [m[i][j] + k if i == j else m[i][j] for j in range(d)] for i in range(d)
    ]


def where_mat(cond, a, b):
    d = len(a)
    return [
        [torch.where(cond, a[i][j], b[i][j]) for j in range(d)] for i in range(d)
    ]


def frob2_c(m):
    """Squared Frobenius norm."""
    return sum(sum(x * x for x in row) for row in m)


def trace_c(m):
    return sum(m[i][i] for i in range(len(m)))


def deviatoric_c(m):
    """m - (tr(m)/d) I. Ref: physics.rs `deviatoric_part`."""
    d = len(m)
    sph = linalg.div_const(trace_c(m), d)
    return add_diag_c(m, -sph)


def strain_rate_c(g):
    """Symmetric part. Ref: physics.rs `strain_rate`."""
    d = len(g)
    return [[0.5 * (g[i][j] + g[j][i]) for j in range(d)] for i in range(d)]


def safe_div(a, b, eps=1e-20):
    good = torch.abs(b) > eps
    return torch.where(good, a / torch.where(good, b, 1.0), 0.0)


def pow_pos(x, p, tiny=1e-30):
    """x**p for x > 0 as exp(p·log(max(x, tiny))), the JAX package's form
    (not torch.pow: the EOS pressure multiplies this rounding by p₀)."""
    return torch.exp(p * torch.log(torch.clamp(x, min=tiny)))


def sinh_c(x):
    """sinh(x) as 0.5 (e^x - 1/e^x), the JAX package's form (NACC's
    hardened p0)."""
    e = torch.exp(x)
    return 0.5 * (e - linalg.rdiv(1.0, e))
