"""Branch-free 2x2 and 3x3 SVD on component matrices (port of
sparkl_tpu/math/svd.py: the 2x2 closed form `svd2x2_c`, and the cardano
path `svd_c` -> `svd3x3_c` -> `_sym_eig3x3_cardano`).

2x2: polar decomposition F = R S in closed form, then the symmetric
eigendecomposition of S by one algebraic Givens rotation; a negative
eigenvalue (det F < 0) flips its sign into U.

Semantics of nalgebra's `svd_unordered` as the reference uses it: singular
values non-negative and descending here, reflections pushed into U,
U diag(s) V^T = F. Eigenvalues of F^T F by the trigonometric Cardano formula
(with cos(acos(r)/3) from a polynomial seed and two Newton steps, as the JAX
package computes it) refined through the invariants; eigenvectors by
max-norm row cross products. The Jacobi backend of the JAX package is not
ported yet.

The kernels' CUDA copy of this code is csrc/particle_physics.cuh.
"""

import torch

from sparkl_tpu_torch.math import linalg


def _cos_acos3(r):
    """cos(acos(r)/3) for r in [-1, 1]: the root of 4x^3 - 3x = r in
    [1/2, 1], from a degree-4 seed in sqrt(1 + r) and two clamped Newton
    steps."""
    u = torch.sqrt(torch.clamp(r + 1.0, min=0.0))
    x = 0.500019159 + u * (
        0.407814278 + u * (-0.0531768362 + u * (0.0135525949 + u * -0.00218724162))
    )
    x = torch.clamp(x, 0.5, 1.0)
    for _ in range(2):
        g = 4.0 * x * x * x - 3.0 * x - r
        gp = torch.clamp(12.0 * x * x - 3.0, min=0.075)
        x = torch.clamp(x - g / gp, 0.5, 1.0)
    return x


def _cardano_trig_vals(a00, a01, a02, a11, a12, a22):
    """Raw trigonometric-Cardano eigenvalues, descending. The divisions by
    3 and 6 stay true divisions (the eager JAX function's), not jitted
    XLA's products with f32(1/3) and f32(1/6): jitted, the reference also
    contracts this function's multiply-adds into FMAs, so the products do
    not reach its bits, and they move the crushed singular value of a
    near-singular F by 3e-5 of the largest against either form."""
    q = linalg.div(a00 + a11 + a22, 3.0)
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (
        a01 * a01 + a02 * a02 + a12 * a12
    )
    p = torch.sqrt(torch.clamp(linalg.div(p2, 6.0), min=0.0))
    p_ok = p > 1e-30
    pinv = torch.where(p_ok, 1.0 / torch.where(p_ok, p, 1.0), 0.0)
    c00, c11, c22 = b00 * pinv, b11 * pinv, b22 * pinv
    c01, c02, c12 = a01 * pinv, a02 * pinv, a12 * pinv
    detb = (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    r = torch.clamp(0.5 * detb, -1.0, 1.0)
    cphi = _cos_acos3(r)
    sphi = torch.sqrt(torch.clamp(1.0 - cphi * cphi, min=0.0))
    l0 = q + 2.0 * p * cphi
    l2 = q + 2.0 * p * (-0.5 * cphi - 0.8660254037844386 * sphi)
    l1 = 3.0 * q - l0 - l2
    return l0, l1, l2


def _cardano_refined_vals(a00, a01, a02, a11, a12, a22):
    """Descending eigenvalues of a PSD symmetric 3x3: Cardano, then the
    small ones recovered from det (l2) and the second invariant (l1)."""
    l0, l1, l2 = _cardano_trig_vals(a00, a01, a02, a11, a12, a22)
    i2 = (
        a00 * a11 - a01 * a01
        + a00 * a22 - a02 * a02
        + a11 * a22 - a12 * a12
    )
    i3 = (
        a00 * (a11 * a22 - a12 * a12)
        - a01 * (a01 * a22 - a12 * a02)
        + a02 * (a01 * a12 - a11 * a02)
    )
    tiny = 1e-30

    def refine_l2(l1v):
        den = l0 * l1v
        ok = den > tiny
        out = torch.minimum(
            torch.clamp(i3 / torch.where(ok, den, 1.0), min=0.0), l1v
        )
        return torch.where(ok, out, torch.clamp(l2, min=0.0))

    l2r = refine_l2(torch.clamp(l1, min=0.0))
    den1 = l0 + l2r
    ok1 = den1 > tiny
    l1r = torch.minimum(
        torch.maximum((i2 - l0 * l2r) / torch.where(ok1, den1, 1.0), l2r), l0
    )
    l1 = torch.where(ok1, l1r, torch.clamp(l1, min=0.0))
    l2 = refine_l2(l1)
    return l0, l1, l2


def _cross(x, y):
    return (
        x[1] * y[2] - x[2] * y[1],
        x[2] * y[0] - x[0] * y[2],
        x[0] * y[1] - x[1] * y[0],
    )


def _sym_eig3x3_cardano(a00, a01, a02, a11, a12, a22):
    """([l0, l1, l2] descending, [v0, v1, v2] eigenvector columns)."""
    one = torch.ones_like(a00)
    zero = torch.zeros_like(a00)
    l0, l1, l2 = _cardano_refined_vals(a00, a01, a02, a11, a12, a22)

    def row_cross_null(lv):
        r0 = (a00 - lv, a01, a02)
        r1 = (a01, a11 - lv, a12)
        r2 = (a02, a12, a22 - lv)
        c01_, c02_, c12_ = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)

        def n2(x):
            return x[0] * x[0] + x[1] * x[1] + x[2] * x[2]

        n01, n02, n12 = n2(c01_), n2(c02_), n2(c12_)
        use02 = n02 > n01
        best = tuple(torch.where(use02, c02_[i], c01_[i]) for i in range(3))
        bestn = torch.where(use02, n02, n01)
        use12 = n12 > bestn
        return tuple(torch.where(use12, c12_[i], best[i]) for i in range(3))

    cand_t = row_cross_null(l0)
    cand_b = row_cross_null(l2)
    use_top = (l0 - l1) >= (l1 - l2)
    anchor_raw = tuple(torch.where(use_top, cand_t[i], cand_b[i]) for i in range(3))
    other_raw = tuple(torch.where(use_top, cand_b[i], cand_t[i]) for i in range(3))

    def normalize(x):
        n2v = x[0] * x[0] + x[1] * x[1] + x[2] * x[2]
        good = n2v > 1e-20
        # 1/sqrt rather than rsqrt: the same rounding on every device.
        inv = torch.where(good, 1.0 / torch.sqrt(torch.where(good, n2v, 1.0)), 0.0)
        return tuple(xi * inv for xi in x), good

    anchor, a_good = normalize(anchor_raw)
    anchor = (
        torch.where(a_good, anchor[0], one),
        torch.where(a_good, anchor[1], zero),
        torch.where(a_good, anchor[2], zero),
    )
    dot = sum(o * a for o, a in zip(other_raw, anchor))
    other, o_good = normalize(tuple(o - dot * a for o, a in zip(other_raw, anchor)))
    # Fallback: unit vector orthogonal to anchor via the least-aligned axis.
    au = (torch.abs(anchor[0]), torch.abs(anchor[1]), torch.abs(anchor[2]))
    pick0 = (au[0] <= au[1]) & (au[0] <= au[2])
    pick1 = (~pick0) & (au[1] <= au[2])
    e = (
        torch.where(pick0, one, zero),
        torch.where(pick1, one, zero),
        torch.where(pick0 | pick1, zero, one),
    )
    fb, _ = normalize(_cross(anchor, e))
    other = tuple(torch.where(o_good, other[i], fb[i]) for i in range(3))

    # Middle column = cross of the outer two, signed so det(V) = +1.
    ms = torch.where(use_top, -1.0, 1.0)
    mid = tuple(ms * c for c in _cross(anchor, other))
    v0 = tuple(torch.where(use_top, anchor[i], other[i]) for i in range(3))
    v2 = tuple(torch.where(use_top, other[i], anchor[i]) for i in range(3))
    return [l0, l1, l2], [v0, mid, v2]


def _svd3x3_from_eig(f, sig2, cols):
    """sigma = sqrt(eig); U from F v_k with orthonormal fallbacks for
    (near-)singular F."""
    s = [torch.sqrt(x) for x in sig2]

    def matvec(x):
        return tuple(f[i][0] * x[0] + f[i][1] * x[1] + f[i][2] * x[2] for i in range(3))

    fv0, fv1, fv2 = matvec(cols[0]), matvec(cols[1]), matvec(cols[2])
    eps = 1e-12

    def normalize3(x):
        n = torch.sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2])
        good = n > eps
        inv = torch.where(good, 1.0 / torch.where(good, n, 1.0), 0.0)
        return tuple(xi * inv for xi in x), good

    u0, good0 = normalize3(fv0)
    u0 = (
        torch.where(good0, u0[0], 1.0),
        torch.where(good0, u0[1], 0.0),
        torch.where(good0, u0[2], 0.0),
    )
    dot01 = u0[0] * fv1[0] + u0[1] * fv1[1] + u0[2] * fv1[2]
    u1, good1 = normalize3(tuple(fv1[i] - dot01 * u0[i] for i in range(3)))
    au = (torch.abs(u0[0]), torch.abs(u0[1]), torch.abs(u0[2]))
    pick0 = (au[0] <= au[1]) & (au[0] <= au[2])
    pick1 = (~pick0) & (au[1] <= au[2])
    e = (
        torch.where(pick0, 1.0, 0.0),
        torch.where(pick1, 1.0, 0.0),
        torch.where(pick0 | pick1, 0.0, 1.0),
    )
    fb, _ = normalize3(_cross(u0, e))
    u1 = tuple(torch.where(good1, u1[i], fb[i]) for i in range(3))
    u2d = _cross(u0, u1)
    sgn = u2d[0] * fv2[0] + u2d[1] * fv2[1] + u2d[2] * fv2[2]
    sgn = torch.where(sgn < 0.0, -1.0, 1.0)
    u2 = tuple(x * sgn for x in u2d)

    def cols_to_rows(c0, c1, c2):
        return [[c0[i], c1[i], c2[i]] for i in range(3)]

    return cols_to_rows(u0, u1, u2), s, cols_to_rows(*cols)


def svd3x3_c(f):
    """Component-wise SVD of a nested-list 3x3 matrix: (u, s, v)."""
    f00, f01, f02 = f[0]
    f10, f11, f12 = f[1]
    f20, f21, f22 = f[2]
    a00 = f00 * f00 + f10 * f10 + f20 * f20
    a11 = f01 * f01 + f11 * f11 + f21 * f21
    a22 = f02 * f02 + f12 * f12 + f22 * f22
    a01 = f00 * f01 + f10 * f11 + f20 * f21
    a02 = f00 * f02 + f10 * f12 + f20 * f22
    a12 = f01 * f02 + f11 * f12 + f21 * f22
    scale = torch.clamp(
        torch.maximum(torch.maximum(torch.abs(a00), torch.abs(a11)), torch.abs(a22)),
        min=1e-30,
    )
    inv_scale = 1.0 / scale
    a00, a11, a22 = a00 * inv_scale, a11 * inv_scale, a22 * inv_scale
    a01, a02, a12 = a01 * inv_scale, a02 * inv_scale, a12 * inv_scale
    lam, vcols = _sym_eig3x3_cardano(a00, a01, a02, a11, a12, a22)
    sig2 = [torch.clamp(lv, min=0.0) * scale for lv in lam]
    return _svd3x3_from_eig(f, sig2, [list(v) for v in vcols])


def svd2x2_c(f):
    """Component-wise SVD of a nested-list 2x2 matrix (sparkl_tpu/math/svd.py
    svd2x2_c): (u, s, v) with f = u diag(s) v^T, s >= 0 (unsorted),
    det(u) det(v) = sign(det f). 1/sqrt stands for the JAX package's rsqrt,
    which its CPU backend computes so."""
    a, b = f[0][0], f[0][1]
    c, d = f[1][0], f[1][1]

    # Polar decomposition F = R S with R a rotation.
    x = a + d
    y = c - b
    r = torch.sqrt(x * x + y * y)
    ok = r > 1e-20
    r_safe = torch.where(ok, r, 1.0)
    cr = torch.where(ok, x / r_safe, 1.0)
    sr = torch.where(ok, y / r_safe, 0.0)
    s00 = cr * a + sr * c
    s01 = cr * b + sr * d
    s11 = -sr * b + cr * d

    # S = G diag(l) G^T by one algebraic Givens rotation.
    diff = s00 - s11
    denom_ok = torch.abs(s01) > 1e-30
    tau = diff / torch.where(denom_ok, 2.0 * s01, 1.0)
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, 1.0, t)
    t = torch.where(denom_ok, t, 0.0)
    ct = 1.0 / torch.sqrt(1.0 + t * t)
    st = t * ct
    l0 = ct * ct * s00 + 2.0 * ct * st * s01 + st * st * s11
    l1 = st * st * s00 - 2.0 * ct * st * s01 + ct * ct * s11

    # V = G, U = R G; a negative eigenvalue flips its sign into U.
    v00, v01 = ct, -st
    v10, v11 = st, ct
    u00 = cr * v00 - sr * v10
    u01 = cr * v01 - sr * v11
    u10 = sr * v00 + cr * v10
    u11 = sr * v01 + cr * v11
    sign0 = torch.where(l0 < 0.0, -1.0, 1.0)
    sign1 = torch.where(l1 < 0.0, -1.0, 1.0)
    return ([[u00 * sign0, u01 * sign1], [u10 * sign0, u11 * sign1]],
            [l0 * sign0, l1 * sign1], [[v00, v01], [v10, v11]])


def svd_c(f):
    """Component-core SVD dispatch on the matrix size (2 or 3)."""
    if len(f) == 2:
        return svd2x2_c(f)
    return svd3x3_c(f)


def _stack(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def svd2x2(f):
    """SVD of [..., 2, 2] matrices: (u, s [..., 2], v), f = u diag(s) v^T."""
    u, s, v = svd2x2_c([[f[..., i, j] for j in range(2)] for i in range(2)])
    return _stack(u), torch.stack(s, dim=-1), _stack(v)


def svd3x3(f):
    """SVD of [..., 3, 3] matrices: (u, s [..., 3], v), f = u diag(s) v^T."""
    u, s, v = svd3x3_c([[f[..., i, j] for j in range(3)] for i in range(3)])
    return _stack(u), torch.stack(s, dim=-1), _stack(v)


def svd(f):
    """Dispatch on the trailing matrix size (2 or 3)."""
    if f.shape[-1] == 2:
        return svd2x2(f)
    if f.shape[-1] == 3:
        return svd3x3(f)
    raise NotImplementedError(f"svd of {f.shape[-1]}x{f.shape[-1]} matrices")


def sym_eigvals2x2_c(m):
    """Eigenvalues [min, max] of a symmetric 2x2 nested-list matrix (closed
    form)."""
    a, b, c = m[0][0], m[0][1], m[1][1]
    mean = 0.5 * (a + c)
    r = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    return [mean - r, mean + r]


def sym_eigvals3x3_c(m):
    """Eigenvalues of a symmetric 3x3 nested-list matrix (the cardano
    backend): the trigonometric Cardano values of m scaled by its largest
    diagonal magnitude."""
    a00, a11, a22 = m[0][0], m[1][1], m[2][2]
    a01, a02, a12 = m[0][1], m[0][2], m[1][2]
    scale = torch.clamp(
        torch.maximum(torch.maximum(torch.abs(a00), torch.abs(a11)), torch.abs(a22)), min=1e-30
    )
    inv = 1.0 / scale
    lam = _cardano_trig_vals(a00 * inv, a01 * inv, a02 * inv, a11 * inv, a12 * inv, a22 * inv)
    return [x * scale for x in lam]


def svd_values_c(f):
    """Singular values only (unordered), for invariants of F (the corotated
    pos energy): the 2x2 closed form's, or in 3x3 the square roots of the
    eigenvalues of F^T F, skipping the U/V construction."""
    if len(f) == 2:
        return svd2x2_c(f)[1]
    a = [[sum(f[k][i] * f[k][j] for k in range(3)) for j in range(3)] for i in range(3)]
    return [torch.sqrt(torch.clamp(x, min=0.0)) for x in sym_eigvals3x3_c(a)]
