"""Plastic return maps on the singular values of the deformation gradient
(port of sparkl_tpu/models/plasticity.py: Drucker-Prager, NACC, Rankine
and Snow), 2D and 3D.

Each map is branch-free (selects, not early returns) and has a
component-wise core (`*_update_c`, nested-list matrices and per-particle
parameter tensors) that kernel B's plain version composes; the array API
wraps it. Ref: sparkl `src_core/dynamics/models/plasticity_drucker_prager.rs:10-105`,
`plasticity_nacc.rs:12-166`, `plasticity_rankine.rs`, `plasticity_snow.rs`.
"""

import math

import torch

from sparkl_tpu_torch.math import cmat, linalg
from sparkl_tpu_torch.math.svd import svd_c

PLASTIC_NONE = 0
DRUCKER_PRAGER = 1
NACC = 2
RANKINE = 3
SNOW = 4
PLASTIC_CUSTOM_BASE = 16

_safe_div = cmat.safe_div


def drucker_prager_alpha(h0, h1, h2, h3, q):
    """α(q) = √(2/3)·2 sin(angle) / (3 - sin(angle)),
    angle = h0 + (h1·q - h3)·e^(-h2·q)."""
    angle = h0 + (h1 * q - h3) * torch.exp(-h2 * q)
    s = torch.sin(angle)
    return math.sqrt(2.0 / 3.0) * (2.0 * s) / (3.0 - s)


def drucker_prager_update(params, phase, f, plastic_def_det, plastic_hardening, log_vol_gain):
    """DP return map of [..., d, d] matrices; params [..., 8] rows [h0, h1,
    h2, h3, lambda, mu, only_when_failed, vol_corr]. Returns (f, pdd, ph,
    lvg)."""
    fc, pdd, ph, lvg = drucker_prager_update_c(
        [params[..., k] for k in range(8)], phase, cmat.unpack(f), plastic_def_det,
        plastic_hardening, log_vol_gain,
    )
    return cmat.pack(fc), pdd, ph, lvg


def drucker_prager_update_c(params, phase, f, plastic_def_det, plastic_hardening, log_vol_gain):
    """Component-wise core; params = list of 8 scalars."""
    out = drucker_prager_update_with_svd_c(
        params, phase, f, plastic_def_det, plastic_hardening, log_vol_gain, svd_c(f)
    )
    return out[:4]


def drucker_prager_project_s_c(
    params, phase, s, plastic_def_det, plastic_hardening, log_vol_gain
):
    """DP return map on the singular values s. params = [h0, h1, h2, h3,
    lambda, mu, only_when_failed, vol_corr]. Returns (s_sel, new_pdd,
    new_ph, new_lvg, applied): s_sel = projected singular values where
    `applied`, else s."""
    h0, h1, h2, h3, lam, mu, only_when_failed, vol_corr = params
    d = len(s)
    alpha = drucker_prager_alpha(h0, h1, h2, h3, plastic_hardening)

    strain = [torch.log(torch.clamp(si, min=1e-20)) + linalg.div_const(log_vol_gain, d) for si in s]
    strain_trace = sum(strain)
    dev = [e - linalg.div_const(strain_trace, d) for e in strain]
    dev_norm = torch.sqrt(sum(e * e for e in dev))

    # Case A: zero deviatoric strain or expanding trace -> identity.
    case_a = (dev_norm == 0.0) | (strain_trace > 0.0)
    dq_a = torch.sqrt(sum(e * e for e in strain))
    # Case B: inside the yield surface -> no change.
    gamma = dev_norm + (d * lam + 2.0 * mu) / (2.0 * mu) * strain_trace * alpha
    case_b = (~case_a) & (gamma <= 0.0)
    # Case C: project onto the cone.
    s_c = [torch.exp(e - gamma * _safe_div(dv, dev_norm)) for e, dv in zip(strain, dev)]

    one = torch.ones_like(s[0])
    new_s = [torch.where(case_a, one, sc) for sc in s_c]
    dq = torch.where(case_a, dq_a, gamma)

    applied = (~case_b) & ((only_when_failed == 0.0) | (phase == 0.0))

    prev_det = s[0]
    new_det0 = new_s[0]
    for k in range(1, d):
        prev_det = prev_det * s[k]
        new_det0 = new_det0 * new_s[k]
    diff = new_det0 - prev_det
    new_det = torch.where(diff > 0.0, new_det0, prev_det + diff * vol_corr)

    det_ratio = _safe_div(prev_det, new_det)
    new_plastic_def_det = plastic_def_det * torch.where(applied, det_ratio, 1.0)
    new_log_vol_gain = log_vol_gain + torch.where(
        applied,
        torch.log(torch.clamp(prev_det, min=1e-30))
        - torch.log(torch.clamp(new_det, min=1e-30)),
        0.0,
    )
    new_hardening = plastic_hardening + torch.where(applied, dq, 0.0)
    s_sel = [torch.where(applied, ns, si) for ns, si in zip(new_s, s)]
    return s_sel, new_plastic_def_det, new_hardening, new_log_vol_gain, applied


def drucker_prager_update_with_svd_c(
    params, phase, f, plastic_def_det, plastic_hardening, log_vol_gain, usv
):
    """DP return map with a caller-supplied SVD of f. Returns (f_new, pdd,
    ph, lvg, s_sel); f_new = U diag(s_sel) Vᵀ where the map applied."""
    u, s, v = usv
    s_sel, new_pdd, new_ph, new_lvg, applied = drucker_prager_project_s_c(
        params, phase, s, plastic_def_det, plastic_hardening, log_vol_gain
    )
    f_new = cmat.where_mat(applied, cmat.recompose_c(u, s_sel, v), f)
    return f_new, new_pdd, new_ph, new_lvg, s_sel


# ---------------------------------------------------------------------------
# NACC (non-associated Cam-Clay)
# ---------------------------------------------------------------------------

# nacc_project_c's case codes: A the max tip, B the min tip, C inside the
# yield surface (F kept), D projection onto it.
NACC_TIP_MAX, NACC_TIP_MIN, NACC_INSIDE, NACC_PROJECT = 0, 1, 2, 3


def nacc_update(params, f, nacc_alpha):
    """NACC return map of [..., d, d] matrices; params [..., 6] rows [mu,
    kappa, hardening_enabled, xi, beta, M]. Returns (f, nacc_alpha)."""
    fc, na = nacc_update_c([params[..., k] for k in range(6)], cmat.unpack(f), nacc_alpha)
    return cmat.pack(fc), na


def nacc_update_c(params, f, nacc_alpha):
    """Component-wise core; params = list of 6 scalars. Returns (f,
    nacc_alpha)."""
    return nacc_project_c(params, f, nacc_alpha)[:2]


def nacc_margin(kappa, beta, p0, p_tr, y_terms, j_e_x, tips, gate):
    """How close a lane's NACC decisions lie to their thresholds, over the
    decisions that choose its result: |p_tr - p0| and |p_tr + β p0| (the
    tips, every lane) over κ, a J-equivalent strain (p_tr ~ κ (1 - J));
    where neither tip is taken, |y - 1e-4| over the magnitude of y's two
    terms (inside or projected); where the projection hardens or could
    (`gate`: case D with hardening on), |p_tr - (p0 - 1e-4)|, |p_tr - (-β
    p0 + 1e-4)| and |p0 - 1e-4| over κ, and |J_x - 1e-4|. Two computations
    of the same lane (another rounding of F, exp or log) may decide
    differently only where this is near their rounding."""
    y0s, y1 = y_terms
    k = torch.clamp(torch.abs(kappa), min=1e-30)
    out = torch.minimum(torch.abs(p_tr - p0) / k, torch.abs(p_tr + beta * p0) / k)
    far = torch.full_like(out, float("inf"))
    y = torch.abs(y0s + y1 - 1.0e-4) / torch.clamp(torch.abs(y0s) + torch.abs(y1), min=1e-30)
    out = torch.minimum(out, torch.where(tips, far, y))
    g = torch.minimum(torch.abs(p_tr - (p0 - 1.0e-4)) / k,
                      torch.abs(p_tr - (-beta * p0 + 1.0e-4)) / k)
    g = torch.minimum(g, torch.minimum(torch.abs(p0 - 1.0e-4) / k, torch.abs(j_e_x - 1.0e-4)))
    return torch.minimum(out, torch.where(gate, g, far))


def nacc_project_c(params, f, nacc_alpha):
    """NACC on its own SVD of f (ref: plasticity_nacc.rs
    `project_deformation_gradient`): the trial pressure p_tr and deviatoric
    Kirchhoff stress from the elastic J and singular values, p0 = κ(1e-5 +
    sinh(ξ max(-α, 0))); case A (p_tr > p0) and B (p_tr < -β p0) move the
    singular values to the max or min tip, C (the yield function y < 1e-4)
    keeps F, D projects onto the yield surface along the line to its
    centre. With hardening, α gains ln(J / J_new) (in D only where p0 >
    1e-4, p_tr within the tips by 1e-4 and the projected J > 1e-4). Returns
    (f, nacc_alpha, case, margin): the case codes above, and nacc_margin
    of the lane's decisions."""
    mu, kappa, hardening_flag, xi, beta, m = params
    hardening_enabled = hardening_flag != 0.0
    d = float(len(f))

    u, s, v = svd_c(f)
    sq = [si * si for si in s]
    sq_trace = sum(sq)

    p0 = kappa * (1.0e-5 + cmat.sinh_c(xi * torch.clamp(-nacc_alpha, min=0.0)))
    j_e_tr = s[0]
    for si in s[1:]:
        j_e_tr = j_e_tr * si
    safe_j = torch.clamp(j_e_tr, min=1e-20)
    s_tr_coeff = mu * cmat.pow_pos(safe_j, -2.0 / d)
    s_tr = [s_tr_coeff * (q - linalg.div_const(sq_trace, d)) for q in sq]
    psi_kappa = kappa / 2.0 * (j_e_tr - linalg.rdiv(1.0, safe_j))
    p_tr = -psi_kappa * j_e_tr

    # Case A: the max tip.
    j_a = torch.sqrt(torch.clamp(-2.0 * p0 / kappa + 1.0, min=0.0))
    s_a = cmat.pow_pos(torch.clamp(j_a, min=1e-20), 1.0 / d)
    alpha_a = nacc_alpha + torch.where(
        hardening_enabled, torch.log(safe_j / torch.clamp(j_a, min=1e-20)), 0.0)
    # Case B: the min tip.
    j_b = torch.sqrt(2.0 * beta * p0 / kappa + 1.0)
    s_b = cmat.pow_pos(torch.clamp(j_b, min=1e-20), 1.0 / d)
    alpha_b = nacc_alpha + torch.where(
        hardening_enabled, torch.log(safe_j / torch.clamp(j_b, min=1e-20)), 0.0)

    # The yield function.
    y0 = (1.0 + 2.0 * beta) * ((6.0 - d) / 2.0)
    y1 = m * m * (p_tr + beta * p0) * (p_tr - p0)
    s_tr_norm_sq = sum(x * x for x in s_tr)
    y = y0 * s_tr_norm_sq + y1

    # Case D: the projection, with optional hardening.
    p_c = (1.0 - beta) * p0 / 2.0
    q_tr = math.sqrt((6.0 - d) / 2.0) * torch.sqrt(s_tr_norm_sq)
    dir0 = p_c - p_tr
    dir1 = 0.0 - q_tr
    dir_norm = torch.sqrt(dir0 * dir0 + dir1 * dir1)
    dir0 = _safe_div(dir0, dir_norm)
    dir1 = _safe_div(dir1, dir_norm)
    c_q = m * m * (p_c + beta * p0) * (p_c - p0)
    b_q = m * m * dir0 * (2.0 * p_c - p0 + beta * p0)
    a_q = m * m * dir0 * dir0 + (1.0 + 2.0 * beta) * dir1 * dir1
    discr = torch.sqrt(torch.clamp(b_q * b_q - 4.0 * a_q * c_q, min=0.0))
    l1 = _safe_div(-b_q + discr, 2.0 * a_q)
    l2 = _safe_div(-b_q - discr, 2.0 * a_q)
    p1 = p_c + l1 * dir0
    p2 = p_c + l2 * dir0
    p_x = torch.where((p_tr - p_c) * (p1 - p_c) > 0.0, p1, p2)
    j_e_x = torch.sqrt(torch.abs(-2.0 * p_x / kappa + 1.0))
    do_hardening = (hardening_enabled & (p0 > 1.0e-4) & (p_tr < p0 - 1.0e-4)
                    & (p_tr > -beta * p0 + 1.0e-4) & (j_e_x > 1.0e-4))
    alpha_d = nacc_alpha + torch.where(
        do_hardening, torch.log(safe_j / torch.clamp(j_e_x, min=1e-20)), 0.0)
    s_tr_norm = torch.sqrt(s_tr_norm_sq)
    b_coeff = (torch.sqrt(torch.clamp(_safe_div(-y1, y0), min=0.0))
               * cmat.pow_pos(safe_j, 2.0 / d) / torch.clamp(mu, min=1e-20))
    s_d = [torch.sqrt(torch.clamp(b_coeff * _safe_div(x, s_tr_norm)
                                  + linalg.div_const(sq_trace, d), min=0.0)) for x in s_tr]

    case_a = p_tr > p0
    case_b = (~case_a) & (p_tr < -beta * p0)
    case_c = (~case_a) & (~case_b) & (y < 1.0e-4)
    case_d = (~case_a) & (~case_b) & (~case_c)
    new_s = [torch.where(case_a, s_a, torch.where(case_b, s_b, torch.where(case_d, sd, si)))
             for sd, si in zip(s_d, s)]
    new_alpha = torch.where(case_a, alpha_a, torch.where(
        case_b, alpha_b, torch.where(case_d, alpha_d, nacc_alpha)))
    case = torch.where(case_a, NACC_TIP_MAX, torch.where(
        case_b, NACC_TIP_MIN, torch.where(case_c, NACC_INSIDE, NACC_PROJECT)))
    f_new = cmat.where_mat(~case_c, cmat.recompose_c(u, new_s, v), f)
    margin = nacc_margin(kappa, beta, p0, p_tr, (y0 * s_tr_norm_sq, y1), j_e_x,
                         case_a | case_b, case_d & hardening_enabled)
    return f_new, new_alpha, case, margin


# ---------------------------------------------------------------------------
# Rankine (tensile softening)
# ---------------------------------------------------------------------------


def rankine_update(params, f, plastic_hardening):
    """Rankine return map of [..., d, d] matrices; params [..., 4] rows [mu,
    lambda, tensile_strength, softening_rate]. Returns (f, ph)."""
    fc, ph = rankine_update_c([params[..., k] for k in range(4)], cmat.unpack(f),
                              plastic_hardening)
    return cmat.pack(fc), ph


def rankine_update_c(params, f, plastic_hardening):
    """Caps the principal Hencky strains at the softened tensile strength
    and accumulates the softening into plastic_hardening. The ascending sort
    and its inverse are comparison networks on a stable rank (ties keep the
    original order); in 2D the second-largest value e2 aliases the smaller
    one (the reference's index list [0, 1, DIM - 1]), as the JAX package
    takes it."""
    mu, lam, tensile_strength, softening_rate = params
    d = len(f)

    u, s, v = svd_c(f)
    eigv = [torch.log(torch.clamp(si, min=1e-20)) for si in s]

    def rank_of(i):
        r = torch.zeros_like(eigv[0], dtype=torch.int32)
        for j in range(d):
            if j != i:
                less = (eigv[j] < eigv[i]) | ((eigv[j] == eigv[i]) & (j < i))
                r = r + less.to(torch.int32)
        return r

    ranks = [rank_of(i) for i in range(d)]
    es = []
    for r in range(d):
        val = torch.zeros_like(eigv[0])
        for i in range(d):
            val = val + torch.where(ranks[i] == r, eigv[i], 0.0)
        es.append(val)

    e_sum = sum(eigv)
    e1, e2, e3 = es[-1], es[-2], es[0]
    soft = tensile_strength - (plastic_hardening - 1.0)

    case0 = lam * e_sum + 2.0 * mu * e1 <= soft
    cond1 = (2.0 * mu + lam) * e2 + lam * (e_sum - e1) <= soft
    new_e1_c1 = (soft - lam * (e_sum - e1)) / (2.0 * mu + lam)
    if d == 3:
        cond2 = (2.0 * mu + 3.0 * lam) * e3 <= soft
        new_e12_c2 = (soft - lam * (e_sum - e1 - e2)) / (2.0 * mu + 2.0 * lam)
    else:
        cond2 = torch.zeros_like(case0)
        new_e12_c2 = torch.zeros_like(e1)
    new_e_c3 = soft / (2.0 * mu + 3.0 * lam)

    es_new = []
    for r in range(d):
        base = es[r]
        c1 = new_e1_c1 if r == d - 1 else base
        c2 = new_e12_c2 if (d == 3 and r >= d - 2) else base
        es_new.append(torch.where(case0, base, torch.where(
            cond1, c1, torch.where(cond2, c2, new_e_c3))))

    eigv_new = []
    for i in range(d):
        val = torch.zeros_like(eigv[0])
        for r in range(d):
            val = val + torch.where(ranks[i] == r, es_new[r], 0.0)
        eigv_new.append(val)

    delta_sq = sum((a - b) ** 2 for a, b in zip(eigv, eigv_new))
    dh = softening_rate * torch.sqrt(delta_sq)
    new_hardening = torch.where(case0, plastic_hardening, plastic_hardening + dh)
    new_hardening = torch.minimum(new_hardening, tensile_strength)

    f_proj = cmat.recompose_c(u, [torch.exp(e) for e in eigv_new], v)
    return cmat.where_mat(case0, f, f_proj), new_hardening


# ---------------------------------------------------------------------------
# Snow
# ---------------------------------------------------------------------------


def snow_update(params, f, elastic_hardening, plastic_def_det):
    """Snow clamp of [..., d, d] matrices; params [..., 3] rows [min_epsilon,
    max_epsilon, hardening_coeff]. Returns (f, eh, pdd)."""
    fc, eh, pdd = snow_update_c([params[..., k] for k in range(3)], cmat.unpack(f),
                                elastic_hardening, plastic_def_det)
    return cmat.pack(fc), eh, pdd


def snow_update_c(params, f, elastic_hardening, plastic_def_det):
    """Clamps the singular values to [1 - min_eps, 1 + max_eps], moves the
    clamped volume change into plastic_def_det, and sets the elastic
    hardening to exp(coeff (1 - plastic_def_det)). F is always rebuilt from
    its SVD, clamped or not, as the JAX package does."""
    min_eps, max_eps, hard_coeff = params
    u, s, v = svd_c(f)
    new_s = [torch.clamp(si, min=1.0 - min_eps, max=1.0 + max_eps) for si in s]
    prod_s, prod_new = s[0], new_s[0]
    for k in range(1, len(s)):
        prod_s = prod_s * s[k]
        prod_new = prod_new * new_s[k]
    new_plastic_def_det = plastic_def_det * _safe_div(prod_s, prod_new)
    new_elastic_hardening = torch.exp(hard_coeff * (1.0 - new_plastic_def_det))
    return cmat.recompose_c(u, new_s, v), new_elastic_hardening, new_plastic_def_det
