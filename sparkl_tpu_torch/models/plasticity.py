"""Plastic return maps on singular values (port of the Drucker-Prager part
of sparkl_tpu/models/plasticity.py).

Ref: sparkl `src_core/dynamics/models/plasticity_drucker_prager.rs:10-105`.
NACC, Rankine and Snow are not ported yet.
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
    """DP return map of [..., 3, 3] matrices; params [..., 8] rows [h0, h1,
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

    strain = [torch.log(torch.clamp(si, min=1e-20)) + linalg.div(log_vol_gain, d) for si in s]
    strain_trace = sum(strain)
    dev = [e - linalg.div(strain_trace, d) for e in strain]
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
