"""Constitutive models (port of the corotated and Monaghan EOS parts of
sparkl_tpu/models/constitutive.py).

Component-wise functions on nested-list matrices of tensors, with raw
parameter tensors. Ref: sparkl
`src_core/dynamics/models/elasticity_corotated_linear.rs:12-147`,
`eos_monaghan_sph.rs` and
`src_core/dynamics/timestep/elasticity_sound_speed_timestep_bound.rs`.
Neo-Hookean is not ported yet.
"""

import numpy as np
import torch

from sparkl_tpu_torch.math import cmat, linalg
from sparkl_tpu_torch.math.svd import svd_c, svd_values_c

# Constitutive type codes (the JAX package's model-table ABI).
COROTATED = 0
NEO_HOOKEAN = 1
EOS_MONAGHAN_SPH = 2
CUSTOM_BASE = 16


def corotated_kirchhoff_stress(lam, mu, split_on_failure, phase, hardening, f):
    """[..., d, d] form of corotated_kirchhoff_stress_c."""
    return cmat.pack(
        corotated_kirchhoff_stress_c(lam, mu, split_on_failure, phase, hardening, cmat.unpack(f))
    )


def corotated_kirchhoff_stress_c(lam, mu, split_on_failure, phase, hardening, f):
    """2µh·U(Σ-1)Vᵀ·Fᵀ + λh(J-1)J·I with the positive/negative split when
    fractured (phase == 0 and split_on_failure)."""
    u, s, v = svd_c(f)
    return corotated_kirchhoff_stress_from_svd_c(
        lam, mu, split_on_failure, phase, hardening, f, u, s, v
    )


def corotated_kirchhoff_stress_from_svd_c(
    lam, mu, split_on_failure, phase, hardening, f, u, s, v
):
    """corotated_kirchhoff_stress_c with a caller-supplied SVD of f."""
    j = cmat.det_c(f)
    pos = [torch.clamp(si - 1.0, min=0.0) for si in s]
    neg = [torch.clamp(si - 1.0, max=0.0) for si in s]
    coeff = 2.0 * mu * hardening
    pos_dev = cmat.scale_c(cmat.matmul_nt_c(cmat.recompose_c(u, pos, v), f), coeff)
    neg_dev = cmat.scale_c(cmat.matmul_nt_c(cmat.recompose_c(u, neg, v), f), coeff)
    spherical = lam * hardening * (j - 1.0) * j
    compressed = j < 1.0
    sph_pos = torch.where(compressed, 0.0, spherical)
    sph_neg = torch.where(compressed, spherical, 0.0)
    pos_part = cmat.add_diag_c(pos_dev, sph_pos)
    neg_part = cmat.add_diag_c(neg_dev, sph_neg)
    phase_coeff = torch.where((split_on_failure != 0.0) & (phase == 0.0), 0.0, 1.0)
    return cmat.add_c(cmat.scale_c(pos_part, phase_coeff), neg_part)


def corotated_pos_energy(lam, mu, hardening, f):
    """Tensile part of the energy of [..., d, d] matrices (ref: `pos_energy`)."""
    return corotated_pos_energy_c(lam, mu, hardening, cmat.unpack(f))


def corotated_pos_energy_c(lam, mu, hardening, f):
    """corotated_pos_energy on nested lists, from the singular values alone."""
    return corotated_pos_energy_from_s_c(lam, mu, hardening, f, svd_values_c(f))


def corotated_pos_energy_from_s_c(lam, mu, hardening, f, s):
    """Tensile energy µh Σ max(σᵢ-1, 0)² (+ λh/2 (J-1)² when J ≥ 1) from the
    singular values s of f (ref: `pos_energy`)."""
    j = cmat.det_c(f)
    pos_dev = mu * hardening * sum(torch.clamp(si - 1.0, min=0.0) ** 2 for si in s)
    spherical = lam * hardening / 2.0 * (j - 1.0) ** 2
    return torch.where(j < 1.0, pos_dev, pos_dev + spherical)


def sound_speed_timestep_bound(alpha, bulk, shear, density0, velocity, cell_width):
    """sound_speed_timestep_bound_c of velocities [..., d]."""
    vnorm = torch.linalg.vector_norm(velocity, dim=-1)
    return sound_speed_timestep_bound_c(alpha, bulk, shear, density0, vnorm, cell_width)


def sound_speed_timestep_bound_c(alpha, bulk, shear, density0, vnorm, cell_width):
    """dt ≤ α·h / max(‖v‖, c) with c = √((K + 4/3 G)/ρ₀)."""
    c = torch.sqrt((bulk + 4.0 / 3.0 * shear) / density0)
    return alpha * cell_width / torch.maximum(vnorm, c)


# The bulk modulus K = λ + 2µ/3 as jitted XLA forms the JAX package's
# (lam + 2.0 * mu / 3.0): the division becomes a product with f32(1/3), the
# constants fold into µ·f32(2/3) (exactly 2µ·f32(1/3)), and the sum
# contracts into one FMA.
_TWO_THIRDS = 2.0 * float(np.float32(1.0) / np.float32(3.0))


def _bulk(lam, mu, hardening):
    return linalg.fma(mu, _TWO_THIRDS, lam) * hardening


def corotated_timestep_bound(lam, mu, cfl, hardening, density0, velocity, cell_width):
    shear = mu * hardening
    return sound_speed_timestep_bound(cfl, _bulk(lam, mu, hardening), shear, density0,
                                      velocity, cell_width)


def corotated_timestep_bound_c(lam, mu, cfl, hardening, density0, vnorm, cell_width):
    shear = mu * hardening
    return sound_speed_timestep_bound_c(cfl, _bulk(lam, mu, hardening), shear, density0,
                                        vnorm, cell_width)


# ---------------------------------------------------------------------------
# Monaghan SPH equation of state (weakly-compressible fluid)
# ---------------------------------------------------------------------------


def eos_pressure(pressure0, gamma, max_neg_pressure, mass, volume0, density_fluid):
    """p = max(p₀((ρ/ρ₀)^γ - 1), -p_neg_max). Ref: eos_monaghan_sph.rs `pressure`."""
    density0 = mass / volume0
    ratio = density_fluid / density0
    return torch.maximum(pressure0 * (cmat.pow_pos(ratio, gamma) - 1.0), -max_neg_pressure)


def eos_kirchhoff_stress(pressure0, gamma, viscosity, max_neg_pressure, mass, volume0,
                         density_fluid, fluid_j, velocity_gradient):
    """[..., 3, 3] form of eos_kirchhoff_stress_c."""
    return cmat.pack(eos_kirchhoff_stress_c(
        pressure0, gamma, viscosity, max_neg_pressure, mass, volume0, density_fluid,
        fluid_j, cmat.unpack(velocity_gradient),
    ))


def eos_kirchhoff_stress_c(pressure0, gamma, viscosity, max_neg_pressure, mass, volume0,
                           density_fluid, fluid_j, velocity_gradient):
    """-p·J·I + 2µ_visc·J·dev(strain rate). Ref: eos_monaghan_sph.rs `kirchhoff_stress`."""
    p = eos_pressure(pressure0, gamma, max_neg_pressure, mass, volume0, density_fluid)
    sr_dev = cmat.deviatoric_c(cmat.strain_rate_c(velocity_gradient))
    visc = torch.where(viscosity != 0.0, 2.0 * viscosity * fluid_j, 0.0)
    out = cmat.scale_c(sr_dev, visc)
    return cmat.add_diag_c(out, -p * fluid_j)


def eos_timestep_bound(pressure0, gamma, max_neg_pressure, fluid_j, mass, volume0,
                       density_fluid, velocity, cell_width):
    """eos_timestep_bound_c of velocities [..., d]."""
    vsq = sum(velocity[..., ax] * velocity[..., ax] for ax in range(velocity.shape[-1]))
    return eos_timestep_bound_c(pressure0, gamma, max_neg_pressure, fluid_j, mass, volume0,
                                density_fluid, vsq, cell_width, velocity.shape[-1])


def eos_timestep_bound_c(pressure0, gamma, max_neg_pressure, fluid_j, mass, volume0,
                         density_fluid, velocity_sq, cell_width, dim):
    """Single-particle stability and CFL bound, +inf where the stability
    argument is not positive or J <= 0. Ref: eos_monaghan_sph.rs
    `timestep_bound` (whose f32 sqrt of a negative is NaN, which min()
    then drops). The CFL bound's h / sqrt(c²) is h·(1/sqrt(c²)): jitted
    XLA rewrites it as the product with rsqrt, whose CPU form agrees with
    1/sqrt on about 63% of inputs and on c² = 10, every lane's at |v| <= 1."""
    j = fluid_j
    density0 = mass / volume0
    k = 6.0  # quadratic splines
    p = -eos_pressure(pressure0, gamma, max_neg_pressure, mass, volume0, density_fluid)
    arg = cmat.safe_div(density0 * (j - 1.0), k * p * dim)
    safe_j = torch.where(j > 0.0, j, 1.0)
    single = linalg.rdiv(cell_width, safe_j) * torch.sqrt(torch.clamp(arg, min=0.0))
    single = torch.where((arg > 0.0) & (j > 0.0), single, float("inf"))
    density_fluctuation = 0.1
    c_sq = linalg.div_const(torch.clamp(velocity_sq, min=1.0), density_fluctuation)
    cfl = cell_width * linalg.rdiv(1.0, torch.sqrt(c_sq))
    return torch.minimum(single, cfl)
