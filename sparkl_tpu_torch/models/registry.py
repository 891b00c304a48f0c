"""Model registry: per-model parameters packed into small tables, per-particle
dispatch by model id (port of sparkl_tpu/models/registry.py for the models
the port carries: corotated elasticity with optional Drucker-Prager,
Rankine or Snow plasticity, the Monaghan SPH equation of state for fluids,
and maximum-stress failure).

The table layout is the JAX package's: ctype [M] i32, cparams [M, 4] f32,
ptype [M] i32, pparams [M, 8] f32, ftype [M] i32, fparams [M, 2] f32.
"""

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from sparkl_tpu_torch.math.lame import lame_lambda_mu
from sparkl_tpu_torch.models import constitutive as con
from sparkl_tpu_torch.models import failure as fail
from sparkl_tpu_torch.models import plasticity as plas

FAILURE_NONE = fail.FAILURE_NONE

_N_CPARAMS = 4
_N_PPARAMS = 8
_N_FPARAMS = 2


def corotated_linear_elasticity(
    young_modulus, poisson_ratio, split_stress_on_failure=True, cfl_coeff=0.9
):
    """Ref: elasticity_corotated_linear.rs `CorotatedLinearElasticity::new`."""
    lam, mu = lame_lambda_mu(young_modulus, poisson_ratio)
    return (
        con.COROTATED,
        (lam, mu, cfl_coeff, 1.0 if split_stress_on_failure else 0.0),
    )


def monaghan_sph_eos(pressure0, gamma, viscosity, max_neg_pressure=1.0):
    """Ref: eos_monaghan_sph.rs `MonaghanSphEos::new`."""
    return (con.EOS_MONAGHAN_SPH, (pressure0, float(gamma), viscosity, max_neg_pressure))


def drucker_prager_plasticity(
    young_modulus,
    poisson_ratio,
    h0_deg=35.0,
    h1_deg=9.0,
    h2=0.2,
    h3_deg=10.0,
    only_active_when_failed=False,
    volume_correction=1.0,
):
    """Ref: plasticity_drucker_prager.rs `DruckerPragerPlasticity::new`."""
    lam, mu = lame_lambda_mu(young_modulus, poisson_ratio)
    return (
        plas.DRUCKER_PRAGER,
        (
            math.radians(h0_deg),
            math.radians(h1_deg),
            h2,
            math.radians(h3_deg),
            lam,
            mu,
            1.0 if only_active_when_failed else 0.0,
            volume_correction,
        ),
    )


def rankine_plasticity(young_modulus, poisson_ratio, tensile_strength, softening_rate):
    """Ref: plasticity_rankine.rs `RankinePlasticity::new`."""
    lam, mu = lame_lambda_mu(young_modulus, poisson_ratio)
    return (plas.RANKINE, (mu, lam, tensile_strength, softening_rate))


def snow_plasticity(min_epsilon=2.5e-2, max_epsilon=4.5e-3, hardening_coeff=10.0):
    """Ref: plasticity_snow.rs `SnowPlasticity::new`."""
    return (plas.SNOW, (min_epsilon, max_epsilon, hardening_coeff))


def maximum_stress_failure(max_principal_stress, max_shear_stress):
    """Ref: failure_maximum_stress.rs `MaximumStressFailure::new`."""
    return (fail.MAXIMUM_STRESS, (max_principal_stress, max_shear_stress))


@dataclass(frozen=True)
class ParticleModel:
    """One material: constitutive model (+ optional plasticity / failure)."""

    constitutive: Tuple[int, Tuple[float, ...]]
    plastic: Optional[Tuple[int, Tuple[float, ...]]] = None
    failure: Optional[Tuple[int, Tuple[float, ...]]] = None


@dataclass(frozen=True)
class ModelSet:
    ctype: torch.Tensor  # [M] int32
    cparams: torch.Tensor  # [M, 4] f32
    ptype: torch.Tensor  # [M] int32
    pparams: torch.Tensor  # [M, 8] f32
    ftype: torch.Tensor  # [M] int32
    fparams: torch.Tensor  # [M, 2] f32
    present_c: Tuple[int, ...] = field(default=())
    present_p: Tuple[int, ...] = field(default=())
    present_f: Tuple[int, ...] = field(default=())

    @staticmethod
    def from_tables(ctype, cparams, ptype, pparams, ftype, fparams, device):
        """Tables given as numpy arrays -> ModelSet on `device`."""
        ctype, ptype, ftype = (np.asarray(t, np.int32) for t in (ctype, ptype, ftype))

        def dev(a, dtype):
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)

        return ModelSet(
            ctype=dev(ctype, torch.int32),
            cparams=dev(cparams, torch.float32),
            ptype=dev(ptype, torch.int32),
            pparams=dev(pparams, torch.float32),
            ftype=dev(ftype, torch.int32),
            fparams=dev(fparams, torch.float32),
            present_c=tuple(sorted(set(int(t) for t in ctype))),
            present_p=tuple(sorted(set(int(t) for t in ptype) - {plas.PLASTIC_NONE})),
            present_f=tuple(sorted(set(int(t) for t in ftype) - {FAILURE_NONE})),
        )

    @staticmethod
    def pack(models, device):
        """Pack a list of ParticleModel into tables on `device`."""
        m = len(models)
        ctype = np.zeros((m,), np.int32)
        cparams = np.zeros((m, _N_CPARAMS), np.float32)
        ptype = np.zeros((m,), np.int32)
        pparams = np.zeros((m, _N_PPARAMS), np.float32)
        ftype = np.zeros((m,), np.int32)
        fparams = np.zeros((m, _N_FPARAMS), np.float32)
        for i, pm in enumerate(models):
            ct, cp = pm.constitutive
            ctype[i] = ct
            cparams[i, : len(cp)] = cp
            if pm.plastic is not None:
                pt, pp = pm.plastic
                ptype[i] = pt
                pparams[i, : len(pp)] = pp
            if pm.failure is not None:
                ft, fp = pm.failure
                ftype[i] = ft
                fparams[i, : len(fp)] = fp
        return ModelSet.from_tables(
            ctype, cparams, ptype, pparams, ftype, fparams, device
        )

    @property
    def num_models(self):
        return self.ctype.shape[0]

    def is_fluid(self, model_id):
        """bool [N]: the particle's constitutive model is a fluid (no custom
        models are ported, so only the Monaghan EOS is)."""
        return self.ctype[model_id] == con.EOS_MONAGHAN_SPH

    def unsupported(self):
        """Why the port cannot run this model set, or '' if it can."""
        extra_c = set(self.present_c) - {con.COROTATED, con.EOS_MONAGHAN_SPH}
        if extra_c:
            return (f"constitutive model types {sorted(extra_c)} (only corotated and the "
                    "Monaghan EOS are ported)")
        extra_p = set(self.present_p) - {plas.DRUCKER_PRAGER, plas.RANKINE, plas.SNOW}
        if extra_p:
            return (f"plastic model types {sorted(extra_p)} (only Drucker-Prager, Rankine and "
                    "Snow are ported)")
        extra_f = set(self.present_f) - {fail.MAXIMUM_STRESS}
        if extra_f:
            return (f"failure model types {sorted(extra_f)} (only maximum stress is "
                    "ported)")
        return ""


def _check(ms):
    why = ms.unsupported()
    if why:
        raise NotImplementedError(why)


def kirchhoff_stress(ms: ModelSet, model_id, phase, elastic_hardening, f,
                     velocity_gradient, mass, volume0):
    """Per-particle Kirchhoff stress [N, d, d]. Fluids read J from F[0, 0]
    (ref: particle.rs `fluid_deformation_gradient_det`)."""
    _check(ms)
    ct = ms.ctype[model_id]
    cp = ms.cparams[model_id]
    out = torch.zeros_like(f)
    if con.COROTATED in ms.present_c:
        s = con.corotated_kirchhoff_stress(cp[..., 0], cp[..., 1], cp[..., 3], phase,
                                           elastic_hardening, f)
        out = torch.where((ct == con.COROTATED)[..., None, None], s, out)
    if con.EOS_MONAGHAN_SPH in ms.present_c:
        fluid_j = f[..., 0, 0]
        density_fluid = (mass / volume0) / torch.clamp(fluid_j, min=1e-20)
        s = con.eos_kirchhoff_stress(cp[..., 0], cp[..., 1], cp[..., 2], cp[..., 3], mass,
                                     volume0, density_fluid, fluid_j, velocity_gradient)
        out = torch.where((ct == con.EOS_MONAGHAN_SPH)[..., None, None], s, out)
    return out


def pos_energy(ms: ModelSet, model_id, phase, elastic_hardening, f):
    """Per-particle tensile energy density for crack propagation (0 for
    fluids)."""
    _check(ms)
    ct = ms.ctype[model_id]
    cp = ms.cparams[model_id]
    out = torch.zeros(f.shape[:-2], dtype=f.dtype, device=f.device)
    if con.COROTATED in ms.present_c:
        e = con.corotated_pos_energy(cp[..., 0], cp[..., 1], elastic_hardening, f)
        out = torch.where(ct == con.COROTATED, e, out)
    return out


def timestep_bound(ms: ModelSet, model_id, phase, elastic_hardening, f, mass,
                   volume0, velocity, cell_width):
    """Per-particle constitutive dt bound (inf for model types without one)."""
    _check(ms)
    ct = ms.ctype[model_id]
    cp = ms.cparams[model_id]
    density0 = mass / volume0
    out = torch.full(model_id.shape, float("inf"), dtype=velocity.dtype, device=velocity.device)
    if con.COROTATED in ms.present_c:
        b = con.corotated_timestep_bound(cp[..., 0], cp[..., 1], cp[..., 2],
                                         elastic_hardening, density0, velocity, cell_width)
        out = torch.where(ct == con.COROTATED, b, out)
    if con.EOS_MONAGHAN_SPH in ms.present_c:
        fluid_j = f[..., 0, 0]
        density_fluid = density0 / torch.clamp(fluid_j, min=1e-20)
        b = con.eos_timestep_bound(cp[..., 0], cp[..., 1], cp[..., 3], fluid_j, mass,
                                   volume0, density_fluid, velocity, cell_width)
        out = torch.where(ct == con.EOS_MONAGHAN_SPH, b, out)
    return out


def apply_plasticity(ms: ModelSet, model_id, phase, f, plastic_def_det, plastic_hardening,
                     elastic_hardening, log_vol_gain, nacc_alpha):
    """Run every present plastic return map, masked per particle. Returns
    (f, plastic_def_det, plastic_hardening, elastic_hardening,
    log_vol_gain, nacc_alpha)."""
    _check(ms)
    if plas.DRUCKER_PRAGER in ms.present_p:
        f2, pdd2, ph2, lvg2 = plas.drucker_prager_update(
            ms.pparams[model_id], phase, f, plastic_def_det, plastic_hardening, log_vol_gain
        )
        m = ms.ptype[model_id] == plas.DRUCKER_PRAGER
        f = torch.where(m[..., None, None], f2, f)
        plastic_def_det = torch.where(m, pdd2, plastic_def_det)
        plastic_hardening = torch.where(m, ph2, plastic_hardening)
        log_vol_gain = torch.where(m, lvg2, log_vol_gain)
    if plas.RANKINE in ms.present_p:
        f2, ph2 = plas.rankine_update(ms.pparams[model_id][..., :4], f, plastic_hardening)
        m = ms.ptype[model_id] == plas.RANKINE
        f = torch.where(m[..., None, None], f2, f)
        plastic_hardening = torch.where(m, ph2, plastic_hardening)
    if plas.SNOW in ms.present_p:
        f2, eh2, pdd2 = plas.snow_update(ms.pparams[model_id][..., :3], f, elastic_hardening,
                                         plastic_def_det)
        m = ms.ptype[model_id] == plas.SNOW
        f = torch.where(m[..., None, None], f2, f)
        elastic_hardening = torch.where(m, eh2, elastic_hardening)
        plastic_def_det = torch.where(m, pdd2, plastic_def_det)
    return f, plastic_def_det, plastic_hardening, elastic_hardening, log_vol_gain, nacc_alpha


def apply_failure(ms: ModelSet, model_id, phase, stress):
    """phase := 0 where the failure model trips (ref: grid_to_particle.rs
    "Apply failure model")."""
    _check(ms)
    if not ms.present_f:
        return phase
    trip = (ms.ftype[model_id] == fail.MAXIMUM_STRESS) & fail.maximum_stress_failed(
        ms.fparams[model_id], stress)
    return torch.where(trip, 0.0, phase)
