"""Particle state: a fixed-capacity structure of arrays of torch tensors
(port of sparkl_tpu/core/particles.py, same fields and defaults).

Floats are float32, ids int32, masks bool — the JAX package's dtypes, so
that the two packages exchange arrays through numpy unchanged.
"""

from dataclasses import dataclass, fields, replace
from typing import Tuple

import numpy as np
import torch

F32_MAX = float(np.finfo(np.float32).max)


@dataclass(frozen=True)
class Particles:
    # Geometry / kinematics
    position: torch.Tensor  # [N, d] f32
    velocity: torch.Tensor  # [N, d] f32
    velocity_gradient: torch.Tensor  # [N, d, d] f32
    deformation_gradient: torch.Tensor  # [N, d, d] f32
    plastic_def_det: torch.Tensor  # [N] f32

    # Mass properties
    mass: torch.Tensor  # [N] f32
    volume0: torch.Tensor  # [N] f32
    radius0: torch.Tensor  # [N] f32

    # Classification / status
    model_id: torch.Tensor  # [N] i32
    active: torch.Tensor  # [N] bool
    failed: torch.Tensor  # [N] bool
    is_static: torch.Tensor  # [N] bool
    kinematic_enabled: torch.Tensor  # [N] bool
    kinematic_vel: torch.Tensor  # [N, d] f32

    # Fracture / damage
    phase: torch.Tensor  # [N] f32
    psi_pos: torch.Tensor  # [N] f32
    parameter1: torch.Tensor  # [N] f32
    parameter2: torch.Tensor  # [N] f32
    crack_propagation_factor: torch.Tensor  # [N] f32
    crack_threshold: torch.Tensor  # [N] f32
    m_c: torch.Tensor  # [N] f32
    g: torch.Tensor  # [N] f32

    # Plasticity state
    nacc_alpha: torch.Tensor  # [N] f32
    plastic_hardening: torch.Tensor  # [N] f32
    elastic_hardening: torch.Tensor  # [N] f32
    log_vol_gain: torch.Tensor  # [N] f32

    # User data / debugging
    user_data: torch.Tensor  # [N] i32
    debug_val: torch.Tensor  # [N] f32

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @property
    def dim(self) -> int:
        return self.position.shape[1]

    @property
    def device(self) -> torch.device:
        return self.position.device

    def replace(self, **kw):
        return replace(self, **kw)

    def to(self, device) -> "Particles":
        return Particles(
            **{f.name: getattr(self, f.name).to(device) for f in fields(self)}
        )

    @staticmethod
    def empty(capacity: int, dim: int, device) -> "Particles":
        n, d = capacity, dim
        f32 = dict(dtype=torch.float32, device=device)

        def z(*s):
            return torch.zeros(s, **f32)

        def full(v):
            return torch.full((n,), v, **f32)

        return Particles(
            position=z(n, d),
            velocity=z(n, d),
            velocity_gradient=z(n, d, d),
            deformation_gradient=torch.eye(d, **f32).expand(n, d, d).clone(),
            plastic_def_det=full(1.0),
            mass=z(n),
            volume0=full(1.0),
            radius0=z(n),
            model_id=torch.zeros((n,), dtype=torch.int32, device=device),
            active=torch.zeros((n,), dtype=torch.bool, device=device),
            failed=torch.zeros((n,), dtype=torch.bool, device=device),
            is_static=torch.zeros((n,), dtype=torch.bool, device=device),
            kinematic_enabled=torch.zeros((n,), dtype=torch.bool, device=device),
            kinematic_vel=z(n, d),
            phase=full(1.0),
            psi_pos=z(n),
            parameter1=z(n),
            parameter2=z(n),
            crack_propagation_factor=z(n),
            crack_threshold=full(float("inf")),
            m_c=full(F32_MAX),
            g=z(n),
            nacc_alpha=full(-0.01),
            plastic_hardening=full(1.0),
            elastic_hardening=full(1.0),
            log_vol_gain=z(n),
            user_data=torch.zeros((n,), dtype=torch.int32, device=device),
            debug_val=z(n),
        )

    @staticmethod
    def from_positions(positions, model_id, radius, density0, device,
                       capacity=None, **overrides) -> "Particles":
        """Particles at the given positions: volume0 = (2r)^d,
        mass = volume0 * density0 (ref: particle.rs
        `Particle::with_internal_energy`); `overrides` set other fields of
        the new rows to a value (e.g. crack_threshold=89.0)."""
        positions = np.asarray(positions, np.float32)
        n, d = positions.shape
        capacity = capacity or n
        if capacity < n:
            raise ValueError(f"capacity {capacity} < {n} particles")
        p = Particles.empty(capacity, d, device)
        volume0 = float((2.0 * radius) ** d)
        mass = volume0 * density0
        p.position[:n] = torch.from_numpy(positions).to(device)
        p.mass[:n] = mass
        p.volume0[:n] = volume0
        p.radius0[:n] = radius
        p.model_id[:n] = int(model_id)
        p.active[:n] = True
        for k, v in overrides.items():
            getattr(p, k)[:n] = v
        return p

    @staticmethod
    def concatenate(parts: Tuple["Particles", ...], capacity=None) -> "Particles":
        """Active rows of `parts`, in order (ref: ParticleSet::insert_batch)."""
        total = sum(int(q.active.sum()) for q in parts)
        capacity = capacity or total
        out = Particles.empty(capacity, parts[0].dim, parts[0].device)
        cursor = 0
        for q in parts:
            sel = torch.nonzero(q.active).reshape(-1)
            n = sel.numel()
            for f in fields(Particles):
                getattr(out, f.name)[cursor : cursor + n] = getattr(q, f.name)[sel]
            cursor += n
        return out


def cube_particles(origin, counts, model_id, particle_radius, density0, device,
                   capacity=None) -> Particles:
    """Regular lattice of particles with spacing 2r (ref: helper.rs
    `cube_particles`). Positions come from the same sampler the JAX package
    prefers (native/sparkl_host.cpp), and from its numpy form where no g++
    is available."""
    from sparkl_tpu_torch import native

    pts = native.cube_particles(origin, counts, particle_radius)
    if pts is None:
        axes = [np.arange(c, dtype=np.float32) for c in counts]
        mesh = np.meshgrid(*axes, indexing="ij")
        pts = np.stack([m.reshape(-1) for m in mesh], axis=-1) * (
            2.0 * particle_radius
        )
        pts += np.asarray(origin, np.float32)
    return Particles.from_positions(
        pts, model_id, particle_radius, density0, device, capacity=capacity
    )
