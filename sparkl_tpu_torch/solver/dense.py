"""MLS-MPM solver stages the fused and block-sparse pipelines use (port of
part of sparkl_tpu/solver/dense.py): the out-of-grid mark, the grid update
with collider boundary conditions (CPU-reference semantics), the particle
update after the G2P gather, and the per-particle dt bounds. Ref: sparkl
`src/dynamics/solver/grid_update.rs`, `grid_to_particle.rs`,
`timestep_estimator.rs`, `particle_set.rs:132-135`.
"""

import numpy as np
import torch

from sparkl_tpu_torch.core.grid import GridParams, GridState
from sparkl_tpu_torch.core.params import BoundaryHandling, DamageModel, SimulationDofs
from sparkl_tpu_torch.math import cmat, linalg
from sparkl_tpu_torch.models import constitutive as con
from sparkl_tpu_torch.models import registry


def base_cell_and_fx(grid: GridParams, position):
    """Associated node round(x/h) - 1, offset fx in [0.5, 1.5), and whether
    the 3-node stencil lies inside the grid."""
    dev = position.device
    origin = torch.tensor(grid.origin, dtype=position.dtype, device=dev)
    xg = linalg.div_const(position - origin, grid.cell_width)
    base = torch.round(xg).to(torch.int32) - 1
    fx = xg - base.to(position.dtype)
    res = torch.tensor(grid.res, dtype=torch.int32, device=dev)
    in_bounds = torch.all((base >= 0) & (base + 2 <= res - 1), dim=-1)
    return base, fx, in_bounds


def mark_out_of_grid_failed(grid: GridParams, p):
    """Particles whose stencil leaves the grid are marked failed."""
    _, _, ok = base_cell_and_fx(grid, p.position)
    return p.replace(failed=p.failed | (p.active & ~ok))


def penalty_velocity_delta(colliders, position, mass, dt, poses=None):
    """Per-particle velocity-equivalent of the collider penalty force, or
    None when no collider opts in (the reference's default: its penalty
    block is gated off). Penalty colliders are not ported: the pipelines
    refuse them, and this raises for one."""
    if any(float(c.penalty_stiffness) > 0.0 for c in colliders):
        raise NotImplementedError("penalty colliders are not ported")
    return None


def grid_node_projections(colliders, node_positions, only=None):
    """Per-collider (proj, inside) for every node: a pure function of node
    positions, computed once per structure rebuild and carried across
    substeps (the reference's projection cache, reset_grid.rs:29-63)."""
    return tuple(
        c.project_point(node_positions) if (only is None or ci in only) else None
        for ci, c in enumerate(colliders)
    )


def _effective_bh(collider, boundary_handling):
    return (
        BoundaryHandling(collider.boundary_handling)
        if collider.boundary_handling is not None
        else boundary_handling
    )


def grid_update(grid: GridParams, state: GridState, colliders, dt,
                boundary_handling: BoundaryHandling,
                simulation_dofs: SimulationDofs, node_positions, projections=None):
    """Per-node DOF locking + collider boundary conditions with the CPU
    reference's semantics (src/dynamics/solver/grid_update.rs:43-132): each
    collider applied in turn with projection-delta normals; Stick zeroes
    velocity inside; Friction projects out approaching normal velocity with
    Coulomb tangential decay and a one-cell penetration-margin correction;
    FrictionZUp aliases Friction. The GPU-pipeline semantics of the JAX
    package are not ported yet."""
    vel = state.velocity
    mom = state.momentum
    h = grid.cell_width
    for ax, lock in enumerate((SimulationDofs.LOCK_X, SimulationDofs.LOCK_Y,
                               SimulationDofs.LOCK_Z)[: grid.dim]):
        if simulation_dofs & lock:
            vel = vel.clone()
            mom = mom.clone()
            vel[..., ax] = 0.0
            mom[..., ax] = 0.0

    for ci, collider in enumerate(colliders):
        bh = _effective_bh(collider, boundary_handling)
        if bh == BoundaryHandling.NONE:
            continue
        if projections is not None and projections[ci] is not None:
            proj, inside = projections[ci]
        else:
            proj, inside = collider.project_point(node_positions)

        if bh == BoundaryHandling.STICK:
            vel = torch.where(inside[..., None], 0.0, vel)
            continue

        delta = node_positions - proj
        dist = torch.linalg.vector_norm(delta, dim=-1)
        has_normal = dist > 1.0e-5
        safe_dist = torch.where(has_normal, dist, 1.0)
        normal = delta / safe_dist[..., None]
        normal = torch.where(inside[..., None], -normal, normal)

        normal_vel = torch.sum(vel * normal, dim=-1)
        approaching = normal_vel < 0.0
        dist_with_margin = dist - h

        tangent = vel - normal_vel[..., None] * normal
        tangent_norm = torch.linalg.vector_norm(tangent, dim=-1)
        safe_t = torch.where(tangent_norm > 1.0e-10, tangent_norm, 1.0)
        friction_vel = (
            tangent / safe_t[..., None]
            * torch.clamp(tangent_norm + normal_vel * collider.friction, min=0.0)[..., None]
        )
        contact_vel = torch.where((tangent_norm > 1.0e-10)[..., None], friction_vel, tangent)

        in_contact = inside | (dist_with_margin <= 0.0)
        tunnel = (-normal_vel * dt) > dist_with_margin
        corrected = vel - (linalg.div(dist_with_margin, dt) + normal_vel)[..., None] * normal
        new_vel = torch.where(
            in_contact[..., None], contact_vel,
            torch.where(tunnel[..., None], corrected, vel),
        )
        apply = has_normal & approaching
        vel = torch.where(apply[..., None], new_vel, vel)

    return state.replace(velocity=vel, momentum=mom)


def particle_update_after_gather(
    grid: GridParams, p, models: registry.ModelSet, dt, velocity, velocity_gradient,
    velocity_gradient_det, psi_pos_momentum, colliders=(),
    damage_model: DamageModel = DamageModel.NONE,
    enable_boundary_particle_projection: bool = False, gpu_velocity_clamp: bool = False,
    compute_dt_bound: bool = False, poses=None,
):
    """Particle state update from the gathered grid quantities (ref:
    grid_to_particle.rs): kinematic override, the optional GPU velocity
    clamp, advection, F update, plastic return map, static particles, the
    broken-F guards and the pos-energy accumulation. With
    compute_dt_bound, also returns the next substep's dt bounds. The
    modified-eigenerosion trip, boundary particle projection and runtime
    poses are not ported and raise; so do fluid model sets (the fluid J
    update is carried by the fused pipeline's kernel B only) and failure
    model sets (registry.apply_plasticity refuses them)."""
    if con.EOS_MONAGHAN_SPH in models.present_c:
        raise NotImplementedError("the particle update's fluid J update is not ported")
    if damage_model == DamageModel.MODIFIED_EIGENEROSION:
        raise NotImplementedError("modified eigenerosion is not ported")
    if enable_boundary_particle_projection:
        raise NotImplementedError("boundary particle projection is not ported")
    if poses is not None:
        raise NotImplementedError("runtime collider poses are not ported")
    phase = p.phase

    # Advection (kinematic override; ref :81-89).
    velocity = torch.where(p.kinematic_enabled[..., None], p.kinematic_vel, velocity)
    if gpu_velocity_clamp:
        # If any component would cross a cell this substep, clamp all
        # components to +-h/dt (particle_updater.rs:113-121).
        h = grid.cell_width
        over = torch.any(torch.abs(velocity) * dt >= h, dim=-1)
        clamp = float(np.float32(h) / np.float32(dt))  # h / dt in f32, as the JAX package
        velocity = torch.where(over[..., None], torch.sign(velocity) * clamp, velocity)
    position = p.position + velocity * dt

    # Deformation gradient update (ref :91-105).
    f = p.deformation_gradient
    gf = cmat.pack(cmat.matmul_c(cmat.unpack(velocity_gradient), cmat.unpack(f)))
    f = f + dt * gf

    # Plastic return mapping (ref :107-109).
    f, pdd, ph, eh, lvg, nacc = registry.apply_plasticity(
        models, p.model_id, phase, f, p.plastic_def_det, p.plastic_hardening,
        p.elastic_hardening, p.log_vol_gain, p.nacc_alpha,
    )

    # Static particles (ref :111-114).
    velocity = torch.where(p.is_static[..., None], 0.0, velocity)
    velocity_gradient = torch.where(p.is_static[..., None, None], 0.0, velocity_gradient)

    # Failure guards (ref :116-127): det(F) = 0, already failed, |F00| blowup.
    blowup = torch.abs(f[:, 0, 0]) > 1.0e4
    broken = (linalg.det(f) == 0.0) | p.failed | blowup
    eye = torch.eye(p.dim, dtype=f.dtype, device=f.device).expand_as(f)
    f = torch.where(broken[..., None, None], eye, f)
    velocity_gradient = torch.where(broken[..., None, None], 0.0, velocity_gradient)
    failed = p.failed | broken

    # Pos energy accumulation (ref :129-138).
    psi_pos = torch.maximum(p.psi_pos, registry.pos_energy(models, p.model_id, phase, eh, f))

    out = p.replace(
        position=position, velocity=velocity, velocity_gradient=velocity_gradient,
        deformation_gradient=f, plastic_def_det=pdd, plastic_hardening=ph,
        elastic_hardening=eh, log_vol_gain=lvg, nacc_alpha=nacc, phase=phase,
        psi_pos=psi_pos, parameter1=psi_pos * p.mass, parameter2=p.mass, failed=failed,
    )
    if compute_dt_bound:
        bound = particle_dt_bounds(
            grid, p, models, velocity=velocity, velocity_gradient=velocity_gradient,
            failed=failed, deformation_gradient=f, elastic_hardening=eh, phase=phase,
        )
        return out, bound
    return out


def particle_dt_bounds(grid: GridParams, p, models: registry.ModelSet, velocity=None,
                       velocity_gradient=None, failed=None, deformation_gradient=None,
                       elastic_hardening=None, phase=None):
    """Per-particle dt bound [N] (velocity/APIC + constitutive), inf where
    inactive (ref: timestep_estimator.rs). The optional fields override
    p's, so the particle update can bound the next substep from its new
    state."""
    h = grid.cell_width
    d_coeff = (h * h) / 4.0
    velocity = p.velocity if velocity is None else velocity
    velocity_gradient = p.velocity_gradient if velocity_gradient is None else velocity_gradient
    failed = p.failed if failed is None else failed
    f = p.deformation_gradient if deformation_gradient is None else deformation_gradient
    eh = p.elastic_hardening if elastic_hardening is None else elastic_hardening
    phase = p.phase if phase is None else phase
    norm_b = d_coeff * torch.sqrt(
        torch.sum(velocity_gradient * velocity_gradient, dim=(-2, -1))
    )
    apic_v = linalg.div_const(norm_b * 6.0 * float(np.sqrt(p.dim)), h)
    v = torch.linalg.vector_norm(velocity, dim=-1) + apic_v
    vel_bound = linalg.rdiv(h, torch.clamp(v, min=1e-20))
    vel_bound = torch.where(v > 0.0, vel_bound, float("inf"))
    con_bound = registry.timestep_bound(
        models, p.model_id, phase, eh, f, p.mass, p.volume0, velocity, h,
    )
    con_bound = torch.where(failed, float("inf"), con_bound)
    bound = torch.minimum(vel_bound, con_bound)
    return torch.where(p.active, bound, float("inf"))


def adaptive_timestep(grid: GridParams, p, models: registry.ModelSet, max_dt):
    """min over particles of the dt bounds, and max_dt (a tensor; ref:
    timestep_estimator.rs `adaptive_timestep_length`)."""
    return torch.minimum(torch.min(particle_dt_bounds(grid, p, models)), max_dt)
