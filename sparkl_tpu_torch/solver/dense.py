"""MLS-MPM solver stages the fused pipeline uses (port of part of
sparkl_tpu/solver/dense.py): the out-of-grid mark, the grid update with
collider boundary conditions (CPU-reference semantics) and the
per-particle dt bounds. Ref: sparkl `src/dynamics/solver/grid_update.rs`,
`timestep_estimator.rs`, `particle_set.rs:132-135`.
"""

import numpy as np
import torch

from sparkl_tpu_torch.core.grid import GridParams, GridState
from sparkl_tpu_torch.core.params import BoundaryHandling, SimulationDofs
from sparkl_tpu_torch.math import linalg
from sparkl_tpu_torch.models import registry


def base_cell_and_fx(grid: GridParams, position):
    """Associated node round(x/h) - 1, offset fx in [0.5, 1.5), and whether
    the 3-node stencil lies inside the grid."""
    dev = position.device
    origin = torch.tensor(grid.origin, dtype=position.dtype, device=dev)
    xg = linalg.div(position - origin, grid.cell_width)
    base = torch.round(xg).to(torch.int32) - 1
    fx = xg - base.to(position.dtype)
    res = torch.tensor(grid.res, dtype=torch.int32, device=dev)
    in_bounds = torch.all((base >= 0) & (base + 2 <= res - 1), dim=-1)
    return base, fx, in_bounds


def mark_out_of_grid_failed(grid: GridParams, p):
    """Particles whose stencil leaves the grid are marked failed."""
    _, _, ok = base_cell_and_fx(grid, p.position)
    return p.replace(failed=p.failed | (p.active & ~ok))


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


def particle_dt_bounds(grid: GridParams, p, models: registry.ModelSet):
    """Per-particle dt bound [N] (velocity/APIC + constitutive), inf where
    inactive (ref: timestep_estimator.rs)."""
    h = grid.cell_width
    d_coeff = (h * h) / 4.0
    norm_b = d_coeff * torch.sqrt(
        torch.sum(p.velocity_gradient * p.velocity_gradient, dim=(-2, -1))
    )
    apic_v = linalg.div(norm_b * 6.0 * float(np.sqrt(p.dim)), h)
    v = torch.linalg.vector_norm(p.velocity, dim=-1) + apic_v
    vel_bound = h / torch.clamp(v, min=1e-20)
    vel_bound = torch.where(v > 0.0, vel_bound, float("inf"))
    con_bound = registry.timestep_bound(
        models, p.model_id, p.phase, p.elastic_hardening, p.deformation_gradient,
        p.mass, p.volume0, p.velocity, h,
    )
    con_bound = torch.where(p.failed, float("inf"), con_bound)
    bound = torch.minimum(vel_bound, con_bound)
    return torch.where(p.active, bound, float("inf"))
