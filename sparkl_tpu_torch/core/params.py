"""Solver parameters and enums.

Ref: sparkl `src_core/dynamics/solver/solver_parameters.rs` (SolverParameters,
BoundaryHandling, DamageModel, SimulationDofs). These are static (trace-time)
configuration: changing them retriggers XLA compilation, which matches how the
reference treats them (fixed per scene).
"""

import enum
from dataclasses import dataclass, field


class BoundaryHandling(enum.IntEnum):
    STICK = 0
    FRICTION = 1
    FRICTION_Z_UP = 2
    NONE = 3


class DamageModel(enum.IntEnum):
    NONE = 0
    CD_MPM = 1
    EIGENEROSION = 2
    MODIFIED_EIGENEROSION = 3


class SimulationDofs(enum.IntFlag):
    LOCK_NONE = 0
    LOCK_X = 1
    LOCK_Y = 2
    LOCK_Z = 4


@dataclass(frozen=True)
class SolverParameters:
    """Defaults mirror solver_parameters.rs:54-68 (dt=1/60, Friction, no damage)."""

    dt: float = 1.0 / 60.0
    max_substep_dt: float = float("inf")
    max_num_substeps: int = 1000
    boundary_handling: BoundaryHandling = BoundaryHandling.FRICTION
    damage_model: DamageModel = DamageModel.NONE
    force_fluids_volume_recomputation: bool = False
    enable_boundary_particle_projection: bool = False
    stop_after_one_substep: bool = False
    simulation_dofs: SimulationDofs = SimulationDofs.LOCK_NONE
    # The reference's GPU pipeline clamps per-particle velocity so no
    # component crosses a full cell per substep (particle_updater.rs:113-121);
    # its CPU pipeline does not. Off by default (CPU semantics).
    gpu_velocity_clamp: bool = False
    # GPU-pipeline boundary semantics: FrictionZUp in 3D applies friction
    # only where the contact normal's z-component is >= 0
    # (grid_update.rs:160-165); the CPU pipeline treats FrictionZUp exactly
    # like Friction (src/dynamics/solver/grid_update.rs:95). Off by default
    # (CPU semantics, like gpu_velocity_clamp).
    gpu_boundary_semantics: bool = False
