"""User hook points of the pipelines (port of MpmHooks and
DirichletVelocityHook of sparkl_tpu/solver/pipeline.py; ref:
src/dynamics/solver/mpm_hooks.rs). The dense MpmPipeline is not ported.
"""

import numpy as np
import torch

from sparkl_tpu_torch.core.grid import GridParams, GridState


class MpmHooks:
    """`post_grid_update(state, grid, dt, node_positions) -> state` runs
    after the grid update of every substep; node_positions has the leading
    shape of the state's node fields. The base class changes nothing."""

    def post_grid_update(self, state: GridState, grid: GridParams, dt,
                         node_positions=None) -> GridState:
        return state


class DirichletVelocityHook(MpmHooks):
    """Prescribe the grid velocity of every node within half a cell (per
    axis) of given world points (ref: l_panel2.rs
    BoundaryConditions::post_grid_update_hook: the loading pins one node).
    points, velocities: [K, d]."""

    def __init__(self, points, velocities):
        self.points = np.asarray(points, np.float32)
        self.velocities = np.asarray(velocities, np.float32)

    def post_grid_update(self, state, grid, dt, node_positions=None):
        vel = state.velocity
        half = 0.5 * grid.cell_width
        for pt, v in zip(self.points, self.velocities):
            near = torch.all(torch.abs(node_positions - torch.from_numpy(pt).to(vel.device))
                             < half, dim=-1)
            vel = torch.where(near[..., None], torch.from_numpy(v).to(vel.device), vel)
        return state.replace(velocity=vel)
