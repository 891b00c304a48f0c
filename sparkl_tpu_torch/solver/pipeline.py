"""User hook points of the pipelines (port of the MpmHooks base of
sparkl_tpu/solver/pipeline.py; ref: src/dynamics/solver/mpm_hooks.rs).

The dense MpmPipeline and DirichletVelocityHook are not ported yet; the
port's pipelines take hooks=None only.
"""

from sparkl_tpu_torch.core.grid import GridParams, GridState


class MpmHooks:
    """`post_grid_update(state, grid, dt, node_positions) -> state` runs
    after the grid update of every substep; node_positions has the leading
    shape of the state's node fields. The base class changes nothing."""

    def post_grid_update(self, state: GridState, grid: GridParams, dt,
                         node_positions=None) -> GridState:
        return state
