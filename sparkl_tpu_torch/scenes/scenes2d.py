"""2D scenes (port of the l_panel2 part of sparkl_tpu/scenes/scenes2d.py).
Ref: examples2d/l_panel2.rs."""

import numpy as np

import sparkl_tpu_torch.scenes as sc
from sparkl_tpu_torch import device as _device
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.core.params import BoundaryHandling, DamageModel, SolverParameters
from sparkl_tpu_torch.core.particles import Particles
from sparkl_tpu_torch.geometry.colliders import cuboid
from sparkl_tpu_torch.models import registry as reg
from sparkl_tpu_torch.solver.pipeline import DirichletVelocityHook


def _polygon_contains(poly, pts):
    """Even-odd test, vectorized numpy."""
    a = poly
    b = np.roll(poly, -1, axis=0)
    inside = np.zeros(len(pts), bool)
    for (ax, ay), (bx, by) in zip(a, b):
        cond = (ay <= pts[:, 1]) != (by <= pts[:, 1])
        denom = np.where(np.abs(by - ay) < 1e-20, 1e-20, by - ay)
        xint = ax + (pts[:, 1] - ay) / denom * (bx - ax)
        inside ^= cond & (xint > pts[:, 0])
    return inside


def _sample_polygon(poly, offset, model_id, radius, density, device, **overrides):
    """The lattice of spacing 2r over the polygon's box, kept where the
    polygon contains it, shifted by `offset`."""
    lo = poly.min(axis=0) - radius
    hi = poly.max(axis=0) + radius
    xs = np.arange(lo[0], hi[0], 2 * radius, dtype=np.float32)
    ys = np.arange(lo[1], hi[1], 2 * radius, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)
    pts = pts[_polygon_contains(poly, pts)]
    return Particles.from_positions(
        pts + np.asarray(offset, np.float32), model_id, radius, density, device, **overrides
    )


@sc.register_scene("l_panel2")
def l_panel2(cell_width=0.005, dt=1.0 / 6000.0, device="cuda"):
    """Quasi-brittle L-panel fracture: two L-shaped concrete panels (E =
    25.85e9, nu = 0.18, density 2500, r = h/4), the first with eigenerosion
    crack propagation (factor 4.5, threshold 89), the second with
    maximum-stress failure (2.7e6); a cuboid ground under STICK handling,
    no gravity, and the loading as a grid Dirichlet hook pinning one node
    per panel at 0.1 m/s upward. The defaults are the reference's
    (cell_width 0.005, dt 1/6000: 60,000 particles); cell_width and dt scale
    the discretization."""
    device = _device.resolve(device)
    e, nu = 25.85e9, 0.18
    h = cell_width
    ground_height = h * 10.0
    ground_shift = h * 40.0

    colliders = (
        cuboid((1000.0, ground_height), translation=(0.0, ground_shift - ground_height)),
    )
    panel_poly = np.array(
        [[0.0, 0.0], [0.25, 0.0], [0.25, 0.25], [0.5, 0.25], [0.5, 0.5], [0.0, 0.5]],
        np.float32,
    )
    m1 = reg.ParticleModel(reg.corotated_linear_elasticity(e, nu))
    m2 = reg.ParticleModel(
        reg.corotated_linear_elasticity(e, nu),
        failure=reg.maximum_stress_failure(2.7e6, np.finfo(np.float32).max),
    )
    models = reg.ModelSet.pack([m1, m2], device)

    origins = [(ground_shift, ground_shift), (ground_shift * 8.0, ground_shift)]
    panel1 = _sample_polygon(panel_poly, origins[0], 0, h / 4.0, 2500.0, device,
                             crack_propagation_factor=4.5, crack_threshold=89.0, m_c=0.0,
                             g=10.0)
    panel2 = _sample_polygon(panel_poly, origins[1], 1, h / 4.0, 2500.0, device)
    particles = Particles.concatenate((panel1, panel2))

    load = np.array([0.47, 0.25], np.float32)
    hooks = DirichletVelocityHook(
        points=[np.asarray(o, np.float32) + load for o in origins],
        velocities=[[0.0, 0.1], [0.0, 0.1]],
    )
    grid = GridParams.for_domain((0.05, 0.05), (2.2, 0.95), h, pad=3)
    return sc.SceneBundle(
        name="l_panel2",
        grid=grid,
        models=models,
        colliders=colliders,
        particles=particles,
        params=SolverParameters(dt=dt, boundary_handling=BoundaryHandling.STICK,
                                damage_model=DamageModel.EIGENEROSION),
        gravity=(0.0, 0.0),
        hooks=hooks,
    )
