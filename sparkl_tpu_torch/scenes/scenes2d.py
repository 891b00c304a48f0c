"""2D scenes (port of the elasticity2, basic2, fluids2 and l_panel2 parts of
sparkl_tpu/scenes/scenes2d.py). Ref:
examples2d/{elasticity2,basic2,fluids2,l_panel2}.rs."""

import numpy as np

import sparkl_tpu_torch.scenes as sc
from sparkl_tpu_torch import device as _device
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.core.params import BoundaryHandling, DamageModel, SolverParameters
from sparkl_tpu_torch.core.particles import Particles, cube_particles
from sparkl_tpu_torch.geometry.colliders import cuboid, heightfield
from sparkl_tpu_torch.models import registry as reg
from sparkl_tpu_torch.solver.pipeline import DirichletVelocityHook


def _star_points(w):
    """8-point star from elasticity2.rs:52-60."""
    return np.array(
        [[w, -w], [w * 0.5, 0.0], [w, w], [0.0, w * 0.5], [-w, w], [-w * 0.5, 0.0], [-w, -w],
         [0.0, -w * 0.5]],
        np.float32,
    )


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


@sc.register_scene("elasticity2")
def elasticity2(seed=42, device="cuda"):
    """Five star-shaped corotated + Rankine blocks dropping into a box of
    three cuboids (the 2D baseline scene): E = 2e4, nu = 0.35, Rankine
    (tensile strength 1e2, softening 5), cell width 0.05, r = h/4, density
    2, crack factor 0.9, threshold 1, m_c 0.01, g 20000. The stars' centres
    are drawn from numpy's default_rng(seed). Ref: examples2d/elasticity2.rs."""
    device = _device.resolve(device)
    e, nu = 2.0e4, 0.35
    h = 0.05
    ground_height = h * 10.0
    ground_shift = h * 40.0
    colliders = (
        cuboid((1000.0, ground_height), translation=(0.0, ground_shift - ground_height)),
        cuboid((ground_height, 1000.0), translation=(ground_shift - ground_height, 0.0)),
        cuboid((ground_height, 1000.0),
               translation=(ground_shift - ground_height + ground_shift * 8.0, 0.0)),
    )
    models = reg.ModelSet.pack(
        [reg.ParticleModel(reg.corotated_linear_elasticity(e, nu),
                           reg.rankine_plasticity(e, nu, 1.0e2, 5.0))], device)

    rng = np.random.default_rng(seed)
    star = _star_points(h * 20.0)
    blocks = []
    for _ in range(5):
        cx = ground_shift + h * 40.0 * (rng.integers(0, 5) + 1)
        cy = ground_shift + h * 40.0 * (rng.integers(0, 5) + 1)
        blocks.append(_sample_polygon(star, (cx, cy), 0, h / 4.0, 2.0, device,
                                      crack_propagation_factor=0.9, crack_threshold=1.0,
                                      m_c=0.01, g=20000.0))
    grid = GridParams.for_domain((1.0, 1.0), (14.5, 14.5), h, pad=3)
    return sc.SceneBundle(
        name="elasticity2",
        grid=grid,
        models=models,
        colliders=colliders,
        particles=Particles.concatenate(tuple(blocks)),
        params=SolverParameters(dt=1.0 / 60.0),
        gravity=(0.0, -9.81),
    )


@sc.register_scene("basic2")
def basic2(device="cuda"):
    """Snow, sand and a breakable star on a sine-valley heightfield: snow
    (corotated E = 1e5, nu = 0.2, + Snow) in a 0.2 x 0.4 block at (40h,
    ground_shift + 0.8), density 1000; sand (the same block 0.5 higher,
    Drucker-Prager); the star (maximum stress 1e5) at (40h, 1.7), density
    4000; cell width 1/128, r = h/4; the heightfield -sin over 41 samples,
    scale (2, 1) at (0.5, 1.5); at most 50 substeps a frame. Ref:
    examples2d/basic2.rs."""
    device = _device.resolve(device)
    e, nu = 1.0e5, 0.2
    h = 1.0 / 128.0
    ground_shift = h * 10.0
    n = 40
    heights = -np.sin(np.arange(n + 1, dtype=np.float32) * np.pi / n)
    colliders = (heightfield(heights, scale=(2.0, 1.0), translation=(0.5, 1.5)),)
    elastic = reg.corotated_linear_elasticity(e, nu)
    models = reg.ModelSet.pack([
        reg.ParticleModel(elastic, reg.snow_plasticity()),
        reg.ParticleModel(elastic, reg.drucker_prager_plasticity(e, nu)),
        reg.ParticleModel(elastic,
                          failure=reg.maximum_stress_failure(1.0e5, np.finfo(np.float32).max)),
    ], device)

    r = h / 4.0
    cx = h * 40.0
    cy = ground_shift + 0.8
    xs = np.arange(-0.1 + r, 0.1, 2 * r, dtype=np.float32)
    ys = np.arange(-0.2 + r, 0.2, 2 * r, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    snow_pts = np.stack([gx.reshape(-1), gy.reshape(-1)], -1) + np.asarray((cx, cy), np.float32)
    blocks = [
        Particles.from_positions(snow_pts, 0, r, 1000.0, device),
        Particles.from_positions(snow_pts + np.asarray([0.0, 0.5], np.float32), 1, r, 1000.0,
                                 device),
        _sample_polygon(_star_points(h * 10.0), (cx, 1.7), 2, r, 4000.0, device),
    ]
    grid = GridParams.for_domain((-0.8, 0.3), (1.8, 2.6), h, pad=3)
    return sc.SceneBundle(
        name="basic2",
        grid=grid,
        models=models,
        colliders=colliders,
        particles=Particles.concatenate(tuple(blocks)),
        params=SolverParameters(dt=1.0 / 60.0, max_num_substeps=50),
        gravity=(0.0, -9.81),
    )


@sc.register_scene("fluids2")
def fluids2(n=300, device="cuda"):
    """SPH-EOS dam break, n x n particles (90,000 as published): Monaghan
    EOS (p0 = 1e4, gamma 7, viscosity 1.01e-3), cell width 0.1, r = h/4,
    density 1000, a ground and two walls (cuboids), fluid volume
    recomputation forced. Ref: examples2d/fluids2.rs."""
    device = _device.resolve(device)
    h = 0.1
    ground_height = h * 10.0
    ground_shift = h * 40.0
    colliders = (
        cuboid((1000.0, ground_height), translation=(0.0, ground_shift - ground_height)),
        cuboid((ground_height, 1000.0), translation=(ground_shift - ground_height, 0.0)),
        cuboid((ground_height, 1000.0),
               translation=(ground_shift - ground_height + ground_shift * 8.0, 0.0)),
    )
    models = reg.ModelSet.pack(
        [reg.ParticleModel(reg.monaghan_sph_eos(1.0e4, 7, 1.01e-3, 1.0))], device
    )
    particles = cube_particles(
        origin=(ground_shift + h * 2.0 + h / 4.0, ground_shift + h * 2.0 + h / 4.0),
        counts=(n, n), model_id=0, particle_radius=h / 4.0, density0=1000.0, device=device,
    )
    grid = GridParams.for_domain((2.5, 2.5), (36.5, 24.0), h, pad=3)
    return sc.SceneBundle(
        name="fluids2",
        grid=grid,
        models=models,
        colliders=colliders,
        particles=particles,
        params=SolverParameters(dt=1.0 / 60.0, force_fluids_volume_recomputation=True),
        gravity=(0.0, -9.81),
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
