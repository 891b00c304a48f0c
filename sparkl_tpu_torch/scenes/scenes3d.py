"""3D scenes (port of sparkl_tpu/scenes/scenes3d.py). Ref:
examples3d/{sand3,cube_through_sand3,fluids3,sand_penetration3}.rs."""

import numpy as np

import sparkl_tpu_torch.scenes as sc
from sparkl_tpu_torch import device as _device
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.core.params import SolverParameters
from sparkl_tpu_torch.core.particles import Particles, cube_particles
from sparkl_tpu_torch.geometry.colliders import heightfield
from sparkl_tpu_torch.models import registry as reg


def _sine_valley():
    """sand3's heightfield: heights -sin(pi·i/40) along x, scale (40, 10,
    40) at y = 10."""
    hf_n = 40
    i = np.arange(hf_n + 1, dtype=np.float32)
    heights = np.broadcast_to(
        -np.sin(i[:, None] * np.pi / hf_n), (hf_n + 1, hf_n + 1)
    ).astype(np.float32)
    return heightfield(heights, scale=(40.0, 10.0, 40.0), translation=(0.0, 10.0, 0.0))


def _sand_model(e, nu):
    return reg.ParticleModel(
        reg.corotated_linear_elasticity(e, nu),
        reg.drucker_prager_plasticity(e, nu),
    )


@sc.register_scene("sand3")
def sand3(nx=100, ny=50, nz=50, device="cuda"):
    """Sand column (corotated + Drucker-Prager) above a plain corotated
    block on a sine-valley heightfield: E=1e7, nu=0.2, cell_width=0.2,
    r=h/4, density 2700. 2·nx·ny·nz particles."""
    device = _device.resolve(device)
    e, nu = 1.0e7, 0.2
    h = 0.2
    r = h / 4.0

    models = reg.ModelSet.pack(
        [_sand_model(e, nu), reg.ParticleModel(reg.corotated_linear_elasticity(e, nu))], device
    )

    y0 = h * 3.0 + 2.0 + r * 2.0 * ny
    sand_particles = cube_particles(
        origin=(0.0, y0, 0.0), counts=(nx, ny, nz), model_id=0,
        particle_radius=r, density0=2700.0, device=device,
    )
    block_particles = cube_particles(
        origin=(0.0, h * 3.0 + 2.0, 0.0), counts=(nx, ny, nz), model_id=1,
        particle_radius=r, density0=2700.0, device=device,
    )
    particles = Particles.concatenate((sand_particles, block_particles))

    x_hi = nx * 2 * r
    grid = GridParams.for_domain(
        (-6.0, -1.0, -6.0), (x_hi + 6.0, y0 + ny * 2 * r + 1.0, nz * 2 * r + 6.0), h, pad=2
    )
    return sc.SceneBundle(
        name="sand3",
        grid=grid,
        models=models,
        colliders=(_sine_valley(),),
        particles=particles,
        params=SolverParameters(dt=1.0 / 60.0),
        gravity=(0.0, -9.81, 0.0),
    )


@sc.register_scene("cube_through_sand3")
def cube_through_sand3(nx=100, ny=50, nz=50, device="cuda"):
    """A kinematic 25^3 block (kinematic_vel = 10 x̂, corotated) driven
    through a sand bed (corotated + Drucker-Prager, nx·ny·nz particles) on
    sand3's sine-valley heightfield: E=1e7, nu=0.2, density 2700, h=0.2,
    r=h/4; sand at (0, 2.6, 0), the block at (-10, 2.6, 0). Ref:
    examples3d/cube_through_sand3.rs."""
    device = _device.resolve(device)
    e, nu = 1.0e7, 0.2
    h = 0.2
    r = h / 4.0
    models = reg.ModelSet.pack(
        [_sand_model(e, nu), reg.ParticleModel(reg.corotated_linear_elasticity(e, nu))], device
    )
    y0 = h * 3.0 + 2.0
    sand_particles = cube_particles(
        origin=(0.0, y0, 0.0), counts=(nx, ny, nz), model_id=0,
        particle_radius=r, density0=2700.0, device=device,
    )
    block_particles = cube_particles(
        origin=(-10.0, y0, 0.0), counts=(25, 25, 25), model_id=1,
        particle_radius=r, density0=2700.0, device=device,
        kinematic_enabled=True,
        kinematic_vel=np.asarray((10.0, 0.0, 0.0), np.float32),
    )
    particles = Particles.concatenate((sand_particles, block_particles))
    grid = GridParams.for_domain(
        (-12.0, -1.0, -6.0), (nx * 2 * r + 8.0, y0 + ny * 2 * r + 2.0, nz * 2 * r + 6.0),
        h, pad=2,
    )
    return sc.SceneBundle(
        name="cube_through_sand3",
        grid=grid,
        models=models,
        colliders=(_sine_valley(),),
        particles=particles,
        params=SolverParameters(dt=1.0 / 60.0),
        gravity=(0.0, -9.81, 0.0),
    )


def _rot_x(theta):
    """Rotation by theta about x, formed in float64 and cast to float32:
    the terms that are 0 in exact arithmetic come out as sin(pi) = 1.2e-16
    or cos(pi/2) = 6.1e-17, not 0."""
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


@sc.register_scene("sand_penetration3")
def sand_penetration3(nx=100, ny=50, nz=50, device="cuda"):
    """A sand column (corotated + Drucker-Prager, nx·ny·nz particles)
    dropped through four rippled heightfield plates, heights
    sin(10·pi·i/40) at scale (40, 1, 40): a plate at y = 10, an inverted
    one at y = 12 (rotated by pi about x) and two upright ones at z = ±5
    (rotated by ∓pi/2 about x). E=1e7, nu=0.2, density 2700, h=0.2, r=h/4,
    dropped from y = 2(3h + 2 + ny·2r). Ref: examples3d/sand_penetration3.rs."""
    device = _device.resolve(device)
    e, nu = 1.0e7, 0.2
    h = 0.2
    r = h / 4.0

    n = 40
    i = np.arange(n + 1, dtype=np.float32)
    heights = np.broadcast_to(
        np.sin(i[:, None] * np.pi / n * 10.0), (n + 1, n + 1)
    ).astype(np.float32)
    scale = (40.0, 1.0, 40.0)
    colliders = (
        heightfield(heights, scale=scale, translation=(0.0, 10.0, 0.0)),
        heightfield(heights, scale=scale, translation=(0.0, 12.0, 0.0),
                    rotation=_rot_x(np.pi)),
        heightfield(heights, scale=scale, translation=(0.0, 0.0, 5.0),
                    rotation=_rot_x(-np.pi / 2.0)),
        heightfield(heights, scale=scale, translation=(0.0, 0.0, -5.0),
                    rotation=_rot_x(np.pi / 2.0)),
    )
    models = reg.ModelSet.pack([_sand_model(e, nu)], device)
    y0 = 2.0 * (h * 3.0 + 2.0 + r * 2.0 * ny)
    particles = cube_particles(
        origin=(0.0, y0, 0.0), counts=(nx, ny, nz), model_id=0,
        particle_radius=r, density0=2700.0, device=device,
    )
    grid = GridParams.for_domain(
        (-8.0, -2.0, -8.0), (nx * 2 * r + 8.0, y0 + ny * 2 * r + 1.0, nz * 2 * r + 8.0),
        h, pad=2,
    )
    return sc.SceneBundle(
        name="sand_penetration3",
        grid=grid,
        models=models,
        colliders=colliders,
        particles=particles,
        params=SolverParameters(dt=1.0 / 60.0),
        gravity=(0.0, -9.81, 0.0),
    )


@sc.register_scene("fluids3")
def fluids3(device="cuda"):
    """15.2k-particle free-falling EOS fluid blob, no colliders: cell_width
    0.8, particle radius 0.1 (not h/4), p0 = 1e6, gamma 7, viscosity
    1.01e-3, origin (1.6, 1.6, 1.6), density 1000, fluid volume
    recomputation forced; the grid leaves fall room below. Ref:
    examples3d/fluids3.rs."""
    device = _device.resolve(device)
    h = 0.8
    r = 0.1
    models = reg.ModelSet.pack(
        [reg.ParticleModel(reg.monaghan_sph_eos(1.0e6, 7, 1.01e-3, 1.0))], device
    )
    particles = cube_particles(
        origin=(1.6, 1.6, 1.6), counts=(38, 20, 20), model_id=0,
        particle_radius=r, density0=1000.0, device=device,
    )
    grid = GridParams.for_domain((-8.0, -40.0, -8.0), (18.0, 8.0, 14.0), h, pad=2)
    return sc.SceneBundle(
        name="fluids3",
        grid=grid,
        models=models,
        colliders=(),
        particles=particles,
        params=SolverParameters(dt=1.0 / 60.0, force_fluids_volume_recomputation=True),
        gravity=(0.0, -9.81, 0.0),
    )
