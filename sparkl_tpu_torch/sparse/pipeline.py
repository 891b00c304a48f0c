"""Block-sparse MPM pipeline (port of sparkl_tpu/sparse/pipeline.py).

Per substep: mark out-of-grid particles failed, rebuild the block
structure (one stable key sort), recompute the fluid volumes from the grid
mass (with force_fluids_volume_recomputation), take the adaptive dt, run
eigenerosion's neighbour pooling (sparse/neighbors.py), then pack the
particles' transfer fields into chunk slots, P2G through the window kernel,
merge the window images into the block node table (the scatter merge),
update the grid (gravity, collider boundary conditions on every node, the
hooks), gather the velocity windows (and the psi ratio), G2P through the
window kernel, map the slots back to particle order and update the
particles (SVD, return maps, guards, the failure model, modified
eigenerosion's trip). Ref: sparkl `src/cuda/cuda_mpm_pipeline.rs:262-645`.

The JAX package runs a frame as one device while_loop. This port runs a
host loop with one host read per substep, which carries the dt bound, the
structure's counts and eigenerosion's bucket overflow (the capacity
checks) together, as the reference's CUDA pipeline reads its dt and block
counts. On overflow the frame is retried from its unchanged input with
grown capacities (or, for the buckets, twice their depth).

The pipeline carries 2D and 3D scenes with every constitutive and plastic
model the port has (corotated, neo-Hookean, the Monaghan EOS with the
fluid volume pass; Drucker-Prager, NACC, Rankine, Snow), maximum-stress
failure, eigenerosion and modified eigenerosion, heightfield and cuboid
colliders and grid hooks. The constructor raises NotImplementedError for
CD-MPM, penalty colliders, other collider shapes, boundary particle
projection and GPU boundary semantics, and step_with_stats for runtime
collider poses: those wait for later ports and never fall back to another
path.
"""

from typing import Optional

import numpy as np
import torch

from sparkl_tpu_torch import device as _device
from sparkl_tpu_torch.core.grid import GridParams, GridState
from sparkl_tpu_torch.core.params import DamageModel, SolverParameters
from sparkl_tpu_torch.fused.kernels import kernel_meta, meta_unsupported
from sparkl_tpu_torch.geometry.colliders import CUBOID, HEIGHTFIELD
from sparkl_tpu_torch.math import linalg
from sparkl_tpu_torch.math.kernel import inv_d as kernel_inv_d
from sparkl_tpu_torch.models import registry
from sparkl_tpu_torch.ops import transfer_kernels as K
from sparkl_tpu_torch.solver import dense
from sparkl_tpu_torch.solver.eigenerosion import default_max_per_cell, evolve_eigenerosion
from sparkl_tpu_torch.solver.pipeline import MpmHooks
from sparkl_tpu_torch.sparse import blocks as B
from sparkl_tpu_torch.sparse import transfer as T

# Overflow flag bits: the host regrow-retry loop grows the capacity that
# actually tripped.
OVERFLOW_TABLES = 1  # block / chunk / grid tables
OVERFLOW_EIGEN = 2  # eigenerosion: a cell's (sparse) or a block's (fused) candidates
OVERFLOW_MERGE = 4  # a block compressed past MERGE_KMAX chunks (fused merge)


def unsupported(grid, models, colliders, params, fused=False):
    """Why the port's pipelines cannot run this configuration: a list of
    reasons, empty if they can. Both refuse model sets the registry does
    not carry, penalty colliders, collider shapes other than heightfields
    and cuboids, boundary particle projection and GPU boundary semantics;
    the sparse pipeline also CD-MPM (the phase field is not ported), the
    fused one what its kernels do not carry (fused.kernels.meta_unsupported,
    CD-MPM among it)."""
    why = []
    m = models.unsupported()
    if m:
        why.append(m)
    if params.enable_boundary_particle_projection:
        why.append("boundary particle projection")
    if params.gpu_boundary_semantics:
        why.append("GPU boundary semantics")
    for c in colliders:
        if c.shape_type not in (HEIGHTFIELD, CUBOID) or len(c.translation) != grid.dim:
            why.append(f"collider shape {c.shape_type} of {len(c.translation)}D in {grid.dim}D")
        if float(c.penalty_stiffness) > 0.0:
            why.append("penalty colliders")
    if fused:
        if not m:
            why += meta_unsupported(kernel_meta(models, params), grid.dim)
        return why
    if grid.dim not in (2, 3):
        why.append(f"{grid.dim}D grids")
    if params.damage_model == DamageModel.CD_MPM:
        why.append("damage model CD_MPM (the phase field is not ported)")
    return why


class SparseMpmPipeline:
    """step / step_with_stats / run_frames on Particles; the block-sparse
    window-kernel transfer path."""

    def __init__(
        self,
        grid: GridParams,
        models: registry.ModelSet,
        colliders=(),
        params: SolverParameters = SolverParameters(),
        gravity=None,
        hooks: Optional[MpmHooks] = None,
        config: Optional[B.BlockConfig] = None,
        calibration_slack: float = 1.4,
        device="cuda",
    ):
        why = unsupported(grid, models, colliders, params)
        if why:
            raise NotImplementedError(
                "SparseMpmPipeline (torch port) does not carry: " + "; ".join(why)
            )
        self.device = _device.resolve(device)
        if models.ctype.device != self.device:
            raise ValueError(f"models on {models.ctype.device}, pipeline on {self.device}")
        self.grid = grid
        self.models = models
        self.colliders = tuple(colliders)
        self.params = params
        if gravity is None:
            gravity = [0.0, -9.81] if grid.dim == 2 else [0.0, -9.81, 0.0]
        self.gravity = torch.tensor(gravity, dtype=torch.float32, device=self.device)
        self.hooks = hooks or MpmHooks()
        self._cfg = config
        self._calibration_slack = calibration_slack
        self._low_use_frames = 0
        # Eigenerosion's bucket depth per cell; doubled on OVERFLOW_EIGEN,
        # which eigen_regrows counts.
        self._eigen_k = default_max_per_cell(grid.dim)
        self.eigen_regrows = 0

    @property
    def _with_psi(self):
        # The psi (crack energy) channels ride the transfers only for the
        # eigenerosion family.
        return self.params.damage_model in (DamageModel.EIGENEROSION,
                                            DamageModel.MODIFIED_EIGENEROSION)

    # -- capacity management (host-side regrow & retry) ----------------------

    def _ensure_cfg(self, p):
        if self._cfg is None:
            self._cfg = B.BlockConfig.calibrate(
                self.grid, p.position, p.active, slack=self._calibration_slack
            )

    def _grow(self, factor=1.6):
        c = self._cfg
        self._cfg = B.BlockConfig(
            max_blocks=int(c.max_blocks * factor) + 64,
            max_chunks=int(c.max_chunks * factor) + 64,
            chunk_size=c.chunk_size,
            max_grid_blocks=int(c.max_grid_blocks * factor) + 64,
        )

    def _adapt_capacity(self, peak_chunks, p):
        """Re-calibrate from the current particle distribution when chunk
        occupancy crosses 85% (before an overflow wastes a frame) or stays
        under 45% for 20 frames (padding costs time in every per-slot
        stage); the reference regrows its hashmap at >50% load
        (cuda_sparse_grid.rs:217-221)."""
        cap = self._cfg.max_chunks
        if peak_chunks > 0.85 * cap:
            self._recalibrate(p)
        elif peak_chunks < 0.45 * cap:
            self._low_use_frames += 1
            if self._low_use_frames >= 20:
                self._recalibrate(p)
        else:
            self._low_use_frames = 0

    def _recalibrate(self, p):
        self._cfg = B.BlockConfig.calibrate(
            self.grid, p.position, p.active, slack=self._calibration_slack
        )
        self._low_use_frames = 0

    # -- one substep -------------------------------------------------------------

    def _recompute_fluids_sparse(self, p, structure, inv_perm, plan):
        """Fluid volume recomputation on the block-sparse transfers: a
        mass-only P2G and a per-particle mass gather in the einsum form
        (sparse/transfer.py, as the JAX package runs this pass: XLA glue, not
        a window kernel) with the scatter merge between; sets F00 = J =
        V_new / V0 for active fluid particles (ref: fluids_volume.rs
        recompute_fluids_volumes)."""
        grid, cfg = self.grid, self._cfg
        dim = grid.dim
        cpb = B.cells_per_block(dim)
        zero = torch.zeros_like(p.mass)
        images = T.p2g_images(grid, cfg, structure, p.position, p.mass,
                              torch.zeros_like(p.velocity), torch.zeros_like(p.velocity_gradient),
                              zero, zero, with_psi=True)
        node = T.merge_images_to_grid(grid, cfg, structure, images, force_scatter=True,
                                      plan=plan)
        mass_g = node.reshape(cfg.max_grid_blocks + 1, dim + 3, cpb)[:, 0, :]
        # Gathered through the psi channel of the window machinery.
        win_fields = torch.cat([mass_g.new_zeros((cfg.max_grid_blocks + 1, dim, cpb)),
                                mass_g[:, None, :]], dim=1).reshape(cfg.max_grid_blocks + 1, -1)
        windows = T.gather_grid_windows(grid, cfg, structure, win_fields)
        _, _, _, mass_s, _ = T.g2p_from_windows(grid, cfg, structure, p.position, windows,
                                                with_psi=True)
        (new_mass,) = T.scatter_slots_to_particles(cfg, structure, inv_perm, mass_s)
        new_density = linalg.div_const(new_mass, grid.cell_width**dim)
        new_volume = p.mass / torch.clamp(new_density, min=1e-20)
        f = p.deformation_gradient.clone()
        f[:, 0, 0] = torch.where(self.models.is_fluid(p.model_id) & p.active,
                                 new_volume / p.volume0, f[:, 0, 0])
        return p.replace(deformation_gradient=f)

    def _substep(self, p, dt, structure, inv_perm, plan):
        """P2G -> merge -> grid update -> windows -> G2P -> particle update.
        `dt` is a host float32."""
        grid, models, params, cfg = self.grid, self.models, self.params, self._cfg
        dim = grid.dim
        cpb = B.cells_per_block(dim)
        invd = kernel_inv_d(grid.cell_width)
        with_psi = self._with_psi
        nf = 1 + dim + (2 if with_psi else 0)

        # Stress + affine.
        stress = registry.kirchhoff_stress(
            models, p.model_id, p.phase, p.elastic_hardening, p.deformation_gradient,
            p.velocity_gradient, p.mass, p.volume0,
        )
        stress = torch.where(p.failed[..., None, None], 0.0, stress)
        affine = (p.mass[..., None, None] * p.velocity_gradient
                  - (p.volume0 * invd * dt)[..., None, None] * stress)
        psi_mass_p = torch.where(
            (p.phase > 0.0) & (p.crack_propagation_factor != 0.0) & ~p.failed, p.mass, 0.0
        )
        psi_mom_p = psi_mass_p * p.psi_pos
        velocity_p2g = p.velocity
        pen = dense.penalty_velocity_delta(self.colliders, p.position, p.mass, dt)
        if pen is not None:
            velocity_p2g = velocity_p2g + pen

        # P2G: one wide row gather into chunk-slot layout, then the kernel.
        packed = K.pack_p2g_inputs(p.position, p.mass, velocity_p2g, affine, psi_mass_p,
                                   psi_mom_p)
        slot_data = K.gather_slot_data(cfg, structure, packed)
        images = K.p2g_windows(grid, cfg, slot_data, with_psi=with_psi)
        node = T.merge_images_to_grid(grid, cfg, structure, images, force_scatter=True,
                                      plan=plan)
        node = node.reshape(cfg.max_grid_blocks + 1, nf, cpb)
        mass = node[:, 0, :]
        mom = node[:, 1 : 1 + dim, :].transpose(1, 2)  # [MGB+1, cpb, d]
        zero = torch.zeros_like(mass)
        psi_mom_g, psi_mass_g = (node[:, 1 + dim, :], node[:, 2 + dim, :]) if with_psi else (
            zero, zero)

        inv_mass = linalg.inv_exact(mass)
        velocity = (mom + mass[..., None] * self.gravity * dt) * inv_mass[..., None]

        # Grid update, with every node projected onto the colliders; the hooks.
        node_pos = B.block_node_positions(grid, structure.grid_keys)
        node_pos = torch.cat(
            [node_pos, torch.full((1, cpb, dim), 1.0e10, dtype=torch.float32,
                                  device=node_pos.device)], dim=0
        )
        gstate = GridState(mass=mass, momentum=mom, velocity=velocity,
                           psi_momentum=psi_mom_g, psi_mass=psi_mass_g)
        gstate = dense.grid_update(
            grid, gstate, self.colliders, dt, params.boundary_handling,
            params.simulation_dofs, node_positions=node_pos,
        )
        gstate = self.hooks.post_grid_update(gstate, grid, dt, node_pos)
        velocity = gstate.velocity
        velocity[cfg.max_grid_blocks] = 0.0

        # G2P: velocity (and psi ratio) windows, the kernel, one row gather
        # back to particles.
        win_parts = [velocity.transpose(1, 2)]
        if with_psi:
            win_parts.append((psi_mom_g * linalg.inv_exact(psi_mass_g))[:, None, :])
        win_fields = torch.cat(win_parts, dim=1).reshape(cfg.max_grid_blocks + 1, -1)
        windows = T.gather_grid_windows(grid, cfg, structure, win_fields).contiguous()
        out = K.g2p_windows(grid, cfg, slot_data, windows, with_psi=with_psi)
        rows = out.transpose(1, 2).reshape(cfg.max_chunks * cfg.chunk_size, out.shape[1])
        got = T.gather_slot_rows(cfg, structure, inv_perm, rows)
        velocity_p = got[:, :dim]
        grad_cols = got[:, dim : dim + dim * dim].reshape(-1, dim, dim)
        grad_p = grad_cols.transpose(1, 2)  # rows were j-major
        det_p = sum(grad_cols[:, j, j] for j in range(dim))
        psi_p = got[:, dim + dim * dim] if with_psi else torch.zeros_like(det_p)

        return dense.particle_update_after_gather(
            grid, p, models, dt, velocity_p, grad_p, det_p, psi_p,
            colliders=self.colliders, damage_model=params.damage_model,
            enable_boundary_particle_projection=params.enable_boundary_particle_projection,
            gpu_velocity_clamp=params.gpu_velocity_clamp,
        )

    def _step_impl(self, p):
        """One frame: substeps until params.dt is consumed. Returns (p,
        substeps, overflow flags, most chunks in use); nonzero flags abort
        the frame before any kernel sees the overflowed structure (the fluid
        pass and the pooling, which run before the read, only index within
        their tables)."""
        grid, models, params, cfg = self.grid, self.models, self.params, self._cfg
        f32 = np.float32
        min_dt = f32(params.dt / params.max_num_substeps)
        remaining = f32(params.dt)
        niter = peak = 0
        while remaining > 0.0 and niter < params.max_num_substeps:
            p = dense.mark_out_of_grid_failed(grid, p)
            # One structure per substep, shared by the fluid pass and the
            # transfers (the reference sorts once per substep too).
            structure = B.build_structure(grid, cfg, p.position, p.active)
            inv_perm = torch.empty_like(structure.sorted_ids)
            inv_perm[structure.sorted_ids.long()] = torch.arange(
                p.capacity, dtype=torch.int32, device=p.device)
            plan = T.scatter_plan(cfg, structure)
            if params.force_fluids_volume_recomputation:
                p = self._recompute_fluids_sparse(p, structure, inv_perm, plan)
            max_dt = min(remaining, f32(params.max_substep_dt))
            dt = dense.adaptive_timestep(
                grid, p, models, torch.tensor(max_dt, dtype=torch.float32, device=p.device))
            eig_ov = torch.zeros((), dtype=torch.bool, device=p.device)
            if params.damage_model == DamageModel.EIGENEROSION:
                p, eig_ov = evolve_eigenerosion(grid, p, self._eigen_k)
            # The substep's one host read: dt (as its bits), the structure's
            # counts and the bucket overflow.
            vals = torch.stack([
                dt.view(torch.int32), structure.num_blocks, structure.num_grid_blocks,
                structure.num_chunks, eig_ov.to(torch.int32),
            ]).cpu().numpy()
            dt = vals[:1].view(np.float32)[0]
            nb, ngb, nc, eig = (int(v) for v in vals[1:])
            flags = (OVERFLOW_TABLES if nb > cfg.max_blocks or ngb > cfg.max_grid_blocks
                     or nc > cfg.max_chunks else 0) | (OVERFLOW_EIGEN if eig else 0)
            if flags:
                return p, niter, flags, peak
            peak = max(peak, nc)
            if dt < min_dt and remaining > min_dt:
                dt = min_dt
            p = self._substep(p, float(dt), structure, inv_perm, plan)
            remaining = f32(0.0) if params.stop_after_one_substep else f32(remaining - dt)
            niter += 1
        return p, niter, 0, peak

    # -- public API -----------------------------------------------------------

    def _check_particles(self, particles):
        if particles.device != self.device:
            raise ValueError(f"particles on {particles.device}, pipeline on {self.device}")

    def step(self, particles):
        p, _ = self.step_with_stats(particles)
        return p

    def step_with_stats(self, particles, poses=None):
        """One frame; returns (particles, substeps)."""
        if poses is not None:
            raise NotImplementedError("SparseMpmPipeline (torch port): runtime collider "
                                      "poses are not ported")
        return self.run_frames(particles, 1)

    def run_frames(self, particles, num_frames: int):
        """Advance `num_frames` frames; returns (particles, total substeps).
        A capacity overflow in any frame grows what tripped (the tables, or
        the eigenerosion buckets' depth) and retries the span from its
        input. (The JAX package's `frames_per_launch` bounds the size of one
        device program; a host loop has none to bound.)"""
        self._check_particles(particles)
        self._ensure_cfg(particles)
        for _attempt in range(6):
            p, total, peak, flags = particles, 0, 0, 0
            for _ in range(num_frames):
                p, n, flags, pk = self._step_impl(p)
                total += n
                peak = max(peak, pk)
                if flags:
                    break
            if flags == 0:
                self._adapt_capacity(peak, p)
                return p, total
            if flags & OVERFLOW_EIGEN:
                # A cell held more eligible particles than the buckets take:
                # the pool would drop neighbours (the reference never does).
                self._eigen_k *= 2
                self.eigen_regrows += 1
            if flags & OVERFLOW_TABLES:
                self._grow()
        raise RuntimeError("block table capacity still overflowing after regrows")
