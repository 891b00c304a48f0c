"""Fused MPM pipeline: persistent slot state + the fused substep kernels
(port of sparkl_tpu/fused/pipeline.py for the slice's configuration).

Particle state lives in chunk-slot layout between substeps; kernel A turns
slots into window images, the merge kernel sums them into the block node
table, the grid update applies gravity and the cached collider
projections, and kernel B gathers, updates every particle and writes the
next dt bound in place. The structure is rebuilt lazily, when accumulated
drift reaches DRIFT_FRACTION of a cell (the off-by-two window tolerates
one cell). With force_fluids_volume_recomputation, each substep first
recomputes every fluid particle's volume from the grid mass (the mass
kernels, the merge and the window gather), sets J = F00 = V/V0 and
refreshes the carried dt bound, as the JAX package does. With eigenerosion,
each substep pools m·psi_pos and m over every eligible slot's neighbours
within one cell width (the pooling kernel over the chunks of the 3^d
neighbouring blocks) before the kernels, after the dt is taken; kernel A
then scatters the psi channels and kernel B trips maximum-stress failure.
With modified eigenerosion there is no pooling: the grid carries the psi
ratio to the windows and kernel B trips the crack energy it gathers.

Unlike the JAX package, which runs a frame span as one device program,
this port runs eagerly with a host loop over substeps and one host read
per substep (the drift trigger and the dt bound together), as the
reference's CUDA pipeline does (cuda_mpm_pipeline.rs:393-398). Resort
substeps read a few more scalars to choose their branch. The fluid path
runs the volume pass, which rewrites the dt bound, before that read, and
on resort substeps runs it again after the resort and reads the bound
again, which gives the reference's order (resort, volume pass, dt).
Capturing the substep in a CUDA graph is later work.

The port carries 3D and 2D scenes with corotated or neo-Hookean
elasticity (± Drucker-Prager, NACC, Rankine or Snow plasticity),
eigenerosion, modified eigenerosion and maximum-stress failure, Monaghan
EOS fluids, static heightfield or cuboid colliders and grid hooks, the
stress cache on without damage and failure and off with them
(sparse.pipeline.unsupported lists the rest). The constructor raises
NotImplementedError for anything else (CD-MPM, custom models, penalty
colliders, boundary particle projection, GPU boundary semantics, collider
pose functions): those wait for later ports and never fall back to
another path.
"""

from typing import Optional

import numpy as np
import torch

from sparkl_tpu_torch import device as _device
from sparkl_tpu_torch.core.grid import GridParams, GridState
from sparkl_tpu_torch.core.params import DamageModel, SolverParameters
from sparkl_tpu_torch.math import linalg
from sparkl_tpu_torch.models import constitutive as con
from sparkl_tpu_torch.models import registry
from sparkl_tpu_torch.solver import dense
from sparkl_tpu_torch.solver.pipeline import MpmHooks
from sparkl_tpu_torch.sparse import blocks as B
from sparkl_tpu_torch.sparse import transfer as T
from sparkl_tpu_torch.sparse.pipeline import (
    OVERFLOW_EIGEN,
    OVERFLOW_MERGE,
    OVERFLOW_TABLES,
    unsupported,
)
from sparkl_tpu_torch.fused import kernels as K
from sparkl_tpu_torch.fused import layout as L
from sparkl_tpu_torch.fused import structure as S

# Resort when accumulated displacement reaches this fraction of a cell.
DRIFT_FRACTION = 0.9


class FusedMpmPipeline:
    """step / run_frames on Particles, or pack_state -> run_frames_state ->
    unpack_state on a resident SlotState."""

    def __init__(
        self,
        grid: GridParams,
        models: registry.ModelSet,
        colliders=(),
        params: SolverParameters = SolverParameters(),
        gravity=None,
        hooks=None,
        config: Optional[B.BlockConfig] = None,
        calibration_slack: float = 1.4,
        collider_pose_fn=None,
        device="cuda",
    ):
        why = unsupported(grid, models, colliders, params, fused=True)
        if collider_pose_fn is not None:
            why.append("collider pose functions")
        if why:
            raise NotImplementedError(
                "FusedMpmPipeline (torch port) does not carry: " + "; ".join(why)
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
        self._tab_f, self._tab_i = K.pack_model_tables(models)
        self._meta = K.kernel_meta(models, params)
        self._kparams = dict(gpu_velocity_clamp=params.gpu_velocity_clamp)
        # Sticky scatter fallback for the merge, pinned (with a span retry)
        # the first time a block exceeds MERGE_KMAX chunks.
        self._merge_force_scatter = False
        self._span_peak = 0  # most chunks in use during the current span
        # Candidate chunks per neighbour block for the eigenerosion pooling
        # (nominal packing fills a block with <= 2 chunks in 2D, 4 in 3D); a
        # denser block raises OVERFLOW_EIGEN and the span is retried with
        # the list doubled. eigen_regrows counts those retries.
        self._eigen = params.damage_model == DamageModel.EIGENEROSION
        self._eigen_mcb = 2 if grid.dim == 2 else 4
        self.eigen_regrows = 0
        self.last_resorts = 0
        # Resorts taken per branch; the source-row kernel runs on "pure"
        # and "mixed" ones, the permute kernel on "mixed" ones.
        self.resort_branches = {"relabel": 0, "pure": 0, "mixed": 0}

    # -- capacity management --------------------------------------------------

    def _ensure_cfg(self, p):
        if self._cfg is None:
            self._cfg = S.calibrate_ob2(
                self.grid, p.position, p.active, slack=self._calibration_slack
            )

    def _grow(self, factor=1.6):
        c = self._cfg

        def q(x, step):
            return -(-int(x) // step) * step

        self._cfg = B.BlockConfig(
            max_blocks=q(c.max_blocks * factor + 64, 256),
            max_chunks=q(c.max_chunks * factor + 64, 512),
            chunk_size=c.chunk_size,
            max_grid_blocks=q(c.max_grid_blocks * factor + 64, 256),
        )

    @property
    def _rows(self):
        return L.Rows(self.grid.dim)

    def _occupied(self, state):
        return (state.ints[:, L.I_FLAGS, :] & L.OCCUPIED) != 0

    def _active(self, state):
        return (state.ints[:, L.I_FLAGS, :] & L.ACTIVE) != 0

    # -- one substep -------------------------------------------------------------

    def _cell_order(self):
        """The fused kernels' window cell order: z-major in 3D, row-major
        (None) in 2D."""
        return T.ZMAJOR_ORDER_3D if self.grid.dim == 3 else None

    def _substep(self, state, dt):
        """P2G -> merge -> grid update -> G2P (kernel B reads the window
        fields at each chunk's corner blocks itself). `dt` is a host
        float32. Returns the new state."""
        nchunks = state.structure.num_chunks
        images = K.p2g_fused(self.grid, self._cfg, self._meta, state.slots,
                             state.ints, dt, nchunks, tables=(self._tab_f, self._tab_i))
        new_slots = K.g2p_fused(
            self.grid, self._cfg, self._meta, self._kparams, state.slots, state.ints,
            self._node_fields(state, images, dt), self._corners(state), dt, self._tab_f,
            self._tab_i, nchunks,
        )
        return state.replace(slots=new_slots,
                             cum_disp=torch.max(new_slots[:, self._rows.cumd, :]))

    def _node_fields(self, state, images, dt):
        """Window images -> node table (merge) -> grid velocity with gravity,
        the collider boundary conditions and the hooks -> the window fields
        [MG + 1, (d (+1)) · 4^d] kernel B reads: the velocity, and with the
        psi channels the psi ratio psi_mom / psi_mass. The two stages are
        methods of their own (_merge_nodes, _grid_fields)."""
        return self._grid_fields(state, self._merge_nodes(state, images), dt)

    @staticmethod
    def _corners(state):
        """[D, 2^d] i32: each chunk's corner blocks' rows in the node table
        (built with the structure, in its grid cache)."""
        return state.grid_cache[3]

    def _merge_nodes(self, state, images):
        """Window images [D, nf, 8^d] -> the block node table [MG + 1, nf,
        4^d] (the merge)."""
        grid, cfg = self.grid, self._cfg
        node, _ = T.merge_images_to_grid(
            grid, cfg, state.structure, images, cell_order=self._cell_order(),
            force_scatter=self._merge_force_scatter, plan=state.grid_cache[2],
        )
        return node.reshape(cfg.max_grid_blocks + 1, images.shape[1], B.cells_per_block(grid.dim))

    def _grid_fields(self, state, node, dt):
        """The node table -> the window fields [MG + 1, (d (+1)) · 4^d]:
        velocity from momentum and mass with gravity, the colliders'
        boundary conditions and the hooks (and the psi ratio)."""
        grid, cfg, params = self.grid, self._cfg, self.params
        dim = grid.dim
        with_psi = self._meta["with_psi"]
        mass = node[:, 0, :]
        mom = node[:, 1 : 1 + dim, :].transpose(1, 2)
        zero = torch.zeros_like(mass)
        psi_mom, psi_mass = (node[:, 1 + dim, :], node[:, 2 + dim, :]) if with_psi else (zero,
                                                                                        zero)

        inv_mass = linalg.inv_exact(mass)
        velocity = (mom + mass[..., None] * self.gravity * dt) * inv_mass[..., None]

        node_pos, projections = state.grid_cache[:2]
        gstate = GridState(mass=mass, momentum=mom, velocity=velocity,
                           psi_momentum=psi_mom, psi_mass=psi_mass)
        gstate = dense.grid_update(
            grid, gstate, self.colliders, dt, params.boundary_handling,
            params.simulation_dofs, node_positions=node_pos, projections=projections,
        )
        gstate = self.hooks.post_grid_update(gstate, grid, dt, node_pos)
        velocity = gstate.velocity
        velocity[cfg.max_grid_blocks] = 0.0

        parts = [velocity.transpose(1, 2)]
        if with_psi:
            parts.append((psi_mom * linalg.inv_exact(psi_mass))[:, None, :])
        return torch.cat(parts, dim=1).reshape(cfg.max_grid_blocks + 1, -1).contiguous()

    def _gather_windows(self, state, fields):
        """Node fields -> per-chunk windows [D, nf, 8^d] (the gather; the
        fluid volume pass's mass windows)."""
        return T.windows_from_corners(
            self.grid, self._cfg, self._corners(state), fields, cell_order=self._cell_order(),
        ).contiguous()

    def _min_dtb(self, state):
        """Minimum carried dt bound over occupied slots, on the device."""
        return torch.min(torch.where(self._occupied(state), state.slots[:, self._rows.dtb, :],
                                     float("inf")))

    def _probe(self, state):
        """The substep's one host read: (drift since the last sort, minimum
        carried dt bound over occupied slots). A resort keeps every
        occupied slot's row, so the minimum holds across it."""
        cum, mdt = torch.stack([state.cum_disp, self._min_dtb(state)]).cpu().numpy()
        return np.float32(cum), np.float32(mdt)

    # -- fluid volume pass -------------------------------------------------------

    def _recompute_fluids(self, state):
        """Fluid volume recomputation on slot rows (ref: fluids_volume.rs
        recompute_fluids_volumes): mass-only window images, the merge, the
        window gather, the per-slot grid-mass gather, then F00 = V/V0 on
        active fluid slots and the dt-bound row refreshed, both rows
        written in place (as kernel B writes its slots)."""
        grid, cfg = self.grid, self._cfg
        nchunks = state.structure.num_chunks
        images = K.mass_p2g_fused(grid, cfg, state.slots, state.ints, nchunks)
        node = self._merge_nodes(state, images)
        windows = self._gather_windows(state, node.reshape(node.shape[0], -1))
        new_mass = K.mass_g2p_fused(grid, cfg, state.slots, state.ints, windows,
                                    nchunks)[:, 0, :]
        self._set_fluid_volumes(state, new_mass)
        return state

    def _set_fluid_volumes(self, state, new_mass):
        """F00 = V/V0 on active fluid slots from the grid mass gathered at
        each slot, new_mass [D, C], and the dt-bound row refreshed; both
        rows written in place."""
        grid, r = self.grid, self._rows
        new_density = linalg.div_const(new_mass, grid.cell_width ** grid.dim)
        slots = state.slots
        new_volume = slots[:, r.mass, :] / torch.clamp(new_density, min=1e-20)
        models = self._slot_models(state)
        is_fluid = (models[0] == con.EOS_MONAGHAN_SPH) & self._active(state)
        slots[:, r.defgrad, :] = torch.where(
            is_fluid, new_volume / torch.clamp(slots[:, r.vol0, :], min=1e-30),
            slots[:, r.defgrad, :],
        )
        # The EOS dt bound depends on F00: refresh the carried bound row.
        self._refresh_dtb_rows(state, models)

    def _slot_models(self, state):
        """Per slot [D, C]: the model's constitutive type and its four
        constitutive parameters."""
        (ct,), p = K.model_columns(self._tab_f, self._tab_i, state.ints,
                                   range(K.TAB_C, K.TAB_C + 4))
        return ct, p

    def _refresh_dtb_rows(self, state, models=None):
        """Recompute the dt-bound row in place from the current slot rows
        (ref: timestep_estimator.rs). models: _slot_models(state), if the
        caller has it."""
        r, h, d = self._rows, self.grid.cell_width, self.grid.dim
        slots = state.slots

        def row(k):
            return slots[:, k, :]

        ct, p = self._slot_models(state) if models is None else models
        g = [[row(r.grad + d * i + j) for j in range(d)] for i in range(d)]
        f = [[row(r.defgrad + d * i + j) for j in range(d)] for i in range(d)]
        vel = [row(r.vel + ax) for ax in range(d)]
        con_bound = K.timestep_bound_c(ct, p, row(r.eh), f, row(r.mass), row(r.vol0), vel, h,
                                       self.models.present_c)
        slots[:, r.dtb, :] = K.dt_bound_row(h, vel, g, con_bound, row(r.failed) != 0.0,
                                            self._active(state))

    # -- eigenerosion ----------------------------------------------------------

    def _eigen_candidates(self, structure):
        """Per chunk, the candidate chunk ids of the pooling: every chunk of
        the 3^d neighbouring blocks (own included), up to _eigen_mcb per
        block. Returns ([D, KN] i32, D for none; overflow [] bool, a block
        holds more chunks than the list takes). Port of
        sparkl_tpu/fused/pipeline.py:_eigen_candidates."""
        grid, cfg = self.grid, self._cfg
        dim = grid.dim
        d_, mb = cfg.max_chunks, cfg.max_blocks
        dev = structure.block_keys.device
        bspace = S.block_space_ob2(grid)
        strides = [1] * dim
        for ax in range(dim - 2, -1, -1):
            strides[ax] = strides[ax + 1] * bspace[ax + 1]
        sentinel = int(np.prod(bspace))

        bk = structure.block_keys  # [MB] sorted, sentinel pad
        rem, coords = bk, []
        for ax in range(dim):
            coords.append(rem // strides[ax])
            rem = rem % strides[ax]
        coords = torch.stack(coords, dim=-1)  # [MB, d]
        offs = torch.tensor(np.stack(np.meshgrid(*[[0, 1, 2]] * dim, indexing="ij"), -1)
                            .reshape(-1, dim) - 1, dtype=torch.int32, device=dev)  # {-1,0,1}^d
        nco = coords[:, None, :] + offs[None, :, :]  # [MB, 3^d, d]
        in_space = (torch.all(nco >= 0, dim=-1)
                    & torch.all(nco < torch.tensor(bspace, dtype=torch.int32, device=dev), dim=-1)
                    & (bk < sentinel)[:, None])
        nkeys = (nco * torch.tensor(strides, dtype=torch.int32, device=dev)).sum(-1,
                                                                               dtype=torch.int32)
        nkeys = torch.where(in_space, nkeys, sentinel).reshape(-1)
        found = torch.clamp(torch.searchsorted(bk, nkeys, out_int32=True), 0, mb - 1)
        hit = (bk[found.long()] == nkeys) & (nkeys < sentinel)
        nblk = torch.where(hit, found, mb).reshape(mb, -1).long()  # [MB, 3^d]

        mcb = self._eigen_mcb
        i32 = dict(dtype=torch.int32, device=dev)
        first = torch.cat([structure.block_first_chunk, torch.full((1,), d_, **i32)])[nblk]
        nch = torch.cat([structure.block_num_chunks, torch.zeros((1,), **i32)])[nblk]
        overflow = torch.any(nch > mcb)
        t = torch.arange(mcb, **i32)
        cand_blk = torch.where(t[None, None, :] < nch[:, :, None],
                               first[:, :, None] + t[None, None, :], d_).reshape(mb, -1)
        cand_blk = torch.cat([cand_blk, torch.full((1, cand_blk.shape[1]), d_, **i32)])
        cand = cand_blk[torch.clamp(structure.chunk_block, 0, mb).long()]  # [D, KN]
        return cand.contiguous(), overflow

    def _eigen_rows(self, state):
        """The pooling's inputs: the eigen rows e [D, 8, C] (pos d,
        m·psi_pos, m, eligible) and the eligible mask [D, C] (a crack
        factor, unbroken, not failed, active)."""
        r, dim = self._rows, self.grid.dim
        slots = state.slots
        cpf, phase, mass = slots[:, r.cpf, :], slots[:, r.phase, :], slots[:, r.mass, :]
        eligible = ((cpf != 0.0) & (phase > 0.0) & (slots[:, r.failed, :] == 0.0)
                    & self._active(state))
        e_rows = [slots[:, r.pos + ax, :] for ax in range(dim)]
        e_rows += [mass * slots[:, r.psi_pos, :], mass, eligible.to(torch.float32)]
        e_rows += [torch.zeros_like(mass)] * (K.EIG_ROWS - len(e_rows))
        return torch.stack(e_rows, dim=1), eligible

    def _eigen_update(self, state, pooled, eligible):
        """(par1, trip) from the pooled sums [D, 2, C]: par1 = the slot's own
        m·psi_pos (kernel B's) plus its pool, replaced by the energy
        par1·cpf·h/par2 on crack slots; trip where that energy exceeds the
        crack threshold."""
        r = self._rows
        slots = state.slots
        cpf = slots[:, r.cpf, :]
        par1 = slots[:, r.par1, :] + torch.where(eligible, pooled[:, 0, :], 0.0)
        par2 = slots[:, r.par2, :] + torch.where(eligible, pooled[:, 1, :], 0.0)
        has_crack = cpf != 0.0
        safe2 = torch.where(par2 > 0.0, par2, 1.0)
        energy = par1 * cpf * self.grid.cell_width / safe2
        return torch.where(has_crack, energy, par1), has_crack & (energy > slots[:, r.cthr, :])

    def _evolve_eigenerosion(self, state):
        """Eigenerosion on slot rows by exact pairwise pooling (port of
        sparkl_tpu/fused/pipeline.py:_evolve_eigenerosion; ref:
        eigenerosion.rs:9-58): eligible slots pool the m·psi_pos and m of
        their eligible neighbours within h (the pooling kernel), and a
        crack slot whose energy exceeds its threshold breaks (phase 0).
        The par1 and phase rows are written in place; par2 keeps kernel
        B's value, as in the JAX package."""
        r = self._rows
        e, eligible = self._eigen_rows(state)
        cand, _ = self._eigen_candidates(state.structure)
        pooled = K.eigen_pool_fused(self.grid, self._cfg, e, cand)
        par1, trip = self._eigen_update(state, pooled, eligible)
        state.slots[:, r.par1, :] = par1
        state.slots[:, r.phase, :] = torch.where(trip, 0.0, state.slots[:, r.phase, :])
        return state

    def _structure_flags(self, kmax):
        """Overflow flags of a structure whose densest block holds `kmax`
        chunks (a host int): the merge past MERGE_KMAX, the eigenerosion
        candidate list past _eigen_mcb."""
        flags = 0
        if not self._merge_force_scatter and kmax > T.MERGE_KMAX:
            flags |= OVERFLOW_MERGE
        if self._eigen and kmax > self._eigen_mcb:
            flags |= OVERFLOW_EIGEN
        return flags

    def _resort(self, state):
        """Lazy resort; returns (state, overflow flags) with the flags read
        on the host (an overflowed structure must not reach the kernels)."""
        state, ov, branch = L.resort(self.grid, self._cfg, state, self.grid.dim,
                                     cache_fn=self._grid_cache)
        self.resort_branches[branch] += 1
        st = state.structure
        ov, nc, kmax = torch.stack(
            [ov.to(torch.int32), st.num_chunks, torch.max(st.block_num_chunks)]
        ).tolist()
        self._span_peak = max(self._span_peak, nc)
        return state, (OVERFLOW_TABLES if ov else 0) | self._structure_flags(kmax)

    def _step_body(self, state, remaining):
        """One substep including the lazy resort, for fluids the volume
        pass, and for eigenerosion the pooling after dt is taken (the JAX
        package's order). Returns (state, remaining, resorted, flags);
        nonzero flags abort the span before any kernel sees the overflowed
        structure."""
        grid, params = self.grid, self.params
        f32 = np.float32
        min_dt = f32(params.dt / params.max_num_substeps)
        fluids = params.force_fluids_volume_recomputation
        if fluids:
            # The volume pass runs ahead of the read, on the structure in
            # place, so that the read carries the bound it refreshed.
            state = self._recompute_fluids(state)
        cum_disp, min_dtb = self._probe(state)
        resorted = bool(cum_disp >= f32(DRIFT_FRACTION * grid.cell_width))
        if resorted:
            state, flags = self._resort(state)
            if flags:
                return state, remaining, resorted, flags
            if fluids:
                # The reference order is resort, then volume pass: redo it
                # on the new structure (it overwrites every row the first
                # pass wrote) and read the bound again.
                state = self._recompute_fluids(state)
                min_dtb = f32(self._min_dtb(state).item())
        max_dt = min(remaining, f32(params.max_substep_dt))
        dt = min(min_dtb, max_dt)
        if dt < min_dt and remaining > min_dt:
            dt = min_dt
        if self._eigen:
            state = self._evolve_eigenerosion(state)
        state = self._substep(state, float(dt))
        remaining = f32(0.0) if params.stop_after_one_substep else f32(remaining - dt)
        return state, remaining, resorted, 0

    def _step_impl(self, state):
        """One frame: substeps until params.dt is consumed. Returns (state,
        substeps, resorts, flags)."""
        remaining = np.float32(self.params.dt)
        niter = nres = 0
        while remaining > 0.0 and niter < self.params.max_num_substeps:
            state, remaining, resorted, flags = self._step_body(state, remaining)
            if flags:
                return state, niter, nres, flags
            niter += 1
            nres += int(resorted)
        return state, niter, nres, 0

    def _frames_impl(self, state, num_frames):
        total = nres = 0
        for _ in range(num_frames):
            state, n, r, flags = self._step_impl(state)
            total += n
            nres += r
            if flags:
                return state, total, nres, flags
        return state, total, nres, 0

    # -- packing ------------------------------------------------------------------

    def _grid_cache(self, structure):
        """Node positions + per-collider node projections of the block node
        table (the reference's projection cache, reset_grid.rs:29-63) + the
        scatter merge's index plan + each chunk's corner blocks' rows [D,
        2^d] i32 (kernel B's and the volume pass's window reads), computed
        once per resort. The trash row sits far outside the domain."""
        cpb = B.cells_per_block(self.grid.dim)
        node_pos = S.block_node_positions_ob2(self.grid, structure.grid_keys)
        pad = torch.full((1, cpb, self.grid.dim), 1.0e10, dtype=torch.float32,
                         device=node_pos.device)
        node_pos = torch.cat([node_pos, pad], dim=0)
        return (node_pos, dense.grid_node_projections(self.colliders, node_pos),
                T.scatter_plan(self._cfg, structure), T._chunk_corners(structure).contiguous())

    def _pack(self, particles):
        particles = dense.mark_out_of_grid_failed(self.grid, particles)
        dtb = dense.particle_dt_bounds(self.grid, particles, self.models)
        stress = None
        if self._meta["stress_cache"]:
            # Seed the stress-cache rows so the first kernel A reads valid stress.
            stress = registry.kirchhoff_stress(
                self.models, particles.model_id, particles.phase,
                particles.elastic_hardening, particles.deformation_gradient,
                particles.velocity_gradient, particles.mass, particles.volume0,
            )
        return L.pack(self.grid, self._cfg, particles, dtb,
                      cache_fn=self._grid_cache, stress=stress)

    def pack_state(self, particles):
        """Particles -> resident SlotState (capacity-checked, regrown to
        fit)."""
        if particles.device != self.device:
            raise ValueError(f"particles on {particles.device}, pipeline on {self.device}")
        self._ensure_cfg(particles)
        self._state_capacity = particles.capacity
        for _attempt in range(6):
            state = self._pack(particles)
            s = state.structure
            nb, ngb, nc, kmax = torch.stack(
                [s.num_blocks, s.num_grid_blocks, s.num_chunks,
                 torch.max(s.block_num_chunks)]
            ).tolist()
            if nb > self._cfg.max_blocks or ngb > self._cfg.max_grid_blocks or (
                nc > self._cfg.max_chunks
            ):
                self._grow()
                continue
            if kmax > T.MERGE_KMAX:
                self._merge_force_scatter = True
            return state
        raise RuntimeError("block table capacity still overflowing after regrows")

    def unpack_state(self, state, capacity: Optional[int] = None):
        """Resident SlotState -> Particles (original-order rows)."""
        if capacity is None:
            capacity = self._state_capacity
        return L.unpack(self.grid, self._cfg, state, capacity, self.grid.dim)

    def _repack_state(self, state):
        particles = self.unpack_state(state)
        self._grow()
        return self._pack(particles)

    def run_frames_state(self, state, num_frames: int):
        """Advance a resident SlotState by `num_frames` frames; returns
        (state, total_substeps). An overflow restores the pre-span copy,
        regrows the tables, pins the scatter merge or doubles the
        eigenerosion candidate list, and retries. The span's starting
        structure is checked first (one host read), as each resort's is."""
        for _attempt in range(6):
            # Kernel B and the pooling update slots in place: keep a copy
            # to retry from.
            backup = state.replace(slots=state.slots.clone())
            st = state.structure
            self._span_peak, kmax = torch.stack(
                [st.num_chunks, torch.max(st.block_num_chunks)]).tolist()
            flags = self._structure_flags(kmax)
            if not flags:
                state, total, nres, flags = self._frames_impl(state, num_frames)
            if flags == 0:
                self.last_resorts = nres
                if self._span_peak > 0.85 * self._cfg.max_chunks:
                    state = self._repack_state(state)
                return state, total
            state = backup
            if flags & OVERFLOW_EIGEN:
                self._eigen_mcb *= 2
                self.eigen_regrows += 1
            if flags & OVERFLOW_MERGE:
                self._merge_force_scatter = True
            if flags & OVERFLOW_TABLES:
                state = self._repack_state(state)
        raise RuntimeError("block table capacity still overflowing after regrows")

    def run_frames(self, particles, num_frames: int):
        """Pack, advance `num_frames` frames, unpack."""
        capacity = particles.capacity
        state = self.pack_state(particles)
        state, total = self.run_frames_state(state, num_frames)
        return self.unpack_state(state, capacity), total

    def step_with_stats(self, particles):
        return self.run_frames(particles, 1)

    def step(self, particles):
        p, _ = self.step_with_stats(particles)
        return p
