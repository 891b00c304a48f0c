"""Persistent chunk-slot particle layout (port of sparkl_tpu/fused/layout.py).

Between substeps particle state lives in an f-major slot tensor
[MAX_CHUNKS, NF, C] (one row per scalar field, chunks grouped by grid
block) plus an int tensor [MAX_CHUNKS, NI, C] for ids, flags and window
origins: the layout the fused kernels consume directly. Row offsets, the
flag bits and the inf-free row contract (BIGF) are the JAX package's, so
slot tensors compare bit for bit.
"""

from dataclasses import dataclass, replace

import numpy as np
import torch

from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.core.particles import Particles
from sparkl_tpu_torch.sparse.blocks import BlockConfig
from sparkl_tpu_torch.fused import structure as S

# Flag bits (int row FLAGS).
ACTIVE = 1
STATIC = 2
KINEMATIC = 4
OCCUPIED = 8

# Slot rows never hold inf: infinite values (crack_threshold, dt bounds) are
# stored as the largest finite f32 and restored on unpack. The JAX package
# needs this for its selection-matmul permutes; the port keeps it so that
# slot tensors stay bit-comparable.
BIGF = float(np.finfo(np.float32).max)

# Int row indices.
I_MODEL = 0
I_FLAGS = 1
I_ORIG = 2
I_USER = 3
I_ORIGIN = 4  # .. I_ORIGIN + d
NI = 8


def _round8(x):
    return -(-x // 8) * 8


@dataclass(frozen=True)
class Rows:
    """Row offsets of every scalar field in the f32 slot tensor."""

    dim: int

    @property
    def pos(self):
        return 0

    @property
    def vel(self):
        return self.dim

    @property
    def grad(self):
        return 2 * self.dim

    @property
    def defgrad(self):
        return 2 * self.dim + self.dim * self.dim

    @property
    def _scalars(self):
        return 2 * self.dim + 2 * self.dim * self.dim

    @property
    def mass(self):
        return self._scalars

    @property
    def vol0(self):
        return self._scalars + 1

    @property
    def phase(self):
        return self._scalars + 2

    @property
    def psi_pos(self):
        return self._scalars + 3

    @property
    def pdd(self):
        return self._scalars + 4

    @property
    def ph(self):
        return self._scalars + 5

    @property
    def eh(self):
        return self._scalars + 6

    @property
    def lvg(self):
        return self._scalars + 7

    @property
    def nacc(self):
        return self._scalars + 8

    @property
    def kinvel(self):
        return self._scalars + 9

    @property
    def cpf(self):
        return self._scalars + 9 + self.dim

    @property
    def cthr(self):
        return self._scalars + 10 + self.dim

    @property
    def dtb(self):
        return self._scalars + 11 + self.dim

    @property
    def failed(self):
        return self._scalars + 12 + self.dim

    @property
    def radius0(self):
        return self._scalars + 13 + self.dim

    @property
    def par1(self):
        return self._scalars + 14 + self.dim

    @property
    def par2(self):
        return self._scalars + 15 + self.dim

    @property
    def m_c(self):
        return self._scalars + 16 + self.dim

    @property
    def g(self):
        return self._scalars + 17 + self.dim

    @property
    def debug(self):
        return self._scalars + 18 + self.dim

    @property
    def cumd(self):
        # Per-slot drift accumulated since the last sort; the lazy-resort
        # trigger is its maximum over slots.
        return self._scalars + 19 + self.dim

    @property
    def stress(self):
        # Cached Kirchhoff stress of the current F (symmetric upper
        # triangle, row-major), written by kernel B and read by kernel A.
        return self._scalars + 20 + self.dim

    @property
    def nstress(self):
        return self.dim * (self.dim + 1) // 2

    @property
    def nf(self):
        return _round8(self._scalars + 20 + self.dim + self.nstress)


@dataclass(frozen=True)
class SlotState:
    """Slot-resident particle population + its sparse structure.
    `grid_cache` holds structure-derived grid data (node positions and the
    per-collider node projections) computed once per resort."""

    slots: torch.Tensor  # [D, NF, C] f32
    ints: torch.Tensor  # [D, NI, C] i32
    structure: S.SlotStructure
    cum_disp: torch.Tensor  # [] f32 max drift accumulated since the sort
    grid_cache: tuple

    def replace(self, **kw):
        return replace(self, **kw)


def _field_columns(r: Rows, p: Particles, dtb, stress=None):
    """Particles -> list of NF [N] f32 columns in Rows order."""
    d = p.dim
    cols = [p.position[:, ax] for ax in range(d)]
    cols += [p.velocity[:, ax] for ax in range(d)]
    cols += [p.velocity_gradient[:, i, j] for i in range(d) for j in range(d)]
    cols += [p.deformation_gradient[:, i, j] for i in range(d) for j in range(d)]
    cols += [p.mass, p.volume0, p.phase, p.psi_pos, p.plastic_def_det,
             p.plastic_hardening, p.elastic_hardening, p.log_vol_gain,
             p.nacc_alpha]
    cols += [p.kinematic_vel[:, ax] for ax in range(d)]
    cols += [p.crack_propagation_factor, p.crack_threshold, dtb,
             p.failed.to(torch.float32), p.radius0, p.parameter1,
             p.parameter2, p.m_c, p.g, p.debug_val]
    cols.append(torch.zeros_like(p.mass))  # cumd starts at zero
    if stress is not None:
        cols += [stress[:, i, j] for i in range(d) for j in range(i, d)]
    while len(cols) < r.nf:
        cols.append(torch.zeros_like(p.mass))
    return cols


def _write_origin_rows(ints, structure, d):
    """Return `ints` with the window-origin rows set from the structure."""
    ints = ints.clone()
    ints[:, I_ORIGIN : I_ORIGIN + d, :] = structure.chunk_origin[:, :, None]
    return ints


def pack(grid: GridParams, cfg: BlockConfig, p: Particles, dtb,
         cache_fn=None, stress=None) -> SlotState:
    """Particles (original order) -> slot state. `dtb` = per-particle dt
    bounds [N], carried as a row; `cache_fn` (structure -> grid_cache)
    builds the carried grid-side cache; `stress` [N, d, d] seeds the
    stress-cache rows."""
    r = Rows(p.dim)
    d = p.dim
    structure, sort_order, chunk_start = S.build_slot_structure(
        grid, cfg, p.position, p.active, p.active
    )
    src, slot_valid = S.slot_source_index(
        cfg, sort_order, chunk_start, structure.chunk_count
    )
    src = src.long()

    packed = torch.stack(_field_columns(r, p, dtb, stress=stress), dim=1)  # [N, NF]
    packed = torch.clamp(packed, -BIGF, BIGF)
    flat = torch.where(slot_valid[:, None], packed[src], 0.0)
    slots = flat.reshape(cfg.max_chunks, cfg.chunk_size, r.nf).transpose(1, 2).contiguous()

    act = p.active.to(torch.int32)
    flags = (
        act * ACTIVE
        + p.is_static.to(torch.int32) * STATIC
        + p.kinematic_enabled.to(torch.int32) * KINEMATIC
        + act * OCCUPIED
    )
    icols = [p.model_id, flags,
             torch.arange(p.capacity, dtype=torch.int32, device=p.device),
             p.user_data]
    while len(icols) < NI:
        icols.append(torch.zeros_like(p.model_id))
    ipacked = torch.stack(icols, dim=1)  # [N, NI]
    iflat = torch.where(slot_valid[:, None], ipacked[src], 0)
    ints = iflat.reshape(cfg.max_chunks, cfg.chunk_size, NI).transpose(1, 2).contiguous()
    ints = _write_origin_rows(ints, structure, d)

    return SlotState(
        slots=slots,
        ints=ints,
        structure=structure,
        cum_disp=torch.zeros((), dtype=torch.float32, device=p.device),
        grid_cache=cache_fn(structure) if cache_fn else (),
    )


def unpack(grid: GridParams, cfg: BlockConfig, state: SlotState, capacity: int,
           dim: int) -> Particles:
    """Slot state -> Particles in original order. Rows that hold no
    particle are left at Particles.empty defaults."""
    r = Rows(dim)
    dev = state.slots.device
    flat = state.slots.transpose(1, 2).reshape(-1, r.nf)  # [S, NF]
    iflat = state.ints.transpose(1, 2).reshape(-1, NI)
    occupied = (iflat[:, I_FLAGS] & OCCUPIED) != 0
    ids = iflat[occupied, I_ORIG].long()

    empty = Particles.empty(capacity, dim, dev)
    mat = torch.stack(
        _field_columns(r, empty, torch.zeros((capacity,), dtype=torch.float32, device=dev)),
        dim=1,
    )
    mat[ids] = flat[occupied]
    z = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    imat = torch.stack(
        [empty.model_id, z, torch.arange(capacity, dtype=torch.int32, device=dev),
         empty.user_data] + [z] * (NI - 4),
        dim=1,
    )
    imat[ids] = iflat[occupied]

    d = dim

    def vec(row):
        return mat[:, row : row + d]

    def matx(row):
        return mat[:, row : row + d * d].reshape(-1, d, d)

    flags = imat[:, I_FLAGS]
    occ = (flags & OCCUPIED) != 0
    cthr = mat[:, r.cthr]
    return Particles(
        position=vec(r.pos),
        velocity=vec(r.vel),
        velocity_gradient=matx(r.grad),
        deformation_gradient=torch.where(
            occ[:, None, None], matx(r.defgrad), empty.deformation_gradient
        ),
        plastic_def_det=torch.where(occ, mat[:, r.pdd], empty.plastic_def_det),
        mass=mat[:, r.mass],
        volume0=torch.where(occ, mat[:, r.vol0], empty.volume0),
        radius0=mat[:, r.radius0],
        model_id=imat[:, I_MODEL],
        active=(flags & ACTIVE) != 0,
        failed=mat[:, r.failed] != 0.0,
        is_static=(flags & STATIC) != 0,
        kinematic_enabled=(flags & KINEMATIC) != 0,
        kinematic_vel=vec(r.kinvel),
        phase=torch.where(occ, mat[:, r.phase], empty.phase),
        psi_pos=mat[:, r.psi_pos],
        parameter1=mat[:, r.par1],
        parameter2=mat[:, r.par2],
        crack_propagation_factor=mat[:, r.cpf],
        crack_threshold=torch.where(
            occ, torch.where(cthr >= BIGF, float("inf"), cthr), empty.crack_threshold
        ),
        m_c=torch.where(occ, mat[:, r.m_c], empty.m_c),
        g=mat[:, r.g],
        nacc_alpha=torch.where(occ, mat[:, r.nacc], empty.nacc_alpha),
        plastic_hardening=torch.where(occ, mat[:, r.ph], empty.plastic_hardening),
        elastic_hardening=torch.where(occ, mat[:, r.eh], empty.elastic_hardening),
        log_vol_gain=mat[:, r.lvg],
        user_data=imat[:, I_USER],
        debug_val=mat[:, r.debug],
    )


def _gather_chunks(state, first_chunk, valid):
    """Pure chunk reorder: destination chunk j is an in-order copy of
    source chunk first_chunk[j] (lanes past its count zeroed)."""
    ids0 = torch.clamp(first_chunk, 0, state.slots.shape[0] - 1).long()
    vm = valid[:, None, :]
    return (torch.where(vm, state.slots[ids0], 0.0),
            torch.where(vm, state.ints[ids0], 0))


def slot_positions(state, dim):
    """Per slot [D·C]: position [D·C, dim], active, occupied."""
    r = Rows(dim)
    pos = torch.stack([state.slots[:, r.pos + ax, :].reshape(-1) for ax in range(dim)], dim=-1)
    flags = state.ints[:, I_FLAGS, :].reshape(-1)
    occupied = (flags & OCCUPIED) != 0
    return pos, occupied & ((flags & ACTIVE) != 0), occupied


def source_order_rows(cfg, sort_order, chunk_start):
    """The source-row kernel's operands. Destination chunk j's source
    slots, sort_order[start_j : start_j + C], span two rows of the
    [D, C]-shaped order: returns those rows [D, 2, C] and the shift of the
    slice in the first, [D]. (The JAX kernel routes them in f32, so its
    package cuts the slice elementwise past 2^24 slots; the CUDA kernel
    copies int32 and needs no such limit.)"""
    c, d_ = cfg.chunk_size, cfg.max_chunks
    start = torch.clamp(chunk_start, max=d_ * c - c)
    r0 = start // c
    rows2 = torch.stack([r0, torch.clamp(r0 + 1, max=d_ - 1)], dim=1).reshape(-1)
    return (sort_order.reshape(d_, c)[rows2.long()].reshape(d_, 2, c),
            (start % c).to(torch.int32))


def _finalize(slots, ints, structure, r, dim):
    """A sort resets the drift row and takes the new window origins."""
    slots[:, r.cumd, :] = 0.0
    return slots, _write_origin_rows(ints, structure, dim)


def resort(grid: GridParams, cfg: BlockConfig, state: SlotState, dim: int,
           cache_fn=None):
    """Rebuild the block structure from current slot positions and permute
    the slot state into the new order. Returns (state, overflow [] bool,
    branch): branch is "relabel", "pure" or "mixed".

    Three branches, as in the JAX package: the chunk-relabel fast path
    (no particle moves), a pure chunk reorder (one chunk-row gather), and
    the mixed case. Outside the relabel path, the source-row kernel cuts
    each destination chunk's source slots from the sort order; the mixed
    case moves every slot with the permute kernel, which needs no
    per-destination routing and so no fallback (the JAX package routes at
    most 8 source chunks per destination and takes a per-slot gather
    past that). Branches are chosen on the host, which costs one read per
    branch point on resort substeps only."""
    from sparkl_tpu_torch.fused import kernels as K

    r = Rows(dim)
    c = cfg.chunk_size
    d_ = cfg.max_chunks
    dev = state.slots.device

    pos, active, occupied = slot_positions(state, dim)
    key_eff = S.slot_key_rows(grid, cfg, pos, active, occupied)
    occ2 = occupied.reshape(d_, c)
    relabel_ok, ckey, occ_count = S.detect_chunk_relabel(grid, cfg, key_eff, occ2)

    if bool(relabel_ok):
        branch = "relabel"
        structure = S.structure_from_chunk_keys(grid, cfg, ckey, occ_count)
        # Zero pad lanes so every branch leaves "pads are zero" bit-exactly.
        om = occ2[:, None, :]
        slots, ints = _finalize(torch.where(om, state.slots, 0.0),
                                torch.where(om, state.ints, 0), structure, r, dim)
    else:
        structure, sort_order, chunk_start = S.build_slot_structure(
            grid, cfg, pos, active, occupied
        )
        src = K.src_rows_from_order(*source_order_rows(cfg, sort_order, chunk_start))
        lanes = torch.arange(c, dtype=torch.int32, device=dev)[None, :]
        valid = lanes < structure.chunk_count[:, None]
        first_chunk = src[:, 0] // c
        pure_relabel = torch.all(
            torch.where(valid, (src % c == lanes) & (src // c == first_chunk[:, None]), True)
        )
        if bool(pure_relabel):
            branch = "pure"
            slots, ints = _finalize(*_gather_chunks(state, first_chunk, valid),
                                    structure, r, dim)
        else:
            branch = "mixed"
            slots, ints = K.permute_slots(state.slots, state.ints, torch.where(valid, src, -1),
                                          structure.chunk_origin, r.cumd)

    overflow = (
        (structure.num_blocks > cfg.max_blocks)
        | (structure.num_grid_blocks > cfg.max_grid_blocks)
        | (structure.num_chunks > cfg.max_chunks)
    )
    new_state = SlotState(
        slots=slots,
        ints=ints,
        structure=structure,
        cum_disp=torch.zeros((), dtype=torch.float32, device=dev),
        grid_cache=cache_fn(structure) if cache_fn else (),
    )
    return new_state, overflow, branch
