"""Carry the JAX package's objects across to the port and back, as numpy
arrays (the port's "weights carried across").

Callers convert sparkl_tpu objects to numpy themselves (np.asarray on each
field); this module never imports jax. Field names and dtypes are the JAX
package's: float32 floats, int32 ids, bool masks. Like every entry point of
the port, each function that makes tensors puts them on the card unless
given device="cpu"; colliders and hooks keep their geometry in numpy, as in
both packages.
"""

from dataclasses import fields

import numpy as np
import torch

from sparkl_tpu_torch import device as _device
from sparkl_tpu_torch.core.particles import Particles
from sparkl_tpu_torch.geometry.colliders import Collider
from sparkl_tpu_torch.models.registry import ModelSet
from sparkl_tpu_torch.solver.pipeline import DirichletVelocityHook
from sparkl_tpu_torch.fused.layout import SlotState
from sparkl_tpu_torch.fused.structure import SlotStructure


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.float64:
        raise TypeError("float64 array: the port keeps float32 state")
    if a.dtype == np.int64:
        raise TypeError("int64 array: the port keeps int32 ids")
    return torch.tensor(a, device=device)  # a copy: the source may be read-only


def particles_from_numpy(arrays, device="cuda") -> Particles:
    """{field name: array} (every Particles field) -> Particles."""
    device = _device.resolve(device)
    missing = {f.name for f in fields(Particles)} - set(arrays)
    if missing:
        raise KeyError(f"missing particle fields: {sorted(missing)}")
    return Particles(**{f.name: _tensor(arrays[f.name], device) for f in fields(Particles)})


def particles_to_numpy(p: Particles):
    return {f.name: getattr(p, f.name).detach().cpu().numpy() for f in fields(Particles)}


def modelset_from_numpy(ctype, cparams, ptype, pparams, ftype, fparams,
                        device="cuda") -> ModelSet:
    """The JAX ModelSet's six tables -> ModelSet (present types recomputed
    from the tables, as ModelSet.pack derives them)."""
    device = _device.resolve(device)
    return ModelSet.from_tables(ctype, cparams, ptype, pparams, ftype, fparams, device)


def collider_from_numpy(shape_type, data, translation, rotation, friction=0.0,
                        penalty_stiffness=0.0, boundary_handling=None,
                        flip_interior=False) -> Collider:
    """A JAX Collider's fields (its `data` tuple of arrays, the pose) ->
    Collider; the shape's projection is the port's (cuboid or
    heightfield)."""
    return Collider(
        int(shape_type), tuple(np.asarray(a, np.float32) for a in data),
        np.asarray(translation, np.float32), np.asarray(rotation, np.float32),
        float(friction), float(penalty_stiffness),
        None if boundary_handling is None else int(boundary_handling), bool(flip_interior),
    )


def dirichlet_hook_from_numpy(points, velocities) -> DirichletVelocityHook:
    """A JAX DirichletVelocityHook's points [K, d] and velocities [K, d] ->
    the port's hook."""
    return DirichletVelocityHook(np.asarray(points, np.float32),
                                 np.asarray(velocities, np.float32))


def slot_state_from_numpy(arrays, cache_fn=None, device="cuda") -> SlotState:
    """{"slots", "ints", "cum_disp", and every SlotStructure field} ->
    SlotState. `cache_fn` (structure -> grid_cache, e.g. a pipeline's
    _grid_cache) rebuilds the carried grid cache, which the JAX package
    holds as device arrays of its own collider code."""
    device = _device.resolve(device)
    structure = SlotStructure(
        **{f.name: _tensor(arrays[f.name], device) for f in fields(SlotStructure)}
    )
    return SlotState(
        slots=_tensor(arrays["slots"], device),
        ints=_tensor(arrays["ints"], device),
        structure=structure,
        cum_disp=_tensor(np.asarray(arrays["cum_disp"], np.float32), device),
        grid_cache=cache_fn(structure) if cache_fn else (),
    )


def slot_state_to_numpy(state: SlotState):
    """SlotState -> {"slots", "ints", "cum_disp", SlotStructure fields}."""
    out = {k: v.detach().cpu().numpy() for k, v in state.structure.tensors().items()}
    out["slots"] = state.slots.detach().cpu().numpy()
    out["ints"] = state.ints.detach().cpu().numpy()
    out["cum_disp"] = state.cum_disp.detach().cpu().numpy()
    return out
