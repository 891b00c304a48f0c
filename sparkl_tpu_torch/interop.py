"""Carry the JAX package's objects across to the port and back, as numpy
arrays (the port's "weights carried across").

Callers convert sparkl_tpu objects to numpy themselves (np.asarray on each
field); this module never imports jax. Field names and dtypes are the JAX
package's: float32 floats, int32 ids, bool masks. Like every entry point of
the port, each function puts its tensors on the card unless given
device="cpu".
"""

from dataclasses import fields

import numpy as np
import torch

from sparkl_tpu_torch import device as _device
from sparkl_tpu_torch.core.particles import Particles
from sparkl_tpu_torch.models.registry import ModelSet
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
