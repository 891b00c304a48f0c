"""Example scenes (port of sparkl_tpu/scenes/__init__.py).

Each builder returns a SceneBundle; `build(name, device=...)` is the scene
registry. Scenes are built on the card unless device="cpu" is given. The
port carries the 3D sand scene and the 3D fluid blob.
"""

from dataclasses import dataclass
from typing import Callable, Dict

from sparkl_tpu_torch import device as _device
from sparkl_tpu_torch.core.grid import GridParams
from sparkl_tpu_torch.core.params import SolverParameters
from sparkl_tpu_torch.core.particles import Particles
from sparkl_tpu_torch.models.registry import ModelSet


@dataclass
class SceneBundle:
    name: str
    grid: GridParams
    models: ModelSet
    colliders: tuple
    particles: Particles
    params: SolverParameters
    gravity: tuple


_REGISTRY: Dict[str, Callable[..., SceneBundle]] = {}


def register_scene(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def build(name, device="cuda", **kw) -> SceneBundle:
    return _REGISTRY[name](device=_device.resolve(device), **kw)


from sparkl_tpu_torch.scenes import scenes3d  # noqa: E402,F401  (registration)
