"""Example scenes (port of sparkl_tpu/scenes/__init__.py).

Each builder returns a SceneBundle; `build(name, device=...)` is the scene
registry. Scenes are built on the card unless device="cpu" is given. The
port carries the 3D sand scene, the 3D fluid blob, the 2D baseline scene
(elasticity2), snow, sand and a breakable star on a 2D heightfield
(basic2), the 2D dam break (fluids2) and the 2D L-panel fracture scene.
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
    hooks: object = None  # MpmHooks run after each grid update, or None


_REGISTRY: Dict[str, Callable[..., SceneBundle]] = {}


def register_scene(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def build(name, device="cuda", **kw) -> SceneBundle:
    return _REGISTRY[name](device=_device.resolve(device), **kw)


from sparkl_tpu_torch.scenes import scenes2d, scenes3d  # noqa: E402,F401  (registration)
