"""sparkl_tpu_torch: the PyTorch / CUDA port of sparkl_tpu for NVIDIA Hopper.

The package mirrors sparkl_tpu's module tree and names (each module here has
its counterpart at the same path under sparkl_tpu/), imports torch and numpy
and never jax or sparkl_tpu. Plain tensor code is PyTorch; the substep's hot
kernels are hand-written CUDA C++ for sm_90a under csrc/, bound with ctypes
(fused/kernels.py). A kernel wrapper runs its plain PyTorch version only for
tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises.

This first slice carries sand3's main path: 3D, corotated elasticity with
optional Drucker-Prager plasticity, one heightfield collider, no damage, the
stress cache on, driven by fused.pipeline.FusedMpmPipeline.
"""

from sparkl_tpu_torch.core.params import (
    BoundaryHandling,
    DamageModel,
    SimulationDofs,
    SolverParameters,
)
from sparkl_tpu_torch.core.grid import GridParams, GridState
from sparkl_tpu_torch.core.particles import Particles, cube_particles
from sparkl_tpu_torch.models.registry import ModelSet, ParticleModel
from sparkl_tpu_torch.geometry.colliders import Collider, heightfield
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline

__all__ = [
    "BoundaryHandling",
    "Collider",
    "DamageModel",
    "FusedMpmPipeline",
    "GridParams",
    "GridState",
    "ModelSet",
    "ParticleModel",
    "Particles",
    "SimulationDofs",
    "SolverParameters",
    "cube_particles",
    "heightfield",
]
