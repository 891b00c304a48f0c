"""sparkl_tpu_torch: the PyTorch / CUDA port of sparkl_tpu for NVIDIA Hopper.

The package mirrors sparkl_tpu's module tree and names (each module here has
its counterpart at the same path under sparkl_tpu/), imports torch and numpy
and never jax or sparkl_tpu. Plain tensor code is PyTorch; the substep's hot
kernels are hand-written CUDA C++ for sm_90a under csrc/, bound with ctypes
(fused/kernels.py). A kernel wrapper runs its plain PyTorch version only for
tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises.

The port carries sand3's configuration: 3D, corotated elasticity with
optional Drucker-Prager plasticity, heightfield colliders and no damage, on
two pipelines: fused.pipeline.FusedMpmPipeline (persistent slots, the stress
cache on) and sparse.pipeline.SparseMpmPipeline (the block-sparse window
transfers); fluids3's, the Monaghan EOS fluid with fluid volume
recomputation (alone or mixed with those solids), on the fused pipeline;
l_panel2's, 2D corotated fracture with eigenerosion and maximum-stress
failure, a cuboid ground, STICK handling and a Dirichlet velocity hook;
elasticity2's and basic2's, 2D Rankine, Snow and Drucker-Prager plasticity
on cuboids and a 2D heightfield; fluids2's, the 2D Monaghan EOS fluid
with its volume pass between cuboid walls; and fracture in 3D (l_panel2's
two mechanisms in a slab), with eigenerosion or modified eigenerosion and
maximum-stress failure; all on the fused pipeline.
Every entry point that takes a device defaults to
"cuda" and raises without one; pass device="cpu" for the plain PyTorch
versions.
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
from sparkl_tpu_torch.geometry.colliders import Collider, cuboid, heightfield
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
from sparkl_tpu_torch.sparse.pipeline import SparseMpmPipeline


def auto_pipeline(bundle, prefer="auto", device="cuda", **kw):
    """Build a pipeline for a scene bundle, with its hooks. "auto" and
    "fused" build the fused persistent-slot pipeline (the JAX package's
    "auto" takes it for every configuration it supports, and the port's
    sparse pipeline carries no configuration it does not); "sparse" builds
    the block-sparse one; the dense pipeline is not ported."""
    args = (bundle.grid, bundle.models, bundle.colliders, bundle.params, bundle.gravity,
            bundle.hooks)
    if prefer == "dense":
        raise NotImplementedError("auto_pipeline: the dense MpmPipeline is not ported")
    if prefer == "sparse":
        return SparseMpmPipeline(*args, device=device, **kw)
    if prefer in ("auto", "fused"):
        return FusedMpmPipeline(*args, device=device, **kw)
    raise ValueError(f"auto_pipeline: prefer must be auto, fused, sparse or dense, not {prefer!r}")


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
    "SparseMpmPipeline",
    "auto_pipeline",
    "cube_particles",
    "cuboid",
    "heightfield",
]
