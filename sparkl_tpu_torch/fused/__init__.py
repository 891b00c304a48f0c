"""Fused substep path: persistent chunk-slot state + the fused kernels."""
