"""Grid containers (port of sparkl_tpu/core/grid.py).

`GridParams` is static scene geometry (origin / cell width / resolution);
`GridState` holds the per-substep node fields of whatever node table a
pipeline uses (here the fused pipeline's block node table).
"""

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class GridParams:
    """Static grid geometry. Node i sits at origin + i * cell_width."""

    origin: Tuple[float, ...]
    cell_width: float
    res: Tuple[int, ...]  # number of nodes per axis

    @property
    def dim(self) -> int:
        return len(self.res)

    @staticmethod
    def for_domain(lo, hi, cell_width, pad=4):
        """Grid covering [lo, hi] with `pad` extra cells on each side."""
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        origin = np.floor(lo / cell_width).astype(np.int64) - pad
        top = np.ceil(hi / cell_width).astype(np.int64) + pad
        res = tuple(int(t - o + 1) for o, t in zip(origin, top))
        return GridParams(
            origin=tuple(float(o * cell_width) for o in origin),
            cell_width=float(cell_width),
            res=res,
        )


@dataclass(frozen=True)
class GridState:
    mass: torch.Tensor  # [...]
    momentum: torch.Tensor  # [..., d]
    velocity: torch.Tensor  # [..., d]
    psi_momentum: torch.Tensor  # [...]
    psi_mass: torch.Tensor  # [...]

    def replace(self, **kw):
        return replace(self, **kw)
