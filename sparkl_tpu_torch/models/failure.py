"""Failure models (port of sparkl_tpu/models/failure.py).

Ref: sparkl `src_core/dynamics/models/failure_maximum_stress.rs`.
"""

import torch

from sparkl_tpu_torch.math import cmat
from sparkl_tpu_torch.math.svd import sym_eigvals2x2_c, sym_eigvals3x3_c

FAILURE_NONE = 0
MAXIMUM_STRESS = 1
FAILURE_CUSTOM_BASE = 16


def maximum_stress_failed(params, stress):
    """True where the stress leaves the failure envelope: params [..., 2] =
    [max principal stress, max shear stress], stress [..., d, d]."""
    return maximum_stress_failed_c(params[..., 0], params[..., 1], cmat.unpack(stress))


def maximum_stress_failed_c(max_principal, max_shear, stress):
    """Component-wise core: the eigenvalues of sym(stress) (closed form in
    2D, the cardano values in 3D); failed where the largest exceeds
    max_principal or half their spread exceeds max_shear."""
    sym = cmat.strain_rate_c(stress)  # 0.5 (S + S^T)
    eig = sym_eigvals2x2_c(sym) if len(stress) == 2 else sym_eigvals3x3_c(sym)
    emin = emax = eig[0]
    for e in eig[1:]:
        emin = torch.minimum(emin, e)
        emax = torch.maximum(emax, e)
    return (emax > max_principal) | ((emax - emin) / 2.0 > max_shear)
