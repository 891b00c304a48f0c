"""The port's damage models beside 3D fracture, on the CPU against the JAX
package: the kernels' meta carrying 3D eigenerosion and modified
eigenerosion, the 3x3 symmetric eigenvalues and the maximum-stress failure
they feed, and modified eigenerosion's 2D crack-energy trip through both
fused pipelines. (test_torch_fracture3d.py holds l_panel3's build, pack,
hook, kernels, pooling and substeps.)

Inputs come from numpy seeds; the JAX kernels run in interpret mode, the
port's kernels through their plain versions. Each comparison states its
tolerance.
"""


import importlib

import numpy as np
import torch

import jax
import jax.numpy as jnp

import sparkl_tpu as jsk
from sparkl_tpu.core.grid import GridParams as JGridParams
from sparkl_tpu.core.params import DamageModel as JDM
from sparkl_tpu.core.params import SolverParameters as JParams
from sparkl_tpu.fused.pipeline import FusedMpmPipeline as JPipeline
from sparkl_tpu.geometry import colliders as jcol
from sparkl_tpu.models import registry as jreg

from sparkl_tpu_torch.core.params import DamageModel
from sparkl_tpu_torch.fused import kernels as TK
from sparkl_tpu_torch.math import svd as tsvd
from sparkl_tpu_torch.models import constitutive as tcon
from sparkl_tpu_torch.models import failure as tfail

from test_torch_fracture3d import TIE, _compare, _np, _port_particles, _port_pipeline

torch.set_num_threads(1)

jsvd = importlib.import_module("sparkl_tpu.math.svd")  # the package re-exports a function `svd`


def test_meta_carries_3d_damage_and_modified():
    """meta_unsupported takes 3D eigenerosion, 3D maximum-stress failure
    and modified eigenerosion in 2D and 3D (and, since the material slice,
    NACC, neo-Hookean and 3D Rankine and Snow: tests/test_torch_materials.py);
    CD-MPM and another failure type stay refused."""
    base = dict(with_psi=False, m_count=1, present_c=(tcon.COROTATED,), present_p=(),
                present_f=(), damage_model=int(DamageModel.NONE), stress_cache=True)
    carried = [dict(with_psi=True, damage_model=int(DamageModel.EIGENEROSION),
                    stress_cache=False),
               dict(present_f=(tfail.MAXIMUM_STRESS,), stress_cache=False),
               dict(with_psi=True, damage_model=int(DamageModel.MODIFIED_EIGENEROSION),
                    stress_cache=False)]
    for over in carried:
        for dim in (2, 3):
            assert TK.meta_unsupported(dict(base, **over), dim) == [], (over, dim)
    refused = [(dict(damage_model=int(DamageModel.CD_MPM), stress_cache=False), (2, 3)),
               (dict(present_f=(tfail.MAXIMUM_STRESS + 1,), stress_cache=False), (2, 3))]
    for over, dims in refused:
        for dim in dims:
            assert TK.meta_unsupported(dict(base, **over), dim), (over, dim)


def test_sym_eigvals3x3_and_failure_match_jax():
    """sym_eigvals3x3_c (the cardano form scaled by max|a_ii|) on random
    symmetric stresses of l_panel3's scale against the JAX package's, run
    op by op (unjitted, where XLA rewrites no division): bit-equal on at
    least 98% of the matrices (99.0% here: XLA's CPU square root differs
    from the correctly rounded one in the last bit on ~0.7% of inputs) and
    within 4e-7 of the largest eigenvalue, and against numpy's eigenvalues
    within 1e-5 of it (the cardano floor); maximum_stress_failed_c equal to
    the JAX package's on every lane whose margin is not within TIE of the
    envelope."""
    rng = np.random.default_rng(71)
    n = 4096
    st = (rng.normal(size=(n, 3, 3)) * 2e6).astype(np.float32)
    sym = (0.5 * (st + st.transpose(0, 2, 1))).astype(np.float32)
    mj = [[jnp.asarray(sym[:, i, j]) for j in range(3)] for i in range(3)]
    mt = [[torch.from_numpy(sym[:, i, j].copy()) for j in range(3)] for i in range(3)]
    with jax.disable_jit():
        ej = np.stack([_np(x) for x in jsvd.sym_eigvals3x3_c(mj, method="cardano")], 1)
    et = np.stack([x.numpy() for x in tsvd.sym_eigvals3x3_c(mt)], 1)
    scale = np.abs(ej).max(1)
    assert (et == ej).all(1).mean() >= 0.98
    np.testing.assert_array_less(np.abs(et - ej).max(1), 4e-7 * scale)
    ref = np.linalg.eigvalsh(sym.astype(np.float64))[:, ::-1]
    np.testing.assert_array_less(np.abs(et - ref).max(1), 1e-5 * scale)
    params = np.stack([rng.uniform(1e6, 5e6, n), rng.uniform(1e6, 5e6, n)], -1).astype(np.float32)
    stc = [[jnp.asarray(st[:, i, j]) for j in range(3)] for i in range(3)]
    from sparkl_tpu.models import failure as jfail
    fj = _np(jax.jit(jfail.maximum_stress_failed_c)(jnp.asarray(params[:, 0]),
                                                     jnp.asarray(params[:, 1]), stc))
    ft = tfail.maximum_stress_failed_c(torch.from_numpy(params[:, 0]),
                                       torch.from_numpy(params[:, 1]),
                                       [[torch.from_numpy(st[:, i, j].copy()) for j in range(3)]
                                        for i in range(3)]).numpy()
    margin = np.minimum(np.abs(ref[:, 0] - params[:, 0]) / params[:, 0],
                        np.abs((ref[:, 0] - ref[:, 2]) / 2 - params[:, 1]) / params[:, 1])
    clear = margin > TIE
    np.testing.assert_array_equal(ft[clear], fj[clear])
    assert 0.2 < ft.mean() < 0.8 and clear.mean() > 0.99


def test_modified_eigenerosion_2d_matches_jax_fused():
    """The port's mirror of tests/test_fused.py's modified-eigenerosion
    scene (a 10 x 10 2D cube failing by maximum stress, crack factor 0.1,
    threshold 50, one frame of 1/60 s): the port's fused pipeline against
    the JAX fused pipeline in interpret mode, with test_fused's tolerances
    and the phase within 1e-6 (as that test holds fused against dense)."""
    grid = JGridParams(origin=(0.0, 0.0), cell_width=0.05, res=(64, 64))
    models = jreg.ModelSet.pack([jreg.ParticleModel(
        jreg.corotated_linear_elasticity(2.0e4, 0.35),
        failure=jreg.maximum_stress_failure(1.0e5, 1.0e5))])
    p = jsk.cube_particles(origin=(0.8, 1.2), counts=(10, 10), model_id=0,
                           particle_radius=0.05 / 4, density0=1000.0,
                           crack_propagation_factor=0.1, crack_threshold=50.0)
    params = JParams(dt=1.0 / 60.0, damage_model=JDM.MODIFIED_EIGENEROSION)
    colliders = (jcol.cuboid((100.0, 0.5), translation=(0.0, 0.25), friction=0.3),)
    gravity = (0.0, -9.81)
    jpipe = JPipeline(grid, models, colliders, params, gravity, use_pallas="interpret")
    tpipe = _port_pipeline(grid, models, colliders, params, gravity, None)
    pj, nj = jpipe.step_with_stats(p)
    pt, nt = tpipe.step_with_stats(_port_particles(p))
    assert int(nj) == nt
    _compare(pj, pt)
    np.testing.assert_allclose(pt.phase.numpy(), _np(pj.phase), atol=1e-6)
