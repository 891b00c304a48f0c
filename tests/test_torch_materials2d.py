"""The material models' 2D forms on the port's fused pipeline, on the CPU
against the JAX package: neo-Hookean's stress, energy and dt bound on
random F; reduced materials2 and its failure form built, packed, and
through kernels A and B's material forms (their plain versions) against
the Pallas kernels in interpret mode; a JAX model set carried across; and
what the kernels and both pipelines carry and refuse.
test_torch_materials.py holds the 3D forms, NACC and the substeps, and
states the tolerances' reasons.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparkl_tpu.models import constitutive as jcon
from sparkl_tpu.models import registry as jreg

import chip_smoke
import sparkl_tpu_torch as tsk
from sparkl_tpu_torch import interop
from sparkl_tpu_torch.core.params import DamageModel
from sparkl_tpu_torch.fused import kernels as TK
from sparkl_tpu_torch.fused.pipeline import FusedMpmPipeline
from sparkl_tpu_torch.models import constitutive as tcon
from sparkl_tpu_torch.models import failure as tfail
from sparkl_tpu_torch.models import plasticity as tplas
from sparkl_tpu_torch.models import registry as treg
from sparkl_tpu_torch.sparse.pipeline import SparseMpmPipeline

from test_torch_materials import (
    TIE,
    _c,
    _jax_models3,
    _np,
    _stack,
    check_kernel_a_materials_matches_pallas,
    check_kernel_b_materials_matches_pallas,
    check_materials_builds_bit_equal,
    check_materials_pack_bit_equal,
    pipelines_by_form,
    states_by_form,
)

torch.set_num_threads(1)

FORMS = ("2", "2-failure")


def _random_f(rng, n, d, lo, hi):
    """F = U diag(s) Vᵀ with U, V random rotations and s uniform in [lo, hi]."""
    def rot():
        q, r = np.linalg.qr(rng.normal(size=(n, d, d)))
        q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
        q[:, :, 0] *= np.sign(np.linalg.det(q))[:, None]
        return q
    s = rng.uniform(lo, hi, size=(n, d))
    return (rot() * s[:, None, :] @ rot().transpose(0, 2, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def scenes():
    """The 2D forms' _pipelines."""
    return pipelines_by_form(FORMS)


@pytest.fixture(scope="module")
def kernel_states(scenes):
    return states_by_form(scenes)


@pytest.mark.parametrize("d", [2, 3])
def test_neo_hookean_matches_jax(d):
    """Neo-Hookean's Kirchhoff stress, tensile energy and dt bound on random
    F of the large deformations the model is for (singular values in [0.6,
    1.6], random rotations) and near I (F = I + 0.02 N), phases 0, 0.3 and
    1, hardening in [0.8, 1.2], E = 1e7: stress and energy within rtol 1e-5
    and atol 1e-6 of the batch's largest magnitude, the bound within 1e-6
    relative. Near I two terms cancel to their f32 floor: the deviatoric
    stress µ J^(-2/d) (F Fᵀ - tr/d I) to ~µ·ulp·d (1.5 Pa of ~2e5 here),
    so the near-I batch's stress takes atol 1e-5 of its scale; and the
    energy's tr(F Fᵀ) J^(-2/d) - d, whose absolute error is the f32
    rounding of J^(-2/d) (exp and log, computed by other libraries in the
    two packages) times h µ d/2, so the near-I energy is held to the
    strain-equivalent scale 2e-5 · 2 sqrt(µ e_max) (g2p_errors's energy
    measure)."""
    rng = np.random.default_rng(80 + d)
    n = 4096
    lam, mu = (np.float32(x) for x in treg.lame_lambda_mu(1.0e7, 0.2))
    for batch, f in (("wide", _random_f(rng, n, d, 0.6, 1.6)),
                     ("near I", (np.eye(d) + 0.02 * rng.normal(size=(n, d, d))).astype(np.float32))):
        phase = rng.choice(np.array([0.0, 0.3, 1.0], np.float32), n)
        eh = rng.uniform(0.8, 1.2, n).astype(np.float32)
        jargs = (lam, mu, jnp.asarray(phase), jnp.asarray(eh), _c(f, "jax"))
        targs = (torch.tensor(lam), torch.tensor(mu), torch.from_numpy(phase),
                 torch.from_numpy(eh), _c(f, "torch"))
        sj = _stack(jax.jit(jcon.neo_hookean_kirchhoff_stress_c)(*jargs))
        st = _stack(tcon.neo_hookean_kirchhoff_stress_c(*targs))
        atol = (1e-6 if batch == "wide" else 1e-5) * np.abs(sj).max()
        np.testing.assert_allclose(st, sj, rtol=1e-5, atol=atol, err_msg=batch)
        ej = _np(jax.jit(jcon.neo_hookean_pos_energy_c)(*jargs))
        et = tcon.neo_hookean_pos_energy_c(*targs).numpy()
        if batch == "wide":
            np.testing.assert_allclose(et, ej, rtol=1e-5, atol=1e-6 * np.abs(ej).max())
        else:
            escale = 2.0 * np.sqrt(mu * np.abs(ej).max())
            assert np.abs(et - ej).max() <= 2e-5 * escale
        assert (ej > 0).any() and (np.linalg.det(f) < 1).any() and (np.linalg.det(f) > 1).any()
    vel = rng.normal(scale=3.0, size=(n, d)).astype(np.float32)
    rho = np.float32(2700.0)
    bj = _np(jax.jit(jcon.neo_hookean_timestep_bound)(lam, mu, np.float32(0.5), jnp.asarray(eh),
                                                      rho, jnp.asarray(vel), 0.2))
    bt = tcon.neo_hookean_timestep_bound(torch.tensor(lam), torch.tensor(mu), 0.5,
                                         torch.from_numpy(eh), torch.tensor(rho),
                                         torch.from_numpy(vel), 0.2).numpy()
    np.testing.assert_allclose(bt, bj, rtol=1e-6)


@pytest.mark.parametrize("form", FORMS)
def test_materials_builds_bit_equal(scenes, form):
    """chip_smoke.materials3 and materials2 (the port's API), reduced, and
    with their failure forms, against the same configurations built with
    the JAX package's API: every particle field, the grid and the model
    tables bit for bit; materials3's bands hold 2 lattice columns each
    (models 0-3), the lower lattice model 4."""
    check_materials_builds_bit_equal(scenes, form)


@pytest.mark.parametrize("dim", [2])
def test_materials_pack_bit_equal(scenes, dim):
    """The fused pack of the reduced materials3 and materials2 (the stress
    cache on: its rows seeded from registry.kirchhoff_stress, neo-Hookean
    and corotated): the structure, every slot row (the stress and dt-bound
    rows among them) and the ints, bit for bit, at the JAX pipeline's
    calibration; the JAX pack carried across by interop.slot_state_from_numpy
    keeps every row, the nacc row among them."""
    check_materials_pack_bit_equal(scenes, dim)


@pytest.mark.parametrize("form", FORMS)
def test_kernel_a_materials_matches_pallas(scenes, kernel_states, form):
    """Kernel A's material forms on the perturbed reduced states: the
    stress-cache read (materials3, materials2) and the fresh corotated and
    neo-Hookean stress (the failure forms, the cache off): images [D, 1 +
    d, 8^d] within rtol 1e-5, atol 1e-6 of the image's scale
    (test_torch_plastic2d's bound: the same terms summed in another
    order)."""
    check_kernel_a_materials_matches_pallas(scenes, kernel_states, form)


@pytest.mark.parametrize("form", FORMS)
def test_kernel_b_materials_matches_pallas(scenes, kernel_states, form):
    """Kernel B's material forms on occupied lanes of the perturbed reduced
    states, on the windows of the port's kernel-A images: NACC (with the
    nacc row), neo-Hookean's energy, cached stress (cache on) or failure
    stress (cache off) and dt bound, Rankine and Snow in 3D with
    Drucker-Prager beside them (3D), and NACC, neo-Hookean and Rankine in 2D.
    test_torch_plastic2d's row tolerances: rows to 1e-5 of their scale,
    those that pass through the SVDs and the maps' exp/log (F, the plastic
    state, nacc, the hardening) to 2e-5; the energy rows psi_pos and par1
    to 2e-5 of the strain-equivalent scale 2 sqrt(µ e_max) (times m for
    par1), as test_torch_fracture3d holds them (neo-Hookean's energy
    cancels near F = I); the stress rows to 2e-5 of λ + 2µ, chip_smoke's
    g2p_errors measure (the cardano SVD's f32 floor as a strain: Snow's
    clamp and Rankine's caps set singular values equal, and the epilogue's
    SVD of such an F is degenerate; measured 1.5e-5 here); on every lane
    but the NACC ties (counted, at most 2% of the NACC lanes). failed equal; phase equal (the failure
    forms trip maximum stress on the neo-Hookean lanes: checked). NACC's
    tips and projection occur in every form (its inside case too without
    failure), and the Rankine caps; in 3D also Snow's two clamps,
    Rankine's two-strain cap and Drucker-Prager flow."""
    check_kernel_b_materials_matches_pallas(scenes, kernel_states, form)


def test_interop_carries_nacc_and_neo_hookean_models():
    """A JAX ModelSet with neo-Hookean, NACC and the other models (materials3's
    failure form), taken as numpy arrays, becomes a port ModelSet with the
    same tables and present types, whose registry dispatch matches the JAX
    package's on random F (singular values in [0.9, 1.1], random
    rotations): on the neo-Hookean particles the stress within rtol 1e-5
    and atol 1e-6 of the batch scale and the energy within the
    strain-equivalent 2e-5 · 2 sqrt(µ e_max) (its near-I cancellation, as
    test_neo_hookean_matches_jax holds it), on every particle the dt
    bound within 1e-6 relative, and on the NACC particles the return map's
    F and α within 1e-5 off the NACC ties (the corotated models' SVD-based
    dispatch is held in tests/test_torch_math_models.py and
    test_torch_plastic2d.py)."""
    jm = _jax_models3(failure=True)
    tm = interop.modelset_from_numpy(jm.ctype, jm.cparams, jm.ptype, jm.pparams, jm.ftype,
                                     jm.fparams, device="cpu")
    for k in ("ctype", "cparams", "ptype", "pparams", "ftype", "fparams"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(), _np(getattr(jm, k)))
    assert (tm.present_c, tm.present_p, tm.present_f) == (jm.present_c, jm.present_p,
                                                          jm.present_f)
    assert not tm.unsupported()
    rng = np.random.default_rng(120)
    n = 2048
    ids = rng.integers(0, 5, n).astype(np.int32)
    f = _random_f(rng, n, 3, 0.9, 1.1)
    phase = rng.choice(np.array([0.0, 1.0], np.float32), n)
    eh = rng.uniform(0.9, 1.1, n).astype(np.float32)
    mass = np.full(n, 2.7, np.float32)
    vol0 = np.full(n, 1e-3, np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    zeros = np.zeros((n, 3, 3), np.float32)
    J = (jnp.asarray(ids), jnp.asarray(phase), jnp.asarray(eh), jnp.asarray(f))
    T = (torch.from_numpy(ids), torch.from_numpy(phase), torch.from_numpy(eh),
         torch.from_numpy(f))
    sj = _np(jax.jit(lambda *a: jreg.kirchhoff_stress(jm, *a, jnp.asarray(zeros),
                                                       jnp.asarray(mass), jnp.asarray(vol0)))(*J))
    st = treg.kirchhoff_stress(tm, *T, torch.from_numpy(zeros), torch.from_numpy(mass),
                               torch.from_numpy(vol0)).numpy()
    neo = (ids == 0) | (ids == 4)
    np.testing.assert_allclose(st[neo], sj[neo], rtol=1e-5, atol=1e-6 * np.abs(sj[neo]).max())
    ej = _np(jax.jit(lambda *a: jreg.pos_energy(jm, *a))(*J))
    et = treg.pos_energy(tm, *T).numpy()
    mu = float(tm.cparams[0, 1])
    assert np.abs(et[neo] - ej[neo]).max() <= 2e-5 * 2.0 * np.sqrt(mu * np.abs(ej[neo]).max())
    bj = _np(jax.jit(lambda *a: jreg.timestep_bound(jm, *a, jnp.asarray(mass), jnp.asarray(vol0),
                                                     jnp.asarray(vel), 0.2))(*J))
    bt = treg.timestep_bound(tm, *T, torch.from_numpy(mass), torch.from_numpy(vol0),
                             torch.from_numpy(vel), 0.2).numpy()
    np.testing.assert_allclose(bt, bj, rtol=1e-6)
    alpha = rng.uniform(-0.05, 0.0, n).astype(np.float32)
    ones = np.ones(n, np.float32)
    outs_j = jax.jit(lambda i, ph, ff, a: jreg.apply_plasticity(
        jm, i, ph, ff, jnp.asarray(ones), jnp.asarray(ones), jnp.asarray(ones),
        jnp.zeros(n), a))(jnp.asarray(ids), jnp.asarray(phase), jnp.asarray(f),
                          jnp.asarray(alpha))
    outs_t = treg.apply_plasticity(tm, torch.from_numpy(ids), torch.from_numpy(phase),
                                   torch.from_numpy(f), torch.ones(n), torch.ones(n),
                                   torch.ones(n), torch.zeros(n), torch.from_numpy(alpha))
    pp = tm.pparams[torch.from_numpy(ids).long()]
    margin = tplas.nacc_project_c([pp[:, k] for k in range(6)],
                                  [[torch.from_numpy(f[:, i, j].copy()) for j in range(3)]
                                   for i in range(3)], torch.from_numpy(alpha))[3].numpy()
    clear = (ids == 0) & (margin > TIE)
    assert clear.sum() >= 0.98 * (ids == 0).sum()
    np.testing.assert_array_less(np.abs(outs_t[0].numpy() - _np(outs_j[0])).max((1, 2))[clear],
                                 1e-5)
    np.testing.assert_array_less(np.abs(outs_t[5].numpy() - _np(outs_j[5]))[clear], 1e-5)
    assert (outs_t[5].numpy()[ids == 0] != alpha[ids == 0]).any()
    np.testing.assert_array_equal(outs_t[5].numpy()[ids != 0], alpha[ids != 0])


def test_meta_and_sparse_refusals():
    """meta_unsupported and registry.unsupported carry neo-Hookean, NACC,
    and Rankine and Snow in 2D and 3D, and refuse CD-MPM; mats_form picks
    the kernels' material instances for neo-Hookean or NACC, and for
    Rankine or Snow only in 3D. Both pipelines take the material scenes'
    models (the sparse one since the 2D slice) and refuse an unknown
    constitutive type."""
    base = dict(with_psi=False, m_count=1, present_c=(tcon.COROTATED,), present_p=(),
                present_f=(), damage_model=int(DamageModel.NONE), stress_cache=True)
    carried = [dict(present_c=(tcon.NEO_HOOKEAN,)), dict(present_p=(tplas.NACC,)),
               dict(present_p=(tplas.RANKINE,)), dict(present_p=(tplas.SNOW,)),
               dict(present_c=(tcon.COROTATED, tcon.NEO_HOOKEAN),
                    present_p=(tplas.DRUCKER_PRAGER, tplas.NACC, tplas.RANKINE, tplas.SNOW)),
               dict(present_c=(tcon.NEO_HOOKEAN,), present_f=(tfail.MAXIMUM_STRESS,),
                    stress_cache=False)]
    for over in carried:
        for dim in (2, 3):
            assert TK.meta_unsupported(dict(base, **over), dim) == [], (over, dim)
    for dim in (2, 3):
        assert TK.meta_unsupported(dict(base, damage_model=int(DamageModel.CD_MPM),
                                        stress_cache=False), dim)
        assert TK.mats_form(dict(base, present_c=(tcon.NEO_HOOKEAN,)), dim)
        assert TK.mats_form(dict(base, present_p=(tplas.NACC,)), dim)
        assert TK.mats_form(dict(base, present_p=(tplas.RANKINE,)), dim) == (dim == 3)
        assert TK.mats_form(dict(base, present_p=(tplas.SNOW,)), dim) == (dim == 3)
        assert not TK.mats_form(dict(base, present_p=(tplas.DRUCKER_PRAGER,)), dim)
        assert not TK.mats_form(base, dim)
    b = chip_smoke.materials3(chip_smoke.MATERIALS3_SMALL, device="cpu")
    assert not b.models.unsupported()
    assert isinstance(tsk.auto_pipeline(b, device="cpu"), FusedMpmPipeline)
    e, nu = 1.0e7, 0.2
    el = treg.corotated_linear_elasticity(e, nu)
    for spec, word in (((treg.neo_hookean_elasticity(e, nu), None), "neo-Hookean"),
                       ((el, treg.nacc_plasticity(e, nu, 0.5, True, 0.8, 0.6)), "NACC"),
                       ((el, treg.rankine_plasticity(e, nu, 5e4, 5.0)), "Rankine"),
                       ((el, treg.snow_plasticity()), "Snow")):
        ms = treg.ModelSet.pack([treg.ParticleModel(*spec)], "cpu")
        assert not ms.unsupported(), word
        SparseMpmPipeline(b.grid, ms, b.colliders, b.params, device="cpu")
        FusedMpmPipeline(b.grid, ms, b.colliders, b.params, device="cpu")
    other = treg.ModelSet.from_tables([5], [[1.0, 1.0, 0.5, 0.0]], [0], np.zeros((1, 8)), [0],
                                      np.zeros((1, 2)), "cpu")
    assert other.unsupported()
    for pipeline in (FusedMpmPipeline, SparseMpmPipeline):
        with pytest.raises(NotImplementedError, match="constitutive model types"):
            pipeline(b.grid, other, b.colliders, b.params, device="cpu")
