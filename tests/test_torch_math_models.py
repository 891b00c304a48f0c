"""sparkl_tpu_torch math, models and collider against the JAX package.

The same float32 inputs, made with numpy from a fixed seed, go through the
sparkl_tpu function and its port; tolerances are stated where they are
used. Also checks that the port never imports jax or sparkl_tpu and that
the CUDA sources' row constants match the slot layout.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import importlib

import jax
import jax.numpy as jnp

from sparkl_tpu.math import cmat as jcmat
from sparkl_tpu.models import constitutive as jcon
from sparkl_tpu.models import plasticity as jplas
from sparkl_tpu.models import registry as jreg
from sparkl_tpu.geometry import colliders as jcol
from sparkl_tpu.solver import dense as jdense
import sparkl_tpu.scenes as jscenes

jsvd = importlib.import_module("sparkl_tpu.math.svd")  # the package re-exports a function `svd`

from sparkl_tpu_torch import interop
from sparkl_tpu_torch.math import svd as tsvd
from sparkl_tpu_torch.math import cmat as tcmat
from sparkl_tpu_torch.models import constitutive as tcon
from sparkl_tpu_torch.models import plasticity as tplas
from sparkl_tpu_torch.models import registry as treg
from sparkl_tpu_torch.geometry import colliders as tcol
from sparkl_tpu_torch.solver import dense as tdense
from sparkl_tpu_torch.fused import layout as TL

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, NU = 1.0e7, 0.2


def _f_batch(kind, n=512, seed=0):
    """[n, 3, 3] float32 deformation gradients of one family."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        f = np.eye(3) + 0.3 * rng.normal(size=(n, 3, 3))
    elif kind == "near_identity":
        # Clustered singular values: the ill-conditioned case for
        # eigenvectors (sand at rest sits here).
        f = np.eye(3) + 1e-4 * rng.normal(size=(n, 3, 3))
    elif kind == "compressed":
        q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
        s = rng.uniform(0.9, 1.0, size=(n, 3))
        s[:, 2] = rng.uniform(1e-3, 1e-2, size=n)  # one crushed direction
        f = q * s[:, None, :] @ np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    else:
        raise ValueError(kind)
    return f.astype(np.float32)


def _jit(fn):
    # One XLA program per JAX call instead of op-by-op dispatch: faster on
    # the CPU. Not used for the SVD, the stress and the heightfield, whose
    # f32 results XLA's fusions move by more than op-by-op rounding does.
    return jax.jit(fn)


def _jc(f):
    return [[jnp.asarray(f[:, i, j]) for j in range(3)] for i in range(3)]


def _tc(f):
    return [[torch.from_numpy(np.ascontiguousarray(f[:, i, j])) for j in range(3)]
            for i in range(3)]


def _np(m):
    return np.stack([np.stack([np.asarray(x) for x in r], -1) for r in m], -2)


@pytest.mark.parametrize("kind", ["random", "near_identity", "compressed"])
def test_svd_c_matches_jax(kind):
    f = _f_batch(kind)
    uj, sj, vj = jsvd.svd_c(_jc(f))
    ut, st, vt = tsvd.svd_c(_tc(f))
    rec_j = _np(jcmat.recompose_c(uj, sj, vj))
    sj = np.stack([np.asarray(x) for x in sj], -1)
    st_ = np.stack([x.numpy() for x in st], -1)
    smax = np.max(sj, axis=-1, keepdims=True)
    # Singular values agree to the cardano f32 floor (~2e-5 of the
    # largest one, ROADMAP hazard list); eigenvectors of clustered values
    # are not unique, so U and V are checked through the reconstruction.
    np.testing.assert_allclose(st_ / smax, sj / smax, atol=2e-5)
    # U diag(s) V^T reproduces F as closely as the JAX package's own SVD
    # does (its worst case, with a factor 2 of rounding headroom).
    err_t = np.abs(_np(tcmat.recompose_c(ut, st, vt)) - f).max()
    err_j = np.abs(rec_j - f).max()
    assert err_t <= 2.0 * err_j + 1e-6, (err_t, err_j)
    u, v = _np(ut), _np(vt)
    eye = np.broadcast_to(np.eye(3), u.shape)
    np.testing.assert_allclose(np.swapaxes(u, -1, -2) @ u, eye, atol=1e-5)
    np.testing.assert_allclose(np.swapaxes(v, -1, -2) @ v, eye, atol=1e-5)


@pytest.mark.parametrize("kind", ["random", "near_identity", "compressed"])
def test_corotated_stress_and_energy_match_jax(kind):
    f = _f_batch(kind, seed=1)
    n = f.shape[0]
    lam, mu = (np.float32(x) for x in jreg.corotated_linear_elasticity(E, NU)[1][:2])
    rng = np.random.default_rng(2)
    phase = (rng.uniform(size=n) > 0.3).astype(np.float32)  # some fractured
    hard = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    uj, sj, vj = jsvd.svd_c(_jc(f))
    ut, st, vt = tsvd.svd_c(_tc(f))
    ph_j, h_j = jnp.asarray(phase), jnp.asarray(hard)
    ph_t, h_t = torch.from_numpy(phase), torch.from_numpy(hard)
    sj_ = _np(jcon.corotated_kirchhoff_stress_from_svd_c(lam, mu, 1.0, ph_j, h_j, _jc(f), uj, sj, vj))
    st_ = _np(tcon.corotated_kirchhoff_stress_from_svd_c(lam, mu, 1.0, ph_t, h_t, _tc(f), ut, st, vt))
    # f32 stress of magnitude ~mu*|s-1|: agree to 1e-4 of the batch's
    # largest entry (the SVD floor times lam+2mu amplification).
    np.testing.assert_allclose(st_, sj_, atol=1e-4 * np.abs(sj_).max())
    ej = np.asarray(jcon.corotated_pos_energy_from_s_c(lam, mu, h_j, _jc(f), sj))
    et = tcon.corotated_pos_energy_from_s_c(lam, mu, h_t, _tc(f), st).numpy()
    np.testing.assert_allclose(et, ej, atol=1e-4 * np.abs(ej).max())


def test_drucker_prager_update_with_svd_matches_jax():
    rng = np.random.default_rng(3)
    n = 1024
    # Compressed and sheared states: every return-map case (expanding,
    # inside the cone, projected) occurs in the batch.
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    s = rng.uniform(0.97, 1.02, size=(n, 3))
    f = (q * s[:, None, :] @ np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]).astype(np.float32)
    pp = np.asarray(jreg.drucker_prager_plasticity(E, NU)[1], np.float32)
    pdd = rng.uniform(0.9, 1.1, size=n).astype(np.float32)
    ph = rng.uniform(0.0, 0.2, size=n).astype(np.float32)
    lvg = rng.uniform(-0.01, 0.01, size=n).astype(np.float32)
    phase = np.ones(n, np.float32)
    outj = _jit(lambda *a: jplas.drucker_prager_update_with_svd_c(*a, jsvd.svd_c(a[2])))(
        [jnp.float32(x) for x in pp], jnp.asarray(phase), _jc(f), jnp.asarray(pdd),
        jnp.asarray(ph), jnp.asarray(lvg),
    )
    outt = tplas.drucker_prager_update_with_svd_c(
        [torch.tensor(x) for x in pp], torch.from_numpy(phase), _tc(f), torch.from_numpy(pdd),
        torch.from_numpy(ph), torch.from_numpy(lvg), tsvd.svd_c(_tc(f)),
    )
    # Projected F and the plastic state agree to the SVD floor (2e-5 of
    # the O(1) values).
    np.testing.assert_allclose(_np(outt[0]), _np(outj[0]), atol=2e-5)
    for a, b in zip(outt[1:4], outj[1:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)
    applied = np.any(np.abs(_np(outt[0]) - f) > 1e-6, axis=(-1, -2))
    assert 0 < applied.sum() < n  # both branches exercised


@pytest.fixture(scope="module")
def sand3_small():
    b = jscenes.build("sand3", nx=6, ny=4, nz=4)
    arrays = {k: np.asarray(v) for k, v in vars(b.particles).items()}
    return b, arrays


def _randomized(arrays, seed=4):
    rng = np.random.default_rng(seed)
    a = dict(arrays)
    n = a["position"].shape[0]
    a["velocity"] = rng.normal(scale=0.5, size=(n, 3)).astype(np.float32)
    a["velocity_gradient"] = rng.normal(scale=0.5, size=(n, 3, 3)).astype(np.float32)
    a["deformation_gradient"] = _f_batch("random", n=n, seed=seed)
    a["elastic_hardening"] = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    a["failed"] = rng.uniform(size=n) < 0.1
    return a


def test_kirchhoff_stress_and_dt_bounds_match_jax(sand3_small):
    b, arrays = sand3_small
    a = _randomized(arrays)
    pj = b.particles.replace(**{k: jnp.asarray(v) for k, v in a.items()})
    m = b.models
    mt = interop.modelset_from_numpy(m.ctype, m.cparams, m.ptype, m.pparams, m.ftype, m.fparams,
                                     device="cpu")
    pt = interop.particles_from_numpy(a, device="cpu")
    sj = np.asarray(_jit(lambda q: jreg.kirchhoff_stress(
        m, q.model_id, q.phase, q.elastic_hardening, q.deformation_gradient,
        q.velocity_gradient, q.mass, q.volume0))(pj))
    st = treg.kirchhoff_stress(
        mt, pt.model_id, pt.phase, pt.elastic_hardening, pt.deformation_gradient,
        pt.velocity_gradient, pt.mass, pt.volume0).numpy()
    # Same SVD floor as test_corotated_stress_and_energy_match_jax.
    np.testing.assert_allclose(st, sj, atol=1e-4 * np.abs(sj).max())
    dj = np.asarray(_jit(lambda q: jdense.particle_dt_bounds(b.grid, q, m))(pj))
    dt_ = tdense.particle_dt_bounds(b.grid, pt, mt).numpy()
    # Norms and a sqrt in float32: a few ulps.
    np.testing.assert_allclose(dt_, dj, rtol=1e-6)
    assert np.isinf(dt_[a["failed"] & (np.linalg.norm(a["velocity"], axis=-1) == 0)]).all()


def _surface_height(cj, q):
    """The JAX heightfield's triangulated surface height at the horizontal
    positions of q [M, 3], in float64 (cells split along the (i,k)->(i+1,k+1)
    diagonal; identity rotation)."""
    h = np.asarray(cj.data[0], np.float64)
    s = np.asarray(cj.data[1], np.float64)
    t = np.asarray(cj.translation, np.float64)
    u = ((q[:, 0] - t[0]) / s[0] + 0.5) * (h.shape[0] - 1)
    w = ((q[:, 2] - t[2]) / s[2] + 0.5) * (h.shape[1] - 1)
    i = np.clip(np.floor(u).astype(int), 0, h.shape[0] - 2)
    k = np.clip(np.floor(w).astype(int), 0, h.shape[1] - 2)
    fu, fw = u - i, w - k
    h00, h10, h01, h11 = h[i, k], h[i + 1, k], h[i, k + 1], h[i + 1, k + 1]
    y = np.where(fu >= fw, h00 + fu * (h10 - h00) + fw * (h11 - h10),
                 h00 + fw * (h01 - h00) + fu * (h11 - h01))
    return y * s[1] + t[1]


def test_heightfield_projection_matches_jax(sand3_small):
    b, _ = sand3_small
    cj = b.colliders[0]
    ct = tcol.heightfield(cj.data[0], cj.data[1], translation=cj.translation)
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(-22, 22, 4096), rng.uniform(-1, 12, 4096),
                    rng.uniform(-22, 22, 4096)], -1).astype(np.float32)
    # Jitted, as the JAX pipelines call it: the field and sample coordinates
    # are then rounded as the port rounds them (_field_coord, _vertex_coord).
    pj, ij = (np.asarray(x) for x in jax.jit(cj.project_point)(jnp.asarray(pts)))
    pe = np.asarray(cj.project_point(jnp.asarray(pts))[0])
    pt, it = (x.numpy() for x in ct.project_point(torch.from_numpy(pts)))
    np.testing.assert_array_equal(it, ij)
    # Every projection lies on the triangulated surface (measured 1.8e-6).
    np.testing.assert_allclose(pt[:, 1], _surface_height(cj, pt.astype(np.float64)), atol=1e-5)
    # Same triangle arithmetic, which XLA contracts into FMAs and the port
    # does not: 2e-6 (measured 1.9e-6), except on ties. A query nearly
    # equidistant from two triangles may take the other one: measured on 2
    # of 4096 queries, 1.25e-3 and 9.3e-4 from the jitted projection. There
    # the port's point, on the surface, is as near the query as the jitted
    # one (float64 distances; measured 5e-8 relative).
    tie = np.abs(pt - pj).max(-1) > 2e-6
    assert tie.sum() <= 4
    np.testing.assert_allclose(pt[~tie], pj[~tie], atol=2e-6)
    q = pts[tie].astype(np.float64)
    np.testing.assert_allclose(np.linalg.norm(q - pt[tie], axis=-1),
                               np.linalg.norm(q - pj[tie], axis=-1), rtol=1e-6)
    # The eager projection, as before (2e-5), wherever it agrees with the
    # jitted one to 2e-5 (all but 6 of 4096, ties of the reference itself)
    # and the port's choice is no tie.
    amb = np.abs(pe - pj).max(-1) > 2e-5
    assert amb.sum() <= 8
    np.testing.assert_allclose(pt[~amb & ~tie], pe[~amb & ~tie], atol=2e-5)


def _spiked_fields():
    """Heightfields of 41 samples at -1 with isolated spikes at -100, and
    queries that project exactly onto a spike, one per sample index: the
    projection copies the spike vertex, so it shows the vertex coordinates.
    3D: spikes at (i, 2i mod 41) (no two adjacent), each queried from just
    below; sand3's scale. 2D: every third sample, queried from below and
    just right of the next sample, so that the spike starts the query's
    first segment (its parameter clamps to 0); basic2's scale."""
    n = 41
    s3 = np.asarray([40.0, 10.0, 40.0], np.float32)
    h3 = -np.ones((n, n), np.float32)
    i = np.arange(n)
    h3[i, (2 * i) % n] = -100.0
    q3 = np.stack([(i / (n - 1) - 0.5) * s3[0], np.full(n, -100.0 * s3[1] - 1.0),
                   ((2 * i) % n / (n - 1) - 0.5) * s3[2]], -1)
    yield h3, s3, q3.astype(np.float32)
    s2 = np.asarray([2.0, 1.0], np.float32)
    for phase in range(3):
        h2 = -np.ones(n, np.float32)
        i = np.arange(phase, n - 1, 3)
        h2[i] = -100.0
        q2 = np.stack([((i + 1.01) / (n - 1) - 0.5) * s2[0], np.full(len(i), -100.05)], -1)
        yield h2, s2, q2.astype(np.float32)


def test_heightfield_vertices_bit_equal_to_jitted_jax():
    """The heightfield's sample coordinates (i / (n - 1) - 0.5) * s at n =
    41, 2D and 3D, bit-equal to jax.jit of the JAX projection's, which
    rounds the division as the product with f32(1/40) and contracts the
    subtraction into it (a true division differs at 7 of 41 samples)."""
    for h, s, q in _spiked_fields():
        cj = jcol.heightfield(h, s)
        pj = np.asarray(jax.jit(cj.project_point)(jnp.asarray(q))[0])
        pt = tcol.heightfield(h, s).project_point(torch.from_numpy(q))[0].numpy()
        assert (pj[:, 1] == -100.0 * s[1]).all()  # every query landed on its spike
        np.testing.assert_array_equal(pt, pj)


def test_scene_particles_bit_equal(sand3_small):
    _, arrays = sand3_small
    import sparkl_tpu_torch.scenes as tscenes

    bt = tscenes.build("sand3", nx=6, ny=4, nz=4, device="cpu")
    for k, v in interop.particles_to_numpy(bt.particles).items():
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)


def test_port_imports_neither_jax_nor_sparkl_tpu():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import sparkl_tpu_torch\n"
        "for m in pkgutil.walk_packages(sparkl_tpu_torch.__path__, 'sparkl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'sparkl_tpu' or m.startswith('sparkl_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    pat = re.compile(r"^\s*(import|from)\s+(jax|sparkl_tpu)(\.|\s|$)", re.M)
    for root, _, files in os.walk(os.path.join(REPO, "sparkl_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as fh:
                    assert not pat.search(fh.read()), name


def test_cuda_row_constants_match_layout():
    with open(os.path.join(REPO, "sparkl_tpu_torch", "csrc", "fused_kernels.cu")) as fh:
        src = fh.read()
    consts = dict((k, int(v)) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src))
    # The 3D table (ROW_*, NF) and the 2D one (ROW2_*, NF2); the source
    # checks its Rows<D> formula against both at compile time.
    for dim, prefix, nf in ((3, "ROW_", "NF"), (2, "ROW2_", "NF2")):
        r = TL.Rows(dim)
        names = {
            "POS": r.pos, "VEL": r.vel, "GRAD": r.grad, "DEFGRAD": r.defgrad,
            "MASS": r.mass, "VOL0": r.vol0, "PHASE": r.phase, "PSI_POS": r.psi_pos,
            "PDD": r.pdd, "PH": r.ph, "EH": r.eh, "LVG": r.lvg, "NACC": r.nacc,
            "KINVEL": r.kinvel, "CPF": r.cpf, "CTHR": r.cthr, "DTB": r.dtb,
            "FAILED": r.failed, "RADIUS0": r.radius0, "PAR1": r.par1, "PAR2": r.par2,
            "MC": r.m_c, "G": r.g, "DEBUG": r.debug, "CUMD": r.cumd, "STRESS": r.stress,
        }
        for k, v in names.items():
            assert consts[prefix + k] == v, (dim, k)
        assert consts[nf] == r.nf
    assert consts["NI"] == TL.NI
    assert (consts["I_MODEL"], consts["I_FLAGS"], consts["I_ORIGIN"]) == (
        TL.I_MODEL, TL.I_FLAGS, TL.I_ORIGIN)
    assert (consts["FLAG_ACTIVE"], consts["FLAG_STATIC"], consts["FLAG_KINEMATIC"]) == (
        TL.ACTIVE, TL.STATIC, TL.KINEMATIC)
