"""The port's probe microbenchmarks (sparkl_tpu_torch/scripts/) on the CPU
against the JAX package's TPU probe scripts.

The scripts' kernel bodies run through pl.pallas_call in interpret mode
with the scripts' own BlockSpecs, at a small size, on seeded numpy input;
the port's wrappers (their plain versions on CPU tensors) must agree to
the bit, but the exp chain: XLA's exp and torch's round differently in the
last bit, so it is held within 1e-6. scripts/vreg_probe.py is import-safe
and is loaded as a module; scripts/layout_probe.py runs its benchmarks at
import, so only its imports, assignments and defs are executed, read with
ast. chip_smoke.py holds the CUDA kernels to these plain versions on the
card.
"""

import ast
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sparkl_tpu_torch.math import linalg
from sparkl_tpu_torch.scripts import layout_probe as tlp
from sparkl_tpu_torch.scripts import vreg_probe as tvp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VREG = os.path.join(REPO, "scripts", "vreg_probe.py")
LAYOUT = os.path.join(REPO, "scripts", "layout_probe.py")


@pytest.fixture(scope="module")
def jvp():
    spec = importlib.util.spec_from_file_location("tpu_vreg_probe", VREG)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jlp():
    """scripts/layout_probe.py's imports, assignments and defs, executed
    without its module-level benchmark calls."""
    with open(LAYOUT) as fh:
        tree = ast.parse(fh.read())
    keep = (ast.Import, ast.ImportFrom, ast.Assign, ast.FunctionDef)
    tree.body = [node for node in tree.body if isinstance(node, keep)]
    ns = {"__name__": "tpu_layout_probe"}
    exec(compile(tree, LAYOUT, "exec"), ns)
    return ns


def _constants(path):
    """The script's top-level constants: {name: value}."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            value = ast.literal_eval(node.value)
            for target in node.targets:
                if isinstance(target, ast.Tuple):
                    out.update(zip((t.id for t in target.elts), value))
                else:
                    out[target.id] = value
    return out, tree


@pytest.mark.parametrize("n_ops", [64, 1024])
@pytest.mark.parametrize("transcend", [False, True], ids=["fma", "exp"])
def test_chain_matches_pallas_interpret(jvp, n_ops, transcend):
    """_chain_kernel at TOTAL_ROWS = 16, R = 8: the fma chain bit-equal (each
    step one FMA, as XLA contracts x*0.999 + 0.001); the exp chain within
    1e-6 (measured 6e-8 at 64 steps: the two libraries' exp)."""
    rows, r, c = 16, 8, jvp.C
    x = np.random.default_rng(3).uniform(-2.0, 2.0, (rows, c)).astype(np.float32)
    kernel = functools.partial(jvp._chain_kernel, n_ops, transcend)
    spec = pl.BlockSpec((r, c), lambda i: (i, 0), memory_space=pltpu.VMEM)
    f = jax.jit(lambda v: pl.pallas_call(
        kernel, grid=(rows // r,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((rows, c), jnp.float32), interpret=True)(v))
    want = np.asarray(f(jnp.asarray(x)))
    got = tvp.chain(torch.from_numpy(x), r, n_ops, transcend).numpy()
    if transcend:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def _layout_call(ns, kernel, field_major, rw, x):
    d, nf, c, nr, nrows = x.shape[1] if field_major else x.shape[0], ns["NF"], ns["C"], \
        ns["NR"], ns["NROWS"]
    vmem = pltpu.VMEM
    if field_major:
        ispec = pl.BlockSpec((nf, nr, c), lambda i: (0, i, 0), memory_space=vmem)
    else:
        ispec = pl.BlockSpec((nr, nf, c), lambda i: (i, 0, 0), memory_space=vmem)
    if not rw:
        ospec, oshape = pl.BlockSpec((nr, c), lambda i: (i, 0), memory_space=vmem), (d, c)
    elif field_major:
        ospec = pl.BlockSpec((nrows, nr, c), lambda i: (0, i, 0), memory_space=vmem)
        oshape = (nrows, d, c)
    else:
        ospec = pl.BlockSpec((nr, nrows, c), lambda i: (i, 0, 0), memory_space=vmem)
        oshape = (d, nrows, c)
    f = jax.jit(lambda v: pl.pallas_call(
        kernel, grid=(d // nr,), in_specs=[ispec], out_specs=ospec,
        out_shape=jax.ShapeDtypeStruct(oshape, jnp.float32), interpret=True)(v))
    return np.asarray(f(jnp.asarray(x)))


@pytest.mark.parametrize("body", ["k_chunk_major", "k_field_major", "kw_chunk_major",
                                  "kw_field_major"])
def test_layout_bodies_match_pallas_interpret(jlp, body):
    """The four bodies at D = 16, NF = 56, NROWS = 48, bit-equal: the read
    sum one FMA a row in row order (as XLA contracts acc + row * w, with
    the weight f32(1 + 0.001k) from the double literal), the write one f32
    product."""
    d = 16
    field_major = "field" in body
    rw = body.startswith("kw")
    x = np.random.default_rng(11).normal(size=(d, jlp["NF"], jlp["C"])).astype(np.float32)
    if field_major:
        x = np.ascontiguousarray(x.transpose(1, 0, 2))
    want = _layout_call(jlp, jlp[body], field_major, rw, x)
    port = {"k_chunk_major": tlp.read_chunk_major, "k_field_major": tlp.read_field_major,
            "kw_chunk_major": tlp.rw_chunk_major, "kw_field_major": tlp.rw_field_major}[body]
    got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_constants_match_the_scripts():
    """TOTAL_ROWS, C, N_OPS and the R sweep of vreg_probe.py; D, NF, C, NR
    and NROWS of layout_probe.py, read from the scripts with ast."""
    consts, tree = _constants(VREG)
    for name in ("TOTAL_ROWS", "C", "N_OPS"):
        assert getattr(tvp, name) == consts[name], name
    sweeps = [ast.literal_eval(node.iter) for node in ast.walk(tree)
              if isinstance(node, ast.For) and isinstance(node.target, ast.Name)
              and node.target.id == "r"]
    assert sweeps == [tvp.ROWS]
    consts, _ = _constants(LAYOUT)
    for name in ("D", "NF", "C", "NR", "NROWS"):
        assert getattr(tlp, name) == consts[name], name


def test_fma_exact_is_one_rounding():
    """linalg.fma against jitted XLA's contracted a*b + c (a hardware
    FMA) on triples over 40 decades, where rounding the f64 sum to nearest
    would round twice now and then: bit-equal."""
    rng = np.random.default_rng(29)
    n = 200_000
    a, b, c = ((rng.normal(size=n) * 10.0 ** rng.integers(-15, 15, n)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax.jit(lambda p, q, r: p * q + r)(a, b, c))
    got = linalg.fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_wrappers_refuse_bad_inputs():
    x = torch.zeros((16, 128))
    for bad, r, err in ((x.double(), 8, TypeError), (torch.zeros((16, 64)), 8, ValueError),
                        (x, 12, ValueError), (torch.zeros((8, 128)), 16, ValueError),
                        (torch.zeros((128, 16)).t(), 8, ValueError)):
        with pytest.raises(err):
            tvp.chain(bad, r, 16)
    y = torch.zeros((4, 56, 128))
    for fn in (tlp.read_chunk_major, tlp.rw_chunk_major):
        for bad, err in ((y.double(), TypeError), (torch.zeros((4, 40, 128)), ValueError),
                         (torch.zeros((4, 56, 64)), ValueError),
                         (torch.zeros((56, 4, 128)).transpose(0, 1), ValueError)):
            with pytest.raises(err):
                fn(bad)
    for fn in (tlp.read_field_major, tlp.rw_field_major):
        with pytest.raises(ValueError):
            fn(torch.zeros((40, 4, 128)))


def test_probes_refuse_without_a_card(monkeypatch):
    """Both probes' main() raise where no CUDA device is: they never time
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (tvp.main, tlp.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main()
