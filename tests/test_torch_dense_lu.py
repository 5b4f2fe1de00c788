"""The port's dense LU (ida_tpu_torch.ops) against the JAX package's.

Inputs come from a numpy seed and go through both packages. The JAX side
runs op by op here (no jit), as does the port, so XLA cannot contract a
multiply-add; the f64 tolerance still allows for an FMA (rtol 1e-13).
Pivots and the failing column must match exactly. ``lu_factor_solve`` is
held against the Pallas kernel in interpret mode, with the tolerance of
tests/test_pallas_lu.py (the kernels' back substitutions differ in order).
The CUDA kernel itself is tested in tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ida_tpu.ops import dense_lu as jlu
from ida_tpu_torch.ops import dense_lu as tlu
from ida_tpu_torch.ops import small_lu

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

B = 16
TOL = {np.float64: 1e-13, np.float32: 1e-5}
TDT = {np.float64: torch.float64, np.float32: torch.float32}


def _system(n, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n, B)) + 3.0 * np.eye(n)[:, :, None]
    b = rng.normal(size=(n, B))
    return a.astype(dtype), b.astype(dtype)


def _jax_factor_solve(a, b):
    """Reference: the JAX package's auto dispatch, per lane (vmap) for the
    looped form above the unroll bound, batch-native below it."""
    n = a.shape[0]
    if n <= jlu.SMALL_N_UNROLL:
        f = jlu.lu_factor_unrolled(jnp.asarray(a))
        x = jlu.lu_solve_unrolled(f, jnp.asarray(b))
        return np.asarray(f.lu), np.asarray(f.piv), np.asarray(f.fail_col), np.asarray(x)
    al = jnp.asarray(np.moveaxis(a, -1, 0))
    bl = jnp.asarray(np.moveaxis(b, -1, 0))
    f = jax.vmap(jlu.lu_factor)(al)
    x = jax.vmap(jlu.lu_solve)(f, bl)
    return (
        np.moveaxis(np.asarray(f.lu), 0, -1),
        np.moveaxis(np.asarray(f.piv), 0, -1),
        np.asarray(f.fail_col),
        np.moveaxis(np.asarray(x), 0, -1),
    )


def _check(got, ref, dtype):
    lu, piv, fail, x = got
    lu_r, piv_r, fail_r, x_r = ref
    np.testing.assert_array_equal(piv.numpy(), piv_r)
    np.testing.assert_array_equal(fail.numpy(), fail_r)
    np.testing.assert_allclose(lu.numpy(), lu_r, rtol=TOL[dtype], atol=0)
    np.testing.assert_allclose(x.numpy(), x_r, rtol=TOL[dtype], atol=TOL[dtype] * np.abs(x_r).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [1, 3, 5, 8, 16, 20])
def test_auto_matches_jax(n, dtype):
    a, b = _system(n, dtype, seed=n)
    f = tlu.lu_factor_auto(torch.from_numpy(a))
    x = tlu.lu_solve_auto(f, torch.from_numpy(b))
    assert f.lu.dtype == TDT[dtype] and x.dtype == TDT[dtype]
    _check((f.lu, f.piv, f.fail_col, x), _jax_factor_solve(a, b), dtype)


@pytest.mark.parametrize("n", [1, 3, 5, 8, 16, 20])
def test_looped_matches_jax(n):
    a, b = _system(n, np.float64, seed=100 + n)
    f = tlu.lu_factor(torch.from_numpy(a))
    x = tlu.lu_solve(f, torch.from_numpy(b))
    _check((f.lu, f.piv, f.fail_col, x), _jax_factor_solve(a, b), np.float64)


def _native(rows):
    """Golden fixtures write rows of the transposed matrix (see
    tests/test_dense_lu.py); return the [N, N, 1] batch-native matrix."""
    return torch.tensor(np.array(rows).T[:, :, None].copy(), dtype=torch.float64)


GOLDEN_RF = {
    # reference crates/linear/src/dense.rs:267-288 and :290-311
    "rf1": (
        [[-0.09593473862037126, 0.040000000000000001, 1.0],
         [5274.5976183265557, -5485.2758397300222, 1.0],
         [0.035103714444140913, -0.035103714444140913, 1.0]],
        [[1.0, 0.040000000000000001, -0.09593473862037126],
         [1.0, -5485.3158397300222, -0.96160252338811314],
         [1.0, -0.075103714444140907, 0.058818531739205995]],
    ),
    "rf2": (
        [[-0.042361503587159809, 0.040000000000000001, 1.0],
         [9313.8399601148321, -9331.507477848012, 1.0],
         [0.0029441927049318833, -0.0029441927049318833, 1.0]],
        [[1.0, 0.040000000000000001, -0.042361503587159809],
         [1.0, -9331.5474778480129, -0.99810694246891751],
         [1.0, -0.042944192704931883, 0.0024427994145761397]],
    ),
}

GOLDEN_RS = {
    # reference crates/linear/src/dense.rs:215-239 (pre-factored LU + pivots)
    "rs1": (
        [[1.0, 0.040000000000000001, -0.040655973218655501],
         [1.0, -9562.0329139608493, -0.99881984364015208],
         [1.0, -0.041880782326080723, 0.00070539909027303449]],
        [-0.00000018658722011386564, 0.0000001791760359416981, 0.000000000000015432100042289676],
        [0.000010806109402745275, 0.000000000028591564117644602, -0.000010806137978877292],
    ),
    "rs2": (
        [[1.0, 0.040000000000000001, -0.041180751793579905],
         [1.0, -9376.8756693193609, -0.99825358822328103],
         [1.0, -0.04272931434962135, 0.0012553747713712066]],
        [-0.00000092446647014019954, 0.0000009098297931611867, 0.000000000000010769163338864018],
        [0.000012924954909363613, -0.000000000038131780122501411, -0.000012924916766814327],
    ),
}


@pytest.mark.parametrize("factor", [tlu.lu_factor_auto, tlu.lu_factor], ids=["auto", "looped"])
@pytest.mark.parametrize("case", sorted(GOLDEN_RF))
def test_golden_factor(case, factor):
    a_rows, expect_rows = GOLDEN_RF[case]
    f = factor(_native(a_rows))
    np.testing.assert_allclose(f.lu[:, :, 0].numpy(), np.array(expect_rows).T, rtol=1e-13)
    np.testing.assert_array_equal(f.piv[:, 0].numpy(), [2, 1, 2])
    assert int(f.fail_col[0]) == 0


@pytest.mark.parametrize("solve", [tlu.lu_solve_auto, tlu.lu_solve], ids=["auto", "looped"])
@pytest.mark.parametrize("case", sorted(GOLDEN_RS))
def test_golden_solve(case, solve):
    lu_rows, b, expect = GOLDEN_RS[case]
    f = tlu.DenseLU(
        _native(lu_rows),
        torch.tensor([[2], [1], [2]], dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32),
    )
    x = solve(f, torch.tensor(b, dtype=torch.float64)[:, None])
    np.testing.assert_allclose(x[:, 0].numpy(), expect, rtol=1e-13)


def test_golden_dense_4x4():
    # reference crates/linear/src/dense.rs:313-328
    a = torch.tensor(
        [[5.0, 0.0, 0.0, 1.0], [2.0, 2.0, 2.0, 1.0], [4.0, 5.0, 5.0, 5.0], [1.0, 6.0, 4.0, 5.0]],
        dtype=torch.float64,
    )[:, :, None]
    b = torch.tensor([9.0, 16.0, 49.0, 45.0], dtype=torch.float64)[:, None]
    x = tlu.lu_solve_auto(tlu.lu_factor_auto(a), b)
    np.testing.assert_allclose(x[:, 0].numpy(), [1.0, 2.0, 3.0, 4.0], rtol=1e-9)


@pytest.mark.parametrize("factor", [tlu.lu_factor_auto, tlu.lu_factor], ids=["auto", "looped"])
def test_singular_lanes_report_column(factor):
    # lane 0: only a[0,0] set (first zero pivot in column 2, as in
    # tests/test_dense_lu.py); lane 1: zero first column; lane 2: regular
    a = np.zeros((3, 3, 3))
    a[0, 0, 0] = 1.0
    a[:, 1:, 1] = np.arange(6.0).reshape(3, 2) + 1.0
    a[:, :, 2] = np.eye(3) * 2.0
    f = factor(torch.from_numpy(a))
    np.testing.assert_array_equal(f.fail_col.numpy(), [2, 1, 0])
    ref = jlu.lu_factor_unrolled(jnp.asarray(a))
    np.testing.assert_array_equal(f.fail_col.numpy(), np.asarray(ref.fail_col))
    np.testing.assert_array_equal(f.piv.numpy(), np.asarray(ref.piv))


def test_cpu_wrapper_runs_plain_version_and_counts_nothing():
    a, b = _system(3, np.float64, seed=7)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    small_lu.reset_launch_counts()
    f = small_lu.lu_factor(at)
    x = small_lu.lu_solve(f, bt)
    g = tlu.lu_factor_unrolled(at)
    assert torch.equal(f.lu, g.lu) and torch.equal(f.piv, g.piv)
    assert torch.equal(x, tlu.lu_solve_unrolled(g, bt))
    assert small_lu.FACTOR_LAUNCHES == 0 and small_lu.SOLVE_LAUNCHES == 0


@pytest.mark.parametrize("n", [3, 5, 8])
def test_lu_factor_solve_matches_pallas_interpret(n, monkeypatch):
    from jax.experimental import pallas as pl

    import ida_tpu.ops.pallas_lu as mod

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    rng = np.random.default_rng(n)
    bsz, tile = 16, 8
    a = rng.normal(size=(bsz, n, n)).astype(np.float32) + 3.0 * np.eye(n, dtype=np.float32)
    b = rng.normal(size=(bsz, n)).astype(np.float32)
    x_ref = np.asarray(mod.pallas_lu_solve(jnp.asarray(a), jnp.asarray(b), tile_b=tile))
    x = small_lu.lu_factor_solve(torch.from_numpy(a), torch.from_numpy(b))
    assert x.shape == (bsz, n) and x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=2e-4, atol=1e-5)
