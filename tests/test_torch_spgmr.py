"""The port's SPGMR (``ida_tpu_torch.ops.spgmr``) against ``ida_tpu``'s on
the systems of tests/test_spgmr.py: n = 40 plain, n = 30 scaled and
preconditioned, and a batch-native [30, 4] case whose last lane does not
converge, each by modified (MGS) and classical (CGS2) Gram-Schmidt.

The JAX side is the jitted ``spgmr_solve``, run once per module, at basis
sizes (maxl 5 and 6) that keep its unrolled Arnoldi loop quick to compile.
The products with A and the sums inside GMRES run in each framework's own
order (XLA:CPU vectorizes sums over more than ~32 terms), so ``x`` is held
to 1e-12 relative and the counters and flags exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ida_tpu.ops.spgmr import spgmr_solve as jax_spgmr
from ida_tpu_torch.ops.spgmr import spgmr_solve

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

GS = ["modified", "classical"]


def _plain():
    rng = np.random.default_rng(0)
    n = 40
    a = np.eye(n) * 4.0 + rng.normal(size=(n, n)) * 0.2
    return {"a": a, "b": a @ rng.normal(size=n), "kw": dict(maxl=5, max_restarts=30)}


def _scaled():
    rng = np.random.default_rng(1)
    n = 30
    d = np.abs(rng.normal(size=n)) + 1.0
    a = np.diag(d) + rng.normal(size=(n, n)) * 0.05
    x_true = rng.normal(size=n)
    return {"a": a, "b": a @ x_true, "d": d, "w": 1.0 / (np.abs(x_true) + 1.0),
            "kw": dict(maxl=5, max_restarts=10)}


def _batched():
    rng = np.random.default_rng(2)
    n, bsz = 30, 4
    a = np.eye(n)[:, :, None] * 4.0 + rng.normal(size=(n, n, bsz)) * 0.3
    # the last lane: far from diagonal dominance, too few iterations to
    # converge (but the residual shrinks: SUNLS_RES_REDUCED)
    a[:, :, -1] = rng.normal(size=(n, n)) * 2.0
    d = np.abs(rng.normal(size=(n, bsz))) + 1.0
    return {"a": a, "b": rng.normal(size=(n, bsz)), "d": d, "w": 1.0 / (d + 1.0),
            "kw": dict(maxl=6, max_restarts=5)}


CASES = {"plain_n40": _plain, "scaled_preconditioned_n30": _scaled, "batched_30x4": _batched}


def _matvec(xp, a):
    """A v, lane by lane: [N, N] @ [N], or [N, N, B] with [N, B]."""
    if a.ndim == 2:
        return lambda v: a @ v
    return lambda v: (a * v[None]).sum(1)


def _run(xp, solve, case, gs, tol):
    a = xp(case["a"])
    kw = dict(case["kw"], gs=gs)
    if "d" in case:
        d, w = xp(case["d"]), xp(case["w"])
        kw.update(psolve=lambda r: r / d, s1=w, s2=w)
    return solve(_matvec(xp, a), xp(case["b"]), tol, **kw)


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for name, make in CASES.items():
        case = make()
        for gs in GS:
            fn = jax.jit(lambda b_unused, case=case, gs=gs: _run(
                jnp.asarray, jax_spgmr, case, gs, jnp.asarray(1e-10)))
            res = fn(0)
            out[name, gs] = {k: np.asarray(v) for k, v in res._asdict().items()}
            out[name, gs]["reduced"] = np.asarray(res.reduced)
    return out


def test_inactive_lanes_are_not_solved():
    case = _batched()
    active = torch.tensor([True, False, True, False])
    res = _run(torch.from_numpy, lambda *a, **k: spgmr_solve(*a, active=active, **k), case,
               "modified", torch.tensor(1e-10, dtype=torch.float64))
    full = _run(torch.from_numpy, spgmr_solve, case, "modified",
                torch.tensor(1e-10, dtype=torch.float64))
    for k in ("x", "converged", "nli", "nps", "natimes"):
        assert torch.equal(getattr(res, k)[..., 0::2], getattr(full, k)[..., 0::2]), k
    assert res.nli[1::2].tolist() == [0, 0] and not res.converged[1::2].any()
    assert not res.x[:, 1::2].any()


@pytest.mark.parametrize("name", list(CASES))
def test_bfloat16_basis_storage_matches_ida_tpu(name):
    # storage_dtype=bfloat16: the basis rounded to bfloat16 at every store
    # (both round to nearest even), every reduction in float64: the counters
    # exactly, x to 1e-9 of its scale (XLA's contractions)
    case = CASES[name]()
    fn = jax.jit(lambda b_unused: _run(
        jnp.asarray, lambda *a, **k: jax_spgmr(*a, storage_dtype=jnp.bfloat16, **k), case,
        "modified", jnp.asarray(1e-10)))
    ref = fn(0)
    res = _run(torch.from_numpy, lambda *a, **k: spgmr_solve(*a, storage_dtype=torch.bfloat16, **k),
               case, "modified", torch.tensor(1e-10, dtype=torch.float64))
    assert res.x.dtype == torch.float64
    for k in ("converged", "nli", "nps", "natimes"):
        assert np.array_equal(getattr(res, k).numpy(), np.asarray(getattr(ref, k))), k
    scale = np.abs(np.asarray(ref.x)).max()
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-9 * scale)


def test_unknown_gs_refused():
    a = _plain()
    b = torch.from_numpy(a["b"])
    with pytest.raises(ValueError, match="gs"):
        spgmr_solve(lambda v: v, b, torch.tensor(1e-10), gs="householder")
