"""The differentiable LU and the solve's loop forms, against finite
differences and the while forms: ``gradcheck`` of the LU Functions at N = 2,
3, 6, the gradient of a 20-unknown consistent-IC solve through the looped LU
against ``ida_tpu``'s, and the unrolled Newton and root loops keeping the
primal bit for bit (split from tests/test_torch_sensitivity.py, whose helpers
they share).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ida_tpu.sensitivity as jsens
from ida_tpu.tol_control import tol_sv as jax_tol_sv
from ida_tpu_torch import sensitivity as S
from ida_tpu_torch.core.state import IdaOptions
from ida_tpu_torch.models import roberts_factory
from ida_tpu_torch.ops import dense_lu
from ida_tpu_torch.tol_control import tol_sv
from ida_tpu_torch.utils import ad_mode
from test_torch_sensitivity import (
    N20,
    _chain_jax,
    _chain_port,
    _lu_system,
    _same_state,
    _solve_fields,
    _t,
)

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


@pytest.mark.parametrize("n", [2, 3, 6])
def test_lu_functions_gradcheck(n):
    """``lu_solve_auto`` and ``lu_solve_t_auto`` through ``lu_factor_auto``:
    reverse, forward and second order, f64, B = 5 (the looped form past
    N = 16 is held against ``ida_tpu`` below, at N = 20)."""
    a, b = _lu_system(n)

    def solve(a, b):
        return dense_lu.lu_solve_auto(dense_lu.lu_factor_auto(a), b)

    def solve_t(a, b):
        return dense_lu.lu_solve_t_auto(dense_lu.lu_factor_auto(a), b)

    for fn in (solve, solve_t):
        assert torch.autograd.gradcheck(fn, (a, b), check_forward_ad=True)
        assert torch.autograd.gradgradcheck(fn, (a, b))
    # the values: the solve and the transposed solve of the same factors
    lead = a.detach().permute(2, 0, 1)
    x = torch.linalg.solve(lead, b.detach().t().unsqueeze(-1)).squeeze(-1).t()
    xt = torch.linalg.solve(lead.transpose(1, 2), b.detach().t().unsqueeze(-1)).squeeze(-1).t()
    np.testing.assert_allclose(solve(a, b).detach().numpy(), x.numpy(), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(solve_t(a, b).detach().numpy(), xt.numpy(), rtol=1e-12, atol=1e-13)


def test_safe_ad_and_the_unrolled_loops_keep_the_primal_bit_for_bit():
    """The guarded run (``ida_tpu``'s tests/test_adjoint.py:153) and the
    fixed-trip Newton loop give every field of the plain run, to 4e4."""
    ref = _solve_fields(IdaOptions())
    assert int(ref[0].nst) > 29
    with ad_mode.safe_ad():
        guarded = _solve_fields(IdaOptions())
    _same_state(ref, guarded)
    _same_state(ref, _solve_fields(IdaOptions(unroll_newton=True)))


def test_unrolled_root_search_is_bit_for_bit_the_while_form():
    from functools import partial

    factory = partial(roberts_factory, with_roots=True)
    ref = _solve_fields(IdaOptions(), factory, tout=0.4)
    assert int(ref[2]) == 2  # ROOT_RETURN at y1 = 1e-4 ... the first event
    _same_state(ref, _solve_fields(IdaOptions(unroll_roots=True), factory, tout=0.4))


def test_consistent_ic_gradient_through_the_looped_lu_at_n20():
    """The gradient of a 20-unknown IC solve (the looped LU, which swaps
    rows in place) against ``ida_tpu``'s."""
    p0 = np.array([0.5, 0.3, 0.7])
    rng = np.random.default_rng(20)
    yy0 = rng.uniform(0.1, 1.0, N20)
    yp0 = np.zeros(N20)
    w = rng.normal(size=N20)
    jtol = jax_tol_sv(1e-6, 1e-8)
    jcic = jsens.make_consistent_ic(_chain_jax, "ya_ydp", 1.0, jtol)
    jg = jax.grad(lambda p: jnp.sum(jcic(p, jnp.asarray(yy0), jnp.asarray(yp0))[1] * w))(
        jnp.asarray(p0))
    cic = S.make_consistent_ic(_chain_port, "ya_ydp", 1.0, tol_sv(1e-6, 1e-8, device="cpu"))
    p = _t(p0).requires_grad_()
    yyc, ypc, ok = cic(p, _t(yy0), _t(yp0))
    (g,) = torch.autograd.grad((ypc * _t(w)).sum(), p)
    assert float(ok) == 1.0
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-8)
