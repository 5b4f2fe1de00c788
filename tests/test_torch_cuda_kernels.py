"""The port's CUDA kernels on the card (marked ``cuda``; skipped without a
GPU, since a CUDA kernel has no CPU mode).

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Each kernel is held against its plain PyTorch version on the same CUDA
tensors: built with ``-fmad=false`` and following the plain version's order
of operations, it must agree bit for bit.
"""

import numpy as np
import pytest
import torch

from ida_tpu_torch import constants as C
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ida_tpu_torch.ops import dense_lu, small_lu
from ida_tpu_torch.parallel import ensemble_init, make_ensemble_solve
from ida_tpu_torch.tol_control import tol_sv

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _system(n, dtype, device, bsz=4096, seed=0):
    rng = np.random.default_rng(seed + n)
    a = rng.normal(size=(n, n, bsz)) + 3.0 * np.eye(n)[:, :, None]
    b = rng.normal(size=(n, bsz))
    return torch.from_numpy(a).to(device, dtype), torch.from_numpy(b).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 16])
def test_kernel_matches_plain_bitwise(cuda, n, dtype):
    a, b = _system(n, dtype, cuda)
    f, g = small_lu.lu_factor(a), dense_lu.lu_factor_unrolled(a)
    x, y = small_lu.lu_solve(f, b), dense_lu.lu_solve_unrolled(g, b)
    torch.cuda.synchronize()
    assert torch.equal(f.lu, g.lu) and torch.equal(f.piv, g.piv)
    assert torch.equal(f.fail_col, g.fail_col) and torch.equal(x, y)


def test_kernel_reports_singular_columns(cuda):
    a = torch.zeros((3, 3, 4), dtype=torch.float64)
    a[0, 0, 0] = 1.0
    a[:, 1:, 1] = 1.0
    a[:, :, 2] = 2.0 * torch.eye(3, dtype=torch.float64)
    a[:, :, 3] = torch.eye(3, dtype=torch.float64)
    a[2, 2, 3] = 0.0
    f = small_lu.lu_factor(a.to(cuda))
    assert f.fail_col.cpu().tolist() == [2, 1, 0, 3]
    assert torch.equal(f.fail_col.cpu(), dense_lu.lu_factor_unrolled(a).fail_col)


def test_wrappers_count_only_kernel_launches(cuda):
    a, b = _system(3, torch.float64, cuda)
    small_lu.reset_launch_counts()
    f = small_lu.lu_factor(a)
    small_lu.lu_solve(f, b)
    small_lu.lu_solve(f, b)
    dense_lu.lu_solve_unrolled(f, b)
    assert (small_lu.FACTOR_LAUNCHES, small_lu.SOLVE_LAUNCHES) == (1, 2)


def test_wrappers_reject_what_the_kernel_does_not_take(cuda):
    a, b = _system(3, torch.float64, cuda)
    with pytest.raises(TypeError):
        small_lu.lu_factor(a.to(torch.float16))
    with pytest.raises(ValueError):
        small_lu.lu_factor(torch.zeros((17, 17, 8), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        small_lu.lu_factor(a.transpose(0, 1))
    f = small_lu.lu_factor(a)
    with pytest.raises(TypeError):
        small_lu.lu_solve(f._replace(piv=f.piv.long()), b)
    with pytest.raises(ValueError):
        small_lu.lu_solve(f, b[:, :100].contiguous())
    with pytest.raises(ValueError):
        dense_lu.lu_factor_auto(torch.zeros((20, 20, 8), dtype=torch.float64, device=cuda))


def test_lu_factor_solve_solves_on_the_card(cuda):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(512, 5, 5)) + 3.0 * np.eye(5)
    b = rng.normal(size=(512, 5))
    x = small_lu.lu_factor_solve(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
    np.testing.assert_allclose(np.einsum("bij,bj->bi", a, x.cpu().numpy()), b, atol=1e-10)


def test_ensemble_goes_through_the_kernels(cuda):
    bsz = 64
    params = np.outer(np.exp(np.linspace(-0.2, 0.2, bsz)), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (bsz, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    out = {}
    for dev in ("cpu", cuda):
        st = ensemble_init(roberts_factory, params, yy0, yp0, device=dev)
        small_lu.reset_launch_counts()
        out[str(dev)] = make_ensemble_solve(roberts_factory)(
            st, params, tol_sv(1e-4, [1e-8, 1e-6, 1e-6], device=dev), 4.0
        )
        launched = small_lu.FACTOR_LAUNCHES > 0 and small_lu.SOLVE_LAUNCHES > 0
        assert launched == (str(dev) != "cpu")
    (sg, _, ig), (sc, _, ic) = out["cuda"], out["cpu"]
    assert bool((ig.cpu() == C.SUCCESS).all()) and bool((ic == C.SUCCESS).all())
    w = 1.0 / (1e-4 * sc.yy.abs() + torch.tensor([1e-8, 1e-6, 1e-6], dtype=torch.float64))
    assert float(((w * (sg.yy.cpu() - sc.yy)) ** 2).mean(dim=1).sqrt().max()) < 1.0
