"""K1's group skeleton, on the CPU.

Where few lanes are solved, the factor and the solve of ``csrc/small_lu.cu``
take one system per group of G threads (G the power of two >= N), one row a
thread, with the group's collectives (shuffles, ballots) in place of the
serial code's selects. Here the source is built for the host with g++ as
``tests/test_torch_lu_layouts.py`` builds it, with the group's collectives
emulated in lockstep (each thread of a block a coroutine, run from one
collective to the next; a collective that names a thread outside its group
or one that has left counts as an error), and held bit for bit against the
plain versions ``dense_lu.lu_factor_unrolled`` / ``lu_solve_unrolled``:

* at N = 1..16 in both dtypes, on lane counts that leave groups of a block
  idle (the tail of the grid);
* on adversarial columns: ties on the maximum, NaN at the diagonal and below
  it, +-0, +-Inf and zero pivots, with ``fail``;
* on the solve's layouts (``solve_layout``), and on pivots that are not a
  factor's (the serial code swaps only rows below k);
* the dispatch rule, asked of the shipped build through
  ``small_lu.uses_groups``, at each threshold.

The card runs the same source (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``). No JAX here: ``dense_lu``'s plain versions are held
against ``ida_tpu`` elsewhere (``tests/test_torch_dense_lu.py``).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from ida_tpu_torch.ops import dense_lu, small_lu
from test_torch_lu_layouts import build_host_lib, operands

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

DTYPES = [torch.float64, torch.float32]
# values of the adversarial matrices: ties, signed zeros, infinities, NaN
SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, 2.0, -2.0, 0.5, np.inf, -np.inf, np.nan])


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """The source built twice, at once: with every factor and solve on the
    group skeleton (``groups``), and as shipped, the skeleton by its rule
    (``rule``)."""
    flags = {"groups": ("-DIDA_LU_GROUP=2",), "rule": ()}
    with ThreadPoolExecutor(len(flags)) as pool:
        futures = {k: pool.submit(build_host_lib, tmp_path_factory.mktemp(f"small_lu_{k}"), f)
                   for k, f in flags.items()}
        return {k: f.result() for k, f in futures.items()}


@pytest.fixture(scope="module")
def groups_lib(host_libs):
    return host_libs["groups"]


@pytest.fixture(scope="module")
def rule_lib(host_libs):
    return host_libs["rule"]


@pytest.fixture
def on_groups(groups_lib, monkeypatch):
    """Route the wrappers' launches to the group build, on CPU tensors."""
    monkeypatch.setattr(small_lu, "build", lambda: {"lib": groups_lib})
    monkeypatch.setattr(small_lu, "_stream", lambda t: 0)
    before = groups_lib.host_collective_errors()
    yield
    assert groups_lib.host_collective_errors() == before, "a collective named a thread it may not"


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Every element the same bits (+0 is not -0), any NaN matching any NaN."""
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if not x.is_floating_point():
        return torch.equal(x, y)
    ints = torch.int64 if x.dtype == torch.float64 else torch.int32
    nx, ny = torch.isnan(x), torch.isnan(y)
    bx = torch.where(nx, 0, x.contiguous().view(ints))
    by = torch.where(ny, 0, y.contiguous().view(ints))
    return torch.equal(nx, ny) and torch.equal(bx, by)


def check_factor_and_solve(a: torch.Tensor, b: torch.Tensor, what) -> None:
    f = small_lu._factor_launch(a)
    g = dense_lu.lu_factor_unrolled(a)
    assert same_bits(f.lu, g.lu), what
    assert torch.equal(f.piv, g.piv) and torch.equal(f.fail_col, g.fail_col), what
    x = small_lu._solve_launch(g, b, "solve")
    assert same_bits(x, dense_lu.lu_solve_unrolled(g, b)), what


@pytest.mark.parametrize("dtype", DTYPES)
def test_group_factor_and_solve_are_bitwise_the_plain_versions(on_groups, dtype):
    """N = 1..16 on 1 and 3 lanes (dead groups beside live ones in a warp,
    warps of a block left idle), random matrices with no special values."""
    for n in range(1, 17):
        for lanes in (1, 3):
            rng = np.random.default_rng(100 * n + lanes)
            a = torch.from_numpy(rng.normal(size=(n, n, lanes))).to(dtype)
            b = torch.from_numpy(rng.normal(size=(n, lanes))).to(dtype)
            check_factor_and_solve(a, b, (n, lanes))


def adversarial(n: int, lanes: int, seed: int) -> np.ndarray:
    """[n, n, lanes] matrices drawn from ties, +-0, +-Inf and NaN (half the
    lanes mostly small integers, so that most columns pivot), a zero column,
    a last pivot -0, a NaN at the first diagonal and a matrix of ones."""
    rng = np.random.default_rng(seed)
    a = SPECIAL[rng.integers(0, len(SPECIAL), size=(n, n, lanes))]
    half = lanes // 2
    mild = rng.integers(-2, 3, size=(n, n, half)).astype(float)
    a[..., :half] = np.where(rng.random((n, n, half)) < 0.8, mild, a[..., :half])
    a[:, min(n - 1, 1), half] = 0.0
    a[:, :, half + 1] = np.eye(n)
    a[-1, -1, half + 1] = -0.0
    a[0, 0, half + 2] = np.nan
    a[:, :, half + 3] = 1.0
    return a


@pytest.mark.parametrize("dtype", DTYPES)
def test_group_skeleton_on_adversarial_columns(on_groups, dtype):
    """A NaN at the diagonal keeps k, a NaN below it is never taken, the
    first of equal maxima wins, +-0 compare equal, ``fail`` is the first
    zero column: the factor, its ``fail`` and the solve, bit for bit."""
    for n in range(1, 17):
        a = torch.from_numpy(adversarial(n, 12, 7 * n)).to(dtype)
        b = torch.from_numpy(np.random.default_rng(n).normal(size=(n, 12))).to(dtype)
        check_factor_and_solve(a, b, n)


@pytest.mark.parametrize("dtype", DTYPES)
def test_group_solve_reads_each_layout(on_groups, dtype):
    """The group solve reads every operand by the layout's strides, like the
    one-thread solve: batch-last contiguous, ``ida_tpu``'s pdata, the
    factor's views as ``foodweb.prec_solve`` hands them."""
    for n in (1, 2, 3, 5, 10, 16):
        for layout in ("contiguous", "pdata", "factor_view"):
            for bsz in (1, 5):
                f, b = operands(layout, n, bsz, dtype)
                x = small_lu._solve_launch(f, b, "solve")
                assert x.stride() == b.stride()
                assert same_bits(x, dense_lu.lu_solve_unrolled(f, b)), (n, layout, bsz)


def test_group_solve_takes_pivots_that_are_no_factors(on_groups):
    """Pivots at or above k are swaps; below k the serial code swaps
    nothing, and the group solve works out the same permutation."""
    for n in (2, 3, 7, 16):
        rng = np.random.default_rng(n)
        lanes = 8
        a = rng.normal(size=(n, n, lanes)) + 3.0 * np.eye(n)[:, :, None]
        f = dense_lu.lu_factor_unrolled(torch.from_numpy(a))
        piv = torch.from_numpy(rng.integers(0, n, size=(n, lanes)).astype(np.int32))
        f = f._replace(piv=piv)
        b = torch.from_numpy(rng.normal(size=(n, lanes)))
        assert same_bits(small_lu._solve_launch(f, b, "solve"), dense_lu.lu_solve_unrolled(f, b))


@pytest.fixture
def on_rule(rule_lib, monkeypatch):
    """Route the wrappers (and ``uses_groups``) to the shipped build."""
    monkeypatch.setattr(small_lu, "build", lambda: {"lib": rule_lib})
    monkeypatch.setattr(small_lu, "_stream", lambda t: 0)
    before = rule_lib.host_collective_errors()
    yield
    assert rule_lib.host_collective_errors() == before, "a collective named a thread it may not"


# the rule's thresholds by (kernel, dtype tag): the least N, the range of
# lanes, and the N from which every lane count takes the groups (None: none)
RULE = {("factor", "f64"): (9, 1, 1024, 13), ("factor", "f32"): (10, 1, 1024, None),
        ("solve", "f64"): (6, 1, 8192, None), ("solve", "f32"): (5, 32, 8192, None)}


@pytest.mark.parametrize("kernel, tag", list(RULE))
def test_dispatch_rule_thresholds(on_rule, kernel, tag):
    """``uses_groups`` asks the library: at every N, the groups exactly from
    the least N over the range of lanes (both sides of each end), and at
    every lane count from the N where the one-thread factor spills."""
    least, lo, hi, every = RULE[kernel, tag]
    for n in range(1, 17):
        for lanes in sorted({1, 2, 31, 32, 33, 1023, 1024, 1025, 4096, 8191, 8192, 8193, 51200,
                             65536, small_lu.MAX_LANES}):
            want = (every is not None and n >= every) or (n >= least and lo <= lanes <= hi)
            assert small_lu.uses_groups(kernel, tag, n, lanes) == want, (kernel, tag, n, lanes)


def test_dispatch_rule_keeps_the_wide_paths_and_groups_the_few_lanes(on_rule):
    """The headline (N = 3, 65,536 lanes), foodweb (N = 2, 51,200 lanes) and
    the adjoints' N = 3 systems (1,024 and 4,096 lanes) keep the one-thread
    skeletons, and so does the transposed solve; slider-crank's one lane at
    N = 10 takes the groups, factor and solve, and so does the continuous
    adjoint's N = 6 solve at 1,024 lanes (not its factor)."""
    for kernel in ("factor", "solve"):
        for tag in ("f64", "f32"):
            assert not small_lu.uses_groups(kernel, tag, 3, 65536)
            assert not small_lu.uses_groups(kernel, tag, 2, 51200)
        for lanes in (16, 1024, 4096):
            assert not small_lu.uses_groups(kernel, "f64", 3, lanes)
        assert small_lu.uses_groups(kernel, "f64", 10, 1)
    assert small_lu.uses_groups("solve", "f64", 6, 1024)
    assert not small_lu.uses_groups("factor", "f64", 6, 1024)
    for n, lanes in ((3, 1), (10, 1), (16, 1)):
        assert not small_lu.uses_groups("solve_t", "f64", n, lanes)


def test_rule_build_runs_each_skeleton_bitwise(on_rule):
    """The shipped build through the real wrappers' launch code on both
    sides of a threshold (N = 10: the f64 factor's groups end at 1,024
    lanes; N = 5 / 6: the f64 solve's begin at N = 6; N = 5 in f32: the
    solve's begin at 32 lanes): each bit for bit the plain versions."""
    cases = ((10, 1, torch.float64), (10, 1025, torch.float64), (5, 1, torch.float64),
             (6, 1, torch.float64), (5, 31, torch.float32), (5, 32, torch.float32))
    for n, lanes, dtype in cases:
        rng = np.random.default_rng(lanes)
        a = torch.from_numpy(rng.normal(size=(n, n, lanes))).to(dtype)
        b = torch.from_numpy(rng.normal(size=(n, lanes))).to(dtype)
        check_factor_and_solve(a, b, (n, lanes, dtype))
    assert not small_lu.uses_groups("factor", "f64", 10, 1025)
    assert small_lu.uses_groups("solve", "f64", 6, 1) and not small_lu.uses_groups("solve", "f64", 5, 1)
    assert small_lu.uses_groups("solve", "f32", 5, 32) and not small_lu.uses_groups("solve", "f32", 5, 31)
