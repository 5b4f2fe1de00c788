"""The LU solve kernels' layouts, on the CPU.

The solve kernels of ``csrc/small_lu.cu`` read every operand by strides
(``ops/small_lu.py::solve_layout``): the batch-last contiguous layout,
foodweb's ``pdata`` and right-hand side, one lane, and the views
``foodweb.prec_solve`` hands them, with no copy around the launch. Here:

* the stride analysis (plain Python over shapes, strides and pointers) on
  each layout, and its refusal of one it cannot express;
* the kernel source built for the HOST with the C++ compiler (the CUDA
  keywords defined away, the vector types as plain structs, each
  ``kernel<<<grid, threads, 0, s>>>(...)`` a loop over blocks whose threads
  run as coroutines in lockstep from one warp collective to the next,
  ``-ffp-contract=off``: ``build_host_lib``, which
  ``test_torch_lu_groups.py`` also builds the group skeleton with),
  launched through the real wrapper on CPU tensors, bit for bit against the
  plain versions on each layout;
* ``foodweb.prec_solve`` against its earlier copying form (the same bits),
  and, with the solve routed to the host build, with no copy at all.

The kernels themselves run only on a GPU (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``). No JAX here: ``test_torch_krylov_path.py`` holds the
preconditioner against ``ida_tpu``.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from ida_tpu_torch.models import foodweb_problem
from ida_tpu_torch.ops import dense_lu, small_lu
from ida_tpu_torch.ops._build import CSRC

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

NPTS = 3  # grid points of the foodweb-like layouts

_STUB = r"""
#pragma once
#include <math.h>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <vector>
#include <ucontext.h>
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct HostDim { unsigned x = 0; };
static thread_local HostDim blockIdx, threadIdx, blockDim;
inline int cudaGetLastError() { return 0; }
struct double2 { double x, y; };
struct float2 { float x, y; };
struct int2 { int x, y; };
inline double2 make_double2(double x, double y) { return {x, y}; }
inline float2 make_float2(float x, float y) { return {x, y}; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }

// A block's threads run as coroutines, each from one collective to the
// next, all of them before any goes on: lockstep between collectives. A
// thread publishes its operand in its own slot (two of them, alternating),
// yields, and reads its source's slot once every thread has published. A
// collective that names a thread outside its mask, or one that has left or
// is at another collective, counts as an error (host_collective_errors).
struct HostBlock {
  std::vector<ucontext_t> ctx;
  std::vector<std::vector<char>> stack;
  std::vector<char> done;
  std::vector<unsigned> calls;
  std::vector<uint64_t> slot[2];
  std::vector<unsigned> masks[2];
  ucontext_t main;
  const std::function<void()>* body = nullptr;
  long errors = 0;
};
static HostBlock host_block;

inline void host_entry() {
  (*host_block.body)();
  host_block.done[threadIdx.x] = 1;
}

template <class F>
void host_run_block(unsigned threads, F& body) {
  HostBlock& h = host_block;
  std::function<void()> fn = body;
  h.body = &fn;
  h.ctx.resize(threads);
  h.stack.resize(threads);
  h.done.assign(threads, 0);
  h.calls.assign(threads, 0);
  for (int i = 0; i < 2; ++i) { h.slot[i].assign(threads, 0); h.masks[i].assign(threads, 0); }
  for (unsigned t = 0; t < threads; ++t) {
    h.stack[t].resize(1 << 17);
    getcontext(&h.ctx[t]);
    h.ctx[t].uc_stack.ss_sp = h.stack[t].data();
    h.ctx[t].uc_stack.ss_size = h.stack[t].size();
    h.ctx[t].uc_link = &h.main;
    makecontext(&h.ctx[t], host_entry, 0);
  }
  for (bool live = true; live;) {
    live = false;
    for (unsigned t = 0; t < threads; ++t) {
      if (h.done[t]) continue;
      threadIdx.x = t;
      swapcontext(&h.main, &h.ctx[t]);
      live = live || !h.done[t];
    }
  }
}

// publish `bits`, wait for every thread, and return this collective's buffer
inline unsigned host_publish(unsigned mask, uint64_t bits) {
  HostBlock& h = host_block;
  const unsigned t = threadIdx.x;
  const unsigned buf = h.calls[t]++ & 1u;
  h.slot[buf][t] = bits;
  h.masks[buf][t] = mask;
  if (!((mask >> (t & 31u)) & 1u)) ++h.errors;
  swapcontext(&h.ctx[t], &h.main);
  // every thread the mask names is at this collective, with this mask
  const unsigned c = h.calls[t];
  for (unsigned lane = 0; lane < 32; ++lane) {
    const unsigned src = (t & ~31u) + lane;
    if (((mask >> lane) & 1u) && (src >= h.done.size() || h.calls[src] < c
                                  || h.calls[src] > c + 1 || h.masks[buf][src] != mask))
      ++h.errors;
  }
  return buf;
}

inline uint64_t host_read(unsigned buf, unsigned mask, unsigned lane) {
  HostBlock& h = host_block;
  const unsigned t = threadIdx.x;
  const unsigned src = (t & ~31u) + lane;
  // the source published this collective (the calls-th) and, if it ran
  // before this thread in the pass, at most the next one (other buffer)
  const unsigned c = h.calls[t];
  if (src >= h.done.size() || h.calls[src] < c || h.calls[src] > c + 1
      || h.masks[buf][src] != mask || !((mask >> lane) & 1u)) {
    ++h.errors;
    return h.slot[buf][t];
  }
  return h.slot[buf][src];
}

template <class V>
uint64_t host_bits(V v) { uint64_t b = 0; std::memcpy(&b, &v, sizeof(V)); return b; }
template <class V>
V host_value(uint64_t b) { V v; std::memcpy(&v, &b, sizeof(V)); return v; }

template <class V>
V __shfl_sync(unsigned mask, V v, int src, int width) {
  const unsigned buf = host_publish(mask, host_bits(v));
  const unsigned lane = threadIdx.x & 31u;
  const unsigned from = (lane & ~(unsigned)(width - 1)) + ((unsigned)src & (unsigned)(width - 1));
  return host_value<V>(host_read(buf, mask, from));
}

template <class V>
V __shfl_xor_sync(unsigned mask, V v, int bit, int width) {
  const unsigned buf = host_publish(mask, host_bits(v));
  const unsigned lane = threadIdx.x & 31u;
  if (bit >= width) ++host_block.errors;
  return host_value<V>(host_read(buf, mask, lane ^ (unsigned)bit));
}

inline unsigned __ballot_sync(unsigned mask, int pred) {
  const unsigned buf = host_publish(mask, pred ? 1u : 0u);
  unsigned out = 0;
  for (unsigned lane = 0; lane < 32; ++lane)
    if ((mask >> lane) & 1u) out |= (unsigned)(host_read(buf, mask, lane) & 1u) << lane;
  return out;
}
"""
_PRELUDE = r"""
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#include <cuda_runtime.h>
template <class F, class... A>
void host_launch(unsigned grid, unsigned threads, F f, A... a) {
  blockDim.x = threads;
  auto body = [&]() { f(a...); };
  for (unsigned g = 0; g < grid; ++g) {
    blockIdx.x = g;
    host_run_block(threads, body);
  }
}
extern "C" long host_collective_errors() { return host_block.errors; }
"""


def build_host_lib(out, flags=()):
    """``csrc/small_lu.cu`` built for the host with g++ (``flags`` added:
    e.g. ``-DIDA_LU_GROUP=2``), bound as the wrappers bind the card's."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    (out / "cuda_runtime.h").write_text(_STUB)
    src, n = re.subn(r"(\w+<[^<>]*>)<<<([^,]+), ([^,]+), 0, s>>>\(", r"host_launch(\2, \3, \1, ",
                     (CSRC / "small_lu.cu").read_text())
    # the factor, the solve and the transposed solve in each skeleton, and
    # the floor's copies
    assert n == 9
    (out / "small_lu_host.cpp").write_text(_PRELUDE + src)
    lib_path = out / "libsmall_lu_host.so"
    proc = subprocess.run(
        [cxx, "-O0", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-I", str(out),
         "-I", str(CSRC), *flags, "-o", str(lib_path), str(out / "small_lu_host.cpp")],
        capture_output=True, text=True, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(lib_path))
    small_lu.bind(lib)
    lib.host_collective_errors.restype = ctypes.c_long
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory.mktemp("small_lu_host"))


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """Route the solve wrappers' launches to the host build, on CPU tensors."""
    monkeypatch.setattr(small_lu, "build", lambda: {"lib": host_lib})
    monkeypatch.setattr(small_lu, "_stream", lambda t: 0)
    yield
    small_lu.reset_launch_counts()


def operands(layout: str, n: int, bsz: int, dtype, seed: int = 0):
    """Factors of a well-conditioned batch and a right-hand side, laid out
    as ``layout``; bsz = 1 in a foodweb layout is one lane (no batch axis).

    - ``contiguous``: lu [n, n, bsz], piv [n, bsz], b [n, bsz];
    - ``pdata``: ``ida_tpu``'s pdata as a checkpoint loads it, lu stored
      [npts, n, n, *batch], piv [npts, n, *batch], b from r [npts * n, *batch],
      each viewed as the solve takes it ([n, n, npts, *batch] ...);
    - ``factor_view``: lu and piv as the factor writes them, [n, n, npts,
      *batch], b as ``foodweb.prec_solve`` views r (its main path).
    """
    batch = () if layout != "contiguous" and bsz == 1 else (bsz,)
    lanes = (bsz,) if layout == "contiguous" else (NPTS,) + batch
    rng = np.random.default_rng(seed + 97 * n + bsz)
    a = rng.normal(size=(n, n) + lanes) + 3.0 * np.eye(n).reshape((n, n) + (1,) * len(lanes))
    f = dense_lu.lu_factor_unrolled(torch.from_numpy(a).to(dtype))
    b = torch.from_numpy(rng.normal(size=(n,) + lanes)).to(dtype)
    if layout == "pdata":
        lu = f.lu.movedim((0, 1), (1, 2)).contiguous().movedim((1, 2), (0, 1))
        piv = f.piv.movedim(0, 1).contiguous().movedim(1, 0)
        b = b.movedim(0, 1).contiguous().movedim(1, 0)
        return dense_lu.DenseLU(lu, piv, None), b
    if layout == "factor_view":
        return f, b.movedim(0, 1).contiguous().movedim(1, 0)
    return f, b


@pytest.mark.parametrize("layout, bsz, dtype, expect", [
    ("contiguous", 200, torch.float64, dict(outer=1, inner=200, lu_j=200, lu_o=0, vector=1)),
    ("contiguous", 129, torch.float64, dict(outer=1, inner=129, vector=0)),
    ("contiguous", 202, torch.float32, dict(outer=1, inner=202, vector=1)),
    ("contiguous", 129, torch.float32, dict(outer=1, inner=129, vector=0)),
    ("pdata", 128, torch.float64,
     dict(outer=NPTS, inner=128, lu_i=2 * 128, lu_j=128, lu_o=4 * 128, piv_i=128,
          piv_o=2 * 128, b_i=128, b_o=2 * 128, x_i=128, x_o=2 * 128, vector=1)),
    ("factor_view", 128, torch.float64,
     dict(outer=NPTS, inner=128, lu_i=2 * NPTS * 128, lu_o=128, piv_o=128, b_o=2 * 128,
          vector=1)),
    ("pdata", 1, torch.float64, dict(outer=NPTS, inner=1, lu_o=4, piv_o=2, b_o=2, vector=0)),
    ("factor_view", 1, torch.float64, dict(outer=NPTS, inner=1, lu_o=1, b_o=2, vector=0)),
])
def test_solve_layout_reads_each_layout_of_the_path(layout, bsz, dtype, expect):
    f, b = operands(layout, 2, bsz, dtype)
    got = small_lu.solve_layout(f.lu, f.piv, b, torch.empty_like(b)).as_dict()
    assert {k: got[k] for k in expect} == expect
    assert small_lu.reads(f, b)


def test_solve_layout_refuses_what_it_cannot_express():
    """Lanes [4, 5] that b holds transposed while lu holds them in order:
    no run of lanes is consecutive in both, and the axes do not fold into
    one stride. The wrapper raises, naming the layout, before any build."""
    f, b = operands("contiguous", 3, 20, torch.float64)
    f = dense_lu.DenseLU(f.lu.reshape(3, 3, 4, 5), f.piv.reshape(3, 4, 5), None)
    bt = b.reshape(3, 5, 4).transpose(1, 2)
    assert small_lu.solve_layout(f.lu, f.piv, bt, torch.empty_like(bt)) is None
    assert not small_lu.reads(f, bt)
    with pytest.raises(ValueError, match=r"cannot read lanes \(4, 5\)"):
        small_lu._solve_launch(f, bt, "solve")
    # a cotangent expanded along every lane axis reads (stride 0); one
    # expanded along some only is what dense_lu._solve_any copies
    assert small_lu.reads(f, torch.ones(3, 1, 1, dtype=torch.float64).expand(3, 4, 5))
    assert not small_lu.reads(f, torch.ones(3, 4, 1, dtype=torch.float64).expand(3, 4, 5))
    # an unaligned view still reads, lane by lane
    off = b[:, 1:]
    got = small_lu.solve_layout(f.lu.reshape(3, 3, 20)[..., 1:], f.piv.reshape(3, 20)[:, 1:], off,
                                torch.empty_like(off))
    assert (got.outer, got.inner, got.vector) == (1, 19, 0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel", ["solve", "solve_t"])
def test_host_build_is_bitwise_the_plain_version_on_each_layout(on_host, kernel, dtype):
    """The kernel source's solve and transposed solve, launched through the
    wrapper on each layout (pairs of lanes, lane by lane, one lane, rows of
    the foodweb layouts), against the plain versions: every bit."""
    plain = dense_lu.lu_solve_unrolled if kernel == "solve" else dense_lu.lu_solve_unrolled_t
    for n in (1, 2, 3, 4, 5, 16):
        for layout in ("contiguous", "pdata", "factor_view"):
            for bsz in (1, 129, 200):
                f, b = operands(layout, n, bsz, dtype)
                x = small_lu._solve_launch(f, b, kernel)
                assert x.stride() == b.stride()
                assert torch.equal(x, plain(f, b)), (n, layout, bsz)


def _parent_prec_solve(npts):
    """``foodweb.prec_solve`` as it was before the kernel read strides: the
    lu, piv and right-hand side copied to [2, 2, npts, *batch], [2, npts,
    *batch], [2, npts, *batch], and the result copied back."""
    def prec_solve(pdata, r, cj):
        lu, piv = pdata
        rb = r.reshape((npts, 2) + r.shape[1:]).movedim(1, 0).contiguous()
        f = dense_lu.DenseLU(lu.movedim((1, 2), (0, 1)).contiguous(),
                             piv.movedim(1, 0).contiguous(), None)
        return dense_lu.lu_solve_auto(f, rb).movedim(0, 1).reshape(r.shape)
    return prec_solve


def _prec_inputs(m, batch, seed=3):
    prob = foodweb_problem(m, m, device="cpu")
    rng = np.random.default_rng(seed)
    shape = (prob.n,) + batch
    yy = torch.from_numpy(10.0 + rng.random(shape))
    cj = torch.tensor(1e3 * (1.0 + rng.random(batch)), dtype=torch.float64)
    pdata = prob.prec_setup(0.0, cj, yy, torch.zeros_like(yy), torch.zeros_like(yy))
    r = torch.from_numpy(rng.normal(size=shape))
    return prob, pdata, r, cj


@pytest.mark.parametrize("batch", [(), (3,)], ids=["one_lane", "batched"])
def test_prec_solve_without_copies_keeps_the_parent_bits(batch):
    """On the CPU (the plain version): the preconditioner solve reads
    pdata's views as they lie and gives the bits of the copying form, for
    pdata as ``prec_setup`` returns it and as a checkpoint loads it."""
    m = 3
    prob, pdata, r, cj = _prec_inputs(m, batch)
    parent = _parent_prec_solve(m * m)
    loaded = tuple(t.contiguous() for t in pdata)
    for pd in (pdata, loaded):
        z = prob.prec_solve(pd, r, cj)
        assert z.shape == r.shape and torch.equal(z, parent(pd, r, cj))


class _Calls(TorchFunctionMode):
    """The torch functions called, by name, and the tensors ``empty_like``
    returned."""

    def __init__(self):
        super().__init__()
        self.names, self.allocated = [], []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.names.append(getattr(func, "__name__", str(func)))
        if self.names[-1] == "empty_like":
            self.allocated.append(out)
        return out


@pytest.mark.parametrize("batch", [(), (4,)], ids=["one_lane", "batched"])
def test_prec_solve_is_one_launch_and_no_copy(on_host, monkeypatch, batch):
    """With the solve routed to the host build of the kernel (as a CUDA
    tensor would go to the kernel), one ``prec_solve`` launches once and
    allocates only the kernel's result, which it returns as a view: every
    other call is a view or reads a tensor's metadata."""
    monkeypatch.setattr(small_lu, "lu_solve", lambda f, b: small_lu._solve_launch(f, b, "solve"))
    m = 3
    prob, pdata, r, cj = _prec_inputs(m, batch)
    with _Calls() as calls:
        z = prob.prec_solve(pdata, r, cj)
    views = {"movedim", "reshape", "view", "permute", "transpose"}
    metadata = {"__get__", "stride", "data_ptr", "element_size", "dim", "size"}
    assert set(calls.names) - views - metadata == {"empty_like"}, calls.names
    (x,) = calls.allocated
    assert z.data_ptr() == x.data_ptr() and z.shape == r.shape
    assert torch.equal(z, _parent_prec_solve(m * m)(pdata, r, cj))
