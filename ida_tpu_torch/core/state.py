"""The integrator state (L4 layer).

Port of ``ida_tpu/core/state.py``: the reference's mutable ``Ida`` struct and
its nonlinear/linear solver state (reference ``src/lib.rs:89-244``,
``src/ida_nls.rs:20-60``, ``src/ida_ls.rs:15-106``) as one NamedTuple of
tensors with the same fields, so a state converts field by field. Per lane a
field has the reference's shape; an ensemble adds batch axes (leading from
:func:`init_state` with batched inputs, trailing inside the core).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import constants as C
from ..problem import IdaProblem
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class IdaOptions:
    """Solver options (reference ``Ida::new`` defaults, src/lib.rs:309-317).

    ``linear_solver`` is "dense" (batched LU), "band" (banded LU,
    ``ops/banded.py``, with half-bandwidths ``band_mu`` and ``band_ml``) or
    "spgmr" (matrix-free restarted GMRES, ``ops/spgmr.py``: ``krylov_maxl``
    basis vectors, ``krylov_max_restarts`` restarts, Arnoldi by
    ``krylov_gs`` "modified" Gram-Schmidt or "classical" CGS2, linear
    tolerance factor ``eplifac``). ``enable_constraints`` False leaves the
    inequality-constraints block of the Newton layer out (bit for bit the
    same for a state without constraints; ``IDA.set_constraints`` then
    refuses). ``unroll_newton`` runs the Newton loops a fixed number of
    masked passes (``maxnlsit`` inner, 2 outer) and ``unroll_roots`` the
    Illinois root search ``max_root_iters`` masked passes, with no host read
    between them; both are bit for bit the while forms in every lane (the
    adjoint path of ``sensitivity.py`` sets both, as ``ida_tpu``'s does).
    ``remat_attempts`` recomputes each step attempt in the backward pass
    (``torch.utils.checkpoint``): autograd then keeps only the attempt
    loop's carry, not every Newton iterate and factor; no effect on a solve
    that is not differentiated. ``debug_trace`` dumps the state before every
    step attempt into the active ``utils.trace.DataTrace``.

    The mixed-precision modes (``ida_tpu``'s, not C-parity: an inexact
    Newton whose f64 residual and error test still gate every step):
    ``ls_precision`` "full" solves the linear systems in the state's dtype;
    "single" evaluates the Jacobian and runs the LU factor and solve (dense,
    band) or the whole Krylov iteration (spgmr) in float32 and casts the
    correction back; "refined" (dense only) evaluates the Jacobian in the
    state's dtype, factors and stores it in float32, and refines every
    solve once against that Jacobian applied as a jvp of the residual at
    the saved lsetup point (``state.ls_*``): x = x0 + LU32^-1 (b - J x0).
    Under both, the dense and band factors are stored in float32.
    ``krylov_storage="bfloat16"`` stores the GMRES basis in bfloat16, every
    reduction staying in the solve's dtype. ``fast_math`` keeps phi unscaled
    and folds the phi -> phi-star scaling into its consumers (predict, the
    error test, complete_step's recurrence; ``coeffs.phi_star_scale``): one
    [K1, N] pass less an attempt and none on a failure, at the price of a
    different association, so step sequences need not be C IDA's."""

    maxord: int = C.MAXORD_DEFAULT  # max BDF order (1..5)
    mxstep: int = C.MXSTEP_DEFAULT  # max internal steps per solve() call
    maxncf: int = C.MXNCF  # max convergence failures per step
    maxnef: int = C.MXNEF  # max error-test failures per step
    maxnlsit: int = C.MAXNLSIT  # max Newton iterations per attempt
    suppressalg: bool = False  # exclude algebraic vars from error tests
    max_root_iters: int = 100  # hard bound on the Illinois root search loop
    linear_solver: str = "dense"  # "dense" | "band" | "spgmr"
    band_mu: int = 0  # upper half-bandwidth (linear_solver="band")
    band_ml: int = 0  # lower half-bandwidth (linear_solver="band")
    ls_precision: str = "full"  # "full" | "single" | "refined"
    krylov_storage: str = "compute"  # GMRES basis: "compute" (the solve's dtype) | "bfloat16"
    krylov_maxl: int = 5  # GMRES subspace dimension (SUNDIALS default)
    krylov_max_restarts: int = 5  # GMRES restarts (SUNDIALS default)
    krylov_gs: str = "modified"  # "modified" (MGS) | "classical" (CGS2)
    eplifac: float = 0.05  # linear tolerance factor (reference ida_ls.rs:211)
    enable_constraints: bool = True  # False: no inequality-constraints block
    unroll_newton: bool = False  # fixed masked passes of the Newton loops
    unroll_roots: bool = False  # fixed masked passes of the Illinois loop
    remat_attempts: bool = False  # recompute each attempt in the backward
    fast_math: bool = False  # phi kept unscaled (not C-parity)
    debug_trace: bool = False

    def __post_init__(self):
        if self.linear_solver not in ("dense", "band", "spgmr"):
            raise ValueError(
                f"linear_solver must be 'dense', 'band' or 'spgmr', got {self.linear_solver!r}")
        if self.band_mu < 0 or self.band_ml < 0:
            raise ValueError("band_mu and band_ml must be at least 0")
        if self.ls_precision not in ("full", "single", "refined"):
            raise ValueError(
                f"ls_precision must be 'full', 'single' or 'refined', got {self.ls_precision!r}")
        if self.ls_precision == "refined" and self.linear_solver != "dense":
            raise ValueError("ls_precision='refined' is implemented for the dense path only")
        if self.krylov_storage not in ("compute", "bfloat16"):
            raise ValueError(
                f"krylov_storage must be 'compute' or 'bfloat16', got {self.krylov_storage!r}")
        if self.krylov_gs not in ("modified", "classical"):
            raise ValueError(f"krylov_gs must be 'modified' or 'classical', got {self.krylov_gs!r}")
        if self.krylov_maxl < 1 or self.krylov_max_restarts < 0:
            raise ValueError("krylov_maxl must be at least 1 and krylov_max_restarts at least 0")
        if not 1 <= self.maxord <= C.MAXORD_DEFAULT:
            raise ValueError(f"maxord must lie in 1..{C.MAXORD_DEFAULT}, got {self.maxord}")


class IdaState(NamedTuple):
    """Complete integrator state. Per-lane shapes: N = problem size,
    R = max(nroots, 1), K1 = MXORDP1 = 6. Real fields share one dtype, but
    ``lu``: float32 under ``ls_precision`` "single" or "refined" on the
    dense and band paths (:func:`ls_store_dtype`)."""

    # --- BDF history and coefficients (reference src/lib.rs:104-116) ---
    phi: torch.Tensor  # [K1, N] divided differences
    psi: torch.Tensor  # [K1]
    alpha: torch.Tensor  # [K1]
    beta: torch.Tensor  # [K1]
    sigma: torch.Tensor  # [K1]
    gamma: torch.Tensor  # [K1]

    # --- work vectors (reference src/lib.rs:118-126, src/ida_nls.rs:25-39) ---
    ee: torch.Tensor  # [N] accumulated corrections / local error estimate
    yy: torch.Tensor  # [N]
    yp: torch.Tensor  # [N]
    yypredict: torch.Tensor  # [N]
    yppredict: torch.Tensor  # [N]
    ewt: torch.Tensor  # [N] error weights
    savres: torch.Tensor  # [N] saved residual

    # --- step data (reference src/lib.rs:140-194) ---
    tn: torch.Tensor  # current internal time
    hh: torch.Tensor  # current step size
    hused: torch.Tensor  # step size of last successful step
    rr: torch.Tensor  # hnext / hused
    h0u: torch.Tensor  # actual initial step size
    tretlast: torch.Tensor  # last tret returned
    tolsf: torch.Tensor  # tolerance scale factor
    kk: torch.Tensor  # int32 current order
    kused: torch.Tensor  # int32 order of last successful step
    knew: torch.Tensor  # int32 proposed order after decrease decision
    phase: torch.Tensor  # int32 0 = startup (raise order, double h)
    ns: torch.Tensor  # int32 steps at constant h and k

    # --- nonlinear-solver state (reference src/ida_nls.rs:41-48) ---
    cj: torch.Tensor
    cjlast: torch.Tensor
    cjold: torch.Tensor
    cjratio: torch.Tensor
    ss: torch.Tensor
    oldnrm: torch.Tensor
    eps_newt: torch.Tensor
    toldel: torch.Tensor

    # --- linear-solver state (reference src/ida_ls.rs:22-31) ---
    lu: torch.Tensor  # [N, N] factored J (dense; band [2*ml+mu+1, N]; [0, 0] under spgmr);
    #                   float32 under the mixed-precision modes
    piv: torch.Tensor  # [N] int32 pivots (dense; band row offsets; [0] under spgmr)
    pdata: object  # preconditioner state: a tuple of tensors, () without one
    ls_tn: torch.Tensor  # [] time of the last lsetup (refined mode only)
    ls_cj: torch.Tensor  # [] cj of the last lsetup (refined mode only)
    ls_yy: torch.Tensor  # [N] y of the last lsetup ([0] unless refined)
    ls_yp: torch.Tensor  # [N] y' of the last lsetup ([0] unless refined)

    # --- per-lane options ---
    hin: torch.Tensor  # initial step (0 = auto)
    hmax_inv: torch.Tensor  # 1/hmax (0 = unlimited)
    epcon: torch.Tensor  # Newton convergence constant
    tstop: torch.Tensor  # stop time (meaningful iff tstop_set)
    tstop_set: torch.Tensor  # bool
    constraints: torch.Tensor  # [N] inequality constraint codes (0 = none)
    constraints_set: torch.Tensor  # bool

    # --- counters (reference src/lib.rs:71-84, ida_ls.rs:44-59), int64 ---
    nst: torch.Tensor  # steps
    nre: torch.Tensor  # residual evaluations
    ncfn: torch.Tensor  # nonlinear convergence failures
    netf: torch.Tensor  # error test failures
    nni: torch.Tensor  # Newton iterations
    nsetups: torch.Tensor  # lsetup calls
    nje: torch.Tensor  # Jacobian evaluations
    nge: torch.Tensor  # root function evaluations
    nli: torch.Tensor  # linear (Krylov) iterations
    nps: torch.Tensor  # preconditioner solves
    ncfl: torch.Tensor  # linear convergence failures
    njtsetup: torch.Tensor  # jtimes-setup calls
    njtimes: torch.Tensor  # Jacobian-vector products

    # --- rootfinding (reference src/lib.rs:196-231) ---
    tlo: torch.Tensor
    thi: torch.Tensor
    trout: torch.Tensor
    ttol: torch.Tensor
    toutc: torch.Tensor
    glo: torch.Tensor  # [R]
    ghi: torch.Tensor  # [R]
    grout: torch.Tensor  # [R]
    iroots: torch.Tensor  # [R] int32
    rootdir: torch.Tensor  # [R] int32
    gactive: torch.Tensor  # [R] bool
    irfnd: torch.Tensor  # bool
    taskc: torch.Tensor  # int32 saved itask

    # --- quadrature accumulator ---
    yQ: torch.Tensor  # [max(nquad, 1)] running integral of quad() from t0 to tn

    # --- outcome lane (replaces Rust Result) ---
    status: torch.Tensor  # int32, constants.CONTINUE while stepping

    @property
    def dtype(self) -> torch.dtype:
        return self.phi.dtype


def ls_store_dtype(opts: IdaOptions, dtype: torch.dtype) -> torch.dtype:
    """The direct solvers' factor storage dtype: float32 under the
    mixed-precision modes (the float32 factor's image is exact), else the
    state's."""
    if opts.linear_solver in ("dense", "band") and opts.ls_precision in ("single", "refined"):
        return torch.float32
    return dtype


def init_state(
    problem: IdaProblem,
    yy0,
    yp0,
    *,
    device=None,
    dtype: torch.dtype = torch.float64,
    opts: IdaOptions = IdaOptions(),
) -> IdaState:
    """Initial state (reference ``Ida::new``, src/lib.rs:278-405): phi[0] = y0,
    phi[1] = y'0, defaults elsewhere. ``yy0``/``yp0`` are [N] for one lane or
    [*batch, N] for a batch-leading ensemble (every field then gains the
    leading ``batch`` axes). ``opts`` sizes the linear-solver workspace: the
    dense factor [N, N] and pivots [N], the band factor [2*ml+mu+1, N] and
    pivots [N] (factors in :func:`ls_store_dtype`), the refined mode's
    linearization point ``ls_yy``/``ls_yp`` [N] ([0] in the other modes), or
    nothing ([0, 0], [0]) under spgmr, whose
    preconditioner state ``pdata`` starts as the problem's
    ``prec_zero()`` (each leaf in the state's dtype, on its device). ``device``
    None is the current CUDA device (raises when there is none)."""
    device = resolve_device(device)
    n = problem.n
    yy0 = torch.as_tensor(yy0, dtype=dtype, device=device)
    yp0 = torch.as_tensor(yp0, dtype=dtype, device=device)
    if yy0.shape[-1:] != (n,) or yp0.shape != yy0.shape:
        raise ValueError(f"yy0/yp0 must be [..., {n}], got {tuple(yy0.shape)}, {tuple(yp0.shape)}")
    b = tuple(yy0.shape[:-1])
    r = max(problem.nroots, 1)

    def full(shape, value, dt=dtype):
        return torch.full(b + tuple(shape), value, dtype=dt, device=device)

    zero = full((), 0.0)
    zeros_k1 = full((C.MXORDP1,), 0.0)
    zeros_n = full((n,), 0.0)
    phi = torch.cat([yy0.unsqueeze(-2), yp0.unsqueeze(-2), full((C.MXORDP1 - 2, n), 0.0)], dim=-2)
    if opts.linear_solver == "dense":
        lu_shape, npiv = (n, n), n
    elif opts.linear_solver == "band":
        lu_shape, npiv = (2 * opts.band_ml + opts.band_mu + 1, n), n
    else:
        lu_shape, npiv = (0, 0), 0
    n_ls = n if opts.ls_precision == "refined" else 0
    pdata = ()
    if problem.prec_setup is not None:
        pdata = tuple(
            x.to(device=device, dtype=dtype if x.is_floating_point() else x.dtype)
            .expand(b + tuple(x.shape)).clone()
            for x in problem.prec_zero()
        )
    i32, i64 = torch.int32, torch.int64
    return IdaState(
        phi=phi, psi=zeros_k1, alpha=zeros_k1, beta=zeros_k1, sigma=zeros_k1, gamma=zeros_k1,
        ee=zeros_n, yy=yy0, yp=yp0, yypredict=zeros_n, yppredict=zeros_n, ewt=zeros_n,
        savres=zeros_n,
        tn=zero, hh=zero, hused=zero, rr=zero, h0u=zero, tretlast=zero, tolsf=full((), 1.0),
        kk=full((), 0, i32), kused=full((), 0, i32), knew=full((), 0, i32),
        phase=full((), 0, i32), ns=full((), 0, i32),
        cj=zero, cjlast=zero, cjold=zero, cjratio=zero, ss=zero, oldnrm=zero,
        eps_newt=zero, toldel=zero,
        lu=full(lu_shape, 0.0, ls_store_dtype(opts, dtype)), piv=full((npiv,), 0, i32),
        pdata=pdata, ls_tn=zero, ls_cj=zero, ls_yy=full((n_ls,), 0.0), ls_yp=full((n_ls,), 0.0),
        hin=zero, hmax_inv=full((), C.HMAX_INV_DEFAULT), epcon=full((), C.EPCON),
        tstop=zero, tstop_set=full((), False, torch.bool), constraints=zeros_n,
        constraints_set=full((), False, torch.bool),
        nst=full((), 0, i64), nre=full((), 0, i64), ncfn=full((), 0, i64),
        netf=full((), 0, i64), nni=full((), 0, i64), nsetups=full((), 0, i64),
        nje=full((), 0, i64), nge=full((), 0, i64), nli=full((), 0, i64),
        nps=full((), 0, i64), ncfl=full((), 0, i64), njtsetup=full((), 0, i64),
        njtimes=full((), 0, i64),
        tlo=zero, thi=zero, trout=zero, ttol=zero, toutc=zero,
        glo=full((r,), 0.0), ghi=full((r,), 0.0), grout=full((r,), 0.0),
        iroots=full((r,), 0, i32), rootdir=full((r,), 0, i32),
        # C IDA semantics: roots start active
        gactive=full((r,), True, torch.bool),
        irfnd=full((), False, torch.bool), taskc=full((), 0, i32),
        yQ=full((max(problem.nquad, 1),), 0.0),
        status=full((), C.CONTINUE, i32),
    )
