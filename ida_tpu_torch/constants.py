"""Algorithmic constants of the IDA method.

Values mirror the reference implementation (reference ``src/constants.rs:1-31``),
which in turn mirrors SUNDIALS ``ida_impl.h``. These are compile-time (trace-time)
Python constants; they never appear as traced values.
"""

# --- integrator defaults (reference src/constants.rs:1-8) ---
HMAX_INV_DEFAULT = 0.0
MAXORD_DEFAULT = 5
MXORDP1 = 6  # number of vectors in the phi history array
MXSTEP_DEFAULT = 500

# --- algorithmic constants (reference src/constants.rs:10-31) ---
MXNCF = 10  # max convergence failures per step attempt loop
MXNEF = 10  # max error-test failures per step attempt loop
MAXNH = 5  # max h tries in IC calculation
MAXNJ = 4  # max J tries in IC calculation
MAXNI = 10  # max Newton iterations in IC calculation
EPCON = 0.33  # Newton convergence test constant
MAXBACKS = 100  # max backtracks per Newton step in IDACalcIC
ALPHA_LS = 1.0e-4  # Armijo sufficient-decrease constant (C ida_ic.c ALPHA)
XRATE = 0.25  # cj-ratio threshold for Jacobian/preconditioner refresh

MAXNLSIT = 4  # default max nonlinear (Newton) iterations per step attempt

# --- nonlinear solver (reference src/ida_nls.rs:15) ---
RATEMAX = 0.9  # max convergence rate used in divergence check

# --- status codes -----------------------------------------------------------
# The reference communicates outcomes via Rust Result/enum types
# (reference src/error.rs:3-126, src/lib.rs:57-63). In a traced, batched
# solver those become integer status lanes. Non-negative: normal returns.
# Negative: failures, mirroring the IDA C return-code taxonomy.
CONTINUE = 99  # internal: keep stepping (IdaSolveStatus::ContinueSteps)
SUCCESS = 0
TSTOP_RETURN = 1
ROOT_RETURN = 2

TOO_MUCH_WORK = -1
TOO_MUCH_ACC = -2
ERR_FAIL = -3
CONV_FAIL = -4
LINIT_FAIL = -5
LSETUP_FAIL = -6
LSOLVE_FAIL = -7
RES_FAIL = -8
REP_RES_ERR = -9
RTFUNC_FAIL = -10
CONSTR_FAIL = -11
BAD_EWT = -13
ILL_INPUT = -22
BAD_K = -25
BAD_T = -26
CLOSE_ROOTS = -50  # not a C IDA code; reference IdaError::CloseRoots

# recoverable-failure kinds carried inside the nonlinear solve
# (reference src/error.rs:3-15 `Recoverable::{Residual,LSetup,LSolve,Constraint}`)
REC_NONE = 0
REC_CONV = 1  # Newton failed to converge (SUN_NLS_CONV_RECVR)
REC_RESIDUAL = 2
REC_LSETUP = 3
REC_LSOLVE = 4
REC_CONSTRAINT = 5
ERROR_TEST_FAIL = 6  # not recoverable-kind per se; used in handle_n_flag

STATUS_NAMES = {
    CONTINUE: "CONTINUE",
    SUCCESS: "SUCCESS",
    TSTOP_RETURN: "TSTOP_RETURN",
    ROOT_RETURN: "ROOT_RETURN",
    TOO_MUCH_WORK: "TOO_MUCH_WORK",
    TOO_MUCH_ACC: "TOO_MUCH_ACC",
    ERR_FAIL: "ERR_FAIL",
    CONV_FAIL: "CONV_FAIL",
    LINIT_FAIL: "LINIT_FAIL",
    LSETUP_FAIL: "LSETUP_FAIL",
    LSOLVE_FAIL: "LSOLVE_FAIL",
    RES_FAIL: "RES_FAIL",
    REP_RES_ERR: "REP_RES_ERR",
    RTFUNC_FAIL: "RTFUNC_FAIL",
    CONSTR_FAIL: "CONSTR_FAIL",
    BAD_EWT: "BAD_EWT",
    ILL_INPUT: "ILL_INPUT",
    BAD_K: "BAD_K",
    BAD_T: "BAD_T",
    CLOSE_ROOTS: "CLOSE_ROOTS",
}


def not_ported(what: str, item: int, module: str) -> NotImplementedError:
    """The error every entry point raises for a feature of ``ida_tpu`` that
    this port does not have yet: it names the ROADMAP.md Queue 1 item (and
    the ``ida_tpu`` module) whose port lifts it."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1 item {item}, {module})"
    )
