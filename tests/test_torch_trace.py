"""The port's per-attempt data trace (``utils/trace.py`` and the hook in
``core.step.attempt_once``) against the JAX package's: the same run, traced
in both, gives the same number of records with the same fields; integer
fields agree exactly and the well-conditioned floats to rtol 1e-9 (the JAX
run is jitted, so residuals, Newton rates and high divided differences,
which are differences of nearly equal terms, agree only in shape)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ida_tpu
from ida_tpu.core.state import IdaOptions as JOptions
from ida_tpu.models import ROBERTS_YP0, ROBERTS_YY0
from ida_tpu.models import roberts_problem as jroberts_problem
from ida_tpu.tol_control import tol_sv as jtol_sv
from ida_tpu.utils import trace as jtrace
from ida_tpu_torch import IDA, IdaOptions, constants as C
from ida_tpu_torch.core.state import init_state
from ida_tpu_torch.models import roberts_factory, roberts_problem
from ida_tpu_torch.ops import make_fused_solve
from ida_tpu_torch.parallel import EnsembleIDA
from ida_tpu_torch.tol_control import tol_sv
from ida_tpu_torch.utils import trace as ttrace

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

ATOL = np.array([1e-8, 1e-6, 1e-6])
INT_FIELDS = ("kk", "kused", "knew", "phase", "ns", "nst", "nre", "ncfn", "netf", "nni", "nsetups",
              "nje", "nge", "piv", "iroots", "gactive", "irfnd", "tstop_set", "status")
CLOSE_FIELDS = ("tn", "hh", "hused", "h0u", "tretlast", "psi", "alpha", "beta", "sigma", "gamma",
                "cj", "cjlast", "ewt", "yypredict", "tlo", "glo")


def _port_ida(**kw):
    return IDA(roberts_problem(device="cpu"), ROBERTS_YY0, ROBERTS_YP0,
               tol_sv(1e-4, ATOL, device="cpu"), IdaOptions(debug_trace=True), device="cpu", **kw)


@pytest.fixture(scope="module")
def traces():
    jida = ida_tpu.IDA(jroberts_problem(), ROBERTS_YY0, ROBERTS_YP0, jtol_sv(1e-4, jnp.asarray(ATOL)),
                       JOptions(debug_trace=True))
    with jtrace.DataTrace() as jt:
        jida.solve(0.4)
        jida.solve(0.4)
    tida = _port_ida()
    with ttrace.DataTrace() as tt:
        tida.solve(0.4)
        tida.solve(0.4)
    return jt.records, tt.records, tida


def test_trace_fields_are_the_jax_package_s():
    assert ttrace.TRACE_FIELDS == jtrace.TRACE_FIELDS
    assert set(ttrace.TRACE_FIELDS) <= set(init_state(
        roberts_problem(device="cpu"), ROBERTS_YY0, ROBERTS_YP0, device="cpu")._fields)


def test_one_record_per_attempt_with_a_schema_version(traces):
    jrecs, trecs, tida = traces
    attempts = (tida.get_num_steps() + tida.get_num_err_test_fails()
                + tida.get_num_nonlin_solv_conv_fails())
    assert len(trecs) == len(jrecs) == attempts
    for rec in trecs:
        assert rec["schema"] == ttrace.TRACE_SCHEMA == 1
        assert set(rec) == set(ttrace.TRACE_FIELDS) | {"schema"}
    assert [r["nst"] for r in trecs] == sorted(r["nst"] for r in trecs)


def test_records_match_the_jax_trace(traces):
    jrecs, trecs, _ = traces
    for k, (jr, tr) in enumerate(zip(jrecs, trecs)):
        for f in ttrace.TRACE_FIELDS:
            a, b = np.asarray(tr[f], dtype=np.float64), np.asarray(jr[f], dtype=np.float64)
            assert a.shape == b.shape, (k, f)
            if f in INT_FIELDS:
                np.testing.assert_array_equal(a, b, err_msg=f"record {k}: {f}")
            elif f in CLOSE_FIELDS:
                np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-300, err_msg=f"record {k}: {f}")
    # scalars are floats, vectors lists, as the JAX emitter writes them
    assert isinstance(trecs[0]["tn"], float) and isinstance(trecs[0]["nst"], float)
    assert isinstance(trecs[0]["phi"], list) and len(trecs[0]["phi"]) == C.MXORDP1


def test_trace_file_is_json_lines(tmp_path):
    path = tmp_path / "trace.jsonl"
    ida = _port_ida()
    with ttrace.DataTrace(str(path)) as tt:
        ida.solve(0.01)
    lines = path.read_text().splitlines()
    assert len(lines) == len(tt.records) > 0
    assert json.loads(lines[-1]) == tt.records[-1]
    assert tt._fh is None


def test_no_collector_no_records_and_same_result():
    traced, plain = _port_ida(), IDA(roberts_problem(device="cpu"), ROBERTS_YY0, ROBERTS_YP0,
                                     tol_sv(1e-4, ATOL, device="cpu"), device="cpu")
    assert traced.solve(0.4) == plain.solve(0.4)  # outside a DataTrace block: dropped
    assert ttrace._collector is None
    for f in ("phi", "nst", "nge", "tlo"):
        assert torch.equal(getattr(traced.state, f), getattr(plain.state, f)), f


def test_batched_records_carry_the_batch_shape():
    params = np.outer([0.9, 1.0, 1.1], [0.04, 1.0e4, 3.0e7])
    yy0 = np.tile(ROBERTS_YY0, (3, 1))
    ens = EnsembleIDA(roberts_factory, params, yy0, params[:, :1] * np.array([-1.0, 1.0, 0.0]),
                      tol_sv(1e-4, ATOL, device="cpu"), IdaOptions(debug_trace=True), device="cpu")
    with ttrace.DataTrace() as tt:
        ens.solve(0.001)
    assert np.asarray(tt.records[0]["phi"]).shape == (C.MXORDP1, 3, 3)
    assert np.asarray(tt.records[0]["tn"]).shape == (3,)


def test_the_fused_kernel_refuses_to_trace():
    with pytest.raises(ValueError, match="debug_trace"):
        make_fused_solve(roberts_factory, tol_sv(1e-4, ATOL, device="cpu"), IdaOptions(debug_trace=True))
