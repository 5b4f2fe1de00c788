"""Quadratures (``ida_tpu_torch.core.quad``, ``IDA.get_quad``) and
checkpoints (``ida_tpu_torch.utils.checkpoint``) against ``ida_tpu``.

Quadratures: tests/test_quadrature.py's conserved, augmented, batched and
out-of-window cases on the port, its quadratures beside the jitted JAX
solve's (counters exactly, integrals to 1e-9 relative: XLA:CPU contracts
multiply-adds), ``get_quad`` on one state bit for bit ``ida_tpu``'s run op
by op, and a solve with quadratures bit for bit the solve without them in
every field but ``yQ``. Checkpoints: the same archive format both ways (a
state saved by either package loads into the other, field for field and
dtype for dtype), a resumed solve bit for bit the uninterrupted one, and
tests/test_checkpoint.py's pdata trees, guards and legacy archives.
"""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ida_tpu as jida
from ida_tpu.models import roberts_factory as jax_roberts_factory
from ida_tpu.models import roberts_problem as jax_roberts
from ida_tpu.utils import checkpoint as jax_ck
import ida_tpu_torch as port
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory, roberts_problem
from ida_tpu_torch.parallel import ensemble_init, make_ensemble_solve
from ida_tpu_torch.tol_control import tol_sv
from ida_tpu_torch.utils import checkpoint as ck
from ida_tpu_torch.utils.convert import state_fields

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

RTOL = 1e-6
ATOL = [1e-10, 1e-8, 1e-8]
YP0 = np.array([-0.04, 0.04, 0.0])
TOUTS = (0.4, 4.0, 40.0)


def _total(t, yy, yp):
    return (yy[0] + yy[1] + yy[2]).unsqueeze(0)


def _port_quad_ida(quad=_total, nquad=1):
    prob = dataclasses.replace(roberts_factory(torch.from_numpy(ROBERTS_PARAMS)), quad=quad,
                               nquad=nquad)
    return port.IDA(prob, ROBERTS_YY0, YP0, tol_sv(RTOL, ATOL, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def jax_quads():
    """The jitted JAX solve with quadratures [y1 + y2 + y3, y1, y3] over
    TOUTS: (tret, get_quad, counters) at each, and the final state."""
    prob = dataclasses.replace(
        jax_roberts_factory(jnp.asarray(ROBERTS_PARAMS)),
        quad=lambda t, yy, yp: jnp.stack([yy[0] + yy[1] + yy[2], yy[0], yy[2]]), nquad=3)
    ida = jida.IDA(prob, ROBERTS_YY0, YP0, jida.tol_sv(RTOL, jnp.asarray(ATOL)))
    rows = []
    for tout in TOUTS:
        tret, _ = ida.solve(tout)
        rows.append((float(tret), np.asarray(ida.get_quad()), ida.get_num_steps(),
                     ida.get_num_res_evals()))
    return rows, ida.state, prob


def _quad_factory(p):
    return dataclasses.replace(roberts_factory(p), quad=_total, nquad=1)


# ------------------------------------------------------------------ checkpoints


def _port_ida():
    return port.IDA(roberts_problem(with_roots=False, device="cpu"), ROBERTS_YY0,
                    np.array([-0.04, 0.04, 0.0]), tol_sv(1e-4, [1e-8, 1e-6, 1e-6], device="cpu"),
                    device="cpu")


def _jax_ida():
    return jida.IDA(jax_roberts(with_roots=False), ROBERTS_YY0, np.array([-0.04, 0.04, 0.0]),
                    jida.tol_sv(1e-4, jnp.array([1e-8, 1e-6, 1e-6])))


def _fields_equal(st_port, arrays: dict) -> list:
    """Fields of a port state that differ (value or dtype) from numpy arrays."""
    bad = []
    for f in st_port._fields:
        if f == "pdata":
            continue
        x, want = getattr(st_port, f).numpy(), np.asarray(arrays[f])
        if x.dtype != want.dtype or not np.array_equal(x, want):
            bad.append(f)
    return bad


def test_resume_from_a_checkpoint_is_bit_identical(tmp_path):
    # tests/test_checkpoint.py: a solve resumed from an archive written
    # after the first decade ends where the uninterrupted one does
    straight = _port_ida()
    straight.solve(0.4)
    straight.solve(4.0)
    first = _port_ida()
    first.solve(0.4)
    ck.save_state(str(tmp_path / "ck.npz"), first.state)
    resumed = _port_ida()
    resumed.state = ck.load_state(str(tmp_path / "ck.npz"), device="cpu")
    resumed.solve(4.0)
    assert _fields_equal(resumed.state, {f: getattr(straight.state, f).numpy()
                                         for f in straight.state._fields if f != "pdata"}) == []


def test_an_ida_tpu_checkpoint_loads_into_the_port(tmp_path):
    ida = _jax_ida()
    ida.solve(0.4)
    path = str(tmp_path / "jax.npz")
    jax_ck.save_state(path, ida.state)
    st = ck.load_state(path, device="cpu")
    assert _fields_equal(st, state_fields(ida.state)) == [] and st.pdata == ()
    mine = _port_ida()
    mine.state = st
    assert mine.solve(4.0)[1] == port.IdaSolveStatus.Success


def test_a_port_checkpoint_loads_into_ida_tpu(tmp_path):
    # the port's state after one decade, saved, loaded by ida_tpu and
    # continued there: the same steps as the port's own continuation
    mine = _port_ida()
    mine.solve(0.4)
    path = str(tmp_path / "port.npz")
    ck.save_state(path, mine.state)
    st = jax_ck.load_state(path)
    assert _fields_equal(mine.state, state_fields(st)) == []
    ida = _jax_ida()
    ida.state = st
    ida.solve(4.0)
    mine.solve(4.0)
    assert ida.get_num_steps() == mine.get_num_steps()
    np.testing.assert_allclose(np.asarray(ida.get_yy()), mine.get_yy(), rtol=1e-9, atol=1e-20)


def test_a_batched_checkpoint_round_trips_both_ways(tmp_path):
    # four lanes, batch-leading, with a preconditioner state in pdata
    params = np.tile(ROBERTS_PARAMS, (4, 1)) * np.array([1.0, 1.1, 0.9, 1.05])[:, None]
    st = ensemble_init(roberts_factory, params, np.tile(ROBERTS_YY0, (4, 1)),
                       params[:, :1] * np.array([-1.0, 1.0, 0.0]), device="cpu")
    st, _, _ = make_ensemble_solve(roberts_factory)(st, params, tol_sv(1e-4, [1e-8, 1e-6, 1e-6],
                                                                       device="cpu"), 0.4)
    st = st._replace(pdata=(torch.arange(12.0).reshape(4, 3), torch.ones(4, 2, dtype=torch.int32)))
    path = str(tmp_path / "ens.npz")
    ck.save_state(path, st)
    back = ck.load_state(path, device="cpu")
    jst = jax_ck.load_state(path)
    assert tuple(back.nst.shape) == (4,) and tuple(jst.nst.shape) == (4,)
    for f in st._fields:
        if f != "pdata":
            assert torch.equal(getattr(back, f), getattr(st, f)), f
            assert np.array_equal(np.asarray(getattr(jst, f)), getattr(st, f).numpy()), f
    assert all(torch.equal(a, b) for a, b in zip(back.pdata, st.pdata))
    assert all(np.array_equal(np.asarray(a), b.numpy()) for a, b in zip(jst.pdata, st.pdata))


def test_pdata_trees_round_trip_between_the_packages(tmp_path):
    # a dict with a nested tuple and a None (tests/test_checkpoint.py): each
    # package reads the other's archive into the same tree
    ida = _jax_ida()
    ida.solve(0.4)
    tree = {"diag": np.arange(3.0), "nested": (np.ones(2), None, np.zeros((2, 2)))}
    ida.state = ida.state._replace(pdata=jax.tree_util.tree_map(jnp.asarray, tree))
    jax_path = str(tmp_path / "jax.npz")
    jax_ck.save_state(jax_path, ida.state)
    got = ck.load_state(jax_path, device="cpu").pdata
    assert isinstance(got, dict) and got["nested"][1] is None
    assert np.array_equal(got["diag"].numpy(), tree["diag"])
    assert np.array_equal(got["nested"][2].numpy(), tree["nested"][2])

    mine = _port_ida()
    mine.solve(0.4)
    mine.state = mine.state._replace(pdata=jax.tree_util.tree_map(torch.from_numpy, tree))
    port_path = str(tmp_path / "port.npz")
    ck.save_state(port_path, mine.state)
    back = jax_ck.load_state(port_path).pdata
    assert isinstance(back, dict) and back["nested"][1] is None
    assert np.array_equal(np.asarray(back["nested"][0]), tree["nested"][0])
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert json.loads(a[ck._META_KEY].tobytes()) == json.loads(b[ck._META_KEY].tobytes())

    mine.state = mine.state._replace(pdata={1: torch.ones(2)})
    with pytest.raises(TypeError, match="string keys"):
        ck.save_state(str(tmp_path / "bad.npz"), mine.state)
    with pytest.raises(ValueError, match="unknown checkpoint tree node"):
        ck._decode_skeleton({"t": "mystery"}, [])


def _rewrite_npz(src, dst, drop=(), add=None):
    with np.load(str(src)) as data:
        arrays = {k: data[k] for k in data.files if k not in drop}
    arrays.update(add or {})
    np.savez(str(dst), **arrays)


def test_pickled_and_older_archives(tmp_path):
    # a version-2 archive (a pickled JAX treedef) is refused unless
    # allow_pickle, and then read without unpickling, as its flat leaves; a
    # version-1 archive as a flat tuple; one without yQ or the refined-mode
    # fields gets their defaults in its batch layout (batch-native here)
    ida = _jax_ida()
    ida.solve(0.4)
    pdata = (jnp.arange(3.0), jnp.ones(2))
    ida.state = ida.state._replace(pdata=pdata)
    v3 = tmp_path / "v3.npz"
    jax_ck.save_state(str(v3), ida.state)
    _, treedef = jax.tree_util.tree_flatten(pdata)
    v2 = tmp_path / "v2.npz"
    meta2 = {"version": 2, "pdata_leaves": ["pdata_0", "pdata_1"]}
    _rewrite_npz(v3, v2, drop=(ck._META_KEY,), add={
        ck._META_KEY: np.frombuffer(json.dumps(meta2).encode(), dtype=np.uint8),
        ck._PDATA_TREEDEF_KEY: np.frombuffer(pickle.dumps(treedef), dtype=np.uint8)})
    with pytest.raises(ValueError, match="pickle"):
        ck.load_state(str(v2), device="cpu")
    got = ck.load_state(str(v2), allow_pickle=True, device="cpu").pdata
    assert isinstance(got, tuple) and len(got) == 2
    assert np.array_equal(got[0].numpy(), np.arange(3.0))
    v1 = tmp_path / "v1.npz"
    _rewrite_npz(v3, v1, drop=(ck._META_KEY,), add={ck._META_KEY: np.frombuffer(
        json.dumps({"version": 1, "pdata_leaves": ["pdata_0"]}).encode(), dtype=np.uint8)})
    assert len(ck.load_state(str(v1), device="cpu").pdata) == 1

    native = jax.tree_util.tree_map(lambda x: jnp.moveaxis(jnp.stack([x] * 3), 0, -1),
                                    ida.state._replace(pdata=()))
    full = tmp_path / "native.npz"
    jax_ck.save_state(str(full), native)
    legacy = tmp_path / "legacy.npz"
    _rewrite_npz(full, legacy, drop=("yQ", "ls_tn", "ls_cj", "ls_yy", "ls_yp"))
    st = ck.load_state(str(legacy), device="cpu")
    assert tuple(st.yQ.shape) == (1, 3) and tuple(st.ls_yy.shape) == (0, 3)
    assert tuple(st.ls_tn.shape) == tuple(st.tn.shape) == (3,)
