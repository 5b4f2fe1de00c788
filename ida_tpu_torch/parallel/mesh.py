"""Device meshes over ``torch.distributed``: ensembles and state vectors
sharded over ranks.

Port of ``ida_tpu/parallel/mesh.py``. JAX's mesh is single-controller: one
process sees every device and GSPMD inserts the collectives. The port is
SPMD, PyTorch's idiom: one process a device under a process group, a
``torch.distributed.device_mesh.DeviceMesh`` naming the axes. Every rank
calls the same entry with the same full inputs and keeps its own shard. The
shards are plain local tensors, and every step that crosses shards is an
explicit collective, all of them in :func:`gather`:

* it counts its calls, broadcasts and bytes (``COLLECTIVES``), so a test or
  the smoke run can show that a data-parallel solve makes none;
* it is one ``broadcast`` from each rank of the group, which both backends
  carry for CUDA tensors (gloo takes only ``broadcast`` and ``all_reduce``
  for them, and NCCL refuses two ranks on one card), and which keeps every
  bit (a sum into zero-filled buffers would turn -0.0 into +0.0).

Two kinds of sharding, as in ``ida_tpu``:

* **lanes** (data parallelism): :func:`shard_ensemble` keeps the rank's
  contiguous slice of a batch-leading ensemble. Each rank solves its lanes
  alone, with no collective, and loops until its own lanes finish
  (``EnsembleIDA(mesh=...)``).
* **the state vector** (the tensor-parallel analogue):
  :func:`shard_state_vector` (one system) and :func:`shard_ensemble_2d` (a
  batch-native ensemble over a batch x state mesh) keep the rank's rows of
  the fields that carry N; :func:`sharded_solve` runs the core on them and
  :func:`sharded_calc_ic` the consistent initial conditions. The reductions
  over N cross ranks (``utils/sharding.py``); the residual, J v, the root
  functions and the quadrature integrand see the gathered vectors (the
  first two return the rank's rows, the others their whole [R] / [nquad]
  outputs, the same on every rank); the preconditioner runs on the rank's
  own rows, points or blocks where the problem says where they lie in
  ``pdata`` (``IdaProblem.pdata_rows``: heat2d's diagonal, the food web's
  blocks, the blocked BBD of ``ops/bbd.py``), and on the gathered vectors
  otherwise, its ``pdata`` whole on every rank (as under ``ida_tpu``'s
  GSPMD). Every feature of ``core.solve`` runs there but the direct
  solvers, whose [N, N] or banded Jacobian ``ida_tpu`` keeps on one device
  (ROADMAP.md item 12).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..constants import not_ported
from ..core.calc_ic import IC_CODES
from ..core.calc_ic import calc_ic as core_calc_ic
from ..core.solve import TASK_NORMAL
from ..core.solve import solve as core_solve
from ..core.state import IdaOptions, IdaState
from ..problem import IdaProblem
from ..tol_control import TolControl
from ..utils import sharding

# what gather() moved since the last reset: calls, broadcasts, and the
# bytes each rank received
COLLECTIVES = {"calls": 0, "broadcasts": 0, "bytes": 0}


def reset_collective_counts() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def _device_type(device_type: str | None) -> str:
    if device_type is not None:
        return device_type
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a mesh is made over the cards by default; pass "
            "device_type=\"cpu\" to make one over CPU processes")
    return "cuda"


def _world(n: int | None, device_type: str) -> int:
    """The number of ranks a mesh of ``n`` devices takes (None: all). A
    world of one opens its own group; a larger mesh needs the caller's."""
    if not dist.is_initialized():
        if n not in (None, 1):
            raise ValueError(
                f"a mesh of {n} devices needs the caller's process group: start one process a "
                "device and call torch.distributed.init_process_group in each")
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n is None:
        return world
    if n > world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks; the process group has {world}")
    return n


def _device_mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(int(torch.tensor(shape).prod())).reshape(shape)
    if device_type == "cuda":
        # ranks beyond the cards share them (gloo: two ranks on one card)
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, axis: str = "batch", *, device_type: str | None = None):
    """A 1-D mesh over the first ``n_devices`` ranks of the process group
    (all of them for None), its axis named ``axis``. ``device_type`` None is
    "cuda", each rank on ``cuda:<local rank>`` (modulo the cards), and
    raises without CUDA; tests pass "cpu". A mesh of one opens its own
    process group when there is none (NCCL on the card, gloo on the CPU)."""
    device_type = _device_type(device_type)
    return _device_mesh(device_type, (_world(n_devices, device_type),), (axis,))


def make_mesh_2d(n_batch: int, n_state: int, axes=("batch", "state"), *,
                 device_type: str | None = None):
    """A 2-D (batch x state) mesh over the first ``n_batch * n_state``
    ranks: ensemble lanes split over one axis, each lane's state vector over
    the other (ranks in row-major order)."""
    device_type = _device_type(device_type)
    _world(n_batch * n_state, device_type)
    return _device_mesh(device_type, (n_batch, n_state), tuple(axes))


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _dim(mesh, axis: str) -> int:
    return mesh.mesh_dim_names.index(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(_dim(mesh, axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return coord[_dim(mesh, axis)]


def gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The port's one collective: the concatenation along ``dim`` of ``x``
    over the ranks of ``axis`` (in their order along it), on each of them.
    Every rank passes a tensor of the same shape and dtype. One broadcast
    from each rank of the group; a group of one returns ``x``."""
    size = axis_size(mesh, axis)
    if size == 1:
        return x
    d = _dim(mesh, axis)
    coord = list(mesh.get_coordinate())
    members = []
    for j in range(size):
        coord[d] = j
        members.append(int(mesh.mesh[tuple(coord)]))
    group = mesh.get_group(d)
    wire = x.contiguous()
    if wire.dtype == torch.bool:  # not every backend carries bool
        wire = wire.to(torch.uint8)
    me = dist.get_rank()
    parts = []
    for src in members:
        buf = wire if src == me else torch.empty_like(wire)
        dist.broadcast(buf, src=src, group=group)
        parts.append(buf)
    COLLECTIVES["calls"] += 1
    COLLECTIVES["broadcasts"] += size
    COLLECTIVES["bytes"] += wire.numel() * wire.element_size() * (size - 1)
    return torch.cat(parts, dim=dim).to(x.dtype)


def _chunk(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``dim`` (a copy, so the
    full tensor can go)."""
    size = axis_size(mesh, axis)
    if x.shape[dim] % size:
        raise ValueError(
            f"axis {dim} of a {tuple(x.shape)} tensor does not divide over the {size} ranks "
            f"of mesh axis {axis!r}")
    m = x.shape[dim] // size
    return x.narrow(dim, axis_index(mesh, axis) * m, m).contiguous()


def map_tensors(x, fn):
    """``fn`` on every tensor of an IdaState, a tuple (pdata) or a tensor."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, IdaState):
        return IdaState(*(map_tensors(y, fn) for y in x))
    return tuple(map_tensors(y, fn) for y in x)


def shard_ensemble(states, mesh, axis: str = "batch"):
    """This rank's lanes of a batch-LEADING ensemble (an IdaState from
    ``ensemble_init``, or a tensor / tuple of them, such as params [B, P] or
    per-lane touts [B]): its contiguous slice of dim 0 on the rank's
    device. The batch must divide by the axis' size (ValueError)."""
    dev = mesh_device(mesh)
    return map_tensors(states, lambda x: _chunk(x.to(dev), mesh, axis, 0))


# IdaState fields that carry the system-size (N) axis: last axis in the
# single-instance layout, second-to-last in the batch-native layout (lu
# carries it twice: [N, N] / [N, N, B]). An EXPLICIT list, not a
# shape == n test: where N collides with another lane size (N == MXORDP1 ==
# 6 would match psi/alpha/..., N == nroots would match iroots/gactive), a
# shape test would cut coefficient or root lanes over the state axis.
# ``pdata`` is cut where its problem says (IdaProblem.pdata_rows), for the
# same reason: foodweb's [npts, 2, 2] has its rows first, and N == 2 would
# match its last axes.
_N_AXIS_FIELDS = frozenset({
    "phi", "ee", "yy", "yp", "yypredict", "yppredict", "ewt", "savres",
    "constraints", "piv", "lu",
})


def _pdata_cut(pdata: tuple, problem: IdaProblem | None, mesh, axis: str, n: int, bnd: int):
    """This rank's part of ``pdata`` (``bnd`` trailing batch axes, already
    cut): each leaf cut on its ``problem.pdata_rows`` axis, or every leaf
    whole where the preconditioner runs on gathered vectors."""
    if not pdata or (problem is not None and not problem.prec_local):
        return pdata
    if problem is None:
        raise ValueError("the state holds a preconditioner's pdata: pass problem= so its rows "
                         "can be cut (IdaProblem.pdata_rows)")
    if len(problem.pdata_rows) != len(pdata):
        raise ValueError(f"pdata_rows names {len(problem.pdata_rows)} leaves; pdata has "
                         f"{len(pdata)}")
    size = axis_size(mesh, axis)
    out = []
    for x, (ax, per) in zip(pdata, problem.pdata_rows):
        dim = x.dim() - bnd + ax
        if x.shape[dim] * per != n:
            raise ValueError(f"pdata_rows puts {per} rows an entry on axis {ax} of a "
                             f"{tuple(x.shape)} pdata leaf: its entries do not cover N = {n}")
        if n % size or (n // size) % per:
            raise ValueError(f"N = {n} over {size} ranks splits the preconditioner's entries of "
                             f"{per} rows: each rank must hold whole entries")
        out.append(_chunk(x, mesh, axis, dim))
    return tuple(out)


def _state_cut(states: IdaState, cut, pdata_cut) -> IdaState:
    """``cut(x, has_n)`` on every tensor of ``states``, then
    ``pdata_cut(pdata)``."""
    out = {}
    for name in states._fields:
        has_n = name in _N_AXIS_FIELDS
        out[name] = map_tensors(getattr(states, name), lambda x: cut(x, has_n))
    out["pdata"] = pdata_cut(out["pdata"])
    return IdaState(**out)


def shard_ensemble_2d(states: IdaState, mesh, n: int, batch_axis: str = "batch",
                      state_axis: str = "state", *, problem: IdaProblem | None = None
                      ) -> IdaState:
    """This rank's part of a BATCH-NATIVE (trailing-batch) ensemble over a
    2-D mesh: the trailing batch over ``batch_axis`` and, on the fields that
    carry N, the axis before it over ``state_axis`` (phi [K, N, B] ->
    [K, N/s, B/b], ewt [N, B] -> [N/s, B/b], per-lane scalars [B] ->
    [B/b]); ``pdata`` over the batch, and over ``state_axis`` where
    ``problem.pdata_rows`` puts its rows (``problem`` is needed when the
    state holds pdata). Solve it with :func:`sharded_solve` over
    ``state_axis``."""
    dev = mesh_device(mesh)

    def cut(x, has_n):
        x = x.to(dev)
        if x.dim() == 0:
            return x
        x = _chunk(x, mesh, batch_axis, x.dim() - 1)
        if has_n and x.dim() >= 2:
            x = _chunk(x, mesh, state_axis, x.dim() - 2)
        return x

    return _state_cut(states, cut,
                      lambda pdata: _pdata_cut(pdata, problem, mesh, state_axis, n, 1))


def shard_state_vector(states: IdaState, mesh, n: int, axis: str = "batch", *,
                       problem: IdaProblem | None = None) -> IdaState:
    """This rank's part of ONE large system's state (the tensor-parallel
    analogue): the fields that carry N cut on their last axis, ``pdata``
    where ``problem.pdata_rows`` puts its rows (whole for a preconditioner
    without them; ``problem`` is needed when the state holds pdata),
    everything else (scalars, BDF coefficients, root lanes) whole. Solve it
    with :func:`sharded_solve` (the Krylov path: the dense path's [N, N]
    Jacobian stays on one device)."""
    dev = mesh_device(mesh)

    def cut(x, has_n):
        x = x.to(dev)
        return _chunk(x, mesh, axis, x.dim() - 1) if has_n and x.dim() >= 1 else x

    return _state_cut(states, cut, lambda pdata: _pdata_cut(pdata, problem, mesh, axis, n, 0))


def _refuse(problem: IdaProblem, opts: IdaOptions) -> None:
    """What a state sharded over N cannot run: the direct solvers, whose
    Jacobian reads the whole state and which ``ida_tpu`` keeps on one
    device."""
    if opts.linear_solver != "spgmr":
        raise not_ported(f"linear_solver={opts.linear_solver!r} on a state sharded over N", 12,
                         "ida_tpu/parallel/mesh.py")


def _rows_problem(problem: IdaProblem) -> IdaProblem:
    """``problem`` on this rank's rows (inside ``sharding.use_mesh``): the
    residual and J v see the gathered vectors and return the rank's rows
    (bit for bit those of the unsharded call), the root functions and the
    quadrature integrand see them and return their whole outputs; the
    preconditioner hooks run on the rank's own rows where ``pdata_rows``
    places them, and on the gathered vectors otherwise (``pdata`` whole,
    the solve's result cut to the rank's rows). Each gather is made once a
    vector (``sharding.gather_rows`` keeps the last few by identity)."""
    rows = sharding.rows(problem.n)
    full = sharding.gather_rows

    def res(t, yy, yp):
        return problem.res(t, full(yy), full(yp))[rows]

    def jtimes_fn(jdata, t, cj, yy, yp, v):
        return problem.jtimes(t, cj, full(yy), full(yp), full(v), jdata)[rows]

    def whole_inputs(fn):
        return None if fn is None else (lambda t, yy, yp: fn(t, full(yy), full(yp)))

    jtimes_setup = None
    if problem.jtimes_setup is not None:
        def jtimes_setup(t, cj, yy, yp, rr):
            return problem.jtimes_setup(t, cj, full(yy), full(yp), full(rr))

    prec = {}
    if problem.prec_setup is not None and not problem.prec_local:
        def prec_setup(t, cj, yy, yp, rr):
            return problem.prec_setup(t, cj, full(yy), full(yp), full(rr))

        def prec_solve(pdata, r, cj):
            return problem.prec_solve(pdata, full(r), cj)[rows]

        prec = dict(prec_setup=prec_setup, prec_solve=prec_solve)

    return dataclasses.replace(
        problem, n=rows.stop - rows.start, res=res, jac=None,
        id=None if problem.id is None else problem.id[rows],
        jtimes_setup=jtimes_setup, jtimes_fn=jtimes_fn, root=whole_inputs(problem.root),
        quad=whole_inputs(problem.quad), **prec)


def _tol_rows(tol: TolControl, n: int) -> TolControl:
    """``tol`` with an atol that carries N ([N] or [N, *batch]) cut to this
    rank's rows."""
    atol = tol.atol
    if atol.dim() >= 1 and atol.shape[0] == n:
        atol = atol[sharding.rows(n)]
    return TolControl(rtol=tol.rtol, atol=atol)


def sharded_solve(states: IdaState, problem: IdaProblem, opts: IdaOptions, tol: TolControl, tout,
                  itask: int = TASK_NORMAL, *, mesh, axis: str = "batch"):
    """``core.solve`` on a state sharded over N along ``mesh``'s ``axis``
    (:func:`shard_state_vector`, or :func:`shard_ensemble_2d` with ``axis``
    its state axis and ``tout`` the rank's lanes). ``problem`` is the whole
    system's; each rank returns its rows and the counters, which agree on
    every rank of the axis, as do the root lanes and ``yQ``. Every reduction
    over N crosses ranks by :func:`gather`, and a sharded sum is the
    unsharded one bit for bit, so the result is the unsharded solve's, in
    every mode (``ls_precision`` "single", ``krylov_storage``, ``fast_math``)
    and with constraints, roots and quadratures. The Krylov path only: the
    direct solvers raise (ROADMAP.md item 12)."""
    _refuse(problem, opts)
    with sharding.use_mesh(mesh, state_axis=axis):
        return core_solve(states, _rows_problem(problem), opts, _tol_rows(tol, problem.n), tout,
                          itask)


def sharded_calc_ic(states: IdaState, problem: IdaProblem, opts: IdaOptions, tol: TolControl,
                    icopt, tout1, *, mesh, axis: str = "batch"):
    """``core.calc_ic`` (``icopt`` "ya_ydp" or "y", as ``IDA.calc_ic``) on a state
    sharded over N along ``mesh``'s ``axis``, as :func:`sharded_solve` takes
    it (``problem`` and ``tol`` the whole system's). The IC Jacobian is
    dense, built from every row (as ``ida_tpu``'s GSPMD builds it): each
    rank gathers the fields the IC reads and writes (phi, yy, yp), one
    gather each, runs ``calc_ic`` on the whole state and keeps its rows.
    Returns (the rank's state, ok [*batch], the same on every rank): the
    unsharded ``calc_ic`` bit for bit. Refuses what ``sharded_solve``
    refuses."""
    _refuse(problem, opts)
    bnd = states.tn.dim()
    with sharding.use_mesh(mesh, state_axis=axis):
        rows = sharding.rows(problem.n)

    def n_dim(x):
        return x.dim() - 1 - bnd

    whole = {f: gather(getattr(states, f), mesh, axis, n_dim(getattr(states, f)))
             for f in ("phi", "yy", "yp")}
    out, ok = core_calc_ic(states._replace(**whole), problem, opts, tol, IC_CODES[icopt], tout1)
    mine = {f: getattr(out, f).narrow(n_dim(whole[f]), rows.start, rows.stop - rows.start)
            .contiguous() for f in whole}
    return states._replace(**mine), ok
