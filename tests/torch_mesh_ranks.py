"""The rank side of ``tests/test_torch_mesh.py``: what each process of a
gloo group on the CPU computes with ``ida_tpu_torch.parallel.mesh``.

Kept apart from the test module so that the spawned ranks import torch and
the port only (the test module imports JAX for its references). ``spawn``
starts ``WORLD`` ranks once; each runs every case of :func:`cases` and
saves what it found, and the test module holds those results against
``ida_tpu`` and against the port's unsharded runs.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ida_tpu_torch.core.state import IdaOptions, init_state
from ida_tpu_torch.models import (ROBERTS_PARAMS, ROBERTS_YY0, heat2d_ic, heat2d_problem,
                                  roberts_factory)
from ida_tpu_torch.norms import wrms_norm, wrms_norm_masked
from ida_tpu_torch.ops.bbd import make_bbd_prec
from ida_tpu_torch.parallel import (EnsembleIDA, ensemble_init, make_ensemble_solve, make_mesh,
                                    make_mesh_2d, mesh, shard_ensemble, shard_ensemble_2d,
                                    shard_state_vector, sharded_solve, to_native)
from ida_tpu_torch.problem import IdaProblem
from ida_tpu_torch.tol_control import tol_ss, tol_sv
from ida_tpu_torch.utils.sharding import use_mesh

WORLD = 4
B_DP = 16
HEAT_M = 16
HEAT_TOUT = 0.01
BBD_HOOKS_M = 8
GRID_TOUTS = (0.04, 0.4)
COUNTERS = ("nst", "nni", "nre", "nje", "netf", "ncfn", "nli", "nps", "ncfl", "nsetups",
            "njtimes")


def roberts_inputs(b: int):
    """``tests/test_multidevice.py``'s ensemble: rates scaled by
    exp(linspace(-0.1, 0.1, B))."""
    params = np.outer(np.exp(np.linspace(-0.1, 0.1, b)), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (b, 1))
    yp0 = params[:, 0:1] * np.array([-1.0, 1.0, 0.0])
    return params, yy0, yp0


ROBERTS_RTOL, ROBERTS_ATOL, DP_TOUT = 1.0e-4, [1e-8, 1e-6, 1e-6], 0.4
HEAT_OPTS = IdaOptions(linear_solver="spgmr", mxstep=2000)


def bbd_problem(m: int, nblocks: int, mu: int = 4, ml: int = 4):
    """``tests/test_bbd_prec.py``'s blocked BBD heat problem (keep
    bandwidths 4)."""
    base = heat2d_problem(m, use_prec=False, device="cpu")
    bbd = make_bbd_prec(base.res, base.n, mu, ml, nblocks=nblocks)
    return IdaProblem(n=base.n, res=base.res, id=base.id, **bbd.hooks()), bbd


def heat2d_lanes(m: int, b: int):
    """``test_multidevice.py``'s 2-D case: b heat lanes, u0 scaled by
    linspace(0.9, 1.1, b), batch-leading numpy."""
    u0, up0 = heat2d_ic(m)
    scales = np.linspace(0.9, 1.1, b)
    return scales, u0[None] * scales[:, None], up0[None] * scales[:, None]


def _np(st) -> dict:
    """An IdaState's tensors as numpy (pdata leaves as pdata0, ...)."""
    out = {}
    for name, x in zip(st._fields, st):
        if isinstance(x, torch.Tensor):
            out[name] = x.numpy()
        else:
            out.update({f"{name}{i}": y.numpy() for i, y in enumerate(x)})
    return out


def _counted(fn):
    """``fn()`` and the collectives it made."""
    mesh.reset_collective_counts()
    out = fn()
    return out, dict(mesh.COLLECTIVES)


def case_dp(m1) -> dict:
    """Roberts B = 16 at four lanes a rank: the sharded solve, its
    collectives, and the rank's per-shard run without a mesh."""
    params, yy0, yp0 = roberts_inputs(B_DP)
    tol = tol_sv(ROBERTS_RTOL, ROBERTS_ATOL, device="cpu")
    fn = make_ensemble_solve(roberts_factory)
    st = shard_ensemble(ensemble_init(roberts_factory, params, yy0, yp0, device="cpu"), m1)
    p_loc = shard_ensemble(torch.as_tensor(params), m1)
    (st8, tret, ist), coll = _counted(lambda: fn(st, p_loc, tol, DP_TOUT))
    k, lanes = mesh.axis_index(m1, "batch"), B_DP // WORLD
    part = slice(k * lanes, (k + 1) * lanes)
    st1 = ensemble_init(roberts_factory, params[part], yy0[part], yp0[part], device="cpu")
    own, tret1, ist1 = fn(st1, params[part], tol, DP_TOUT)
    whole = {f: mesh.gather(x, m1, "batch").numpy()  # the gathered batch-leading state
             for f, x in zip(st8._fields, st8) if isinstance(x, torch.Tensor)}
    return {"collectives": coll, "shard": _np(st8), "per_shard": _np(own),
            "tret": mesh.gather(tret, m1, "batch").numpy(),
            "istate": mesh.gather(ist, m1, "batch").numpy(), "whole": whole,
            "per_shard_istate": ist1.numpy(), "per_shard_tret": tret1.numpy()}


def case_ensemble(m1) -> dict:
    """``EnsembleIDA(mesh=...)``: solve, one_step, solve_grid and the
    getters, every rank with the whole batch; a batch that does not divide."""
    params, yy0, yp0 = roberts_inputs(B_DP)
    tol = tol_sv(ROBERTS_RTOL, ROBERTS_ATOL, device="cpu")
    ens = EnsembleIDA(roberts_factory, params, yy0, yp0, tol, mesh=m1)
    out = {"solve": ens.solve(DP_TOUT), "one_step": ens.solve(4.0, one_step=True),
           "yy": ens.yy, "nst": ens.nst, "states": _np(ens.states)}
    grid = EnsembleIDA(roberts_factory, params, yy0, yp0, tol, mesh=m1)
    out["grid"] = grid.solve_grid(np.asarray(GRID_TOUTS))
    try:
        EnsembleIDA(roberts_factory, params[:6], yy0[:6], yp0[:6], tol, mesh=m1)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def case_norms(mx) -> dict:
    """``wrms_norm``/``wrms_norm_masked`` with ``axis_name`` at n = 64
    (``tests/test_shard_norms.py``'s inputs), each rank on its 16 entries."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=64)
    w = 1.0 / (np.abs(rng.normal(size=64)) + 1.0)
    mask = rng.uniform(size=64) > 0.3
    xs, ws, ms = shard_ensemble((torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(mask)), mx,
                                "x")
    with use_mesh(mx):
        return {"plain": float(wrms_norm(xs, ws, axis_name="x")),
                "masked": float(wrms_norm_masked(xs, ws, ms, axis_name="x"))}


def case_heat(m1) -> dict:
    """heat2d m = 16, SPGMR with its diagonal preconditioner, the state
    vector over the four ranks, to tout 0.01."""
    prob = heat2d_problem(HEAT_M, use_prec=True, device="cpu")
    u0, up0 = heat2d_ic(HEAT_M)
    st = shard_state_vector(init_state(prob, u0, up0, opts=HEAT_OPTS, device="cpu"), m1, prob.n)
    (out, tret, ist), coll = _counted(lambda: sharded_solve(
        st, prob, HEAT_OPTS, tol_ss(1e-5, 1e-8, device="cpu"), HEAT_TOUT, mesh=m1))
    return {"collectives": coll, "istate": int(ist), "tret": float(tret),
            "counters": {f: int(getattr(out, f)) for f in COUNTERS},
            "yy": mesh.gather(out.yy, m1, "batch").numpy(), "pdata_rows": out.pdata[0].shape[0]}


def case_heat_2d(m2) -> dict:
    """Four heat2d lanes over the 2 x 2 (batch x state) mesh."""
    prob = heat2d_problem(HEAT_M, use_prec=True, device="cpu")
    scales, u0b, up0b = heat2d_lanes(HEAT_M, 4)
    st = to_native(ensemble_init(lambda s: prob, scales[:, None], u0b, up0b, opts=HEAT_OPTS,
                                 device="cpu"))
    st = shard_ensemble_2d(st, m2, prob.n)
    tout = shard_ensemble(torch.full((4,), HEAT_TOUT, dtype=torch.float64), m2, "batch")
    out, tret, ist = sharded_solve(st, prob, HEAT_OPTS, tol_ss(1e-5, 1e-8, device="cpu"), tout,
                                   mesh=m2, axis="state")
    yy = mesh.gather(mesh.gather(out.yy, m2, "state", 0), m2, "batch", 1)
    return {"istate": mesh.gather(ist, m2, "batch").numpy(), "yy": yy.numpy(),
            "local_phi": tuple(out.phi.shape),
            "counters": {f: mesh.gather(getattr(out, f), m2, "batch").numpy() for f in COUNTERS}}


def case_bbd_hooks(m1) -> dict:
    """``test_bbd_prec.py::test_bbd_blocked_sharded_hooks``: the blocked BBD
    setup and solve at m = 8 on each rank's block (nblocks = 4)."""
    prob, bbd = bbd_problem(BBD_HOOKS_M, WORLD)
    u0, up0 = heat2d_ic(BBD_HOOKS_M)
    r = np.random.default_rng(1).standard_normal(prob.n)
    t, cj = torch.tensor(0.0, dtype=torch.float64), torch.tensor(3.0, dtype=torch.float64)
    u0s, up0s, rs = (mesh.shard_ensemble(torch.as_tensor(v), m1) for v in (u0, up0, r))
    with use_mesh(m1, state_axis="batch"):
        (x, pdata), coll = _counted(lambda: (lambda pd: (bbd.prec_solve(pd, rs, cj), pd))(
            bbd.prec_setup(t, cj, u0s, up0s, torch.zeros_like(u0s))))
        _, coll_solve = _counted(lambda: bbd.prec_solve(pdata, rs, cj))
    return {"x": mesh.gather(x, m1, "batch").numpy(), "lu_shape": tuple(pdata[0].shape),
            "collectives": coll, "collectives_solve": coll_solve}


def case_bbd_solve(m1) -> dict:
    """``test_bbd_prec.py::test_bbd_blocked_sharded_solve``: heat2d m = 16
    with the BBD preconditioner in four blocks, the state over the ranks."""
    prob, _ = bbd_problem(HEAT_M, WORLD)
    u0, up0 = heat2d_ic(HEAT_M)
    st = shard_state_vector(init_state(prob, u0, up0, opts=HEAT_OPTS, device="cpu"), m1, prob.n)
    (out, tret, ist), coll = _counted(lambda: sharded_solve(
        st, prob, HEAT_OPTS, tol_ss(1e-5, 1e-8, device="cpu"), HEAT_TOUT, mesh=m1))
    return {"collectives": coll, "istate": int(ist), "tret": float(tret),
            "counters": {f: int(getattr(out, f)) for f in COUNTERS},
            "phi0": mesh.gather(out.phi[0], m1, "batch").numpy()}


def cases(rank: int) -> dict:
    """Every case on this rank (a gloo group of WORLD ranks is up)."""
    m1 = make_mesh(WORLD, device_type="cpu")
    mx = make_mesh(WORLD, "x", device_type="cpu")
    m2 = make_mesh_2d(2, 2, device_type="cpu")
    return {"dp": case_dp(m1), "ensemble": case_ensemble(m1), "norms": case_norms(mx),
            "heat": case_heat(m1), "heat_2d": case_heat_2d(m2), "bbd_hooks": case_bbd_hooks(m1),
            "bbd_solve": case_bbd_solve(m1)}


def _rank(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, 'rendezvous')}",
                            rank=rank, world_size=world)
    try:
        torch.save(cases(rank), os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(root: str) -> list:
    """Run :func:`cases` on WORLD spawned gloo ranks (rendezvous through a
    file under ``root``); every rank's results."""
    mp.start_processes(_rank, args=(WORLD, root), nprocs=WORLD, start_method="spawn")
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]
