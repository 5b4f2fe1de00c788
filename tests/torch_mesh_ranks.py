"""The rank side of ``tests/test_torch_mesh*.py``: what each process of a
gloo group on the CPU computes with ``ida_tpu_torch.parallel.mesh``.

Kept apart from the test modules so that the spawned ranks import torch and
the port only (the test modules import JAX for their references). ``spawn``
starts ``WORLD`` ranks once for a test module; each runs the module's cases
of :data:`CASES` and saves what it found, and the module holds those
results against ``ida_tpu`` and against the port's unsharded runs.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ida_tpu_torch import constants as C
from ida_tpu_torch.core.state import IdaOptions, init_state
from ida_tpu_torch.models import (ROBERTS_PARAMS, ROBERTS_YY0, foodweb_ic, foodweb_problem,
                                  heat2d_ic, heat2d_problem, roberts_factory)
from ida_tpu_torch.norms import wrms_norm, wrms_norm_masked
from ida_tpu_torch.ops.bbd import make_bbd_prec
from ida_tpu_torch.parallel import (EnsembleIDA, ensemble_init, make_ensemble_solve, make_mesh,
                                    make_mesh_2d, mesh, shard_ensemble, shard_ensemble_2d,
                                    shard_state_vector, sharded_calc_ic, sharded_solve,
                                    to_native)
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

# the food web (idaFoodWeb_kry_p's deployment: calc_ic("ya_ydp"), then the
# legs) at 8 x 8, N = 128: 32 rows, 16 grid points a rank; krylov_maxl 6 as
# tests/test_torch_krylov_path.py
FOOD_M = 8
FOOD_TOL = (1e-5, 1e-5)
FOOD_TOUTS = (1e-3, 4e-3)
FOOD_OPTS = dict(linear_solver="spgmr", mxstep=5000, krylov_maxl=6, krylov_max_restarts=10)
FOOD_CENTRE = (FOOD_M // 2) * FOOD_M + FOOD_M // 2  # a grid point near the centre
# the prey's rate there rises from 41.8 through this level before the first
# tout. The prey itself (10.92 to 10.96) moves less than an ulp across the
# root finder's ttol, so at most levels its root lies exactly at a zero of g
# and the next call returns CLOSE_ROOTS, as C IDA's IDARcheck2 does
FOOD_ROOT_LEVEL = 42.5
# each feature and mode, one case each, from the same consistent IC
FOOD_CASES = {"base": {}, "constraints": {}, "roots": {}, "quad": {},
              "single": dict(ls_precision="single"), "bf16": dict(krylov_storage="bfloat16"),
              "fast_math": dict(fast_math=True)}
FOOD_B = 4  # lanes of the 2 x 2 case: prey x linspace(0.95, 1.05, 4)


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


def food_problem(case: str = "base"):
    """The food web with the case's root function (the prey's rate at
    FOOD_CENTRE minus FOOD_ROOT_LEVEL) or quadrature (the total prey)."""
    prob = foodweb_problem(FOOD_M, FOOD_M, device="cpu")
    p = 2 * FOOD_CENTRE
    if case == "roots":
        prob = dataclasses.replace(prob, root=lambda t, yy, yp: yp[p:p + 1] - FOOD_ROOT_LEVEL,
                                   nroots=1)
    if case == "quad":
        prob = dataclasses.replace(prob, quad=lambda t, yy, yp: yy[0::2].sum(0, keepdim=True),
                                   nquad=1)
    return prob


def food_opts(case: str = "base") -> IdaOptions:
    return IdaOptions(**FOOD_OPTS, **FOOD_CASES[case])


def food_state(case: str = "base", b: int | None = None):
    """The C initial profile (b lanes batch-native, prey scaled by
    linspace(0.95, 1.05, b)), constraints y >= 0 on every component for the
    "constraints" case."""
    prob = food_problem(case)
    c0, cp0 = foodweb_ic(FOOD_M, FOOD_M)
    if b is None:
        st = init_state(prob, c0, cp0, opts=food_opts(case), device="cpu")
    else:
        ids = prob.id.numpy()
        scales = np.linspace(0.95, 1.05, b)
        c0b = np.stack([c0 * np.where(ids, s, 1.0) for s in scales])
        st = to_native(ensemble_init(lambda s: prob, scales[:, None], c0b, np.tile(cp0, (b, 1)),
                                     opts=food_opts(case), device="cpu"))
    if case == "constraints":
        st = st._replace(constraints=torch.ones_like(st.constraints),
                         constraints_set=torch.ones_like(st.constraints_set))
    return st


def food_tol():
    return tol_ss(*FOOD_TOL, device="cpu")


def food_legs(st, solve, gather_rows) -> list:
    """The legs to FOOD_TOUTS by ``solve(st, tout)``, a root return resumed
    (at most four calls a leg): per call its tret, istate, counters (nge
    too), iroots, yQ and the whole yy (``gather_rows`` of the state's)."""
    calls = []
    for tout in FOOD_TOUTS:
        for _ in range(4):
            st, tret, ist = solve(st, tout)
            calls.append({"tret": tret.numpy(), "istate": ist.numpy(),
                          "counters": {f: getattr(st, f).numpy() for f in COUNTERS + ("nge",)},
                          "iroots": st.iroots.numpy(), "yQ": st.yQ.numpy(),
                          "yy": gather_rows(st.yy).numpy()})
            if not bool(((ist == C.ROOT_RETURN) & (tret < tout)).any()):
                break
    return calls, st


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


def case_food(m1, cases=tuple(FOOD_CASES)) -> dict:
    """The 8 x 8 food web with its state vector over the four ranks:
    ``sharded_calc_ic("ya_ydp")``, then the legs of each of ``cases`` (of
    FOOD_CASES) from that IC (the block-diagonal preconditioner on the
    rank's 16 grid points), with the collectives of the IC and of each
    case's legs, and the rank's pdata at the end of the base legs."""
    tol = food_tol()
    prob = food_problem()
    st0 = shard_state_vector(food_state(), m1, prob.n, problem=prob)
    (st, ok), coll_ic = _counted(lambda: sharded_calc_ic(
        st0, prob, food_opts(), tol, "ya_ydp", FOOD_TOUTS[0], mesh=m1))
    out = {"ic_ok": bool(ok), "ic_collectives": coll_ic,
           "ic": [mesh.gather(x, m1, "batch").numpy() for x in (st.phi[0], st.phi[1])],
           "pdata0_shapes": [tuple(x.shape) for x in st.pdata]}

    def whole(x):
        return mesh.gather(x, m1, "batch")

    for case in cases:
        p, opts = food_problem(case), food_opts(case)
        cst = shard_state_vector(food_state(case), m1, p.n, problem=p)
        cst = cst._replace(phi=st.phi, yy=st.yy, yp=st.yp)
        mesh.reset_collective_counts()
        calls, end = food_legs(cst, lambda s, tout: sharded_solve(s, p, opts, tol, tout, mesh=m1),
                               whole)
        out[case] = {"calls": calls, "collectives": dict(mesh.COLLECTIVES)}
        if case == "base":
            out[case]["pdata"] = [x.numpy() for x in end.pdata]
    return out


def case_food_2d(m2) -> dict:
    """Four food-web lanes over the 2 x 2 (batch x state) mesh:
    ``sharded_calc_ic`` over the state axis, then the legs."""
    prob, tol = food_problem(), food_tol()
    st = shard_ensemble_2d(food_state(b=FOOD_B), m2, prob.n, problem=prob)
    lanes = shard_ensemble(torch.ones(FOOD_B, dtype=torch.float64), m2, "batch")
    st, ok = sharded_calc_ic(st, prob, food_opts(), tol, "ya_ydp", FOOD_TOUTS[0], mesh=m2,
                             axis="state")

    def whole(x):  # [N / 2, B / 2] -> [N, B]
        return mesh.gather(mesh.gather(x, m2, "state", 0), m2, "batch", 1)

    out = {"ic_ok": mesh.gather(ok, m2, "batch").numpy(), "ic_yy": whole(st.yy).numpy(),
           "local_pdata": [tuple(x.shape) for x in st.pdata]}
    calls = []
    for tout in FOOD_TOUTS:
        st, tret, ist = sharded_solve(st, prob, food_opts(), tol, tout * lanes, mesh=m2,
                                      axis="state")
        calls.append({"istate": mesh.gather(ist, m2, "batch").numpy(),
                      "counters": {f: mesh.gather(getattr(st, f), m2, "batch").numpy()
                                   for f in COUNTERS},
                      "yy": whole(st.yy).numpy()})
    out["calls"] = calls
    return out


def heat_whole_prec(m: int):
    """heat2d with its diagonal preconditioner written over the whole state
    (no ``pdata_rows``): a sharded solve runs it on the gathered vectors."""
    base = heat2d_problem(m, use_prec=False, device="cpu")
    coeff = float((m - 1) ** 2)

    def prec_setup(t, cj, yy, yp, rr):
        interior = base.id.reshape((base.n,) + (1,) * (yy.dim() - 1))
        return (1.0 / torch.where(interior, cj + 4.0 * coeff, torch.ones((), dtype=yy.dtype)),)

    return dataclasses.replace(base, prec_setup=prec_setup, prec_solve=lambda pd, r, cj: pd[0] * r,
                               prec_zero=lambda: (torch.zeros(base.n, dtype=torch.float64),))


def case_heat_whole_prec(m1) -> dict:
    """heat2d m = 16 with the whole-state preconditioner, its state vector
    over the ranks."""
    prob = heat_whole_prec(HEAT_M)
    u0, up0 = heat2d_ic(HEAT_M)
    st = shard_state_vector(init_state(prob, u0, up0, opts=HEAT_OPTS, device="cpu"), m1, prob.n,
                            problem=prob)
    out, tret, ist = sharded_solve(st, prob, HEAT_OPTS, tol_ss(1e-5, 1e-8, device="cpu"),
                                   HEAT_TOUT, mesh=m1)
    return {"istate": int(ist), "counters": {f: int(getattr(out, f)) for f in COUNTERS},
            "yy": mesh.gather(out.yy, m1, "batch").numpy(),
            "pdata_shape": tuple(out.pdata[0].shape)}


def case_split_point(m1) -> dict:
    """The 3 x 2 food web (N = 12) over four ranks, three rows a rank, which
    split a grid point: the shard and the preconditioner refuse it."""
    out = {}
    prob = foodweb_problem(3, 2, device="cpu")
    c0, cp0 = foodweb_ic(3, 2)
    st = init_state(prob, c0, cp0, opts=food_opts(), device="cpu")
    try:
        shard_state_vector(st, m1, prob.n, problem=prob)
        out["shard"] = None
    except ValueError as e:
        out["shard"] = str(e)
    y = shard_ensemble(torch.as_tensor(c0), m1)
    try:
        with use_mesh(m1, state_axis="batch"):
            prob.prec_setup(0.0, torch.tensor(10.0, dtype=torch.float64), y, y, y)
        out["prec_setup"] = None
    except ValueError as e:
        out["prec_setup"] = str(e)
    return out


def case_heat(m1) -> dict:
    """heat2d m = 16, SPGMR with its diagonal preconditioner, the state
    vector over the four ranks, to tout 0.01."""
    prob = heat2d_problem(HEAT_M, use_prec=True, device="cpu")
    u0, up0 = heat2d_ic(HEAT_M)
    st = shard_state_vector(init_state(prob, u0, up0, opts=HEAT_OPTS, device="cpu"), m1, prob.n,
                            problem=prob)
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
    st = shard_ensemble_2d(st, m2, prob.n, problem=prob)
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
    st = shard_state_vector(init_state(prob, u0, up0, opts=HEAT_OPTS, device="cpu"), m1, prob.n,
                            problem=prob)
    (out, tret, ist), coll = _counted(lambda: sharded_solve(
        st, prob, HEAT_OPTS, tol_ss(1e-5, 1e-8, device="cpu"), HEAT_TOUT, mesh=m1))
    return {"collectives": coll, "istate": int(ist), "tret": float(tret),
            "counters": {f: int(getattr(out, f)) for f in COUNTERS},
            "phi0": mesh.gather(out.phi[0], m1, "batch").numpy()}


# name -> (the mesh it runs on, the case); "food" is the IC and the base
# legs, "food_modes" the other cases of FOOD_CASES from the same IC
CASES = {"dp": ("m1", case_dp), "ensemble": ("m1", case_ensemble), "norms": ("mx", case_norms),
         "heat": ("m1", case_heat), "heat_2d": ("m2", case_heat_2d),
         "bbd_hooks": ("m1", case_bbd_hooks), "bbd_solve": ("m1", case_bbd_solve),
         "food": ("m1", functools.partial(case_food, cases=("base",))),
         "food_modes": ("m1", functools.partial(
             case_food, cases=tuple(c for c in FOOD_CASES if c != "base"))),
         "food_2d": ("m2", case_food_2d), "heat_whole_prec": ("m1", case_heat_whole_prec),
         "split_point": ("m1", case_split_point)}


def cases(rank: int, names: tuple) -> dict:
    """The cases ``names`` (of CASES) on this rank (a gloo group of WORLD
    ranks is up)."""
    meshes = {"m1": make_mesh(WORLD, device_type="cpu"),
              "mx": make_mesh(WORLD, "x", device_type="cpu"),
              "m2": make_mesh_2d(2, 2, device_type="cpu")}
    return {name: CASES[name][1](meshes[CASES[name][0]]) for name in names}


def _rank(rank: int, world: int, root: str, names: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, 'rendezvous')}",
                            rank=rank, world_size=world)
    try:
        torch.save(cases(rank, names), os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(root: str, names: tuple) -> list:
    """Run the cases ``names`` (of CASES) on WORLD spawned gloo ranks
    (rendezvous through a file under ``root``); every rank's results."""
    mp.start_processes(_rank, args=(WORLD, root, tuple(names)), nprocs=WORLD,
                       start_method="spawn")
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]
