"""Food-web reaction-diffusion DAE (SUNDIALS ``idaFoodWeb_kry`` structure).

Port of ``ida_tpu/models/foodweb.py``: one prey and one predator species
on an MX x MY grid (BASELINE.md config 5 at 20 x 20),

  prey     s:  dc_s/dt = d_s * lap(c_s) + R_s(x, y, c)      (differential)
  predator s:  0       = d_s * lap(c_s) + R_s(x, y, c)      (algebraic)

with rates R_s = c_s (b_s(x,y) + sum_j a_sj c_j), a = [[-AA, -GG], [EE, -AA]],
b = (+-BB)(1 + ALPHA x y) and reflective (Neumann) boundaries. The state is
[MX*MY*2, *batch], species fastest.

The preconditioner is block-diagonal over grid points: at each point the
2 x 2 reaction Jacobian with cj on the prey row, factored and solved by
``ops.dense_lu.lu_factor_auto``/``lu_solve_auto``, which on the card is the
batched small-LU kernel (``csrc/small_lu.cu``) over npts x batch systems.
A block reads its own point's concentrations alone, so on a state sharded
over N (``parallel/mesh.py::sharded_solve``, C ``idaFoodWeb_kry_p``'s
subgrid a rank) each rank factors and solves the blocks of its own points,
with no collective (``pdata_rows``: the points on the first axis of each
leaf, two rows a point); a rank whose rows split a point is refused.
``pdata`` keeps ``ida_tpu``'s shapes, (lu [npts, 2, 2, *batch], piv
[npts, 2, *batch]), as views of the factor's [2, 2, npts, *batch] output
(a checkpoint loads them contiguous). The solve kernel reads either layout,
and the right-hand side [npts * 2, *batch], by strides, and writes its
result in the right-hand side's layout: ``prec_solve`` is one launch and
copies nothing.
The Krylov path's J v is given in closed form (``jtimes_fn``): the values
of a jvp of ``res``, bit for bit, at a fraction of its host time.

Every constant is cast to the state's dtype where it is used, so an f32
state stays f32 through the residual, its jvps and the preconditioner
(``ida_tpu/models/foodweb.py:69-83`` tells what the promotion cost there).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.dense_lu import DenseLU, lu_factor_auto, lu_solve_auto
from ..problem import IdaProblem
from ..utils import sharding
from ..utils.device import resolve_device

AA = 1.0
EE = 1.0e4
GG = 0.5e-6
BB = 1.0
DPREY = 1.0
DPRED = 0.05
ALPHA = 50.0
NS = 2  # 1 prey + 1 predator

_ACOEF = np.array([[-AA, -GG], [EE, -AA]])


@functools.lru_cache(maxsize=None)
def _constants(mx: int, my: int, device: torch.device, dtype: torch.dtype) -> dict:
    """The model's arrays on ``device`` in ``dtype``, made once: a factory
    may be called per solve, and a host-to-device copy synchronizes."""
    x = np.linspace(0.0, 1.0, mx)
    y = np.linspace(0.0, 1.0, my)
    xx, yy_ = np.meshgrid(x, y, indexing="ij")
    fac = 1.0 + ALPHA * xx * yy_
    bcoef = np.stack([BB * fac, -BB * fac], axis=-1)  # [mx, my, ns]
    id_np = np.zeros((mx, my, NS), bool)
    id_np[:, :, 0] = True
    dx = 1.0 / (mx - 1)
    dy = 1.0 / (my - 1)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    return {
        "bcoef": t(bcoef), "id": torch.from_numpy(id_np).to(device),
        "diff": t([DPREY, DPRED]), "dx2": t(dx * dx), "dy2": t(dy * dy),
        "a": [[t(_ACOEF[i, j]) for j in range(NS)] for i in range(NS)],
    }


def _rates(c: torch.Tensor, k: dict, bnd: int) -> torch.Tensor:
    """sum_s a_ts c_s over [.., ns, *batch] (species axis ``-1 - bnd``)."""
    a = k["a"]
    c0, c1 = c.select(-1 - bnd, 0), c.select(-1 - bnd, 1)
    return torch.stack([a[t][0] * c0 + a[t][1] * c1 for t in range(NS)], dim=-1 - bnd)


def own_points(n: int) -> slice | None:
    """The grid points of this rank's rows of a state sharded over N (None
    unsharded); ValueError when the rows split a point."""
    own = sharding.rows(n)
    if own is None:
        return None
    if own.start % NS or own.stop % NS:
        raise ValueError(
            f"the food web's preconditioner needs whole grid points ({NS} rows a point) on each "
            f"rank: rows {own.start}:{own.stop} of N = {n} split one")
    return slice(own.start // NS, own.stop // NS)


def prec_blocks(mx: int, my: int, cj: torch.Tensor, yy: torch.Tensor,
                points: slice | None = None) -> torch.Tensor:
    """The preconditioner's blocks at (cj, yy), [2, 2, npts, *batch], the
    layout the LU kernel takes: per grid point cj*I_diff - (diag(rate) +
    c outer a), in ``ida_tpu``'s order of operations. ``yy`` holds the
    ``points`` of the grid (a slice of its MX*MY points; all for None)."""
    lane = yy.shape[1:]
    bnd = len(lane)
    k = _constants(mx, my, yy.device, yy.dtype)
    bcoef = k["bcoef"].reshape((mx * my, NS))
    if points is not None:
        bcoef = bcoef[points]
    npts = bcoef.shape[0]
    c_pts = yy.reshape((npts, NS) + lane)
    rate = bcoef.reshape((npts, NS) + (1,) * bnd) + _rates(c_pts, k, bnd)
    a = k["a"]
    rows = []
    for t in range(NS):
        row = []
        for s in range(NS):
            jac_r = (1.0 if t == s else 0.0) * rate[:, t] + c_pts[:, t] * a[t][s]
            row.append(cj * (1.0 if t == s == 0 else 0.0) - jac_r)
        rows.append(torch.stack(row))
    return torch.stack(rows)


def foodweb_problem(mx: int = 20, my: int = 20, use_prec: bool = True, *, device=None) -> IdaProblem:
    """The MX x MY food web; ``device`` (None: the current CUDA device)
    places its arrays."""
    npts = mx * my
    n = NS * npts
    device = resolve_device(device)

    def consts(dtype):
        return _constants(mx, my, device, dtype)

    def lap_neumann(c, k):
        # reflective boundaries: the outward neighbour is the inward one
        up = torch.cat([c[1:2], c[:-1]], dim=0)
        dn = torch.cat([c[1:], c[-2:-1]], dim=0)
        lf = torch.cat([c[:, 1:2], c[:, :-1]], dim=1)
        rt = torch.cat([c[:, 1:], c[:, -2:-1]], dim=1)
        return (up + dn - 2.0 * c) / k["dx2"] + (lf + rt - 2.0 * c) / k["dy2"]

    def res(t, yy, yp):
        lane = yy.shape[1:]
        bnd = len(lane)
        k = consts(yy.dtype)
        c3 = yy.reshape((mx, my, NS) + lane)
        cp3 = yp.reshape((mx, my, NS) + lane)
        lap = lap_neumann(c3, k)
        f = (k["diff"].reshape((1, 1, NS) + (1,) * bnd) * lap
             + c3 * (k["bcoef"].reshape((mx, my, NS) + (1,) * bnd) + _rates(c3, k, bnd)))
        r = torch.where(k["id"].reshape((mx, my, NS) + (1,) * bnd), cp3 - f, -f)
        return r.reshape(yy.shape)

    def jtimes_fn(jdata, t, cj, yy, yp, v):
        # J v: the tangent a jvp of res computes along (v, cj v), term for
        # term (the product rule's two terms and each product commute, so
        # the values are the jvp's bit for bit), without the forward-mode
        # machinery and without the primal residual
        lane = v.shape[1:]
        bnd = len(lane)
        k = consts(v.dtype)
        c3 = yy.reshape((mx, my, NS) + lane)
        v3 = v.reshape((mx, my, NS) + lane)
        rate = k["bcoef"].reshape((mx, my, NS) + (1,) * bnd) + _rates(c3, k, bnd)
        tf = (k["diff"].reshape((1, 1, NS) + (1,) * bnd) * lap_neumann(v3, k)
              + (v3 * rate + c3 * _rates(v3, k, bnd)))
        tp = (cj * v).reshape((mx, my, NS) + lane)
        r = torch.where(k["id"].reshape((mx, my, NS) + (1,) * bnd), tp - tf, -tf)
        return r.reshape(v.shape)

    # ---- block-diagonal preconditioner (C Precondbd/PSolvebd), on the
    # rank's own points of a state sharded over N ----
    def prec_setup(t, cj, yy, yp, rr):
        # [2, 2, npts, *batch]
        f = lu_factor_auto(prec_blocks(mx, my, cj, yy, own_points(n)))
        return (f.lu.movedim((0, 1), (1, 2)), f.piv.movedim(0, 1))

    def prec_solve(pdata, r, cj):
        # views only: the kernel reads pdata and r as they lie and writes
        # its result in r's layout, so the reshape back copies nothing
        lu, piv = pdata
        rb = r.reshape((lu.shape[0], NS) + r.shape[1:]).movedim(1, 0)
        f = DenseLU(lu.movedim((1, 2), (0, 1)), piv.movedim(1, 0), None)
        return lu_solve_auto(f, rb).movedim(0, 1).reshape(r.shape)

    def prec_zero():
        return (torch.zeros((npts, NS, NS), dtype=torch.float64),
                torch.zeros((npts, NS), dtype=torch.int32))

    kwargs = {}
    if use_prec:
        kwargs = dict(prec_setup=prec_setup, prec_solve=prec_solve, prec_zero=prec_zero,
                      pdata_rows=((-3, NS), (-2, NS)))
    return IdaProblem(n=n, res=res, id=_constants(mx, my, device, torch.float64)["id"].reshape(-1),
                      jtimes_fn=jtimes_fn, **kwargs)


def foodweb_ic(mx: int = 20, my: int = 20):
    """C SetInitialProfiles, numpy [MX*MY*2] each: prey = 10 +
    (16x(1-x)y(1-y))^2, predator = 1e5 (a guess for calc_ic("ya_ydp") to
    correct), c' = 0."""
    x = np.linspace(0.0, 1.0, mx)
    y = np.linspace(0.0, 1.0, my)
    xx, yy_ = np.meshgrid(x, y, indexing="ij")
    prey = 10.0 + (16.0 * xx * (1 - xx) * yy_ * (1 - yy_)) ** 2
    pred = np.full_like(prey, 1.0e5)
    c0 = np.stack([prey, pred], axis=-1).reshape(-1)
    cp0 = np.zeros_like(c0)
    return c0, cp0
