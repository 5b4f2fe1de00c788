"""The current mesh, and the reductions over a state vector sharded across it.

A solve whose state vector is sharded over N (``parallel/mesh.py``:
``shard_state_vector``, ``shard_ensemble_2d``, ``sharded_solve``) runs the
core on each rank's rows. The reductions over N then need every rank's rows.
They read the current sharding here, a module flag set by a context manager
(the pattern of :mod:`.ad_mode`), and cross ranks through the mesh's one
collective, ``parallel.mesh.gather``. Outside :func:`use_mesh` every helper
is the plain local reduction.

Which reductions cross shards. Of the core's and SPGMR's reductions, only
those over the N axis do:

* over N (across shards): the WRMS norms (``norms.py``, reached from
  ``core/error_test.py::_norm``, ``core/nls.py``'s Newton and constraints
  norms and ``core/calc_ic.py``), SPGMR's dot products and norms
  (``ops/spgmr.py::_dot`` and the classical Gram-Schmidt sums), the
  ``any``/``all`` tests over N (``core/solve.py::_any_data`` of the error
  weights, ``core/nls.py::_res_ok``, the constraints block's ``any``), the
  constraints block's ``amin`` (:func:`min_over`), and the Krylov
  tolerance's sqrt(N);
* over the BDF order, the Krylov basis or the lanes (local): ``sum0`` in
  ``core/coeffs.py`` and ``core/interp.py``, SPGMR's basis combinations and
  back substitution, the host loops' ``any`` over lanes (``core/solve.py``,
  ``ops/spgmr.py``), and the root functions' ``any`` over their R roots.

The non-parity modes add none: under ``ls_precision="single"`` the Krylov
iteration's sums are the same ``sum_over`` calls on float32 terms, a
bfloat16 basis is cast back before every dot product, and ``fast_math``
changes only the BDF history's scaling, which is local.

What reads the whole state gets it gathered (``parallel/mesh.py``): the
residual, J v, the root functions, the quadrature integrand, a
preconditioner that is not row-local, and ``calc_ic`` (whose dense IC
Jacobian is built from all rows, as under GSPMD). Only the direct solvers'
[N, N] or banded Jacobian stays unsharded: ``sharded_solve`` refuses them.

Exactness: :func:`sum_over` gathers the shards' terms and adds them with
``numerics.sum0`` over the whole axis. ``sum0`` pairs entry i with
i + size/2, so with contiguous shards its first levels add whole shards
elementwise; replaying its tree on the gathered terms makes a sharded sum
the unsharded one bit for bit, whatever N and the number of ranks. A min
or an ``any`` is exact in any order.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from .numerics import sum0

_MESH = None  # the current torch.distributed DeviceMesh (use_mesh)
_STATE_AXIS = None  # the mesh axis the state vector is sharded over, or None
_GATHERED: list = []  # (tensor, its gather over the state axis), newest last
_GATHER_CACHE = 4


@contextmanager
def use_mesh(mesh, state_axis: str | None = None):
    """Make ``mesh`` the current mesh (``axis_name`` arguments resolve
    against it); ``state_axis`` names the axis the state vector is sharded
    over in a sharded solve."""
    global _MESH, _STATE_AXIS
    old = _MESH, _STATE_AXIS, list(_GATHERED)
    _MESH, _STATE_AXIS = mesh, state_axis
    _GATHERED.clear()
    try:
        yield
    finally:
        _MESH, _STATE_AXIS = old[0], old[1]
        _GATHERED[:] = old[2]


def state_axis() -> str | None:
    """The axis the current solve's state vector is sharded over, or None."""
    return _STATE_AXIS


def _current():
    if _MESH is None:
        raise RuntimeError("axis_name needs a current mesh (utils.sharding.use_mesh)")
    return _MESH


def axis_size(axis_name: str | None) -> int:
    """The number of ranks along ``axis_name`` of the current mesh (1 for None)."""
    if axis_name is None:
        return 1
    from ..parallel import mesh

    return mesh.axis_size(_current(), axis_name)


def rows(n: int) -> slice | None:
    """This rank's rows of an N-long state vector in a sharded solve (None
    when the state is not sharded): contiguous, N / ranks of them."""
    if _STATE_AXIS is None:
        return None
    from ..parallel.mesh import axis_index

    size = axis_size(_STATE_AXIS)
    if n % size:
        raise ValueError(f"N = {n} does not divide over {size} ranks")
    m = n // size
    k = axis_index(_MESH, _STATE_AXIS)
    return slice(k * m, (k + 1) * m)


def _gather(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    from ..parallel.mesh import gather

    return gather(x, _current(), axis_name, 0)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole of a state-shaped ``x`` ([N_local, *rest]) on every rank of
    the state axis. The last few gathers are kept by identity: the Newton
    iterate reaches every J v product of a linear solve as one tensor, and
    the port never writes a state tensor in place."""
    for src, full in _GATHERED:
        if src is x:
            return full
    full = _gather(x, _STATE_AXIS)
    _GATHERED.append((x, full))
    del _GATHERED[:-_GATHER_CACHE]
    return full


def sum_over(t: torch.Tensor, axis_name: str | None = None) -> torch.Tensor:
    """``sum0`` over the leading axis, across the shards of ``axis_name``
    (bit for bit the unsharded sum: see the module doc)."""
    return sum0(t if axis_name is None else _gather(t, axis_name))


def any_over(x: torch.Tensor, axis_name: str | None = None) -> torch.Tensor:
    """``any`` over the leading axis, across the shards of ``axis_name``."""
    local = x.any(dim=0)
    return local if axis_name is None else _gather(local.unsqueeze(0), axis_name).any(dim=0)


def min_over(x: torch.Tensor, axis_name: str | None = None) -> torch.Tensor:
    """``torch.amin`` over the leading axis, across the shards of
    ``axis_name``: each shard's min, gathered, and their min (NaN propagates
    as in ``torch.amin``)."""
    local = torch.amin(x, dim=0)
    return local if axis_name is None else torch.amin(_gather(local.unsqueeze(0), axis_name), dim=0)
