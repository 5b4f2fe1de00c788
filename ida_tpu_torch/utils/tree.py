"""Control-flow helpers for the branchless, batchable solver core.

Port of ``ida_tpu/utils/tree.py``. Each batch lane carries its own status;
loops run until every lane is done and each body application is masked, so
finished lanes are frozen. Leaves are tensors whose TRAILING axes are the
batch (the batch-native layout), or ``()`` for empty slots. A loop
condition becomes a host-side ``bool(...)``: one device sync per iteration.

``bounded_fori_loop`` is the fixed-trip form that ``IdaOptions.unroll_roots``
selects: no host read at all, at the cost of masked passes after the last
lane is done.
"""

from __future__ import annotations

from typing import Callable, TypeVar

import torch

T = TypeVar("T")


def tree_where(pred: torch.Tensor, new_tree: T, old_tree: T) -> T:
    """Elementwise select over matching NamedTuples (or tuples) of tensors.
    ``pred`` broadcasts against each leaf from the right (trailing batch).
    A leaf that is the same tensor object on both sides (a field that
    ``_replace`` left alone) is returned as it is: no select is launched for
    it, and the result is the same bit for bit. Nothing in the core writes a
    tensor in place, so sharing the object is safe."""
    if new_tree is old_tree:
        return old_tree
    if isinstance(new_tree, torch.Tensor):
        return torch.where(pred, new_tree, old_tree)
    leaves = [tree_where(pred, n, o) for n, o in zip(new_tree, old_tree)]
    return type(new_tree)(*leaves) if hasattr(new_tree, "_fields") else type(new_tree)(leaves)


def take1(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane element pick ``vec[idx]`` from [K, *batch] with idx [*batch]."""
    return torch.gather(vec, 0, idx.long().unsqueeze(0)).squeeze(0)


def take_row(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane row pick from [K, N, *batch] with idx [*batch] -> [N, *batch]."""
    index = idx.long().unsqueeze(0).unsqueeze(0).expand((1,) + mat.shape[1:])
    return torch.gather(mat, 0, index).squeeze(0)


def set_row(mat: torch.Tensor, idx: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Per-lane row write into [K, N, *batch]: ``mat[idx] = row``."""
    k = mat.shape[0]
    iota = torch.arange(k, dtype=torch.int32, device=mat.device)
    onehot = iota.reshape((k,) + (1,) * (mat.dim() - 1)) == idx
    return torch.where(onehot, row.unsqueeze(0), mat)


def set1(vec: torch.Tensor, idx: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Per-lane element write into [K, *batch]: ``vec[idx] = value``."""
    k = vec.shape[0]
    iota = torch.arange(k, dtype=torch.int32, device=vec.device)
    onehot = iota.reshape((k,) + (1,) * idx.dim()) == idx
    return torch.where(onehot, value, vec)


def masked_while_loop(
    cond_fn: Callable[[T], torch.Tensor], body_fn: Callable[[T], T], init: T
) -> T:
    """Run ``body_fn`` while any lane's ``cond_fn`` holds; lanes whose
    condition is false keep their carry bit for bit."""
    c = init
    active = cond_fn(c)
    while bool(active.any()):
        c = tree_where(active, body_fn(c), c)
        active = cond_fn(c)
    return c


def bounded_while_loop(
    cond_fn: Callable[[T], torch.Tensor],
    body_fn: Callable[[T], T],
    init: T,
    max_iters: int,
) -> T:
    """:func:`masked_while_loop` with a hard iteration bound (the safety net
    of the root search, whose convergence is mathematically, not
    structurally, guaranteed)."""
    c = init
    n = 0
    active = cond_fn(c)
    while n < max_iters and bool(active.any()):
        c = tree_where(active, body_fn(c), c)
        active = cond_fn(c)
        n += 1
    return c


def bounded_fori_loop(
    cond_fn: Callable[[T], torch.Tensor],
    body_fn: Callable[[T], T],
    init: T,
    max_iters: int,
) -> T:
    """The fixed-trip form of :func:`bounded_while_loop` (``ida_tpu``'s
    reverse-differentiable form): the same masked body, always ``max_iters``
    passes, each a no-op for lanes whose condition has turned false, so no
    lane's arithmetic changes and no pass reads the host."""
    c = init
    for _ in range(max_iters):
        c = tree_where(cond_fn(c), body_fn(c), c)
    return c
