"""Checkpoint and resume: write an integrator state to disk and read it back.

Port of ``ida_tpu/utils/checkpoint.py``, in its format, so that a state
saved by either package loads into the other: one ``.npz`` archive with an
array per ``IdaState`` field, the preconditioner state ``pdata`` flattened
into ``pdata_<i>`` leaves, and a JSON meta entry under the key
``__ida_tpu_meta__`` (version 3) that holds the leaves' names and a
skeleton of ``pdata``'s containers (tuples, lists, dicts with string keys,
None), in the leaf order of ``jax.tree_util.tree_flatten``. Nothing is
pickled, so loading an untrusted archive runs no code. A version-2 archive
(``ida_tpu``'s older format, with a pickled JAX treedef) is refused unless
``allow_pickle=True``; even then its treedef is not unpickled here (that
would need JAX): its leaves come back as a flat tuple, the port's form of
``pdata``. Archives written before ``yQ`` or the refined-mode fields
existed get their defaults, in the archive's batch layout.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..core.state import IdaState
from .device import resolve_device

_META_KEY = "__ida_tpu_meta__"
_PDATA_TREEDEF_KEY = "__pdata_treedef__"  # version-2 pickled treedef


def _encode_skeleton(tree, leaves: list):
    """JSON skeleton of ``tree``; its leaves are appended to ``leaves`` in
    JAX's flatten order (dicts by sorted key; None holds no leaf)."""
    if tree is None:
        return {"t": "none"}
    if isinstance(tree, dict):
        if not all(isinstance(k, str) for k in tree):
            raise TypeError("checkpoint pdata dicts must have string keys to serialize "
                            "without pickle")
        keys = sorted(tree)
        return {"t": "dict", "k": keys, "v": [_encode_skeleton(tree[k], leaves) for k in keys]}
    if isinstance(tree, (list, tuple)):
        tag = "list" if isinstance(tree, list) else "tuple"
        return {"t": tag, "v": [_encode_skeleton(x, leaves) for x in tree]}
    leaves.append(tree)
    return {"t": "leaf", "i": len(leaves) - 1}


def _decode_skeleton(spec, leaves):
    t = spec["t"]
    if t == "none":
        return None
    if t == "dict":
        return {k: _decode_skeleton(v, leaves) for k, v in zip(spec["k"], spec["v"])}
    if t == "list":
        return [_decode_skeleton(v, leaves) for v in spec["v"]]
    if t == "tuple":
        return tuple(_decode_skeleton(v, leaves) for v in spec["v"])
    if t == "leaf":
        return leaves[spec["i"]]
    raise ValueError(f"unknown checkpoint tree node type {t!r}")


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_state(path: str, state: IdaState) -> None:
    """Write an IdaState (one lane or a batch, any device) to ``path``
    (.npz)."""
    leaves: list = []
    skeleton = _encode_skeleton(state.pdata, leaves)
    arrays = {f"pdata_{i}": _numpy(x) for i, x in enumerate(leaves)}
    for name, value in state._asdict().items():
        if name != "pdata":
            arrays[name] = _numpy(value)
    meta = {"version": 3, "pdata_leaves": [f"pdata_{i}" for i in range(len(leaves))],
            "pdata_skeleton": skeleton}
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _batch_shape(phi: np.ndarray, rows: int) -> tuple:
    """A [rows] per-lane field's shape in the batch layout of ``phi``: [K1, N]
    one lane, [B, K1, N] batch-leading, [K1, N, B] batch-native (K1 = 6)."""
    if phi.ndim == 2:
        return (rows,)
    if phi.shape[0] == 6 and phi.shape[1] != 6:
        return (rows, phi.shape[-1])
    return (phi.shape[0], rows)


def load_state(path: str, *, allow_pickle: bool = False, device=None) -> IdaState:
    """Read an IdaState written by :func:`save_state` (or by ``ida_tpu``)
    onto ``device`` (None: the current CUDA device). ``allow_pickle`` only
    admits a version-2 archive; leave it False for anything untrusted."""
    device = resolve_device(device)

    def tensor(arr) -> torch.Tensor:
        return torch.from_numpy(np.array(arr, copy=True)).to(device)

    with np.load(path) as data:
        meta = json.loads(bytes(data[_META_KEY].tobytes()).decode())
        leaves = [tensor(data[k]) for k in meta["pdata_leaves"]]
        if "pdata_skeleton" in meta:
            pdata = _decode_skeleton(meta["pdata_skeleton"], leaves)
        elif _PDATA_TREEDEF_KEY in data and not allow_pickle:
            raise ValueError("legacy version-2 checkpoint stores a pickled treedef; "
                             "pass allow_pickle=True only if the file is trusted")
        else:  # version 1, or version 2 read as its flat leaves
            pdata = tuple(leaves)
        phi = np.asarray(data["phi"])
        fields = {}
        for name in IdaState._fields:
            if name == "pdata":
                fields[name] = pdata
            elif name in data:
                fields[name] = tensor(data[name])
            elif name == "yQ":  # written before quadratures existed
                fields[name] = tensor(np.zeros(_batch_shape(phi, 1), data["yy"].dtype))
            elif name in ("ls_tn", "ls_cj"):  # written before the refined mode
                fields[name] = tensor(np.zeros_like(data["tn"]))
            elif name in ("ls_yy", "ls_yp"):
                fields[name] = tensor(np.zeros(_batch_shape(phi, 0), data["yy"].dtype))
            else:
                raise KeyError(f"checkpoint {path} has no field {name!r}")
    return IdaState(**fields)
