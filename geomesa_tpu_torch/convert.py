"""Carry a z3 or z2 index's resident state across packages.

The state is a dict of numpy arrays and ints holding exactly the
attributes of the index (of either package), capacity padding included:
for a ``Z3PointIndex`` ``bins``, ``z``, ``pos``, ``x``, ``y``, ``dtg``,
``n_rows``, ``t_min_ms``, ``t_max_ms``, ``period`` and ``version``; for a
``Z2PointIndex`` ``z``, ``pos``, ``x``, ``y``, ``n_rows`` and ``version``.

A sharded index's state holds each column as an ``(n_shards, capacity)``
array, row ``s`` being shard ``s``'s slots (the JAX package's global
arrays reshaped), plus ``shard_counts``, ``segments`` (the residency
segments), ``n_total`` and ``version``, and for z3 the time extent and
``period``.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .index.z2 import Z2PointIndex
from .index.z3 import Z3PointIndex
from .parallel.scan import ShardedZ3Index
from .parallel.z2 import ShardedZ2Index

__all__ = ["sharded_index_state", "sharded_z2_index_from_state",
           "sharded_z3_index_from_state", "z2_index_from_state",
           "z2_index_state", "z3_index_from_state", "z3_index_state"]

_COLUMNS = ("bins", "z", "pos", "x", "y", "dtg")
_Z2_COLUMNS = ("z", "pos", "x", "y")
_SHARDED_Z3_COLUMNS = ("bins", "z", "gid", "x", "y", "dtg")
_SHARDED_Z2_COLUMNS = ("z", "gid", "x", "y")


def z3_index_from_state(state: dict, device=None) -> Z3PointIndex:
    """A port ``Z3PointIndex`` on ``device`` holding ``state``'s columns
    (copied: the index updates its columns in place on append)."""
    dev = resolve_device(device)
    cols = {k: torch.tensor(np.asarray(state[k]), device=dev)
            for k in _COLUMNS}
    idx = Z3PointIndex(str(state["period"]), version=int(state["version"]),
                       **cols)
    idx._n_rows = int(state["n_rows"])
    for k in ("t_min_ms", "t_max_ms"):
        v = state[k]
        setattr(idx, k, None if v is None else int(v))
    return idx


def z3_index_state(idx) -> dict:
    """The resident state of a ``Z3PointIndex`` (of either package) as
    numpy arrays and ints."""
    state = {k: _to_numpy(getattr(idx, k)) for k in _COLUMNS}
    state.update(n_rows=len(idx), t_min_ms=idx.t_min_ms,
                 t_max_ms=idx.t_max_ms, period=str(idx.period.value),
                 version=int(idx.version))
    return state


def z2_index_from_state(state: dict, device=None) -> Z2PointIndex:
    """A port ``Z2PointIndex`` on ``device`` holding ``state``'s columns
    (copied: the index updates its columns in place on append)."""
    dev = resolve_device(device)
    cols = {k: torch.tensor(np.asarray(state[k]), device=dev)
            for k in _Z2_COLUMNS}
    return Z2PointIndex(version=int(state["version"]),
                        n_rows=int(state["n_rows"]), **cols)


def z2_index_state(idx) -> dict:
    """The resident state of a ``Z2PointIndex`` (of either package) as
    numpy arrays and ints."""
    state = {k: _to_numpy(getattr(idx, k)) for k in _Z2_COLUMNS}
    state.update(n_rows=len(idx), version=int(idx.version))
    return state


def _shard_columns(state: dict, names, mesh) -> list:
    """Per-column lists of per-shard tensors, shard ``s`` on ``mesh[s]``
    (copied: the index updates its columns in place on append)."""
    out = []
    for k in names:
        a = np.asarray(state[k])
        if a.shape[0] != mesh.size:
            raise ValueError(f"state column {k!r} holds {a.shape[0]} shards, "
                             f"the mesh {mesh.size}")
        out.append([torch.tensor(a[s], device=d) for s, d in enumerate(mesh)])
    return out


def _segments(state: dict) -> list:
    return [tuple(int(v) for v in seg) for seg in state["segments"]]


def sharded_z3_index_from_state(state: dict, mesh) -> ShardedZ3Index:
    """A port ``ShardedZ3Index`` over ``mesh`` holding ``state``'s
    per-shard columns (see the module doc)."""
    idx = ShardedZ3Index(
        mesh, str(state["period"]), *_shard_columns(
            state, _SHARDED_Z3_COLUMNS, mesh),
        n_total=int(state["n_total"]),
        shard_counts=np.asarray(state["shard_counts"], np.int64),
        t_min_ms=None if state["t_min_ms"] is None else int(state["t_min_ms"]),
        t_max_ms=None if state["t_max_ms"] is None else int(state["t_max_ms"]),
        version=int(state["version"]))
    idx._segments = _segments(state)
    return idx


def sharded_z2_index_from_state(state: dict, mesh) -> ShardedZ2Index:
    """A port ``ShardedZ2Index`` over ``mesh`` holding ``state``'s
    per-shard columns (see the module doc)."""
    idx = ShardedZ2Index(
        mesh, *_shard_columns(state, _SHARDED_Z2_COLUMNS, mesh),
        n_total=int(state["n_total"]),
        shard_counts=np.asarray(state["shard_counts"], np.int64),
        version=int(state["version"]))
    idx._segments = _segments(state)
    return idx


def sharded_index_state(idx) -> dict:
    """The resident state of a sharded z3 or z2 index (of either
    package) as numpy arrays and ints: a JAX global array is reshaped to
    ``(n_shards, capacity)``, a port index's per-shard tensors stacked."""
    n_shards = len(idx._shard_counts)
    names = (_SHARDED_Z3_COLUMNS if hasattr(idx, "bins")
             else _SHARDED_Z2_COLUMNS)
    state = {}
    for k in names:
        col = getattr(idx, k)
        state[k] = (np.stack([_to_numpy(t) for t in col])
                    if isinstance(col, list)
                    else _to_numpy(col).reshape(n_shards, -1))
    state.update(shard_counts=np.asarray(idx._shard_counts, np.int64),
                 segments=list(idx._segments), n_total=int(len(idx)),
                 version=int(idx.version))
    if hasattr(idx, "bins"):
        state.update(t_min_ms=idx.t_min_ms, t_max_ms=idx.t_max_ms,
                     period=str(idx.period.value))
    return state


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)
