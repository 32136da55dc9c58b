"""Carry a z3 or z2 index's resident state across packages.

The state is a dict of numpy arrays and ints holding exactly the
attributes of the index (of either package), capacity padding included:
for a ``Z3PointIndex`` ``bins``, ``z``, ``pos``, ``x``, ``y``, ``dtg``,
``n_rows``, ``t_min_ms``, ``t_max_ms``, ``period`` and ``version``; for a
``Z2PointIndex`` ``z``, ``pos``, ``x``, ``y``, ``n_rows`` and ``version``.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .index.z2 import Z2PointIndex
from .index.z3 import Z3PointIndex

__all__ = ["z2_index_from_state", "z2_index_state", "z3_index_from_state",
           "z3_index_state"]

_COLUMNS = ("bins", "z", "pos", "x", "y", "dtg")
_Z2_COLUMNS = ("z", "pos", "x", "y")


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


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)
