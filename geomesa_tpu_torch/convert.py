"""Carry a z3 or z2 index's resident state across packages.

The state is a dict of numpy arrays and ints holding exactly the
attributes of the index (of either package), capacity padding included:
for a ``Z3PointIndex`` ``bins``, ``z``, ``pos``, ``x``, ``y``, ``dtg``,
``n_rows``, ``t_min_ms``, ``t_max_ms``, ``period`` and ``version``; for a
``Z2PointIndex`` ``z``, ``pos``, ``x``, ``y``, ``n_rows`` and ``version``.

A ``LeanZ3Index``'s state holds its settings (``period``, ``version``,
``generation_slots``, ``hbm_budget_bytes``, ``payload_on_device``,
``compaction_factor``), ``n_rows``, the time extent, the host payload
``(x, y, t)`` and, per generation, ``tier``, ``n``, ``base``, ``gen_id``
and its columns: ``bins``, ``z`` and ``pos`` (the whole capacity of a
device tier, the ``n`` rows of a host run) and, on the full tier, ``x``,
``y`` and ``t``.

A sharded index's state holds each column as an ``(n_shards, capacity)``
array, row ``s`` being shard ``s``'s slots (the JAX package's global
arrays reshaped), plus ``shard_counts``, ``segments`` (the residency
segments), ``n_total`` and ``version``, and for z3 the time extent and
``period``.

An ``XZ2Index``'s state holds ``g``, ``codes``, ``pos``, ``bbox`` and the
packed geometries ``geoms`` (a dict of the ``PackedGeometry`` buffers);
an ``XZ3Index``'s adds ``period``, ``bins`` and ``dtg``.  A sharded XZ
index's state holds ``codes``, ``gid``, ``bx0``, ``by0``, ``bx1``,
``by1`` (and for XZ3 ``bins`` and ``dtg``) as ``(n_shards, capacity)``
arrays, with ``g``, ``n_total``, ``geoms`` (and ``period``).  A lean XZ
index's state (``LeanXZ2Index`` / ``LeanXZ3Index``) holds ``kind``,
``g``, the time extent and ``period`` for XZ3, and its core
``LeanAttrIndex``'s settings (``generation_slots``,
``hbm_budget_bytes``, ``compaction_factor``), ``n_rows`` and, per
generation, ``tier``, ``n``, ``gen_id`` and ``keys``, ``sec``, ``gid``
(the whole capacity of a device run, the ``n`` rows of a host run).

Every index state keeps its key-layout ``version``: a v1 state rebuilds
an index on the legacy curve (``curve/legacy.py``).

A schema store's row-level state (:func:`schema_store_state`) holds its
``tombstone`` (or None), ``visibilities`` (or None), the per-attribute
``attr_visibilities``, ``index_versions`` and ``next_fid``; its columns
are not part of it (write the same rows into both stores).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .geometry.packed import PackedGeometry
from .index.attr_lean import _AttrGeneration
from .index.xz2 import XZ2Index
from .index.xz2_lean import LeanXZ2Index, LeanXZ3Index
from .index.xz3 import XZ3Index
from .index.z2 import Z2PointIndex
from .index.z3 import Z3PointIndex
from .index.z3_lean import HostRun, LeanZ3Index, _Generation
from .parallel.scan import ShardedZ3Index
from .parallel.xz import ShardedXZ2Index, ShardedXZ3Index
from .parallel.z2 import ShardedZ2Index

__all__ = ["apply_schema_store_state", "schema_store_state",
           "lean_xz_index_from_state", "lean_xz_index_state",
           "lean_z3_index_from_state", "lean_z3_index_state",
           "sharded_index_state", "sharded_xz_index_from_state",
           "sharded_xz_index_state", "sharded_z2_index_from_state",
           "sharded_z3_index_from_state", "xz_index_from_state",
           "xz_index_state", "z2_index_from_state", "z2_index_state",
           "z3_index_from_state", "z3_index_state"]

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


def lean_z3_index_state(idx) -> dict:
    """The state of a ``LeanZ3Index`` (of either package) as numpy arrays
    and ints (see the module doc)."""
    gens = []
    for g in idx.generations:
        d = {"tier": g.tier, "n": int(g.n), "base": int(g.base),
             "gen_id": int(g.gen_id)}
        if g.tier == "host":
            run = g.run
            # a stacked run's bins live in its segment table
            d.update(bins=np.repeat(run._bin_vals, np.diff(run._bin_starts)),
                     z=np.array(run.z), pos=np.array(run.pos))
        else:
            names = (("bins", "z", "pos", "x", "y", "t")
                     if g.tier == "full" else ("bins", "z", "pos"))
            d.update({k: _to_numpy(getattr(g, k)) for k in names})
        gens.append(d)
    x, y, t = (np.array(a) for a in idx._payload_flat())
    return {"generations": gens, "n_rows": len(idx),
            "t_min_ms": idx.t_min_ms, "t_max_ms": idx.t_max_ms,
            "period": str(idx.period.value), "version": int(idx.version),
            "generation_slots": int(idx.generation_slots),
            "hbm_budget_bytes": int(idx.hbm_budget_bytes),
            "payload_on_device": bool(idx.payload_on_device),
            "compaction_factor": int(idx.compaction_factor),
            "payload": (x, y, t)}


def lean_z3_index_from_state(state: dict, device=None) -> LeanZ3Index:
    """A port ``LeanZ3Index`` holding ``state``'s generations: device
    tiers on ``device`` (copied), host runs in host RAM."""
    idx = LeanZ3Index(
        period=str(state["period"]), version=int(state["version"]),
        generation_slots=int(state["generation_slots"]),
        hbm_budget_bytes=int(state["hbm_budget_bytes"]),
        payload_on_device=bool(state["payload_on_device"]),
        compaction_factor=int(state["compaction_factor"]), device=device)
    dev = idx.device
    for d in state["generations"]:
        if d["tier"] == "host":
            gen = _Generation.merged_host(
                HostRun(*(np.array(d[k]) for k in ("bins", "z", "pos"))),
                base=int(d["base"]))
        else:
            cols = [torch.tensor(np.asarray(d[k]), device=dev)
                    for k in ("bins", "z", "pos")]
            payload = (tuple(torch.tensor(np.asarray(d[k]), device=dev)
                             for k in ("x", "y", "t"))
                       if d["tier"] == "full" else None)
            gen = _Generation.from_columns(d["tier"], *cols, n=int(d["n"]),
                                           base=int(d["base"]),
                                           payload=payload)
        gen.gen_id = int(d["gen_id"])
        idx.generations.append(gen)
    idx._gen_counter = max([g.gen_id for g in idx.generations], default=0)
    idx._n_rows = int(state["n_rows"])
    for k in ("t_min_ms", "t_max_ms"):
        v = state[k]
        setattr(idx, k, None if v is None else int(v))
    idx._payload = [tuple(np.asarray(a) for a in state["payload"])]
    return idx


_PACKED_FIELDS = ("kinds", "coords", "ring_offsets", "part_ring_offsets",
                  "geom_part_offsets", "bbox")
_SHARDED_XZ_COLUMNS = ("codes", "gid", "bx0", "by0", "bx1", "by1")


def _packed_state(geoms) -> dict | None:
    if geoms is None:
        return None
    return {k: np.array(getattr(geoms, k)) for k in _PACKED_FIELDS}


def _packed_from_state(d: dict | None) -> PackedGeometry | None:
    if d is None:
        return None
    return PackedGeometry(**{k: np.array(d[k]) for k in _PACKED_FIELDS})


def xz_index_state(idx) -> dict:
    """The state of an ``XZ2Index`` or ``XZ3Index`` (of either package)
    as numpy arrays and ints (see the module doc)."""
    state = {"g": int(idx.sfc.g), "codes": np.array(idx.codes),
             "pos": np.array(idx.pos), "bbox": np.array(idx.bbox),
             "geoms": _packed_state(idx.geoms)}
    if hasattr(idx, "bins"):
        state.update(period=str(idx.period.value), bins=np.array(idx.bins),
                     dtg=np.array(idx.dtg))
    return state


def xz_index_from_state(state: dict):
    """A port ``XZ3Index`` (when the state has ``bins``) or ``XZ2Index``
    holding ``state``'s columns (host arrays, copied)."""
    geoms = _packed_from_state(state["geoms"])
    cols = [np.array(state[k]) for k in ("codes", "pos", "bbox")]
    if "bins" in state:
        return XZ3Index(str(state["period"]), int(state["g"]),
                        np.array(state["bins"]), *cols,
                        np.array(state["dtg"]), geoms)
    return XZ2Index(int(state["g"]), *cols, geoms)


def sharded_xz_index_state(idx) -> dict:
    """The state of a sharded XZ2 or XZ3 index (of either package): a
    JAX global array reshaped to ``(n_shards, capacity)``, a port index's
    per-shard tensors stacked."""
    n_shards = (len(idx.codes) if isinstance(idx.codes, list)
                else idx.mesh.devices.size)

    def cols(col):
        return (np.stack([_to_numpy(t) for t in col])
                if isinstance(col, list)
                else _to_numpy(col).reshape(n_shards, -1))
    state = dict(zip(_SHARDED_XZ_COLUMNS,
                     [cols(idx.codes), cols(idx.gid)]
                     + [cols(c) for c in idx.bbox_cols]))
    state.update(g=int(idx.sfc.g), n_total=int(len(idx)),
                 geoms=_packed_state(idx.geoms))
    if hasattr(idx, "bins"):
        state.update(bins=cols(idx.bins), dtg=cols(idx.dtg),
                     period=str(idx.period.value))
    return state


def sharded_xz_index_from_state(state: dict, mesh):
    """A port ``ShardedXZ3Index`` (when the state has ``bins``) or
    ``ShardedXZ2Index`` over ``mesh`` holding ``state``'s per-shard
    columns."""
    codes, gid, *bbox = _shard_columns(state, _SHARDED_XZ_COLUMNS, mesh)
    geoms = _packed_from_state(state["geoms"])
    if "bins" in state:
        bins, dtg = _shard_columns(state, ("bins", "dtg"), mesh)
        return ShardedXZ3Index(mesh, str(state["period"]), int(state["g"]),
                               bins, codes, gid, bbox, dtg, geoms,
                               int(state["n_total"]))
    return ShardedXZ2Index(mesh, int(state["g"]), codes, gid, bbox, geoms,
                           int(state["n_total"]))


def lean_xz_index_state(idx) -> dict:
    """The state of a ``LeanXZ2Index`` or ``LeanXZ3Index`` (of either
    package) through its ``LeanAttrIndex`` core (see the module doc)."""
    core = idx._core
    gens = []
    for g in core.generations:
        d = {"tier": g.tier, "n": int(g.n), "gen_id": int(g.gen_id)}
        src = (g.spilled if g.tier == "host"
               else (g.keys, g.sec, g.gid))
        d.update(zip(("keys", "sec", "gid"),
                     (np.array(_to_numpy(a)) for a in src)))
        gens.append(d)
    state = {"kind": "xz3" if hasattr(idx, "period") else "xz2",
             "g": int(idx.g), "generations": gens, "n_rows": len(core),
             "generation_slots": int(core.generation_slots),
             "hbm_budget_bytes": int(core.hbm_budget_bytes),
             "compaction_factor": int(core.compaction_factor)}
    if state["kind"] == "xz3":
        state.update(period=str(idx.period.value), t_min_ms=idx.t_min_ms,
                     t_max_ms=idx.t_max_ms)
    return state


def lean_xz_index_from_state(state: dict, device=None):
    """A port ``LeanXZ3Index`` or ``LeanXZ2Index`` holding ``state``'s
    generations: device runs on ``device`` (copied), host runs in host
    RAM."""
    settings = dict(generation_slots=int(state["generation_slots"]),
                    hbm_budget_bytes=int(state["hbm_budget_bytes"]),
                    compaction_factor=int(state["compaction_factor"]),
                    device=device)
    if state["kind"] == "xz3":
        idx = LeanXZ3Index(period=str(state["period"]), g=int(state["g"]),
                           **settings)
        for k in ("t_min_ms", "t_max_ms"):
            v = state[k]
            setattr(idx, k, None if v is None else int(v))
    else:
        idx = LeanXZ2Index(g=int(state["g"]), **settings)
    core = idx._core
    for d in state["generations"]:
        cols = [np.array(d[k]) for k in ("keys", "sec", "gid")]
        if d["tier"] == "host":
            gen = _AttrGeneration.merged_host(cols)
        else:
            gen = _AttrGeneration.merged_device(
                *(torch.tensor(c, device=core.device) for c in cols),
                n=int(d["n"]))
        gen.gen_id = int(d["gen_id"])
        core.generations.append(gen)
    core._gen_counter = max([g.gen_id for g in core.generations], default=0)
    core._n_rows = int(state["n_rows"])
    return idx


def schema_store_state(store) -> dict:
    """The row-level state of a schema store (of either package; see the
    module doc), copied."""
    def labels(a):
        return None if a is None else np.array(a, dtype=object)

    return {"tombstone": (None if store.tombstone is None
                          else np.array(store.tombstone, dtype=bool)),
            "visibilities": labels(store.visibilities),
            "attr_visibilities": {k: labels(v) for k, v
                                  in store.attr_visibilities.items()},
            "index_versions": {k: int(v)
                               for k, v in store.index_versions.items()},
            "next_fid": int(store.next_fid)}


def apply_schema_store_state(store, state: dict) -> None:
    """Give a port schema store ``state``'s row-level state (copied); its
    built indexes are dropped, as their layout versions may change."""
    tomb = state["tombstone"]
    store.tombstone = None if tomb is None else np.array(tomb, dtype=bool)
    vis = state["visibilities"]
    store.visibilities = None if vis is None else np.array(vis, dtype=object)
    store.attr_visibilities = {k: np.array(v, dtype=object)
                               for k, v in state["attr_visibilities"].items()}
    store.index_versions = dict(state["index_versions"])
    store.next_fid = int(state["next_fid"])
    store._vis_masks = {}
    if store.tombstone is not None and store.tombstone.any():
        # the deleting store recomputed its sketches over the live rows
        store.recompute_stats()
    # each index rebuilds (a lean one streams the column store) at the
    # carried layout versions
    store.drop_indexes()


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)
