"""Several processes: the multi-controller mode on ``torch.distributed``.

The reference scales across machines with its storage cluster's RPC
fabric (Accumulo Thrift scans, HBase coprocessor streams; SURVEY.md
§2.7).  The JAX package rides JAX's multi-controller runtime: every host
runs the same program and its ``shard_map`` programs span every
process's devices.  Here every process runs the same store program over
a mesh of ITS OWN devices (:func:`global_device_mesh`) and feeds only its
local rows; the cross-process steps are explicit collectives:

* **host arrays** (counts, gids, strings, stat JSON) travel through the
  default process group, a CPU ``gloo`` group, as numpy arrays viewed as
  bytes in CPU tensors (:func:`allgather_concat`, :func:`agreed_int`,
  :func:`allgather_strings`);
* **device partials** (density grids, histogram and count-min tables,
  range counts) reduce with ``torch.distributed.all_reduce`` on the
  device tensor over a second group whose backend the caller names
  (:func:`allreduce_tensor`): ``nccl`` where every process has its own
  card, ``gloo`` where processes share one (NCCL refuses two ranks on
  one device; gloo stages CUDA tensors through the host).

With no process group initialized the process is rank 0 of a world of 1
and every collective is the identity — the JAX package's
``process_count() == 1``, which runs its multihost mode without
``jax.distributed.initialize``.

No collective is retried or caught: one that fails or outlives the
group's timeout raises, and the run fails.

**Position semantics.**  A process's rows fill its local shards front to
back in blocks of one AGREED padded length (the allgathered maximum
local row count); the global shard numbering is process-contiguous (the
shards of process ``p`` are ``p * L .. p * L + L - 1`` for ``L`` local
shards), and gids code ``process << GID_PROC_SHIFT | local_row``.
"""

from __future__ import annotations

import datetime
import logging

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DeviceMesh, device_mesh, pad_to_multiple

__all__ = ["initialize_distributed", "shutdown_distributed",
           "process_index", "process_count", "device_backend",
           "global_device_mesh", "local_device_count", "agreed_int",
           "allgather_concat", "allgather_strings", "allreduce_tensor",
           "global_shard_counts", "agree_append_layout",
           "process_local_shard"]

_log = logging.getLogger(__name__)

#: the device-partial group and its backend name (None: no group)
_DEVICE_GROUP = None
_DEVICE_BACKEND: str | None = None


def initialize_distributed(coordinator_address: str, num_processes: int,
                           process_id: int, *, timeout_s: float = 180.0,
                           device_backend: str = "nccl") -> None:
    """Join this process into a group of ``num_processes`` over TCP at
    ``coordinator_address`` (``host:port``, process 0 listens there).
    The host group is ``gloo``; the device group's backend is
    ``device_backend`` (``nccl`` with one card per process, ``gloo``
    where processes share a card).  A collective that does not complete
    within ``timeout_s`` raises.  Call once per process before any store
    operation; a one-process run may skip it."""
    global _DEVICE_GROUP, _DEVICE_BACKEND
    if device_backend not in ("nccl", "gloo"):
        raise ValueError(f"device_backend must be 'nccl' or 'gloo', "
                         f"got {device_backend!r}")
    timeout = datetime.timedelta(seconds=float(timeout_s))
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)
    _DEVICE_GROUP = dist.new_group(backend=device_backend, timeout=timeout)
    _DEVICE_BACKEND = device_backend
    _log.warning("geomesa multihost: process %d of %d, host group gloo, "
                 "device group %s", process_id, num_processes,
                 device_backend)


def shutdown_distributed() -> None:
    """Leave the process group (no-op without one).  The kernel gates'
    agreed probe outcomes held for this group's processes, so they are
    forgotten with it."""
    global _DEVICE_GROUP, _DEVICE_BACKEND
    from ..ops.gate import forget_agreements
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE_GROUP = None
    _DEVICE_BACKEND = None
    forget_agreements()


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """Processes in the group (1 without a process group)."""
    return dist.get_world_size() if _initialized() else 1


def device_backend() -> str | None:
    """The device group's backend name, or None without a group."""
    return _DEVICE_BACKEND if _initialized() else None


def global_device_mesh(devices=None) -> DeviceMesh:
    """This process's part of the global mesh: ``devices`` when named
    (e.g. ``["cpu"] * 4`` on the CPU), else one card per process,
    ``cuda:{rank % cards}`` (processes share cards when there are fewer
    cards than processes).  Global shard ``p * L + s`` is local shard
    ``s`` of process ``p``."""
    if devices is None:
        from ..device import resolve_device
        resolve_device("cuda")
        devices = [f"cuda:{process_index() % torch.cuda.device_count()}"]
    return device_mesh(devices=devices)


def local_device_count(mesh: DeviceMesh) -> int:
    """Devices of THIS process in the mesh (its local shard count)."""
    return max(1, mesh.size)


# -- host collectives (the gloo default group) ----------------------------
def _allgather_equal(buf: np.ndarray) -> list[np.ndarray]:
    """All-gather one equal-length uint8 buffer per process, in process
    order."""
    t = torch.from_numpy(np.ascontiguousarray(buf, dtype=np.uint8))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return [o.numpy() for o in out]


def agreed_int(value: int, op: str = "sum") -> int:
    """Agree an integer across processes (``sum``/``max``/``min`` of the
    per-process values); the identity with one process.  Used wherever
    every process must reach the same decision from per-process inputs
    (slot sizing, capacity growth, totals, gates)."""
    if process_count() == 1:
        return int(value)
    vals = np.concatenate([p.view(np.int64) for p in _allgather_equal(
        np.array([int(value)], np.int64).view(np.uint8))])
    return int({"sum": vals.sum, "max": vals.max, "min": vals.min}[op]())


def allgather_concat(a: np.ndarray) -> np.ndarray:
    """Concatenate per-process host arrays of UNEQUAL lengths in process
    order (lengths first, then one pad-to-max gather of the raw bytes).
    The host merge of per-process partial results — residual-filter
    survivors, local hit lists — bounded by the result size, never the
    dataset.  Every process must pass the same dtype and row shape."""
    a = np.ascontiguousarray(a)
    if process_count() == 1:
        return a
    lens = [int(p.view(np.int64)[0]) for p in _allgather_equal(
        np.array([len(a)], np.int64).view(np.uint8))]
    m = max(lens)
    if m == 0:
        return a[:0]
    pad = np.zeros((m,) + a.shape[1:], dtype=a.dtype)
    pad[:len(a)] = a
    parts = _allgather_equal(pad.reshape(-1).view(np.uint8))
    return np.concatenate([
        p.view(a.dtype).reshape((m,) + a.shape[1:])[:n]
        for p, n in zip(parts, lens)])


def allgather_strings(arr: np.ndarray) -> np.ndarray:
    """Concatenate per-process STRING arrays across processes: strings
    travel as a NUL-terminated UTF-8 byte blob through
    :func:`allgather_concat` (dictionaries, stat JSON, ids — bounded by
    cardinality, not row count)."""
    arr = np.asarray(arr)
    if process_count() == 1:
        return arr
    blob = "".join(s + "\x00" for s in arr.astype(str).tolist())
    merged = allgather_concat(np.frombuffer(blob.encode("utf-8"),
                                            dtype=np.uint8))
    text = merged.tobytes().decode("utf-8")
    parts = text.split("\x00")[:-1] if text else []
    if not parts:
        return arr[:0]
    return (np.asarray(parts, dtype=object) if arr.dtype == object
            else np.asarray(parts))


# -- device collectives ----------------------------------------------------
_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def allreduce_tensor(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Reduce a device partial (a grid, a histogram, a count) over every
    process in place on its device, through the device group; the
    identity with one process.  Returns ``t``."""
    if process_count() == 1:
        return t
    dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]),
                    group=_DEVICE_GROUP)
    return t


# -- the process-contiguous block layout ------------------------------------
def _agreed_padded_local(n_local: int, n_local_shards: int) -> int:
    """Padded per-process block length, identical on every process: the
    maximum local row count rounded to the local shard multiple."""
    n = agreed_int(n_local, "max")
    return -(-n // n_local_shards) * n_local_shards


def global_shard_counts(n_local: int, mesh: DeviceMesh,
                        m_per: int | None = None) -> np.ndarray:
    """Per-shard valid row counts of the process-contiguous block layout
    over every process's shards, identical on every process: each
    process's ``n_local`` rows fill its local shards front to back in
    blocks of the agreed per-shard length (``m_per`` overrides it, as an
    append does)."""
    local_shards = local_device_count(mesh)
    counts = allgather_concat(np.array([n_local], np.int64))
    per = (m_per if m_per is not None
           else _agreed_padded_local(n_local, local_shards) // local_shards)
    per = max(per, 1)
    return np.concatenate([
        np.clip(int(c) - np.arange(local_shards) * per, 0, per)
        for c in counts]).astype(np.int64)


def agree_append_layout(mesh: DeviceMesh, m_local: int,
                        minimum: int = 8) -> tuple[int, int, int]:
    """Agree the per-shard slot count of a multihost append from the
    LARGEST process load, so the grow decision derived from it is the
    same everywhere.  Returns ``(m_per_shard, slots_local,
    local_shards)``; every sharded index's multihost append shares it."""
    from ..ops.search import gather_capacity
    local_shards = local_device_count(mesh)
    m_per = gather_capacity(
        agreed_int(-(-max(m_local, 1) // local_shards), "max"),
        minimum=minimum)
    return m_per, m_per * local_shards, local_shards


def process_local_shard(mesh: DeviceMesh, *arrays,
                        padded_local: int | None = None):
    """Place this process's rows on its local shards: each array pads to
    the agreed per-process block length (``padded_local`` overrides it)
    and slice ``s`` goes to local device ``s``.  Returns ``(shards,
    valid)`` in :func:`~geomesa_tpu_torch.parallel.mesh.shard_batch`'s
    form: ``shards[k][s]`` is array ``k``'s slice on local shard ``s``,
    ``valid[s]`` marks its real rows."""
    n_shards = local_device_count(mesh)
    n = len(arrays[0])
    padded = (padded_local if padded_local is not None
              else _agreed_padded_local(n, n_shards))
    per = padded // n_shards
    valid = np.arange(padded) < n

    def split(a):
        a = pad_to_multiple(np.asarray(a), padded)
        return [torch.tensor(a[s * per:(s + 1) * per], device=d)
                for s, d in enumerate(mesh)]

    return [split(a) for a in arrays], split(valid)
