"""The device mesh and batch sharding.

The JAX package's mesh is a one-axis ``jax.sharding.Mesh`` whose ``shard``
axis spreads the feature axis over devices, the role of the reference's
tablet-server spread (ShardStrategy, api/ShardStrategy.scala:17-75).  The
port's mesh is an ordered tuple of ``torch.device``s, one shard each: a
program that JAX runs inside ``shard_map`` is a loop over the mesh's
devices here, and a ``psum`` the sum of the per-shard partials.  One
process drives every device of the mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["DeviceMesh", "device_mesh", "pad_to_multiple", "shard_batch"]


class DeviceMesh(tuple):
    """An ordered tuple of ``torch.device``s: shard ``s`` lives on
    ``mesh[s]``."""

    @property
    def devices(self) -> tuple:
        return tuple(self)

    @property
    def size(self) -> int:
        return len(self)


def device_mesh(n_devices: int | None = None, *,
                devices=None) -> DeviceMesh:
    """1-D mesh over the first ``n_devices`` CUDA devices (default: all),
    or over ``devices`` when named (e.g. ``devices=["cpu"] * 8``, the CPU
    tests' analog of the JAX package's 8-device virtual CPU mesh).
    Without a card and without named devices this raises, as
    :func:`~geomesa_tpu_torch.device.resolve_device` does."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devs):
            raise ValueError(f"device_mesh: {n_devices} devices asked, "
                             f"{len(devs)} available")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("device_mesh: no devices")
    return DeviceMesh(devs)


def pad_to_multiple(a: np.ndarray, padded_n: int) -> np.ndarray:
    """Zero-pad the leading axis to ``padded_n`` rows."""
    a = np.asarray(a)
    if padded_n == len(a):
        return a
    pad = np.zeros((padded_n - len(a),) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([a, pad])


def shard_batch(mesh: DeviceMesh, *arrays):
    """Pad host arrays to a multiple of the mesh size and put slice ``s``
    on device ``s``.  Returns ``(shards, valid)``: ``shards[k][s]`` is
    array ``k``'s slice on shard ``s`` and ``valid[s]`` marks its real
    rows."""
    n_shards = mesh.size
    n = len(arrays[0])
    per = -(-n // n_shards)
    padded = [pad_to_multiple(a, per * n_shards) for a in arrays]
    valid = np.arange(per * n_shards) < n

    def split(a):
        return [torch.tensor(a[s * per:(s + 1) * per], device=d)
                for s, d in enumerate(mesh)]

    return [split(a) for a in padded], split(valid)
