"""Feature-id generation with z-curve locality.

The port's copy of the JAX package's ``utils/feature_id.py``: the analog
of the reference's Z3FeatureIdGenerator / Version4UuidGenerator
(geomesa-utils/.../uuid/Z3FeatureIdGenerator.scala).  Version-4-shaped
UUIDs whose LEADING bytes follow the feature's Z3 key order, so ids of
spatio-temporally nearby features sort near each other.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from ..curve.binnedtime import TimePeriod, to_binned_time
from ..curve.sfc import z3_sfc

__all__ = ["z3_feature_ids", "random_feature_id"]


def random_feature_id() -> str:
    """Random version-4 UUID string (Version4UuidGenerator analog)."""
    b = bytearray(secrets.token_bytes(16))
    b[6] = (b[6] & 0x0F) | 0x40
    b[8] = (b[8] & 0x3F) | 0x80
    return _fmt(bytes(b))


def _fmt(b: bytes) -> str:
    h = b.hex()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


def z3_feature_ids(x, y, dtg_ms,
                   period: TimePeriod | str = TimePeriod.WEEK) -> np.ndarray:
    """Vectorized z-prefixed UUIDs for a batch of point features.

    Byte layout (UUIDv4-shaped, lexicographic string order == (bin, z)
    key-prefix order — the fixed version nibble is identical across ids
    so it never perturbs relative order):

    ========  ==================================================
    bytes     content
    ========  ==================================================
    0–1       time bin (big-endian)
    2–5       z bits 62..31
    6         ``0x4_`` version nibble + z bits 30..27
    7         z bits 26..19
    8         ``10``-variant bits + 6 random bits
    9–15      random
    ========  ==================================================

    The keys are encoded on the CPU, whatever device the store uses."""
    period = TimePeriod.parse(period)
    sfc = z3_sfc(period)
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    dtg_ms = np.asarray(dtg_ms, dtype=np.int64)
    bins, offs = to_binned_time(dtg_ms, period)
    z = sfc.index(torch.from_numpy(x), torch.from_numpy(y),
                  torch.from_numpy(offs.astype(np.float64))).numpy()
    n = len(x)
    out = np.empty(n, dtype=object)
    rand = np.frombuffer(secrets.token_bytes(8 * n), dtype=np.uint8
                         ).reshape(n, 8).copy()
    for i in range(n):
        b = bytearray(16)
        b[0] = (int(bins[i]) >> 8) & 0xFF
        b[1] = int(bins[i]) & 0xFF
        zi = int(z[i])
        top32 = (zi >> 31) & 0xFFFFFFFF
        b[2] = (top32 >> 24) & 0xFF
        b[3] = (top32 >> 16) & 0xFF
        b[4] = (top32 >> 8) & 0xFF
        b[5] = top32 & 0xFF
        b[6] = 0x40 | ((zi >> 27) & 0x0F)
        b[7] = (zi >> 19) & 0xFF
        b[8:16] = rand[i].tobytes()
        b[8] = (b[8] & 0x3F) | 0x80
        out[i] = _fmt(bytes(b))
    return out
