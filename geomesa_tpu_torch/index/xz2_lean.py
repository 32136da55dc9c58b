"""LeanXZ2Index / LeanXZ3Index: tiered generational XZ indexes —
polygons and lines at the lean profile's scale.

The port of the JAX package's ``index/xz2_lean.py``.  The reference's XZ
indexes are first-class at cluster scale
(geomesa-z3/.../curve/XZ2SFC.scala:54-77,
geomesa-index-api/.../index/z2/XZ2IndexKeySpace.scala:44).  Here the XZ
key spaces ride the lean generational machinery: a sequence code IS an
order-preserving int64, so the sorted runs, device/host residency tiers,
device budget, stacked host bisection and seek loops of
:class:`~geomesa_tpu_torch.index.attr_lean.LeanAttrIndex` serve them
verbatim — for XZ2 ``key`` = the code (``sec`` unused), for XZ3
``(key, sec)`` = ``(bin, code)``.  The device generations hold the codes
on the card.

Queries plan covering code ranges on the host (``XZ2SFC.ranges`` /
:func:`~geomesa_tpu_torch.index.xz3.xz3_bin_code_ranges`, the native
sweep when it is available), seek every generation, and return
CANDIDATE gids; the planner's residual filter applies the exact geometry
predicate (the client-side re-check, the host index's split).  Codes are
encoded on the host with numpy, as the JAX package encodes them.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_MAX_RANGES
from ..curve.binnedtime import TimePeriod
from ..curve.xz2 import xz2_sfc
from ..curve.xz3 import xz3_sfc
from ..geometry.types import Geometry
from .attr_lean import LeanAttrIndex
from .xz3 import xz3_bin_code_ranges, xz3_codes

__all__ = ["LeanCoreFacade", "LeanXZ2Index", "LeanXZ3Index", "XZ2Facade"]


class LeanCoreFacade:
    """Delegation base over a generational ``(key, sec, gid)`` core — the
    one definition of the core surface every lean XZ facade presents."""

    def __init__(self, core):
        self._core = core

    def __len__(self) -> int:
        return len(self._core)

    @property
    def generations(self):
        return self._core.generations

    @property
    def hbm_budget_bytes(self) -> int:
        return self._core.hbm_budget_bytes

    @property
    def dispatch_count(self) -> int:
        return self._core.dispatch_count

    def device_bytes(self) -> int:
        return self._core.device_bytes()

    def host_key_bytes(self) -> int:
        return self._core.host_key_bytes()

    def tier_counts(self) -> dict:
        return self._core.tier_counts()

    def storage_stats(self) -> dict:
        """Byte accounting of the core, tagged with the facade's kind."""
        st = self._core.storage_stats()
        st["kind"] = type(self).__name__
        return st

    def block(self) -> None:
        self._core.block()

    @property
    def compactions(self) -> int:
        return self._core.compactions

    def compact(self, budget_ms: float | None = None,
                factor: int | None = None,
                max_groups: int | None = None) -> dict:
        """Incremental size-tiered merge compaction of the core's runs
        (see LeanAttrIndex.compact)."""
        return self._core.compact(budget_ms=budget_ms, factor=factor,
                                  max_groups=max_groups)

    def sketch_scan(self, fold):
        """Stat-sketch fold over the core's own ``(key, sec)`` runs (see
        LeanAttrIndex.sketch_scan)."""
        return self._core.sketch_scan(fold)


class XZ2Facade(LeanCoreFacade):
    """The XZ2 surface over a generational core."""

    def __init__(self, core, g: int = 12):
        super().__init__(core)
        self.g = g
        self.sfc = xz2_sfc(g)

    def append_bboxes(self, bbox: np.ndarray,
                      base_gid: int | None = None) -> "XZ2Facade":
        """Stream one slice of per-feature envelopes ``(n, 4)`` in: encode
        sequence codes on the host, merge them into the current
        generation."""
        bb = np.asarray(bbox, np.float64).reshape((-1, 4))
        codes = self.sfc.index(bb[:, 0], bb[:, 1], bb[:, 2],
                               bb[:, 3]).astype(np.int64)
        self._core.append(codes, np.zeros(len(codes), np.int64),
                          base_gid=base_gid)
        return self

    def query(self, geometry: Geometry,
              max_ranges: int = DEFAULT_MAX_RANGES,
              exact: bool = True) -> np.ndarray:
        """CANDIDATE gids whose envelope code falls in the covering ranges
        of ``geometry``'s envelope.  ``exact`` is accepted for interface
        parity and ignored: exactness comes from the caller's residual
        geometry predicate (the code is envelope-granular by design)."""
        env = geometry.envelope
        ranges = self.sfc.ranges([env.as_tuple()], max_ranges=max_ranges)
        if not len(ranges) or not len(self):
            return np.empty(0, dtype=np.int64)
        return self._core.query_ranges(
            [(int(lo), int(hi), None, None, 0) for lo, hi in ranges])


class LeanXZ2Index(XZ2Facade):
    """Single-device generational tiered XZ2 index (module doc)."""

    def __init__(self, g: int = 12, generation_slots: int | None = None,
                 hbm_budget_bytes: int | None = None,
                 compaction_factor: int | None = None, device=None):
        super().__init__(LeanAttrIndex(
            "__xz2__", "long", generation_slots=generation_slots,
            hbm_budget_bytes=hbm_budget_bytes,
            compaction_factor=compaction_factor, device=device), g=g)


class LeanXZ3Index(LeanCoreFacade):
    """Generational tiered XZ3 index — polygons and lines WITH TIME at the
    lean scale (the reference's XZ3IndexKeySpace key = ``[2B bin][8B
    code]``).  The ``(bin, code)`` pair IS the core's ``(key, sec)``
    composite: per-bin code ranges seek with the two-key search the lean
    family shares.  Range planning is the shared
    :func:`~geomesa_tpu_torch.index.xz3.xz3_bin_code_ranges`."""

    def __init__(self, period="week", g: int = 12,
                 generation_slots: int | None = None,
                 hbm_budget_bytes: int | None = None,
                 compaction_factor: int | None = None, device=None,
                 core=None):
        """``core``: the generational ``(key, sec, gid)`` core to ride — a
        single-device :class:`LeanAttrIndex` by default (built from the
        other arguments), or a sharded one over a mesh
        (parallel/attr_lean.ShardedLeanXZ3Index)."""
        super().__init__(core if core is not None else LeanAttrIndex(
            "__xz3__", "long", generation_slots=generation_slots,
            hbm_budget_bytes=hbm_budget_bytes,
            compaction_factor=compaction_factor, device=device))
        self.period = TimePeriod.parse(period)
        self.g = g
        self.sfc = xz3_sfc(self.period, g)
        self.t_min_ms: int | None = None
        self.t_max_ms: int | None = None

    def append_bboxes(self, bbox: np.ndarray, dtg_ms: np.ndarray,
                      base_gid: int | None = None) -> "LeanXZ3Index":
        """Stream (envelope, timestamp) slices: per-row ``(bin, code)``
        keys into the generational runs; the running time extent clamps
        open query bounds."""
        bb = np.asarray(bbox, np.float64).reshape((-1, 4))
        t = np.ascontiguousarray(dtg_ms, np.int64)
        bins, codes = xz3_codes(self.sfc, bb, t)
        self._core.append(bins.astype(np.int64), codes, base_gid=base_gid)
        if len(t):
            t_min, t_max = int(t.min()), int(t.max())
            self.t_min_ms = (t_min if self.t_min_ms is None
                             else min(self.t_min_ms, t_min))
            self.t_max_ms = (t_max if self.t_max_ms is None
                             else max(self.t_max_ms, t_max))
        return self

    def query(self, geometry: Geometry, t_lo_ms=None, t_hi_ms=None,
              max_ranges: int = DEFAULT_MAX_RANGES,
              exact: bool = True) -> np.ndarray:
        """CANDIDATE gids for envelope ∩ ``[t_lo, t_hi]`` (open bounds
        clamp to the data's extent); the caller's residual predicate is
        the exactness stage."""
        if not len(self) or self.t_min_ms is None:
            return np.empty(0, dtype=np.int64)
        t_lo_ms = self.t_min_ms if t_lo_ms is None else int(t_lo_ms)
        t_hi_ms = self.t_max_ms if t_hi_ms is None else int(t_hi_ms)
        t_lo_ms = max(t_lo_ms, self.t_min_ms)
        t_hi_ms = min(t_hi_ms, self.t_max_ms)
        if t_lo_ms > t_hi_ms:
            return np.empty(0, dtype=np.int64)
        triples = xz3_bin_code_ranges(self.sfc, geometry.envelope.as_tuple(),
                                      t_lo_ms, t_hi_ms, self.period,
                                      max_ranges)
        if not triples:
            return np.empty(0, dtype=np.int64)
        return self._core.query_ranges(
            [(b, b, lo, hi, 0) for b, lo, hi in triples])
