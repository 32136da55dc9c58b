"""XZ2 curve: extended-Z ordering for objects with spatial extension.

The port's copy of the JAX package's XZ2 curve, after the XZ-Ordering
scheme (Böhm, Klump & Kriegel: "XZ-Ordering: A Space-Filling Curve for
Objects with Spatial Extension") that the reference uses to index
non-point geometries by bounding box (geomesa-z3/.../curve/XZ2SFC.scala):

* An object's bbox is assigned the quadtree cell whose *extended*
  footprint (the cell doubled in width and height) encloses it, at the
  deepest possible resolution ``length ≤ g`` (XZ2SFC.scala:54-77).
* Cells are numbered by *sequence codes*: a pre-order quadtree numbering
  where entering quadrant ``q`` at depth ``i`` adds
  ``1 + q·(4^(g-i)-1)/3`` (Definition 2; XZ2SFC.scala:264-286).
* A query window is covered by the union of (a) full subtree intervals
  ``[cs, cs + (4^(g-l+1)-1)/3]`` for contained cells (Lemma 3;
  XZ2SFC.scala:297-306) and (b) singleton intervals ``[cs, cs]`` for
  every overlapping ancestor cell — the latter catch *large* objects
  stored at coarse cells.

Encoding runs on the host in numpy, as every index build of the JAX
package does: the resolution comes from ``floor(log(max_dim) /
log(0.5))``, and agreement with the reference depends on the last ulp of
that ``log``, which numpy computes alike in both packages.  The quadrant
digit at depth ``i`` is a bit pair of the integerized cell coordinates,
so a batch of bboxes encodes in ``g`` fixed vectorized steps.  Range
decomposition is the level-synchronous frontier sweep of
:mod:`geomesa_tpu_torch.curve.ranges`, in the native library when it is
available and in numpy otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..config import DEFAULT_MAX_RANGES

__all__ = ["XZ2SFC", "xz2_sfc", "DEFAULT_G"]

DEFAULT_G = 12  # reference default XZ precision (geomesa.xz.precision)


def _iv_table(g: int) -> np.ndarray:
    """IV[i] = (4^(g-i) - 1) / 3 for i in [0, g] — the subtree sizes."""
    if g > 30:
        raise ValueError("g must be <= 30 to fit sequence codes in int64")
    return np.array([(4 ** (g - i) - 1) // 3 for i in range(g + 1)],
                    dtype=np.int64)


def _resolution(max_dim, mins, maxs, g: int):
    """The code's depth: ``l1 = floor(log(max_dim) / log(0.5))`` (the
    reference's float formula, so lengths agree to the ulp; a degenerate
    bbox takes ``g``), or ``l1 + 1`` when the bbox spans at most two cells
    of that finer level on every axis."""
    log_half = float(np.log(0.5))
    with np.errstate(divide="ignore"):
        l1 = np.where(
            max_dim > 0.0,
            np.floor(np.log(np.maximum(max_dim, 1e-300))
                     / log_half).astype(np.int32),
            g)
    l1 = np.clip(l1, 0, g)
    w2 = np.exp2(-(l1 + 1).astype(np.float64))
    fits = np.asarray(l1 < g)
    for mn, mx in zip(mins, maxs):
        fits = fits & (mx <= np.floor(mn / w2) * w2 + 2.0 * w2)
    return np.where(fits, l1 + 1, l1)


def _sequence_code(coords, length, g: int, iv: np.ndarray):
    """Sequence code of the cell holding the normalized min corner
    ``coords`` at depth ``length``: ``length + Σ_{i<length} digit_i ·
    IV[i]``, the digit at depth ``i`` being the bits of the integerized
    coordinates (``x`` the lowest)."""
    scale = float(1 << g)
    ks = [np.minimum(np.floor(c * scale), scale - 1).astype(np.int64)
          for c in coords]
    cs = np.asarray(length, np.int64) + np.zeros_like(ks[0])
    length = np.asarray(length)
    for i in range(g):
        digit = sum(((k >> (g - 1 - i)) & 1) << d for d, k in enumerate(ks))
        cs = cs + np.where(i < length, digit * iv[i], 0)
    return cs


def _sweep(wmins: np.ndarray, wmaxs: np.ndarray, g: int, iv: np.ndarray,
           budget: int) -> np.ndarray:
    """The numpy XZ range sweep over normalized ``(W, d)`` windows (the
    native library's ``gm_xz_ranges``, emit for emit): at each level the
    frontier's children are classified against all windows by their
    *extended* footprints; contained cells emit their subtree interval,
    overlapping cells emit their own code and descend."""
    from .ranges import merge_ranges

    dims = wmins.shape[1]
    fanout = 1 << dims
    q = np.arange(fanout, dtype=np.int64)
    bits = [(q >> d) & 1 for d in range(dims)]
    ks = [np.array([0], dtype=np.int64) for _ in range(dims)]
    cs = np.array([0], dtype=np.int64)  # code of the parent prefix path
    out_lo: list[np.ndarray] = []
    out_hi: list[np.ndarray] = []
    emitted = 0
    for level in range(1, g + 1):
        if cs.size == 0:
            break
        cks = [((k[:, None] << 1) + b[None, :]).ravel()
               for k, b in zip(ks, bits)]
        # entering child q at depth (level-1) adds 1 + q * IV[level-1]
        ccs = (cs[:, None] + 1 + q[None, :] * iv[level - 1]).ravel()
        w = 0.5 ** level
        lo = np.stack([k * w for k in cks], axis=1)          # (n, d)
        ext = lo + 2 * w                                      # extended
        contained = ((wmins[None, :, :] <= lo[:, None, :])
                     & (wmaxs[None, :, :] >= ext[:, None, :])
                     ).all(axis=2).any(axis=1)
        overlaps = ((wmaxs[None, :, :] >= lo[:, None, :])
                    & (wmins[None, :, :] <= ext[:, None, :])
                    ).all(axis=2).any(axis=1)
        partial = overlaps & ~contained
        if contained.any():
            c = ccs[contained]
            out_lo.append(c)
            out_hi.append(c + iv[level - 1])  # Lemma 3
            emitted += c.size
        if not partial.any():
            break
        rest_cs = ccs[partial]
        if level == g or emitted + rest_cs.size * fanout > budget:
            # bottom out: cover each remaining cell's whole subtree
            out_lo.append(rest_cs)
            out_hi.append(rest_cs + iv[level - 1])
            break
        # partial matches emit their own code (large objects stored at
        # this cell) and descend
        out_lo.append(rest_cs)
        out_hi.append(rest_cs.copy())
        emitted += rest_cs.size
        ks = [k[partial] for k in cks]
        cs = rest_cs
    if not out_lo:
        return np.empty((0, 2), dtype=np.int64)
    return merge_ranges(np.concatenate(out_lo), np.concatenate(out_hi))


def xz_ranges(wmins: np.ndarray, wmaxs: np.ndarray, g: int, iv: np.ndarray,
              budget: int) -> np.ndarray:
    """Covering ranges of normalized ``(W, d)`` windows: the native sweep
    when its library is available, else the numpy one."""
    from .. import native

    res = native.xz_ranges_native(wmins, wmaxs, dims=wmins.shape[1], g=g,
                                  budget=budget)
    if res is not None:
        return res
    return _sweep(wmins, wmaxs, g, iv, budget)


@dataclass(frozen=True)
class XZ2SFC:
    """XZ2 curve over a lon/lat (or custom) 2-D domain, resolution ``g``."""

    g: int = DEFAULT_G
    x_lo: float = -180.0
    x_hi: float = 180.0
    y_lo: float = -90.0
    y_hi: float = 90.0

    def _normalize(self, xmin, ymin, xmax, ymax):
        xs = self.x_hi - self.x_lo
        ys = self.y_hi - self.y_lo

        def n(v, lo, size):
            return np.clip((np.asarray(v, np.float64) - lo) / size, 0.0, 1.0)
        return (n(xmin, self.x_lo, xs), n(ymin, self.y_lo, ys),
                n(xmax, self.x_lo, xs), n(ymax, self.y_lo, ys))

    def index(self, xmin, ymin, xmax, ymax) -> np.ndarray:
        """Vectorized bbox → sequence code (int64), on the host.

        Matches XZ2SFC.index: resolution = min(g, l1 or l1+1) where
        l1 = floor(-log2(max bbox side)) and l1+1 applies when the bbox
        spans at most two cells at that finer resolution on both axes."""
        nxmin, nymin, nxmax, nymax = self._normalize(xmin, ymin, xmax, ymax)
        max_dim = np.maximum(nxmax - nxmin, nymax - nymin)
        length = _resolution(max_dim, (nxmin, nymin), (nxmax, nymax), self.g)
        return _sequence_code((nxmin, nymin), length, self.g,
                              _iv_table(self.g))

    def ranges(self, queries, max_ranges: int | None = None) -> np.ndarray:
        """Covering sequence-code ranges for OR'd ``(xmin, ymin, xmax,
        ymax)`` query windows: merged ``(R, 2)`` int64 inclusive ranges."""
        budget = DEFAULT_MAX_RANGES if max_ranges is None else int(max_ranges)
        w = np.atleast_2d(np.asarray(queries, dtype=np.float64))
        nxmin, nymin, nxmax, nymax = self._normalize(w[:, 0], w[:, 1],
                                                     w[:, 2], w[:, 3])
        return xz_ranges(np.stack([nxmin, nymin], axis=1),
                         np.stack([nxmax, nymax], axis=1), self.g,
                         _iv_table(self.g), budget)


@lru_cache(maxsize=None)
def xz2_sfc(g: int = DEFAULT_G) -> XZ2SFC:
    return XZ2SFC(g)
