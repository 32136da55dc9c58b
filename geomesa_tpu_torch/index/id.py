"""ID (record) index: feature-id point lookups.

The port's copy of the JAX package's ``index/id.py``.  Analog of the
reference's id index (geomesa-index-api/.../index/id/
IdIndexKeySpace.scala — rows keyed by feature id, with UUID-optimized
byte encoding).  Here: a sorted string-id column + permutation; lookups
are binary searches."""

from __future__ import annotations

import numpy as np

__all__ = ["IdIndex", "LeanIdIndex"]


class LeanIdIndex:
    """Id lookups for the lean profile's IMPLICIT ids (row ``r`` ⇔
    ``f"{prefix}{r}"`` — features/lean.py): no index structure at all,
    an id lookup is a prefix strip + integer parse + range check.  The
    O(1)-per-id analog of IdIndexKeySpace's direct row seek."""

    def __init__(self, n_rows: int, prefix: str = ""):
        self.n_rows = int(n_rows)
        self.prefix = prefix

    def __len__(self) -> int:
        return self.n_rows

    def query(self, ids) -> np.ndarray:
        """Rows of the given ids, sorted and unique; ids that are not a
        row's canonical decimal form ('007' is NOT row 7's id) are
        skipped.  Vectorized: a delete or age-off resolves millions of
        ids at once."""
        s = np.asarray(ids, dtype=object).astype(str)
        if self.prefix and len(s):
            s = s[np.char.startswith(s, self.prefix)]
        if not len(s):
            return np.empty(0, dtype=np.int64)
        if self.prefix:
            s = np.char.replace(s, self.prefix, "", count=1)
        # ≤ 18 digits parse into int64; a longer canonical number is
        # past any row count
        ok = np.char.isdecimal(s) & (np.char.str_len(s) <= 18)
        s = s[ok]
        rows = s.astype(np.int64)
        # canonical form: the digits print back unchanged (no leading
        # zeros, ASCII digits only)
        rows = rows[(rows.astype(str) == s) & (rows < self.n_rows)]
        return np.unique(rows)


class IdIndex:
    def __init__(self, ids: np.ndarray, pos: np.ndarray):
        self.ids = ids    # sorted string array
        self.pos = pos

    @classmethod
    def build(cls, ids) -> "IdIndex":
        ids = np.asarray(ids).astype(str)
        order = np.argsort(ids, kind="stable")
        srt = ids[order]
        if len(srt) > 1:
            dup = srt[1:] == srt[:-1]
            if dup.any():
                # ids identify exactly one row (the reference's id
                # generators never reuse ids); a duplicate here means a
                # broken writer upstream — failing beats silently
                # returning two rows for one id
                raise ValueError(
                    f"duplicate feature id {srt[1:][dup][0]!r}: feature "
                    "ids must be unique within a schema")
        return cls(srt, order.astype(np.int64))

    def __len__(self) -> int:
        return len(self.ids)

    def query(self, ids) -> np.ndarray:
        """Positions of the given feature ids (missing ids are skipped)."""
        out = []
        for fid in ids:
            fid = str(fid)
            lo = np.searchsorted(self.ids, fid, side="left")
            hi = np.searchsorted(self.ids, fid, side="right")
            out.append(self.pos[lo:hi])
        if not out:
            return np.empty(0, dtype=np.int64)
        # unique: repeated ids (or AND'd id filters) must not duplicate rows
        return np.unique(np.concatenate(out))
