"""Sorted-key search: the device replacement for KV-store seeks.

The reference's scan path turns z-ranges into tablet-server seeks over a
distributed sorted map (e.g. AccumuloQueryPlan BatchScanPlan,
geomesa-accumulo/.../data/AccumuloQueryPlan.scala:123-157).  Here the
"table" is a lexicographically sorted pair of device-resident columns
``(hi, lo)`` — for Z3, ``hi`` = time bin and ``lo`` = 63-bit z — and a
seek is a branchless vectorized binary search evaluated for all R query
ranges at once, with a fixed iteration count (log2 n).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["searchsorted2", "expand_ranges", "gather_capacity",
           "coded_pos_bits", "wire_dtype", "pack_wire", "pack_coded",
           "run_packed_query", "split_coded", "pad_pow2", "pad_ranges", "pad_boxes"]

#: bits per word of the split candidate total in the wire header
_TOTAL_SPLIT = 30


def coded_pos_bits(n_rows: int, n_queries: int) -> int:
    """Wire coding for multi-window scans: bits reserved for the position
    field of the ``qid << pos_bits | pos`` code.  Prefers an
    int32-fitting layout (qid_bits + pos_bits <= 31); falls back to a
    40-bit int64 layout for huge tables, widening further for position
    spans beyond 2^40.  :func:`wire_dtype` maps the result to the wire
    dtype — keep the two in sync via this module."""
    pos_bits = max(1, int(np.ceil(np.log2(max(2, n_rows)))))
    qid_bits = max(1, int(np.ceil(np.log2(max(2, n_queries)))))
    if pos_bits + qid_bits <= 31:
        return pos_bits
    pos_bits = max(40, pos_bits)
    if pos_bits + qid_bits > 63:
        raise ValueError(
            f"coded layout overflow: {pos_bits} position bits + "
            f"{qid_bits} query bits exceed int64 — batch fewer windows")
    return pos_bits


def wire_dtype(pos_bits: int) -> torch.dtype:
    """Wire dtype for a coded layout chosen by :func:`coded_pos_bits`."""
    return torch.int32 if pos_bits < 31 else torch.int64


def pack_coded(total, qid, pos, mask, pos_bits: int):
    """Encode a multi-window scan result: ``qid << pos_bits | pos`` in
    the dtype :func:`wire_dtype` picks, wrapped by :func:`pack_wire`
    (decode: ``coded >> pos_bits`` / mask)."""
    dt = wire_dtype(pos_bits)
    coded = (qid.to(dt) << pos_bits) | pos.to(dt)
    return pack_wire(total, coded, mask, dt)


def pack_wire(total, values, mask, dt: torch.dtype):
    """Encode one scan's result as the packed wire vector
    ``[total_hi, total_lo, v_0|-1, v_1|-1, …]`` in dtype ``dt``.

    Values travel as int32 whenever they fit (positions, or
    qid<<pos_bits|pos codes that fit 31 bits), halving the device→host
    copy.  The candidate ``total`` — which can legitimately exceed 2^31
    when overlapping covering ranges double-count a large gather — is
    split into two 30-bit words so the int32 wire can never wrap it into
    a false "fits" signal (overflow detection depends on it).
    """
    total = torch.as_tensor(total, dtype=torch.int64, device=values.device)
    head = torch.stack([total >> _TOTAL_SPLIT,
                        total & ((1 << _TOTAL_SPLIT) - 1)]).to(dt)
    packed = torch.where(mask, values.to(dt),
                         torch.full_like(values, -1, dtype=dt))
    return torch.cat([head, packed])


def run_packed_query(dispatch, capacity: int):
    """Run a packed one-dispatch scan with adaptive capacity.

    ``dispatch(capacity)`` must return a :func:`pack_wire` tensor (any
    integer dtype; int32 keeps the transfer small).  If ``total`` exceeds
    the capacity the gather truncated — regrow to the next power of two
    and retry (rare; capacity is sticky with the caller).  Returns
    ``(sorted_values int64, capacity)``.
    """
    while True:
        out = dispatch(capacity).cpu().numpy()  # the one device→host copy
        total = (int(out[0]) << _TOTAL_SPLIT) | int(out[1])
        if total <= capacity:
            packed = out[2:]
            return np.sort(packed[packed >= 0]).astype(np.int64), capacity
        capacity = gather_capacity(total)


def split_coded(coded: np.ndarray, pos_bits: int,
                n_queries: int) -> list[np.ndarray]:
    """Decode a multi-window scan's sorted ``qid << pos_bits | pos`` codes
    (as :func:`run_packed_query` returns them) into one sorted,
    duplicate-free int64 position array per query.

    Sorted codes hold each query's hits as one contiguous run, sorted by
    position, and a feature that lands in several of its query's covering
    ranges repeats adjacently — so a boundary search and an adjacent
    comparison replace a mask and ``np.unique`` per query, whose cost
    varies widely across numpy versions (see PERF.md)."""
    bounds = np.searchsorted(
        coded, np.arange(n_queries + 1, dtype=np.int64) << pos_bits)
    positions = coded & ((np.int64(1) << pos_bits) - 1)
    out = []
    for q in range(n_queries):
        p = positions[bounds[q]:bounds[q + 1]]
        keep = np.ones(len(p), dtype=bool)
        keep[1:] = p[1:] != p[:-1]
        out.append(p[keep])
    return out


def pad_pow2(n: int, minimum: int = 8) -> int:
    """Next power of two ≥ n — plan arrays pad to bucketed shapes, so the
    scan sees few distinct shapes."""
    return gather_capacity(n, minimum)


def pad_ranges(arrays: dict, n_pad: int) -> dict:
    """Pad per-range plan arrays to ``n_pad`` with never-matching ranges
    (zlo > zhi ⇒ searchsorted start == end ⇒ count 0)."""
    n = len(next(iter(arrays.values())))
    if n == n_pad:
        return arrays
    fill = {"rbin": -1, "rzlo": 1, "rzhi": 0, "rtlo": 1, "rthi": 0,
            "rqid": 0}
    out = {}
    for k, v in arrays.items():
        pad = np.full(n_pad - n, fill.get(k, 0), dtype=v.dtype)
        out[k] = np.concatenate([v, pad])
    return out


def pad_boxes(ixy, boxes, n_pad: int, bqid=None):
    """Pad box arrays with inverted (never-matching) boxes."""
    n = len(ixy)
    if n == n_pad:
        return (ixy, boxes) if bqid is None else (ixy, boxes, bqid)
    ixy_p = np.concatenate(
        [ixy, np.tile(np.array([[1, 1, 0, 0]], ixy.dtype), (n_pad - n, 1))])
    boxes_p = np.concatenate(
        [boxes, np.tile(np.array([[1.0, 1.0, 0.0, 0.0]], boxes.dtype),
                        (n_pad - n, 1))])
    if bqid is None:
        return ixy_p, boxes_p
    bqid_p = np.concatenate([bqid, np.full(n_pad - n, -1, bqid.dtype)])
    return ixy_p, boxes_p, bqid_p


def gather_capacity(total: int, minimum: int = 1024) -> int:
    """Static gather capacity: next power of two ≥ total.  Bounds the number
    of distinct candidate-buffer shapes to log2(N)."""
    cap = minimum
    while cap < total:
        cap *= 2
    return cap


def searchsorted2(keys_hi, keys_lo, q_hi, q_lo, side: str = "left"):
    """Vectorized binary search over lexicographically sorted key pairs.

    Equivalent to ``np.searchsorted`` on the composite key ``(hi, lo)``
    (which for Z3 matches the reference's big-endian ``[2B bin][8B z]``
    row-key ordering, index/index/z3/Z3IndexKeySpace.scala:60): returns,
    per query, the first index at which the query could be inserted while
    keeping order ('left'), or the index past any equal run ('right').

    A fixed ``n.bit_length()`` steps, branchless.  All comparisons are
    signed int64 — z values occupy ≤63 bits so signed order equals
    unsigned byte order.
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    n = int(keys_hi.shape[0])
    q_hi = torch.as_tensor(q_hi, device=keys_hi.device)
    q_lo = torch.as_tensor(q_lo, device=keys_lo.device)
    lo = torch.zeros(q_hi.shape, dtype=torch.int64, device=keys_hi.device)
    if n == 0:
        return lo
    hi = torch.full(q_hi.shape, n, dtype=torch.int64, device=keys_hi.device)
    for _ in range(max(1, n.bit_length())):
        active = lo < hi
        mid = torch.clamp((lo + hi) >> 1, max=n - 1)
        mh = keys_hi[mid]
        ml = keys_lo[mid]
        if side == "left":
            go_right = (mh < q_hi) | ((mh == q_hi) & (ml < q_lo))
        else:
            go_right = (mh < q_hi) | ((mh == q_hi) & (ml <= q_lo))
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def expand_ranges(starts, counts, capacity: int):
    """Flatten R variable-length index ranges into one fixed-size gather.

    Given per-range start offsets and lengths (the result of searchsorted
    over the sorted key columns), produce ``capacity`` gather indices that
    enumerate ``starts[r] + 0..counts[r]-1`` for every range in order, plus
    a validity mask and the owning range id per slot.  ``capacity`` must be
    >= the total count; surplus slots are masked out.
    """
    starts = starts.to(torch.int64)
    counts = counts.to(torch.int64)
    device = counts.device
    offsets = torch.cumsum(counts, 0)
    total = (offsets[-1] if counts.shape[0] > 0
             else torch.zeros((), dtype=torch.int64, device=device))
    j = torch.arange(capacity, dtype=torch.int64, device=device)
    rid = torch.searchsorted(offsets, j, right=True)
    rid_c = torch.clamp(rid, max=counts.shape[0] - 1)
    # offsets[rid_c - 1] at rid_c == 0 would wrap to offsets[-1] (torch
    # indexes negatives from the end): clamp the index, then mask
    prev = torch.where(rid_c > 0, offsets[torch.clamp(rid_c - 1, min=0)],
                       torch.zeros_like(rid_c))
    idx = starts[rid_c] + (j - prev)
    valid = j < total
    return torch.where(valid, idx, torch.zeros_like(idx)), valid, rid_c
