"""Port parity: the seek/gather/wire layer (ops/search.py) of
geomesa_tpu_torch against geomesa_tpu.  All outputs are integers and must
be equal bit for bit."""

import numpy as np
import pytest
import torch

from geomesa_tpu.ops import search as js
from geomesa_tpu_torch.ops import search as ts


def _sorted_keys(rng, n):
    """Lexicographically sorted (bin, z) pairs with many duplicate keys."""
    hi = rng.integers(0, 6, n).astype(np.int32)
    lo = rng.integers(0, 50, n).astype(np.int64) * (1 << 40)
    order = np.lexsort((lo, hi))
    return hi[order], lo[order]


@pytest.mark.parametrize("n", [0, 1, 7, 1000])
@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted2_matches_jax(n, side):
    rng = np.random.default_rng(n + 11)
    hi, lo = _sorted_keys(rng, n)
    q_hi = rng.integers(-1, 7, 300).astype(np.int32)
    q_lo = rng.integers(0, 51, 300).astype(np.int64) * (1 << 40)
    if n:  # exact hits on existing keys, and the padded never-matching range
        k = min(20, n)
        q_hi[:k], q_lo[:k] = hi[:k], lo[:k]
    q_hi[-1], q_lo[-1] = -1, 1
    got = ts.searchsorted2(torch.from_numpy(hi), torch.from_numpy(lo),
                           torch.from_numpy(q_hi), torch.from_numpy(q_lo),
                           side=side)
    import jax.numpy as jnp
    want = np.asarray(js.searchsorted2(jnp.asarray(hi), jnp.asarray(lo),
                                       q_hi, q_lo, side=side))
    np.testing.assert_array_equal(got.numpy(), want)
    # the composite-key oracle (lo >> 40 < 64 here)
    comp = hi.astype(np.int64) * 64 + (lo >> 40)
    qc = q_hi.astype(np.int64) * 64 + (q_lo >> 40)
    np.testing.assert_array_equal(got.numpy(),
                                  np.searchsorted(comp, qc, side=side))


def test_searchsorted2_rejects_bad_side():
    with pytest.raises(ValueError):
        ts.searchsorted2(torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int64),
                         torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int64), side="middle")


@pytest.mark.parametrize("counts,capacity", [
    ([3, 0, 5, 2], 16),          # an empty range between non-empty ones
    ([0, 0, 4], 8),              # leading empty ranges (rid == 0 masking)
    ([6, 0, 0], 4),              # truncated: total exceeds capacity
    ([0, 0, 0, 0], 8),           # all padding
])
def test_expand_ranges_matches_jax(counts, capacity):
    counts = np.asarray(counts, dtype=np.int64)
    starts = np.cumsum(np.r_[0, counts[:-1]]) * 3 + 5
    got = ts.expand_ranges(torch.from_numpy(starts), torch.from_numpy(counts),
                           capacity)
    want = js.expand_ranges(starts, counts, capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pack_wire_total_past_2_31():
    total = (1 << 31) + 12345
    vals = np.arange(10, dtype=np.int64)
    mask = vals % 3 == 0
    got = ts.pack_wire(torch.tensor(total), torch.from_numpy(vals),
                       torch.from_numpy(mask), torch.int32)
    import jax.numpy as jnp
    want = np.asarray(js.pack_wire(jnp.int64(total), vals, mask, jnp.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    head = got.numpy()
    assert (int(head[0]) << 30) | int(head[1]) == total


@pytest.mark.parametrize("n_rows,n_q", [(1000, 3), (1 << 28, 9), (1 << 41, 2)])
def test_pack_coded_matches_jax(n_rows, n_q):
    pos_bits = ts.coded_pos_bits(n_rows, n_q)
    assert pos_bits == js.coded_pos_bits(n_rows, n_q)
    rng = np.random.default_rng(5)
    qid = rng.integers(0, n_q, 64).astype(np.int32)
    pos = rng.integers(0, min(n_rows, 1 << 31), 64).astype(np.int32)
    mask = rng.random(64) > 0.4
    got = ts.pack_coded(torch.tensor(77), torch.from_numpy(qid),
                        torch.from_numpy(pos), torch.from_numpy(mask),
                        pos_bits)
    import jax.numpy as jnp
    want = np.asarray(js.pack_coded(jnp.int64(77), qid, pos, mask, pos_bits))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def test_run_packed_query_regrows():
    """The first dispatch reports a total past its capacity; the loop
    regrows to the next power of two and retries, in both packages."""
    hits = np.array([9, 2, 5], dtype=np.int64)

    def make_dispatch(calls, to_tensor):
        def dispatch(capacity):
            calls.append(capacity)
            total = 3000 if capacity < 3000 else 3
            body = np.full(capacity, -1, np.int32)
            body[: len(hits)] = hits
            out = np.concatenate([[total >> 30, total & ((1 << 30) - 1)],
                                  body]).astype(np.int32)
            return torch.from_numpy(out) if to_tensor else out
        return dispatch

    calls_t, calls_j = [], []
    got, cap = ts.run_packed_query(make_dispatch(calls_t, True), 1024)
    want, cap_j = js.run_packed_query(make_dispatch(calls_j, False), 1024)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(hits))
    assert cap == cap_j == 4096 and calls_t == calls_j == [1024, 4096]


def test_padding_matches_jax():
    rng = np.random.default_rng(6)
    arrays = {"rbin": rng.integers(0, 9, 5).astype(np.int32),
              "rzlo": rng.integers(0, 99, 5), "rzhi": rng.integers(99, 199, 5),
              "rtlo": np.zeros(5, np.int32), "rthi": np.ones(5, np.int32),
              "rqid": np.zeros(5, np.int32)}
    n_pad = ts.pad_pow2(5)
    assert n_pad == js.pad_pow2(5) == 8
    got, want = ts.pad_ranges(arrays, n_pad), js.pad_ranges(arrays, n_pad)
    for k in arrays:
        np.testing.assert_array_equal(got[k], want[k])
    # padded ranges never match: zlo > zhi
    assert (got["rzlo"][5:] > got["rzhi"][5:]).all()
    ixy = rng.integers(0, 1000, (3, 4)).astype(np.int32)
    boxes = rng.uniform(-1, 1, (3, 4))
    bqid = np.arange(3, dtype=np.int32)
    for g, w in zip(ts.pad_boxes(ixy, boxes, 4, bqid),
                    js.pad_boxes(ixy, boxes, 4, bqid)):
        np.testing.assert_array_equal(g, w)
    assert ts.gather_capacity(5000) == js.gather_capacity(5000) == 8192


@pytest.mark.parametrize("pos_bits,n_q", [(20, 5), (40, 3), (27, 1)])
def test_split_coded_matches_mask_and_unique(pos_bits, n_q):
    """The sorted-run decode of multi-window codes equals the JAX
    package's per-query mask + ``np.unique``, duplicates and empty
    queries included."""
    rng = np.random.default_rng(pos_bits)
    qid = rng.integers(0, n_q, 5000)
    qid[qid == n_q - 1] = 0 if n_q > 1 else qid[qid == n_q - 1]
    pos = rng.integers(0, 1 << min(pos_bits, 20), 5000)
    coded = np.sort((qid.astype(np.int64) << pos_bits) | pos)
    got = ts.split_coded(coded, pos_bits, n_q)
    assert len(got) == n_q
    qids = coded >> pos_bits
    positions = coded & ((np.int64(1) << pos_bits) - 1)
    for q in range(n_q):
        want = np.unique(positions[qids == q])
        assert got[q].dtype == np.int64
        np.testing.assert_array_equal(got[q], want)
    empty = ts.split_coded(np.empty(0, np.int64), pos_bits, n_q)
    assert [len(e) for e in empty] == [0] * n_q
