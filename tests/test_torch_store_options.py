"""Port parity: the schema options that rewrite queries or mint ids —
``geomesa.query.interceptors``, ``geomesa.age.off`` and
``geomesa.fid.strategy=z3`` — through geomesa_tpu_torch's store against
geomesa_tpu's, on the same seeded rows.

Held equal: the exception a guard interceptor raises, the positions an
age-off window leaves, and the (bin, z) prefix and UUID format of
z-prefixed feature ids (their tail bytes are random)."""

import time

import numpy as np
import pytest

from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.utils.feature_id import z3_feature_ids as jax_fids
from geomesa_tpu_torch import TpuDataStore
from geomesa_tpu_torch.age_off import parse_duration_ms
from geomesa_tpu_torch.utils.feature_id import (
    random_feature_id, z3_feature_ids,
)

DAY = 86_400_000
SPEC = "v:Int,dtg:Date,*geom:Point"
GUARD = {
    "jax": "geomesa_tpu.planning.interceptor:GuardedQueryInterceptor",
    "torch": "geomesa_tpu_torch.planning.interceptor:GuardedQueryInterceptor",
}


def _stores(user_data: dict, rows: dict):
    """The same schema and rows in both stores; ``user_data`` maps each
    side ("jax", "torch") to its option string."""
    out = {}
    for side, ds in (("jax", JaxStore()),
                     ("torch", TpuDataStore(device="cpu"))):
        spec = SPEC + (f";{user_data[side]}" if user_data.get(side) else "")
        ds.create_schema("s", spec)
        ds.write("s", rows)
        out[side] = ds
    return out


def _four_rows():
    """Four rows at (0,0)…(3,3), days away from a 7-day cutoff."""
    now = int(time.time() * 1000)
    return {"v": np.arange(4),
            "dtg": np.array([now - 30 * DAY, now - 20 * DAY,
                             now - 2 * DAY, now - DAY], np.int64),
            "geom": (np.arange(4.0), np.arange(4.0))}


def test_age_off_hides_expired_rows():
    opt = "geomesa.age.off=7 days"
    st = _stores({"jax": opt, "torch": opt}, _four_rows())
    got = {k: ds.query_result("s", "BBOX(geom,-1,-1,5,5)").positions
           for k, ds in st.items()}
    np.testing.assert_array_equal(got["jax"], [2, 3])
    np.testing.assert_array_equal(got["torch"], got["jax"])
    inc = {k: ds.query_result("s", "INCLUDE").positions
           for k, ds in st.items()}
    np.testing.assert_array_equal(inc["torch"], inc["jax"])


@pytest.mark.parametrize("s,ms", [
    ("7 days", 7 * DAY), ("12 hours", 12 * 3_600_000),
    ("30 minutes", 1_800_000), ("45 seconds", 45_000),
    ("500 millis", 500), ("1.5 weeks", int(1.5 * 7 * DAY)), ("250", 250),
    (90, 90)])
def test_parse_duration_matches_reference(s, ms):
    from geomesa_tpu.age_off import parse_duration_ms as jax_parse
    assert parse_duration_ms(s) == jax_parse(s) == ms


@pytest.mark.parametrize("bad", ["", "x days", "5 fortnights"])
def test_parse_duration_rejects_like_reference(bad):
    from geomesa_tpu.age_off import parse_duration_ms as jax_parse
    with pytest.raises(ValueError):
        jax_parse(bad)
    with pytest.raises(ValueError):
        parse_duration_ms(bad)


def test_guard_interceptor_blocks_full_scans():
    st = _stores({k: f"geomesa.query.interceptors={v}"
                  for k, v in GUARD.items()}, _four_rows())
    for ds in st.values():
        with pytest.raises(ValueError, match="blocked"):
            ds.query_result("s", "INCLUDE")
    got = {k: ds.query_result("s", "BBOX(geom,0.5,0.5,5,5)").positions
           for k, ds in st.items()}
    np.testing.assert_array_equal(got["jax"], [1, 2, 3])
    np.testing.assert_array_equal(got["torch"], got["jax"])


def test_bad_interceptor_path_fails_create_schema():
    ds = TpuDataStore(device="cpu")
    with pytest.raises((ImportError, AttributeError)):
        ds.create_schema("s", SPEC + ";geomesa.query.interceptors="
                              "geomesa_tpu_torch.planning.interceptor:Nope")


def test_z3_fid_strategy_auto_ids():
    rng = np.random.default_rng(0)
    n = 5
    rows = {"v": np.arange(n),
            "dtg": rng.integers(1514764800000, 1515364800000, n),
            "geom": (rng.uniform(-10, 10, n), rng.uniform(40, 50, n))}
    opt = "geomesa.fid.strategy=z3"
    st = _stores({"jax": opt, "torch": opt}, rows)
    ids = {k: list(ds.query("s").ids) for k, ds in st.items()}
    for side in ids:
        assert len(set(ids[side])) == n
        assert all(len(i) == 36 and i[14] == "4" and i[19] in "89ab"
                   for i in ids[side])
    # the 8-byte (bin, z) prefix: the first 18 characters of the UUID
    assert [i[:18] for i in ids["torch"]] == [i[:18] for i in ids["jax"]]
    # a second write mints fresh ids, never a counter
    more = {k: ds.write("s", rows) for k, ds in st.items()}
    assert more == {"jax": n, "torch": n}
    again = list(st["torch"].query("s").ids)
    assert len(set(again)) == 2 * n


def test_z3_feature_ids_prefix_matches_reference():
    rng = np.random.default_rng(5)
    n = 2000
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    t = rng.integers(0, 1_700_000_000_000, n)
    for period in ("week", "day", "month", "year"):
        a = z3_feature_ids(x, y, t, period=period)
        b = jax_fids(x, y, t, period=period)
        assert [i[:18] for i in a] == [i[:18] for i in b]
    rid = random_feature_id()
    assert len(rid) == 36 and rid[14] == "4" and rid[19] in "89ab"
