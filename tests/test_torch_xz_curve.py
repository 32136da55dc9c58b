"""Port parity: the XZ curves and the native range sweep of
geomesa_tpu_torch against geomesa_tpu.

Same seeded numpy inputs through both packages.  Sequence codes are
equal bit for bit (random envelopes, and degenerate ones: zero-size,
world-size, sides of 2^-k of the domain and their ``nextafter``
neighbours, where the resolution hangs on the last ulp of a ``log``);
covering ranges are equal native against native and numpy against numpy
across the packages, and native against numpy within the port, as
``tests/test_native.py`` holds the JAX package's pair.
"""

import numpy as np
import pytest

from geomesa_tpu import native as j_native
from geomesa_tpu.curve import ranges as j_ranges
from geomesa_tpu.curve.xz2 import xz2_sfc as j_xz2_sfc
from geomesa_tpu.curve.xz3 import xz3_sfc as j_xz3_sfc
from geomesa_tpu_torch import native
from geomesa_tpu_torch.curve import ranges as ranges_mod
from geomesa_tpu_torch.curve.xz2 import xz2_sfc
from geomesa_tpu_torch.curve.xz3 import xz3_sfc
from geomesa_tpu_torch.ops.build import BUILD_DIR

PERIODS = ("day", "week", "month", "year")


@pytest.fixture
def numpy_sweeps(monkeypatch):
    """Both packages' native dispatch disabled: every call takes the
    numpy sweep."""
    for mod in (native, j_native):
        monkeypatch.setattr(mod, "zranges_native", lambda *a, **k: None)
        monkeypatch.setattr(mod, "xz_ranges_native", lambda *a, **k: None)


def _envelopes(rng, n, lo, hi):
    """Sorted random intervals over [lo, hi] per axis, plus degenerate
    ones: zero-size, the whole axis, sides of 2^-k of the axis and their
    nextafter neighbours on both sides."""
    a = np.sort(rng.uniform(lo, hi, (n, 2)), axis=1)
    span = hi - lo
    sides = []
    for k in range(0, 24):
        s = span * 2.0 ** -k
        sides += [s, np.nextafter(s, 0.0), np.nextafter(s, np.inf)]
    sides = np.array(sides)
    starts = rng.uniform(lo, hi - span / 2, len(sides))
    deg = np.stack([starts, np.minimum(starts + sides, hi)], axis=1)
    fixed = np.array([[lo, lo], [hi, hi], [lo, hi], [0.5 * (lo + hi)] * 2,
                      [lo, np.nextafter(lo, hi)]])
    return np.concatenate([a, deg, fixed])


def _xy(rng, n):
    x = _envelopes(rng, n, -180.0, 180.0)
    y = _envelopes(rng, n, -90.0, 90.0)
    m = min(len(x), len(y))
    return x[rng.permutation(len(x))[:m]], y[rng.permutation(len(y))[:m]]


@pytest.mark.parametrize("g", [4, 12, 20])
def test_xz2_index_bit_exact(g):
    rng = np.random.default_rng(800 + g)
    x, y = _xy(rng, 4000)
    # the same sides on both axes: max_dim at 2^-k of the domain exactly
    y2 = (x - (-180.0)) / 2.0 - 90.0
    for xs, ys in ((x, y), (x, y2)):
        got = xz2_sfc(g).index(xs[:, 0], ys[:, 0], xs[:, 1], ys[:, 1])
        want = np.asarray(j_xz2_sfc(g).index(xs[:, 0], ys[:, 0], xs[:, 1],
                                             ys[:, 1], xp=np))
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    # scalars encode alike too
    assert (int(xz2_sfc(g).index(1.0, 2.0, 1.5, 2.5))
            == int(j_xz2_sfc(g).index(1.0, 2.0, 1.5, 2.5, xp=np)))


@pytest.mark.parametrize("g", [4, 12, 20])
@pytest.mark.parametrize("period", PERIODS)
def test_xz3_index_bit_exact(g, period):
    rng = np.random.default_rng(900 + g)
    x, y = _xy(rng, 2000)
    zmax = j_xz3_sfc(period, g).z_hi
    z = _envelopes(rng, len(x), 0.0, zmax)[:len(x)]
    got = xz3_sfc(period, g).index(x[:, 0], y[:, 0], z[:, 0],
                                   x[:, 1], y[:, 1], z[:, 1])
    want = np.asarray(j_xz3_sfc(period, g).index(
        x[:, 0], y[:, 0], z[:, 0], x[:, 1], y[:, 1], z[:, 1], xp=np))
    np.testing.assert_array_equal(got, want)
    # instants (zmin == zmax), as the indexes encode rows
    got = xz3_sfc(period, g).index(x[:, 0], y[:, 0], z[:, 0],
                                   x[:, 1], y[:, 1], z[:, 0])
    want = np.asarray(j_xz3_sfc(period, g).index(
        x[:, 0], y[:, 0], z[:, 0], x[:, 1], y[:, 1], z[:, 0], xp=np))
    np.testing.assert_array_equal(got, want)


def test_precision_limits_raise_alike():
    with pytest.raises(ValueError, match="g must be <= 30"):
        xz2_sfc(31).index(0.0, 0.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="g must be <= 20"):
        xz3_sfc("week", 21).index(0.0, 0.0, 0.0, 1.0, 1.0, 1.0)


def _xz2_windows(rng, n):
    x = np.sort(rng.uniform(-180, 180, size=(n, 2)), axis=1)
    y = np.sort(rng.uniform(-90, 90, size=(n, 2)), axis=1)
    return np.stack([x[:, 0], y[:, 0], x[:, 1], y[:, 1]], axis=1)


def _xz3_windows(rng, n, zmax):
    w = _xz2_windows(rng, n)
    z = np.sort(rng.uniform(0, zmax, size=(n, 2)), axis=1)
    return np.stack([w[:, 0], w[:, 1], z[:, 0], w[:, 2], w[:, 3], z[:, 1]],
                    axis=1)


def _xz_cases(dims, g, seed, n_cases=20):
    rng = np.random.default_rng(seed)
    zmax = j_xz3_sfc("week", g).z_hi
    for _ in range(n_cases):
        n = int(rng.integers(1, 4))
        q = (_xz2_windows(rng, n) if dims == 2
             else _xz3_windows(rng, n, zmax))
        yield q, int(rng.choice([8, 100, 2000]))
    world = ([(-180.0, -90.0, 180.0, 90.0)] if dims == 2
             else [(-180.0, -90.0, 0.0, 180.0, 90.0, zmax)])
    yield np.array(world), 2000


def _sfcs(dims, g):
    if dims == 2:
        return xz2_sfc(g), j_xz2_sfc(g)
    return xz3_sfc("week", g), j_xz3_sfc("week", g)


def test_native_loads_into_build_dir():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    libs = list(BUILD_DIR.glob("libgeomesa_native-*.so"))
    assert libs, f"no native library under {BUILD_DIR}"


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("g", [6, 12])
def test_xz_ranges_native_across_packages(dims, g):
    assert native.available() and j_native.available()
    port, jax_sfc = _sfcs(dims, g)
    for q, budget in _xz_cases(dims, g, 99 + g + dims):
        np.testing.assert_array_equal(port.ranges(q, max_ranges=budget),
                                      jax_sfc.ranges(q, max_ranges=budget))


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("g", [6, 12])
def test_xz_ranges_numpy_across_packages(dims, g, numpy_sweeps):
    port, jax_sfc = _sfcs(dims, g)
    for q, budget in _xz_cases(dims, g, 199 + g + dims):
        np.testing.assert_array_equal(port.ranges(q, max_ranges=budget),
                                      jax_sfc.ranges(q, max_ranges=budget))


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("g", [6, 12])
def test_xz_ranges_native_vs_numpy(dims, g, monkeypatch):
    port, _ = _sfcs(dims, g)
    for q, budget in _xz_cases(dims, g, 299 + g + dims):
        got = port.ranges(q, max_ranges=budget)
        with monkeypatch.context() as m:
            m.setattr(native, "xz_ranges_native", lambda *a, **k: None)
            want = port.ranges(q, max_ranges=budget)
        np.testing.assert_array_equal(got, want)


def _zcases(dims, bits, seed):
    rng = np.random.default_rng(seed)
    hi = (1 << bits) - 1
    for trial in range(25):
        n_boxes = int(rng.integers(1, 5))
        a = rng.integers(0, hi + 1, size=(n_boxes, dims))
        b = rng.integers(0, hi + 1, size=(n_boxes, dims))
        budget = int(rng.choice([4, 32, 2000]))
        levels = None if trial % 3 else int(rng.integers(1, bits + 1))
        yield np.minimum(a, b), np.maximum(a, b), budget, levels


@pytest.mark.parametrize("dims,bits", [(2, 31), (2, 8), (3, 21), (3, 5)])
def test_zranges_native_path(dims, bits, monkeypatch):
    """``zranges`` goes through the native sweep: equal to the JAX
    package's native result and to the port's numpy sweep."""
    calls = []
    real = native.zranges_native
    monkeypatch.setattr(native, "zranges_native",
                        lambda *a: calls.append(1) or real(*a))
    for mins, maxs, budget, levels in _zcases(dims, bits, 1234 + dims + bits):
        got = ranges_mod.zranges(mins, maxs, dims=dims, bits=bits,
                                 max_ranges=budget, max_levels=levels)
        np.testing.assert_array_equal(got, j_ranges.zranges(
            mins, maxs, dims=dims, bits=bits, max_ranges=budget,
            max_levels=levels))
        with monkeypatch.context() as m:
            m.setattr(native, "zranges_native", lambda *a, **k: None)
            np.testing.assert_array_equal(got, ranges_mod.zranges(
                mins, maxs, dims=dims, bits=bits, max_ranges=budget,
                max_levels=levels))
    assert calls


def test_env_kill_switch(monkeypatch):
    """GEOMESA_TPU_NATIVE=0 is honored by a fresh loader state, which then
    says why; zranges and the XZ ranges still answer through numpy."""
    monkeypatch.setenv("GEOMESA_TPU_NATIVE", "0")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_ERROR", None)
    assert not native.available()
    assert "GEOMESA_TPU_NATIVE=0" in native.build_error()
    out = ranges_mod.zranges([[0, 0]], [[7, 7]], dims=2, bits=4)
    assert out.shape[0] >= 1
    q = [(-10.0, -10.0, 10.0, 10.0)]
    monkeypatch.setattr(j_native, "xz_ranges_native", lambda *a, **k: None)
    np.testing.assert_array_equal(xz2_sfc(12).ranges(q),
                                  j_xz2_sfc(12).ranges(q))


def test_failed_build_is_reported(monkeypatch, tmp_path):
    """A build that fails leaves the library unavailable with the
    compiler's reason; nothing falls back silently."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.delenv("GEOMESA_TPU_NATIVE", raising=False)
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_ERROR", None)
    assert not native.available()
    assert "g++ failed" in native.build_error()
