"""Port parity: the option registry of ``geomesa_tpu_torch/config.py``
against geomesa_tpu's ``config.py``.

Held: every name the port declares is a JAX name with the same default;
every ``geomesa.*`` literal in the port's sources (and in
``chip_smoke.py``) is declared; the JAX names the port leaves undeclared
are exactly the listed ones; the same typo warns once in both packages
and raises in both under ``geomesa.config.strict``, while clearing a
stale typo stays possible there.
"""

import re
import warnings
from pathlib import Path

import pytest

from geomesa_tpu import config as jcfg
from geomesa_tpu_torch import config as tcfg

ROOT = Path(__file__).resolve().parents[1]
#: JAX names the port reads nowhere yet: the Arrow knobs (ROADMAP A9), two
#: names neither package reads, and the deliberate differences (the
#: port's kernels never fall back; its writes end without a device copy)
UNDECLARED = {"geomesa.arrow.chunk.rows", "geomesa.arrow.dictionary.threshold",
              "geomesa.arrow.stream.buffer.bytes",
              "geomesa.query.loose.bounding.box", "geomesa.query.cost.type",
              "geomesa.scan.pallas", "geomesa.obs.write.block"}
_LITERAL = re.compile(r"""["'](geomesa\.[a-z0-9_]+(?:\.[a-z0-9_]+)+)["']""")


def _port_literals() -> set:
    files = list((ROOT / "geomesa_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    out = set()
    for f in files:
        out |= set(_LITERAL.findall(f.read_text()))
    return out


def test_port_names_are_a_subset_of_the_reference():
    tnames, jnames = tcfg.known_option_names(), jcfg.known_option_names()
    assert tnames <= jnames
    assert jnames - tnames == UNDECLARED
    for name in tnames:
        assert tcfg._REGISTRY[name].default == jcfg._REGISTRY[name].default, \
            name


def test_every_literal_in_the_port_is_declared():
    lits = _port_literals()
    # the store's knobs and the options this slice adds are among them
    assert {"geomesa.lean.hbm.budget", "geomesa.obs.heat.enabled",
            "geomesa.slo.objectives"} <= lits | tcfg.known_option_names()
    assert lits - tcfg.known_option_names() == set()


@pytest.mark.parametrize("cls", ["ObsProperties", "SloProperties"])
def test_new_knobs_match_reference(cls):
    tc, jc = getattr(tcfg, cls), getattr(jcfg, cls)
    names = {k for k, v in vars(tc).items()
             if isinstance(v, tcfg.SystemProperty)}
    for k in names:
        assert getattr(tc, k).name == getattr(jc, k).name
        assert getattr(tc, k).default == getattr(jc, k).default
    if cls == "SloProperties":
        assert len(names) == 8
    else:
        assert {"RECOMPILE_TRACK", "HEAT_ENABLED", "HEAT_TAU_S",
                "HEAT_MAX_ENTRIES", "JOBS_CAPACITY",
                "SCRAPE_MIN_INTERVAL_MS"} <= names
        assert "WRITE_BLOCK" not in names


def _warnings_of(cfg, fn):
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        fn()
    return [w for w in got if issubclass(w.category, cfg.UnknownOptionWarning)]


@pytest.mark.parametrize("typo", ["geomesa.lean.compactoin.factor",
                                  "geomesa.obs.heat.enabeld",
                                  "geomesa.slo.objective"])
def test_a_typo_warns_once_in_both_packages(typo):
    counts = []
    for cfg in (jcfg, tcfg):
        cfg._warned.discard(typo)
        first = _warnings_of(cfg, lambda: cfg.set_property(typo, 2))
        again = _warnings_of(cfg, lambda: cfg.set_property(typo, 3))
        cfg.clear_property(typo)
        counts.append((len(first), len(again)))
        assert "unregistered option" in str(first[0].message)
    assert counts[0] == counts[1] == (1, 0)


@pytest.mark.parametrize("name", sorted(UNDECLARED))
def test_reference_only_names_warn_in_the_port_alone(name):
    tcfg._warned.discard(name)
    assert len(_warnings_of(tcfg, lambda: tcfg.set_property(name, 1))) == 1
    tcfg.clear_property(name)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jcfg.set_property(name, jcfg._REGISTRY[name].default)
        jcfg.clear_property(name)


@pytest.mark.parametrize("name", ["geomesa.scan.ranges.target",
                                  "geomesa.slo.burn.alert",
                                  "myapp.private.knob"])
def test_declared_and_foreign_names_stay_silent(name):
    for cfg in (jcfg, tcfg):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            cfg.set_property(name, 1)
            cfg.clear_property(name)


def test_strict_mode_raises_in_both_packages():
    typo = "geomesa.lean.compaction.factr"
    for cfg in (jcfg, tcfg):
        cfg.set_property("geomesa.config.strict", True)
        try:
            with pytest.raises(ValueError, match="unregistered option"):
                cfg.set_property(typo, 0)
            with pytest.raises(ValueError, match="unregistered option"):
                cfg.SystemProperty("geomesa.nope.nope", 1).get()
            # clearing a stale typo stays possible: it only warns
            cfg._warned.discard(typo)
            assert len(_warnings_of(cfg, lambda: cfg.clear_property(typo))) \
                == 1
        finally:
            cfg.clear_property("geomesa.config.strict")
    # strict mode off again: a lookup of an undeclared name only warns
    tcfg._warned.discard("geomesa.nope.nope")
    assert len(_warnings_of(
        tcfg, lambda: tcfg.SystemProperty("geomesa.nope.nope", 1).get())) == 1
