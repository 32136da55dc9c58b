"""Converter enrichment caches.

The analog of the reference's enrichment-cache SPI
(geomesa-convert-common/.../transforms/EnrichmentCacheFunctionFactory.scala
and the ``geomesa.convert.caches`` config): named lookup tables available
to transform expressions via ``cacheLookup('name', $keyExpr, 'field')``.

Sources: inline config maps, or CSV files (first row = header, one
column designated the key).  The port's copy of the JAX package's
``io/enrichment.py``.
"""

from __future__ import annotations

import threading

__all__ = ["EnrichmentCache", "InlineCache", "CsvCache", "register_cache",
           "lookup_cache", "cache_from_config", "clear_caches"]

_registry: dict[str, "EnrichmentCache"] = {}
_lock = threading.Lock()
#: converter-scoped caches pushed for the duration of a convert() call —
#: takes precedence over the global registry so two converters with
#: same-named caches never see each other's tables
_active = threading.local()


class EnrichmentCache:
    """name → (key → {field: value}) lookup."""

    def get(self, key, field):  # pragma: no cover - interface
        raise NotImplementedError


class InlineCache(EnrichmentCache):
    def __init__(self, data: dict):
        self.data = {str(k): v for k, v in data.items()}

    def get(self, key, field):
        row = self.data.get(str(key))
        return None if row is None else row.get(field)


class CsvCache(EnrichmentCache):
    """CSV file with a header row; ``key_column`` values index the rows."""

    def __init__(self, path: str, key_column: str):
        import csv
        self.data: dict = {}
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                self.data[str(row[key_column])] = row

    def get(self, key, field):
        row = self.data.get(str(key))
        return None if row is None else row.get(field)


def register_cache(name: str, cache: EnrichmentCache) -> None:
    with _lock:
        _registry[name] = cache


def push_active_caches(caches: dict) -> None:
    stack = getattr(_active, "stack", None)
    if stack is None:
        stack = _active.stack = []
    stack.append(caches)


def pop_active_caches() -> None:
    _active.stack.pop()


def lookup_cache(name: str) -> EnrichmentCache:
    for scope in reversed(getattr(_active, "stack", [])):
        if name in scope:
            return scope[name]
    with _lock:
        if name not in _registry:
            raise KeyError(f"no enrichment cache {name!r} registered")
        return _registry[name]


def clear_caches() -> None:
    with _lock:
        _registry.clear()


def cache_from_config(cfg: dict) -> EnrichmentCache:
    kind = cfg.get("type", "inline")
    if kind == "inline":
        return InlineCache(cfg["data"])
    if kind == "csv":
        return CsvCache(cfg["path"], cfg.get("key-column", "id"))
    raise ValueError(f"unknown enrichment cache type {kind!r}")
