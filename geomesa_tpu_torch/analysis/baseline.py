"""Grandfathered-finding baseline: the committed ``baseline.json``.

A baseline entry matches findings by :meth:`Finding.key` — ``(check,
file, message)``, no line number — so entries survive unrelated edits.
Every entry MUST carry a non-empty ``justification`` string: a
baseline is a debt ledger, and an unjustified entry is
indistinguishable from a silenced bug, so loading rejects it outright.

``--fail-on-new`` mode: findings whose key is in the baseline are
reported as baselined (exit 0); anything else is NEW and fails.  Stale
entries (baselined keys no finding produced) are reported so the
ledger shrinks as violations get fixed.
"""

from __future__ import annotations

import json
from pathlib import Path

from .model import Finding

__all__ = ["Baseline", "BaselineError", "DEFAULT_BASELINE_PATH"]

#: the committed ledger, next to this module
DEFAULT_BASELINE_PATH = Path(__file__).resolve().parent / "baseline.json"


class BaselineError(ValueError):
    """Malformed or unjustified baseline content."""


class Baseline:
    """A loaded ledger: key -> justification."""

    def __init__(self, entries: dict[tuple, str] | None = None):
        self.entries: dict[tuple, str] = dict(entries or {})

    @classmethod
    def load(cls, path: Path | str = DEFAULT_BASELINE_PATH) -> "Baseline":
        path = Path(path)
        if not path.exists():
            return cls()
        try:
            data = json.loads(path.read_text(encoding="utf-8"))
        except json.JSONDecodeError as e:
            raise BaselineError(f"unparseable baseline {path}: {e}") from e
        entries: dict[tuple, str] = {}
        for i, row in enumerate(data.get("entries", ())):
            missing = {"check", "file", "message"} - set(row)
            if missing:
                raise BaselineError(
                    f"baseline entry {i} missing {sorted(missing)}")
            just = str(row.get("justification", "")).strip()
            if not just:
                raise BaselineError(
                    f"baseline entry {i} ({row['check']} @ {row['file']}) "
                    f"has no justification — every grandfathered finding "
                    f"must say WHY it is acceptable")
            entries[(row["check"], row["file"], row["message"])] = just
        return cls(entries)

    @classmethod
    def from_findings(cls, findings, justification: str) -> "Baseline":
        """Build a ledger grandfathering ``findings`` (the round-trip
        helper tests and ``--write-baseline`` use)."""
        return cls({f.key(): justification for f in findings})

    def save(self, path: Path | str) -> None:
        rows = [{"check": c, "file": f, "message": m, "justification": j}
                for (c, f, m), j in sorted(self.entries.items())]
        Path(path).write_text(
            json.dumps({"version": 1, "entries": rows}, indent=1) + "\n",
            encoding="utf-8")

    def contains(self, finding: Finding) -> bool:
        return finding.key() in self.entries

    def split(self, findings) -> tuple[list, list, list]:
        """``(new, baselined, stale_keys)`` for a finding set."""
        new, seen = [], set()
        baselined = []
        for f in findings:
            if f.key() in self.entries:
                baselined.append(f)
                seen.add(f.key())
            else:
                new.append(f)
        stale = sorted(k for k in self.entries if k not in seen)
        return new, baselined, stale
