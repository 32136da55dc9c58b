"""The finding model and the inline-pragma grammar.

A :class:`Finding` pins one invariant violation to a file/line; its
:meth:`Finding.key` deliberately EXCLUDES the line number — baseline
entries must survive unrelated edits above them, so grandfathering
matches on ``(check, file, message)`` and messages are written to be
stable (they name the symbol, not the position).

Pragmas (``# gm-lint: disable=<check>[,<check>...] [reason]``)
suppress findings on the pragma's own line, or — when the pragma is a
standalone comment line — on the next line; ``# gm-lint:
disable-file=<check>`` anywhere in a file suppresses the whole file.
A pragma may carry a free-form reason after the check list; the
convention (docs/static_analysis.md) is that it always should.
"""

from __future__ import annotations

import io
import re
import tokenize
from dataclasses import dataclass

__all__ = ["Finding", "findings_to_json", "parse_pragmas", "Pragmas"]

#: check ids are short kebab-case slugs
_PRAGMA_RE = re.compile(
    r"#\s*gm-lint:\s*(disable|disable-file)="
    r"(?P<checks>[a-z0-9,-]+)(?:\s+(?P<reason>.*))?")


@dataclass(frozen=True)
class Finding:
    """One invariant violation: where, which check, and a message
    stable across unrelated line churn."""

    file: str          # path relative to the analyzed root (posix)
    line: int          # 1-based line of the offending node
    check_id: str
    message: str

    def key(self) -> tuple:
        """Baseline identity — line-independent (module doc)."""
        return (self.check_id, self.file, self.message)

    def to_json(self) -> dict:
        return {"file": self.file, "line": self.line,
                "check": self.check_id, "message": self.message}

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.check_id}] {self.message}"


def findings_to_json(findings) -> list[dict]:
    return [f.to_json() for f in findings]


class Pragmas:
    """Per-file suppression state parsed from raw source lines."""

    __slots__ = ("line_disables", "file_disables")

    def __init__(self, line_disables: dict[int, set[str]],
                 file_disables: set[str]):
        self.line_disables = line_disables
        self.file_disables = file_disables

    def suppresses(self, check_id: str, line: int) -> bool:
        if check_id in self.file_disables:
            return True
        at = self.line_disables.get(line)
        return at is not None and check_id in at


def _comment_tokens(lines: list[str]):
    """``(line, text, standalone)`` for every COMMENT token — pragma
    syntax quoted in a docstring or string literal is NOT a pragma."""
    src = "\n".join(lines) + "\n"
    try:
        tokens = tokenize.generate_tokens(io.StringIO(src).readline)
        return [(t.start[0], t.string,
                 lines[t.start[0] - 1].lstrip().startswith("#"))
                for t in tokens if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # untokenizable text (the walker already ast-parsed it, so
        # this is belt-and-braces): fall back to the raw line scan
        return [(i, raw, raw.lstrip().startswith("#"))
                for i, raw in enumerate(lines, start=1)]


def parse_pragmas(lines: list[str], tokens=None) -> Pragmas:
    """Build the suppression map from COMMENT tokens only: a same-line
    pragma covers its own line; a standalone comment-line pragma
    covers the next line (the idiomatic spot above a multi-line
    statement).  ``tokens`` reuses a precomputed ``_comment_tokens``
    list so callers tokenize each file once."""
    line_disables: dict[int, set[str]] = {}
    file_disables: set[str] = set()
    for i, text, standalone in (tokens if tokens is not None
                                else _comment_tokens(lines)):
        m = _PRAGMA_RE.search(text)
        if m is None:
            continue
        checks = {c for c in m.group("checks").split(",") if c}
        if m.group(1) == "disable-file":
            file_disables |= checks
            continue
        line_disables.setdefault(i, set()).update(checks)
        if standalone:
            line_disables.setdefault(i + 1, set()).update(checks)
    return Pragmas(line_disables, file_disables)
