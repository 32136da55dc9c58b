"""Explain tracing: hierarchical, lazily-evaluated query-plan traces.

Mirrors the reference's Explainer (geomesa-index-api/.../index/utils/
Explainer.scala:18-42): ``push``/``pop`` indentation levels, lazy message
evaluation (callables are only invoked when the sink is active), and
pluggable sinks — string buffer, logging, stdout, or the null sink.
"""

from __future__ import annotations

import logging
from typing import Callable

__all__ = ["Explainer", "ExplainString", "ExplainPrintln", "ExplainLogging",
           "ExplainNull"]


class Explainer:
    """Base explainer; subclasses implement ``output``."""

    active: bool = True

    def __init__(self):
        self._level = 0

    def output(self, text: str) -> None:
        raise NotImplementedError

    def __call__(self, msg, *lazy_parts) -> "Explainer":
        if self.active:
            text = msg() if callable(msg) else str(msg)
            for part in lazy_parts:
                text += part() if callable(part) else str(part)
            self.output("  " * self._level + text)
        return self

    def push(self, msg=None) -> "Explainer":
        if msg is not None:
            self(msg)
        self._level += 1
        return self

    def pop(self) -> "Explainer":
        self._level = max(0, self._level - 1)
        return self


class ExplainString(Explainer):
    """Accumulate the trace into a string (the `explain` CLI sink)."""

    def __init__(self):
        super().__init__()
        self._lines: list[str] = []

    def output(self, text: str) -> None:
        self._lines.append(text)

    def __str__(self) -> str:
        return "\n".join(self._lines)


class ExplainPrintln(Explainer):
    def output(self, text: str) -> None:
        print(text)


class ExplainLogging(Explainer):
    def __init__(self, logger: logging.Logger | None = None,
                 level: int = logging.DEBUG):
        super().__init__()
        self._logger = logger or logging.getLogger("geomesa_tpu.plan")
        self._log_level = level

    def output(self, text: str) -> None:
        self._logger.log(self._log_level, text)


class ExplainNull(Explainer):
    active = False

    def output(self, text: str) -> None:
        pass
