"""Structured per-frame metrics and timers.

Replaces the reference's `Stopwatch` (UDP-streamed named CPU timers) and
GUI counters (SURVEY.md §6 "Metrics / tracing").  Design:

- `MetricsWriter`: one flat dict per frame, written as JSONL — machine-
  greppable, TensorBoard-convertible, no GUI dependency.
- `Timer`: wall-clock phase timers.  Dispatch is async, so a phase only
  times device work when given a pytree to wait for (`sync_tree`).
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, IO

import jax


class Timer:
    """Named phase timers (per-frame scope)."""

    def __init__(self) -> None:
        self.times_ms: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_tree: Any = None):
        t0 = time.perf_counter()
        yield
        if sync_tree is not None:
            jax.block_until_ready(sync_tree)
        self.times_ms[name] = self.times_ms.get(name, 0.0) + (
            (time.perf_counter() - t0) * 1000.0
        )


class MetricsWriter:
    """JSONL metrics stream (stdout and/or file)."""

    def __init__(self, path: str | None = None, echo: bool = False) -> None:
        self._f: IO[str] | None = open(path, "w") if path else None
        self._echo = echo

    def write(self, record: dict) -> None:
        line = json.dumps(record)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self._echo:
            print(line)

    def close(self) -> None:
        if self._f:
            self._f.close()
