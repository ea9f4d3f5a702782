"""Spans of a command: named stretches of its work on the machine's
monotonic clock, kept in memory and written out once, when it ends.

A span is a name, a start and an end (`time.perf_counter()`, the clock
the benchmark's device traces are shifted onto) and its parent: the span
open on the same thread when it opened.  A span belongs to a batch (an
index, or None outside the batches); one opened without a batch takes
its parent's.  A span opened on a worker thread has no parent and is
given its batch.  Spans of one name, parent and batch are summed into one
record as they close, so the record count is bounded by names x batches,
not by how often a span opens:

    [name, parent, batch, first_start, last_end, total_s, self_s, count]

`total_s` sums the spans' durations, `self_s` their durations less what
their child spans cover (children run nested on their parent's thread).
A span opened once is its own interval; one opened per chunk or per job
gives its envelope, its summed time and its count.

Recording costs two clock reads, a lock and a dict update a span; there
is no switch.  Each command makes a `Recorder` and passes it down.
"""

from __future__ import annotations

import threading
import time


class Recorder:
    """The spans of one command, from every thread it runs."""

    def __init__(self):
        self._records: dict[tuple, list] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, batch: int | None = None) -> "Span":
        """A context manager timing `name` (in `batch`, else the parent's)."""
        return Span(self, name, batch)

    def _close(self, sp: "Span", end: float) -> None:
        key = (sp.name, sp.parent, sp.batch)
        self_s = sp.seconds - sp.child_s
        with self._lock:
            r = self._records.get(key)
            if r is None:
                self._records[key] = [sp.start, end, sp.seconds, self_s, 1]
            else:
                r[1] = max(r[1], end)
                r[2] += sp.seconds
                r[3] += self_s
                r[4] += 1

    def total(self, name: str, batch: int | None = None) -> float:
        """The summed seconds of the closed spans `name` of `batch`."""
        with self._lock:
            return sum((r[2] for (n, _, b), r in self._records.items()
                        if n == name and b == batch), 0.0)

    def records(self) -> list[list]:
        """[name, parent, batch, first_start, last_end, total_s, self_s,
        count] a name, parent and batch, by first start."""
        with self._lock:
            out = [[*key, *r] for key, r in self._records.items()]
        return sorted(out, key=lambda r: r[3])


class Span:
    """One timed stretch (`Recorder.span`); `seconds` once closed."""

    __slots__ = ("rec", "name", "batch", "parent", "start", "seconds",
                 "child_s")

    def __init__(self, rec: Recorder, name: str, batch: int | None):
        self.rec, self.name, self.batch = rec, name, batch

    def __enter__(self) -> "Span":
        stack = self.rec._stack()
        self.parent = stack[-1].name if stack else None
        if self.batch is None and stack:
            self.batch = stack[-1].batch
        self.child_s = 0.0
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter()
        self.seconds = end - self.start
        stack = self.rec._stack()
        stack.pop()
        if stack:
            stack[-1].child_s += self.seconds
        self.rec._close(self, end)
