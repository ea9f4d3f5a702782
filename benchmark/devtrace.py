"""The profiler's traces of a window, reduced to what the metrics read.

Each process the window runs traces itself (`child.py`): `Trace.
from_chrome` reads its `torch.profiler` chrome trace (device operations
— kernels, copies, sets — the host's torch operations, and spans: the
`record_function` names that start with `SPAN_PREFIX`), and the process
reports its device operations and its own idle stretches, each named by
the host operation at its middle, on the machine's monotonic clock.
`Window` merges the processes on that clock with the harness's own
spans (each process's start, its `main`, its exit).  Times are seconds.
"""

from __future__ import annotations

import collections
import dataclasses
import json

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
SPAN_PREFIX = "bench:"


@dataclasses.dataclass
class Op:
    name: str
    start: float
    end: float


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The intervals merged where they overlap or touch, in order."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(ops: list[Op]) -> float:
    return sum(e - s for s, e in union([(o.start, o.end) for o in ops]))


def gaps(ops: list[Op], start: float, end: float
         ) -> list[tuple[float, float]]:
    """The stretches of [start, end] in which no device operation ran."""
    out, t = [], start
    for s, e in union([(max(o.start, start), min(o.end, end)) for o in ops
                       if o.end > start and o.start < end]):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if end > t:
        out.append((t, end))
    return out


def kernel_ms(device: list[Op], names: dict[str, str],
              launches: dict[str, int]) -> dict[str, float]:
    """{kernel: device ms}: each kernel's mean time a launch seen in the
    trace times its launches counted by the program (a trace can lose
    some records); a kernel that ran and was never seen is left out.
    `names`: {counter name: text in the kernel's symbol}."""
    seen: dict[str, list[float]] = collections.defaultdict(list)
    for op in device:
        for counter, symbol in names.items():
            if symbol in op.name:
                seen[counter].append(op.end - op.start)
    return {k: 1e3 * sum(v) / len(v) * launches.get(k, 0)
            for k, v in seen.items() if v}


def device_ops(device: list[Op], top: int = 10) -> list[list]:
    """The device operations that took most time: [name, seconds]."""
    total: dict[str, float] = collections.defaultdict(float)
    for op in device:
        total[op.name] += op.end - op.start
    return [[k, v] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:top]]


@dataclasses.dataclass
class Trace:
    """One process's trace."""

    device: list[Op]
    host: list[Op]
    spans: list[Op]

    @classmethod
    def from_chrome(cls, path) -> "Trace":
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        device, host, spans = [], [], []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            op = Op(ev.get("name", ""), ev["ts"] / 1e6,
                    (ev["ts"] + ev["dur"]) / 1e6)
            cat = ev.get("cat", "")
            if cat in DEVICE_CATS:
                device.append(op)
            elif op.name.startswith(SPAN_PREFIX):
                spans.append(op)
            elif cat == "cpu_op":
                host.append(op)
        return cls(device, host, spans)

    def named_gaps(self, start: float, end: float
                   ) -> list[tuple[float, float, str]]:
        """The device's idle stretches in [start, end], each named by the
        innermost host torch operation at its middle, if any."""
        out = []
        for s, e in gaps(self.device, start, end):
            mid = (s + e) / 2
            ops = [o for o in self.host if o.start <= mid <= o.end]
            out.append((s, e, min(ops, key=lambda o: o.end - o.start).name
                        if ops else "host code outside torch"))
        return out


@dataclasses.dataclass
class Window:
    """The traced window [start, end] of the harness: every process's
    device operations, the named stretches that say what the host was
    doing (the processes' own idle stretches first, then the harness's
    spans), and the stretches the profiler spent starting and exporting,
    which are not the program's and are left out."""

    start: float
    end: float
    device: list[Op]
    named: list[Op]
    spans: list[Op]
    excluded: list[Op] = dataclasses.field(default_factory=list)

    def seconds(self) -> float:
        """The window's wall, less the profiler's own stretches."""
        return self.end - self.start - sum(
            e - s for s, e in union([(o.start, o.end)
                                     for o in self.excluded]))

    def kernel_ms(self, names: dict[str, str], launches: dict[str, int]
                  ) -> dict[str, float]:
        return kernel_ms(self.device, names, launches)

    def device_ops(self, top: int = 10) -> list[list]:
        return device_ops(self.device, top)

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The longest stretches of the window with no device operation,
        each named by what the host was doing at its middle: [name,
        seconds]."""
        out = []
        for s, e in gaps(self.device + self.excluded, self.start, self.end):
            mid = (s + e) / 2
            where = [o.name for o in self.named + self.spans
                     if o.start <= mid <= o.end]
            out.append([where[0] if where else "harness", e - s])
        return sorted(out, key=lambda g: -g[1])[:top]
