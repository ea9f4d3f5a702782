"""One run of one cell: set-up, the measured window, the metrics, the check.

The cell's traffic names its loop (`modes/<mode>.py`), which makes the
inputs from the seed, and says which of the program's commands a unit of
work (a shard) runs.  Each command runs as a process of its own
(`child.py`), as a user or a pipeline's scatter step starts it, and is
timed from its launch to its exit: nothing the program builds in one
process is there for the next.  The window is a closed loop: a shard
starts when the one before it has ended, until `seconds` have passed.
Untraced, the shard still running then is stopped and not counted;
traced, it is finished (its device work is in the trace) and not counted.
Then the loop checks what the window produced against the plain
reference.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from benchmark import devtrace, prepare, spec

FOREIGN = ("jax", "jaxlib", "flax", "ibwa_tpu")
CHILD = spec.HERE / "child.py"


def say(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def foreign_modules(names) -> list[str]:
    """The loaded modules whose top-level name is one the benchmark must
    not load, compared whole (`ibwa_tpu_torch` is not `ibwa_tpu`)."""
    return sorted(n for n in names if n.split(".")[0] in FOREIGN)


@dataclasses.dataclass
class Ctx:
    """What a mode's functions get: the cell's configuration and traffic,
    the run's seed, its scratch directory, the configuration's cache,
    extra CLI flags (a device; none on the card), and a fault to plant in
    every command (`plants.py`; none in the benchmark's runs)."""

    cfg: dict
    traffic: dict
    seed: int
    tmp: pathlib.Path
    cache: pathlib.Path
    cli_extra: tuple = ()
    ref_workers: int = 8
    ref_device: str = "cuda"
    plant: str | None = None
    inputs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class View:
    """What a metric's reader gets."""

    ctx: Ctx
    shards: list            # every shard run, in order: dicts
    done: list              # the shards that ended inside the window
    last_end: float         # the last of those ends, from the window
                            # start (traced: less the profiler's stretches)
    launches: dict          # the program's kernel launches in the loop
    trace: devtrace.Window | None
    traced_s: float         # the traced window, host clock, less the
                            # profiler's own stretches

    def kernel_ms(self, names: dict[str, str]) -> dict[str, float]:
        if self.trace is None:
            return {}
        return self.trace.kernel_ms(names, self.launches)


def ensure_cache(cfg: dict, cfg_file: pathlib.Path | None) -> None:
    """Make the configuration's cache in a child process (its memory on
    the card is not the run's) unless it is there."""
    if prepare.is_ready(cfg):
        return
    say(f"making the cache of {cfg['name']} (once per checkout)")
    subprocess.run([sys.executable, "-m", "benchmark.prepare",
                    str(cfg_file)], cwd=spec.ROOT, check=True,
                   stdout=sys.stderr)
    if not prepare.is_ready(cfg):
        raise RuntimeError(f"the cache of {cfg['name']} was not made")


class Command:
    """One of the program's commands in a process of its own."""

    def __init__(self, ctx: Ctx, args: list[str], name: str, trace: bool,
                 card: bool):
        self.name = name
        self.report = ctx.tmp / f"{name}.report.json"
        self.err_path = ctx.tmp / f"{name}.err"
        argv = [sys.executable, str(CHILD), "--report", str(self.report),
                "--trace", str(int(trace)), "--card", str(int(card))]
        if ctx.plant:
            argv += ["--plant", ctx.plant]
        self.start = time.perf_counter()
        with open(self.err_path, "wb") as err:
            self.proc = subprocess.Popen(
                argv + ["--", *args], cwd=spec.ROOT, stdin=subprocess.DEVNULL,
                stdout=err, stderr=subprocess.STDOUT)
        self.end = None

    def wait(self, timeout: float | None) -> bool:
        """Wait for the process, at most `timeout` seconds; whether it
        ended."""
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return False
        self.end = time.perf_counter()
        return True

    def stop(self) -> None:
        """Stop the process and wait until it has ended."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()

    def result(self) -> dict:
        """{rc, err (its standard error), report (child.py's, {} where it
        wrote none)}."""
        rep = (json.loads(self.report.read_text())
               if self.report.is_file() else {})
        return {"name": self.name, "rc": self.proc.returncode,
                "err": self.err_path.read_text(errors="replace"),
                "report": rep, "launch": self.start, "exit": self.end}


def run_commands(ctx: Ctx, commands: list[tuple[str, list[str]]],
                 trace: bool, card: bool, deadline: float | None):
    """Run (name, args) commands one after another; (runs, cut): each
    run's `Command.result()`, and whether the deadline (perf_counter)
    came first and stopped the one running."""
    runs = []
    for name, args in commands:
        cmd = Command(ctx, args, name, trace, card)
        left = None if deadline is None else max(deadline -
                                                 time.perf_counter(), 0.0)
        if not cmd.wait(left):
            cmd.stop()
            return runs, True
        runs.append(cmd.result())
        if runs[-1]["rc"] != 0:
            break
    return runs, False


def closed_loop(mode, ctx: Ctx, seconds: float, trace: bool, card: bool):
    """Run shards one after another until `seconds` have passed; returns
    (start, shards): each shard's start and end from the window's start,
    its commands' runs, and what the mode reads from them."""
    shards = []
    t_win = time.perf_counter()
    for i, unit in enumerate(ctx.inputs["shards"]):
        if time.perf_counter() - t_win >= seconds:
            break
        t0 = time.perf_counter()
        runs, cut = run_commands(
            ctx, mode.shard_commands(ctx, unit, i), trace, card,
            None if trace else t_win + seconds)
        rec = {"index": i, "units": unit["units"], "runs": runs,
               "start": t0 - t_win, "end": time.perf_counter() - t_win}
        if cut:
            rec["cut"] = True
            shards.append(rec)
            break
        failed = [r for r in runs if r["rc"] != 0]
        rec["rc"] = failed[0]["rc"] if failed else 0
        if failed:
            rec["error"] = failed[0]["err"][-4000:]
        rec.update(mode.shard_result(ctx, unit, runs))
        shards.append(rec)
    if time.perf_counter() - t_win < seconds and \
            not any(s.get("rc") for s in shards):
        raise RuntimeError(f"the traffic's {len(ctx.inputs['shards'])} "
                           f"shards ended before the {seconds} s window")
    return t_win, shards


def window_trace(shards: list, t_win: float, t_end: float
                 ) -> devtrace.Window:
    """The window's processes merged on the harness's clock."""
    device, named, spans, excluded = [], [], [], []
    for s in shards:
        for r in s["runs"]:
            rep, tag = r["report"], f"shard {s['index']} {r['name']}"
            excluded += profiler_stretches(rep)
            device += [devtrace.Op(*o) for o in rep.get("device_ops", [])]
            named += [devtrace.Op(f"{tag}: {n}", a, b)
                      for a, b, n in rep.get("gaps", [])]
            if "t_main" in rep:
                spans += [
                    devtrace.Op(f"{tag}: process start and imports",
                                r["launch"], rep["t_main"]),
                    devtrace.Op(f"{tag}: main", rep["t_main"],
                                rep["t_main_end"]),
                    devtrace.Op(f"{tag}: process exit", rep["t_main_end"],
                                r["exit"])]
    return devtrace.Window(t_win, t_end, device, named, spans, excluded)


def profiler_stretches(rep: dict) -> list[devtrace.Op]:
    """The stretches a traced process spent starting its profiler and
    exporting and reading its trace."""
    if "t_profiler" not in rep:
        return []
    return [devtrace.Op("profiler start", rep["t_profiler"], rep["t_main"]),
            devtrace.Op("profiler export", rep["t_main_end"],
                        rep["t_traced"])]


def run_cell(cfg: dict, traffic: dict, metrics: list[dict], seed: int,
             seconds: float, trace: bool, t0: float,
             cfg_file: pathlib.Path | None = None, card: bool = True,
             cli_extra: tuple = (), ref_workers: int = 8,
             plant: str | None = None) -> dict:
    """One run; returns the result's fields, `checks`: [(name, value,
    limit)], each a number the check compared beside its limit, and
    `foreign`: the modules of JAX or of the JAX package the program's
    processes had loaded."""
    ensure_cache(cfg, cfg_file)
    mode = spec.mode(traffic["mode"])
    base = pathlib.Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bench_run_", dir=base))
    ctx = Ctx(cfg, traffic, seed, tmp, prepare.cache_dir(cfg), cli_extra,
              ref_workers, "cuda" if card else "cpu", plant)
    try:
        mode.make_inputs(ctx)
        os.sync()                 # the shards on disk before the window
        warm, _ = run_commands(ctx, mode.warmup_commands(ctx), False, card,
                               None)
        bad = [r for r in warm if r["rc"] != 0]
        if bad or not warm:
            raise RuntimeError("the warm-up exited "
                               f"{bad[0]['rc'] if bad else None}:\n"
                               f"{bad[0]['err'][-4000:] if bad else ''}")
        setup_s = time.perf_counter() - t0
        t_win, shards = closed_loop(mode, ctx, seconds, trace, card)
        t_end = max([t_win + seconds] + [r["exit"] for s in shards
                                         for r in s["runs"]])
        runs = [r for s in shards for r in s["runs"]]
        launches: dict = {}
        for r in runs:
            for k, v in r["report"].get("launches", {}).items():
                launches[k] = launches.get(k, 0) + v
        tr = window_trace(shards, t_win, t_end) if trace else None
        traced_s = tr.seconds() if tr is not None else t_end - t_win
        peak = max([r["report"].get("memory_peak_bytes", 0)
                    for r in warm + runs])
        foreign = sorted({n for r in warm + runs
                          for n in r["report"].get("foreign", [])})
        done = [s for s in shards if not s.get("cut")
                and s["end"] <= seconds]
        # traced, the profiler's own stretches are not the program's time
        last_end = max((s["end"] for s in done), default=0.0) - sum(
            o.end - o.start for s in done for r in s["runs"]
            for o in profiler_stretches(r["report"]))
        view = View(ctx, shards, done, last_end, launches, tr, traced_s)
        values = {"setup_s": setup_s}
        out_metrics = {}
        for m in metrics:
            v = (values[m["name"]] if m["name"] in values
                 else spec.reader(m["name"]).read(view))
            if v is not None:
                out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        t_check = time.perf_counter()
        checks = mode.check(ctx, view)
        say(f"check of {sum(s['units'] for s in done)} units in "
            f"{time.perf_counter() - t_check:.1f} s")
        failed = sum(s["units"] for s in shards if s.get("rc", 0) != 0)
        result = {
            "correct": bool(done) and failed == 0
            and all(v <= lim for _, v, lim in checks),
            "attempted": sum(s["units"] for s in shards),
            "failed": failed,
            "metrics": out_metrics,
            "device": device_info(card, peak, tr, traced_s),
        }
        if tr is not None:
            result["breakdown"] = {"device_ops": tr.device_ops(),
                                   "idle_gaps": tr.idle_gaps()}
        for s in shards:
            say(f"shard {s['index']}: {s['start']:.3f}-{s['end']:.3f} s, "
                + ("cut at the window's close" if s.get("cut") else
                   f"rc {s.get('rc')}, " + ", ".join(
                       f"{k} {s.get('stats', {}).get(k)}"
                       for k in ("search_s", "reads", "host_reads",
                                 "fallback_reads", "fallback_by_cause"))))
            for r in s["runs"]:
                rep = r["report"]
                if "t_main" in rep:
                    say(f"  {r['name']}: start {rep['t_main'] - r['launch']:.3f}"
                        f" s, main {rep['t_main_end'] - rep['t_main']:.3f} s,"
                        f" exit {r['exit'] - rep['t_main_end']:.3f} s")
            if s.get("rc", 0) != 0:
                say(f"shard {s['index']} failed: {s.get('error')}")
        result["checks"] = checks
        result["foreign"] = foreign
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def stop_helpers() -> None:
    """Stop and wait for multiprocessing's resource tracker, the one
    process the spawned pools leave running until this one exits."""
    from multiprocessing import resource_tracker
    gc.collect()                  # the pools' semaphores unlinked first
    resource_tracker._resource_tracker._stop()


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def device_info(card: bool, peak: int, tr, traced_s: float) -> dict:
    import torch
    if card:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if tr is not None:
        info["busy_s"] = devtrace.busy_seconds(tr.device)
        info["window_s"] = traced_s
    return info
