"""One command of the program in a process of its own, as a user starts it.

    python3 benchmark/child.py --report R.json [--trace 0|1] [--card 0|1]
        [--plant NAME[:ARG]] -- <the program's CLI arguments>

Runs `ibwa_tpu_torch.cli.main(arguments)` (what `python -m ibwa_tpu_torch`
runs); its standard error is the program's.  Then writes R.json: the exit
code, the perf_counter clock (the machine's monotonic clock, the harness's
too) at the start of this process's own code and around `main`, the
program's kernel launches, the card's peak memory, the loaded modules of
JAX or of the JAX package, and with --trace 1 the device operations of
`main` under `torch.profiler` on that clock and the idle stretches within
it, each named by the host operation at its middle, with the clock before
the profiler is imported and once its trace is read (the profiler's own
import, start and export, which the harness leaves out of the window).
`--plant NAME[:ARG]` breaks the timed path in one of the ways `plants.py`
names; the benchmark's own runs never give it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

GAPS_KEPT = 64       # the longest idle stretches a process reports


def traced(fn, report: dict, card: bool, trace_file: pathlib.Path) -> int:
    """fn() under the profiler; its device operations and idle stretches
    into `report`, on the perf_counter clock; torch itself is imported
    first, as the program would import it."""
    import torch
    report["t_profiler"] = time.perf_counter()
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import devtrace
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=acts) as prof:
        t0 = report["t_main"] = time.perf_counter()
        with record_function(devtrace.SPAN_PREFIX + "main"):
            rc = fn()
        if card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_file))
    tr = devtrace.Trace.from_chrome(trace_file)
    trace_file.unlink()
    main = [s for s in tr.spans if s.name == devtrace.SPAN_PREFIX + "main"]
    shift = t0 - main[0].start
    report["device_ops"] = [[o.name, o.start + shift, o.end + shift]
                            for o in tr.device]
    gaps = tr.named_gaps(main[0].start, main[0].end)
    gaps.sort(key=lambda g: g[0] - g[1])
    report["gaps"] = [[s + shift, e + shift, name]
                      for s, e, name in gaps[:GAPS_KEPT]]
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--card", type=int, choices=(0, 1), default=1)
    ap.add_argument("--plant", default=None)
    ap.add_argument("cli", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    cli_args = args.cli[1:] if args.cli[:1] == ["--"] else args.cli
    report_path = pathlib.Path(args.report)

    from ibwa_tpu_torch import cli, kernels

    from benchmark import harness
    if args.plant:
        from benchmark import plants
        plants.plant(args.plant, cli_args)
    report = {"t_start": T_START}
    report["t_main"] = time.perf_counter()
    if args.trace:
        rc = traced(lambda: cli.main(cli_args), report, bool(args.card),
                    report_path.with_suffix(".trace.json"))
    else:
        rc = cli.main(cli_args)
    report["t_main_end"] = time.perf_counter()
    import torch
    report.update(
        rc=rc, launches=dict(kernels.launches),
        memory_peak_bytes=(torch.cuda.max_memory_allocated(0)
                           if args.card and torch.cuda.is_initialized()
                           else 0),
        foreign=harness.foreign_modules(sys.modules))
    if args.trace:
        report["t_traced"] = time.perf_counter()
    report_path.write_text(json.dumps(report))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
