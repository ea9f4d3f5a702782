"""One run of one cell of BENCHMARK.json on the card(s) it asks for.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints the result as the last line of standard output (one JSON object:
correct, attempted, failed, metrics, device, with --trace 1 breakdown,
and checks last: each number the correctness check compared beside its
limit), and the same numbers as the last lines of standard error.  Exits
2 without a result where the program is not in the checkout, or where
there is no card or fewer than the cell asks for, and 1 where a module of
JAX or of the JAX package is loaded once the window has closed, in this
process or in one of the program's.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness, spec
    if importlib.util.find_spec("ibwa_tpu_torch") is None:
        print("[benchmark] the program under test, ibwa_tpu_torch, is not "
              "in this checkout", file=sys.stderr)
        return 2
    bench = spec.Bench()
    wl = bench.workload(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < wl["chips"]:
        print(f"[benchmark] {args.workload} needs {wl['chips']} CUDA "
              f"card(s); this machine has {have}", file=sys.stderr)
        return 2
    cfg_file = bench.config_file(wl["config"])
    result = harness.run_cell(
        spec.load_json(cfg_file), spec.traffic(wl["traffic"]),
        bench.metrics(args.workload, bool(args.trace)), args.seed,
        args.seconds, bool(args.trace), T0, cfg_file=cfg_file)
    found = sorted(set(harness.foreign_modules(sys.modules))
                   | set(result.pop("foreign", [])))
    if found:
        print(f"[benchmark] loaded modules it must not: {found}",
              file=sys.stderr)
        return 1
    checks = result.pop("checks")
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    print(f"[benchmark] power limit {harness.power_limit()}",
          file=sys.stderr)
    for n, v, lim in checks:
        print(f"[benchmark] check {n} {v} limit {lim}", file=sys.stderr)
    print(f"[benchmark] correct {result['correct']}", file=sys.stderr,
          flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        from benchmark import harness
        harness.stop_helpers()
    raise SystemExit(rc)
