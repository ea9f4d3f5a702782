"""The control of a cell's check: the program's card search with its host
fallback left out (`plants.no_fallback`: a read that overflows keeps the
hits the card found, the search cut short), put in the timed path of a
whole run at the cell's own size, must read as not correct.

    python3 -m benchmark.control --workload NAME --seeds 1,2,3 [--seconds S]

For each seed, one run of the cell by `harness.run_cell` with the plant
in every `aln` process, its window `--seconds` long (default the cell's
own, `run_seconds`; the check samples as many reads as a run's): one
JSON line with `correct` and each number the check compared beside its
limit.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import harness, spec

PLANT = "no_fallback"


def runs(cfg: dict, traffic: dict, metrics: list[dict], seeds, seconds:
         float, **run_cell_args):
    """One record a seed: the run with the control planted, its `correct`
    and the numbers its check compared."""
    for seed in seeds:
        r = harness.run_cell(cfg, traffic, metrics, seed, seconds, False,
                             time.perf_counter(), plant=PLANT,
                             **run_cell_args)
        yield {"seed": seed, "plant": PLANT, "correct": r["correct"],
               "attempted": r["attempted"], "failed": r["failed"],
               "checks": {n: {"value": v, "limit": lim}
                          for n, v, lim in r["checks"]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    bench = spec.Bench()
    wl = bench.workload(args.workload)
    cfg_file = bench.config_file(wl["config"])
    seconds = args.seconds or bench.doc["run_seconds"]
    for rec in runs(spec.load_json(cfg_file), spec.traffic(wl["traffic"]),
                    bench.metrics(args.workload, False),
                    [int(s) for s in args.seeds.split(",")], seconds,
                    cfg_file=cfg_file):
        print(json.dumps({"workload": args.workload, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        harness.stop_helpers()
    sys.exit(rc)
