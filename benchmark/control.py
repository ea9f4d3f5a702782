"""The control of a cell's check: the program's card search with its host
fallback left out (`plants.no_fallback`: a read that overflows keeps the
hits the card found, the search cut short), put in the timed path of a
whole run at the cell's own size, must read as not correct.

    python3 -m benchmark.control --workload NAME --seeds 1,2,3 [--seconds S]

For each seed, one run of the cell by `harness.run_cell` with the plant
in every `aln` process, its window `--seconds` long (default 20: a shard
or more ends in it, and the check samples as many reads as a run's): one
JSON line with `correct` and each number the check compared beside its
limit.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import harness, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    bench = spec.Bench()
    wl = bench.workload(args.workload)
    cfg_file = bench.config_file(wl["config"])
    cfg = spec.load_json(cfg_file)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(cfg, spec.traffic(wl["traffic"]),
                             bench.metrics(args.workload, False), seed,
                             args.seconds, False, time.perf_counter(),
                             cfg_file=cfg_file, plant="no_fallback")
        print(json.dumps({
            "workload": args.workload, "seed": seed, "plant": "no_fallback",
            "correct": r["correct"], "attempted": r["attempted"],
            "failed": r["failed"],
            "checks": {n: {"value": v, "limit": lim}
                       for n, v, lim in r["checks"]}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        harness.stop_helpers()
    sys.exit(rc)
