"""How often a torch.profiler session on the card loses its records.

    python3 -m ibwa_tpu_torch.profiler_probe [--seconds 200]

Makes profiler sessions of 1, 5, 20 and 200 launches of one small kernel
in turns for `--seconds`, and counts per size the sessions that saw no
device time at all ("empty") and those that saw fewer launches than they
made ("short").  After an empty session it makes three more at once and
records what each saw, with the time since the start, so that the
spacing of the losses shows.  Prints one JSON object.  `chip_smoke.py`
retries an empty session after a pause because of what this finds."""
from __future__ import annotations

import argparse
import json
import sys
import time

SIZES = (1, 5, 20, 200)


def session(x, n: int) -> tuple[int, float]:
    """(launches seen, device us) of a profiler session of n launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            x.add_(1)
        torch.cuda.synchronize()
    seen, us = 0, 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0:
            seen += e.count
            us += e.self_device_time_total
    return seen, us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=200.0)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this probe runs on the card only",
              file=sys.stderr)
        return 2
    x = torch.zeros(1 << 22, device="cuda", dtype=torch.int32)
    stats = {n: {"sessions": 0, "empty": 0, "short": 0} for n in SIZES}
    empty = []
    t0 = time.time()
    i = 0
    while time.time() - t0 < a.seconds:
        n = SIZES[i % len(SIZES)]
        seen, us = session(x, n)
        stats[n]["sessions"] += 1
        if us <= 0:
            stats[n]["empty"] += 1
            empty.append({"session": i, "launches": n,
                          "at_s": round(time.time() - t0, 1),
                          "next_three_saw": [session(x, n)[0]
                                             for _ in range(3)]})
        elif seen < n:
            stats[n]["short"] += 1
        i += 1
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "seconds": a.seconds,
                      "by_launches": stats, "empty": empty}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
