"""The dependent-gather probe: chains of dependent table-row fetches.

Port of `scripts/bench_chase.py`.  The aln engine's occ queries (K2) and
the SA walker (K5) are dependent pointer chases: each step's row address
is the previous step's result.  This probe measures what such a step
costs on the card, for a table that sits in the L2 cache and for one that
does not.  B lanes each follow

    row = table[idx];  idx = (row[0] ^ it) % n_rows;  acc ^= row[1]

for `steps` steps, fetching the whole `roww`-word row each step.

Variants of the report:

  torch      `chase_plain`: one B-row gather per step, a Python loop of
             torch ops (the counterpart of `chase_xla`)
  torch-mwW  `chase_plain_mw`: W serial B/W-row gathers per step
  chase      K3, `csrc/chase.cu`: per-lane asynchronous row copies, every
             copy waited for before the compute (unpipelined)
  chase-mwW  K4: W waves per block, one wave's copies in flight while the
             others are waited for and computed

A CPU table runs the plain versions only; a CUDA table runs the kernels
or raises.  The table is an int32 tensor holding u32 bit patterns, as the
FM block table is (`u32.py`).

Times are CUDA-event times of one launch, reported both as launch / steps
and as the marginal cost (t(steps + delta) - t(steps)) / delta, which
takes the launch out.  Every timed launch follows chains of its own after
one read of the whole table (see `time_call`), so a table larger than the
L2 cache is met cold and a smaller one resident.  Rows fetched is exactly
lanes x steps.

Run: python -m ibwa_tpu_torch.bench_chase --device cuda [--rows N]
     [--roww W] [--steps S] [--delta D] [--lanes B ...] [--waves W ...]
     [--reps R] [--json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from . import kernels
from .u32 import MASK

REPO = pathlib.Path(__file__).resolve().parent.parent
ROWW = 128            # words per row of the default table (512 B rows)
LANES_PER_BLOCK = 64  # lanes one thread block of K3 / K4 carries


def make_table(n_rows: int, roww: int, seed=0) -> np.ndarray:
    """uint32[n_rows, roww] of row numbers, as the JAX probe makes it."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_rows, size=(n_rows, roww), dtype=np.uint32)


def make_table_device(n_rows: int, roww: int, seed: int, device
                      ) -> torch.Tensor:
    """int32[n_rows, roww] of row numbers, made on `device` from `seed`
    (a table of gigabytes is not made on the host)."""
    _check_rows(n_rows)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, n_rows, (n_rows, roww), dtype=torch.int32,
                         device=device, generator=gen)


def _check_rows(n_rows: int) -> None:
    if not 0 < n_rows < 1 << 31:
        raise ValueError(f"n_rows must be in 1 .. 2**31 - 1: {n_rows}")


def _next(row: torch.Tensor, it: int, n_rows: int) -> torch.Tensor:
    """(row[:, 0] ^ it) % n_rows as an unsigned remainder, int64."""
    return (((row[:, 0].to(torch.int64) & MASK) ^ it) % n_rows)


def chase_plain(table: torch.Tensor, idx0: torch.Tensor, steps: int,
                n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: one `table[idx]` gather per step.

    table: int32[n_rows, roww]; idx0: int32[B].  Returns (idx, acc) as
    int32[B]."""
    idx = idx0.to(torch.int64)
    acc = torch.zeros_like(idx0)
    for it in range(steps):
        row = table[idx]                       # [B, roww] gather
        idx = _next(row, it, n_rows)
        acc = acc ^ row[:, 1]
    return idx.to(torch.int32), acc


def chase_plain_mw(table: torch.Tensor, idx0: torch.Tensor, steps: int,
                   n_rows: int, waves: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """W serial B/W-row gathers per step instead of one B-row gather; the
    results equal `chase_plain`'s."""
    B = idx0.shape[0]
    if waves <= 0 or B % waves:
        raise ValueError(f"waves={waves} must divide the {B} lanes")
    bw = B // waves
    idx = idx0.to(torch.int64)
    acc = torch.zeros_like(idx0)
    for it in range(steps):
        nxt, got = [], []
        for w in range(waves):
            row = table[idx[w * bw:(w + 1) * bw]]
            nxt.append(_next(row, it, n_rows))
            got.append(row[:, 1])
        idx = torch.cat(nxt)
        acc = acc ^ torch.cat(got)
    return idx.to(torch.int32), acc


def _check_args(table: torch.Tensor, idx0: torch.Tensor, steps: int,
                n_rows: int) -> None:
    _check_rows(n_rows)
    if (table.dtype != torch.int32 or table.dim() != 2
            or table.shape[0] != n_rows):
        raise ValueError("table must be an int32[n_rows, roww] tensor")
    if (idx0.dtype != torch.int32 or idx0.dim() != 1
            or idx0.device != table.device):
        raise ValueError("idx0 must be an int32[B] tensor on the table's "
                         "device")
    if steps < 0:
        raise ValueError(f"steps must not be negative: {steps}")


def _launch(name: str, table, idx0, steps, n_rows, *waves):
    """Checks of a CUDA launch of K3 / K4, the launch and its count."""
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    roww = table.shape[1]
    if roww % 4:
        raise ValueError(f"{name}: roww={roww} must be a multiple of 4 "
                         f"words (rows are copied in 16-byte chunks)")
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError(f"{name}: table must be contiguous and 16-byte "
                         f"aligned")
    B = idx0.shape[0]
    lpb = min(LANES_PER_BLOCK, B)
    if waves and (waves[0] <= 0 or lpb % waves[0]):
        raise ValueError(f"{name}: waves={waves[0]} must divide the {lpb} "
                         f"lanes of a block")
    idx0 = idx0.contiguous()
    out_idx = torch.empty_like(idx0)
    out_acc = torch.empty_like(idx0)
    if B == 0:
        return out_idx, out_acc
    fn = getattr(kernels.lib(), f"ibwa_{name}")
    rc = fn(table.data_ptr(), idx0.data_ptr(), out_idx.data_ptr(),
            out_acc.data_ptr(), B, lpb, roww, steps, n_rows, *waves,
            torch.cuda.current_stream(table.device).cuda_stream)
    kernels.check(rc, name)
    kernels.launches[name] += 1
    return out_idx, out_acc


def chase(table: torch.Tensor, idx0: torch.Tensor, steps: int, n_rows: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: `chase_plain` for a CPU table, the kernel for a CUDA table."""
    _check_args(table, idx0, steps, n_rows)
    if table.device.type == "cpu":
        return chase_plain(table, idx0, steps, n_rows)
    return _launch("chase", table, idx0, steps, n_rows)


def chase_mw(table: torch.Tensor, idx0: torch.Tensor, steps: int,
             n_rows: int, waves: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: `chase_plain_mw` for a CPU table, the kernel for a CUDA table.
    `waves` must divide the lanes of a block (and of the call)."""
    _check_args(table, idx0, steps, n_rows)
    if table.device.type == "cpu":
        return chase_plain_mw(table, idx0, steps, n_rows, waves)
    return _launch("chase_mw", table, idx0, steps, n_rows, waves)


# ------------------------------------------------------------- timing
def start_rows(n_rows: int, lanes: int, count: int, device
               ) -> list[torch.Tensor]:
    """`count` different start vectors int32[lanes], from seeds 1, 2, ..."""
    return [torch.from_numpy(np.random.default_rng(1 + r).integers(
        0, n_rows, lanes, dtype=np.int32)).to(device) for r in range(count)]


def time_call(fn, starts: list[torch.Tensor], table: torch.Tensor) -> float:
    """Best seconds of one call fn(idx0) over starts[1:], after a warm-up
    call on starts[0]: CUDA events on a CUDA device, the host clock on the
    CPU.

    A chain is fixed by its start rows, so a call repeated on the same
    rows would find them all in the L2 cache, whatever the table's size.
    Every timed call therefore follows chains of its own, and before each
    the whole table is read once: a table that fits the L2 is then found
    there, as a resident FM table would be, and a larger one has pushed
    the earlier calls' rows out."""
    fn(starts[0])
    best = float("inf")
    for idx0 in starts[1:]:
        if table.device.type != "cuda":
            t0 = time.perf_counter()
            fn(idx0)
            best = min(best, time.perf_counter() - t0)
            continue
        table.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(idx0)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def probe(table: torch.Tensor, lanes: list[int], waves: list[int],
          steps: int, delta: int, reps: int = 3, plain_mw: bool = True,
          label: str = "") -> list[dict]:
    """The probe's report for one table: per (lanes, variant) the time of
    one launch over its steps, the marginal time per step, both per row,
    and parity with `chase_plain`."""
    if reps < 1 or steps < 1 or delta < 1:
        raise ValueError("reps, steps and delta must be at least 1")
    n_rows, roww = table.shape
    on_card = table.device.type == "cuda"
    results = []
    for B in lanes:
        starts = start_rows(n_rows, B, reps + 1, table.device)
        want = chase_plain(table, starts[0], steps, n_rows)
        variants = [("torch", lambda i, s: chase_plain(table, i, s, n_rows))]
        if plain_mw:
            variants += [
                (f"torch-mw{W}", lambda i, s, W=W: chase_plain_mw(
                    table, i, s, n_rows, W))
                for W in waves if B % W == 0]
        if on_card:
            variants.append(
                ("chase", lambda i, s: chase(table, i, s, n_rows)))
            variants += [
                (f"chase-mw{W}", lambda i, s, W=W: chase_mw(
                    table, i, s, n_rows, W))
                for W in waves if min(LANES_PER_BLOCK, B) % W == 0]
        for name, run in variants:
            t1 = time_call(lambda i: run(i, steps), starts, table)
            t2 = time_call(lambda i: run(i, steps + delta), starts, table)
            got = run(starts[0], steps)
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            per, marg = t1 / steps, (t2 - t1) / delta
            rec = {"table": label, "rows": n_rows, "roww": roww,
                   "variant": name, "lanes": B, "steps": steps,
                   "rows_fetched": B * steps,
                   "us_per_step": per * 1e6, "ns_per_row": per / B * 1e9,
                   "marginal_us_per_step": marg * 1e6,
                   "marginal_ns_per_row": marg / B * 1e9, "parity": ok}
            print(f"{label} B={B:6d} {name:10s}: {per * 1e6:9.3f} us/step "
                  f"{per / B * 1e9:8.3f} ns/row | marginal "
                  f"{marg * 1e6:9.3f} us/step {marg / B * 1e9:8.3f} ns/row "
                  f"{'OK' if ok else 'MISMATCH'}", flush=True)
            results.append(rec)
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibwa_tpu_torch.bench_chase")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the table (cuda, cuda:N, cpu)")
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--delta", type=int, default=2048,
                    help="extra steps for the marginal measurement")
    ap.add_argument("--lanes", type=int, nargs="*", default=[256, 1024])
    ap.add_argument("--waves", type=int, nargs="*", default=[4])
    ap.add_argument("--roww", type=int, default=ROWW)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}", flush=True)
    table = make_table_device(args.rows, args.roww, 0, device)
    results = probe(table, args.lanes, args.waves, args.steps, args.delta,
                    args.reps, label=f"{args.rows}x{args.roww}")
    if args.json:
        out = REPO / ".bench" / "chase_torch.json"
        out.parent.mkdir(exist_ok=True)
        out.write_text(json.dumps({"device": name, "results": results},
                                  indent=1))
        print(f"wrote {out}", file=sys.stderr)
    return 0 if all(r["parity"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
