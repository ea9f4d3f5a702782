"""Smoke test of ibwa_tpu_torch on one CUDA card: builds the kernels,
checks them against their plain twins, and drives `aln` end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. device: a CUDA card is required (there is no CPU path)
  2. build: csrc/*.cu with nvcc for sm_90a
  3. kernel vs twin, bitwise, at the main path's shapes: K1 stack_update
     at B=1024 x ACAP 256 and 1024; K2 occ4_pair / occ1_pair over the
     main path's block table; each timed beside its twin
  4. main path: a 32 Mbp repeat-structured genome (bench.py's recipe,
     indexed and cached under .bench/smoke/), 16,384 simulated 100 bp
     reads; `ibwa_tpu_torch aln` device-only (IBWA_HOST_FRAC=0), then
     hybrid; each .sai must be byte-identical to `--engine native`, and
     every kernel must have launched during the device-only run
  5. the result lines: the card, the kernel table, and the contract line
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import random
import subprocess
import sys
import time

SEED = 20261016
N_READS = 16384
READ_LEN = 100
B_LANES = 1024
REPO = pathlib.Path(__file__).resolve().parent
WORK = REPO / ".bench" / "smoke"


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def timed_ms(fn, reps: int) -> tuple[float, float]:
    """(device ms, call ms) per call of fn over `reps` calls, after one
    warm-up call.  Device ms is the summed time of the kernels the calls
    ran (torch.profiler); call ms is the CUDA-event span of the calls,
    which at these sizes is set by the host launching them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if dev_us <= 0:
        raise AssertionError("the profiler saw no device time")
    return dev_us / 1e3 / reps, call_ms


def max_abs_err(got, want) -> int:
    import torch
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def check_stack(dev) -> dict:
    """K1 against stack_update_plain on random planes (ties, full rows,
    inactive lanes) at B=1024 and both arena sizes."""
    import numpy as np
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.align import stack_kernel as sk
    row = {}
    for acap in (256, 1024):
        case = sk.random_case(np.random.default_rng(SEED + acap), B_LANES,
                              acap)
        args = sk.case_tensors(case, dev)
        want = sk.stack_update_plain(*args)
        got = sk.stack_update(*[a.clone() for a in args])
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"stack_update ACAP={acap}: kernel != twin "
                                 f"(max abs err {err})")
        scratch = [a.clone() for a in args]
        ms, call_ms = timed_ms(lambda: sk.stack_update(*scratch), 200)
        plain_ms, plain_call_ms = timed_ms(
            lambda: sk.stack_update_plain(*args), 50)
        log(f"K1 stack_update B={B_LANES} ACAP={acap}: bitwise equal; "
            f"device ms/call kernel {ms:.5f}, plain {plain_ms:.5f}; "
            f"call ms kernel {call_ms:.5f}, plain {plain_call_ms:.5f}")
        if acap == 256:   # the main path's arena (make_config, 32 Mbp)
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    kernels.reset_launches()
    return row


def check_occ(fm, dev) -> dict:
    """K2 against its twins over `fm`'s table at random and edge bounds,
    at the step's shape (B lanes) and the width pass's (2 x 2048)."""
    import numpy as np
    import torch
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.fm import device as fd
    rng = np.random.default_rng(SEED)
    n = fm.seq_len
    prim = fm.primary.tolist()
    edges = [0, 1, 2, 63, 64, 65, n - 1, n, prim[0], prim[0] + 1,
             prim[1], prim[1] + 1]
    rows = {}
    for m in (B_LANES, 4096):
        k = rng.integers(0, n + 1, m)
        k[:len(edges)] = edges
        l = rng.integers(0, n + 1, m)
        l[-len(edges):] = edges
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        strand, kq, lq = t(rng.integers(0, 2, m)), t(k), t(l)
        c = t(rng.integers(0, 4, m))
        for name, kern, plain in (
                ("occ4_pair", lambda: fd.occ4_pair(fm, strand, kq, lq),
                 lambda: fd.occ4_pair_plain(fm, strand, kq, lq)),
                ("occ1_pair", lambda: fd.occ1_pair(fm, strand, kq, lq, c),
                 lambda: fd.occ1_pair_plain(fm, strand, kq, lq, c))):
            err = max_abs_err([kern()], [plain()])
            if err:
                raise AssertionError(f"{name} m={m}: kernel != twin "
                                     f"(max abs err {err})")
            ms, call_ms = timed_ms(kern, 200)
            plain_ms, plain_call_ms = timed_ms(plain, 50)
            log(f"K2 {name} m={m} intv={fm.intv}: bitwise equal; "
                f"device ms/call kernel {ms:.5f}, plain {plain_ms:.5f}; "
                f"call ms kernel {call_ms:.5f}, plain {plain_call_ms:.5f}")
            if m == B_LANES:
                rows[name] = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms}
    kernels.reset_launches()
    return rows


def make_inputs() -> tuple[pathlib.Path, pathlib.Path]:
    """Genome (bench.py's recipe, 32 Mbp), its index, and the reads, all
    from SEED; cached under .bench/smoke/."""
    import bench
    from ibwa_tpu.index.builder import bwa_index
    WORK.mkdir(parents=True, exist_ok=True)
    fa = WORK / f"genome_{SEED}.fa"
    fq = WORK / f"reads_{SEED}_{N_READS}.fq"
    if pathlib.Path(str(fa) + ".bwt").exists() and fq.exists():
        return fa, fq
    t0 = time.perf_counter()
    rng = random.Random(SEED)
    seq = bench.make_genome(rng)
    with open(fa, "w") as f:
        f.write(">smoke_chr\n")
        for i in range(0, len(seq), 70):
            f.write(seq[i:i + 70] + "\n")
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    with open(fq, "w") as f:
        for i in range(N_READS):
            pos = rng.randrange(0, len(seq) - READ_LEN)
            s = list(seq[pos:pos + READ_LEN])
            for j in range(len(s)):
                if rng.random() < 0.01:
                    s[j] = rng.choice("ACGT")
            if rng.random() < 0.5:
                s = [comp[ch] for ch in reversed(s)]
            f.write(f"@r{i}\n{''.join(s)}\n+\n{'I' * READ_LEN}\n")
    log(f"genome {len(seq)} bp + {N_READS} reads made in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bwa_index(str(fa))
    log(f"indexed in {time.perf_counter() - t0:.1f} s")
    return fa, fq


def run_aln(args: list[str], out: pathlib.Path) -> dict:
    """`ibwa_tpu_torch aln ... -f out` in-process; returns its stats line
    plus the wall seconds of the whole command."""
    from ibwa_tpu_torch import cli
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["aln", *args, "-f", str(out)])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"aln {args} exited {rc}:\n{err.getvalue()}")
    lines = [ln for ln in err.getvalue().splitlines()
             if ln.startswith("[aln] stats ")]
    if not lines:
        raise AssertionError(f"aln printed no stats:\n{err.getvalue()}")
    stats = json.loads(lines[-1][len("[aln] stats "):])
    stats["wall_s"] = wall
    return stats


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: this check runs on the card only",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    log(f"device {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build
    from ibwa_tpu_torch import kernels
    kernels.lib()
    info = kernels.build_info
    log(f"kernels built in {info['seconds']:.1f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. kernel vs twin (K2 needs the main path's table)
    fa, fq = make_inputs()
    from ibwa_tpu.fm.fmindex import FmIndex
    from ibwa_tpu.index.builder import load_index
    from ibwa_tpu_torch.fm.device import build_device_pair
    fms = (FmIndex(load_index(str(fa), 0)), FmIndex(load_index(str(fa), 1)))
    fm = build_device_pair(fms[0], fms[1], dev)
    rows = {"stack_update": check_stack(dev), **check_occ(fm, dev)}
    del fm, fms

    # ---- 4. main path
    from ibwa_tpu.io import sai
    sais = {name: WORK / f"{name}.sai"
            for name in ("native", "device_only", "hybrid")}
    base = [str(fa), str(fq)]
    res = {"native": run_aln(base + ["--engine", "native"], sais["native"])}
    os.environ["IBWA_HOST_FRAC"] = "0"
    kernels.reset_launches()
    res["device_only"] = run_aln(base + ["--device", "cuda"],
                                 sais["device_only"])
    launches = dict(kernels.launches)
    del os.environ["IBWA_HOST_FRAC"]
    kernels.reset_launches()
    res["hybrid"] = run_aln(base + ["--device", "cuda"], sais["hybrid"])
    hybrid_launches = dict(kernels.launches)
    want = sais["native"].read_bytes()
    for name in ("device_only", "hybrid"):
        if sais[name].read_bytes() != want:
            raise AssertionError(f"{name} .sai differs from --engine native")
    for name in rows:
        if launches.get(name, 0) <= 0 or hybrid_launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} never launched on the main "
                                 f"path ({launches}, {hybrid_launches})")
    n_hit = sum(1 for hits in sai.iter_sai(str(sais["native"])) if hits)
    if not N_READS * 0.9 <= n_hit <= N_READS:
        raise AssertionError(f"only {n_hit}/{N_READS} reads have hits")
    for name, r in res.items():
        dev_reads = r.get("device_reads", 0)
        log(f"aln {name}: {r['reads'] / r['search_s']:.1f} reads/s search "
            f"({r['search_s']:.3f} s), {r['reads'] / r['wall_s']:.1f} "
            f"reads/s end to end ({r['wall_s']:.3f} s); device reads "
            f"{dev_reads}, overflow fallback {r.get('fallback_reads', 0)} "
            f"({r.get('fallback_reads', 0) / max(dev_reads + r.get('fallback_reads', 0), 1):.4f}), "
            f"host share {r.get('host_reads', 0)}, steps "
            f"{r.get('iterations', 0)}")
    log(f".sai byte-identical to --engine native (device-only, hybrid); "
        f"{n_hit}/{N_READS} reads with hits; launches {launches}")

    # ---- 5. result lines
    src = {"stack_update": ("ibwa_tpu_torch/csrc/stack_update.cu",
                            "ibwa_tpu/align/stack_kernel.py:115"),
           "occ4_pair": ("ibwa_tpu_torch/csrc/occ.cu",
                         "ibwa_tpu/fm/device.py:334"),
           "occ1_pair": ("ibwa_tpu_torch/csrc/occ.cu",
                         "ibwa_tpu/fm/device.py:430")}
    table = [{"name": name, "route": "cuda", "source": src[name][0],
              "replaces": src[name][1], "launches": launches[name], **r}
             for name, r in rows.items()]
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
