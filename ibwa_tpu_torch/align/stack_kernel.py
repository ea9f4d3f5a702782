"""The fused per-read arena stack update of one search step (K1).

Port of `ibwa_tpu/align/stack_kernel.py`: one step's stack mutations —
freeing the popped slot, ranking the free slots, placing up to 10
children, and the next step's pop (first-minimum argmin of the key row +
that slot's entry words).  Slot CHOICE does not change the search (only
the priority key does), but the kernel and the twin pick the same slot as
the Pallas kernel, so the planes compare bitwise.

Tensors (one row per search lane, B rows):
  slot0 int64[B], act bool[B]: the slot popped this step, lane active;
  cv bool[B,10], ofs int64[B,10]: child valid, exclusive push rank;
  kv int64[B,10]: child priority key (an int32 value);
  ck, cl, cm1, cm2 int64[B,10]: child entry words (u32 values);
  key int32[B,ACAP] and sk, sl, sm1, sm2 int32[B,ACAP] (u32 bit patterns).
Returns (key, sk, sl, sm1, sm2, ovf bool[B], npush int64[B], pslot
int64[B], pkey int64[B], pk, pl, pm1, pm2 int64[B] u32 values).

`stack_update` runs the plain twin for CPU tensors and the CUDA kernel
(`csrc/stack_update.cu`, which updates the five planes in place) for
CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..u32 import from_bits, to_bits

INT32_MAX = 0x7FFFFFFF
NCH = 10


def stack_update_plain(slot0, act, cv, ofs, kv, ck, cl, cm1, cm2,
                       key, sk, sl, sm1, sm2):
    """Plain PyTorch twin: a port of `stack_update_xla` (functional: the
    input planes are not modified)."""
    B, acap = key.shape
    li = torch.arange(acap, device=key.device)[None, :]
    key = torch.where((li == slot0[:, None]) & act[:, None], INT32_MAX, key)
    free = key == INT32_MAX
    rank = torch.cumsum(free.to(torch.int64), dim=1)
    fits = ofs < rank[:, -1:]
    ovf = (cv & ~fits).any(dim=1)
    npush = (cv & fits).sum(dim=1)
    # child j goes to the free slot of inclusive rank ofs[j] + 1: the
    # first slot whose rank reaches it.  Where two placed children share
    # an offset the later one wins, as in the Pallas kernel's j loop; the
    # rest scatter to a spare column that is cut off again.
    place = cv & fits & (ofs >= 0)
    later = torch.triu(torch.ones(NCH, NCH, dtype=torch.bool,
                                  device=key.device), diagonal=1)
    shadowed = ((ofs[:, :, None] == ofs[:, None, :]) & place[:, None, :]
                & later).any(dim=2)
    tgt = torch.where(place & ~shadowed, torch.searchsorted(rank, ofs + 1),
                      acap)
    spare = torch.zeros(B, 1, dtype=torch.int32, device=key.device)
    key, sk, sl, sm1, sm2 = (
        torch.cat([p, spare], dim=1).scatter_(1, tgt, to_bits(v))[:, :acap]
        .contiguous()
        for p, v in ((key, kv), (sk, ck), (sl, cl), (sm1, cm1), (sm2, cm2)))
    pslot = torch.argmin(key, dim=1)        # documented: first minimum
    rows = torch.arange(B, device=key.device)
    pick = lambda p: from_bits(p[rows, pslot])
    return (key, sk, sl, sm1, sm2, ovf, npush, pslot,
            key[rows, pslot].to(torch.int64),
            pick(sk), pick(sl), pick(sm1), pick(sm2))


def stack_update(slot0, act, cv, ofs, kv, ck, cl, cm1, cm2,
                 key, sk, sl, sm1, sm2):
    """Apply one step's pop-free + pushes; see the module docstring.

    CPU tensors go to `stack_update_plain`.  CUDA tensors go to the
    kernel, which updates key/sk/sl/sm1/sm2 in place and returns them."""
    B, acap = key.shape
    dev = key.device
    _check(B, acap, dev, slot0, act, cv, ofs, kv, ck, cl, cm1, cm2,
           key, sk, sl, sm1, sm2)
    if dev.type == "cpu":
        return stack_update_plain(slot0, act, cv, ofs, kv, ck, cl, cm1, cm2,
                                  key, sk, sl, sm1, sm2)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if acap % 32:
        raise ValueError(f"stack_update: ACAP={acap} must be a multiple "
                         f"of 32 (one warp per lane row)")
    ins = [x.contiguous() for x in (slot0, act, cv, ofs, kv, ck, cl, cm1,
                                    cm2)]
    ovf = torch.empty(B, dtype=torch.bool, device=dev)
    outs = [torch.empty(B, dtype=torch.int64, device=dev) for _ in range(7)]
    npush, pslot, pkey, pk, pl, pm1, pm2 = outs
    rc = kernels.lib().ibwa_stack_update(
        *[x.data_ptr() for x in ins],
        *[x.data_ptr() for x in (key, sk, sl, sm1, sm2)],
        ovf.data_ptr(), *[x.data_ptr() for x in outs], B, acap,
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(rc, "stack_update")
    kernels.launches["stack_update"] += 1
    return (key, sk, sl, sm1, sm2, ovf, npush, pslot, pkey, pk, pl, pm1,
            pm2)


def random_case(rng, B: int, acap: int) -> dict:
    """A random stack_update input in the JAX kernel's dtypes (numpy), for
    checking the kernel and the twin against each other and against
    `ibwa_tpu`: arenas empty, sparse, half full, nearly full and full
    (overflow), keys with many ties, inactive lanes, and some rows whose
    child offsets repeat (the later child wins)."""
    free_frac = rng.choice([0.0, 0.02, 0.5, 0.98, 1.0], size=(B, 1))
    free = rng.random((B, acap)) < free_frac
    ties = (rng.integers(0, 6, (B, acap)) << 20) | \
        (0xFFFFF - rng.integers(0, 4, (B, acap)))
    key = np.where(free, INT32_MAX, ties).astype(np.int32)
    cv = rng.random((B, NCH)) < 0.6
    ofs = np.cumsum(cv, axis=1) - cv
    dup = rng.random(B) < 0.125
    ofs[dup] = rng.integers(-1, 12, (int(dup.sum()), NCH))
    kv = ((rng.integers(0, 6, (B, NCH)) << 20)
          | (0xFFFFF - rng.integers(0, 4, (B, NCH))))
    word = lambda *s: rng.integers(0, 1 << 32, s, dtype=np.uint64).astype(
        np.uint32)
    return dict(
        slot0=rng.integers(0, acap, B).astype(np.int32),
        act=rng.random(B) < 0.8, cv=cv, ofs=ofs.astype(np.int32),
        kv=kv.astype(np.int32), ck=word(B, NCH), cl=word(B, NCH),
        cm1=word(B, NCH), cm2=word(B, NCH), key=key,
        sk=word(B, acap), sl=word(B, acap), sm1=word(B, acap),
        sm2=word(B, acap))


def case_tensors(case: dict, device) -> list[torch.Tensor]:
    """random_case's arrays as stack_update's tensors, in argument order."""
    out = []
    for name in ("slot0", "act", "cv", "ofs", "kv", "ck", "cl", "cm1",
                 "cm2", "key", "sk", "sl", "sm1", "sm2"):
        a = case[name]
        if name in ("key", "sk", "sl", "sm1", "sm2"):
            a = a.view(np.int32)
        elif a.dtype != np.bool_:
            a = a.astype(np.int64)
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return out


def _check(B, acap, dev, slot0, act, cv, ofs, kv, ck, cl, cm1, cm2,
           key, sk, sl, sm1, sm2) -> None:
    spec = [(slot0, torch.int64, (B,)), (act, torch.bool, (B,)),
            (cv, torch.bool, (B, NCH))]
    spec += [(x, torch.int64, (B, NCH)) for x in (ofs, kv, ck, cl, cm1, cm2)]
    spec += [(x, torch.int32, (B, acap)) for x in (key, sk, sl, sm1, sm2)]
    for x, dt, shape in spec:
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(
                f"stack_update: expected {dt}{list(shape)} on {dev}, got "
                f"{x.dtype}{list(x.shape)} on {x.device}")
    for x in (key, sk, sl, sm1, sm2):
        if not x.is_contiguous():   # updated in place by the kernel
            raise ValueError("stack_update: planes must be contiguous")
