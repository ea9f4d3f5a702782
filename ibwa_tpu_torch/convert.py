"""Carry state between `ibwa_tpu` (JAX) and this port, as numpy arrays.

* `fm_from_numpy` turns the fields of
  `ibwa_tpu.fm.device.build_device_pair(fwd, rev, put=np.asarray,
  dimer=False, intv=...)` into this port's `DeviceFmPair` on a device.
* `state_from_jax_tuple` / `state_to_tuple` map the 30-field JAX search
  state (engine_jax.py:252-257) to and from `SearchState`.
* `fmindex_from_jax` reads the arrays of an `ibwa_tpu.fm.fmindex.FmIndex`
  into the port's `FmIndex`.
* `walker_from_numpy` puts the JAX `DeviceWalker`'s table and its sampled
  arrays into the port's `DeviceWalker`.

This module imports only numpy and torch; the tests bring JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .align.engine import FIELDS, SearchState
from .fm.device import DeviceFmPair
from .fm.fmindex import FmIndex
from .fm.walk import DeviceWalker
from .index.formats import BwtIndex

# JAX dtype of each state field; the rest are int32
_U32 = {"sk", "sl", "sm1", "sm2", "w", "meta", "hk", "hl", "hm",
        "pk", "pl", "pm1", "pm2"}
_BOOL = {"has_seed", "done", "fb"}
_PLANES = {"sk", "sl", "sm1", "sm2", "key"}   # int32 tensors in the port


def fm_from_numpy(jfm, device="cpu") -> DeviceFmPair:
    """JAX-side DeviceFmPair with numpy fields -> the port's."""
    blocks = np.ascontiguousarray(np.asarray(jfm.blocks, dtype=np.uint32))
    as64 = lambda a: torch.from_numpy(
        np.asarray(a).astype(np.int64)).to(device)
    return DeviceFmPair(
        blocks=torch.from_numpy(blocks.view(np.int32)).to(device),
        L2=as64(jfm.L2), l2diff=as64(jfm.l2diff), primary=as64(jfm.primary),
        seq_len=int(jfm.seq_len), n_blk=int(jfm.n_blk), intv=int(jfm.intv))


def fmindex_from_jax(idx) -> FmIndex:
    """An `ibwa_tpu.fm.fmindex.FmIndex` (read by attribute) -> the port's
    `FmIndex` over the same arrays."""
    return FmIndex(BwtIndex(
        primary=int(idx.primary), L2=np.asarray(idx.L2).astype(np.uint32),
        seq_len=int(idx.seq_len),
        interleaved=np.asarray(idx._interleaved, dtype=np.uint32),
        sa_intv=int(idx.sa_intv),
        sa=None if idx.sa is None else np.asarray(idx.sa, dtype=np.uint32)))


def walker_from_numpy(jfm, sampled, sa_intv: int, device="cpu"
                      ) -> DeviceWalker:
    """The JAX `DeviceWalker`'s table (`jfm`, numpy fields, through
    `fm_from_numpy`) and its (fwd, rev) sampled arrays -> the port's."""
    return DeviceWalker.from_table(fm_from_numpy(jfm, device), sampled,
                                   sa_intv)


def state_from_jax_tuple(st, device="cpu") -> SearchState:
    """30-tuple of arrays (numpy or JAX) -> SearchState on `device`."""
    if len(st) != len(FIELDS):
        raise ValueError(f"expected {len(FIELDS)} fields, got {len(st)}")
    out = {}
    for name, a in zip(FIELDS, st):
        a = np.asarray(a)
        if name in _PLANES:
            a = np.ascontiguousarray(a).view(np.int32)
        elif name not in _BOOL:
            a = a.astype(np.int64)
        out[name] = torch.from_numpy(np.array(a)).to(device)
    return SearchState(**out)


def state_to_tuple(state: SearchState) -> tuple:
    """SearchState -> 30-tuple of numpy arrays with the JAX dtypes."""
    out = []
    for name in FIELDS:
        a = getattr(state, name).cpu().numpy()
        if name in _BOOL:
            a = a.astype(bool)
        elif name in _U32:
            a = (a.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
        else:
            a = a.astype(np.int32)
        out.append(a)
    return tuple(out)
