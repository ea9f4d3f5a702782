"""Exact re-implementation of the POSIX rand48 generator family.

The reference pipeline's output depends on the drand48/lrand48 stream in
three places (cf. reference bntseq.c:180-231 N-filling,
bwase.c:29-104 primary-hit selection, bwape.c:299-369 remap retry), so SAM
parity requires generating the identical stream.  rand48 is a 48-bit LCG:

    X_{n+1} = (a * X_n + c) mod 2**48,  a = 0x5DEECE66D, c = 0xB

* ``srand48(seed)`` sets X = (seed << 16) | 0x330E
* ``drand48()`` advances and returns X / 2**48 as a double
* ``lrand48()`` advances and returns X >> 17 (31-bit non-negative int)

Python ints are exact, so the scalar class below is bit-identical to libc.
Bulk streams are produced by the native C++ helper when available (see
the package's `native` module), with a NumPy fallback here.

Copy of `ibwa_tpu/rng.py`: the port keeps its own host code and imports
nothing of `ibwa_tpu`.
"""

from __future__ import annotations

import numpy as np

_A = 0x5DEECE66D
_C = 0xB
_MASK = (1 << 48) - 1


class Rand48:
    """Scalar drop-in for srand48/drand48/lrand48 with exact libc semantics."""

    __slots__ = ("x",)

    def __init__(self, seed: int = 0):
        self.srand48(seed)

    def srand48(self, seed: int) -> None:
        self.x = (((seed & 0xFFFFFFFF) << 16) | 0x330E) & _MASK

    def _step(self) -> int:
        self.x = (_A * self.x + _C) & _MASK
        return self.x

    def drand48(self) -> float:
        return self._step() / float(1 << 48)

    def lrand48(self) -> int:
        return self._step() >> 17

    def lrand48_array(self, n: int) -> np.ndarray:
        """n successive lrand48() draws as uint32 (vectorized LCG jump)."""
        return _stream(self.x, n, self)[0] >> np.uint64(17)

    def drand48_array(self, n: int) -> np.ndarray:
        xs, _ = _stream(self.x, n, self)
        return xs.astype(np.float64) / float(1 << 48)


def _stream(x0: int, n: int, rng: Rand48 | None = None):
    """Vector of the next n states after x0 (and advance rng if given).

    Doubling construction: if xs holds states x_1..x_m, then the next m
    states are A_m * xs + C_m (mod 2**48) where (A_m, C_m) is the m-step
    jump. 48-bit modular multiply is done in 24-bit limbs to stay inside
    uint64.
    """
    if n == 0:
        return np.empty(0, dtype=np.uint64), x0
    xs = np.empty(n, dtype=np.uint64)
    x1 = (_A * x0 + _C) & _MASK
    xs[0] = x1
    m = 1
    jump_a, jump_c = _A, _C  # 1-step jump
    while m < n:
        take = min(m, n - m)
        seg = _mulmod48(np.uint64(jump_a), xs[:take])
        seg = (seg + np.uint64(jump_c)) & np.uint64(_MASK)
        xs[m : m + take] = seg
        # square the jump: (a,c) -> (a*a, a*c + c)
        jump_c = (jump_a * jump_c + jump_c) & _MASK
        jump_a = (jump_a * jump_a) & _MASK
        m += take
    if rng is not None:
        rng.x = int(xs[-1])
    return xs, int(xs[-1])


def _mulmod48(a: np.uint64, xs: np.ndarray) -> np.ndarray:
    """(a * xs) mod 2**48 elementwise without uint64 overflow."""
    a = int(a)
    a_lo = np.uint64(a & 0xFFFFFF)
    a_hi = np.uint64((a >> 24) & 0xFFFFFF)
    x_lo = xs & np.uint64(0xFFFFFF)
    x_hi = xs >> np.uint64(24)
    lo = a_lo * x_lo  # ≤ 48 bits
    mid = (a_lo * x_hi + a_hi * x_lo) & np.uint64(0xFFFFFF)  # keep 24 bits
    return (lo + (mid << np.uint64(24))) & np.uint64(_MASK)
