"""Numerical Recipes ran0/rang -- the reference's RNG, bit exact.

The reference initial-condition generator inirand draws every random
number from RAN0, the Park-Miller minimal-standard LCG with a 32-slot
Bays-Durham shuffle table, and RANG, a rejection-sampled Box-Muller
transform on top of it (reference src/utils/random.f90; seeding in
src/tools/initialize/rand/rand_local.f90:53 `seed = -abs(seed + rank)`).
Reproducing those streams exactly is what turns the broadband example
cases (Case01 etc.) digit-exact against dns.out.ref.

A batch C kernel (native/nrrand.c, built into tlab_tpu/_nrrand*.so by
native/build.py) provides the fast path; the pure-Python fallback is
identical arithmetic (all intermediates fit in float64/int64 exactly).
"""
from __future__ import annotations

import ctypes
import glob
import math
import os

import numpy as np

_IA, _IM, _IQ, _IR, _NTAB = 16807, 2147483647, 127773, 2836, 32
_NDIV = 1 + (_IM - 1) // _NTAB
_AM = 1.0 / _IM
_RNMX = 1.0 - 1.2e-7

_lib = None


def _load_native():
    global _lib
    if _lib is not None:
        return _lib or None
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cands = glob.glob(os.path.join(pkg, "_nrrand*.so"))
    if not cands:
        _lib = False
        return None
    try:
        lib = ctypes.CDLL(cands[0])
        lib.nr_fill_uniform.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
        lib.nr_fill_gaussian.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_double, ctypes.c_double]
        _lib = lib
    except OSError:
        _lib = False
    return _lib or None


def native_loaded() -> bool:
    """True when the C batch kernel (native/nrrand.c) is in use."""
    return _load_native() is not None


class NRStream:
    """Sequential RAN0/RANG stream with the reference's state semantics.

    `seed` is the raw IDUM as the reference passes it on first call
    (negative triggers (re)initialization of the shuffle table)."""

    def __init__(self, seed: int):
        self._state = np.zeros(34, dtype=np.int64)   # idum, iv[32], iy
        self._state[0] = int(seed)

    # -- pure-python reference implementation ---------------------------
    def _ran0_py(self) -> float:
        st = self._state
        idum = int(st[0])
        iy = int(st[33])
        if idum <= 0 or iy == 0:
            idum = max(-idum, 1)
            for j in range(_NTAB + 8, 0, -1):
                k = idum // _IQ
                idum = _IA * (idum - k * _IQ) - _IR * k
                if idum < 0:
                    idum += _IM
                if j <= _NTAB:
                    st[j] = idum
            iy = int(st[1])
        k = idum // _IQ
        idum = _IA * (idum - k * _IQ) - _IR * k
        if idum < 0:
            idum += _IM
        j = 1 + iy // _NDIV
        iy = int(st[j])
        st[j] = idum
        st[0] = idum
        st[33] = iy
        return min(_AM * iy, _RNMX)

    def _rang_py(self, mean: float, sigma: float) -> float:
        while True:
            v1 = 2.0 * self._ran0_py() - 1.0
            v2 = 2.0 * self._ran0_py() - 1.0
            r = v1 * v1 + v2 * v2
            if r < 1.0:
                break
        v2 = v1 * math.sqrt(-2.0 * math.log(r) / r)
        return mean + v2 * sigma

    # -- batch API -------------------------------------------------------
    def uniform(self, n: int) -> np.ndarray:
        """n consecutive RAN0 values in [0, 1)."""
        out = np.empty(n, dtype=np.float64)
        lib = _load_native()
        if lib is not None:
            lib.nr_fill_uniform(
                self._state.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ctypes.c_int64(n))
        else:
            for i in range(n):
                out[i] = self._ran0_py()
        return out

    def gaussian(self, n: int, mean: float = 0.0,
                 sigma: float = 1.0) -> np.ndarray:
        """n consecutive RANG deviates."""
        out = np.empty(n, dtype=np.float64)
        lib = _load_native()
        if lib is not None:
            lib.nr_fill_gaussian(
                self._state.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ctypes.c_int64(n), ctypes.c_double(mean),
                ctypes.c_double(sigma))
        else:
            for i in range(n):
                out[i] = self._rang_py(mean, sigma)
        return out
