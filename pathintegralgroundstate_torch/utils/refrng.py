"""Reference-compatible MT19937 stream (ctypes binding to native/mtref.c).

The torch port's copy of pathintegralgroundstate_tpu/utils/refrng.py: the
exact random sequence of the reference Fortran program (random_mod.f90),
its 69069 seeding, `grnd` tempered doubles and `rangauss` polar
Box-Muller.  The replay harness (utils/replay.py) drives the reference's
moves with it; `RefRNG` is also there for workflows that depend on the
reference's seeded streams.

The C source native/mtref.c is compiled with `cc` on first use into
build/mtref/<hash>/ beside the package (the hash covers the source, so an
edited source rebuilds); nothing is written into native/.  PyRefRNG is the
pure-Python transcription, bit-identical and slow.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "mtref.c"
_BUILD = _ROOT / "build" / "mtref"


def build() -> Path:
    """Compile native/mtref.c if needed; the shared library's path."""
    src = _SRC.read_bytes()
    out = _BUILD / hashlib.sha256(src).hexdigest()[:16] / "libmtref.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"libmtref.so.{os.getpid()}.tmp")
    cc = os.environ.get("CC", "cc")
    proc = subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", str(tmp),
                           str(_SRC), "-lm"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cc} failed on {_SRC}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.mtref_state_size.restype = ctypes.c_int
    lib.mtref_grnd.restype = ctypes.c_double
    lib.mtref_grnd.argtypes = [ctypes.c_void_p]
    lib.mtref_seed.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.mtref_grnd_array.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_long]
    lib.mtref_rangauss_array.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                         ctypes.c_double, ctypes.c_void_p,
                                         ctypes.c_long]
    lib.mtref_rangauss.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                   ctypes.c_double, ctypes.c_void_p,
                                   ctypes.c_void_p]
    return lib


class RefRNG:
    """The reference's RNG module (native backend)."""

    def __init__(self, seed: int = 1982):
        lib = _load()
        self._lib = lib
        self._st = ctypes.create_string_buffer(lib.mtref_state_size())
        lib.mtref_seed(self._st, ctypes.c_uint32(seed & 0xFFFFFFFF))

    def grnd(self) -> float:
        return self._lib.mtref_grnd(self._st)

    def uniform(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float64)
        self._lib.mtref_grnd_array(
            self._st, out.ctypes.data_as(ctypes.c_void_p), n)
        return out

    def rangauss(self, sigma: float = 1.0, mu: float = 0.0):
        x1 = ctypes.c_double()
        x2 = ctypes.c_double()
        self._lib.mtref_rangauss(self._st, sigma, mu,
                                 ctypes.byref(x1), ctypes.byref(x2))
        return x1.value, x2.value

    def gauss(self, n: int, sigma: float = 1.0, mu: float = 0.0) -> np.ndarray:
        """n draws of rangauss's x1 (the reference discards x2,
        vpi_mod.f90:515)."""
        out = np.empty(n, np.float64)
        self._lib.mtref_rangauss_array(
            self._st, sigma, mu, out.ctypes.data_as(ctypes.c_void_p), n)
        return out


class PyRefRNG:
    """Pure-Python transcription of random_mod.f90, bit-identical to
    RefRNG (slow)."""

    N, M = 624, 397
    MATA = 0x9908B0DF
    UMASK, LMASK = 0x80000000, 0x7FFFFFFF
    TB, TC = 0x9D2C5680, 0xEFC60000

    def __init__(self, seed: int = 1982):
        mt = [seed & 0xFFFFFFFF]
        for _ in range(1, self.N):
            mt.append((69069 * mt[-1]) & 0xFFFFFFFF)
        self.mt = mt
        self.mti = self.N

    def _gen(self):
        mt, N, M = self.mt, self.N, self.M
        for kk in range(N):
            y = (mt[kk] & self.UMASK) | (mt[(kk + 1) % N] & self.LMASK)
            mt[kk] = mt[(kk + M) % N] ^ (y >> 1) ^ (self.MATA if y & 1 else 0)
        self.mti = 0

    def grnd(self) -> float:
        if self.mti >= self.N:
            self._gen()
        y = self.mt[self.mti]
        self.mti += 1
        y ^= y >> 11
        y = (y ^ ((y << 7) & self.TB)) & 0xFFFFFFFF
        y = (y ^ ((y << 15) & self.TC)) & 0xFFFFFFFF
        y ^= y >> 18
        return y / 4294967295.0

    def rangauss(self, sigma=1.0, mu=0.0):
        while True:
            u1 = 2.0 * self.grnd() - 1.0
            u2 = 2.0 * self.grnd() - 1.0
            w = u1 * u1 + u2 * u2
            if w <= 1.0:
                break
        w = math.sqrt(-2.0 * math.log(w) / w)
        return mu + sigma * u1 * w, mu + sigma * u2 * w
