"""Build and load the hand-written Hopper kernels (csrc/*.cu).

`nvcc` compiles every source under pathintegralgroundstate_torch/csrc once
per storage type (float32, float64, bfloat16: -DPIGS_STORAGE=0, 1, 2, each
compilation instantiating that type's entry points), one process per
source and type, all started together, and links the objects into one
shared library with a plain C interface, at first use, into
build/pigs_torch_kernels/<hash>/ beside the package (the hash covers the
sources and the flags, so an edited source rebuilds).  The library is bound
with ctypes.  Nothing comes from outside the checkout; a failed build
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "pigs_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libpigs_kernels.so"
STORAGE = ("f32", "f64", "bf16")   # -DPIGS_STORAGE=0, 1, 2 (pigs_pair.cuh)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels in pathintegralgroundstate_torch/csrc")


def sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build() -> tuple[Path, float, str]:
    """Compile the kernels if needed: (library path, seconds, compiler log)."""
    cu, cuh = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    log = out_dir / "nvcc.log"
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    units = [(f, t) for f in cu for t in range(len(STORAGE))]
    objs = [out_dir / f"{f.stem}.{STORAGE[t]}.{os.getpid()}.o"
            for f, t in units]
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, f"-DPIGS_STORAGE={t}",
                                   "-c", "-o", str(o), str(f)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for (f, t), o in zip(units, objs)]
        text = "".join(pr.communicate()[0] for pr in procs)
        if any(pr.returncode for pr in procs):
            raise RuntimeError(f"nvcc failed:\n{text}")
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        seconds = time.perf_counter() - t0
        text += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{text}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    log.write_text(text)
    os.replace(tmp, lib)
    return lib, seconds, text


def ptxas_summary(log: str) -> list:
    """One line per kernel of nvcc's -Xptxas -v log: its name with its
    template arguments (storage type, then its int and bool arguments:
    lanes, block size, mode, force, pair model, and last the dimension
    variant DP: 3 for dim <= 3, 0 for dim >= 4), registers and spills."""
    name, spill, out = "?", "", []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?((?:pair_rows|pair_pot|"
                      r"pair_delta|pair_u|cascade|bis_propose|bis_accept|"
                      r"pair_fold)"
                      r"_kernel)"
                      r"I(f|d|13__nv_bfloat16)((?:L[ib]\d+E)*)", line)
        if m:
            args = [{"f": "float", "d": "double"}.get(m.group(2), "bf16")] + [
                v if t == "i" else ("true" if v == "1" else "false")
                for t, v in re.findall(r"L([ib])(\d+)E", m.group(3))]
            name = f"{m.group(1)}<{', '.join(args)}>"
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_ROWS_ARGS = [_P] * 11
_POT_ARGS = [_P, _P, _P, _I, _P, _P, _P]
_DELTA_ARGS = [_P] * 6 + [_I] * 2 + [_P] * 5
_CASCADE_ARGS = [_P, _P, _P, _LL, _LL, _LL, _P, _P, _P, _LL, _LL, _P, _I, _I,
                 _I, _I, _I, _I, _I, _P]
_PROPOSE_ARGS = [_P] * 9
_ACCEPT_ARGS = [_P] * 10
_FOLD_ARGS = [_P] * 13
# csrc/bis_glue.cu and csrc/pair_fold.cu: no bfloat16 entries
GLUE_STORAGE = ("f32", "f64")


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, once per process)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for kernel, args, types in (
            ("pair_rows", _ROWS_ARGS, STORAGE),
            ("pair_pot", _POT_ARGS, STORAGE),
            ("pair_delta", _DELTA_ARGS, STORAGE),
            ("cascade", _CASCADE_ARGS, STORAGE),
            ("bis_propose", _PROPOSE_ARGS, GLUE_STORAGE),
            ("bis_accept", _ACCEPT_ARGS, GLUE_STORAGE),
            ("pair_fold", _FOLD_ARGS, GLUE_STORAGE)):
        for suffix in types:
            fn = getattr(lib, f"pigs_{kernel}_{suffix}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib
