"""Build and load the CUDA kernels of ``csrc/`` at first use.

Each source is compiled by ``nvcc`` into a shared library with a plain
C interface and loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  The library lands in ``build/torch_kernels/`` at the
root of the checkout, named by a hash of the source and the flags, so
a changed source rebuilds and an unchanged one loads the library
already built.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_CFG = ctypes.POINTER(ctypes.c_int)
# argument types of each source's extern "C" functions
SIGNATURES = {
    "vm_kernel": {
        # fuzz, ni, instrs_shared, nb, table_mode, n_edges, L
        "kbz_state_rows": (_I, _I, _I, _I, _I, _I, _I),
        # instrs, ni, instrs_shared, table, nb, table_mode, state_shared,
        # ring, L, ring_lens, sel, base_key, its, stack_pow2, B, mem_size,
        # max_steps, n_edges, scratch, cols, status, exit_code, counts,
        # steps, hash, bufs, lens, stream, cfg
        "kbz_fuzz_launch": (_P, _I, _I, _P, _I, _I, _I, _P, _I, _P, _P,
                            _P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P,
                            _P, _P, _P, _P, _P, _P, _CFG),
        # instrs, ni, instrs_shared, table, nb, table_mode, state_shared,
        # inputs, L, lengths, lanes, n_lanes, n_threads, mem_size,
        # max_steps, n_edges, scratch, cols, status, exit_code, counts,
        # steps, hash, stream, cfg
        "kbz_vm_launch": (_P, _I, _I, _P, _I, _I, _I, _P, _I, _P, _P, _P,
                          _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                          _CFG),
    },
    "triage": {
        # counts, row, B, slots, edges, U, E, u_slots, vb, vc, vh,
        # map_bytes, crash, hang, keys, mins, cap, epoch, lane_slot,
        # lane_nov, acc, any, rets, uc, uh, vb', vc', vh', stream
        "kbz_triage_launch": (_P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P,
                              _I, _P, _P, _P, _P, _U, _U, _P, _P, _P, _P,
                              _P, _P, _P, _P, _P, _P, _P),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: seconds each library took to build (0.0 when it was already built)
build_seconds: Dict[str, float] = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    the toolkit's default install path."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def sources(name: str):
    """The files a build of ``csrc/<name>.cu`` reads: the source and
    every header of ``csrc/``."""
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    nvcc's report (ptxas registers and spills) is kept beside it as
    ``.log``.  Returns the library path."""
    out = library_path(name)
    if out.exists():
        build_seconds.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)            # atomic: concurrent builders agree
    build_seconds[name] = time.perf_counter() - t0
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use,
    with every function's argument types declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib
