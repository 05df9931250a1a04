"""Build of the native host components at first use.

The C and C++ sources are the repository's own ``native/`` (the exec
backend, the target runtime, the preload forkserver, the kb-cc wrapper
and the kb-trace tracer) and ``corpus/`` (the fixture targets).  They
are built with ``make`` into ``build/torch_native/`` at the root of the
checkout (the corpus fixtures into ``build/torch_native/corpus/``),
never into the sources' own ``build/`` directories, and never at
import.  A process-level file lock (``fcntl.flock``) serializes the
builds of concurrent processes; make rebuilds only what is older than
its sources.  A failed build raises with make's output.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import subprocess
import threading
from typing import Iterable, Optional, Set

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
CORPUS_DIR = os.path.join(_REPO_ROOT, "corpus")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_native")
CORPUS_BUILD_DIR = os.path.join(BUILD_DIR, "corpus")

_lock = threading.Lock()
_native_built = False
_corpus_built: Set[str] = set()
# make's output of a failed build_native, kept by native_available
_build_error: Optional[str] = None


@contextlib.contextmanager
def _build_lock():
    """This process's build lock, then the file lock every process of
    the checkout shares."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)


def _make(args) -> None:
    proc = subprocess.run(["make", *args], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"native build failed (make {' '.join(args)}):\n"
            f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")


def build_native() -> None:
    """Build ``native/`` into ``build/torch_native/`` (once per
    process; make skips what is current)."""
    global _native_built
    if _native_built:
        return
    if not os.path.isdir(NATIVE_DIR):
        raise RuntimeError(f"native source dir missing: {NATIVE_DIR} — "
                           "the host-execution tier needs a checkout of "
                           "the repository")
    with _build_lock():
        if not _native_built:
            _make(["-C", NATIVE_DIR, f"BUILD={BUILD_DIR}"])
            _native_built = True


def native_available() -> bool:
    """True when ``build_native()`` succeeds.  A failure is kept, as in
    the JAX package: later calls answer False at once and
    ``build_error()`` gives the reason.  ``build_native`` itself still
    raises for its callers."""
    global _build_error
    if _build_error is not None:
        return False
    try:
        build_native()
    except RuntimeError as e:
        _build_error = str(e)
        return False
    return True


def build_error() -> Optional[str]:
    """Why the native build failed, or None when it succeeded."""
    native_available()
    return _build_error


def build_corpus(names: Iterable[str]) -> None:
    """Build the named ``corpus/`` fixtures (``test``, ``hang``, ...)
    into ``build/torch_native/corpus/`` with this build's kb-cc and
    runtime."""
    build_native()
    want = [n for n in names if n not in _corpus_built]
    if not want:
        return
    with _build_lock():
        # make exports command-line variables to its recipes, and kb-cc
        # reads KB_CC from its environment as the compiler to run: an
        # exported KB_CC would make kb-cc exec itself
        _make(["-C", CORPUS_DIR, "--eval", "unexport KB_CC KB_RT",
               f"KB_CC={kb_cc_path()}",
               f"KB_RT={rt_obj_path()}", f"BUILD={CORPUS_BUILD_DIR}",
               *(os.path.join(CORPUS_BUILD_DIR, n) for n in want)])
        _corpus_built.update(want)


def corpus_path(name: str) -> str:
    """Path of a corpus fixture built by ``build_corpus``, building it
    first."""
    build_corpus([name])
    return os.path.join(CORPUS_BUILD_DIR, name)


def _artifact(name: str) -> str:
    build_native()
    return os.path.join(BUILD_DIR, name)


def exec_lib_path() -> str:
    return _artifact("libkbexec.so")


def rt_obj_path() -> str:
    return _artifact("kb_rt.o")


def preload_path() -> str:
    return _artifact("libkbpreload.so")


def kb_cc_path() -> str:
    return _artifact("kb-cc")


def kb_trace_path() -> str:
    """The bundled binary-only tracer (the QEMU-mode tier's default
    emulator: forkserver + per-PC SHM coverage over ptrace)."""
    return _artifact("kb-trace")
