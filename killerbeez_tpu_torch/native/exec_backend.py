"""ctypes bindings for libkbexec — the C++ host exec backend.

``ExecTarget`` wraps one target process configuration: plain
fork+execve or forkserver (fds 198/199 protocol), optional SysV-SHM
coverage bitmap, persistence, deferred startup and LD_PRELOAD.

Status codes from the C layer (kb_exec.cpp):
    0..255   exit code          512+sig  killed by signal
    -1       hang (timeout)     -2       backend error
``classify()`` maps them to the framework's FUZZ_* verdicts.
"""

from __future__ import annotations

import ctypes as ct
import os
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import FUZZ_CRASH, FUZZ_ERROR, FUZZ_HANG, FUZZ_NONE
from .build import exec_lib_path, preload_path

KB_MAP_SIZE = 1 << 16
# per-module partitioning (KB_MODULES=1): mirrors kb_protocol.h
KB_N_MODULES = 8
KB_MOD_SIZE = KB_MAP_SIZE // KB_N_MODULES
KB_MODTAB_NAME = 64


class CrashInfo(ct.Structure):
    """Mirror of kb_crash_info (kb_exec.cpp debugger mode)."""
    _fields_ = [("signal_no", ct.c_int32),
                ("si_code", ct.c_int32),
                ("fault_addr", ct.c_uint64),
                ("pc", ct.c_uint64)]


_lib = None


def _load() -> ct.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ct.CDLL(exec_lib_path())
    lib.kb_target_create.restype = ct.c_void_p
    lib.kb_target_create.argtypes = [
        ct.POINTER(ct.c_char_p), ct.c_int, ct.c_char_p, ct.c_int,
        ct.c_char_p, ct.c_int, ct.c_int, ct.c_long, ct.c_int]
    lib.kb_target_start.restype = ct.c_int
    lib.kb_target_start.argtypes = [ct.c_void_p, ct.c_double]
    lib.kb_target_run.restype = ct.c_int
    lib.kb_target_run.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_int32,
                                  ct.c_double]
    lib.kb_target_run_batch.restype = ct.c_int
    lib.kb_target_run_batch.argtypes = [
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int, ct.c_int,
        ct.c_double, ct.c_void_p, ct.c_void_p]
    lib.kb_target_launch.restype = ct.c_int
    lib.kb_target_launch.argtypes = [ct.c_void_p, ct.c_double]
    lib.kb_target_alive.restype = ct.c_int
    lib.kb_target_alive.argtypes = [ct.c_void_p]
    lib.kb_target_wait_done.restype = ct.c_int
    lib.kb_target_wait_done.argtypes = [ct.c_void_p, ct.c_double]
    lib.kb_target_fork.restype = ct.c_int
    lib.kb_target_fork.argtypes = [ct.c_void_p, ct.c_double]
    lib.kb_target_resume.restype = ct.c_int
    lib.kb_target_resume.argtypes = [ct.c_void_p, ct.c_double]
    lib.kb_target_run_debug.restype = ct.c_int
    lib.kb_target_run_debug.argtypes = [
        ct.c_void_p, ct.c_char_p, ct.c_int32, ct.c_double,
        ct.POINTER(CrashInfo)]
    lib.kb_target_trace_bits.restype = ct.POINTER(ct.c_uint8)
    lib.kb_target_trace_bits.argtypes = [ct.c_void_p]
    lib.kb_target_module_table.restype = ct.c_void_p
    lib.kb_target_module_table.argtypes = [ct.c_void_p]
    lib.kb_target_add_env.argtypes = [ct.c_void_p, ct.c_char_p]
    lib.kb_target_clear_trace.argtypes = [ct.c_void_p]
    lib.kb_target_pid.restype = ct.c_int
    lib.kb_target_pid.argtypes = [ct.c_void_p]
    lib.kb_target_total_execs.restype = ct.c_long
    lib.kb_target_total_execs.argtypes = [ct.c_void_p]
    lib.kb_target_stop.argtypes = [ct.c_void_p]
    lib.kb_target_free.argtypes = [ct.c_void_p]
    lib.kb_last_error.restype = ct.c_char_p
    _lib = lib
    return lib


def classify(status: int) -> Tuple[int, int]:
    """(FUZZ_* verdict, exit_code) from a backend status code."""
    if status == -1:
        return FUZZ_HANG, -1
    if status == -2:
        return FUZZ_ERROR, -2
    if status >= 512:
        return FUZZ_CRASH, status - 512
    return FUZZ_NONE, status


def pool_token_matches(arg: str, input_file: str) -> bool:
    """True when ``arg`` carries ``input_file`` in a form ExecPool can
    re-point per worker: the whole token, or a --flag=<path> value."""
    return arg == input_file or arg.endswith("=" + input_file)


def classify_batch(statuses_raw: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized classify() over a raw status array: (verdicts,
    exit_codes).  The single definition of the status encoding for
    batched host tiers (afl, host ipt) — ``<= -2`` covers both the
    error sentinel and result-padding lanes (-3)."""
    verdicts = np.full(len(statuses_raw), FUZZ_NONE, dtype=np.int32)
    verdicts[statuses_raw >= 512] = FUZZ_CRASH
    verdicts[statuses_raw == -1] = FUZZ_HANG
    verdicts[statuses_raw <= -2] = FUZZ_ERROR
    exit_codes = np.where(statuses_raw >= 512, statuses_raw - 512,
                          np.maximum(statuses_raw, 0)).astype(np.int32)
    return verdicts, exit_codes


def replay_message_train(target: "ExecTarget",
                         messages: Sequence[bytes],
                         mode: str = "stdin_train",
                         addr: Optional[Tuple[str, int]] = None,
                         timeout: Optional[float] = None,
                         connect_timeout: float = 5.0) -> int:
    """Replay a translated message train (hybrid bridge,
    docs/HYBRID.md) on a native target; returns a raw status code.

    ``stdin_train`` concatenates the messages onto the target's
    stdin — the child reads them sequentially off the pipe, which is
    the reference's stdin replay of a session.  ``tcp`` is the
    network_client / send_tcp_input pattern: launch() the server,
    connect, send each message as one write, half-close, then
    wait_done() for the verdict.  Connection failure returns the
    error sentinel (-2), never an exception — the validator's
    retry/backoff owns transient transport faults.
    """
    if mode in ("stdin", "stdin_train", "file"):
        return target.run(b"".join(messages), timeout)
    if mode != "tcp":
        raise ValueError(f"unknown replay mode {mode!r}")
    if not addr:
        raise ValueError("tcp replay needs addr=(host, port)")
    import socket

    target.launch()
    sock = None
    deadline = time.monotonic() + connect_timeout
    while time.monotonic() < deadline:
        try:
            sock = socket.create_connection(addr, timeout=1.0)
            break
        except OSError:
            if not target.alive():
                break
            time.sleep(0.05)
    if sock is None:
        target.wait_done(0.01)      # reap the launched child
        return -2
    try:
        with sock:
            for m in messages:
                sock.sendall(bytes(m))
            try:
                sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            # drain any reply so the server isn't blocked on write
            sock.settimeout(0.25)
            try:
                while sock.recv(4096):
                    pass
            except OSError:
                pass
    except OSError:
        pass                        # verdict comes from wait_done
    return target.wait_done(timeout)


class ExecTarget:
    """One configured target; reusable across many executions."""

    def __init__(self, argv: Sequence[str], *,
                 use_stdin: bool = False,
                 input_file: Optional[str] = None,
                 use_forkserver: bool = False,
                 preload: Optional[str] = None,
                 use_preload_forkserver: bool = False,
                 persistent: int = 0,
                 deferred: bool = False,
                 mem_limit_mb: int = 0,
                 coverage: bool = False,
                 timeout: float = 2.0,
                 extra_env: Optional[Sequence[str]] = None):
        self._lib = _load()
        self.timeout = float(timeout)
        self._owns_input_file = input_file is None and use_stdin
        if self._owns_input_file:
            fd, input_file = tempfile.mkstemp(prefix="kb_input_")
            os.close(fd)
        self.input_file = input_file
        if use_preload_forkserver and not preload:
            preload = preload_path()

        c_argv = (ct.c_char_p * (len(argv) + 1))()
        for i, a in enumerate(argv):
            c_argv[i] = a.encode()
        c_argv[len(argv)] = None
        self._h = self._lib.kb_target_create(
            c_argv, int(use_stdin),
            input_file.encode() if input_file else None,
            int(use_forkserver),
            preload.encode() if preload else None,
            int(persistent), int(deferred), int(mem_limit_mb),
            int(coverage))
        if not self._h:
            raise RuntimeError(
                f"kb_target_create: {self._lib.kb_last_error().decode()}")
        for kv in (extra_env or ()):
            # per-target child env (e.g. KB_MODULES=1) — never the
            # fuzzer's own process-global environment
            self._lib.kb_target_add_env(self._h, kv.encode())
        self.coverage = coverage
        self.use_forkserver = use_forkserver
        self._started = False

    def start(self, timeout: float = 10.0) -> None:
        if self._lib.kb_target_start(self._h, timeout) != 0:
            raise RuntimeError(
                f"kb_target_start: {self._lib.kb_last_error().decode()}")
        self._started = True

    def _ensure_started(self) -> None:
        if not self._started:
            self.start()

    def run(self, data: bytes, timeout: Optional[float] = None) -> int:
        """Execute one input; returns the raw backend status code."""
        self._ensure_started()
        return self._lib.kb_target_run(
            self._h, data, len(data),
            self.timeout if timeout is None else timeout)

    def run_batch(self, inputs: np.ndarray, lengths: np.ndarray,
                  want_bitmaps: bool = True,
                  timeout: Optional[float] = None
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Execute a [B, L] uint8 batch. Returns (statuses int32[B],
        bitmaps uint8[B, 64K] or None). One ctypes call for the whole
        batch — the C layer loops, clearing + copying the SHM bitmap
        per exec."""
        self._ensure_started()
        inputs = np.ascontiguousarray(inputs, dtype=np.uint8)
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        n, stride = inputs.shape
        statuses = np.empty(n, dtype=np.int32)
        bitmaps = (np.empty((n, KB_MAP_SIZE), dtype=np.uint8)
                   if (want_bitmaps and self.coverage) else None)
        done = self._lib.kb_target_run_batch(
            self._h, inputs.ctypes.data_as(ct.c_void_p),
            lengths.ctypes.data_as(ct.c_void_p), n, stride,
            self.timeout if timeout is None else timeout,
            statuses.ctypes.data_as(ct.c_void_p),
            bitmaps.ctypes.data_as(ct.c_void_p)
            if bitmaps is not None else None)
        if done < n:
            statuses[done:] = -2
            if bitmaps is not None:
                # never triage uninitialized rows: zero = no coverage
                bitmaps[done:] = 0
        return statuses, bitmaps

    def run_debug(self, data: bytes, timeout: Optional[float] = None
                  ) -> Tuple[int, dict]:
        """Execute one input under ptrace (debugger mode, no
        forkserver); returns (status, crash_info dict). crash_info
        carries signal/si_code/fault_addr/pc when the run faulted."""
        self._ensure_started()
        info = CrashInfo()
        st = self._lib.kb_target_run_debug(
            self._h, data, len(data),
            self.timeout if timeout is None else timeout,
            ct.byref(info))
        return st, {"signal": int(info.signal_no),
                    "si_code": int(info.si_code),
                    "fault_addr": int(info.fault_addr),
                    "pc": int(info.pc)}

    def launch(self, timeout: float = 10.0) -> int:
        """Start one exec WITHOUT waiting (network-driver pattern:
        start the server, talk to it, then wait_done). Returns pid."""
        self._ensure_started()
        pid = self._lib.kb_target_launch(self._h, timeout)
        if pid <= 0:
            raise RuntimeError(
                f"kb_target_launch: {self._lib.kb_last_error().decode()}")
        return pid

    def alive(self) -> bool:
        return bool(self._lib.kb_target_alive(self._h))

    def wait_done(self, timeout: Optional[float] = None) -> int:
        """Collect the verdict of a launch()ed exec; kills on timeout
        (hang). Returns a raw backend status code."""
        return self._lib.kb_target_wait_done(
            self._h, self.timeout if timeout is None else timeout)

    def fork_stopped(self, timeout: float = 10.0) -> int:
        """FORK command: spawn a child left SIGSTOPped (tracer attach
        window). Returns the child pid."""
        self._ensure_started()
        pid = self._lib.kb_target_fork(self._h, timeout)
        if pid <= 0:
            raise RuntimeError(
                f"kb_target_fork: {self._lib.kb_last_error().decode()}")
        return pid

    def resume(self, timeout: Optional[float] = None) -> int:
        """RUN + GET_STATUS on a forked child; returns a status code."""
        return self._lib.kb_target_resume(
            self._h, self.timeout if timeout is None else timeout)

    def trace_bits(self) -> Optional[np.ndarray]:
        """Zero-copy view of the live SHM coverage bitmap."""
        if not self.coverage:
            return None
        ptr = self._lib.kb_target_trace_bits(self._h)
        return np.ctypeslib.as_array(ptr, shape=(KB_MAP_SIZE,))

    def clear_trace(self) -> None:
        self._lib.kb_target_clear_trace(self._h)

    def module_table(self) -> List[str]:
        """Names of the modules that claimed map partitions (targets
        run with KB_MODULES=1); index = submap number.  Warns once if
        an entry's degraded-accounting flag (byte KB_MODTAB_NAME-1,
        set by kb_rt on table overflow or truncated-name merge) shows
        that its partition aliases multiple modules."""
        ptr = self._lib.kb_target_module_table(self._h)
        if not ptr:
            return []
        out = []
        degraded = []
        for i in range(KB_N_MODULES):
            # bounded read: byte KB_MODTAB_NAME-1 is the flag, not
            # part of the (always-NUL-terminated-within-width) name
            name = ct.string_at(ptr + i * KB_MODTAB_NAME,
                                KB_MODTAB_NAME - 1).split(b"\x00")[0]
            if name:
                out.append(name.decode(errors="replace"))
                flag = ct.string_at(
                    ptr + i * KB_MODTAB_NAME + KB_MODTAB_NAME - 1, 1)
                # bit 0 = partition aliases multiple modules; bit 1
                # is kb_rt's "name truncated" bookkeeping, not by
                # itself a degradation
                if flag[0] & 1:
                    degraded.append(out[-1])
        if degraded and not getattr(self, "_modtab_warned", False):
            self._modtab_warned = True
            from ..utils.logging import WARNING_MSG
            WARNING_MSG(
                "per-module coverage degraded: partition(s) %s alias "
                "multiple modules (>%d kb-cc modules registered, or "
                "basenames truncated at %d chars collided)",
                degraded, KB_N_MODULES, KB_MODTAB_NAME - 1)
        return out

    def total_execs(self) -> int:
        return int(self._lib.kb_target_total_execs(self._h))

    def stop(self) -> None:
        if self._h:
            self._lib.kb_target_stop(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.kb_target_free(self._h)
            self._h = None
        if self._owns_input_file and self.input_file:
            try:
                os.unlink(self.input_file)
            except OSError:
                pass
            self.input_file = None

    def __enter__(self) -> "ExecTarget":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


class ExecPool:
    """N independent forkserver instances fed batch shards in parallel.

    The reference scales host throughput by running N fuzzer processes
    with distinct SHM names (dynamorio_instrumentation.c:418-431 picks
    a random fuzzer_id per instance); here one fuzzer process shards
    each batch across N ``ExecTarget`` instances — each with its own
    forkserver, IPC_PRIVATE SHM segment and private input file — on a
    thread pool.  ctypes releases the GIL for the duration of
    ``kb_target_run_batch``, so the C exec loops genuinely overlap.

    File-mode delivery (``input_file`` set): each worker derives a
    private ``<input_file>.wN`` path and gets the argv with the
    driver's ``@@`` substitution re-pointed at it, matching the
    reference's per-instance input files
    (dynamorio_instrumentation.c:418-431).  Stdin mode mints a temp
    file per worker as before.

    The single-exec surface (``run``/``trace_bits``/...) delegates to
    worker 0, so an ExecPool drops into ExecTarget call sites.
    """

    def __init__(self, argv: Sequence[str], n_workers: int, **kwargs):
        from concurrent.futures import ThreadPoolExecutor
        input_file = kwargs.pop("input_file", None)
        self._derived_files: list = []
        if input_file:
            if not any(pool_token_matches(a, input_file) for a in argv):
                raise ValueError(
                    "ExecPool file mode needs the input file as an "
                    f"argv token (or --flag={input_file!r} value); it "
                    "is absent or embedded mid-argument (callers "
                    "degrade such targets to a single instance)")
            self.targets = []
            root, ext = os.path.splitext(input_file)
            for i in range(max(n_workers, 1)):
                # suffix BEFORE the extension: format-sniffing targets
                # that validate the input path's extension keep seeing
                # it (in.png -> in.w0.png, not in.png.w0).  Only whole
                # tokens and --flag=<path> values are re-pointed — a
                # raw substring replace would corrupt companion
                # arguments like --dict=<input>.dict that nobody
                # stages per worker.
                f_i = f"{root}.w{i}{ext}"
                argv_i = [
                    f_i if a == input_file
                    else (a[:-len(input_file)] + f_i
                          if a.endswith("=" + input_file) else a)
                    for a in argv]
                self.targets.append(
                    ExecTarget(argv_i, input_file=f_i, **kwargs))
                self._derived_files.append(f_i)
        else:
            self.targets = [ExecTarget(argv, **kwargs)
                            for _ in range(max(n_workers, 1))]
        self._tp = ThreadPoolExecutor(max_workers=len(self.targets))
        self.coverage = self.targets[0].coverage
        self.timeout = self.targets[0].timeout

    @property
    def n_workers(self) -> int:
        return len(self.targets)

    def run_batch(self, inputs: np.ndarray, lengths: np.ndarray,
                  want_bitmaps: bool = True,
                  timeout: Optional[float] = None
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        n = inputs.shape[0]
        bounds = np.linspace(0, n, len(self.targets) + 1).astype(int)
        shards = [(self.targets[i], bounds[i], bounds[i + 1])
                  for i in range(len(self.targets))
                  if bounds[i + 1] > bounds[i]]
        futs = [self._tp.submit(t.run_batch, inputs[lo:hi],
                                lengths[lo:hi], want_bitmaps, timeout)
                for t, lo, hi in shards]
        stats, maps = [], []
        for f in futs:
            s, m = f.result()
            stats.append(s)
            maps.append(m)
        statuses = np.concatenate(stats) if stats else \
            np.empty(0, dtype=np.int32)
        bitmaps = (np.concatenate(maps)
                   if want_bitmaps and self.coverage and maps else None)
        return statuses, bitmaps

    # -- single-exec surface: worker 0 ---------------------------------

    def run(self, data: bytes, timeout: Optional[float] = None) -> int:
        return self.targets[0].run(data, timeout)

    def run_debug(self, data: bytes, timeout: Optional[float] = None):
        return self.targets[0].run_debug(data, timeout)

    def launch(self, timeout: float = 10.0) -> int:
        return self.targets[0].launch(timeout)

    def alive(self) -> bool:
        return self.targets[0].alive()

    def wait_done(self, timeout: Optional[float] = None) -> int:
        return self.targets[0].wait_done(timeout)

    def trace_bits(self) -> Optional[np.ndarray]:
        return self.targets[0].trace_bits()

    def clear_trace(self) -> None:
        self.targets[0].clear_trace()

    def module_table(self) -> List[str]:
        return self.targets[0].module_table()

    def total_execs(self) -> int:
        return sum(t.total_execs() for t in self.targets)

    def close(self) -> None:
        self._tp.shutdown(wait=True)
        for t in self.targets:
            t.close()
        for f in self._derived_files:
            try:
                os.unlink(f)
            except OSError:
                pass
        self._derived_files = []

    def __enter__(self) -> "ExecPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
