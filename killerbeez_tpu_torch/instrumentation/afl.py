"""afl — forkserver + SHM-bitmap instrumentation for real host
binaries (the reference's AFL-style path: reference
afl_instrumentation.c — SysV SHM 64KB map, three virgin maps
virgin_bits/tmout/crash, has_new_bits novelty, simplify_trace for
crash/hang dedup, forkserver options), over the native C++ exec
backend (``native/kb_exec.cpp``, bound in ``native/exec_backend.py``)
that collects one bitmap per exec.

Targets are built with the kb-cc wrapper (compiled-in runtime,
``native/kb_rt.c``) or run with the LD_PRELOAD forkserver; the wire
protocol is the reference's (fds 198/199, __AFL_SHM_ID).

A batch's bitmaps are triaged sequentially (lane i against the virgin
maps as lanes < i left them: the single-exec loop's verdicts) either
on the host with a numpy word-skip scan (``device_triage`` 0, the
default) or on the instrumentation's device with torch ops
(``device_triage`` 1: classify, simplify, then a prefix-OR scan over
lane chunks that carry the maps forward), bit for bit the same.

Options (reference afl_instrumentation.c:322-337 parity):
  use_fork_server, persistence_max_cnt, deferred_startup, qemu_mode,
  qemu_path, timeout, mem_limit, preload_forkserver, device_triage.
"""

from __future__ import annotations

import json
import os
import shlex
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import FUZZ_CRASH, FUZZ_ERROR, FUZZ_HANG, MAP_SIZE, resolve_device
from ..native.exec_backend import (
    KB_MOD_SIZE, ExecPool, ExecTarget, classify, classify_batch,
    pool_token_matches,
)
from ..ops.coverage import (
    COUNT_CLASS_LOOKUP, classify_counts, has_new_bits_scan, simplify_trace,
)
from ..utils.logging import WARNING_MSG
from ..utils.serialization import decode_array, encode_array
from .base import BatchResult, Instrumentation, module_slice_edges
from .factory import register_instrumentation

#: lanes the device triage scans at once: each chunk holds a few
#: uint8[TRIAGE_CHUNK, MAP_SIZE] temporaries (64 MB each at 1024)
TRIAGE_CHUNK = 1024


def triage_host_bitmaps(bitmaps: torch.Tensor, statuses: torch.Tensor,
                        vb: torch.Tensor, vc: torch.Tensor,
                        vh: torch.Tensor, chunk: int = TRIAGE_CHUNK):
    """Triage of host-collected raw bitmaps (uint8[B, MAP_SIZE]) on
    their device: classify and simplify each lane, then judge it
    against the three virgin maps as the lanes before it left them
    (every lane against ``vb``, crash lanes against ``vc``, hang lanes
    against ``vh``).  Lane chunks carry the maps forward, so the
    chunking changes no verdict.  B must be at least 1.  Returns
    (new_paths int32[B], unique_crashes, unique_hangs, vb', vc',
    vh')."""
    crash = statuses == FUZZ_CRASH
    hang = statuses == FUZZ_HANG
    every = torch.ones_like(crash)
    out = []
    for lo in range(0, bitmaps.shape[0], chunk):
        bm = bitmaps[lo:lo + chunk]
        rets, vb = has_new_bits_scan(vb, classify_counts(bm),
                                     every[lo:lo + chunk])
        simp = simplify_trace(bm)
        c, h = crash[lo:lo + chunk], hang[lo:lo + chunk]
        cret, vc = has_new_bits_scan(vc, simp, c)
        hret, vh = has_new_bits_scan(vh, simp, h)
        out.append((rets, c & (cret > 0), h & (hret > 0)))
    new_paths, uc, uh = (torch.cat(x) for x in zip(*out))
    return new_paths, uc, uh, vb, vc, vh


def _np_classify(trace: np.ndarray) -> np.ndarray:
    return COUNT_CLASS_LOOKUP[trace]


def _np_has_new_bits(virgin: np.ndarray, trace: np.ndarray
                     ) -> Tuple[int, np.ndarray]:
    inter = trace & virgin
    if not inter.any():
        return 0, virgin
    ret = 2 if bool(((trace != 0) & (virgin == 0xFF)).any()) else 1
    return ret, virgin & ~trace


@register_instrumentation
class AflInstrumentation(Instrumentation):
    """Forkserver + 64KB edge bitmap for kb-cc-built host targets."""
    name = "afl"
    supports_batch = True
    device_backed = False
    OPTION_SCHEMA = {
        "use_fork_server": int, "persistence_max_cnt": int,
        "deferred_startup": int, "qemu_mode": int, "qemu_path": str,
        "timeout": float, "mem_limit": int, "preload_forkserver": int,
        "device_triage": int, "ignore_bytes_file": str, "edges": int,
        "workers": int, "modules": int,
    }
    OPTION_DESCS = {
        "use_fork_server": "1 = fork per exec via the forkserver "
                           "(default), 0 = fork+execve per exec",
        "persistence_max_cnt": "N>0: persistent mode, N inputs per "
                               "process (SIGSTOP/SIGCONT loop)",
        "deferred_startup": "1 = target calls __kb_manual_init() "
                            "itself (skip the pre-main forkserver)",
        "qemu_mode": "1 = binary-only target: run it under the "
                     "coverage tracer given by qemu_path (default: "
                     "the bundled kb-trace ptrace tracer; any "
                     "__AFL_SHM_ID-honoring emulator works, such as "
                     "corpus/qemu_stub.c, built from the documented "
                     "wire contract alone)",
        "qemu_path": "emulator/tracer binary for qemu_mode (default "
                     "build/torch_native/kb-trace)",
        "timeout": "seconds before an exec counts as a hang "
                   "(default 2.0)",
        "mem_limit": "child address-space limit in MB (0 = none)",
        "preload_forkserver": "1 = LD_PRELOAD the forkserver into an "
                              "uninstrumented target",
        "device_triage": "1 = the batch's novelty scan runs on the "
                         "instrumentation's device (the CUDA card "
                         "unless --device cpu): the bitmaps go up, the "
                         "verdicts and maps come back; 0 = a numpy "
                         "word-skip scan on the host (the default); "
                         "both give the same verdicts",
        "ignore_bytes_file": "picker-produced JSON mask of "
                             "nondeterministic bitmap bytes to exclude "
                             "from novelty",
        "edges": "1 = keep the last exec's nonzero bitmap slots for "
                 "get_edges() (tracer mode)",
        "workers": "N>1: shard batches over N parallel forkserver "
                   "instances (the reference's multi-instance "
                   "scaling in one process)",
        "modules": "1 = per-module coverage: each kb-cc-built object "
                   "(main binary, shared libraries) claims its own map "
                   "partition + virgin state (reference per-module "
                   "maps, dynamorio_instrumentation.h:27-41)",
    }
    DEFAULTS = {"use_fork_server": 1, "persistence_max_cnt": 0,
                "deferred_startup": 0, "qemu_mode": 0, "timeout": 2.0,
                "mem_limit": 0, "preload_forkserver": 0,
                "device_triage": 0, "edges": 0, "workers": 1,
                "modules": 0}

    def __init__(self, options: Optional[str] = None, device="cuda"):
        super().__init__(options)
        self.device = resolve_device(device)
        if self.options["qemu_mode"]:
            qemu = self.options.get("qemu_path")
            if not qemu:
                # bundled default: the ptrace single-step tracer
                from ..native.build import kb_trace_path
                qemu = kb_trace_path()
                self.options["qemu_path"] = qemu
            if not os.path.exists(qemu):
                raise ValueError(
                    f"qemu_mode: tracer binary {qemu!r} not found "
                    "(qemu_path must point at an __AFL_SHM_ID-honoring "
                    "emulator; the bundled default is "
                    "build/torch_native/kb-trace)")
        self.virgin_bits = np.full(MAP_SIZE, 0xFF, dtype=np.uint8)
        self.virgin_crash = np.full(MAP_SIZE, 0xFF, dtype=np.uint8)
        self.virgin_tmout = np.full(MAP_SIZE, 0xFF, dtype=np.uint8)
        self.total_execs = 0
        self._target: Optional[ExecTarget] = None
        self._target_key: Optional[Tuple] = None
        self._last_unique_crash = False
        self._last_unique_hang = False
        self._last_trace: Optional[np.ndarray] = None
        self._ignore: Optional[np.ndarray] = None
        if self.options.get("ignore_bytes_file"):
            with open(self.options["ignore_bytes_file"]) as f:
                d = json.load(f)
            self._ignore = decode_array(d["ignore_bytes"]) != 0
            if self._ignore.shape != (MAP_SIZE,):
                raise ValueError("ignore_bytes mask must cover the "
                                 f"{MAP_SIZE}-byte map")

    def _mask_ignored(self, trace: np.ndarray) -> np.ndarray:
        """Zero out picker-flagged nondeterministic bytes before
        novelty (reference has_new_bits_with_ignore semantics,
        dynamorio_instrumentation.c:197)."""
        if self._ignore is None:
            return trace
        return np.where(self._ignore, 0, trace)

    # -- target lifecycle ----------------------------------------------

    def _build_argv(self, cmd_line: str) -> List[str]:
        argv = shlex.split(cmd_line)
        if self.options["qemu_mode"]:
            argv = [self.options["qemu_path"]] + argv
        return argv

    def _ensure_target(self, cmd_line: str, use_stdin: bool,
                       input_file: Optional[str]) -> ExecTarget:
        key = (cmd_line, use_stdin, input_file)
        if self._target is not None and self._target_key == key:
            return self._target
        if self._target is not None:
            self._target.close()
        kwargs = dict(
            use_stdin=use_stdin,
            input_file=input_file,
            use_forkserver=bool(self.options["use_fork_server"]),
            use_preload_forkserver=bool(
                self.options["preload_forkserver"]),
            persistent=int(self.options["persistence_max_cnt"]),
            deferred=bool(self.options["deferred_startup"]),
            mem_limit_mb=int(self.options["mem_limit"]),
            coverage=True,
            timeout=float(self.options["timeout"]))
        extra_env = []
        if self.options["modules"]:
            # targets read KB_MODULES at constructor time; delivered
            # as per-target child env, not the fuzzer's own environ
            extra_env.append("KB_MODULES=1")
        if self.options["qemu_mode"]:
            # kb-trace's full-map re-run must finish inside the exec's
            # status window or the exec is misreported as a hang: pass
            # the full per-exec timeout (the tracer arms its guard with
            # what is left of it after the fast exec, kb_trace.c
            # kb_rerun_budget)
            extra_env.append(
                f"KB_TRACE_BUDGET={float(self.options['timeout'])}")
        if extra_env:
            kwargs["extra_env"] = extra_env
        workers = int(self.options["workers"])
        argv = self._build_argv(cmd_line)
        # stdin workers mint private temp files; file-delivery workers
        # derive private @@ paths from the driver's (reference
        # per-instance scaling, dynamorio_instrumentation.c:418-431).
        # A file path the argv doesn't carry as a re-pointable token
        # (whole token or --flag=<path>) can't be privatized per
        # worker: those targets keep a single instance.
        poolable = (input_file is None and use_stdin) or \
            (input_file is not None and
             any(pool_token_matches(a, input_file) for a in argv))
        if workers > 1 and poolable:
            self._target = ExecPool(argv, workers, **kwargs)
        else:
            if workers > 1:
                WARNING_MSG(
                    "afl: workers=%d requested but the input file is "
                    "not a re-pointable argv token (no @@, or embedded "
                    "mid-argument) — running 1 instance", workers)
            self._target = ExecTarget(argv, **kwargs)
        self._target_key = key
        return self._target

    def prepare_host(self, cmd_line: str, use_stdin: bool,
                     input_file: Optional[str] = None) -> None:
        self._ensure_target(cmd_line, use_stdin, input_file)

    # -- single-exec ----------------------------------------------------

    def _finish_exec(self, verdict: int) -> None:
        """Harvest the SHM bitmap and update the three virgin maps
        (reference finish_fuzz_round semantics)."""
        trace = self._target.trace_bits().copy()
        self.total_execs += 1
        self._last_trace = trace
        masked = self._mask_ignored(trace)
        cls = _np_classify(masked)
        ret, self.virgin_bits = _np_has_new_bits(self.virgin_bits, cls)
        self._last_unique_crash = False
        self._last_unique_hang = False
        if verdict in (FUZZ_CRASH, FUZZ_HANG):
            simp = np.where(masked == 0, 1, 128).astype(np.uint8)
            if verdict == FUZZ_CRASH:
                cret, self.virgin_crash = _np_has_new_bits(
                    self.virgin_crash, simp)
                self._last_unique_crash = cret > 0
            else:
                hret, self.virgin_tmout = _np_has_new_bits(
                    self.virgin_tmout, simp)
                self._last_unique_hang = hret > 0
        self.last_status = verdict
        self.last_new_path = ret

    def enable(self, input_bytes: Optional[bytes] = None,
               cmd_line: Optional[str] = None) -> None:
        if cmd_line is None:
            raise ValueError("afl instrumentation needs a cmd_line "
                             "(use a host driver: file/stdin/network)")
        use_stdin = input_bytes is not None
        # file-mode single exec: the driver already wrote the test
        # file, so the backend must not stage over it
        t = self._ensure_target(cmd_line, use_stdin, None)
        t.clear_trace()
        status_raw = t.run(input_bytes or b"")
        verdict, _ = classify(status_raw)
        self._finish_exec(verdict)

    # -- async exec (network drivers) -----------------------------------

    def start_process(self, cmd_line: str) -> None:
        t = self._ensure_target(cmd_line, False, None)
        t.clear_trace()
        t.launch()

    def is_process_done(self) -> bool:
        return self._target is None or not self._target.alive()

    def wait_done(self, timeout: float) -> int:
        verdict, _ = classify(self._target.wait_done(timeout))
        self._finish_exec(verdict)
        return verdict

    def abort_process(self) -> int:
        if self._target is not None and not self.is_process_done():
            self._target.wait_done(0.0)  # kills + reaps immediately
        self._last_unique_crash = False
        self._last_unique_hang = False
        self.last_status = FUZZ_ERROR
        self.last_new_path = 0
        return FUZZ_ERROR

    def last_unique_crash(self) -> bool:
        return self._last_unique_crash

    def last_unique_hang(self) -> bool:
        return self._last_unique_hang

    # -- batched --------------------------------------------------------

    def run_batch(self, inputs: np.ndarray, lengths: np.ndarray,
                  pad_to: Optional[int] = None) -> BatchResult:
        """Execute a numpy [B, L] batch on the bound target and triage
        its bitmaps.  ``pad_to`` pads the result arrays only: a padded
        lane's status is the sentinel -3 (FUZZ_ERROR) and its bitmap is
        zero, so it costs no exec and changes no map, and
        ``total_execs`` counts the real lanes."""
        if self._target is None:
            raise RuntimeError("afl: prepare_host() not called (the "
                               "driver binds the target command first)")
        statuses_raw, bitmaps = self._target.run_batch(inputs, lengths)
        real = len(statuses_raw)
        self.total_execs += real
        if bitmaps is not None and self._ignore is not None:
            bitmaps = np.where(self._ignore[None, :], 0, bitmaps)
        if pad_to is not None and pad_to > real:
            pad = pad_to - real
            statuses_raw = np.concatenate(
                [statuses_raw,
                 np.full(pad, -3, dtype=statuses_raw.dtype)])
            if bitmaps is not None:
                bitmaps = np.concatenate(
                    [bitmaps,
                     np.zeros((pad, bitmaps.shape[1]), dtype=np.uint8)])
        verdicts, exit_codes = classify_batch(statuses_raw)

        if self.options["device_triage"]:
            new_paths, uc, uh = self._torch_triage_batch(bitmaps,
                                                         verdicts)
        else:
            new_paths, uc, uh = self._np_triage_batch(bitmaps, verdicts)
        self._last_trace = bitmaps[real - 1] if real else None
        return BatchResult(statuses=verdicts, new_paths=new_paths,
                           unique_crashes=uc, unique_hangs=uh,
                           exit_codes=exit_codes)

    def _torch_triage_batch(self, bitmaps: np.ndarray,
                            verdicts: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``triage_host_bitmaps`` on the instrumentation's device: the
        bitmaps and the three maps go up, the verdicts and the maps
        come back (the host reads them at once)."""
        dev = self.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        new_paths, uc, uh, vb, vc, vh = triage_host_bitmaps(
            up(bitmaps), up(verdicts), up(self.virgin_bits),
            up(self.virgin_crash), up(self.virgin_tmout))
        self.virgin_bits, self.virgin_crash, self.virgin_tmout = (
            m.cpu().numpy() for m in (vb, vc, vh))
        return new_paths.cpu().numpy(), uc.cpu().numpy(), uh.cpu().numpy()

    def _np_triage_batch(self, bitmaps: np.ndarray,
                         verdicts: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host triage of a batch of raw 64KB maps, sequential-exact.

        phase 1 (vectorized word-skip, the C has_new_bits play): find
        the nonzero u64 words of every lane in one pass — fuzzing maps
        are mostly zero — then classify and test only those words
        against the batch-start virgin map.  Virgin maps only ever
        shrink, so a lane with no overlap now cannot become novel
        later in the batch: the gate is exact, not heuristic.

        phase 2 (sequential, candidates only): the ordinary
        has_new_bits fold, preserving the single-exec loop's verdicts
        for in-batch duplicate novelty.
        """
        n = len(bitmaps) if bitmaps is not None else 0
        new_paths = np.zeros(n, dtype=np.int32)
        uc = np.zeros(n, dtype=bool)
        uh = np.zeros(n, dtype=bool)
        if n == 0:
            return new_paths, uc, uh
        # word-skip gate: lanes whose nonzero words overlap virgin
        words = np.ascontiguousarray(bitmaps).reshape(n, -1, 8)
        nzl, nzw = np.nonzero(words.view(np.uint64)[..., 0])
        if len(nzl):
            wb = words[nzl, nzw]                        # [K, 8] bytes
            cls = COUNT_CLASS_LOOKUP[wb]
            virg = self.virgin_bits.reshape(-1, 8)[nzw]  # [K, 8]
            hit_lanes = nzl[(cls & virg).any(axis=1)]
            cand = np.zeros(n, dtype=bool)
            cand[hit_lanes] = True
        else:
            cand = np.zeros(n, dtype=bool)

        for i in np.flatnonzero(cand):
            cls = _np_classify(bitmaps[i])
            new_paths[i], self.virgin_bits = _np_has_new_bits(
                self.virgin_bits, cls)
        for i in np.flatnonzero((verdicts == FUZZ_CRASH)
                                | (verdicts == FUZZ_HANG)):
            simp = np.where(bitmaps[i] == 0, 1, 128).astype(np.uint8)
            if verdicts[i] == FUZZ_CRASH:
                r, self.virgin_crash = _np_has_new_bits(
                    self.virgin_crash, simp)
                uc[i] = r > 0
            else:
                r, self.virgin_tmout = _np_has_new_bits(
                    self.virgin_tmout, simp)
                uh[i] = r > 0
        return new_paths, uc, uh

    # -- state / merge (reference afl_get_state/afl_set_state/merge) ---

    def get_state(self) -> str:
        return json.dumps({
            "instrumentation": self.name,
            "total_execs": self.total_execs,
            "virgin_bits": encode_array(self.virgin_bits),
            "virgin_crash": encode_array(self.virgin_crash),
            "virgin_tmout": encode_array(self.virgin_tmout),
        })

    def set_state(self, state: str) -> None:
        d = json.loads(state)
        if d.get("instrumentation") not in (None, self.name):
            raise ValueError(
                f"state is for {d.get('instrumentation')!r}, not "
                f"{self.name!r}")
        self.total_execs = int(d.get("total_execs", 0))
        for key in ("virgin_bits", "virgin_crash", "virgin_tmout"):
            if key in d:
                setattr(self, key, decode_array(d[key]))

    def merge(self, other_state: str) -> None:
        """Coverage union: each virgin map ANDed with the other
        state's."""
        d = json.loads(other_state)
        for key in ("virgin_bits", "virgin_crash", "virgin_tmout"):
            if key in d:
                setattr(self, key, getattr(self, key)
                        & decode_array(d[key]))
        self.total_execs += int(d.get("total_execs", 0))

    def coverage_bytes(self) -> int:
        return int((self.virgin_bits != 0xFF).sum())

    def last_trace(self) -> Optional[np.ndarray]:
        """Raw (unmasked) 64KB bitmap of the last exec."""
        return self._last_trace

    def get_edges(self):
        """Nonzero bitmap slots of the last exec as (slot, hit_count)
        pairs; the tracer consumes these (requires {"edges": 1})."""
        if not self.options.get("edges") or self._last_trace is None:
            return None
        idx = np.flatnonzero(self._last_trace)
        return [(int(i), int(self._last_trace[i])) for i in idx]

    def get_module_info(self) -> List[str]:
        """Module names. With {"modules": 1} these come from the SHM
        name table each kb_rt copy registered in (main binary + every
        kb-cc-built shared library); otherwise one anonymous module."""
        if self.options["modules"] and self._target is not None:
            names = self._target.module_table()
            if names:
                return names
        return ["target"]

    def _partition_size(self) -> int:
        """Module partition width: 8KB submaps under {"modules": 1}
        once the target has registered modules — a runtime that
        ignores KB_MODULES (qemu) logs across the full map, so the
        fallback single "target" module must too."""
        if self.options["modules"] and self._target is not None \
                and self._target.module_table():
            return KB_MOD_SIZE
        return MAP_SIZE

    def get_module_edges(self, module: str):
        """get_edges restricted to one module's map partition, with
        partition-local slot numbers (requires {"modules": 1,
        "edges": 1})."""
        return module_slice_edges(self.get_edges(),
                                  self.get_module_info(), module,
                                  self._partition_size())

    def module_coverage_bytes(self) -> Dict[str, int]:
        """Touched virgin bytes per module partition."""
        ps = self._partition_size()
        out = {}
        for m, name in enumerate(self.get_module_info()):
            sl = self.virgin_bits[m * ps:(m + 1) * ps]
            out[name] = int((sl != 0xFF).sum())
        return out

    def module_map_ranges(self):
        ps = self._partition_size()
        return [(name, m * ps, (m + 1) * ps)
                for m, name in enumerate(self.get_module_info())]

    def cleanup(self) -> None:
        if self._target is not None:
            self._target.close()
            self._target = None
