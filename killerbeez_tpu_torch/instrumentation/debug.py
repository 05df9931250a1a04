"""debug — debugger-based crash triage for host binaries.

The reference's debug instrumentation is Windows-only: a debug thread
waits on WaitForDebugEvent and maps EXCEPTION events to FUZZ_CRASH,
EXIT_PROCESS to FUZZ_NONE (SURVEY §2.3, reference
debug_instrumentation.c:19-88). The Linux equivalent here runs the
target under ptrace (native/kb_exec.cpp kb_target_run_debug): a fatal
signal stop yields the *crash details* — signal, si_code, faulting
address and PC — before the signal is delivered, so findings carry
triage data (NULL deref vs wild write vs abort) instead of just an
exit status. No coverage: ``is_new_path`` is always 0, like the
reference (crash dedup happens on (signal, pc) instead).
"""

from __future__ import annotations

import json
import shlex
import signal as signal_mod
from typing import Any, Dict, Optional, Set, Tuple

from .. import FUZZ_CRASH, resolve_device
from ..native.exec_backend import ExecTarget, classify
from .base import Instrumentation
from .factory import register_instrumentation


@register_instrumentation
class DebugInstrumentation(Instrumentation):
    """ptrace-backed crash detail harvesting (no coverage)."""
    name = "debug"
    supports_batch = False
    device_backed = False
    OPTION_SCHEMA = {"timeout": float, "mem_limit": int}
    OPTION_DESCS = {
        "timeout": "seconds before an exec counts as a hang "
                   "(default 2.0)",
        "mem_limit": "child address-space limit in MB (0 = none)",
    }
    DEFAULTS = {"timeout": 2.0, "mem_limit": 0}

    def __init__(self, options: Optional[str] = None, device="cuda"):
        super().__init__(options)
        # nothing runs on the device: it is checked like every
        # component's, so a campaign's parts agree on where they run
        self.device = resolve_device(device)
        self._target: Optional[ExecTarget] = None
        self._target_key: Optional[Tuple] = None
        self.total_execs = 0
        self.last_crash_info: Dict[str, Any] = {}
        # (signal, pc) pairs seen — the debugger-mode uniqueness notion
        self.crash_sites: Set[Tuple[int, int]] = set()
        self._last_unique_crash = False

    def _ensure_target(self, cmd_line: str, use_stdin: bool
                       ) -> ExecTarget:
        key = (cmd_line, use_stdin)
        if self._target is not None and self._target_key == key:
            return self._target
        if self._target is not None:
            self._target.close()
        self._target = ExecTarget(
            shlex.split(cmd_line), use_stdin=use_stdin,
            use_forkserver=False,  # the debugger IS the supervisor
            mem_limit_mb=int(self.options["mem_limit"]),
            coverage=False,
            timeout=float(self.options["timeout"]))
        self._target_key = key
        return self._target

    def enable(self, input_bytes: Optional[bytes] = None,
               cmd_line: Optional[str] = None) -> None:
        if cmd_line is None:
            raise ValueError("debug instrumentation needs a cmd_line "
                             "(use a host driver: file/stdin)")
        t = self._ensure_target(cmd_line, input_bytes is not None)
        status, info = t.run_debug(input_bytes or b"")
        verdict, _ = classify(status)
        self.total_execs += 1
        self.last_status = verdict
        self.last_new_path = 0  # no coverage, like the reference
        self.last_crash_info = info if verdict == FUZZ_CRASH else {}
        self._last_unique_crash = False
        if verdict == FUZZ_CRASH:
            site = (info.get("signal", 0), info.get("pc", 0))
            if site not in self.crash_sites:
                self.crash_sites.add(site)
                self._last_unique_crash = True

    def last_unique_crash(self) -> bool:
        return self._last_unique_crash

    def crash_description(self) -> str:
        """Human-readable triage line for the last crash."""
        if not self.last_crash_info:
            return "no crash"
        info = self.last_crash_info
        try:
            signame = signal_mod.Signals(info["signal"]).name
        except ValueError:
            signame = f"signal {info['signal']}"
        return (f"{signame} at pc=0x{info['pc']:x} "
                f"fault_addr=0x{info['fault_addr']:x} "
                f"si_code={info['si_code']}")

    # -- state ----------------------------------------------------------

    def get_state(self) -> str:
        return json.dumps({
            "instrumentation": self.name,
            "total_execs": self.total_execs,
            "crash_sites": sorted(
                [s, p] for s, p in self.crash_sites),
        })

    def set_state(self, state: str) -> None:
        d = json.loads(state)
        if d.get("instrumentation") not in (None, self.name):
            raise ValueError(
                f"state is for {d.get('instrumentation')!r}, not "
                f"{self.name!r}")
        self.total_execs = int(d.get("total_execs", 0))
        self.crash_sites = {(int(s), int(p))
                            for s, p in d.get("crash_sites", [])}

    def merge(self, other_state: str) -> None:
        d = json.loads(other_state)
        self.crash_sites |= {(int(s), int(p))
                             for s, p in d.get("crash_sites", [])}
        self.total_execs += int(d.get("total_execs", 0))

    def cleanup(self) -> None:
        if self._target is not None:
            self._target.close()
            self._target = None
