"""return_code — dumb host-exec instrumentation.

Parity with the reference's return_code instrumentation
(return_code_instrumentation.c): run the target process, verdict from
the exit status only (signal -> crash, timeout -> hang), no coverage
(``is_new_path`` always 0, ``merge`` unsupported).  Single-exec only:
the fuzzing loop runs it one input at a time.
"""

from __future__ import annotations

import json
import shlex
import signal
import subprocess
from typing import Optional

from .. import FUZZ_CRASH, FUZZ_ERROR, FUZZ_HANG, FUZZ_NONE, \
    resolve_device
from .base import Instrumentation
from .factory import register_instrumentation


@register_instrumentation
class ReturnCodeInstrumentation(Instrumentation):
    """Exit-status-only verdicts for real host binaries."""
    name = "return_code"
    supports_batch = False
    OPTION_SCHEMA = {"timeout": float}
    OPTION_DESCS = {"timeout": "seconds before an exec counts as a hang "
                               "(default 2.0)"}
    DEFAULTS = {"timeout": 2.0}

    def __init__(self, options: Optional[str] = None, device="cuda"):
        super().__init__(options)
        # nothing runs on the device: it is checked like every
        # component's, so a campaign's parts agree on where they run
        self.device = resolve_device(device)
        self.last_exit_code = 0
        self.total_execs = 0

    def enable(self, input_bytes: Optional[bytes] = None,
               cmd_line: Optional[str] = None) -> None:
        if not cmd_line:
            raise ValueError("return_code needs a command line from the "
                             "driver")
        try:
            proc = subprocess.run(
                shlex.split(cmd_line),
                input=input_bytes,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                timeout=float(self.options["timeout"]))
            rc = proc.returncode
            if rc < 0:  # killed by signal -> crash (WIFSIGNALED)
                self.last_status = FUZZ_CRASH
            else:
                self.last_status = FUZZ_NONE
            self.last_exit_code = rc
        except subprocess.TimeoutExpired:
            self.last_status = FUZZ_HANG
            self.last_exit_code = -int(signal.SIGKILL)
        except OSError:
            self.last_status = FUZZ_ERROR
            self.last_exit_code = -1
        self.total_execs += 1
        self.last_new_path = 0  # dumb fuzzing: no coverage signal

    # -- async exec (network drivers) -----------------------------------

    def start_process(self, cmd_line: str) -> None:
        self._proc = subprocess.Popen(
            shlex.split(cmd_line),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def is_process_done(self) -> bool:
        proc = getattr(self, "_proc", None)
        return proc is None or proc.poll() is not None

    def wait_done(self, timeout: float) -> int:
        proc = self._proc
        try:
            rc = proc.wait(timeout=timeout)
            self.last_status = FUZZ_CRASH if rc < 0 else FUZZ_NONE
            self.last_exit_code = rc
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            self.last_status = FUZZ_HANG
            self.last_exit_code = -int(signal.SIGKILL)
        self._proc = None
        self.total_execs += 1
        self.last_new_path = 0
        return self.last_status

    def abort_process(self) -> int:
        proc = getattr(self, "_proc", None)
        if proc is not None:
            proc.kill()
            proc.wait()
            self._proc = None
        self.last_status = FUZZ_ERROR
        self.last_exit_code = -1
        self.last_new_path = 0
        return FUZZ_ERROR

    # merge: the reference returns NULL state and no merge for
    # return_code; keep get_state minimal for -isd parity
    def get_state(self) -> str:
        return json.dumps({"instrumentation": self.name,
                           "total_execs": self.total_execs})

    def set_state(self, state: str) -> None:
        d = json.loads(state)
        self.total_execs = int(d.get("total_execs", 0))
