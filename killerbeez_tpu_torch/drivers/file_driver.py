"""file driver — delivers input via a file path in the target argv.

Parity with the reference file driver (file_driver.c): mutated input
is written to a test file, ``@@`` in the argument string is replaced
by its path, and the instrumentation runs the command.  When the
instrumentation is device-backed (jit_harness, ipt), the bytes go to
the device directly — the "file" is the input tensor, no disk I/O per
exec.
"""

from __future__ import annotations

import os

from ..utils.fileio import get_temp_filename, write_buffer_to_file
from .base import Driver
from .factory import register_driver


@register_driver
class FileDriver(Driver):
    """Runs `path arguments` with @@ replaced by the input file."""
    name = "file"
    OPTION_SCHEMA = {"path": str, "arguments": str, "timeout": float,
                     "test_filename": str}
    OPTION_DESCS = {
        "path": "target executable (host backends)",
        "arguments": "argument string; @@ becomes the input path "
                     "(default just @@)",
        "timeout": "seconds before a run counts as a hang",
        "test_filename": "fixed input filename (default: a temp file)",
    }
    DEFAULTS = {"arguments": "@@"}

    def __init__(self, options, instrumentation, mutator=None,
                 device="cuda"):
        super().__init__(options, instrumentation, mutator, device=device)
        self._device_backed = instrumentation.device_backed
        if not self._device_backed and "path" not in self.options:
            raise ValueError(
                'file driver needs {"path": target} for host backends')
        self.test_filename = self.options.get("test_filename") or \
            get_temp_filename("kbz_input_")

    def _cmd_line(self) -> str:
        args = self.options["arguments"].replace("@@", self.test_filename)
        return f'{self.options["path"]} {args}'

    def _host_exec_spec(self):
        # the exec backend stages the input file itself in the batched
        # path (a C-side write per exec, no Python file I/O)
        return {"cmd_line": self._cmd_line(), "use_stdin": False,
                "input_file": self.test_filename}

    def test_input(self, buf: bytes) -> int:
        self.last_input = bytes(buf)
        if self._device_backed:
            self.instrumentation.enable(input_bytes=buf)
        else:
            write_buffer_to_file(self.test_filename, buf)
            self.instrumentation.enable(cmd_line=self._cmd_line())
        return self.instrumentation.get_fuzz_result()

    def cleanup(self) -> None:
        if not self.options.get("test_filename") and \
                os.path.exists(self.test_filename):
            os.unlink(self.test_filename)
