"""stdin driver — delivers input on the target's standard input
(reference stdin_driver.c:29-106; the forkserver feeds the bytes to
the child's stdin there, subprocess stdin here)."""

from __future__ import annotations

from .base import Driver
from .factory import register_driver


@register_driver
class StdinDriver(Driver):
    """Runs `path arguments` with input bytes on stdin."""
    name = "stdin"
    OPTION_SCHEMA = {"path": str, "arguments": str, "timeout": float}
    OPTION_DESCS = {
        "path": "target executable (host backends)",
        "arguments": "extra argument string (no @@ substitution)",
        "timeout": "seconds before a run counts as a hang",
    }
    DEFAULTS = {"arguments": ""}

    def __init__(self, options, instrumentation, mutator=None,
                 device="cuda"):
        super().__init__(options, instrumentation, mutator, device=device)
        self._device_backed = instrumentation.device_backed
        if not self._device_backed and "path" not in self.options:
            raise ValueError(
                'stdin driver needs {"path": target} for host backends')

    def _cmd_line(self) -> str:
        args = self.options["arguments"]
        return f'{self.options["path"]} {args}'.strip()

    def _host_exec_spec(self):
        return {"cmd_line": self._cmd_line(), "use_stdin": True,
                "input_file": None}

    def test_input(self, buf: bytes) -> int:
        self.last_input = bytes(buf)
        if self._device_backed:
            self.instrumentation.enable(input_bytes=buf)
        else:
            self.instrumentation.enable(input_bytes=buf,
                                        cmd_line=self._cmd_line())
        return self.instrumentation.get_fuzz_result()
