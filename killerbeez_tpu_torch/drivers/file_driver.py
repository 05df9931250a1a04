"""file driver — delivers input via a file path in the target argv.

With a device-backed instrumentation (jit_harness) the bytes go to
the device directly: the "file" is the input tensor, no disk I/O per
exec.  Host-executed targets are not ported yet.
"""

from __future__ import annotations

from .base import Driver
from .factory import register_driver


@register_driver
class FileDriver(Driver):
    """Runs `path arguments` with @@ replaced by the input file."""
    name = "file"
    OPTION_SCHEMA = {"path": str, "arguments": str, "timeout": float,
                     "test_filename": str}
    OPTION_DESCS = {
        "path": "target executable (host backends; not ported yet)",
        "arguments": "argument string; @@ becomes the input path "
                     "(default just @@)",
        "timeout": "seconds before a run counts as a hang",
        "test_filename": "fixed input filename",
    }
    DEFAULTS = {"arguments": "@@"}

    def __init__(self, options, instrumentation, mutator=None,
                 device="cuda"):
        super().__init__(options, instrumentation, mutator, device=device)
        if not instrumentation.device_backed:
            raise ValueError("file driver: host-executed targets are not "
                             "ported yet")

    def test_input(self, buf: bytes) -> int:
        self.last_input = bytes(buf)
        self.instrumentation.enable(input_bytes=buf)
        return self.instrumentation.get_fuzz_result()
