"""Command-line synthesis for fuzzing jobs.

Parity with the reference's lib/fuzzer.py:59-95 ``format_cmdline``:
build the client invocation ``driver instrumentation mutator -sf seed
-n N [-d ..][-i ..][-m ..]`` with shell escaping per platform
(sh/bat, lib/fuzzer.py:15-53). Jobs stay reproducible shell commands
— an operator can paste a job row into a terminal.
"""

from __future__ import annotations

import shlex
from typing import Any, Dict, Optional


def _escape_sh(s: str) -> str:
    return shlex.quote(s)


def _escape_bat(s: str) -> str:
    """cmd.exe-style quoting (reference bat escaping): wrap in double
    quotes, double embedded double quotes."""
    return '"' + s.replace('"', '""') + '"'


def format_cmdline(job: Dict[str, Any], platform: str = "linux_x86_64",
                   program: str = "python -m killerbeez_tpu_torch.fuzzer",
                   seed_file: Optional[str] = None) -> str:
    """Render a job row (db.py jobs schema) as an executable command."""
    esc = _escape_bat if platform.startswith("windows") else _escape_sh
    parts = [program, job["driver"], job["instrumentation"],
             job["mutator"]]
    seed = seed_file or job.get("seed_file")
    if seed:
        parts += ["-sf", esc(seed)]
    parts += ["-n", str(int(job.get("iterations", 1000)))]
    for flag, key in (("-d", "driver_opts"),
                      ("-i", "instrumentation_opts"),
                      ("-m", "mutator_opts"),
                      ("-msf", "mutator_state_file"),
                      ("-isf", "instrumentation_state_file")):
        val = job.get(key)
        if val:
            parts += [flag, esc(val)]
    return " ".join(parts)
