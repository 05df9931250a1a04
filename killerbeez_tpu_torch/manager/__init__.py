"""Distributed manager tier (reference SURVEY §2.8).

The reference pairs a Flask+SQLAlchemy REST manager with BOINC work
distribution. Here the same REST surface (Job / Results / Target /
Config / File / Minimize) runs on the standard library
(ThreadingHTTPServer + sqlite3), and BOINC is replaced by a pull
work-queue over DCN: workers claim workunits (`POST /api/work/claim`),
run the fuzzer CLI locally, and the assimilator posts findings back —
the same lifecycle as manager `create_work` -> BOINC wrapper ->
assimilator POST (python/manager/lib/boinc.py:63-91,
server/killerbeez_assimilator.py).

    python -m killerbeez_tpu_torch.manager --port 8650    # serve
    python -m killerbeez_tpu_torch.manager --seed         # demo rows
"""

from .db import ManagerDB
from .fuzzer_cmd import format_cmdline
from .api import ManagerServer

__all__ = ["ManagerDB", "format_cmdline", "ManagerServer"]
