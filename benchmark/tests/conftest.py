"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q``
from the root of the repository.  They import the benchmark's packages
(``kbbench``, ``reference``) from ``benchmark/`` and the port from the
root."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
