"""The `radamsa` mutator: wraps an external radamsa binary when one
is available (the reference fetches radamsa as an ExternalProject,
CMakeLists.txt:85-97). Gated: creation fails with a clear message if
no binary is on PATH or given via options.  The candidates are made
on the host, one process each, and uploaded once per batch."""

from __future__ import annotations

import shutil
import subprocess
from typing import Tuple

import numpy as np
import torch

from .base import Mutator


class RadamsaMutator(Mutator):
    """External radamsa process; deterministic via per-iteration seed."""
    name = "radamsa"
    lazy_batches = False     # candidates made on the host
    OPTION_SCHEMA = {"path": str}
    OPTION_DESCS = {"path": "radamsa binary (default: found on PATH)"}

    def __init__(self, options, input_bytes, device="cuda"):
        super().__init__(options, input_bytes, device=device)
        self.binary = self.options.get("path") or shutil.which("radamsa")
        if not self.binary:
            raise ValueError(
                "radamsa mutator: no radamsa binary found (set "
                '{"path": ...} or install radamsa)')

    def _generate(self, its: np.ndarray) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        n = len(its)
        bufs = np.zeros((n, self.max_length), dtype=np.uint8)
        lens = np.zeros(n, dtype=np.int32)
        base_seed = int(self.options.get("seed", 0))
        for row, it in enumerate(np.asarray(its)):
            out = subprocess.run(
                [self.binary, "-s", str(base_seed + int(it))],
                input=self.seed_bytes, stdout=subprocess.PIPE, check=True
            ).stdout[:self.max_length]
            if not out:
                out = self.seed_bytes[:self.max_length]
            bufs[row, :len(out)] = np.frombuffer(out, dtype=np.uint8)
            lens[row] = len(out)
        return self._upload(bufs), self._upload(lens)
