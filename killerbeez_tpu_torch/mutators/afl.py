"""The `afl` mutator: AFL's full deterministic pipeline, then havoc.

Stage order mirrors AFL (and the reference's afl mutator): walking
bit flips (1/2/4), walking byte flips (8/16/32 bits), arithmetic,
interesting values — then endless havoc.  The absolute iteration index
decodes to (stage, local index) on the host; a batch that spans stage
boundaries is put together on the device from one call per stage
(each stage's share of a run of consecutive iterations is itself a
run), in iteration order.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..ops import mutate_core as mc
from ..ops import prng
from ..ops.vm_kernel import havoc_words_for_keys
from .randomized import _KeyedMutator


class AflMutator(_KeyedMutator):
    """AFL deterministic stages then havoc (never exhausts)."""
    name = "afl"
    OPTION_SCHEMA = {"skip_deterministic": int, "stack_pow2": int}
    OPTION_DESCS = {
        "skip_deterministic": "1 = jump straight to havoc (AFL -d)",
        "stack_pow2": "havoc stack: max edits = 2**stack_pow2 (default 4)",
    }
    DEFAULTS = {"skip_deterministic": 0, "stack_pow2": 4}

    def __init__(self, options, input_bytes, device="cuda"):
        super().__init__(options, input_bytes, device=device)
        self._build_stages()

    def _build_stages(self) -> None:
        n = self.seed_len
        stages: List[Tuple[str, int, int]] = []  # (kind, param, size)
        if not self.options["skip_deterministic"]:
            stages += [
                ("flip", 1, mc.bit_flip_total(n, 1)),
                ("flip", 2, mc.bit_flip_total(n, 2)),
                ("flip", 4, mc.bit_flip_total(n, 4)),
                # byte flips: byte-aligned windows, one per start byte
                ("byteflip", 8, max(n, 0)),
                ("byteflip", 16, max(n - 1, 0)),
                ("byteflip", 32, max(n - 3, 0)),
                ("arith", 0, mc.arithmetic_total(n)),
                ("interest", 0, mc.interesting_total(n)),
            ]
        self.stages = stages
        self.det_total = sum(s[2] for s in stages)

    def set_input(self, input_bytes: bytes,
                  keep_length: bool = False) -> None:
        super().set_input(input_bytes, keep_length)
        self._build_stages()

    def get_total_iteration_count(self) -> int:
        return -1  # havoc tail never exhausts

    def stage_name(self, it: int | None = None) -> str:
        """Human-readable stage for an iteration (status reporting)."""
        it = self.iteration if it is None else it
        for kind, param, size in self.stages:
            if it < size:
                return f"{kind}{param or ''}"
            it -= size
        return "havoc"

    def _run_stage(self, kind: str, param: int, start: int, n: int):
        """Local iterations [start, start + n) of one stage.  The walks
        take their iteration numbers as int32, as the JAX package's
        do."""
        seed, sl = self._seed_on_device(), self.seed_len
        local = torch.arange(start, start + n, dtype=torch.int64,
                             device=self.device)
        if kind == "flip":
            return mc.bit_flip_at(seed, sl, local, param)
        if kind == "byteflip":
            return mc.bit_flip_at(seed, sl, local * 8, param)
        if kind == "arith":
            return mc.arithmetic_at(seed, sl, local)
        if kind == "interest":
            return mc.interesting_at(seed, sl, local)
        raise AssertionError(kind)

    def _havoc(self, start: int, n: int):
        """Havoc-tail lanes [start, start + n) past the deterministic
        stages: keys ``fold_in(key(seed), it - det_total)``."""
        sp = int(self.options["stack_pow2"])
        local = torch.arange(start, start + n, dtype=torch.int64,
                             device=self.device)
        words = havoc_words_for_keys(prng.fold_in(self._base_key(), local),
                                     sp)
        if self.focus_positions is not None:
            # the focus mask applies to the havoc tail only: the
            # deterministic stages are position-exhaustive walks whose
            # iteration contract must not change under a mask
            return mc.havoc_focus_at(self._seed_on_device(), self.seed_len,
                                     words, self._focus_on_device(), sp)
        return mc.havoc_at(self._seed_on_device(), self.seed_len, words, sp)

    def _generate(self, its: np.ndarray):
        lo = self._run_start(its)
        hi = lo + len(its)
        parts = []
        offset = 0
        for kind, param, size in self.stages:
            a, b = max(lo, offset), min(hi, offset + size)
            if a < b:
                parts.append(self._run_stage(kind, param, a - offset,
                                             b - a))
            offset += size
        if hi > offset:
            a = max(lo, offset)
            parts.append(self._havoc(a - offset, hi - a))
        if len(parts) == 1:
            return parts[0]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
