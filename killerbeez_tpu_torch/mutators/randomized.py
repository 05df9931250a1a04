"""Randomized mutators (this slice: havoc).

Each lane's PRNG key is derived from (base seed, absolute iteration
index) with the JAX-compatible threefry ``fold_in`` (ops/prng.py), so
candidate i is the same bytes whether generated alone, inside any
batch, or inside the fused kernel — and the same bytes the JAX
package generates.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import prng
from ..ops.mutate_core import havoc_at
from ..ops.vm_kernel import havoc_words_for_keys
from .base import Mutator


class _KeyedMutator(Mutator):
    """Shared plumbing: iteration index -> per-lane key."""

    _key_cache = None

    def _base_key(self) -> torch.Tensor:
        """The mutator's PRNG root (``jax.random.key(seed)``'s data) on
        its device, made once per seed value.  fused_spec hands THIS
        key to the fused kernel, which folds in iteration indices
        exactly like _keys."""
        seed = int(self.options.get("seed", 0))
        if self._key_cache is None or self._key_cache[0] != seed:
            self._key_cache = (seed, prng.key(seed, device=self.device))
        return self._key_cache[1]

    def _keys(self, its: np.ndarray) -> torch.Tensor:
        its = torch.as_tensor(np.asarray(its, dtype=np.int64),
                              device=self.device)
        return prng.fold_in(self._base_key(), its)


class HavocMutator(_KeyedMutator):
    """AFL havoc: stacked random edits (flip/arith/interesting/blocks)."""
    name = "havoc"
    OPTION_SCHEMA = {"stack_pow2": int}
    OPTION_DESCS = {"stack_pow2": "max stacked edits = 2**stack_pow2 "
                                  "(default 4; AFL uses 7)"}
    DEFAULTS = {"stack_pow2": 4}

    def __init__(self, options, input_bytes, device="cuda"):
        super().__init__(options, input_bytes, device=device)
        sp = int(self.options["stack_pow2"])
        if not (1 <= sp <= 7):
            raise ValueError("stack_pow2 must be in 1..7")

    _seed_cache = None

    def _seed_on_device(self) -> torch.Tensor:
        """``seed_buf`` on the mutator's device, copied once per seed
        buffer."""
        if self._seed_cache is None or \
                self._seed_cache[0] is not self.seed_buf:
            self._seed_cache = (self.seed_buf, torch.as_tensor(
                self.seed_buf, device=self.device))
        return self._seed_cache[1]

    def _generate(self, its):
        sp = int(self.options["stack_pow2"])
        words = havoc_words_for_keys(self._keys(its), sp)
        return havoc_at(self._seed_on_device(), self.seed_len, words, sp)

    def fused_spec(self):
        """What a fused mutate+execute kernel needs to generate this
        mutator's lanes itself: (seed buffer uint8[L] on the device,
        seed_len, base PRNG key, stack_pow2).  The kernel derives
        per-lane keys as fold_in(base, absolute_iteration) — exactly
        _keys."""
        return (self._seed_on_device(), self.seed_len, self._base_key(),
                int(self.options["stack_pow2"]))
