"""Randomized mutators: havoc, zzuf, ni, honggfuzz, splice.

Each lane's PRNG key is derived from (base seed, absolute iteration
index) with the JAX-compatible threefry ``fold_in`` (ops/prng.py), so
candidate i is the same bytes whether generated alone, inside any
batch, or inside the fused kernel — and the same bytes the JAX
package generates.  Every draw comes from ``ops/prng.py``, never from
torch's own generators.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import mutate_core as mc
from ..ops import prng
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
        return prng.fold_in(self._base_key(), self._its_on_device(its))


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

    def _generate(self, its):
        sp = int(self.options["stack_pow2"])
        words = havoc_words_for_keys(self._keys(its), sp)
        if self.focus_positions is not None:
            return mc.havoc_focus_at(self._seed_on_device(), self.seed_len,
                                     words, self._focus_on_device(), sp)
        return mc.havoc_at(self._seed_on_device(), self.seed_len, words, sp)

    def fused_spec(self):
        """What a fused mutate+execute kernel needs to generate this
        mutator's lanes itself: (seed buffer uint8[L] on the device,
        seed_len, base PRNG key, stack_pow2).  The kernel derives
        per-lane keys as fold_in(base, absolute_iteration) — exactly
        _keys."""
        return (self._seed_on_device(), self.seed_len, self._base_key(),
                int(self.options["stack_pow2"]))


class ZzufMutator(_KeyedMutator):
    """zzuf-style: flips each bit with probability ``ratio_bits``."""
    name = "zzuf"
    OPTION_SCHEMA = {"ratio_bits": float}
    OPTION_DESCS = {"ratio_bits": "per-bit flip probability "
                                  "(default 0.004, zzuf's default)"}
    DEFAULTS = {"ratio_bits": 0.004}

    def __init__(self, options, input_bytes, device="cuda"):
        super().__init__(options, input_bytes, device=device)
        r = float(self.options["ratio_bits"])
        if not (0.0 < r <= 1.0):
            raise ValueError("ratio_bits must be in (0, 1]")

    def _generate(self, its):
        ratio = float(self.options["ratio_bits"])
        if self.focus_positions is not None:
            return mc.zzuf_focus_at(self._seed_on_device(), self.seed_len,
                                    self._keys(its), self._focus_on_device(),
                                    ratio)
        return mc.zzuf_at(self._seed_on_device(), self.seed_len,
                          self._keys(its), ratio)


class NiMutator(_KeyedMutator):
    """ni-style structure-blind chunk shuffler: swaps/duplicates
    aligned chunks of the seed plus light byte noise."""
    name = "ni"
    OPTION_SCHEMA = {"chunk_size": int}
    OPTION_DESCS = {"chunk_size": "chunk granularity in bytes (default 4)"}
    DEFAULTS = {"chunk_size": 4}

    def __init__(self, options, input_bytes, device="cuda"):
        super().__init__(options, input_bytes, device=device)
        if int(self.options["chunk_size"]) < 1:
            raise ValueError("chunk_size must be >= 1")

    def _generate(self, its):
        cs = int(self.options["chunk_size"])
        keys = self._keys(its)
        buf, length = mc.lanes(self._seed_on_device(), self.seed_len,
                                keys.shape[0])
        L = buf.shape[-1]
        ks = prng.split(keys, 5)
        # the four integer draws (two chunks, a noise position, a noise
        # byte) as one randint over four of the split keys
        n_chunks = (length // cs).clamp(min=1)
        hi = torch.stack([n_chunks, n_chunks, length.clamp(min=1),
                          torch.full_like(length, 256)], dim=-1)
        lo = torch.zeros_like(hi)
        lo[:, 3] = 1
        a, b, pos, val = (d[:, None] for d in
                          prng.randint(ks[:, :4], lo, hi).unbind(-1))
        a, b = a * cs, b * cs
        idx = torch.arange(L, device=buf.device)[None, :]
        in_a = (idx >= a) & (idx < a + cs)
        in_b = (idx >= b) & (idx < b + cs)
        from_b = buf.gather(1, (b + (idx - a)).clamp(0, L - 1))
        from_a = buf.gather(1, (a + (idx - b)).clamp(0, L - 1))
        swapped = torch.where(in_a, from_b, torch.where(in_b, from_a, buf))
        # light noise: one random byte xor'ed in (the JAX scatter drops
        # a position outside the buffer; the compare-select does too)
        noisy = torch.where(idx == pos, swapped ^ val.to(torch.uint8),
                            swapped)
        use_noise = prng.bernoulli(ks[:, 4], 0.5, 1)
        return torch.where(use_noise, noisy, swapped), length


class HonggfuzzMutator(_KeyedMutator):
    """honggfuzz-style mangle: run-oriented byte-set/copy/magic/inc/dec."""
    name = "honggfuzz"
    OPTION_SCHEMA = {"max_ops": int}
    OPTION_DESCS = {"max_ops": "max stacked mangle ops (default 8)"}
    DEFAULTS = {"max_ops": 8}

    def __init__(self, options, input_bytes, device="cuda"):
        super().__init__(options, input_bytes, device=device)
        if not (1 <= int(self.options["max_ops"]) <= 64):
            raise ValueError("max_ops must be in 1..64")

    def _generate(self, its):
        return mc.mangle_at(self._seed_on_device(), self.seed_len,
                            self._keys(its), int(self.options["max_ops"]))


class SpliceMutator(_KeyedMutator):
    """Splices the seed with corpus files at random cut points."""
    name = "splice"
    OPTION_SCHEMA = {"corpus": list, "corpus_dir": str}
    OPTION_DESCS = {
        "corpus": "inline list of base64 or plain-string second inputs",
        "corpus_dir": "directory of files to splice with",
    }

    def __init__(self, options, input_bytes, device="cuda"):
        super().__init__(options, input_bytes, device=device)
        partners = [item.encode() if isinstance(item, str) else bytes(item)
                    for item in self.options.get("corpus", [])]
        if "corpus_dir" in self.options:
            d = self.options["corpus_dir"]
            for fn in sorted(os.listdir(d)):
                p = os.path.join(d, fn)
                if os.path.isfile(p):
                    with open(p, "rb") as f:
                        partners.append(f.read())
        partners = [p for p in partners if p]
        if not partners:
            raise ValueError("splice mutator needs corpus/corpus_dir")
        L = self.max_length
        arr = np.zeros((len(partners), L), dtype=np.uint8)
        lens = np.zeros(len(partners), dtype=np.int32)
        for i, p in enumerate(partners):
            p = p[:L]
            arr[i, :len(p)] = np.frombuffer(p, dtype=np.uint8)
            lens[i] = len(p)
        self.partners, self.partner_lens = arr, lens
        # the partner table goes to the device once
        self._partners_on = (self._upload(arr), self._upload(lens))

    def _generate(self, its):
        pbufs, plens = self._partners_on
        keys = self._keys(its)
        sub = prng.split(keys, 2)
        j = prng.randint(sub[:, 0], 0, pbufs.shape[0]).clamp(
            0, pbufs.shape[0] - 1)
        return mc.splice_at(self._seed_on_device(), self.seed_len,
                            pbufs[j], plens[j], sub[:, 1])
