"""Deterministic walking mutators: nop, bit_flip, arithmetic,
interesting_value, dictionary.

Each decodes an absolute iteration index into an exact mutation
(AFL-style walking order), so runs are reproducible and resumable from
the serialized iteration counter alone — the reference's
deterministic-iteration contract (api_mutator.tex:154-177).  A batch
is one vectorised call over its lanes' iteration numbers, made on the
device.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..ops import mutate_core as mc
from .base import Mutator


class NopMutator(Mutator):
    """Returns the seed unchanged every iteration (plumbing tests)."""
    name = "nop"

    def _generate(self, its):
        n = len(its)
        seed = self._seed_on_device()
        return (seed.expand(n, seed.shape[0]).contiguous(),
                torch.full((n,), self.seed_len, dtype=torch.int32,
                           device=self.device))


class BitFlipMutator(Mutator):
    """Walks the seed flipping num_bits consecutive bits per iteration."""
    name = "bit_flip"
    OPTION_SCHEMA = {"num_bits": int}
    OPTION_DESCS = {"num_bits": "consecutive bits flipped per iteration "
                                "(1/2/4, default 1)"}
    DEFAULTS = {"num_bits": 1}

    def __init__(self, options, input_bytes, device="cuda"):
        super().__init__(options, input_bytes, device=device)
        nb = int(self.options["num_bits"])
        if nb not in (1, 2, 4, 8, 16, 32):
            raise ValueError(f"bit_flip: unsupported num_bits {nb}")

    def get_total_iteration_count(self) -> int:
        return mc.bit_flip_total(self.seed_len,
                                 int(self.options["num_bits"]))

    def _generate(self, its):
        return mc.bit_flip_at(self._seed_on_device(), self.seed_len,
                              self._its_on_device(its),
                              int(self.options["num_bits"]))


class ArithmeticMutator(Mutator):
    """Walks +/- deltas (1..35) over 1/2/4-byte fields, both ends."""
    name = "arithmetic"

    def get_total_iteration_count(self) -> int:
        return mc.arithmetic_total(self.seed_len)

    def _generate(self, its):
        return mc.arithmetic_at(self._seed_on_device(), self.seed_len,
                                self._its_on_device(its))


class InterestingValueMutator(Mutator):
    """Walks boundary values (AFL interesting 8/16/32) over the seed."""
    name = "interesting_value"

    def get_total_iteration_count(self) -> int:
        return mc.interesting_total(self.seed_len)

    def _generate(self, its):
        return mc.interesting_at(self._seed_on_device(), self.seed_len,
                                 self._its_on_device(its))


class DictionaryMutator(Mutator):
    """Overwrites/inserts dictionary tokens at every position.

    With no token file or inline list, tokens auto-populate from
    static analysis of a KBVM target: the branch-comparison constants
    the abstract interpreter extracts (magic strings, opcode bytes,
    guarded values — ``analysis.extract_dictionary``)."""
    name = "dictionary"
    OPTION_SCHEMA = {"dictionary": str, "tokens": list, "target": str,
                     "program_file": str}
    OPTION_DESCS = {
        "dictionary": "path to a token file (one token per line; "
                      "\\xNN escapes allowed)",
        "tokens": "inline token list (strings)",
        "target": "KBVM target name: auto-extract tokens from its "
                  "branch-comparison constants (static analysis)",
        "program_file": "compiled .npz KBVM program to auto-extract "
                        "tokens from",
    }

    def __init__(self, options, input_bytes, device="cuda"):
        super().__init__(options, input_bytes, device=device)
        toks: List[bytes] = []
        if "tokens" in self.options:
            toks += [t.encode() if isinstance(t, str) else bytes(t)
                     for t in self.options["tokens"]]
        if "dictionary" in self.options:
            path = self.options["dictionary"]
            if not os.path.isfile(path):
                raise ValueError(f"dictionary file not found: {path}")
            with open(path, "rb") as f:
                for line in f.read().splitlines():
                    if line and not line.startswith(b"#"):
                        toks.append(
                            line.decode("latin-1").encode("latin-1")
                            .decode("unicode_escape").encode("latin-1"))
        if not toks and ("target" in self.options
                         or "program_file" in self.options):
            toks += self._static_tokens()
        if not toks:
            raise ValueError(
                "dictionary mutator needs tokens (a token file, "
                "inline tokens, or a KBVM target/program_file to "
                "auto-extract from)")
        toks = [t[:self.max_length] for t in toks if t]
        tl = max(len(t) for t in toks)
        arr = np.zeros((len(toks), tl), dtype=np.uint8)
        for i, t in enumerate(toks):
            arr[i, :len(t)] = np.frombuffer(t, dtype=np.uint8)
        self.tokens = arr
        self.token_lens = np.array([len(t) for t in toks], dtype=np.int32)
        # the token table goes to the device once
        self._tokens_on = (self._upload(arr), self._upload(self.token_lens))

    def _static_tokens(self) -> List[bytes]:
        """Auto-dictionary from the target's static analysis."""
        from ..analysis import extract_dictionary
        from ..models.targets import load_program_from_options

        prog = load_program_from_options(
            self.options, "dictionary auto-extraction needs a "
                          "'target' or 'program_file' option")
        toks = extract_dictionary(prog)
        if not toks:
            raise ValueError(
                f"static analysis of {prog.name!r} extracted no "
                f"branch-comparison constants; supply tokens")
        return toks

    def get_total_iteration_count(self) -> int:
        return mc.dictionary_total(self.seed_len, len(self.token_lens))

    def _generate(self, its):
        return mc.dictionary_at(self._seed_on_device(), self.seed_len,
                                self._its_on_device(its), *self._tokens_on)
