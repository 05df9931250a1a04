"""Mutator base class — the reference's mutator vtable, batch-first.

API parity (reference docs/api/api_mutator.tex): mutate /
get_state / set_state / get_current_iteration /
get_total_iteration_count / get_input_info / set_input / help.
``mutate`` returns the mutated buffer or ``None`` when the walk is
exhausted.

``mutate_batch(n)`` generates candidates for iterations
``[it, it+n)`` in one device call as ``(uint8[n, L], int32[n])``
tensors on the mutator's device; ``mutate`` is the n==1 case.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..utils.options import format_help, parse_options
from ..utils.serialization import b64, unb64


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class Mutator:
    """Base mutator. Subclasses set ``name``, ``OPTION_SCHEMA``,
    ``OPTION_DESCS`` and implement ``_generate(its) -> (bufs, lens)``
    over absolute iteration indices."""

    name = "base"
    OPTION_SCHEMA: Dict[str, type] = {}
    OPTION_DESCS: Dict[str, str] = {}
    DEFAULTS: Dict[str, Any] = {}

    #: extra schema shared by every mutator
    _COMMON_SCHEMA = {"ratio": float, "seed": int}
    _COMMON_DESCS = {
        "ratio": "output buffer size as a multiple of the seed size "
                 "(reference setup_mutate_buffer semantics; default 2.0)",
        "seed": "PRNG seed for randomized mutators (default 0)",
    }
    _COMMON_DEFAULTS = {"ratio": 2.0, "seed": 0}

    def __init__(self, options: Optional[str], input_bytes: bytes,
                 device="cuda"):
        schema = {**self.OPTION_SCHEMA, **self._COMMON_SCHEMA}
        defaults = {**self._COMMON_DEFAULTS, **self.DEFAULTS}
        self.options = parse_options(options, schema, defaults)
        self.device = resolve_device(device)
        self.iteration = 0
        self._set_seed_buffer(bytes(input_bytes))

    # -- seed management ------------------------------------------------

    def _set_seed_buffer(self, input_bytes: bytes,
                         keep_length: bool = False) -> None:
        if len(input_bytes) == 0:
            raise ValueError(f"{self.name}: empty seed input")
        if keep_length:
            # corpus-feedback rotation: the candidate width L is part
            # of every kernel launch's shape (and picks the kernels'
            # shared-memory plan) — a seed swap keeps it
            if len(input_bytes) > self.max_length:
                raise ValueError(
                    f"{self.name}: seed ({len(input_bytes)}) exceeds "
                    f"the fixed buffer ({self.max_length})")
        else:
            ratio = float(self.options.get("ratio", 2.0))
            L = max(int(np.ceil(len(input_bytes) * max(ratio, 1.0))), 8)
            self.max_length = _round_up(L, 8)  # word-aligned maps
        buf = np.zeros(self.max_length, dtype=np.uint8)
        buf[:len(input_bytes)] = np.frombuffer(input_bytes, dtype=np.uint8)
        # assigned only after validation: a rejected keep_length swap
        # must not leave seed_bytes describing a seed the buffers
        # don't (state dumps would serialize the wrong walk)
        self.seed_bytes = input_bytes
        self.seed_buf = buf
        self.seed_len = len(input_bytes)

    def set_input(self, input_bytes: bytes,
                  keep_length: bool = False) -> None:
        """Swap the seed (reference set_input); resets the walk
        position.  ``keep_length`` keeps the candidate buffer width
        (raises ValueError if the new seed does not fit)."""
        self._set_seed_buffer(bytes(input_bytes), keep_length)
        self.iteration = 0

    #: focus byte masks (the crack stage / learn tier) are not ported
    focus_positions = None

    def set_focus_mask(self, positions, pad_pow2: bool = False) -> None:
        raise NotImplementedError("focused mutation (set_focus_mask) is "
                                  "not ported yet")

    # -- iteration bookkeeping -----------------------------------------

    def get_current_iteration(self) -> int:
        return self.iteration

    def get_total_iteration_count(self) -> int:
        """-1 = infinite (randomized mutators never exhaust)."""
        return -1

    def remaining(self) -> int:
        total = self.get_total_iteration_count()
        if total < 0:
            return 2**62
        return max(total - self.iteration, 0)

    # -- generation -----------------------------------------------------

    def _generate(self, its: np.ndarray) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        """Produce candidates for absolute iteration indices ``its``.
        Returns (uint8[n, L], int32[n]) on the mutator's device."""
        raise NotImplementedError

    batch_capable = True

    def peek_iterations(self, n: int) -> np.ndarray:
        """The next ``n`` absolute iteration indices WITHOUT advancing
        (fused paths generate these lanes themselves and call
        ``advance(n)``)."""
        if n <= 0:
            raise ValueError("batch size must be positive")
        if self.remaining() < n:
            raise ValueError(
                f"{self.name}: only {self.remaining()} iterations left, "
                f"requested {n}")
        return np.arange(self.iteration, self.iteration + n,
                         dtype=np.int64)

    def advance(self, n: int) -> None:
        self.iteration += n

    def mutate_batch(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Generate the next ``n`` candidates and advance the walk."""
        its = self.peek_iterations(n)
        bufs, lens = self._generate(its)
        self.iteration += n
        return bufs.to(torch.uint8), lens.to(torch.int32)

    def mutate(self, max_size: Optional[int] = None) -> Optional[bytes]:
        """Single-buffer API: next candidate, or None when exhausted."""
        if self.remaining() == 0:
            return None
        bufs, lens = self.mutate_batch(1)
        out = bufs[0, :int(lens[0])].cpu().numpy().tobytes()
        if max_size is not None:
            out = out[:max_size]
        return out

    def get_input_info(self) -> Tuple[int, List[int]]:
        """(num_inputs, per-input sizes) — single-input."""
        return 1, [self.max_length]

    # -- state ----------------------------------------------------------

    def _state_dict(self) -> Dict[str, Any]:
        return {
            "mutator": self.name,
            "iteration": self.iteration,
            "seed": b64(self.seed_bytes),
        }

    def get_state(self) -> str:
        return json.dumps(self._state_dict())

    def set_state(self, state: str) -> None:
        d = json.loads(state)
        if d.get("mutator") not in (None, self.name):
            raise ValueError(
                f"state is for mutator {d['mutator']!r}, not {self.name!r}")
        if "seed" in d:
            self._set_seed_buffer(unb64(d["seed"]))
        self.iteration = int(d.get("iteration", 0))

    def cleanup(self) -> None:
        pass

    @classmethod
    def help(cls) -> str:
        schema = {**cls.OPTION_SCHEMA, **cls._COMMON_SCHEMA}
        descs = {**cls.OPTION_DESCS, **cls._COMMON_DESCS}
        head = f"{cls.name} mutator"
        doc = (cls.__doc__ or "").strip().splitlines()
        if doc:
            head += f" — {doc[0]}"
        return head + "\n" + format_help(cls.name, schema, descs)
