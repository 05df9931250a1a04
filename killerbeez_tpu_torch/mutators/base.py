"""Mutator base class — the reference's mutator vtable, batch-first.

API parity (reference docs/api/api_mutator.tex): mutate /
get_state / set_state / get_current_iteration /
get_total_iteration_count / get_input_info / set_input / help.
``mutate`` returns the mutated buffer or ``None`` when the walk is
exhausted.

``mutate_batch(n)`` generates candidates for iterations
``[it, it+n)`` in one device call as ``(uint8[n, L], int32[n])``
tensors on the mutator's device; ``mutate`` is the n==1 case.  The
seed is uploaded once per ``set_input`` and the iteration numbers are
made on the device, so a batch copies nothing from the host.

Host-executed targets take the candidates on the host:
``mutate_batch_host(n)`` gives numpy arrays, and ``prefetch_batch(n)``
generates the next ``n`` ahead, starting their copies to the host
while the current batch's target processes run.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.host_copy import HostCopy
from ..utils.options import format_help, parse_options
from ..utils.serialization import b64, unb64


# mutate_extended flags (reference api_mutator.tex:89-119)
MUTATE_THREAD_SAFE = 1 << 30
MUTATE_MULTIPLE_INPUTS = 1 << 31
MUTATE_INDEX_MASK = 0x00FFFFFF


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pack_byte_rows(rows: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Pack variable-length byte strings into the framework's batch
    shape: (uint8[n, L] zero-padded, int32[n] lengths), L rounded up
    to 8 with a floor of 8 (the shared candidate-tensor convention)."""
    max_len = max((len(r) for r in rows), default=1)
    L = max(8, _round_up(max_len, 8))
    bufs = np.zeros((len(rows), L), dtype=np.uint8)
    lens = np.zeros((len(rows),), dtype=np.int32)
    for i, r in enumerate(rows):
        bufs[i, :len(r)] = np.frombuffer(r, dtype=np.uint8)
        lens[i] = len(r)
    return bufs, lens


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
        self._stash = None  # prefetched candidates used the old seed

    def set_input(self, input_bytes: bytes,
                  keep_length: bool = False) -> None:
        """Swap the seed (reference set_input); resets the walk
        position.  ``keep_length`` keeps the candidate buffer width
        (raises ValueError if the new seed does not fit)."""
        self._set_seed_buffer(bytes(input_bytes), keep_length)
        self.iteration = 0

    _seed_cache = None

    def _seed_on_device(self) -> torch.Tensor:
        """``seed_buf`` on the mutator's device, copied once per seed
        buffer (each ``set_input`` and each corpus-feedback rotation
        makes a new one)."""
        if self._seed_cache is None or \
                self._seed_cache[0] is not self.seed_buf:
            self._seed_cache = (self.seed_buf, self._upload(self.seed_buf))
        return self._seed_cache[1]

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of ``arr`` on the device that never waits for it: a
        copy from pageable memory would wait for every batch already
        queued, so the bytes go through a fresh pinned staging tensor
        with a non-blocking copy on the kernels' stream, ordered after
        the batches that still read the old data.  The staging tensor
        can go at once: PyTorch's pinned-memory allocator records an
        event for the copy and reuses the block only once it has
        completed."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    @staticmethod
    def _run_start(its: np.ndarray) -> int:
        """The first of ``its``, which must be a run of consecutive
        iteration numbers (what ``peek_iterations`` gives)."""
        start = int(its[0])
        if not np.array_equal(its, np.arange(start, start + len(its))):
            raise ValueError("iterations must be a consecutive run")
        return start

    def _its_on_device(self, its: np.ndarray) -> torch.Tensor:
        """Absolute iteration numbers (a consecutive run) as an int64
        tensor on the device, made there from the first, copying
        nothing from the host."""
        start = self._run_start(its)
        return torch.arange(start, start + len(its), dtype=torch.int64,
                            device=self.device)

    # -- focused mutation (Angora-style byte masks) ---------------------

    #: optional int32[P] byte positions mutation should concentrate
    #: on (the frontier-dependency mask from the static layer); None
    #: = unfocused.  Mutators that can honor it do (havoc, zzuf, the
    #: afl havoc tail); deterministic walks ignore it — their
    #: iteration contract is position-exhaustive by definition.
    focus_positions = None
    #: the installed mask on the device (``_focus_on_device``)
    _focus_dev = None

    def set_focus_mask(self, positions, pad_pow2: bool = False
                       ) -> None:
        """Install (or clear, with None/empty) the focus byte mask.
        Positions beyond the candidate buffer are dropped; an empty
        surviving set clears the mask — a mask must never silently
        pin mutation to nothing.

        ``pad_pow2`` cycles the surviving set up to the next
        power-of-two length (the JAX package's focused kernels
        specialize on the position-array shape; the padded set is
        kept here so both packages draw from the same array).
        Repeats only skew the uniform pick WITHIN the mask (still a
        masked position)."""
        if positions is not None:
            positions = sorted({int(p) for p in positions
                                if 0 <= int(p) < self.max_length})
        if not positions:
            self.focus_positions = None
        else:
            if pad_pow2:
                want = 1 << (len(positions) - 1).bit_length()
                positions = (positions * ((want + len(positions) - 1)
                                          // len(positions)))[:want]
            self.focus_positions = np.asarray(positions, dtype=np.int32)
        self._stash = None  # prefetched candidates used the old mask
        self._focus_dev = None

    def _focus_on_device(self) -> torch.Tensor:
        """The focus mask as an int64 tensor on the mutator's device,
        copied once per installed mask (a pageable copy per batch
        would wait for the card)."""
        if self._focus_dev is None:
            self._focus_dev = torch.as_tensor(
                self.focus_positions, dtype=torch.int64, device=self.device)
        return self._focus_dev

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

    #: (start_iteration, n, bufs, lens, host copies) generated ahead
    _stash = None
    #: True when _generate makes the candidates on the device, so that
    #: generating them ahead overlaps their host copies with other
    #: work; mutators that make them on the host set it False
    lazy_batches = True

    def prefetch_batch(self, n: int) -> None:
        """Generate the next ``n`` candidates now and start their
        copies to the host, without advancing the walk: host-executed
        drivers call this before a batch's target processes run, so
        the next ``mutate_batch_host(n)`` waits only on a copy that
        has landed.  A seed swap drops the stash."""
        if self.remaining() < n or not self.batch_capable \
                or not self.lazy_batches:
            return
        its = self.peek_iterations(n)
        bufs, lens = self._generate(its)
        bufs, lens = bufs.to(torch.uint8), lens.to(torch.int32)
        self._stash = (int(its[0]), n, bufs, lens,
                       (HostCopy(bufs), HostCopy(lens)))

    def _take_stash(self, n: int):
        """The stash if it holds the next ``n`` candidates (the walk
        advances past them), else None; either way the stash is
        dropped."""
        stash, self._stash = self._stash, None
        if stash is None or stash[0] != self.iteration or stash[1] != n:
            return None
        self.iteration += n
        return stash

    def mutate_batch(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Generate the next ``n`` candidates and advance the walk."""
        stash = self._take_stash(n)
        if stash is not None:
            return stash[2], stash[3]
        its = self.peek_iterations(n)
        bufs, lens = self._generate(its)
        self.iteration += n
        return bufs.to(torch.uint8), lens.to(torch.int32)

    def mutate_batch_host(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """``mutate_batch`` as numpy arrays (uint8[n, L], int32[n]) for
        host-executed targets: the prefetched host copies when the
        stash holds these candidates (one wait, on their event), else
        a fresh batch copied at once."""
        stash = self._take_stash(n)
        if stash is not None:
            copies = stash[4]
        else:
            copies = tuple(HostCopy(t) for t in self.mutate_batch(n))
        return tuple(c.materialize() for c in copies)

    def mutate(self, max_size: Optional[int] = None) -> Optional[bytes]:
        """Single-buffer API: next candidate, or None when exhausted."""
        if self.remaining() == 0:
            return None
        bufs, lens = self.mutate_batch(1)
        out = bufs[0, :int(lens[0])].cpu().numpy().tobytes()
        if max_size is not None:
            out = out[:max_size]
        return out

    def mutate_extended(self, flags: int = 0,
                        max_size: Optional[int] = None) -> Optional[bytes]:
        """Flagged mutate (reference api_mutator.tex:89-119).
        MUTATE_MULTIPLE_INPUTS selects a part on multipart mutators;
        single-input mutators accept only part 0."""
        if flags & MUTATE_MULTIPLE_INPUTS:
            part = flags & MUTATE_INDEX_MASK
            if part != 0:
                raise ValueError(
                    f"{self.name}: single-input mutator, part {part} invalid")
        return self.mutate(max_size)

    def get_input_info(self) -> Tuple[int, List[int]]:
        """(num_inputs, per-input sizes) — single-input by default."""
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
