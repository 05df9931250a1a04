"""The `manager` mutator: composes child mutators over a multi-part
input (reference tests/test-fuzzer.sh:220-228 `{"mutators":
["bit_flip","bit_flip"]}`; api_mutator.tex:179-196 get_input_info).

A multi-part seed (e.g. a sequence of network packets) is split into
parts; child mutator i owns part i. ``mutate`` advances one child per
call round-robin (the others replay their current part), and
``mutate_extended(MUTATE_MULTIPLE_INPUTS | i)`` returns part i of the
current composite candidate — exactly the contract the network
drivers consume.  The children live on the manager's device; the
composites are put together on the host and uploaded once per batch.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..utils.serialization import b64, unb64, decode_mem_array
from .base import (
    MUTATE_INDEX_MASK, MUTATE_MULTIPLE_INPUTS, Mutator, pack_byte_rows,
)


class ManagerMutator(Mutator):
    """Composes child mutators, one per input part.

    With ``{"framed": 1}`` the composite candidate is a FRAMED
    message sequence (stateful/framing.py) instead of a bare
    concatenation: message boundaries ride in the frame header, so
    per-message mutation can never corrupt them — the structure-aware
    mutation mode of the stateful session tier.  The seed may then be
    either the usual mem-array encoding or an already-framed buffer
    (kb-frame output): framed seeds split back into their messages."""
    name = "manager"
    lazy_batches = False     # candidates made on the host
    OPTION_SCHEMA = {"mutators": list, "mutator_options": list,
                     "framed": int, "m_max": int}
    OPTION_DESCS = {
        "mutators": 'child mutator names, e.g. ["bit_flip","havoc"]',
        "mutator_options": "per-child JSON option objects (optional)",
        "framed": "1 = compose candidates as framed message "
                  "sequences (stateful session tier; boundaries "
                  "survive any child mutation by construction)",
        "m_max": "framed: the sequence capacity (must match the "
                 "target's StatefulSpec; default 4)",
    }
    DEFAULTS = {"framed": 0, "m_max": 4}

    def __init__(self, options, input_bytes, device="cuda"):
        # input_bytes: either an encoded mem array (JSON list of b64
        # parts) or raw bytes treated as one part
        from .factory import mutator_factory  # local import: cycle
        self._factory = mutator_factory
        super().__init__(options, input_bytes, device=device)
        names = self.options.get("mutators")
        if not names:
            raise ValueError('manager mutator needs {"mutators": [...]}')
        child_opts = self.options.get("mutator_options") or [None] * len(names)
        if len(child_opts) != len(names):
            raise ValueError("mutator_options length != mutators length")
        if len(self.parts) != len(names):
            raise ValueError(
                f"seed has {len(self.parts)} parts but {len(names)} "
                "child mutators were configured")
        self.children: List[Mutator] = []
        for name, opts, part in zip(names, child_opts, self.parts):
            o = json.dumps(opts) if isinstance(opts, dict) else opts
            self.children.append(self._factory(name, o, part,
                                               device=self.device))
        self.current: List[bytes] = list(self.parts)
        self._next_child = 0

    # -- seed handling: parts ------------------------------------------

    def _set_seed_buffer(self, input_bytes: bytes,
                         keep_length: bool = False) -> None:
        # keep_length is meaningless for multi-part seeds (each child
        # sizes its own part buffer); accepted for vtable parity
        try:
            parts = decode_mem_array(input_bytes.decode("ascii"))
            assert isinstance(parts, list) and parts
        except Exception:
            if self.options.get("framed"):
                # framed mode accepts a kb-frame sequence directly:
                # the framing parse is total, so any buffer splits
                from ..stateful.framing import unframe
                # the framing parse is total: always >= 1 message
                parts = [p or b"\x00"      # children reject empties
                         for p in unframe(
                             input_bytes,
                             int(self.options.get("m_max", 4)))]
            else:
                parts = [input_bytes]
        self.parts = [bytes(p) for p in parts]
        self.seed_bytes = input_bytes
        self.seed_len = len(input_bytes)
        self.max_length = max(len(p) for p in self.parts)

    def _compose(self, parts) -> bytes:
        """Parts -> one candidate buffer: framed sequence when the
        framed option is on (boundaries in the header, clipped to
        the strict frame bounds), bare concatenation otherwise."""
        if self.options.get("framed"):
            from ..stateful.framing import MAX_MSG_LEN, frame_messages
            m_max = int(self.options.get("m_max", 4))
            clipped = [bytes(p[:MAX_MSG_LEN])
                       for p in parts[:m_max]] or [b""]
            return frame_messages(clipped, m_max)
        return b"".join(parts)

    # -- iteration ------------------------------------------------------

    def get_total_iteration_count(self) -> int:
        totals = [c.get_total_iteration_count() for c in self.children]
        if any(t < 0 for t in totals):
            return -1
        return sum(totals)

    def remaining(self) -> int:
        rems = [c.remaining() for c in self.children]
        return sum(rems)

    def mutate(self, max_size: Optional[int] = None) -> Optional[bytes]:
        """Advance one child (round-robin over non-exhausted children),
        return the concatenated composite candidate."""
        n = len(self.children)
        for probe in range(n):
            i = (self._next_child + probe) % n
            child = self.children[i]
            if child.remaining() > 0:
                out = child.mutate()
                if out is not None:
                    self.current[i] = out
                    self._next_child = (i + 1) % n
                    self.iteration += 1
                    whole = self._compose(self.current)
                    return whole[:max_size] if max_size else whole
        return None  # all children exhausted

    def mutate_extended(self, flags: int = 0,
                        max_size: Optional[int] = None) -> Optional[bytes]:
        if flags & MUTATE_MULTIPLE_INPUTS:
            part = flags & MUTATE_INDEX_MASK
            if not (0 <= part < len(self.children)):
                raise ValueError(f"part index {part} out of range")
            if part == 0:
                # advancing happens when part 0 is requested; parts > 0
                # replay the same composite (network drivers iterate
                # parts 0..N-1 per candidate)
                if self.mutate() is None:
                    return None
            out = self.current[part]
            return out[:max_size] if max_size else out
        return self.mutate(max_size)

    def mutate_batch_parts(self, n: int) -> List[List[bytes]]:
        """``n`` composite candidates as per-part byte lists, advancing
        children round-robin exactly like ``n`` sequential mutate()
        calls — but each child generates ALL its turns in one batched
        call (its device path), recomposed on host.  Packet drivers
        consume this form directly (one list = one packet sequence)."""
        if n <= 0:
            raise ValueError("batch size must be positive")
        if self.remaining() < n:
            raise ValueError(
                f"{self.name}: only {self.remaining()} iterations "
                f"left, requested {n}")
        nc = len(self.children)
        rem = [c.remaining() for c in self.children]
        nxt = self._next_child
        turns: List[int] = []
        for _ in range(n):
            for probe in range(nc):
                i = (nxt + probe) % nc
                if rem[i] > 0:
                    turns.append(i)
                    rem[i] -= 1
                    nxt = (i + 1) % nc
                    break
        counts = [turns.count(i) for i in range(nc)]
        child_out: Dict[int, List[bytes]] = {}
        for i, child in enumerate(self.children):
            if counts[i]:
                bufs, lens = child.mutate_batch(counts[i])
                bufs, lens = bufs.cpu().numpy(), lens.cpu().numpy()
                child_out[i] = [bufs[j, :int(lens[j])].tobytes()
                                for j in range(counts[i])]
        used = [0] * nc
        cur = list(self.current)
        out: List[List[bytes]] = []
        for i in turns:
            cur[i] = child_out[i][used[i]]
            used[i] += 1
            out.append(list(cur))
        self.current = cur
        self._next_child = nxt
        self.iteration += n
        return out

    def mutate_batch(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Composite form of mutate_batch_parts (matches ``mutate``'s
        return shape for single-buffer consumers; framed sequences
        when the framed option is on), on the manager's device."""
        parts = self.mutate_batch_parts(n)
        bufs, lens = pack_byte_rows([self._compose(p) for p in parts])
        return self._upload(bufs), self._upload(lens)

    def get_input_info(self) -> Tuple[int, List[int]]:
        if self.options.get("framed"):
            # framed mode: the composite IS one input (the sequence
            # travels as a single framed buffer — what single-input
            # drivers like `file` consume; parts are internal
            # structure, not separate driver inputs)
            return 1, [len(self._compose(self.current))]
        return len(self.children), [len(p) for p in self.current]

    # -- state ----------------------------------------------------------

    def _state_dict(self) -> Dict[str, Any]:
        return {
            "mutator": self.name,
            "iteration": self.iteration,
            "next_child": self._next_child,
            "current": [b64(p) for p in self.current],
            "children": [c.get_state() for c in self.children],
        }

    def set_state(self, state: str) -> None:
        d = json.loads(state)
        if d.get("mutator") not in (None, self.name):
            raise ValueError(f"state is for {d.get('mutator')!r}")
        self.iteration = int(d.get("iteration", 0))
        self._next_child = int(d.get("next_child", 0))
        if "current" in d:
            self.current = [unb64(p) for p in d["current"]]
        for child, cs in zip(self.children, d.get("children", [])):
            child.set_state(cs)

    def cleanup(self) -> None:
        for c in self.children:
            c.cleanup()
