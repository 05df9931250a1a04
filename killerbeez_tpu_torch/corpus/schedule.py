"""Pluggable seed-scheduling policies for the fuzzing loop.

Extracted from ``Fuzzer._rotate_seed`` / ``_credit_period``: the loop
owns WHEN to rotate (cadence, pipeline safety, shape-stable seed
swaps); the scheduler owns WHICH seed the next period fuzzes.  Angora
frames search strategy as a swappable policy and FairFuzz shows the
choice dominates coverage growth (PAPERS.md) — so the policy is an
interface, not a hard-coded heuristic:

  * ``bandit``    — the default: greedy optimistic bandit with
    per-period decay, an exact port of the in-loop behavior it
    replaces (same arm scores, same tie-breaks, same splice RNG
    stream — ``--schedule bandit`` reproduces the old rotation
    decisions bit-for-bit on a fixed seed).
  * ``rr``        — round-robin over base + arms, the baseline
    ``bench.py --schedule`` compares against.

Arms are ``Arm`` objects — ``list`` subclasses holding the loop's
historical ``[buf, selections, finds]`` triple (credit pointers keep
working across cap evictions exactly as before) plus the store
metadata (md5, signature, lineage) the persistence tier needs.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Tuple

from .store import CorpusEntry, coverage_hash
from ..utils.fileio import md5_hex


class Arm(list):
    """One rotation arm: ``[buf, selections, finds]`` (the loop's
    historical shape — credits write through indices 1/2) plus store
    metadata as attributes."""

    __slots__ = ("md5", "seq", "sig", "state_sig", "parent",
                 "source", "discovered", "provenance", "tier",
                 "validation")

    def __init__(self, buf: bytes, selections: float = 0.0,
                 finds: float = 0.0, md5: Optional[str] = None,
                 seq: int = 0, sig: Optional[List[int]] = None,
                 parent: Optional[str] = None, source: str = "local",
                 discovered: Optional[float] = None,
                 state_sig: Optional[List] = None,
                 provenance=None, tier: Optional[str] = None,
                 validation=None):
        super().__init__([bytes(buf), selections, finds])
        self.md5 = md5 or md5_hex(buf)
        self.seq = int(seq)
        self.sig = sorted(set(int(s) for s in sig)) if sig else None
        self.state_sig = state_sig
        self.parent = parent
        #: mutation provenance (learn tier): set at admission, rides
        #: into the entry sidecar
        self.provenance = provenance
        #: hybrid campaign tags: minting tier + cross-tier verdict
        #: (docs/HYBRID.md) — ride into/out of the entry sidecar
        self.tier = tier
        self.validation = validation
        self.source = source
        self.discovered = discovered

    @property
    def buf(self) -> bytes:
        return self[0]

    @property
    def cov_hash(self) -> str:
        return coverage_hash(self.sig, self[0], self.state_sig)

    def to_entry(self) -> CorpusEntry:
        return CorpusEntry(
            self[0], md5=self.md5, seq=self.seq, sig=self.sig,
            edge_hits=None, selections=float(self[1]),
            finds=float(self[2]), parent=self.parent,
            source=self.source, discovered=self.discovered,
            state_sig=self.state_sig, provenance=self.provenance,
            tier=self.tier, validation=self.validation)

    @classmethod
    def from_entry(cls, e: CorpusEntry) -> "Arm":
        return cls(e.buf, selections=e.selections, finds=e.finds,
                   md5=e.md5, seq=e.seq, sig=e.sig, parent=e.parent,
                   source=e.source, discovered=e.discovered,
                   state_sig=e.state_sig,
                   provenance=getattr(e, "provenance", None),
                   tier=getattr(e, "tier", None),
                   validation=getattr(e, "validation", None))


class Scheduler:
    """Seed-scheduling policy: owns the arm list, the base-seed stats
    and the per-period credit fold; ``select()`` names the next
    period's seed.  The loop calls, in order per feedback period:
    ``credit_find`` per edge-novel finding (to the GENERATING arm),
    ``admit`` per finding entering rotation, ``credit_period`` at the
    boundary, then ``select``."""

    name = "base"

    #: rotation keeps at most this many arms (oldest evicted; the
    #: loop's historical CORPUS_CAP)
    CAP = 256

    #: per-period decay of arm stats (bandit scoring; kept for every
    #: policy so observability and resume see comparable stats)
    DECAY = 0.8

    def __init__(self, cap: Optional[int] = None):
        self.arms: List[Arm] = []
        self.base_stats: List[float] = [0.0, 0.0]  # [selections, finds]
        self.base_seed: Optional[bytes] = None
        self.rotations = 0
        #: md5s whose findings the JAX package's native tier confirmed
        #: (its hybrid bridge, not ported): carried through the
        #: checkpoint so a resumed hybrid campaign keeps them
        self.confirmed_md5s: set = set()
        if cap is not None:
            self.CAP = int(cap)
        # deterministic splice/choice stream — the loop's historical
        # seed, so the default policy replays old campaigns exactly
        self.rng = random.Random(0x6b62)
        self._seq = 0

    # -- corpus membership ---------------------------------------------

    def admit(self, arm: Arm) -> Optional[Arm]:
        """Add an arm; returns the evicted oldest arm when over cap
        (the eviction only drops it from ROTATION — the store keeps
        the entry on disk)."""
        arm.seq = max(arm.seq, self._seq)
        self._seq = arm.seq + 1
        self.arms.append(arm)
        if len(self.arms) > self.CAP:
            return self.arms.pop(0)
        return None

    def drop(self, index: int) -> Arm:
        """Remove an arm that cannot be scheduled (e.g. wider than the
        candidate buffer)."""
        return self.arms.pop(index)

    # -- credit fold (shared by every policy) ---------------------------

    def credit_find(self, arm: Optional[list]) -> None:
        """One edge-novel find, credited to the arm whose candidates
        produced it (None = the base seed).  A capped-out arm's entry
        may already be off the list — the credit is then a harmless
        write to a dead object, exactly as before the extraction."""
        if arm is None:
            self.base_stats[1] += 1
        else:
            arm[2] += 1

    def credit_period(self, active: Optional[list],
                      period: int = 1) -> None:
        """Close one feedback period: decay every arm's stats and
        charge the period's selection to the arm that generated it.

        ``DECAY`` is the PER-BATCH forgetting rate; ``period`` is how
        many batches this period spanned (the loop's -fb cadence), so
        the compounded ``DECAY ** period`` keeps an arm's stats
        half-life a fixed number of EXECUTIONS regardless of how
        often rotation fires — at the default cadence of 8 this is
        0.8^8 ~ 0.17 per call, intentionally much stronger than a
        flat 0.8-per-period would be, not an accidental 9x change.
        ``min(..., 16)`` only floors the factor (0.8^16 ~ 0.03) so
        extreme cadences don't flush history to zero in one call."""
        g = self.DECAY ** min(period or 1, 16)
        self.base_stats[0] *= g
        self.base_stats[1] *= g
        for e in self.arms:
            e[1] *= g
            e[2] *= g
        if active is None:
            self.base_stats[0] += 1
        else:
            active[1] += 1

    # -- selection ------------------------------------------------------

    def select(self) -> Tuple[Optional[int], Optional[bytes]]:
        """(arm index or None for the base seed, candidate bytes).
        ``(None, None)`` means nothing schedulable (no base, no arms).
        The candidate may differ from the arm's buffer (splice)."""
        raise NotImplementedError

    def favored_count(self) -> int:
        """How many arms the policy currently considers frontier
        (the ``corpus_favored`` gauge)."""
        return len(self.arms)

    # -- persistence ----------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        st = self.rng.getstate()
        d = {
            "scheduler": self.name,
            "base_stats": list(self.base_stats),
            "rotations": self.rotations,
            "rng_state": [st[0], list(st[1]), st[2]],
            "seq": self._seq,
        }
        # only hybrid campaigns carry verdict state — pre-hybrid
        # checkpoints stay byte-identical in shape
        if self.confirmed_md5s:
            d["confirmed"] = sorted(self.confirmed_md5s)
        return d

    def load_state(self, d: Dict[str, Any]) -> None:
        self.base_stats = [float(v) for v in
                           d.get("base_stats", [0.0, 0.0])]
        self.rotations = int(d.get("rotations", 0))
        self._seq = int(d.get("seq", self._seq))
        self.confirmed_md5s = set(
            str(m) for m in d.get("confirmed", []))
        rs = d.get("rng_state")
        if rs:
            self.rng.setstate((rs[0], tuple(rs[1]), rs[2]))

    def load_entries(self, entries: List[CorpusEntry]) -> None:
        """Rebuild the arm list from stored entries (resume): entries
        in admission order, rotation keeps the newest CAP of them —
        exactly what a continuously-running loop would hold."""
        for e in sorted(entries, key=lambda e: e.seq):
            self.admit(Arm.from_entry(e))


class BanditScheduler(Scheduler):
    """Greedy optimistic decay bandit — the loop's historical policy,
    ported verbatim.  Each arm scores ``(finds+1)/(selections+1)``
    (unexplored arms score 1.0 — every new frontier probed once),
    ties break toward the NEWEST discovery, and when two or more
    findings exist half the corpus-arm turns fuzz an AFL-style splice
    of the arm with a random partner (crossover inside the differing
    region so magic bytes / headers survive)."""

    name = "bandit"

    def select(self) -> Tuple[Optional[int], Optional[bytes]]:
        best, best_score = None, 0.0
        if self.base_seed is not None:
            best_score = ((self.base_stats[1] + 1.0)
                          / (self.base_stats[0] + 1.0))
        for i, (buf, sel, finds) in enumerate(self.arms):
            score = (finds + 1.0) / (sel + 1.0)
            if score >= best_score:     # >= : newest wins ties
                best, best_score = i, score
        if best is None:
            return None, self.base_seed
        cand = self.arms[best][0]
        if len(self.arms) >= 2 and self.rng.random() < 0.5:
            partner = self.rng.choice(
                [e[0] for j, e in enumerate(self.arms) if j != best])
            # AFL-style splice (afl locate_diffs semantics): cross
            # over INSIDE the differing region so the common prefix
            # — magic bytes, headers — survives
            n = min(len(cand), len(partner))
            fd = next((i for i in range(n)
                       if cand[i] != partner[i]), None)
            if fd is not None:
                ld = next(i for i in range(n - 1, -1, -1)
                          if cand[i] != partner[i])
                if ld > fd + 1:
                    k = self.rng.randrange(fd + 1, ld)
                    cand = cand[:k] + partner[k:]
        return best, cand

    def favored_count(self) -> int:
        """Arms whose score matches or beats the base seed's — the
        frontier the greedy choice draws from."""
        base = ((self.base_stats[1] + 1.0)
                / (self.base_stats[0] + 1.0)) \
            if self.base_seed is not None else 0.0
        return sum(1 for _, sel, finds in self.arms
                   if (finds + 1.0) / (sel + 1.0) >= base)


class RoundRobinScheduler(Scheduler):
    """Round-robin over the base seed plus every arm, in admission
    order — the uniform-budget baseline coverage-guided policies are
    measured against (``bench.py --schedule``)."""

    name = "rr"

    def __init__(self, cap: Optional[int] = None):
        super().__init__(cap)
        self._cursor = 0

    def select(self) -> Tuple[Optional[int], Optional[bytes]]:
        slots = (1 if self.base_seed is not None else 0) + len(self.arms)
        if slots == 0:
            return None, None
        pos = self._cursor % slots
        self._cursor += 1
        if self.base_seed is not None:
            if pos == 0:
                return None, self.base_seed
            pos -= 1
        return pos, self.arms[pos][0]

    def state_dict(self) -> Dict[str, Any]:
        d = super().state_dict()
        d["cursor"] = self._cursor
        return d

    def load_state(self, d: Dict[str, Any]) -> None:
        super().load_state(d)
        self._cursor = int(d.get("cursor", 0))


SCHEDULERS = {
    "bandit": BanditScheduler,
    "rr": RoundRobinScheduler,
}


def make_scheduler(name: str, cap: Optional[int] = None) -> Scheduler:
    try:
        cls = SCHEDULERS[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r} (choose from "
            f"{', '.join(sorted(SCHEDULERS))})")
    return cls(cap)
