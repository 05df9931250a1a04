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
  * ``rare-edge`` — FairFuzz-style: prefer arms whose coverage
    signature contains the globally rarest edges (hit by the fewest
    corpus entries), probing unsigned arms once.
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

    #: find-equivalent credit for a native-confirmed verdict (hybrid
    #: bridge): ground truth on the real binary is worth a full find
    CONFIRM_CREDIT = 1.0

    #: cap on the remembered confirmed-md5 set (enough for any real
    #: campaign; bounds resume state)
    CONFIRM_CAP = 4096

    def __init__(self, cap: Optional[int] = None):
        self.arms: List[Arm] = []
        self.base_stats: List[float] = [0.0, 0.0]  # [selections, finds]
        self.base_seed: Optional[bytes] = None
        self.rotations = 0
        #: md5s whose findings the native tier confirmed on the real
        #: binary (hybrid bridge write-back, ``note_validation``) — the
        #: cross-tier credit boost keys off membership here; carried
        #: through the checkpoint so a resumed hybrid campaign keeps them
        self.confirmed_md5s: set = set()
        if cap is not None:
            self.CAP = int(cap)
        # deterministic splice/choice stream — the loop's historical
        # seed, so the default policy replays old campaigns exactly
        self.rng = random.Random(0x6b62)
        self._seq = 0
        # md5 -> how many arms in rotation carry it, kept in step with
        # every change to ``arms`` (admit, its cap eviction, drop)
        self._md5s: Dict[str, int] = {}

    def _count(self, arm: Arm, k: int) -> None:
        n = self._md5s.get(arm.md5, 0) + k
        if n > 0:
            self._md5s[arm.md5] = n
        else:
            self._md5s.pop(arm.md5, None)

    # -- corpus membership ---------------------------------------------

    def admit(self, arm: Arm) -> Optional[Arm]:
        """Add an arm; returns the evicted oldest arm when over cap
        (the eviction only drops it from ROTATION — the store keeps
        the entry on disk)."""
        arm.seq = max(arm.seq, self._seq)
        self._seq = arm.seq + 1
        self.arms.append(arm)
        self._count(arm, 1)
        if len(self.arms) > self.CAP:
            return self.drop(0)
        return None

    def drop(self, index: int) -> Arm:
        """Remove an arm that cannot be scheduled (e.g. wider than the
        candidate buffer)."""
        arm = self.arms.pop(index)
        self._count(arm, -1)
        return arm

    def holds(self, md5: str) -> bool:
        """Whether an arm in rotation carries this md5 — a set lookup,
        not a scan of the arms.  An arm evicted past ``CAP`` or dropped
        no longer counts, so it can be admitted again."""
        return md5 in self._md5s

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

    def note_validation(self, md5: str, verdict: str,
                        parent: Optional[str] = None) -> None:
        """Fold one cross-tier verdict (hybrid bridge).  A
        ``confirmed`` verdict — the finding reproduced on the real
        native binary — marks the finding AND its generating seed
        (``parent``) confirmed, and credits any arm carrying either
        md5 with a find-equivalent boost (RareEdgeScheduler
        additionally sharpens their rarity).  Idempotent per finding
        md5; other verdicts are recorded nowhere here (proxy_only
        feeds the proxy-gap report, not scheduling).  With no hybrid
        bridge attached this is never called, so every policy's
        ordering is exactly the unbridged one."""
        if verdict != "confirmed" or md5 in self.confirmed_md5s:
            return
        for m in (md5, parent):
            if m and len(self.confirmed_md5s) < self.CONFIRM_CAP:
                self.confirmed_md5s.add(m)
        for arm in self.arms:
            if arm.md5 == md5 or (parent and arm.md5 == parent):
                arm[2] += self.CONFIRM_CREDIT

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


class RareEdgeScheduler(Scheduler):
    """FairFuzz-style rarity scheduling: prefer arms whose coverage
    signature contains the edges hit by the FEWEST corpus entries.
    Global hit counts fold over every admitted signature.  Unsigned
    arms (no signature on this tier) are probed once, then fall behind
    signed arms; among equal rarity the least-selected arm wins, ties
    toward the newest."""

    name = "rare-edge"

    #: rarity scale for arms whose md5 is in ``confirmed_md5s`` (the
    #: hybrid tier's native confirmations): a confirmed seed's rarest
    #: edge counts as half as common
    CONFIRM_RARITY_SCALE = 0.5

    def __init__(self, cap: Optional[int] = None,
                 static_prior: Optional[Dict[int, float]] = None):
        super().__init__(cap)
        self.edge_hits: Dict[int, int] = {}
        #: optional static edge-frequency prior (slot -> probability
        #: mass, ``analysis.static_edge_prior``): breaks cold-start
        #: ties only — it enters the selection key after every dynamic
        #: statistic
        self.static_prior: Optional[Dict[int, float]] = \
            dict(static_prior) if static_prior else None

    def set_static_prior(self,
                         prior: Optional[Dict[int, float]]) -> None:
        """Install the static rarity prior (e.g. from
        ``analysis.static_edge_prior(program)``)."""
        self.static_prior = dict(prior) if prior else None

    def _prior_key(self, arm: Arm) -> float:
        """Statically expected frequency of the arm's rarest edge (0.0
        without a prior: the ordering is then the unprimed one)."""
        if not self.static_prior or not arm.sig:
            return 0.0
        return min(self.static_prior.get(e, 1.0) for e in arm.sig)

    def _forget(self, arm: Optional[Arm]) -> None:
        if arm is None or not arm.sig:
            return
        for e in arm.sig:
            n = self.edge_hits.get(e, 0) - 1
            if n <= 0:
                self.edge_hits.pop(e, None)
            else:
                self.edge_hits[e] = n

    def admit(self, arm: Arm) -> Optional[Arm]:
        if arm.sig:
            for e in arm.sig:
                self.edge_hits[e] = self.edge_hits.get(e, 0) + 1
        # an arm evicted past the cap leaves through ``drop``, which
        # releases its edge counts
        return super().admit(arm)

    def drop(self, index: int) -> Arm:
        """Arms leaving rotation release their edge counts, or the
        surviving arms' rarity reads stale."""
        arm = super().drop(index)
        self._forget(arm)
        return arm

    def _rarity(self, arm: Arm) -> float:
        if not arm.sig:
            # unsigned: probe once (rarity 0 beats everything), then
            # fall behind every signed arm
            return 0.0 if arm[1] == 0 else float("inf")
        r = float(min(self.edge_hits.get(e, 1) for e in arm.sig))
        if self.confirmed_md5s and arm.md5 in self.confirmed_md5s:
            r *= self.CONFIRM_RARITY_SCALE
        return r

    def select(self) -> Tuple[Optional[int], Optional[bytes]]:
        if not self.arms:
            return None, self.base_seed
        best, best_key = None, None
        for i, arm in enumerate(self.arms):
            key = (self._rarity(arm), float(arm[1]),
                   self._prior_key(arm), -arm.seq)
            if best_key is None or key < best_key:
                best, best_key = i, key
        if best_key is not None and best_key[0] == float("inf") \
                and self.base_seed is not None:
            # every arm is unsigned and already probed: split the
            # budget with the base seed instead of thrashing blind arms
            if self.rng.random() < 0.5:
                return None, self.base_seed
        return best, self.arms[best][0]

    def favored_count(self) -> int:
        if not self.edge_hits:
            return len(self.arms)
        rarest = min(self.edge_hits.values())
        return sum(1 for a in self.arms if a.sig and
                   min(self.edge_hits.get(e, 1) for e in a.sig)
                   <= rarest)


SCHEDULERS = {
    "bandit": BanditScheduler,
    "rare-edge": RareEdgeScheduler,
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
