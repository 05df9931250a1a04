"""Batched branch-distance descent — the solver-unknown frontier tier.

The exact solver (``analysis/solver.py``) is honest about
checksum-style loops: they come
back ``unknown``.  Angora's answer (arxiv 1803.01307) is to treat the
uncracked branch as a black-box distance objective over the input
bytes and descend it; this engine runs that search with the expensive
half on device — one ``run_batch_distances`` dispatch scores the
whole candidate population against the whole GUARD CURRICULUM (the
deciding branches of the path into the frontier block, plus the
edge's own) at once, and lanes rank by (deepest guard sampled,
distance there).

Per iteration the population is rebuilt around the elite front —
stratified per curriculum stage, with probe centers spanning the
best elite, structurally-distinct ties (zero-extended siblings) and
one back-stage repair candidate:

  * the elites themselves (monotone best-so-far),
  * finite-difference coordinate probes per center
    (+/- {1, 2, 4, 16, 64} per byte — numeric descent moves, operand
    dependency positions first),
  * compensated PAIR probes (+d on an operand byte, +/-d or +/-2d on
    a second byte) that move an operand THROUGH sum-style integrity
    checks instead of dying at them,
  * dictionary-token insertion sweeps and window duplications —
    command-stream targets gate depth counters on how many
    well-formed records precede the branch, which no fixed-position
    byte move can change,
  * ES mutants: rank-weighted parent, dictionary-biased byte values,
    length/structure moves ("not all bytes are equal", arxiv
    1711.04596: mutation dimensions restrict to the solver's
    dependency-byte mask when one is known),
  * uniform recombination of elite pairs over the mask positions,
  * ``torch.autograd`` proposals through the float32-relaxed soft-KBVM
    when the path slice to the blocking guard is arithmetic-only
    (soft.py),
  * fresh reseeds after a stagnation window (restart, wider radius).

All deterministic probe families cycle their combo lists under
per-batch quotas with cursors keyed by CENTER ROLE, so the sweep
keeps advancing when centers churn between equally-ranked lanes.

Witness detection does not rely on the distance at all: the engine
reads the target edge's own hit count from the returned coverage map,
so a candidate that traverses the edge by ANY path is caught.  The
honesty contract matches the solver: a witness is re-checked through
the pure-Python reference interpreter before it is ever reported.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..analysis.solver import concrete_run
from ..models.vm import DIST_UNREACHED, run_batch_distances
from ..utils.logging import DEBUG_MSG
from .objective import BranchObjective, edge_objectives
from .soft import slice_operand_deps, soft_refine, trace_slice

#: staged-key sentinel ranking below any lane that sampled a guard
_KEY_UNREACHED = (1 << 20, float(DIST_UNREACHED))

#: curriculum size cap (guards into the block + the edge's own
#: deciding branches; jit specializes per K)
MAX_GUARDS = 8

#: device dispatches per edge before the engine reports ``exhausted``
DEFAULT_DESCENT_BUDGET = 48

#: candidate lanes per dispatch (the population size)
DEFAULT_LANES = 1024

#: iterations with no best-distance improvement before a restart
STAGNATION_WINDOW = 8

#: elite front size
N_ELITE = 16

#: finite-difference probe deltas (both signs tried): the small
#: steps walk counters/length fields exactly, the big ones detect
#: the descent direction across most of a byte's range
_PROBE_DELTAS = (1, 2, 4, 16, 64)


@dataclass
class DescentResult:
    """Outcome of one edge descent.

    ``status``:
      descended — ``input`` concretely traverses the edge (verified
                  against the reference interpreter; never guessed)
      exhausted — the step budget ran out; ``best_dist`` is the
                  closest the population got (``DIST_UNREACHED`` =
                  no candidate ever reached the branch in-block)
    """
    edge: Tuple[int, int]
    status: str
    input: Optional[bytes] = None
    steps: int = 0              # search iterations spent
    evals: int = 0              # candidate executions scored
    best_dist: float = float(DIST_UNREACHED)
    objective: str = ""
    reason: str = ""
    soft_used: bool = False
    #: which engine produced the result: "host" (this module — one
    #: device dispatch per iteration) or "device" (device_descent.py
    #: — R iterations fused per dispatch)
    engine: str = "host"
    #: device dispatches actually issued (== iterations for the host
    #: engine; iterations / scan_iters for the in-scan engine) — the
    #: bench wall-clock gate's machine-readable denominator
    dispatches: int = 0
    iterations: int = 0
    #: True when the witness came from an input-to-state lane
    i2s: bool = False

    def as_dict(self) -> Dict:
        d = {"edge": list(self.edge), "status": self.status,
             "steps": self.steps, "evals": self.evals,
             "best_dist": (None if self.best_dist >= DIST_UNREACHED
                           else float(self.best_dist)),
             "objective": self.objective, "reason": self.reason,
             "soft_used": self.soft_used, "engine": self.engine,
             "dispatches": self.dispatches,
             "iterations": self.iterations, "i2s": self.i2s}
        if self.input is not None:
            d["input_hex"] = self.input.hex()
            d["length"] = len(self.input)
        return d


def _edge_index(program, edge: Tuple[int, int]) -> Optional[int]:
    ef = np.asarray(program.edge_from)
    et = np.asarray(program.edge_to)
    hit = np.flatnonzero((ef == edge[0]) & (et == edge[1]))
    return int(hit[0]) if len(hit) else None


def _pack(rows: Sequence[bytes], lanes: int, L: int):
    bufs = np.zeros((lanes, L), dtype=np.uint8)
    lens = np.zeros((lanes,), dtype=np.int32)
    for i, r in enumerate(rows[:lanes]):
        r = r[:L]
        bufs[i, :len(r)] = np.frombuffer(r, dtype=np.uint8)
        lens[i] = len(r)
    # unused lanes repeat row 0 (coverage no-ops, same convention as
    # the fuzzing loop's batch padding)
    for i in range(len(rows), lanes):
        bufs[i] = bufs[0]
        lens[i] = lens[0]
    return bufs, lens


class _Population:
    """Host-side candidate generator around a rank-ordered elite
    front; all randomness comes from one seeded Generator so descents
    are reproducible."""

    def __init__(self, seeds: List[bytes], mask: Optional[List[int]],
                 lanes: int, rng: np.random.Generator,
                 max_len: int = 64,
                 tokens: Sequence[bytes] = ()):
        self.lanes = lanes
        self.rng = rng
        self.mask = mask
        self.max_len = max_len
        #: static-analysis dictionary (branch-compare constants):
        #: opcode/type/magic bytes the target actually compares
        #: against — ES value draws prefer them, and insertion moves
        #: splice them in whole
        self.tokens = [t for t in tokens if t]
        self.values = sorted({t[0] for t in self.tokens if len(t) == 1}
                             | {b for t in self.tokens for b in t})
        # zero-extended seed variants ride along from the start: the
        # frontier branches behind length/checksum guards often need
        # LONGER inputs than any corpus entry (a zero extension keeps
        # trailing sum-checksums self-consistent), and byte moves
        # alone can never grow a lane
        # interleaved with their parents so they survive the elite
        # cut even when the caller supplies a deep seed pool
        self.seeds = []
        for s in seeds:
            self.seeds.append(s)
            for ext in (4, 8, 16):
                if len(s) + ext <= max_len:
                    self.seeds.append(s + b"\x00" * ext)
        #: (staged key, bytes) elites, best first — the key is
        #: (guards past the deepest one sampled, distance there), so
        #: tuple order IS curriculum order
        self.elite: List[Tuple[tuple, bytes]] = \
            [(_KEY_UNREACHED, s) for s in self.seeds[:N_ELITE]]
        #: one representative per curriculum stage (deceptive-fitness
        #: guard: a lane that re-broke an early checksum while fixing
        #: the primary operand ranks below a local optimum, yet is
        #: the right probe center for the repair move)
        self.centers: List[bytes] = [s for _, s in self.elite[:4]]
        self.center_keys: List[tuple] = [k for k, _ in self.elite[:4]]
        self.radius = 1
        #: per-(family, center) probe rotation cursors, so several
        #: centers of different shapes cycle their combo lists
        #: independently
        self._cursors: Dict[tuple, int] = {}
        #: dynamic per-path taint of the CURRENT objective's operands
        #: (soft.slice_operand_deps on the best elite): probe moves
        #: concentrate on these positions when known
        self.focus: Optional[List[int]] = None

    def positions(self, buf: bytes) -> List[int]:
        if self.mask:
            p = [i for i in self.mask if i < len(buf)]
            if p:
                return p
        return list(range(len(buf)))

    def _cycle(self, family: str, role: int, combos: list,
               quota: int) -> list:
        """Take the next ``quota`` entries of ``combos``, resuming
        where this (family, center-role) left off last iteration.
        Keying on the ROLE (position in the centers list), not the
        center's bytes, keeps the sweep advancing when the center
        churns between equally-ranked lanes — byte-keyed cursors
        reset on every churn and starve the deeper combos."""
        if not combos or quota <= 0:
            return []
        key = (family, role)
        start = self._cursors.get(key, 0) % len(combos)
        n = min(quota, len(combos))
        self._cursors[key] = (start + n) % len(combos)
        return [combos[(start + k) % len(combos)] for k in range(n)]

    def _rand_value(self) -> int:
        """A byte value: dictionary-biased — the target only ever
        compares against a handful of constants (opcodes, type tags,
        bounds), and a uniform draw finds them at 1/256."""
        if self.values and self.rng.random() < 0.5:
            return int(self.values[int(self.rng.integers(
                len(self.values)))])
        return int(self.rng.integers(256))

    def _insert(self, b: bytearray) -> None:
        """Structural insertion: splice a duplicated window or a
        dictionary token (+ random arg byte) at a random offset,
        shifting the tail.  Command-stream/TLV targets gate depth
        counters ("sp >= 2") on how many well-formed records precede
        the branch — no set of fixed-position byte moves can ADD a
        record, an insertion can."""
        if len(b) >= self.max_len:
            return
        p = int(self.rng.integers(len(b) + 1))
        if self.tokens and self.rng.random() < 0.5:
            t = self.tokens[int(self.rng.integers(len(self.tokens)))]
            ins = bytes(t) + bytes([self._rand_value()])
        else:
            w = int(self.rng.choice((1, 2, 4)))
            lo = max(p - w, 0)
            ins = bytes(b[lo:p]) or bytes([self._rand_value()])
        ins = ins[:self.max_len - len(b)]
        b[p:p] = ins

    def _mutate(self, buf: bytes, k: int) -> bytes:
        b = bytearray(buf)
        structural = self.mask is None  # a dependency mask pins
        r = self.rng.random()           # positions: no shifting then
        if structural and r < 0.15:
            self._insert(b)
        elif structural and r < 0.22 and len(b) > 2:
            # deletion: drop a window (the inverse structural move)
            w = int(self.rng.choice((1, 2, 4)))
            p = int(self.rng.integers(max(len(b) - w, 1)))
            del b[p:p + w]
        elif r < 0.3:
            # length move: grow (zeros or noise) or shrink —
            # structural guards ("payload+cksum present") gate on
            # length, and the dependency-byte mask can't know that
            delta = int(self.rng.integers(1, 9))
            if self.rng.random() < 0.7 and \
                    len(b) + delta <= self.max_len:
                ext = (b"\x00" * delta if self.rng.random() < 0.5
                       else bytes(self.rng.integers(0, 256, delta,
                                                    dtype=np.uint8)))
                b.extend(ext)
            elif len(b) > delta:
                del b[-delta:]
        pos = self.positions(bytes(b))
        for i in self.rng.choice(pos, size=min(k, len(pos)),
                                 replace=False) if pos else ():
            m = self.rng.random()
            if m < 0.5:
                b[i] = self._rand_value()
            else:
                delta = int(self.rng.choice((1, 2, 4, 16, 64))) * \
                    (1 if self.rng.random() < 0.5 else -1)
                b[i] = (b[i] + delta) & 0xFF
        return bytes(b)

    def _parent(self) -> bytes:
        # rank-weighted pick: geometric over the elite front
        r = min(int(self.rng.geometric(0.5)) - 1, len(self.elite) - 1)
        return self.elite[r][1]

    def _insert_probes(self, best: bytes, role: int,
                       quota: int) -> List[bytes]:
        """Deterministic dictionary-insertion sweep around the best
        elite: every (position, token) splice, rotated across
        iterations.  Command-stream targets need whole well-formed
        records ADDED before the target branch; enumerating the
        splices finds them in O(1) iterations where random insertion
        needs many."""
        if not self.tokens or self.mask is not None:
            return []
        variants: List[bytes] = []
        for t in self.tokens:
            variants.append(bytes(t))
            if len(t) == 1:
                variants.append(bytes(t) + b"\x00")  # opcode + arg
        # variant-major: each token sweeps every position before the
        # cycle moves to the next token, so early-dictionary tokens
        # (magic, low opcodes) land within the first iterations even
        # under small per-center quotas
        combos = [(p, v) for v in variants
                  for p in range(len(best) + 1)]
        out = []
        for p, v in self._cycle("ins", role, combos, quota):
            if len(best) + len(v) <= self.max_len:
                b = bytearray(best)
                b[p:p] = v
                out.append(bytes(b))
        return out

    def _probe_center(self, best: bytes, role: int, n_single: int,
                      n_pair: int, n_insert: int) -> List[bytes]:
        """Deterministic probe families around ONE center, each
        cycled across iterations so every combo gets its turn under
        the per-batch quotas."""
        out: List[bytes] = []
        pos = self.positions(best)
        out.extend(self._insert_probes(best, role, n_insert))
        # single-coordinate probes (finite differences: the numeric-
        # descent moves); operand-dependency positions go first
        hot = [i for i in (self.focus or []) if i in set(pos)]
        cold = [i for i in pos if i not in set(hot)]
        combos = [(i, s) for i in hot + cold for d in _PROBE_DELTAS
                  for s in (d, -d)]
        for i, s in self._cycle("one", role, combos, n_single):
            b = bytearray(best)
            b[i] = (b[i] + s) & 0xFF
            out.append(bytes(b))
        # PAIR probes: +d on byte i with a compensating delta on byte
        # j.  A lone byte move through a sum-style integrity check
        # (checksums, counters) kills reachability before the target
        # branch ever samples; the compensated pair preserves linear
        # invariants while still moving the operand.  When the
        # operand's dynamic byte deps are known, i ranges over THEM
        # (j — the compensator, e.g. the checksum byte — stays
        # unrestricted).  Compensation variants: +/-d (same-weight
        # sums) and +/-2d (a grown record re-bases a moved integrity
        # byte on other operands — 2d covers the unit-growth case)
        isrc = hot or pos
        pcombos = [(i, j, d, s)
                   for d in (1, 4, 16, 64)
                   for i in isrc for j in pos if i != j
                   for s in (d, -d, 2 * d, -2 * d)]
        for i, j, d, s in self._cycle("two", role, pcombos, n_pair):
            b = bytearray(best)
            b[i] = (b[i] + d) & 0xFF
            b[j] = (b[j] + s) & 0xFF
            out.append(bytes(b))
        return out

    def batch(self, extra: Sequence[bytes] = ()) -> List[bytes]:
        out: List[bytes] = [e[1] for e in self.elite]
        out.extend(extra)
        # every center is probed every batch: the zero-extended
        # sibling (or a back-stage repair lane) must not wait for a
        # rotation turn it may never get
        centers = self.centers or [self.elite[0][1]]
        nc = len(centers)
        for role, best in enumerate(centers):
            out.extend(self._probe_center(
                best, role, (self.lanes // 3) // nc,
                (self.lanes // 3) // nc, (self.lanes // 8) // nc))
        # recombination: uniform elite-pair crossover over mask bytes
        for _ in range(self.lanes // 8):
            p1, p2 = self._parent(), self._parent()
            if len(p2) != len(p1):
                continue
            b = bytearray(p1)
            for i in self.positions(p1):
                if self.rng.random() < 0.5 and i < len(p2):
                    b[i] = p2[i]
            out.append(bytes(b))
        # ES mutants fill the rest
        while len(out) < self.lanes:
            k = int(self.rng.integers(1, 4 + self.radius))
            out.append(self._mutate(self._parent(), k))
        return out[:self.lanes]

    def rank(self, cands: List[bytes], keys: List[tuple]) -> bool:
        """Rebuild the elite front from THIS batch's staged keys;
        True when the best key improved.  Elites ride in every batch,
        so rebuilding (rather than min-folding history) keeps the
        front monotone while letting curriculum progress re-score
        everything cleanly."""
        prev = self.elite[0][0]
        pool: Dict[bytes, tuple] = {}
        for c, k in zip(cands, keys):
            if c not in pool or k < pool[c]:
                pool[c] = k
        ranked = sorted(pool.items(), key=lambda kv: kv[1])
        # stratified keep: reserve slots for the best lanes of EACH
        # curriculum stage so back-stage progress survives the cut
        by_stage: Dict[int, List[Tuple[tuple, bytes]]] = {}
        for c, k in ranked:
            by_stage.setdefault(k[0], []).append((k, c))
        stages = sorted(by_stage)
        quota = max(N_ELITE // max(len(stages), 1), 2)
        elite: List[Tuple[tuple, bytes]] = []
        taken = set()
        for st in stages:
            for k, c in by_stage[st][:quota]:
                elite.append((k, c))
                taken.add(c)
        for c, k in ranked:             # fill with the global best
            if len(elite) >= N_ELITE:
                break
            if c not in taken:
                elite.append((k, c))
                taken.add(c)
        self.elite = sorted(elite)[:N_ELITE]
        # probe centers, probed EVERY batch with split quotas:
        #   * the best elite,
        #   * leading elites of DISTINCT LENGTHS (structurally
        #     different ties — e.g. the zero-extended sibling whose
        #     extra positions a moved checksum must land on),
        #   * one representative of the next stage back (a lane that
        #     re-broke an early guard while fixing a later operand is
        #     often one repair probe from the front).
        centers = [self.elite[0]]
        have = {self.elite[0][1]}
        have_lens = {len(self.elite[0][1])}
        for k, c in self.elite:
            if len(centers) >= 3:
                break
            if c not in have and len(c) not in have_lens:
                centers.append((k, c))
                have.add(c)
                have_lens.add(len(c))
        stage0 = self.elite[0][0][0]
        for st in stages:
            if st > stage0:
                k, c = by_stage[st][0][0], by_stage[st][0][1]
                if c not in have:
                    centers.append((k, c))
                break
        self.center_keys = [k for k, _ in centers]
        self.centers = [c for _, c in centers]
        return self.elite[0][0] < prev

    def restart(self) -> None:
        """Stagnation: widen the mutation radius and refresh the tail
        of the front from heavily-mutated seeds."""
        self.radius = min(self.radius + 2, 8)
        keep = self.elite[:max(2, N_ELITE // 4)]
        fresh = []
        for _ in range(N_ELITE - len(keep)):
            s = self.seeds[int(self.rng.integers(len(self.seeds)))]
            fresh.append((_KEY_UNREACHED,
                          self._mutate(s, 4 + self.radius)))
        self.elite = keep + fresh


def _concrete_trace(program, s: bytes, cache: Optional[Dict] = None):
    """``concrete_run`` memoized per input buffer — the reach filter
    and the path-guard extraction replay the same seeds."""
    if cache is None:
        return concrete_run(program, s)
    t = cache.get(s)
    if t is None:
        t = cache[s] = concrete_run(program, s)
    return t


def _path_guards(program, edge: Tuple[int, int],
                 seeds: Sequence[bytes],
                 cap: int = MAX_GUARDS,
                 trace_cache: Optional[Dict] = None
                 ) -> List[BranchObjective]:
    """The guard curriculum INTO the edge's source block: deciding
    branches of every edge along the first seed path that reaches it,
    in path order.  Mutations that break an earlier guard (shift a
    checksum, shorten a length field) stop sampling the target branch
    entirely; scoring these guards in the same dispatch tells the
    ranking WHERE such a lane died and how close it is to recovering."""
    f = int(edge[0])
    if f < 0:
        return []
    for s in seeds:
        tr = _concrete_trace(program, bytes(s), trace_cache)
        if f not in tr.blocks:
            continue
        guards: List[BranchObjective] = []
        for e2 in tr.edges:
            guards.extend(edge_objectives(program,
                                          (int(e2[0]), int(e2[1]))))
            if int(e2[1]) == f:
                break
        seen = set()
        out = []
        for g in guards:
            k = g.spec()
            if k not in seen:
                seen.add(k)
                out.append(g)
        return out[-cap:]
    return []


def _staged_keys(dists: np.ndarray) -> List[tuple]:
    """Per-lane curriculum rank key from the [B, K] guard distances:
    ``(guards past the DEEPEST one sampled, distance there)`` —
    lexicographically smaller = further along the path and closer at
    the frontier guard.  Ranking on the deepest SAMPLED guard (not
    the first non-zero one) matters on loops: a lane that takes the
    loop body exits through a different edge than the seed's
    zero-iteration path, leaving an early guard's distance nonzero
    forever even though the lane sailed past that region."""
    keys = []
    k_total = dists.shape[1]
    unreached = np.float32(DIST_UNREACHED)
    for row in dists:
        sampled = np.flatnonzero(row < unreached)
        if len(sampled):
            i = int(sampled[-1])
            keys.append((k_total - 1 - i, float(row[i])))
        else:
            keys.append((k_total, float(DIST_UNREACHED)))
    return keys


def descend_edge(program, edge: Tuple[int, int],
                 seeds: Sequence[bytes], *,
                 mask: Optional[Sequence[int]] = None,
                 lanes: int = DEFAULT_LANES,
                 budget: int = DEFAULT_DESCENT_BUDGET,
                 max_len: int = 64,
                 rng_seed: int = 0x6465,
                 trace=None,
                 trace_cache: Optional[Dict] = None,
                 device="cuda") -> DescentResult:
    """Descend the branch-distance curriculum of ``edge`` until a
    verified witness traverses it or ``budget`` device dispatches are
    spent.  The curriculum is the deciding branches of the path INTO
    the edge's source block plus the edge's own deciding branches, in
    program order; one dispatch scores all of them for the whole
    population and lanes rank by how far along they got.  ``seeds``
    should be inputs whose paths reach the source block (the cracker
    filters the corpus; anything works, it just starts unranked).
    ``mask`` restricts mutation dimensions to the solver's
    dependency bytes; ``trace`` (a TraceRecorder) puts every dispatch
    on the ``descent`` lane.  The population is built on the host
    (its numpy ``Generator`` is the JAX package's) and scored on
    ``device`` (the card unless the caller passes ``"cpu"``)."""
    dev = resolve_device(device)
    f_idx, t_idx = int(edge[0]), int(edge[1])
    e_idx = _edge_index(program, edge)
    if e_idx is None:
        return DescentResult(edge=(f_idx, t_idx), status="exhausted",
                             reason="edge not in the static universe")
    seeds = [bytes(s) for s in seeds if s] or [b"\x00"]
    own = edge_objectives(program, edge)
    guards = _path_guards(program, edge, seeds,
                          cap=max(MAX_GUARDS - len(own), 0),
                          trace_cache=trace_cache)
    specs_objs: List[BranchObjective] = (guards + own)[-MAX_GUARDS:]
    rng = np.random.default_rng(rng_seed ^ ((f_idx & 0xFFFF) << 16)
                                ^ (t_idx & 0xFFFF))
    max_len = max(int(max_len), max(len(s) for s in seeds))
    L = max(8, ((max_len + 7) // 8) * 8)
    lanes = max(int(lanes), 2 * N_ELITE)
    k_total = len(specs_objs)

    try:
        from ..analysis.dataflow import extract_dictionary
        tokens = extract_dictionary(program)
    except Exception:
        tokens = []
    pop = _Population(list(seeds), list(mask) if mask else None,
                      lanes, rng, max_len=max_len, tokens=tokens)
    steps = evals = 0
    stagnant = 0
    best_primary = float(DIST_UNREACHED)
    best_desc = ""
    soft_used = False
    deps_cache: Dict[tuple, tuple] = {}

    def _slice_for(k_idx: int, buf: bytes):
        key = (k_idx, buf)
        if key not in deps_cache:
            sl = trace_slice(program, buf, specs_objs[k_idx])
            deps_cache[key] = (sl, slice_operand_deps(
                program, sl, specs_objs[k_idx]))
        return deps_cache[key]

    for it in range(max(int(budget), 1)):
        grads: List[bytes] = []
        obj = None
        if specs_objs:
            # each stage representative's first unsatisfied guard
            # contributes its operands' dynamic byte deps to the
            # probe focus — one concrete host replay per (guard,
            # center), cached
            focus: set = set()
            for ck, cb in zip(pop.center_keys, pop.centers):
                k_idx = min(max(k_total - 1 - ck[0], 0), k_total - 1)
                focus.update(_slice_for(k_idx, cb)[1])
            pop.focus = sorted(focus) or None
            # the soft tier relaxes the BEST elite's frontier guard
            # when its path slice is arithmetic-only
            ke, best = pop.elite[0]
            k_idx = min(max(k_total - 1 - ke[0], 0), k_total - 1)
            obj = specs_objs[k_idx]
            if it and it % 4 == 0:
                sl = _slice_for(k_idx, best)[0]
                if sl.eligible:
                    grads = soft_refine(program, best, obj,
                                        positions=pop.positions(best),
                                        slice_=sl)
                    soft_used = soft_used or bool(grads)
        cands = pop.batch(extra=grads)
        bufs, lens = _pack(cands, lanes, L)
        span = (trace.span("descend_batch", lane="descent",
                           args={"edge": f"{f_idx}:{t_idx}",
                                 "iter": it, "lanes": lanes,
                                 "guards": k_total})
                if trace is not None else contextlib.nullcontext())
        with span:
            bufs = torch.from_numpy(bufs).to(dev)
            lens = torch.from_numpy(lens).to(dev)
            if specs_objs:
                res, dists = run_batch_distances(
                    program, bufs, lens,
                    tuple(o.spec() for o in specs_objs))
                dists = dists.cpu().numpy()
            else:
                # unconditional edge: no branch to descend on — run
                # the population anyway (covering the source block
                # covers the edge) and rank everything equal
                from ..models.vm import run_batch
                res = run_batch(program, bufs, lens,
                                record_stream=False)
                dists = np.full((lanes, 1), DIST_UNREACHED,
                                dtype=np.float32)
            hits = res.counts[:, e_idx].cpu().numpy() > 0
        steps += 1
        evals += len(cands)
        for r in np.flatnonzero(hits[:len(cands)]):
            buf = cands[int(r)]
            # honesty contract: the reference interpreter must agree
            # before the witness is reported
            if (f_idx, t_idx) in concrete_run(program, buf).edges:
                return DescentResult(
                    edge=(f_idx, t_idx), status="descended",
                    input=buf, steps=steps, evals=evals,
                    best_dist=0.0,
                    objective=obj.desc if obj else "",
                    soft_used=soft_used, engine="host",
                    dispatches=steps, iterations=steps)
        improved = pop.rank(cands, _staged_keys(dists[:len(cands)]))
        if specs_objs and own:
            primary = float(dists[:len(cands), -1].min())
            if primary < best_primary:
                best_primary = primary
                best_desc = specs_objs[-1].desc
        DEBUG_MSG("descend %d:%d iter %d best %s",
                  f_idx, t_idx, it, pop.elite[0][0])
        if improved:
            stagnant = 0
        else:
            stagnant += 1
            if stagnant >= STAGNATION_WINDOW:
                pop.restart()
                stagnant = 0
    return DescentResult(
        edge=(f_idx, t_idx), status="exhausted", steps=steps,
        evals=evals, best_dist=best_primary, objective=best_desc,
        reason=f"step budget exhausted ({budget} dispatches)",
        soft_used=soft_used, engine="host", dispatches=steps,
        iterations=steps)


def seeds_reaching_block(program, seeds: Sequence[bytes],
                         block: int, cap: int = 64,
                         trace_cache: Optional[Dict] = None
                         ) -> List[bytes]:
    """Filter ``seeds`` to those whose concrete path executes
    ``block`` (-1 = entry: every input).  The population wants to
    START at the branch, not re-discover the path to it.  Pass one
    ``trace_cache`` dict across calls (and into ``descend_edge``) so
    each seed is reference-interpreted once, not once per consumer."""
    if block < 0:
        return list(seeds)[:cap]
    out = []
    for s in seeds:
        if block in _concrete_trace(program, bytes(s),
                                    trace_cache).blocks:
            out.append(bytes(s))
            if len(out) >= cap:
                break
    return out
