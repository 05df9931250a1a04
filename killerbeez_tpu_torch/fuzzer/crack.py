"""The plateau crack stage — solver-guided branch cracking.

Closes the loop from "observe coverage" to "compute the input that
extends it": when the fuzzing loop plateaus (no new paths for N
batches), the cracker diffs the program's STATIC edge universe
(``vm.compute_edges``) against the dynamic coverage the campaign has
actually accumulated (the instrumentation's virgin map), asks the
path-condition solver (``analysis/solver.py``) for inputs reaching
the never-hit edges, and injects the solved candidates straight
through the instrumentation — ahead of any scheduler decision.
Solved, unsat and unknown verdicts are cached (and persisted to the
corpus store's ``solver.json`` sidecar when a store is attached), so
an edge is solved at most once per campaign lineage, resumes
included.

Second consumer: **focused mutation masks**.  The dependency sets of
the branches guarding the still-uncovered frontier (dataflow layer)
become a byte mask the havoc/zzuf mutators honor — Angora's "don't
burn mutations on bytes no uncovered branch reads", bought statically
instead of with dynamic taint.  ``--no-focus`` disables the masks;
campaigns without a cracker never see one (parity-pinned).

Third tier: **gradient-guided escalation** (``--descend``).  Edges
the solver honestly reports ``unknown`` — checksum loops, deep
loop-carried state — escalate to the search tier
(``search/descent.py``): batched branch-distance descent on the card,
seeded from corpus entries that reach the edge's source block,
mutation dimensions restricted to the solver's dependency-byte mask.
Verified witnesses inject through the same path as solved inputs
(same honesty contract: concretely re-checked before emission), and
per-edge verdicts (``descended``/``exhausted``, steps, final
distance) cache in the same ``solver.json`` sidecar so ``--resume``
never re-descends.

The solver and the analyses are host numpy; the descent scores its
candidates on the card (the instrumentation's device), and the solved
inputs execute through the main instrumentation's ``run_batch`` (the
``kbz_vm_kernel`` launch over every lane on engine ``cuda``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..analysis import analyze_dataflow, edge_dep_mask
from ..analysis.solver import (
    DEFAULT_BUDGET, DEFAULT_MAX_LEN, DEFAULT_MAX_VISITS, solve_edge,
)
from ..utils.logging import DEBUG_MSG, INFO_MSG, WARNING_MSG
from .loop import _host


class BranchCracker:
    """Owns the plateau trigger, the per-edge solve cache, candidate
    injection and the focus-mask feed for ONE campaign/program."""

    #: at most this many fresh solver attempts per crack invocation
    #: (the rest wait for the next plateau — keeps a single crack's
    #: host-side pause bounded)
    MAX_SOLVES_PER_CRACK = 32

    #: at most this many descent escalations per crack invocation
    #: (a descent is many device dispatches — later plateaus pick up
    #: the rest, with fresher seeds from whatever cracked meanwhile)
    MAX_DESCENDS_PER_CRACK = 4

    #: seed-pool size cap for descent populations
    MAX_DESCENT_SEEDS = 96

    def __init__(self, program, *, plateau_batches: int = 16,
                 budget: int = DEFAULT_BUDGET,
                 max_visits: int = DEFAULT_MAX_VISITS,
                 max_len: int = DEFAULT_MAX_LEN,
                 focus: bool = True, store=None,
                 descend: int = 0, descend_lanes: int = 1024,
                 descend_engine: str = "device",
                 descend_scan_iters: int = 0,
                 max_solves: Optional[int] = None,
                 max_descends: Optional[int] = None,
                 vsa: bool = False, device="cuda"):
        self.program = program
        #: where the descent engines score candidates (the campaign's
        #: instrumentation device)
        self.device = device
        self.plateau_batches = max(int(plateau_batches), 1)
        self.budget = int(budget)
        self.max_visits = int(max_visits)
        self.max_len = int(max_len)
        self.focus = bool(focus)
        self.store = store
        #: descent iteration budget per edge; 0 = the search tier is
        #: off and solver-unknown edges stay unknown
        self.descend = int(descend)
        self.descend_lanes = int(descend_lanes)
        #: which descent engine escalated edges run on: "device" =
        #: the in-scan engine (search/device_descent.py, R iterations
        #: fused per dispatch, input-to-state matching on) with an
        #: automatic stand-down to the host engine on edges it cannot
        #: take (unconditional edges); "host" = the host-driven
        #: engine only (descent.py)
        if descend_engine not in ("device", "host"):
            raise ValueError(
                f"descend_engine must be 'device' or 'host', "
                f"got {descend_engine!r}")
        self.descend_engine = descend_engine
        self.descend_scan_iters = int(descend_scan_iters)
        #: per-crack work caps (instance-tunable: bench/offline
        #: callers crank them to sweep a whole universe in one crack)
        self.max_solves = int(max_solves) if max_solves \
            else self.MAX_SOLVES_PER_CRACK
        self.max_descends = int(max_descends) if max_descends \
            else self.MAX_DESCENDS_PER_CRACK
        ef = np.asarray(program.edge_from)
        et = np.asarray(program.edge_to)
        slots = np.asarray(program.edge_slot)
        self.edges: List[Tuple[int, int]] = \
            [(int(f), int(t)) for f, t in zip(ef, et)]
        self.slot_of_edge: Dict[Tuple[int, int], int] = {
            e: int(s) for e, s in zip(self.edges, slots)}
        self._dataflow = None           # lazy (mask computation only)
        #: --vsa: solve through solve_edge_vsa (byte-domain seeding
        #: + the visit-cap escalation ladder); the fixpoint document
        #: is computed once and cached in the corpus store's
        #: checkpoint epoch, so --resume and repeated cracks never
        #: re-run it.  Off (default): solve_edge, bit-identical to
        #: the pre-VSA cracker.
        self.vsa = bool(vsa)
        self._vsa_result = None         # lazy (first crack)
        #: "f:t" -> {"status", "reason", "input_hex"?}
        self.cache: Dict[str, Dict] = {}
        if store is not None:
            self.cache = store.load_solver_cache()
        self._last_new_paths = -1
        self._progress_iter = 0

    # -- coverage frontier ----------------------------------------------

    def uncovered_edges(self, instr) -> List[Tuple[int, int]]:
        """Static edges whose AFL map slot the campaign has never lit
        (colliding slots conflate, exactly as novelty itself does)."""
        virgin = _host(instr.virgin_bits)
        covered = set(np.flatnonzero(virgin != 0xFF).tolist())
        return [e for e in self.edges
                if self.slot_of_edge[e] not in covered]

    @staticmethod
    def _key(edge: Tuple[int, int]) -> str:
        return f"{edge[0]}:{edge[1]}"

    # -- the value-set document (--vsa) ---------------------------------

    def _get_vsa(self):
        """The VsaResult for this program: corpus-cached doc if its
        ``program_sig`` still matches, else one fresh fixpoint run
        persisted for every later crack / resume."""
        if self._vsa_result is not None:
            return self._vsa_result
        from ..analysis.vsa import VsaResult, analyze_vsa
        if self.store is not None:
            doc = self.store.load_vsa_doc()
            if doc is not None:
                cached = VsaResult.from_doc(doc, self.program)
                if cached is not None:
                    self._vsa_result = cached
                    return cached
        self._vsa_result = analyze_vsa(self.program)
        if self.store is not None:
            self.store.save_vsa_doc(self._vsa_result.to_doc())
        return self._vsa_result

    # -- the plateau trigger --------------------------------------------

    def maybe_crack(self, fuzzer) -> None:
        """Called once per loop iteration: fire ``crack`` after
        ``plateau_batches`` batches with zero new paths.

        ``stats.iterations`` advances at DISPATCH while
        ``stats.new_paths`` advances at triage, which lags by up to
        ``PIPELINE_DEPTH`` batches — so the plateau window is padded
        by the pipeline depth.  By the time the padded window
        elapses, every batch of the un-padded window has been
        triaged (the pending deque caps at the depth), and any
        finding among them would have reset the baseline: the crack
        only fires after ``plateau_batches`` PROVEN finding-free
        batches, not during warm-up."""
        s = fuzzer.stats
        if s.new_paths != self._last_new_paths:
            self._last_new_paths = s.new_paths
            self._progress_iter = s.iterations
            return
        depth = getattr(fuzzer, "PIPELINE_DEPTH", 0)
        window = (self.plateau_batches + depth) * fuzzer.batch_size
        if s.iterations - self._progress_iter < window:
            return
        self._progress_iter = s.iterations      # re-arm
        # flight recorder: the plateau itself is a campaign event —
        # kb-timeline overlays it on the span lanes (a crack that fired
        # during warm-up shows there)
        fuzzer.telemetry.event(
            "plateau", execs=int(s.iterations),
            new_paths=int(s.new_paths), window_execs=int(window))
        tr = fuzzer.telemetry.trace
        with (tr.span("crack", lane="crack") if tr is not None
              else contextlib.nullcontext()):
            self.crack(fuzzer)

    # -- the crack itself -----------------------------------------------

    def crack(self, fuzzer) -> int:
        """Solve + inject the uncovered frontier; returns how many
        candidates were injected."""
        instr = fuzzer.driver.instrumentation
        reg = fuzzer.telemetry.registry
        uncovered = self.uncovered_edges(instr)
        reg.gauge("solver_frontier", len(uncovered))
        if not uncovered:
            if self.focus:
                fuzzer.driver.mutator.set_focus_mask(None)
            return 0

        fresh = [e for e in uncovered if self._key(e) not in self.cache]
        t0 = time.time()
        for e in fresh[:self.max_solves]:
            reg.count("solver_attempts")
            if self.vsa:
                from ..analysis.solver import solve_edge_vsa
                res = solve_edge_vsa(
                    self.program, e, vsa=self._get_vsa(),
                    budget=self.budget, max_visits=self.max_visits,
                    max_len=self.max_len)
            else:
                res = solve_edge(self.program, e, budget=self.budget,
                                 max_visits=self.max_visits,
                                 max_len=self.max_len)
            entry = {"status": res.status, "reason": res.reason}
            if res.status == "solved":
                reg.count("solver_solved")
                entry["input_hex"] = res.input.hex()
            elif res.status == "unsat":
                reg.count("solver_unsat")
            else:
                reg.count("solver_unknown")
                if "budget" in res.reason:
                    reg.count("solver_budget_bailed")
            self.cache[self._key(e)] = entry

        # gradient-guided escalation: the edges the solver just (or
        # previously) reported unknown are exactly the search tier's
        # intake — descend their branch distances on device.  Returns
        # ATTEMPTS, not witnesses: an exhausted verdict also mutates
        # the cache and must persist, or --resume re-descends it
        searched = self._descend_frontier(fuzzer, uncovered) \
            if self.descend else 0

        if self.store is not None and (fresh or searched):
            self._persist_verdicts(fuzzer)

        # inject every cached solve/descent whose edge is STILL
        # uncovered — includes results restored from a resumed
        # campaign's sidecar
        bufs = []
        for e in uncovered:
            entry = self.cache.get(self._key(e))
            if entry and entry.get("status") in ("solved", "descended") \
                    and "input_hex" in entry:
                bufs.append(bytes.fromhex(entry["input_hex"]))
        injected = self._inject(fuzzer, bufs) if bufs else 0
        if fresh or injected:
            fuzzer.telemetry.event(
                "crack_injection", injected=int(injected),
                attempts=len(fresh[:self.max_solves]),
                frontier=len(uncovered),
                solve_seconds=round(time.time() - t0, 3))
            INFO_MSG(
                "crack: %d uncovered edges, %d solve attempts "
                "(%.2fs), %d candidates injected",
                len(uncovered), len(fresh[:self.max_solves]),
                time.time() - t0, injected)

        # focus mask from whatever frontier remains unsolved
        if self.focus:
            remaining = self.uncovered_edges(instr)
            self._update_mask(fuzzer, remaining)
        return injected

    def _persist_verdicts(self, fuzzer) -> None:
        """Fresh verdicts hit disk through the loop's unified
        checkpoint when this cracker is the loop's (ONE atomic epoch:
        the corpus state and the solver cache can never disagree
        about a kill again — the old separate solver.json write left
        a window where a kill between the corpus persist and the
        cache save forgot crack verdicts).  Offline callers
        (kb-descend rounds, bench sweeps) keep the standalone
        solver.json path."""
        if fuzzer is not None and \
                getattr(fuzzer, "cracker", None) is self and \
                getattr(fuzzer, "store", None) is self.store:
            fuzzer._persist_campaign(now=True)
        else:
            self.store.save_solver_cache(self.cache)

    # -- the search-tier escalation (search/descent.py) -----------------

    def _seed_pool(self, fuzzer) -> List[bytes]:
        """Descent seed candidates: rotation arms, the base seed, and
        every cached solver/descent witness (those reach the deepest
        known blocks — exactly where the frontier lives)."""
        pool: List[bytes] = []
        for entry in self.cache.values():
            if "input_hex" in entry:
                pool.append(bytes.fromhex(entry["input_hex"]))
        sched = getattr(fuzzer, "scheduler", None)
        if sched is not None:
            pool.extend(a.buf for a in sched.arms)
            if sched.base_seed:
                pool.append(sched.base_seed)
        seen = set()
        out = []
        for b in pool:
            if b and b not in seen:
                seen.add(b)
                out.append(b)
        return out[:self.MAX_DESCENT_SEEDS]

    def _descend_frontier(self, fuzzer, uncovered) -> int:
        """Escalate solver-unknown uncovered edges to branch-distance
        descent; returns how many edges were ATTEMPTED (the cache
        mutated — the caller persists on any nonzero return).  One
        attempt per edge per campaign lineage: verdicts (including
        ``exhausted``) cache under the edge's ``search`` key, so
        plateaus and ``--resume`` never re-descend."""
        from ..search import (
            DEFAULT_SCAN_ITERS, descend_edge, descend_edge_device,
            seeds_reaching_block,
        )
        cand = []
        for e in uncovered:
            entry = self.cache.get(self._key(e))
            if entry is not None and entry.get("status") == "unknown" \
                    and "search" not in entry:
                cand.append(e)
        reg = fuzzer.telemetry.registry
        reg.gauge("search_frontier", len(cand))
        if not cand:
            return 0
        seeds = self._seed_pool(fuzzer)
        if self._dataflow is None:
            self._dataflow = analyze_dataflow(self.program)
        tr = fuzzer.telemetry.trace
        # one reference-interpreter trace per seed per crack: the
        # reach filter and the engine's path-guard extraction share it
        traces: Dict[bytes, object] = {}
        n = attempted = 0
        t0 = time.time()
        scan_iters = self.descend_scan_iters or DEFAULT_SCAN_ITERS
        for e in cand[:self.max_descends]:
            reg.count("search_attempts")
            attempted += 1
            mask = edge_dep_mask(self.program, [e], self._dataflow)
            se = seeds_reaching_block(self.program, seeds, e[0],
                                      cap=24, trace_cache=traces) \
                or seeds[:16]
            if self.descend_engine == "device":
                res = descend_edge_device(
                    self.program, e, se or [b"\x00"], mask=mask,
                    lanes=self.descend_lanes, budget=self.descend,
                    scan_iters=scan_iters, max_len=self.max_len,
                    trace=tr, trace_cache=traces, registry=reg,
                    device=self.device)
            else:
                res = descend_edge(self.program, e, se or [b"\x00"],
                                   mask=mask,
                                   lanes=self.descend_lanes,
                                   budget=self.descend,
                                   max_len=self.max_len, trace=tr,
                                   trace_cache=traces,
                                   device=self.device)
            entry = dict(self.cache.get(self._key(e)) or {})
            d = res.as_dict()
            entry["search"] = {k: d[k] for k in
                               ("status", "steps", "evals",
                                "best_dist", "objective", "engine",
                                "dispatches", "iterations", "i2s")}
            if res.status == "descended":
                reg.count("search_descended")
                entry["status"] = "descended"
                entry["input_hex"] = res.input.hex()
                entry["reason"] = (f"branch-distance descent: witness "
                                   f"after {res.steps} batches")
                seeds.append(res.input)   # chain: deeper edges seed
                n += 1                    # from this witness
            else:
                reg.count("search_exhausted")
            self.cache[self._key(e)] = entry
            fuzzer.telemetry.event(
                "descent", edge=f"{e[0]}:{e[1]}", status=res.status,
                steps=int(res.steps), evals=int(res.evals),
                engine=res.engine, dispatches=int(res.dispatches),
                i2s=bool(res.i2s),
                best_dist=(None if res.input else float(res.best_dist)))
        if attempted:
            INFO_MSG("descend: %d unknown edges, %d attempts, %d "
                     "cracked (%.2fs)", len(cand), attempted, n,
                     time.time() - t0)
        return attempted

    def _inject(self, fuzzer, bufs: List[bytes]) -> int:
        """Run solved candidates through the MAIN instrumentation (so
        its virgin maps absorb the new coverage) and hand each lane to
        the loop's triage — findings dedup, persist, sync and enter
        rotation exactly like mutated ones."""
        from ..mutators.base import pack_byte_rows
        instr = fuzzer.driver.instrumentation
        inputs, lengths = pack_byte_rows(bufs)
        try:
            res = instr.run_batch(inputs, lengths)
        except Exception as e:      # cracking must never kill the loop
            WARNING_MSG("crack injection failed: %s", e)
            return 0
        # statuses arrive hang-mapped (run_batch folds FUZZ_RUNNING)
        statuses = _host(res.statuses)
        new_paths = _host(res.new_paths)
        uc = _host(res.unique_crashes)
        uh = _host(res.unique_hangs)
        reg = fuzzer.telemetry.registry
        n = len(bufs)
        fuzzer.stats.iterations += n
        reg.rate("execs", n)
        reg.count("solver_injected", n)
        prev_credit = fuzzer._credit_arm
        fuzzer._credit_arm = None       # solver finds credit the base
        try:
            for i in range(n):
                fuzzer._triage_lane(int(statuses[i]),
                                    int(new_paths[i]), bufs[i],
                                    bool(uc[i]), bool(uh[i]))
        finally:
            fuzzer._credit_arm = prev_credit
        return n

    def _update_mask(self, fuzzer, remaining) -> None:
        mut = fuzzer.driver.mutator
        if not remaining:
            mut.set_focus_mask(None)
            reg = fuzzer.telemetry.registry
            reg.gauge("solver_frontier", 0)
            return
        if self._dataflow is None:
            self._dataflow = analyze_dataflow(self.program)
        mask = edge_dep_mask(self.program, remaining, self._dataflow)
        mut.set_focus_mask(mask)
        fuzzer.telemetry.registry.gauge(
            "solver_focus_bytes", len(mask) if mask else 0)
        DEBUG_MSG("crack: focus mask %s over %d frontier edges",
                  mask, len(remaining))
