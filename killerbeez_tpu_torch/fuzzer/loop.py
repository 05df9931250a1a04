"""The fuzzing main loop — batch generalization of the reference's
iteration loop (fuzzer/main.c:370-418).

Per step: mutate a candidate batch on the device -> execute -> novelty
and verdict reduce on the device -> copy only the packed verdicts and
the interesting lanes to the host -> md5-dedup and write findings to
``output/{crashes,hangs,new_paths}/<md5>`` like the reference.

Device work is asynchronous: every batch's packed verdict bytes and
compact report are copied to pinned host memory with non-blocking
copies and a CUDA event, and triage waits on the event only when it
reaches that batch, ``PIPELINE_DEPTH`` batches later.

Corpus feedback (on by default for randomized mutators): every
``feedback`` batches the scheduler (corpus/schedule.py) picks the next
seed from the edge-novel findings, and finds are credited to the arm
that GENERATED their batch, so rotation never drains the pipeline.
The registry (telemetry/) counts everything; the stats files, the
event log, the span ring, the corpus store and the watchdog hang off
it exactly as in the JAX package.

Not ported yet: generations, the crack and repair stages, sync, the
learn and hybrid tiers, device profiling, and the single-exec loop
(only batching backends exist).
"""

from __future__ import annotations

import base64
import contextlib
import json
import os
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from .. import FUZZ_CRASH, FUZZ_ERROR, FUZZ_HANG, FUZZ_NONE
from ..corpus.schedule import Arm, make_scheduler
from ..corpus.store import CorpusStore
from ..drivers.base import BatchOutcome, Driver
from ..instrumentation.base import CompactReport, pack_verdicts, \
    unpack_verdicts
from ..resilience.chaos import chaos_point
from ..telemetry import MetricsRegistry, Telemetry
from ..utils.fileio import ensure_dir, md5_hex, write_buffer_to_file
from ..utils.logging import CRITICAL_MSG, DEBUG_MSG, INFO_MSG, WARNING_MSG


def _host(x) -> np.ndarray:
    """numpy view of a tensor (copied from the device if need be), a
    host copy, or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _HostCopy:
    """A device tensor's host copy, started without blocking: a
    non-blocking copy into pinned memory plus a CUDA event, waited on
    only when the host reads it.  CPU tensors are used as they are."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t
        self._np = None

    def ready(self) -> bool:
        """Whether the copy has landed — a probe that never waits."""
        return self._np is not None or self._event is None \
            or self._event.query()

    def materialize(self) -> np.ndarray:
        if self._np is None:
            if self._event is not None:
                self._event.synchronize()
            self._np = self._host.numpy()
        return self._np

    def __array__(self, dtype=None, copy=None):
        a = self.materialize()
        return a.astype(dtype) if dtype is not None else a

    def row(self, i: int) -> "_LazyRow":
        return _LazyRow(self, i)


class _LazyRow:
    """numpy-coercible view of one row of a stacked _HostCopy."""

    def __init__(self, holder: _HostCopy, i: int):
        self._holder = holder
        self._i = i

    def ready(self) -> bool:
        return self._holder.ready()

    def __array__(self, dtype=None, copy=None):
        r = np.asarray(self._holder.materialize()[self._i])
        return r.astype(dtype) if dtype is not None else r


class FuzzStats:
    """Thin live view over the telemetry ``MetricsRegistry`` — the
    registry is the single source of truth, so the loop, the CLI and
    the stats files can never disagree about counts or rates.  Field
    reads/writes map straight onto registry counters; ``iterations``
    is the registry's ``execs`` series (AFL naming on the wire,
    reference naming in code)."""

    _FIELD_TO_SERIES = {
        "iterations": "execs", "crashes": "crashes", "hangs": "hangs",
        "new_paths": "new_paths", "unique_crashes": "unique_crashes",
        "unique_hangs": "unique_hangs", "errors": "errors",
    }

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._reg = registry if registry is not None \
            else MetricsRegistry()

    @property
    def registry(self) -> MetricsRegistry:
        return self._reg

    @property
    def elapsed(self) -> float:
        """Accumulated in-run wall time (sum of ``run()`` windows,
        not campaign age — warm-up gaps between runs don't count)."""
        return self._reg.active_seconds()

    @property
    def execs_per_sec(self) -> float:
        """Lifetime rate over in-run time."""
        return self._reg.execs_per_sec()

    @property
    def execs_per_sec_ema(self) -> float:
        """Recent rate (EMA over the registry's horizon)."""
        return self._reg.execs_per_sec_ema()

    def as_dict(self) -> Dict[str, float]:
        d: Dict[str, float] = {f: getattr(self, f)
                               for f in self._FIELD_TO_SERIES}
        d["elapsed"] = self.elapsed
        d["execs_per_sec"] = self.execs_per_sec
        d["execs_per_sec_ema"] = self.execs_per_sec_ema
        return d


def _stat_field(series: str) -> property:
    def _get(self: FuzzStats) -> int:
        return int(self._reg.counters.get(series, 0))

    def _set(self: FuzzStats, v: int) -> None:
        self._reg.counters[series] = int(v)

    return property(_get, _set)


for _f, _s in FuzzStats._FIELD_TO_SERIES.items():
    setattr(FuzzStats, _f, _stat_field(_s))


class Fuzzer:
    """Drives driver/instrumentation/mutator to completion."""

    #: corpus-feedback cap: rotation cycles at most this many of the
    #: most recent new-path findings (older ones stay on disk)
    CORPUS_CAP = 256

    #: K-step superbatch default for the fused path (1 disables)
    ACCUMULATE_AUTO = 8

    #: default corpus-feedback cadence (batches between rotations)
    #: when feedback < 0: on for RANDOMIZED mutators
    #: (get_total_iteration_count() == -1), off for deterministic
    #: walks, whose iteration contract a mid-walk seed swap would
    #: change (an explicit -fb N still applies to them).  8 matches
    #: the superbatch depth, and because finds are credited to the
    #: GENERATING arm, rotation reads the corpus without draining the
    #: pipeline.  Rotation only engages once edge-novel findings
    #: exist, so finding-free runs behave exactly as with feedback off.
    FEEDBACK_AUTO = 8

    #: batches kept in flight before their results are read on the
    #: host: device work is enqueued ahead while earlier copies land
    PIPELINE_DEPTH = 24

    #: seconds between campaign checkpoints to the corpus store
    #: (admissions write through at once; run end always saves)
    PERSIST_INTERVAL = 5.0

    #: tier tag stamped onto minted corpus entries (the sidecar's
    #: "tier"): this loop is the CUDA device tier
    tier_tag = "cuda"

    def __init__(self, driver: Driver, output_dir: str = "output",
                 batch_size: int = 1024,
                 feedback: int = -1, accumulate: int = 0,
                 stats: bool = True,
                 stats_interval: float = 5.0,
                 scheduler: str = "bandit",
                 corpus_dir: Optional[str] = None,
                 resume: bool = False,
                 trace: int = 0,
                 events_max_mb: float = 0.0,
                 watchdog=None):
        if not driver.supports_batch:
            raise ValueError("only batching backends are ported yet")
        self.driver = driver
        self.output_dir = output_dir
        self.batch_size = int(batch_size)
        # observability: the registry ALWAYS runs (FuzzStats is a view
        # over it); ``stats=False`` (CLI --no-stats) only disables the
        # stats files and the event log.  ``trace`` > 0 turns the span
        # ring on with that many events.  A NON-resume campaign starts
        # a fresh event timeline even in a reused output dir; --resume
        # continues the log.
        telemetry = Telemetry(
            output_dir if stats else None, interval_s=stats_interval,
            trace=trace, fresh_events=not resume,
            events_max_bytes=int(float(events_max_mb) * 1e6))
        self.telemetry = telemetry
        # drivers time their mutate/execute phases with the loop's
        # stage timer (base.Driver.test_batch)
        driver.stage_timer = telemetry.timer
        if feedback < 0:
            mut = getattr(driver, "mutator", None)
            randomized = (mut is not None
                          and mut.get_total_iteration_count() < 0)
            feedback = self.FEEDBACK_AUTO if randomized else 0
        #: fused superbatch depth: 0 = auto (ACCUMULATE_AUTO when the
        #: driver supports the fused-multi path), 1 = per-batch
        self.accumulate = int(accumulate)
        #: every `feedback` batches, rotate the mutator seed through
        #: new-path findings (coverage-guided corpus loop; 0 = off)
        self.feedback = int(feedback)
        # the scheduler owns the arms ([buf, selections, finds] +
        # metadata), the base-seed stats and the per-period credit
        # fold; the loop owns WHEN to rotate and the shape-stable
        # seed swap
        self.scheduler = make_scheduler(scheduler, cap=self.CORPUS_CAP)
        #: durable corpus tier: admissions write through immediately;
        #: scheduler/campaign state flushes every PERSIST_INTERVAL seconds
        self.store = CorpusStore(corpus_dir) if corpus_dir else None
        #: monotone dispatched-batch counter — the flight recorder
        #: maps it onto PIPELINE_DEPTH trace lanes (seq % depth)
        self._batch_seq = 0
        self._last_persist = 0.0
        #: dispatch watchdog (resilience/watchdog.py): a deadline on
        #: every blocking device wait; a stall dumps in-flight lane
        #: state and exits for a supervisor-mediated restart
        self.watchdog = watchdog
        if watchdog is not None:
            watchdog.registry = telemetry.registry
            watchdog.telemetry = telemetry
            watchdog.dump_fn = self._watchdog_dump
            watchdog.note_batch(self.batch_size)
        #: live view of the pipeline's pending deque for the watchdog
        #: dump (set by _run_batched)
        self._pending = None
        # the arm whose candidates the batch being TRIAGED came from:
        # triage lags generation by the pipeline, so finds credit the
        # GENERATING arm (entry object, robust to corpus index
        # shifts), not whichever arm is active at triage time
        self._credit_arm: Optional[list] = None
        self._active_entry: Optional[list] = None
        self._iter_base = 0             # execs restored by --resume
        self._fb_batches = 0
        self._accum_warned = False
        self.stats = FuzzStats(telemetry.registry)
        self._seen = {k: set() for k in ("crashes", "hangs", "new_paths")}
        for sub in ("crashes", "hangs", "new_paths"):
            ensure_dir(os.path.join(output_dir, sub))
        if resume:
            if self.store is None:
                raise ValueError("resume requires a corpus_dir")
            self._restore_campaign()

    # -- campaign persistence / resume (corpus/store.py) ----------------

    def _persist_campaign(self, force: bool = False,
                          now: bool = False) -> None:
        """Flush the campaign to the corpus store as ONE atomic
        checkpoint epoch (resilience/checkpoint.py), in the JAX
        package's format.  ``now`` skips the interval gate but stays
        host-side; ``force`` (run end, including interrupts) adds the
        mutator/instrumentation resume states, whose serialization
        waits for the card (never from the watchdog — the card is the
        thing that is stuck)."""
        if self.store is None:
            return
        t = time.time()
        if not force and not now and \
                t - self._last_persist < self.PERSIST_INTERVAL:
            return
        self._last_persist = t
        base = self.scheduler.base_seed
        reg = self.telemetry.registry
        counters = dict(reg.counters)
        # run_seconds is normally folded at run_ended(); a hard kill
        # never gets there, so snapshot the LIVE active time
        counters["run_seconds"] = reg.active_seconds()
        doc = {"campaign": {
            "version": 1,
            "scheduler_state": self.scheduler.state_dict(),
            "counters": counters,
            # arm stats ride in THIS snapshot (one atomic write per
            # interval); per-arm sidecars rewrite only on force
            "arm_stats": {a.md5: [float(a[1]), float(a[2])]
                          for a in self.scheduler.arms},
            "fb_batches": self._fb_batches,
            "feedback": self.feedback,
            "base_seed_b64": (base64.b64encode(base).decode()
                              if base else None),
            "saved_at": t,
        }}
        if self.telemetry.events is not None:
            # the log's high-water at save time: resume anchors seq
            # at max(file tail, checkpoint)
            doc["event_seq"] = self.telemetry.events.next_seq
        if force:
            components = {}
            mut = getattr(self.driver, "mutator", None)
            instr = getattr(self.driver, "instrumentation", None)
            for which, comp in (("mutator", mut),
                                ("instrumentation", instr)):
                if comp is None:
                    continue
                try:
                    components[which] = comp.get_state()
                except NotImplementedError:
                    pass
                except Exception as e:
                    WARNING_MSG("%s state persist failed: %s",
                                which, e)
            doc["components"] = components
        self.store.save_checkpoint(doc)
        if force:
            for arm in self.scheduler.arms:
                self.store.update_meta(arm.to_entry())

    def _restore_campaign(self) -> None:
        """Rebuild scheduler arms, campaign counters and component
        states from the corpus store — ``--resume`` continues a killed
        campaign (of either package) where it stopped."""
        entries = self.store.load()
        self.scheduler.load_entries(entries)
        for e in entries:
            self._seen["new_paths"].add(e.md5)
        # the output dir carries findings the store does not (bucket-
        # only new paths, crashes, hangs) — recover their md5 names so
        # dedup and the corpus_seen gauge continue exactly
        for kind in self._seen:
            d = os.path.join(self.output_dir, kind)
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                if len(name) == 32 and all(
                        c in "0123456789abcdef" for c in name):
                    self._seen[kind].add(name)
        st = self.store.load_state()
        if st:
            ss = st.get("scheduler_state") or {}
            if ss.get("scheduler") not in (None, self.scheduler.name):
                WARNING_MSG(
                    "resuming a %s-scheduled campaign with %s: arm "
                    "stats carry over, policy state starts fresh",
                    ss.get("scheduler"), self.scheduler.name)
            else:
                self.scheduler.load_state(ss)
            reg = self.telemetry.registry
            for k, v in (st.get("counters") or {}).items():
                reg.counters[k] = v
            # arm stats from the campaign snapshot (fresher than the
            # sidecars between force-persists)
            stats = st.get("arm_stats") or {}
            for a in self.scheduler.arms:
                if a.md5 in stats:
                    a[1], a[2] = stats[a.md5]
            self._fb_batches = int(st.get("fb_batches", 0))
            b64 = st.get("base_seed_b64")
            if b64:
                self.scheduler.base_seed = base64.b64decode(b64)
        mut = getattr(self.driver, "mutator", None)
        instr = getattr(self.driver, "instrumentation", None)
        for which, comp in (("mutator", mut),
                            ("instrumentation", instr)):
            if comp is None:
                continue
            state = self.store.load_component_state(which)
            if state is None:
                continue
            try:
                comp.set_state(state)
            except Exception as e:
                WARNING_MSG("%s state restore failed (fresh %s "
                            "state): %s", which, which, e)
        # no-event-seq-regression invariant: even if events.jsonl was
        # torn away or truncated, the checkpoint's high-water keeps
        # the resumed stream monotone for every cursor consumer
        ck = self.store.load_checkpoint()
        if ck and self.telemetry.events is not None:
            try:
                self.telemetry.events.ensure_seq_at_least(
                    int(ck.get("event_seq", 0)))
            except (TypeError, ValueError):
                pass
        # -n counts THIS invocation's executions; restored lifetime
        # counters keep stats files and rates cumulative
        self._iter_base = int(self.stats.iterations)
        reg = self.telemetry.registry
        reg.gauge("corpus_seen", len(self._seen["new_paths"]))
        reg.gauge("corpus_arms", len(self.scheduler.arms))
        INFO_MSG("resumed campaign: %d stored entries, %d rotation "
                 "arms, %d execs done",
                 len(entries), len(self.scheduler.arms),
                 self.stats.iterations)

    # -- finding triage (reference fuzzer/main.c:393-417) ---------------

    def _record(self, kind: str, buf: bytes,
                digest: Optional[str] = None) -> bool:
        """Write a finding, deduped by input md5. Returns True if new.
        ``digest`` skips rehashing when the caller already has it."""
        digest = digest or md5_hex(buf)
        if digest in self._seen[kind]:
            return False
        self._seen[kind].add(digest)
        name = "crash" if kind == "crashes" else kind.rstrip("es")
        path = os.path.join(self.output_dir, kind, digest)
        if os.path.exists(path):  # left over from a previous run
            return False
        with self.telemetry.timer("fs_write"):
            write_buffer_to_file(path, buf)
        CRITICAL_MSG("Found a %s! Saving result to %s", name, path)
        return True

    def _parent_bytes(self, parent: Optional[str]) -> Optional[bytes]:
        """Resolve a lineage parent key to its input bytes: the base
        seed, a live rotation arm, or (last) the corpus store entry
        on disk.  None when unresolvable."""
        if parent in (None, "base"):
            base = self.scheduler.base_seed
            if base is not None:
                return base
            mut = getattr(self.driver, "mutator", None)
            return getattr(mut, "seed_bytes", None)
        for a in self.scheduler.arms:
            if getattr(a, "md5", None) == parent:
                return a[0]
        if self.store is not None:
            try:
                with open(self.store.entry_path(parent), "rb") as f:
                    return f.read()
            except OSError:
                return None
        return None

    def _admit_arm(self, buf: bytes, digest: str) -> None:
        """The ADMISSION stage of triage: mint a corpus arm for an
        edge-novel finding — store write-through, scheduler admission,
        and one find credited to the arm that GENERATED the
        batch (None: the base seed).  It mints no duplicate arm without
        scanning the arms: every arm's md5 is in the new-path dedup
        set, so a digest recorded for the first time is no arm's, and
        the ``heal`` re-admission checks the arms itself."""
        credit = self._credit_arm
        arm = Arm(buf, parent=getattr(credit, "md5", None) or "base",
                  discovered=time.time(), tier=self.tier_tag)
        if self.store is not None and not os.path.exists(
                self.store.entry_path(digest)):
            arm.seq = self.store.next_seq()
            with self.telemetry.timer("fs_write"):
                self.store.put(arm.to_entry())
        if self.feedback:
            # admission evicts the oldest arm beyond the cap
            # (rotation only — the store keeps it); the ENTRY-object
            # credit pointers stay valid regardless
            self.scheduler.admit(arm)
            self.scheduler.credit_find(credit)
            self.telemetry.registry.gauge("corpus_arms",
                                          len(self.scheduler.arms))

    def _triage_lane(self, status: int, new_path: int, buf: bytes,
                     unique_crash: bool = False,
                     unique_hang: bool = False) -> None:
        """VERDICT + RECORD stages of one lane's triage (counters,
        finding files, events, dedup), then the admission stage for
        edge-novel lanes."""
        s = self.stats
        if status == FUZZ_CRASH:
            s.crashes += 1
            s.unique_crashes += int(unique_crash)
            digest = md5_hex(buf)
            self._record("crashes", buf, digest)
            if unique_crash:
                # event contract (telemetry/events.py): one crash
                # event per unique_crashes increment
                self.telemetry.event(
                    "crash", md5=digest,
                    crashes=int(s.crashes),
                    unique_crashes=int(s.unique_crashes))
        elif status == FUZZ_HANG:
            s.hangs += 1
            s.unique_hangs += int(unique_hang)
            digest = md5_hex(buf)
            self._record("hangs", buf, digest)
            if unique_hang:
                self.telemetry.event(
                    "hang", md5=digest, hangs=int(s.hangs),
                    unique_hangs=int(s.unique_hangs))
        elif status == FUZZ_ERROR:
            s.errors += 1
            WARNING_MSG("target exec error on iteration %d", s.iterations)
        if new_path > 0:
            s.new_paths += 1
            reg = self.telemetry.registry
            reg.rate("new_paths", 1)
            digest = md5_hex(buf)
            recorded = self._record("new_paths", buf, digest)
            # one new_path event per counter increment: the event
            # count reconciles exactly with fuzzer_stats paths_total
            self.telemetry.event(
                "new_path", md5=digest,
                edge_novel=bool(new_path == 2),
                new_paths=int(s.new_paths))
            # corpus_seen: distinct new-path inputs ever recorded;
            # corpus_arms: entries actually in rotation
            reg.gauge("corpus_seen", len(self._seen["new_paths"]))
            # corpus feedback keeps only EDGE-novel findings (ret 2);
            # bucket-only findings are overwhelmingly shallow
            # variants.  ``heal``: a kill can land BETWEEN the finding
            # write and the store write-through, leaving the finding
            # on disk (so the resume replay dedups it, recorded=False)
            # but absent from the store — re-admit exactly that case,
            # never minting a duplicate arm
            heal = (not recorded and self.store is not None
                    and new_path == 2
                    and not os.path.exists(
                        self.store.entry_path(digest))
                    and not any(getattr(a, "md5", None) == digest
                                for a in self.scheduler.arms))
            if (recorded or heal) and new_path == 2 and \
                    (self.feedback or self.store is not None):
                self._admit_arm(buf, digest)

    # -- loops ----------------------------------------------------------

    def run(self, n_iterations: int = -1) -> FuzzStats:
        """Run ``n_iterations`` executions (-1 = until the mutator
        exhausts)."""
        if self.stats.iterations == 0:
            # baseline snapshot: plot_data's first row is all-zero so
            # the sum of row deltas equals the cumulative counters
            self.telemetry.flush()
        self.telemetry.registry.run_started()
        try:
            self._run_batched(n_iterations)
        finally:
            if self.watchdog is not None:
                self.watchdog.stop()
            self.telemetry.registry.run_ended()
            self.telemetry.flush()
            # the span ring exports on every run end — interrupts
            # included, with still-open spans closed synthetically
            if self.telemetry.trace is not None:
                self.telemetry.export_trace(
                    os.path.join(self.output_dir, "trace.json"))
            # full campaign snapshot (scheduler + component states):
            # runs on clean exits AND interrupts, so --resume
            # continues exactly here
            self._persist_campaign(force=True)
        INFO_MSG("Ran %d iterations in %.1f seconds "
                 "(%.0f execs/s lifetime, %.0f recent)",
                 self.stats.iterations, self.stats.elapsed,
                 self.stats.execs_per_sec, self.stats.execs_per_sec_ema)
        return self.stats

    def _remaining(self, n_iterations: int) -> int:
        """Executions still owed to THIS run() call: a resumed
        campaign restores lifetime counters, so -n counts from the
        resume point, not from zero."""
        if n_iterations < 0:
            return 2**62 - self.stats.iterations
        return n_iterations - (self.stats.iterations - self._iter_base)

    @staticmethod
    def _compact_rows(compact):
        """{batch_lane: report_row} for a CompactReport, or None when
        the report overflowed (caller falls back to a full pull)."""
        count = int(np.asarray(compact.count).reshape(()))
        idx = np.asarray(compact.idx)
        if count > len(idx):
            return None
        return {int(idx[r]): r for r in range(count)}

    def _triage_batch(self, out: BatchOutcome, room: int,
                      done_through: int, packed,
                      arm: Optional[list] = None,
                      lane: Optional[int] = None) -> None:
        """Triage one batch from its packed verdict bytes; the
        candidate bytes cross to the host only for interesting lanes.
        ``done_through`` is the global iteration count as of THIS
        batch (the pipeline runs ahead of triage); ``arm`` is the arm
        that generated it; ``lane`` is the flight recorder's pipeline
        slot, whose in-flight span this closes."""
        tr = self.telemetry.trace
        if tr is not None and lane is not None:
            tr.lane = lane
            tr.async_end("in_flight", lane)
        self._credit_arm = arm
        timer = self.telemetry.timer
        with self._wd_guard("host_transfer"), timer("host_transfer"):
            # chaos seam INSIDE the guard: a "hang" here is exactly
            # what a wedged card looks like from the host — an event
            # that never completes
            chaos_point("device_wait")
            pk = np.asarray(packed)
        statuses, new_paths, uc, uh = unpack_verdicts(pk)
        statuses = statuses.astype(np.int32)
        interesting = np.flatnonzero(
            (statuses[:room] != FUZZ_NONE) | (new_paths[:room] > 0))
        if len(interesting):
            with timer("triage"):
                self._triage_interesting(out, interesting, statuses,
                                         new_paths, uc, uh)
        DEBUG_MSG("batch done: %d iterations total", done_through)

    def _triage_interesting(self, out, interesting, statuses,
                            new_paths, uc, uh) -> None:
        """Pull and record the interesting lanes of one batch: from
        the compact report when it holds them all, else from the full
        candidate tensors."""
        rows = None
        if out.compact is not None:
            rows = self._compact_rows(out.compact)
            if rows is not None:
                inputs = np.asarray(out.compact.bufs)
                lengths = np.asarray(out.compact.lens)
        if rows is None:
            inputs = _host(out.inputs)
            lengths = _host(out.lengths)
        for i in interesting:
            r = i
            if rows is not None:
                r = rows.get(int(i))
                if r is None:
                    # the device-side interesting predicate drifted
                    # from the host one: read the full batch instead
                    WARNING_MSG("compact report missing lane %d; "
                                "pulling full batch", int(i))
                    inputs = _host(out.inputs)
                    lengths = _host(out.lengths)
                    rows = None
                    r = i
            buf = inputs[r, :int(lengths[r])].tobytes()
            self._triage_lane(int(statuses[i]), int(new_paths[i]),
                              buf, bool(uc[i]), bool(uh[i]))

    @staticmethod
    def _prefetch(out: BatchOutcome):
        """Pack the four verdict arrays into one uint8 lane byte on
        the device and start the host copies of it and of the compact
        report without blocking.  Returns (out, packed copy)."""
        if out.compact is not None:
            out = out._replace(compact=CompactReport(
                *(_HostCopy(a) for a in out.compact)))
        res = out.result
        return out, _HostCopy(pack_verdicts(res.statuses, res.new_paths,
                                            res.unique_crashes,
                                            res.unique_hangs))

    def _wd_guard(self, stage: str):
        """Watchdog deadline over one blocking region (no-op without
        a watchdog installed)."""
        if self.watchdog is None:
            return contextlib.nullcontext()
        return self.watchdog.guard(stage)

    def _watchdog_dump(self, stage: str, waited: float,
                       deadline: float) -> None:
        """Stall post-mortem, called from the WATCHDOG thread while
        the main thread is stuck: snapshot the in-flight pipeline
        lanes into <output>/watchdog_dump.json, overlay them on the
        flight recorder and export trace.json, then checkpoint the
        host-side campaign state (``now=True``, never ``force`` —
        component serialization would wait for the stuck card)."""
        pend = []
        for item in list(self._pending or []):
            out, room, iters, packed, arm_entry, lane = item
            pend.append({"iterations": int(iters), "room": int(room),
                         "lane": lane,
                         "arm": getattr(arm_entry, "md5", None)})
        tr = self.telemetry.trace
        if tr is not None:
            for p in pend:
                tr.instant("watchdog_in_flight", args=p)
            self.telemetry.export_trace(
                os.path.join(self.output_dir, "trace.json"))
        doc = {"t": time.time(), "stage": stage,
               "waited_s": round(waited, 3),
               "deadline_s": round(deadline, 3),
               "iterations": int(self.stats.iterations),
               "batch_seq": int(self._batch_seq),
               "pending": pend}
        try:
            write_buffer_to_file(
                os.path.join(self.output_dir, "watchdog_dump.json"),
                json.dumps(doc, default=str).encode())
        except OSError as e:
            WARNING_MSG("watchdog dump write failed: %s", e)
        self._persist_campaign(now=True)

    def _trace_lane(self, tr) -> int:
        """Point the recorder at THIS batch's pipeline lane (one of
        PIPELINE_DEPTH slots, reused round-robin) and return the lane
        id for the pending tuple."""
        lane = self._batch_seq % self.PIPELINE_DEPTH
        tr.name_lane(lane, f"batch-{lane:02d}")
        tr.lane = lane
        return lane

    def _credit_period(self) -> None:
        """Close one feedback period: the scheduler decays every
        arm's stats and charges the period to the arm ENTRY that
        generated it; ``feedback`` rides along as the period length in
        batches (``Scheduler.credit_period`` compounds the per-batch
        decay)."""
        self.scheduler.credit_period(self._active_entry, self.feedback)
        reg = self.telemetry.registry
        reg.gauge("corpus_arms", len(self.scheduler.arms))
        reg.gauge("corpus_favored", self.scheduler.favored_count())

    def _rotate_seed(self, mut) -> None:
        """Coverage-guided corpus feedback: WHICH seed fuzzes next is
        the scheduler's call; the loop keeps the mechanics.  The seed
        swap keeps the candidate width L (the kernels' launch shape
        and shared-memory plan), the walk position stays monotonic,
        and findings too wide for the buffer are dropped from
        rotation."""
        self.scheduler.rotations += 1
        while True:
            best, cand = self.scheduler.select()
            if cand is None:
                return                # nothing schedulable
            try:
                it = mut.get_current_iteration()
                mut.set_input(cand, keep_length=True)
                # keep the walk position monotonic: set_input resets
                # it, but a re-visited seed must get FRESH candidate
                # keys, not replay the (seed, iteration) pairs it
                # already executed
                mut.iteration = it
                self._active_entry = (None if best is None
                                      else self.scheduler.arms[best])
                self.telemetry.event(
                    "scheduler_pick",
                    arm=(getattr(self._active_entry, "md5", None)
                         or "base"),
                    policy=self.scheduler.name,
                    rotation=int(self.scheduler.rotations))
                DEBUG_MSG("feedback: arm %s (%s), %d-byte input",
                          best, self.scheduler.name, len(cand))
                return
            except ValueError:       # finding wider than the buffer
                if best is None:
                    return            # base seed itself doesn't fit
                self.scheduler.drop(best)

    def _resolve_accumulate(self) -> int:
        """Effective superbatch depth K.  Auto engages only on the
        fused device path; corpus feedback requires the rotation
        cadence to land on superbatch boundaries (K divides
        ``feedback``), else K degrades to the largest divisor."""
        k = self.accumulate if self.accumulate > 0 \
            else self.ACCUMULATE_AUTO
        if k <= 1 or not self.driver.supports_fused_multi():
            return 1
        if self.feedback:
            while k > 1 and self.feedback % k:
                k -= 1
            if self.accumulate > 1 and k != self.accumulate \
                    and not self._accum_warned:
                self._accum_warned = True
                WARNING_MSG(
                    "accumulate: explicit -K %d degraded to %d — a "
                    "superbatch may not stride a corpus-feedback "
                    "rotation boundary, so K must divide the "
                    "feedback cadence (-fb %d); pass a -K that "
                    "divides -fb (or adjust -fb) to keep it",
                    self.accumulate, k, self.feedback)
        return k

    def _after_dispatch(self, n: int, pending) -> None:
        """Per-dispatch bookkeeping: rates, gauges, the stats files
        and the campaign checkpoint (each time-gated)."""
        reg = self.telemetry.registry
        reg.rate("execs", n)
        reg.gauge("pipeline_depth", len(pending))
        self.telemetry.maybe_flush()
        self._persist_campaign()

    def _run_superbatch(self, k: int, pending, depth) -> None:
        """Execute K fused batches in one call and enqueue K per-step
        triage entries over shared stacked host copies."""
        b = self.batch_size
        tr = self.telemetry.trace
        if tr is not None:
            # the fused call covers k batches; its execute span lands
            # on the first slot
            self._trace_lane(tr)
        with self._wd_guard("dispatch"):
            chaos_point("device_dispatch")
            packed, bufs, lens, compact = \
                self.driver.test_batch_fused_multi(b, k)
        ph = _HostCopy(packed)
        idxh, sbh, slh, cnth = (_HostCopy(a) for a in compact)
        for j in range(k):
            self.stats.iterations += b
            self._fb_batches += 1
            lane = None
            if tr is not None:
                lane = self._trace_lane(tr)
                tr.async_begin("in_flight", lane,
                               args={"batch": self._batch_seq, "n": b})
            self._batch_seq += 1
            out = BatchOutcome(
                result=None, inputs=bufs[j], lengths=lens[j],
                compact=CompactReport(idx=idxh.row(j), bufs=sbh.row(j),
                                      lens=slh.row(j),
                                      count=cnth.row(j)))
            pending.append((out, b, self.stats.iterations, ph.row(j),
                            self._active_entry, lane))
            if len(pending) >= depth:
                self._triage_batch(*pending.popleft())
        self._after_dispatch(b * k, pending)

    def _drain_ready(self, pending) -> None:
        """Triage every leading pending batch whose host copy has
        already landed (a CUDA event query, never a wait): keeps the
        corpus fresh at rotation boundaries without stalling the
        pipeline."""
        while pending and pending[0][3].ready():
            self._triage_batch(*pending.popleft())

    def _run_batched(self, n_iterations: int) -> None:
        mut = self.driver.mutator
        pending: "deque" = deque()
        self._pending = pending         # watchdog-dump visibility
        depth = self.PIPELINE_DEPTH
        accumulate = self._resolve_accumulate()
        if self.feedback and self.scheduler.base_seed is None and \
                getattr(mut, "seed_bytes", None):
            # the baseline seed anchors the rotation: findings ADD
            # exploration frontiers without abandoning the proven seed
            self.scheduler.base_seed = mut.seed_bytes
        try:
            while True:
                room = min(self._remaining(n_iterations),
                           mut.remaining(), self.batch_size)
                if room <= 0:
                    break
                # the cadence counter lives on self: repeated short
                # run() calls must not reset the rotation clock
                if (self.feedback and self._fb_batches
                        and self._fb_batches % self.feedback == 0):
                    # freshen the corpus without stalling; while it is
                    # still EMPTY, force one pull — but only of an
                    # entry at least a full cadence old, whose copy
                    # has had a cadence of compute time to land
                    with self.telemetry.timer("corpus_feedback"):
                        self._drain_ready(pending)
                        if (not self.scheduler.arms and pending
                                and self.stats.iterations
                                - pending[0][2]
                                >= self.feedback * self.batch_size):
                            self._triage_batch(*pending.popleft())
                        self._credit_period()
                        if self.scheduler.arms:
                            self._rotate_seed(mut)
                # a superbatch may not stride over a feedback rotation
                # boundary (the check above only fires at loop top):
                # engage only when the next boundary is at least K
                # batches away — _fb_batches can enter run()
                # misaligned after short per-batch runs
                if self.feedback:
                    gap = (-self._fb_batches) % self.feedback \
                        or self.feedback
                else:
                    gap = accumulate
                if (accumulate > 1 and gap >= accumulate
                        and self._remaining(n_iterations)
                        >= accumulate * self.batch_size
                        and mut.remaining()
                        >= accumulate * self.batch_size):
                    self._run_superbatch(accumulate, pending, depth)
                    continue
                self._fb_batches += 1
                lane = None
                tr = self.telemetry.trace
                if tr is not None:
                    # mutate/execute spans (driver stage timer) land
                    # on this batch's pipeline lane
                    lane = self._trace_lane(tr)
                with self._wd_guard("dispatch"):
                    chaos_point("device_dispatch")
                    out = self.driver.test_batch(room)
                out, packed = self._prefetch(out)
                self.stats.iterations += room
                if tr is not None:
                    tr.async_begin("in_flight", lane,
                                   args={"batch": self._batch_seq,
                                         "n": room})
                self._batch_seq += 1
                pending.append((out, room, self.stats.iterations,
                                packed, self._active_entry, lane))
                if len(pending) >= depth:
                    self._triage_batch(*pending.popleft())
                self._after_dispatch(room, pending)
        finally:
            # findings in already-executed batches must survive an
            # interrupt or a raise
            while pending:
                self._triage_batch(*pending.popleft())
