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

With ``generations`` > 1 (CLI ``-G``) the card runs G whole
generations per dispatch (ops/generations.py) and the host only
drains the findings ring and the admission ledger, replaying them
through the same triage and admission stages.  ``profile_device``
(``--profile-device``) records a ``torch.profiler`` trace of the first
N batches or generations.  On a single-card CUDA campaign the loop
marks each dispatch for the device spans (telemetry/device.py), whose
batch marks the instrumentation records, and folds the ones the card
has passed after each dispatch, without waiting.

With a mesh driver (``parallel/campaign.py``, CLI ``--mesh dp,mp``)
the loop requests whole mesh batches, reads each dp shard's block of
the compact report, and drains mesh generation reports shard by shard
through their ``shard(d)`` views.

Host-executed targets (afl, ipt's ``qemu_mode``) batch the same way:
the driver runs a numpy batch of real processes while the mutator
generates the next one on the device, and the results come back as
numpy arrays.  Backends that cannot batch (return_code, debug) run the
single-exec loop, one input at a time.  ``debug_triage`` (CLI ``-dt``)
re-runs each unique crash once under the ptrace debug tier and writes
its signal-level details next to the repro.

The plateau crack stage (``fuzzer/crack.py``, CLI ``--crack``) hangs
off the host-driven loop: after each triage it may solve uncovered
edges, inject the solved inputs and install a focus mask, which stands
the fused path (and ``-G``) down until it clears; its solver cache
rides the campaign checkpoint.

With a stateful instrumentation (CLI ``--stateful``) every admission
records the entry's state x edge signature in its sidecar (the
admission candidates of a batch or dispatch signed in one session
batch), and the state-coverage gauges and ``state_cov`` events follow
the live state x edge map.

With a learn tier (learn/, CLI ``--learn``) admissions label the
byte-saliency model (and write their ``provenance`` into the sidecar),
bucket-only new paths label it negative, the model trains on the card
between dispatches, and its masks shape mutation: at each rotation in
the host-driven loop (``set_focus_mask``), per generation under ``-G``
(the weights ride each dispatch).  With a corpus sync (corpus/sync.py
or corpus/gossip.py, CLI ``--sync-manager``/``--gossip``) every
admission is noted for the fleet and a time-gated sync round runs
after each dispatch, with one forced round at the end of the run.

With a hybrid bridge (hybrid/, CLI ``--hybrid``) each unique crash or
hang is queued for validation on the real native binary, the verdicts
fold back into sidecars, events, counters and scheduler credit after
each dispatch, and the queue drains before the final sync round; the
plateau auto-repair stage (``fuzzer/repairer.py``, CLI
``--auto-repair``) rides the host-driven loop's plateau signal and
runs once more after that drain.
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
from ..ops.host_copy import HostCopy
from ..ops.vm_kernel import LAUNCHES
from ..resilience.chaos import chaos_point
from ..telemetry import DeviceSpans, MetricsRegistry, Telemetry
from ..utils.fileio import ensure_dir, md5_hex, write_buffer_to_file
from ..utils.logging import CRITICAL_MSG, DEBUG_MSG, INFO_MSG, WARNING_MSG


def _host(x) -> np.ndarray:
    """numpy view of a tensor (copied from the device if need be), a
    host copy, or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _quantum_warning(room: int, quantum: int) -> None:
    WARNING_MSG("stopping %d iterations early: the mesh executes whole "
                "%d-lane batches (-n should be a multiple of -b)", room,
                quantum)


def _marker() -> None:
    """One short kernel (``spin_kernel``) on the current stream: the
    device spans' anchor in a ``--profile-device`` capture."""
    torch.cuda._sleep(1)


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
                 batch_size: int = 1024, debug_triage: bool = False,
                 feedback: int = -1, accumulate: int = 0,
                 stats: bool = True,
                 stats_interval: float = 5.0,
                 scheduler: str = "bandit",
                 corpus_dir: Optional[str] = None,
                 resume: bool = False,
                 trace: int = 0,
                 events_max_mb: float = 0.0,
                 watchdog=None,
                 profile_device: int = 0,
                 generations: int = 0,
                 sync=None,
                 learn=None,
                 hybrid=None):
        self.driver = driver
        self.output_dir = output_dir
        self.batch_size = int(batch_size)
        #: re-run each unique crash once under the debug tier (-dt)
        self.debug_triage = debug_triage
        self._dbg = None
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
        #: device spans (telemetry/device.py): the card's time at the
        #: layer boundaries, on single-card CUDA campaigns; the fused
        #: steps and the generation loop mark them through the
        #: instrumentation, the loop marks each dispatch
        self.spans = None
        dev = getattr(driver, "device", None)
        if dev is not None and dev.type == "cuda" and \
                getattr(driver, "mesh", None) is None:
            self.spans = DeviceSpans(telemetry.registry, telemetry.trace)
            if driver.instrumentation is not None:
                driver.instrumentation.spans = self.spans
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
        #: manager-mediated corpus exchange (corpus/sync.py, or
        #: corpus/gossip.py's peer-to-peer one); polled between
        #: dispatches, time-gated inside
        self.sync = sync
        #: learned mutation shaping (learn/): a LearnTier collecting
        #: labels from the admission stream, training the byte-saliency
        #: model on its device between dispatches and serving masks —
        #: weights for the -G generation loops, set_focus_mask positions
        #: at rotation for the host-driven loop.  None = off
        self.learn = learn
        #: optional signature hook: bytes -> [edge slot, ...] for the
        #: entry sidecar (--schedule rare-edge; the CLI installs it)
        self._signer = None
        #: optional plateau crack stage (fuzzer/crack.py): solves
        #: statically-reachable-but-never-hit edges into concrete
        #: inputs when coverage stalls, and feeds the focused-
        #: mutation masks; installed by the CLI's --crack wiring
        self.cracker = None
        #: hybrid native⇄device bridge (hybrid/validate.py): unique
        #: findings enqueue for native validation in _triage_lane,
        #: verdicts fold back after every dispatch.  None = off
        self.hybrid = hybrid
        #: plateau auto-repair stage (fuzzer/repairer.py): consumes
        #: accumulated proxy-gap counterexamples into a verified
        #: patched proxy; installed by the CLI's --auto-repair wiring
        self.repairer = None
        #: monotone dispatched-batch counter — the flight recorder
        #: maps it onto PIPELINE_DEPTH trace lanes (seq % depth)
        self._batch_seq = 0
        self._last_persist = 0.0
        #: stateful session tier: last state-gauge refresh and the
        #: high-water of touched state x edge pairs (one state_cov
        #: event per increase)
        self._state_gauge_t = 0.0
        self._state_pairs_seen = 0
        #: state x edge signatures of the admission candidates of the
        #: batch or dispatch being triaged, made in one session batch
        #: (_presign) and consumed by _admit_arm
        self._state_sigs: Dict[bytes, list] = {}
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
        #: dump (set by _run_batched and _run_generations)
        self._pending = None
        #: --profile-device: batches (or generations) still to capture
        #: with torch.profiler into <output>/device_trace
        self.profile_device = int(profile_device)
        self._prof = None
        self._prof_active = False
        #: device-resident generation loop (--generations): the card
        #: runs this many full mutate->execute->triage->reseed
        #: generations per host dispatch and the host only drains the
        #: findings ring + admission ledger (ops/generations.py);
        #: <= 1 = host-driven loop.  Stands down (with a warning) when
        #: the driver or mutator cannot run it.
        self.generations = int(generations)
        self._gen_warned = False
        #: whether the CURRENT generations run reseeds on the device:
        #: with reseeding off the device ledger is empty, so the drain
        #: admits edge-novel ring lanes host-side instead — the store
        #: write-through contract holds in both regimes
        self._gen_reseed = True
        #: host mirror of the device seed-slot rings ((shard, slot) ->
        #: entry md5; shard 0 on a single device): the admission
        #: replay's parent map, rebuilt dispatch by dispatch from the
        #: device's per-shard ledgers
        self._ring_mirror: Dict[tuple, str] = {}
        # the arm whose candidates the batch being TRIAGED came from:
        # triage lags generation by the pipeline, so finds credit the
        # GENERATING arm (entry object, robust to corpus index
        # shifts), not whichever arm is active at triage time
        self._credit_arm: Optional[list] = None
        self._active_entry: Optional[list] = None
        self._iter_base = 0             # execs restored by --resume
        self._fb_batches = 0
        self._triage_seen = LAUNCHES["kbz_triage"]
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
        if self.cracker is not None:
            doc["solver"] = self.cracker.cache
        if self.learn is not None:
            # model weights + version ride the SAME epoch: --resume
            # restores the trained model (labels rebuild from the
            # provenance sidecars, see _restore_campaign)
            doc["learn"] = self.learn.state_dict()
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
        if self.learn is not None:
            if ck and isinstance(ck.get("learn"), dict):
                self.learn.load_state(ck["learn"])
            # labels rebuild from the persisted provenance sidecars
            # (entries without the field contribute nothing); explicit
            # reject negatives restart empty, which only slows
            # re-sharpening
            self.learn.bootstrap(entries, self._parent_bytes)
            self.telemetry.registry.gauge(
                "learn_model_version", self.learn.version)
            self.telemetry.registry.gauge(
                "learn_label_count", len(self.learn.labels))
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

    def _learn_admission(self, arm: Arm, buf: bytes,
                         parent: str) -> None:
        """Label one admission for the learn tier and attach the
        mutation-provenance record to the arm (it rides into the entry
        sidecar).  Best-effort: a failed label never blocks an
        admission."""
        if self.learn is None:
            return
        pbuf = self._parent_bytes(parent)
        if not pbuf:
            return
        mut = getattr(self.driver, "mutator", None)
        stage = None
        stage_fn = getattr(mut, "stage_name", None)
        if stage_fn is not None:
            try:
                stage = stage_fn()
            except Exception:
                stage = None
        arm.provenance = self.learn.note_admission(
            parent or "base", pbuf, buf, getattr(mut, "name", "?"), stage)

    _NO_CREDIT = object()   # credit sentinel: None credits the base seed

    def _admit_arm(self, buf: bytes, digest: str, parent: str,
                   credit=_NO_CREDIT) -> None:
        """The ADMISSION stage of triage: mint a corpus arm for an
        edge-novel finding — its coverage signature (``_signer``), the
        learn tier's labels and provenance, store write-through, the
        sync note, scheduler admission,
        and one find credited to ``credit``, the arm that GENERATED
        the batch (None: the base seed; ``_NO_CREDIT``: none, for the
        --generations ledger replay).  Shared by host-side lane triage
        and the ledger replay, which feeds the device ring's decisions
        back through this same contract.  Never mints a duplicate arm
        (a ring replay can re-present a digest: two identical mutants
        of one batch, or a lane the drain already recorded), checked
        against the scheduler's md5 set, not by a scan of the arms."""
        arm = Arm(buf, parent=parent, discovered=time.time(),
                  tier=self.tier_tag)
        if self._signer is not None:
            try:
                arm.sig = self._signer(buf)
            except Exception as e:
                WARNING_MSG("corpus signer failed: %s", e)
        # stateful session tier: the entry's state x edge signature for
        # its sidecar (pure side executions through the session
        # executor, made for the whole batch by _presign)
        ssig_fn = getattr(getattr(self.driver, "instrumentation", None),
                          "state_signature", None)
        if buf in self._state_sigs:
            arm.state_sig = self._state_sigs[buf]
        elif ssig_fn is not None:
            try:
                arm.state_sig = ssig_fn(buf)
            except Exception as e:
                WARNING_MSG("state signature failed: %s", e)
        # learn tier: positive labels + the provenance record BEFORE the
        # store write-through, so the sidecar carries it
        self._learn_admission(arm, buf, parent)
        if self.store is not None and not os.path.exists(
                self.store.entry_path(digest)):
            arm.seq = self.store.next_seq()
            with self.telemetry.timer("fs_write"):
                self.store.put(arm.to_entry())
        if self.sync is not None:
            self.sync.note_entry(arm.to_entry())
        if self.feedback and not self.scheduler.holds(digest):
            # admission evicts the oldest arm beyond the cap
            # (rotation only — the store keeps it); the ENTRY-object
            # credit pointers stay valid regardless
            self.scheduler.admit(arm)
            if credit is not self._NO_CREDIT:
                self.scheduler.credit_find(credit)
            self.telemetry.registry.gauge("corpus_arms",
                                          len(self.scheduler.arms))

    def _presign(self, rows) -> None:
        """Stateful session tier: sign the edge-novel lanes a batch or
        dispatch may admit (``rows``, an iterable of their bytes, read
        only when the tier is on) with one run of the session executor:
        on the card a side execution costs a whole message loop of small
        ops, so one per admission would dominate a campaign's early
        batches.  Lanes are independent, so each signature is the one
        ``state_signature`` gives that input alone."""
        self._state_sigs = {}
        instr = getattr(self.driver, "instrumentation", None)
        if getattr(instr, "stateful_spec", None) is None or not (
                self.feedback or self.store is not None):
            return
        bufs = list(rows)
        if not bufs:
            return
        try:
            sigs = instr.state_signatures(bufs)
        except Exception as e:
            WARNING_MSG("state signature failed: %s", e)
            return
        self._state_sigs = dict(zip(bufs, sigs))

    def _triage_lane(self, status: int, new_path: int, buf: bytes,
                     unique_crash: bool = False,
                     unique_hang: bool = False,
                     admit: bool = True) -> None:
        """VERDICT + RECORD stages of one lane's triage (counters,
        finding files, events, dedup), then — unless ``admit`` is
        False — the admission stage for edge-novel lanes.  The
        generations drain passes ``admit=False`` when the DEVICE made
        the admission decisions: it replays the ledger through
        _admit_arm instead."""
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
                if self.hybrid is not None:
                    # cross-tier triage: one native validation per
                    # UNIQUE finding — the dedup above is the rate limit
                    self.hybrid.enqueue(
                        "crash", buf, digest,
                        parent=getattr(self._credit_arm, "md5", None),
                        proxy_status=status)
                if self.debug_triage:
                    self._debug_repro(buf)
        elif status == FUZZ_HANG:
            s.hangs += 1
            s.unique_hangs += int(unique_hang)
            digest = md5_hex(buf)
            self._record("hangs", buf, digest)
            if unique_hang:
                self.telemetry.event(
                    "hang", md5=digest, hangs=int(s.hangs),
                    unique_hangs=int(s.unique_hangs))
                if self.hybrid is not None:
                    self.hybrid.enqueue(
                        "hang", buf, digest,
                        parent=getattr(self._credit_arm, "md5", None),
                        proxy_status=status)
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
                    and not self.scheduler.holds(digest))
            if (recorded or heal) and new_path == 2 and admit and \
                    (self.feedback or self.store is not None):
                self._admit_arm(
                    buf, digest,
                    parent=getattr(self._credit_arm, "md5", None)
                    or "base",
                    credit=self._credit_arm)
            elif recorded and new_path == 1 and self.learn is not None:
                # bucket-only new path — interesting but NOT admitted:
                # the admission stream's reject, labeled negative
                # (budget-capped inside the tier).  Parent = the
                # generating arm (the base seed in -G drains)
                pkey = getattr(self._credit_arm, "md5", None) or "base"
                pbuf = self._parent_bytes(pkey)
                if pbuf:
                    self.learn.note_reject(pkey, pbuf, buf)

    def _debug_repro(self, buf: bytes) -> None:
        """Re-run a unique crash once under the ptrace debug tier and
        log (and write to ``crashes/<md5>.info``) its signal-level
        details: fuzzing stays batched, crash detail single-exec.
        Device targets carry their detail in exit codes and are
        skipped."""
        instr = self.driver.instrumentation
        if instr is not None and instr.device_backed:
            return
        try:
            spec = self.driver._host_exec_spec()
        except (NotImplementedError, KeyError):
            return
        try:
            if self._dbg is None:
                from ..instrumentation.debug import DebugInstrumentation
                # inherit the batched tier's execution conditions: a
                # slow or rlimit-dependent crash must re-run under the
                # same timeout and mem_limit to reproduce
                opts = {key: instr.options[key]
                        for key in ("timeout", "mem_limit")
                        if key in getattr(instr, "options", {})}
                self._dbg = DebugInstrumentation(
                    json.dumps(opts) if opts else None,
                    device=instr.device)
            if spec.get("use_stdin"):
                self._dbg.enable(buf, cmd_line=spec["cmd_line"])
            else:
                write_buffer_to_file(spec["input_file"], buf)
                self._dbg.enable(None, cmd_line=spec["cmd_line"])
            desc = self._dbg.crash_description()
            CRITICAL_MSG("crash triage: %s", desc)
            write_buffer_to_file(
                os.path.join(self.output_dir, "crashes",
                             md5_hex(buf) + ".info"),
                (desc + "\n").encode())
        except Exception as e:  # triage detail must never stop fuzzing
            WARNING_MSG("debug triage failed: %s", e)

    # -- loops ----------------------------------------------------------

    def run(self, n_iterations: int = -1) -> FuzzStats:
        """Run ``n_iterations`` executions (-1 = until the mutator
        exhausts): batched when the driver batches, else one input at
        a time."""
        if self.stats.iterations == 0:
            # baseline snapshot: plot_data's first row is all-zero so
            # the sum of row deltas equals the cumulative counters
            self.telemetry.flush()
        self.telemetry.registry.run_started()
        if self.spans is not None:
            # --profile-device starts its capture before the anchor, so
            # that the anchor's marker kernel lands in it
            if self.profile_device and not self._prof_active:
                self._profile_start()
            self.spans.anchor(_marker if self._prof_active else None)
        try:
            if not self.driver.supports_batch:
                self._run_single(n_iterations)
            elif self.generations > 1:
                self._run_generations(n_iterations)
            else:
                self._run_batched(n_iterations)
        finally:
            if self.watchdog is not None:
                self.watchdog.stop()
            self._profile_stop()
            self._update_state_gauges(force=True)
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
            # hybrid bridge drain BEFORE the forced sync: verdicts
            # from in-flight native validations land in sidecars and
            # the event stream before the final push
            if self.hybrid is not None:
                self.hybrid.finish(self)
                # after the drain every verdict (and gap report) has
                # folded, so the run-end repair sees the full
                # counterexample set
                if self.repairer is not None:
                    self.repairer.finish(self)
            # one forced sync round last: entries triaged at the end
            # (a short campaign triages everything there) still reach
            # the fleet
            if self.sync is not None:
                self.sync.maybe_sync(self, force=True)
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
        the report overflowed (caller falls back to a full pull).
        ``count`` is a scalar (single device: valid rows are the first
        count) or a per-dp-shard vector (mesh campaigns: each shard
        owns a cap-row block of the report, lane ids are global)."""
        counts = np.asarray(compact.count).reshape(-1)
        idx = np.asarray(compact.idx)
        cap = len(idx) // len(counts)
        if (counts > cap).any():
            return None
        return {int(idx[s * cap + j]): s * cap + j
                for s, c in enumerate(counts) for j in range(int(c))}

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
        with timer("triage"):
            statuses, new_paths, uc, uh = unpack_verdicts(pk)
            statuses = statuses.astype(np.int32)
            interesting = np.flatnonzero(
                (statuses[:room] != FUZZ_NONE) | (new_paths[:room] > 0))
            if len(interesting):
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
        novel = (i if rows is None else rows.get(int(i))
                 for i in interesting if new_paths[i] == 2)
        self._presign(inputs[r, :int(lengths[r])].tobytes()
                      for r in novel if r is not None)
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
                *(HostCopy(a) for a in out.compact)))
        res = out.result
        return out, HostCopy(pack_verdicts(res.statuses, res.new_paths,
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
                # learned mask source (host-driven loop): focus the next
                # period's mutation on the model's salient bytes of the
                # freshly rotated seed; a None mask CLEARS — shaping
                # never outlives the seed it was computed for.  The
                # mask stands the fused superbatch down, as the crack
                # stage's masks do
                if self.learn is not None:
                    mut.set_focus_mask(
                        self.learn.focus_positions_for(cand),
                        pad_pow2=True)
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
        """Per-dispatch bookkeeping: rates, gauges, the device spans the
        card has passed, the learn tier's training, the stats files, the
        campaign checkpoint and the sync round (each time-gated)."""
        with self.telemetry.timer("telemetry"):
            reg = self.telemetry.registry
            reg.rate("execs", n)
            reg.gauge("pipeline_depth", len(pending))
            self._update_state_gauges()
            self._collect_spans()
            self._count_triage_kernels()
        self._between_dispatches()

    def _count_triage_kernels(self) -> None:
        """``triage_kernel_batches``: the batches the throughput-triage
        kernels judged (the growth of ``LAUNCHES["kbz_triage"]``).  On
        the card it equals the batches (generations) triaged in
        throughput mode: a shortfall is a batch that took another
        path."""
        n = LAUNCHES["kbz_triage"]
        if n != self._triage_seen:
            self.telemetry.registry.count("triage_kernel_batches",
                                          n - self._triage_seen)
            self._triage_seen = n

    def _collect_spans(self) -> None:
        """Fold the device spans of the dispatches the card has
        finished (never waits)."""
        if self.spans is not None:
            self.spans.collect()

    def _between_dispatches(self) -> None:
        """The loops' common tail after each dispatch: train the learn
        tier when due, flush the stats files, checkpoint, sync, fold
        the hybrid bridge's verdicts."""
        self._maybe_learn()
        with self.telemetry.timer("telemetry"):
            self.telemetry.maybe_flush()
        with self.telemetry.timer("checkpoint"):
            self._persist_campaign()
        if self.sync is not None:
            self.sync.maybe_sync(self)
        if self.hybrid is not None:
            self.hybrid.fold(self)

    def _maybe_learn(self) -> None:
        """Between-dispatches learn-tier hook: train the saliency model
        when due (time- and label-gated inside the tier — usually one
        cheap check).  The round runs on the card behind the in-flight
        fuzzing dispatches, which is why the model shares it."""
        if self.learn is None:
            return
        with self.telemetry.timer("learn"):
            self.learn.maybe_train(self.telemetry.registry,
                                   self.telemetry)

    def _run_superbatch(self, k: int, pending, depth) -> None:
        """Execute K fused batches in one call and enqueue K per-step
        triage entries over shared stacked host copies."""
        b = self.batch_size
        tr = self.telemetry.trace
        if tr is not None:
            # the fused call covers k batches; its execute span lands
            # on the first slot
            self._trace_lane(tr)
        sp = self.spans
        with self._wd_guard("dispatch"):
            chaos_point("device_dispatch")
            if sp is not None:
                sp.begin()
            packed, bufs, lens, compact = \
                self.driver.test_batch_fused_multi(b, k)
            if sp is not None:
                sp.end()
        ph = HostCopy(packed)
        idxh, sbh, slh, cnth = (HostCopy(a) for a in compact)
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
        # mesh campaigns execute whole mesh batches; a smaller tail is
        # skipped with a warning instead of dying mid-run
        quantum = getattr(self.driver, "batch_quantum", 1)
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
                    if mut.remaining() <= 0:
                        INFO_MSG("mutator exhausted after %d iterations",
                                 self.stats.iterations)
                    break
                if room < quantum:
                    _quantum_warning(room, quantum)
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
                # plateau crack: when no new paths for N batches,
                # solve uncovered static edges into inputs and inject
                # them ahead of the scheduler (the injected execs
                # triage synchronously — the pipeline keeps flowing).
                # Ready batches are triaged first so the plateau
                # verdict reads coverage as fresh as non-blocking
                # probes allow.
                if self.cracker is not None:
                    with self.telemetry.timer("corpus_feedback"):
                        self._drain_ready(pending)
                        self.cracker.maybe_crack(self)
                # conformance repair rides the same plateau signal:
                # coverage stalls are when spending host time on the
                # accumulated proxy-gap counterexamples is free
                if self.repairer is not None:
                    self.repairer.maybe_repair(self)
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
                # opt-in device capture: starts at the next dispatch,
                # stops after profile_device batches
                if self.profile_device and not self._prof_active:
                    self._profile_start()
                if (accumulate > 1 and gap >= accumulate
                        and self._remaining(n_iterations)
                        >= accumulate * self.batch_size
                        and mut.remaining()
                        >= accumulate * self.batch_size
                        # re-checked per batch: a crack-stage focus
                        # mask drops fused eligibility (the fused
                        # kernel draws its own edit positions and
                        # would silently ignore the mask)
                        and self.driver.supports_fused_multi()):
                    self._run_superbatch(accumulate, pending, depth)
                    self._profile_count(accumulate)
                    continue
                self._fb_batches += 1
                # the NEXT batch's size, so that a host driver's
                # mutator prefetches exactly what will be asked for (a
                # full-size stash before a smaller tail is stale)
                nxt = min(self._remaining(n_iterations) - room,
                          mut.remaining() - room, self.batch_size)
                lane = None
                tr = self.telemetry.trace
                if tr is not None:
                    # mutate/execute spans (driver stage timer) land
                    # on this batch's pipeline lane
                    lane = self._trace_lane(tr)
                sp = self.spans
                with self._wd_guard("dispatch"):
                    chaos_point("device_dispatch")
                    if sp is not None:
                        sp.begin()
                    # a short tail batch is padded to the batch size,
                    # as the JAX package pads it: a device backend's
                    # state counts the executed lanes, a host backend
                    # pads its results and counts the real ones
                    out = self.driver.test_batch(
                        room, pad_to=self.batch_size,
                        prefetch_next=max(nxt, 0))
                    if sp is not None:
                        sp.end()
                out, packed = self._prefetch(out)
                self.stats.iterations += room
                if tr is not None:
                    tr.async_begin("in_flight", lane,
                                   args={"batch": self._batch_seq,
                                         "n": room})
                self._batch_seq += 1
                self._profile_count(1)
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
            self._collect_spans()

    def _run_single(self, n_iterations: int) -> None:
        """The single-exec loop (backends that cannot batch: return_code,
        debug): one ``test_next_input`` per execution, triaged at once.
        Corpus feedback rotates every ``feedback`` batches' worth of
        executions, and ``--profile-device`` counts each execution as a
        batch."""
        instr = self.driver.instrumentation
        mut = self.driver.mutator
        rotate_every = self.feedback * self.batch_size
        if rotate_every and self.scheduler.base_seed is None and \
                getattr(mut, "seed_bytes", None):
            self.scheduler.base_seed = mut.seed_bytes
        reg = self.telemetry.registry
        while self._remaining(n_iterations) > 0:
            if (rotate_every and self.stats.iterations
                    and self.stats.iterations % rotate_every == 0):
                with self.telemetry.timer("corpus_feedback"):
                    self._credit_period()
                    if self.scheduler.arms:
                        self._rotate_seed(mut)
            if self.profile_device and not self._prof_active:
                self._profile_start()
            with self._wd_guard("execute"), \
                    self.telemetry.timer("execute"):
                chaos_point("device_dispatch")
                result = self.driver.test_next_input()
            if result is None:
                INFO_MSG("mutator exhausted after %d iterations",
                         self.stats.iterations)
                break
            self._profile_count(1)
            self.stats.iterations += 1
            reg.rate("execs", 1)
            buf = self.driver.get_last_input() or b""
            self._credit_arm = self._active_entry
            with self.telemetry.timer("triage"):
                self._triage_lane(result, instr.is_new_path(), buf,
                                  instr.last_unique_crash(),
                                  instr.last_unique_hang())
            self._between_dispatches()

    def _update_state_gauges(self, force: bool = False) -> None:
        """Stateful session tier: refresh the state-coverage gauges
        (state_cov_pairs / state_cov_states) from the live virgin map
        and emit one state_cov event per high-water increase.  Gated on
        the persist interval — the read waits for the card, so it must
        never ride the per-batch hot path.  A no-op when the tier is
        off."""
        instr = getattr(self.driver, "instrumentation", None)
        fn = getattr(instr, "state_coverage_stats", None)
        if fn is None:
            return
        t = time.time()
        if not force and t - self._state_gauge_t < self.PERSIST_INTERVAL:
            return
        self._state_gauge_t = t
        try:
            st = fn()
        except Exception as e:    # observability must never stop it
            WARNING_MSG("state coverage stats failed: %s", e)
            return
        if st is None:
            return                # tier off on this instrumentation
        pairs, states = st
        reg = self.telemetry.registry
        reg.gauge("state_cov_pairs", pairs)
        reg.gauge("state_cov_states", states)
        if pairs > self._state_pairs_seen:
            self._state_pairs_seen = pairs
            self.telemetry.event("state_cov", pairs=int(pairs),
                                 states=int(states))

    # -- opt-in device profiling (--profile-device) ---------------------

    def _profile_start(self) -> None:
        """Start a ``torch.profiler`` capture (CPU, and CUDA activity on
        the card) for the next ``profile_device`` batches or
        generations; ``_profile_stop`` writes it to
        ``<output>/device_trace/trace.json`` as a Chrome trace, next to
        the host ``trace.json``.  A profiler that cannot start warns
        and the campaign goes on — like every observability path."""
        try:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if getattr(self.driver, "device", None) is not None and \
                    self.driver.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            ensure_dir(os.path.join(self.output_dir, "device_trace"))
            prof = profile(activities=activities)
            prof.start()
            self._prof = prof
            self._prof_active = True
            INFO_MSG("device profiling: capturing %d batches to %s",
                     self.profile_device,
                     os.path.join(self.output_dir, "device_trace"))
        except Exception as e:
            WARNING_MSG("device profiling unavailable: %s", e)
            self.profile_device = 0

    def _profile_count(self, n: int) -> None:
        """Count ``n`` dispatched batches (or generations) against the
        capture; stop it once ``profile_device`` have run."""
        if self._prof_active:
            self.profile_device -= n
            if self.profile_device <= 0:
                self._profile_stop()

    def _profile_stop(self) -> None:
        if not self._prof_active:
            return
        self._prof_active = False
        self.profile_device = 0
        prof, self._prof = self._prof, None
        path = os.path.join(self.output_dir, "device_trace", "trace.json")
        try:
            prof.stop()
            prof.export_chrome_trace(path)
            INFO_MSG("device profile written to %s", path)
        except Exception as e:
            WARNING_MSG("device profile stop failed: %s", e)

    # -- device-resident generations (--generations) --------------------

    def _drain_generations(self, out, room, done_through, _packed,
                           _arm, lane) -> None:
        """Drain one G-generation dispatch: materialize the bounded
        findings ring + admission ledger (the ONLY device->host
        transfer in this mode), replay each interesting lane through
        the verdict/record triage stages, and replay the device's
        ring-admission decisions through the admission stage — in
        (generation, lane) order, exactly the order host-driven triage
        would have seen them.  Ring overflow is counted
        (``findings_ring_drops``) and warned, never silent.

        With reseeding OFF the device made no admission decisions (the
        ledger is empty), so edge-novel ring lanes admit through the
        normal host path instead — otherwise a ``-fb 0`` campaign with
        a corpus store would silently skip the write-through the
        host-driven loop performs."""
        tr = self.telemetry.trace
        if tr is not None and lane is not None:
            tr.lane = lane
            tr.async_end("in_flight", lane)
        timer = self.telemetry.timer
        if self.watchdog is not None:
            # the guarded wait below is on THIS dispatch: arm with its
            # own generation count, not the newest dispatch's — a
            # shrunken tail dispatch queued behind a full-G one must
            # not clamp the full-G drain to a 1-batch deadline
            self.watchdog.note_dispatch_scale(max(int(out.g), 1))
        with self._wd_guard("host_transfer"), timer("host_transfer"):
            # chaos seam INSIDE the guard: a "hang" here is what a
            # wedged card looks like from the host
            chaos_point("device_wait")
            h = out.materialize()
        with timer("triage"):
            self._replay_generations(h)
        DEBUG_MSG("generations dispatch done: %d iterations total",
                  done_through)

    def _replay_generations(self, h) -> None:
        """The triage of one drained ``-G`` dispatch ``h``: count ring
        overflow, then replay its interesting lanes and its ledger's
        admissions in (generation, lane) order."""
        reg = self.telemetry.registry
        # mesh outcomes carry a leading dp axis on every field EVEN at
        # dp = 1, so the discriminator is the shard() view, never the
        # shard count
        shard_view = getattr(h, "shard", None)
        views = [shard_view(d) for d in range(int(h.n_shards))] \
            if shard_view is not None else [h]
        stored = [min(int(v.fr_ptr), int(v.cap)) for v in views]
        drops = sum(int(v.fr_ptr) - st for v, st in zip(views, stored))
        if drops > 0:
            reg.count("findings_ring_drops", drops)
            WARNING_MSG(
                "generations: findings ring overflowed — %d "
                "interesting lanes dropped this dispatch (finding "
                "files/events under-report them; counters track the "
                "loss; raise jit_harness gen_findings_cap)", drops)
        verdicts = [unpack_verdicts(v.fr_pack[:st])
                    for v, st in zip(views, stored)]
        replay_adm = bool(self.feedback or self.store is not None)
        # reseeding off => the device ledger is empty by construction:
        # edge-novel ring lanes go through host-side admission, same
        # gates as the host-driven loop (with reseeding on the ledger
        # replay below owns admission and ring lanes must not)
        admit_ring = not self._gen_reseed
        self._credit_arm = None
        if replay_adm:
            def candidates():
                for v, (_s, new_paths, _c, _h) in zip(views, verdicts):
                    for j, a in np.argwhere(np.asarray(v.adm_valid) != 0):
                        yield v.adm_bufs[j, a, :int(v.adm_len[j, a])
                                         ].tobytes()
                    if admit_ring:
                        for e in np.flatnonzero(new_paths == 2):
                            yield v.fr_bufs[e, :int(v.fr_len[e])].tobytes()
            self._presign(candidates())

        def replay_lane(d, ei):
            v = views[d]
            statuses, new_paths, ucs, uhs = verdicts[d]
            buf = v.fr_bufs[ei, :int(v.fr_len[ei])].tobytes()
            self._triage_lane(int(statuses[ei]), int(new_paths[ei]), buf,
                              bool(ucs[ei]), bool(uhs[ei]),
                              admit=admit_ring)

        ei = [0] * len(views)
        for j in range(int(h.g)):
            gid = int(h.gen0) + j
            for d, v in enumerate(views):
                # this generation's interesting lanes first (each
                # ring is (gen, lane)-ordered), then the shard's
                # admissions
                while ei[d] < stored[d] and int(v.fr_gen[ei[d]]) <= gid:
                    replay_lane(d, ei[d])
                    ei[d] += 1
                if not replay_adm or not int(v.adm_raw[j]):
                    continue
                parent = self._ring_mirror.get((d, int(v.sel[j])),
                                               "base")
                for a in range(v.adm_valid.shape[1]):
                    if not int(v.adm_valid[j, a]):
                        continue
                    buf = v.adm_bufs[j, a, :int(v.adm_len[j, a])
                                     ].tobytes()
                    digest = md5_hex(buf)
                    self._admit_arm(buf, digest, parent=parent)
                    slot = int(v.adm_slot[j, a])
                    self._ring_mirror[(d, slot)] = digest
                    self.telemetry.event("ring_admit", md5=digest,
                                         slot=slot, gen=gid, shard=d,
                                         parent=parent)
        for d in range(len(views)):
            while ei[d] < stored[d]:    # defensive: trailing rows
                replay_lane(d, ei[d])
                ei[d] += 1
        reg.gauge("gen_ring_filled",
                  sum(int(v.ring_filled.sum()) for v in views))

    def _run_generations(self, n_iterations: int) -> None:
        """The device-resident dispatch mode: each device call runs up
        to ``self.generations`` full generations (mutate -> execute ->
        triage -> ring reseed, ops/generations.py) and the host only
        drains findings + the admission ledger.  Double-buffered (a
        dispatch is G batches long, so depth 2 keeps the card fed);
        stands down to the host-driven loop — with a named warning —
        when the crack stage is active or the driver/mutator can't run
        the generation loop (the superbatch path's discipline).  With
        corpus feedback off, device reseeding is off too and the
        candidate stream is bit-identical to the host loop's."""
        drv = self.driver
        mut = drv.mutator
        g_max = max(int(self.generations), 1)
        reseed = bool(self.feedback)
        self._gen_reseed = reseed
        reg = self.telemetry.registry
        # mesh campaigns execute whole mesh batches per generation
        quantum = getattr(drv, "batch_quantum", 1)
        stood_down = self.cracker is not None \
            or not drv.supports_batch_generations()
        pending: "deque" = deque()
        if not stood_down:
            self._pending = pending     # watchdog-dump visibility
            try:
                while True:
                    room = min(self._remaining(n_iterations),
                               mut.remaining(), g_max * self.batch_size)
                    if room <= 0:
                        break
                    if room < quantum:
                        _quantum_warning(room, quantum)
                        break
                    if not drv.supports_batch_generations():
                        stood_down = True   # mid-run state change
                        break
                    if self.profile_device and not self._prof_active:
                        self._profile_start()
                    if self.learn is not None:
                        # the LIVE weights for this dispatch's per-
                        # generation inference (a version-0 model gives
                        # all-ones masks: the parity regime)
                        drv.instrumentation.learn_params = \
                            self.learn.scan_params()
                    n_real = min(room, self.batch_size)
                    g_room = min(max(room // self.batch_size, 1), g_max)
                    # tails quantize down to a power of two: the JAX
                    # package does so to bound its recompiles, and the
                    # generation ids a split assigns feed the seed-slot
                    # picks, so parity with it needs the same split
                    g_eff = g_room if g_room == g_max \
                        else 1 << (g_room.bit_length() - 1)
                    if self.watchdog is not None:
                        # a G-generation dispatch legitimately waits
                        # ~G x one batch: scale the guard deadline
                        self.watchdog.note_dispatch_scale(g_eff)
                    lane = None
                    tr = self.telemetry.trace
                    if tr is not None:
                        lane = self._trace_lane(tr)
                    sp = self.spans
                    with self._wd_guard("dispatch"):
                        chaos_point("device_dispatch")
                        if sp is not None:
                            sp.begin()
                        out = drv.test_batch_generations(
                            n_real, g_eff, pad_to=self.batch_size,
                            reseed=reseed)
                        if sp is not None:
                            sp.end()
                    self.stats.iterations += g_eff * n_real
                    self._fb_batches += g_eff
                    out = out.prefetch()
                    if tr is not None:
                        tr.async_begin(
                            "in_flight", lane,
                            args={"batch": self._batch_seq,
                                  "n": g_eff * n_real,
                                  "generations": g_eff})
                    self._batch_seq += 1
                    self._profile_count(g_eff)
                    pending.append((out, g_eff * n_real,
                                    self.stats.iterations, None, None,
                                    lane))
                    if len(pending) >= 2:   # double buffer
                        self._drain_generations(*pending.popleft())
                    if self.learn is not None and self.learn.version > 0:
                        # one learned mask per generation once the model
                        # has trained (v0 masks are all-ones)
                        self.learn.masks_applied += g_eff
                    with self.telemetry.timer("telemetry"):
                        reg.rate("execs", g_eff * n_real)
                        reg.gauge("generations_per_dispatch", g_eff)
                        reg.gauge("pipeline_depth", len(pending))
                        self._update_state_gauges()
                        self._collect_spans()
                        self._count_triage_kernels()
                    self._between_dispatches()
            finally:
                while pending:
                    self._drain_generations(*pending.popleft())
                self._collect_spans()
                if self.watchdog is not None:
                    self.watchdog.note_dispatch_scale(1)
        if stood_down:
            if not self._gen_warned:
                self._gen_warned = True
                reason = ("the crack stage injects host-side "
                          "candidates and focus masks"
                          if self.cracker is not None else
                          "the driver/mutator cannot run the device "
                          "generation loop (needs jit_harness + a "
                          "fused-capable mutator, no focus mask)")
                WARNING_MSG("--generations stood down: %s — running "
                            "the host-driven loop", reason)
            self._run_batched(n_iterations)
