"""Cross-tier triage: device-tier findings validated on the native
binary.

The pipeline (docs/HYBRID.md):

  loop thread                      native worker thread(s)
  -----------                      -----------------------
  unique crash/hang  --enqueue-->  bounded ValidationQueue
                                   NativeValidator.validate():
                                     translate -> replay xN with
                                     retry/timeout/backoff (the
                                     manager-RPC conventions)
  fold() <--results--------------  verdict record
    sidecar write-back (corpus + findings dir)
    cross_tier_validate event (+ proxy_gap event & report)
    hybrid_validations counters, queue gauges
    scheduler.note_validation credit boost

Verdict taxonomy (store.VALIDATION_VERDICTS):

  * ``confirmed``  — every native repeat reproduced the finding:
    ground truth, earns the scheduler boost.
  * ``proxy_only`` — no repeat reproduced it: the proxy diverges
    from the real binary on this input.  Emits a machine-readable
    proxy-gap report — the signal for improving the proxy — and is
    NEVER silently dropped.
  * ``flaky``      — some repeats reproduced it, or the native
    substrate kept erroring: undecided, kept visible.

All corpus/event/scheduler mutation happens on the LOOP thread (in
``fold()``); worker threads only execute natively and append result
records — the same single-writer discipline the sync tier uses.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .. import FUZZ_CRASH, FUZZ_ERROR, FUZZ_HANG
from ..corpus.store import (
    MAX_VALIDATION_REPEATS,
    VALIDATION_VERDICTS,
    _atomic_write,
)
from ..utils.fileio import ensure_dir
from ..utils.logging import INFO_MSG, WARNING_MSG
from .gaps import GapIndex, make_gap_report, proxy_trace_edge
from .registry import (
    ProxyBinding,
    get_binding,
    native_verdict,
    open_native,
)

VERDICT_CONFIRMED, VERDICT_PROXY_ONLY, VERDICT_FLAKY = \
    VALIDATION_VERDICTS


class ValidationItem:
    """One pending cross-tier validation."""

    __slots__ = ("kind", "buf", "md5", "parent", "proxy_status", "t")

    def __init__(self, kind: str, buf: bytes, md5: str,
                 parent: Optional[str] = None,
                 proxy_status: int = FUZZ_CRASH,
                 t: Optional[float] = None):
        self.kind = kind            # "crash" | "hang"
        self.buf = bytes(buf)
        self.md5 = md5
        self.parent = parent        # generating seed (scheduler boost)
        self.proxy_status = int(proxy_status)
        self.t = time.time() if t is None else float(t)


class ValidationQueue:
    """Bounded FIFO between the loop and the native workers.

    ``put`` REJECTS when full (backpressure toward the fast tier;
    the drop is counted and logged, never silent).  ``oldest_age``
    feeds the ``validation_backlog`` alert rule."""

    def __init__(self, cap: int = 256):
        self.cap = int(cap)
        self._q: deque = deque()
        self._cv = threading.Condition()
        self.dropped = 0
        self._warned = 0.0

    def put(self, item: ValidationItem) -> bool:
        with self._cv:
            if len(self._q) >= self.cap:
                self.dropped += 1
                now = time.time()
                if now - self._warned > 5.0:     # rate-limited
                    self._warned = now
                    WARNING_MSG(
                        "validation queue full (cap %d): dropped %d "
                        "findings so far — native tier cannot keep "
                        "up", self.cap, self.dropped)
                return False
            self._q.append(item)
            self._cv.notify()
            return True

    def get(self, timeout: float = 0.2) -> Optional[ValidationItem]:
        with self._cv:
            if not self._q:
                self._cv.wait(timeout)
            if not self._q:
                return None
            return self._q.popleft()

    def depth(self) -> int:
        with self._cv:
            return len(self._q)

    def oldest_age(self, now: Optional[float] = None) -> float:
        with self._cv:
            if not self._q:
                return 0.0
            return (time.time() if now is None else now) - self._q[0].t


class NativeValidator:
    """Replays one finding on the native binary N times.

    Transient native faults (status -2: backend error, e.g. a dying
    forkserver or a refused TCP connect) are retried per attempt with
    exponential backoff — the same 0.5/1/2/4s ladder the manager RPC
    layer uses — before the repeat is recorded as an error.
    ``run_fn`` injects a fake native side for tests."""

    def __init__(self, binding: ProxyBinding, repeats: int = 3,
                 attempts: int = 4, base_delay: float = 0.1,
                 run_fn: Optional[Callable[[bytes], int]] = None,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.binding = binding
        if int(repeats) > MAX_VALIDATION_REPEATS:
            # one status lands per repeat; beyond the sidecar schema
            # bound peers would quarantine the record on sync
            WARNING_MSG(
                "hybrid repeats %d exceeds the sidecar schema bound; "
                "clamped to %d", int(repeats), MAX_VALIDATION_REPEATS)
        self.repeats = max(1, min(int(repeats), MAX_VALIDATION_REPEATS))
        self.attempts = max(1, int(attempts))
        self.base_delay = float(base_delay)
        self._run_fn = run_fn
        self._sleep = sleep_fn
        self._target = None

    def _run_native(self, buf: bytes) -> int:
        """One native replay; returns the FUZZ_* verdict."""
        if self._run_fn is not None:
            return self._run_fn(buf)
        if self._target is None:
            self._target = open_native(self.binding.native)
        delivery = self.binding.translate(buf)
        kind, _ = native_verdict(self._target, self.binding.native,
                                 delivery)
        return kind

    def close(self) -> None:
        if self._target is not None:
            self._target.close()
            self._target = None

    def validate(self, item: ValidationItem) -> Dict[str, Any]:
        """Full verdict record for one finding (sidecar schema)."""
        t0 = time.time()
        want = FUZZ_HANG if item.kind == "hang" else FUZZ_CRASH
        statuses: List[int] = []
        n_execs = 0
        repro = 0
        errors = 0
        for _ in range(self.repeats):
            kind = FUZZ_ERROR
            for attempt in range(self.attempts):
                kind = self._run_native(item.buf)
                n_execs += 1
                if kind != FUZZ_ERROR:
                    break
                # transient native fault: reopen + back off
                self.close()
                self._sleep(self.base_delay * (2 ** attempt))
            statuses.append(int(kind))
            if kind == FUZZ_ERROR:
                errors += 1
            elif kind == want:
                repro += 1
        if errors == self.repeats:
            # never measured: undecided, not a proxy-gap claim
            verdict, detail = VERDICT_FLAKY, "native-exec-error"
        elif repro == self.repeats:
            verdict, detail = VERDICT_CONFIRMED, None
        elif repro == 0:
            verdict, detail = VERDICT_PROXY_ONLY, None
        else:
            verdict, detail = VERDICT_FLAKY, None
        rec: Dict[str, Any] = {
            "md5": item.md5, "kind": item.kind, "verdict": verdict,
            "tier": "native", "repro": repro, "repeats": self.repeats,
            "attempts": n_execs, "statuses": statuses,
            "t": round(time.time(), 3),
            "wall_s": round(time.time() - t0, 3),
        }
        if detail:
            rec["detail"] = detail
        return rec


def write_proxy_gap(output_dir: str, item: ValidationItem,
                    result: Dict[str, Any],
                    binding: ProxyBinding,
                    index: Optional["GapIndex"] = None) -> str:
    """Write the machine-readable proxy-gap report (the contract in
    docs/HYBRID.md) for one ``proxy_only`` divergence; returns its
    path (the existing report's path when the index dedups it).

    Reports carry the concrete input and the proxy-trace edge so the
    conformance pass can replay them as counterexamples; storage is
    bounded+deduped through :class:`hybrid.gaps.GapIndex`."""
    gap_dir = os.path.join(output_dir, "proxy_gaps")
    report = make_gap_report(
        md5=item.md5, kind=item.kind, binding=binding.name,
        proxy_target=binding.proxy_target,
        proxy_status=item.proxy_status,
        native_argv=binding.native.argv,
        native_delivery=binding.native.delivery,
        statuses=result.get("statuses", []),
        repro=result.get("repro", 0),
        repeats=result.get("repeats", 0),
        t=result.get("t"),
        input_bytes=item.buf,
        edge=proxy_trace_edge(binding.program(), item.buf))
    idx = index if index is not None else GapIndex(gap_dir)
    path = idx.admit(report)
    return path or os.path.join(gap_dir, f"{item.md5}.json")


class HybridBridge:
    """Glue between one device campaign loop and its native validators.

    Owns the bounded queue, the worker thread(s) and the pending
    result list; the loop calls ``enqueue`` from triage, ``fold``
    beside every sync round and ``finish`` at run end.  With
    ``workers=0`` nothing runs in the background and ``pump()``
    validates synchronously — the deterministic test mode."""

    def __init__(self, binding: ProxyBinding, repeats: int = 3,
                 queue_cap: int = 256, workers: int = 1,
                 validator: Optional[NativeValidator] = None,
                 validator_factory:
                     Optional[Callable[[], NativeValidator]] = None):
        self.binding = binding
        self.queue = ValidationQueue(queue_cap)
        # EVERY thread that replays natively owns its own validator —
        # the underlying ExecTarget handle is not thread-safe and the
        # retry path closes/reopens it mid-validate, so sharing one
        # across workers races (corrupted verdicts, native crashes).
        self._make_validator = validator_factory or (
            lambda: NativeValidator(binding, repeats=repeats))
        # loop-side validator: pump() / workers=0 synchronous mode
        self.validator = validator or self._make_validator()
        # completed (item, verdict-record) pairs awaiting fold()
        self._results: List = []
        self._rlock = threading.Lock()
        self._parents: Dict[str, Optional[str]] = {}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._worker_validators: List[NativeValidator] = []
        self.enqueued = 0
        self.validated = 0
        self.native_execs = 0
        # per-verdict tally (mirrors the campaign registry counters):
        # rides the native heartbeat so kb-fleet shows the verdict
        # breakdown even when no device-side stats reporter is running
        # (CLI --sync-manager campaigns only sync corpus)
        self.verdict_counts: Dict[str, int] = {}
        self.proxy_gaps = 0
        # lazy: the bounded gap-report index for this campaign's
        # proxy_gaps/ dir (created on the first proxy_only verdict)
        self._gap_index: Optional[GapIndex] = None
        if workers > 0:
            for i in range(int(workers)):
                v = self._make_validator()
                self._worker_validators.append(v)
                th = threading.Thread(target=self._worker, args=(v,),
                                      name=f"hybrid-native-{i}",
                                      daemon=True)
                th.start()
                self._threads.append(th)

    # -- worker side (native thread) ----------------------------------

    def _worker(self, validator: NativeValidator) -> None:
        while not self._stop.is_set():
            item = self.queue.get(0.2)
            if item is None:
                continue
            try:
                result = validator.validate(item)
            except Exception as e:     # never kill the campaign
                WARNING_MSG("hybrid validator died on %s: %s",
                            item.md5, e)
                result = {"md5": item.md5, "kind": item.kind,
                          "verdict": VERDICT_FLAKY,
                          "tier": "native", "repro": 0,
                          "repeats": validator.repeats,
                          "attempts": 0, "statuses": [],
                          "t": round(time.time(), 3),
                          "detail": f"validator-error:"
                                    f"{type(e).__name__}"[:256]}
            with self._rlock:
                self._results.append((item, result))

    # -- loop side ----------------------------------------------------

    def enqueue(self, kind: str, buf: bytes, md5: str,
                parent: Optional[str] = None,
                proxy_status: int = FUZZ_CRASH) -> bool:
        """Queue one unique finding for native validation (loop
        thread).  Idempotent per md5."""
        if md5 in self._parents:
            return False
        ok = self.queue.put(ValidationItem(
            kind, buf, md5, parent=parent, proxy_status=proxy_status))
        if ok:
            # record the dedup key only on admission: a finding the
            # full queue rejected must stay eligible when it recurs
            # after the queue drains
            self._parents[md5] = parent
            self.enqueued += 1
        return ok

    def pump(self, limit: int = 0) -> int:
        """Synchronously validate queued items on the CALLING thread
        (workers=0 mode / tests / final drain); returns how many."""
        n = 0
        while True:
            if limit and n >= limit:
                break
            item = self.queue.get(0.0)
            if item is None:
                break
            result = self.validator.validate(item)
            with self._rlock:
                self._results.append((item, result))
            n += 1
        return n

    def fold(self, fuzzer) -> int:
        """Apply completed verdicts to the campaign (LOOP thread):
        sidecars, events, counters, scheduler credit.  Returns how
        many verdicts landed."""
        with self._rlock:
            done, self._results = self._results, []
        reg = fuzzer.telemetry.registry
        for item, result in done:
            self.validated += 1
            self.native_execs += int(result.get("attempts", 0))
            verdict = result["verdict"]
            self.verdict_counts[verdict] = \
                self.verdict_counts.get(verdict, 0) + 1
            reg.count("hybrid_validations")
            reg.count(f"hybrid_{verdict}")
            # findings sidecar (always — crashes/hangs need not be
            # corpus entries) + corpus sidecar when the entry exists
            self._write_finding_sidecar(fuzzer, item, result)
            if fuzzer.store is not None:
                fuzzer.store.update_validation(item.md5, result)
            gap_path = None
            if verdict == VERDICT_PROXY_ONLY:
                self.proxy_gaps += 1
                reg.count("hybrid_proxy_gaps")
                if self._gap_index is None:
                    self._gap_index = GapIndex(os.path.join(
                        fuzzer.output_dir, "proxy_gaps"))
                gap_path = write_proxy_gap(
                    fuzzer.output_dir, item, result, self.binding,
                    index=self._gap_index)
                fuzzer.telemetry.event(
                    "proxy_gap", md5=item.md5, kind=item.kind,
                    binding=self.binding.name, report=gap_path)
            fuzzer.telemetry.event(
                "cross_tier_validate", md5=item.md5, kind=item.kind,
                verdict=verdict, tier="native",
                repro=result.get("repro", 0),
                repeats=result.get("repeats", 0),
                attempts=result.get("attempts", 0))
            fuzzer.scheduler.note_validation(
                item.md5, verdict, parent=item.parent)
            INFO_MSG("cross-tier verdict for %s %s: %s (%d/%d "
                     "native repros)", item.kind, item.md5[:12],
                     verdict, result.get("repro", 0),
                     result.get("repeats", 0))
        reg.gauge("validation_queue_depth", self.queue.depth())
        reg.gauge("validation_queue_age",
                  round(self.queue.oldest_age(), 1))
        return len(done)

    def _write_finding_sidecar(self, fuzzer, item: ValidationItem,
                               result: Dict[str, Any]) -> None:
        # the port's loop always writes its findings, so the sidecar
        # always has a findings directory beside it
        kind_dir = os.path.join(fuzzer.output_dir,
                                "crashes" if item.kind == "crash"
                                else "hangs")
        ensure_dir(kind_dir)
        path = os.path.join(kind_dir, f"{item.md5}.json")
        try:
            _atomic_write(path, json.dumps(
                {"md5": item.md5, "kind": item.kind,
                 "validation": result}).encode())
        except OSError as e:
            WARNING_MSG("finding sidecar write failed for %s: %s",
                        item.md5, e)

    def finish(self, fuzzer, drain_timeout: float = 30.0) -> None:
        """Final drain at run end: wait (bounded) for the queue to
        empty, stop workers, fold everything that completed."""
        deadline = time.monotonic() + drain_timeout
        if self._threads:
            while self.queue.depth() and time.monotonic() < deadline:
                time.sleep(0.05)
            self._stop.set()
            for th in self._threads:
                th.join(timeout=max(0.1, deadline - time.monotonic()))
        else:
            self.pump()
        self.fold(fuzzer)
        if any(th.is_alive() for th in self._threads):
            # a validation still in flight at the drain deadline
            # appends its result after the fold above: grant one
            # grace join and fold again so late verdicts land
            # instead of silently vanishing
            for th in self._threads:
                th.join(timeout=0.5)
            self.fold(fuzzer)
        self.validator.close()
        stuck = 0
        for th, v in zip(self._threads, self._worker_validators):
            if th.is_alive():
                # still mid-validate: closing its target under it is
                # the exact race per-worker validators exist to avoid
                stuck += 1
            else:
                v.close()
        with self._rlock:
            unfolded = len(self._results)
        if self.queue.depth() or self.queue.dropped or unfolded \
                or stuck:
            WARNING_MSG(
                "hybrid bridge exiting with %d unvalidated, %d "
                "dropped and %d unfolded findings; %d native "
                "worker(s) still busy (native tier too slow — raise "
                "--hybrid-queue or add native workers)",
                self.queue.depth(), self.queue.dropped, unfolded,
                stuck)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Native-tier stats block (heartbeat payload shape)."""
        counters = {
            "execs": self.native_execs,
            "hybrid_validations": self.validated,
        }
        for verdict, n in self.verdict_counts.items():
            counters[f"hybrid_{verdict}"] = n
        if self.proxy_gaps:
            counters["hybrid_proxy_gaps"] = self.proxy_gaps
        return {
            "counters": counters,
            "gauges": {
                "validation_queue_depth": self.queue.depth(),
                "validation_queue_age":
                    round(self.queue.oldest_age(), 1),
            },
        }


def make_bridge(binding_name: str, repeats: int = 3,
                queue_cap: int = 256, workers: int = 1,
                certify: bool = True, device="cuda") -> HybridBridge:
    """Resolve a binding by name, certify it on ``device`` (the proxy
    side's verdicts run there), and build the bridge.

    Raises RuntimeError with the stand-down reason when the native
    substrate is unavailable — the CLI surfaces it and exits instead
    of running a hybrid campaign that cannot validate anything."""
    binding = get_binding(binding_name)
    if certify:
        from .registry import bind
        cert = bind(binding, certify=True, strict=True,
                    device=device)
        if cert["certified"] is None:
            raise RuntimeError(
                f"hybrid tier unavailable for binding "
                f"{binding_name!r}: {cert['reason']}")
        INFO_MSG("proxy binding %r certified (benign seed verdict-"
                 "identical on both tiers)", binding_name)
    return HybridBridge(binding, repeats=repeats,
                        queue_cap=queue_cap, workers=workers)
