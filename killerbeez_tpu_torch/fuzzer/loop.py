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

Not ported yet: corpus feedback (seed rotation) and the scheduler,
stats files and telemetry, generations, the crack stage, sync, and
the single-exec loop (only batching backends exist).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from .. import FUZZ_CRASH, FUZZ_ERROR, FUZZ_HANG, FUZZ_NONE
from ..drivers.base import BatchOutcome, Driver
from ..instrumentation.base import CompactReport, pack_verdicts, \
    unpack_verdicts
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

    def __array__(self, dtype=None, copy=None):
        r = np.asarray(self._holder.materialize()[self._i])
        return r.astype(dtype) if dtype is not None else r


class FuzzStats:
    """Campaign counters and the in-run wall clock."""

    def __init__(self):
        self.iterations = 0
        self.crashes = 0
        self.hangs = 0
        self.new_paths = 0
        self.unique_crashes = 0
        self.unique_hangs = 0
        self.errors = 0
        self.elapsed = 0.0

    @property
    def execs_per_sec(self) -> float:
        return self.iterations / self.elapsed if self.elapsed > 0 else 0.0


class Fuzzer:
    """Drives driver/instrumentation/mutator to completion."""

    #: K-step superbatch default for the fused path (1 disables)
    ACCUMULATE_AUTO = 8

    #: batches kept in flight before their results are read on the
    #: host: device work is enqueued ahead while earlier copies land
    PIPELINE_DEPTH = 24

    def __init__(self, driver: Driver, output_dir: str = "output",
                 batch_size: int = 1024, feedback: int = 0,
                 accumulate: int = 0):
        if feedback:
            raise ValueError("corpus feedback is not ported yet: run "
                             "with feedback 0 (CLI: -fb 0)")
        if not driver.supports_batch:
            raise ValueError("only batching backends are ported yet")
        self.driver = driver
        self.output_dir = output_dir
        self.batch_size = int(batch_size)
        #: fused superbatch depth: 0 = auto (ACCUMULATE_AUTO when the
        #: driver supports the fused-multi path), 1 = per-batch
        self.accumulate = int(accumulate)
        self.stats = FuzzStats()
        self._seen = {k: set() for k in ("crashes", "hangs", "new_paths")}
        for sub in ("crashes", "hangs", "new_paths"):
            ensure_dir(os.path.join(output_dir, sub))

    def _record(self, kind: str, buf: bytes,
                digest: Optional[str] = None) -> bool:
        """Write a finding, deduped by input md5. Returns True if new."""
        digest = digest or md5_hex(buf)
        if digest in self._seen[kind]:
            return False
        self._seen[kind].add(digest)
        path = os.path.join(self.output_dir, kind, digest)
        if os.path.exists(path):  # left over from a previous run
            return False
        write_buffer_to_file(path, buf)
        CRITICAL_MSG("Found a %s! Saving result to %s",
                     "crash" if kind == "crashes" else kind.rstrip("es"),
                     path)
        return True

    def _triage_lane(self, status: int, new_path: int, buf: bytes,
                     unique_crash: bool = False,
                     unique_hang: bool = False) -> None:
        """Verdict + record stages of one lane's triage."""
        s = self.stats
        if status == FUZZ_CRASH:
            s.crashes += 1
            s.unique_crashes += int(unique_crash)
            self._record("crashes", buf)
        elif status == FUZZ_HANG:
            s.hangs += 1
            s.unique_hangs += int(unique_hang)
            self._record("hangs", buf)
        elif status == FUZZ_ERROR:
            s.errors += 1
            WARNING_MSG("target exec error on iteration %d", s.iterations)
        if new_path > 0:
            s.new_paths += 1
            self._record("new_paths", buf)

    # -- loops ----------------------------------------------------------

    def run(self, n_iterations: int = -1) -> FuzzStats:
        """Run ``n_iterations`` executions (-1 = until the mutator
        exhausts)."""
        t0 = time.perf_counter()
        try:
            self._run_batched(n_iterations)
        finally:
            self.stats.elapsed += time.perf_counter() - t0
        INFO_MSG("Ran %d iterations in %.1f seconds (%.0f execs/s)",
                 self.stats.iterations, self.stats.elapsed,
                 self.stats.execs_per_sec)
        return self.stats

    def _remaining(self, n_iterations: int) -> int:
        if n_iterations < 0:
            return 2**62 - self.stats.iterations
        return n_iterations - self.stats.iterations

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
                      done_through: int, packed) -> None:
        """Triage one batch from its packed verdict bytes; the
        candidate bytes cross to the host only for interesting lanes.
        ``done_through`` is the global iteration count as of THIS
        batch (the pipeline runs ahead of triage)."""
        statuses, new_paths, uc, uh = unpack_verdicts(np.asarray(packed))
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

    def _resolve_accumulate(self) -> int:
        """Effective superbatch depth K: auto engages only on the
        fused device path."""
        k = self.accumulate if self.accumulate > 0 \
            else self.ACCUMULATE_AUTO
        if k <= 1 or not self.driver.supports_fused_multi():
            return 1
        return k

    def _run_superbatch(self, k: int, pending, depth) -> None:
        """Execute K fused batches in one call and enqueue K per-step
        triage entries over shared stacked host copies."""
        b = self.batch_size
        packed, bufs, lens, compact = \
            self.driver.test_batch_fused_multi(b, k)
        ph = _HostCopy(packed)
        idxh, sbh, slh, cnth = (_HostCopy(a) for a in compact)
        for j in range(k):
            self.stats.iterations += b
            out = BatchOutcome(
                result=None, inputs=bufs[j], lengths=lens[j],
                compact=CompactReport(idx=idxh.row(j), bufs=sbh.row(j),
                                      lens=slh.row(j),
                                      count=cnth.row(j)))
            pending.append((out, b, self.stats.iterations, ph.row(j)))
            if len(pending) >= depth:
                self._triage_batch(*pending.popleft())

    def _run_batched(self, n_iterations: int) -> None:
        mut = self.driver.mutator
        pending: "deque" = deque()
        depth = self.PIPELINE_DEPTH
        accumulate = self._resolve_accumulate()
        try:
            while True:
                room = min(self._remaining(n_iterations),
                           mut.remaining(), self.batch_size)
                if room <= 0:
                    break
                if (accumulate > 1
                        and self._remaining(n_iterations)
                        >= accumulate * self.batch_size
                        and mut.remaining()
                        >= accumulate * self.batch_size):
                    self._run_superbatch(accumulate, pending, depth)
                    continue
                out, packed = self._prefetch(self.driver.test_batch(room))
                self.stats.iterations += room
                pending.append((out, room, self.stats.iterations, packed))
                if len(pending) >= depth:
                    self._triage_batch(*pending.popleft())
        finally:
            # findings in already-executed batches must survive an
            # interrupt or a raise
            while pending:
                self._triage_batch(*pending.popleft())
