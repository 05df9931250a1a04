"""Run a cell's campaign through the port's CLI and time one window of
it.

The campaign is built by ``killerbeez_tpu_torch.fuzzer.cli.main`` from
the cell's arguments, with the CLI's ``Fuzzer`` class swapped for a
subclass that keeps the loop's own behaviour and adds clocks:

  * each dispatch's return from the driver is stamped with its
    executions; the triage end (``_triage_batch``,
    ``_drain_generations``) of a dispatch's last batch ends a step;
  * the warm-up is the first ``warmup_steps`` steps; the window opens
    at the last one's end and closes ``seconds`` later: from the first
    dispatch boundary past it (``_between_dispatches``) ``_remaining``
    reads 0, so the loop stops dispatching and triages what is in
    flight, outside the window;
  * with ``--trace 1`` the profiler (device activity only, so the host
    runs at its own pace) starts at that boundary, and the campaign
    runs on through the profiled stretch: ``profile_steps`` dispatches,
    fenced on the card's stream by two marker kernels, after two more
    to refill the pipeline;
  * the driver's dispatch calls are wrapped to count the lanes
    dispatched and, for the campaign's first dispatch and one of the
    window drawn from the seed, to keep what went in and what came out
    for ``check``: the state, the dispatch's outputs and, through the
    functions that ``benchmark/hooks/*.json`` name, its VM results.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import random
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from . import spec

M32 = 0xFFFFFFFF
#: the span of the window, as shares of its length, in which the
#: checked dispatch starts (drawn from the seed)
SAMPLE_SPAN = (0.1, 0.8)


class Dispatch:
    """One call of the driver that enqueued device work."""

    def __init__(self, kind: str, it0: int, n: int, k: int, end: int,
                 gen0: int):
        self.kind = kind            # "multi", "batch" or "generations"
        self.it0 = it0              # lanes dispatched before (our count)
        self.n = n                  # lanes per batch
        self.k = k                  # batches (or generations)
        self.end = end              # the loop's count after its last batch
        self.gen0 = gen0            # generations dispatched before
        self.before: Optional[Dict[str, Any]] = None
        self.after: Optional[Dict[str, Any]] = None
        #: what the hooked VM calls of its batches returned, (VM
        #: result, bufs, lens) each
        self.vm: List[Any] = []


class Window:
    """Clocks of one run: warm-up, window, profiled stretch."""

    def __init__(self, seconds: float, warmup_steps: int,
                 profile_steps: int, sample_frac: float, trace: bool):
        self.seconds = float(seconds)
        self.warmup_steps = int(warmup_steps)
        self.profile_steps = int(profile_steps) if trace else 0
        self.sample_frac = sample_frac
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.sample_at: Optional[float] = None
        self.closed = False
        self.n_steps = 0
        self.dispatched: List[tuple] = []    # (t, executions)
        self.step_ends: List[float] = []
        self.counters0: Dict[str, float] = {}
        self.counters1: Dict[str, float] = {}
        self.t_snap1: Optional[float] = None
        self.memory_peak = 0
        self.sample: Optional[Dispatch] = None
        self.start: Optional[Dispatch] = None
        self.stretch: List[Dispatch] = []
        self.stretch_state = "off"            # off, armed, on, done
        self.stretch_skip = 2
        #: the program's stage spans while the profiler runs:
        #: (stage, start ns, end ns) on the host's clock
        self.stages: List[tuple] = []
        #: host ns just before the calibration marker was launched on
        #: an idle card
        self.calibration_ns: Optional[int] = None
        self.window_dispatches = 0
        #: host clocks of set-up's stages: the campaign built
        #: (``Fuzzer.run`` entered), its first dispatch back on the host
        self.marks: Dict[str, float] = {}


class Campaign:
    """One cell's campaign and its window."""

    def __init__(self, argv: List[str], window: Window, device: str,
                 prepare: Optional[Callable] = None):
        self.argv = argv
        self.w = window
        self.device = device
        self.prepare = prepare
        self.fuzzer = None
        self.lanes = 0
        self.gens = 0
        self.ends: Dict[int, Dispatch] = {}
        self.sink: Optional[List[Any]] = None
        self.profiler = None
        self.profiling = False

    # -- the loop's hooks ---------------------------------------------

    def batch_done(self, done_through: int) -> None:
        t = time.perf_counter()
        w = self.w
        if int(done_through) not in self.ends:
            return
        self.ends.pop(int(done_through))
        w.n_steps += 1
        if w.t0 is None:
            if w.n_steps >= w.warmup_steps:
                self._open(t)
            return
        w.step_ends.append(t)

    def _open(self, t: float) -> None:
        w = self.w
        w.t0 = t
        w.t1 = t + w.seconds
        w.counters0 = dict(self.fuzzer.telemetry.registry.counters)
        w.sample_at = t + w.sample_frac * w.seconds

    def between_dispatches(self) -> None:
        """At a dispatch boundary past the window's end: read the stage
        counters and the memory peak, then (once the checked dispatch
        is in, should the window have ended before one began) close,
        or under ``--trace 1`` start the profiler and arm the
        stretch, and close when it is done."""
        w = self.w
        if w.t0 is None or w.closed:
            return
        if w.t_snap1 is None:
            now = time.perf_counter()
            if now < w.t1:
                return
            w.t_snap1 = now
            w.counters1 = dict(self.fuzzer.telemetry.registry.counters)
            if self.device == "cuda":
                w.memory_peak = torch.cuda.max_memory_allocated()
        if w.sample is None or w.sample.after is None:
            return
        if w.stretch_state == "off" and w.profile_steps \
                and self.device == "cuda":
            self._reserve()
            self._start_profiler()
            w.stretch_state = "armed"
        elif w.stretch_state in ("off", "done"):
            w.closed = True

    # -- the driver's dispatches --------------------------------------

    def _begin(self, kind: str, n: int, k: int) -> Dispatch:
        f = self.fuzzer
        d = Dispatch(kind, self.lanes, int(n), int(k),
                     int(f.stats.iterations) + int(n) * int(k), self.gens)
        self.lanes += int(n) * int(k)
        if kind == "generations":
            self.gens += int(k)
        self.ends[d.end] = d
        w = self.w
        if w.start is None:
            w.start = d
            self.sink = d.vm
        elif w.t0 is not None and w.sample is None \
                and time.perf_counter() >= w.sample_at:
            w.sample = d
            d.before = self._state(kind, before=True)
            self.sink = d.vm
        else:
            self._stretch(d)
        if w.t0 is not None and w.t_snap1 is None:
            w.window_dispatches += 1
        return d

    def _end(self, d: Dispatch, out) -> None:
        self.w.dispatched.append((time.perf_counter(), d.n * d.k))
        if self.w.start is d:
            # the campaign's first dispatch, checked from the fresh
            # state: kept on the host, so that it holds no device
            # memory through the window (the copy waits, in set-up)
            d.after = _to_host(dict(self._state(d.kind, False), out=out))
            d.vm = _to_host(d.vm)
            self.w.marks["first_dispatch"] = time.perf_counter()
        elif self.w.sample is d:
            d.after = self._state(d.kind, before=False)
            d.after["out"] = out
        elif d.vm:
            # a profiled dispatch: only the work counts are read
            d.vm = [(v[0].steps, v[0].counts) for v in d.vm]
        self.sink = None

    def _state(self, kind: str, before: bool) -> Dict[str, Any]:
        instr = self.fuzzer.driver.instrumentation
        mut = self.fuzzer.driver.mutator
        st = {"maps": (instr.virgin_bits, instr.virgin_crash,
                       instr.virgin_tmout)}
        if before:
            st["seed"] = bytes(mut.seed_bytes)
            st["L"] = int(mut.max_length)
        if kind == "generations" and instr._gen_ring is not None:
            ring = instr._gen_ring
            s = ring.slots
            st["ring"] = {"bufs": ring.bufs[:s].clone(),
                          "lens": ring.lens[:s].clone(),
                          "filled": ring.filled[:s].clone(),
                          "hits": ring.hits[:s].clone(),
                          "finds": ring.finds[:s].clone(),
                          "ptr": ring.ptr.clone()}
        return st

    def _wrap_driver(self, drv) -> None:
        multi, batch, gens = (drv.test_batch_fused_multi, drv.test_batch,
                              drv.test_batch_generations)

        def test_batch_fused_multi(n, k):
            d = self._begin("multi", n, k)
            out = multi(n, k)
            self._end(d, out)
            return out

        def test_batch(n, pad_to=None, prefetch_next=True):
            d = self._begin("batch", n, 1)
            out = batch(n, pad_to=pad_to, prefetch_next=prefetch_next)
            self._end(d, out)
            return out

        def test_batch_generations(n, g, pad_to=None, reseed=True):
            d = self._begin("generations", n, g)
            out = gens(n, g, pad_to=pad_to, reseed=reseed)
            self._end(d, out)
            return out

        drv.test_batch_fused_multi = test_batch_fused_multi
        drv.test_batch = test_batch
        drv.test_batch_generations = test_batch_generations

    @contextlib.contextmanager
    def _vm_hooks(self):
        """Keep the VM results of the dispatch being captured: every
        function that ``benchmark/hooks/*.json`` names (``wrap``: module
        and attribute) is wrapped while the campaign runs, and what it
        returns, ``(VM result, mutant bytes, lengths)``, is kept.  Each
        must run once a batch (a ``-G`` generation).  A name the
        program no longer has is passed over: the check then finds no
        VM results and counts every lane as a mismatch, so a change that
        moves the step adds a file here naming the new one."""
        saved = []
        for path in sorted(spec.bench_path("hooks").glob("*.json")):
            with open(path, encoding="utf-8") as f:
                for mod_name, attr in json.load(f)["wrap"]:
                    mod = importlib.import_module(mod_name)
                    if hasattr(mod, attr):
                        saved.append((mod, attr, getattr(mod, attr)))

        def keep(fn):
            def wrapped(*args, **kwargs):
                out = fn(*args, **kwargs)
                if self.sink is not None:
                    self.sink.append(out)
                return out
            return wrapped

        for m, a, fn in saved:
            setattr(m, a, keep(fn))
        try:
            yield
        finally:
            for m, a, fn in saved:
                setattr(m, a, fn)

    # -- the profiler (--trace 1) -------------------------------------

    def _stretch(self, d: Dispatch) -> None:
        """Fence ``profile_steps`` dispatches with marker kernels on
        the card's stream, the third marker launched on an idle card
        just after the host reads its clock (the clocks' offset)."""
        w = self.w
        if w.stretch_state == "armed":
            if w.stretch_skip:
                w.stretch_skip -= 1
                return
            _marker()
            w.stretch_state = "on"
        if w.stretch_state != "on":
            return
        if len(w.stretch) < w.profile_steps:
            w.stretch.append(d)
            self.sink = d.vm
            return
        _marker()
        torch.cuda.synchronize()
        w.calibration_ns = time.time_ns()
        _marker()
        w.stretch_state = "done"

    def _reserve(self) -> None:
        """Have the allocator hold the memory the profiled dispatches'
        kept work counts will take, so that keeping them makes no
        device allocation inside the stretch."""
        if self.device != "cuda":
            return
        f = self.fuzzer
        k = max(int(f.generations), int(f.ACCUMULATE_AUTO), 1)
        e = f.driver.instrumentation.program.n_edges
        n = (self.w.profile_steps + 2) * k * f.batch_size * (e + 1 + 4)
        torch.empty(int(n), dtype=torch.uint8, device="cuda")

    def _start_profiler(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.profiler = profile(activities=[ProfilerActivity.CUDA])
        self.profiler.start()
        self.profiling = True

    def stop_profiler(self) -> Optional[list]:
        """Stop the profiler; its device operations as (name, start
        ns, end ns) on the card's clock, or None without a stretch."""
        if self.profiler is None:
            return None
        self.profiler.stop()
        self.profiling = False
        events = self.profiler.profiler.kineto_results.events()
        self.profiler = None
        if self.w.stretch_state != "done":
            return None
        return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in events
                if e.device_type() == torch.autograd.DeviceType.CUDA]

    def _label_stages(self, fuzzer) -> None:
        """While the profiler runs, keep each of the program's stage
        spans with its host clock: the idle gaps' labels."""
        inner = fuzzer.telemetry.timer
        camp = self

        @contextlib.contextmanager
        def kept(stage):
            t0 = time.time_ns()
            try:
                with inner(stage):
                    yield
            finally:
                camp.w.stages.append((stage, t0, time.time_ns()))

        class Labelled:
            def __call__(self, stage):
                return kept(stage) if camp.profiling else inner(stage)

        fuzzer.telemetry.timer = Labelled()
        fuzzer.driver.stage_timer = fuzzer.telemetry.timer

    # -- the run ------------------------------------------------------

    def fuzzer_class(self, base):
        camp = self

        class BenchFuzzer(base):
            def _remaining(self, n_iterations):
                if camp.w.closed:
                    return 0
                return super()._remaining(n_iterations)

            def _triage_batch(self, out, room, done_through, *rest):
                super()._triage_batch(out, room, done_through, *rest)
                camp.batch_done(done_through)

            def _drain_generations(self, out, room, done_through, *rest):
                super()._drain_generations(out, room, done_through, *rest)
                camp.batch_done(done_through)

            def _between_dispatches(self):
                super()._between_dispatches()
                camp.between_dispatches()

            def run(self, n_iterations=-1):
                camp.w.marks["built"] = time.perf_counter()
                camp.fuzzer = self
                camp._wrap_driver(self.driver)
                if camp.w.profile_steps:
                    camp._label_stages(self)
                if camp.prepare is not None:
                    camp.prepare(self)
                return super().run(n_iterations)

        return BenchFuzzer

    def run(self) -> int:
        from killerbeez_tpu_torch.fuzzer import cli
        base = cli.Fuzzer
        cli.Fuzzer = self.fuzzer_class(base)
        try:
            with self._vm_hooks():
                return cli.main(self.argv)
        finally:
            cli.Fuzzer = base


def _marker() -> None:
    """A marker kernel (``spin_kernel``, which the program never
    launches) on the current stream."""
    torch.cuda._sleep(1)


def _to_host(x):
    """``x`` (tensors in tuples, lists and dicts) with every tensor
    copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def sample_frac(seed: int) -> float:
    """Where in the window the checked dispatch starts, drawn from the
    seed."""
    return random.Random(int(seed)).uniform(*SAMPLE_SPAN)


def instrumentation_options(config: Dict[str, Any],
                            traffic: Dict[str, Any],
                            program_file: str) -> Dict[str, Any]:
    """The instrumentation's options of a cell: the configuration's,
    the traffic's (such as the ``-G`` ring's sizes) over them, the
    frozen program's file."""
    return {**config["instrumentation_options"],
            **traffic.get("instrumentation_options", {}),
            "program_file": program_file}


def cli_argv(config: Dict[str, Any], traffic: Dict[str, Any], seed: int,
             out_dir: str, seed_file: str, iopts: Dict[str, Any],
             device: str) -> List[str]:
    """The CLI's arguments for a cell: the configuration's deployment
    with the instrumentation's options ``iopts``, the traffic's mode
    flags, the mutator seed from ``--seed``, the campaign's output and
    log under ``out_dir``."""
    iopts = dict(iopts)
    if device == "cpu":
        iopts.pop("engine", None)
    mopts = dict(config.get("mutator_options", {}))
    mopts["seed"] = int(seed) & M32
    argv = [config["driver"], config["instrumentation"], config["mutator"],
            "-sf", seed_file, "-b", str(int(config["lanes"])),
            "-i", json.dumps(iopts), "-m", json.dumps(mopts),
            "-o", os.path.join(out_dir, "campaign"),
            "-l", json.dumps({"file": os.path.join(out_dir, "fuzzer.log")}),
            *traffic.get("flags", [])]
    if device == "cpu":
        argv += ["--device", "cpu"]
    return argv


def tree_size(path: str) -> tuple:
    """(files, bytes) under ``path``."""
    files = size = 0
    for d, _dirs, names in os.walk(path):
        for n in names:
            files += 1
            try:
                size += os.path.getsize(os.path.join(d, n))
            except OSError:
                pass
    return files, size


def write_seed(out_dir: str, seed_hex: str) -> str:
    path = Path(out_dir) / "seed.bin"
    path.write_bytes(bytes.fromhex(seed_hex))
    return str(path)
