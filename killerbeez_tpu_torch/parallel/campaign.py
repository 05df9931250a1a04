"""Mesh fuzzing campaigns — the sharded step as a Driver.

Port of the JAX package's ``parallel/campaign.py``.  One CLI invocation
(``--mesh dp,mp``) is the fleet: the (dp, mp) mesh step executes
``batch_per_device`` lanes per dp shard with the virgin-map AND-fold
after every step, and this adapter routes its verdicts through the
ordinary ``Fuzzer`` triage, so findings land md5-deduped in
``output/{crashes,hangs,new_paths}`` exactly like a single-device run.

State flows through the attached jit_harness instrumentation: its
virgin maps seed the mesh state (so ``-isf`` resume works), and after
every step they are the mesh's whole maps again, so ``get_state()``
exports the standard merger-compatible JSON.  A stateful instrumentation
(``--stateful``) takes its session spec to the mesh, whose state x edge
map rides the mesh state as one row per dp shard, dp-folded like the
classic maps.
"""

from __future__ import annotations

from typing import Optional

from ..drivers.base import BatchOutcome, Driver
from ..instrumentation.base import BatchResult, CompactReport
from ..ops.generations import MeshGenerationOutcome, gen_ring_caps
from ..telemetry import merge, merge_two
from ..utils.logging import INFO_MSG
from .distributed import (
    make_mesh, make_sharded_fuzz_step, make_sharded_generations,
    shard_stat_snapshots, sharded_gen_ring_init, state_from_maps,
)


def parse_mesh_spec(spec: str):
    """"dp,mp" (e.g. "4,2") -> (dp, mp); bare "4" means mp=1."""
    parts = [p.strip() for p in str(spec).split(",")]
    if len(parts) == 1:
        parts.append("1")
    if len(parts) != 2:
        raise ValueError(f"mesh spec {spec!r}: expected 'dp,mp'")
    try:
        dp, mp = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"mesh spec {spec!r}: expected integers")
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh spec {spec!r}: axes must be >= 1")
    return dp, mp


class ShardedCampaignDriver(Driver):
    """Driver running the (dp, mp)-sharded fuzz step each batch.

    Candidates are generated per dp shard from mesh-shape-independent
    per-global-lane PRNG keys, executed with the instrumentation's
    engine, and triaged against mp-sharded virgin maps.  The mesh takes
    the instrumentation's device kind: dp x mp CUDA cards (fewer is an
    error naming the count), or dp x mp CPU shards under ``--device
    cpu``."""

    name = "sharded"

    def __init__(self, mesh_spec, instrumentation, mutator,
                 batch_size: int):
        # Driver.__init__'s option parsing is bypassed: the CLI's mesh
        # path builds this driver, not the factory
        self.options = {}
        self.instrumentation = instrumentation
        self.mutator = mutator
        self.last_input = None
        self._last_batch_tail = None
        self._check_input_info()
        self.device = instrumentation.device
        if mutator.device.type != self.device.type:
            raise ValueError(f"mesh on {self.device} was given a mutator "
                             f"on {mutator.device}")

        n_dp, n_mp = parse_mesh_spec(mesh_spec)
        if batch_size % n_dp:
            raise ValueError(
                f"batch size {batch_size} not divisible by dp={n_dp}")
        self.batch_per_device = batch_size // n_dp
        self.mesh = make_mesh(n_dp, n_mp, ["cpu"] * (n_dp * n_mp)
                              if self.device.type == "cpu" else None)
        prog = instrumentation.program
        engine = instrumentation.engine
        # stateful session tier: the instrumentation's resolved spec
        # (jit_harness already stood its engine down to torch)
        sspec = getattr(instrumentation, "stateful_spec", None)
        self._stateful = None if sspec is None else (
            sspec.m_max, sspec.n_states, sspec.state_reg)
        self._step = make_sharded_fuzz_step(
            prog, self.mesh, self.batch_per_device,
            max_len=mutator.max_length,
            stack_pow2=int(mutator.options.get("stack_pow2", 4)),
            engine=engine, seed=int(mutator.options.get("seed", 0)),
            stateful=self._stateful)
        # seed the mesh state from the instrumentation's maps so -isf
        # resume and merged states carry over
        self.state = state_from_maps(
            self.mesh, instrumentation.virgin_bits,
            instrumentation.virgin_crash, instrumentation.virgin_tmout,
            vs=getattr(instrumentation, "virgin_state", None))
        #: accumulated mesh-wide stats: per-shard snapshots folded
        #: through telemetry.aggregate each sync epoch
        self.fleet_stats: dict = {}
        self._host_step = 0   # mirrors state.step
        #: mesh-resident generation loop state (-G on --mesh): the
        #: dispatch builder + per-dp-shard seed rings, built lazily
        self._gen_dispatch = None
        self._gen_ring = None
        self._gen_ring_key = None
        self._gen_count = 0
        self._gen_cap = 0
        INFO_MSG("sharded campaign: mesh dp=%d mp=%d, %d lanes/shard, "
                 "engine=%s", n_dp, n_mp, self.batch_per_device, engine)

    @property
    def supports_batch(self) -> bool:
        return True

    @property
    def batch_quantum(self) -> int:
        """The loop may only request whole mesh batches."""
        return self.batch_per_device * self.mesh.shape["dp"]

    def _check_full_batch(self, n: int) -> None:
        if n != self.batch_quantum:
            raise ValueError(
                f"sharded campaigns run full batches: asked {n}, mesh "
                f"batch is {self.batch_quantum} (use -n as a multiple "
                f"of -b)")

    def _sync_after(self, bufs, lens, n: int, execs: int) -> None:
        """Post-step bookkeeping shared by the per-batch and K-step
        paths: expose the mesh's maps through the instrumentation
        (get_state()/merge()/coverage_bytes() see campaign coverage),
        fold the per-shard stat snapshots into the registry (host
        values only) and defer last-input materialization."""
        instr = self.instrumentation
        for name in ("virgin_bits", "virgin_crash", "virgin_tmout"):
            setattr(instr, name, self.state.full_map(name))
        if self._stateful is not None:
            # dp rows are fold-identical; row 0 is the canonical view
            # get_state()/merge()/state_coverage_stats() export
            instr.virgin_state = self.state.virgin_state[0]
        instr.total_execs += execs
        n_dp = self.mesh.shape["dp"]
        self._host_step += execs // max(self.batch_quantum, 1)
        epoch = merge(shard_stat_snapshots(self.mesh, execs // n_dp,
                                           self._host_step))
        if epoch is not None:
            self.fleet_stats = merge_two(self.fleet_stats, epoch)
            timer = self.stage_timer
            if timer is not None:
                for k, v in self.fleet_stats["gauges"].items():
                    timer.reg.gauge(k, v)
                timer.reg.gauge("mesh_dp", n_dp)
                timer.reg.gauge("mesh_mp", self.mesh.shape["mp"])
                # flight recorder: one instant per dp shard per step on
                # a named shard lane
                tr = getattr(timer, "tracer", None)
                if tr is not None:
                    for i in range(n_dp):
                        tr.instant("shard_step",
                                   lane=tr.lane_id(f"shard-{i}"),
                                   args={"step": self._host_step,
                                         "execs": execs // n_dp})
        if n > 0:
            self._last_batch_tail = (bufs, lens, n - 1)
            self.last_input = None

    def _seed(self):
        """(seed buffer on the device, seed_len) of the mutator."""
        seed, seed_len, _key, _sp = self.mutator.fused_spec()
        return seed, int(seed_len)

    def test_batch(self, n: int, pad_to: Optional[int] = None,
                   prefetch_next=True) -> BatchOutcome:
        # mesh batches are always whole (checked), so pad_to has
        # nothing to pad; the candidates never leave the devices, so
        # there is nothing to prefetch
        self._check_full_batch(n)
        mut = self.mutator
        # the RAW absolute mutator iteration is the PRNG counter (a
        # Python int; the step folds all 64 bits), so a state resumed
        # under a different -b never lands on a used (counter, lane)
        base_it = int(mut.peek_iterations(n)[0])
        with self._span("execute"):
            (self.state, statuses, rets, uc, uh, exit_codes, bufs, lens,
             compact) = self._step(self.state, *self._seed(), base_it)
        mut.advance(n)
        self._sync_after(bufs, lens, n, n)
        return BatchOutcome(
            result=BatchResult(statuses=statuses, new_paths=rets,
                               unique_crashes=uc, unique_hangs=uh,
                               exit_codes=exit_codes),
            inputs=bufs, lengths=lens, compact=CompactReport(*compact))

    def supports_fused_multi(self) -> bool:
        """Mesh campaigns get their own K-step accumulation: the virgin
        maps (and the per-step folds) carry through K global batches,
        one transfer set per K batches."""
        return True

    def test_batch_fused_multi(self, n: int, k: int):
        self._check_full_batch(n)
        mut = self.mutator
        base_it = int(mut.peek_iterations(n)[0])
        with self._span("execute"):
            (self.state, packed, bufs, lens, compact) = self._step.multi(
                self.state, *self._seed(), base_it, k)
        mut.advance(k * n)
        self._sync_after(bufs[k - 1], lens[k - 1], n, k * n)
        return packed, bufs, lens, compact

    # -- mesh-resident generations (-G on --mesh) -----------------------

    def supports_batch_generations(self) -> bool:
        """The instrumentation's own gate (fused candidate spec, no
        focus mask): the single-device conditions, minus its
        quantum."""
        supports = getattr(self.instrumentation, "supports_generations",
                           None)
        return supports is not None and supports(self.mutator)

    def _ensure_gen_dispatch(self):
        """(Re)build the mesh generation dispatch + per-shard rings;
        rebuilt when the candidate width changes."""
        instr = self.instrumentation
        seed, seed_len = self._seed()
        L = int(self.mutator.max_length)
        slots = max(int(instr.options.get("gen_ring_slots", 32)), 2)
        # learned shaping is decided by weight presence (the loop
        # installs them before the first dispatch, so the flag never
        # flips mid-campaign); the grammar tables are compiled at
        # instrumentation init, so they stay the same for the
        # campaign's lifetime
        learn = getattr(instr, "learn_params", None) is not None
        grammar = getattr(instr, "grammar_tables", None)
        key = (L, slots, learn)
        if self._gen_ring is not None and self._gen_ring_key == key:
            return
        bpd = self.batch_per_device
        # ring sizing PER SHARD, against the per-shard batch
        adm_cap, cap = gen_ring_caps(
            instr.options.get("gen_admits", 8),
            instr.options.get("gen_findings_cap", 0), bpd, slots)
        self._gen_cap = cap
        mseed = int(self.mutator.options.get("seed", 0))
        self._gen_dispatch = make_sharded_generations(
            instr.program, self.mesh, bpd, max_len=L,
            stack_pow2=int(self.mutator.options.get("stack_pow2", 4)),
            engine=instr.engine, seed=mseed, salt=mseed & 0xFFFFFFFF,
            adm_cap=adm_cap, findings_cap=cap, stateful=self._stateful,
            learn=learn, grammar=grammar)
        self._gen_ring = sharded_gen_ring_init(self.mesh, seed, seed_len,
                                               slots, L)
        self._gen_ring_key = key

    def test_batch_generations(self, n: int, g: int,
                               pad_to: Optional[int] = None,
                               reseed: bool = True):
        """``g`` full mesh generations in one dispatch: each dp shard
        mutates from its own seed-slot ring, executes, triages against
        the (periodically dp-folded) virgin maps and reseeds on the
        device; the host gets back one MeshGenerationOutcome of device
        tensors.  Generation j consumed counter ``it0 + j*n``; the
        mutator advances by g*n."""
        self._check_full_batch(n)
        mut = self.mutator
        self._ensure_gen_dispatch()
        base_it = int(mut.peek_iterations(n)[0])
        fold_every = int(self.instrumentation.options.get(
            "gen_fold_every", 0))
        with self._span("execute"):     # the whole loop is on the device
            self.state, self._gen_ring, rep = self._gen_dispatch(
                self.state, self._gen_ring, base_it, self._gen_count,
                int(g), reseed=bool(reseed), fold_every=fold_every,
                learn_params=getattr(self.instrumentation, "learn_params",
                                     None))
        out = MeshGenerationOutcome(
            *rep, ring_filled=self._gen_ring.filled, gen0=self._gen_count,
            g=int(g), n_real=n, cap=self._gen_cap,
            n_shards=self.mesh.shape["dp"])
        self._gen_count += int(g)
        mut.advance(int(g) * n)
        self._sync_after_generations(int(g), int(g) * n)
        return out

    def _sync_after_generations(self, g: int, execs: int) -> None:
        """Generations-mode twin of _sync_after, plus per-shard
        generation instants on the flight recorder.  Candidate tensors
        never leave the device in this mode: no last-input tail."""
        self._sync_after(None, None, 0, execs)
        self._last_batch_tail = None
        self.last_input = None
        timer = self.stage_timer
        tr = getattr(timer, "tracer", None) if timer is not None \
            else None
        if tr is not None:
            for i in range(self.mesh.shape["dp"]):
                tr.instant("shard_generations",
                           lane=tr.lane_id(f"shard-{i}"),
                           args={"shard": i, "generations": g,
                                 "step": self._host_step})

    def test_input(self, buf: bytes) -> int:
        """Single-input repro path, through the instrumentation."""
        self.instrumentation.enable(buf)
        self.last_input = buf
        return self.instrumentation.get_fuzz_result()
