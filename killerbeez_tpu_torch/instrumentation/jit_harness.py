"""jit_harness — whole-loop-on-device instrumentation over the KBVM.

The port of the JAX package's ``instrumentation/jit_harness.py``: the
target is a compiled KBVM program, a candidate batch executes on the
device, and coverage triage (classify -> novelty vs three virgin maps
-> unique crash/hang via simplified traces) runs on the device too;
only verdicts and the few interesting lanes cross to the host.

Engines (the reference's xla / pallas / pallas_fused):
  * ``torch``       the plain PyTorch VM; CPU only
  * ``cuda``        the CUDA VM kernel; fuses automatically with a
                    fusable mutator (havoc), like ``pallas``
  * ``cuda_fused``  havoc and the VM in one CUDA kernel (the flagship
                    path), with two-phase tail scheduling

``run_batch_generations`` runs G whole generations per dispatch on
the device (ops/generations.py: the ``-G`` loop), with a seed-slot
ring that lives on the harness's device.

``{"stateful": 1}`` runs the session tier (stateful/): inputs are
framed message sequences executed message by message from carried
machine state by the plain torch session executor on the harness's
device (the card included; any engine stands down to it, as the JAX
package stands its Pallas engines down to xla), with a state x edge
virgin map triaged beside the classic three.

``{"grammar": spec}`` runs the grammar tier (grammar/): the spec
compiles to tables once, and ``-G`` dispatches (the mesh's too) draw
their candidates with ``grammar_havoc_at`` and run them through
``kbz_vm_kernel`` over every lane; ``cuda_fused`` stands down to
``cuda``, as the JAX package stands its Pallas engines down to xla.

``{"learn": 1}`` runs the learn tier (learn/): the loop installs the
byte-saliency model's weights in ``learn_params`` before each ``-G``
dispatch, whose generations draw masked havoc candidates and run them
through ``kbz_vm_kernel`` over every lane; ``cuda_fused`` stands down
to ``cuda``.

``{"edges": 1}`` keeps lane 0's static-edge counts of each batch (a
host copy started without a wait) for ``get_edges``, ``last_trace``,
``get_edge_pairs`` and the module API — the tracer, showmap and the
rare-edge signer read them; the superbatch and ``-G`` stand down.

Novelty modes:
  * ``exact``      — lanes judged sequentially (lane i sees the virgin
                     maps after lanes < i): the single-exec loop's
                     counts, bit for bit;
  * ``throughput`` — all lanes vs the incoming maps + in-batch hash
                     dedup (over-reports within a batch the way the
                     reference's persistence mode does).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import FUZZ_CRASH, FUZZ_HANG, FUZZ_NONE, FUZZ_RUNNING, MAP_SIZE, \
    resolve_device
from ..models import targets as targets_mod
from ..ops.host_copy import HostCopy
from ..ops.coverage import (
    classify_counts, count_non_255_bytes, has_new_bits_scan, merge_virgin,
    simplify_trace,
)
from ..ops.static_triage import (
    _outside_mask, counts_by_slot, make_static_maps, static_triage,
)
from ..ops.vm_kernel import (
    auto_phase1_steps, compact_lanes, fuzz_batch_2phase,
    run_batch as vm_run_batch, seed_ring,
)
from ..utils.logging import WARNING_MSG
from ..utils.serialization import decode_array, encode_array
from .base import BatchResult, CompactReport, Instrumentation, \
    module_slice_edges, pack_verdicts
from .factory import register_instrumentation

# the sequential exact scan is the parity mode; above this lane count
# the DEFAULT novelty flips to throughput
EXACT_BATCH_GATE = 1024

# lanes the in-step compaction can report per batch; batches with
# more interesting lanes than this fall back to a full-tensor pull
COMPACT_CAP = 1024

M32 = 0xFFFFFFFF


def _triage_exact(vb, vc, vh, cls, simp, statuses, u_slots):
    """Sequential parity triage (the reference's single-exec loop run
    B times) over the static universe: ``cls``/``simp`` are the
    classified and simplified traces at ``u_slots`` (uint8[B, U]).
    Slots outside the universe hold simplified value 1 for every lane,
    so they are carried as two flags per map (some byte still 0xFF,
    some byte with bit 0 set) that the first crash (hang) clears."""
    b = cls.shape[0]
    us = u_slots.long()
    lane = torch.arange(b, device=cls.device)
    new_paths, vbu = has_new_bits_scan(vb[us], cls,
                                       torch.ones(b, dtype=torch.bool,
                                                  device=cls.device))
    vb2 = vb.clone()
    vb2[us] = vbu

    def dedup_map(v, active):
        rets, vu = has_new_bits_scan(v[us], simp, active)
        outside = _outside_mask(u_slots, v.shape[0]).bool()
        any_ff = ((v == 0xFF) & outside).any()
        any_b0 = (((v & 1) != 0) & outside).any()
        first = torch.where(active, lane, b).amin()
        fresh = ~(first < lane)                  # no active lane before
        out_rets = torch.where(fresh & any_ff, 2,
                               torch.where(fresh & any_b0, 1, 0))
        rets = torch.maximum(rets, out_rets)
        v2 = v.clone()
        v2[us] = vu
        v2 = torch.where(active.any(), v2 & ~outside.to(torch.uint8), v2)
        return active & (rets > 0), v2

    uc, vc2 = dedup_map(vc, statuses == FUZZ_CRASH)
    uh, vh2 = dedup_map(vh, statuses == FUZZ_HANG)
    return new_paths.to(torch.int32), uc, uh, vb2, vc2, vh2


def _triage_counts(counts, statuses, u_slots, seg_id, vb, vc, vh, exact):
    """Shared triage tail: static-edge counts -> novelty verdicts +
    virgin updates (exact = the sequential parity scan)."""
    if exact:
        by_slot = counts_by_slot(counts, seg_id, u_slots.shape[0])
        return _triage_exact(vb, vc, vh, classify_counts(by_slot),
                             simplify_trace(by_slot), statuses, u_slots)
    return static_triage(vb, vc, vh, counts, u_slots, seg_id,
                         statuses == FUZZ_CRASH, statuses == FUZZ_HANG)


def _judge(res, u_slots, seg_id, vb, vc, vh, exact):
    """VM results -> (statuses with RUNNING as HANG, new_paths, uc,
    uh, exit codes, vb', vc', vh', counts)."""
    statuses = torch.where(res.status == FUZZ_RUNNING, FUZZ_HANG,
                           res.status).to(torch.int32)
    new_paths, uc, uh, vb2, vc2, vh2 = _triage_counts(
        res.counts, statuses, u_slots, seg_id, vb, vc, vh, exact)
    return (statuses, new_paths, uc, uh, res.exit_code, vb2, vc2, vh2,
            res.counts)


def _session_step(instrs, edge_table, u_slots, seg_id, inputs, lengths,
                  vb, vc, vh, vs, mem_size, max_steps, n_edges, exact,
                  m_max, n_states, state_reg):
    """The stateful twin of ``_fused_step``: framed-sequence batch ->
    session execution (stateful/session.py) -> classic static-edge
    triage PLUS state x edge triage.  The reported per-lane novelty is
    ``max(classic, state)`` — a lane novel only in the state dimension
    is a finding too — while each virgin map updates from its own
    dimension alone."""
    from ..stateful.coverage import state_triage, state_triage_exact
    from ..stateful.session import _run_session_impl
    res = _run_session_impl(instrs, edge_table, inputs, lengths, mem_size,
                            max_steps, n_edges, m_max, n_states, state_reg)
    (statuses, new_paths, uc, uh, exit_codes, vb2, vc2, vh2,
     counts) = _judge(res, u_slots, seg_id, vb, vc, vh, exact)
    s_rets, vs2 = (state_triage_exact if exact else state_triage)(
        vs, res.se_counts)
    return (statuses, torch.maximum(new_paths, s_rets), uc, uh,
            exit_codes, vb2, vc2, vh2, vs2, counts, res.se_counts)


def _fused_step(instrs, edge_table, u_slots, seg_id, inputs, lengths,
                vb, vc, vh, mem_size, max_steps, n_edges, exact):
    """mutated batch -> VM exec -> static-edge triage.  The VM runs
    as the CUDA kernel for CUDA tensors, the plain torch VM on the
    CPU (ops/vm_kernel.run_batch)."""
    res = vm_run_batch(instrs, edge_table, inputs, lengths, mem_size,
                       max_steps, n_edges)
    return _judge(res, u_slots, seg_id, vb, vc, vh, exact)


def _compact(statuses, new_paths, bufs, lens):
    """In-step compaction of the interesting lanes (crash, hang or new
    path): (idx int32[cap], bufs, lens, count), idx filled with 0
    past count."""
    flags = (statuses != FUZZ_NONE) | (new_paths > 0)
    lanes, count = compact_lanes(flags)
    sel = lanes[:min(COMPACT_CAP, flags.shape[0])]
    sl = sel.long()
    return sel, bufs[sl], lens[sl], count


def _fuzz_one(instrs, edge_table, u_slots, seg_id, seed, base_key, its,
              vb, vc, vh, mem_size, max_steps, n_edges, exact, stack_pow2,
              phase1_steps):
    """One fused batch, judged: ``seed`` is the kernel's (ring, lengths,
    slot) triple (ops/vm_kernel.seed_ring for a single seed)."""
    res, bufs, lens = fuzz_batch_2phase(
        instrs, edge_table, *seed, base_key, its, mem_size, max_steps,
        n_edges, stack_pow2=stack_pow2, phase1_steps=phase1_steps)
    return _judge(res, u_slots, seg_id, vb, vc, vh, exact) + (bufs, lens)


def _fused_fuzz_step(instrs, edge_table, u_slots, seg_id, seed, base_key,
                     its, vb, vc, vh, mem_size, max_steps, n_edges, exact,
                     stack_pow2, phase1_steps=0):
    """The flagship product path: per-lane keys fold_in(base_key,
    its), their havoc words, havoc mutation AND VM execution in one
    kernel (two-phase), static-edge triage, and the in-step compaction —
    candidates are born, run and judged on the device.  ``its`` is an
    int64 tensor of uint32 iteration numbers on the device."""
    out = _fuzz_one(instrs, edge_table, u_slots, seg_id, seed, base_key,
                    its, vb, vc, vh, mem_size, max_steps, n_edges, exact,
                    stack_pow2, phase1_steps)
    statuses, new_paths = out[0], out[1]
    bufs, lens = out[9], out[10]
    return out + (_compact(statuses, new_paths, bufs, lens),)


def _fused_fuzz_multi(instrs, edge_table, u_slots, seg_id, seed, base_key,
                      its0, vb, vc, vh, mem_size, max_steps, n_edges, exact,
                      stack_pow2, k, phase1_steps=0):
    """K fused fuzz steps in one call, virgin maps threaded through,
    verdicts bit-packed on the device.  Step j executes iterations
    ``its0 + j * len(its0)``: the candidate streams are bit-identical
    to K sequential steps.  Returns (vb, vc, vh, packed u8[k, B], bufs
    u8[k, B, L], lens i32[k, B], idx i32[k, C], sel_bufs u8[k, C, L],
    sel_lens i32[k, C], count i32[k])."""
    n = its0.shape[0]
    outs = []
    for step in range(k):
        its = (its0 + step * n) & M32
        (statuses, new_paths, uc, uh, _exit, vb, vc, vh, _counts, bufs,
         lens) = _fuzz_one(instrs, edge_table, u_slots, seg_id, seed,
                           base_key, its, vb, vc, vh, mem_size, max_steps,
                           n_edges, exact, stack_pow2, phase1_steps)
        packed = pack_verdicts(statuses, new_paths, uc, uh)
        outs.append((packed, bufs, lens)
                    + _compact(statuses, new_paths, bufs, lens))
    return (vb, vc, vh) + tuple(torch.stack(col) for col in zip(*outs))


# options of the reference whose machinery this package has not
# ported yet: passing one (other than at its default) is an error
_UNPORTED = ()

ENGINES = ("torch", "cuda", "cuda_fused")


@register_instrumentation
class JitHarnessInstrumentation(Instrumentation):
    """Executes KBVM targets fully on-device with AFL-map triage."""
    name = "jit_harness"
    supports_batch = True
    device_backed = True
    OPTION_SCHEMA = {"target": str, "program_file": str, "max_steps": int,
                     "novelty": str, "edges": int, "engine": str,
                     "phase1_steps": int, "gen_ring_slots": int,
                     "gen_findings_cap": int, "gen_admits": int,
                     "gen_fold_every": int, "stateful": int,
                     "msgs": int, "n_states": int, "state_reg": int,
                     "learn": int, "grammar": str,
                     "grammar_stage": int}
    OPTION_DESCS = {
        "target": "built-in KBVM target name (test/hang/libtest/"
                  "tlvstack_vm/...)",
        "program_file": "path to a .npz compiled KBVM program",
        "max_steps": "override the program's hang step budget",
        "novelty": '"exact" (sequential parity; the default, but '
                   'auto-switches to throughput above 1024-lane '
                   'batches) or "throughput"',
        "engine": '"cuda" (default on the card: the CUDA VM kernel, '
                  'fusing with havoc), "cuda_fused" (havoc and the VM '
                  'in one kernel; the flagship path) or "torch" (the '
                  'plain PyTorch VM; the default, and only engine, '
                  'on the CPU)',
        "edges": "1 = keep the last exec's edge counts (tracer / "
                 "showmap mode: get_edges, get_edge_pairs, last_trace); "
                 "the superbatch and -G stand down",
        "phase1_steps": "fused-engine two-phase tail scheduling: "
                        "phase-1 step budget (-1 = auto: max_steps/8 "
                        "when max_steps >= 256; 0 = single phase)",
        "gen_ring_slots": "--generations: device seed-slot ring size "
                          "(slot 0 = the base seed; default 32)",
        "gen_findings_cap": "--generations: findings-ring rows per "
                            "dispatch (0 = auto: batch/8, at least "
                            "256, at most 16384; overflow is counted)",
        "gen_admits": "--generations: max ring admissions per "
                      "generation (default 8, at most slots-1)",
        "gen_fold_every": "--generations on --mesh: AND-fold the virgin "
                          "maps across dp every N generations (0 = auto: "
                          "once per dispatch with reseeding on, every "
                          "generation with it off; a value that does not "
                          "divide the dispatch's G is lowered to one "
                          "that does)",
        "stateful": "1 = session tier: inputs are framed message "
                    "sequences executed message-by-message from "
                    "carried machine state, with state x edge "
                    "novelty folded alongside the classic map (the "
                    "plain torch session executor; any engine stands "
                    "down to it)",
        "msgs": "stateful: max messages per sequence (0 = the "
                "target's registered StatefulSpec, else 4)",
        "n_states": "stateful: abstract-state buckets the state "
                    "register clips into (0 = registered spec, "
                    "else 16)",
        "state_reg": "stateful: the protocol-state register "
                     "(-1 = registered spec, else r7)",
        "grammar": "structure-aware generation tier (grammar/): a "
                   "grammar spec as JSON, @path, \"auto\" (derive "
                   "from the target's static analysis) or "
                   "\"degenerate\" (the parity anchor).  Compiled to "
                   "tables once; -G and --mesh -G candidates come from "
                   "grammar_havoc_at and run through the VM kernel "
                   "(\"cuda_fused\" stands down to \"cuda\"); "
                   "exclusive with learn",
        "grammar_stage": "grammar: structured-lane probability "
                         "numerator of 256 (default 128 = half the "
                         "lanes run structured stages)",
        "learn": "1 = learned mutation shaping (learn/): the loop's "
                 "byte-saliency model shapes -G and --mesh -G "
                 "candidates per generation (masked havoc, then the VM "
                 "kernel; \"cuda_fused\" stands down to \"cuda\"); "
                 "exclusive with grammar",
        **{k: "not ported yet" for k in _UNPORTED},
    }
    DEFAULTS = {"novelty": "exact", "edges": 0, "phase1_steps": -1,
                "gen_ring_slots": 32, "gen_findings_cap": 0,
                "gen_admits": 8, "gen_fold_every": 0, "stateful": 0,
                "msgs": 0, "n_states": 0, "state_reg": -1, "learn": 0,
                "grammar": "", "grammar_stage": 128}

    def __init__(self, options: Optional[str] = None, device="cuda"):
        super().__init__(options)
        self.device = resolve_device(device)
        if self.options["grammar"] and self.options["learn"]:
            raise ValueError(
                "grammar and learn are mutually exclusive — both tiers "
                "would own the generation loop's mutation")
        for key in _UNPORTED:
            if self.options[key] != self.DEFAULTS[key]:
                raise ValueError(f"jit_harness option {key!r} is not "
                                 "ported yet")
        self.program = prog = targets_mod.load_program_from_options(
            self.options,
            'jit_harness needs {"target": name} or '
            '{"program_file": path}')
        if self.options["novelty"] not in ("exact", "throughput"):
            raise ValueError('novelty must be "exact" or "throughput"')
        on_card = self.device.type == "cuda"
        asked = self.options.get("engine")
        self.engine = asked or ("cuda" if on_card else "torch")
        if self.engine not in ENGINES:
            raise ValueError('engine must be "torch", "cuda" or '
                             '"cuda_fused"')
        # -- stateful session tier (stateful/) ------------------------
        # resolved spec: explicit options win, then the target's
        # registered StatefulSpec, then the package defaults
        self.stateful_spec = None
        if self.options["stateful"]:
            from ..models.targets_stateful import get_stateful_spec
            from ..stateful import StatefulSpec
            reg_spec = get_stateful_spec(prog.name) or StatefulSpec()
            self.stateful_spec = StatefulSpec(
                m_max=(int(self.options["msgs"]) or reg_spec.m_max),
                n_states=(int(self.options["n_states"])
                          or reg_spec.n_states),
                state_reg=(int(self.options["state_reg"])
                           if int(self.options["state_reg"]) >= 0
                           else reg_spec.state_reg))
            if asked not in (None, "torch"):
                WARNING_MSG(
                    "jit_harness: stateful sessions run the plain torch "
                    "session executor — %r stands down (the CUDA kernels "
                    "execute single-shot inputs only)", asked)
            self.engine = "torch"
        elif on_card and self.engine == "torch":
            raise ValueError('engine "torch" runs on the CPU only '
                             '(device "cpu"); on the card use "cuda" '
                             'or "cuda_fused"')
        if not on_card and self.engine != "torch":
            raise ValueError(f'engine {self.engine!r} needs the CUDA '
                             'card (device "cuda"); the CPU runs '
                             'engine "torch"')
        # -- learned mutation shaping (learn/) ------------------------
        # the loop installs the live model weights here before each -G
        # dispatch, and the generation loop infers a mask per
        # generation (None = shaping off, the historical path)
        self.learn_params = None
        if self.options["learn"] and self.engine == "cuda_fused":
            WARNING_MSG(
                "jit_harness: learned mutation shaping runs the cuda "
                "engine — \"cuda_fused\" stands down (the fused kernel "
                "generates candidates in-kernel and cannot consume a "
                "per-generation mask)")
            self.engine = "cuda"
        # -- grammar tier (grammar/) ----------------------------------
        # the spec compiles to fixed-shape tables ONCE here, and goes
        # to the device once; -G dispatches (and the mesh's) draw their
        # candidates with grammar_havoc_at.  "auto" derives from the
        # target's static analysis; "degenerate" compiles the
        # parity-anchor tables (bit-identical to havoc)
        self.grammar_tables = None
        self._grammar_gt = None
        if self.options["grammar"]:
            from ..grammar import compile_grammar, derive_grammar
            from ..grammar.spec import load_grammar
            src = str(self.options["grammar"])
            gspec = derive_grammar(prog) if src == "auto" \
                else load_grammar(src)
            self.grammar_tables = compile_grammar(
                gspec, stage_p=int(self.options["grammar_stage"]))
            if self.engine == "cuda_fused":
                WARNING_MSG(
                    "jit_harness: grammar-structured generations run "
                    "the cuda engine — \"cuda_fused\" stands down (the "
                    "fused kernel generates candidates in-kernel and "
                    "cannot consume the structure tables)")
                self.engine = "cuda"
            self._grammar_gt = self.grammar_tables.device(self.device)
        self._fuse_warned = False
        self._grammar_fuse_warned = False
        p1 = int(self.options["phase1_steps"])
        self.phase1_steps = auto_phase1_steps(prog.max_steps) \
            if p1 < 0 else p1
        self.exact = self.options["novelty"] == "exact"
        # whether the user ASKED for exact (vs inheriting the default):
        # the default flips to throughput above EXACT_BATCH_GATE lanes,
        # an explicit request is honored (with a warning)
        try:
            raw_keys = json.loads(options) if options else {}
        except ValueError:
            raw_keys = {}
        self._novelty_explicit = "novelty" in raw_keys
        self._gate_warned = False
        dev = self.device
        self._instrs = torch.as_tensor(prog.instrs, device=dev)
        self._edge_table = torch.as_tensor(prog.edge_table, device=dev)
        u_slots, seg_id = make_static_maps(prog.edge_slot)
        self._u_slots = torch.as_tensor(u_slots, device=dev)
        self._seg_id = torch.as_tensor(seg_id, device=dev)
        # one 64KB map per module, laid out flat
        ms = prog.map_size
        self.virgin_bits = torch.full((ms,), 0xFF, dtype=torch.uint8,
                                      device=dev)
        self.virgin_crash = self.virgin_bits.clone()
        self.virgin_tmout = self.virgin_bits.clone()
        # the state x edge virgin map (stateful tier only; edge-index
        # space, n_states x (E+1) bytes — see stateful/coverage.py)
        self.virgin_state = None
        if self.stateful_spec is not None:
            from ..stateful.coverage import fresh_virgin_state
            self.virgin_state = fresh_virgin_state(
                self.stateful_spec.n_states, prog.n_edges, dev)
        self.total_execs = 0
        self._lane_offsets: Dict[Tuple[int, int], torch.Tensor] = {}
        # --generations: the device seed-slot ring (ops/generations
        # RingState), the (L, slots) it was built for, and the global
        # index of the next generation
        self._gen_ring = None
        self._gen_ring_key = None
        self._gen_count = 0
        # the mutator's seed as the fused kernel's one-slot ring, made
        # once per seed buffer: (seed tensor, seed_len, ring triple)
        self._seed_ring = None
        self._last_unique_crash = False
        self._last_unique_hang = False
        # {"edges": 1}: lane 0's counts row of the last batch, a host
        # copy started without blocking and read by get_edges (and its
        # state x edge row under stateful, read by get_state_pairs)
        self._last_counts: Optional[HostCopy] = None
        self._last_se: Optional[HostCopy] = None

    def _args(self):
        p = self.program
        return (p.mem_size, p.max_steps, p.n_edges, self.exact)

    # -- batched --------------------------------------------------------

    def _apply_exact_gate(self, b: int) -> None:
        """Flip the DEFAULT novelty to throughput above the gate (an
        explicit "exact" request is honored with a warning)."""
        if not (self.exact and b > EXACT_BATCH_GATE) or self._gate_warned:
            return
        self._gate_warned = True
        if self._novelty_explicit:
            WARNING_MSG(
                "jit_harness: exact novelty judges lanes "
                "sequentially — batch %d will be slow (parity "
                "gates only; use \"novelty\": \"throughput\" for "
                "fuzzing)", b)
        else:
            WARNING_MSG(
                "jit_harness: batch %d > %d — switching default "
                "novelty to \"throughput\": same-step duplicates of a "
                "new path each count (pass {\"novelty\": \"exact\"} to "
                "force the sequential parity scan)", b,
                EXACT_BATCH_GATE)
            self.exact = False

    def _keep_counts(self, counts) -> None:
        """{"edges": 1}: start the host copy of lane 0's counts row (the
        single-exec surface's lane) without waiting for the card."""
        if self.options.get("edges"):
            self._last_counts = HostCopy(counts[:1])

    def run_batch(self, inputs, lengths) -> BatchResult:
        """Execute a uint8[B, L] batch; results stay device tensors."""
        b = int(inputs.shape[0])
        self._apply_exact_gate(b)
        inputs = torch.as_tensor(inputs, dtype=torch.uint8,
                                 device=self.device)
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=self.device)
        if self.stateful_spec is not None:
            return self._run_batch_stateful(inputs, lengths)
        (statuses, new_paths, uc, uh, exit_codes, vb, vc, vh,
         counts) = _fused_step(
            self._instrs, self._edge_table, self._u_slots, self._seg_id,
            inputs, lengths, self.virgin_bits, self.virgin_crash,
            self.virgin_tmout, *self._args())
        self.virgin_bits, self.virgin_crash, self.virgin_tmout = vb, vc, vh
        self.total_execs += b
        self._keep_counts(counts)
        return BatchResult(statuses=statuses, new_paths=new_paths,
                           unique_crashes=uc, unique_hangs=uh,
                           exit_codes=exit_codes)

    def _run_batch_stateful(self, inputs, lengths) -> BatchResult:
        """Session-tier batch execution: framed sequences through the
        session executor, dual-map triage (see _session_step)."""
        spec = self.stateful_spec
        (statuses, new_paths, uc, uh, exit_codes, vb, vc, vh, vs,
         counts, se) = _session_step(
            self._instrs, self._edge_table, self._u_slots, self._seg_id,
            inputs, lengths, self.virgin_bits, self.virgin_crash,
            self.virgin_tmout, self.virgin_state, *self._args(),
            spec.m_max, spec.n_states, spec.state_reg)
        self.virgin_bits, self.virgin_crash, self.virgin_tmout = vb, vc, vh
        self.virgin_state = vs
        self.total_execs += int(inputs.shape[0])
        self._keep_counts(counts)
        if self.options.get("edges"):
            self._last_se = HostCopy(se[:1])
        return BatchResult(statuses=statuses, new_paths=new_paths,
                           unique_crashes=uc, unique_hangs=uh,
                           exit_codes=exit_codes)

    # -- fused mutate+execute (the flagship product path) ---------------

    def wants_fused(self, mutator) -> bool:
        """True when this instrumentation drives the one-kernel
        mutate+execute path for ``mutator``: any CUDA engine fuses
        with a fusable mutator (havoc) — the fused kernel consumes the
        mutator's OWN per-lane keys, so candidates and verdicts are
        bit-identical to the mutate-then-execute pipeline.  Sessions
        never fuse: the fused kernel runs single-shot inputs only.  The
        grammar mutator fuses only under an explicit ``cuda_fused``
        (as plain havoc, with a warning)."""
        if self.stateful_spec is not None:
            return False
        fusable = getattr(mutator, "fused_spec", None) is not None
        if self.engine == "cuda_fused" and not fusable \
                and not self._fuse_warned:
            self._fuse_warned = True
            WARNING_MSG(
                "jit_harness: engine \"cuda_fused\" needs a fusable "
                "mutator (havoc); %s mutates separately — running the "
                "unfused cuda engine",
                getattr(mutator, "name", type(mutator).__name__))
        if getattr(mutator, "focus_positions", None) is not None:
            # a focus mask (crack-stage frontier bytes) is honored
            # only by the mutate-then-execute path; the fused kernel
            # draws its own edit positions and would drop the mask, so
            # fusion stands down until the mask clears
            return False
        if getattr(mutator, "grammar_tables", None) is not None:
            # the grammar mutator's fused spec is plain havoc: the
            # default cuda engine keeps its structure (grammar_havoc_at,
            # then kbz_vm_kernel); an explicit cuda_fused fuses it as
            # the JAX package's pallas_fused does, and says so
            if self.engine != "cuda_fused":
                return False
            if not self._grammar_fuse_warned:
                self._grammar_fuse_warned = True
                WARNING_MSG(
                    "jit_harness: engine \"cuda_fused\" fuses the "
                    "grammar mutator as plain havoc — its structure "
                    "stands down (use engine \"cuda\" to keep it)")
        return self.engine in ("cuda", "cuda_fused") and fusable

    def _fused_inputs(self, mutator, its):
        """The fused kernel's inputs on the device.  ``its`` is a run of
        consecutive iteration numbers (``peek_iterations``): it is made
        on the device from its first number, and the seed and key come
        cached from the mutator, so a dispatch copies nothing from the
        host — a pageable host copy would wait for the queued batches."""
        seed, seed_len, base_key, stack_pow2 = mutator.fused_spec()
        seed = seed.to(self.device)
        if self._seed_ring is None or self._seed_ring[0] is not seed or \
                self._seed_ring[1] != int(seed_len):
            self._seed_ring = (seed, int(seed_len),
                               seed_ring(seed, seed_len))
        return (self._seed_ring[2], base_key.to(self.device),
                self._its(its), int(stack_pow2))

    def _its(self, its, pad_to: int = 0) -> torch.Tensor:
        """``its`` (a run of consecutive iteration numbers,
        ``peek_iterations``) on the device, made there from its first
        number so that a dispatch copies nothing from the host, padded
        to ``pad_to`` lanes with lane 0's number."""
        n = len(its)
        start = int(its[0]) if n else 0
        if n and int(its[-1]) - start != n - 1:
            raise ValueError("fused paths take consecutive iterations")
        b = max(n, pad_to)
        ar = self._lane_offsets.get((n, b))
        if ar is None:
            ar = torch.arange(b, dtype=torch.int64, device=self.device)
            ar = self._lane_offsets[(n, b)] = torch.where(ar < n, ar, 0)
        return (ar + start) & M32

    def run_batch_fused(self, mutator, its
                        ) -> Tuple[BatchResult, Any, Any, CompactReport]:
        """Execute iterations ``its`` of ``mutator`` (havoc) with
        mutation fused into the VM kernel.  Returns (BatchResult,
        mutant bufs uint8[B, L], lens int32[B], CompactReport), all
        device tensors."""
        n = len(its)
        self._apply_exact_gate(n)
        seed, base_key, its, sp = self._fused_inputs(mutator, its)
        (statuses, new_paths, uc, uh, exit_codes, vb, vc, vh, counts,
         bufs, lens, compact) = _fused_fuzz_step(
            self._instrs, self._edge_table, self._u_slots, self._seg_id,
            seed, base_key, its, self.virgin_bits,
            self.virgin_crash, self.virgin_tmout, *self._args(), sp,
            self.phase1_steps)
        self.virgin_bits, self.virgin_crash, self.virgin_tmout = vb, vc, vh
        self.total_execs += n
        self._keep_counts(counts)
        return (BatchResult(statuses=statuses, new_paths=new_paths,
                            unique_crashes=uc, unique_hangs=uh,
                            exit_codes=exit_codes),
                bufs, lens, CompactReport(*compact))

    def run_batch_fused_multi(self, mutator, its, k: int):
        """K fused steps in one call (see _fused_fuzz_multi).  Returns
        (packed uint8[k, B], bufs uint8[k, B, L], lens int32[k, B],
        (idx, bufs, lens, count) stacked compact), device tensors;
        step j executed iterations ``its + j*len(its)``.  Callers
        advance the mutator by k*len(its)."""
        n = len(its)
        self._apply_exact_gate(n)
        seed, base_key, its, sp = self._fused_inputs(mutator, its)
        (vb, vc, vh, packed, bufs, lens, sel_idx, sel_bufs, sel_lens,
         counts) = _fused_fuzz_multi(
            self._instrs, self._edge_table, self._u_slots, self._seg_id,
            seed, base_key, its, self.virgin_bits,
            self.virgin_crash, self.virgin_tmout, *self._args(), sp,
            int(k), self.phase1_steps)
        self.virgin_bits, self.virgin_crash, self.virgin_tmout = vb, vc, vh
        self.total_execs += int(k) * n
        return packed, bufs, lens, (sel_idx, sel_bufs, sel_lens, counts)

    # -- device-resident generations (ops/generations.py) ---------------

    def supports_generations(self, mutator) -> bool:
        """True when the G-generation device loop can drive
        ``mutator``: it needs the fused candidate spec (havoc's keyed
        per-lane streams) and stands down while a focus mask is
        installed (the device loop generates candidates itself and
        would silently drop the mask).  Engine-agnostic: the torch
        engine runs the same loop with the plain versions (the CPU
        surface)."""
        return (getattr(mutator, "fused_spec", None) is not None
                and getattr(mutator, "focus_positions", None) is None
                and not self.options.get("edges"))

    def _ensure_gen_ring(self, seed_buf, seed_len) -> None:
        """(Re)build the device seed-slot ring: slot 0 = the base seed,
        pinned; the rest empty until edge-novel lanes admit.  Rebuilt
        when the candidate buffer width changes (a new base seed shape
        would make stale slots unloadable)."""
        from ..ops.generations import new_ring
        slots = max(int(self.options["gen_ring_slots"]), 2)
        L = int(seed_buf.shape[0])
        if self._gen_ring is not None and \
                self._gen_ring_key == (L, slots):
            return
        self._gen_ring = new_ring(seed_buf.to(self.device), seed_len,
                                  slots)
        self._gen_ring_key = (L, slots)

    def run_batch_generations(self, mutator, its, g: int,
                              pad_to: Optional[int] = None,
                              reseed: bool = True):
        """Run ``g`` full generations on the device in ONE dispatch
        (ops/generations.run_generations): mutate from the device
        seed-slot ring, execute, triage against the device-resident
        virgin maps, reseed the ring from edge-novel lanes, and return
        the bounded findings ring + admission ledger as a
        GenerationOutcome of device tensors.  Generation j consumes
        iterations ``its + j*len(its)``; callers advance the mutator by
        ``g*len(its)``.  Lanes are padded to ``pad_to`` with lane 0's
        iteration (coverage no-ops).  ``reseed=False`` pins every
        generation to slot 0 (the base seed): the candidate stream is
        then bit-identical to the host-driven loop's."""
        from ..ops.generations import (
            GenerationOutcome, gen_ring_caps, run_generations,
        )
        n = len(its)
        b = max(n, pad_to or 0)
        self._apply_exact_gate(b)
        seed_buf, seed_len, base_key, stack_pow2 = mutator.fused_spec()
        self._ensure_gen_ring(seed_buf, seed_len)
        salt = int(getattr(mutator, "options", {}).get("seed", 0)) & M32
        adm_cap, cap = gen_ring_caps(
            self.options["gen_admits"], self.options["gen_findings_cap"],
            b, self._gen_ring_key[1])
        spec = self.stateful_spec
        (vb, vc, vh, vs), ring, rep = run_generations(
            self._instrs, self._edge_table, self._u_slots, self._seg_id,
            self._gen_ring, base_key.to(self.device),
            self._its(its, b), n, self._gen_count, salt,
            self.virgin_bits, self.virgin_crash, self.virgin_tmout,
            mem_size=self.program.mem_size,
            max_steps=self.program.max_steps,
            n_edges=self.program.n_edges, exact=self.exact,
            stack_pow2=int(stack_pow2), g=int(g),
            phase1_steps=self.phase1_steps, reseed=bool(reseed),
            adm_cap=adm_cap, findings_cap=cap,
            stateful=None if spec is None else (
                spec.m_max, spec.n_states, spec.state_reg),
            vs=self.virgin_state, learn_params=self.learn_params,
            grammar=None if self.grammar_tables is None else (
                self.grammar_tables, self._grammar_gt))
        self.virgin_bits, self.virgin_crash, self.virgin_tmout = vb, vc, vh
        self.virgin_state = vs
        self._gen_ring = ring
        out = GenerationOutcome(*rep, gen0=self._gen_count, g=int(g),
                                n_real=n, cap=cap)
        self._gen_count += int(g)
        self.total_execs += int(g) * n
        return out

    # -- single-exec shim ----------------------------------------------

    def enable(self, input_bytes: Optional[bytes] = None,
               cmd_line: Optional[str] = None) -> None:
        if input_bytes is None:
            raise ValueError("jit_harness needs input bytes")
        L = max(((len(input_bytes) + 7) // 8) * 8, 8)
        buf = np.zeros((1, L), dtype=np.uint8)
        buf[0, :len(input_bytes)] = np.frombuffer(input_bytes,
                                                  dtype=np.uint8)
        res = self.run_batch(buf, np.array([len(input_bytes)],
                                           dtype=np.int32))
        self.last_status = int(res.statuses[0])
        self.last_new_path = int(res.new_paths[0])
        self._last_unique_crash = bool(res.unique_crashes[0])
        self._last_unique_hang = bool(res.unique_hangs[0])

    def last_unique_crash(self) -> bool:
        return self._last_unique_crash

    def last_unique_hang(self) -> bool:
        return self._last_unique_hang

    # -- edge reporting ({"edges": 1}; tracer, showmap, rare-edge) -------

    def _lane0_counts(self) -> Optional[np.ndarray]:
        """Lane 0's static-edge counts of the last batch (overflow
        column dropped), or None before any batch or without edges."""
        if self._last_counts is None:
            return None
        return np.asarray(self._last_counts)[0, :-1]

    def get_edges(self) -> Optional[List[Tuple[int, int]]]:
        """Edge slots of the last exec (lane 0) as (slot, hit_count)
        pairs; the tracer reads these (requires {"edges": 1}).  Counts
        are mod-256, like AFL's uint8 trace_bits: an edge hit a
        multiple of 256 times wraps to 0 and drops out."""
        c = self._lane0_counts()
        if c is None:
            return None
        agg: dict = {}
        for s, n in zip(self.program.edge_slot, c.astype(np.int64)):
            if n:
                agg[int(s)] = agg.get(int(s), 0) + int(n)
        return sorted(agg.items())

    def last_trace(self) -> Optional[np.ndarray]:
        """Dense uint8[map_size] bitmap of the last exec (lane 0),
        rebuilt from the static-edge counts (requires {"edges": 1};
        counts wrap at u8 like trace_bits)."""
        c = self._lane0_counts()
        if c is None:
            return None
        dense = np.zeros(self.program.map_size, np.uint8)
        np.add.at(dense, np.asarray(self.program.edge_slot), c)
        return dense

    def get_edge_pairs(self, module: Optional[str] = None
                       ) -> Optional[List[Tuple[int, int, int]]]:
        """(from_id, to_id, hit_count) records of the last exec (0 =
        program entry); ``module`` keeps the edges landing in that
        module.  Counts are mod-256 (see get_edges)."""
        c = self._lane0_counts()
        if c is None:
            return None
        prog = self.program
        ids = prog.block_ids
        mod_range = None
        if module is not None:
            mod_range = prog.modules[list(prog.module_names)
                                     .index(module)][1:]
        out = []
        for e in np.nonzero(c)[0]:
            f = int(prog.edge_from[e])
            t = int(prog.edge_to[e])
            if mod_range is not None and not \
                    (mod_range[0] <= t < mod_range[1]):
                continue
            out.append((0 if f < 0 else ids[f], ids[t], int(c[e])))
        return out

    def get_module_info(self) -> List[str]:
        """Coverage module names (one per target module)."""
        return list(self.program.module_names)

    def module_coverage_bytes(self) -> Dict[str, int]:
        """Touched virgin bytes per module."""
        vb = self.virgin_bits.cpu().numpy()
        return {name: int((vb[m * MAP_SIZE:(m + 1) * MAP_SIZE]
                           != 0xFF).sum())
                for m, name in enumerate(self.program.module_names)}

    def module_map_ranges(self):
        return [(name, m * MAP_SIZE, (m + 1) * MAP_SIZE)
                for m, name in enumerate(self.program.module_names)]

    def get_module_edges(self, module: str
                         ) -> Optional[List[Tuple[int, int]]]:
        """get_edges restricted to one module's slot space, with
        module-local slot numbers."""
        return module_slice_edges(self.get_edges(),
                                  list(self.program.module_names),
                                  module, MAP_SIZE)

    # -- stateful session surface (showmap / corpus / telemetry) --------

    def state_signature(self, buf: bytes):
        """The state x edge signature of ONE framed input as sorted
        ``[state, slot]`` pairs — PURE (no virgin-map fold; a side
        execution through the session executor).  The corpus sidecar
        and picker wire format.  None when the tier is off."""
        sigs = self.state_signatures([buf])
        return None if sigs is None else sigs[0]

    def state_signatures(self, bufs: List[bytes]):
        """``state_signature`` of several framed inputs from ONE session
        batch (lanes are independent, so each row's pairs are the
        single input's): the loop signs a batch's admissions with one
        run of the executor instead of one per admission.  None when the
        tier is off."""
        if self.stateful_spec is None:
            return None
        from ..mutators.base import pack_byte_rows
        from ..stateful.session import run_session_batch, state_edge_pairs
        arr, lens = pack_byte_rows(bufs)
        res = run_session_batch(
            self.program, torch.as_tensor(arr, device=self.device),
            torch.as_tensor(lens, device=self.device), self.stateful_spec)
        return [state_edge_pairs(row, self.program.edge_slot)
                for row in res.se_counts.cpu().numpy()]

    def state_coverage_stats(self):
        """(touched state x edge pairs, distinct states seen) from the
        live virgin map — the telemetry gauges.  None when the tier is
        off.  Waits for the card (a tiny copy)."""
        if self.stateful_spec is None:
            return None
        from ..stateful.coverage import state_coverage_stats
        return state_coverage_stats(self.virgin_state.cpu().numpy(),
                                    self.stateful_spec.n_states)

    def get_state_pairs(self):
        """Last exec's (state, slot, count) records (requires
        {"edges": 1}, like get_edges) — the showmap "state" section
        source."""
        if self._last_se is None:
            return None
        se = np.asarray(self._last_se)[0, :, :-1]
        slots = np.asarray(self.program.edge_slot)
        agg: dict = {}
        for s, e in zip(*np.nonzero(se)):
            key = (int(s), int(slots[e]))
            agg[key] = agg.get(key, 0) + int(se[s, e])
        return [(s, slot, c) for (s, slot), c in sorted(agg.items())]

    # -- state / merge --------------------------------------------------

    def _spec_dict(self) -> Dict[str, int]:
        spec = self.stateful_spec
        return {"m_max": spec.m_max, "n_states": spec.n_states,
                "state_reg": spec.state_reg}

    def get_state(self) -> str:
        d = {
            "instrumentation": self.name,
            "target": self.program.name,
            "total_execs": self.total_execs,
            "virgin_bits": encode_array(self.virgin_bits.cpu().numpy()),
            "virgin_crash": encode_array(self.virgin_crash.cpu().numpy()),
            "virgin_tmout": encode_array(self.virgin_tmout.cpu().numpy()),
        }
        if self.stateful_spec is not None:
            d["virgin_state"] = encode_array(self.virgin_state.cpu().numpy())
            d["stateful"] = self._spec_dict()
        if len(self.program.modules) > 1:
            d["modules"] = list(self.program.module_names)
        return json.dumps(d)

    def _check_state_layout(self, d: Dict[str, Any], arr) -> None:
        """States only interoperate across identical module layouts."""
        if arr.shape != (self.program.map_size,):
            raise ValueError(
                f"state map is {arr.shape[0]} bytes but "
                f"{self.program.name!r} has {self.program.map_size} "
                f"({len(self.program.modules)} module(s))")
        mods = d.get("modules")
        if mods is not None and tuple(mods) != self.program.module_names:
            raise ValueError(
                f"state modules {mods} != {self.program.module_names}")

    def _check_state_state_layout(self, d: Dict[str, Any], arr) -> None:
        """virgin_state interop requires the same (n_states, E+1) shape
        AND the same session spec: same-sized maps built under
        different state registers (or message capacities) encode
        different state machines, and AND-folding them would mark
        genuinely novel (state, edge) rows as seen."""
        from ..stateful.coverage import state_map_size
        want = state_map_size(self.stateful_spec.n_states,
                              self.program.n_edges)
        if arr.shape != (want,):
            raise ValueError(
                f"state-map is {arr.shape[0]} bytes but "
                f"{self.program.name!r} with n_states="
                f"{self.stateful_spec.n_states} has {want}")
        meta = d.get("stateful")
        if meta is not None:
            mine = self._spec_dict()
            theirs = {k: meta.get(k) for k in mine}
            if theirs != mine:
                raise ValueError(
                    f"state spec mismatch: state is from {theirs}, this "
                    f"instance runs {mine} — same-sized maps under "
                    f"different specs encode different state machines")

    def _load_maps(self, d: Dict[str, Any]):
        for key in ("virgin_bits", "virgin_crash", "virgin_tmout"):
            if key in d:
                arr = decode_array(d[key])
                self._check_state_layout(d, arr)
                yield key, torch.as_tensor(arr, device=self.device)
        if self.stateful_spec is not None and "virgin_state" in d:
            arr = decode_array(d["virgin_state"])
            self._check_state_state_layout(d, arr)
            yield "virgin_state", torch.as_tensor(arr, device=self.device)

    def set_state(self, state: str) -> None:
        d = json.loads(state)
        if d.get("instrumentation") not in (None, self.name):
            raise ValueError(
                f"state is for {d.get('instrumentation')!r}, not "
                f"{self.name!r}")
        self.total_execs = int(d.get("total_execs", 0))
        for key, arr in self._load_maps(d):
            setattr(self, key, arr)

    def merge(self, other_state: str) -> None:
        d = json.loads(other_state)
        for key, arr in self._load_maps(d):
            setattr(self, key, merge_virgin(getattr(self, key), arr))
        self.total_execs += int(d.get("total_execs", 0))

    def coverage_bytes(self) -> int:
        """Touched virgin bytes (status reporting)."""
        return int(count_non_255_bytes(self.virgin_bits))
