"""Device-resident generation loop — G full fuzzing generations per
host dispatch.

Port of the JAX package's ``ops/generations.py``: the single-chip
scan here, its per-dp-shard pieces (``_select_slot``,
``_ring_append_and_admit``, ``MeshGenerationOutcome``) shared with the
mesh scan in ``parallel/distributed.py``.  The host-driven loop
returns to the host every batch or superbatch: verdicts cross, triage
and corpus reseeding run there.  Here one dispatch enqueues, G times,

    seed-slot pick -> havoc mutate + KBVM execute (the fused kernel,
    reading its seed from the device ring) -> classify -> novelty vs
    the device-resident virgin maps -> findings-ring append ->
    seed-slot ring reseed

on the current stream with no host read in between, and the host
drains ONE bounded findings report + admission ledger per dispatch.
``jax.lax.scan`` becomes a Python loop that only enqueues work.

Device-resident state:

  * the three AFL virgin maps, judged by the same ``_triage_counts``
    tail every other path uses;
  * a seed-slot ring (``RingState``): S slots x L bytes + lengths +
    per-slot hit/find stats.  Slot 0 pins the base seed; edge-novel
    lanes (ret 2) are admitted FIFO into slots 1..S-1 (admission k
    lands in slot ``1 + k % (S-1)``), at most ``adm_cap`` per
    generation in lane order, each recorded in a per-generation ledger
    the host replays;
  * a bounded findings ring (packed verdict byte, generation index,
    lane iteration number, mutant bytes) that interesting lanes append
    to in (generation, lane) order; overflow is COUNTED by the write
    pointer, never silent.

Parity: lane keys are ``fold_in(base_key, absolute_iteration)`` as in
the mutator and the fused kernel, so with reseeding off the candidate
stream is the host-driven loop's; with reseeding on, generation g
mutates the slot a ``_mix32`` draw over the filled slots picks —
deterministic and host-replayable (``np_select_slot``).

Torch has no ``mode="drop"`` scatter and no fixed-size ``nonzero``:
rows that JAX drops go to a sink row past the end (the ring carries
row S, the findings ring row F, neither ever read), and the lanes of a
mask come from ``compact_lanes``.  Nothing here reads a device value
on the host.  The ring updates in place; everything the report
exports (``ring_filled`` cloned, the findings ring and the ledger made
fresh per dispatch) is never written by a later dispatch, so a report
may be read after the next dispatch is enqueued.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .. import FUZZ_NONE
from ..grammar.device import grammar_from_ring
from ..models.vm import _mix32
from ..stateful.coverage import state_triage, state_triage_exact
from ..stateful.session import _run_session_impl
from .host_copy import HostCopy
from .vm_kernel import (
    compact_lanes, fuzz_batch_2phase, havoc_from_ring, run_batch,
)

#: default seed-slot ring size (slot 0 = pinned base seed)
DEFAULT_RING_SLOTS = 32
#: default bounded findings-ring capacity per dispatch
DEFAULT_FINDINGS_CAP = 16384
#: default max ring admissions per generation (lane order)
DEFAULT_ADM_CAP = 8

M32 = 0xFFFFFFFF


def gen_ring_caps(gen_admits: int, gen_findings_cap: int,
                  batch: int, slots: int) -> tuple:
    """Shared --generations ring sizing: clamp the per-generation
    admission cap to the ring's S-1 distinct admission slots, and
    auto-size the findings ring when no explicit cap is set.  Returns
    ``(adm_cap, findings_cap)``.

    Auto-cap rationale (the JAX package's, measured there on the CPU):
    every generation pays a compaction + gather + scatter of width
    min(cap, batch) to append into the findings ring, so the default
    stays well below the batch shape.  Steady-state interesting lanes
    are rare (that's the premise of the mode); overflow is counted and
    warned, and explicit gen_findings_cap values are honored."""
    adm_cap = min(max(int(gen_admits), 1), int(slots) - 1)
    cap = int(gen_findings_cap)
    if cap <= 0:
        cap = min(DEFAULT_FINDINGS_CAP, max(int(batch) // 8, 256))
    return adm_cap, cap


def _host_array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class GenerationOutcome(NamedTuple):
    """One G-generation dispatch's host-facing report — device tensors
    until ``materialize()``."""
    # bounded findings ring (valid rows: first min(fr_ptr, cap))
    fr_pack: Any      # uint8[F]  pack_verdicts lane byte
    fr_gen: Any       # int32[F]  global generation index
    fr_iter: Any      # int64[F]  absolute mutator iteration (uint32)
    fr_len: Any       # int32[F]
    fr_bufs: Any      # uint8[F, L]
    fr_ptr: Any       # int32 scalar: TOTAL interesting lanes seen
    # per-generation ledger
    sel: Any          # int32[G] ring slot each generation mutated
    adm_raw: Any      # int32[G] edge-novel lanes (uncapped)
    adm_valid: Any    # int32[G, A]
    adm_slot: Any     # int32[G, A]
    adm_iter: Any     # int64[G, A] (uint32)
    adm_len: Any      # int32[G, A]
    adm_bufs: Any     # uint8[G, A, L]
    ring_filled: Any  # int32[S] final ring occupancy (gauge)
    # dispatch metadata (host ints)
    gen0: int = 0     # global generation index of this dispatch's gen 0
    g: int = 0        # generations in this dispatch
    n_real: int = 0   # real (non-padding) lanes per generation
    cap: int = 0      # findings-ring capacity F

    def prefetch(self) -> "GenerationOutcome":
        """Start every field's device->host copy without blocking (the
        loop enqueues the next dispatch while these land); returns the
        report with the copies in place of the tensors."""
        return self._replace(**{
            f: HostCopy(v) for f, v in self._asdict().items()
            if isinstance(v, torch.Tensor)})

    def materialize(self) -> "GenerationOutcome":
        """Every field as numpy (the blocking device wait the loop
        wraps in its watchdog guard)."""
        return self._replace(**{
            f: _host_array(v) for f, v in self._asdict().items()
            if isinstance(v, (torch.Tensor, HostCopy))})


class MeshGenerationOutcome(NamedTuple):
    """One mesh dispatch's host-facing report: the per-dp-shard twin of
    ``GenerationOutcome``.  Every ring/ledger field carries a leading
    ``dp`` axis, even at dp = 1 (shard d's findings ring, seed-slot ring
    and admission ledger are independent device state); the loop drains
    shards in shard order through ``shard(d)`` views."""
    fr_pack: Any      # uint8[dp, F]
    fr_gen: Any       # int32[dp, F]
    fr_iter: Any      # int64[dp, F] (uint32)
    fr_len: Any       # int32[dp, F]
    fr_bufs: Any      # uint8[dp, F, L]
    fr_ptr: Any       # int32[dp]
    sel: Any          # int32[dp, G]
    adm_raw: Any      # int32[dp, G]
    adm_valid: Any    # int32[dp, G, A]
    adm_slot: Any     # int32[dp, G, A]
    adm_iter: Any     # int64[dp, G, A] (uint32)
    adm_len: Any      # int32[dp, G, A]
    adm_bufs: Any     # uint8[dp, G, A, L]
    ring_filled: Any  # int32[dp, S]
    gen0: int = 0
    g: int = 0
    n_real: int = 0   # GLOBAL lanes per generation (dp x per-shard)
    cap: int = 0      # findings-ring capacity F PER SHARD
    n_shards: int = 1

    prefetch = GenerationOutcome.prefetch
    materialize = GenerationOutcome.materialize

    def shard(self, d: int) -> GenerationOutcome:
        """Shard ``d``'s view as a single-chip-shaped outcome (call
        after ``materialize()``)."""
        return GenerationOutcome(
            *(getattr(self, f)[d] for f in GenerationOutcome._fields[:14]),
            gen0=self.gen0, g=self.g,
            n_real=self.n_real // max(self.n_shards, 1), cap=self.cap)


class RingState(NamedTuple):
    """The seed-slot ring on the device.  Each array has S + 1 rows:
    row S is the sink that admissions past the per-generation count
    are scattered to, never read (``view()`` drops it)."""
    bufs: torch.Tensor    # uint8[S + 1, L]
    lens: torch.Tensor    # int32[S + 1]
    filled: torch.Tensor  # int32[S + 1]
    hits: torch.Tensor    # int32[S + 1]
    finds: torch.Tensor   # int32[S + 1]
    ptr: torch.Tensor     # int32 scalar: admissions so far

    @property
    def slots(self) -> int:
        return self.bufs.shape[0] - 1

    def view(self) -> tuple:
        """(bufs, lens, filled, hits, finds, ptr) without the sink row —
        the JAX package's ring tuple."""
        s = self.slots
        return (self.bufs[:s], self.lens[:s], self.filled[:s],
                self.hits[:s], self.finds[:s], self.ptr)


def new_ring(seed_buf: torch.Tensor, seed_len: int, slots: int
             ) -> RingState:
    """A ring of ``slots`` slots on the seed's device: slot 0 the base
    seed (``seed_buf`` uint8[L]), the rest empty.  The length goes in
    with ``fill_``, a kernel argument, so nothing waits for the card."""
    dev = seed_buf.device
    L = seed_buf.shape[0]
    bufs = torch.zeros((slots + 1, L), dtype=torch.uint8, device=dev)
    bufs[0].copy_(seed_buf)
    z = [torch.zeros(slots + 1, dtype=torch.int32, device=dev)
         for _ in range(4)]
    z[0][:1].fill_(int(seed_len))
    z[1][:1].fill_(1)
    return RingState(bufs, z[0], z[1], z[2], z[3],
                     torch.zeros((), dtype=torch.int32, device=dev))


def _slot_draw(gen_id: int, salt: int) -> int:
    """The uint32 ``_mix32`` draw of generation ``gen_id``: a host
    integer, since the generation index and the salt are."""
    m = M32
    x = ((int(gen_id) * 0x9E3779B9) & m) ^ (int(salt) & m)
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & m
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & m
    x ^= x >> 16
    return x


def _select_slot(filled: torch.Tensor, gen_id: int, salt: int
                 ) -> torch.Tensor:
    """Deterministic seed-slot pick for one generation, on the device:
    draw k uniformly below the number of filled slots, return the
    index of the (k+1)-th filled slot (slot 0 is always filled).
    ``argmax(cumsum > k)`` is ``(cumsum <= k).sum()``, the cumulative
    fill being non-decreasing.  Returns an int32 scalar tensor."""
    nf = filled.sum().clamp(min=1)
    k = torch.remainder(nf.new_full((), _slot_draw(gen_id, salt)), nf)
    return (torch.cumsum(filled, 0) <= k).sum().to(torch.int32)


def np_select_slot(filled: np.ndarray, gen_id: int, salt: int) -> int:
    """Host replay of ``_select_slot`` (numpy, bit-exact) — the
    deterministic-policy witness the parity tests pin."""
    nf = max(int(np.sum(filled)), 1)
    k = _slot_draw(gen_id, salt) % nf
    return int(np.argmax(np.cumsum(filled) > k))


def _cached_slot_mask(learn_params, ring_bufs, ring_lens, sel,
                      mask_cache, mask_valid):
    """The learned mask of ring slot ``sel`` (an int32 scalar tensor),
    through the per-slot cache shared by both generation loops (this
    one and the mesh's per-shard loop): a slot's mask is a pure function
    of the weights (fixed for a dispatch) and the slot's bytes.  The
    JAX package skips inference on a cache hit with ``lax.cond``; here
    the fresh mask is always computed (one [L, D] chain) and the cached
    one selected on the device, so no host read decides the branch.
    Cached or fresh, the bytes are the same.  ``mask_cache`` uint8[S +
    1, L] and ``mask_valid`` int32[S + 1] (row S the sink) update in
    place.  Returns the mask uint8[L]."""
    from ..learn.model import masked_saliency
    slot = sel.reshape(1).long()
    fresh = masked_saliency(learn_params,
                            ring_bufs.index_select(0, slot)[0],
                            ring_lens.index_select(0, slot)[0])
    hit = mask_valid.index_select(0, slot)[0] > 0
    mask = torch.where(hit, mask_cache.index_select(0, slot)[0], fresh)
    mask_cache.index_copy_(0, slot, mask[None])
    mask_valid.index_fill_(0, slot, 1)
    return mask


def _invalidate_admitted_masks(mask_valid, ledger, n_slots: int) -> None:
    """Ring admission overwrote slots 1..S-1: their cached masks are
    stale once new bytes land.  ``ledger`` is ``_ring_append_and_admit``'s
    (row 0 the validity, row 1 slot x validity); rows past the
    admission count go to the sink row ``n_slots``."""
    inv = torch.where(ledger[0] > 0, ledger[1], n_slots).long()
    mask_valid.index_fill_(0, inv, 0)


def new_mask_cache(slots: int, L: int, dev):
    """An all-invalid per-slot mask cache (with the sink row): the
    weights retrain between dispatches, so each dispatch starts cold."""
    return (torch.zeros((slots + 1, L), dtype=torch.uint8, device=dev),
            torch.zeros(slots + 1, dtype=torch.int32, device=dev))


def _ring_append_and_admit(flags, aflags, packed, its, bufs, lens,
                           gen_id, sel, ring: RingState, fr, adm_cap,
                           reseed):
    """One generation's findings-ring append + FIFO seed-slot admission
    + admission-ledger emission.  Host replay (``fuzzer/loop.py``) and
    the parity suites pin the semantics: the findings pointer COUNTS
    overflow (rows past the ring capacity go to the sink), admissions
    are FIFO into slots 1..S-1, and ledger rows past the admission
    count are masked to zero (their bytes are lane 0's, as the JAX
    package's fixed-size nonzero fills them).

    ``ring`` is updated in place (its ``ptr`` replaced); ``fr`` is the
    list ``[pack, gen, iter, len, bufs, ptr]`` with a sink row at F,
    updated in place but for ``ptr``, which is replaced.  ``flags``
    marks the interesting lanes, ``aflags`` the ring-admissible ones
    (both already masked to real lanes).  Returns ``(ring', araw,
    ledger)``."""
    fr_pack, fr_gen, fr_iter, fr_len, fr_bufs, fr_ptr = fr
    dev = flags.device
    F = fr_pack.shape[0] - 1
    S = ring.slots
    A = int(adm_cap)
    cap_g = min(F, flags.shape[0])

    # findings ring: interesting lanes append in lane order at the
    # carried write pointer; rows past F go to the sink but the pointer
    # keeps counting so overflow is never silent
    raw = flags.sum().to(torch.int32)
    idx = compact_lanes(flags)[0][:cap_g].long()
    ar = torch.arange(cap_g, dtype=torch.int32, device=dev)
    pos = fr_ptr + ar
    valid = (ar < raw.clamp(max=cap_g)) & (pos < F)
    tgt = torch.where(valid, pos, F).long()
    fr_pack.index_copy_(0, tgt, packed[idx])
    fr_gen.index_fill_(0, tgt, ((gen_id & M32) ^ (1 << 31)) - (1 << 31))
    fr_iter.index_copy_(0, tgt, its[idx])
    fr_len.index_copy_(0, tgt, lens[idx].to(torch.int32))
    fr_bufs.index_copy_(0, tgt, bufs[idx])
    fr[5] = fr_ptr + raw

    # per-slot stats for the GENERATING slot (before any admission
    # overwrites it)
    araw = aflags.sum().to(torch.int32)
    slot = sel.reshape(1).long()
    ring.hits.index_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))
    ring.finds.index_add_(0, slot, araw.reshape(1))

    if not reseed:
        zA = torch.zeros(A, dtype=torch.int32, device=dev)
        return ring, araw, (zA, zA, zA.to(torch.int64), zA,
                            torch.zeros((A, bufs.shape[1]),
                                        dtype=torch.uint8, device=dev))
    # FIFO admission of the first A edge-novel lanes into slots
    # 1..S-1; slots are distinct (A <= S-1)
    aidx = compact_lanes(aflags)[0][:A].long()
    arA = torch.arange(A, dtype=torch.int32, device=dev)
    n_adm = araw.clamp(max=A)
    avalid = arA < n_adm
    slots = 1 + (ring.ptr + arA) % (S - 1)
    tgt_s = torch.where(avalid, slots, S).long()
    adm_bufs = bufs[aidx]
    adm_lens = lens[aidx].to(torch.int32)
    ring.bufs.index_copy_(0, tgt_s, adm_bufs)
    ring.lens.index_copy_(0, tgt_s, adm_lens)
    ring.filled.index_fill_(0, tgt_s, 1)
    ring.hits.index_fill_(0, tgt_s, 0)
    ring.finds.index_fill_(0, tgt_s, 0)
    vi = avalid.to(torch.int32)
    ledger = (vi, slots * vi, its[aidx] * vi, adm_lens * vi, adm_bufs)
    return ring._replace(ptr=ring.ptr + n_adm), araw, ledger


def run_generations(instrs, edge_table, u_slots, seg_id, ring: RingState,
                    base_key, its0, n_real: int, gen0: int, salt: int,
                    vb, vc, vh, *, mem_size, max_steps, n_edges, exact,
                    stack_pow2=4, g=1, phase1_steps=0, reseed=True,
                    adm_cap=DEFAULT_ADM_CAP,
                    findings_cap=DEFAULT_FINDINGS_CAP, stateful=None,
                    vs=None, learn_params=None, grammar=None):
    """G generations, enqueued on the current stream with no host read.
    Returns ((vb, vc, vh, vs), ring', report fields) — the report
    fields in ``GenerationOutcome``'s order.

    ``its0`` int64[B] holds generation 0's absolute iteration numbers
    (uint32 values, padded to the batch shape with lane-0 repeats);
    generation j executes ``its0 + j*n_real`` mod 2**32 — bit-identical
    to j sequential host batches.  ``gen0`` and ``salt`` are host ints.
    On CUDA tensors each generation runs the fused kernel two-phase
    (``phase1_steps``) with its seed read from the ring; on the CPU its
    plain version, single phase.

    ``stateful`` (an ``(m_max, n_states, state_reg)`` tuple) runs the
    session tier: each generation's candidates come from ``havoc_at``
    in torch ops on the ring's selected slot (``havoc_from_ring``, the
    same lanes the fused kernel would draw) and run as framed sequences
    through the session executor (plain torch on the card too, as the
    JAX package runs them in XLA); the state x edge map ``vs`` is
    triaged alongside the classic maps and the lane verdict becomes
    ``max(classic, state)``.  Without it ``vs`` is returned untouched.

    ``grammar`` (a compiled ``GrammarTables`` and its device tensors,
    grammar/) runs the grammar tier: each generation's candidates come
    from ``grammar_havoc_at`` on the ring's selected slot
    (``grammar_from_ring``) and run through ``run_batch`` —
    ``kbz_vm_kernel`` over every lane on the card, its plain version on
    the CPU — as the JAX package's xla branch does; with stateful, the
    session executor runs them instead.  Degenerate tables give
    exactly the havoc lanes.

    ``learn_params`` (the byte-saliency model's weights, learn/) runs
    the learn tier: each generation infers the selected slot's mask
    (``_cached_slot_mask``; admissions invalidate their slots) and draws
    its candidates with the masked havoc (``havoc_from_ring(...,
    mask=)``), then runs them through ``run_batch`` as the grammar tier
    does.  A version-0 model's all-ones mask gives exactly the havoc
    lanes.  Grammar and learn are mutually exclusive."""
    from ..instrumentation.base import pack_verdicts
    from ..instrumentation.jit_harness import _judge

    if grammar is not None and learn_params is not None:
        raise ValueError(
            "grammar and learn are mutually exclusive — both tiers "
            "would own the generation loop's mutation (run the learned "
            "mask OR the structure tables, not both)")
    dev = its0.device
    b = its0.shape[0]
    L = ring.bufs.shape[1]
    F = int(findings_cap)
    A = int(adm_cap) if reseed else 1   # ledger shape floor
    if A > ring.slots - 1:
        # admissions must land in distinct slots: a duplicate scatter
        # index has no defined winner on the card
        raise ValueError(f"adm_cap {adm_cap} exceeds the ring's "
                         f"{ring.slots - 1} admission slots "
                         "(gen_ring_caps clamps it)")
    lanes_real = torch.arange(b, device=dev) < int(n_real)
    if dev.type != "cuda":
        phase1_steps = 0
    fr = [torch.zeros(F + 1, dtype=torch.uint8, device=dev),
          torch.zeros(F + 1, dtype=torch.int32, device=dev),
          torch.zeros(F + 1, dtype=torch.int64, device=dev),
          torch.zeros(F + 1, dtype=torch.int32, device=dev),
          torch.zeros((F + 1, L), dtype=torch.uint8, device=dev),
          torch.zeros((), dtype=torch.int32, device=dev)]
    sels, araws, ledgers = [], [], []
    slot0 = torch.zeros((), dtype=torch.int32, device=dev)
    unfused = grammar is not None or stateful is not None \
        or learn_params is not None
    if learn_params is not None:
        mask_cache, mask_valid = new_mask_cache(ring.slots, L, dev)
    for j in range(int(g)):
        gen_id = (int(gen0) + j) & M32
        sel = _select_slot(ring.filled[:ring.slots], gen_id, salt) \
            if reseed else slot0
        its = (its0 + j * int(n_real)) & M32
        if unfused:
            if grammar is not None:
                bufs, lens = grammar_from_ring(ring.bufs, ring.lens, sel,
                                               base_key, its, *grammar,
                                               stack_pow2)
            elif learn_params is not None:
                mask = _cached_slot_mask(learn_params, ring.bufs,
                                         ring.lens, sel, mask_cache,
                                         mask_valid)
                bufs, lens = havoc_from_ring(ring.bufs, ring.lens, sel,
                                             base_key, its, stack_pow2,
                                             mask=mask)
            else:
                bufs, lens = havoc_from_ring(ring.bufs, ring.lens, sel,
                                             base_key, its, stack_pow2)
            if stateful is not None:
                res = _run_session_impl(instrs, edge_table, bufs, lens,
                                        mem_size, max_steps, n_edges,
                                        *stateful)
            else:
                res = run_batch(instrs, edge_table, bufs, lens, mem_size,
                                max_steps, n_edges)
        else:
            res, bufs, lens = fuzz_batch_2phase(
                instrs, edge_table, ring.bufs, ring.lens, sel, base_key,
                its, mem_size, max_steps, n_edges, stack_pow2=stack_pow2,
                phase1_steps=phase1_steps)
        statuses, new_paths, uc, uh, _exit, vb, vc, vh, _counts = _judge(
            res, u_slots, seg_id, vb, vc, vh, exact)
        if stateful is not None:
            s_rets, vs = (state_triage_exact if exact
                          else state_triage)(vs, res.se_counts)
            new_paths = torch.maximum(new_paths, s_rets)
        packed = pack_verdicts(statuses, new_paths, uc, uh)
        flags = ((statuses != FUZZ_NONE) | (new_paths > 0)) & lanes_real
        aflags = (new_paths == 2) & lanes_real
        ring, araw, ledger = _ring_append_and_admit(
            flags, aflags, packed, its, bufs, lens, gen_id, sel, ring, fr,
            A, reseed)
        if learn_params is not None and reseed:
            _invalidate_admitted_masks(mask_valid, ledger, ring.slots)
        sels.append(sel)
        araws.append(araw)
        ledgers.append(ledger)
    adm = [torch.stack(col) for col in zip(*ledgers)]
    report = ([t[:F] for t in fr[:5]] + [fr[5], torch.stack(sels),
                                         torch.stack(araws)] + adm
              + [ring.filled[:ring.slots].clone()])
    return (vb, vc, vh, vs), ring, tuple(report)
