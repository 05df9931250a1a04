"""The (dp, mp) mesh tier: sharded fuzz steps and mesh-resident
generations over an explicit grid of devices.

Port of the JAX package's ``parallel/distributed.py``.  The JAX tier is
one program under ``shard_map`` over a (dp, mp) device ``Mesh``.  Here
one controller process enqueues every shard's work in turn on the
shard's own device (``Mesh.devices[d][m]``), so the same code runs
dp x mp shards on as many cards, on one card (a device list that
repeats ``cuda:0``) or on the CPU (``["cpu"] * 8``, the counterpart of
the JAX tests' virtual 8-device CPU mesh).

Axes:
  * ``dp`` — data parallel over candidate lanes: shard d runs global
    lanes ``d*bpd .. (d+1)*bpd - 1`` with per-GLOBAL-lane PRNG keys, so
    the candidate stream is the same for every mesh shape.
  * ``mp`` — map parallel over the coverage bitmap: shard m owns a
    dense slice of the virgin maps and judges only its own u-slots.
    Under ``shard_map`` every mp shard of a dp row runs the same
    mutate+execute; here it runs once per dp row, on
    ``devices[d][0]``, and the counts go to the row's mp shards.

The JAX step's collectives are plain functions, kept together so that
a version with one process per card can swap in ``torch.distributed``:
  * ``_pmax_mp`` — a lane's verdict is the max over its row's mp shards;
  * ``_psum_mp`` — the dedup hash is the sum of the slice hashes mod
    2**32 (a ``psum`` of uint32);
  * ``_gather_and_fold`` — the virgin union across dp: a bitwise AND,
    handed back to every shard on its own device.

In-batch dedup is per dp shard: two shards that find the same path in
one step both report it, and the AND-fold makes the next step see it
(over-report, never under-report — the JAX package's documented
behaviour).  Nothing here reads a device value on the host: counters
are Python ints, keys and seeds reach the device through ``fill_``.
The TPU's lane-tile padding is not semantics and has no counterpart.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import FUZZ_CRASH, FUZZ_HANG, FUZZ_NONE, FUZZ_RUNNING, MAP_SIZE
from ..instrumentation.base import pack_verdicts
from ..models.vm import _run_batch_impl
from ..ops.coverage import classify_counts, simplify_trace
from ..grammar.device import grammar_from_ring
from ..ops.generations import (
    DEFAULT_ADM_CAP, DEFAULT_FINDINGS_CAP, _ring_append_and_admit,
    _select_slot, new_ring,
)
from ..ops.prng import threefry2x32
from ..ops.sparse_coverage import _first_occurrence_multi, stream_hash
from ..ops.static_triage import _or_rows, counts_by_slot, make_static_maps
from ..ops.vm_kernel import (
    compact_lanes, fuzz_batch, havoc_from_ring, run_batch, seed_ring,
)
from ..stateful.coverage import state_triage
from ..stateful.session import _run_session_impl
from ..utils.logging import WARNING_MSG

M32 = 0xFFFFFFFF
ENGINES = ("torch", "cuda", "cuda_fused")
MAPS = ("virgin_bits", "virgin_crash", "virgin_tmout")


def shard_stat_snapshots(mesh: "Mesh", execs_per_shard: int,
                         step: int) -> list:
    """Per-dp-shard telemetry snapshots for one sync epoch, shaped
    for ``telemetry.aggregate.merge``: each data-parallel shard
    contributes its executed-lane count as a counter (summed by the
    fold) and its step clock as a gauge (max'd — a straggling shard
    shows up as a step gap in the merged view).  Host-side by
    construction: every value is already known to the host."""
    return [{"counters": {"execs": execs_per_shard},
             "gauges": {"shard_step": step,
                        "lanes_per_shard": execs_per_shard}}
            for _ in range(mesh.shape["dp"])]


class Mesh:
    """A (dp, mp) grid of torch devices: ``devices[d][m]`` is shard
    (d, m)'s device, ``shape`` is ``{"dp": n_dp, "mp": n_mp}`` as in
    JAX's ``Mesh``.  A device may repeat."""

    def __init__(self, devices, n_dp: int, n_mp: int):
        self.devices = tuple(tuple(devices[d * n_mp:(d + 1) * n_mp])
                             for d in range(n_dp))
        self.shape = {"dp": n_dp, "mp": n_mp}

    def row(self, d: int) -> torch.device:
        """Where dp row d mutates and executes (its mp shard 0)."""
        return self.devices[d][0]


def make_mesh(n_dp: int, n_mp: int = 1, devices=None) -> Mesh:
    """A (dp, mp) mesh over ``devices`` (any torch device specs, which
    may repeat), or over the first dp x mp CUDA cards."""
    n = n_dp * n_mp
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        devices = [f"cuda:{i}" for i in range(min(have, n))]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh(devices, n_dp, n_mp)


class ShardedFuzzState(NamedTuple):
    """The mesh's fuzzing state: each virgin map as its mp slices, slice
    m on ``devices[0][m]`` (dp replicas are equal after every fold and
    are handed out per step).  ``virgin_state`` is the stateful tier's
    state x edge map as uint8[dp, M] on ``devices[0][0]``, one row per
    dp shard (rows equal after every dp fold; the map is tiny and
    whole on every shard, so dp rows are its shard unit, as in the JAX
    layout), or a uint8[dp, 1] dummy when the tier is off."""
    virgin_bits: tuple       # n_mp x uint8[map_size / n_mp]
    virgin_crash: tuple
    virgin_tmout: tuple
    step: int                # batches done
    virgin_state: torch.Tensor = None

    def full_map(self, name: str) -> torch.Tensor:
        """Map ``name`` whole, on its first slice's device."""
        parts = getattr(self, name)
        return torch.cat([p.to(parts[0].device) for p in parts])


def _split(mesh: Mesh, full: torch.Tensor) -> tuple:
    """A whole map as its mp slices on ``devices[0][m]``."""
    n_mp = mesh.shape["mp"]
    size = full.shape[0] // n_mp
    return tuple(full[m * size:(m + 1) * size].to(mesh.devices[0][m])
                 .clone() for m in range(n_mp))


def state_from_maps(mesh: Mesh, vb, vc, vh, step: int = 0, vs=None
                    ) -> ShardedFuzzState:
    """The mesh state holding these three whole maps (uint8 tensors)
    and, for the stateful tier, the whole state x edge map ``vs``
    (uint8[M], tiled over the dp rows; None: the 1-byte dummy)."""
    dev0 = mesh.devices[0][0]
    n_dp = mesh.shape["dp"]
    vs = (torch.full((n_dp, 1), 0xFF, dtype=torch.uint8, device=dev0)
          if vs is None else vs.to(dev0).reshape(1, -1).repeat(n_dp, 1))
    return ShardedFuzzState(*(_split(mesh, v) for v in (vb, vc, vh)),
                            step, vs)


def sharded_state_init(mesh: Mesh, map_size: int = MAP_SIZE,
                       state_map_size: int = 0) -> ShardedFuzzState:
    """Fresh maps; ``map_size`` must be the program's (64KB x modules),
    ``state_map_size`` the stateful tier's n_states x (E+1) bytes (0 =
    tier off, a 1-byte dummy rides along)."""
    dev0 = mesh.devices[0][0]
    full = torch.full((map_size,), 0xFF, dtype=torch.uint8, device=dev0)
    vs = (torch.full((int(state_map_size),), 0xFF, dtype=torch.uint8,
                     device=dev0) if state_map_size else None)
    return state_from_maps(mesh, full, full, full, vs=vs)


def _shard_static_maps(program, n_mp: int):
    """Host-side partition of the program's static slot universe over
    the mp axis.  The virgin maps are mp-sharded by dense slot ranges
    (state-export compatibility); each shard's per-step WORK runs over
    only its own u-slots:

    Returns (u_loc int32[n_mp, U_max]  shard-local virgin offsets
             (sentinel = slice_size for padding),
             eidx  int32[n_mp, E]      edge -> shard u-column
             (sentinel = U_max: edge belongs to another shard),
             outside uint8[n_mp, slice_size]  the constant
             simplify-trace class-1 pattern of slots outside the
             universe, per shard slice)."""
    u_slots, seg_id = make_static_maps(program.edge_slot)
    slice_size = program.map_size // n_mp
    shard_of_u = u_slots // slice_size
    counts = np.bincount(shard_of_u, minlength=n_mp)
    u_max = max(int(counts.max(initial=0)), 1)
    u_loc = np.full((n_mp, u_max), slice_size, dtype=np.int32)
    u_pos = np.zeros(len(u_slots), dtype=np.int32)
    for m in range(n_mp):
        idxs = np.where(shard_of_u == m)[0]
        u_loc[m, :len(idxs)] = u_slots[idxs] - m * slice_size
        u_pos[idxs] = np.arange(len(idxs))
    eidx = np.full((n_mp, len(seg_id)), u_max, dtype=np.int32)
    for e, g in enumerate(seg_id):
        eidx[shard_of_u[g], e] = u_pos[g]
    outside = np.ones((n_mp, slice_size), dtype=np.uint8)
    for m in range(n_mp):
        sel = u_loc[m][u_loc[m] < slice_size]
        outside[m, sel] = 0
    return u_loc, eidx, outside


# -- the collectives ------------------------------------------------------

def _gather_and_fold(parts):
    """Virgin union across dp: the AND of every shard's slice, handed
    back to each shard on its own device."""
    out = parts[0]
    for p in parts[1:]:
        out = out & p.to(out.device)
    return [out.to(p.device) for p in parts]


def _pmax_mp(parts):
    """Max over a dp row's mp shards, on the first shard's device."""
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p.to(out.device))
    return out


def _psum_mp(parts):
    """uint32 sum (int64 holding uint32) over a dp row's mp shards."""
    out = parts[0]
    for p in parts[1:]:
        out = (out + p.to(out.device)) & M32
    return out


def _counter_halves(base_it) -> Tuple[int, int]:
    """``base_it`` as its uint32 halves (lo, hi), host ints: all 64
    bits are folded, so campaigns past 2**32 execs never replay an
    earlier (counter, lane) key pair."""
    it = int(base_it)
    return it & M32, (it >> 32) & M32


def _advance(lo: int, hi: int, off: int) -> Tuple[int, int]:
    """Counter (lo, hi) plus a uint32 offset, the carry into hi."""
    lo2 = (lo + (off & M32)) & M32
    return lo2, (hi + (lo2 < lo)) & M32


def _fill(values, dtype, dev) -> torch.Tensor:
    """A small tensor of host values on ``dev`` made with ``fill_``
    (kernel arguments): a copy from the host would wait for the card."""
    t = torch.empty(len(values), dtype=dtype, device=dev)
    for i, v in enumerate(values):
        t[i:i + 1].fill_(v)
    return t


class _ShardKernels:
    """Per-shard building blocks shared by the per-batch fuzz step and
    the mesh-resident generation scan: global-lane PRNG keys, the
    engine-switched mutate+execute tier, and the mp-sharded coverage /
    novelty / virgin-clear triage (everything up to — but NOT
    including — the dp AND-fold, which each caller schedules on its own
    cadence).

    Engines (the JAX package's xla / pallas / pallas_fused): ``torch``
    the plain VM; ``cuda`` havoc in torch ops and ``kbz_vm_kernel`` over
    every lane; ``cuda_fused`` havoc and the VM in ``kbz_fuzz_kernel``.
    On CPU tensors the kernels' wrappers take their plain versions.

    ``stateful`` (an ``(m_max, n_states, state_reg)`` tuple) runs the
    session tier: candidates execute as framed sequences through the
    session executor (plain torch, engine ``torch``) and
    ``state_triage_row`` triages the state x edge map.

    ``grammar`` (a compiled ``GrammarTables``) runs the grammar tier:
    candidates come from ``grammar_havoc_at`` (engine ``torch`` or
    ``cuda``; the fused kernel cannot consume the tables), and the
    degenerate tables give exactly the havoc lanes."""

    def __init__(self, program, mesh: Mesh, batch_per_device: int,
                 max_len: int, stack_pow2: int = 4, engine: str = "torch",
                 seed: int = 0, stateful=None, grammar=None):
        n_mp = mesh.shape["mp"]
        if program.map_size % n_mp:
            raise ValueError("mp must divide the program's map size")
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        self.stateful = (tuple(int(v) for v in stateful)
                         if stateful is not None else None)
        if self.stateful is not None and engine != "torch":
            raise ValueError(
                "stateful mesh campaigns need the torch engine (the "
                "session executor is the plain engine path)")
        if grammar is not None and engine == "cuda_fused":
            raise ValueError(
                "grammar-structured mutation needs the torch or cuda "
                "engine (the fused kernel generates candidates in-kernel "
                "and cannot consume the structure tables)")
        self.grammar = grammar
        self.program = program
        self.mesh = mesh
        self.batch_per_device = int(batch_per_device)
        self.max_len = int(max_len)
        self.stack_pow2 = int(stack_pow2)
        self.engine = engine
        self.seed = int(seed)
        self.slice_size = program.map_size // n_mp
        self._u_loc, self._eidx, self._outside = _shard_static_maps(
            program, n_mp)
        self.u_max = self._u_loc.shape[1]
        self._consts = {}

    def _const(self, key, make):
        """Per-device constants, made once (never copied per step)."""
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = make()
        return t

    def tables(self, dev):
        p = self.program
        return self._const(("tables", dev), lambda: (
            torch.as_tensor(p.instrs, device=dev),
            torch.as_tensor(p.edge_table, device=dev)))

    def lanes(self, d: int) -> torch.Tensor:
        """Dp row d's global lane ids, int64[bpd] on its device."""
        b = self.batch_per_device
        return self._const(("lanes", d), lambda: torch.arange(
            d * b, (d + 1) * b, dtype=torch.int64,
            device=self.mesh.row(d)))

    def slice_consts(self, d: int, m: int):
        """Shard (d, m)'s (u_loc, clipped u_loc, u_loc valid, eidx,
        outside) on its device."""
        dev = self.mesh.devices[d][m]

        def make():
            u_loc = torch.as_tensor(self._u_loc[m], device=dev).long()
            return (u_loc, u_loc.clamp(max=self.slice_size - 1),
                    u_loc < self.slice_size,
                    torch.as_tensor(self._eidx[m], device=dev),
                    torch.as_tensor(self._outside[m], device=dev))
        return self._const(("slice", dev, m), make)

    # -- PRNG: per-GLOBAL-lane keys (mesh-shape independent) ----------

    def base_key(self, lo: int, hi: int, dev) -> torch.Tensor:
        """``fold_in(fold_in(key(seed), lo), hi)`` (host ints through
        the same threefry), int64[2] on ``dev``: lane i's key is then
        ``fold_in(base_key, global_lane_i)``, the fused kernel's
        ``fold_in(base_key, its[i])`` contract."""
        k = (0, self.seed & M32)
        for half in (lo, hi):
            k = threefry2x32(k[0], k[1], 0, half & M32)
        return _fill(k, torch.int64, dev)

    # -- mutate + execute (engine switch) -----------------------------

    def mutate_exec(self, d: int, ring, ring_lens, sel, key):
        """Havoc-mutate dp row d's lanes from ring row ``sel`` and run
        them; returns (VMResult, bufs uint8[bpd, L], lens int32[bpd])
        on the row's device."""
        p = self.program
        dev = self.mesh.row(d)
        instrs, table = self.tables(dev)
        its = self.lanes(d)
        if self.grammar is not None:
            gt = self._const(("grammar", dev),
                             lambda: self.grammar.device(dev))
            bufs, lens = grammar_from_ring(ring, ring_lens, sel, key, its,
                                           self.grammar, gt,
                                           self.stack_pow2)
        elif self.stateful is None and self.engine == "cuda_fused":
            return fuzz_batch(instrs, table, ring, ring_lens, sel, key, its,
                              p.mem_size, p.max_steps, p.n_edges,
                              self.stack_pow2)
        else:
            bufs, lens = havoc_from_ring(ring, ring_lens, sel, key, its,
                                         self.stack_pow2)
        if self.stateful is not None:
            # session tier: the mutants are framed sequences and the
            # result carries se_counts beside the classic fields
            return (_run_session_impl(instrs, table, bufs, lens,
                                      p.mem_size, p.max_steps, p.n_edges,
                                      *self.stateful), bufs, lens)
        run = run_batch if self.engine == "cuda" else _run_batch_impl
        return (run(instrs, table, bufs, lens, p.mem_size, p.max_steps,
                    p.n_edges), bufs, lens)

    # -- mp-sharded triage (everything up to the dp fold) -------------

    def triage_row(self, d: int, vbs, vcs, vhs, counts, statuses):
        """Coverage over each mp shard's u-slots, novelty against its
        virgin slices (max over mp), the row's in-batch dedup by the
        full-map hash (summed over mp), and each shard's virgin clears.
        ``vbs``/``vcs``/``vhs`` are the row's slices (shard m's on
        ``devices[d][m]``); ``counts``, ``statuses`` on the row's
        device.  Returns (rets int32, uc, uh, vbs', vcs', vhs')."""
        parts = []
        for m in range(len(vbs)):
            dev = self.mesh.devices[d][m]
            u_loc, u_clip, u_ok, eidx, _ = self.slice_consts(d, m)
            by = counts_by_slot(counts.to(dev), eidx,
                                self.u_max + 1)[:, :self.u_max]
            cls = classify_counts(by)
            simp = simplify_trace(by)

            def novelty(virgin, classes):
                # padded columns read 0: never novel
                vloc = torch.where(u_ok, virgin[u_clip], 0)[None, :]
                new_count = ((classes & vloc) != 0).any(dim=1)
                new_tuple = ((classes != 0) & (vloc == 0xFF)).any(dim=1)
                return torch.where(new_tuple, 2,
                                   torch.where(new_count, 1, 0))

            parts.append((cls, simp, novelty(vbs[m], cls),
                          novelty(vcs[m], simp), novelty(vhs[m], simp),
                          stream_hash(cls.to(torch.int64))))
        rets = _pmax_mp([p[2] for p in parts])
        crash_rets = _pmax_mp([p[3] for p in parts])
        hang_rets = _pmax_mp([p[4] for p in parts])
        full_hash = _psum_mp([p[5] for p in parts])
        crash = statuses == FUZZ_CRASH
        hang = statuses == FUZZ_HANG
        first, first_crash, first_hang = _first_occurrence_multi(
            full_hash, crash, hang)
        rets = torch.where(first, rets, 0).to(torch.int32)
        uc = first_crash & (crash_rets > 0)
        uh = first_hang & (hang_rets > 0)

        # each shard clears its slice with the new lanes' bits; the
        # crash/hang maps also clear the constant outside-universe
        # class-1 pattern when the row has a crash (hang)
        out = ([], [], [])
        for m, (cls, simp, *_rest) in enumerate(parts):
            dev = self.mesh.devices[d][m]
            u_loc, u_clip, _, _, outside = self.slice_consts(d, m)
            for acc, virgin, traces, active, outer in (
                    (out[0], vbs[m], cls, rets > 0, False),
                    (out[1], vcs[m], simp, crash, True),
                    (out[2], vhs[m], simp, hang, True)):
                active = active.to(dev)
                seen = _or_rows(torch.where(active[:, None], traces, 0))
                cur = virgin[u_clip] & ~seen
                v = virgin & ~torch.where(active.any(), outside, 0) \
                    if outer else virgin
                # slots past the slice (padding) go to a sink byte
                v = torch.cat([v, v.new_zeros(1)])
                v.index_copy_(0, u_loc, cur)
                acc.append(v[:-1])
        return (rets, uc, uh) + out

    def state_triage_row(self, vs, se_counts):
        """State x edge novelty of one dp row's lanes against its copy
        of the (whole) state map — throughput mode with the row's own
        in-batch dedup, as the JAX mesh does.  The caller schedules the
        dp AND-fold on the classic maps' cadence."""
        return state_triage(vs, se_counts)


def _row_maps(mesh: Mesh, state: ShardedFuzzState):
    """maps[k][d][m]: map k's slice m on shard (d, m)'s device."""
    return [[[getattr(state, name)[m].to(mesh.devices[d][m])
              for m in range(mesh.shape["mp"])]
             for d in range(mesh.shape["dp"])] for name in MAPS]


def _row_states(mesh: Mesh, state: ShardedFuzzState, stateful):
    """vss[d]: dp row d's state x edge map on its device (None when the
    stateful tier is off)."""
    if stateful is None:
        return None
    return [state.virgin_state[d].to(mesh.row(d))
            for d in range(mesh.shape["dp"])]


def _fold_maps(mesh: Mesh, maps, vss=None) -> None:
    """The dp AND-fold of every map slice (and of the state x edge
    maps, when given), in place."""
    for k in range(3):
        for m in range(mesh.shape["mp"]):
            folded = _gather_and_fold([maps[k][d][m]
                                       for d in range(mesh.shape["dp"])])
            for d, v in enumerate(folded):
                maps[k][d][m] = v
    if vss is not None:
        vss[:] = _gather_and_fold(vss)


def _state_after(state: ShardedFuzzState, maps, steps: int, vss=None
                 ) -> ShardedFuzzState:
    """The state holding the folded maps (row 0's replicas)."""
    vs = state.virgin_state if vss is None else \
        _stack(vss, state.virgin_state.device)
    return state._replace(virgin_bits=tuple(maps[0][0]),
                          virgin_crash=tuple(maps[1][0]),
                          virgin_tmout=tuple(maps[2][0]),
                          step=state.step + steps, virgin_state=vs)


def _check_state(state: ShardedFuzzState, program, stateful=None) -> None:
    size = sum(int(p.shape[0]) for p in state.virgin_bits)
    if size != program.map_size:
        raise ValueError(
            f"state map is {size} bytes but {program.name!r} needs "
            f"{program.map_size} — pass sharded_state_init(mesh, "
            f"program.map_size)")
    if stateful is not None:
        want = stateful[1] * (program.n_edges + 1)
        if state.virgin_state.shape[-1] != want:
            raise ValueError(
                f"state x edge map is {state.virgin_state.shape[-1]} "
                f"bytes but the session spec needs {want} — pass "
                f"sharded_state_init(mesh, program.map_size, "
                f"state_map_size)")


def _stack(parts, dev) -> torch.Tensor:
    return torch.stack([p.to(dev) for p in parts])


def _cat(parts, dev) -> torch.Tensor:
    return torch.cat([p.to(dev) for p in parts])


def make_sharded_fuzz_step(program, mesh: Mesh, batch_per_device: int,
                           max_len: int, stack_pow2: int = 4,
                           engine: str = "torch", seed: int = 0,
                           compact_cap: int = 1024, stateful=None):
    """Build the mesh fuzz step.

    Returns ``step(state, seed_buf, seed_len, base_it) -> (state',
    statuses[B], new_paths[B], uc[B], uh[B], exit_codes[B],
    candidates[B, L], lengths[B], compact)`` with B = batch_per_device
    x dp, the batch tensors on ``devices[0][0]`` in global lane order,
    and ``compact`` = (idx, bufs, lens, counts): each dp shard's
    interesting lanes in a block of ``compact_cap`` rows (filled with
    lane 0 past the count), global lane ids, and the per-shard counts.
    ``seed_buf`` is a uint8 tensor (up to ``max_len`` bytes, padded),
    ``seed_len`` an int.  ``base_it`` is the counter the per-lane keys
    fold in (the absolute mutator iteration, a Python int; all 64 bits
    fold as two uint32 halves).

    ``step.multi(state, seed_buf, seed_len, base_it, k)`` runs k steps,
    step j at counter ``base_it + j*B``, and returns (state', packed
    uint8[k, B], bufs[k, B, L], lens[k, B], stacked compact)."""
    n_dp = mesh.shape["dp"]
    # a shard can never report more interesting lanes than it runs
    compact_cap = min(int(compact_cap), int(batch_per_device))
    kern = _ShardKernels(program, mesh, batch_per_device, max_len,
                         stack_pow2=stack_pow2, engine=engine, seed=seed,
                         stateful=stateful)
    bpd = kern.batch_per_device
    dev0 = mesh.devices[0][0]

    def seeds(seed_buf, seed_len):
        """The seed as each dp row's one-slot ring, padded to max_len."""
        L = int(seed_buf.shape[-1])
        if L > max_len:
            raise ValueError(f"seed buffer ({L}) exceeds max_len "
                             f"({max_len})")
        if L < max_len:
            seed_buf = torch.cat([seed_buf,
                                  seed_buf.new_zeros(max_len - L)])
        out = {}
        for d in range(n_dp):
            dev = mesh.row(d)
            if dev not in out:
                out[dev] = seed_ring(seed_buf.to(dev), seed_len)
        return [out[mesh.row(d)] for d in range(n_dp)]

    def local_step(maps, vss, rings, lo, hi):
        """One step of every shard: rows mutate, execute and triage,
        then the dp AND-fold.  Returns the per-row outputs."""
        rows = []
        for d in range(n_dp):
            key = kern.base_key(lo, hi, mesh.row(d))
            res, bufs, lens = kern.mutate_exec(d, *rings[d], key)
            statuses = torch.where(res.status == FUZZ_RUNNING, FUZZ_HANG,
                                   res.status).to(torch.int32)
            rets, uc, uh, *new = kern.triage_row(
                d, *(maps[k][d] for k in range(3)), res.counts, statuses)
            for k in range(3):
                maps[k][d] = new[k]
            if vss is not None:
                # state x edge novelty joins the verdict (max, like the
                # single-device session step)
                s_rets, vss[d] = kern.state_triage_row(vss[d],
                                                       res.se_counts)
                rets = torch.maximum(rets, s_rets)
            # in-step compaction: the interesting lanes' bytes, so
            # campaign triage never pulls the full [B, L] tensor
            flags = (statuses != FUZZ_NONE) | (rets > 0)
            sel, count = compact_lanes(flags)
            sel = sel[:compact_cap]
            rows.append((statuses, rets, uc, uh, res.exit_code, bufs, lens,
                         sel + d * bpd, bufs[sel.long()], lens[sel.long()],
                         count.reshape(1)))
        _fold_maps(mesh, maps, vss)
        return [_cat(col, dev0) for col in zip(*rows)]

    def step(state: ShardedFuzzState, seed_buf, seed_len, base_it):
        _check_state(state, program, kern.stateful)
        maps = _row_maps(mesh, state)
        vss = _row_states(mesh, state, kern.stateful)
        lo, hi = _counter_halves(base_it)
        (statuses, rets, uc, uh, exit_codes, bufs, lens, sel_idx, sel_bufs,
         sel_lens, counts) = local_step(maps, vss,
                                        seeds(seed_buf, seed_len), lo, hi)
        return (_state_after(state, maps, 1, vss), statuses, rets, uc, uh,
                exit_codes, bufs, lens, (sel_idx, sel_bufs, sel_lens,
                                         counts))

    def step_multi(state: ShardedFuzzState, seed_buf, seed_len, base_it,
                   k: int):
        _check_state(state, program, kern.stateful)
        maps = _row_maps(mesh, state)
        vss = _row_states(mesh, state, kern.stateful)
        rings = seeds(seed_buf, seed_len)
        lo0, hi0 = _counter_halves(base_it)
        outs = []
        for j in range(int(k)):
            lo, hi = _advance(lo0, hi0, j * n_dp * bpd)
            (statuses, rets, uc, uh, _ec, bufs, lens, *compact) = \
                local_step(maps, vss, rings, lo, hi)
            outs.append([pack_verdicts(statuses, rets, uc, uh), bufs, lens]
                        + compact)
        packed, bufs, lens, *compact = (torch.stack(c) for c in zip(*outs))
        return (_state_after(state, maps, int(k), vss), packed, bufs, lens,
                tuple(compact))

    step.multi = step_multi
    return step


# -- mesh-resident generations (ops/generations.py per dp shard) ----------


_RING_FIELDS = ("bufs", "lens", "filled", "hits", "finds", "ptr")


class ShardedGenRing(NamedTuple):
    """Per-dp-shard seed-slot rings for the mesh generation scan:
    ``rings[d]`` is shard d's ``ops.generations.RingState`` on its row's
    device.  ``field(name)`` gives the JAX package's stacked field
    (leading ``dp`` axis, on shard 0's device, a copy)."""
    rings: tuple

    def field(self, name: str) -> torch.Tensor:
        i = _RING_FIELDS.index(name)
        rows = [r.view()[i] for r in self.rings]
        return _stack(rows, rows[0].device)

    @property
    def filled(self) -> torch.Tensor:
        return self.field("filled")


def sharded_gen_ring_init(mesh: Mesh, seed_buf, seed_len: int,
                          slots: int, max_len: int) -> ShardedGenRing:
    """Fresh per-shard rings: slot 0 of EVERY dp shard pins the base
    seed; the rest stay empty until edge-novel lanes admit."""
    slots = max(int(slots), 2)
    seed = torch.as_tensor(seed_buf, dtype=torch.uint8).reshape(-1)
    seed = seed[:max_len]
    if seed.shape[0] < max_len:
        seed = torch.cat([seed, seed.new_zeros(max_len - seed.shape[0])])
    return ShardedGenRing(tuple(
        new_ring(seed.to(mesh.row(d)), int(seed_len), slots)
        for d in range(mesh.shape["dp"])))


def make_sharded_generations(program, mesh: Mesh, batch_per_device: int,
                             max_len: int, stack_pow2: int = 4,
                             engine: str = "torch", seed: int = 0,
                             salt: int = 0, adm_cap: int = DEFAULT_ADM_CAP,
                             findings_cap: int = DEFAULT_FINDINGS_CAP,
                             stateful=None, learn: bool = False,
                             grammar=None):
    """Build the mesh-resident generation dispatch: the single-chip
    generation loop (ops/generations.py) run per dp shard.

    Each dp shard carries its OWN state through the dispatch — virgin
    map slices (mp-sharded like the per-batch step), a seed-slot ring
    and a bounded findings ring — and every ``fold_every`` generations
    the virgin maps are AND-folded across dp (``_gather_and_fold``), so
    shards stop re-finding each other's paths without a host round
    trip.  A dispatch always ends on a fold, so the returned state is
    dp-replicated like the per-batch step's.

    Candidate parity: lane keys are the host-driven mesh step's, and
    generation j consumes counter ``base_it + j*(dp*bpd)``; with
    reseeding off and ``fold_every=1`` the scan is bit-identical to the
    host-driven mesh loop.  With ``fold_every > 1`` shards may re-find
    each other's paths between folds: over-report, never under-report,
    and the folded maps end identical.  Shard d's slot pick is salted
    with ``salt ^ d``; each pick lands in the ledger.

    ``grammar`` (a compiled ``GrammarTables``) draws every shard's
    candidates with ``grammar_havoc_at`` from its selected ring slot
    (engine ``torch`` or ``cuda``: the candidates then run through
    ``kbz_vm_kernel`` on the card), as the JAX mesh's xla engine does.

    Returns ``dispatch(state, ring, base_it, gen0, g, reseed,
    fold_every) -> (state', ring', rep)`` where ``rep`` is the 13 ring
    and ledger fields of ``MeshGenerationOutcome`` (leading dp axis, on
    ``devices[0][0]``).  Rings update in place; ``ring.filled`` is read
    as a copy.  Nothing in a dispatch waits for the card."""
    if learn and engine != "torch":
        raise ValueError("learned mutation shaping needs the torch engine "
                         "(the fused kernel generates candidates "
                         "in-kernel)")
    if learn:
        raise ValueError("mesh generations with the learn tier: the learn "
                         "tier is not ported yet")
    n_dp = mesh.shape["dp"]
    b = int(batch_per_device)
    kern = _ShardKernels(program, mesh, b, max_len, stack_pow2=stack_pow2,
                         engine=engine, seed=seed, stateful=stateful,
                         grammar=grammar)
    F = int(findings_cap)
    A = max(int(adm_cap), 1)
    salt = int(salt) & M32
    dev0 = mesh.devices[0][0]
    fold_warned: set = set()

    def dispatch(state: ShardedFuzzState, ring: ShardedGenRing, base_it,
                 gen0: int, g: int, reseed: bool = True,
                 fold_every: int = 0):
        """Run ``g`` mesh generations in one dispatch.  ``fold_every``
        <= 0 means auto: once per dispatch with reseeding on, every
        generation with it off (the host-mesh-loop parity cadence).  A
        value that does not divide ``g`` is decremented to a divisor
        (warned once per (E, g) pair)."""
        _check_state(state, program, kern.stateful)
        g = int(g)
        asked = int(fold_every)
        fold = asked if asked > 0 else (g if reseed else 1)
        fold = max(1, min(fold, g))
        while g % fold:
            fold -= 1
        if fold != asked and asked > 0 and (asked, g) not in fold_warned:
            fold_warned.add((asked, g))
            WARNING_MSG(
                "gen_fold_every %d does not divide this dispatch's %d "
                "generations: folding every %d instead (a dispatch must "
                "end on a fold so the virgin maps return dp-replicated)",
                asked, g, fold)
        A_eff = A if reseed else 1
        maps = _row_maps(mesh, state)
        vss = _row_states(mesh, state, kern.stateful)
        rings = list(ring.rings)
        if A_eff > rings[0].slots - 1:
            # admissions must land in distinct slots: a duplicate
            # scatter index has no defined winner on the card
            raise ValueError(f"adm_cap {A} exceeds the ring's "
                             f"{rings[0].slots - 1} admission slots "
                             "(gen_ring_caps clamps it)")
        lo0, hi0 = _counter_halves(base_it)
        frs, ledgers = [], [[] for _ in range(n_dp)]
        for d in range(n_dp):
            dev = mesh.row(d)
            L = rings[d].bufs.shape[1]
            frs.append([torch.zeros(F + 1, dtype=dt, device=dev)
                        for dt in (torch.uint8, torch.int32, torch.int64,
                                   torch.int32)]
                       + [torch.zeros((F + 1, L), dtype=torch.uint8,
                                      device=dev),
                          torch.zeros((), dtype=torch.int32, device=dev)])
        for j in range(g):
            gen_id = (int(gen0) + j) & M32
            lo, hi = _advance(lo0, hi0, j * n_dp * b)
            for d in range(n_dp):
                dev = mesh.row(d)
                r = rings[d]
                sel = (_select_slot(r.filled[:r.slots], gen_id, salt ^ d)
                       if reseed else
                       torch.zeros((), dtype=torch.int32, device=dev))
                res, bufs, lens = kern.mutate_exec(
                    d, r.bufs, r.lens, sel, kern.base_key(lo, hi, dev))
                statuses = torch.where(res.status == FUZZ_RUNNING,
                                       FUZZ_HANG, res.status
                                       ).to(torch.int32)
                rets, uc, uh, *new = kern.triage_row(
                    d, *(maps[k][d] for k in range(3)), res.counts,
                    statuses)
                for k in range(3):
                    maps[k][d] = new[k]
                if vss is not None:
                    s_rets, vss[d] = kern.state_triage_row(vss[d],
                                                           res.se_counts)
                    rets = torch.maximum(rets, s_rets)
                packed = pack_verdicts(statuses, rets, uc, uh)
                its = (kern.lanes(d) + lo) & M32
                rings[d], araw, ledger = _ring_append_and_admit(
                    (statuses != FUZZ_NONE) | (rets > 0), rets == 2,
                    packed, its, bufs, lens, gen_id, sel, r, frs[d], A_eff,
                    reseed)
                ledgers[d].append((sel, araw) + tuple(ledger))
            if (j + 1) % fold == 0:
                _fold_maps(mesh, maps, vss)
        per_shard = []
        for d in range(n_dp):
            cols = [torch.stack(c) for c in zip(*ledgers[d])]
            per_shard.append([t[:F] for t in frs[d][:5]] + [frs[d][5]]
                             + cols)
        rep = tuple(_stack(col, dev0) for col in zip(*per_shard))
        return (_state_after(state, maps, g, vss),
                ShardedGenRing(tuple(rings)), rep)

    return dispatch
