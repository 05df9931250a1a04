"""Static-edge triage — AFL-map novelty over a known edge universe.

The port of the JAX package's ``ops/static_triage.py``.  The KBVM
compiler enumerates every possible coverage edge of a program
(``Program.edge_slot``), so triage never touches the 64KB map shape:
the whole pipeline runs over ``[B, U]`` where U = number of distinct
AFL map slots the program can hit (a few hundred).

Semantics are the dense AFL contract (classify_counts buckets,
``has_new_bits`` ret codes, simplify_trace crash/hang maps including
the absent-edge "1" class) restricted to the static universe — exact
for KBVM targets: slots outside the universe are never hit, so their
dense contribution is the constant class-1 pattern, reproduced by
``_outside_mask`` on the first unique crash/hang.

``static_triage`` takes its plain PyTorch version,
``static_triage_plain``, for tensors on the CPU, and only then; for
CUDA tensors it launches ``csrc/triage.cu``'s three kernels
(``kbz_triage_lanes``, ``kbz_triage_resolve``, ``kbz_triage_maps``)
or raises.  ``LAUNCHES["kbz_triage"]`` (ops/vm_kernel.py) counts the
batches they triaged.
"""

from __future__ import annotations

import weakref
from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import MAP_SIZE
from .coverage import classify_counts
from .sparse_coverage import _first_occurrence_multi, stream_hash
from .vm_kernel import LAUNCHES, _check, _launch_check


def make_static_maps(edge_slot: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(u_slots int32[U] sorted unique AFL slots, seg_id int32[E]
    edge-index -> slot-group index). Host-side, once per program."""
    u_slots, seg_id = np.unique(np.asarray(edge_slot), return_inverse=True)
    return u_slots.astype(np.int32), seg_id.astype(np.int32)


def counts_by_slot(counts: torch.Tensor, seg_id: torch.Tensor,
                   n_slots: int) -> torch.Tensor:
    """Fold edge hit counts into AFL map cells: colliding edges (same
    ``cur ^ prev`` slot) share a cell, wrapping at u8 exactly like the
    dense ``trace_bits[slot]++`` (summed in int32, then & 0xFF).

    counts: uint8[B, E+1] (overflow column dropped) -> uint8[B, U].
    """
    c = counts[:, :-1].to(torch.int32)
    out = torch.zeros((c.shape[0], n_slots), dtype=torch.int32,
                      device=c.device)
    out.index_add_(1, seg_id.long(), c)
    return (out & 0xFF).to(torch.uint8)


def expand_to_map(by_slot: torch.Tensor, u_slots: torch.Tensor,
                  map_size: int = MAP_SIZE) -> torch.Tensor:
    """uint8[B, U] -> uint8[B, map_size] dense bitmaps (the parity /
    state-export shape; map_size = 64KB per module)."""
    out = torch.zeros((by_slot.shape[0], map_size), dtype=torch.uint8,
                      device=by_slot.device)
    out[:, u_slots.long()] = by_slot
    return out


def _outside_mask(u_slots: torch.Tensor, map_size: int) -> torch.Tensor:
    """uint8[map_size]: the constant simplify_trace contribution of
    slots outside the universe (class 1 everywhere, 0 at u_slots)."""
    m = torch.ones(map_size, dtype=torch.uint8, device=u_slots.device)
    # index_fill_ takes the 0 as a kernel argument; ``m[idx] = 0`` would
    # copy it from the host and wait for the device's queued work
    return m.index_fill_(0, u_slots.long(), 0)


def static_triage_plain(vb, vc, vh, counts, u_slots, seg_id, crash,
                        hang):
    """The plain PyTorch version of ``static_triage``: throughput triage
    over the static universe.

    Args: vb/vc/vh uint8[MAP_SIZE] virgin maps, counts uint8[B, E+1],
    u_slots int32[U], seg_id int32[E], crash/hang bool[B].
    Returns (rets int32[B], uc bool[B], uh bool[B], vb', vc', vh'):
    all lanes judged vs the incoming maps, in-batch dedup by map hash,
    virgin updates folded over the new lanes.  No host sync.
    """
    u = u_slots.shape[0]
    us = u_slots.long()
    by_slot = counts_by_slot(counts, seg_id, u)            # [B, U]
    cls = classify_counts(by_slot)
    simp = torch.where(by_slot != 0, 128, 1).to(torch.uint8)

    def novelty(virgin, classes):
        v = virgin[us][None, :]                             # [1, U]
        new_count = ((classes & v) != 0).any(dim=1)
        new_tuple = ((classes != 0) & (v == 0xFF)).any(dim=1)
        return torch.where(new_tuple, 2, torch.where(new_count, 1, 0))

    rets = novelty(vb, cls)
    crash_rets = novelty(vc, simp)
    hang_rets = novelty(vh, simp)

    # dedup on CLASSIFIED counts: lanes whose hit counts fall in the
    # same AFL buckets are the same path
    hashes = stream_hash(cls.to(torch.int64))
    first_all, first_crash, first_hang = _first_occurrence_multi(
        hashes, crash, hang)
    rets = torch.where(first_all, rets, 0).to(torch.int32)
    uc = first_crash & (crash_rets > 0)
    uh = first_hang & (hang_rets > 0)

    def upd(virgin, classes, active, with_outside):
        """Clear the OR of active lanes' class bits; crash/hang maps
        also clear the constant outside-universe class-1 pattern.
        A batch with no active lane leaves the map as it was."""
        seen = _or_rows(torch.where(active[:, None], classes, 0))
        v = virgin.clone()
        v[us] = virgin[us] & ~seen
        if with_outside:
            v = v & ~_outside_mask(u_slots, v.shape[0])
        return torch.where(active.any(), v, virgin)

    vb2 = upd(vb, cls, rets > 0, False)
    vc2 = upd(vc, simp, uc, True)
    vh2 = upd(vh, simp, uh, True)
    return rets, uc, uh, vb2, vc2, vh2


# --------------------------------------------------------------------
# the triage kernels (csrc/triage.cu)
# --------------------------------------------------------------------

def slot_table(u_slots: torch.Tensor, seg_id: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The program's slot -> edges table in CSR form, on the tensors'
    device (torch ops: nothing waits for the card): (slots int32[U, 4],
    edges int32[E]).  Slot s's edges are ``edges[slots[s, 0]:slots[s,
    1]]``, ``slots[s, 2]`` is its AFL map slot ``u_slots[s]``."""
    seg = seg_id.to(torch.int64)
    order = torch.argsort(seg, stable=True)
    bounds = torch.searchsorted(
        seg[order], torch.arange(u_slots.shape[0] + 1, device=seg.device))
    slots = torch.stack([bounds[:-1], bounds[1:], u_slots.to(torch.int64),
                         torch.zeros_like(bounds[1:])], dim=1)
    return slots.to(torch.int32).contiguous(), order.to(torch.int32)


# each program's slot table, built at its first triage on the card and
# kept while its seg_id tensor lives
_TABLES = WeakIdKeyDictionary()


def _program_table(u_slots, seg_id):
    entry = _TABLES.get(seg_id)
    if (entry is None or entry[0]() is not u_slots
            or entry[1] != (u_slots._version, seg_id._version)):
        entry = _TABLES[seg_id] = (
            weakref.ref(u_slots), (u_slots._version, seg_id._version),
            *slot_table(u_slots, seg_id))
    return entry[2], entry[3]


class _Scratch:
    """A device's first-of-hash table and per-batch scratch.  The table
    has a power of two of at least 2B entries: a key word (epoch << 32
    | hash) and three min words (~epoch << 32 | lane), so each batch,
    under a new epoch, reads an older batch's entries as empty."""

    def __init__(self, dev, b: int, u: int):
        self.cap = 64
        while self.cap < 2 * b:
            self.cap *= 2
        self.b, self.u, self.epoch = b, u, 0
        self.keys = torch.zeros(self.cap, dtype=torch.int64, device=dev)
        self.mins = torch.full((3, self.cap), -1, dtype=torch.int64,
                               device=dev)
        self.lane_slot = torch.empty(max(b, 1), dtype=torch.int32,
                                     device=dev)
        self.lane_nov = torch.empty(max(b, 1), dtype=torch.uint8,
                                    device=dev)
        self.acc = torch.empty(max(u, 1), dtype=torch.int32, device=dev)
        self.any = torch.empty(1, dtype=torch.int32, device=dev)

    def next_epoch(self) -> int:
        if self.epoch == 0xFFFFFFFE:        # ~epoch must stay above 0
            self.keys.zero_()
            self.mins.fill_(-1)
            self.epoch = 0
        self.epoch += 1
        return self.epoch


_SCRATCH: Dict[torch.device, _Scratch] = {}


def _scratch(dev, b: int, u: int) -> _Scratch:
    sc = _SCRATCH.get(dev)
    if sc is None or b > sc.b or u > sc.u:
        sc = _SCRATCH[dev] = _Scratch(dev, max(b, sc.b if sc else 0),
                                      max(u, sc.u if sc else 0))
    return sc


def static_triage(vb, vc, vh, counts, u_slots, seg_id, crash, hang):
    """Fused throughput triage over the static universe: the plain
    version for CPU tensors, the kernels of ``csrc/triage.cu`` for
    CUDA tensors (bit for bit the plain version's outputs, as fresh
    tensors; three launches, no host sync)."""
    dev = counts.device
    if dev.type == "cpu":
        return static_triage_plain(vb, vc, vh, counts, u_slots, seg_id,
                                   crash, hang)
    _check(dev.type == "cuda", f"static_triage: unsupported device {dev}")
    u, e = u_slots.shape[0], seg_id.shape[0]
    _check(counts.dtype == torch.uint8 and counts.dim() == 2 and
           counts.shape[1] == e + 1, "counts must be uint8[B, E + 1]")
    b = counts.shape[0]
    m = vb.shape[0]
    for v in (vb, vc, vh):
        # the kernels read and write the maps as 32-bit words
        _check(v.dtype == torch.uint8 and v.shape == (m,) and
               v.device == dev and v.is_contiguous() and
               v.data_ptr() % 4 == 0,
               "maps must be contiguous, 4-byte aligned uint8[MAP] on "
               "counts' device")
    _check(m % 4 == 0 and m < 2 ** 31, "map size must be a multiple of 4")
    for f in (crash, hang):
        _check(f.dtype == torch.bool and f.shape == (b,) and
               f.device == dev, "crash and hang must be bool[B]")
    u_slots = u_slots.to(device=dev, dtype=torch.int32).contiguous()
    seg_id = seg_id.to(device=dev)
    slots, edges = _program_table(u_slots, seg_id)
    sc = _scratch(dev, b, u)
    counts, crash, hang = (counts.contiguous(), crash.contiguous(),
                           hang.contiguous())
    rets = torch.empty(b, dtype=torch.int32, device=dev)
    uc = torch.empty(b, dtype=torch.bool, device=dev)
    uh = torch.empty(b, dtype=torch.bool, device=dev)
    ob, oc, oh = (torch.empty_like(v) for v in (vb, vc, vh))
    from ._build import load
    rc = load("triage").kbz_triage_launch(
        counts.data_ptr(), e + 1, b, slots.data_ptr(), edges.data_ptr(), u,
        e, u_slots.data_ptr(), vb.data_ptr(), vc.data_ptr(), vh.data_ptr(),
        m, crash.data_ptr(), hang.data_ptr(), sc.keys.data_ptr(),
        sc.mins.data_ptr(), sc.cap, sc.next_epoch(),
        sc.lane_slot.data_ptr(), sc.lane_nov.data_ptr(), sc.acc.data_ptr(),
        sc.any.data_ptr(), rets.data_ptr(), uc.data_ptr(), uh.data_ptr(),
        ob.data_ptr(), oc.data_ptr(), oh.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _launch_check(rc, "kbz_triage")
    LAUNCHES["kbz_triage"] += 1
    return rets, uc, uh, ob, oc, oh


def _or_rows(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over the rows of a uint8[B, U] tensor -> uint8[U]
    (torch has no OR reduction: the max of each bit plane, summed)."""
    out = torch.zeros(x.shape[1], dtype=torch.uint8, device=x.device)
    if x.shape[0] == 0:
        return out
    for k in range(8):
        out = out | (x & (1 << k)).amax(dim=0)
    return out
