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
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import MAP_SIZE
from .coverage import classify_counts
from .sparse_coverage import _first_occurrence_multi, stream_hash


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


def static_triage(vb, vc, vh, counts, u_slots, seg_id, crash, hang):
    """Fused throughput triage over the static universe.

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


def _or_rows(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over the rows of a uint8[B, U] tensor -> uint8[U]
    (torch has no OR reduction: the max of each bit plane, summed)."""
    out = torch.zeros(x.shape[1], dtype=torch.uint8, device=x.device)
    if x.shape[0] == 0:
        return out
    for k in range(8):
        out = out | (x & (1 << k)).amax(dim=0)
    return out
