"""Sparse coverage triage in PyTorch — novelty straight from edge
streams: the port of the JAX package's ``ops/sparse_coverage.py``.
Static-edge triage takes its in-batch dedup hash and the shared
first-occurrence pass from here."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import MAP_SIZE
from .coverage import classify_counts

M32 = 0xFFFFFFFF


def stream_hash(words: torch.Tensor) -> torch.Tensor:
    """Order-aware mixing hash of uint32[B, T] streams (int64 tensor
    holding uint32): each (word, position) pair goes through the
    murmur3 finalizer and the results are XOR-reduced per row.  torch
    has no XOR reduction, so the row folds in halves (log2 T steps).
    Returns int64[B] holding uint32."""
    t = words.shape[-1]
    pos = torch.arange(t, dtype=torch.int64, device=words.device)
    x = (words & M32) ^ ((pos * 0x9E3779B9) & M32)[None, :]
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & M32
    x = x ^ (x >> 16)
    if t == 0:
        return torch.zeros(words.shape[0], dtype=torch.int64,
                           device=words.device)
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        h = x.shape[1] // 2
        x = x[:, :h] ^ x[:, h:]
    return x[:, 0]


def _first_occurrence_multi(hashes: torch.Tensor, crash: torch.Tensor,
                            hang: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(first_all, first_crash, first_hang) bool[B]: whether each lane
    is the lowest-index lane with its hash overall / among crash lanes
    / among hang lanes — one stable sort shared by all three."""
    b = hashes.shape[0]
    order = torch.argsort(hashes, stable=True)
    sh = hashes[order]
    head = torch.ones(b, dtype=torch.bool, device=hashes.device)
    head[1:] = sh[1:] != sh[:-1]
    run = torch.cumsum(head.to(torch.int64), 0) - 1

    def firsts(pred):
        ps = pred[order]
        vals = torch.where(ps, order, b)
        m = torch.full((b,), b, dtype=torch.int64, device=hashes.device)
        m = m.scatter_reduce(0, run, vals, reduce="amin")
        hit_sorted = ps & (order == m[run])
        out = torch.zeros(b, dtype=torch.bool, device=hashes.device)
        out[order] = hit_sorted
        return out

    return (firsts(torch.ones(b, dtype=torch.bool, device=hashes.device)),
            firsts(crash), firsts(hang))


# --------------------------------------------------------------------
# sparse triage straight from edge streams
# --------------------------------------------------------------------
#
# A KBVM exec touches at most ``max_steps`` edges, so triage over the
# [B, T] edge stream needs no uint8[B, MAP_SIZE] bitmap: sort each
# lane's ids, run-length-encode them into (id, AFL class) pairs, test
# novelty with T gathers per lane, dedup in-batch by a hash of the
# sorted stream, and clear the virgin bits of new lanes through a
# per-bit scatter-max.  The same AFL contract as the dense ops in
# ``ops/coverage.py``.


def first_occurrence(hashes: torch.Tensor, active: torch.Tensor
                     ) -> torch.Tensor:
    """bool[B]: the lane is the lowest-index ACTIVE lane with its
    hash.  The reference's lexsort by (hash, inactive, index) is three
    stable sorts, least significant key first."""
    b = hashes.shape[0]
    order = torch.arange(b, device=hashes.device)
    for key in ((~active).to(torch.uint8), hashes):
        order = order[torch.sort(key[order], stable=True).indices]
    sk = hashes[order]
    head = torch.ones(b, dtype=torch.bool, device=hashes.device)
    head[1:] = sk[1:] != sk[:-1]
    out = torch.zeros(b, dtype=torch.bool, device=hashes.device)
    out[order] = head
    return out & active


def sparse_classify(edge_ids: torch.Tensor, valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-lane sorted unique edges and their AFL count classes.

    Args: edge_ids int[B, T], valid bool[B, T].  Returns (ids
    int32[B, T], cls uint8[B, T]): ids sorted, duplicates collapsed to
    the run head, non-heads and invalid entries id == MAP_SIZE with
    cls 0; counts wrap at 256 like the dense path's u8 increments."""
    ids = torch.where(valid, edge_ids.to(torch.int64), MAP_SIZE)
    ids = torch.sort(ids, dim=1).values
    b, t = ids.shape
    is_head = torch.ones_like(ids, dtype=torch.bool)
    is_head[:, 1:] = ids[:, 1:] != ids[:, :-1]
    is_head = is_head & (ids < MAP_SIZE)
    pos = torch.arange(t, device=ids.device)[None, :]
    head_pos = torch.cummax(torch.where(is_head, pos, -1), dim=1).values
    head_pos = torch.where(head_pos < 0, t, head_pos)   # dead -> sink
    counts = torch.zeros((b, t + 1), dtype=torch.int64, device=ids.device)
    counts.scatter_add_(1, head_pos, (ids < MAP_SIZE).to(torch.int64))
    counts = counts[:, :t] % 256
    cls = torch.where(is_head, classify_counts(counts.to(torch.uint8)), 0)
    out_ids = torch.where(is_head, ids, MAP_SIZE)
    return out_ids.to(torch.int32), cls.to(torch.uint8)


def _novelty_rets(virgin, ids, cls):
    live = ids < MAP_SIZE
    v = virgin[ids.long().clamp(0, MAP_SIZE - 1)]
    v = torch.where(live, v, 0).to(torch.uint8)
    new_count = ((cls & v) != 0).any(dim=1)
    new_tuple = ((cls != 0) & (v == 0xFF)).any(dim=1)
    return torch.where(new_tuple, 2, torch.where(new_count, 1, 0))


def _scatter_index(ids: torch.Tensor) -> torch.Tensor:
    """The row an entry of ``ids`` scatters to in a [MAP_SIZE + 1]
    table whose last row is a sink: the reference's ``.at[].max(...,
    mode="drop")`` takes a negative index from the end once and drops
    what is still out of range, so those go to the sink."""
    n = MAP_SIZE + 1
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    return torch.where((ids < 0) | (ids >= n), MAP_SIZE, ids)


def _virgin_update_mask(ids: torch.Tensor, cls: torch.Tensor,
                        is_new: torch.Tensor) -> torch.Tensor:
    """OR of the new lanes' class bits per edge -> uint8[MAP_SIZE],
    by a scatter-max into eight bit planes (row MAP_SIZE is the sink
    for dropped entries)."""
    live = ids < MAP_SIZE
    flat_ids = torch.where(is_new[:, None] & live, _scatter_index(ids),
                           MAP_SIZE).reshape(-1)
    flat_cls = torch.where(is_new[:, None], cls, 0).to(torch.int64) \
        .reshape(-1)
    bitpos = torch.arange(8, device=ids.device)
    bits = (flat_cls[:, None] >> bitpos[None, :]) & 1
    planes = torch.zeros((MAP_SIZE + 1, 8), dtype=torch.int64,
                         device=ids.device)
    planes.scatter_reduce_(0, flat_ids[:, None].expand(-1, 8), bits,
                           reduce="amax")
    return (planes[:MAP_SIZE] << bitpos[None, :]).sum(dim=1) \
        .to(torch.uint8)


def sparse_has_new_bits_batch(virgin: torch.Tensor, ids: torch.Tensor,
                              cls: torch.Tensor,
                              active: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched novelty from sparse (ids, cls) against a shared virgin
    map, with the dense ``has_new_bits_batch``'s semantics: all lanes
    judged against the incoming map, deduped in-batch by stream hash,
    then the map updated with the union of new lanes' bits.  Returns
    (rets int32[B], new virgin uint8[MAP_SIZE])."""
    b = ids.shape[0]
    rets = _novelty_rets(virgin, ids, cls)
    words = (ids.to(torch.int64) & M32) ^ (cls.to(torch.int64) << 20)
    hashes = stream_hash(words)
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=ids.device)
    first = first_occurrence(hashes, active)
    rets = torch.where(first & active, rets, 0).to(torch.int32)
    return rets, virgin & ~_virgin_update_mask(ids, cls, rets > 0)


def _presence_mask(ids: torch.Tensor, is_new: torch.Tensor
                   ) -> torch.Tensor:
    """uint8[MAP_SIZE] with bit 7 set on every edge a new lane touched
    (the sparse ``simplify_trace`` contribution, presence only)."""
    live = ids < MAP_SIZE
    flat = torch.where(is_new[:, None] & live, _scatter_index(ids),
                       MAP_SIZE).reshape(-1)
    plane = torch.zeros(MAP_SIZE + 1, dtype=torch.uint8, device=ids.device)
    plane[flat] = 1
    return plane[:MAP_SIZE] << 7


def sparse_simplify(ids: torch.Tensor) -> torch.Tensor:
    """Simplified-trace classes for the crash/hang maps: every live
    edge contributes the 128 ("hit") bit.  Presence only: unlike the
    dense ``simplify_trace``, an absent edge contributes nothing (the
    reference's known divergence; exact novelty keeps the dense
    semantics)."""
    return torch.where(ids < MAP_SIZE, 128, 0).to(torch.uint8)


def sparse_triage(vb, vc, vh, edge_ids, valid, crash, hang):
    """Throughput triage over all three AFL maps sharing the sort,
    classify and hash work.  Returns (rets int32[B], unique_crash,
    unique_hang, vb', vc', vh')."""
    ids, cls = sparse_classify(edge_ids, valid)
    simp = sparse_simplify(ids)
    words = (ids.to(torch.int64) & M32) ^ (cls.to(torch.int64) << 20)
    hashes = stream_hash(words)

    rets = _novelty_rets(vb, ids, cls)
    crash_rets = _novelty_rets(vc, ids, simp)
    hang_rets = _novelty_rets(vh, ids, simp)

    first_all, first_crash, first_hang = _first_occurrence_multi(
        hashes, crash, hang)
    rets = torch.where(first_all, rets, 0).to(torch.int32)
    uc = first_crash & (crash_rets > 0)
    uh = first_hang & (hang_rets > 0)
    vb2 = vb & ~_virgin_update_mask(ids, cls, rets > 0)
    vc2 = vc & ~_presence_mask(ids, uc)
    vh2 = vh & ~_presence_mask(ids, uh)
    return rets, uc, uh, vb2, vc2, vh2
