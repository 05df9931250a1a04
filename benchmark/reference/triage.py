"""Throughput triage against the AFL virgin maps, over a program's
static edge universe.

Each lane's edge counts fold into AFL map slots (colliding edges add,
wrapping at 256), are bucketed into AFL count classes, and are judged
against the incoming virgin maps: 2 when some slot is hit for the
first time, 1 when only a new count bucket shows, else 0.  A lane
counts only as the first lane of the batch with its classified-count
hash.  Crashes and hangs are judged on the simplified trace (hit ->
128, else 1) against their own maps; the slots outside the universe
hold 1 for every lane, which the first unique crash (hang) clears.
The maps then lose the bits of the lanes that counted.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_LOOKUP = np.zeros(256, dtype=np.uint8)
_LOOKUP[1], _LOOKUP[2], _LOOKUP[3] = 1, 2, 4
_LOOKUP[4:8], _LOOKUP[8:16], _LOOKUP[16:32] = 8, 16, 32
_LOOKUP[32:128], _LOOKUP[128:] = 64, 128


def static_maps(edge_slot: np.ndarray):
    """(u_slots int64[U] sorted distinct slots, seg_id int64[E])."""
    u, seg = np.unique(np.asarray(edge_slot), return_inverse=True)
    return u.astype(np.int64), seg.astype(np.int64)


def classify(counts: torch.Tensor) -> torch.Tensor:
    table = torch.as_tensor(_LOOKUP, device=counts.device)
    return table[counts.long()]


def by_slot(counts: torch.Tensor, seg_id: torch.Tensor, n_slots: int):
    c = counts[:, :-1].to(torch.int32)
    out = torch.zeros((c.shape[0], n_slots), dtype=torch.int32,
                      device=c.device)
    out.index_add_(1, seg_id, c)
    return (out & 0xFF).to(torch.uint8)


def stream_hash(words: torch.Tensor) -> torch.Tensor:
    """Order-aware murmur hash of each row (int64 holding uint32)."""
    t = words.shape[-1]
    pos = torch.arange(t, dtype=torch.int64, device=words.device)
    x = (words & M32) ^ ((pos * 0x9E3779B9) & M32)[None, :]
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & M32
    x = x ^ (x >> 16)
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        h = x.shape[1] // 2
        x = x[:, :h] ^ x[:, h:]
    return x[:, 0]


def first_of_hash(hashes: torch.Tensor, pred: torch.Tensor):
    """bool[B]: the lane is the lowest-index lane with ``pred`` among
    the lanes with its hash."""
    b = hashes.shape[0]
    dev = hashes.device
    order = torch.argsort(hashes, stable=True)
    sh = hashes[order]
    head = torch.ones(b, dtype=torch.bool, device=dev)
    head[1:] = sh[1:] != sh[:-1]
    run = torch.cumsum(head.to(torch.int64), 0) - 1
    ps = pred[order]
    m = torch.full((b,), b, dtype=torch.int64, device=dev)
    m = m.scatter_reduce(0, run, torch.where(ps, order, b), reduce="amin")
    out = torch.zeros(b, dtype=torch.bool, device=dev)
    out[order] = ps & (order == m[run])
    return out


def or_rows(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(x.shape[1], dtype=torch.uint8, device=x.device)
    for k in range(8):
        out = out | (x & (1 << k)).amax(dim=0)
    return out


def novelty(virgin_at, classes):
    """2 / 1 / 0 per lane of classes uint8[B, U] against the map's
    bytes at the same positions (uint8[U])."""
    v = virgin_at[None, :]
    new_count = ((classes & v) != 0).any(dim=1)
    new_tuple = ((classes != 0) & (v == 0xFF)).any(dim=1)
    return torch.where(new_tuple, 2, torch.where(new_count, 1, 0))


def triage(vb, vc, vh, counts, u_slots, seg_id, crash, hang):
    """(rets int32[B], uc bool[B], uh bool[B], vb', vc', vh') for one
    batch of edge counts uint8[B, E+1] against maps uint8[MAP]."""
    us = u_slots
    slots = by_slot(counts, seg_id, us.shape[0])
    cls = classify(slots)
    simp = torch.where(slots != 0, 128, 1).to(torch.uint8)
    rets = novelty(vb[us], cls)
    crash_rets = novelty(vc[us], simp)
    hang_rets = novelty(vh[us], simp)
    hashes = stream_hash(cls.to(torch.int64))
    ones = torch.ones_like(crash)
    rets = torch.where(first_of_hash(hashes, ones), rets, 0).to(torch.int32)
    uc = first_of_hash(hashes, crash) & (crash_rets > 0)
    uh = first_of_hash(hashes, hang) & (hang_rets > 0)
    outside = torch.ones(vb.shape[0], dtype=torch.uint8, device=vb.device)
    outside[us] = 0

    def update(virgin, classes, active, with_outside):
        seen = or_rows(torch.where(active[:, None], classes, 0))
        v = virgin.clone()
        v[us] = virgin[us] & ~seen
        if with_outside:
            v = v & ~outside
        return v if bool(active.any()) else virgin.clone()

    return (rets, uc, uh, update(vb, cls, rets > 0, False),
            update(vc, simp, uc, True), update(vh, simp, uh, True))


def pack(statuses, new_paths, uc, uh) -> torch.Tensor:
    """The campaign's lane byte: status | new_path << 3 | unique crash
    << 5 | unique hang << 6."""
    def u8(x):
        return x.to(torch.uint8)
    return (u8(statuses) | (u8(new_paths) << 3) | (u8(uc) << 5)
            | (u8(uh) << 6))
