"""The two helpers static-edge triage takes from the JAX package's
``ops/sparse_coverage.py``: the in-batch dedup hash and the shared
first-occurrence pass, in PyTorch."""

from __future__ import annotations

from typing import Tuple

import torch

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
