"""Threefry-2x32, bit-identical to ``jax.random``'s default PRNG.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words; every
uint32 travels in int64 and is masked to 32 bits after each carry.
  * ``key(seed)``      ``[0, seed & 0xFFFFFFFF]``;
  * ``fold_in(k, d)``  ``threefry2x32(k, [0], [d])``;
  * ``bits(k, n)``     counters are the flat index split into (hi, lo)
                       words, the output word ``x0 ^ x1``.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """One key folded with each uint32 of ``data``: keys
    ``[*data.shape, 2]``."""
    d = data.to(device=k.device, dtype=torch.int64) & M32
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([o0, o1], dim=-1)


def bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` uint32 words per key, row-major: int64 ``[..., n]``."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    o0, o1 = threefry2x32(keys[..., 0:1], keys[..., 1:2],
                          torch.zeros_like(lo), lo)
    return o0 ^ o1


def havoc_words(base_key: torch.Tensor, its: torch.Tensor,
                stack_pow2: int) -> torch.Tensor:
    """Each lane's havoc words: ``bits(fold_in(base_key, it),
    (2**stack_pow2 + 1) * 8)``, int64 holding uint32."""
    return bits(fold_in(base_key, its), ((1 << stack_pow2) + 1) * 8)
