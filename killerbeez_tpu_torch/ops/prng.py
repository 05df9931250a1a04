"""Threefry-2x32 in PyTorch, bit-identical to ``jax.random``.

The JAX package derives every candidate from its default PRNG: a key
per mutator (``jax.random.key(seed)``), a key per lane
(``fold_in(key, iteration)``) and one bulk draw of havoc words per
lane (``jax.random.bits(key, (2**sp + 1, 8), uint32)``).  No candidate
stream can match the reference unless these bits match, so this
module reproduces ``jax/_src/prng.py`` as installed (jax 0.9.0, where
``jax_threefry_partitionable`` is True):

  * ``key(seed)``       raw key ``[0, seed & 0xFFFFFFFF]`` (JAX
                        without x64 takes the seed as a 32-bit
                        integer, so the high word is zero);
  * ``fold_in(k, d)``   ``threefry2x32(k, [0], [d])`` -> new key;
  * ``bits(k, shape)``  counts are the row-major flat index as a
                        64-bit integer split into (hi, lo) words;
                        the output word is ``x0 ^ x1`` of the hash.

torch has few uint32 operations, so uint32 values travel in int64
tensors, masked to 32 bits after every operation that can carry.
A key is an int64 tensor ``[..., 2]`` holding the two uint32 words.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counters ``(x0, x1)``
    under key ``(k0, k1)``; all int64 tensors holding uint32 values,
    broadcast together.  Returns the two output words."""
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
    """``jax.random.key(seed)`` as raw key data, int64[2]."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of each uint32 in ``data`` (int64
    tensor, any shape) into key ``k`` (int64[2]).  Returns int64
    ``[*data.shape, 2]`` keys."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & M32
    o0, o1 = threefry2x32(k[0], k[1], torch.zeros_like(d), d)
    return torch.stack([o0, o1], dim=-1)


def bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` for every key in
    ``keys`` (int64 ``[..., 2]``), with ``n`` = prod(shape) words in
    row-major order.  Returns int64 ``[..., n]`` of uint32 values."""
    k0 = keys[..., 0:1]
    k1 = keys[..., 1:2]
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    o0, o1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return o0 ^ o1
