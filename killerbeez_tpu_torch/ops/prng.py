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
                        the output word is ``x0 ^ x1`` of the hash;
  * ``split(k, n)``     the same counts for shape ``(n,)``, but BOTH
                        output words make key i;
  * ``randint``         ``jax.random.randint`` for shape ``()`` in
                        int32: two split keys draw the high and low
                        words, folded with ``(2**16 % span)**2 %
                        span`` in uint32 arithmetic;
  * ``uniform``         float32: ``(bits >> 9) | 0x3F800000`` bit-cast,
                        minus 1.0;
  * ``bernoulli``       ``uniform < p`` compared in float32 (a Python
                        float probability becomes float32 in JAX).

torch has few uint32 operations, so uint32 values travel in int64
tensors, masked to 32 bits after every operation that can carry.
A key is an int64 tensor ``[..., 2]`` holding the two uint32 words.
"""

from __future__ import annotations

import numpy as np
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
    """``jax.random.key(seed)`` as raw key data, int64[2].  The words
    are filled on the device (a copy from the host would wait for the
    card's queued work)."""
    k = torch.zeros(2, dtype=torch.int64, device=device)
    k[1:].fill_(int(seed) & M32)       # a kernel argument, not a copy
    return k


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of ``data`` into key ``k``: either one
    key (int64[2]) and a tensor of uint32s (int64, any shape), giving
    ``[*data.shape, 2]`` keys, or keys ``[..., 2]`` and one Python
    int folded into each, giving ``[..., 2]``.  A Python int reaches
    the device as a kernel argument: nothing is copied."""
    if isinstance(data, int):
        o0, o1 = threefry2x32(k[..., 0], k[..., 1], 0, data & M32)
    else:
        d = torch.as_tensor(data, dtype=torch.int64,
                            device=k.device) & M32
        o0, o1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d),
                              d)
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


def split(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(k, n)`` for every key in ``keys`` (int64
    ``[..., 2]``).  Returns int64 ``[..., n, 2]``."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    o0, o1 = threefry2x32(keys[..., 0:1], keys[..., 1:2],
                          torch.zeros_like(i), i)
    return torch.stack([o0, o1], dim=-1)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as int32 arithmetic leaves them (wrapping), as JAX's
    int32 casts and sums do."""
    return ((x + 2**31) & M32) - 2**31


def randint(keys: torch.Tensor, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(k, (), minval, maxval)`` (dtype int32) for
    every key in ``keys`` (int64 ``[..., 2]``); ``minval`` and
    ``maxval`` are int32 values, Python ints or int64 tensors that
    broadcast against the keys' batch shape.  A span of ``maxval <=
    minval`` returns ``minval``.  Returns int64 ``[...]``."""
    higher, lower = bits(split(keys, 2), 1)[..., 0].unbind(-1)
    if isinstance(minval, int) and isinstance(maxval, int):
        span = 1 if maxval <= minval else (maxval - minval) & M32
    else:
        span = torch.where(maxval <= minval, 1, (maxval - minval) & M32)
    # (2**32 * higher + lower) % span without a 64-bit remainder, in
    # uint32 arithmetic that wraps as JAX's does
    mult = (2**16) % span
    mult = ((mult * mult) & M32) % span
    off = ((((higher % span) * mult) & M32) + lower % span) & M32
    return wrap_i32(minval + off % span)


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32)`` in [0, 1) for every
    key, with ``n`` = prod(shape) values in row-major order.  Returns
    float32 ``[..., n]``."""
    f = (bits(keys, n) >> 9) | 0x3F800000
    return f.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(keys: torch.Tensor, p: float, n: int) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)`` (the default mode) for
    every key, ``n`` = prod(shape) draws: ``uniform < p`` in float32.
    Returns bool ``[..., n]``."""
    # p rounded to float32 on the host: compared as a Python scalar it
    # reaches the kernel as an argument, with nothing copied
    return uniform(keys, n) < float(np.float32(p))
