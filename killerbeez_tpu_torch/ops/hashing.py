"""Hashes for coverage novelty short-circuiting and trace identity.

The port of the JAX package's ``ops/hashing.py``:

  * ``murmur3_32`` — MurmurHash3 x86_32 (public algorithm, Austin
    Appleby, public domain) over uint32 word streams, batched in torch
    ops on the stream's device; the ``ipt`` instrumentation's per-lane
    trace hash;
  * ``murmur3_32_np`` and ``xxh64`` (public algorithm, Yann Collet,
    BSD) — host references in numpy, copied;
  * ``hash_bitmaps`` — the per-lane hash of uint8[B, M] bitmaps.

torch has no full uint32 arithmetic, so uint32 values travel in int64
tensors, masked to 32 bits after every multiply, add and rotate (as
``ops/prng.py`` does); results come back as int64 holding the uint32.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF

HASH_SEED = np.uint32(0xA5B35705)  # fuzzer-wide default hash seed


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def murmur3_32(data_u32: torch.Tensor, seed: int = int(HASH_SEED)
               ) -> torch.Tensor:
    """MurmurHash3_x86_32 over a uint32-word view of the buffer.

    ``data_u32`` holds uint32 words along its last axis (any integer
    dtype: int32 and int64 values are taken modulo 2**32); leading
    axes are batch.  The byte length is ``4*W``, so the public
    algorithm's tail-byte path never triggers.  Returns int64[...]
    holding the uint32 hashes.  The word chain is sequential: one
    pass of torch ops per word."""
    words = data_u32.to(torch.int64) & M32
    k = (words * 0xCC9E2D51) & M32
    k = _rotl32(k, 15)
    k = (k * 0x1B873593) & M32
    h = torch.full(words.shape[:-1], int(seed) & M32, dtype=torch.int64,
                   device=words.device)
    for j in range(words.shape[-1]):
        h = h ^ k[..., j]
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & M32
    h = h ^ ((4 * words.shape[-1]) & M32)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def murmur3_32_np(data: bytes, seed: int = int(HASH_SEED)) -> int:
    """Host-side MurmurHash3_x86_32 reference (full algorithm incl.
    byte tail) for parity tests and host state hashing."""
    data = bytes(data)
    n = len(data)
    nblocks = n // 4
    h = np.uint32(seed)
    c1, c2 = np.uint32(0xCC9E2D51), np.uint32(0x1B873593)
    with np.errstate(over="ignore"):
        if nblocks:
            words = np.frombuffer(data[:nblocks * 4], dtype="<u4")
            for w in words:
                k = np.uint32(w) * c1
                k = np.uint32((int(k) << 15 | int(k) >> 17) & 0xFFFFFFFF)
                k = k * c2
                h = h ^ k
                h = np.uint32((int(h) << 13 | int(h) >> 19) & 0xFFFFFFFF)
                h = h * np.uint32(5) + np.uint32(0xE6546B64)
        tail = data[nblocks * 4:]
        k = np.uint32(0)
        if len(tail) >= 3:
            k = k ^ np.uint32(tail[2] << 16)
        if len(tail) >= 2:
            k = k ^ np.uint32(tail[1] << 8)
        if len(tail) >= 1:
            k = k ^ np.uint32(tail[0])
            k = k * c1
            k = np.uint32((int(k) << 15 | int(k) >> 17) & 0xFFFFFFFF)
            k = k * c2
            h = h ^ k
        h = h ^ np.uint32(n)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    return int(h)


# --- XXH64 (host, numpy uint64) --------------------------------------

_P1 = np.uint64(0x9E3779B185EBCA87)
_P2 = np.uint64(0xC2B2AE3D27D4EB4F)
_P3 = np.uint64(0x165667B19E3779F9)
_P4 = np.uint64(0x85EBCA77C2B2AE63)
_P5 = np.uint64(0x27D4EB2F165667C5)


def _rotl64(x: np.uint64, r: int) -> np.uint64:
    return np.uint64((int(x) << r | int(x) >> (64 - r)) & (2**64 - 1))


def _round64(acc: np.uint64, inp: np.uint64) -> np.uint64:
    with np.errstate(over="ignore"):
        acc = acc + inp * _P2
        acc = _rotl64(acc, 31)
        return acc * _P1


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of a byte string (public algorithm; PT-style trace-stream
    and state hashing)."""
    data = bytes(data)
    n = len(data)
    seed = np.uint64(seed)
    i = 0
    with np.errstate(over="ignore"):
        if n >= 32:
            v1 = seed + _P1 + _P2
            v2 = seed + _P2
            v3 = seed + np.uint64(0)
            v4 = seed - _P1
            while i + 32 <= n:
                lanes = np.frombuffer(data[i:i + 32], dtype="<u8")
                v1 = _round64(v1, lanes[0])
                v2 = _round64(v2, lanes[1])
                v3 = _round64(v3, lanes[2])
                v4 = _round64(v4, lanes[3])
                i += 32
            h = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12)
                 + _rotl64(v4, 18))
            for v in (v1, v2, v3, v4):
                h = h ^ _round64(np.uint64(0), v)
                h = h * _P1 + _P4
        else:
            h = seed + _P5
        h = h + np.uint64(n)
        while i + 8 <= n:
            k = _round64(np.uint64(0), np.frombuffer(
                data[i:i + 8], dtype="<u8")[0])
            h = h ^ k
            h = _rotl64(h, 27) * _P1 + _P4
            i += 8
        if i + 4 <= n:
            h = h ^ (np.uint64(np.frombuffer(
                data[i:i + 4], dtype="<u4")[0]) * _P1)
            h = _rotl64(h, 23) * _P2 + _P3
            i += 4
        while i < n:
            h = h ^ (np.uint64(data[i]) * _P5)
            h = _rotl64(h, 11) * _P1
            i += 1
        h = h ^ (h >> np.uint64(33))
        h = h * _P2
        h = h ^ (h >> np.uint64(29))
        h = h * _P3
        h = h ^ (h >> np.uint64(32))
    return int(h)


def hash_bitmaps(bitmaps: torch.Tensor, seed: int = int(HASH_SEED)
                 ) -> torch.Tensor:
    """Per-lane 32-bit hash of uint8[B, M] bitmaps (M % 4 == 0), the
    bytes read as little-endian uint32 words.  Returns int64[B]
    holding the uint32 hashes."""
    b, m = bitmaps.shape
    by = bitmaps.to(torch.int64).reshape(b, m // 4, 4)
    words = by[..., 0] | (by[..., 1] << 8) | (by[..., 2] << 16) | \
        (by[..., 3] << 24)
    return murmur3_32(words, seed)
