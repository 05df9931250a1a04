"""The port's hashes against the JAX package's, bit for bit:
``murmur3_32`` over uint32 streams whose words have the high bit set
(the values int64 carries masked to 32 bits), the host references
``murmur3_32_np`` and ``xxh64`` on every length 0-64 (the byte tails
and XXH64's 32-byte stripes), and ``hash_bitmaps``.  Tolerance: none
(integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu.ops import hashing as jax_hashing
from killerbeez_tpu_torch.ops import hashing

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [int(hashing.HASH_SEED), 0, 0xFFFFFFFF,
                                  0x1994C9A5])
@pytest.mark.parametrize("w", [1, 7, 64])
def test_murmur3_32_matches_jax(seed, w):
    rng = np.random.default_rng(seed % 9973 + w)
    words = rng.integers(0, 2 ** 32, (33, w), dtype=np.uint64) \
        .astype(np.uint32)
    words[:, 0] |= 0x80000000                     # high bit set
    words[0] = 0xFFFFFFFF
    ref = np.asarray(jax_hashing.murmur3_32(jnp.asarray(words),
                                            np.uint32(seed)))
    # the port takes the words in any integer dtype: int64 holding
    # uint32, and int32 with the same bits
    for t in (torch.from_numpy(words.astype(np.int64)),
              torch.from_numpy(words.view(np.int32))):
        got = hashing.murmur3_32(t, seed)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_murmur3_32_leading_batch_axes():
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2 ** 32, (3, 4, 9), dtype=np.uint64) \
        .astype(np.uint32)
    ref = np.asarray(jax_hashing.murmur3_32(jnp.asarray(words)))
    got = hashing.murmur3_32(torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("n", range(65))
def test_host_hashes_match_jax(n):
    rng = np.random.default_rng(1000 + n)
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    for seed in (0, 12345, 2 ** 63 + 17):
        assert hashing.xxh64(data, seed) == jax_hashing.xxh64(data, seed)
    for seed in (int(hashing.HASH_SEED), 7):
        assert hashing.murmur3_32_np(data, seed) == \
            jax_hashing.murmur3_32_np(data, seed)


def test_hash_bitmaps_matches_jax():
    rng = np.random.default_rng(11)
    maps = rng.integers(0, 256, (17, 256), dtype=np.uint8)
    maps[3] = 0xFF
    maps[4] = 0
    ref = np.asarray(jax_hashing.hash_bitmaps(jnp.asarray(maps)))
    got = hashing.hash_bitmaps(torch.from_numpy(maps))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    ref = np.asarray(jax_hashing.hash_bitmaps(jnp.asarray(maps), 99))
    got = hashing.hash_bitmaps(torch.from_numpy(maps), 99)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
