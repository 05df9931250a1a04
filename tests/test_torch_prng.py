"""The port's threefry-2x32 against jax.random, bit for bit: key,
fold_in and bits as the JAX package calls them, and the fused
kernel's per-lane havoc words."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu.ops.vm_kernel import (
    havoc_words_for_keys as jax_havoc_words,
)
from killerbeez_tpu_torch.ops import prng
from killerbeez_tpu_torch.ops.vm_kernel import havoc_words_for_keys

# batches here are small: torch's intra-op threads cost more than
# they give, and the test workers already share the cores
torch.set_num_threads(1)

SEEDS = (0, 3, 2**31 - 1, -1)
ITERATIONS = (0, 1, 2**32 - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_bits_match_jax(seed):
    k = jax.random.key(seed)
    kt = prng.key(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(k)),
                                  kt.numpy())
    for it in ITERATIONS:
        f = jax.random.fold_in(k, jnp.uint32(it))
        ft = prng.fold_in(kt, torch.tensor(it))
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(f)), ft.numpy())
        for sp in (1, 4, 7):
            n = (1 << sp) + 1
            ref = np.asarray(jax.random.bits(f, (n, 8), jnp.uint32))
            np.testing.assert_array_equal(
                ref.reshape(-1).astype(np.int64),
                prng.bits(ft, n * 8).numpy())


@pytest.mark.parametrize("sp", [1, 4, 7])
def test_havoc_words_for_keys_match_jax(sp):
    its = np.array([0, 1, 2, 1000, 2**32 - 1], dtype=np.uint32)
    for seed in SEEDS:
        base = jax.random.key(seed)
        keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
            jnp.asarray(its))
        ref = np.asarray(jax_havoc_words(keys, sp)).T      # [B, W]
        tkeys = prng.fold_in(prng.key(seed),
                             torch.from_numpy(its.astype(np.int64)))
        out = havoc_words_for_keys(tkeys, sp)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(ref.view(np.int32), out.numpy())
