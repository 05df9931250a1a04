"""The port's havoc (ops/mutate_core.havoc_at, the plain version of
the fused kernel's prologue) against JAX havoc_at: bytes and lengths,
for every stack depth, seed lengths 1, L/2 and L, several L."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu.ops import mutate_core as jax_mc
from killerbeez_tpu_torch.ops import prng
from killerbeez_tpu_torch.ops.mutate_core import havoc_at
from killerbeez_tpu_torch.ops.vm_kernel import havoc_words_for_keys

# batches here are small: torch's intra-op threads cost more than
# they give, and the test workers already share the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("sp", [1, 2, 3, 4, 5, 6, 7])
def test_havoc_matches_jax(sp):
    L = (8, 40, 64)[sp % 3]
    B = 64
    rng = np.random.default_rng(sp)
    base = jax.random.key(11 + sp)
    its = np.arange(5000, 5000 + B, dtype=np.uint32)
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
        jnp.asarray(its))
    words = havoc_words_for_keys(
        prng.fold_in(prng.key(11 + sp),
                     torch.from_numpy(its.astype(np.int64))), sp)
    fn = jax.vmap(lambda b, ln, k: jax_mc.havoc_at(b, ln, k,
                                                   stack_pow2=sp),
                  in_axes=(None, None, 0))
    for seed_len in (1, L // 2, L):
        seed = rng.integers(0, 256, L).astype(np.uint8)
        ref_b, ref_l = fn(jnp.asarray(seed), jnp.int32(seed_len), keys)
        out_b, out_l = havoc_at(torch.from_numpy(seed), seed_len, words,
                                sp)
        np.testing.assert_array_equal(np.asarray(ref_b), out_b.numpy())
        np.testing.assert_array_equal(np.asarray(ref_l), out_l.numpy())
