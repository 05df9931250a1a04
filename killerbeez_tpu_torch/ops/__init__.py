"""Device-side coverage and hashing primitives, the VM kernels' wrappers
and the generation loop.

The package exports the JAX package's ``ops`` names: the AFL bitmap
operations (``coverage.py``) and the hashes (``hashing.py``), vectorized
in PyTorch on the tensors' device.
"""

from .coverage import (
    classify_counts,
    simplify_trace,
    has_new_bits,
    has_new_bits_with_ignore,
    has_new_bits_seq,
    has_new_bits_batch,
    update_virgin,
    merge_virgin,
    build_bitmap,
    count_non_255_bytes,
    count_bytes,
)
from .hashing import murmur3_32, murmur3_32_np, xxh64, hash_bitmaps

__all__ = [
    "classify_counts", "simplify_trace", "has_new_bits",
    "has_new_bits_with_ignore", "has_new_bits_seq", "has_new_bits_batch",
    "update_virgin", "merge_virgin", "build_bitmap",
    "count_non_255_bytes", "count_bytes",
    "murmur3_32", "murmur3_32_np", "xxh64", "hash_bitmaps",
]
