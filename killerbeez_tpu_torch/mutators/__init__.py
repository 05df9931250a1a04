"""Mutator engine: batched byte-tensor mutators behind the reference's
mutator vtable."""

from .base import (
    MUTATE_INDEX_MASK, MUTATE_MULTIPLE_INPUTS, MUTATE_THREAD_SAFE, Mutator,
    pack_byte_rows,
)
from .factory import (
    mutator_factory, mutator_help, mutator_names, register_mutator,
)

__all__ = [
    "Mutator", "MUTATE_THREAD_SAFE", "MUTATE_MULTIPLE_INPUTS",
    "MUTATE_INDEX_MASK", "mutator_factory", "mutator_help",
    "mutator_names", "pack_byte_rows", "register_mutator",
]
