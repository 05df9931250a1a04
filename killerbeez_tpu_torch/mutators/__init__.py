"""Mutator engine: batched byte-tensor mutators behind the reference's
mutator vtable."""

from .base import Mutator
from .factory import (
    mutator_factory, mutator_help, mutator_names, register_mutator,
)

__all__ = ["Mutator", "mutator_factory", "mutator_help",
           "mutator_names", "register_mutator"]
