"""Mutator factory: name -> instance, plus aggregated help."""

from __future__ import annotations

from typing import Dict, Optional, Type

from .afl import AflMutator
from .base import Mutator
from .deterministic import (
    ArithmeticMutator, BitFlipMutator, DictionaryMutator,
    InterestingValueMutator, NopMutator,
)
from .grammar import GrammarMutator
from .multipart import ManagerMutator
from .radamsa import RadamsaMutator
from .randomized import (
    HavocMutator, HonggfuzzMutator, NiMutator, SpliceMutator, ZzufMutator,
)

_REGISTRY: Dict[str, Type[Mutator]] = {}


def register_mutator(cls: Type[Mutator]) -> Type[Mutator]:
    _REGISTRY[cls.name] = cls
    return cls


for _cls in (NopMutator, BitFlipMutator, ArithmeticMutator,
             InterestingValueMutator, DictionaryMutator, HavocMutator,
             ZzufMutator, NiMutator, HonggfuzzMutator, SpliceMutator,
             AflMutator, ManagerMutator, RadamsaMutator, GrammarMutator):
    register_mutator(_cls)


def mutator_names() -> list[str]:
    return sorted(_REGISTRY)


def mutator_factory(name: str, options: Optional[str] = None,
                    input_bytes: bytes = b"", device="cuda") -> Mutator:
    """Create a mutator by name on ``device``."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown mutator {name!r}; known: "
            f"{', '.join(mutator_names())}")
    return _REGISTRY[name](options, input_bytes, device=device)


def mutator_help() -> str:
    return "\n".join(_REGISTRY[n].help() for n in mutator_names())
