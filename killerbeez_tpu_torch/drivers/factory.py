"""Driver factory (reference driver_factory.c): one factory taking an
instrumentation and an optional mutator."""

from __future__ import annotations

from typing import Dict, Optional, Type

from .base import Driver

_REGISTRY: Dict[str, Type[Driver]] = {}


def register_driver(cls: Type[Driver]) -> Type[Driver]:
    _REGISTRY[cls.name] = cls
    return cls


def driver_names() -> list[str]:
    return sorted(_REGISTRY)


def driver_factory(name: str, options: Optional[str],
                   instrumentation, mutator=None, device="cuda") -> Driver:
    """name -> driver wired to its instrumentation and mutator."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown driver {name!r}; ported so far: "
            f"{', '.join(driver_names())}")
    return _REGISTRY[name](options, instrumentation, mutator,
                           device=device)


def driver_help() -> str:
    return "\n".join(_REGISTRY[n].help() for n in driver_names())
