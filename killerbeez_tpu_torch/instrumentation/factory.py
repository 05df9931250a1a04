"""Instrumentation factory (reference instrumentation_factory.c)."""

from __future__ import annotations

from typing import Dict, Optional, Type

from .base import Instrumentation

_REGISTRY: Dict[str, Type[Instrumentation]] = {}


def register_instrumentation(cls: Type[Instrumentation]
                             ) -> Type[Instrumentation]:
    _REGISTRY[cls.name] = cls
    return cls


def instrumentation_names() -> list[str]:
    return sorted(_REGISTRY)


def instrumentation_factory(name: str, options: Optional[str] = None,
                            device="cuda") -> Instrumentation:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown instrumentation {name!r}; ported so far: "
            f"{', '.join(instrumentation_names())}")
    return _REGISTRY[name](options, device=device)


def instrumentation_help() -> str:
    return "\n".join(_REGISTRY[n].help() for n in instrumentation_names())
