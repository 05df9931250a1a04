"""Instrumentation layer: runs the target and classifies outcomes
(reference instrumentation/instrumentation.h vtable plus the batched
``run_batch`` path)."""

from .base import BatchResult, Instrumentation
from .factory import (
    instrumentation_factory, instrumentation_help, instrumentation_names,
    register_instrumentation,
)
from .afl import AflInstrumentation
from .debug import DebugInstrumentation
from .ipt import IptInstrumentation
from .jit_harness import JitHarnessInstrumentation
from .return_code import ReturnCodeInstrumentation

__all__ = [
    "Instrumentation", "BatchResult",
    "instrumentation_factory", "instrumentation_help",
    "instrumentation_names", "register_instrumentation",
    "AflInstrumentation", "DebugInstrumentation", "IptInstrumentation",
    "JitHarnessInstrumentation", "ReturnCodeInstrumentation",
]
