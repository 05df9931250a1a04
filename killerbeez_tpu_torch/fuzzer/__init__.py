"""The fuzzer client: batched main loop + CLI (reference
fuzzer/main.c)."""

from .loop import Fuzzer, FuzzStats

__all__ = ["Fuzzer", "FuzzStats"]
