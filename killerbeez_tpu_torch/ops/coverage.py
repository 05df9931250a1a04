"""AFL-style edge-coverage bitmap ops in PyTorch.

The port of the JAX package's ``ops/coverage.py`` (the parts the fuzz
loop uses): bit-for-bit the AFL contract of ``has_new_bits``,
``simplify_trace`` and ``classify_counts``, over uint8 tensors.

Conventions:
  * ``trace``  — uint8[MAP_SIZE] raw hit counts (wrapping, like C u8)
  * ``virgin`` — uint8[MAP_SIZE], starts all-0xFF; bits clear as seen
  * a *classified* trace has hit counts bucketed into power-of-2
    classes so that "new hit-count bucket" is a bit test
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# AFL count classes: hits -> {0,1,2,4,8,16,32,64,128}
#   0->0, 1->1, 2->2, 3->4, 4..7->8, 8..15->16, 16..31->32,
#   32..127->64, 128..255->128
_lookup = np.zeros(256, dtype=np.uint8)
_lookup[1] = 1
_lookup[2] = 2
_lookup[3] = 4
_lookup[4:8] = 8
_lookup[8:16] = 16
_lookup[16:32] = 32
_lookup[32:128] = 64
_lookup[128:256] = 128
COUNT_CLASS_LOOKUP = _lookup

# the lookup table on each device it was asked for: copying it from the
# host on every call would wait for the device's queued work
_LOOKUP_ON = {}


def classify_counts(trace: torch.Tensor) -> torch.Tensor:
    """Bucket raw hit counts into AFL count classes (any shape,
    uint8): a table lookup, which the card gathers per element."""
    table = _LOOKUP_ON.get(trace.device)
    if table is None:
        table = _LOOKUP_ON[trace.device] = torch.as_tensor(
            COUNT_CLASS_LOOKUP, device=trace.device)
    return table[trace.long()]


def simplify_trace(trace: torch.Tensor) -> torch.Tensor:
    """Collapse a trace for hang/crash dedup maps: 0 -> 1, hit -> 128."""
    return torch.where(trace == 0, 1, 128).to(torch.uint8)


def has_new_bits(virgin: torch.Tensor, trace: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-exec novelty check against a virgin map: ``(ret,
    new_virgin)`` with ret 2 if some edge was hit for the first time
    ever, 1 if only a new hit-count bucket appeared, else 0, and
    ``new_virgin = virgin & ~trace``."""
    new_count = ((trace & virgin) != 0).any()
    new_tuple = ((trace != 0) & (virgin == 0xFF)).any()
    ret = torch.where(new_tuple, 2, torch.where(new_count, 1, 0))
    return ret.to(torch.int32), virgin & ~trace


def merge_virgin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine two virgin maps: coverage union = bitwise AND."""
    return a & b


def count_non_255_bytes(virgin: torch.Tensor) -> torch.Tensor:
    """Number of virgin-map bytes touched (AFL's coverage%)."""
    return (virgin != 0xFF).sum()
