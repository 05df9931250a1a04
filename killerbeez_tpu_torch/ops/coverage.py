"""AFL-style edge-coverage bitmap ops in PyTorch.

The port of the JAX package's ``ops/coverage.py``: bit-for-bit the
AFL contract of ``has_new_bits`` (one exec, sequential, batched with
in-batch hash dedup, with an ignore mask), ``simplify_trace``,
``classify_counts`` and the stream-to-bitmap build, over uint8
tensors.

Conventions:
  * ``trace``  — uint8[MAP_SIZE] raw hit counts (wrapping, like C u8)
  * ``virgin`` — uint8[MAP_SIZE], starts all-0xFF; bits clear as seen
  * a *classified* trace has hit counts bucketed into power-of-2
    classes so that "new hit-count bucket" is a bit test
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import MAP_SIZE

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


def has_new_bits_with_ignore(virgin: torch.Tensor, trace: torch.Tensor,
                             ignore: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Novelty check masking nondeterministic bytes: any nonzero
    ``ignore`` byte excludes that whole trace byte."""
    return has_new_bits(virgin, torch.where(ignore != 0, 0, trace)
                        .to(torch.uint8))


def update_virgin(virgin: torch.Tensor, trace: torch.Tensor
                  ) -> torch.Tensor:
    return virgin & ~trace


def has_new_bits_seq(virgin: torch.Tensor, traces: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential-parity novelty over a batch: lane i is judged
    against the virgin map after lanes < i, as if the single-exec loop
    ran B times.  Returns (rets int32[B], final virgin)."""
    rets = []
    for t in traces:
        ret, virgin = has_new_bits(virgin, t)
        rets.append(ret)
    return (torch.stack(rets) if rets else
            torch.zeros(0, dtype=torch.int32, device=traces.device)), virgin


def has_new_bits_scan(virgin: torch.Tensor, traces: torch.Tensor,
                      active: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``has_new_bits_seq`` without the loop over lanes, for traces
    whose bytes may hold any bits: lane i is judged against ``virgin``
    less the OR of the ACTIVE lanes' traces before it (an exclusive
    prefix OR over the lanes, in log2(B) doubling steps), and only the
    active lanes clear the map.  Returns (rets int32[B] for every lane,
    the map after the active lanes)."""
    b = traces.shape[0]
    pre = torch.where(active[:, None], traces, 0).to(torch.uint8)
    d = 1
    while d < b:
        pre[d:] = pre[d:] | pre[:-d]
        d *= 2
    before = torch.cat([torch.zeros_like(pre[:1]), pre[:-1]])
    v = virgin[None, :] & ~before
    new_count = ((traces & v) != 0).any(dim=1)
    new_tuple = ((traces != 0) & (v == 0xFF)).any(dim=1)
    rets = torch.where(new_tuple, 2, torch.where(new_count, 1, 0))
    return rets.to(torch.int32), virgin & ~pre[-1] if b else virgin


def has_new_bits_batch(virgin: torch.Tensor, traces: torch.Tensor,
                       hashes: torch.Tensor,
                       active: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Throughput-mode batched novelty: every lane is judged against
    the same incoming map, then deduped in-batch by ``hashes`` (a lane
    counts only as the first ACTIVE lane with its hash); inactive lanes
    report 0 and leave the map alone.  The map is updated with the OR
    of the new lanes' traces.  Returns (rets int32[B], new virgin)."""
    v = virgin[None, :]
    new_count = ((traces & v) != 0).any(dim=1)
    new_tuple = ((traces != 0) & (v == 0xFF)).any(dim=1)
    rets = torch.where(new_tuple, 2, torch.where(new_count, 1, 0))
    b = hashes.shape[0]
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=hashes.device)
    same = (hashes[:, None] == hashes[None, :]) & active[None, :]
    earlier = torch.ones((b, b), dtype=torch.bool,
                         device=hashes.device).tril(-1)
    first = ~(same & earlier).any(dim=1)
    rets = torch.where(first & active, rets, 0).to(torch.int32)
    return rets, virgin & ~_or_rows(
        torch.where((rets > 0)[:, None], traces, 0).to(torch.uint8))


def _or_rows(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over the rows of uint8[B, M] (torch has no OR
    reduction): the max of each bit plane."""
    seen = torch.zeros(x.shape[1], dtype=torch.uint8, device=x.device)
    if x.shape[0] == 0:
        return seen
    for k in range(8):
        seen = seen | (((x >> k) & 1).amax(dim=0) << k)
    return seen


def merge_virgin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine two virgin maps: coverage union = bitwise AND."""
    return a & b


def count_non_255_bytes(virgin: torch.Tensor) -> torch.Tensor:
    """Number of virgin-map bytes touched (AFL's coverage%)."""
    return (virgin != 0xFF).sum()


def build_bitmap(edge_ids: torch.Tensor, valid: torch.Tensor,
                 map_size: int = MAP_SIZE) -> torch.Tensor:
    """Per-lane hit-count bitmaps uint8[B, map_size] from int[B, T]
    edge streams and bool[B, T] masks of the steps actually executed;
    counts wrap at 256 like the reference's uint8 trace_bits.  Invalid,
    negative and out-of-range ids are dropped: they land in a sink
    column past the map, which is cut off."""
    b = edge_ids.shape[0]
    ids = edge_ids.to(torch.int64)
    ok = valid & (ids >= 0) & (ids < map_size)
    ids = torch.where(ok, ids, map_size)
    out = torch.zeros((b, map_size + 1), dtype=torch.int32,
                      device=edge_ids.device)
    out.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.int32))
    return (out[:, :map_size] & 0xFF).to(torch.uint8)


def count_bytes(trace: torch.Tensor) -> torch.Tensor:
    """Number of nonzero trace bytes (edges hit this exec)."""
    return (trace != 0).sum()
