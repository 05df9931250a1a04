"""The work a batch needs, counted from its inputs, and the least time
an NVIDIA H100 (SXM, 700 W) needs for it.

Peaks: 3.35 TB/s of HBM (NVIDIA's data sheet) and 16.7 TOP/s of int32
operations, derived, not published: 132 SMs x 64 int32 lanes x 1.98
GHz boost clock.  Operations are those the semantics need
(``reference/vm.step``, ``reference/havoc``, ``reference/triage``), not
those a kernel issues:

  * a VM step: clip pc and fetch (2), read two registers (2), dispatch
    and do the op (2), write a register (1), update pc (1), status and
    step count (2); a BLOCK adds the edge index and table load (3), the
    count's load, add and store (3), the edge chain (1) and the path
    hash (9);
  * a havoc edit decodes its eight words (10) and loads and stores each
    byte it writes (2 per byte); each lane's key and each havoc word
    group is one threefry-2x32 hash (80: key schedule 2, injection 2,
    20 rounds of add, rotate and xor 60, five key injections 15,
    output 1);
  * triage: each edge count is read and added into its AFL slot (2);
    each slot is bucketed (1), simplified (1), tested against three
    virgin maps (9), hashed (10) and folded into the maps (3); each
    lane's hash is sorted (2 per level of a sort of the batch) and
    resolved first-of-hash for three predicates (12).

Bytes: what a batch cannot avoid moving, each counted once: its lanes'
candidates, lengths and verdict bytes written, the program's tables
and the three maps read and written.
"""

from __future__ import annotations

import math

import torch

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_VM_STEP = 10
OPS_PER_BLOCK = 16
OPS_PER_EDIT = 10
OPS_PER_WRITTEN_BYTE = 2
OPS_PER_HASH = 80
OPS_PER_EDGE_COUNT = 2
OPS_PER_SLOT = 24
OPS_PER_LANE_FIRSTS = 12
#: bytes one havoc edit writes, by op (w0 % 15); None: the buffer
EDIT_BYTES = (1, 1, 2, 4, 1, 1, 2, 2, 4, 4, 1, None, None, None, None)


def vm_ops(steps: torch.Tensor, counts: torch.Tensor) -> int:
    """Operations of the VM runs with these steps (int[B]) and edge
    counts (uint8[B, E+1]): each step, plus each BLOCK as the counts
    record it (a wrapped count never counts more than ran)."""
    blocks = int(counts.to(torch.int64).sum())
    return int(steps.to(torch.int64).sum()) * OPS_PER_VM_STEP \
        + blocks * OPS_PER_BLOCK


def havoc_ops(words: torch.Tensor, stack_pow2: int, L: int) -> int:
    """Operations of the havoc prologue of lanes with these words
    (int64[B, (2**stack_pow2 + 1) * 8]): each lane hashes its key and
    word group 0, then applies ``1 << (1 + w0 % stack_pow2)`` edits,
    each hashing and decoding its own group."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    b = w.shape[0]
    n_max = 1 << stack_pow2
    stack = 1 << (1 + w[:, 0] % stack_pow2)
    ops = w[:, 8:8 + 8 * n_max].reshape(b, n_max, 8)[:, :, 0] % 15
    active = torch.arange(n_max, device=w.device)[None, :] < stack[:, None]
    per_op = torch.tensor([L if n is None else n for n in EDIT_BYTES],
                          dtype=torch.int64, device=w.device)
    edits = int(active.sum())
    written = int(torch.where(active, per_op[ops], 0).sum())
    hashes = 2 * b + 8 * edits
    return (edits * OPS_PER_EDIT + written * OPS_PER_WRITTEN_BYTE
            + hashes * OPS_PER_HASH)


def triage_ops(lanes: int, n_edges: int, n_slots: int) -> int:
    """Operations of throughput triage of one batch of ``lanes``."""
    per_lane = ((n_edges + 1) * OPS_PER_EDGE_COUNT + n_slots * OPS_PER_SLOT
                + 2 * max(math.ceil(math.log2(max(lanes, 2))), 1)
                + OPS_PER_LANE_FIRSTS)
    return lanes * per_lane


def batch_bytes(lanes: int, L: int, table_bytes: int,
                map_bytes: int) -> int:
    """Bytes a batch has to move: candidates (L), lengths (4) and
    verdict bytes (1) written per lane; tables read; three maps read
    and written."""
    return lanes * (L + 4 + 1) + table_bytes + 6 * map_bytes


def bound_seconds(bytes_moved: float, ops: float):
    """(the least seconds, "bytes" or "operations")."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
