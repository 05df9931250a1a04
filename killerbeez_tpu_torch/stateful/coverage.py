"""State x edge novelty — the session tier's second virgin map.

The port of the JAX package's ``stateful/coverage.py``.  The classic
AFL map answers "did this input light an edge (bucket) we have never
seen"; protocol targets need "did it light an edge FROM a protocol
state we have never seen it from".  The map is ``n_states x (E+1)``
uint8 hit counts over the program's static edge universe (edge-index
space, not AFL slot space), classified into AFL count buckets and
AND-folded into a ``virgin_state`` byte map with exactly
``has_new_bits`` semantics.

Two triage modes mirroring the classic ones (jit_harness novelty):

  * ``state_triage_exact``    — lanes judged sequentially (lane i
    sees the virgin map after lanes < i): the parity mode, as an
    exclusive prefix OR over the lanes (``has_new_bits_scan``), not a
    loop over them;
  * ``state_triage``          — throughput mode: all lanes vs the
    incoming map, in-batch dedup by classified-map hash, one
    OR-folded virgin clear.

Both return AFL ret codes per lane (2 = a never-seen (state, edge)
pair, 1 = only a new hit-count bucket, 0 = nothing) and the updated
virgin map.  The verdict the session tier reports is ``max(classic,
state)``.  Everything runs on the tensors' device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.coverage import COUNT_CLASS_LOOKUP, _or_rows, classify_counts, \
    has_new_bits_scan
from ..ops.sparse_coverage import first_occurrence, stream_hash


def state_map_size(n_states: int, n_edges: int) -> int:
    """Bytes in a program's state x edge virgin map."""
    return int(n_states) * (int(n_edges) + 1)


def fresh_virgin_state(n_states: int, n_edges: int,
                       device="cpu") -> torch.Tensor:
    return torch.full((state_map_size(n_states, n_edges),), 0xFF,
                      dtype=torch.uint8, device=device)


def _classify_flat(se_counts: torch.Tensor) -> torch.Tensor:
    """uint8[B, S, E+1] -> classified uint8[B, S*(E+1)]."""
    return classify_counts(se_counts.reshape(se_counts.shape[0], -1))


def state_triage(virgin_state: torch.Tensor, se_counts: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Throughput-mode state novelty.  Args: virgin uint8[S*(E+1)],
    se_counts uint8[B, S, E+1].  Returns (rets int32[B], virgin')."""
    cls = _classify_flat(se_counts)
    v = virgin_state[None, :]
    new_count = ((cls & v) != 0).any(dim=1)
    new_tuple = ((cls != 0) & (v == 0xFF)).any(dim=1)
    rets = torch.where(new_tuple, 2, torch.where(new_count, 1, 0))
    hashes = stream_hash(cls.to(torch.int64))
    first = first_occurrence(hashes, torch.ones_like(hashes,
                                                     dtype=torch.bool))
    rets = torch.where(first, rets, 0).to(torch.int32)
    seen = _or_rows(torch.where((rets > 0)[:, None], cls, 0)
                    .to(torch.uint8))
    return rets, virgin_state & ~seen


def state_triage_exact(virgin_state: torch.Tensor,
                       se_counts: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential-parity state novelty: lane i is judged against the
    virgin map less the OR of lanes < i's classified maps — bit for bit
    the JAX package's scan over the lanes."""
    cls = _classify_flat(se_counts)
    return has_new_bits_scan(
        virgin_state, cls,
        torch.ones(cls.shape[0], dtype=torch.bool, device=cls.device))


def np_state_triage_exact(virgin_state: np.ndarray,
                          se_counts: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy witness of ``state_triage_exact`` (one lane at a
    time, the single-exec loop's order)."""
    v = np.asarray(virgin_state).copy()
    se = np.asarray(se_counts)
    b = se.shape[0]
    cls = COUNT_CLASS_LOOKUP[se.reshape(b, -1)]
    rets = np.zeros(b, np.int32)
    for i in range(b):
        t = cls[i]
        new_tuple = bool(((t != 0) & (v == 0xFF)).any())
        new_count = bool((t & v).any())
        rets[i] = 2 if new_tuple else (1 if new_count else 0)
        v &= ~t
    return rets, v


def state_coverage_stats(virgin_state: np.ndarray,
                         n_states: int) -> Tuple[int, int]:
    """(touched state x edge pairs, distinct states seen) from a
    virgin map — the telemetry gauges' source."""
    v = np.asarray(virgin_state).reshape(n_states, -1)
    touched = v != 0xFF
    return int(touched.sum()), int(touched.any(axis=1).sum())
