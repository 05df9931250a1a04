"""Instrumentation base class (reference instrumentation.h:40-63).

Two execution APIs:

  * single-exec (reference-shaped): ``enable(input)`` runs one input;
    ``get_fuzz_result()`` / ``is_new_path()`` report on it.  Host
    backends (afl, return_code, debug, ipt's ``qemu_mode``) take the
    driver's command line, and the network drivers run a live target
    through ``start_process`` / ``wait_done``.
  * batched: ``run_batch(inputs, lengths)`` executes a whole candidate
    tensor and returns per-lane verdicts + novelty in one device step;
    host backends execute numpy batches of real processes once the
    driver has bound the command with ``prepare_host``.

State is a JSON string (get_state/set_state) and ``merge`` folds two
states' coverage together; the string format is the JAX package's, so
a state dumped by either package loads in the other.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import FUZZ_ERROR, FUZZ_NONE
from ..utils.options import format_help, parse_options


def pack_verdicts(statuses, new_paths, unique_crashes, unique_hangs):
    """One uint8 lane byte: status (3 bits) | new_paths (2) << 3 |
    unique_crash << 5 | unique_hang << 6 — the wire layout between
    device steps and host triage (torch tensors or numpy arrays).
    Change field widths here and in unpack_verdicts ONLY."""
    if isinstance(statuses, torch.Tensor):
        def u8(x):
            return x.to(torch.uint8)
    else:
        def u8(x):
            return np.asarray(x).astype(np.uint8)
    return (u8(statuses) | (u8(new_paths) << 3)
            | (u8(unique_crashes) << 5) | (u8(unique_hangs) << 6))


def unpack_verdicts(packed):
    """(statuses, new_paths, unique_crashes, unique_hangs) from the
    pack_verdicts lane byte."""
    return (packed & 7, (packed >> 3) & 3,
            (packed >> 5) & 1, (packed >> 6) & 1)


def pad_batch_result(res: "BatchResult", pad_to: int) -> "BatchResult":
    """Pad numpy result arrays to ``pad_to`` lanes: padded lanes read
    FUZZ_ERROR with zero novelty, so a consumer that reads past the
    real count fails loudly instead of consuming plausible results."""
    n = len(res.statuses)
    if pad_to <= n:
        return res
    pad = pad_to - n
    return BatchResult(
        statuses=np.concatenate(
            [res.statuses, np.full(pad, FUZZ_ERROR, dtype=np.int32)]),
        new_paths=np.concatenate(
            [res.new_paths, np.zeros(pad, dtype=np.int32)]),
        unique_crashes=np.concatenate(
            [res.unique_crashes, np.zeros(pad, dtype=bool)]),
        unique_hangs=np.concatenate(
            [res.unique_hangs, np.zeros(pad, dtype=bool)]),
        exit_codes=np.concatenate(
            [res.exit_codes, np.zeros(pad, dtype=np.int32)]))


class BatchResult(NamedTuple):
    """Per-lane outcome of a batched execution: tensors on the
    instrumentation's device, or numpy arrays from host backends."""
    statuses: Any          # int32[B] FUZZ_* (RUNNING already -> HANG)
    new_paths: Any         # int32[B] 0 / 1 (new bucket) / 2 (new edge)
    unique_crashes: Any    # bool[B] first-seen crash shape
    unique_hangs: Any      # bool[B] first-seen hang shape
    exit_codes: Any        # int32[B]


class CompactReport(NamedTuple):
    """Device-side compaction of a batch's interesting lanes (crash /
    hang / new path): the candidate bytes of up to ``capacity`` such
    lanes, gathered in the step so triage never pulls the full [B, L]
    tensor.  ``count`` is the true number of interesting lanes — when
    it exceeds capacity the consumer falls back to a full pull."""
    idx: Any        # int32[C] lane numbers (valid: first count)
    bufs: Any       # uint8[C, L] candidate bytes of those lanes
    lens: Any       # int32[C]
    count: Any      # int32 scalar


class Instrumentation:
    name = "base"
    OPTION_SCHEMA: Dict[str, type] = {}
    OPTION_DESCS: Dict[str, str] = {}
    DEFAULTS: Dict[str, Any] = {}
    supports_batch = False
    #: inputs are tensors handed straight to the device (no target
    #: process, no cmd_line)
    device_backed = False

    def __init__(self, options: Optional[str] = None):
        self.options = parse_options(options, self.OPTION_SCHEMA,
                                     self.DEFAULTS)
        self.last_status = FUZZ_NONE
        self.last_new_path = 0

    def enable(self, input_bytes: Optional[bytes] = None,
               cmd_line: Optional[str] = None) -> None:
        """Run the target on one input (blocking).  Host backends take
        the driver-built ``cmd_line``; device backends ignore it."""
        raise NotImplementedError

    def is_process_done(self) -> bool:
        return True

    # -- async exec (network drivers) -----------------------------------

    def start_process(self, cmd_line: str) -> None:
        """Start the target without waiting (the reference enable's
        async half): the driver talks to the live process, then calls
        wait_done() for the verdict and the novelty update."""
        raise NotImplementedError(
            f"{self.name} cannot run live targets")

    def wait_done(self, timeout: float) -> int:
        """Wait for a start_process() target; kill on timeout (hang).
        Returns the FUZZ_* verdict and updates novelty state."""
        raise NotImplementedError

    def abort_process(self) -> int:
        """Kill and reap a start_process() target without triaging the
        run (no virgin-map update, no hang or crash), for driver-level
        failures that say nothing about the input (the target never
        opened its port).  Returns FUZZ_ERROR."""
        raise NotImplementedError

    def get_fuzz_result(self) -> int:
        return self.last_status

    def is_new_path(self) -> int:
        return self.last_new_path

    def last_unique_crash(self) -> bool:
        return False

    def last_unique_hang(self) -> bool:
        return False

    def prepare_host(self, cmd_line: str, use_stdin: bool,
                     input_file: Optional[str] = None) -> None:
        """Host backends: bind the target command before batch runs
        (drivers call this before each batch; device backends ignore
        it)."""

    def run_batch(self, inputs, lengths,
                  pad_to: Optional[int] = None) -> BatchResult:
        """Execute a [B, L] candidate batch.  ``pad_to`` asks host
        backends to pad the result arrays up to a stable lane count —
        padding never costs a real target execution; device backends
        get already-padded inputs and take no ``pad_to``."""
        raise NotImplementedError(f"{self.name} has no batch path")

    def merge(self, other_state: str) -> None:
        raise NotImplementedError(f"{self.name} cannot merge")

    def get_edges(self) -> Optional[List[Tuple[int, int]]]:
        """(slot, hit count) pairs of the last execution (the tracer
        and showmap read them); None when the backend can't report
        edges."""
        return None

    def get_module_info(self) -> List[str]:
        """Names of instrumented modules (per-module coverage)."""
        return []

    def module_map_ranges(self):
        """[(name, lo, hi)] byte ranges of each module's partition in
        the raw coverage bitmap; None when the backend has no raw
        bitmap."""
        return None

    def get_edge_pairs(self, module: Optional[str] = None):
        """(from, to, count) records of the last execution; None when
        unsupported."""
        return None

    def get_state(self) -> str:
        raise NotImplementedError

    def set_state(self, state: str) -> None:
        raise NotImplementedError

    def cleanup(self) -> None:
        pass

    @classmethod
    def help(cls) -> str:
        head = f"{cls.name} instrumentation"
        doc = (cls.__doc__ or "").strip().splitlines()
        if doc:
            head += f" — {doc[0]}"
        return head + "\n" + format_help(cls.name, cls.OPTION_SCHEMA,
                                         cls.OPTION_DESCS)


def module_slice_edges(edges, module_names: List[str], module: str,
                       partition_size: int):
    """Restrict a global (slot, count) edge list to one module's map
    partition, renumbering slots partition-locally."""
    if edges is None:
        return None
    m = module_names.index(module)
    lo, hi = m * partition_size, (m + 1) * partition_size
    return [(s - lo, c) for s, c in edges if lo <= s < hi]
