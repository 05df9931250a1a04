"""ipt — trace-hash novelty instrumentation (hash-set coverage) over
KBVM targets.

The port of the JAX package's ``instrumentation/ipt.py``, itself the
re-architecture of the reference's Intel-PT path: the reference
reduces each exec to a pair of XXH64 hashes — (control-flow targets,
taken/not-taken stream) — and calls an exec novel when the pair is new
in a hash set.  The KBVM yields the decoded trace directly, so per exec
two 32-bit lane hashes are computed on the device and the novelty
verdicts come from host-side hash sets:

  * unfiltered (the default): the VM's in-loop path hash and an
    order-aware hash of the static-edge counts — no stream is
    materialized, so on the card the VM runs as ``kbz_vm_kernel``
    over every lane;
  * with ``filters`` (block-id windows, the reference's IPT address
    filters): murmur3 of the windowed edge stream and of its first
    difference, over the stream-recording engine
    (``models/vm._run_batch_impl(record_stream=True)``).

``merge`` is set union.  The host-binary tier (``{"qemu_mode": 1}``)
needs the host-execution tier and is not ported yet.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from .. import FUZZ_CRASH, FUZZ_ERROR, FUZZ_HANG, FUZZ_RUNNING, \
    resolve_device
from ..models import targets as targets_mod
from ..models.vm import _run_batch_impl
from ..ops.hashing import murmur3_32
from ..ops.sparse_coverage import stream_hash
from ..ops.vm_kernel import run_batch as vm_run_batch
from ..utils.logging import WARNING_MSG
from .base import BatchResult, Instrumentation
from .factory import register_instrumentation

TIP_SEED = 0x1994C9A5  # control-flow-target stream hash
TNT_SEED = 0x7E57ED01  # branch-outcome stream hash

M32 = 0xFFFFFFFF


def _verdicts(res):
    return torch.where(res.status == FUZZ_RUNNING, FUZZ_HANG,
                       res.status).to(torch.int32)


def _ipt_step_fast(instrs, edge_table, inputs, lengths, mem_size,
                   max_steps, n_edges):
    """Unfiltered trace-hash step without an edge stream: the VM's
    path hash is the order-sensitive half (the reference's TIP
    stream), a positional hash of the static-edge counts the multiset
    half (TNT).  The VM is ``kbz_vm_kernel`` over every lane on CUDA
    tensors, the plain engine on the CPU.  Returns (statuses, exit
    codes, tip, tnt), the hashes int64 holding uint32."""
    res = vm_run_batch(instrs, edge_table, inputs, lengths, mem_size,
                       max_steps, n_edges)
    return (_verdicts(res), res.exit_code, res.path_hash,
            stream_hash(res.counts.to(torch.int64)))


def _ipt_step(instrs, edge_table, inputs, lengths, filt_lo, filt_hi,
              mem_size, max_steps, n_edges):
    """Filtered trace-hash step over the ordered edge stream: ids
    outside every [lo, hi) window drop to the padding value (-1), then
    murmur3 of the stream (tip) and of its first difference (tnt: two
    paths through the same blocks in another order separate here)."""
    res = _run_batch_impl(instrs, edge_table, inputs, lengths, mem_size,
                          max_steps, n_edges, record_stream=True)
    ids = res.edge_ids.to(torch.int64)
    in_range = (ids[..., None] >= filt_lo) & (ids[..., None] < filt_hi)
    keep = in_range.any(dim=-1) & (ids >= 0)
    stream = torch.where(keep, ids, -1) & M32
    tip = murmur3_32(stream, TIP_SEED)
    trans = torch.cat([stream[:, :1], stream[:, 1:] ^ stream[:, :-1]],
                      dim=1)
    return _verdicts(res), res.exit_code, tip, murmur3_32(trans, TNT_SEED)


@register_instrumentation
class IptInstrumentation(Instrumentation):
    """Hash-set (path-sensitive) novelty over KBVM trace streams."""
    name = "ipt"
    supports_batch = True
    device_backed = True
    OPTION_SCHEMA = {"target": str, "program_file": str,
                     "max_steps": int, "filters": list,
                     "qemu_mode": int, "qemu_path": str,
                     "timeout": float}
    OPTION_DESCS = {
        "target": "built-in KBVM target name",
        "program_file": "path to a .npz compiled KBVM program",
        "max_steps": "override the program's hang step budget",
        "filters": "[[lo, hi], ...] block-id ranges to trace "
                   "(default: everything; the reference's IPT address "
                   "filters)",
        "qemu_mode": "hash coverage of a host binary: not ported yet",
        "qemu_path": "not ported yet (qemu_mode)",
        "timeout": "not ported yet (qemu_mode)",
    }
    DEFAULTS: dict = {"qemu_mode": 0, "timeout": 2.0}

    def __init__(self, options: Optional[str] = None, device="cuda"):
        super().__init__(options)
        if self.options["qemu_mode"]:
            raise ValueError(
                "ipt option 'qemu_mode' (hash coverage of host binaries) "
                "is not ported yet: it needs the host-execution tier")
        self.device = dev = resolve_device(device)
        self.program = prog = targets_mod.load_program_from_options(
            self.options,
            'ipt needs {"target": name} or {"program_file": path}')
        self._instrs = torch.as_tensor(prog.instrs, device=dev)
        self._edge_table = torch.as_tensor(prog.edge_table, device=dev)
        # no filters (the default) = whole-trace hashing from the
        # engines' in-loop hash and counts: no stream materialized
        self._unfiltered = not self.options.get("filters")
        filters = self.options.get("filters") or [[0, (1 << 31) - 1]]
        filt = np.asarray(filters, dtype=np.int32)
        if filt.ndim != 2 or filt.shape[1] != 2:
            raise ValueError("filters must be [[lo, hi], ...]")
        self._filt_lo = torch.as_tensor(filt[:, 0], dtype=torch.int64,
                                        device=dev)
        self._filt_hi = torch.as_tensor(filt[:, 1], dtype=torch.int64,
                                        device=dev)
        self.hashes: Set[int] = set()
        self.crash_hashes: Set[int] = set()
        self.hang_hashes: Set[int] = set()
        self.total_execs = 0
        self._last_unique_crash = False
        self._last_unique_hang = False

    # -- set updates ----------------------------------------------------

    def _update_sets(self, statuses: np.ndarray, pairs: List[int],
                     exit_codes: np.ndarray) -> BatchResult:
        """Sequential membership + insert: in-batch duplicates count
        once (the single-exec loop's verdicts).  Returns CPU tensors."""
        n = len(pairs)
        self.total_execs += n
        new_paths = np.zeros(n, dtype=np.int32)
        uc = np.zeros(n, dtype=bool)
        uh = np.zeros(n, dtype=bool)
        for i, p in enumerate(pairs):
            if statuses[i] == FUZZ_ERROR:
                # a failed exec's pair is not a path identity
                continue
            if p not in self.hashes:
                self.hashes.add(p)
                new_paths[i] = 1
            if statuses[i] == FUZZ_CRASH and p not in self.crash_hashes:
                self.crash_hashes.add(p)
                uc[i] = True
            elif statuses[i] == FUZZ_HANG and p not in self.hang_hashes:
                self.hang_hashes.add(p)
                uh[i] = True
        return BatchResult(
            statuses=torch.as_tensor(statuses, dtype=torch.int32),
            new_paths=torch.from_numpy(new_paths),
            unique_crashes=torch.from_numpy(uc),
            unique_hangs=torch.from_numpy(uh),
            exit_codes=torch.as_tensor(exit_codes, dtype=torch.int32))

    # -- batched --------------------------------------------------------

    def run_batch(self, inputs, lengths) -> BatchResult:
        """Execute a uint8[B, L] batch on the device and judge it
        against the host hash sets (the verdicts wait for the card)."""
        dev = self.device
        inputs = torch.as_tensor(inputs, dtype=torch.uint8, device=dev)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        p = self.program
        if self._unfiltered:
            statuses, exit_codes, tip, tnt = _ipt_step_fast(
                self._instrs, self._edge_table, inputs, lengths,
                p.mem_size, p.max_steps, p.n_edges)
        else:
            statuses, exit_codes, tip, tnt = _ipt_step(
                self._instrs, self._edge_table, inputs, lengths,
                self._filt_lo, self._filt_hi, p.mem_size, p.max_steps,
                p.n_edges)
        tip = tip.cpu().numpy().astype(np.uint64)
        tnt = tnt.cpu().numpy().astype(np.uint64)
        pairs = [int(x) for x in (tip << np.uint64(32)) | tnt]
        return self._update_sets(statuses.cpu().numpy(), pairs,
                                 exit_codes.cpu().numpy())

    # -- single-exec shim ----------------------------------------------

    def enable(self, input_bytes: Optional[bytes] = None,
               cmd_line: Optional[str] = None) -> None:
        if input_bytes is None:
            raise ValueError("ipt needs input bytes")
        L = max(((len(input_bytes) + 7) // 8) * 8, 8)
        buf = np.zeros((1, L), dtype=np.uint8)
        buf[0, :len(input_bytes)] = np.frombuffer(input_bytes,
                                                  dtype=np.uint8)
        res = self.run_batch(buf, np.array([len(input_bytes)],
                                           dtype=np.int32))
        self.last_status = int(res.statuses[0])
        self.last_new_path = int(res.new_paths[0])
        self._last_unique_crash = bool(res.unique_crashes[0])
        self._last_unique_hang = bool(res.unique_hangs[0])

    def last_unique_crash(self) -> bool:
        return self._last_unique_crash

    def last_unique_hang(self) -> bool:
        return self._last_unique_hang

    def get_module_info(self) -> List[str]:
        return [self.program.name]

    # -- state / merge (the reference's ipt state: hash lists) ----------

    @staticmethod
    def _dump(hs: Set[int]) -> List[str]:
        return [f"{h:016x}" for h in sorted(hs)]

    @staticmethod
    def _load(items: List[str]) -> Set[int]:
        return {int(h, 16) for h in items}

    @property
    def _hash_scheme(self) -> str:
        """Hash-space identity: the unfiltered (path hash + counts
        hash) and filtered (murmur over the windowed stream) spaces
        differ, and states only union within one."""
        return "path+counts" if self._unfiltered else "stream"

    def _check_scheme(self, d: Dict) -> bool:
        """True when the state's hash space matches ours; a mismatch
        (or a state with no ``hash_scheme`` key) is discarded with a
        warning, keeping the counters."""
        theirs = d.get("hash_scheme", "stream")
        if theirs == self._hash_scheme:
            return True
        WARNING_MSG(
            "ipt state hashes are %r but this instance uses %r "
            "(filters change the hash space) — discarding the foreign "
            "hash sets and keeping counters", theirs, self._hash_scheme)
        return False

    def get_state(self) -> str:
        return json.dumps({
            "instrumentation": self.name,
            "target": self.program.name,
            "hash_scheme": self._hash_scheme,
            "total_execs": self.total_execs,
            "hashes": self._dump(self.hashes),
            "crash_hashes": self._dump(self.crash_hashes),
            "hang_hashes": self._dump(self.hang_hashes),
        })

    def set_state(self, state: str) -> None:
        d = json.loads(state)
        if d.get("instrumentation") not in (None, self.name):
            raise ValueError(
                f"state is for {d.get('instrumentation')!r}, not "
                f"{self.name!r}")
        same_space = self._check_scheme(d)
        self.total_execs = int(d.get("total_execs", 0))
        for key in ("hashes", "crash_hashes", "hang_hashes"):
            setattr(self, key, self._load(d.get(key, [])) if same_space
                    else set())

    def merge(self, other_state: str) -> None:
        d = json.loads(other_state)
        if not self._check_scheme(d):
            return
        for key in ("hashes", "crash_hashes", "hang_hashes"):
            getattr(self, key).update(self._load(d.get(key, [])))
        self.total_execs += int(d.get("total_execs", 0))

    def coverage_bytes(self) -> int:
        return len(self.hashes)
