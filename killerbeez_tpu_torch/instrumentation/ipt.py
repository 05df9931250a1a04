"""ipt — trace-hash novelty instrumentation (hash-set coverage) over
KBVM targets and host binaries.

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

``merge`` is set union.  With ``{"qemu_mode": 1}`` the target is an
uninstrumented host binary run under the kb-trace engine in hash mode
(``KB_TRACE_HASH=1``): the tracer publishes each exec's 128-bit (tip,
tnt) pair over the block-PC stream in the first 16 bytes of the SHM
map, and novelty is an unseen pair, as on the KBVM.
"""

from __future__ import annotations

import json
import os
import shlex
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
from .base import BatchResult, Instrumentation, pad_batch_result
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
    """Hash-set (path-sensitive) novelty over KBVM trace streams, or —
    with ``{"qemu_mode": 1}`` — over a host binary's block-PC stream
    observed by the kb-trace engine in hash mode."""
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
                   "filters; KBVM targets only)",
        "qemu_mode": "1 = hash coverage of an uninstrumented host "
                     "binary: run it under kb-trace in hash mode "
                     "(KB_TRACE_HASH=1), novelty = unseen 128-bit "
                     "(tip, tnt) pair over the block-PC stream",
        "qemu_path": "tracer binary for qemu_mode (default "
                     "build/torch_native/kb-trace)",
        "timeout": "qemu_mode: seconds before an exec counts as a "
                   "hang (default 2.0)",
    }
    DEFAULTS: dict = {"qemu_mode": 0, "timeout": 2.0}

    def __init__(self, options: Optional[str] = None, device="cuda"):
        super().__init__(options)
        self.device = dev = resolve_device(device)
        self._host_target = None
        self._host_target_key = None
        if self.options["qemu_mode"]:
            # host-binary tier: the target comes from the driver's
            # cmd_line at enable/prepare_host time, like afl
            self.program = None
            self.device_backed = False  # instance override
            qemu = self.options.get("qemu_path")
            if not qemu:
                from ..native.build import kb_trace_path
                qemu = kb_trace_path()
                self.options["qemu_path"] = qemu
            if not os.path.exists(qemu):
                raise ValueError(
                    f"qemu_mode: tracer binary {qemu!r} not found "
                    "(the bundled default is build/torch_native/kb-trace)")
            if self.options.get("filters"):
                raise ValueError(
                    "ipt filters are block-id ranges of KBVM programs; "
                    "host-binary (qemu_mode) hashing is whole-image")
        else:
            self.program = prog = targets_mod.load_program_from_options(
                self.options,
                'ipt needs {"target": name} or {"program_file": path} '
                'for KBVM targets, or {"qemu_mode": 1} to hash-cover '
                "a real host binary under the kb-trace engine")
            self._instrs = torch.as_tensor(prog.instrs, device=dev)
            self._edge_table = torch.as_tensor(prog.edge_table,
                                               device=dev)
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

    # -- host-binary tier (qemu_mode) -----------------------------------

    def _ensure_host_target(self, cmd_line: str, use_stdin: bool,
                            input_file: Optional[str]):
        from ..native.exec_backend import ExecTarget
        key = (cmd_line, use_stdin, input_file)
        if self._host_target is not None and \
                self._host_target_key == key:
            return self._host_target
        if self._host_target is not None:
            self._host_target.close()
        argv = [self.options["qemu_path"]] + shlex.split(cmd_line)
        # hash mode makes no re-runs, so no KB_TRACE_BUDGET: every
        # exec is a full trace
        self._host_target = ExecTarget(
            argv, use_stdin=use_stdin, input_file=input_file,
            use_forkserver=True, coverage=True,
            timeout=float(self.options["timeout"]),
            extra_env=["KB_TRACE_HASH=1"])
        self._host_target_key = key
        return self._host_target

    def prepare_host(self, cmd_line: str, use_stdin: bool,
                     input_file: Optional[str] = None) -> None:
        if self.options["qemu_mode"]:
            self._ensure_host_target(cmd_line, use_stdin, input_file)

    @staticmethod
    def _host_pairs(bitmaps: np.ndarray) -> List[int]:
        """The tracer publishes the exec's (tip, tnt) u64 pair in the
        first 16 bytes of the SHM region (kb_trace.c hash mode); fold
        it into one 128-bit set key."""
        words = bitmaps[:, :16].copy().view("<u8")
        return [(int(w[0]) << 64) | int(w[1]) for w in words]

    # -- set updates ----------------------------------------------------

    def _update_sets(self, statuses: np.ndarray, pairs: List[int],
                     exit_codes: np.ndarray) -> BatchResult:
        """Sequential membership + insert: in-batch duplicates count
        once (the single-exec loop's verdicts).  Returns numpy
        arrays."""
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
        return BatchResult(statuses=statuses, new_paths=new_paths,
                           unique_crashes=uc, unique_hangs=uh,
                           exit_codes=np.asarray(exit_codes))

    # -- batched --------------------------------------------------------

    def run_batch(self, inputs, lengths,
                  pad_to: Optional[int] = None) -> BatchResult:
        """Execute a uint8[B, L] batch and judge it against the host
        hash sets.  KBVM targets run on the device (the verdicts wait
        for the card) and give CPU tensors; ``qemu_mode`` runs the
        host binary on a numpy batch, padding the numpy results to
        ``pad_to`` lanes."""
        if self.options["qemu_mode"]:
            return self._run_batch_host(inputs, lengths, pad_to)
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
        res = self._update_sets(statuses.cpu().numpy(), pairs,
                                exit_codes.cpu().numpy())
        return BatchResult(*(torch.from_numpy(np.asarray(a))
                             for a in res))

    def _run_batch_host(self, inputs, lengths,
                        pad_to: Optional[int] = None) -> BatchResult:
        from ..native.exec_backend import classify_batch
        if self._host_target is None:
            raise RuntimeError(
                "ipt qemu_mode: prepare_host() not called (the driver "
                "binds the target command first)")
        statuses_raw, bitmaps = self._host_target.run_batch(
            np.asarray(inputs), np.asarray(lengths))
        verdicts, exit_codes = classify_batch(statuses_raw)
        res = self._update_sets(verdicts, self._host_pairs(bitmaps),
                                exit_codes)
        if pad_to is not None:
            res = pad_batch_result(res, pad_to)
        return res

    # -- single-exec shim ----------------------------------------------

    def enable(self, input_bytes: Optional[bytes] = None,
               cmd_line: Optional[str] = None) -> None:
        if self.options["qemu_mode"]:
            if cmd_line is None:
                raise ValueError(
                    "ipt qemu_mode needs a cmd_line (use a host "
                    "driver: file/stdin)")
            from ..native.exec_backend import classify
            t = self._ensure_host_target(cmd_line,
                                         input_bytes is not None, None)
            t.clear_trace()
            verdict, _ = classify(t.run(input_bytes or b""))
            pair = self._host_pairs(t.trace_bits().reshape(1, -1))[0]
            res = self._update_sets(
                np.array([verdict], dtype=np.int32), [pair],
                np.array([0], dtype=np.int32))
        else:
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
        return [self.program.name if self.program is not None
                else "target"]

    def cleanup(self) -> None:
        if self._host_target is not None:
            self._host_target.close()
            self._host_target = None

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
        hash), filtered (murmur over the windowed stream) and
        host-block (kb-trace 128-bit pairs over real binaries) spaces
        differ, and states only union within one."""
        if self.options["qemu_mode"]:
            return "host-block"
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
            "target": (self.program.name if self.program is not None
                       else "host"),
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
