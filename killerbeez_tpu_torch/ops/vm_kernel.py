"""The KBVM kernels: wrappers, plain versions and two-phase glue.

Port of the JAX package's ``ops/vm_kernel.py``, whose Pallas kernels
become CUDA C++ kernels for Hopper (``csrc/vm_kernel.cu``):

  * ``fuzz_batch``  -> ``kbz_fuzz_kernel`` (replaces ``_fuzz_kernel``,
    ``fuzz_batch_pallas``): per-lane havoc words, havoc mutation AND
    VM execution in one kernel, one thread per lane;
  * ``run_batch``   -> ``kbz_vm_kernel`` (replaces ``_vm_kernel_skip``
    and ``_vm_kernel``, ``run_batch_pallas``): the VM over given
    inputs, optionally over a list of lanes only.

Each wrapper takes its plain PyTorch version for tensors on the CPU,
and only then; for CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts the kernel launches of each wrapper, those of
``kbz_vm_kernel`` with a lane list and over all lanes apart.

Layouts are lane-major: inputs u8[B, L], counts u8[B, E+1]; the
path hash comes back as int64 holding the uint32.  The fused kernel
takes the mutator's base key (int64[2]) and the lanes' iteration
numbers (int64[B], uint32 values) and draws each lane's havoc words
itself, bit-identical to ``havoc_words_for_keys(fold_in(base_key,
its))``.  Its seed is a row of a seed ring (u8[S, L], lengths
int32[S]) picked by a slot index in device memory, so a caller whose
seed the card chose (ops/generations.py) never reads it on the host;
``seed_ring`` makes the one-slot ring of a single seed.  The TPU-only
devices of the reference (one-hot MXU gathers, lane-tile padding,
int16 count narrowing) are not semantics and have no counterpart here:
results for a lane do not depend on the batch around it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .. import FUZZ_NONE, FUZZ_RUNNING
from ..models.vm import VMResult, _run_batch_impl
from . import prng
from .mutate_core import havoc_at

M32 = 0xFFFFFFFF

#: kernel launches made by the wrappers (plain-version calls on CPU
#: tensors do not count): "kbz_vm_kernel" over a lane list (two-phase
#: scheduling), "kbz_vm_kernel_all" over every lane (the mesh's unfused
#: cuda engine)
LAUNCHES = {"kbz_fuzz_kernel": 0, "kbz_vm_kernel": 0,
            "kbz_vm_kernel_all": 0}
#: each kernel's last launch: block size, grid, shared memory bytes
#: per block, resident blocks per SM and whether the lanes' buffers
#: and counts rows were in shared memory
LAST_CONFIG = {"kbz_fuzz_kernel": None, "kbz_vm_kernel": None}
#: the most shared memory a block gives each program table (the
#: instructions, the edge table); a larger one is read from device
#: memory
TABLE_SMEM_MAX = 64 * 1024

# csrc/vm_kernel.cu's table modes
TABLE_DEVICE, TABLE_U8, TABLE_U16 = 0, 1, 2
_CONFIG_FIELDS = ("threads", "grid", "smem_bytes", "blocks_per_sm",
                  "lane_state_shared")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _launch_check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 -> int32 with the same bits."""
    return (((x & M32) ^ (1 << 31)) - (1 << 31)).to(torch.int32)


class Layout(NamedTuple):
    """How the kernels read a program: its tables as the kernel takes
    them and whether each is staged in shared memory."""
    instrs: torch.Tensor        # int32[NI, 4]
    instrs_shared: bool
    table: torch.Tensor         # u8 / int16 (u16 bits) / int32 [nb+1, nb]
    table_mode: int             # TABLE_U8, TABLE_U16 or TABLE_DEVICE


def program_layout(instrs, edge_table, n_edges, dev) -> Layout:
    """The program's tables for the kernels: the edge table narrowed to
    u8 (n_edges < 256) or u16 and staged in shared memory when it fits
    ``TABLE_SMEM_MAX``, else int32 read from device memory; the
    instructions staged when they fit."""
    instrs = instrs.to(device=dev, dtype=torch.int32).contiguous()
    table = edge_table.to(device=dev, dtype=torch.int32).contiguous()
    _check(instrs.dim() == 2 and instrs.shape[1] == 4 and
           instrs.shape[0] > 0, "instrs must be int32[NI, 4], NI > 0")
    _check(table.dim() == 2 and table.shape[0] == table.shape[1] + 1,
           "edge_table must be int32[nb + 1, nb]")
    cells = table.numel()
    if n_edges < 256 and cells <= TABLE_SMEM_MAX:
        table, mode = table.to(torch.uint8), TABLE_U8
    elif n_edges < 32768 and 2 * cells <= TABLE_SMEM_MAX:
        table, mode = table.to(torch.int16), TABLE_U16
    else:
        mode = TABLE_DEVICE
    return Layout(instrs, instrs.numel() * 4 <= TABLE_SMEM_MAX, table, mode)


def _scratch(lib, lay: Layout, fuzz: bool, mem_size, n_edges, L, n, dev):
    """The kernel's device scratch for n lanes: int32[mem_size + state
    rows, cols], the VM's scratch cells and, when the lanes' buffers do
    not fit the block's shared memory (``kbz_state_rows``), the
    buffers.  Returns (scratch, cols, lane state in shared memory)."""
    state_rows = lib.kbz_state_rows(
        int(fuzz), lay.instrs.shape[0], int(lay.instrs_shared),
        lay.table.shape[1], lay.table_mode, n_edges, L)
    cols = (n + 255) // 256 * 256
    rows = max(mem_size + state_rows, 1)
    _check(rows * cols < 2 ** 31, "the batch's scratch exceeds 2**31 "
           "words: use fewer lanes or a shorter input")
    return (torch.empty((rows, cols), dtype=torch.int32, device=dev), cols,
            state_rows == 0)


_CFG = {name: (ctypes.c_int * len(_CONFIG_FIELDS))() for name in LAST_CONFIG}


def _record_launch(name: str, count: str = "") -> None:
    LAST_CONFIG[name] = dict(zip(_CONFIG_FIELDS, _CFG[name]))
    LAUNCHES[count or name] += 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# --------------------------------------------------------------------
# the VM kernel (kbz_vm_kernel) and its plain version
# --------------------------------------------------------------------

def compact_lanes(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lanes where ``mask`` holds, in lane order, without a host
    sync: int32[B] (entries past the count are 0) and the count as an
    int32 device scalar."""
    b = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    target = torch.where(mask, pos, b)
    out = torch.zeros(b + 1, dtype=torch.int32, device=mask.device)
    out.scatter_(0, target, torch.arange(b, dtype=torch.int32,
                                         device=mask.device))
    return out[:b], mask.sum().to(torch.int32)


def _result(b, n_edges, dev, zero: bool) -> VMResult:
    """Output tensors for a batch of b lanes: zeroed (status FUZZ_NONE)
    where a kernel leaves lanes unwritten or counts into the output
    rows, else left for the kernel to write every row."""
    new = torch.zeros if zero else torch.empty     # FUZZ_NONE is 0
    return VMResult(
        status=new(b, dtype=torch.int32, device=dev),
        exit_code=new(b, dtype=torch.int32, device=dev),
        counts=new((b, n_edges + 1), dtype=torch.uint8, device=dev),
        steps=new(b, dtype=torch.int32, device=dev),
        path_hash=new(b, dtype=torch.int64, device=dev))


def run_batch_plain(instrs, edge_table, inputs, lengths, mem_size,
                    max_steps, n_edges, lanes=None, n_lanes=None
                    ) -> VMResult:
    """The plain PyTorch version of ``kbz_vm_kernel``: the torch VM
    (``models/vm._run_batch_impl``) over every lane, or over the first
    ``n_lanes`` entries of ``lanes`` with every other lane FUZZ_NONE
    and zero (the reference's skip-mask contract)."""
    if lanes is None:
        return _run_batch_impl(instrs, edge_table, inputs, lengths,
                               mem_size, max_steps, n_edges)
    idx = lanes[:int(n_lanes)].long()
    sub = _run_batch_impl(instrs, edge_table, inputs[idx], lengths[idx],
                          mem_size, max_steps, n_edges)
    out = _result(inputs.shape[0], n_edges, inputs.device, zero=True)
    for full, part in zip(out, sub):
        if full is not None:            # no edge stream
            full[idx] = part
    return out


def run_batch(instrs, edge_table, inputs, lengths, mem_size, max_steps,
              n_edges, lanes: Optional[torch.Tensor] = None,
              n_lanes: Optional[torch.Tensor] = None) -> VMResult:
    """Run the KBVM over a uint8[B, L] batch (``kbz_vm_kernel``).

    ``lanes`` (int32[>= n_lanes]) with ``n_lanes`` (int32 scalar
    tensor on the same device) restricts execution to those lanes;
    the rest come back FUZZ_NONE with zero counts, steps and hash.
    CPU tensors take the plain version; CUDA tensors the kernel."""
    dev = inputs.device
    if dev.type == "cpu":
        return run_batch_plain(instrs, edge_table, inputs, lengths,
                               mem_size, max_steps, n_edges, lanes,
                               n_lanes)
    _check(dev.type == "cuda", f"run_batch: unsupported device {dev}")
    _check(inputs.dtype == torch.uint8 and inputs.dim() == 2,
           "inputs must be uint8[B, L]")
    _check((lanes is None) == (n_lanes is None),
           "lanes and n_lanes go together")
    b, L = inputs.shape
    lay = program_layout(instrs, edge_table, n_edges, dev)
    inputs = inputs.contiguous()
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    _check(lengths.shape == (b,), "lengths must be int32[B]")
    n_threads = b
    if lanes is not None:
        lanes = lanes.to(device=dev, dtype=torch.int32).contiguous()
        n_lanes = n_lanes.to(device=dev, dtype=torch.int32).reshape(1)
        n_threads = int(lanes.shape[0])
        _check(n_threads <= b, "more lanes than the batch holds")
    from ._build import load
    lib = load("vm_kernel")
    scratch, cols, state_shared = _scratch(lib, lay, False, mem_size,
                                           n_edges, L, n_threads, dev)
    # without a list the kernel writes every row; with one, only the
    # listed lanes' rows, so the rest start zeroed, as do counts rows
    # the kernel counts into directly
    out = _result(b, n_edges, dev,
                  zero=lanes is not None or not state_shared)
    rc = lib.kbz_vm_launch(
        lay.instrs.data_ptr(), lay.instrs.shape[0], int(lay.instrs_shared),
        lay.table.data_ptr(), lay.table.shape[1], lay.table_mode,
        int(state_shared), inputs.data_ptr(), L, lengths.data_ptr(),
        _ptr(lanes), _ptr(n_lanes), n_threads, mem_size, max_steps,
        n_edges, scratch.data_ptr(), cols, out.status.data_ptr(),
        out.exit_code.data_ptr(),
        out.counts.data_ptr(), out.steps.data_ptr(),
        out.path_hash.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        _CFG["kbz_vm_kernel"])
    _launch_check(rc, "kbz_vm_kernel")
    _record_launch("kbz_vm_kernel",
                   "kbz_vm_kernel" if lanes is not None
                   else "kbz_vm_kernel_all")
    return out


# --------------------------------------------------------------------
# the fused havoc + VM kernel (kbz_fuzz_kernel) and its plain version
# --------------------------------------------------------------------

def havoc_words_for_keys(keys: torch.Tensor, stack_pow2: int = 4
                         ) -> torch.Tensor:
    """The per-lane havoc words, one row per key (int64 [B, 2] raw
    keys): exactly ``havoc_at``'s stream in the JAX package, one
    ``bits(key, (2**stack_pow2 + 1, 8))`` draw per lane.  Returns
    int32[B, (2**stack_pow2 + 1) * 8] holding the uint32 bits.  The
    unfused havoc mutator and ``fuzz_batch_plain`` draw their words
    here; ``kbz_fuzz_kernel`` computes the same words itself."""
    n_words = ((1 << stack_pow2) + 1) * 8
    return _i32_bits(prng.bits(keys, n_words))


def seed_ring(seed_buf: torch.Tensor, seed_len: int):
    """One seed as the fused kernel's ring: (u8[1, L], int32[1] lengths,
    int32 slot 0), on the seed's device.  The length and the slot are
    filled on the device (``fill_`` takes its value as a kernel
    argument), so nothing waits for the card; the ``seed_len`` range
    is checked here, on the host."""
    L = int(seed_buf.shape[-1])
    _check(seed_buf.dim() == 1 and L > 0, "seed_buf must be uint8[L]")
    seed_len = int(seed_len)
    _check(1 <= seed_len <= L, "seed_len must be in 1..L")
    dev = seed_buf.device
    return (seed_buf.reshape(1, L),
            torch.empty(1, dtype=torch.int32, device=dev).fill_(seed_len),
            torch.zeros((), dtype=torch.int32, device=dev))


def fuzz_batch_plain(instrs, edge_table, ring, ring_lens, sel, base_key,
                     its, mem_size, max_steps, n_edges, stack_pow2=4):
    """The plain PyTorch version of ``kbz_fuzz_kernel``: the seed is ring
    row ``sel`` (gathered on the device, like the kernel's load), then
    per-lane keys ``fold_in(base_key, its)``, their havoc words,
    ``havoc_at`` and the torch VM."""
    bufs, lens = havoc_from_ring(ring, ring_lens, sel, base_key, its,
                                 stack_pow2)
    res = _run_batch_impl(instrs, edge_table, bufs, lens, mem_size,
                          max_steps, n_edges)
    return res, bufs, lens


def havoc_from_ring(ring, ring_lens, sel, base_key, its, stack_pow2=4):
    """The havoc half of ``kbz_fuzz_kernel``'s plain version, in torch
    ops on the ring's device: ring row ``sel`` mutated by each lane's
    words from ``fold_in(base_key, its)``.  Returns (bufs uint8[B, L],
    lens int32[B]); the unfused ``cuda`` engine of the mesh runs these
    lanes through ``run_batch``."""
    slot = sel.reshape(1).long()
    seed = ring.index_select(0, slot)[0]
    seed_len = ring_lens.index_select(0, slot)[0]
    words = havoc_words_for_keys(prng.fold_in(base_key, its), stack_pow2)
    return havoc_at(seed, seed_len, words, stack_pow2)


def fuzz_batch(instrs, edge_table, ring, ring_lens, sel, base_key, its,
               mem_size, max_steps, n_edges, stack_pow2=4):
    """Fused fuzz step (``kbz_fuzz_kernel``): lane i starts from the
    seed, applies the stacked havoc edits drawn from its key
    ``fold_in(base_key, its[i])`` and runs the mutant through the VM.
    The seed is row ``sel`` of ``ring`` (uint8[S, L]) with length
    ``ring_lens[sel]`` (int32[S], each in 1..L); ``sel`` is an int32
    scalar tensor on the device, read there (``seed_ring`` makes the
    one-slot ring of a single seed).  ``base_key`` int64[2] raw key,
    ``its`` int64[B] uint32 iteration numbers.  Returns (VMResult,
    bufs uint8[B, L], lens int32[B]).  CPU tensors take the plain
    version; CUDA the kernel."""
    dev = its.device
    _check(its.dim() == 1 and its.dtype == torch.int64,
           "its must be int64[B]")
    _check(base_key.shape == (2,) and base_key.dtype == torch.int64 and
           base_key.device == dev,
           "base_key must be an int64[2] raw key on its' device")
    _check(1 <= stack_pow2 <= 7, "stack_pow2 must be in 1..7")
    _check(ring.dim() == 2 and ring.dtype == torch.uint8 and
           ring.shape[0] > 0 and ring.shape[1] > 0 and ring.device == dev,
           "ring must be uint8[S, L] on its' device")
    _check(ring_lens.shape == (ring.shape[0],) and
           ring_lens.dtype == torch.int32 and ring_lens.device == dev,
           "ring_lens must be int32[S] on its' device")
    _check(sel.numel() == 1 and sel.dtype == torch.int32 and
           sel.device == dev, "sel must be one int32 on its' device")
    if dev.type == "cpu":
        return fuzz_batch_plain(instrs, edge_table, ring, ring_lens, sel,
                                base_key, its, mem_size, max_steps,
                                n_edges, stack_pow2)
    _check(dev.type == "cuda", f"fuzz_batch: unsupported device {dev}")
    b = its.shape[0]
    L = int(ring.shape[1])
    ring = ring.contiguous()
    ring_lens = ring_lens.contiguous()
    lay = program_layout(instrs, edge_table, n_edges, dev)
    its = its.contiguous()
    base_key = base_key.contiguous()
    from ._build import load
    lib = load("vm_kernel")
    scratch, cols, state_shared = _scratch(lib, lay, True, mem_size,
                                           n_edges, L, b, dev)
    res = _result(b, n_edges, dev, zero=not state_shared)
    bufs = torch.empty((b, L), dtype=torch.uint8, device=dev)
    lens = torch.empty(b, dtype=torch.int32, device=dev)
    rc = lib.kbz_fuzz_launch(
        lay.instrs.data_ptr(), lay.instrs.shape[0], int(lay.instrs_shared),
        lay.table.data_ptr(), lay.table.shape[1], lay.table_mode,
        int(state_shared), ring.data_ptr(), L, ring_lens.data_ptr(),
        sel.data_ptr(), base_key.data_ptr(), its.data_ptr(), stack_pow2, b,
        mem_size, max_steps, n_edges, scratch.data_ptr(), cols,
        res.status.data_ptr(), res.exit_code.data_ptr(),
        res.counts.data_ptr(), res.steps.data_ptr(),
        res.path_hash.data_ptr(), bufs.data_ptr(), lens.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, _CFG["kbz_fuzz_kernel"])
    _launch_check(rc, "kbz_fuzz_kernel")
    _record_launch("kbz_fuzz_kernel")
    return res, bufs, lens


# --------------------------------------------------------------------
# two-phase scheduling
# --------------------------------------------------------------------
#
# A warp (like a TPU tile) runs until its deepest lane halts, and
# mutant depth is heavy-tailed.  Phase 1 runs the fused kernel with a
# small budget; the lanes still running are re-executed from scratch
# with the full budget by the VM kernel over their lane list, and the
# results are mixed back.  Bit-identical to a single phase: finished
# lanes' fields are final, and survivors re-run deterministically.

def auto_phase1_steps(max_steps: int) -> int:
    """The default phase-1 budget: max_steps/8 on deep targets,
    single phase on shallow ones (max_steps < 256)."""
    return max_steps // 8 if max_steps >= 256 else 0


def fuzz_batch_2phase(instrs, edge_table, ring, ring_lens, sel, base_key,
                      its, mem_size, max_steps, n_edges, stack_pow2=4,
                      phase1_steps=0):
    """fuzz_batch with two-phase tail scheduling.  ``phase1_steps``:
    <0 = auto (auto_phase1_steps); 0 or >= max_steps = single phase."""
    if phase1_steps < 0:
        phase1_steps = auto_phase1_steps(max_steps)
    res1, bufs, lens = fuzz_batch(
        instrs, edge_table, ring, ring_lens, sel, base_key, its, mem_size,
        min(phase1_steps, max_steps) if phase1_steps else max_steps,
        n_edges, stack_pow2=stack_pow2)
    if not phase1_steps or phase1_steps >= max_steps:
        return res1, bufs, lens
    surv = res1.status == FUZZ_RUNNING
    lanes, n_lanes = compact_lanes(surv)
    res2 = run_batch(instrs, edge_table, bufs, lens, mem_size, max_steps,
                     n_edges, lanes=lanes, n_lanes=n_lanes)
    res = VMResult(*(torch.where(surv if f1.dim() == 1 else surv[:, None],
                                 f2, f1)
                     for f1, f2 in zip(res1, res2) if f1 is not None))
    return res, bufs, lens
