"""Before/after timing of the KBVM kernels on the card, taken in turns.

    python -m killerbeez_tpu_torch.tools.kernel_ab --old-source OLD.cu

``OLD.cu`` is an earlier revision of ``csrc/vm_kernel.cu`` whose fused
kernel takes the havoc words as an input, drawn beforehand with torch
ops (``ops/prng.py``); its launch functions are::

    kbz_fuzz_launch(instrs, ni, table, nb, seed, L, seed_len, words,
                    n_words, stack_pow2, B, mem_size, max_steps, n_edges,
                    scratch, mem, status, exit_code, counts, steps, hash32,
                    bufs, lens, stream)
    kbz_vm_launch(instrs, ni, table, nb, inputs, L, lengths, lanes,
                  n_lanes, n_threads, mem_size, max_steps, n_edges, mem,
                  status, exit_code, counts, steps, hash32, stream)

The tool builds it with nvcc (into ``build/ab/``), holds its outputs to
the current kernels' on the flagship shapes (tlvstack_vm, 65536 lanes,
L = 64, stack_pow2 4, mutator seed 3), and times the device work with
CUDA events (``tools/timing.py``: median of 7 after a warm-up, each
call queued behind a hold of the card), each pair in the order old,
new, new, old so that drift of the card does not favour either side:

  * the fused step at the phase-1 budget: "old" is the havoc words
    drawn with torch ops plus the old kernel (also timed apart), "new"
    the current kernel, which draws the words itself (also timed at a
    VM budget of 0: its havoc prologue and fixed costs alone);
  * the VM kernel over the phase-2 survivors (budget 1024), and over
    every lane (the unfused engine's call).

It prints one JSON line with every time and the card's name and power
limit.  Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..models import targets_cgc
from ..models.targets import get_target
from ..models.vm import VMResult
from ..ops import _build, prng
from ..ops import vm_kernel as vk
from .timing import host_ms, in_turns, timed

B = 65536
L = 64
STACK_POW2 = 4
MUT_SEED = 3
AB_DIR = _build.BUILD_DIR.parent / "ab"

_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIGNATURES = {
    "kbz_fuzz_launch": (_P, _I, _P, _I, _P, _I, _I, _P, _I, _I, _I, _I,
                        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "kbz_vm_launch": (_P, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                      _P, _P, _P, _P, _P, _P, _P),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def build_old(src: Path) -> ctypes.CDLL:
    AB_DIR.mkdir(parents=True, exist_ok=True)
    out = AB_DIR / "libvm_kernel_old.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in OLD_SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def _zeros(b, n_edges, dev):
    return (torch.zeros(b, dtype=torch.int32, device=dev),
            torch.zeros(b, dtype=torch.int32, device=dev),
            torch.zeros((b, n_edges + 1), dtype=torch.uint8, device=dev),
            torch.zeros(b, dtype=torch.int32, device=dev),
            torch.zeros(b, dtype=torch.int32, device=dev))


def _result(st, ex, cn, sp, h32):
    return VMResult(st, ex, cn, sp, h32.to(torch.int64) & vk.M32)


def old_fuzz(lib, instrs, table, seed, seed_len, words, ms, steps, ne):
    """The old wrapper's launch of the old fused kernel on given words."""
    dev = words.device
    b = words.shape[0]
    out = _zeros(b, ne, dev)
    bufs = torch.empty((b, L), dtype=torch.uint8, device=dev)
    lens = torch.empty(b, dtype=torch.int32, device=dev)
    scratch = torch.empty((b, L), dtype=torch.uint8, device=dev)
    mem = torch.empty((max(ms, 1), b), dtype=torch.int32, device=dev)
    rc = lib.kbz_fuzz_launch(
        instrs.data_ptr(), instrs.shape[0], table.data_ptr(),
        table.shape[1], seed.data_ptr(), L, seed_len, words.data_ptr(),
        words.shape[1], STACK_POW2, b, ms, steps, ne, scratch.data_ptr(),
        mem.data_ptr(), *(t.data_ptr() for t in out), bufs.data_ptr(),
        lens.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"old kbz_fuzz_kernel: CUDA error {rc}"
    return _result(*out), bufs, lens


def old_vm(lib, instrs, table, inputs, lengths, lanes, n_lanes, ms, steps,
           ne):
    dev = inputs.device
    b = inputs.shape[0]
    n_threads = b if lanes is None else lanes.shape[0]
    out = _zeros(b, ne, dev)
    mem = torch.empty((max(ms, 1), n_threads), dtype=torch.int32,
                      device=dev)
    rc = lib.kbz_vm_launch(
        instrs.data_ptr(), instrs.shape[0], table.data_ptr(),
        table.shape[1], inputs.data_ptr(), L, lengths.data_ptr(),
        None if lanes is None else lanes.data_ptr(),
        None if lanes is None else n_lanes.reshape(1).data_ptr(),
        n_threads, ms,
        steps, ne, mem.data_ptr(), *(t.data_ptr() for t in out),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"old kbz_vm_kernel: CUDA error {rc}"
    return _result(*out)


def max_abs_err(a_fields, b_fields) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in zip(a_fields, b_fields))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-source", required=True, type=Path,
                    help="the earlier vm_kernel.cu to time against")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    old = build_old(args.old_source)
    prog = get_target("tlvstack_vm")
    sb = targets_cgc.tlvstack_vm_seed()
    seed = torch.zeros(L, dtype=torch.uint8, device=dev)
    seed[:len(sb)] = torch.tensor(list(sb), dtype=torch.uint8)
    instrs = torch.as_tensor(prog.instrs, device=dev).to(torch.int32)
    table = torch.as_tensor(prog.edge_table, device=dev).to(torch.int32)
    key = prng.key(MUT_SEED, device=dev)
    its = torch.arange(B, dtype=torch.int64, device=dev)
    ms, steps, ne = prog.mem_size, prog.max_steps, prog.n_edges
    p1 = vk.auto_phase1_steps(steps)

    def words():
        return vk.havoc_words_for_keys(prng.fold_in(key, its), STACK_POW2)

    w = words()

    def fuzz_old():
        return old_fuzz(old, instrs, table, seed, len(sb), words(), ms, p1,
                        ne)

    def fuzz_old_kernel():
        return old_fuzz(old, instrs, table, seed, len(sb), w, ms, p1, ne)

    def fuzz_new(budget=p1):
        return vk.fuzz_batch(instrs, table, seed, len(sb), key, its, ms,
                             budget, ne, STACK_POW2)

    r_old, b_old, l_old = fuzz_old()
    r_new, b_new, l_new = fuzz_new()
    err_fuzz = max_abs_err(list(r_old) + [b_old, l_old],
                           list(r_new) + [b_new, l_new])
    lanes, n_lanes = vk.compact_lanes(r_new.status == vk.FUZZ_RUNNING)
    n_surv = int(n_lanes)

    def vm_old():
        return old_vm(old, instrs, table, b_new, l_new, lanes, n_lanes, ms,
                      steps, ne)

    def vm_new():
        return vk.run_batch(instrs, table, b_new, l_new, ms, steps, ne,
                            lanes=lanes, n_lanes=n_lanes)

    err_vm = max_abs_err(vm_old(), vm_new())
    if err_fuzz or err_vm:
        raise AssertionError(f"old and new kernels disagree: fuzz "
                             f"{err_fuzz}, vm {err_vm}")

    fuzz_before, fuzz_after = in_turns(fuzz_old, fuzz_new)
    kernel_before, kernel_after = in_turns(fuzz_old_kernel, fuzz_new)
    words_ms = timed(words)
    # the fused kernel without VM steps: key, words, edits, fixed costs
    havoc_ms = timed(lambda: fuzz_new(budget=0))
    host = {"old_words_plus_kernel": host_ms(fuzz_old),
            "new": host_ms(fuzz_new),
            "vm_old": host_ms(vm_old), "vm_new": host_ms(vm_new)}
    vm_before, vm_after = in_turns(vm_old, vm_new)
    all_before, all_after = in_turns(
        lambda: old_vm(old, instrs, table, b_new, l_new, None, None, ms,
                       steps, ne),
        lambda: vk.run_batch(instrs, table, b_new, l_new, ms, steps, ne))
    fuzz_new()
    vm_new()
    print(json.dumps({
        "card": card_line(), "B": B, "phase1_budget": p1,
        "survivors": n_surv, "max_abs_err": 0,
        "fuzz_ms": {"old_words_plus_kernel": fuzz_before,
                    "new": fuzz_after,
                    "old_kernel_alone": kernel_before,
                    "new_beside_old_kernel_alone": kernel_after,
                    "words_stage": words_ms,
                    "new_at_budget_0": havoc_ms},
        "vm_survivors_ms": {"old": vm_before, "new": vm_after},
        "vm_all_lanes_ms": {"old": all_before, "new": all_after},
        "survivor_steps": {"max": int(vm_new().steps.max()),
                           "mean": float(vm_new().steps[
                               lanes[:n_surv].long()].float().mean())},
        "launch_shapes": dict(vk.LAST_CONFIG),
        "host_enqueue_ms": host}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
