"""Before/after timing of the fused KBVM kernel on the card, in turns.

    git show REV:killerbeez_tpu_torch/csrc/vm_kernel.cu \\
        > build/ab/vm_kernel_seed.cu    # REV: a revision before the ring
    python -m killerbeez_tpu_torch.tools.kernel_ab \\
        --old-source build/ab/vm_kernel_seed.cu

``OLD.cu`` is an earlier revision of ``csrc/vm_kernel.cu`` whose fused
kernel takes its seed by value — a pointer to u8[L] and the length as
an int — as the kernels did before the seed ring (ops/generations.py);
its ``kbz_state_rows`` and ``kbz_vm_launch`` are today's, and its
fused launch is::

    kbz_fuzz_launch(instrs, ni, instrs_shared, table, nb, table_mode,
                    state_shared, seed, L, seed_len, base_key, its,
                    stack_pow2, B, mem_size, max_steps, n_edges, scratch,
                    cols, status, exit_code, counts, steps, hash, bufs,
                    lens, stream, cfg)

The tool builds it with nvcc (into ``build/ab/``), holds its outputs to
the current kernel's on the flagship shapes (tlvstack_vm, 65536 lanes,
L = 64, stack_pow2 4, mutator seed 3, the phase-1 budget), and times
the device work with CUDA events (``tools/timing.py``: median of 7
after a warm-up, each call queued behind a hold of the card), each
pair in the order old, new, new, old so that drift of the card does
not favour either side: the old kernel against the current one reading
the one-slot ring of the host-driven loop, and against the current one
reading slot 7 of a 32-slot ring (the ``-G`` path).

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
from ..ops import _build, prng
from ..ops import vm_kernel as vk
from .timing import host_ms, in_turns

B = 65536
L = 64
STACK_POW2 = 4
MUT_SEED = 3
SLOTS, SLOT = 32, 7
AB_DIR = _build.BUILD_DIR.parent / "ab"

_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIGNATURES = {
    "kbz_state_rows": _build.SIGNATURES["vm_kernel"]["kbz_state_rows"],
    "kbz_fuzz_launch": (_P, _I, _I, _P, _I, _I, _I, _P, _I, _I, _P, _P,
                        _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P,
                        _P, _P, _P, ctypes.POINTER(ctypes.c_int)),
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


def old_fuzz(lib, instrs, table, seed, seed_len, key, its, ms, steps, ne):
    """The old wrapper's launch of the old fused kernel (the current
    wrapper's allocations and layout, the seed passed by value)."""
    dev = its.device
    b = its.shape[0]
    lay = vk.program_layout(instrs, table, ne, dev)
    scratch, cols, shared = vk._scratch(lib, lay, True, ms, ne, L, b, dev)
    res = vk._result(b, ne, dev, zero=not shared)
    bufs = torch.empty((b, L), dtype=torch.uint8, device=dev)
    lens = torch.empty(b, dtype=torch.int32, device=dev)
    rc = lib.kbz_fuzz_launch(
        lay.instrs.data_ptr(), lay.instrs.shape[0], int(lay.instrs_shared),
        lay.table.data_ptr(), lay.table.shape[1], lay.table_mode,
        int(shared), seed.data_ptr(), L, seed_len, key.data_ptr(),
        its.data_ptr(), STACK_POW2, b, ms, steps, ne, scratch.data_ptr(),
        cols, res.status.data_ptr(), res.exit_code.data_ptr(),
        res.counts.data_ptr(), res.steps.data_ptr(),
        res.path_hash.data_ptr(), bufs.data_ptr(), lens.data_ptr(),
        torch.cuda.current_stream().cuda_stream, None)
    assert rc == 0, f"old kbz_fuzz_kernel: CUDA error {rc}"
    return res, bufs, lens


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
    instrs = torch.as_tensor(prog.instrs, device=dev)
    table = torch.as_tensor(prog.edge_table, device=dev)
    key = prng.key(MUT_SEED, device=dev)
    its = torch.arange(B, dtype=torch.int64, device=dev)
    ms, ne = prog.mem_size, prog.n_edges
    p1 = vk.auto_phase1_steps(prog.max_steps)
    one_slot = vk.seed_ring(seed, len(sb))
    # a 32-slot ring of other seeds with the flagship seed in slot 7
    ring = torch.randint(0, 256, (SLOTS, L), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1)).to(dev)
    ring[SLOT] = seed
    lens = torch.full((SLOTS,), L, dtype=torch.int32, device=dev)
    lens[SLOT] = len(sb)
    ring_slot = (ring, lens, torch.tensor(SLOT, dtype=torch.int32,
                                          device=dev))

    def fuzz_old():
        return old_fuzz(old, instrs, table, seed, len(sb), key, its, ms, p1,
                        ne)

    def fuzz_new(triple=one_slot):
        return vk.fuzz_batch(instrs, table, *triple, key, its, ms, p1, ne,
                             STACK_POW2)

    ref = fuzz_old()
    for triple in (one_slot, ring_slot):
        got = fuzz_new(triple)
        err = max_abs_err(list(ref[0]) + list(ref[1:]),
                          list(got[0]) + list(got[1:]))
        if err:
            raise AssertionError(f"old and new fused kernels disagree: "
                                 f"{err}")
    old_one, new_one = in_turns(fuzz_old, fuzz_new)
    old_ring, new_ring = in_turns(fuzz_old, lambda: fuzz_new(ring_slot))
    print(json.dumps({
        "card": card_line(), "B": B, "phase1_budget": p1,
        "max_abs_err": 0,
        "fuzz_ms": {"old_seed_by_value": old_one,
                    "new_one_slot_ring": new_one,
                    "old_seed_by_value_2": old_ring,
                    "new_32_slot_ring": new_ring},
        "launch_shape": vk.LAST_CONFIG["kbz_fuzz_kernel"],
        "host_enqueue_ms": {"old": host_ms(fuzz_old),
                            "new_one_slot_ring": host_ms(fuzz_new)}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
