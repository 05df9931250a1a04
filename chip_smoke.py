"""Chip smoke test of the PyTorch/CUDA port (killerbeez_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``killerbeez_tpu_torch/csrc`` and:

  1. prints the card (``nvidia-smi``: name, power limit), the torch and
     CUDA versions and the kernel build time;
  2. at the flagship shapes (target tlvstack_vm, B = 65536 lanes,
     L = 64, havoc stack_pow2 4) holds ``kbz_fuzz_kernel`` (at the
     phase-1 budget the main path gives it; it draws each lane's havoc
     words from the base key and the lane's iteration number) against
     its plain PyTorch version on all seven outputs, ``kbz_vm_kernel``
     with and without a lane list against the plain VM, and the
     two-phase glue against a single phase; then both kernels again on
     fixedform_vm, whose edge table is read from device memory instead
     of shared memory, and on tlvstack_vm with inputs of 4096 bytes and
     with 8000 edges, whose lanes' buffers or counts rows do not fit
     shared memory and live in device memory — all bit-identical
     (tolerance: none; integer semantics) — and times each kernel and
     its plain version, and
     each device stage of a flagship batch (phase 1, phase 2, triage,
     packing), with CUDA events (median of several runs after a
     warm-up), and prints each kernel's launch shape (block size, grid,
     shared memory per block, resident blocks per SM);
  3. drives the main path: the port's CLI in a subprocess, ``file
     jit_harness havoc -b 65536 -n 6291456`` with engine cuda_fused
     (twelve superbatches of 8 x 65536 lanes) and no ``-fb`` flag, the
     default campaign: corpus feedback every 8 batches with the bandit
     scheduler, stats files and the event log; requires exit 0, launch
     counts > 0 for both kernels (the CLI prints them; the subprocess
     starts from zero), findings in new_paths/, ``fuzzer_stats`` and a
     ``scheduler_pick`` event onto an admitted arm, not the base seed;
     runs it and the same command at ``-fb 0`` in turns (default,
     ``-fb 0``, ``-fb 0``, default) and prints the four execs/s beside
     the card's name and power limit;
  4. runs the CLI on the card (cuda_fused) and on the CPU (torch) at
     ``-b 1024 -n 12288 -fb 0`` — one K = 8 superbatch, then four
     single batches — once with throughput novelty (the flagship's)
     and once with exact novelty, and requires equal md5 sets and
     equal instrumentation state dumps; then, in this process through
     the CLI's ``main`` with ``Fuzzer.PIPELINE_DEPTH = 1`` (every
     batch triaged before the next rotation, so the rotations are
     fixed), at the default ``-fb`` with ``-b 1024 -n 25600`` (its
     third rotation picks an admitted arm), under both novelties, and
     requires equal md5 sets, ``-isd`` and ``-msd`` states, rotation
     picks and ``fuzzer_stats`` counters;
  5. prints one ``{"kernels": [...]}`` line, then the card line, then
     the result line ``{"ok": true, "device": {...}}`` last.

Any failure raises: the script exits non-zero and prints no result.
Outputs go to build/chip_smoke/ in the checkout.

``bound_ms`` is the least time the card could take for a kernel's
work: the larger of the bytes it must move (each input read once, each
output written once) at 3.35 TB/s, and its integer operations at
16.7 TOP/s (132 SMs x 64 INT32 lanes x 1.98 GHz; the H100 SXM has no
faster path for this work).  The operations are what this run's data
needs by the VM's, havoc's and threefry's semantics, not what the
kernel issues: see ``vm_ops`` and ``havoc_ops``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"
B = 65536
STACK_POW2 = 4
#: the main path's run length: 12 superbatches of 8 batches, so the
#: default campaign rotates 11 times; its first rotations pick the base
#: seed while the base still finds edges, later ones admitted arms
FLAGSHIP_BATCHES = 96
MUT_SEED = 3
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations the semantics need (models/vm._step_batched,
# ops/mutate_core._havoc_one), not what the kernels issue.  Every VM
# step: clip pc and fetch (2), read two registers (2), dispatch on the
# op and do its work (2), write a register (1), update pc (1), status
# and step count (2).  A BLOCK step adds the edge index and table load
# (3), the count's load, add and store (3), prev_idx (1) and the path
# hash (xor with the location, then mix32: 3 shifts, 3 xors, 2
# multiplies; 9).  A havoc edit decodes its eight words (10: op, two
# positions, byte, value, endianness, block length, bit, delta, fill),
# then loads and stores each byte it writes (2 per byte).  Each havoc
# word, and each lane's key, is one threefry-2x32 hash (ops/prng.py):
# the key schedule (2), the key injection (2), 20 rounds of add, rotate
# and xor (60), 5 key injections of 3 adds (15), and the output xor (1).
OPS_PER_VM_STEP = 10
OPS_PER_BLOCK = 16
OPS_PER_EDIT = 10
OPS_PER_WRITTEN_BYTE = 2
OPS_PER_HASH = 80
SOURCE = "killerbeez_tpu_torch/csrc/vm_kernel.cu"
REF = "killerbeez_tpu/ops/vm_kernel.py"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out.splitlines()[0]


def max_abs_err(a_fields, b_fields) -> int:
    err = 0
    for a, b in zip(a_fields, b_fields):
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def vm_ops(res) -> int:
    """Operations the VM runs of ``res`` (a VMResult) need: every
    executed step, plus the BLOCK steps, read off the edge counts (a
    count wraps at 256, so this never counts more than ran)."""
    blocks = int(res.counts.to(torch.int64).sum())
    return int(res.steps.sum()) * OPS_PER_VM_STEP + blocks * OPS_PER_BLOCK


# bytes one havoc edit writes, by op (w[0] % 15): bit flip; interesting
# 8/16/32; arith -/+ 8, 16, 32; xor: a few bytes; delete, insert,
# overwrite/fill move the buffer (None: L bytes)
EDIT_BYTES = (1, 1, 2, 4, 1, 1, 2, 2, 4, 4, 1, None, None, None, None)


def havoc_ops(words: torch.Tensor, stack_pow2: int, L: int):
    """(edits, hashes, operations) the havoc prologue of lanes with
    these words needs: each lane hashes its key and its word 0, then
    applies 1 << (1 + w0 % stack_pow2) edits, edit i hashing and
    decoding words[8 (i + 1): 8 (i + 2)]."""
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
    return edits, hashes, (edits * OPS_PER_EDIT
                           + written * OPS_PER_WRITTEN_BYTE
                           + hashes * OPS_PER_HASH)


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cli_argv(out, *args):
    return ["file", "jit_harness", "havoc", "-sf", str(OUT / "seed.bin"),
            "-m", json.dumps({"seed": MUT_SEED}), "-o", str(out), "-l",
            '{"level": 1}', *args]


def run_cli(args, name):
    """Run the port's CLI in a subprocess; returns (stderr text, output
    dir)."""
    out = OUT / name
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "killerbeez_tpu_torch.fuzzer",
           *cli_argv(out, *args)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    log = proc.stderr
    (OUT / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"CLI {name} exited {proc.returncode}:\n"
                           f"{log[-3000:]}")
    print(f"cli {name}: exit 0 in {wall:.1f} s wall", flush=True)
    return log, out


def launch_shape(vk, name) -> str:
    c = vk.LAST_CONFIG[name]
    return (f"{name}: {c['threads']} threads x {c['grid']} blocks, "
            f"{c['smem_bytes']} B shared memory per block, "
            f"{c['blocks_per_sm']} blocks per SM, lane state in "
            f"{'shared' if c['lane_state_shared'] else 'device'} memory")


def check_program(vk, name, dev, n, L, seed_len=None, n_edges=None):
    """Both kernels against their plain versions on target ``name`` at
    n lanes (max abs error over every output), the table path the
    kernels took and whether each kernel kept its lanes' buffers and
    counts rows in shared memory.  ``seed_len`` extends the target's
    seed with bytes made from a seed; ``n_edges`` widens the counts
    rows past the program's own edge count."""
    from killerbeez_tpu_torch.models import targets_cgc
    from killerbeez_tpu_torch.models.targets import get_target
    from killerbeez_tpu_torch.ops import prng
    prog = get_target(name)
    sb = targets_cgc.VM_SEEDS[name][0]()
    seed = torch.zeros(L, dtype=torch.uint8, device=dev)
    seed[:len(sb)] = torch.tensor(list(sb), dtype=torch.uint8)
    seed_len = seed_len or len(sb)
    seed[len(sb):seed_len] = torch.randint(
        0, 256, (seed_len - len(sb),), dtype=torch.uint8,
        generator=torch.Generator().manual_seed(MUT_SEED)).to(dev)
    ne = n_edges or prog.n_edges
    instrs = torch.as_tensor(prog.instrs, device=dev)
    table = torch.as_tensor(prog.edge_table, device=dev)
    its = torch.arange(n, dtype=torch.int64, device=dev)
    fargs = (instrs, table, seed, seed_len, prng.key(MUT_SEED, device=dev),
             its, prog.mem_size, prog.max_steps, ne, STACK_POW2)
    res, bufs, lens = vk.fuzz_batch(*fargs)
    shared = [vk.LAST_CONFIG["kbz_fuzz_kernel"]["lane_state_shared"]]
    ref, rbufs, rlens = vk.fuzz_batch_plain(*fargs)
    err = max_abs_err(list(res) + [bufs, lens], list(ref) + [rbufs, rlens])
    vargs = (instrs, table, bufs, lens, prog.mem_size, prog.max_steps, ne)
    err = max(err, max_abs_err(vk.run_batch(*vargs),
                               vk.run_batch_plain(*vargs)))
    lanes, n_lanes = vk.compact_lanes(res.steps > prog.max_steps // 8)
    err = max(err, max_abs_err(
        vk.run_batch(*vargs, lanes=lanes, n_lanes=n_lanes),
        vk.run_batch_plain(*vargs, lanes=lanes, n_lanes=n_lanes)))
    shared.append(vk.LAST_CONFIG["kbz_vm_kernel"]["lane_state_shared"])
    mode = vk.program_layout(instrs, table, ne, dev).table_mode
    return err, mode, shared


def findings(out: Path):
    return {d: sorted(os.listdir(out / d))
            for d in ("crashes", "hangs", "new_paths")}


def events(out: Path):
    with open(out / "events.jsonl") as f:
        return [json.loads(line) for line in f]


def picks(out: Path):
    return [(e["arm"], e["rotation"]) for e in events(out)
            if e["type"] == "scheduler_pick"]


def stats_counters(out: Path):
    keep = ("execs_done", "paths_total", "unique_crashes", "unique_hangs")
    rows = dict(line.split(":", 1) for line in
                (out / "fuzzer_stats").read_text().splitlines())
    return {k.strip(): v.strip() for k, v in rows.items()
            if k.strip() in keep}


def flagship(name, *args):
    """The main path's CLI run; returns (launches, execs/s, output
    dir)."""
    n_iter = FLAGSHIP_BATCHES * B
    log, out = run_cli(
        ["-b", str(B), "-n", str(n_iter), "-i",
         json.dumps({"target": "tlvstack_vm", "engine": "cuda_fused",
                     "novelty": "throughput"}), *args], name)
    m = re.search(r"kernel launches: (\{.*\})", log)
    if not m:
        raise AssertionError("the CLI printed no kernel launch counts")
    launches = json.loads(m.group(1))
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the main path "
                             f"({name}): {launches}")
    eps = re.search(r"Ran (\d+) iterations in ([0-9.]+) seconds "
                    r"\(([0-9.]+) execs/s lifetime", log)
    if not eps or int(eps.group(1)) != n_iter:
        raise AssertionError(f"the CLI did not run every iteration "
                             f"({name})")
    found = findings(out)
    if not found["new_paths"]:
        raise AssertionError(f"the flagship run found no new paths "
                             f"({name})")
    per_batch = float(eps.group(2)) / (n_iter // B) * 1e3
    print(f"main path ({name}): {n_iter} execs in {eps.group(2)} s = "
          f"{eps.group(3)} execs/s ({per_batch:.1f} ms per batch); "
          f"launches {launches}; findings: {len(found['crashes'])} "
          f"crashes, {len(found['hangs'])} hangs, "
          f"{len(found['new_paths'])} new paths", flush=True)
    return launches, float(eps.group(3)), out


def inprocess(out: Path, *args):
    """The port's CLI in this process with PIPELINE_DEPTH = 1; returns
    what the card and the CPU must agree on."""
    from killerbeez_tpu_torch.fuzzer.cli import main as cli_main
    from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
    shutil.rmtree(out, ignore_errors=True)
    depth = Fuzzer.PIPELINE_DEPTH
    Fuzzer.PIPELINE_DEPTH = 1
    try:
        rc = cli_main(cli_argv(out, "-isd", f"{out}.isd", "-msd",
                               f"{out}.msd", *args))
    finally:
        Fuzzer.PIPELINE_DEPTH = depth
    if rc != 0:
        raise RuntimeError(f"in-process CLI {out.name} exited {rc}")
    return {"findings": findings(out), "picks": picks(out),
            "isd": Path(f"{out}.isd").read_text(),
            "msd": Path(f"{out}.msd").read_text(),
            "counters": stats_counters(out)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from killerbeez_tpu_torch.models import targets_cgc
    from killerbeez_tpu_torch.models.targets import get_target
    from killerbeez_tpu_torch.ops import _build, prng, vm_kernel as vk
    from killerbeez_tpu_torch.models.vm import _run_batch_impl
    from killerbeez_tpu_torch.tools.timing import timed

    # -- phase 1: card, versions, build --------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    _build.load("vm_kernel")
    print(f"kernel build+load: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds.get('vm_kernel', 0.0):.1f} s)",
          flush=True)
    log = _build.library_path("vm_kernel").with_suffix(".log")
    if log.exists():
        # one line per kernel instance: its (mangled) name, registers
        # and spills, from nvcc's -Xptxas=-v report
        fn = spill = ""
        for line in log.read_text().splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                print(f"ptxas: {fn}: {line.split(':', 1)[1].strip()}; "
                      f"{spill}", flush=True)

    # -- phase 2: kernels vs plain at the flagship shapes --------------
    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)
    prog = get_target("tlvstack_vm")
    seed_bytes = targets_cgc.tlvstack_vm_seed()
    (OUT / "seed.bin").write_bytes(seed_bytes)
    L = 64
    seed = torch.zeros(L, dtype=torch.uint8, device=dev)
    seed[:len(seed_bytes)] = torch.tensor(list(seed_bytes),
                                          dtype=torch.uint8)
    instrs = torch.as_tensor(prog.instrs, device=dev)
    table = torch.as_tensor(prog.edge_table, device=dev)
    its = torch.arange(B, dtype=torch.int64, device=dev)
    key = prng.key(MUT_SEED, device=dev)
    ms, steps_max, ne = prog.mem_size, prog.max_steps, prog.n_edges
    p1 = vk.auto_phase1_steps(steps_max)
    common = (instrs, table, seed, len(seed_bytes), key, its, ms)

    res1, bufs, lens = vk.fuzz_batch(*common, p1, ne, STACK_POW2)
    ref1, rbufs, rlens = vk.fuzz_batch_plain(*common, p1, ne, STACK_POW2)
    err_fuzz = max_abs_err(list(res1) + [bufs, lens],
                           list(ref1) + [rbufs, rlens])
    print(f"kbz_fuzz_kernel vs plain (7 outputs, B={B}, budget {p1}): "
          f"max_abs_err {err_fuzz}; {launch_shape(vk, 'kbz_fuzz_kernel')}",
          flush=True)
    if err_fuzz:
        raise AssertionError("kbz_fuzz_kernel disagrees with its plain "
                             "version")

    full = vk.run_batch(instrs, table, bufs, lens, ms, steps_max, ne)
    full_ref = _run_batch_impl(instrs, table, bufs, lens, ms, steps_max,
                               ne)
    err_full = max_abs_err(full, full_ref)
    surv = res1.status == 3
    lanes, n_lanes = vk.compact_lanes(surv)
    part = vk.run_batch(instrs, table, bufs, lens, ms, steps_max, ne,
                        lanes=lanes, n_lanes=n_lanes)
    part_ref = vk.run_batch_plain(instrs, table, bufs, lens, ms,
                                  steps_max, ne, lanes=lanes,
                                  n_lanes=n_lanes)
    err_part = max_abs_err(part, part_ref)
    n_surv = int(n_lanes)
    print(f"kbz_vm_kernel vs plain: no lane list max_abs_err {err_full}; "
          f"lane list ({n_surv} survivors of {B}) max_abs_err {err_part}; "
          f"{launch_shape(vk, 'kbz_vm_kernel')}", flush=True)
    if err_full or err_part:
        raise AssertionError("kbz_vm_kernel disagrees with the plain VM")

    two, b2, l2 = vk.fuzz_batch_2phase(*common, steps_max, ne, STACK_POW2,
                                       phase1_steps=p1)
    one, b1, l1 = vk.fuzz_batch(*common, steps_max, ne, STACK_POW2)
    err_2p = max_abs_err(list(two) + [b2, l2], list(one) + [b1, l1])
    err_2p = max(err_2p, max_abs_err(two, full_ref))
    print(f"two-phase vs single phase: max_abs_err {err_2p}", flush=True)
    if err_2p:
        raise AssertionError("two-phase glue disagrees with one phase")
    # the kernels' other table path: fixedform_vm's 343 x 342 edge table
    # does not fit shared memory, so it is read from device memory
    err_ff, mode_ff, _ = check_program(vk, "fixedform_vm", dev, 4096, 128)
    print(f"fixedform_vm (4096 lanes, edge table mode {mode_ff}: "
          f"{'device memory' if mode_ff == vk.TABLE_DEVICE else 'shared'}"
          f"): both kernels vs plain max_abs_err {err_ff}", flush=True)
    if err_ff or mode_ff != vk.TABLE_DEVICE:
        raise AssertionError("the device-memory table path failed")
    # the kernels' device-memory lane state: buffers of a 2 KB seed at
    # ratio 2, and counts rows of 8000 edges, do not fit shared memory
    for label, L_big, seed_len, n_edges in (
            ("L = 4096, a 2048-byte seed", 4096, 2048, None),
            ("8000 edges", 64, None, 8000)):
        err_st, _, shared = check_program(vk, "tlvstack_vm", dev, 4096,
                                          L_big, seed_len, n_edges)
        print(f"tlvstack_vm ({label}, 4096 lanes, lane state in shared "
              f"memory: fuzz {shared[0]}, vm {shared[1]}): both kernels "
              f"vs plain max_abs_err {err_st}", flush=True)
        if err_st or any(shared):
            raise AssertionError(f"the device-memory lane state path "
                                 f"failed ({label})")

    t_fuzz = timed(lambda: vk.fuzz_batch(*common, p1, ne, STACK_POW2), 7)
    t_fuzz_plain = timed(lambda: vk.fuzz_batch_plain(
        *common, p1, ne, STACK_POW2), 3)
    t_vm_list = timed(lambda: vk.run_batch(
        instrs, table, bufs, lens, ms, steps_max, ne, lanes=lanes,
        n_lanes=n_lanes), 7)
    t_vm_list_plain = timed(lambda: vk.run_batch_plain(
        instrs, table, bufs, lens, ms, steps_max, ne, lanes=lanes,
        n_lanes=n_lanes), 3)
    t_vm_all = timed(lambda: vk.run_batch(instrs, table, bufs, lens, ms,
                                          steps_max, ne), 7)
    t_vm_all_plain = timed(lambda: _run_batch_impl(
        instrs, table, bufs, lens, ms, steps_max, ne), 3)
    t_2p = timed(lambda: vk.fuzz_batch_2phase(
        *common, steps_max, ne, STACK_POW2, phase1_steps=p1), 7)
    t_1p = timed(lambda: vk.fuzz_batch(*common, steps_max, ne,
                                       STACK_POW2), 7)
    print(f"times [ms, median, {card}]: fuzz {t_fuzz:.3f} (plain "
          f"{t_fuzz_plain:.1f}); vm lane list {t_vm_list:.3f} (plain "
          f"{t_vm_list_plain:.1f}); vm all lanes {t_vm_all:.3f} (plain "
          f"{t_vm_all_plain:.1f}); two-phase batch {t_2p:.3f}, single "
          f"phase {t_1p:.3f}", flush=True)

    # bounds from this run's data (the words only count the edits)
    words = vk.havoc_words_for_keys(prng.fold_in(key, its), STACK_POW2)
    table_bytes = instrs.numel() * 4 + table.numel() * 4
    out_bytes = B * (4 * 4 + 8 + (ne + 1) + L)
    edits, hashes, edit_ops = havoc_ops(words, STACK_POW2, L)
    del words
    ops_fuzz, ops_vm, ops_all = vm_ops(res1) + edit_ops, vm_ops(part), \
        vm_ops(full)
    b_fuzz, by_fuzz = bound(B * 8 + 16 + L + table_bytes + out_bytes,
                            ops_fuzz)
    list_bytes = (n_surv * (L + 4 + 4) + table_bytes
                  + n_surv * (3 * 4 + 8 + (ne + 1)))
    b_vm, by_vm = bound(list_bytes, ops_vm)
    b_all, by_all = bound(B * (L + 4) + table_bytes
                          + B * (3 * 4 + 8 + (ne + 1)), ops_all)
    print(f"bounds [ms]: fuzz {b_fuzz:.4f} ({by_fuzz}), vm lane list "
          f"{b_vm:.4f} ({by_vm}), vm all lanes {b_all:.4f} ({by_all}); "
          f"operations: fuzz {ops_fuzz} (havoc {edit_ops} over {edits} "
          f"edits and {hashes} threefry hashes), vm lane list {ops_vm}, "
          f"vm all lanes {ops_all}; "
          f"executed VM steps: phase 1 {int(res1.steps.sum())}, phase 2 "
          f"{int(part.steps.sum())}", flush=True)

    # where a flagship batch's device time goes, stage by stage
    from killerbeez_tpu_torch.instrumentation import jit_harness as jh
    from killerbeez_tpu_torch.instrumentation.base import pack_verdicts
    from killerbeez_tpu_torch.ops.static_triage import make_static_maps
    u_slots, seg_id = (torch.as_tensor(a, device=dev)
                       for a in make_static_maps(prog.edge_slot))
    virgin = torch.full((prog.map_size,), 0xFF, dtype=torch.uint8,
                        device=dev)
    statuses = torch.where(two.status == 3, 1, two.status).to(torch.int32)
    tri = jh._triage_counts(two.counts, statuses, u_slots, seg_id, virgin,
                            virgin, virgin, False)
    stages = {
        "phase1": t_fuzz,
        "phase2": timed(lambda: vk.run_batch(
            instrs, table, bufs, lens, ms, steps_max, ne,
            *vk.compact_lanes(res1.status == 3)), 5),
        "triage": timed(lambda: jh._triage_counts(
            two.counts, statuses, u_slots, seg_id, virgin, virgin, virgin,
            False), 5),
        "pack+compact": timed(lambda: (
            pack_verdicts(statuses, tri[0], tri[1], tri[2]),
            jh._compact(statuses, tri[0], b2, l2)), 5),
    }
    print("stage breakdown [ms per 65536-lane batch, median, "
          f"{card}]: " + ", ".join(f"{k} {v:.3f}"
                                   for k, v in stages.items())
          + f"; device total {sum(stages.values()):.3f}", flush=True)

    # -- phase 3: the main path, the port's CLI on the card ------------
    # the default campaign (corpus feedback, stats files, events) and
    # the same command without feedback, in turns: default, -fb 0,
    # -fb 0, default; the first run's launch counts are the main path's
    eps = {"default": [], "fb0": []}
    launches = None
    for mode, name in (("default", "flagship"), ("fb0", "flagship_fb0"),
                       ("fb0", "flagship_fb0_2"), ("default", "flagship_2")):
        got, rate, out = flagship(name, *(["-fb", "0"] if mode == "fb0"
                                          else []))
        launches = launches or got
        eps[mode].append(rate)
        if mode == "fb0":
            continue
        if not (out / "fuzzer_stats").exists():
            raise AssertionError("the default campaign wrote no "
                                 "fuzzer_stats")
        arms = [arm for arm, _ in picks(out) if arm != "base"]
        if not arms:
            raise AssertionError("the default campaign never fuzzed an "
                                 "admitted arm (every scheduler_pick was "
                                 "the base seed, or none came)")
        print(f"default campaign ({name}): {len(picks(out))} rotations, "
              f"{len(arms)} onto admitted arms", flush=True)
    print(f"main path execs/s on {card}: default -fb (8) "
          f"{', '.join(f'{r:.0f}' for r in eps['default'])}; -fb 0 "
          f"{', '.join(f'{r:.0f}' for r in eps['fb0'])} (in turns: "
          "default, -fb 0, -fb 0, default)", flush=True)

    # -- phase 4: the card's findings and state against the CPU ---------
    # 12288 = one K = 8 superbatch of 1024 lanes, then four single
    # batches; throughput novelty is the flagship's, exact the parity
    # mode that 1024-lane batches default to
    small = ["-b", "1024", "-n", "12288", "-fb", "0"]
    for novelty in ("throughput", "exact"):
        iopts = {"target": "tlvstack_vm", "novelty": novelty}
        states = {}
        outs = {}
        for dev, engine, extra in (("cuda", "cuda_fused", []),
                                   ("cpu", "torch", ["--device", "cpu"])):
            states[dev] = OUT / f"{novelty}_{dev}.state"
            _, outs[dev] = run_cli(
                small + extra + ["-i", json.dumps({**iopts,
                                                   "engine": engine}),
                                 "-isd", str(states[dev])],
                f"parity_{novelty}_{dev}")
        if findings(outs["cuda"]) != findings(outs["cpu"]):
            raise AssertionError(f"card and CPU findings differ "
                                 f"({novelty} novelty)")
        if states["cuda"].read_text() != states["cpu"].read_text():
            raise AssertionError(f"card and CPU virgin-map states differ "
                                 f"({novelty} novelty)")
        print(f"parity ({novelty} novelty): card == CPU "
              f"({len(findings(outs['cuda'])['new_paths'])} new paths, "
              "equal -isd states)", flush=True)
    # the default -fb: 25 batches of 1024 lanes, rotations after 8, 16
    # and 24 batches (the third picks an admitted arm)
    for novelty in ("throughput", "exact"):
        iopts = {"target": "tlvstack_vm", "novelty": novelty}
        got = {}
        for dev, engine in (("cuda", "cuda_fused"), ("cpu", "torch")):
            got[dev] = inprocess(
                OUT / f"fb_{novelty}_{dev}", "-b", "1024", "-n", "25600",
                "--device", dev, "-i",
                json.dumps({**iopts, "engine": engine}))
        if got["cuda"] != got["cpu"]:
            diff = [k for k in got["cuda"] if got["cuda"][k] != got["cpu"][k]]
            raise AssertionError(f"card and CPU differ at the default -fb "
                                 f"({novelty} novelty): {diff}")
        if not any(arm != "base" for arm, _ in got["cuda"]["picks"]):
            raise AssertionError("no rotation picked an admitted arm")
        print(f"parity at the default -fb ({novelty} novelty, "
              f"PIPELINE_DEPTH 1): card == CPU "
              f"({len(got['cuda']['findings']['new_paths'])} new paths, "
              f"picks {got['cuda']['picks']}, equal -isd, -msd and "
              f"fuzzer_stats counters)", flush=True)

    # -- phase 5: the record -------------------------------------------
    kernels = [
        {"name": "kbz_fuzz_kernel", "route": "cuda", "source": SOURCE,
         "replaces": f"{REF}:566", "launches": launches["kbz_fuzz_kernel"],
         "max_abs_err": err_fuzz, "ms": t_fuzz, "plain_ms": t_fuzz_plain,
         "bound_ms": b_fuzz, "bound_by": by_fuzz, "library_ms": None},
        {"name": "kbz_vm_kernel", "route": "cuda", "source": SOURCE,
         "replaces": f"{REF}:311", "launches": launches["kbz_vm_kernel"],
         "max_abs_err": max(err_part, err_full), "ms": t_vm_list,
         "plain_ms": t_vm_list_plain, "bound_ms": b_vm, "bound_by": by_vm,
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
