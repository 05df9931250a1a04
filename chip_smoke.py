"""Chip smoke test of the PyTorch/CUDA port (killerbeez_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``killerbeez_tpu_torch/csrc`` and:

  1. prints the card (``nvidia-smi``: name, power limit), the torch and
     CUDA versions and the kernel build time;
  2. at the flagship shapes (target tlvstack_vm, B = 65536 lanes,
     L = 64, havoc stack_pow2 4) holds ``kbz_fuzz_kernel`` (at the
     phase-1 budget the main path gives it; it draws each lane's havoc
     words from the base key and the lane's iteration number, and
     reads its seed from a ring on the card: the one-slot ring of the
     host-driven loop, slot 3 of eight random rows shorter than L, and
     slot 7 of a 32-slot ring, the -G shape) against its plain PyTorch
     version on all seven outputs, ``kbz_vm_kernel``
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
  3. drives the main path: the port's CLI (its ``main``, in this
     process, as every CLI run of this script), ``file
     jit_harness havoc -b 65536 -n 6291456`` with engine cuda_fused
     (twelve superbatches of 8 x 65536 lanes) and no ``-fb`` flag, the
     default campaign: corpus feedback every 8 batches with the bandit
     scheduler, stats files and the event log; requires exit 0, launch
     counts > 0 for both kernels (the CLI prints them; every count is
     set to 0 just before a CLI run), findings in new_paths/,
     ``fuzzer_stats`` and a
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
  5. the device-resident generation loop (``-G``): (a) in this
     process, ``run_batch_generations`` on the card against the CPU's
     plain path on tlvstack_vm (1000 lanes padded to 1024, two
     dispatches of G = 4, reseeding on and off, both novelties): every
     outcome field, the final ring and the virgin maps equal; (b) the
     CLI at ``-G 4 -b 1024 -n 32768``, card against CPU, at the
     default ``-fb`` and at ``-fb 0`` (md5 sets, ``-isd``,
     ``ring_admit`` sequences, ``fuzzer_stats`` counters; the default
     run must admit ring slots), and on the card ``-G 4 -fb 0``
     against the host-driven ``-fb 0`` loop; (c) the flagship at
     ``-G 16`` (six dispatches, default ``-fb``) and the host-driven
     ``-fb 0`` flagship in turns (-G, host, host, -G): exit 0, both
     kernels launched, findings, ``generations_per_dispatch`` 16 in
     ``stats.jsonl``, ring admissions, the four execs/s; (d) device ms
     per generation by stage at the flagship shape (slot pick, phase
     1, phase 2, triage, packing, ring append) and the device's idle
     share over one ``-G 16`` dispatch;
  6. the mesh (``--mesh dp,mp``, parallel/): (a) in this process, a
     dp = 4, mp = 2 mesh on ``["cuda:0"] * 8`` (engines cuda and
     cuda_fused) against ``["cpu"] * 8`` (the plain path) on cgc_like
     with 64 lanes per shard and L = 32: three steps, a K = 8
     superbatch and -G 4 dispatches folding every 1 and 2 generations,
     reseeding on and off — every output, compact report, ring and
     virgin map equal; (b) the CLI at ``--mesh 1,1 -b 1024``, card
     against CPU, host-driven at ``-n 12288 -fb 0`` and at ``-G 4 -n
     32768`` with the default ``-fb`` (md5 sets, ``-isd``, ring
     admissions, counters), and ``--device cpu --mesh 4,2`` once; (c)
     the flagship at ``--mesh 1,1 -b 65536`` (cuda_fused, default
     ``-fb``), host-driven and at ``-G 16``, in turns with the
     host-driven single-device ``-fb 0`` flagship (exit 0, findings,
     ``kbz_fuzz_kernel`` launches, ``mesh_dp`` in ``stats.jsonl``,
     each execs/s), and one short run with engine cuda, which must
     launch ``kbz_vm_kernel`` over all lanes; (d) device ms per mesh
     step by stage (mutate+execute, triage, fold, compaction) at
     --mesh 1,1 x 65536 lanes and at 4,2 x 16384 lanes per shard on
     one card;
  7. the trace surface: (a) the stream-recording engine (the plain
     torch engine; no kernel records the stream) on CUDA tensors
     against the CPU, all six VMResult fields at 4096 lanes on
     tlvstack_vm and fixedform_vm, and its time on one 65536-lane
     batch; (b) ``file ipt havoc -b 65536``, unfiltered (kbz_vm_kernel
     over every lane, 16 batches) and with a block-id filter (the
     stream engine, 4 batches), with their execs/s, then card == CPU
     at ``-b 1024`` at the default ``-fb`` with ``PIPELINE_DEPTH = 1``
     (md5 sets, the ``ipt`` state's hash sets, picks, counters); (c)
     ``{"edges": 1}`` with cuda_fused: ``get_edges``,
     ``get_edge_pairs`` and ``last_trace`` after each of four 1024-lane
     batches and the state card == CPU, the CLI at ``-b 1024`` card ==
     CPU, and the 65536-lane flagship with and without edges in turns
     (48 batches each); (d) ``--schedule rare-edge`` at the default
     ``-fb``: card == CPU at ``-b 1024`` (md5 sets, the corpus
     sidecars' ``sig``, picks, states, counters), the 65536-lane
     flagship in turns with ``--schedule bandit`` (48 batches each;
     the rare-edge run must launch kbz_vm_kernel over all lanes: one
     1-lane signing per admission), and the signer's host ms per
     admission; (e) tracer (slots and pairs) and showmap on the seed,
     card == CPU files;
  8. every mutator but grammar, each feeding ``kbz_vm_kernel`` over
     every lane through the unfused ``cuda`` engine: (a) each mutator's
     ``mutate_batch`` on CUDA tensors against the CPU at the flagship
     shape (65536 lanes or a finite walk's whole length; afl across
     every stage boundary into havoc; manager with bit_flip and havoc
     children), bytes and lengths equal; (b) the CLI at ``-b 1024``,
     card (engine cuda) against CPU (engine torch) in this process with
     ``PIPELINE_DEPTH = 1``: every finite walk run to its end, the
     randomized ones at ``-fb 0`` and at the default ``-fb``, radamsa
     through a stand-in binary (md5 sets, ``-isd``, ``-msd``, picks,
     counters); (c) ``afl``, ``zzuf`` and ``honggfuzz`` at ``-b 65536``
     (48 batches each, default ``-fb``) in turns with the havoc
     ``cuda_fused`` flagship — exit 0, findings, ``kbz_vm_kernel_all``
     launches — with each run's execs/s beside the card's name and
     power limit; (d) device ms per 65536-lane batch by stage: each
     mutator's candidates, ``kbz_vm_kernel`` over every lane, triage;
  10. (run before the record) the host-execution tier, which launches
     no kernel: it builds ``native/`` and the corpus fixtures ``test``,
     ``test-plain``, ``hang`` and ``network_server`` with make into
     ``build/torch_native/``; (a) card == CPU through ``cli.main`` at
     ``PIPELINE_DEPTH = 1``: ``file return_code bit_flip -n 32 -ss
     'ABC@'`` (the crash) and ``stdin afl honggfuzz`` from 'Azzz' at
     ``-b 64`` (two new paths, a rotation); (b) afl's batch triage of
     4096 real host bitmaps with ``device_triage`` 1 on the card ==
     the same torch path on the CPU == the numpy path (rets, uc, uh,
     three maps), each timed; (c) ``stdin afl havoc -b 4096`` execs/s
     with ``device_triage`` 0 and 1 and ``workers`` 8 and 1 in turns,
     with the share of each run spent waiting for the candidates' host
     copies; (d) ``-dt`` card == CPU (``.info`` text) and one ``ipt``
     ``qemu_mode`` batch on the card;
  9. prints one ``{"kernels": [...]}`` line (launches: the first
     host-driven, the first ``-G 16``, the first mesh, the first edges
     and the first rare-edge flagship runs together; the all-lanes
     ``kbz_vm_kernel`` row from the mesh's cuda-engine run, the
     unfiltered ``ipt`` run, the rare-edge run's signer and phase 8c's
     afl, zzuf and honggfuzz runs), then the card line, then the result
     line ``{"ok": true, "device": {...}}`` last.  Each phase's wall
     time is printed as it ends.

Any failure raises: the script exits non-zero and prints no result.
Every CLI run goes through the CLI's ``main`` in this process, so a
run pays no interpreter start and no kernel load of its own.
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

import contextlib
import gc
import io
import json
import os
import re
import shutil
import statistics
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
#: the mesh flagship's run length (--mesh 1,1, phase 6c)
MESH_BATCHES = 48
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
        if a is None and b is None:     # a VMResult without a stream
            continue
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


def cli_argv(out, *args, instr="jit_harness", mutator="havoc",
             mopts=None, seed=None):
    """The CLI's arguments: ``mutator`` with options ``mopts`` (default
    ``{"seed": MUT_SEED}``) on seed file ``seed`` (default the
    flagship's)."""
    return ["file", instr, mutator, "-sf", str(seed or OUT / "seed.bin"),
            "-m", json.dumps({"seed": MUT_SEED} if mopts is None
                             else mopts),
            "-o", str(out), "-l", '{"level": 1}', *args]


#: kernel launches of every CLI run of this script, by kernel
CLI_LAUNCHES: dict = {}


def run_cli(args, name, instr="jit_harness", **mut):
    """Run the port's CLI through its ``main`` in this process (``mut``:
    cli_argv's mutator, mopts, seed) with every kernel launch count set
    to 0 just before; returns (its log, output dir).  Its launches add
    to CLI_LAUNCHES, and after it to this process's counts again."""
    from killerbeez_tpu_torch.fuzzer.cli import main as cli_main
    from killerbeez_tpu_torch.ops.vm_kernel import LAUNCHES
    out = OUT / name
    shutil.rmtree(out, ignore_errors=True)
    before = dict(LAUNCHES)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(log):
            rc = cli_main(cli_argv(out, *args, instr=instr, **mut))
    finally:
        run = dict(LAUNCHES)
        for k in LAUNCHES:
            LAUNCHES[k] = before.get(k, 0) + run[k]
        gc.collect()
    wall = time.perf_counter() - t0
    log = log.getvalue()
    (OUT / f"{name}.log").write_text(log)
    if rc != 0:
        raise RuntimeError(f"CLI {name} exited {rc}:\n{log[-3000:]}")
    print(f"cli {name}: exit 0 in {wall:.1f} s wall", flush=True)
    for k, v in run.items():
        CLI_LAUNCHES[k] = CLI_LAUNCHES.get(k, 0) + v
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
    fargs = (instrs, table, *vk.seed_ring(seed, seed_len),
             prng.key(MUT_SEED, device=dev), its, prog.mem_size,
             prog.max_steps, ne, STACK_POW2)
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


def flagship(name, *args, batches=FLAGSHIP_BATCHES, engine="cuda_fused",
             need=("kbz_fuzz_kernel", "kbz_vm_kernel"), instr="jit_harness",
             iopts=None, **mut):
    """The main path's CLI run; ``need`` names the kernels it must
    launch; ``iopts`` replaces the flagship's instrumentation options;
    ``mut`` picks another mutator (cli_argv).  Returns (launches,
    execs/s, output dir)."""
    n_iter = batches * B
    if iopts is None:
        iopts = {"target": "tlvstack_vm", "engine": engine,
                 "novelty": "throughput"}
    log, out = run_cli(
        ["-b", str(B), "-n", str(n_iter), "-i", json.dumps(iopts), *args],
        name, instr=instr, **mut)
    m = re.search(r"kernel launches: (\{.*\})", log)
    if not m:
        raise AssertionError("the CLI printed no kernel launch counts")
    launches = json.loads(m.group(1))
    if need and min(launches[k] for k in need) <= 0:
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


def inprocess(out: Path, *args, instr="jit_harness", **mut):
    """The port's CLI in this process with PIPELINE_DEPTH = 1 (``mut``:
    cli_argv's mutator, mopts, seed); returns what the card and the CPU
    must agree on."""
    from killerbeez_tpu_torch.fuzzer.cli import main as cli_main
    from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
    shutil.rmtree(out, ignore_errors=True)
    depth = Fuzzer.PIPELINE_DEPTH
    Fuzzer.PIPELINE_DEPTH = 1
    try:
        rc = cli_main(cli_argv(out, "-isd", f"{out}.isd", "-msd",
                               f"{out}.msd", *args, instr=instr, **mut))
    finally:
        Fuzzer.PIPELINE_DEPTH = depth
    if rc != 0:
        raise RuntimeError(f"in-process CLI {out.name} exited {rc}")
    return {"findings": findings(out), "picks": picks(out),
            "isd": Path(f"{out}.isd").read_text(),
            "msd": Path(f"{out}.msd").read_text(),
            "counters": stats_counters(out)}


# -- the generation loop (-G) ------------------------------------------

GEN_IOPTS = {"target": "tlvstack_vm", "novelty": "throughput"}
MAPS = ("virgin_bits", "virgin_crash", "virgin_tmout")


def ring_admits(out: Path):
    return [(e["md5"], e["slot"], e["gen"], e["parent"])
            for e in events(out) if e["type"] == "ring_admit"]


def ring_case(vk, instrs, table, key, its, ms, steps, ne, dev, L,
              seed=None, seed_len=0, sel=3, slots=8):
    """The fused kernel's ring form: ``slots`` rows of random bytes with
    random lengths below L, the seed (if given) in row ``sel``.
    Returns (the kernel's outputs against its plain version's max abs
    error, the kernel's arguments)."""
    gen = torch.Generator().manual_seed(MUT_SEED + sel)
    ring = torch.randint(0, 256, (slots, L), dtype=torch.uint8,
                         generator=gen).to(dev)
    lens = torch.randint(1, L, (slots,), dtype=torch.int32,
                         generator=gen).to(dev)
    if seed is not None:
        ring[sel] = seed
        lens[sel] = seed_len
    args = (instrs, table, ring, lens,
            torch.tensor(sel, dtype=torch.int32, device=dev), key, its, ms,
            steps, ne, STACK_POW2)
    got = vk.fuzz_batch(*args)
    ref = vk.fuzz_batch_plain(*args)
    return max_abs_err(list(got[0]) + list(got[1:]),
                       list(ref[0]) + list(ref[1:])), args


def gen_dispatch_parity():
    """``run_batch_generations`` on the card (cuda_fused) against the
    CPU's plain path on tlvstack_vm: 1000 lanes padded to 1024, two
    dispatches of G = 4, reseeding on and off, both novelties; every
    outcome field, the final ring and the virgin maps must be equal
    (tolerance: none)."""
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.models.targets_cgc import tlvstack_vm_seed
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator
    admitted = 0
    for reseed in (True, False):
        for novelty in ("throughput", "exact"):
            got = {}
            for dev, engine in (("cuda", "cuda_fused"), ("cpu", "torch")):
                instr = JitHarnessInstrumentation(json.dumps(
                    {**GEN_IOPTS, "novelty": novelty, "engine": engine}),
                    device=dev)
                mut = HavocMutator(json.dumps({"seed": MUT_SEED}),
                                   tlvstack_vm_seed(), device=dev)
                outs = []
                for _ in range(2):
                    out = instr.run_batch_generations(
                        mut, mut.peek_iterations(1000), 4, pad_to=1024,
                        reseed=reseed)
                    mut.advance(4000)
                    outs.append(out.materialize())
                got[dev] = (outs, [t.cpu() for t in instr._gen_ring.view()],
                            [getattr(instr, m).cpu() for m in MAPS])
            (c_outs, c_ring, c_maps), (p_outs, p_ring, p_maps) = \
                got["cuda"], got["cpu"]
            for co, po in zip(c_outs, p_outs):
                for f in co._fields:
                    a, b = getattr(co, f), getattr(po, f)
                    if not (a == b if isinstance(a, int)
                            else (a.shape == b.shape and (a == b).all())):
                        raise AssertionError(
                            f"-G dispatch: card and CPU differ in {f} "
                            f"(reseed {reseed}, {novelty})")
            for name, a, b in zip(("ring",) * 6 + MAPS, c_ring + c_maps,
                                  p_ring + p_maps):
                if not torch.equal(a, b):
                    raise AssertionError(f"-G dispatch: card and CPU "
                                         f"differ in the final {name}")
            filled = int(c_outs[-1].ring_filled.sum())
            admitted = max(admitted, filled - 1)
            print(f"-G dispatch parity (reseed {reseed}, {novelty}): card "
                  f"== CPU over 2 x 4 generations (findings ring "
                  f"{int(c_outs[-1].fr_ptr)} rows, ring filled {filled})",
                  flush=True)
    if not admitted:
        raise AssertionError("-G dispatch parity: the ring never admitted")


def gen_cli_parity():
    """The port's CLI at -G 4 -b 1024 -n 32768: cuda_fused on the card
    against torch on the CPU at the default -fb (ring reseeding on) and
    at -fb 0; and on the card -G 4 -fb 0 against the host-driven -fb 0
    loop (the determinism contract)."""
    small = ["-b", "1024", "-n", "32768"]
    got = {}
    for mode, extra in (("default", ["-G", "4"]),
                        ("fb0", ["-G", "4", "-fb", "0"]),
                        ("host_fb0", ["-fb", "0"])):
        for dev, engine in (("cuda", "cuda_fused"), ("cpu", "torch")):
            if mode == "host_fb0" and dev == "cpu":
                continue
            name = f"gen_{mode}_{dev}"
            state = OUT / f"{name}.isd"
            _, out = run_cli(small + extra + [
                "--device", dev, "-isd", str(state), "-i",
                json.dumps({**GEN_IOPTS, "engine": engine})], name)
            got[(mode, dev)] = {"findings": findings(out),
                                "isd": state.read_text(),
                                "admits": ring_admits(out),
                                "counters": stats_counters(out)}
    for mode in ("default", "fb0"):
        if got[(mode, "cuda")] != got[(mode, "cpu")]:
            c, p = got[(mode, "cuda")], got[(mode, "cpu")]
            raise AssertionError(f"-G 4 ({mode}): card and CPU differ in "
                                 f"{[k for k in c if c[k] != p[k]]}")
    admits = got[("default", "cuda")]["admits"]
    if not admits or min(slot for _, slot, _, _ in admits) < 1:
        raise AssertionError("-G 4 at the default -fb admitted no ring "
                             "slot >= 1")
    host, gen = got[("host_fb0", "cuda")], got[("fb0", "cuda")]
    for k in ("findings", "isd", "counters"):
        if host[k] != gen[k]:
            raise AssertionError(f"-G 4 -fb 0 differs from the host-driven "
                                 f"-fb 0 loop in {k}")
    print(f"-G CLI parity: card == CPU at the default -fb "
          f"({len(admits)} ring admissions, "
          f"{len(got[('default', 'cuda')]['findings']['new_paths'])} new "
          f"paths) and at -fb 0; on the card -G 4 -fb 0 == the host-driven "
          f"-fb 0 loop ({len(gen['findings']['new_paths'])} new paths)",
          flush=True)


def gen_flagship(name):
    """The flagship at -G 16 and the default -fb; checks the gauge and
    the ring admissions.  Returns flagship()'s (launches, execs/s)."""
    launches, rate, out = flagship(name, "-G", "16")
    gauges = [json.loads(line).get("gauges", {}) for line in
              (out / "stats.jsonl").read_text().splitlines()
              if line.strip()]
    if not any(g.get("generations_per_dispatch") == 16 for g in gauges):
        raise AssertionError(f"{name}: no generations_per_dispatch 16 in "
                             "stats.jsonl")
    admits = ring_admits(out)
    if not admits:
        raise AssertionError(f"{name}: no ring_admit event")
    print(f"{name}: {len(admits)} ring admissions", flush=True)
    return launches, rate


def gen_stages(card):
    """Device ms per generation by stage at the flagship shape (65536
    lanes, a ring filled by one warm-up -G 16 dispatch), and the device's
    idle share over one -G 16 dispatch: 1 - 16 x (the stages' device
    time) / (the time between CUDA events recorded before and after the
    dispatch is enqueued)."""
    from killerbeez_tpu_torch.instrumentation import jit_harness as jh
    from killerbeez_tpu_torch.instrumentation.base import pack_verdicts
    from killerbeez_tpu_torch.models.targets_cgc import tlvstack_vm_seed
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator
    from killerbeez_tpu_torch.ops import generations as gn
    from killerbeez_tpu_torch.ops import vm_kernel as vk
    from killerbeez_tpu_torch.tools.timing import timed
    instr = jh.JitHarnessInstrumentation(json.dumps(
        {**GEN_IOPTS, "engine": "cuda_fused"}))
    mut = HavocMutator(json.dumps({"seed": MUT_SEED}), tlvstack_vm_seed())
    g = 16

    def dispatch():
        out = instr.run_batch_generations(mut, mut.peek_iterations(B), g,
                                          pad_to=B)
        mut.advance(g * B)
        return out

    dispatch().materialize()          # warm-up: the ring fills
    torch.cuda.synchronize()
    walls, hosts = [], []
    for _ in range(3):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        t0 = time.perf_counter()
        out = dispatch()
        hosts.append((time.perf_counter() - t0) * 1e3)
        e1.record()
        e1.synchronize()
        walls.append(e0.elapsed_time(e1))
        out.materialize()
    ring = instr._gen_ring
    ring = ring._replace(**{f: getattr(ring, f).clone()
                            for f in ring._fields})
    p = instr.program
    key = mut.fused_spec()[2]
    its = instr._its(mut.peek_iterations(B))
    gid, salt = instr._gen_count, MUT_SEED
    sel = gn._select_slot(ring.filled[:ring.slots], gid, salt)
    args = (instr._instrs, instr._edge_table, ring.bufs, ring.lens, sel,
            key, its, p.mem_size)
    p1 = instr.phase1_steps
    res1, bufs, lens = vk.fuzz_batch(*args, p1, p.n_edges, STACK_POW2)
    res, _, _ = vk.fuzz_batch_2phase(*args, p.max_steps, p.n_edges,
                                     STACK_POW2, phase1_steps=p1)
    vb, vc, vh = instr.virgin_bits, instr.virgin_crash, instr.virgin_tmout
    tri = jh._judge(res, instr._u_slots, instr._seg_id, vb, vc, vh, False)
    statuses, new_paths, uc, uh = tri[:4]
    real = torch.ones(B, dtype=torch.bool, device=its.device)

    def flags():
        packed = pack_verdicts(statuses, new_paths, uc, uh)
        return (packed, ((statuses != 0) | (new_paths > 0)) & real,
                (new_paths == 2) & real)

    packed, fl, afl = flags()
    F = gn.gen_ring_caps(8, 0, B, ring.slots)[1]
    fr = [torch.zeros(F + 1, dtype=dt, device=its.device) for dt in
          (torch.uint8, torch.int32, torch.int64, torch.int32)] + [
        torch.zeros((F + 1, bufs.shape[1]), dtype=torch.uint8,
                    device=its.device),
        torch.zeros((), dtype=torch.int32, device=its.device)]
    stages = {
        "select_slot": timed(lambda: gn._select_slot(
            ring.filled[:ring.slots], gid, salt), 5),
        "phase1": timed(lambda: vk.fuzz_batch(*args, p1, p.n_edges,
                                              STACK_POW2), 5),
        "phase2": timed(lambda: vk.run_batch(
            instr._instrs, instr._edge_table, bufs, lens, p.mem_size,
            p.max_steps, p.n_edges, *vk.compact_lanes(res1.status == 3)),
            5),
        "triage": timed(lambda: jh._judge(res, instr._u_slots,
                                          instr._seg_id, vb, vc, vh,
                                          False), 5),
        "pack+flags": timed(flags, 5),
        "ring append": timed(lambda: gn._ring_append_and_admit(
            fl, afl, packed, its, bufs, lens, gid, sel, ring, fr, 8, True),
            5),
    }
    per_gen = sum(stages.values())
    wall = statistics.median(walls)
    idle = 1.0 - g * per_gen / wall
    print(f"-G stage breakdown [ms per generation of {B} lanes, median, "
          f"{card}]: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; device total {per_gen:.3f}", flush=True)
    print(f"-G 16 dispatch [{card}]: event span {wall:.3f} ms (runs "
          f"{', '.join(f'{w:.3f}' for w in walls)}), host enqueue "
          f"{statistics.median(hosts):.3f} ms, stages x 16 "
          f"{g * per_gen:.3f} ms, device idle share {idle:.3f}", flush=True)
    return stages, wall, idle


# -- the mesh (--mesh dp,mp) -------------------------------------------

MESH_SEED = b"CG\x02\x04\x05\x41xx"   # cgc_like's seed


def mesh_run(devices, engine):
    """A dp = 4, mp = 2 mesh on ``devices`` (cgc_like, 64 lanes per
    shard, L = 32): three steps (the third past 2**32), a K = 8
    superbatch, then -G 4 dispatches folding every 1 and every 2
    generations with reseeding on and off.  Returns {label: outputs as
    CPU tensors}."""
    from killerbeez_tpu_torch.models.targets import get_target
    from killerbeez_tpu_torch.parallel import (
        make_mesh, make_sharded_fuzz_step, make_sharded_generations,
        sharded_gen_ring_init, sharded_state_init,
    )
    prog = get_target("cgc_like")
    mesh = make_mesh(4, 2, devices)
    bpd, L = 64, 32
    seed = torch.zeros(L, dtype=torch.uint8)
    seed[:len(MESH_SEED)] = torch.tensor(list(MESH_SEED), dtype=torch.uint8)
    seed = seed.to(mesh.devices[0][0])
    step = make_sharded_fuzz_step(prog, mesh, bpd, L, engine=engine,
                                  seed=MUT_SEED)
    st = sharded_state_init(mesh, prog.map_size)

    def maps():
        return [st.full_map(m) for m in MAPS]
    out = {}
    for i, base in enumerate((0, 256, (1 << 32) + 512)):
        st, *r = step(st, seed, len(MESH_SEED), base)
        out[f"step {i}"] = r[:7] + list(r[7]) + maps()
    st, *r = step.multi(st, seed, len(MESH_SEED), 1024, 8)
    out["superbatch"] = r[:3] + list(r[3]) + maps()
    dispatch = make_sharded_generations(
        prog, mesh, bpd, L, engine=engine, seed=MUT_SEED, salt=MUT_SEED,
        adm_cap=7, findings_cap=64)
    # the generations start from fresh maps, so the rings admit
    st = sharded_state_init(mesh, prog.map_size)
    ring = sharded_gen_ring_init(mesh, seed, len(MESH_SEED), 8, L)
    gen0 = 0
    for fold in (1, 2):
        for reseed in (True, False):
            st, ring, rep = dispatch(st, ring, 4096 + gen0 * 256, gen0, 4,
                                     reseed=reseed, fold_every=fold)
            out[f"-G 4 fold {fold} reseed {reseed}"] = list(rep) + [
                ring.field(f) for f in ("bufs", "lens", "filled", "hits",
                                        "finds", "ptr")] + maps()
            gen0 += 4
    return {k: [t.cpu() for t in v] for k, v in out.items()}


def mesh_parity():
    """Phase 6a: the dp = 4, mp = 2 mesh on one card (engines cuda and
    cuda_fused) against the plain path on eight CPU shards; every
    output equal (tolerance: none).  Returns the card runs' launches."""
    from killerbeez_tpu_torch.ops import vm_kernel as vk
    ref = mesh_run(["cpu"] * 8, "torch")
    before = dict(vk.LAUNCHES)
    for engine in ("cuda", "cuda_fused"):
        got = mesh_run(["cuda:0"] * 8, engine)
        for label, outs in got.items():
            for i, (a, b) in enumerate(zip(outs, ref[label])):
                if a.shape != b.shape or not torch.equal(
                        a.to(torch.int64), b.to(torch.int64)):
                    raise AssertionError(f"mesh 4x2 ({engine}): card and "
                                         f"CPU differ in {label}, output "
                                         f"{i}")
    launches = {k: vk.LAUNCHES[k] - before[k] for k in before}
    last = ref["-G 4 fold 2 reseed False"]
    filled = int(ref["-G 4 fold 1 reseed True"][15].sum())   # ring filled
    print(f"mesh 4x2 parity (cgc_like, 64 lanes per shard): card == CPU "
          f"for engines cuda and cuda_fused over 3 steps, a K = 8 "
          f"superbatch and 4 x -G 4 dispatches (findings rings "
          f"{[int(p) for p in last[5]]} rows, ring filled {filled} of "
          f"32); launches {launches}", flush=True)
    if filled <= 4 or launches["kbz_fuzz_kernel"] <= 0 or \
            launches["kbz_vm_kernel_all"] <= 0:
        raise AssertionError("mesh parity: no ring admission or a kernel "
                             "never launched")
    return launches


def mesh_cli_parity():
    """Phase 6b: the CLI at --mesh 1,1 -b 1024 on the card (cuda_fused)
    against the CPU (torch): host-driven at -fb 0, and -G 4 at the
    default -fb; then --device cpu --mesh 4,2 once."""
    got = {}
    for mode, extra in (("host", ["-n", "12288", "-fb", "0"]),
                        ("gen", ["-n", "32768", "-G", "4"])):
        for dev, engine in (("cuda", "cuda_fused"), ("cpu", "torch")):
            name = f"mesh_{mode}_{dev}"
            state = OUT / f"{name}.isd"
            _, out = run_cli(["--mesh", "1,1", "-b", "1024", *extra,
                              "--device", dev, "-isd", str(state), "-i",
                              json.dumps({**GEN_IOPTS, "engine": engine})],
                             name)
            got[(mode, dev)] = {"findings": findings(out),
                                "isd": state.read_text(),
                                "admits": ring_admits(out),
                                "counters": stats_counters(out)}
        c, p = got[(mode, "cuda")], got[(mode, "cpu")]
        if c != p:
            raise AssertionError(f"--mesh 1,1 ({mode}): card and CPU "
                                 f"differ in {[k for k in c if c[k] != p[k]]}")
    if not got[("gen", "cuda")]["admits"]:
        raise AssertionError("--mesh 1,1 -G 4: no ring admission")
    (OUT / "mesh_seed.bin").write_bytes(MESH_SEED)
    _, out = run_cli(["--mesh", "4,2", "--device", "cpu", "-b", "256", "-n",
                      "2048", "-sf", str(OUT / "mesh_seed.bin"), "-i",
                      json.dumps({"target": "cgc_like"})], "mesh_cpu_4x2")
    found = findings(out)
    if not found["new_paths"]:
        raise AssertionError("--device cpu --mesh 4,2 found nothing")
    print(f"mesh CLI parity: --mesh 1,1 card == CPU host-driven -fb 0 "
          f"({len(got[('host', 'cuda')]['findings']['new_paths'])} new "
          f"paths) and -G 4 at the default -fb "
          f"({len(got[('gen', 'cuda')]['admits'])} ring admissions); "
          f"--device cpu --mesh 4,2: {len(found['new_paths'])} new paths, "
          f"{len(found['crashes'])} crashes", flush=True)


def mesh_flagship(name, *args):
    """A --mesh 1,1 flagship run (cuda_fused); checks the mesh gauge.
    Returns flagship()'s (launches, execs/s)."""
    launches, rate, out = flagship(name, "--mesh", "1,1", *args,
                                   batches=MESH_BATCHES,
                                   need=("kbz_fuzz_kernel",))
    gauges = [json.loads(line).get("gauges", {}) for line in
              (out / "stats.jsonl").read_text().splitlines()
              if line.strip()]
    if not any(g.get("mesh_dp") == 1 for g in gauges):
        raise AssertionError(f"{name}: no mesh_dp gauge in stats.jsonl")
    if "-G" in args and not ring_admits(out):
        raise AssertionError(f"{name}: no ring_admit event")
    return launches, rate


def mesh_stages(card):
    """Phase 6d: device ms per mesh step by stage on tlvstack_vm —
    mutate+execute (single-phase kbz_fuzz_kernel), triage (every mp
    shard's novelty, the row's dedup, the clears), the dp fold and the
    compaction — at --mesh 1,1 x 65536 lanes and at 4,2 x 16384 lanes
    per shard on one card (the same global batch).  Each stage is
    summed over the mesh's rows and timed behind a hold of the card
    long enough for the host to enqueue it.  Then one whole step, not
    held: its event span, the host's enqueue time and the device's
    idle share, 1 - (the stages' device time) / (the span)."""
    from killerbeez_tpu_torch.models.targets import get_target
    from killerbeez_tpu_torch.models.targets_cgc import tlvstack_vm_seed
    from killerbeez_tpu_torch.ops import vm_kernel as vk
    from killerbeez_tpu_torch.parallel import distributed as ds
    from killerbeez_tpu_torch.tools import timing
    prog = get_target("tlvstack_vm")
    sb = tlvstack_vm_seed()
    seed = torch.zeros(64, dtype=torch.uint8)
    seed[:len(sb)] = torch.tensor(list(sb), dtype=torch.uint8)
    seed = seed.cuda()
    hold = timing.HOLD_CYCLES
    # ~250 ms: the host takes ~120 ms to enqueue a 4 x 2 mesh step
    timing.HOLD_CYCLES = 500_000_000
    result = {}
    try:
        for n_dp, n_mp in ((1, 1), (4, 2)):
            mesh = ds.make_mesh(n_dp, n_mp, ["cuda:0"] * (n_dp * n_mp))
            bpd = B // n_dp
            kern = ds._ShardKernels(prog, mesh, bpd, 64, engine="cuda_fused",
                                    seed=MUT_SEED)
            step = ds.make_sharded_fuzz_step(prog, mesh, bpd, 64,
                                             engine="cuda_fused",
                                             seed=MUT_SEED)
            st = ds.sharded_state_init(mesh, prog.map_size)
            for i in range(2):                       # a warm map
                st = step(st, seed, len(sb), i * B)[0]
            maps = ds._row_maps(mesh, st)
            ring = vk.seed_ring(seed, len(sb))
            key = kern.base_key(2 * B, 0, seed.device)
            rows = [kern.mutate_exec(d, *ring, key) for d in range(n_dp)]
            stats = [torch.where(r[0].status == 3, 1, r[0].status).to(
                torch.int32) for r in rows]
            tri = [kern.triage_row(d, *(maps[k][d] for k in range(3)),
                                   rows[d][0].counts, stats[d])
                   for d in range(n_dp)]

            def compaction():
                for d in range(n_dp):
                    fl = (stats[d] != 0) | (tri[d][0] > 0)
                    sel = vk.compact_lanes(fl)[0][:1024].long()
                    _ = (rows[d][1][sel], rows[d][2][sel])
            stages = {
                "mutate+execute": timing.timed(lambda: [
                    kern.mutate_exec(d, *ring, key) for d in range(n_dp)],
                    3),
                "triage": timing.timed(lambda: [
                    kern.triage_row(d, *(maps[k][d] for k in range(3)),
                                    rows[d][0].counts, stats[d])
                    for d in range(n_dp)], 3),
                "fold": timing.timed(lambda: ds._fold_maps(
                    mesh, [[list(t[3 + k]) for t in tri]
                           for k in range(3)]), 3),
                "compaction": timing.timed(compaction, 3),
            }
            # one whole step, not held: the span between CUDA events
            # recorded before and after it is enqueued, the host's
            # enqueue time, and the device's idle share of the span
            spans, hosts = [], []
            for _ in range(3):
                torch.cuda.synchronize()
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                t0 = time.perf_counter()
                step(st, seed, len(sb), 2 * B)
                hosts.append((time.perf_counter() - t0) * 1e3)
                e1.record()
                e1.synchronize()
                spans.append(e0.elapsed_time(e1))
            span, enqueue = statistics.median(spans), statistics.median(hosts)
            device = sum(stages.values())
            result[(n_dp, n_mp)] = (stages, span, enqueue)
            print(f"mesh step stage breakdown --mesh {n_dp},{n_mp} x {bpd} "
                  f"lanes per shard [ms per step, median, {card}]: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
                  + f"; device total {device:.3f}; one step: event span "
                  f"{span:.3f}, host enqueue {enqueue:.3f}, device idle "
                  f"share {1.0 - device / span:.3f}", flush=True)
    finally:
        timing.HOLD_CYCLES = hold
    return result


# -- the trace surface (phase 7) ---------------------------------------

TRACE_BATCHES = 48          # the edges and rare-edge flagship runs


def mutants(vk, prng, name, n, L, dev):
    """``n`` havoc mutants of target ``name``'s seed (the fused kernel's
    plain havoc, from the mutator seed), on ``dev``."""
    from killerbeez_tpu_torch.models import targets_cgc
    sb = targets_cgc.VM_SEEDS[name][0]()
    seed = torch.zeros(L, dtype=torch.uint8, device=dev)
    seed[:len(sb)] = torch.tensor(list(sb), dtype=torch.uint8)
    its = torch.arange(n, dtype=torch.int64, device=dev)
    return vk.havoc_from_ring(*vk.seed_ring(seed, len(sb)),
                              prng.key(MUT_SEED, device=dev), its,
                              STACK_POW2)


def stream_parity(vk, prng, card):
    """7a: the stream-recording engine (the plain torch engine on the
    card; no kernel records the stream) on CUDA tensors against the
    CPU: all six VMResult fields at 4096 lanes on tlvstack_vm and
    fixedform_vm; then its time on one 65536-lane flagship batch."""
    from killerbeez_tpu_torch.models.targets import get_target
    from killerbeez_tpu_torch.models.vm import run_batch as vm_run
    from killerbeez_tpu_torch.tools.timing import timed
    dev = torch.device("cuda")
    for name, L in (("tlvstack_vm", 64), ("fixedform_vm", 128)):
        prog = get_target(name)
        bufs, lens = mutants(vk, prng, name, 4096, L, torch.device("cpu"))
        ref = vm_run(prog, bufs, lens, record_stream=True)
        got = vm_run(prog, bufs.to(dev), lens.to(dev), record_stream=True)
        err = max_abs_err([f.cpu() for f in got], ref)
        print(f"stream engine card vs CPU ({name}, 4096 lanes, 6 fields): "
              f"max_abs_err {err}; {int((ref.edge_ids >= 0).sum())} "
              "stream entries", flush=True)
        if err:
            raise AssertionError(f"the stream engine on the card disagrees "
                                 f"with the CPU ({name})")
    prog = get_target("tlvstack_vm")
    bufs, lens = mutants(vk, prng, "tlvstack_vm", B, 64, dev)
    t_stream = timed(lambda: vm_run(prog, bufs, lens, record_stream=True),
                     3)
    t_plain = timed(lambda: vm_run(prog, bufs, lens), 3)
    print(f"stream engine [{card}]: one {B}-lane tlvstack_vm batch "
          f"{t_stream:.1f} ms with the stream, {t_plain:.1f} ms without "
          "(plain torch engine; it reads the running mask every 16 steps, "
          "so the event span includes the host's waits)", flush=True)


def ipt_runs(card):
    """7b: ``file ipt havoc`` on the card — unfiltered (kbz_vm_kernel
    over every lane) and filtered (the stream engine) at 65536 lanes,
    then card == CPU at -b 1024 at the default -fb (PIPELINE_DEPTH 1).
    Returns the unfiltered run's launches."""
    base = {"target": "tlvstack_vm"}
    filt = {**base, "filters": [[0, 30000]]}
    launches, rate, _ = flagship("ipt", batches=16, instr="ipt",
                                 iopts=base, need=("kbz_vm_kernel_all",))
    f_launches, f_rate, _ = flagship("ipt_filtered", batches=4,
                                     instr="ipt", iopts=filt, need=())
    if any(f_launches.values()):
        raise AssertionError(f"the filtered ipt step launched a kernel: "
                             f"{f_launches}")
    print(f"ipt execs/s on {card}: unfiltered {rate:.0f} (16 batches of "
          f"{B}), filtered {f_rate:.0f} (4 batches)", flush=True)
    for label, iopts in (("unfiltered", base), ("filtered", filt)):
        got = {dev: inprocess(OUT / f"ipt_{label}_{dev}", "-b", "1024",
                              "-n", "8192", "--device", dev, "-i",
                              json.dumps(iopts), instr="ipt")
               for dev in ("cuda", "cpu")}
        if got["cuda"] != got["cpu"]:
            diff = [k for k in got["cuda"]
                    if got["cuda"][k] != got["cpu"][k]]
            raise AssertionError(f"ipt ({label}): card and CPU differ in "
                                 f"{diff}")
        n_hashes = len(json.loads(got["cuda"]["isd"])["hashes"])
        print(f"ipt parity ({label}, -b 1024, default -fb): card == CPU "
              f"({len(got['cuda']['findings']['new_paths'])} new paths, "
              f"{n_hashes} hashes in the state, equal -isd, -msd, picks "
              "and counters)", flush=True)
    return launches


def edges_runs(vk, card):
    """7c: the flagship with {"edges": 1} (cuda_fused): card == CPU for
    get_edges, get_edge_pairs and last_trace after each of four
    1024-lane batches and for the state, and for the CLI at -b 1024
    (default -fb, PIPELINE_DEPTH 1); then execs/s at 65536 lanes in
    turns with the same run without edges.  Returns the first edges
    run's launches."""
    from killerbeez_tpu_torch.drivers.factory import driver_factory
    from killerbeez_tpu_torch.instrumentation.factory import \
        instrumentation_factory
    from killerbeez_tpu_torch.models import targets_cgc
    from killerbeez_tpu_torch.mutators.factory import mutator_factory
    seed = targets_cgc.tlvstack_vm_seed()
    rec = {}
    for dev, engine in (("cuda", "cuda_fused"), ("cpu", "torch")):
        before = vk.LAUNCHES["kbz_fuzz_kernel"]
        instr = instrumentation_factory("jit_harness", json.dumps(
            {"target": "tlvstack_vm", "engine": engine,
             "novelty": "throughput", "edges": 1}), device=dev)
        mut = mutator_factory("havoc", json.dumps({"seed": MUT_SEED}),
                              seed, device=dev)
        drv = driver_factory("file", None, instr, mut, device=dev)
        rows = []
        for _ in range(4):
            drv.test_batch(1024)
            rows.append((instr.get_edges(), instr.get_edge_pairs(),
                         instr.last_trace().tobytes()))
        rec[dev] = (rows, instr.get_state())
        if dev == "cuda" and vk.LAUNCHES["kbz_fuzz_kernel"] - before != 4:
            raise AssertionError("the edges batches did not run the fused "
                                 "kernel")
    if rec["cuda"] != rec["cpu"]:
        raise AssertionError("{\"edges\": 1}: the card's get_edges / "
                             "get_edge_pairs / last_trace / state differ "
                             "from the CPU's")
    got = {}
    for dev, engine in (("cuda", "cuda_fused"), ("cpu", "torch")):
        got[dev] = inprocess(
            OUT / f"edges_{dev}", "-b", "1024", "-n", "16384", "--device",
            dev, "-i", json.dumps({"target": "tlvstack_vm",
                                   "engine": engine,
                                   "novelty": "throughput", "edges": 1}))
    if got["cuda"] != got["cpu"]:
        raise AssertionError("{\"edges\": 1}: the card's CLI run differs "
                             "from the CPU's")
    print(f"edges parity: card == CPU (4 batches: "
          f"{len(rec['cuda'][0][-1][0])} slots, "
          f"{len(rec['cuda'][0][-1][1])} edge pairs in lane 0 of the last; "
          f"CLI -b 1024: {len(got['cuda']['findings']['new_paths'])} new "
          "paths, equal -isd, -msd, picks and counters)", flush=True)
    eps = {"edges": [], "plain": []}
    first = None
    edges_iopts = {"target": "tlvstack_vm", "engine": "cuda_fused",
                   "novelty": "throughput", "edges": 1}
    for mode, name in (("edges", "flagship_edges"),
                       ("plain", "flagship_plain"),
                       ("plain", "flagship_plain_2"),
                       ("edges", "flagship_edges_2")):
        got_l, rate, _ = flagship(
            name, batches=TRACE_BATCHES,
            iopts=edges_iopts if mode == "edges" else None)
        first = first or got_l
        eps[mode].append(rate)
    print(f"edges execs/s on {card} ({TRACE_BATCHES} batches of {B}, "
          f"default -fb): with edges "
          f"{', '.join(f'{r:.0f}' for r in eps['edges'])}; without "
          f"{', '.join(f'{r:.0f}' for r in eps['plain'])} (in turns: "
          "edges, plain, plain, edges)", flush=True)
    return first


def corpus_sigs(corpus_dir: Path):
    out = {}
    for path in sorted(corpus_dir.glob("*.json")):
        meta = json.loads(path.read_text())
        if "sig" in meta:
            out[path.name] = meta["sig"]
    return out


def rare_edge_runs(vk, card):
    """7d: --schedule rare-edge at the default -fb: card == CPU at -b
    1024 (PIPELINE_DEPTH 1: md5 sets, sidecar sigs, picks, states,
    counters); execs/s at 65536 lanes in turns with --schedule bandit;
    the signer's host ms per admission.  Returns the first rare-edge
    run's launches."""
    from killerbeez_tpu_torch.fuzzer import cli
    from killerbeez_tpu_torch.instrumentation.factory import \
        instrumentation_factory
    iopts = {"target": "tlvstack_vm", "novelty": "throughput"}
    got = {}
    for dev, engine in (("cuda", "cuda_fused"), ("cpu", "torch")):
        out = OUT / f"rare_{dev}"
        got[dev] = inprocess(out, "-b", "1024", "-n", "25600", "--device",
                             dev, "--schedule", "rare-edge", "--corpus-dir",
                             str(out / "corpus"), "-i",
                             json.dumps({**iopts, "engine": engine}))
        got[dev]["sigs"] = corpus_sigs(out / "corpus")
    if got["cuda"] != got["cpu"]:
        diff = [k for k in got["cuda"] if got["cuda"][k] != got["cpu"][k]]
        raise AssertionError(f"rare-edge: card and CPU differ in {diff}")
    sigs = got["cuda"]["sigs"]
    if not sigs or not all(sigs.values()):
        raise AssertionError("rare-edge: the corpus entries are unsigned")
    print(f"rare-edge parity (-b 1024, PIPELINE_DEPTH 1): card == CPU "
          f"({len(sigs)} signed entries, picks {got['cuda']['picks']})",
          flush=True)
    eps = {"rare": [], "bandit": []}
    first = out = None
    for mode, name in (("rare", "flagship_rare"),
                       ("bandit", "flagship_bandit"),
                       ("bandit", "flagship_bandit_2"),
                       ("rare", "flagship_rare_2")):
        got_l, rate, o = flagship(
            name, "--schedule", "rare-edge" if mode == "rare" else "bandit",
            batches=TRACE_BATCHES,
            need=("kbz_fuzz_kernel", "kbz_vm_kernel")
            + (("kbz_vm_kernel_all",) if mode == "rare" else ()))
        if first is None:
            first, out = got_l, o
        eps[mode].append(rate)
    print(f"rare-edge execs/s on {card} ({TRACE_BATCHES} batches of {B}, "
          f"default -fb): rare-edge "
          f"{', '.join(f'{r:.0f}' for r in eps['rare'])}; bandit "
          f"{', '.join(f'{r:.0f}' for r in eps['bandit'])} (in turns: "
          f"rare, bandit, bandit, rare); the first rare-edge run signed "
          f"{first['kbz_vm_kernel_all']} admissions", flush=True)

    # the signer's host time per admission: the CLI's signer on the
    # flagship's instrumentation, over that run's new-path findings
    class Loop:
        _signer = None

    class Driver:
        instrumentation = instrumentation_factory("jit_harness", json.dumps(
            {**iopts, "engine": "cuda_fused"}))

    loop = Loop()
    cli._wire_rare_edge_signer(loop, Driver)
    bufs = [p.read_bytes() for p in sorted((out / "new_paths").iterdir())]
    loop._signer(bufs[0])                     # first use: allocations
    before = dict(vk.LAUNCHES)
    times = []
    for buf in bufs[:200]:
        t0 = time.perf_counter()
        loop._signer(buf)
        times.append((time.perf_counter() - t0) * 1e3)
    signs = vk.LAUNCHES["kbz_vm_kernel_all"] - before["kbz_vm_kernel_all"]
    if signs != len(times):
        raise AssertionError("the signer did not launch kbz_vm_kernel once "
                             "per admission")
    print(f"rare-edge signer [{card}]: host {statistics.median(times):.3f} ms "
          f"per admission (median of {len(times)}; min {min(times):.3f}, "
          f"max {max(times):.3f}), one kbz_vm_kernel launch each", flush=True)
    return first


def tool_runs():
    """7e: tracer (slots and pairs) and showmap on one seed, on the card
    and on the CPU: the same output files."""
    from killerbeez_tpu_torch.tools import showmap, tracer
    base = ["file", "jit_harness", "-sf", str(OUT / "seed.bin"), "-i",
            json.dumps({"target": "tlvstack_vm"}), "-l", '{"level": 1}']
    files = {}
    for dev in ("cuda", "cpu"):
        d = OUT / f"tools_{dev}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for mod, extra in ((tracer, ["-o", str(d / "edges.txt")]),
                           (tracer, ["-f", "pairs", "-o",
                                     str(d / "pairs.txt")]),
                           (showmap, ["-o", str(d / "map.txt")])):
            if mod.main(base + extra + ["--device", dev]) != 0:
                raise AssertionError(f"{mod.__name__} failed on {dev}")
        files[dev] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    if files["cuda"] != files["cpu"] or not all(files["cuda"].values()):
        raise AssertionError("tracer/showmap: the card's files differ from "
                             "the CPU's")
    print(f"tracer and showmap: card == CPU "
          f"({', '.join(f'{k} {v.count(chr(10).encode())} lines' for k, v in files['cuda'].items())})",
          flush=True)


# -- the mutators (phase 8) ---------------------------------------------

#: phase 8c's full-width run of each unfused mutator, in batches
MUTATOR_BATCHES = 48
#: a stand-in radamsa for phase 8b: rot13 of its input, the same bytes
#: on every call (the mutator passes "-s <seed>", which it ignores)
RADAMSA_FAKE = "#!/bin/sh\nexec tr 'A-Za-z' 'N-ZA-Mn-za-m'\n"


def mutator_files():
    """Phase 8's inputs, written to OUT: the splice partners, the 8-byte
    head of the flagship seed (afl's deterministic stages are then 2740
    iterations, which a 1024-lane CLI run passes), a two-part manager
    seed and the stand-in radamsa."""
    from killerbeez_tpu_torch.models.targets_cgc import tlvstack_vm_seed
    from killerbeez_tpu_torch.utils.serialization import encode_mem_array
    seed = tlvstack_vm_seed()
    corpus = OUT / "splice_partners"
    shutil.rmtree(corpus, ignore_errors=True)
    corpus.mkdir(parents=True)
    (corpus / "a").write_bytes(seed[::-1])
    (corpus / "b").write_bytes(seed[:12] + b"\x02\x00\x07\x00" * 3)
    files = {"corpus": corpus, "short": OUT / "seed_head8.bin",
             "parts": OUT / "manager_seed.bin", "radamsa": OUT / "radamsa"}
    files["short"].write_bytes(seed[:8])
    files["parts"].write_bytes(
        encode_mem_array([seed[:12], seed[12:]]).encode())
    files["radamsa"].write_text(RADAMSA_FAKE)
    files["radamsa"].chmod(0o755)
    return files


def mutator_cases(files):
    """(label, mutator, options, seed file) of phases 8a and 8d."""
    seed = OUT / "seed.bin"
    keyed = {"seed": MUT_SEED}
    return [
        ("nop", "nop", {}, seed),
        ("bit_flip 1", "bit_flip", {"num_bits": 1}, seed),
        ("bit_flip 32", "bit_flip", {"num_bits": 32}, seed),
        ("arithmetic", "arithmetic", {}, seed),
        ("interesting_value", "interesting_value", {}, seed),
        ("dictionary", "dictionary", {"target": "tlvstack_vm"}, seed),
        ("zzuf", "zzuf", keyed, seed),
        ("ni", "ni", keyed, seed),
        ("honggfuzz", "honggfuzz", keyed, seed),
        ("splice", "splice",
         {**keyed, "corpus_dir": str(files["corpus"])}, seed),
        ("afl", "afl", keyed, seed),
        ("manager", "manager",
         {"mutators": ["bit_flip", "havoc"],
          "mutator_options": [None, keyed], "framed": 1}, files["parts"]),
    ]


def mutator_parity(files):
    """8a: each mutator's mutate_batch on CUDA tensors against the CPU at
    the flagship shape: B lanes (afl's from iteration 0 cross every
    stage boundary into havoc; manager's bit_flip child runs out after
    96 turns and havoc takes the rest), or the whole walk of a finite
    mutator — bytes and lengths equal, no tolerance."""
    from killerbeez_tpu_torch.mutators import mutator_factory
    done = []
    for label, name, opts, seed in mutator_cases(files):
        got = {}
        for dev in ("cuda", "cpu"):
            m = mutator_factory(name, json.dumps(opts), seed.read_bytes(),
                                device=dev)
            n = min(B, m.remaining())
            bufs, lens = m.mutate_batch(n)
            got[dev] = (bufs.cpu(), lens.cpu())
        if not (torch.equal(got["cuda"][0], got["cpu"][0])
                and torch.equal(got["cuda"][1], got["cpu"][1])):
            raise AssertionError(f"mutator {label}: the card's candidates "
                                 "differ from the CPU's")
        done.append(f"{label} ({n} lanes)")
    print("mutators card == CPU (bytes and lengths, tolerance none): "
          + ", ".join(done), flush=True)


def mutator_cli_parity(files, vk):
    """8b: the CLI on the card (engine cuda: kbz_vm_kernel over every
    lane) against the CPU (engine torch) at -b 1024, in this process
    with PIPELINE_DEPTH = 1, for every ported mutator but havoc (phase
    4's): md5 sets, -isd, -msd, rotation picks and fuzzer_stats counters
    equal.  A finite walk runs to its end (-n -1, exit 0, the walk's
    total in -msd); the randomized ones at -fb 0 (4 batches) and at the
    default -fb (9 batches: a rotation after 8); radamsa (the stand-in,
    one process per candidate) one batch of 256, padded to 1024."""
    from killerbeez_tpu_torch.mutators import mutator_factory
    keyed = {"seed": MUT_SEED}
    fb0, fbd = ["-fb", "0", "-n", "4096"], ["-n", "9216"]
    cases = [
        ("nop", {}, None, [["-n", "3072"]]),
        ("bit_flip", {"num_bits": 1}, None, [[]]),
        ("bit_flip", {"num_bits": 32}, None, [[]]),
        ("arithmetic", {}, None, [[]]),
        ("interesting_value", {}, None, [[]]),
        ("dictionary", {"target": "tlvstack_vm"}, None, [[]]),
        ("manager", {"mutators": ["bit_flip", "bit_flip"], "framed": 1},
         files["parts"], [[]]),
        ("zzuf", keyed, None, [fb0, fbd]),
        ("ni", keyed, None, [fb0, fbd]),
        ("honggfuzz", keyed, None, [fb0, fbd]),
        ("splice", {**keyed, "corpus_dir": str(files["corpus"])}, None,
         [fb0, fbd]),
        ("afl", keyed, files["short"], [fb0, fbd]),
        ("manager", {"mutators": ["bit_flip", "havoc"],
                     "mutator_options": [None, keyed], "framed": 1},
         files["parts"], [fb0, fbd]),
        ("radamsa", {"path": str(files["radamsa"]), **keyed}, None,
         [["-fb", "0", "-n", "256"]]),
    ]
    before = vk.LAUNCHES["kbz_vm_kernel_all"]
    done = []
    for i, (name, mopts, seed, runs) in enumerate(cases):
        for j, extra in enumerate(runs):
            got = {}
            for dev, engine in (("cuda", "cuda"), ("cpu", "torch")):
                iopts = {"target": "tlvstack_vm", "engine": engine}
                got[dev] = inprocess(
                    OUT / f"mut{i}_{name}_{j}_{dev}", "-b", "1024",
                    "--device", dev, "-i", json.dumps(iopts), *extra,
                    mutator=name, mopts=mopts, seed=seed)
            if got["cuda"] != got["cpu"]:
                diff = [k for k in got["cuda"]
                        if got["cuda"][k] != got["cpu"][k]]
                raise AssertionError(f"{name} CLI ({extra}): card and CPU "
                                     f"differ in {diff}")
            it = json.loads(got["cuda"]["msd"])["iteration"]
            if not extra:
                total = mutator_factory(
                    name, json.dumps(mopts), Path(
                        seed or OUT / "seed.bin").read_bytes(),
                    device="cpu").get_total_iteration_count()
                if it != total:
                    raise AssertionError(f"{name}: the walk stopped at {it} "
                                         f"of {total}")
            done.append(f"{name}{'' if not extra else ' ' + ' '.join(extra)}"
                        f": {len(got['cuda']['findings']['new_paths'])} new "
                        f"paths, {it} iterations, "
                        f"{len(got['cuda']['picks'])} picks")
    launched = vk.LAUNCHES["kbz_vm_kernel_all"] - before
    if launched <= 0:
        raise AssertionError("the mutators' CLI runs never launched "
                             "kbz_vm_kernel over all lanes")
    print(f"mutator CLI parity (-b 1024, PIPELINE_DEPTH 1): card == CPU "
          f"(md5 sets, -isd, -msd, picks, counters; {launched} "
          "kbz_vm_kernel_all launches on the card): " + "; ".join(done),
          flush=True)


def mutator_flagships(card):
    """8c: afl, zzuf and honggfuzz at -b 65536 on tlvstack_vm (engine
    cuda, the default -fb, MUTATOR_BATCHES batches each) in turns with
    the havoc cuda_fused flagship: havoc, afl, zzuf, honggfuzz, havoc.
    Each exits 0 and writes findings; the unfused ones launch
    kbz_vm_kernel over all lanes (each CLI run counts from 0).
    Returns the unfused runs' launches."""
    rates, launches = [], {}
    for i, name in enumerate(("havoc", "afl", "zzuf", "honggfuzz",
                              "havoc")):
        if name == "havoc":
            got, rate, _ = flagship(f"mut_flagship_havoc_{i}",
                                    batches=MUTATOR_BATCHES)
        else:
            got, rate, _ = flagship(f"mut_flagship_{name}",
                                    batches=MUTATOR_BATCHES, engine="cuda",
                                    need=("kbz_vm_kernel_all",),
                                    mutator=name)
            launches[name] = got
        rates.append(f"{name} {rate:.0f}")
    print(f"mutator execs/s on {card} ({MUTATOR_BATCHES} batches of {B}, "
          f"in turns): {', '.join(rates)}", flush=True)
    return launches


def mutator_stages(card, files, vk):
    """8d: device ms per 65536-lane batch by stage (tools/timing: CUDA
    events, median of 5 after a warm-up): each mutator's candidates for
    iterations 0..B-1 (a finite walk runs past its end: the same work
    per lane; manager's includes its host work), then kbz_vm_kernel over
    every lane of afl's batch and its triage.  Returns {stage: ms}."""
    import numpy as np
    from killerbeez_tpu_torch.instrumentation import jit_harness as jh
    from killerbeez_tpu_torch.models.targets import get_target
    from killerbeez_tpu_torch.mutators import mutator_factory
    from killerbeez_tpu_torch.ops.static_triage import make_static_maps
    from killerbeez_tpu_torch.tools.timing import timed
    its = np.arange(B, dtype=np.int64)
    stages = {}
    for label, name, opts, seed in mutator_cases(files):
        m = mutator_factory(name, json.dumps(opts), seed.read_bytes(),
                            device="cuda")
        if name == "manager":
            stages[label] = timed(lambda: m.mutate_batch(B), 5)
        else:
            stages[label] = timed(lambda: m._generate(its), 5)
    afl = mutator_factory("afl", json.dumps({"seed": MUT_SEED}),
                          (OUT / "seed.bin").read_bytes(), device="cuda")
    bufs, lens = afl._generate(its)
    dev = torch.device("cuda")
    prog = get_target("tlvstack_vm")
    vm_args = (torch.as_tensor(prog.instrs, device=dev),
               torch.as_tensor(prog.edge_table, device=dev), bufs, lens,
               prog.mem_size, prog.max_steps, prog.n_edges)
    stages["kbz_vm_kernel (all lanes)"] = timed(
        lambda: vk.run_batch(*vm_args), 5)
    res = vk.run_batch(*vm_args)
    u_slots, seg_id = (torch.as_tensor(a, device=dev)
                       for a in make_static_maps(prog.edge_slot))
    virgin = torch.full((prog.map_size,), 0xFF, dtype=torch.uint8,
                        device=dev)
    statuses = torch.where(res.status == 3, 1, res.status).to(torch.int32)
    stages["triage"] = timed(lambda: jh._triage_counts(
        res.counts, statuses, u_slots, seg_id, virgin, virgin, virgin,
        False), 5)
    print(f"mutator stages [ms per {B}-lane batch, median, {card}]: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()),
          flush=True)
    return stages


# -- the host-execution tier (phase 10) ----------------------------------

#: lanes of phase 10's host batches: real processes, one exec each
HOST_B = 4096
#: phase 10's corpus fixtures, built by the port into build/torch_native
HOST_FIXTURES = ("test", "test-plain", "hang", "network_server")


def host_build():
    """Builds native/ and HOST_FIXTURES with make into
    build/torch_native/ (the port's own build); returns {name: path}."""
    from killerbeez_tpu_torch.native import build
    t0 = time.perf_counter()
    build.build_corpus(HOST_FIXTURES)
    print(f"native + corpus fixtures built into {build.BUILD_DIR}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {n: build.corpus_path(n) for n in HOST_FIXTURES}


def host_run(out: Path, argv, device, depth=1):
    """The port's CLI in this process on a host target, with
    ``Fuzzer.PIPELINE_DEPTH = depth`` (None: the default); returns
    (what the card and the CPU must agree on, the log)."""
    from killerbeez_tpu_torch.fuzzer.cli import main as cli_main
    from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
    shutil.rmtree(out, ignore_errors=True)
    args = [*argv, "-o", str(out), "-isd", f"{out}.isd", "-l",
            '{"level": 1}', "--device", device]
    saved = Fuzzer.PIPELINE_DEPTH
    Fuzzer.PIPELINE_DEPTH = depth or saved
    log = io.StringIO()
    try:
        with contextlib.redirect_stderr(log):
            rc = cli_main(args)
    finally:
        Fuzzer.PIPELINE_DEPTH = saved
    log = log.getvalue()
    (OUT / f"{out.name}.log").write_text(log)
    if rc != 0:
        raise RuntimeError(f"CLI {out.name} exited {rc}:\n{log[-3000:]}")
    info = {n: (out / "crashes" / n).read_text()
            for n in os.listdir(out / "crashes") if n.endswith(".info")}
    return {"findings": findings(out), "counters": stats_counters(out),
            "isd": Path(f"{out}.isd").read_text(), "info": info,
            "picks": picks(out)}, log


def host_parity(name, argv):
    """``argv`` on the card and with --device cpu (PIPELINE_DEPTH 1):
    md5 sets, ``.info`` texts, counters, ``-isd`` and picks equal."""
    got = {dev: host_run(OUT / f"{name}_{dev}", argv, dev)[0]
           for dev in ("cuda", "cpu")}
    if got["cuda"] != got["cpu"]:
        diff = [k for k in got["cuda"] if got["cuda"][k] != got["cpu"][k]]
        raise AssertionError(f"{name}: card and CPU differ in {diff}")
    return got["cuda"]


def host_cli_parity(fx):
    """10a: the reference's smoke configs through ``cli.main``, card
    against CPU: ``file return_code bit_flip`` over the whole 32-flip
    walk of 'ABC@' (the single-exec loop; flip 29 makes the crasher
    'ABCD') and ``stdin afl honggfuzz`` from 'Azzz' at -b 64 with a
    corpus-feedback rotation (exactly two new paths)."""
    rc = host_parity("host_return_code", [
        "file", "return_code", "bit_flip", "-n", "32", "-ss", "ABC@",
        "-d", json.dumps({"path": fx["test"]})])
    if len(rc["findings"]["crashes"]) != 1:
        raise AssertionError("file return_code bit_flip found no crash "
                             "from ABC@")
    afl = host_parity("host_afl_honggfuzz", [
        "stdin", "afl", "honggfuzz", "-n", "640", "-b", "64", "-ss",
        "Azzz", "-m", json.dumps({"seed": MUT_SEED}),
        "-d", json.dumps({"path": fx["test"]})])
    if afl["counters"]["paths_total"] != "2" or not afl["picks"]:
        raise AssertionError(f"stdin afl honggfuzz: {afl['counters']}, "
                             f"picks {afl['picks']} (want 2 new paths "
                             "and a rotation)")
    print(f"10a: card == CPU (md5 sets, counters, -isd, picks): file "
          f"return_code bit_flip {rc['counters']} with the crash; stdin "
          f"afl honggfuzz {afl['counters']}, picks {afl['picks']}",
          flush=True)


def host_triage(fx, card):
    """10b: HOST_B real bitmaps (havoc of 'ABC@zzzz' on ``test``, so
    some lanes crash) triaged from fresh virgin maps by
    ``triage_host_bitmaps`` on the card and on the CPU, and by the
    numpy word-skip path: rets, unique crashes and hangs and the three
    maps equal.  Times: the card's device ms (tools/timing, CUDA
    events, median of 5), the card path's host ms with its copies
    (bitmaps up, verdicts and maps back: ``_torch_triage_batch``), the
    CPU torch path's ms and the numpy path's ms (median of 3).
    Returns the card's device ms."""
    import numpy as np
    from killerbeez_tpu_torch import MAP_SIZE
    from killerbeez_tpu_torch.instrumentation.afl import (
        AflInstrumentation, triage_host_bitmaps,
    )
    from killerbeez_tpu_torch.mutators import mutator_factory
    from killerbeez_tpu_torch.native.exec_backend import (
        ExecPool, classify_batch,
    )
    from killerbeez_tpu_torch.tools.timing import timed
    mut = mutator_factory("havoc", json.dumps({"seed": MUT_SEED}),
                          b"ABC@zzzz", device="cuda")
    bufs, lens = mut.mutate_batch_host(HOST_B)
    with ExecPool([fx["test"]], 8, use_stdin=True, use_forkserver=True,
                  coverage=True) as pool:
        raw, maps = pool.run_batch(bufs, lens)
    verdicts, _ = classify_batch(raw)

    def fresh(dev):
        return [torch.full((MAP_SIZE,), 0xFF, dtype=torch.uint8,
                           device=dev) for _ in range(3)]

    outs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        got = triage_host_bitmaps(torch.from_numpy(maps).to(dev),
                                  torch.from_numpy(verdicts).to(dev),
                                  *fresh(dev))
        outs[dev] = [t.cpu().numpy() for t in got]
        if dev == "cpu":
            cpu_ms = (time.perf_counter() - t0) * 1e3

    def host_path(device_triage):
        afl = AflInstrumentation(json.dumps(
            {"device_triage": device_triage}), device="cuda")
        t0 = time.perf_counter()
        if device_triage:
            res = afl._torch_triage_batch(maps, verdicts)
        else:
            res = afl._np_triage_batch(maps, verdicts)
        ms = (time.perf_counter() - t0) * 1e3
        return ms, list(res) + [afl.virgin_bits, afl.virgin_crash,
                                afl.virgin_tmout]

    np_runs = [host_path(0) for _ in range(3)]
    card_runs = [host_path(1) for _ in range(3)]
    for label, other in (("CPU torch", outs["cpu"]),
                         ("numpy", np_runs[0][1]),
                         ("the card path with its copies", card_runs[0][1])):
        for a, b in zip(outs["cuda"], other):
            if not np.array_equal(a, np.asarray(b).astype(a.dtype)):
                raise AssertionError(f"10b: the card's triage differs "
                                     f"from {label}")
    dmaps = torch.from_numpy(maps).cuda()
    dverd = torch.from_numpy(verdicts).cuda()
    dev_ms = timed(lambda: triage_host_bitmaps(dmaps, dverd,
                                               *fresh("cuda")), 5)
    new_paths = int((outs["cuda"][0] > 0).sum())
    print(f"10b: triage of {HOST_B} host bitmaps ({int(outs['cuda'][1].sum())}"
          f" unique crashes of {int((verdicts == 2).sum())} crash lanes, "
          f"{new_paths} new paths): card == CPU torch == numpy (rets, uc, "
          f"uh, three maps); [ms, {card}] card device "
          f"{dev_ms:.3f}, card with its copies "
          f"{statistics.median(r[0] for r in card_runs):.1f}, CPU torch "
          f"{cpu_ms:.0f}, numpy "
          f"{statistics.median(r[0] for r in np_runs):.1f}", flush=True)
    return dev_ms


def host_flagships(fx, card):
    """10c: ``stdin afl havoc -b HOST_B`` through ``cli.main`` (the
    default pipeline depth, -fb 0), in turns: afl ``workers`` 8 with
    ``device_triage`` 0 then 1 (two batches each), then ``workers`` 1
    with ``device_triage`` 1 then 0 (one batch each).  Prints each
    run's execs/s and the share of its wall time the driver spent in
    ``mutate_batch_host``: waiting for the prefetched candidates' host
    copies (the first batch, with nothing prefetched, generates and
    copies there)."""
    from killerbeez_tpu_torch.mutators.base import Mutator
    plan = [(8, 0, 2), (8, 1, 2), (1, 1, 1), (1, 0, 1)]
    orig = Mutator.mutate_batch_host
    waited = [0.0]

    def timed_host(self, n):
        t0 = time.perf_counter()
        try:
            return orig(self, n)
        finally:
            waited[0] += time.perf_counter() - t0

    Mutator.mutate_batch_host = timed_host
    rows = []
    try:
        for i, (workers, dt, batches) in enumerate(plan):
            waited[0] = 0.0
            n_iter = batches * HOST_B
            _, log = host_run(OUT / f"host_afl_havoc_{i}", [
                "stdin", "afl", "havoc", "-n", str(n_iter), "-b",
                str(HOST_B), "-fb", "0", "-ss", "ABC@zzzz", "-m",
                json.dumps({"seed": MUT_SEED}),
                "-d", json.dumps({"path": fx["test"]}),
                "-i", json.dumps({"device_triage": dt, "workers": workers})],
                "cuda", depth=None)
            m = re.search(r"Ran (\d+) iterations in ([0-9.]+) seconds "
                          r"\(([0-9.]+) execs/s lifetime", log)
            if not m or int(m.group(1)) != n_iter:
                raise AssertionError(f"10c run {i} did not run every "
                                     "iteration")
            wall = float(m.group(2))
            rows.append(f"workers {workers} device_triage {dt}: "
                        f"{m.group(3)} execs/s, copy wait "
                        f"{waited[0] / wall:.4f} of {wall:.2f} s")
    finally:
        Mutator.mutate_batch_host = orig
    print(f"10c: stdin afl havoc -b {HOST_B} on {card} (in turns): "
          + "; ".join(rows), flush=True)


def host_debug_and_qemu(fx):
    """10d: ``-dt`` on the crasher (card == CPU ``.info`` text), and one
    ``ipt`` ``qemu_mode`` batch on the card: kb-trace in hash mode on
    the uninstrumented ``test-plain``, two execs of the crasher 'ABCD'
    (mutator nop) with a 60 s exec timeout — kb-trace's ptrace stops
    are slow on some kernels — which must both crash, with no hang or
    error.  Prints the execs' seconds and how many distinct (tip, tnt)
    pairs the two identical execs gave (1 when the trace is stable)."""
    dt = host_parity("host_debug_triage", [
        "stdin", "afl", "bit_flip", "-ss", "ABC@", "-dt",
        "-d", json.dumps({"path": fx["test"]})])
    if len(dt["info"]) != 1 or not next(iter(dt["info"].values())) \
            .startswith("SIGSEGV at pc="):
        raise AssertionError(f"-dt wrote {dt['info']}")
    t0 = time.perf_counter()
    q, _ = host_run(OUT / "host_ipt_qemu", [
        "stdin", "ipt", "nop", "-ss", "ABCD", "-n", "2", "-b", "2",
        "-fb", "0", "-d", json.dumps({"path": fx["test-plain"]}),
        "-i", json.dumps({"qemu_mode": 1, "timeout": 60})], "cuda")
    secs = time.perf_counter() - t0
    state = json.loads(q["isd"])
    if (q["counters"]["execs_done"] != "2"
            or len(q["findings"]["crashes"]) != 1
            or q["findings"]["hangs"] or state["total_execs"] != 2):
        raise AssertionError(f"ipt qemu_mode: {q}")
    print(f"10d: -dt card == CPU: {next(iter(dt['info'].values()))!r}; "
          f"ipt qemu_mode on the card: 2 execs of ABCD on test-plain in "
          f"{secs:.1f} s, both crashes, {len(state['hashes'])} distinct "
          "(tip, tnt) pair(s)", flush=True)


class Phases:
    """Prints each phase's wall time as the next one starts."""

    def __init__(self):
        self.name, self.t0 = None, time.perf_counter()

    def start(self, name):
        if self.name:
            print(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} "
                  "s wall", flush=True)
        self.name, self.t0 = name, time.perf_counter()


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
    phases = Phases()
    phases.start("1 (card, build)")
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
    phases.start("2 (kernels against their plain versions)")
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
    common = (instrs, table, *vk.seed_ring(seed, len(seed_bytes)), key,
              its, ms)

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

    # the ring form the generation loop launches: the seed is row 3 of a
    # ring of eight random rows with random lengths below L, read on the
    # card; then the -G shape, the flagship seed in slot 7 of 32
    err_ring, _ = ring_case(vk, instrs, table, key, its, ms, p1, ne, dev, L)
    err_gen, gen_args = ring_case(vk, instrs, table, key, its, ms, p1, ne,
                                  dev, L, seed, len(seed_bytes), 7, 32)
    print(f"kbz_fuzz_kernel ring form vs plain (slot 3 of 8 random rows; "
          f"slot 7 of 32 holding the seed): max_abs_err {err_ring}, "
          f"{err_gen}", flush=True)
    if err_ring or err_gen:
        raise AssertionError("kbz_fuzz_kernel's ring form disagrees with "
                             "its plain version")
    err_fuzz = max(err_fuzz, err_ring, err_gen)
    t_fuzz = timed(lambda: vk.fuzz_batch(*common, p1, ne, STACK_POW2), 7)
    t_fuzz_ring = timed(lambda: vk.fuzz_batch(*gen_args), 7)
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
          f"{t_fuzz_plain:.1f}; from slot 7 of a 32-slot ring "
          f"{t_fuzz_ring:.3f}); vm lane list {t_vm_list:.3f} (plain "
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
    phases.start("3 (flagship CLI, host-driven loop)")
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
    phases.start("4 (card == CPU)")
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

    # -- phase 5: the device-resident generation loop (-G) -------------
    phases.start("5a (-G dispatch parity)")
    gen_dispatch_parity()
    phases.start("5b (-G CLI parity)")
    gen_cli_parity()
    # the flagship at -G 16 (six dispatches) and the host-driven -fb 0
    # loop, in turns: -G, host, host, -G; the first -G run's launch
    # counts are the -G path's
    phases.start("5c (-G 16 flagship)")
    eps_gen = {"gen": [], "host": []}
    gen_launches = None
    for mode, name in (("gen", "flagship_g16"), ("host", "flagship_host"),
                       ("host", "flagship_host_2"),
                       ("gen", "flagship_g16_2")):
        if mode == "gen":
            got, rate = gen_flagship(name)
            gen_launches = gen_launches or got
        else:
            rate = flagship(name, "-fb", "0")[1]
        eps_gen[mode].append(rate)
    print(f"-G 16 execs/s on {card}: -G 16 at the default -fb "
          f"{', '.join(f'{r:.0f}' for r in eps_gen['gen'])}; host-driven "
          f"-fb 0 {', '.join(f'{r:.0f}' for r in eps_gen['host'])} (in "
          "turns: -G, host, host, -G)", flush=True)
    phases.start("5d (-G stages, idle share)")
    gen_stages(card)

    # -- phase 6: the mesh (--mesh dp,mp) ------------------------------
    phases.start("6a (mesh 4x2 parity on one card)")
    mesh_parity()
    phases.start("6b (mesh CLI parity)")
    mesh_cli_parity()
    # the --mesh 1,1 flagship host-driven and at -G 16 (default -fb),
    # in turns with the single-device host-driven -fb 0 flagship:
    # mesh, mesh -G, single, single, mesh -G, mesh; the first mesh and
    # mesh -G runs' launch counts are the mesh path's
    phases.start("6c (mesh flagship)")
    eps_mesh = {"mesh": [], "mesh_g16": [], "single": []}
    mesh_launches = []
    for mode, name in (("mesh", "mesh_flagship"),
                       ("mesh_g16", "mesh_flagship_g16"),
                       ("single", "single_fb0"), ("single", "single_fb0_2"),
                       ("mesh_g16", "mesh_flagship_g16_2"),
                       ("mesh", "mesh_flagship_2")):
        if mode == "single":
            rate = flagship(name, "-fb", "0", batches=MESH_BATCHES)[1]
        else:
            got, rate = mesh_flagship(
                name, *(["-G", "16"] if mode == "mesh_g16" else []))
            if name in ("mesh_flagship", "mesh_flagship_g16"):
                mesh_launches.append(got)
        eps_mesh[mode].append(rate)
    print(f"mesh flagship execs/s on {card} ({MESH_BATCHES} batches of {B}): "
          f"--mesh 1,1 {', '.join(f'{r:.0f}' for r in eps_mesh['mesh'])}; "
          f"--mesh 1,1 -G 16 "
          f"{', '.join(f'{r:.0f}' for r in eps_mesh['mesh_g16'])}; "
          f"single-device -fb 0 "
          f"{', '.join(f'{r:.0f}' for r in eps_mesh['single'])} (in turns: "
          "mesh, mesh -G, single, single, mesh -G, mesh)", flush=True)
    # the unfused cuda engine: havoc in torch ops, then kbz_vm_kernel
    # over every lane (the JAX mesh's pallas engine)
    vm_all_launches = flagship("mesh_cuda_engine", "--mesh", "1,1", "-fb",
                               "0", batches=8, engine="cuda",
                               need=("kbz_vm_kernel_all",))[0]
    phases.start("6d (mesh stages)")
    mesh_stages(card)

    # -- phase 7: the trace surface ------------------------------------
    phases.start("7a (stream engine)")
    stream_parity(vk, prng, card)
    phases.start("7b (ipt)")
    ipt_launches = ipt_runs(card)
    phases.start("7c (edges)")
    edges_launches = edges_runs(vk, card)
    phases.start("7d (rare-edge)")
    rare_launches = rare_edge_runs(vk, card)
    phases.start("7e (tracer, showmap)")
    tool_runs()

    # -- phase 8: every mutator but grammar ----------------------------
    phases.start("8a (mutators card == CPU)")
    files = mutator_files()
    mutator_parity(files)
    phases.start("8b (mutator CLI parity)")
    mutator_cli_parity(files, vk)
    phases.start("8c (unfused mutators at full width)")
    mut_launches = mutator_flagships(card)
    phases.start("8d (mutator stages)")
    mutator_stages(card, files, vk)

    # -- phase 10: the host-execution tier (no kernel on its path) -----
    phases.start("10 (host-execution tier)")
    fx = host_build()
    host_cli_parity(fx)
    host_triage(fx, card)
    host_flagships(fx, card)
    host_debug_and_qemu(fx)

    # -- phase 9: the record -------------------------------------------
    phases.start("9 (record)")
    print(f"main-path launches: host-driven {launches}, -G 16 "
          f"{gen_launches}, --mesh 1,1 {mesh_launches[0]}, --mesh 1,1 -G "
          f"16 {mesh_launches[1]}, --mesh 1,1 engine cuda "
          f"{vm_all_launches}, ipt {ipt_launches}, edges {edges_launches}, "
          f"rare-edge {rare_launches}, mutators {mut_launches}; over this "
          f"whole run: {vk.LAUNCHES}, of which in its CLI runs "
          f"{CLI_LAUNCHES}",
          flush=True)
    launches = {k: launches[k] + gen_launches[k] + mesh_launches[0][k]
                + mesh_launches[1][k] + edges_launches[k] + rare_launches[k]
                for k in launches}
    all_lanes = (vm_all_launches["kbz_vm_kernel_all"]
                 + ipt_launches["kbz_vm_kernel_all"]
                 + rare_launches["kbz_vm_kernel_all"]
                 + sum(m["kbz_vm_kernel_all"]
                       for m in mut_launches.values()))
    kernels = [
        {"name": "kbz_fuzz_kernel", "route": "cuda", "source": SOURCE,
         "replaces": f"{REF}:566", "launches": launches["kbz_fuzz_kernel"],
         "max_abs_err": err_fuzz, "ms": t_fuzz, "plain_ms": t_fuzz_plain,
         "bound_ms": b_fuzz, "bound_by": by_fuzz, "library_ms": None},
        {"name": "kbz_vm_kernel", "route": "cuda", "source": SOURCE,
         "replaces": f"{REF}:311", "launches": launches["kbz_vm_kernel"],
         "max_abs_err": err_part, "ms": t_vm_list,
         "plain_ms": t_vm_list_plain, "bound_ms": b_vm, "bound_by": by_vm,
         "library_ms": None},
        {"name": "kbz_vm_kernel (all lanes)", "route": "cuda",
         "source": SOURCE, "replaces": f"{REF}:297",
         "launches": all_lanes,
         "max_abs_err": err_full, "ms": t_vm_all,
         "plain_ms": t_vm_all_plain, "bound_ms": b_all, "bound_by": by_all,
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
