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
  11. (run before the record) the crack and search tier: (a) the
     branch-distance engine (plain torch on the card) == the CPU on
     4096 lanes of ``tlvstack_vm`` and ``magicsum_vm`` with operand
     capture on and off (the five ``VMResult`` fields, the float32
     distances, the captures), focused ``havoc``, ``zzuf`` and ``afl``
     (havoc tail) candidates at 65536 lanes == the CPU, a masked
     65536-lane batch of the ``cuda_fused`` flagship running
     ``kbz_vm_kernel`` over every lane and the next, unmasked one
     ``kbz_fuzz_kernel``, the device
     descent stepped == in-scan on the card, and the distance engine's
     device ms per 1024-lane dispatch at ``magicsum_vm``'s 512 steps;
     (b) card == CPU through ``cli.main`` at ``PIPELINE_DEPTH = 1``,
     ``-b 1024 -K 1``: ``--crack 2`` on ``test`` from a blind seed (the
     solver finds 'ABCD' and its crash), ``--crack 2 --vsa`` on
     ``cgc_like``, ``--crack 2 --descend 16`` with each descent engine
     on ``magicsum_vm`` (edge 4:5 descended) — md5 sets, ``-isd`` (its
     ``total_execs`` apart by exactly the short tail batch's pad, which
     the unfused CPU engine counts and the fused one does not, as in
     the JAX package), ``-msd``, the solver cache and the
     ``solver_*``/``search_*`` counters — and kb-solve, kb-lint and kb-descend card == CPU; (c)
     the crack campaign at full width (``-b 65536``, ``cuda_fused``,
     ``--crack 2 --descend 48``, device engine) on ``magicsum_vm`` in
     turns with the same command without ``--crack``: a plateau, an
     injection, ``kbz_fuzz_kernel`` and ``kbz_vm_kernel_all`` launches,
     each run's execs/s and the crack's solve and descent seconds
     beside the card's name and power limit;
  12. (run before the record) the stateful session tier, which has no
     kernel on its path (the session executor is plain torch on the
     card, as the JAX package's is plain XLA): (a) the session executor
     and both state triages card == CPU on 65536 havoc mutants of each
     stateful target's framed seed (all eight ``SessionResult`` fields,
     the rets and ``virgin_state``), its event-span ms per batch and its
     host waits (counted by sync debug mode "warn"); (b) ``--stateful``
     campaigns card == CPU through ``cli.main`` at ``PIPELINE_DEPTH =
     1``, ``-b 1024`` on ``tcp_like``: host-driven at ``-fb 0`` and the
     default ``-fb``, ``-G 4``, ``--mesh 1,1`` host-driven and at ``-G
     4`` (md5 sets, ``-isd`` with ``virgin_state``, ``-msd``, picks,
     counters, the ``state_sig`` sidecars; no kernel launched), then
     merger, tracer + minimize and picker card == CPU; (c) per target,
     ``--stateful -b 65536`` (32 batches, throughput novelty, seed 7),
     the same bytes single-shot on ``cuda_fused``, and ``--stateful -G
     16``, in turns: execs/s, states seen, state x edge pairs and
     deep-state edges hit, with the JAX bench's gate (>= 1 deep-state
     edge with ``--stateful``, none without) and no kernel launched by
     the stateful runs;
  13. (run before the record) the grammar tier and the target zoo: (a)
     ``grammar_havoc_at`` on 65536 lanes on the card, == the CPU on
     the first 16384 (bytes and lengths) with the degenerate tables and the grammar of each gated
     zoo instance (``models/zoo.GATED_NAMES``), on the card the
     degenerate tables == ``havoc_at``, and its event-span ms per batch;
     (b) through ``cli.main`` at ``PIPELINE_DEPTH = 1``, ``-b 1024`` on
     ``zoo:tlv:depth=2,bug=1``, card == CPU: havoc with the harness's
     ``grammar`` option at ``-G 4``, the same at ``--mesh 1,1 -G 4``,
     and the host-driven ``grammar`` mutator (md5 sets, ring
     admissions, ``-isd``, ``-msd``, counters; ``kbz_vm_kernel``
     launched on the card); (c) per gated instance at ``-b 65536`` (32
     batches), in turns: the structured lane (``-G 16`` with the
     grammar), the blind lane (the same without it) and the grammar
     mutator host-driven: execs/s and whether each hit the certified
     deep edge, with the gate that the structured lane hits it on every
     instance; (d) ``kbz-supervise`` on the card over a small campaign
     with one injected device loss: exit 0, a clean last exit, findings
     equal to a fault-free control run, then kb-corpus, kb-timeline and
     kb-stats ``--once`` on its output;
  14. (run before the record) the learn tier and the fleet: (a) the
     byte-saliency model on the card against the CPU from one seeded
     label buffer (32 seeds of 64 bytes): version-0 logits exactly 0
     and all-ones masks, two ``train_round``s (8 steps x 256 samples)
     with parameters and logits within LEARN_TOL, masks equal where
     every logit is LEARN_MARGIN clear of 0 (asserted), their ms and
     ``masked_saliency``'s; ``havoc_mask_at`` on 65536 lanes card ==
     CPU for an all-ones mask (== ``havoc_at``), a random and an
     all-zero mask, timed; (b) ``run_batch_generations`` with the learn
     tier card == CPU (1000 lanes padded to 1024, G = 4, reseeding on
     and off, version-0 and carried trained weights), then the CLI
     with a learn tier that never trains: ``-G 4`` card == CPU == the
     run without ``--learn``, host-driven at ``PIPELINE_DEPTH = 1``,
     and ``--mesh 1,1 -G 4`` card == CPU; (c) the flagship at ``-G 16``
     for 96 batches with ``--learn --learn-interval 0.5`` (masked havoc
     feeding ``kbz_vm_kernel`` over every lane) in turns with the same
     run without ``--learn``, with the gate that the model trained, and
     ``--resume`` restoring the model version; (d) a manager in this
     process, two jobs of the flagship, and beside each a CLI at the
     flagship width syncing and gossiping under the job's campaign
     key, then two concurrent worker subprocesses with gossip claiming
     the jobs: both jobs done, rows of both workers and both CLIs in
     the manager's corpus, each worker pulling its CLI's entries,
     heartbeats, findings assimilated, ``/metrics`` with
     ``kbz_manager_degraded``, and each process's kernel launches
     printed on a line of their own;
  15. (run before the record) the hybrid bridge and conformance repair,
     on target test from ABCD and 60 zero bytes (havoc seed 7): (a)
     ``proxy_verdict`` of the bindings test and test_safe on the card,
     one launch of ``kbz_vm_kernel`` over a one-lane batch per verdict
     (counted: no fallback to the plain VM), on ABCD, hello, the empty
     input and 1024 seeded random inputs == the CPU's plain VM, and
     ``certify_binding`` of test, test_safe and a miswired binding card
     == CPU, with the event-span ms of one one-lane verdict and the host
     ms per verdict call; (b) ``--hybrid test`` and ``--hybrid
     test_safe`` at ``-b 64 -n 512``, host-driven and at ``-G 4``, card
     (cuda_fused) == CPU through ``cli.main`` at ``PIPELINE_DEPTH = 1``
     with ``--hybrid-workers 0`` (md5 sets, ``cross_tier_validate`` and
     ``proxy_gap`` events, finding sidecars, gap reports and index,
     ``hybrid_*`` counters; every finding validated, none dropped); (c)
     ``--hybrid test_safe --auto-repair 1`` installs
     ``test_safe+repaired`` (card == CPU), kb-repair ``--probe --apply
     --require-repaired`` on the card == the CPU's (the same blamed pc
     and patch), and kb-lint ``--gaps-dir --gap-backlog 0 --sarif`` is
     clean after it; (d) ``-b 65536`` on test (cuda_fused) with
     ``--hybrid test`` and without, in turns (with, without, without,
     with), 32 batches each: execs/s, ``hybrid_validations``,
     ``hybrid_confirmed``, the deepest and oldest validation queue seen
     at a fold, and each kernel's launches; these run at ``-fb 0`` from
     ABCC and 60 zero bytes, since from the padded ABCD a quarter of
     the lanes are distinct crashing inputs and writing their files
     takes the run;
  16. (run before the record) the device spans (telemetry/device.py):
     a ``-b 65536`` cuda_fused campaign of ``SPANS_SECONDS`` with
     ``--trace`` and ``--profile-device 16``, built as the CLI builds
     it: its ``trace.json`` holds a ``device`` lane with each batch's
     ``kernels``, ``triage`` and ``report`` spans on the host's clock
     and a ``clock_sync`` instant; printed as one ``{"device_spans":
     ...}`` line: the counters of the spans and of the new stages, the
     anchor's drift against the host's clock at the run's end (an
     event the host brackets by two clock reads, placed by the
     anchor), and, with the device trace placed on the host's
     clock by the marker kernel of the ``clock_sync``, how far after
     each captured batch's ``kernels`` span starts its
     ``kbz_fuzz_kernel`` starts, and how far before the span ends its
     phase-2 ``kbz_vm_kernel`` ends (both at least 0 when the two
     traces align; their least values bound the alignment's error);
  17. (run before the record; alone: ``python -c 'import chip_smoke;
     chip_smoke.triage_kernels(chip_smoke.card_line())'``) the
     throughput-triage kernels (``csrc/triage.cu``) alone, on
     tlvstack_vm's fused batches of 262144 and of 65536 lanes: card ==
     CPU (the plain version on the batch's CPU copy) against fresh maps
     and against maps four earlier batches have seen, their device ms
     beside the bound (the operations of
     ``benchmark/kbbench/arith.triage_ops``, the counts' bytes) and the
     plain chain's device ms on the card, and the host ms to enqueue
     them;
  9. prints one ``{"kernels": [...]}`` line (launches: the first
     host-driven, the first ``-G 16``, the first mesh, the first edges,
     the first rare-edge, the first crack flagship, the first
     single-shot run of phase 12c and the first hybrid run of phase 15d
     together;
     the all-lanes ``kbz_vm_kernel`` row from the mesh's cuda-engine
     run, the unfiltered ``ipt`` run, the rare-edge run's signer, phase
     8c's afl, zzuf and honggfuzz runs, the first crack flagship run,
     phase 13c's structured and grammar-mutator runs, phase 14c's
     learn runs and the first hybrid run's certification), then the
     card line, then the result line ``{"ok": true, "device": {...}}``
     last.  Each phase's wall
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
import signal
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
#: phase 16's campaign length: a benchmark window's (BENCHMARK.json
#: ``run_seconds``), over which the anchor's drift is read
SPANS_SECONDS = 51.0
SOURCE = "killerbeez_tpu_torch/csrc/vm_kernel.cu"
REF = "killerbeez_tpu/ops/vm_kernel.py"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out.splitlines()[0]


def vm_launches(launches: dict) -> dict:
    """The VM kernels' launch counts: all but the triage kernels', which
    judge the session tier's classic map too."""
    return {k: v for k, v in launches.items() if k != "kbz_triage"}


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
    default pipeline depth, -fb 0), in turns, one batch each: afl
    ``workers`` 8 with ``device_triage`` 0 then 1, then ``workers`` 1
    with ``device_triage`` 1 then 0.  Prints each
    run's execs/s and the share of its wall time the driver spent in
    ``mutate_batch_host``: waiting for the prefetched candidates' host
    copies (the first batch, with nothing prefetched, generates and
    copies there)."""
    from killerbeez_tpu_torch.mutators.base import Mutator
    plan = [(8, 0, 1), (8, 1, 1), (1, 1, 1), (1, 0, 1)]
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


# -- the crack and search tier (phase 11) ---------------------------------

#: phase 11c's full-width crack run length, in batches of B
CRACK_BATCHES = 48


def crack_seeds():
    """Phase 11's seed files: a blind 8-byte seed (test, cgc_like) and
    magicsum_vm's registered seed."""
    from killerbeez_tpu_torch.models import targets_cgc
    files = {"blind": OUT / "crack_blind.bin",
             "magicsum": OUT / "crack_magicsum.bin"}
    files["blind"].write_bytes(b"\x00" * 8)
    files["magicsum"].write_bytes(targets_cgc.VM_SEEDS["magicsum_vm"][0]())
    return files


def distance_parity(card):
    """11a: the distance engine, focused candidates and the device
    descent, card against CPU; the distance engine's device time."""
    import numpy as np
    from killerbeez_tpu_torch.models.targets import get_target
    from killerbeez_tpu_torch.models.vm import run_batch_distances
    from killerbeez_tpu_torch.mutators import mutator_factory
    from killerbeez_tpu_torch.search import DeviceDescent
    from killerbeez_tpu_torch.search.objective import edge_objectives
    from killerbeez_tpu_torch.tools.timing import timed
    gen = torch.Generator().manual_seed(MUT_SEED)
    for name in ("tlvstack_vm", "magicsum_vm"):
        prog = get_target(name)
        specs = tuple(o.spec() for f, t in zip(prog.edge_from, prog.edge_to)
                      for o in edge_objectives(prog, (int(f), int(t))))[:8]
        x = torch.randint(0, 256, (4096, 64), generator=gen,
                          dtype=torch.uint8)
        y = torch.randint(0, 65, (4096,), generator=gen, dtype=torch.int32)
        for capture in (False, True):
            cpu = run_batch_distances(prog, x, y, specs, capture)
            dev = run_batch_distances(prog, x.cuda(), y.cuda(), specs,
                                      capture)
            err = max_abs_err(
                list(cpu[0][:5]) + [cpu[1].view(torch.int32)]
                + list(cpu[2:]),
                [t.cpu() for t in list(dev[0][:5])
                 + [dev[1].view(torch.int32)] + list(dev[2:])])
            if err:
                raise AssertionError(f"distance engine: card != CPU on "
                                     f"{name} (capture {capture})")
        print(f"distance engine ({name}, 4096 lanes, {len(specs)} specs, "
              "capture off and on): card == CPU on every VMResult field, "
              "the distances and the captures", flush=True)
    seed = (OUT / "seed.bin").read_bytes()
    for name, opts in (("havoc", {"seed": MUT_SEED}),
                       ("zzuf", {"seed": MUT_SEED}),
                       ("afl", {"seed": MUT_SEED,
                                "skip_deterministic": 1})):
        muts = {d: mutator_factory(name, json.dumps(opts), seed, device=d)
                for d in ("cuda", "cpu")}
        for m in muts.values():
            m.set_focus_mask([0, 3, 9, 17, 33])
        got, ref = muts["cuda"].mutate_batch(B), muts["cpu"].mutate_batch(B)
        if max_abs_err([t.cpu() for t in got], ref):
            raise AssertionError(f"focused {name}: card != CPU")
    print(f"focused havoc, zzuf, afl (havoc tail) at {B} lanes: card == "
          "CPU (bytes, lengths)", flush=True)
    # a mask stands the fused path down: the flagship's driver runs the
    # focused candidates through kbz_vm_kernel over every lane, and the
    # fused kernel again once the mask clears
    from killerbeez_tpu_torch.drivers.factory import driver_factory
    from killerbeez_tpu_torch.instrumentation.factory import \
        instrumentation_factory
    from killerbeez_tpu_torch.ops.vm_kernel import LAUNCHES
    instr = instrumentation_factory("jit_harness", json.dumps(
        {"target": "tlvstack_vm", "engine": "cuda_fused",
         "novelty": "throughput"}))
    mut = mutator_factory("havoc", json.dumps({"seed": MUT_SEED}), seed)
    drv = driver_factory("file", None, instr, mut)
    twin = mutator_factory("havoc", json.dumps({"seed": MUT_SEED}), seed,
                           device="cpu")
    for m in (mut, twin):
        m.set_focus_mask([0, 3, 9, 17, 33])
    before = dict(LAUNCHES)
    out = drv.test_batch(B)
    masked = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    if masked != {"kbz_fuzz_kernel": 0, "kbz_vm_kernel": 0,
                  "kbz_vm_kernel_all": 1} or \
            max_abs_err([out.inputs.cpu(), out.lengths.cpu()],
                        twin.mutate_batch(B)):
        raise AssertionError(f"a focus mask did not stand the fused path "
                             f"down ({masked})")
    mut.set_focus_mask(None)
    before = dict(LAUNCHES)
    drv.test_batch(B)
    if LAUNCHES["kbz_fuzz_kernel"] != before["kbz_fuzz_kernel"] + 1:
        raise AssertionError("fusion did not resume once the mask cleared")
    torch.cuda.synchronize()
    print(f"focus mask on the cuda_fused flagship ({B} lanes): the masked "
          f"batch ran kbz_vm_kernel over every lane ({masked}) on the "
          "focused candidates (== CPU), the next one kbz_fuzz_kernel",
          flush=True)
    prog = get_target("magicsum_vm")
    runs = []
    for si, n in ((1, 8), (8, 1)):
        eng = DeviceDescent(prog, (2, 4), [bytes(6)], lanes=256,
                            scan_iters=si, i2s=False)
        rows = [r for _ in range(n) for r in eng.dispatch()]
        runs.append((eng.elite_front(), rows, eng.witnesses_total,
                     eng.best_primary))
    for a, b in zip(runs[0][0], runs[1][0]):
        if not np.array_equal(a, b):
            raise AssertionError("device descent: stepped != in-scan")
    if runs[0][1:] != runs[1][1:]:
        raise AssertionError("device descent: witnesses differ")
    print("device descent on the card (magicsum_vm 2:4, 8 iterations, "
          f"{eng.lanes} lanes): stepped == in-scan (elite order, "
          "witnesses)", flush=True)
    specs = tuple(o.spec() for o in edge_objectives(prog, (4, 5)))
    x = torch.randint(0, 256, (1024, 64), generator=gen,
                      dtype=torch.uint8).cuda()
    y = torch.randint(0, 65, (1024,), generator=gen,
                      dtype=torch.int32).cuda()
    # the engine waits on the card every 16 steps to retire lanes, so
    # the span between its events holds the host's enqueue gaps too
    t = timed(lambda: run_batch_distances(prog, x, y, specs, True), 3)
    print(f"distance engine: {t:.3f} ms event span per 1024-lane "
          f"dispatch (magicsum_vm, max_steps {prog.max_steps}, "
          f"{len(specs)} specs, capture on; median of 3) on {card}",
          flush=True)


def crack_state(out: Path):
    """What the card and the CPU must agree on in a crack run: the
    in-process summary plus the checkpoint's solver cache, VSA document
    and solver/search counters."""
    ck = json.loads((out / "corpus" / "checkpoint.json").read_text())
    counters = ck["campaign"]["counters"]
    return {"solver": ck.get("solver"), "vsa": ck.get("vsa"),
            "counters": {k: v for k, v in counters.items()
                         if k.startswith(("solver_", "search_"))}}


def crack_cli_parity(seeds):
    """11b: crack campaigns card == CPU at PIPELINE_DEPTH = 1, and the
    three tools."""
    from killerbeez_tpu_torch.tools import descend_tool, lint_tool, \
        solve_tool
    cases = (("test", "blind", ["--crack", "2"]),
             ("cgc_like", "blind", ["--crack", "2", "--vsa"]),
             ("magicsum_vm", "magicsum", ["--crack", "2", "--descend", "16",
                                          "--descend-engine", "host"]),
             ("magicsum_vm", "magicsum", ["--crack", "2", "--descend", "16",
                                          "--descend-engine", "device"]))
    for target, seed, extra in cases:
        got = {}
        label = f"{target} {' '.join(extra)}"
        for dev, engine in (("cuda", "cuda_fused"), ("cpu", "torch")):
            out = OUT / f"crack_{target}_{extra[-1]}_{dev}"
            # -K 1: the card's fused path runs batch by batch, so the
            # plateau check runs after every batch as on the CPU (a
            # superbatch checks it once per K batches)
            got[dev] = inprocess(
                out, "-b", "1024", "-n", "16384", "-K", "1",
                "--device", dev,
                "--corpus-dir", str(out / "corpus"), "-i",
                json.dumps({"target": target, "engine": engine,
                            "novelty": "throughput"}), *extra,
                mopts={"seed": 11}, seed=seeds[seed])
            got[dev].update(crack_state(out))
        # the injected lanes count toward -n, so the run ends on a short
        # tail batch; the reference's fused engine counts that batch's
        # requested lanes in total_execs, its unfused engine the padded
        # rows (JAX jit_harness.py:606-609 against :509), and the port
        # keeps both: the card's fused count is the CPU's less the pad
        injected = int(got["cpu"]["counters"].get("solver_injected", 0))
        pad = -(16384 - injected) % 1024
        isd = {d: json.loads(got[d].pop("isd")) for d in got}
        if isd["cuda"].pop("total_execs") + pad != \
                isd["cpu"].pop("total_execs"):
            raise AssertionError(f"crack campaign ({label}): total_execs "
                                 "differs by more than the tail's pad")
        if got["cuda"] != got["cpu"] or isd["cuda"] != isd["cpu"]:
            diff = [k for k in got["cuda"] if got["cuda"][k] != got["cpu"][k]]
            raise AssertionError(f"crack campaign ({label}): card != CPU "
                                 f"in {diff or ['isd']}")
        g = got["cuda"]
        if not g["counters"].get("solver_attempts"):
            raise AssertionError(f"crack campaign ({label}) never cracked")
        if target == "test" and not (
                any(v.get("input_hex") == b"ABCD".hex()
                    for v in g["solver"].values())
                and g["findings"]["crashes"]):
            raise AssertionError("the solver did not find 'ABCD' and its "
                                 "crash")
        if "--vsa" in extra and g["vsa"] is None:
            raise AssertionError("--vsa cached no VSA document")
        if target == "magicsum_vm" and \
                g["solver"].get("4:5", {}).get("status") != "descended":
            raise AssertionError(f"crack campaign ({label}): edge 4:5 not "
                                 "descended")
        print(f"crack campaign ({label}, -b 1024, PIPELINE_DEPTH 1): card "
              f"== CPU ({len(g['findings']['new_paths'])} new paths, "
              f"{len(g['findings']['crashes'])} crashes, counters "
              f"{g['counters']}, equal -msd, solver cache and -isd maps; "
              f"total_execs apart by the tail's pad of {pad})", flush=True)

    def tool(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        return rc, buf.getvalue()

    for label, main, argv, per_device in (
            ("kb-solve", solve_tool.main, ["magicsum_vm", "--json"], False),
            ("kb-lint", lint_tool.main, ["--json", "--vsa"], False),
            ("kb-descend", descend_tool.main,
             ["magicsum_vm", "--lanes", "256", "--budget", "8", "--json",
              "--edge", "4:5"], True)):
        outs = [tool(main, argv + (["--device", d] if per_device else []))
                for d in ("cuda", "cpu")]
        if outs[0] != outs[1]:
            raise AssertionError(f"{label}: card output != CPU output")
        print(f"{label} {' '.join(argv)}: exit {outs[0][0]}, card output "
              "== CPU output", flush=True)


def crack_flagships(card, seeds):
    """11c: the crack campaign at full width in turns with the same
    command without --crack; returns the first crack run's launches."""
    iopts = {"target": "magicsum_vm", "engine": "cuda_fused",
             "novelty": "throughput"}
    crack_args = ["--crack", "2", "--descend", "48",
                  "--descend-engine", "device"]
    rates = {"crack": [], "plain": []}
    first = None
    for mode, name in (("crack", "crack_flagship"),
                       ("plain", "crack_plain"), ("plain", "crack_plain_2"),
                       ("crack", "crack_flagship_2")):
        args = (crack_args + ["--corpus-dir", str(OUT / name / "corpus")]
                if mode == "crack" else [])
        need = (("kbz_fuzz_kernel", "kbz_vm_kernel_all")
                if mode == "crack" else ("kbz_fuzz_kernel",))
        launches, rate, out = flagship(
            name, *args, batches=CRACK_BATCHES, iopts=iopts, need=need,
            seed=seeds["magicsum"])
        rates[mode].append(rate)
        if mode != "crack":
            continue
        first = first or launches
        evs = events(out)
        kinds = {e["type"] for e in evs}
        if not {"plateau", "crack_injection"} <= kinds:
            raise AssertionError(f"{name}: no plateau or no injection")
        counters = crack_state(out)["counters"]
        if not counters.get("solver_injected"):
            raise AssertionError(f"{name}: nothing injected")
        log = (OUT / f"{name}.log").read_text()
        solve = re.search(r"solve attempts \(([0-9.]+)s\)", log)
        descend = re.search(r"descend: .* \(([0-9.]+)s\)", log)
        print(f"crack flagship ({name}): {counters}; solve "
              f"{solve.group(1) if solve else 'n/a'} s (descent included), "
              f"descent {descend.group(1) if descend else 'n/a'} s; "
              f"descents {[(e['edge'], e['status'], e['dispatches']) for e in evs if e['type'] == 'descent']}",
              flush=True)
    print(f"crack flagship execs/s on {card} ({CRACK_BATCHES} batches of "
          f"{B}, magicsum_vm): --crack 2 --descend 48 "
          f"{', '.join(f'{r:.0f}' for r in rates['crack'])}; without "
          f"--crack {', '.join(f'{r:.0f}' for r in rates['plain'])} (in "
          "turns: crack, plain, plain, crack)", flush=True)
    return first


# -- the stateful session tier (phase 12) ---------------------------------

#: phase 12c's full-width run length, in batches of B: the session
#: executor is plain torch ops bound by the host's op issue (0.3 to
#: 0.6 s per 65536-lane batch end to end), so the JAX bench's 48
#: batches are cut to 32 to keep phase 12 near two minutes
STATEFUL_BATCHES = 32
STATEFUL_TARGETS = ("tcp_like", "session_auth")


def stateful_seeds():
    """Each stateful target's framed seed as a file (the JAX bench's
    stateful lane's seed, ``framed_seed``)."""
    from killerbeez_tpu_torch.models import targets_stateful as ts
    out = {}
    for name in STATEFUL_TARGETS:
        out[name] = OUT / f"seq_{name}.bin"
        out[name].write_bytes(ts.framed_seed(name))
    return out


def session_parity(card):
    """12a: the session executor and both state triages, card == CPU, on
    B havoc mutants of each target's framed seed; the executor's
    event-span ms per batch and its host waits."""
    import warnings
    from killerbeez_tpu_torch.models import targets_stateful as ts
    from killerbeez_tpu_torch.models.targets import get_target
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator
    from killerbeez_tpu_torch.ops.vm_kernel import LAUNCHES
    from killerbeez_tpu_torch.stateful import coverage as sc
    from killerbeez_tpu_torch.stateful.session import run_session_batch
    from killerbeez_tpu_torch.tools.timing import timed
    for name in STATEFUL_TARGETS:
        prog, spec = get_target(name), ts.get_stateful_spec(name)
        mut = HavocMutator(json.dumps({"seed": 7}), ts.framed_seed(name),
                           device="cpu")
        bufs, lens = mut.mutate_batch(B)
        before = dict(LAUNCHES)
        got = run_session_batch(prog, bufs.cuda(), lens.cuda(), spec)
        ref = run_session_batch(prog, bufs, lens, spec)
        err = max_abs_err([t.cpu() for t in got], ref)
        v0 = sc.fresh_virgin_state(spec.n_states, prog.n_edges)
        for tri in (sc.state_triage, sc.state_triage_exact):
            err = max(err, max_abs_err(
                [t.cpu() for t in tri(v0.cuda(), got.se_counts)],
                tri(v0, ref.se_counts)))
        if err or LAUNCHES != before:
            raise AssertionError(f"session executor ({name}): card != CPU "
                                 f"(max_abs_err {err}) or a kernel "
                                 "launched")
        args = (prog, bufs.cuda(), lens.cuda(), spec)
        t_exec = timed(lambda: run_session_batch(*args), 3)
        t_tri = {tri.__name__: timed(lambda: tri(v0.cuda(), got.se_counts),
                                     5)
                 for tri in (sc.state_triage, sc.state_triage_exact)}
        # host waits: every read of a card value the executor makes
        # (lane retirement every 16 steps), counted by sync debug mode
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run_session_batch(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        waits = sum("synchroniz" in str(w.message) for w in caught)
        status = got.status.cpu()
        print(f"session executor ({name}, {B} havoc mutants of the framed "
              f"seed): card == CPU on all eight SessionResult fields and "
              f"both triages' rets and virgin_state (max_abs_err 0; "
              f"{int((status == 2).sum())} crashes, "
              f"{int((status == 3).sum())} hangs, "
              f"{int(got.msgs.sum())} messages, "
              f"{int(got.steps.sum())} VM steps); event span "
              f"{t_exec:.3f} ms per batch with {waits} host waits; state "
              f"triage {t_tri['state_triage']:.3f} ms, exact "
              f"{t_tri['state_triage_exact']:.3f} ms [{card}]", flush=True)


def stateful_cli_parity(seeds):
    """12b: --stateful campaigns card == CPU at -b 1024 with
    PIPELINE_DEPTH = 1 (host-driven at -fb 0 and the default -fb, -G 4,
    --mesh 1,1 host-driven and at -G 4), none launching a VM kernel; then
    merger, minimize and picker card == CPU."""
    from killerbeez_tpu_torch.ops.vm_kernel import LAUNCHES
    # the default -fb rotates after 8 batches, so that case runs 12
    cases = (("fb0", ["-n", "4096", "-fb", "0"]),
             ("default", ["-n", "12288"]),
             ("g4", ["-n", "4096", "-G", "4"]),
             ("mesh", ["-n", "4096", "-fb", "0", "--mesh", "1,1"]),
             ("mesh_g4", ["-n", "4096", "-G", "4", "--mesh", "1,1"]))
    isds = {}
    for label, extra in cases:
        got = {}
        for dev in ("cuda", "cpu"):
            out = OUT / f"stateful_{label}_{dev}"
            before = dict(LAUNCHES)
            got[dev] = inprocess(
                out, "-b", "1024", "--stateful", "--device", dev,
                "--corpus-dir", str(out / "corpus"), "-i",
                json.dumps({"target": "tcp_like",
                            "novelty": "throughput"}), *extra,
                mopts={"seed": 7}, seed=seeds["tcp_like"])
            if vm_launches(LAUNCHES) != vm_launches(before):
                raise AssertionError(f"--stateful ({label}) launched a "
                                     "VM kernel")
            got[dev]["sigs"] = sorted(
                (p.name, json.loads(p.read_text())["state_sig"])
                for p in (out / "corpus").glob("*.json")
                if len(p.stem) == 32)
            isds[label, dev] = Path(f"{out}.isd")
        if got["cuda"] != got["cpu"]:
            diff = [k for k in got["cuda"] if got["cuda"][k] != got["cpu"][k]]
            raise AssertionError(f"--stateful ({label}): card != CPU in "
                                 f"{diff}")
        g = got["cuda"]
        if not (g["findings"]["new_paths"] and g["sigs"]):
            raise AssertionError(f"--stateful ({label}) found nothing")
        vs = json.loads(g["isd"])
        print(f"--stateful {' '.join(extra)} (tcp_like, -b 1024, "
              f"PIPELINE_DEPTH 1): card == CPU "
              f"({len(g['findings']['new_paths'])} new paths, "
              f"{len(g['findings']['crashes'])} crashes, picks "
              f"{g['picks']}, {len(g['sigs'])} state_sig sidecars, equal "
              f"-isd with virgin_state (spec {vs['stateful']}), -msd and "
              f"counters {g['counters']}; no kernel launched)", flush=True)
    stateful_tool_parity(seeds, isds)


def stateful_tool_parity(seeds, isds):
    """merger (the -fb 0 and -G 4 runs' states), tracer + minimize (over
    the -fb 0 run's new paths) and picker (the two seeds) on the card
    and on the CPU: the same output files."""
    from killerbeez_tpu_torch.tools import merger, minimize, picker, tracer
    iopts = json.dumps({"target": "tcp_like", "stateful": 1})
    inputs = sorted((OUT / "stateful_fb0_cpu" / "new_paths").iterdir())[:8]
    files = {}
    for dev in ("cuda", "cpu"):
        d = OUT / f"stateful_tools_{dev}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        quiet = ["-l", '{"level": 1}', "--device", dev]
        rc = merger.main(["jit_harness", str(isds["fb0", dev]),
                          str(isds["g4", dev]), "-i", iopts,
                          "-o", str(d / "merged.state"), *quiet])
        edges = []
        for i, path in enumerate(inputs):
            edges.append(str(d / f"edges_{i:02d}.txt"))
            rc |= tracer.main(["file", "jit_harness", "-sf", str(path),
                               "-i", iopts, "-n", "2", "-o", edges[-1],
                               *quiet])
        rc |= minimize.main([*edges, "-o", str(d / "keep.txt"),
                             "-l", '{"level": 1}'])
        rc |= picker.main(["file", "jit_harness", str(seeds["tcp_like"]),
                           str(inputs[0]), "-n", "2", "-i", iopts,
                           "-o", str(d / "picker.json"), *quiet])
        if rc:
            raise AssertionError(f"a stateful tool failed on {dev}")
        (d / "keep.txt").write_text((d / "keep.txt").read_text()
                                    .replace(str(d), "DIR"))
        files[dev] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    if files["cuda"] != files["cpu"]:
        diff = [k for k in files["cuda"]
                if files["cuda"][k] != files["cpu"].get(k)]
        raise AssertionError(f"stateful tools: card != CPU in {diff}")
    rep = json.loads(files["cuda"]["picker.json"])
    print(f"merger, tracer + minimize ({len(inputs)} inputs, "
          f"{files['cuda']['keep.txt'].count(b'DIR')} kept) and picker "
          f"(states reached {rep['state']['states_reached']}, "
          f"{len(rep['state']['pairs'])} state x edge pairs): card == CPU",
          flush=True)


def deep_state_hits(name, isd: Path):
    """(deep-state edges hit, touched state x edge pairs, states seen)
    of a run's -isd state: deep edges read from their collision-free
    AFL slots, as the JAX bench's stateful lane reads them."""
    import numpy as np
    from killerbeez_tpu_torch.models import targets_stateful as ts
    from killerbeez_tpu_torch.models.targets import get_target
    from killerbeez_tpu_torch.stateful.coverage import state_coverage_stats
    from killerbeez_tpu_torch.utils.serialization import decode_array
    prog = get_target(name)
    deep = set(ts.deep_state_edges(prog))
    slots = np.asarray(prog.edge_slot)
    shallow = {int(slots[e]) for e in range(len(slots)) if e not in deep}
    deep_slots = sorted({int(slots[e]) for e in deep} - shallow)
    state = json.loads(isd.read_text())
    vb = decode_array(state["virgin_bits"])
    hit = sum(1 for s in deep_slots if vb[s] != 0xFF)
    if "virgin_state" not in state:
        return hit, None, None
    return (hit,) + state_coverage_stats(
        decode_array(state["virgin_state"]),
        ts.get_stateful_spec(name).n_states)


def stateful_flagships(card, seeds):
    """12c: per target, the sequence campaign (--stateful, -b 65536,
    STATEFUL_BATCHES, throughput novelty, seed 7 from the framed seed),
    the same bytes single-shot on engine cuda_fused, and --stateful -G
    16, in turns; the JAX bench's gate: >= 1 deep-state edge with --stateful,
    none without.  Returns the first single-shot run's launches."""
    from killerbeez_tpu_torch.ops.vm_kernel import LAUNCHES
    first = None
    rows = []
    for name in STATEFUL_TARGETS:
        iopts = {"target": name, "novelty": "throughput"}
        for mode, extra in (("seq", ["--stateful"]),
                            ("single", []),
                            ("seq_g16", ["--stateful", "-G", "16"])):
            run = f"stateful_{name}_{mode}"
            isd = OUT / f"{run}.isd"
            engine = {} if mode != "single" else {"engine": "cuda_fused"}
            before = dict(LAUNCHES)
            launches, rate, _ = flagship(
                run, *extra, "-isd", str(isd), batches=STATEFUL_BATCHES,
                iopts={**iopts, **engine}, mopts={"seed": 7},
                need=() if mode != "single" else ("kbz_fuzz_kernel",),
                seed=seeds[name])
            hit, pairs, states = deep_state_hits(name, isd)
            if mode == "single":
                first = first or launches
                if hit:
                    raise AssertionError(f"{name}: the single-shot run hit "
                                         f"{hit} deep-state edges — the "
                                         "unreachability proof is broken")
            else:
                if (any(vm_launches(launches).values())
                        or vm_launches(LAUNCHES) != vm_launches(before)):
                    raise AssertionError(f"{run} launched a VM kernel: "
                                         f"{launches}")
                if hit < 1:
                    raise AssertionError(f"{run} cracked no deep-state "
                                         "edge")
            rows.append(f"{name} {mode}: {rate:.0f} execs/s, deep-state "
                        f"edges hit {hit}"
                        + ("" if pairs is None else
                           f", states seen {states}, state x edge pairs "
                           f"{pairs}"))
    print(f"stateful flagships on {card} ({STATEFUL_BATCHES} batches of "
          f"{B}, in turns per target: --stateful, single-shot cuda_fused, "
          f"--stateful -G 16): " + "; ".join(rows), flush=True)
    return first


# -- the grammar tier and the zoo (phase 13) ------------------------------

#: phase 13c's full-width run length per lane, in batches of B (2097152
#: execs: two -G 16 dispatches, 64 times the JAX bench's grammar budget)
GRAMMAR_BATCHES = 32
#: phase 13a's CPU half: grammar_havoc_at on the first 16384 of the B
#: lanes (the CPU's torch ops took most of 13a's 67-90 s at B)
GRAMMAR_CPU_LANES = 16384
#: phase 13b's card-against-CPU runs: -b 1024, 16 batches
GRAMMAR_PARITY = ["-b", "1024", "-n", "16384"]


def zoo_files():
    """Each gated zoo instance's bundle, seed file and grammar file,
    written under OUT/zoo."""
    from killerbeez_tpu_torch.models.zoo import GATED_NAMES, build_zoo
    d = OUT / "zoo"
    d.mkdir(parents=True, exist_ok=True)
    files = {}
    for name in GATED_NAMES:
        t = build_zoo(name)
        stem = name.split(":")[1]
        (d / f"{stem}.seed").write_bytes(t.seed)
        (d / f"{stem}.json").write_text(t.grammar.to_json())
        files[name] = (t, d / f"{stem}.seed", d / f"{stem}.json")
    return files


def grammar_parity(card, files, vk, prng):
    """13a: grammar_havoc_at on B lanes on the card, == the CPU on the
    first GRAMMAR_CPU_LANES of them (bytes and lengths; tolerance: none;
    lanes are keyed by their iteration, so a prefix is the same lanes)
    with the degenerate tables and each gated instance's grammar, and on
    the card the degenerate tables against havoc_at on all B lanes; its
    event-span ms per B-lane batch and the host's enqueue ms.  Returns
    {grammar: event-span ms}."""
    from killerbeez_tpu_torch.grammar import compile_grammar
    from killerbeez_tpu_torch.grammar.device import grammar_havoc_at
    from killerbeez_tpu_torch.grammar.tables import degenerate_tables
    from killerbeez_tpu_torch.models.targets_cgc import tlvstack_vm_seed
    from killerbeez_tpu_torch.ops.mutate_core import havoc_at
    from killerbeez_tpu_torch.tools.timing import host_ms, timed
    cases = [("degenerate", degenerate_tables(), tlvstack_vm_seed())] + [
        (name, compile_grammar(t.grammar), t.seed)
        for name, (t, _, _) in files.items()]
    its = torch.arange(B, dtype=torch.int64)
    ms = {}
    for name, tables, sb in cases:
        seed = torch.zeros(64, dtype=torch.uint8)
        seed[:len(sb)] = torch.tensor(list(sb), dtype=torch.uint8)
        outs = []
        for dev, n in (("cuda", B), ("cpu", GRAMMAR_CPU_LANES)):
            keys = prng.fold_in(prng.key(MUT_SEED, device=dev),
                                its[:n].to(dev))
            args = (seed.to(dev), len(sb), keys, tables, tables.device(dev))
            outs.append(grammar_havoc_at(*args))
        err = max_abs_err([t[:GRAMMAR_CPU_LANES].cpu() for t in outs[0]],
                          outs[1])
        if name == "degenerate":
            keys = prng.fold_in(prng.key(MUT_SEED, device="cuda"),
                                its.cuda())
            err = max(err, max_abs_err(outs[0], havoc_at(
                seed.cuda(), len(sb), vk.havoc_words_for_keys(keys))))
        if err:
            raise AssertionError(f"grammar_havoc_at ({name}): card != CPU "
                                 f"or degenerate != havoc_at (max_abs_err "
                                 f"{err})")
        keys = prng.fold_in(prng.key(MUT_SEED, device="cuda"), its.cuda())
        args = (seed.cuda(), len(sb), keys, tables, tables.device("cuda"))
        ms[name] = timed(lambda: grammar_havoc_at(*args), 5)
        enqueue = host_ms(lambda: grammar_havoc_at(*args), 5)
        changed = int((outs[0][0].cpu() != seed[None, :]).any(1).sum())
        print(f"grammar_havoc_at ({name}, {B} lanes, {tables.meta[2]} "
              f"field entries): card == CPU on the first "
              f"{GRAMMAR_CPU_LANES} (max_abs_err 0"
              f"{'; == havoc_at on the card' if name == 'degenerate' else ''}"
              f"; {changed} lanes changed); event span {ms[name]:.3f} ms "
              f"per batch, host enqueue {enqueue:.3f} ms [{card}]",
              flush=True)
    return ms


def grammar_cli_parity(files):
    """13b: through cli.main with PIPELINE_DEPTH = 1 at -b 1024 on the
    zoo's tlv instance, card against CPU: havoc with the harness's
    grammar option at -G 4, the same at --mesh 1,1 -G 4, and the
    host-driven grammar mutator.  Each gives equal md5 sets, ring
    admissions, -isd (the three virgin maps), -msd and fuzzer_stats
    counters, and launches kbz_vm_kernel on the card."""
    from killerbeez_tpu_torch.ops.vm_kernel import LAUNCHES
    t, seed, gfile = files["zoo:tlv:depth=2,bug=1"]
    gram = {"grammar": f"@{gfile}"}
    runs = (("g4", ["-G", "4"], "havoc", gram, {}),
            ("mesh_g4", ["--mesh", "1,1", "-G", "4"], "havoc", gram, {}),
            ("host", [], "grammar", {}, gram))
    rows = []
    for run, extra, mutator, harness, mgram in runs:
        got = {}
        for dev in ("cuda", "cpu"):
            iopts = {"target": t.name, "novelty": "throughput", **harness}
            before = LAUNCHES["kbz_vm_kernel_all"]
            out = OUT / f"grammar_{run}_{dev}"
            got[dev] = inprocess(
                out, *GRAMMAR_PARITY, *extra, "--device", dev, "-i",
                json.dumps(iopts), mutator=mutator,
                mopts={"seed": MUT_SEED, **mgram}, seed=seed)
            got[dev]["admits"] = ring_admits(out)
            if dev == "cuda":
                launched = LAUNCHES["kbz_vm_kernel_all"] - before
        if got["cuda"] != got["cpu"]:
            diff = [k for k in got["cuda"] if got["cuda"][k] != got["cpu"][k]]
            raise AssertionError(f"grammar {run}: card and CPU differ in "
                                 f"{diff}")
        if not got["cuda"]["findings"]["new_paths"]:
            raise AssertionError(f"grammar {run}: no new paths")
        if run != "host" and not got["cuda"]["admits"]:
            raise AssertionError(f"grammar {run}: no ring admission")
        if not launched:
            raise AssertionError(f"grammar {run}: kbz_vm_kernel never "
                                 "launched on the card")
        rows.append(f"{run}: {len(got['cuda']['findings']['new_paths'])} "
                    f"new paths, {len(got['cuda']['admits'])} ring "
                    f"admissions, kbz_vm_kernel launched {launched} times")
    print("grammar CLI parity (zoo:tlv:depth=2,bug=1, PIPELINE_DEPTH 1): "
          "card == CPU (md5 sets, ring admissions, -isd, -msd, counters): "
          + "; ".join(rows), flush=True)


def zoo_deep_hit(t, isd: Path) -> bool:
    """Whether a run's -isd virgin map touched the instance's certified
    deep edge (its collision-free AFL slot)."""
    from killerbeez_tpu_torch.utils.serialization import decode_array
    vb = decode_array(json.loads(isd.read_text())["virgin_bits"])
    p = t.program
    return any(int(vb[int(p.edge_slot[e])]) != 0xFF
               for e in range(len(p.edge_to))
               if (int(p.edge_from[e]), int(p.edge_to[e])) == t.deep_edge)


def grammar_flagships(card, files, gh_ms):
    """13c: per gated instance, in turns, the structured lane (havoc
    with the instance's grammar, -G 16), the blind lane (the same
    without it) and the host-driven grammar mutator, each at -b 65536
    for GRAMMAR_BATCHES batches: execs/s and whether each hit the
    certified deep edge.  The gate: the structured lane hits it on
    every instance.  Returns the kbz_vm_kernel launches of the
    structured and grammar-mutator runs, summed."""
    total = {}
    rows = []
    for name, (t, seed, gfile) in files.items():
        stem = name.split(":")[1]
        base = {"target": name, "novelty": "throughput"}
        for lane, extra, iopts, mutator, mopts, need in (
                ("structured", ["-G", "16"],
                 {**base, "grammar": f"@{gfile}"}, "havoc", None,
                 ("kbz_vm_kernel_all",)),
                ("blind", ["-G", "16"], base, "havoc", None,
                 ("kbz_fuzz_kernel",)),
                ("grammar_mutator", [], base, "grammar",
                 {"seed": MUT_SEED, "grammar": f"@{gfile}"},
                 ("kbz_vm_kernel_all",))):
            run = f"zoo_{stem}_{lane}"
            isd = OUT / f"{run}.isd"
            launches, rate, _ = flagship(
                run, *extra, "-isd", str(isd), batches=GRAMMAR_BATCHES,
                iopts=iopts, need=need, mutator=mutator, mopts=mopts,
                seed=seed)
            hit = zoo_deep_hit(t, isd)
            if lane == "structured" and not hit:
                raise AssertionError(f"{run}: the structured lane missed "
                                     f"the certified deep edge")
            if lane != "blind":
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
            rows.append(f"{name} {lane}: {rate:.0f} execs/s, deep edge "
                        f"{'hit' if hit else 'missed'}")
    print(f"grammar flagships on {card} ({GRAMMAR_BATCHES} batches of {B}, "
          f"in turns per instance: structured -G 16, blind -G 16, the "
          f"grammar mutator host-driven; grammar_havoc_at event span per "
          f"batch: " + ", ".join(f"{k} {v:.3f} ms" for k, v in gh_ms.items())
          + "): " + "; ".join(rows), flush=True)
    return total


def supervisor_run():
    """13d: kbz-supervise on the card over a small port campaign with
    one injected device loss (device_dispatch raise at its third
    dispatch, first launch only): exit 0, supervisor.jsonl ending in a
    clean exit after a device-lost one and a probe that counted a card,
    findings equal to a fault-free control run in this process; then
    kb-corpus, kb-timeline and kb-stats --once on its output, each
    exiting 0."""
    from killerbeez_tpu_torch.tools import corpus_tool, stats_tui
    from killerbeez_tpu_torch.tools import timeline_tool
    # the JAX suite's supervised campaign (tests/test_resilience.py):
    # at this seed and shape the resumed run's findings converge on the
    # fault-free run's in both packages (ROADMAP Queue C 4: at other
    # shapes both re-report crashes after a device-loss resume)
    (OUT / "sup_seed.bin").write_bytes(bytes(8))

    def argv(out):
        return ["file", "jit_harness", "havoc", "-i",
                '{"target": "cgc_like", "novelty": "throughput"}', "-m",
                '{"seed": 11}', "-fb", "0", "-sf",
                str(OUT / "sup_seed.bin"), "-o", str(out), "-b", "256",
                "-n", "1024", "--corpus-dir", str(out / "corpus"),
                "--trace", "65536"]

    from killerbeez_tpu_torch.fuzzer.cli import main as cli_main
    ctl = OUT / "sup_control"
    shutil.rmtree(ctl, ignore_errors=True)
    if cli_main(argv(ctl)) != 0:
        raise AssertionError("the supervisor's control run failed")
    out = OUT / "sup_out"
    shutil.rmtree(out, ignore_errors=True)
    spec = json.dumps({"faults": [{"point": "device_dispatch",
                                   "mode": "raise", "hit": 3}]})
    env = {k: v for k, v in os.environ.items() if k != "KBZ_CHAOS"}
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "killerbeez_tpu_torch.resilience.supervisor",
         "--backoff-base", "0.1", "--backoff-cap", "0.5", "--chaos", spec,
         "--chaos-launches", "1", "--", *argv(out)],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=400)
    (OUT / "sup.log").write_text(r.stderr)
    if r.returncode != 0:
        raise AssertionError(f"kbz-supervise exited {r.returncode}:\n"
                             f"{r.stderr[-3000:]}")
    recs = [json.loads(line) for line in
            (out / "supervisor.jsonl").read_text().splitlines()]
    classes = [rec.get("class") for rec in recs if rec["event"] == "exit"]
    probes = [rec["devices"] for rec in recs
              if rec["event"] == "device_probe"]
    if classes[-1:] != ["clean"] or "device_lost" not in classes \
            or not probes or min(probes) < 1:
        raise AssertionError(f"kbz-supervise: exits {classes}, probes "
                             f"{probes}")
    if findings(out) != findings(ctl):
        raise AssertionError("kbz-supervise: the supervised campaign's "
                             "findings differ from the control run's")
    tools = {"kb-corpus": (corpus_tool.main, ["stats", str(out / "corpus")]),
             "kb-timeline": (timeline_tool.main, [str(out)]),
             "kb-stats": (stats_tui.main, [str(out), "--once"])}
    for tool, (fn, args) in tools.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(args)
        (OUT / f"sup_{tool}.txt").write_text(buf.getvalue())
        if rc != 0 or not buf.getvalue():
            raise AssertionError(f"{tool} on the supervised output exited "
                                 f"{rc}")
    print(f"kbz-supervise on the card: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s; exits {classes}, device "
          f"probes {probes}; findings == the control run's "
          f"({len(findings(out)['new_paths'])} new paths, "
          f"{len(findings(out)['crashes'])} crashes); kb-corpus, "
          f"kb-timeline and kb-stats --once exit 0", flush=True)


# -- the learn tier and the fleet (phase 14) -----------------------------

LEARN_L = 64
LEARN_SEEDS = 32
#: card against CPU after training: parameters and logits may differ by
#: float32 rounding (reduction order), at most this much
LEARN_TOL = 1e-5
#: masks are compared only where every logit lies at least this far
#: from the threshold 0 (asserted; the run fails, never skips)
LEARN_MARGIN = 1e-4
#: the learn flagship: six -G 16 dispatches of B lanes
LEARN_BATCHES = 96
#: a learn tier that never trains (the version-0 regime): the training
#: clock reads wall time, so only an interval past it keeps it off
LEARN_OFF = ["--learn", "--learn-interval", "1e12"]
#: each fleet CLI's length, in batches of B lanes
FLEET_BATCHES = 128
#: each fleet job's length in execs, at the CLI's default batch
FLEET_JOB_EXECS = 1 << 20


def learn_tiers():
    """A LearnTier on the card and one on the CPU, fed the same seeded
    synthetic admissions: LEARN_SEEDS seeds of LEARN_L random bytes, four
    admitted children each, every child flipping one to three of its
    parent's first 16 bytes.  Returns (seeds, {device: tier})."""
    import numpy as np
    from killerbeez_tpu_torch.learn import LearnTier
    rng = np.random.default_rng(MUT_SEED)
    seeds = [rng.integers(0, 256, LEARN_L, dtype=np.uint8).tobytes()
             for _ in range(LEARN_SEEDS)]
    adm = []
    for i, s in enumerate(seeds):
        for _ in range(4):
            c = bytearray(s)
            for p in rng.choice(16, size=int(rng.integers(1, 4)),
                                replace=False):
                c[p] ^= int(rng.integers(1, 256))
            adm.append((f"s{i}", s, bytes(c)))
    tiers = {}
    for dev in ("cuda", "cpu"):
        t = LearnTier(train_interval_s=0.0, min_labels=16, device=dev)
        for key, p, c in adm:
            t.note_admission(key, p, c, "havoc")
        tiers[dev] = t
    return seeds, tiers


def learn_logits(params, seeds, dev):
    """Each seed's saliency logits under ``params`` on ``dev``: float32
    [len(seeds), LEARN_L] on the CPU."""
    from killerbeez_tpu_torch.learn import model
    return torch.stack([model.saliency_logits(
        params, torch.tensor(list(s), dtype=torch.uint8, device=dev),
        len(s)).cpu() for s in seeds])


def learn_masks_compared(cuda_logits, cpu_logits, lens, what):
    """Card and CPU logits within LEARN_TOL, no compared logit within
    LEARN_MARGIN of 0, then the quantized masks equal.  Returns (max abs
    logit difference, the smallest |logit|)."""
    from killerbeez_tpu_torch.learn import model
    diff = float((cuda_logits - cpu_logits).abs().max())
    if diff > LEARN_TOL:
        raise AssertionError(f"{what}: card and CPU logits differ by "
                             f"{diff} > {LEARN_TOL}")
    live = torch.arange(cpu_logits.shape[1])[None, :] < \
        torch.as_tensor(lens)[:, None]
    near = float(cpu_logits.abs()[live].min())
    if near < LEARN_MARGIN:
        raise AssertionError(f"{what}: a logit lies {near} from the mask "
                             f"threshold, inside the margin {LEARN_MARGIN}")
    for a, b, n in zip(cuda_logits, cpu_logits, lens):
        if not torch.equal(model.quantize_mask(a, n),
                           model.quantize_mask(b, n)):
            raise AssertionError(f"{what}: card and CPU masks differ")
    return diff, near


def learn_model_parity(card, vk, prng):
    """14a: the model on the card against the CPU: version-0 logits
    exactly 0.0 and all-ones masks; two train_rounds (8 SGD steps x 256
    samples each) from the same label buffer, parameters within
    LEARN_TOL, and each round's ms (the first pays the warm-up); logits
    and masks under the trained weights; havoc_mask_at on B lanes card
    == CPU for an all-ones mask (== havoc_at), a random mask and an
    all-zero mask (the uniform fallback), with its event-span ms.
    Returns (the CPU tier, the timings)."""
    from killerbeez_tpu_torch.ops.mutate_core import havoc_at, havoc_mask_at
    from killerbeez_tpu_torch.tools.timing import timed
    seeds, tiers = learn_tiers()
    lens = [len(s) for s in seeds]
    v0 = learn_logits(tiers["cuda"].params, seeds, "cuda")
    if float(v0.abs().max()) != 0.0:
        raise AssertionError("a version-0 model's logits are not exactly 0")
    from killerbeez_tpu_torch.learn import model
    if not all(bool((model.quantize_mask(v, n) == 1).all())
               for v, n in zip(v0, lens)):
        raise AssertionError("a version-0 mask is not all-ones")
    train_ms, p_err = [], 0.0
    for _ in range(2):            # the first round pays the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_card = tiers["cuda"].train_round()
        train_ms.append((time.perf_counter() - t0) * 1e3)
        loss_cpu = tiers["cpu"].train_round()
        p_err = max([p_err] + [float((a.cpu() - b).abs().max()) for a, b in
                               zip(tiers["cuda"].params,
                                   tiers["cpu"].params)])
        if p_err > LEARN_TOL:
            raise AssertionError(f"train_round: card and CPU parameters "
                                 f"differ by {p_err} > {LEARN_TOL}")
    l_err, near = learn_masks_compared(
        learn_logits(tiers["cuda"].params, seeds, "cuda"),
        learn_logits(tiers["cpu"].params, seeds, "cpu"), lens,
        "trained model")
    # one inference step of the generation loop at the flagship width
    sb = torch.tensor(list(seeds[0]), dtype=torch.uint8, device="cuda")
    infer_ms = timed(lambda: model.masked_saliency(tiers["cuda"].params,
                                                   sb, LEARN_L), 7)
    its = torch.arange(B, dtype=torch.int64)
    gen = torch.Generator().manual_seed(MUT_SEED)
    masks = {"ones": torch.ones(LEARN_L, dtype=torch.uint8),
             "random": torch.randint(0, 2, (LEARN_L,), dtype=torch.uint8,
                                     generator=gen),
             "zeros": torch.zeros(LEARN_L, dtype=torch.uint8)}
    seed = torch.tensor(list(seeds[0]), dtype=torch.uint8)
    mask_ms = {}
    for name, mask in masks.items():
        outs = []
        for dev in ("cuda", "cpu"):
            words = vk.havoc_words_for_keys(
                prng.fold_in(prng.key(MUT_SEED, device=dev), its.to(dev)))
            outs.append(havoc_mask_at(seed.to(dev), LEARN_L, words,
                                      mask.to(dev)))
        err = max_abs_err([t.cpu() for t in outs[0]], outs[1])
        if name == "ones":
            words = vk.havoc_words_for_keys(prng.fold_in(
                prng.key(MUT_SEED, device="cuda"), its.cuda()))
            err = max(err, max_abs_err(outs[0],
                                       havoc_at(seed.cuda(), LEARN_L, words)))
        if err:
            raise AssertionError(f"havoc_mask_at ({name} mask): card != CPU "
                                 f"or all-ones != havoc_at (max_abs_err "
                                 f"{err})")
        words = vk.havoc_words_for_keys(prng.fold_in(
            prng.key(MUT_SEED, device="cuda"), its.cuda()))
        m = mask.cuda()
        mask_ms[name] = timed(lambda: havoc_mask_at(seed.cuda(), LEARN_L,
                                                    words, m), 5)
    print(f"learn model [{card}]: v0 logits exactly 0 and masks all-ones "
          f"on the card; train_round (8 steps x 256 samples) card "
          f"{train_ms[0]:.1f} ms wall cold, {train_ms[1]:.1f} ms warm (loss "
          f"{loss_card:.5f}, CPU {loss_cpu:.5f}), parameters "
          f"within {p_err:.3g}; trained logits within {l_err:.3g}, smallest "
          f"|logit| {near:.3g}, masks equal over {len(seeds)} seeds; "
          f"masked_saliency at L = {LEARN_L} {infer_ms:.3f} ms event span; "
          f"havoc_mask_at ({B} lanes) card == CPU, all-ones == havoc_at, "
          f"event span " + ", ".join(f"{k} {v:.3f} ms"
                                     for k, v in mask_ms.items()),
          flush=True)
    return tiers["cpu"], {"train_round_ms": train_ms[1],
                          "infer_ms": infer_ms,
                          "havoc_mask_at_ms": mask_ms}


def learn_dispatch_parity(cpu_tier):
    """14b: run_batch_generations with the learn tier, card (engine cuda)
    against the CPU's plain path on tlvstack_vm: 1000 lanes padded to
    1024, G = 4, reseeding on and off, with version-0 weights and with
    the CPU tier's trained weights carried to the card; every outcome
    field, the final ring and the virgin maps equal.  With trained
    weights every slot the dispatch could select (the seed and each
    admitted row of the ledger) is held to LEARN_MARGIN first."""
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.learn import model
    from killerbeez_tpu_torch.models.targets_cgc import tlvstack_vm_seed
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator
    trained = [p.cpu().numpy() for p in cpu_tier.params]
    for weights in ("v0", "trained"):
        for reseed in (True, False):
            got = {}
            for dev, engine in (("cuda", "cuda"), ("cpu", "torch")):
                instr = JitHarnessInstrumentation(json.dumps(
                    {**GEN_IOPTS, "engine": engine, "learn": 1}), device=dev)
                instr.learn_params = (
                    model.init_params(device=dev) if weights == "v0"
                    else model.params_from_numpy(trained, dev))
                mut = HavocMutator(json.dumps({"seed": MUT_SEED}),
                                   tlvstack_vm_seed(), device=dev)
                out = instr.run_batch_generations(
                    mut, mut.peek_iterations(1000), 4, pad_to=1024,
                    reseed=reseed).materialize()
                got[dev] = (out, [t.cpu() for t in instr._gen_ring.view()],
                            [getattr(instr, m).cpu() for m in MAPS])
            (co, c_ring, c_maps), (po, p_ring, p_maps) = got["cuda"], got["cpu"]
            if weights == "trained":
                rows = [tlvstack_vm_seed()] + [
                    bytes(po.adm_bufs[j, a, :int(po.adm_len[j, a])])
                    for j in range(po.adm_valid.shape[0])
                    for a in range(po.adm_valid.shape[1])
                    if po.adm_valid[j, a]]
                params = model.params_from_numpy(trained)
                for r in rows:
                    lg = model.saliency_logits(params, torch.tensor(
                        list(r) + [0] * (LEARN_L - len(r)),
                        dtype=torch.uint8), len(r))[:len(r)]
                    if float(lg.abs().min()) < LEARN_MARGIN:
                        raise AssertionError(
                            "learn dispatch: a selectable slot's logit "
                            "lies inside the margin")
            for f in co._fields:
                a, b = getattr(co, f), getattr(po, f)
                if not (a == b if isinstance(a, int)
                        else (a.shape == b.shape and (a == b).all())):
                    raise AssertionError(f"learn -G dispatch ({weights}, "
                                         f"reseed {reseed}): card and CPU "
                                         f"differ in {f}")
            for name, a, b in zip(("ring",) * 6 + MAPS, c_ring + c_maps,
                                  p_ring + p_maps):
                if not torch.equal(a, b):
                    raise AssertionError(f"learn -G dispatch ({weights}): "
                                         f"card and CPU differ in {name}")
            print(f"learn -G dispatch parity ({weights} weights, reseed "
                  f"{reseed}): card == CPU over 4 generations (findings "
                  f"ring {int(co.fr_ptr)} rows, ring filled "
                  f"{int(co.ring_filled.sum())})", flush=True)


def learn_cli_parity():
    """14b: the CLI with a learn tier that never trains (LEARN_OFF): at
    -G 4 -b 1024 -n 32768 card (engine cuda_fused asked: it stands down
    to cuda) against the CPU and against the same run without --learn;
    host-driven at the default -fb with PIPELINE_DEPTH = 1 (-n 16384:
    two rotations) card against CPU; --mesh 1,1 -G 4 (-n 16384) card
    against CPU.  md5 sets, -isd, ring_admit
    sequences and fuzzer_stats counters equal."""
    small = ["-b", "1024", "-n", "32768", "-G", "4"]
    got = {}
    for name, dev, engine, extra in (
            ("learn_gen_cuda", "cuda", "cuda_fused", LEARN_OFF),
            ("learn_gen_cpu", "cpu", "torch", LEARN_OFF),
            ("learn_gen_plain", "cuda", "cuda_fused", []),
            ("learn_mesh_cuda", "cuda", "cuda", LEARN_OFF
             + ["--mesh", "1,1", "-n", "16384"]),
            ("learn_mesh_cpu", "cpu", "torch", LEARN_OFF
             + ["--mesh", "1,1", "-n", "16384"])):
        state = OUT / f"{name}.isd"
        _, out = run_cli(small + extra + [
            "--device", dev, "-isd", str(state), "-i",
            json.dumps({**GEN_IOPTS, "engine": engine})], name)
        got[name] = {"findings": findings(out), "isd": state.read_text(),
                     "admits": ring_admits(out),
                     "counters": stats_counters(out)}
    for a, b in (("learn_gen_cuda", "learn_gen_cpu"),
                 ("learn_gen_cuda", "learn_gen_plain"),
                 ("learn_mesh_cuda", "learn_mesh_cpu")):
        if got[a] != got[b]:
            raise AssertionError(f"{a} and {b} differ in "
                                 f"{[k for k in got[a] if got[a][k] != got[b][k]]}")
    if not got["learn_gen_cuda"]["admits"]:
        raise AssertionError("learn -G 4 admitted no ring slot")
    host = {}
    for dev, engine in (("cuda", "cuda_fused"), ("cpu", "torch")):
        host[dev] = inprocess(
            OUT / f"learn_host_{dev}", "-b", "1024", "-n", "16384",
            "--device", dev, *LEARN_OFF, "-i",
            json.dumps({**GEN_IOPTS, "engine": engine}))
    if host["cuda"] != host["cpu"]:
        raise AssertionError("host-driven --learn: card and CPU differ in "
                             f"{[k for k in host['cuda'] if host['cuda'][k] != host['cpu'][k]]}")
    print(f"learn CLI parity: -G 4 card == CPU == the run without --learn "
          f"({len(got['learn_gen_cuda']['admits'])} ring admissions, "
          f"{len(got['learn_gen_cuda']['findings']['new_paths'])} new "
          f"paths); host-driven default -fb card == CPU "
          f"({len(host['cuda']['picks'])} picks); --mesh 1,1 -G 4 card == "
          f"CPU", flush=True)


def learn_flagships(card):
    """14c: tlvstack_vm at -b 65536 -G 16 for six dispatches with --learn
    --learn-interval 0.5 (engine cuda: masked havoc, then kbz_vm_kernel
    over every lane) in turns with the same run without --learn
    (cuda_fused): learn, plain, plain, learn.  Gate per learn run:
    exit 0, learn_model_version >= 1, a learn_update event,
    learn_train_steps > 0, kbz_vm_kernel launches > 0.  Then --resume of
    the last learn run (its training off) restores the model version.
    Returns (the learn runs' launches, summed; the learn timer's ms)."""
    from killerbeez_tpu_torch.corpus.store import CorpusStore
    total, rows, learn_ms = {}, [], []
    for i, lane in enumerate(("learn", "plain", "plain", "learn")):
        name = f"learn_flagship_{lane}_{i}"
        extra = ["-G", "16"]
        need = ("kbz_fuzz_kernel",)
        if lane == "learn":
            extra += ["--learn", "--learn-interval", "0.5", "--corpus-dir",
                      str(OUT / f"{name}_corpus")]
            need = ("kbz_vm_kernel_all",)
        launches, rate, out = flagship(name, *extra,
                                       batches=LEARN_BATCHES, need=need)
        rows.append(f"{lane} {rate:.0f}")
        if lane != "learn":
            continue
        snaps = [json.loads(line) for line in
                 (out / "stats.jsonl").read_text().splitlines() if line]
        last = snaps[-1]
        version = last.get("gauges", {}).get("learn_model_version", 0)
        steps = last.get("counters", {}).get("learn_train_steps", 0)
        ups = [e for e in events(out) if e["type"] == "learn_update"]
        if version < 1 or steps <= 0 or not ups:
            raise AssertionError(f"{name}: the model never trained "
                                 f"(version {version}, {steps} steps, "
                                 f"{len(ups)} learn_update events)")
        version = int(version)
        hist = last.get("hists", {}).get("learn", {})
        learn_ms.append({
            "rounds_and_checks": hist.get("total", 0),
            "ms_total": round(last.get("counters", {}).get(
                "learn_seconds", 0.0) * 1e3, 3),
            "version": version, "train_steps": steps})
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        resumed = (name, version)
    name, version = resumed
    corpus = OUT / f"{name}_corpus"
    run_cli(["-b", str(B), "-n", str(16 * B), "-G", "16", *LEARN_OFF,
             "--corpus-dir", str(corpus), "--resume", "-i",
             json.dumps({**GEN_IOPTS, "engine": "cuda_fused"})],
            f"{name}_resume")
    ck = CorpusStore(str(corpus)).load_checkpoint() or {}
    got = (ck.get("learn") or {}).get("version")
    if got != version:
        raise AssertionError(f"--resume of {name}: model version {got}, "
                             f"checkpointed {version}")
    print(f"learn flagships on {card} ({LEARN_BATCHES} batches of {B} at "
          f"-G 16, in turns learn, plain, plain, learn): execs/s "
          f"{', '.join(rows)}; learn timer {learn_ms}; --resume restored "
          f"model version {version}", flush=True)
    return total, learn_ms


def fleet_run(card):
    """14d: a fleet on one card.  A manager in this process on
    127.0.0.1:0 with a file DB; two jobs of the flagship campaign (file
    jit_harness havoc on tlvstack_vm, cuda_fused, at the CLI's default
    batch: a job row carries no batch size in either package), and
    beside each job a CLI at the flagship width (-b B, FLEET_BATCHES
    batches) syncing and gossiping under that job's campaign key.  The
    CLIs start first; once each has pushed a row, two concurrent worker
    subprocesses (--once, gossip, corpus sync every 0.25 s) claim the
    jobs.  Gate: both jobs done; the manager's corpus holds rows from
    both workers and both CLIs; each worker pulled entries its CLI found
    first; heartbeats > 0; findings assimilated; /metrics parses and
    carries kbz_manager_degraded; each worker's and each CLI's log shows
    kernel launches > 0.  Returns each process's launches."""
    import urllib.request
    from killerbeez_tpu_torch.manager.api import ManagerServer
    from killerbeez_tpu_torch.models.targets_cgc import tlvstack_vm_seed
    from killerbeez_tpu_torch.telemetry.sink import read_latest_snapshot
    fleet = OUT / "fleet"
    shutil.rmtree(fleet, ignore_errors=True)
    fleet.mkdir(parents=True)
    seed = fleet / "seed.bin"
    seed.write_bytes(tlvstack_vm_seed())
    srv = ManagerServer(port=0, db_path=str(fleet / "manager.db"))
    srv.start()
    url = f"http://127.0.0.1:{srv.port}"
    instr_opts = json.dumps({"target": "tlvstack_vm", "engine": "cuda_fused",
                             "novelty": "throughput"})

    def call(path, payload=None):
        req = urllib.request.Request(
            url + path, method="POST" if payload is not None else "GET",
            data=json.dumps(payload).encode() if payload is not None
            else None, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = resp.read()
            return json.loads(body) if body else None

    def start(name, argv):
        log = open(fleet / f"{name}.log", "w")
        # a session of its own: a worker runs its job's CLI as a child,
        # and a failure must stop that child too
        procs.append((name, log, subprocess.Popen(
            [sys.executable, "-m"] + argv, cwd=str(ROOT), stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True)))

    def wait(names):
        for name, log, p in procs:
            if name not in names:
                continue
            rc = p.wait(timeout=400)
            log.close()
            if rc != 0:
                raise AssertionError(
                    f"fleet process {name} exited {rc}:\n"
                    f"{(fleet / f'{name}.log').read_text()[-3000:]}")

    t0 = time.perf_counter()
    procs = []
    try:
        tid = call("/api/target", {"name": "tlvstack_vm"})["id"]
        jobs = []
        for j in range(2):
            jobs.append(call("/api/job", {
                "target_id": tid, "driver": "file",
                "instrumentation": "jit_harness", "mutator": "havoc",
                "iterations": FLEET_JOB_EXECS, "seed_file": str(seed),
                "instrumentation_opts": instr_opts,
                "mutator_opts": json.dumps({"seed": MUT_SEED + j})})["id"])
        clis = {f"c{j}": str(job) for j, job in enumerate(jobs, 1)}
        for c, key in clis.items():
            start(c, ["killerbeez_tpu_torch.fuzzer", "file", "jit_harness",
                      "havoc", "-sf", str(seed), "-n", str(FLEET_BATCHES * B),
                      "-b", str(B), "-i", instr_opts, "-m",
                      json.dumps({"seed": MUT_SEED + 10 + int(key)}),
                      "-o", str(fleet / c), "--corpus-dir",
                      str(fleet / c / "corpus"), "--sync-manager", url,
                      "--sync-campaign", key, "--sync-worker", c,
                      "--sync-interval", "0.25", "--gossip", "0"])
        deadline = time.perf_counter() + 300
        while True:
            ended = all(p.poll() is not None for _, _, p in procs)
            if all(any(r["worker"] == c for r in
                       srv.db.get_corpus_entries(key, 0))
                   for c, key in clis.items()):
                break
            if ended or time.perf_counter() > deadline or any(
                    p.poll() not in (None, 0) for _, _, p in procs):
                raise AssertionError("a fleet CLI pushed no corpus row")
            time.sleep(0.2)
        for w in ("w1", "w2"):
            start(w, ["killerbeez_tpu_torch.manager.worker", url, "--once",
                      "--gossip", "--name", w, "--corpus-sync", "0.25"])
        wait(["c1", "c2", "w1", "w2"])
        wall = time.perf_counter() - t0
        status = [call(f"/api/job/{j}")["status"] for j in jobs]
        if status != ["done", "done"]:
            raise AssertionError(f"fleet jobs ended {status}")
        rows, pulled = {}, {}
        for key in clis.values():
            rows[key] = call(f"/api/corpus/{key}?since=0")["entries"]
            for r in srv.db.get_campaign_stats(key):
                c = r["snapshot"].get("counters", {})
                pulled[r["worker"]] = c.get("corpus_synced_in", 0) + \
                    c.get("gossip_entries_in", 0)
        authors = {r.get("worker") for rs in rows.values() for r in rs}
        if not {"w1", "w2", "c1", "c2"} <= authors:
            raise AssertionError(f"the manager's corpus holds rows of "
                                 f"{authors}, not of both workers and "
                                 "both CLIs")
        if sorted(pulled) != ["w1", "w2"]:
            raise AssertionError(f"heartbeat snapshots of {sorted(pulled)}, "
                                 "not of both workers")
        if min(pulled.values()) <= 0:
            raise AssertionError(f"a worker admitted nothing its CLI "
                                 f"found first: {pulled}")
        for c in clis:
            snap = read_latest_snapshot(str(fleet / c)) or {}
            cc = snap.get("counters", {})
            pulled[c] = cc.get("corpus_synced_in", 0) + \
                cc.get("gossip_entries_in", 0)
        results = sum(len(call(f"/api/job/{j}/results")) for j in jobs)
        if not results:
            raise AssertionError("no findings assimilated")
        launches, beats = {}, {}
        for name in ("w1", "w2", "c1", "c2"):
            text = (fleet / f"{name}.log").read_text()
            m = re.findall(r"kernel launches: (\{.*\})", text)
            if not m:
                raise AssertionError(f"{name}: no launch counts in its log")
            launches[name] = json.loads(m[-1])
            if min(launches[name][k] for k in ("kbz_fuzz_kernel",
                                               "kbz_vm_kernel")) <= 0:
                raise AssertionError(f"{name}: a kernel never launched: "
                                     f"{launches[name]}")
            if name.startswith("w"):
                hb = re.findall(r"findings, (\d+) heartbeats", text)
                beats[name] = sum(int(x) for x in hb)
                if beats[name] <= 0:
                    raise AssertionError(f"worker {name}: no heartbeat")
        with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
            metrics = resp.read().decode()
        sys.path.insert(0, str(ROOT / "tests"))
        try:
            from openmetrics_parser import parse_openmetrics
            parse_openmetrics(metrics)
        finally:
            sys.path.pop(0)
        if "kbz_manager_degraded" not in metrics:
            raise AssertionError("/metrics lacks kbz_manager_degraded")
    finally:
        for _, log, p in procs:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
            log.close()
        srv.stop()
    print(f"fleet on {card}: 2 jobs done by 2 concurrent workers beside 2 "
          f"CLIs at -b {B} in {wall:.1f} s wall; manager corpus "
          f"{sum(len(r) for r in rows.values())} rows from "
          f"{sorted(authors)}; entries pulled from the other side "
          f"{pulled}; heartbeats {beats}; {results} findings assimilated; "
          f"/metrics parses with kbz_manager_degraded", flush=True)
    print("fleet worker launches: " + json.dumps(launches), flush=True)
    return launches


# -- the hybrid bridge and conformance repair (phase 15) ------------------

#: phase 15d's full-width run length, in batches of B
HYBRID_BATCHES = 32
#: phase 15's campaigns on target test: havoc seed 7 from ABCD and 60
#: zero bytes (most lanes keep the planted prefix; from the bare 4-byte
#: ABCD the havoc stream never runs it within 512 execs)
HYBRID_MOPTS = {"seed": 7}
#: wall-clock fields and the event envelope, dropped before phase 15's
#: card and CPU records are compared
HYBRID_CLOCK = ("t", "ts", "v", "seq", "wall_s", "seconds")


def hybrid_seed(head: bytes = b"ABCD") -> Path:
    path = OUT / f"hybrid_seed_{head.decode()}.bin"
    path.write_bytes(head + bytes(60))
    return path


def hybrid_norm(obj, root):
    """``obj`` without wall-clock fields, with ``root`` made relative."""
    if isinstance(obj, dict):
        return {k: hybrid_norm(v, root) for k, v in obj.items()
                if k not in HYBRID_CLOCK}
    if isinstance(obj, list):
        return [hybrid_norm(v, root) for v in obj]
    if isinstance(obj, str):
        return obj.replace(str(root), "<out>")
    return obj


@contextlib.contextmanager
def bridges():
    """Capture every bridge the CLI makes: its campaign's registry, and
    the deepest and oldest validation queue seen at a fold."""
    import killerbeez_tpu_torch.hybrid as hybrid
    made, make = [], hybrid.make_bridge

    def capture(*args, **kwargs):
        bridge = make(*args, **kwargs)
        fold = bridge.fold
        bridge.peak = [0, 0.0]

        def fold_and_watch(fuzzer):
            bridge.registry = fuzzer.telemetry.registry
            bridge.peak = [max(bridge.peak[0], bridge.queue.depth()),
                           max(bridge.peak[1], bridge.queue.oldest_age())]
            return fold(fuzzer)
        bridge.fold = fold_and_watch
        made.append(bridge)
        return bridge
    hybrid.make_bridge = capture
    try:
        yield made
    finally:
        hybrid.make_bridge = make


def hybrid_cli(name, args, seed):
    """The CLI with a hybrid bridge, in this process at PIPELINE_DEPTH =
    1; returns what the card and the CPU must agree on."""
    from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
    depth = Fuzzer.PIPELINE_DEPTH
    Fuzzer.PIPELINE_DEPTH = 1
    try:
        with bridges() as made:
            _, out = run_cli(["-b", "64", "-n", "512", "--hybrid-workers",
                              "0", *args], name, mopts=HYBRID_MOPTS,
                             seed=seed)
    finally:
        Fuzzer.PIPELINE_DEPTH = depth
    [bridge] = made

    def jdir(d):
        return {n: hybrid_norm(json.loads((d / n).read_text()), out)
                for n in sorted(os.listdir(d)) if n.endswith(".json")} \
            if d.is_dir() else {}
    counters = bridge.registry.snapshot()["counters"]
    return {
        "findings": {k: sorted(n for n in os.listdir(out / k) if len(n) == 32)
                     for k in ("crashes", "hangs", "new_paths")},
        "events": [hybrid_norm(e, out) for e in events(out) if e["type"] in
                   ("cross_tier_validate", "proxy_gap", "proxy_repair")],
        "sidecars": jdir(out / "crashes"),
        "gaps": jdir(out / "proxy_gaps"),
        "counters": {k: v for k, v in counters.items()
                     if k.startswith(("hybrid_", "repair_"))},
        "bridge": [bridge.validated, bridge.enqueued, bridge.queue.dropped],
    }


def hybrid_verdicts(card, vk):
    """15a: proxy verdicts on the card.  ``proxy_verdict`` of the
    bindings test and test_safe on ABCD, hello, the empty input and 1024
    seeded random inputs (half of them starting with a prefix of ABCD),
    each one launch of kbz_vm_kernel over a one-lane batch, against the
    CPU's plain VM over all of them in one batch (lanes are independent,
    and the VM reads no input byte at or past a lane's length) and the
    CPU's one-lane path on the first 32; ``certify_binding`` of test,
    test_safe and a miswired binding card == CPU.  Prints the event-span
    ms of one one-lane verdict and the host ms per proxy_verdict call.
    Returns the card verdicts' launches."""
    from killerbeez_tpu_torch import FUZZ_HANG, FUZZ_RUNNING
    from killerbeez_tpu_torch.hybrid import registry
    from killerbeez_tpu_torch.models.targets import get_target
    from killerbeez_tpu_torch.native import build
    from killerbeez_tpu_torch.tools.timing import timed
    build.build_corpus(["test-plain", "hybrid-safe"])
    g = torch.Generator().manual_seed(MUT_SEED)
    bufs = [b"ABCD", b"hello", b""]
    for i in range(1024):
        n = int(torch.randint(1, 17, (1,), generator=g))
        x = bytes(torch.randint(0, 256, (n,), generator=g).tolist())
        if i % 2:
            k = int(torch.randint(0, 5, (1,), generator=g))
            x = (b"ABCD"[:k] + x)[:n]
        bufs.append(x)
    prog = get_target("test")
    inputs = torch.zeros((len(bufs), max(map(len, bufs))), dtype=torch.uint8)
    for i, b in enumerate(bufs):
        inputs[i, :len(b)] = torch.tensor(list(b), dtype=torch.uint8)
    lengths = torch.tensor([len(b) for b in bufs], dtype=torch.int32)
    status = vk.run_batch(torch.as_tensor(prog.instrs),
                          torch.as_tensor(prog.edge_table), inputs, lengths,
                          prog.mem_size, prog.max_steps, prog.n_edges).status
    want = [FUZZ_HANG if s == FUZZ_RUNNING else s for s in status.tolist()]
    test = registry.get_binding("test")
    if [registry.proxy_verdict(test, b, "cpu") for b in bufs[:32]] != \
            want[:32]:
        raise AssertionError("the CPU's one-lane proxy verdicts differ from "
                             "its batched plain VM")
    launched, host_ms = 0, []
    for name in ("test", "test_safe"):
        binding = registry.get_binding(name)
        before = vk.LAUNCHES["kbz_vm_kernel_all"]
        t0 = time.perf_counter()
        got = [registry.proxy_verdict(binding, b, "cuda") for b in bufs]
        host_ms.append((time.perf_counter() - t0) * 1e3 / len(bufs))
        n = vk.LAUNCHES["kbz_vm_kernel_all"] - before
        launched += n
        if n != len(bufs):
            raise AssertionError(f"{name}: {n} kbz_vm_kernel launches for "
                                 f"{len(bufs)} proxy verdicts on the card")
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            raise AssertionError(f"{name}: card proxy verdicts differ from "
                                 f"the CPU's at inputs {bad[:8]}")
    safe = registry.get_binding("test_safe")
    broken = registry.ProxyBinding(name="broken", proxy_target="test",
                                   native=safe.native, benign_seed=b"ABCD")
    certs = {}
    for binding in (test, safe, broken):
        card_rec = registry.certify_binding(binding, "cuda")
        if card_rec != registry.certify_binding(binding, "cpu"):
            raise AssertionError(f"certify_binding({binding.name}): card "
                                 f"and CPU records differ")
        certs[binding.name] = card_rec["certified"]
    if certs != {"test": True, "test_safe": True, "broken": False}:
        raise AssertionError(f"certification verdicts {certs}")
    dev = torch.device("cuda")
    one = torch.tensor([list(b"ABCD")], dtype=torch.uint8, device=dev)
    one_len = torch.tensor([4], dtype=torch.int32, device=dev)
    instrs = torch.as_tensor(prog.instrs, device=dev)
    table = torch.as_tensor(prog.edge_table, device=dev)
    span = timed(lambda: vk.run_batch(instrs, table, one, one_len,
                                      prog.mem_size, prog.max_steps,
                                      prog.n_edges), 15)
    counts = {v: want.count(v) for v in sorted(set(want))}
    print(f"proxy verdicts on {card}: card == CPU on {len(bufs)} inputs x "
          f"bindings test, test_safe (verdicts {counts}), {launched} "
          f"kbz_vm_kernel launches over one lane; certification card == "
          f"CPU {certs}; one one-lane verdict {span:.4f} ms event span; "
          f"host ms per proxy_verdict call (program, upload, launch, wait) "
          f"{', '.join(f'{m:.3f}' for m in host_ms)}", flush=True)
    return launched


def hybrid_cli_parity(seed):
    """15b: ``--hybrid test`` and ``--hybrid test_safe`` from the padded
    seed, -b 64 -n 512, host-driven and at -G 4, card (cuda_fused)
    against CPU (torch) through cli.main at PIPELINE_DEPTH = 1 with
    --hybrid-workers 0: md5 sets, cross_tier_validate and proxy_gap
    events, crashes/<md5>.json sidecars, proxy_gaps/ reports and index,
    hybrid_* counters equal; every queued finding validated, none
    dropped; test confirmed, test_safe proxy_only with a gap report."""
    rows = []
    for binding in ("test", "test_safe"):
        for mode, extra in (("host", []), ("g4", ["-G", "4"])):
            got = {}
            for dev, engine in (("cuda", "cuda_fused"), ("cpu", "torch")):
                got[dev] = hybrid_cli(
                    f"hybrid_{binding}_{mode}_{dev}",
                    ["--hybrid", binding, "--device", dev, "-i",
                     json.dumps({"target": "test", "engine": engine}),
                     *extra], seed)
            diff = [k for k in got["cuda"] if got["cuda"][k] != got["cpu"][k]]
            if diff:
                raise AssertionError(f"--hybrid {binding} ({mode}): card "
                                     f"and CPU differ in {diff}")
            validated, enqueued, dropped = got["cuda"]["bridge"]
            verdicts = {e["verdict"] for e in got["cuda"]["events"]
                        if e["type"] == "cross_tier_validate"}
            want = {"confirmed"} if binding == "test" else {"proxy_only"}
            if validated != enqueued or not enqueued or dropped or \
                    verdicts != want or \
                    bool(got["cuda"]["gaps"]) != (binding == "test_safe"):
                raise AssertionError(f"--hybrid {binding} ({mode}): "
                                     f"{validated}/{enqueued} validated, "
                                     f"{dropped} dropped, verdicts "
                                     f"{verdicts}, gap files "
                                     f"{sorted(got['cuda']['gaps'])}")
            rows.append(f"{binding} {mode}: {enqueued} validated "
                        f"{sorted(verdicts)}")
    print("hybrid CLI card == CPU (PIPELINE_DEPTH 1, -b 64 -n 512): "
          + "; ".join(rows), flush=True)


def hybrid_repair(seed):
    """15c: the repair loop on the card.  ``--hybrid test_safe
    --auto-repair 1`` installs test_safe+repaired (card == CPU, the
    repairs.json ledger included); kb-repair --binding test_safe --probe
    --apply --require-repaired --json on the card exits 0, launches
    kbz_vm_kernel for its probe's verdicts and gives the CPU's result
    (the same blamed pc and patch); kb-lint --gaps-dir --gap-backlog 0
    --sarif is clean after the repair."""
    from killerbeez_tpu_torch.ops.vm_kernel import LAUNCHES
    from killerbeez_tpu_torch.tools import lint_tool, repair_tool
    got = {}
    for dev, engine in (("cuda", "cuda_fused"), ("cpu", "torch")):
        got[dev] = hybrid_cli(
            f"hybrid_autorepair_{dev}",
            ["--hybrid", "test_safe", "--auto-repair", "1", "--device", dev,
             "-i", json.dumps({"target": "test", "engine": engine})], seed)
    diff = [k for k in got["cuda"] if got["cuda"][k] != got["cpu"][k]]
    if diff:
        raise AssertionError(f"--auto-repair: card and CPU differ in {diff}")
    [ev] = [e for e in got["cuda"]["events"] if e["type"] == "proxy_repair"]
    if ev["installed"] != "test_safe+repaired":
        raise AssertionError(f"--auto-repair installed {ev['installed']}")
    tools = {}
    for dev in ("cuda", "cpu"):
        d = OUT / f"kb_repair_{dev}"
        shutil.rmtree(d, ignore_errors=True)
        before = LAUNCHES["kbz_vm_kernel_all"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = repair_tool.main(["--binding", "test_safe", "--gaps-dir",
                                   str(d), "--probe", "--apply", "--json",
                                   "--require-repaired", "--device", dev])
        launched = LAUNCHES["kbz_vm_kernel_all"] - before
        result = hybrid_norm(json.loads(buf.getvalue()), d)
        lint = io.StringIO()
        with contextlib.redirect_stdout(lint):
            lint_rc = lint_tool.main(["--gaps-dir", str(d), "--gap-backlog",
                                      "0", "--sarif"])
        results = json.loads(lint.getvalue())["runs"][0]["results"]
        if rc or result["status"] != "repaired" or lint_rc or results:
            raise AssertionError(f"kb-repair --device {dev}: exit {rc}, "
                                 f"{result['status']}; kb-lint exit "
                                 f"{lint_rc}, {len(results)} results")
        tools[dev] = (result, launched)
    if tools["cuda"][0] != tools["cpu"][0] or tools["cuda"][1] <= 0:
        raise AssertionError(f"kb-repair: card and CPU results differ, or "
                             f"no kernel launched on the card "
                             f"({tools['cuda'][1]} launches)")
    [cl] = tools["cuda"][0]["clusters"]
    print(f"repair loop on the card: --auto-repair 1 installed "
          f"{ev['installed']} (card == CPU); kb-repair --probe --apply on "
          f"the card == CPU: blame pc {cl['blame']['pc']} (const "
          f"{cl['blame']['const']}), patch {cl['patch_desc']}, installed "
          f"{tools['cuda'][0]['installed']}, {tools['cuda'][1]} "
          f"kbz_vm_kernel launches; kb-lint --gaps-dir --sarif clean after "
          f"the repair", flush=True)


def hybrid_flagships(card, seed):
    """15d: file jit_harness havoc -b 65536 -fb 0 on test (cuda_fused)
    from ABCC and 60 zero bytes, with --hybrid test (one native worker)
    and without, in turns (with, without, without, with),
    HYBRID_BATCHES batches each: exit 0, kbz_fuzz_kernel launched, the
    same findings in all four runs (the bridge never changes the
    candidates); per hybrid run its validations, confirmed verdicts
    (every one confirmed, none dropped) and the deepest and oldest
    validation queue seen at a fold.  From the padded ABCD seed, or with
    corpus feedback onto an admitted crashing input, a quarter of the
    lanes are distinct crashing inputs, and writing their files takes
    the run (8.6-16.0 s per batch); from ABCC a lane crashes only where
    havoc writes the D.  Returns the first hybrid run's launches."""
    iopts = {"target": "test", "engine": "cuda_fused"}
    rows, first, found = [], None, []
    for i, lane in enumerate(("hybrid", "plain", "plain", "hybrid")):
        extra = ["--hybrid", "test"] if lane == "hybrid" else []
        with bridges() as made:
            launches, rate, out = flagship(
                f"hybrid_flagship_{lane}_{i}", "-fb", "0", *extra,
                batches=HYBRID_BATCHES, iopts=iopts,
                need=("kbz_fuzz_kernel",), seed=seed)
        found.append({k: sorted(n for n in v if len(n) == 32)
                      for k, v in findings(out).items()})
        if found[-1] != found[0] or not found[0]["crashes"]:
            raise AssertionError(f"hybrid flagship {lane} {i}: findings "
                                 f"differ from the first run's, or no "
                                 f"crash")
        if lane == "plain":
            rows.append(f"plain {rate:.0f} execs/s")
            continue
        [bridge] = made
        c = bridge.registry.snapshot()["counters"]
        n = int(c.get("hybrid_validations", 0))
        ok = int(c.get("hybrid_confirmed", 0))
        if not n or ok != n or bridge.queue.dropped:
            raise AssertionError(f"hybrid flagship: {ok}/{n} confirmed, "
                                 f"{bridge.queue.dropped} dropped")
        rows.append(f"hybrid {rate:.0f} execs/s, hybrid_validations {n}, "
                    f"hybrid_confirmed {ok}, validation_queue_depth at most "
                    f"{bridge.peak[0]}, validation_queue_age at most "
                    f"{bridge.peak[1]:.3f} s, launches {launches}")
        first = first or launches
    print(f"hybrid flagships on {card} ({HYBRID_BATCHES} batches of {B}, "
          f"target test, -fb 0, in turns hybrid, plain, plain, hybrid; "
          f"{len(found[0]['crashes'])} crash files and "
          f"{len(found[0]['new_paths'])} new paths in each): "
          + "; ".join(rows), flush=True)
    return first


class Phases:
    """Prints each phase's wall time as the next one starts."""

    def __init__(self):
        self.name, self.t0 = None, time.perf_counter()

    def start(self, name):
        if self.name:
            print(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} "
                  "s wall", flush=True)
        self.name, self.t0 = name, time.perf_counter()


def triage_kernels(card) -> dict:
    """Phase 17: the three triage kernels alone (see the docstring's
    item 17).  Returns the ``kernels`` row of the 262144-lane batch."""
    from killerbeez_tpu_torch import FUZZ_CRASH, FUZZ_HANG, FUZZ_RUNNING
    from killerbeez_tpu_torch.models import targets_cgc
    from killerbeez_tpu_torch.models.targets import get_target
    from killerbeez_tpu_torch.ops import _build, prng, vm_kernel as vk
    from killerbeez_tpu_torch.ops import static_triage as st
    from killerbeez_tpu_torch.tools.timing import host_ms, timed
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        from kbbench import arith
    finally:
        sys.path.pop(0)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.load("triage")
    print(f"triage build+load: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.build_seconds.get('triage', 0.0):.1f} s)", flush=True)
    log = _build.library_path("triage").with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas (triage): {line.strip()}", flush=True)
    prog = get_target("tlvstack_vm")
    seed_bytes = targets_cgc.tlvstack_vm_seed()
    seed = torch.zeros(64, dtype=torch.uint8, device=dev)
    seed[:len(seed_bytes)] = torch.tensor(list(seed_bytes),
                                          dtype=torch.uint8)
    ring = vk.seed_ring(seed, len(seed_bytes))
    instrs = torch.as_tensor(prog.instrs, device=dev)
    table = torch.as_tensor(prog.edge_table, device=dev)
    key = prng.key(MUT_SEED, device=dev)
    ms, steps, ne = prog.mem_size, prog.max_steps, prog.n_edges
    u_slots, seg_id = (torch.as_tensor(a, device=dev)
                       for a in st.make_static_maps(prog.edge_slot))
    n_slots = u_slots.shape[0]
    row = None
    for lanes in (262144, 65536):
        def batch(i):
            its = torch.arange(i * lanes, (i + 1) * lanes,
                               dtype=torch.int64, device=dev)
            res, _, _ = vk.fuzz_batch_2phase(
                instrs, table, *ring, key, its, ms, steps, ne, STACK_POW2,
                phase1_steps=vk.auto_phase1_steps(steps))
            return (res.counts, res.status == FUZZ_CRASH,
                    (res.status == FUZZ_HANG) | (res.status == FUZZ_RUNNING))

        fresh = tuple(torch.full((prog.map_size,), 0xFF, dtype=torch.uint8,
                                 device=dev) for _ in range(3))
        seen = fresh
        for i in range(1, 5):
            c, cr, hg = batch(i)
            seen = st.static_triage(*seen, c, u_slots, seg_id, cr, hg)[3:]
        counts, crash, hang = batch(0)
        args = (counts, u_slots, seg_id, crash, hang)
        for label, maps in (("fresh", fresh), ("seen", seen)):
            got = st.static_triage(*maps, *args)
            ref = st.static_triage_plain(*(t.cpu() for t in maps + args))
            err = max_abs_err([t.cpu() for t in got], ref)
            print(f"triage kernels, {lanes} lanes, {label} maps: card == "
                  f"CPU max_abs_err {err}; new paths {int(ref[0].gt(0).sum())}"
                  f", unique crashes {int(ref[1].sum())}, unique hangs "
                  f"{int(ref[2].sum())}", flush=True)
            if err:
                raise AssertionError(f"triage kernels != CPU ({lanes} "
                                     f"lanes, {label} maps)")
        t_k = timed(lambda: st.static_triage(*seen, *args), 7)
        t_plain = timed(lambda: st.static_triage_plain(*seen, *args), 5)
        t_host = host_ms(lambda: st.static_triage(*seen, *args), 7)
        ops = arith.triage_ops(lanes, ne, n_slots)
        moved = lanes * (ne + 1 + 2 + 4 + 2) + 6 * prog.map_size
        b_ms, by = bound(moved, ops)
        print(f"triage kernels [{lanes} lanes, E {ne}, U {n_slots}, "
              f"{card}]: card {t_k:.4f} ms, bound {b_ms:.4f} ms ({by}: "
              f"{ops} operations, {moved} bytes), plain chain on the card "
              f"{t_plain:.3f} ms, host enqueue {t_host:.3f} ms", flush=True)
        if row is None:
            row = {"name": "kbz_triage_lanes/_resolve/_maps", "route": "cuda",
                   "source": "killerbeez_tpu_torch/csrc/triage.cu",
                   "replaces": None, "launches": None,
                   "max_abs_err": 0, "ms": t_k, "plain_ms": t_plain,
                   "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    return row


def device_spans() -> dict:
    """Phase 16: a ``-b 65536`` cuda_fused campaign of
    ``SPANS_SECONDS`` with
    the flight recorder on and the first 16 batches captured by
    ``--profile-device``; checks the device lane and returns the
    readings printed as the phase's line."""
    from killerbeez_tpu_torch.drivers.factory import driver_factory
    from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.models import targets_cgc
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator

    out = OUT / "spans"
    shutil.rmtree(out, ignore_errors=True)
    instr = JitHarnessInstrumentation(
        '{"target": "tlvstack_vm", "engine": "cuda_fused", '
        '"novelty": "throughput"}')
    mut = HavocMutator(json.dumps({"seed": MUT_SEED}),
                       targets_cgc.tlvstack_vm_seed())
    fz = Fuzzer(driver_factory("file", None, instr, mut),
                output_dir=str(out), batch_size=B, trace=1 << 20,
                profile_device=16)
    remaining, ends = fz._remaining, []

    def until_deadline(n):
        # the run's seconds count from its first dispatch, after the
        # profiler's start and the anchor
        t = time.perf_counter()
        if not ends:
            ends.append(t + SPANS_SECONDS)
        return 0 if t > ends[0] else remaining(n)

    fz._remaining = until_deadline
    t_run = time.perf_counter()
    fz.run()
    t = time.perf_counter()
    drift = _anchor_drift(fz.spans)

    host = json.loads((out / "trace.json").read_text())["traceEvents"]
    lane = next(e["tid"] for e in host if e["ph"] == "M"
                and e["args"]["name"] == "device")
    dev = [e for e in host if e["ph"] == "X" and e["tid"] == lane]
    n = {k: sum(e["name"] == k for e in dev)
         for k in ("kernels", "triage", "report", "dispatch")}
    sync = [e["ts"] for e in host if e["name"] == "clock_sync"]
    prof = json.loads((out / "device_trace" / "trace.json").read_text())
    kern = sorted((e for e in prof["traceEvents"]
                   if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    marks = [e["ts"] for e in kern if "spin_kernel" in e["name"]]
    if not (n["kernels"] == n["triage"] == n["report"] > 0
            and len(sync) == 1 and len(marks) == 1):
        raise AssertionError(f"device spans: lane counts {n}, "
                             f"{len(sync)} clock_sync, {len(marks)} "
                             "marker kernels")
    # the capture on the host's clock, by the marker; each captured
    # batch's kernels span must hold its fused kernel (phase 1) and its
    # kbz_vm_kernel (phase 2): how far inside it each lies bounds the
    # alignment's error from both sides
    offset = marks[0] - sync[0]
    spans = sorted((e for e in dev if e["name"] == "kernels"),
                   key=lambda e: e["ts"])
    fuzz = [e for e in kern if "kbz_fuzz_kernel" in e["name"]]
    vm = [e for e in kern if "kbz_vm_kernel" in e["name"]]
    before = [f["ts"] - offset - s["ts"] for f, s in zip(fuzz, spans)]
    after = [s["ts"] + s["dur"] - (v["ts"] + v["dur"] - offset)
             for v, s in zip(vm, spans)]
    reg = fz.telemetry.registry.counters
    keys = ("dev_kernels_seconds", "dev_triage_seconds",
            "dev_report_seconds", "dev_dispatch_seconds",
            "dev_between_seconds", "dispatch_lead_seconds",
            "telemetry_seconds", "checkpoint_seconds",
            "execute_seconds", "triage_seconds")
    return {"seconds": round(t - t_run, 3),
            "execs": int(reg.get("execs", 0)), "lane": n,
            "counters": {k: reg.get(k, 0.0) for k in keys},
            "self_seconds": sum(v for k, v in reg.items()
                                if k.endswith("_self_seconds")),
            "drift_us": 1e6 * drift,
            "captured_batches": len(before),
            "fuzz_kernel_after_span_start_us": _spread(before),
            "vm_kernel_before_span_end_us": _spread(after)}


def _anchor_drift(spans) -> float:
    """Seconds by which ``spans``' anchor places an event later than the
    host's clock saw it: the event recorded on the idle card between
    two clock reads, in the tightest of ``ANCHOR_ROUNDS`` rounds, less
    the middle of its reads."""
    from killerbeez_tpu_torch.telemetry.device import ANCHOR_ROUNDS

    torch.cuda.synchronize()
    best = None
    for _ in range(ANCHOR_ROUNDS):
        ev = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev.record()
        ev.synchronize()
        t1 = time.perf_counter()
        if best is None or t1 - t0 < best[0]:
            best = (t1 - t0, spans.host_time(ev) - (t0 + t1) / 2)
    return best[1]


def _spread(xs):
    """min, median and max of ``xs`` (None where empty)."""
    if not xs:
        return None
    return {"min": min(xs), "median": statistics.median(xs),
            "max": max(xs)}


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

    # -- phase 11: the crack and search tier ---------------------------
    phases.start("11a (distance engine, focus, descent)")
    crack_files = crack_seeds()
    distance_parity(card)
    phases.start("11b (crack CLI parity, tools)")
    crack_cli_parity(crack_files)
    phases.start("11c (crack flagship)")
    crack_launches = crack_flagships(card, crack_files)

    # -- phase 12: the stateful session tier (no kernel on its path) ---
    phases.start("12a (session executor card == CPU)")
    seq_seeds = stateful_seeds()
    session_parity(card)
    phases.start("12b (stateful CLI and tools card == CPU)")
    stateful_cli_parity(seq_seeds)
    phases.start("12c (stateful flagships)")
    single_launches = stateful_flagships(card, seq_seeds)

    # -- phase 13: the grammar tier and the zoo ------------------------
    phases.start("13a (grammar_havoc_at card == CPU)")
    zoo = zoo_files()
    gh_ms = grammar_parity(card, zoo, vk, prng)
    phases.start("13b (grammar CLI card == CPU)")
    grammar_cli_parity(zoo)
    phases.start("13c (grammar flagships)")
    grammar_launches = grammar_flagships(card, zoo, gh_ms)
    phases.start("13d (kbz-supervise, host tools)")
    supervisor_run()

    # -- phase 14: the learn tier and the fleet ------------------------
    t14 = time.perf_counter()
    phases.start("14a (learn model card == CPU)")
    cpu_tier, learn_times = learn_model_parity(card, vk, prng)
    phases.start("14b (learn parity)")
    learn_dispatch_parity(cpu_tier)
    learn_cli_parity()
    phases.start("14c (learn flagship)")
    learn_launches, _ = learn_flagships(card)
    phases.start("14d (fleet on one card)")
    fleet_launches = fleet_run(card)
    print(f"phase 14: {time.perf_counter() - t14:.1f} s wall", flush=True)

    # -- phase 15: the hybrid bridge and conformance repair ------------
    t15 = time.perf_counter()
    phases.start("15a (proxy verdicts card == CPU)")
    hseed = hybrid_seed()
    hybrid_verdicts(card, vk)
    phases.start("15b (hybrid CLI card == CPU)")
    hybrid_cli_parity(hseed)
    phases.start("15c (repair loop)")
    hybrid_repair(hseed)
    phases.start("15d (hybrid flagships)")
    hybrid_launches = hybrid_flagships(card, hybrid_seed(b"ABCC"))
    print(f"phase 15: {time.perf_counter() - t15:.1f} s wall", flush=True)

    # -- phase 17: the triage kernels ----------------------------------
    phases.start("17 (triage kernels)")
    triage_row = triage_kernels(card)

    # -- phase 16: the device spans -------------------------------------
    phases.start("16 (device spans)")
    print(json.dumps({"device_spans": device_spans(), "card": card}),
          flush=True)

    # -- phase 9: the record -------------------------------------------
    phases.start("9 (record)")
    print(f"main-path launches: host-driven {launches}, -G 16 "
          f"{gen_launches}, --mesh 1,1 {mesh_launches[0]}, --mesh 1,1 -G "
          f"16 {mesh_launches[1]}, --mesh 1,1 engine cuda "
          f"{vm_all_launches}, ipt {ipt_launches}, edges {edges_launches}, "
          f"rare-edge {rare_launches}, mutators {mut_launches}, crack "
          f"{crack_launches}, stateful: none (phase 12's single-shot lane "
          f"{single_launches}), grammar {grammar_launches}, learn "
          f"{learn_launches} (fleet workers, in their own processes: "
          f"{fleet_launches}), hybrid {hybrid_launches}; over this "
          f"whole run: {vk.LAUNCHES}, of which in its CLI runs "
          f"{CLI_LAUNCHES}",
          flush=True)
    launches = {k: launches[k] + gen_launches[k] + mesh_launches[0][k]
                + mesh_launches[1][k] + edges_launches[k] + rare_launches[k]
                + crack_launches[k] + single_launches[k]
                + hybrid_launches[k]
                for k in launches}
    all_lanes = (vm_all_launches["kbz_vm_kernel_all"]
                 + ipt_launches["kbz_vm_kernel_all"]
                 + rare_launches["kbz_vm_kernel_all"]
                 + crack_launches["kbz_vm_kernel_all"]
                 + grammar_launches["kbz_vm_kernel_all"]
                 + learn_launches["kbz_vm_kernel_all"]
                 + hybrid_launches["kbz_vm_kernel_all"]
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
        {**triage_row, "launches": launches["kbz_triage"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
