"""fuzzer CLI — argument parity with the reference client
(fuzzer/main.c:34-69): positional ``driver instrumentation mutator``
plus -n/-sf/-ss/-o/-d/-i/-m/-isd/-isf/-msd/-msf/-ms/-l, a batch size
and ``--device``.

Usage (the default campaign: corpus feedback every 8 batches with the
bandit scheduler, stats files and the event log in -o):
    python -m killerbeez_tpu_torch.fuzzer file jit_harness havoc \
        -sf seed.bin -b 65536 \
        -i '{"target": "tlvstack_vm", "engine": "cuda_fused"}'
Add ``-G 16`` for the device-resident generation loop: 16 generations
per dispatch, reseeded from a seed-slot ring on the card.  ``--mesh
dp,mp`` spreads the campaign over a (dp, mp) mesh of dp x mp cards
(``--device cpu``: dp x mp CPU shards), with ``-G`` the mesh-resident
generation scan.

Host-executed targets take the driver's path (the candidates are made
on the card and run as real processes):
    python -m killerbeez_tpu_torch.fuzzer stdin afl havoc \
        -ss ABC@ -b 4096 -d '{"path": "build/torch_native/corpus/test"}'
(``-i '{"device_triage": 1}'`` runs afl's novelty scan on the card;
``file return_code bit_flip`` runs one process per input).  ``-dt``
re-runs each unique crash under the ptrace debug tier and writes
``crashes/<md5>.info``.

``--schedule rare-edge`` signs each admitted finding with one extra
execution: on a side instrumentation with edge reporting (on the same
device) for KBVM targets, on the live target for host targets; KBVM
targets also prime the scheduler with the program's static edge
prior.  ``--crack N`` solves never-hit static edges into inputs after
N finding-free batches and injects them (``--vsa`` seeds the solver
from the value-set fixpoint, ``--descend M`` escalates the solver's
unknowns to branch-distance descent, ``--no-focus`` keeps the mutators
unfocused).  Runs on the CUDA card unless ``--device cpu`` is given.
Flags whose machinery is not ported yet are accepted by the parser and
refused with exit status 2, naming the flag.
Exit 86: the watchdog killed a stuck device wait; exit 87: the card
was lost (both after a checkpoint, for a supervisor to ``--resume``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

from .. import DEFAULT_BATCH_SIZE
from ..drivers.factory import driver_factory, driver_help
from ..instrumentation.factory import (
    instrumentation_factory, instrumentation_help,
)
from ..mutators.factory import mutator_factory, mutator_help
from ..ops.vm_kernel import LAUNCHES
from ..utils.fileio import read_file, write_buffer_to_file
from ..utils.logging import FatalError, INFO_MSG, setup_logging
from .loop import Fuzzer

# (flags, nargs) of the reference CLI's options whose machinery is not
# ported yet: parsed, then refused
UNPORTED = (
    (("--hybrid",), None), (("--hybrid-repeats",), None),
    (("--hybrid-queue",), None), (("--hybrid-workers",), None),
    (("--auto-repair",), "?"),
)
_NOT_GIVEN = object()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="killerbeez-tpu-torch-fuzzer",
        description="Killerbeez fuzzer on PyTorch/CUDA (driver / "
                    "instrumentation / mutator architecture)")
    p.add_argument("driver", nargs="?",
                   help="driver name (file, stdin, network_server, "
                        "network_client)")
    p.add_argument("instrumentation", nargs="?",
                   help="instrumentation name (jit_harness, ipt, afl, "
                        "return_code, debug)")
    p.add_argument("mutator", nargs="?", help="mutator name (havoc)")
    p.add_argument("-n", "--iterations", type=int, default=-1,
                   help="number of executions (-1 = until exhausted)")
    p.add_argument("-sf", "--seed-file", help="seed input file")
    p.add_argument("-ss", "--seed-string", help="seed input as a string")
    p.add_argument("-o", "--output", default="output",
                   help="findings directory (default ./output)")
    p.add_argument("-d", "--driver-options", help="driver JSON options")
    p.add_argument("-i", "--instrumentation-options",
                   help="instrumentation JSON options")
    p.add_argument("-m", "--mutator-options", help="mutator JSON options")
    p.add_argument("-isf", "--instrumentation-state-file",
                   help="load instrumentation state from file")
    p.add_argument("-isd", "--instrumentation-state-dump",
                   help="dump instrumentation state to file on exit")
    p.add_argument("-msf", "--mutator-state-file",
                   help="load mutator state from file")
    p.add_argument("-ms", "--mutator-state",
                   help="load mutator state from an inline string")
    p.add_argument("-msd", "--mutator-state-dump",
                   help="dump mutator state to file on exit")
    p.add_argument("-l", "--logging-options", help="logging JSON options")
    p.add_argument("-fb", "--feedback", type=int, default=-1,
                   help="coverage-guided corpus loop: every N "
                        "batches, rotate the seed through new-path "
                        "findings (default: ON for randomized "
                        "mutators, every 8 batches; 0 = off)")
    p.add_argument("--corpus-dir",
                   help="persistent corpus store directory: every "
                        "edge-novel finding is written through with "
                        "its metadata sidecar, so a campaign can be "
                        "resumed (by either package)")
    p.add_argument("--resume", action="store_true",
                   help="continue a killed campaign from --corpus-dir "
                        "(default <output>/corpus): restores rotation "
                        "arms, scheduler stats, lifetime counters and "
                        "mutator/instrumentation state; -n counts "
                        "THIS invocation's execs")
    p.add_argument("--schedule", default="bandit",
                   choices=["bandit", "rare-edge", "rr"],
                   help="seed-scheduling policy for corpus feedback "
                        "(default bandit: the greedy-optimistic decay "
                        "bandit with splice; rare-edge: prefer arms "
                        "holding the corpus-wide rarest edges, each "
                        "admission signed by one extra execution; rr: "
                        "round-robin)")
    p.add_argument("--crack", type=int, nargs="?", const=16, default=0,
                   metavar="N",
                   help="plateau crack stage (KBVM targets): "
                        "after N batches with no new paths (default "
                        "16 when the flag is bare), solve statically-"
                        "reachable-but-never-hit edges into concrete "
                        "inputs (analysis/solver.py) and inject them; "
                        "solve results persist to the corpus store's "
                        "solver.json so resumes don't re-solve")
    p.add_argument("--vsa", action="store_true",
                   help="with --crack: seed the solver's byte "
                        "domains from the value-set fixpoint "
                        "(analysis/vsa.py) and escalate visit caps "
                        "on honest visit-cap unknowns; the fixpoint "
                        "document caches in the corpus checkpoint "
                        "epoch so --resume and repeated cracks "
                        "never re-run it")
    p.add_argument("--descend", type=int, nargs="?", const=48,
                   default=0, metavar="N",
                   help="with --crack: escalate solver-UNKNOWN edges "
                        "(checksum loops, deep loop-carried state) to "
                        "the gradient-guided search tier — batched "
                        "branch-distance descent on the card, up to N "
                        "iterations per edge (default 48 when bare); "
                        "verified witnesses inject like solved "
                        "inputs, verdicts cache in solver.json so "
                        "--resume never re-descends")
    p.add_argument("--descend-lanes", type=int, default=1024,
                   metavar="B",
                   help="candidate lanes per descent dispatch "
                        "(default 1024)")
    p.add_argument("--descend-engine", choices=("device", "host"),
                   default="device",
                   help="descent engine: 'device' (default) fuses R "
                        "rank->probe->mutate->re-score iterations "
                        "into one dispatch with input-to-state "
                        "operand matching (search/device_descent.py; "
                        "stands down to the host engine on edges it "
                        "cannot take), 'host' forces the "
                        "host-driven engine (search/descent.py)")
    p.add_argument("--descend-scan-iters", type=int, default=0,
                   metavar="R",
                   help="with --descend-engine device: iterations "
                        "per device dispatch (default 8; the gauge "
                        "descent_iterations_per_dispatch shows the "
                        "live value)")
    p.add_argument("--no-focus", action="store_true",
                   help="with --crack: do NOT install the Angora-"
                        "style focused-mutation byte masks derived "
                        "from the uncovered frontier's dependency "
                        "sets (mutators then keep their exact "
                        "unfocused candidate streams)")
    p.add_argument("-dt", "--debug-triage", action="store_true",
                   help="re-run each unique crash once under the "
                        "ptrace debug tier and save signal-level "
                        "details next to the repro (host targets)")
    p.add_argument("-b", "--batch-size", type=int,
                   default=DEFAULT_BATCH_SIZE,
                   help="candidates per device step")
    p.add_argument("-K", "--accumulate", type=int, default=0,
                   help="fused device path: K batches per call "
                        "(0 = auto, 1 = per-batch)")
    p.add_argument("--sync-manager",
                   help="manager base URL for fleet corpus exchange "
                        "(POST/GET /api/corpus/<campaign>); requires "
                        "--sync-campaign")
    p.add_argument("--sync-campaign",
                   help="campaign key for --sync-manager (job id)")
    p.add_argument("--sync-worker", default=None,
                   help="worker name for corpus sync (default "
                        "worker-<pid>)")
    p.add_argument("--sync-interval", type=float, default=30.0,
                   help="seconds between corpus sync rounds "
                        "(default 30)")
    p.add_argument("--gossip", type=int, nargs="?", const=0,
                   default=None, metavar="PORT",
                   help="peer-to-peer corpus gossip (requires "
                        "--sync-manager): serve this worker's corpus "
                        "on PORT (0 = ephemeral, the bare default) "
                        "and pull a random fanout of peers each sync "
                        "round, with the manager demoted to peer "
                        "directory + anti-entropy backstop.  Synced-in "
                        "entries are validated (schema/size/cov_hash) "
                        "and quarantined to <corpus>/quarantine/ on "
                        "failure; peers crossing the poison threshold "
                        "are banned with decorrelated backoff")
    p.add_argument("--gossip-fanout", type=int, default=2,
                   metavar="N",
                   help="peers pulled per gossip round (default 2)")
    p.add_argument("--gossip-host", default="127.0.0.1",
                   metavar="ADDR",
                   help="address the gossip sidecar binds (default "
                        "127.0.0.1 = loopback-only; multi-host fleets "
                        "need 0.0.0.0 or the NIC address, usually with "
                        "--gossip-advertise)")
    p.add_argument("--gossip-advertise", metavar="URL",
                   help="URL peers should reach this worker's sidecar "
                        "at (default: its bind address)")
    p.add_argument("--learn", action="store_true",
                   help="learned mutation shaping (jit_harness): train "
                        "a small byte-saliency model on the card from "
                        "the campaign's own lineage (provenance "
                        "sidecars) and focus havoc on the "
                        "predicted-useful positions: per generation in "
                        "the -G loops (one device and --mesh), per "
                        "rotation via focus masks in the host-driven "
                        "loop.  Until the first training round masks "
                        "are all-ones and every path is bit-identical "
                        "to an unshaped campaign; the weights ride the "
                        "checkpoint epoch, so --resume restores them.  "
                        "Exclusive with --crack")
    p.add_argument("--learn-interval", type=float, default=5.0,
                   metavar="S",
                   help="with --learn: minimum seconds between training "
                        "rounds (default 5)")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default: the card) or "cpu" (the '
                        "plain PyTorch versions)")
    p.add_argument("--trace", type=int, nargs="?", const=65536,
                   default=0, metavar="MAX_SPANS",
                   help="flight recorder: record pipeline trace spans "
                        "(one lane per in-flight batch) into a bounded "
                        "ring and export <output>/trace.json (Chrome "
                        "trace-event JSON); the optional value caps "
                        "the ring in events (default 65536)")
    p.add_argument("--profile-device", type=int, nargs="?", const=8,
                   default=0, metavar="N",
                   help="capture a torch.profiler trace (CPU, and CUDA "
                        "activity on the card) of N batches or "
                        "generations (default 8 when bare) into "
                        "<output>/device_trace/trace.json, next to the "
                        "host trace; a profiler that cannot start "
                        "warns and the campaign goes on")
    p.add_argument("--events-max-mb", type=float, default=0.0,
                   metavar="MB",
                   help="rotate <output>/events.jsonl to "
                        "events.jsonl.1 when it exceeds this many "
                        "megabytes (0 = unbounded, the default)")
    p.add_argument("--watchdog", type=float, nargs="?", const=8.0,
                   default=0.0, metavar="MULT",
                   help="dispatch watchdog: every blocking device "
                        "wait gets a deadline of MULT x the EMA batch "
                        "time (default 8 when bare), clamped to "
                        "[--watchdog-min, --watchdog-max]; a stall "
                        "dumps in-flight lane state, checkpoints and "
                        "exits 86")
    p.add_argument("--watchdog-min", type=float, default=5.0,
                   metavar="S",
                   help="watchdog deadline floor in seconds "
                        "(default 5)")
    p.add_argument("--watchdog-max", type=float, default=120.0,
                   metavar="S",
                   help="watchdog deadline ceiling in seconds "
                        "(default 120)")
    p.add_argument("--chaos", metavar="SPEC",
                   help="fault-injection spec (JSON, or @file) fired "
                        "at the chaos points — device dispatch/wait, "
                        "persistence, finding and event writes (also "
                        "read from the KBZ_CHAOS environment "
                        "variable)")
    p.add_argument("--no-stats", action="store_true",
                   help="disable the campaign stats files "
                        "(fuzzer_stats / plot_data / stats.jsonl) and "
                        "the event log; counters still accumulate "
                        "in-process")
    p.add_argument("--stats-interval", type=float, default=5.0,
                   help="seconds between stats-file snapshots "
                        "(default 5)")
    p.add_argument("-G", "--generations", type=int, nargs="?",
                   const=16, default=0, metavar="G",
                   help="device-resident generation loop (jit_harness "
                        "+ havoc): the card runs up to G full "
                        "mutate->execute->triage->reseed generations "
                        "per host dispatch (default 16 when bare) "
                        "against device-resident virgin maps and a "
                        "seed-slot ring; the host only drains the "
                        "bounded findings ring + admission ledger.  "
                        "Stands down (warning) when the mutator cannot "
                        "run it; with -fb 0 the candidate stream is "
                        "bit-identical to the host-driven loop's")
    p.add_argument("--stateful", type=int, nargs="?", const=0,
                   default=None, metavar="M",
                   help="stateful protocol sessions (jit_harness): "
                        "inputs are framed message sequences "
                        "(stateful/framing.py; frame seeds with python "
                        "-m killerbeez_tpu_torch.stateful.framing) "
                        "executed message-by-message from carried "
                        "machine state, with a state x edge virgin map "
                        "folded alongside the classic novelty maps.  The "
                        "optional value overrides the sequence capacity "
                        "M (default: the target's registered "
                        "StatefulSpec).  Runs the plain torch session "
                        "executor (the kernels stand down); the fused "
                        "superbatch stands down, -G and --mesh run the "
                        "stateful generation loop and mesh step")
    p.add_argument("--mesh",
                   help='campaign over a "dp,mp" device mesh (e.g. '
                        "--mesh 4,2): candidates shard over dp, coverage "
                        "maps over mp, findings land in -o exactly like "
                        "one device; takes dp x mp CUDA cards (--device "
                        "cpu: dp x mp CPU shards); requires jit_harness "
                        "+ havoc and -b divisible by dp; combine with -G "
                        "for the mesh-resident generation scan")
    p.add_argument("--list", action="store_true",
                   help="list components and their options, then exit")
    for flags, nargs in UNPORTED:
        p.add_argument(*flags, nargs=nargs, default=_NOT_GIVEN,
                       help="not ported yet")
    return p


def list_components() -> str:
    return (driver_help() + "\n" + instrumentation_help() + "\n"
            + mutator_help())


def _wire_rare_edge_signer(fuzzer, driver) -> None:
    """``--schedule rare-edge`` needs per-entry coverage signatures.
    Each admitted finding is signed with ONE extra execution;
    admissions are rare, so the batched path stays untouched.  Device
    tiers sign on a side instrumentation instance with edge reporting
    forced on, on the main instance's device (the main instance keeps
    its fused and superbatch paths); host tiers re-run the input on the
    live target and read its raw trace.  Instrumentations that cannot
    report edges (ipt) leave entries unsigned: the scheduler probes
    those once."""
    instr = driver.instrumentation
    side: dict = {}

    def sign(buf: bytes):
        if instr.device_backed:
            s = side.get("instr")
            if s is None:
                from ..tools.tracer import force_edges_option
                s = side["instr"] = instrumentation_factory(
                    instr.name,
                    force_edges_option(json.dumps(instr.options)),
                    device=instr.device)
            s.enable(buf)
            edges = s.get_edges()
            return [e for e, _ in edges] if edges else None
        # host tier: one extra exec on the live target (the novelty
        # fold is idempotent: the entry was just executed)
        driver.test_input(buf)
        trace_fn = getattr(instr, "last_trace", None)
        if trace_fn is not None:
            trace = trace_fn()
            if trace is not None:
                return [int(i) for i in np.flatnonzero(trace)]
        edges = instr.get_edges()
        return [e for e, _ in edges] if edges else None

    fuzzer._signer = sign


def _wire_static_prior(fuzzer, driver) -> None:
    """``--schedule rare-edge`` on a KBVM target: prime the scheduler
    with the static edge-frequency prior (analysis.static_edge_prior),
    which only breaks cold-start ties."""
    prog = getattr(driver.instrumentation, "program", None)
    if prog is None or \
            not hasattr(fuzzer.scheduler, "set_static_prior"):
        return
    from ..analysis import static_edge_prior
    fuzzer.scheduler.set_static_prior(static_edge_prior(prog))


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    for flags, _ in UNPORTED:
        dest = flags[-1].lstrip("-").replace("-", "_")
        if getattr(args, dest) is not _NOT_GIVEN:
            print(f"error: {'/'.join(flags)} is not ported yet",
                  file=sys.stderr)
            return 2
    if args.list:
        print(list_components())
        return 0
    if not (args.driver and args.instrumentation and args.mutator):
        print("error: driver, instrumentation and mutator are required",
              file=sys.stderr)
        return 2
    try:
        setup_logging(args.logging_options)
        # chaos harness: explicit --chaos wins; KBZ_CHAOS is how a
        # supervisor injects faults into one child launch
        from ..resilience import chaos as _chaos
        _chaos.configure(args.chaos or os.environ.get("KBZ_CHAOS"))
        if args.seed_file:
            seed = read_file(args.seed_file)
        elif args.seed_string:
            seed = args.seed_string.encode()
        else:
            print("error: a seed is required (-sf or -ss)",
                  file=sys.stderr)
            return 2

        if args.learn:
            # inject the learn option into the instrumentation config
            # (the engine's stand-down and tool visibility — the
            # augmentation --stateful uses)
            if args.instrumentation != "jit_harness":
                print("error: --learn needs the jit_harness "
                      "instrumentation (the saliency model trains and "
                      "infers on the device the fuzzer runs on)",
                      file=sys.stderr)
                return 2
            if args.crack:
                print("error: --learn and --crack are mutually "
                      "exclusive — each installs its own mutation focus "
                      "masks (learned saliency vs the static frontier "
                      "dependency sets); run one mask source at a time",
                      file=sys.stderr)
                return 2
            try:
                iopts = json.loads(args.instrumentation_options) \
                    if args.instrumentation_options else {}
            except ValueError:
                iopts = None     # the factory reports the parse error
            if isinstance(iopts, dict):
                iopts.setdefault("learn", 1)
                args.instrumentation_options = json.dumps(iopts)

        if args.stateful is not None:
            # inject the session-tier options into the instrumentation
            # config
            if args.instrumentation != "jit_harness":
                print("error: --stateful needs the jit_harness "
                      "instrumentation (the session executor runs the "
                      "KBVM)", file=sys.stderr)
                return 2
            try:
                iopts = json.loads(args.instrumentation_options) \
                    if args.instrumentation_options else {}
            except ValueError:
                iopts = None     # the factory reports the parse error
            if isinstance(iopts, dict):
                iopts.setdefault("stateful", 1)
                if args.stateful > 0:
                    iopts["msgs"] = args.stateful
                args.instrumentation_options = json.dumps(iopts)

        instrumentation = instrumentation_factory(
            args.instrumentation, args.instrumentation_options,
            device=args.device)
        if args.instrumentation_state_file:
            instrumentation.set_state(
                read_file(args.instrumentation_state_file).decode())
        mutator = mutator_factory(args.mutator, args.mutator_options,
                                  seed, device=args.device)
        if args.mutator_state:
            mutator.set_state(args.mutator_state)
        elif args.mutator_state_file:
            mutator.set_state(read_file(args.mutator_state_file).decode())
        if args.mesh:
            from ..parallel.campaign import ShardedCampaignDriver
            from ..utils.logging import WARNING_MSG
            if args.driver != "file" or args.driver_options:
                WARNING_MSG(
                    "--mesh campaigns deliver candidates on-device; "
                    "the %r driver%s is ignored", args.driver,
                    " and -d options" if args.driver_options else "")
            if args.instrumentation != "jit_harness":
                print("error: --mesh campaigns need the jit_harness "
                      "instrumentation", file=sys.stderr)
                return 2
            if not hasattr(mutator, "fused_spec"):
                print("error: --mesh campaigns need the havoc "
                      "mutator (keyed per-lane candidate streams)",
                      file=sys.stderr)
                return 2
            driver = ShardedCampaignDriver(
                args.mesh, instrumentation, mutator,
                batch_size=args.batch_size)
        else:
            driver = driver_factory(args.driver, args.driver_options,
                                    instrumentation, mutator,
                                    device=args.device)

        corpus_dir = args.corpus_dir
        if args.resume and not corpus_dir:
            corpus_dir = os.path.join(args.output, "corpus")
        sync = None
        if args.gossip is not None and not args.sync_manager:
            print("error: --gossip needs --sync-manager (the peer "
                  "directory lives there)", file=sys.stderr)
            return 2
        if args.sync_manager:
            if not args.sync_campaign:
                print("error: --sync-manager needs --sync-campaign",
                      file=sys.stderr)
                return 2
            worker_name = args.sync_worker or f"worker-{os.getpid()}"
            if args.gossip is not None:
                from ..corpus.gossip import GossipSync
                sync = GossipSync(args.sync_manager, args.sync_campaign,
                                  worker=worker_name,
                                  interval_s=args.sync_interval,
                                  fanout=args.gossip_fanout,
                                  listen_host=args.gossip_host,
                                  listen_port=args.gossip,
                                  advertise=args.gossip_advertise)
            else:
                from ..corpus.sync import CorpusSync
                sync = CorpusSync(args.sync_manager, args.sync_campaign,
                                  worker=worker_name,
                                  interval_s=args.sync_interval)
        watchdog = None
        if args.watchdog > 0:
            from ..resilience.watchdog import DispatchWatchdog
            watchdog = DispatchWatchdog(
                multiplier=args.watchdog,
                min_deadline=args.watchdog_min,
                max_deadline=args.watchdog_max)
        learn_tier = None
        if args.learn:
            from ..learn import LearnTier
            learn_tier = LearnTier(
                train_interval_s=args.learn_interval,
                max_len=getattr(mutator, "max_length", 4096),
                device=args.device)

        fuzzer = Fuzzer(driver, output_dir=args.output,
                        batch_size=args.batch_size,
                        debug_triage=args.debug_triage,
                        feedback=args.feedback,
                        accumulate=args.accumulate,
                        stats=not args.no_stats,
                        stats_interval=args.stats_interval,
                        scheduler=args.schedule,
                        corpus_dir=corpus_dir,
                        resume=args.resume,
                        trace=args.trace,
                        events_max_mb=args.events_max_mb,
                        watchdog=watchdog,
                        profile_device=args.profile_device,
                        generations=args.generations,
                        sync=sync, learn=learn_tier)
        if args.schedule == "rare-edge":
            _wire_rare_edge_signer(fuzzer, driver)
            _wire_static_prior(fuzzer, driver)
        if args.descend and not args.crack:
            print("error: --descend escalates the crack stage's "
                  "solver-unknown frontier — it needs --crack",
                  file=sys.stderr)
            return 2
        if args.vsa and not args.crack:
            print("error: --vsa seeds the crack stage's solver "
                  "from the value-set fixpoint — it needs --crack",
                  file=sys.stderr)
            return 2
        if args.crack:
            prog = getattr(instrumentation, "program", None)
            if prog is None or not instrumentation.device_backed \
                    or args.mesh:
                print("error: --crack needs a KBVM device target "
                      "(jit_harness, single-device) — the solver works "
                      "on the program text", file=sys.stderr)
                return 2
            if getattr(instrumentation, "stateful_spec", None) \
                    is not None:
                print("error: --crack models single-shot execution "
                      "(path conditions over ONE input) — it cannot "
                      "drive the stateful session tier; run it "
                      "without --stateful, or fuzz sequences with "
                      "-G/havoc/multipart", file=sys.stderr)
                return 2
            from .crack import BranchCracker
            fuzzer.cracker = BranchCracker(
                prog, plateau_batches=args.crack,
                focus=not args.no_focus, store=fuzzer.store,
                descend=args.descend,
                descend_lanes=args.descend_lanes,
                descend_engine=args.descend_engine,
                descend_scan_iters=args.descend_scan_iters,
                vsa=args.vsa, device=args.device)
        try:
            stats = fuzzer.run(args.iterations)
        except Exception as e:
            # run()'s finally already checkpointed; classify a lost
            # card for a supervisor (exit 87: re-probe the devices
            # before restarting into --resume)
            from ..resilience import DEVICE_LOST_EXIT_CODE, \
                is_device_loss
            if is_device_loss(e):
                fuzzer.telemetry.event("device_lost",
                                       error=str(e)[:300])
                print(f"error: device lost: {e}", file=sys.stderr)
                return DEVICE_LOST_EXIT_CODE
            raise
        # both rates read the SAME registry the loop recorded into
        INFO_MSG(
            "results: %d crashes (%d unique), %d hangs (%d unique), "
            "%d new paths; %.0f execs/s lifetime (%.0f recent)",
            stats.crashes, stats.unique_crashes, stats.hangs,
            stats.unique_hangs, stats.new_paths, stats.execs_per_sec,
            stats.execs_per_sec_ema)
        INFO_MSG("kernel launches: %s", json.dumps(LAUNCHES))

        # state dumps on exit (reference fuzzer/main.c:426-447)
        if args.instrumentation_state_dump:
            write_buffer_to_file(args.instrumentation_state_dump,
                                 instrumentation.get_state().encode())
        if args.mutator_state_dump:
            write_buffer_to_file(args.mutator_state_dump,
                                 mutator.get_state().encode())
        if sync is not None:
            sync.close()        # the gossip sidecar stops serving
        driver.cleanup()
        instrumentation.cleanup()
        mutator.cleanup()
        return 0
    except FatalError:
        return 1
    except (ValueError, FileNotFoundError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
