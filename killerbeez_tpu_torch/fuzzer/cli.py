"""fuzzer CLI — argument parity with the reference client
(fuzzer/main.c:34-69): positional ``driver instrumentation mutator``
plus -n/-sf/-ss/-o/-d/-i/-m/-isd/-isf/-msd/-msf/-ms/-l, a batch size
and ``--device``.

Usage:
    python -m killerbeez_tpu_torch.fuzzer file jit_harness havoc \
        -sf seed.bin -b 65536 -fb 0 \
        -i '{"target": "tlvstack_vm", "engine": "cuda_fused"}'

Runs on the CUDA card unless ``--device cpu`` is given.  Flags whose
machinery is not ported yet are accepted by the parser and refused
with exit status 2, naming the flag; ``-fb`` must be 0 (corpus
feedback is not ported yet).  No stats files are written yet.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

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
    (("--corpus-dir",), None), (("--resume",), "?"),
    (("--schedule",), None), (("--sync-manager",), None),
    (("--sync-campaign",), None), (("--sync-worker",), None),
    (("--sync-interval",), None), (("--gossip",), "?"),
    (("--gossip-fanout",), None), (("--gossip-host",), None),
    (("--gossip-advertise",), None), (("--hybrid",), None),
    (("--hybrid-repeats",), None), (("--hybrid-queue",), None),
    (("--hybrid-workers",), None), (("--auto-repair",), "?"),
    (("--crack",), "?"), (("--vsa",), "?"), (("--descend",), "?"),
    (("--descend-lanes",), None), (("--descend-engine",), None),
    (("--descend-scan-iters",), None), (("--learn",), "?"),
    (("--learn-interval",), None), (("--no-focus",), "?"),
    (("-dt", "--debug-triage"), "?"), (("--trace",), "?"),
    (("--profile-device",), "?"), (("--events-max-mb",), None),
    (("--watchdog",), "?"), (("--watchdog-min",), None),
    (("--watchdog-max",), None), (("--chaos",), None),
    (("--stats-interval",), None), (("-G", "--generations"), "?"),
    (("--stateful",), "?"), (("--mesh",), None),
)
_NOT_GIVEN = object()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="killerbeez-tpu-torch-fuzzer",
        description="Killerbeez fuzzer on PyTorch/CUDA (driver / "
                    "instrumentation / mutator architecture)")
    p.add_argument("driver", nargs="?", help="driver name (file)")
    p.add_argument("instrumentation", nargs="?",
                   help="instrumentation name (jit_harness)")
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
    p.add_argument("-fb", "--feedback", type=int, default=None,
                   help="corpus feedback cadence; must be 0 (feedback "
                        "is not ported yet)")
    p.add_argument("-b", "--batch-size", type=int,
                   default=DEFAULT_BATCH_SIZE,
                   help="candidates per device step")
    p.add_argument("-K", "--accumulate", type=int, default=0,
                   help="fused device path: K batches per call "
                        "(0 = auto, 1 = per-batch)")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default: the card) or "cpu" (the '
                        "plain PyTorch versions)")
    p.add_argument("--no-stats", action="store_true",
                   help="accepted for parity; no stats files are "
                        "written yet")
    p.add_argument("--list", action="store_true",
                   help="list components and their options, then exit")
    for flags, nargs in UNPORTED:
        p.add_argument(*flags, nargs=nargs, default=_NOT_GIVEN,
                       help="not ported yet")
    return p


def list_components() -> str:
    return (driver_help() + "\n" + instrumentation_help() + "\n"
            + mutator_help())


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    for flags, _ in UNPORTED:
        dest = flags[-1].lstrip("-").replace("-", "_")
        if getattr(args, dest) is not _NOT_GIVEN:
            print(f"error: {'/'.join(flags)} is not ported yet",
                  file=sys.stderr)
            return 2
    if args.feedback != 0:
        print("error: -fb/--feedback: corpus feedback is not ported "
              "yet; pass -fb 0", file=sys.stderr)
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
        if args.seed_file:
            seed = read_file(args.seed_file)
        elif args.seed_string:
            seed = args.seed_string.encode()
        else:
            print("error: a seed is required (-sf or -ss)",
                  file=sys.stderr)
            return 2

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
        driver = driver_factory(args.driver, args.driver_options,
                                instrumentation, mutator,
                                device=args.device)

        fuzzer = Fuzzer(driver, output_dir=args.output,
                        batch_size=args.batch_size, feedback=0,
                        accumulate=args.accumulate)
        stats = fuzzer.run(args.iterations)
        INFO_MSG(
            "results: %d crashes (%d unique), %d hangs (%d unique), "
            "%d new paths; %.0f execs/s", stats.crashes,
            stats.unique_crashes, stats.hangs, stats.unique_hangs,
            stats.new_paths, stats.execs_per_sec)
        INFO_MSG("kernel launches: %s", json.dumps(LAUNCHES))

        # state dumps on exit (reference fuzzer/main.c:426-447)
        if args.instrumentation_state_dump:
            write_buffer_to_file(args.instrumentation_state_dump,
                                 instrumentation.get_state().encode())
        if args.mutator_state_dump:
            write_buffer_to_file(args.mutator_state_dump,
                                 mutator.get_state().encode())
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
