"""Campaign supervisor — ``kbz-supervise``.

The port of the JAX package's ``resilience/supervisor.py``.  The
reference's manager/BOINC tier assumes workers die constantly and
campaigns survive anyway (PAPER.md §L3+); without a supervisor one
device-loss error, a lost card, a stuck dispatch or a mid-write
SIGKILL ends the campaign and recovery is a human typing
``--resume``.  The supervisor closes that
gap: it runs the fuzz loop as a CHILD process, classifies every exit,
and restarts into ``--resume`` with capped exponential backoff +
jitter — the same preemption-tolerant checkpoint/restart shape
training stacks use.

State machine (docs/RESILIENCE.md has the diagram)::

    LAUNCH -> RUNNING -> classify exit
      clean         -> DONE (exit 0)
      watchdog-kill -> BACKOFF -> RESTART (--resume)
      crash         -> BACKOFF -> RESTART (--resume)
      device-lost   -> PROBE (a fresh process re-inits the CUDA runtime)
                         devices >= need        -> BACKOFF -> RESTART
                         0 < devices < need     -> DEGRADE (mesh
                                                   dp-shrink) -> RESTART
                         none after probe budget-> FALLBACK argv
                                                   (native tier) or DONE

Exit classification:

  * rc 0                      -> clean
  * rc ``WATCHDOG_EXIT_CODE`` -> watchdog-kill (stuck dispatch; the
                                 child already dumped its state)
  * rc ``DEVICE_LOST_EXIT_CODE`` or a device-loss marker in the
    stderr tail              -> device-lost
  * anything else (including signals: rc < 0) -> crash

Device probing runs in a FRESH subprocess because a process that lost
its card cannot re-initialize CUDA in place; a fresh child gets a
fresh runtime.  ``--probe-cmd`` overrides the probe (tests use
``echo N``; operators can point it at their platform's health check).

Usage (``kbz-supervise`` is ``python -m
killerbeez_tpu_torch.resilience.supervisor``)::

    kbz-supervise [supervisor flags] -- file jit_harness havoc \
        -i '{"target": "tlvstack_vm"}' -sf seed -o out -n -1

Everything after ``--`` is the fuzzer argv (exactly what you would
pass to ``python -m killerbeez_tpu_torch.fuzzer``).  The supervisor injects ``--corpus-dir
<out>/corpus`` when absent (there must be something to resume) and
appends ``--resume`` from the second launch on.  Supervision history
is appended to ``<out>/supervisor.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shlex
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import (
    DEVICE_LOST_EXIT_CODE, WATCHDOG_EXIT_CODE, is_device_loss,
)
from .. import DEFAULT_BATCH_SIZE
from ..utils.logging import INFO_MSG, WARNING_MSG, setup_logging

#: exit classes
CLEAN, CRASH, DEVICE_LOST, WATCHDOG = \
    "clean", "crash", "device_lost", "watchdog"

#: default probe: count the visible CUDA cards in a fresh interpreter
_DEFAULT_PROBE = (
    f"{shlex.quote(sys.executable)} -c "
    "\"import torch; print(torch.cuda.device_count())\"")


def classify_exit(rc: int, stderr_tail: List[str]) -> str:
    """Map a child's return code + captured stderr tail onto an exit
    class.  Signals surface as negative rc from subprocess."""
    if rc == 0:
        return CLEAN
    if rc == WATCHDOG_EXIT_CODE:
        return WATCHDOG
    if rc == DEVICE_LOST_EXIT_CODE:
        return DEVICE_LOST
    if any(is_device_loss(line) for line in stderr_tail):
        return DEVICE_LOST
    return CRASH


def _arg_value(argv: List[str], *names: str,
               default: Optional[str] = None) -> Optional[str]:
    for i, a in enumerate(argv):
        if a in names and i + 1 < len(argv):
            return argv[i + 1]
    return default


def shrink_mesh(mesh: str, devices: int,
                batch: int = 0) -> Optional[str]:
    """Degrade a ``dp,mp`` mesh to fit ``devices`` chips by shrinking
    dp (candidate sharding degrades gracefully; mp is the coverage
    model partition and is not renegotiable here).  When ``batch`` is
    known, the new dp must also DIVIDE it — the sharded campaign
    driver rejects ``-b % dp != 0`` at startup, so a dp that merely
    fits the chips would turn one device loss into a restart crash
    loop.  Returns the new mesh string, the same one when it already
    fits, or None when no dp >= 1 satisfies both constraints."""
    try:
        dp, mp = (int(x) for x in mesh.split(","))
    except ValueError:
        return None
    limit = devices // mp if mp else 0
    for cand in range(min(dp, limit), 0, -1):
        if batch > 0 and batch % cand:
            continue
        return f"{cand},{mp}"
    return None


class Supervisor:
    """Run-classify-restart driver for one campaign."""

    def __init__(self, fuzzer_argv: List[str],
                 max_restarts: int = -1,
                 backoff_base: float = 1.0,
                 backoff_cap: float = 60.0,
                 healthy_after: float = 60.0,
                 probe_cmd: Optional[str] = None,
                 probe_attempts: int = 5,
                 fallback: Optional[str] = None,
                 chaos: Optional[str] = None,
                 chaos_launches: int = 1,
                 child_cmd: Optional[List[str]] = None,
                 rng: Optional[random.Random] = None,
                 sleep_fn=time.sleep):
        self.argv = list(fuzzer_argv)
        self.max_restarts = int(max_restarts)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        #: a child that lived this long resets the backoff streak
        self.healthy_after = float(healthy_after)
        self.probe_cmd = probe_cmd or _DEFAULT_PROBE
        self.probe_attempts = int(probe_attempts)
        #: native-tier-only argv (string, shlex-split) used when no
        #: device ever comes back
        self.fallback = fallback
        #: chaos spec injected into the first ``chaos_launches``
        #: launches only (later restarts run clean — the harness
        #: tests recovery, not perpetual re-failure)
        self.chaos = chaos
        self.chaos_launches = int(chaos_launches)
        #: child command prefix (tests substitute a stub script)
        self.child_cmd = child_cmd or [sys.executable, "-m",
                                       "killerbeez_tpu_torch.fuzzer"]
        self.rng = rng or random.Random()
        self.sleep = sleep_fn
        self.output_dir = _arg_value(self.argv, "-o", "--output",
                                     default="output")
        if "--corpus-dir" not in self.argv and \
                "--resume" not in self.argv:
            self.argv += ["--corpus-dir",
                          os.path.join(self.output_dir, "corpus")]
        self.restarts = 0
        self.launches = 0
        self.streak = 0                 # unhealthy exits in a row
        self.history: List[Dict[str, Any]] = []
        self._on_fallback = False

    # -- supervision log -------------------------------------------------

    def _log(self, event: str, **fields) -> None:
        rec = {"t": time.time(), "event": event}
        rec.update(fields)
        self.history.append(rec)
        try:
            os.makedirs(self.output_dir, exist_ok=True)
            with open(os.path.join(self.output_dir,
                                   "supervisor.jsonl"), "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")
        except OSError as e:
            WARNING_MSG("supervisor log append failed: %s", e)

    # -- one child launch ------------------------------------------------

    def _child_argv(self) -> List[str]:
        argv = list(self.argv)
        if self.launches > 0 and "--resume" not in argv:
            argv.append("--resume")
        return self.child_cmd + argv

    def launch_once(self) -> Tuple[int, List[str], float]:
        """Run the child to exit; returns (rc, stderr tail lines,
        lifetime seconds).  Stderr is teed: forwarded live to our
        stderr AND kept in a bounded tail for classification."""
        env = dict(os.environ)
        chaotic = bool(self.chaos
                       and self.launches < self.chaos_launches)
        if chaotic:
            env["KBZ_CHAOS"] = self.chaos
        else:
            env.pop("KBZ_CHAOS", None)
        argv = self._child_argv()
        self._log("launch", n=self.launches, argv=argv, chaos=chaotic)
        INFO_MSG("supervisor: launch %d: %s", self.launches,
                 " ".join(shlex.quote(a) for a in argv))
        t0 = time.monotonic()
        proc = subprocess.Popen(argv, stderr=subprocess.PIPE, env=env)
        tail: deque = deque(maxlen=64)

        def _tee():
            for raw in proc.stderr:
                try:
                    line = raw.decode(errors="replace")
                except Exception:
                    continue
                tail.append(line.rstrip("\n"))
                try:
                    sys.stderr.write(line)
                except OSError:
                    pass

        t = threading.Thread(target=_tee, daemon=True)
        t.start()
        rc = proc.wait()
        t.join(timeout=5)
        self.launches += 1
        return rc, list(tail), time.monotonic() - t0

    # -- backoff ---------------------------------------------------------

    def backoff_seconds(self) -> float:
        """Capped exponential on the unhealthy streak, with +-50%
        jitter so a preempted FLEET doesn't restart in lockstep."""
        base = min(self.backoff_cap,
                   self.backoff_base * (2 ** max(self.streak - 1, 0)))
        return base * (0.5 + self.rng.random())

    # -- device recovery -------------------------------------------------

    def probe_devices(self) -> int:
        """Count usable cards from a FRESH process (the only way to
        re-initialize the CUDA runtime after a loss).
        Returns -1 when the probe itself fails."""
        try:
            out = subprocess.run(
                self.probe_cmd, shell=True, capture_output=True,
                text=True, timeout=120)
        except (subprocess.TimeoutExpired, OSError) as e:
            WARNING_MSG("supervisor: device probe failed: %s", e)
            return -1
        if out.returncode != 0:
            return -1
        try:
            return int(out.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError):
            return -1

    def _mesh_need(self) -> int:
        mesh = _arg_value(self.argv, "--mesh")
        if not mesh:
            return 1
        try:
            dp, mp = (int(x) for x in mesh.split(","))
            return dp * mp
        except ValueError:
            return 1

    def _handle_device_loss(self) -> bool:
        """Probe (with backoff) until devices return; degrade the
        mesh or fall back to the native-tier argv when they don't.
        Returns True when a restart is worth attempting."""
        need = self._mesh_need()
        for attempt in range(self.probe_attempts):
            n = self.probe_devices()
            self._log("device_probe", attempt=attempt, devices=n,
                      need=need)
            if n >= need:
                return True
            if n > 0:
                mesh = _arg_value(self.argv, "--mesh")
                if mesh:
                    # the shrunken dp must divide the campaign batch
                    # (the driver rejects -b % dp at startup); the
                    # rest of the argv — including -G/--generations —
                    # is preserved verbatim, only the --mesh value is
                    # rewritten in place
                    try:
                        batch = int(_arg_value(
                            self.argv, "-b", "--batch-size",
                            default=str(DEFAULT_BATCH_SIZE)) or 0)
                    except ValueError:
                        batch = 0
                    smaller = shrink_mesh(mesh, n, batch=batch)
                    if smaller and smaller != mesh:
                        # dp=4 -> dp=2: keep fuzzing on the chips
                        # that still answer instead of crash-looping
                        # on the dead one
                        i = self.argv.index("--mesh")
                        self.argv[i + 1] = smaller
                        self._log("degrade", mesh_from=mesh,
                                  mesh_to=smaller, devices=n)
                        WARNING_MSG(
                            "supervisor: %d/%d devices alive — mesh "
                            "degraded %s -> %s", n, need, mesh, smaller)
                        return True
                # single-chip campaign and at least one device: go
                return True
            self.streak += 1
            delay = self.backoff_seconds()
            WARNING_MSG("supervisor: no devices (probe %d/%d); "
                        "retrying in %.1fs", attempt + 1,
                        self.probe_attempts, delay)
            self.sleep(delay)
        if self.fallback and not self._on_fallback:
            # no device ever came back: hand the campaign to the
            # native tier (host forkserver) rather than abandoning it
            self._on_fallback = True
            old = self.argv
            self.argv = shlex.split(self.fallback)
            if "--corpus-dir" not in self.argv:
                self.argv += ["--corpus-dir",
                              os.path.join(self.output_dir, "corpus")]
            self._log("fallback", argv_from=old, argv_to=self.argv)
            WARNING_MSG("supervisor: no devices after %d probes — "
                        "falling back to native-tier argv",
                        self.probe_attempts)
            return True
        self._log("giveup", reason="no devices")
        return False

    # -- the supervision loop --------------------------------------------

    def run(self) -> int:
        self._log("start", argv=self.argv,
                  max_restarts=self.max_restarts)
        while True:
            rc, tail, lifetime = self.launch_once()
            cls = classify_exit(rc, tail)
            self._log("exit", rc=rc, **{"class": cls},
                      lifetime_s=round(lifetime, 3))
            INFO_MSG("supervisor: child exited rc=%d (%s) after "
                     "%.1fs", rc, cls, lifetime)
            if cls == CLEAN:
                self._log("done", restarts=self.restarts)
                return 0
            if lifetime >= self.healthy_after:
                self.streak = 0         # it WAS working; fresh budget
            if 0 <= self.max_restarts <= self.restarts:
                self._log("giveup", reason="restart budget",
                          restarts=self.restarts)
                WARNING_MSG("supervisor: restart budget (%d) "
                            "exhausted; giving up with rc=%d",
                            self.max_restarts, rc)
                return rc if rc > 0 else 1
            if cls == DEVICE_LOST:
                if not self._handle_device_loss():
                    return rc if rc > 0 else 1
            self.streak += 1
            self.restarts += 1
            delay = self.backoff_seconds()
            self._log("restart", n=self.restarts, backoff_s=
                      round(delay, 3), **{"class": cls})
            INFO_MSG("supervisor: restart %d (%s) in %.1fs",
                     self.restarts, cls, delay)
            self.sleep(delay)


# -- CLI ----------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kbz-supervise",
        description="run a fuzzing campaign under fault supervision: "
                    "classify child exits (clean / crash / "
                    "device-lost / watchdog-kill) and restart into "
                    "--resume with capped exponential backoff",
        epilog="everything after -- is the fuzzer argv, exactly as "
               "you would pass it to python -m "
               "killerbeez_tpu_torch.fuzzer")
    p.add_argument("--max-restarts", type=int, default=-1,
                   help="give up after this many restarts "
                        "(-1 = never, the default)")
    p.add_argument("--backoff-base", type=float, default=1.0,
                   help="first restart delay in seconds (default 1)")
    p.add_argument("--backoff-cap", type=float, default=60.0,
                   help="restart delay ceiling in seconds "
                        "(default 60)")
    p.add_argument("--healthy-after", type=float, default=60.0,
                   help="a child that lived this long resets the "
                        "backoff streak (default 60)")
    p.add_argument("--probe-cmd",
                   help="shell command printing the usable device "
                        "count after a device loss (default: "
                        "torch.cuda.device_count() in a fresh "
                        "interpreter)")
    p.add_argument("--probe-attempts", type=int, default=5,
                   help="device probes before degrading/falling "
                        "back (default 5)")
    p.add_argument("--fallback",
                   help="fuzzer argv STRING to switch to when no "
                        "device returns (native-tier-only campaign "
                        "sharing the same corpus dir)")
    p.add_argument("--chaos",
                   help="chaos spec (JSON or @file) injected into "
                        "the first --chaos-launches launches via "
                        "KBZ_CHAOS; later restarts run clean")
    p.add_argument("--chaos-launches", type=int, default=1,
                   help="how many launches receive the --chaos spec "
                        "(default 1: only the first)")
    p.add_argument("-l", "--logging-options",
                   help="logging JSON options")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        sup_args, fuzz_args = argv[:split], argv[split + 1:]
    else:
        sup_args, fuzz_args = [], argv
    args = build_parser().parse_args(sup_args)
    if not fuzz_args:
        print("error: no fuzzer argv (kbz-supervise [flags] -- "
              "<fuzzer args...>)", file=sys.stderr)
        return 2
    setup_logging(args.logging_options)
    sup = Supervisor(fuzz_args,
                     max_restarts=args.max_restarts,
                     backoff_base=args.backoff_base,
                     backoff_cap=args.backoff_cap,
                     healthy_after=args.healthy_after,
                     probe_cmd=args.probe_cmd,
                     probe_attempts=args.probe_attempts,
                     fallback=args.fallback,
                     chaos=args.chaos,
                     chaos_launches=args.chaos_launches)
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
