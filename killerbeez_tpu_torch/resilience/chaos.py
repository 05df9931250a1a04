"""Deterministic fault injection — the chaos harness.

Killerbeez's manager tier was designed against workers that die
constantly; the only way to keep that property true here is to make
the deaths cheap to produce.  This module plants named **chaos
points** at every seam where the real world fails — device dispatch,
the blocking device wait, every persistence write, manager RPC — and
fires configured faults at them deterministically, so a test (or an
operator) can replay the exact same failure at the exact same
instruction across runs.

A chaos point is a module-level call that compiles to one attribute
read when chaos is off::

    from ..resilience.chaos import chaos_point
    chaos_point("device_dispatch")          # no-op unless configured

Configuration is a JSON spec (``--chaos`` on the fuzzer CLI, the
``KBZ_CHAOS`` environment variable for child processes, or
``configure()`` from tests)::

    {"seed": 7,
     "faults": [
       {"point": "device_dispatch", "mode": "raise",  "hit": 12},
       {"point": "device_wait",     "mode": "hang",   "hit": 5,
        "seconds": 30},
       {"point": "persist",         "mode": "kill",   "prob": 0.05},
       {"point": "persist",         "mode": "torn",   "hit": 3},
       {"point": "manager_rpc",     "mode": "http500", "every": 3}]}

Triggers (exactly one per fault; ``hit`` defaults to 1):

  * ``hit: N``   — fire on the Nth hit of that point (1-based), once.
  * ``every: N`` — fire on every Nth hit.
  * ``prob: p``  — fire per hit with probability ``p`` from the
                   spec-seeded RNG (deterministic given the seed and
                   the hit sequence).

Modes (what firing does):

  * ``raise``   — raise :class:`XlaRuntimeError` with a DEVICE_LOST
                  message (the supervisor classifies it device-lost).
  * ``hang``    — sleep ``seconds`` (default 3600): a stuck dispatch
                  for the watchdog to kill.
  * ``enospc``  — raise ``OSError(ENOSPC)``: disk full.
  * ``torn``    — write HALF the payload straight to the final path
                  (bypassing the temp+rename discipline), then raise:
                  the torn in-place write every loader must survive.
  * ``kill``    — ``SIGKILL`` this process: the mid-write power cut.
  * ``http500`` — raise ``urllib.error.HTTPError(500)``: the manager
                  saw the request and failed.
  * ``timeout`` — raise ``urllib.error.URLError``: network partition.
  * ``partition`` — like ``timeout``, but SCOPED: the fault carries a
                  ``match`` substring and only severs requests whose
                  URL (the ``url=`` context at the chaos point)
                  contains it, so a spec can cut one worker off from
                  the manager while its peer gossip keeps flowing, or
                  sever exactly one peer edge out of a mesh.  A
                  fleet-sim harness typically installs it with
                  ``every: 1`` (total blackout of the matched
                  endpoint) and clears it by reconfiguring.

``match`` may also scope any other mode: a fault with ``match`` set
only counts and fires on hits whose ``url`` context contains the
substring (hit counting stays deterministic given the URL sequence).

Registered chaos points (grep for ``chaos_point(`` to verify):

  ``device_dispatch`` (loop, before each device batch dispatch),
  ``device_wait`` (loop, before each blocking host transfer),
  ``persist`` (corpus store ``_atomic_write``: entries, sidecars,
  checkpoint, campaign/solver state), ``fs_write`` (finding files),
  ``event_append`` (events.jsonl), ``manager_rpc`` (every worker /
  sync / heartbeat / peer-gossip HTTP request), ``gossip_serve``
  (gossip sidecar, before serving each inbound peer request),
  ``manager_db_write`` (manager, before every DB mutation — the
  degraded-mode seam).
"""

from __future__ import annotations

import errno
import json
import os
import random
import signal
import threading
import time
from typing import Any, Dict, List, Optional

from ..utils.logging import WARNING_MSG


class XlaRuntimeError(RuntimeError):
    """Chaos stand-in for a device-loss runtime error.  It keeps the
    JAX package's name on purpose: exit classification
    (``resilience.is_device_loss``) and a supervisor of either package
    match it by the same string."""


MODES = ("raise", "hang", "enospc", "torn", "kill", "http500",
         "timeout", "partition")


class _Fault:
    __slots__ = ("point", "mode", "hit", "every", "prob", "seconds",
                 "match", "seen", "fired")

    def __init__(self, spec: Dict[str, Any]):
        self.point = str(spec["point"])
        self.mode = str(spec.get("mode", "raise"))
        if self.mode not in MODES:
            raise ValueError(f"chaos: unknown mode {self.mode!r} "
                             f"(one of {', '.join(MODES)})")
        self.hit = spec.get("hit")
        self.every = spec.get("every")
        self.prob = spec.get("prob")
        if self.hit is None and self.every is None and self.prob is None:
            self.hit = 1
        self.seconds = float(spec.get("seconds", 3600.0))
        #: endpoint scoping: only hits whose ``url`` context contains
        #: this substring count toward (and fire) this fault — how a
        #: ``partition`` severs one named peer/manager endpoint while
        #: the rest of the fleet's traffic flows
        self.match = spec.get("match")
        if self.match is not None:
            self.match = str(self.match)
        self.seen = 0        # per-fault hit count (match-scoped only)
        self.fired = 0

    def matches(self, ctx: Dict[str, Any]) -> bool:
        if self.match is None:
            return True
        return self.match in str(ctx.get("url", ""))

    def should_fire(self, n: int, rng: random.Random) -> bool:
        if self.hit is not None:
            return n == int(self.hit)
        if self.every is not None:
            return int(self.every) > 0 and n % int(self.every) == 0
        return rng.random() < float(self.prob)


class ChaosEngine:
    """One configured fault table: counts hits per point, fires the
    matching faults.  Thread-safe (heartbeat/watchdog threads hit
    chaos points too); the counters themselves are the determinism
    anchor, so specs should target points hit from ONE thread when
    exact replay matters."""

    def __init__(self, spec: Dict[str, Any]):
        self.rng = random.Random(int(spec.get("seed", 0)))
        self.faults: List[_Fault] = [
            _Fault(f) for f in spec.get("faults", [])]
        self.hits: Dict[str, int] = {}
        self._lock = threading.Lock()

    def hit(self, point: str, **ctx) -> None:
        with self._lock:
            n = self.hits[point] = self.hits.get(point, 0) + 1
            due = []
            for f in self.faults:
                if f.point != point or not f.matches(ctx):
                    continue
                # match-scoped faults count their own hits (the point
                # counter mixes every endpoint's traffic; a scoped
                # fault's trigger must be deterministic given only the
                # MATCHED request sequence)
                if f.match is not None:
                    f.seen += 1
                if f.should_fire(f.seen if f.match is not None else n,
                                 self.rng):
                    f.fired += 1
                    due.append(f)
        for f in due:
            self._fire(f, point, n, ctx)

    # -- the faults themselves ------------------------------------------

    def _fire(self, f: _Fault, point: str, n: int,
              ctx: Dict[str, Any]) -> None:
        WARNING_MSG("chaos: firing %s at %s (hit %d)", f.mode, point, n)
        if f.mode == "raise":
            raise XlaRuntimeError(
                f"DEVICE_LOST: chaos-injected device failure at "
                f"{point} hit {n}")
        if f.mode == "hang":
            time.sleep(f.seconds)
            return
        if f.mode == "enospc":
            raise OSError(errno.ENOSPC,
                          f"chaos: No space left on device ({point})")
        if f.mode == "torn":
            path, data = ctx.get("path"), ctx.get("data")
            if path is not None and data:
                try:
                    with open(path, "wb") as fh:   # IN PLACE: the tear
                        fh.write(bytes(data)[:max(1, len(data) // 2)])
                except OSError:
                    pass
            raise OSError(errno.EIO, f"chaos: torn write ({point})")
        if f.mode == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
            return                                  # unreachable
        if f.mode == "http500":
            import urllib.error
            raise urllib.error.HTTPError(
                str(ctx.get("url", point)), 500,
                "chaos: injected server error", None, None)
        if f.mode == "timeout":
            import urllib.error
            raise urllib.error.URLError(
                f"chaos: injected network partition ({point})")
        if f.mode == "partition":
            import urllib.error
            raise urllib.error.URLError(
                f"chaos: partitioned from "
                f"{ctx.get('url', point)} ({point})")

    def state(self) -> Dict[str, Any]:
        return {"hits": dict(self.hits),
                "fired": {f"{f.point}/{f.mode}": f.fired
                          for f in self.faults}}


_engine: Optional[ChaosEngine] = None


def configure(spec) -> Optional[ChaosEngine]:
    """Install (or clear) the process-wide chaos engine.  ``spec`` is
    a dict, a JSON string, ``@path`` to a JSON file, or None/''/falsy
    to disable.  Returns the engine (None when disabled)."""
    global _engine
    if not spec:
        _engine = None
        return None
    if isinstance(spec, str):
        if spec.startswith("@"):
            with open(spec[1:]) as f:
                spec = f.read()
        spec = json.loads(spec)
    if not isinstance(spec, dict):
        raise ValueError("chaos: spec must be a JSON object")
    _engine = ChaosEngine(spec)
    return _engine


def configure_from_env() -> Optional[ChaosEngine]:
    """Pick up ``KBZ_CHAOS`` (how a supervisor injects faults into one
    child launch, or a fleet worker into its manager RPCs, without
    touching its argv)."""
    return configure(os.environ.get("KBZ_CHAOS"))


def active() -> Optional[ChaosEngine]:
    return _engine


def chaos_point(name: str, **ctx) -> None:
    """Fire any faults due at this seam.  One attribute read when
    chaos is off — safe on hot paths."""
    if _engine is not None:
        _engine.hit(name, **ctx)
