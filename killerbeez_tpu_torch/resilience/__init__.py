"""Campaign resilience: the manager/BOINC tier's fault model
(PAPER.md §L3+: workers die constantly, campaigns survive anyway)
brought to the CUDA tier.

  * ``chaos.py``      — deterministic fault injection at every seam
                        (device dispatch, the blocking device wait,
                        persistence, finding and event writes).
  * ``watchdog.py``   — dispatch watchdog: a deadline on every
                        blocking device wait, scaled from the EMA
                        batch time; a stuck wait dumps state and exits
                        ``WATCHDOG_EXIT_CODE``.
  * ``checkpoint.py`` — crash-consistent campaign checkpoints: ONE
                        atomic ``checkpoint.json`` epoch covering
                        scheduler/campaign state, event seq and
                        component states, so a kill at any instruction
                        resumes consistent.
  * ``supervisor.py`` — ``kbz-supervise``: runs the fuzz loop as a
                        child, classifies exits (clean / crash /
                        device-lost / watchdog-kill) and restarts
                        into ``--resume`` with capped exponential
                        backoff, re-probing the CUDA cards on device
                        loss and shrinking the mesh when cards stay
                        dead.
  * ``fleetsim.py``   — the fleet-tier chaos rig: in-process gossiping
                        workers (real stores, sidecars and exchange
                        clients) driven round by round under manager
                        kills, scoped partitions and poisoned peers.

The exit codes and the checkpoint format are the same in both packages.

Exit-code contract between the loop and a supervisor (clear of the
CLI's 0/1/2 usage codes and shells' 126+ conventions):

  * ``WATCHDOG_EXIT_CODE`` (86) — the dispatch watchdog killed a
    stuck device wait after dumping in-flight state.
  * ``DEVICE_LOST_EXIT_CODE`` (87) — the loop died on a device-loss
    error; devices need re-probing before a restart is worth
    attempting.
"""

from __future__ import annotations

#: the dispatch watchdog killed the process over a stuck device wait
WATCHDOG_EXIT_CODE = 86

#: the loop exited on a classified device-loss error
DEVICE_LOST_EXIT_CODE = 87

#: substrings (lowercased) that mark an exception or a stderr line as
#: a device loss rather than a plain crash: the JAX package's markers
#: (its logs and the chaos harness's injected stand-in use them), and
#: the CUDA runtime's messages for a card that went away.  A kernel's
#: own fault (an illegal memory access, an unspecified launch
#: failure, a device-side assert) is a bug, not a loss: it stays a
#: crash, so a supervisor does not restart into it forever.
_DEVICE_LOSS_MARKERS = (
    "xlaruntimeerror", "device_lost", "device lost", "data_loss",
    "preempt", "tpu_terminated", "slice became unhealthy",
    "failed to connect to all addresses", "deadline_exceeded",
    "device or resource busy",
    # CUDA: the card is gone, busy elsewhere, or failed in hardware
    "all cuda-capable devices are busy or unavailable",
    "no cuda-capable device is detected",
    "uncorrectable ecc error", "gpu has fallen off the bus",
    "system not yet initialized", "cuda error: hardware stop",
)


def is_device_loss(exc_or_text) -> bool:
    """True when an exception (or a stderr line) looks like the
    accelerator went away — the class of failure where restarting
    without re-probing devices would just die again."""
    if isinstance(exc_or_text, BaseException):
        text = f"{type(exc_or_text).__name__}: {exc_or_text}"
    else:
        text = str(exc_or_text)
    low = text.lower()
    return any(m in low for m in _DEVICE_LOSS_MARKERS)


from .chaos import chaos_point  # noqa: E402  (hot-path no-op hook)

__all__ = [
    "DEVICE_LOST_EXIT_CODE", "WATCHDOG_EXIT_CODE", "chaos_point",
    "is_device_loss",
]
