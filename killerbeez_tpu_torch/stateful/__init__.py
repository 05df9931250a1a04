"""Stateful protocol fuzzing tier — session sequences on the device.

The port of the JAX package's ``stateful/``.  An input is a *framed
sequence* of messages (``framing.py``); the batched KBVM executes
message k from the machine state message k-1 left behind — registers
and scratch memory carried per lane on the device, pc re-entering at
the program top like a persistent-mode server's dispatch loop
(``session.py``) — and novelty gains a second dimension: a state x
edge virgin map keyed by (abstract protocol state entering the
message, static edge) (``coverage.py``).

The abstract protocol state is the value of a designated KBVM register
(``state_reg``, r7 by convention) clipped to ``n_states`` buckets.
Message boundaries reset pc, the coverage chain (prev block) and
status; registers, memory and the path hash carry over.

The session executor is plain PyTorch on the card too, as the JAX
package's is plain XLA: no Pallas kernel runs sessions there, so no
CUDA kernel runs them here.  Wired through jit_harness ``{"stateful":
1}``, the CLI's ``--stateful``, ``-G`` and ``--mesh``, the corpus
entries' ``state_sig`` sidecars, the lint's session checks and the
stateful built-in targets in ``models/targets_stateful.py``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StatefulSpec:
    """Session-tier configuration for one target.

    ``m_max``     maximum messages per sequence;
    ``n_states``  abstract-state buckets (state values clip into
                  [0, n_states));
    ``state_reg`` the KBVM register holding the protocol state
                  (read AFTER each message; r7 by convention).
    """
    m_max: int = 4
    n_states: int = 16
    state_reg: int = 7

    def __post_init__(self):
        if not (1 <= self.m_max <= 32):
            raise ValueError("m_max must be in [1, 32]")
        if not (2 <= self.n_states <= 256):
            raise ValueError("n_states must be in [2, 256]")
        if not (0 <= self.state_reg < 8):
            raise ValueError("state_reg must be r0..r7")


from .framing import (  # noqa: E402
    frame_messages, parse_frames, parse_frames_np, unframe,
)
from .session import SessionResult, run_session_batch  # noqa: E402

__all__ = [
    "StatefulSpec", "frame_messages", "unframe", "parse_frames",
    "parse_frames_np", "SessionResult", "run_session_batch",
]
