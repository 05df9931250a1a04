"""Stateful built-in targets — protocol state machines for the
session tier (``stateful/``), copied from the JAX package.

Conventions these targets follow:

  * r7 is the protocol state register (StatefulSpec.state_reg): it
    persists across messages, handlers never use it as scratch;
  * scratch registers are re-initialized (LDI) before use in every
    handler — register values carry over from the previous message;
  * cross-message data lives in scratch memory (query counters,
    expected handshake tokens), which also persists.

Both families are built so their DEEP states are provably
unreachable by single-shot inputs: every deep handler is guarded by
an ``r7 == <state>`` check, and in a single-shot execution r7 is the
constant 0 at every dispatch — ``analysis.dataflow`` constant
propagation folds the guards and reports the deep blocks dead
(``deep_state_blocks`` below returns exactly that set; the
``--stateful`` gate of ``chip_smoke.py`` and kb-lint's
state-reachability check both consume it).  Only a SEQUENCE that
first drives the state machine can light them.

  * ``session_auth`` — login -> query -> quit.  States: 0 START,
    1 AUTHED, 2 DONE.  The planted crash needs login ('L' + the
    "pw" password), at least two authed queries, and a 'Z' query
    payload — three-message minimum.
  * ``tcp_like``     — SYN -> ACK -> DATA/FIN -> FIN handshake and
    teardown.  States: 0 CLOSED, 1 SYN_SEEN, 2 ESTABLISHED,
    3 FIN_WAIT, 4 DONE.  The ACK must echo the SYN's token + 1
    (stored in scratch memory by the SYN handler), and the DATA
    handler stores through an unchecked payload index — the memory
    bug is only reachable in ESTABLISHED.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..stateful import StatefulSpec
from ..stateful.framing import frame_messages
from .compiler import Assembler
from .vm import Program
from .targets import register_target

#: session-tier configuration per stateful target (consumed by the
#: CLI --stateful auto-spec, kb-lint, chip_smoke.py and tests)
STATEFUL_SPECS: Dict[str, StatefulSpec] = {
    "session_auth": StatefulSpec(m_max=4, n_states=8, state_reg=7),
    "tcp_like": StatefulSpec(m_max=4, n_states=8, state_reg=7),
}

#: canonical benign session seeds (valid protocol runs that end
#: cleanly — the corpus anchor campaigns fuzz from)
_SEED_SEQUENCES: Dict[str, List[bytes]] = {
    "session_auth": [b"Lpw", b"QA", b"X"],
    "tcp_like": [b"S\x10", b"A\x11", b"D\x05A", b"F"],
}


def stateful_target_names() -> List[str]:
    return sorted(STATEFUL_SPECS)


def get_stateful_spec(name: str) -> Optional[StatefulSpec]:
    return STATEFUL_SPECS.get(name)


def seed_sequence(name: str) -> List[bytes]:
    if name not in _SEED_SEQUENCES:
        raise ValueError(f"no seed sequence for {name!r}")
    return list(_SEED_SEQUENCES[name])


def framed_seed(name: str) -> bytes:
    """The canonical seed, framed for the target's spec."""
    return frame_messages(seed_sequence(name),
                          STATEFUL_SPECS[name].m_max)


def deep_state_blocks(program: Program) -> List[int]:
    """Blocks provably unreachable by ANY single-shot input: dead
    under single-shot constant propagation (r7 and memory start 0 and
    nothing sets them before the state guards), but CFG-reachable —
    i.e., exactly the sequence-only coverage.  This is the static
    proof the --stateful gate cites: an edge into one of these
    blocks cracked by sequence fuzzing is an edge single-shot fuzzing
    cannot reach."""
    from ..analysis import analyze_dataflow, build_cfg
    cfg = build_cfg(program)
    df = analyze_dataflow(program)
    return sorted(b for b in df.dead_blocks if b in cfg.reachable)


def deep_state_edges(program: Program) -> List[int]:
    """Edge indices whose DESTINATION is a deep-state block."""
    import numpy as np
    deep = set(deep_state_blocks(program))
    et = np.asarray(program.edge_to)
    return [int(e) for e in range(len(et)) if int(et[e]) in deep]


@register_target("session_auth")
def session_auth_target() -> Program:
    """login -> query -> quit session daemon (see module docstring).

    Message grammar: byte 0 = command.
      'L' <pw bytes "pw">   login (START only)
      'Q' <payload>         query (AUTHED only; 'Z' payload after two
                            authed queries hits the planted crash)
      'X'                   quit (AUTHED -> DONE teardown block)
    """
    a = Assembler("session_auth", mem_size=16, max_steps=128)
    a.block()                           # entry / dispatch
    a.ldi(1, 0)
    a.ldb(1, 1)                         # r1 = command byte
    a.ldi(2, ord("L"))
    a.br("eq", 1, 2, "login")
    a.ldi(2, ord("Q"))
    a.br("eq", 1, 2, "query")
    a.ldi(2, ord("X"))
    a.br("eq", 1, 2, "quit")
    a.jmp("bad")

    a.label("login")
    a.block()                           # login attempt
    a.ldi(2, 0)
    a.br("ne", 7, 2, "relogin")         # already past START?
    a.block()                           # fresh login
    a.expect_byte(2, 3, 1, ord("p"), "badpw")
    a.expect_byte(2, 3, 2, ord("w"), "badpw")
    a.ldi(7, 1)                         # -> AUTHED
    a.halt(0)
    a.label("badpw")
    a.block()
    a.halt(1)
    a.label("relogin")
    a.block()
    a.halt(4)

    a.label("query")
    a.block()                           # query dispatch
    a.ldi(2, 1)
    a.br("ne", 7, 2, "denied")
    a.block()                           # DEEP: authed query
    a.ldi(2, 1)
    a.ldm(3, 2)                         # r3 = mem[1] query count
    a.addi(3, 3, 1)
    a.stm(2, 3)                         # mem[1] = count + 1
    a.ldi(4, 1)
    a.ldb(4, 4)                         # r4 = payload byte
    a.ldi(5, ord("Z"))
    a.br("ne", 4, 5, "q_done")
    a.block()                           # DEEP: 'Z' query
    a.ldi(2, 2)
    a.br("lt", 3, 2, "q_done")          # fewer than two queries yet
    a.block()                           # DEEP: the planted crash
    a.ldi(5, -1)
    a.ldi(6, 1)
    a.stm(5, 6)                         # wild-pointer write
    a.label("q_done")
    a.block()                           # DEEP: clean query exit
    a.halt(0)
    a.label("denied")
    a.block()
    a.halt(2)

    a.label("quit")
    a.block()                           # quit dispatch
    a.ldi(2, 1)
    a.br("ne", 7, 2, "quit_noauth")
    a.block()                           # DEEP: authed teardown
    a.ldi(7, 2)                         # -> DONE
    a.halt(0)
    a.label("quit_noauth")
    a.block()
    a.halt(3)

    a.label("bad")
    a.block()
    a.halt(1)
    return a.build(block_seed=0x5E55)


@register_target("tcp_like")
def tcp_like_target() -> Program:
    """SYN/ACK handshake + data + two-step teardown (see module
    docstring).

    Message grammar: byte 0 = command.
      'S' <token>        SYN (CLOSED only): remembers token+1 as the
                         expected ack cookie, -> SYN_SEEN
      'A' <cookie>       ACK (SYN_SEEN only): cookie must equal
                         token+1, -> ESTABLISHED
      'D' <idx> <value>  DATA (ESTABLISHED only): mem[idx] = value,
                         idx UNCHECKED — the planted bug
      'F'                FIN: ESTABLISHED -> FIN_WAIT,
                         FIN_WAIT -> DONE (teardown complete)
    """
    a = Assembler("tcp_like", mem_size=32, max_steps=128)
    a.block()                           # entry / dispatch
    a.ldi(1, 0)
    a.ldb(1, 1)                         # r1 = command byte
    a.ldi(2, ord("S"))
    a.br("eq", 1, 2, "syn")
    a.ldi(2, ord("A"))
    a.br("eq", 1, 2, "ack")
    a.ldi(2, ord("D"))
    a.br("eq", 1, 2, "data")
    a.ldi(2, ord("F"))
    a.br("eq", 1, 2, "fin")
    a.jmp("rst")

    a.label("syn")
    a.block()
    a.ldi(2, 0)
    a.br("ne", 7, 2, "rst")             # SYN only from CLOSED
    a.block()                           # remember the ack cookie
    a.ldi(3, 1)
    a.ldb(3, 3)                         # r3 = token
    a.addi(3, 3, 1)                     # cookie = token + 1
    a.ldi(4, 0)
    a.stm(4, 3)                         # mem[0] = cookie
    a.ldi(7, 1)                         # -> SYN_SEEN
    a.halt(0)

    a.label("ack")
    a.block()
    a.ldi(2, 1)
    a.br("ne", 7, 2, "rst")             # ACK only from SYN_SEEN
    a.block()                           # DEEP: cookie check
    a.ldi(3, 1)
    a.ldb(3, 3)                         # r3 = echoed cookie
    a.ldi(4, 0)
    a.ldm(5, 4)                         # r5 = expected cookie
    a.br("ne", 3, 5, "bad_ack")
    a.block()                           # DEEP: ESTABLISHED
    a.ldi(7, 2)
    a.halt(0)
    a.label("bad_ack")
    a.block()                           # DEEP: wrong cookie -> reset
    a.ldi(7, 0)
    a.halt(2)

    a.label("data")
    a.block()
    a.ldi(2, 2)
    a.br("ne", 7, 2, "rst")             # DATA only in ESTABLISHED
    a.block()                           # DEEP: the unchecked store
    a.ldi(3, 1)
    a.ldb(3, 3)                         # r3 = idx (payload byte 1)
    a.ldi(4, 2)
    a.ldb(4, 4)                         # r4 = value (payload byte 2)
    a.stm(3, 4)                         # BUG: idx 0..255, mem is 32
    a.block()                           # DEEP: data stored
    a.halt(0)

    a.label("fin")
    a.block()
    a.ldi(2, 2)
    a.br("eq", 7, 2, "fin_estab")
    a.ldi(2, 3)
    a.br("eq", 7, 2, "fin_wait")
    a.jmp("rst")
    a.label("fin_estab")
    a.block()                           # DEEP: -> FIN_WAIT
    a.ldi(7, 3)
    a.halt(0)
    a.label("fin_wait")
    a.block()                           # DEEP: teardown complete
    a.ldi(7, 4)
    a.halt(0)

    a.label("rst")
    a.block()
    a.halt(1)
    return a.build(block_seed=0x7C91)
