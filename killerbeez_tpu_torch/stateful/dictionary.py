"""Message-scoped dictionaries — per-message token groups for the
multipart mutator.

``analysis.extract_dictionary`` gives a sequence target ONE flat
token pool — and, worse, an INCOMPLETE one: deep-handler constants
(the query trigger byte, post-handshake magics) sit in blocks that
are dead under single-shot constant propagation, so the single-shot
extraction never even sees them.  Here message k of a seed sequence
gets the dictionary of the program analyzed with the state register
initially in k's ENTERING protocol state
(``protocol.with_initial_state``): gated-off handlers contribute
nothing, deep handlers surface exactly where they apply:

    groups = extract_dictionary_groups(program, spec, seed_msgs)
    # session_auth: ["L","Q","X","p","pw","w"]   <- START message
    #               ["L","Q","X","Z"]            <- AUTHED messages

``manager_options_for_target`` packages that into ready-to-use
multipart (manager) mutator options — one ``dictionary`` child per
message with its scoped token group, framed composition on — the
turnkey structure-aware mutation config for a stateful built-in.
Copied from the JAX package; the one session execution per seed-prefix
runs on ``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

from . import StatefulSpec
from .framing import frame_messages
from .protocol import with_initial_state


def entering_states(program, spec: StatefulSpec,
                    msgs: Sequence[bytes], device="cuda") -> List[int]:
    """The abstract protocol state entering each message of a CONCRETE
    seed sequence (state 0 for message 0, then each prefix's final
    state — one tiny session execution per prefix)."""
    from .session import run_single_session
    states = [0]
    for k in range(1, len(msgs)):
        framed = frame_messages(list(msgs[:k]), spec.m_max)
        res, _ = run_single_session(program, framed, spec, device)
        states.append(int(res.state_final[0]))
    return states


def extract_dictionary_groups(program, spec: StatefulSpec,
                              msgs: Sequence[bytes],
                              max_tokens: int = 64, device="cuda"
                              ) -> List[List[bytes]]:
    """Per-message token groups for ``msgs`` (see module docstring).

    Message k's group is the dictionary of the program ANALYZED WITH
    THE STATE REGISTER INITIALLY in k's entering state
    (``with_initial_state``): handlers the state machine gates off
    are dead under that analysis and contribute nothing, while
    deep-handler tokens — invisible to the single-shot extraction
    precisely because their blocks are single-shot-dead — surface in
    the states that can reach them.  The login password lands in the
    START group, the query trigger byte in the AUTHED group."""
    from ..analysis import extract_dictionary
    states = entering_states(program, spec, msgs, device)
    cache = {}
    groups: List[List[bytes]] = []
    for s in states:
        if s not in cache:
            cache[s] = extract_dictionary(
                with_initial_state(program, spec.state_reg, s),
                max_tokens=max_tokens)
        groups.append(list(cache[s]))
    return groups


def manager_options_for_target(target_name: str,
                               msgs: Optional[Sequence[bytes]] = None,
                               spec: Optional[StatefulSpec] = None,
                               device="cuda") -> str:
    """Ready-made multipart (manager) mutator options JSON for a
    stateful built-in: one ``dictionary`` child per seed message
    with its message-scoped token group, framed composition on.
    Pair with ``stateful.framing.compose_manager_seed`` for the seed:

        opts = manager_options_for_target("session_auth")
        seed = compose_manager_seed(seed_sequence("session_auth"))
        mut = mutator_factory("manager", opts, seed)
    """
    from ..models.targets import get_target
    from ..models.targets_stateful import (
        get_stateful_spec, seed_sequence,
    )
    program = get_target(target_name)
    spec = spec or get_stateful_spec(target_name)
    if spec is None:
        raise ValueError(
            f"{target_name!r} has no registered StatefulSpec")
    msgs = list(msgs) if msgs is not None \
        else seed_sequence(target_name)
    groups = extract_dictionary_groups(program, spec, msgs,
                                       device=device)
    return json.dumps({
        "mutators": ["dictionary"] * len(msgs),
        # tokens as int lists: json-safe for arbitrary bytes (the
        # dictionary mutator's list-of-ints form)
        "mutator_options": [
            {"tokens": [list(t) for t in g]} for g in groups],
        "framed": 1,
        "m_max": spec.m_max,
    })
