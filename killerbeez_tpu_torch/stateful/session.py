"""Session execution — message k runs from the machine state message
k-1 left behind.

The port of the JAX package's ``stateful/session.py``.  The
persistent-server model: between messages the lane's pc re-enters the
program top, REGISTERS and SCRATCH MEMORY persist, and the coverage
chain (prev block / prev edge-table index) resets so every message is
an independent walk of the program's STATIC edge universe.  The
session's path hash keeps folding across messages.

Verdict semantics per session:

  * a message that CRASHES ends the session with FUZZ_CRASH — later
    messages do not execute (frozen lanes);
  * a message still running after ``max_steps`` is a hang: the session
    reports FUZZ_RUNNING and callers map it to FUZZ_HANG;
  * otherwise the session completes FUZZ_NONE with the LAST message's
    exit code.

State x edge attribution: each message's edge hit counts are added
both to the session total and to the ``se_counts[lane, s, :]`` row
where ``s`` is the abstract protocol state ENTERING the message.

Two executors, held to each other bit for bit:

  * ``run_session_batch`` — the framing parsed on the device and the
    messages run one after another with the machine state carried in
    device tensors;
  * ``host_reference_session_batch`` — the framing parsed on the host,
    one device run per message, the machine state round-tripping
    through numpy: the semantic anchor.

Both run the plain torch VM step (``models/vm._step_batched``) on the
tensors' device, the card included: the JAX package runs sessions in
XLA, outside any Pallas kernel.  Values are int64 holding the int32
(path hash: uint32) values of the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import FUZZ_CRASH, FUZZ_NONE, FUZZ_RUNNING, resolve_device
from ..models.vm import N_REGS, _step_batched
from . import StatefulSpec
from .framing import parse_frames, parse_frames_np


class SessionResult(NamedTuple):
    """Per-lane outcome of a batched session execution.  ``status``
    keeps the engine contract: FUZZ_RUNNING = the session hung
    (callers map to FUZZ_HANG).  ``counts`` is the session-total
    static-edge record; ``se_counts`` the state x edge record
    (uint8[B, n_states, E+1], wrapping like every AFL count)."""
    status: torch.Tensor      # int32[B]
    exit_code: torch.Tensor   # int32[B]
    counts: torch.Tensor      # uint8[B, E+1] session-total edge counts
    steps: torch.Tensor       # int32[B] total steps across messages
    path_hash: torch.Tensor   # int64[B] holding uint32, across messages
    msgs: torch.Tensor        # int32[B] messages actually executed
    state_final: torch.Tensor  # int32[B] abstract state after the last
    se_counts: torch.Tensor   # uint8[B, S, E+1] state x edge counts


def _gather_message(bufs: torch.Tensor, offs: torch.Tensor
                    ) -> torch.Tensor:
    """msg[b, i] = bufs[b, offs[b] + i] (clipped) — the per-message
    window of the framed buffer."""
    L = bufs.shape[1]
    idx = offs.to(torch.int64)[:, None] + torch.arange(
        L, dtype=torch.int64, device=bufs.device)[None, :]
    return bufs.gather(1, idx.clamp(0, L - 1))


def _exec_message(instrs, edge_table, msg_bufs, mlens, regs, mem,
                  path_hash, live, mem_size, max_steps, n_edges):
    """One message for all lanes, from carried machine state: pc and
    the coverage chain re-enter at zero; lanes with ``live`` False do
    not run (their registers, memory and hash come back unchanged,
    their counts and steps zero, their status FUZZ_NONE).  ``regs``
    int64[B, N_REGS], ``mem`` int64[B, mem_size], ``path_hash`` int64
    holding uint32.  Each lane runs until it halts, crashes or has
    taken ``max_steps`` steps (then it is still FUZZ_RUNNING: the JAX
    loop's global step bound, since every live lane starts at step 0).

    Every 16 steps the lanes that stopped running are retired, as in
    ``models/vm._run_batch_impl``: their outputs, registers and memory
    are written back and the step continues on the running lanes only.
    The check reads one value on the host (the running lanes' count);
    a stable sort of the running flags splits the lanes without another
    wait.  Returns (status int32, exit_code int32, msg_counts uint8[B, E+1],
    regs', mem', path_hash', lane_steps int32)."""
    dev = msg_bufs.device
    b = msg_bufs.shape[0]
    i64 = dict(dtype=torch.int64, device=dev)
    status = torch.where(live, FUZZ_RUNNING, FUZZ_NONE).to(torch.int32)
    exit_code = torch.zeros(b, dtype=torch.int32, device=dev)
    counts = torch.zeros((b, n_edges + 1), dtype=torch.uint8, device=dev)
    steps = torch.zeros(b, dtype=torch.int32, device=dev)
    regs_out, mem_out, ph_out = regs.clone(), mem.clone(), path_hash.clone()
    # the step's regs and mem carry a sink column for writes that do
    # not happen
    state = (torch.zeros(b, **i64),
             torch.cat([regs, torch.zeros((b, 1), **i64)], 1),
             torch.cat([mem, torch.zeros((b, 1), **i64)], 1),
             status.to(torch.int64), torch.zeros(b, **i64),
             torch.zeros(b, **i64), torch.zeros((b, n_edges + 1), **i64),
             path_hash.clone(), torch.zeros(b, **i64),
             torch.zeros(b, **i64))
    inputs = msg_bufs.to(torch.int64)
    lengths = mlens.to(device=dev, dtype=torch.int64)
    lanes = torch.arange(b, device=dev)

    def retire(sel):
        idx = lanes[sel]
        status[idx] = state[3][sel].to(torch.int32)
        exit_code[idx] = state[4][sel].to(torch.int32)
        counts[idx] = (state[6][sel] & 0xFF).to(torch.uint8)
        steps[idx] = state[8][sel].to(torch.int32)
        ph_out[idx] = state[7][sel]
        regs_out[idx] = state[1][sel][:, :N_REGS]
        mem_out[idx] = state[2][sel][:, :mem_size]

    for i in range(max_steps):
        if i % 16 == 0:
            running = state[3] == FUZZ_RUNNING
            n_run = int(running.sum())
            n_gone = lanes.shape[0] - n_run
            if n_gone:
                order = torch.sort(running.to(torch.uint8),
                                   stable=True).indices
                retire(order[:n_gone])
                if not n_run:
                    lanes = lanes[:0]
                    break
                keep = order[n_gone:]
                state = tuple(t[keep] for t in state)
                inputs, lengths, lanes = (inputs[keep], lengths[keep],
                                          lanes[keep])
        state, _ = _step_batched(instrs, edge_table, inputs, lengths,
                                 mem_size, state)
    if lanes.numel():
        retire(torch.arange(lanes.shape[0], device=dev))
    return status, exit_code, counts, regs_out, mem_out, ph_out, steps


def _tables(program, dev):
    return (torch.as_tensor(program.instrs, device=dev).to(torch.int64),
            torch.as_tensor(program.edge_table, device=dev)
            .to(torch.int64))


def _fold_message(carry, live, st, ec, mc, regs2, mem2, ph2,
                  lane_steps, n_states, state_reg):
    """Fold one message's outcome into the session carry (the JAX
    scan body's update, shared by both executors)."""
    (regs, mem, ph, crashed, hung, exit_code, counts, se, steps,
     state_abs, msgs_done) = carry
    crashed = crashed | (live & (st == FUZZ_CRASH))
    hung = hung | (live & (st == FUZZ_RUNNING))
    completed = live & (st == FUZZ_NONE)
    exit_code = torch.where(completed, ec, exit_code)
    counts = counts + mc                          # uint8: wraps
    # state x edge: this message's counts go to the state ENTERING it
    onehot = (torch.arange(n_states, device=mc.device)[None, :]
              == state_abs[:, None]).to(torch.uint8)
    se = se + onehot[:, :, None] * mc[:, None, :]
    steps = steps + lane_steps
    regs = torch.where(live[:, None], regs2, regs)
    mem = torch.where(live[:, None], mem2, mem)
    ph = torch.where(live, ph2, ph)
    state_abs = torch.where(live, regs[:, state_reg].clamp(0, n_states - 1),
                            state_abs)
    msgs_done = msgs_done + live.to(torch.int32)
    return (regs, mem, ph, crashed, hung, exit_code, counts, se, steps,
            state_abs, msgs_done)


def _carry0(b, mem_size, n_edges, n_states, dev):
    i64 = dict(dtype=torch.int64, device=dev)
    return (torch.zeros((b, N_REGS), **i64),
            torch.zeros((b, mem_size), **i64),
            torch.zeros(b, **i64),
            torch.zeros(b, dtype=torch.bool, device=dev),
            torch.zeros(b, dtype=torch.bool, device=dev),
            torch.zeros(b, dtype=torch.int32, device=dev),
            torch.zeros((b, n_edges + 1), dtype=torch.uint8, device=dev),
            torch.zeros((b, n_states, n_edges + 1), dtype=torch.uint8,
                        device=dev),
            torch.zeros(b, dtype=torch.int32, device=dev),
            torch.zeros(b, **i64),
            torch.zeros(b, dtype=torch.int32, device=dev))


def _result(carry) -> SessionResult:
    (_regs, _mem, ph, crashed, hung, exit_code, counts, se, steps,
     state_abs, msgs_done) = carry
    status = torch.where(crashed, FUZZ_CRASH,
                         torch.where(hung, FUZZ_RUNNING, FUZZ_NONE)
                         ).to(torch.int32)
    return SessionResult(status=status, exit_code=exit_code,
                         counts=counts, steps=steps, path_hash=ph,
                         msgs=msgs_done,
                         state_final=state_abs.to(torch.int32),
                         se_counts=se)


def _run_session_impl(instrs, edge_table, bufs, lengths, mem_size,
                      max_steps, n_edges, m_max, n_states, state_reg
                      ) -> SessionResult:
    """The session executor: parse the framing on the device, then run
    the m_max message slots in turn with the machine state in the
    carry.  Inactive slots (k >= count, or the session already
    crashed or hung) run no lane: zero counts, zero steps."""
    dev = bufs.device
    instrs = instrs.to(device=dev, dtype=torch.int64)
    edge_table = edge_table.to(device=dev, dtype=torch.int64)
    bufs = bufs.to(torch.uint8)
    m, offs, mlens = parse_frames(bufs, lengths, m_max)
    carry = _carry0(bufs.shape[0], mem_size, n_edges, n_states, dev)
    for k in range(m_max):
        crashed, hung = carry[3], carry[4]
        live = (k < m) & ~crashed & ~hung
        msg = _gather_message(bufs, offs[:, k])
        out = _exec_message(instrs, edge_table, msg, mlens[:, k],
                            carry[0], carry[1], carry[2], live, mem_size,
                            max_steps, n_edges)
        carry = _fold_message(carry, live, *out, n_states, state_reg)
    return _result(carry)


def run_session_batch(program, inputs: torch.Tensor,
                      lengths: torch.Tensor,
                      spec: StatefulSpec) -> SessionResult:
    """Execute a uint8[B, L] framed-sequence batch through ``program``
    as sessions, on the inputs' device.  Pure (no virgin maps touched)
    — triage layers on top exactly like ``vm.run_batch``."""
    dev = inputs.device
    return _run_session_impl(
        *_tables(program, dev), inputs,
        lengths.to(device=dev), program.mem_size, program.max_steps,
        program.n_edges, spec.m_max, spec.n_states, spec.state_reg)


# --------------------------------------------------------------------
# Host-driven per-message reference loop (the parity anchor)
# --------------------------------------------------------------------

def host_reference_session_batch(program, inputs, lengths,
                                 spec: StatefulSpec,
                                 device="cuda") -> SessionResult:
    """The reference semantics ``run_session_batch`` is held to:
    framing parsed on the HOST (``parse_frames_np``), one device run
    per message on ``device``, machine state round-tripping through
    numpy between messages.  Returns a SessionResult of tensors on
    ``device``."""
    dev = resolve_device(device)
    inputs = np.asarray(inputs, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int64)
    b, L = inputs.shape
    m, offs, mlens = parse_frames_np(inputs, lengths, spec.m_max)
    carry = tuple(t.cpu() for t in _carry0(
        b, program.mem_size, program.n_edges, spec.n_states, "cpu"))
    tables = _tables(program, dev)
    idx_cols = np.arange(L, dtype=np.int64)
    for k in range(spec.m_max):
        live = torch.as_tensor((k < m) & ~carry[3].numpy()
                               & ~carry[4].numpy())
        if not bool(live.any()):
            break
        idx = np.clip(offs[:, k, None].astype(np.int64)
                      + idx_cols[None, :], 0, L - 1)
        msg = np.take_along_axis(inputs, idx, axis=1)
        out = _exec_message(
            *tables, torch.as_tensor(msg, device=dev),
            torch.as_tensor(mlens[:, k], device=dev), carry[0].to(dev),
            carry[1].to(dev), carry[2].to(dev), live.to(dev),
            program.mem_size, program.max_steps, program.n_edges)
        out = tuple(torch.as_tensor(t.cpu().numpy()) for t in out)
        carry = _fold_message(carry, live, *out, spec.n_states,
                              spec.state_reg)
    return SessionResult(*(t.to(dev) for t in _result(carry)))


# --------------------------------------------------------------------
# Signatures (corpus sidecars / showmap / picker)
# --------------------------------------------------------------------

def state_edge_pairs(se_row: np.ndarray,
                     edge_slot: np.ndarray) -> list:
    """One lane's state x edge signature as sorted ``[state, slot]``
    pairs (AFL map slots; the overflow column is dropped).  The
    sidecar / picker wire format."""
    se_row = np.asarray(se_row)
    slots = np.asarray(edge_slot)
    pairs = set()
    ss, ee = np.nonzero(se_row[:, :-1])
    for s, e in zip(ss, ee):
        pairs.add((int(s), int(slots[e])))
    return [[s, e] for s, e in sorted(pairs)]


def run_single_session(program, buf: bytes, spec: StatefulSpec,
                       device="cuda") -> Tuple[SessionResult, list]:
    """One framed input as a 1-lane session on ``device`` (tools / the
    admission signer).  Returns (its SessionResult row as numpy
    arrays, its state x edge signature pairs)."""
    dev = resolve_device(device)
    L = max(((len(buf) + 7) // 8) * 8, 8)
    arr = np.zeros((1, L), dtype=np.uint8)
    if buf:
        arr[0, :len(buf)] = np.frombuffer(buf, dtype=np.uint8)
    res = run_session_batch(program, torch.as_tensor(arr, device=dev),
                            torch.tensor([len(buf)], dtype=torch.int32,
                                         device=dev), spec)
    res = SessionResult(*(a.cpu().numpy() for a in res))
    return res, state_edge_pairs(res.se_counts[0], program.edge_slot)
