"""Defect checks over a KBVM Program — the ``kb-lint`` core.

Each check turns a silent correctness hazard into a reported finding:

  error severity (kb-lint exits nonzero; the CI lint lane fails):
    empty-module          a (name, lo, hi) module with lo == hi: its
                          64KB map can never light up and per-module
                          novelty silently no-ops
    unreachable-block     a coverage block no path from entry reaches:
                          its edges pad the static universe and its
                          map slots read as permanently-cold targets
    field-bound           an instruction field at/beyond 2^24: the
                          batched engine's f32 matmul fetch goes
                          inexact (Program construction also rejects)
    max-steps-shortfall   the longest LOOP-FREE complete path needs
                          more steps than ``max_steps``: legitimate
                          hang-free executions get triaged as hangs

  warning severity (reported; exit stays 0):
    slot-collision        two distinct static edges land on one AFL
                          map slot: novelty conflates them (AFL lives
                          with this; here it is measurable)
    duplicate-block-id    ``assign_block_ids`` drew the same coverage
                          id for two blocks (birthday collision over
                          MAP_SIZE): whole blocks alias in the map
    dead-block            CFG-reachable but unreachable once constant
                          propagation folds branches — dead weight in
                          the edge universe and the rarity prior

  info severity:
    must-crash-block      every path from the block head crashes —
                          usually the PLANTED bug (expected in fuzz
                          targets; a whole-module must-crash is worth
                          a look)
    no-blocks             the program has no coverage blocks at all

  VSA checks (``lint_program(..., vsa=VsaResult)``; kb-lint enables
  them with ``--vsa``):
    infeasible-edge       (warning; error when constant propagation
                          independently folds the branch the same
                          way) a branch side whose VSA domains make
                          the outcome empty — the edge pads the
                          static universe and the solver's frontier.
                          For stateful targets, a side only message
                          sequences can take downgrades to info
                          (``session-infeasible-edge``), mirroring
                          the dead-block downgrade
    value-range-contradiction
                          (warning) a pc constant propagation says
                          is reached but the value-set fixpoint
                          proves no value combination enters —
                          refinement emptied every path in; info
                          under the same session-live downgrade
    guaranteed-oob-store  (warning) a LDM/STM whose VSA index
                          interval lies entirely outside
                          [0, mem_size) on a non-constant index —
                          the access always faults, but constant
                          propagation cannot see it (constant
                          indices already surface via crash-pc
                          analysis)

  stateful targets (``lint_program(..., stateful=StatefulSpec)``;
  kb-lint resolves the spec from the target registry automatically):
    state-unreachable     (warning) a protocol state the program
                          guards on or assigns that NO session can
                          reach from the initial state in the static
                          CFG (stateful/protocol.py fixpoint) — dead
                          protocol surface, almost certainly a state-
                          machine bug in the target
    state-clip            (warning) a state assignment at/beyond
                          n_states: the session tier clips it into
                          the top bucket, aliasing distinct states
                          in the state x edge map
    session-only-block    (info) a block dead under SINGLE-SHOT
                          constant propagation that a session CAN
                          light — the dead-block warning is
                          downgraded to this for stateful targets
                          (these blocks are the tier's target
                          surface, not dead weight)
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .cfg import ControlFlowGraph, build_cfg
from .dataflow import DataflowResult, analyze_dataflow

SEV_ERROR = "error"
SEV_WARNING = "warning"
SEV_INFO = "info"


@dataclass
class Finding:
    severity: str
    code: str
    message: str
    data: Dict = field(default_factory=dict)

    def as_dict(self) -> Dict:
        return {"severity": self.severity, "code": self.code,
                "message": self.message, **({"data": self.data}
                                            if self.data else {})}


def lint_program(program,
                 cfg: Optional[ControlFlowGraph] = None,
                 dataflow: Optional[DataflowResult] = None,
                 stateful=None, vsa=None) -> List[Finding]:
    """All checks over one Program, errors first.  ``stateful`` (a
    StatefulSpec) enables the session-tier checks and downgrades
    single-shot dead-block warnings for session-reachable blocks.
    ``vsa`` (a VsaResult) enables the value-set checks; ``None``
    (the default) leaves the finding list bit-identical to the
    pre-VSA linter — the parity anchor."""
    cfg = cfg or build_cfg(program)
    dataflow = dataflow or analyze_dataflow(program)
    out: List[Finding] = []

    session_live = None
    if stateful is not None:
        from ..stateful import protocol as _proto
        reached, live_by_state = _proto.reachable_states(program,
                                                         stateful)
        session_live = set()
        for blocks in live_by_state.values():
            session_live |= blocks
        for s in _proto.unreachable_states(program, stateful,
                                           _reached=reached):
            out.append(Finding(
                SEV_WARNING, "state-unreachable",
                f"protocol state {s} is guarded on or assigned but "
                f"no session reaches it from the initial state in "
                f"the static CFG — dead protocol surface (reachable "
                f"states: {sorted(reached)})",
                {"state": int(s), "reachable": sorted(reached)}))
        for pc, v in _proto.state_assignments(program,
                                              stateful.state_reg):
            if v >= stateful.n_states:
                out.append(Finding(
                    SEV_WARNING, "state-clip",
                    f"state assignment r{stateful.state_reg} = {v} "
                    f"at pc {pc} is at/beyond n_states="
                    f"{stateful.n_states}: the session tier clips "
                    f"it into bucket {stateful.n_states - 1}, "
                    f"aliasing distinct states in the state x edge "
                    f"map", {"pc": int(pc), "value": int(v),
                             "n_states": int(stateful.n_states)}))

    # -- empty modules ------------------------------------------------
    for name, lo, hi in program.modules:
        if lo >= hi:
            out.append(Finding(
                SEV_ERROR, "empty-module",
                f"module {name!r} spans no blocks "
                f"(lo == hi == {lo}); its coverage map can never "
                f"light up", {"module": name, "lo": int(lo),
                              "hi": int(hi)}))

    # -- unreachable blocks -------------------------------------------
    for k in cfg.unreachable_blocks():
        out.append(Finding(
            SEV_ERROR, "unreachable-block",
            f"block {k} (pc {cfg.block_pcs[k]}) is unreachable from "
            f"entry; its {sum(1 for f, _ in cfg.edge_cost if f == k)}"
            f" outgoing edges pad the static universe",
            {"block": k, "pc": cfg.block_pcs[k]}))

    # -- instruction field bounds -------------------------------------
    instrs = np.asarray(program.instrs)
    if instrs.size:
        bad = np.flatnonzero(
            (np.abs(instrs[:, 1:]) >= (1 << 24)).any(axis=1))
        for pc in bad:
            out.append(Finding(
                SEV_ERROR, "field-bound",
                f"instruction at pc {int(pc)} has a field >= 2^24; "
                f"the engine's f32 matmul fetch is inexact there",
                {"pc": int(pc)}))

    # -- register fields out of range ---------------------------------
    # the engine clips direct register fields to [0, 8) — defined
    # behavior, but never what the program meant (the assembler
    # rejects these; hand-built / file-loaded programs can carry them
    # and the abstract interpreter models the clip, not the intent)
    from ..models.vm import (
        N_REGS, OP_ADDI, OP_ALU, OP_BR, OP_LDB, OP_LDI, OP_LDM,
        OP_LEN, OP_STM,
    )
    _REG_FIELDS = {OP_LDB: (1, 2), OP_LDI: (1,), OP_ALU: (1, 2),
                   OP_ADDI: (1, 2), OP_BR: (1,), OP_LEN: (1,),
                   OP_LDM: (1, 2), OP_STM: (1, 2)}
    for pc in range(instrs.shape[0]):
        fields = _REG_FIELDS.get(int(instrs[pc, 0]), ())
        bad_f = [f for f in fields
                 if not (0 <= int(instrs[pc, f]) < N_REGS)]
        if bad_f:
            out.append(Finding(
                SEV_WARNING, "register-field-range",
                f"instruction at pc {pc} names register(s) "
                f"{[int(instrs[pc, f]) for f in bad_f]} outside "
                f"r0..r{N_REGS - 1}; the engine clips them — almost "
                f"certainly not what was meant",
                {"pc": int(pc),
                 "fields": [int(instrs[pc, f]) for f in bad_f]}))

    # -- max_steps vs the longest loop-free path ----------------------
    need = cfg.longest_acyclic_path
    if need > program.max_steps:
        out.append(Finding(
            SEV_ERROR, "max-steps-shortfall",
            f"max_steps={program.max_steps} but the longest loop-free "
            f"path needs {need} steps: hang-free executions would be "
            f"triaged as hangs",
            {"max_steps": int(program.max_steps),
             "longest_acyclic_path": int(need)}))

    # -- AFL map-slot collisions in the static edge universe ----------
    slots = np.asarray(program.edge_slot)
    ef = np.asarray(program.edge_from)
    et = np.asarray(program.edge_to)
    by_slot: Dict[int, List] = {}
    for i in range(len(slots)):
        by_slot.setdefault(int(slots[i]), []).append(
            (int(ef[i]), int(et[i])))
    for slot, pairs in sorted(by_slot.items()):
        if len(pairs) > 1:
            out.append(Finding(
                SEV_WARNING, "slot-collision",
                f"{len(pairs)} static edges alias AFL map slot "
                f"{slot}: {pairs} — novelty cannot tell them apart",
                {"slot": slot, "edges": pairs}))

    # -- duplicate coverage ids (assign_block_ids birthday draws) -----
    dup = {bid: n for bid, n in
           Counter(program.block_ids).items() if n > 1}
    for bid, n in sorted(dup.items()):
        blocks = [k for k, b in enumerate(program.block_ids)
                  if b == bid]
        out.append(Finding(
            SEV_WARNING, "duplicate-block-id",
            f"blocks {blocks} share coverage id {bid}: every edge "
            f"into/out of them aliases in the AFL map (re-seed "
            f"assign_block_ids)", {"id": int(bid), "blocks": blocks}))

    # -- statically-dead blocks (constant folding) --------------------
    for k in sorted(dataflow.dead_blocks):
        if k not in cfg.reachable:
            continue                    # already an unreachable error
        if session_live is not None and k in session_live:
            # dead SINGLE-SHOT, alive in sessions: the stateful
            # tier's target surface, not dead weight
            out.append(Finding(
                SEV_INFO, "session-only-block",
                f"block {k} (pc {cfg.block_pcs[k]}) is dead under "
                f"single-shot constant propagation but reachable by "
                f"message sequences — deep-state coverage only the "
                f"session tier can earn",
                {"block": k, "pc": cfg.block_pcs[k]}))
            continue
        out.append(Finding(
            SEV_WARNING, "dead-block",
            f"block {k} (pc {cfg.block_pcs[k]}) is CFG-reachable but "
            f"dead under constant propagation (a branch before it "
            f"always goes the other way)",
            {"block": k, "pc": cfg.block_pcs[k]}))

    # -- value-set checks (--vsa) -------------------------------------
    if vsa is not None:
        out.extend(_vsa_findings(program, cfg, dataflow, vsa,
                                 session_live))

    # -- must-crash blocks --------------------------------------------
    for k in sorted(dataflow.must_crash_blocks):
        out.append(Finding(
            SEV_INFO, "must-crash-block",
            f"every path from block {k} (pc {cfg.block_pcs[k]}) "
            f"crashes — planted bug or dead-end worth confirming",
            {"block": k, "pc": cfg.block_pcs[k]}))

    if cfg.n_blocks == 0:
        out.append(Finding(
            SEV_INFO, "no-blocks",
            "program has no coverage blocks: every input looks "
            "identical to the novelty scan"))

    sev_rank = {SEV_ERROR: 0, SEV_WARNING: 1, SEV_INFO: 2}
    out.sort(key=lambda f: sev_rank[f.severity])
    return out


def _block_of_pc(cfg: ControlFlowGraph, pc: int) -> Optional[int]:
    """Block index containing ``pc`` (the nearest OP_BLOCK at/before
    it), None for pre-block prologue pcs."""
    k = None
    for i, bpc in enumerate(cfg.block_pcs):
        if bpc <= pc:
            k = i
        else:
            break
    return k


def _vsa_findings(program, cfg: ControlFlowGraph,
                  dataflow: DataflowResult, vsa,
                  session_live) -> List[Finding]:
    """The three value-set checks.  All anchored on pcs so the SARIF
    emitter places them like every other finding."""
    out: List[Finding] = []
    instrs = np.asarray(program.instrs)
    ni = instrs.shape[0]
    always_by_pc = {f.pc: f.always for f in dataflow.branches}

    def live_downgrade(block: Optional[int]) -> bool:
        return (session_live is not None and block is not None
                and block in session_live)

    # -- infeasible-edge: a branch side VSA proves empty --------------
    for f in vsa.branches:
        for want, feas in ((True, f.feasible_true),
                           (False, f.feasible_false)):
            if feas:
                continue
            succ = int(instrs[f.pc, 3]) if want else f.pc + 1
            sblk = _block_of_pc(cfg, succ) if 0 <= succ < ni else None
            side = "taken" if want else "fallthrough"
            agrees = always_by_pc.get(f.pc) == (not want)
            if live_downgrade(sblk):
                out.append(Finding(
                    SEV_INFO, "session-infeasible-edge",
                    f"branch at pc {f.pc} ({f.cmp} with "
                    f"x={f.x_dom} y={f.y_dom}) cannot go "
                    f"{side} in a single shot, but message "
                    f"sequences can — the session tier's target "
                    f"surface, not dead weight",
                    {"pc": f.pc, "side": side, "block": f.block,
                     "succ_block": sblk}))
                continue
            sev = SEV_ERROR if agrees else SEV_WARNING
            out.append(Finding(
                sev, "infeasible-edge",
                f"branch at pc {f.pc} ({f.cmp} with x={f.x_dom} "
                f"y={f.y_dom}) can never go {side}: the value-set "
                f"domains make that outcome empty"
                + (" — constant propagation independently agrees"
                   if agrees else "")
                + "; the edge pads the static universe and the "
                  "solver frontier",
                {"pc": f.pc, "side": side, "block": f.block,
                 "succ_block": sblk,
                 "constprop_agrees": bool(agrees)}))

    # -- value-range-contradiction: constprop reaches, VSA refutes ----
    contradicted = sorted(dataflow.reached_pcs - vsa.reached_pcs)
    by_block: Dict[Optional[int], List[int]] = {}
    for pc in contradicted:
        by_block.setdefault(_block_of_pc(cfg, pc), []).append(pc)
    for blk, pcs in sorted(by_block.items(),
                           key=lambda kv: (kv[0] is None, kv[0])):
        if live_downgrade(blk):
            out.append(Finding(
                SEV_INFO, "session-value-range-contradiction",
                f"pcs {pcs} (block {blk}) are reached under "
                f"constant propagation but the value-set fixpoint "
                f"proves no single-shot value combination enters — "
                f"session-only surface",
                {"block": blk, "pcs": pcs}))
            continue
        out.append(Finding(
            SEV_WARNING, "value-range-contradiction",
            f"pcs {pcs}" + (f" (block {blk})" if blk is not None
                            else "")
            + " are reached under constant propagation but the "
              "value-set fixpoint proves no value combination "
              "enters: byte-domain refinement emptied every path "
              "in", {"block": blk, "pcs": pcs}))

    # -- guaranteed-oob-store: non-constant index, interval all OOB ---
    mem = int(program.mem_size)
    for m in vsa.mem_ops:
        d = m.idx_dom
        if d.const_val is not None:
            continue                    # crash-pc analysis owns these
        if d.hi < 0 or d.lo >= mem:
            out.append(Finding(
                SEV_WARNING, "guaranteed-oob-store",
                f"{m.op} at pc {m.pc} indexes mem[{d}] — entirely "
                f"outside [0, {mem}): every execution reaching it "
                f"faults, invisible to constant propagation "
                f"(non-constant index)",
                {"pc": m.pc, "op": m.op, "block": m.block,
                 "index_domain": str(d), "mem_size": mem}))
    return out


def universe_stats(program, cfg: Optional[ControlFlowGraph] = None
                   ) -> Dict:
    """Static-universe summary shared by kb-lint / showmap / picker."""
    cfg = cfg or build_cfg(program)
    slots = np.asarray(program.edge_slot)
    return {
        "name": program.name,
        "n_blocks": int(program.n_blocks),
        "n_edges": int(program.n_edges),
        "n_slots": int(len(np.unique(slots))) if len(slots) else 0,
        "n_modules": len(program.modules),
        "max_steps": int(program.max_steps),
        "longest_acyclic_path": int(cfg.longest_acyclic_path),
        "loop_headers": sorted(cfg.loop_headers),
        "unreachable_blocks": cfg.unreachable_blocks(),
    }
