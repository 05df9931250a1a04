"""Verified proxy repair: bounded patch synthesis over blamed guards.

The synthesis half of the conformance loop (conformance.py is the
analysis half).  Given a blamed branch and the cluster of gap
counterexamples that indict it, search a **bounded, typed patch
space** and accept a candidate ONLY under the honesty contract:

    a patch is accepted iff the patched program is verdict-identical
    to the native tier on EVERY accumulated gap input AND still
    passes the binding's bind-time certification seeds (benign +
    crash reproducers).  Anything else is an honest ``unrepairable``
    verdict with a machine-readable reason — never a silent
    best-effort patch.

The patch space (all row-local — pcs never shift, so coverage block
ids, module ranges and the rest of the static universe survive):

  ===============  ==================================================
  kind             rewrite at the blamed site
  ===============  ==================================================
  const-nudge      the nearest preceding ``LDI`` that loads the
                   guard's constant is re-aimed at the operand values
                   the counterexamples actually observed (±1)
  negate-cmp       flip the comparison (eq<->ne, lt<->ge)
  force-taken      replace the branch with ``JMP target`` (delete
                   the guard, always take)
  force-fall       replace the branch with ``JMP pc+1`` (delete the
                   guard, never take)
  retarget-crash   re-aim the branch target at a must-crash pc (add
                   a crash guard: native crashes where the proxy
                   exits clean)
  ===============  ==================================================

Every candidate is verified through the lockstep reference
interpreter (solver.concrete_run) — the same "a solved result is
always concretely verified" guarantee the crack stage makes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..models.vm import (
    OP_BR, OP_JMP, OP_LDI, Program,
)
from .conformance import (
    BlameRecord, GapCluster, ReplayResult, load_gap_reports, localize,
    replay_gaps, verdict_class,
)
from .dataflow import analyze_dataflow
from .solver import ConcreteTrace, concrete_run

REPAIR_SCHEMA = "kbz-proxy-repair-v1"

#: total candidate patches tried per cluster (bounded search)
MAX_PATCHES_PER_CLUSTER = 32

#: instruction-window scanned backwards for the guarding LDI
CONST_SCAN_WINDOW = 8

#: LDI immediates must stay inside the engine's exact-field bound
_FIELD_BOUND = (1 << 24) - 1

_NEGATE = {0: 1, 1: 0, 2: 3, 3: 2}      # eq<->ne, lt<->ge


@dataclass
class Patch:
    """One row-local rewrite."""

    kind: str
    pc: int                         # rewritten instruction
    site_pc: int                    # blamed branch it services
    old_row: Tuple[int, int, int, int]
    new_row: Tuple[int, int, int, int]

    @property
    def desc(self) -> str:
        return (f"{self.kind}@pc{self.pc}:"
                f"{list(self.old_row)}->{list(self.new_row)}")

    def as_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "pc": self.pc,
                "site_pc": self.site_pc,
                "old": list(self.old_row), "new": list(self.new_row)}


@dataclass
class Obligation:
    """One input the patched program must classify exactly like the
    native tier."""

    label: str
    buf: bytes
    expect_cls: str


def _row(program, pc: int) -> Tuple[int, int, int, int]:
    return tuple(int(v) for v in np.asarray(program.instrs)[pc])


def apply_patch(program: Program, patch: Patch) -> Program:
    """New Program with one row rewritten; edges/universe recomputed
    by Program construction, coverage identity preserved."""
    instrs = np.array(program.instrs, dtype=np.int32, copy=True)
    instrs[patch.pc] = patch.new_row
    return Program(
        instrs=instrs, name=program.name,
        mem_size=program.mem_size, max_steps=program.max_steps,
        n_blocks=program.n_blocks, block_ids=program.block_ids,
        modules=program.modules)


def _guard_ldi(program, site_pc: int, ra: int, rb: int,
               ) -> Optional[Tuple[int, int]]:
    """The nearest preceding LDI (within a bounded window, not past
    control flow) defining one of the branch's operand registers.
    Returns (pc, reg) or None."""
    instrs = np.asarray(program.instrs)
    for p in range(site_pc - 1,
                   max(-1, site_pc - 1 - CONST_SCAN_WINDOW), -1):
        op, a, b, c = (int(v) for v in instrs[p])
        if op in (OP_BR, OP_JMP):
            return None             # merge point: scan unsound
        if op == OP_LDI and (a & 7) in (ra, rb):
            return p, (a & 7)
    return None


def enumerate_patches(program: Program, blame: BlameRecord,
                      dataflow=None) -> List[Patch]:
    """The bounded, typed patch space for one blame record — most
    targeted first.  The verifier is the soundness gate; this only
    proposes."""
    dataflow = dataflow or analyze_dataflow(program)
    instrs = np.asarray(program.instrs)
    ni = instrs.shape[0]
    crash_pcs = sorted(getattr(dataflow, "crash_pcs", ()) or ())
    out: List[Patch] = []

    for site in blame.candidates or [blame.pc]:
        if not (0 <= site < ni):
            continue
        op, a, b, c = (int(v) for v in instrs[site])
        if op != OP_BR:
            continue
        row = (op, a, b, c)
        ra, rb = a & 7, (b >> 2) & 7
        obs = blame.observed if site == blame.pc else []

        # 1. const-nudge: re-aim the guarding LDI at the operand
        #    values the counterexamples observed
        found = _guard_ldi(program, site, ra, rb)
        if found is not None:
            lpc, lreg = found
            lrow = _row(program, lpc)
            # the OTHER operand's observed values are the targets
            want: List[int] = []
            for x, y, _tk in obs:
                v = y if lreg == ra else x
                for cand in (v, v + 1, v - 1):
                    if abs(cand) <= _FIELD_BOUND and \
                            cand != lrow[2] and cand not in want:
                        want.append(cand)
            for v in want[:6]:
                out.append(Patch(
                    kind="const-nudge", pc=lpc, site_pc=site,
                    old_row=lrow,
                    new_row=(lrow[0], lrow[1], v, lrow[3])))

        # 2. negate-cmp
        out.append(Patch(
            kind="negate-cmp", pc=site, site_pc=site, old_row=row,
            new_row=(op, a, (b & ~3) | _NEGATE[b & 3], c)))

        # 3/4. delete the guard (always / never taken)
        if 0 <= c < ni:
            out.append(Patch(kind="force-taken", pc=site,
                             site_pc=site, old_row=row,
                             new_row=(OP_JMP, c, 0, 0)))
        if site + 1 < ni:
            out.append(Patch(kind="force-fall", pc=site,
                             site_pc=site, old_row=row,
                             new_row=(OP_JMP, site + 1, 0, 0)))

        # 5. add a crash guard: branch into a must-crash pc
        for cpc in crash_pcs[:2]:
            if cpc != c:
                out.append(Patch(
                    kind="retarget-crash", pc=site, site_pc=site,
                    old_row=row, new_row=(op, a, b, int(cpc))))

        if len(out) >= MAX_PATCHES_PER_CLUSTER:
            break
    return out[:MAX_PATCHES_PER_CLUSTER]


def verify_program(program: Program, obligations: List[Obligation],
                   trace_cache: Optional[Dict[bytes, ConcreteTrace]]
                   = None) -> List[Dict[str, Any]]:
    """Replay every obligation; returns the failures ([] = verified).
    The cache must be private to one candidate program — traces are
    keyed by input only."""
    failures = []
    cache: Dict[bytes, ConcreteTrace] = \
        trace_cache if trace_cache is not None else {}
    for ob in obligations:
        trace = cache.get(ob.buf)
        if trace is None:
            trace = concrete_run(program, ob.buf)
            cache[ob.buf] = trace
        got = verdict_class(trace.status)
        if got != ob.expect_cls:
            failures.append({"label": ob.label,
                             "expect": ob.expect_cls, "got": got})
    return failures


# --------------------------------------------------------------------
# the repair driver
# --------------------------------------------------------------------

def certification_obligations(binding, program: Program
                              ) -> List[Obligation]:
    """Bind-time seeds as repair obligations.  Expected classes come
    from the ORIGINAL proxy — certification guarantees they equal
    the native tier's, so no native execution is needed here."""
    obs = [Obligation(
        label="cert:benign", buf=bytes(binding.benign_seed),
        expect_cls=verdict_class(
            concrete_run(program, bytes(binding.benign_seed)).status))]
    for i, seed in enumerate(getattr(binding, "crash_seeds", ()) or ()):
        obs.append(Obligation(
            label=f"cert:crash[{i}]", buf=bytes(seed),
            expect_cls=verdict_class(
                concrete_run(program, bytes(seed)).status)))
    return obs


def _repair_cluster(program: Program, cluster: GapCluster,
                    obligations: List[Obligation], dataflow
                    ) -> Tuple[Optional[Program], Optional[Patch],
                               Optional[BlameRecord], str]:
    """Try to patch one cluster.  Returns (patched program, patch,
    blame, reason) — program None when unrepairable."""
    cluster_obs = [
        Obligation(label=f"gap:{rep.md5[:12]}", buf=rep.input,
                   expect_cls=cluster.native_cls)
        for rep in cluster.reports]
    if not verify_program(program, cluster_obs):
        # an earlier cluster's patch already bent these inputs to
        # the native verdict — nothing left to synthesize
        return program, None, None, "already-conformant"
    blame = localize(program, cluster, dataflow)
    if blame is None:
        return None, None, None, "blame:no-input-dependent-branch"
    patches = enumerate_patches(program, blame, dataflow)
    if not patches:
        return None, None, blame, "patch:empty-space"
    for patch in patches:
        candidate = apply_patch(program, patch)
        if not verify_program(candidate, obligations + cluster_obs):
            return candidate, patch, blame, "repaired"
    return None, None, blame, "patch:space-exhausted"


def run_repair(binding, gaps_dir: str,
               backlog_threshold: int = 0,
               now: Optional[float] = None
               ) -> Tuple[Dict[str, Any], Optional[Program]]:
    """The full counterexample-guided repair pass for one binding.

    Returns ``(result, patched_program)``; result carries schema
    ``kbz-proxy-repair-v1`` and status:

    * ``repaired``     — every divergence cluster got a verified
      patch and the FINAL program is verdict-identical to the native
      tier on all gap inputs + all certification seeds.
    * ``unrepairable`` — at least one cluster resisted the bounded
      patch space (or verification failed); per-cluster
      machine-readable reasons.  ``patched_program`` is None: no
      silent best-effort.
    * ``no-gaps``      — nothing to do (no reports, or all stale).
    """
    t0 = now if now is not None else time.time()
    program = binding.program()
    reports, rejects = load_gap_reports(gaps_dir)
    result: Dict[str, Any] = {
        "schema": REPAIR_SCHEMA,
        "binding": binding.name,
        "proxy_target": binding.proxy_target,
        "gaps_dir": gaps_dir,
        "reports": len(reports),
        "rejects": [{"file": f, "reason": r} for f, r in rejects],
        "t": round(t0, 3),
    }
    mine = [r for r in reports if r.binding == binding.name]
    result["foreign"] = len(reports) - len(mine)
    if not mine:
        result.update(status="no-gaps", reason="gap:none-for-binding",
                      clusters=[])
        return result, None
    trace_cache: Dict[bytes, ConcreteTrace] = {}
    replay: ReplayResult = replay_gaps(program, mine, trace_cache)
    result["stale"] = len(replay.stale)
    result["skipped"] = [
        {"md5": rep.md5, "reason": why}
        for rep, why in replay.skipped]
    if not replay.clusters:
        if replay.skipped and not replay.stale:
            result.update(status="unrepairable",
                          reason="gap:no-replayable-inputs",
                          clusters=[])
        else:
            result.update(status="no-gaps", reason="gap:all-stale",
                          clusters=[])
        return result, None

    dataflow = analyze_dataflow(program)
    cert_obs = certification_obligations(binding, program)
    result["obligations"] = {
        "certification": [o.label for o in cert_obs],
        "gap_inputs": sum(len(c.reports) for c in replay.clusters),
    }
    clusters_out: List[Dict[str, Any]] = []
    patched = program
    done_obs: List[Obligation] = []     # repaired clusters' inputs
    all_ok = True
    # big clusters first: most counterexamples, strongest evidence
    for cluster in sorted(replay.clusters,
                          key=lambda c: -len(c.reports)):
        crec: Dict[str, Any] = {
            "edge": list(cluster.edge) if cluster.edge else None,
            "proxy_cls": cluster.proxy_cls,
            "native_cls": cluster.native_cls,
            "inputs": [r.md5 for r in cluster.reports],
        }
        prog2, patch, blame, reason = _repair_cluster(
            patched, cluster, cert_obs + done_obs, dataflow)
        crec["blame"] = blame.as_dict() if blame else None
        crec["status"] = "repaired" if prog2 is not None \
            else "unrepairable"
        if prog2 is not None:
            crec["patch"] = patch.as_dict() if patch else None
            crec["patch_desc"] = patch.desc if patch else reason
            patched = prog2
            # later clusters must keep THIS cluster fixed
            done_obs += [
                Obligation(label=f"gap:{rep.md5[:12]}",
                           buf=rep.input,
                           expect_cls=cluster.native_cls)
                for rep in cluster.reports]
            # patched program changed: facts must be recomputed for
            # the next cluster's localization/patch proposals
            dataflow = analyze_dataflow(patched)
        else:
            crec["reason"] = reason
            all_ok = False
        clusters_out.append(crec)
    result["clusters"] = clusters_out
    if not all_ok:
        reasons = sorted({c.get("reason") for c in clusters_out
                          if c.get("status") == "unrepairable"})
        result.update(status="unrepairable",
                      reason=";".join(r for r in reasons if r))
        return result, None
    # final gate: the WHOLE obligation set against the final program
    final_failures = verify_program(patched, cert_obs + done_obs)
    if final_failures:
        result.update(status="unrepairable",
                      reason="verify:final-program",
                      failures=final_failures)
        return result, None
    result.update(status="repaired", reason=None,
                  patches=[c["patch"] for c in clusters_out
                           if c.get("patch")])
    return result, patched


# --------------------------------------------------------------------
# artifacts
# --------------------------------------------------------------------

def save_patched_program(program: Program, path: str) -> str:
    """Write the patched proxy as a loadable ``.npz`` (the
    load_program_from_options / ProxyBinding.program_file format)."""
    payload: Dict[str, Any] = {
        "instrs": np.asarray(program.instrs, dtype=np.int32),
        "name": np.asarray(f"{program.name}+repaired"),
        "mem_size": np.asarray(int(program.mem_size)),
        "max_steps": np.asarray(int(program.max_steps)),
        "n_blocks": np.asarray(int(program.n_blocks)),
        "block_ids": np.asarray([int(b) for b in program.block_ids],
                                dtype=np.int32),
    }
    if program.modules:
        payload["module_names"] = np.asarray(
            [m[0] for m in program.modules])
        payload["modules_lo"] = np.asarray(
            [int(m[1]) for m in program.modules], dtype=np.int32)
        payload["modules_hi"] = np.asarray(
            [int(m[2]) for m in program.modules], dtype=np.int32)
    with open(path, "wb") as f:
        np.savez(f, **payload)
    return path


def write_repair_ledger(gaps_dir: str, result: Dict[str, Any]
                        ) -> int:
    """Fold one repair result into ``proxy_gaps/repairs.json`` — one
    ledger record per cluster (the conformance lint's consumed-set
    and drift baseline).  Returns how many records landed."""
    from ..hybrid.gaps import append_ledger

    n = 0
    for crec in result.get("clusters") or []:
        append_ledger(gaps_dir, {
            "binding": result["binding"],
            "edge": crec.get("edge"),
            "pc": (crec.get("blame") or {}).get("pc"),
            "status": crec.get("status"),
            "patch": crec.get("patch_desc"),
            "reason": crec.get("reason"),
            "consumed": list(crec.get("inputs") or []),
            "t": result.get("t"),
        })
        n += 1
    return n
