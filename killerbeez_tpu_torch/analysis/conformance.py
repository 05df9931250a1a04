"""Counterexample-guided proxy conformance: gap ingestion, replay
clustering, and divergence localization.

The hybrid tier (docs/HYBRID.md) mints one ``kbz-proxy-gap-v1``
report per input where the KBVM proxy and the real binary disagree.
Each report is a concrete COUNTEREXAMPLE against the proxy program —
exactly what a CEGAR-style pass needs.  This module is the analysis
half of that loop (repair.py is the synthesis half):

  1. **ingestion** — :func:`parse_gap_report` validates accumulated
     reports against the schema contract (added keys tolerated,
     ``schema`` gates parsing; older reports without
     ``input_hex`` parse but are counted unreplayable, never
     silently dropped).
  2. **replay clustering** — :func:`replay_gaps` re-executes every
     replayable counterexample through the lockstep reference
     interpreter (solver.concrete_run, shared trace cache) and
     clusters by (final trace edge, proxy verdict class): one
     cluster ≈ one diverging guard.
  3. **localization** — :func:`localize` walks a cluster's traces
     backwards to the last branch whose outcome the native verdict
     contradicts, ranks blame candidates by the dataflow layer's
     per-branch dependency sets + guarding constants (Angora's
     byte-level-taint idea, arxiv 1803.01307, turned from search
     guidance into blame assignment), and emits a
     ``kbz-proxy-blame-v1`` record: branch pc, cmp, observed
     operands, gap inputs covered.
  4. **conformance lint** — :func:`conformance_lint` turns the gap
     directory's bookkeeping into kb-lint findings:
     ``proxy-gap-backlog`` (warning) when unconsumed counterexamples
     pile up, ``conformance-drift`` (error) when gaps recur on a
     site the repair ledger says was fixed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .. import FUZZ_CRASH, FUZZ_ERROR, FUZZ_HANG, FUZZ_NONE
from .dataflow import BranchFact, DataflowResult, analyze_dataflow
from .lint import SEV_ERROR, SEV_WARNING, Finding
from .solver import ConcreteTrace, concrete_run

GAP_SCHEMA = "kbz-proxy-gap-v1"
BLAME_SCHEMA = "kbz-proxy-blame-v1"

#: unconsumed gap reports tolerated before the backlog lint fires
DEFAULT_BACKLOG_THRESHOLD = 8

#: blame candidates / observed operand samples kept per record
MAX_BLAME_CANDIDATES = 3
MAX_OBSERVED = 8


class GapParseError(ValueError):
    """A report that fails the ``kbz-proxy-gap-v1`` contract."""


def verdict_class(status: int) -> str:
    """FUZZ_* verdict -> the cross-tier verdict-class vocabulary."""
    if status == FUZZ_CRASH:
        return "crash"
    if status == FUZZ_HANG:
        return "hang"
    if status == FUZZ_NONE:
        return "ok"
    return "error"


@dataclass
class GapReport:
    """One parsed counterexample (validated ``kbz-proxy-gap-v1``)."""

    md5: str
    kind: str                       # "crash" | "hang"
    binding: str
    proxy_target: str
    proxy_status: int
    native_statuses: List[int]
    repro: int
    repeats: int
    t: Optional[float]
    #: concrete input bytes — None for older reports (parse, but
    #: cannot be replayed as a counterexample)
    input: Optional[bytes] = None
    #: proxy-trace edge recorded at emit time (may be stale wrt the
    #: current program; replay recomputes)
    edge: Optional[Tuple[int, int]] = None
    raw: Dict[str, Any] = field(default_factory=dict, repr=False)

    @property
    def native_cls(self) -> Optional[str]:
        """Majority native verdict class over the repeats, errors
        excluded; None when the native side never measured."""
        votes: Dict[str, int] = {}
        for s in self.native_statuses:
            if s == FUZZ_ERROR:
                continue
            c = verdict_class(s)
            votes[c] = votes.get(c, 0) + 1
        if not votes:
            return None
        return max(sorted(votes), key=lambda c: votes[c])

    @property
    def proxy_cls(self) -> str:
        return verdict_class(self.proxy_status)


def parse_gap_report(obj: Any) -> GapReport:
    """Validate one report dict; raises :class:`GapParseError` with a
    machine-greppable ``gap:<field>`` reason."""
    if not isinstance(obj, dict):
        raise GapParseError("gap:not-a-dict")
    if obj.get("schema") != GAP_SCHEMA:
        raise GapParseError(f"gap:schema {obj.get('schema')!r}")
    md5 = obj.get("md5")
    if not isinstance(md5, str) or not md5:
        raise GapParseError("gap:md5")
    kind = obj.get("kind")
    if kind not in ("crash", "hang"):
        raise GapParseError(f"gap:kind {kind!r}")
    binding = obj.get("binding")
    if not isinstance(binding, str) or not binding:
        raise GapParseError("gap:binding")
    proxy = obj.get("proxy")
    if not isinstance(proxy, dict) or \
            not isinstance(proxy.get("target"), str) or \
            not isinstance(proxy.get("status"), int):
        raise GapParseError("gap:proxy")
    native = obj.get("native")
    if not isinstance(native, dict):
        raise GapParseError("gap:native")
    statuses = native.get("statuses")
    if not isinstance(statuses, list) or \
            not all(isinstance(s, int) for s in statuses):
        raise GapParseError("gap:native.statuses")
    try:
        repro = int(native.get("repro", 0))
        repeats = int(native.get("repeats", 0))
    except (TypeError, ValueError):
        raise GapParseError("gap:native.repro")
    t = obj.get("t")
    if t is not None and not isinstance(t, (int, float)):
        raise GapParseError("gap:t")
    buf: Optional[bytes] = None
    if "input_hex" in obj:
        try:
            buf = bytes.fromhex(obj["input_hex"])
        except (TypeError, ValueError):
            raise GapParseError("gap:input_hex")
    edge = None
    raw_edge = proxy.get("edge")
    if raw_edge is not None:
        if not (isinstance(raw_edge, (list, tuple))
                and len(raw_edge) == 2
                and all(isinstance(e, int) for e in raw_edge)):
            raise GapParseError("gap:proxy.edge")
        edge = (raw_edge[0], raw_edge[1])
    return GapReport(
        md5=md5, kind=kind, binding=binding,
        proxy_target=proxy["target"],
        proxy_status=int(proxy["status"]),
        native_statuses=[int(s) for s in statuses],
        repro=repro, repeats=repeats,
        t=float(t) if t is not None else None,
        input=buf, edge=edge, raw=obj)


def load_gap_reports(gaps_dir: str
                     ) -> Tuple[List[GapReport],
                                List[Tuple[str, str]]]:
    """Parse every report in a ``proxy_gaps/`` directory.  Returns
    ``(reports, rejects)`` where each reject is (filename, reason) —
    malformed files are surfaced, never silently skipped."""
    import json

    from ..hybrid.gaps import INDEX_FILE, LEDGER_FILE

    reports: List[GapReport] = []
    rejects: List[Tuple[str, str]] = []
    if not os.path.isdir(gaps_dir):
        return reports, rejects
    for name in sorted(os.listdir(gaps_dir)):
        if not name.endswith(".json") or \
                name in (INDEX_FILE, LEDGER_FILE):
            continue
        try:
            with open(os.path.join(gaps_dir, name),
                      encoding="utf-8") as f:
                obj = json.load(f)
        except (OSError, ValueError) as e:
            rejects.append((name, f"gap:json {type(e).__name__}"))
            continue
        try:
            reports.append(parse_gap_report(obj))
        except GapParseError as e:
            rejects.append((name, str(e)))
    return reports, rejects


# --------------------------------------------------------------------
# replay clustering
# --------------------------------------------------------------------

@dataclass
class GapCluster:
    """Counterexamples that replay down the same proxy path tail."""

    #: final (from-block, to-block) edge of the replayed trace
    edge: Optional[Tuple[int, int]]
    #: the proxy's verdict class on these inputs (replayed)
    proxy_cls: str
    #: the native tier's verdict class the proxy must be bent toward
    native_cls: str
    reports: List[GapReport] = field(default_factory=list)
    traces: List[ConcreteTrace] = field(default_factory=list)


@dataclass
class ReplayResult:
    clusters: List[GapCluster]
    #: replayed clean: current proxy already agrees with the native
    #: verdict (e.g. the program was repaired since the report)
    stale: List[GapReport] = field(default_factory=list)
    #: not replayable: no input bytes, or native never measured —
    #: (report, reason) pairs, counted, never silently dropped
    skipped: List[Tuple[GapReport, str]] = field(default_factory=list)


def replay_gaps(program, reports: List[GapReport],
                trace_cache: Optional[Dict[bytes, ConcreteTrace]]
                = None) -> ReplayResult:
    """Replay every replayable counterexample through the reference
    interpreter and cluster divergences by (final trace edge, proxy
    verdict class) — one cluster per suspected diverging guard.

    ``trace_cache`` follows the crack/search-tier convention
    (Dict[bytes, ConcreteTrace]) so repeated passes share replays."""
    if trace_cache is None:
        trace_cache = {}
    out = ReplayResult(clusters=[])
    by_key: Dict[Tuple, GapCluster] = {}
    for rep in reports:
        if rep.input is None:
            out.skipped.append((rep, "no-input"))
            continue
        native_cls = rep.native_cls
        if native_cls is None:
            out.skipped.append((rep, "native-never-measured"))
            continue
        buf = rep.input
        trace = trace_cache.get(buf)
        if trace is None:
            trace = concrete_run(program, buf)
            trace_cache[buf] = trace
        proxy_cls = verdict_class(trace.status)
        if proxy_cls == native_cls:
            out.stale.append(rep)
            continue
        edge = tuple(trace.edges[-1]) if trace.edges else None
        key = (edge, proxy_cls, native_cls)
        cluster = by_key.get(key)
        if cluster is None:
            cluster = GapCluster(edge=edge, proxy_cls=proxy_cls,
                                 native_cls=native_cls)
            by_key[key] = cluster
            out.clusters.append(cluster)
        cluster.reports.append(rep)
        cluster.traces.append(trace)
    return out


# --------------------------------------------------------------------
# divergence localization
# --------------------------------------------------------------------

def _input_dependent(fact: Optional[BranchFact]) -> bool:
    """A branch whose outcome can depend on the input at all: taint
    top (deps is ANY=None), a nonempty byte set, or a length
    dependency.  Constant-only branches cannot explain an
    input-specific divergence."""
    if fact is None:
        return True         # unknown to dataflow: cannot rule it out
    if fact.deps is None:
        return True         # ANY — taint top
    if fact.deps:
        return True
    return bool(fact.len_dep)


@dataclass
class BlameRecord:
    """One ``kbz-proxy-blame-v1`` record: the guard a cluster of
    counterexamples indicts, with evidence."""

    pc: int
    cmp: str
    block: int
    edge: Optional[Tuple[int, int]]
    proxy_cls: str
    native_cls: str
    #: guarding constant from dataflow (None when not constant)
    const: Optional[int]
    #: input byte positions the guard depends on (None = ANY)
    deps: Optional[List[int]]
    #: observed (x, y, taken) operand triples at the blamed branch
    observed: List[Tuple[int, int, bool]]
    #: md5s of the gap inputs this record covers
    inputs: List[str]
    #: runner-up blamed pcs, best first (bounded)
    candidates: List[int] = field(default_factory=list)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "schema": BLAME_SCHEMA,
            "pc": self.pc, "cmp": self.cmp, "block": self.block,
            "edge": list(self.edge) if self.edge else None,
            "proxy_cls": self.proxy_cls,
            "native_cls": self.native_cls,
            "const": self.const,
            "deps": self.deps,
            "observed": [[x, y, bool(tk)]
                         for x, y, tk in self.observed],
            "inputs": list(self.inputs),
            "candidates": list(self.candidates),
        }


def localize(program, cluster: GapCluster,
             dataflow: Optional[DataflowResult] = None
             ) -> Optional[BlameRecord]:
    """Blame assignment for one cluster: the LAST branch executed on
    the cluster's traces whose outcome the native verdict contradicts
    — i.e. the last input-dependent guard before the diverging tail.

    Candidates are ranked per trace by recency (closest to the
    divergence first), filtered to input-dependent branches via the
    dataflow layer's dependency sets, then voted across the cluster's
    traces.  Returns None when no trace executed any input-dependent
    branch (nothing to blame — the divergence is out of the branch
    model; repair reports it unrepairable)."""
    dataflow = dataflow or analyze_dataflow(program)
    facts: Dict[int, BranchFact] = {f.pc: f for f in
                                    dataflow.branches}
    # votes[pc] accumulates recency-weighted support across traces
    votes: Dict[int, float] = {}
    observed: Dict[int, List[Tuple[int, int, bool]]] = {}
    for trace in cluster.traces:
        rank = 0
        for pc, x, y, taken in reversed(trace.branches):
            if not _input_dependent(facts.get(pc)):
                continue
            votes[pc] = votes.get(pc, 0.0) + 1.0 / (1 + rank)
            obs = observed.setdefault(pc, [])
            if len(obs) < MAX_OBSERVED and (x, y, taken) not in obs:
                obs.append((x, y, taken))
            rank += 1
            if rank >= MAX_BLAME_CANDIDATES:
                break
    if not votes:
        return None
    ranked = sorted(votes, key=lambda pc: (-votes[pc], -pc))
    top = ranked[0]
    fact = facts.get(top)
    return BlameRecord(
        pc=top,
        cmp=fact.cmp if fact else "?",
        block=fact.block if fact else -1,
        edge=cluster.edge,
        proxy_cls=cluster.proxy_cls,
        native_cls=cluster.native_cls,
        const=fact.const if fact else None,
        deps=(sorted(fact.deps) if fact and fact.deps is not None
              else None),
        observed=observed.get(top, []),
        inputs=[r.md5 for r in cluster.reports],
        candidates=ranked[:MAX_BLAME_CANDIDATES])


# --------------------------------------------------------------------
# conformance lint (kb-lint --gaps-dir)
# --------------------------------------------------------------------

def conformance_lint(gaps_dir: str,
                     backlog_threshold: int =
                     DEFAULT_BACKLOG_THRESHOLD) -> List[Finding]:
    """Lint the gap directory's bookkeeping (no replay needed):

    * ``proxy-gap-backlog`` (warning) — more unconsumed gap reports
      than ``backlog_threshold``: counterexamples are piling up with
      no repair pass consuming them.
    * ``conformance-drift`` (error) — a gap report NEWER than a
      ledger entry that claims its (binding, edge) site repaired:
      the repaired proxy regressed, or the unrepaired one is still
      deployed.
    """
    from ..hybrid.gaps import GapIndex, load_ledger

    out: List[Finding] = []
    index = GapIndex(gaps_dir)
    ledger = load_ledger(gaps_dir)
    consumed = set()
    for rec in ledger:
        for md5 in rec.get("consumed") or []:
            consumed.add(md5)
    backlog = [e for e in index.entries
               if e.get("md5") not in consumed]
    if len(backlog) > max(0, int(backlog_threshold)):
        bindings = sorted({e.get("binding") for e in backlog
                           if e.get("binding")})
        out.append(Finding(
            SEV_WARNING, "proxy-gap-backlog",
            f"{len(backlog)} unconsumed proxy-gap counterexamples "
            f"in {gaps_dir} (threshold {backlog_threshold}) — run "
            f"kb-repair to fold them into the proxy, or the hybrid "
            f"tier keeps paying the proxy_only tax",
            {"unconsumed": len(backlog),
             "threshold": int(backlog_threshold),
             "bindings": bindings,
             "binding": bindings[0] if bindings else None,
             "gaps_dir": gaps_dir}))
    # drift: repaired (binding, edge) sites with newer gap reports
    repaired: Dict[Tuple, float] = {}
    for rec in ledger:
        if rec.get("status") != "repaired":
            continue
        key = (rec.get("binding"),
               tuple(rec["edge"]) if rec.get("edge") else None)
        t = float(rec.get("t") or 0.0)
        repaired[key] = max(repaired.get(key, 0.0), t)
    for key, t_fixed in sorted(repaired.items(),
                               key=lambda kv: str(kv[0])):
        binding, edge = key
        newer = [e for e in index.entries
                 if e.get("binding") == binding
                 and (edge is None or
                      (e.get("edge") and tuple(e["edge"]) == edge))
                 and float(e.get("t") or 0.0) > t_fixed]
        if newer:
            out.append(Finding(
                SEV_ERROR, "conformance-drift",
                f"binding {binding!r} edge {list(edge) if edge else '?'} "
                f"was repaired at t={t_fixed:.0f} but "
                f"{len(newer)} newer gap report(s) hit the same "
                f"site — the repair regressed or was never "
                f"installed",
                {"binding": binding,
                 "edge": list(edge) if edge else None,
                 "repaired_t": t_fixed,
                 "newer": [e.get("md5") for e in newer][:8],
                 "gaps_dir": gaps_dir}))
    out.sort(key=lambda f: 0 if f.severity == SEV_ERROR else 1)
    return out
