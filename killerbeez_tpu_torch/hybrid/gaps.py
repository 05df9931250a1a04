"""Bounded, indexed storage for ``kbz-proxy-gap-v1`` reports.

The hybrid bridge writes one report per ``proxy_only`` divergence.  A
long-running campaign against a genuinely divergent proxy can mint
thousands of them — most repeating the same (diverging edge, verdict
class) pair — so ``proxy_gaps/`` behaves like the other bounded
artifact stores:

  * one emitter (:func:`make_gap_report`) shared by the hybrid
    bridge's write-back and ``kb-repair --probe``, so every report is
    schema-identical regardless of producer;
  * a :class:`GapIndex` manifest (``index.json``) over the directory
    — dedup by ``(edge, verdict-kind, input md5)``, retention capped
    with an oldest-evicted policy (the counterexample SET matters for
    repair, not the Nth duplicate of one divergence);
  * reports carry the concrete input (``input_hex``, bounded) and
    the proxy-trace edge the divergence clusters under, which is
    exactly what the conformance pass (analysis/conformance.py) needs
    to replay them as counterexamples.  Consumers of the older shape
    keep working: added keys are tolerated per the contract in
    docs/HYBRID.md, and reports WITHOUT ``input_hex`` still parse
    (they just cannot be replayed — counted, never silently dropped).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from ..corpus.store import _atomic_write
from ..utils.fileio import ensure_dir
from ..utils.logging import WARNING_MSG

GAP_SCHEMA = "kbz-proxy-gap-v1"
INDEX_SCHEMA = "kbz-proxy-gap-index-v1"
INDEX_FILE = "index.json"
#: the repair ledger kb-repair / --auto-repair append to (the lint
#: tier's "has this gap been consumed" source; analysis/repair.py)
LEDGER_FILE = "repairs.json"

#: default retention cap on stored gap reports per campaign
DEFAULT_GAP_CAP = 256

#: inputs above this size are not inlined into the report (the md5
#: still names the finding file under crashes/ / hangs/)
MAX_GAP_INPUT_BYTES = 1 << 16


def make_gap_report(*, md5: str, kind: str, binding: str,
                    proxy_target: str, proxy_status: int,
                    native_argv, native_delivery: str,
                    statuses: List[int], repro: int, repeats: int,
                    t: Optional[float],
                    input_bytes: Optional[bytes] = None,
                    edge: Optional[Tuple[int, int]] = None
                    ) -> Dict[str, Any]:
    """One ``kbz-proxy-gap-v1`` report dict (the contract in
    docs/HYBRID.md).  The single emitter for every producer."""
    report: Dict[str, Any] = {
        "schema": GAP_SCHEMA,
        "md5": md5, "kind": kind,
        "binding": binding,
        "proxy": {"target": proxy_target,
                  "status": int(proxy_status)},
        "native": {"argv": list(native_argv),
                   "delivery": native_delivery,
                   "statuses": [int(s) for s in statuses],
                   "repro": int(repro),
                   "repeats": int(repeats)},
        "t": t,
    }
    if edge is not None:
        report["proxy"]["edge"] = [int(edge[0]), int(edge[1])]
    if input_bytes is not None:
        if len(input_bytes) <= MAX_GAP_INPUT_BYTES:
            report["input_hex"] = bytes(input_bytes).hex()
        else:
            report["input_omitted"] = len(input_bytes)
    return report


def proxy_trace_edge(program, buf: bytes
                     ) -> Optional[Tuple[int, int]]:
    """The last (from-block, to-block) edge of the proxy's concrete
    trace on ``buf`` — the key divergences cluster under.  None when
    the replay itself fails (a gap report is still worth keeping)."""
    try:
        from ..analysis.solver import concrete_run
        trace = concrete_run(program, bytes(buf))
        return trace.edges[-1] if trace.edges else None
    except Exception:
        return None


def _entry_key(e: Dict[str, Any]) -> Tuple:
    edge = e.get("edge")
    return (tuple(edge) if edge else None, e.get("kind"),
            e.get("md5"))


class GapIndex:
    """Manifest over one ``proxy_gaps/`` directory: dedup, retention
    cap, oldest-evicted.  ``admit`` is the only writer; loading
    tolerates a missing/torn manifest by rebuilding from the report
    files themselves."""

    def __init__(self, gap_dir: str, cap: int = DEFAULT_GAP_CAP):
        self.gap_dir = gap_dir
        self.cap = max(1, int(cap))
        self.entries: List[Dict[str, Any]] = []
        self.evicted = 0
        self.duplicates = 0
        self._load()

    # -- loading ------------------------------------------------------

    def _load(self) -> None:
        path = os.path.join(self.gap_dir, INDEX_FILE)
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            if doc.get("schema") == INDEX_SCHEMA and \
                    isinstance(doc.get("entries"), list):
                self.entries = [e for e in doc["entries"]
                                if isinstance(e, dict)]
                self.evicted = int(doc.get("evicted", 0))
                self.duplicates = int(doc.get("duplicates", 0))
                return
        except (OSError, ValueError):
            pass
        self._rebuild()

    def _rebuild(self) -> None:
        """No (usable) manifest: index whatever reports exist — a
        directory of unindexed reports becomes a bounded one on first touch."""
        self.entries = []
        if not os.path.isdir(self.gap_dir):
            return
        for name in sorted(os.listdir(self.gap_dir)):
            if not name.endswith(".json") or \
                    name in (INDEX_FILE, LEDGER_FILE):
                continue
            try:
                with open(os.path.join(self.gap_dir, name),
                          encoding="utf-8") as f:
                    rep = json.load(f)
            except (OSError, ValueError):
                continue
            if rep.get("schema") != GAP_SCHEMA:
                continue
            self.entries.append(self._entry_of(rep, name))
        self.entries.sort(key=lambda e: (e.get("t") or 0.0,
                                         e.get("file", "")))

    @staticmethod
    def _entry_of(report: Dict[str, Any], filename: str
                  ) -> Dict[str, Any]:
        return {"md5": report.get("md5"),
                "kind": report.get("kind"),
                "binding": report.get("binding"),
                "edge": (report.get("proxy") or {}).get("edge"),
                "t": report.get("t"),
                "file": filename}

    # -- writing ------------------------------------------------------

    def admit(self, report: Dict[str, Any]) -> Optional[str]:
        """Write one report (dedup'd, capped); returns its path, or
        None when it deduplicated against an already-stored one."""
        ensure_dir(self.gap_dir)
        filename = f"{report['md5']}.json"
        entry = self._entry_of(report, filename)
        key = _entry_key(entry)
        if any(_entry_key(e) == key for e in self.entries):
            self.duplicates += 1
            self._save()
            return None
        path = os.path.join(self.gap_dir, filename)
        _atomic_write(path, json.dumps(report, indent=1).encode())
        self.entries.append(entry)
        while len(self.entries) > self.cap:
            old = self.entries.pop(0)
            self.evicted += 1
            try:
                os.unlink(os.path.join(self.gap_dir,
                                       old.get("file") or ""))
            except OSError:
                pass
        self._save()
        return path

    def _save(self) -> None:
        try:
            _atomic_write(
                os.path.join(self.gap_dir, INDEX_FILE),
                json.dumps({"schema": INDEX_SCHEMA,
                            "cap": self.cap,
                            "entries": self.entries,
                            "evicted": self.evicted,
                            "duplicates": self.duplicates},
                           indent=1).encode())
        except OSError as e:        # manifest loss must not kill folds
            WARNING_MSG("proxy-gap index write failed: %s", e)


def load_ledger(gap_dir: str) -> List[Dict[str, Any]]:
    """The repair ledger's entries ([] when none/torn)."""
    try:
        with open(os.path.join(gap_dir, LEDGER_FILE),
                  encoding="utf-8") as f:
            doc = json.load(f)
        reps = doc.get("repairs")
        return [r for r in reps if isinstance(r, dict)] \
            if isinstance(reps, list) else []
    except (OSError, ValueError):
        return []


def append_ledger(gap_dir: str, record: Dict[str, Any],
                  cap: int = 256) -> None:
    """Append one repair record (bounded, atomic)."""
    ensure_dir(gap_dir)
    entries = load_ledger(gap_dir)
    entries.append(record)
    _atomic_write(
        os.path.join(gap_dir, LEDGER_FILE),
        json.dumps({"schema": "kbz-proxy-repair-ledger-v1",
                    "repairs": entries[-cap:]}, indent=1).encode())
