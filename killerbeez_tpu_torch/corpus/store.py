"""On-disk corpus store — the campaign's durable seed set.

Layout mirrors the reference's ``new_paths/`` (one file per entry
named by its input md5) and adds what the reference kept only in
operator heads: a ``<md5>.json`` metadata sidecar per entry and a
``campaign.json`` state record, so a killed campaign resumes with its
full corpus, bandit stats and lineage instead of starting over.

    <corpus-dir>/
        <md5>            raw input bytes (same naming as new_paths/)
        <md5>.json       metadata sidecar (schema below)
        checkpoint.json  ONE atomic campaign checkpoint epoch
                         (campaign + solver + event seq + component
                         states; resilience/checkpoint.py) — the
                         resume source of truth
        checkpoint.json.prev  previous epoch (torn-write fallback)
        campaign.json    legacy scheduler/campaign state (read when
                         no checkpoint exists)
        solver.json      legacy / offline-tool solver cache
        mutator.state    legacy mutator resume state (JSON string)
        instrumentation.state   legacy coverage resume state

Sidecar schema (docs/CORPUS.md):

    {"md5": ..., "seq": N,            # admission order (monotone)
     "cov_hash": ...,                 # coverage dedup key (sync)
     "sig": [slot, ...] | null,       # coverage signature (edge slots)
     "state_sig": [[state, slot], ...] | null,  # state x edge pairs
                                      # (stateful session tier)
     "edge_hits": {slot: count} | null,   # edge-hit summary
     "selections": float, "finds": float, # bandit arm stats (decayed)
     "parent": md5 | "base" | null,   # lineage: generating arm
     "provenance": {"mutator": ..., "stage": ...,  # mutation
                    "bitmap": b64, "bytes": N} | null,
                                      # provenance: which parent byte
                                      # positions were mutated (the
                                      # learn tier's training labels;
                                      # docs/LEARN.md) — optional,
                                      # pre-learn sidecars omit it
     "source": "local" | "sync",
     "discovered": unix_time,
     "tier": "tpu" | "native" | ... | null,  # execution tier that
                                      # minted the entry (hybrid
                                      # campaigns; docs/HYBRID.md) —
                                      # pre-hybrid sidecars omit it
     "validation": {"verdict": "confirmed" | "proxy_only" | "flaky",
                    "tier": ..., "repro": N, "repeats": N,
                    "attempts": N, "statuses": [...], "t": unix_time,
                    "repair": {"verdict": "repaired" |
                                          "unrepairable",
                               "patch": str | null,
                               "reason": str | null,
                               "t": unix_time} | absent}
                                      # | null — cross-tier verdict
                                      # written back by the hybrid
                                      # bridge (docs/HYBRID.md); the
                                      # repair subsection by
                                      # kb-repair / --auto-repair
                                      # (docs/ANALYSIS.md)

Every write is atomic (tmp file + ``os.replace``, the telemetry
sink's discipline) so a tailer or a crash mid-write never leaves a
torn entry; ``load()`` skips unreadable sidecars instead of dying —
a store survives its own worst write.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional

from ..resilience import checkpoint as _ckpt
from ..resilience.chaos import chaos_point
from ..utils.fileio import ensure_dir, md5_hex
from ..utils.logging import WARNING_MSG

STATE_FILE = "campaign.json"
MUTATOR_STATE_FILE = "mutator.state"
INSTR_STATE_FILE = "instrumentation.state"
SOLVER_STATE_FILE = "solver.json"
VSA_STATE_FILE = "vsa.json"
CHECKPOINT_FILE = _ckpt.CHECKPOINT_FILE
_RESERVED = (STATE_FILE, MUTATOR_STATE_FILE, INSTR_STATE_FILE,
             SOLVER_STATE_FILE, VSA_STATE_FILE, CHECKPOINT_FILE,
             CHECKPOINT_FILE + _ckpt.PREV_SUFFIX)

# Cross-tier validation verdicts (hybrid bridge; docs/HYBRID.md).
# Shared by the sidecar schema, EntryValidator bounds and the hybrid
# validator itself so the taxonomy cannot drift between layers.
VALIDATION_VERDICTS = ("confirmed", "proxy_only", "flaky")

# Sidecar schema bound on ``validation.statuses`` (one status per
# native repeat).  NativeValidator clamps its repeats to this and
# EntryValidator rejects longer lists, so a sidecar minted anywhere
# in the fleet always syncs past every peer's validator.
MAX_VALIDATION_REPEATS = 64

# Repair verdicts a proxy-gap entry's sidecar may carry under
# validation.repair (kb-repair / --auto-repair write-back;
# docs/ANALYSIS.md "Conformance & repair").  Honest by construction:
# there is no "best-effort" value.
REPAIR_VERDICTS = ("repaired", "unrepairable")


def coverage_hash(sig: Optional[List[int]],
                  buf: Optional[bytes] = None,
                  state_sig: Optional[List] = None) -> str:
    """Dedup key for cross-worker exchange: the sha1 of the sorted
    edge-slot signature when one exists (two different inputs hitting
    the same edge set are one frontier), else the content md5 — an
    unsigned entry still dedups exactly.  Stateful session entries
    fold their state x edge pairs in too: a sequence admitted for
    STATE-only novelty (same edge set, new protocol states) is a
    distinct frontier and must not dedup against its stateless
    twin."""
    if sig or state_sig:
        parts = ",".join(str(s) for s in sorted(set(sig or [])))
        if state_sig:
            parts += "|" + ",".join(
                f"{a}:{b}" for a, b in
                sorted((int(a), int(b)) for a, b in state_sig))
        return "sig:" + hashlib.sha1(parts.encode()).hexdigest()
    return "md5:" + (md5_hex(buf) if buf is not None else "")


class CorpusEntry:
    """One stored corpus entry: input bytes + metadata sidecar."""

    __slots__ = ("buf", "md5", "seq", "sig", "state_sig", "edge_hits",
                 "selections", "finds", "parent", "source",
                 "discovered", "cov_hash", "provenance", "tier",
                 "validation")

    def __init__(self, buf: bytes, md5: Optional[str] = None,
                 seq: int = 0, sig: Optional[List[int]] = None,
                 edge_hits: Optional[Dict[int, int]] = None,
                 selections: float = 0.0, finds: float = 0.0,
                 parent: Optional[str] = None, source: str = "local",
                 discovered: Optional[float] = None,
                 cov_hash: Optional[str] = None,
                 state_sig: Optional[List] = None,
                 provenance: Optional[Dict[str, Any]] = None,
                 tier: Optional[str] = None,
                 validation: Optional[Dict[str, Any]] = None):
        self.buf = bytes(buf)
        self.md5 = md5 or md5_hex(self.buf)
        self.seq = int(seq)
        self.sig = sorted(set(int(s) for s in sig)) if sig else None
        # state x edge pairs from the stateful session tier, sorted
        # [[state, slot], ...] (kb-corpus's state-coverage column)
        self.state_sig = (sorted([int(a), int(b)] for a, b in state_sig)
                          if state_sig else None)
        self.edge_hits = ({int(k): int(v) for k, v in edge_hits.items()}
                          if edge_hits else None)
        self.selections = float(selections)
        self.finds = float(finds)
        self.parent = parent
        # mutation provenance (learn tier, optional): a dict with
        # mutator id, stage, and the mutated-byte bitmap — sidecars
        # without it load unchanged
        self.provenance = (dict(provenance)
                           if isinstance(provenance, dict) else None)
        self.source = source
        # hybrid campaign tags (optional): the tier that minted this
        # entry and the cross-tier validation verdict written back by
        # the hybrid bridge — pre-hybrid sidecars load unchanged
        self.tier = str(tier) if tier else None
        self.validation = (dict(validation)
                           if isinstance(validation, dict) else None)
        self.discovered = (time.time() if discovered is None
                           else float(discovered))
        self.cov_hash = cov_hash or coverage_hash(
            self.sig, self.buf, self.state_sig)

    def meta_dict(self) -> Dict[str, Any]:
        return {
            "md5": self.md5, "seq": self.seq, "cov_hash": self.cov_hash,
            "sig": self.sig, "state_sig": self.state_sig,
            "edge_hits": ({str(k): v for k, v in self.edge_hits.items()}
                          if self.edge_hits else None),
            "selections": self.selections, "finds": self.finds,
            "parent": self.parent, "provenance": self.provenance,
            "source": self.source,
            "discovered": self.discovered,
            "tier": self.tier, "validation": self.validation,
        }

    @classmethod
    def from_meta(cls, buf: bytes, meta: Dict[str, Any]) -> "CorpusEntry":
        return cls(buf, md5=meta.get("md5"), seq=meta.get("seq", 0),
                   sig=meta.get("sig"),
                   edge_hits=meta.get("edge_hits"),
                   selections=meta.get("selections", 0.0),
                   finds=meta.get("finds", 0.0),
                   parent=meta.get("parent"),
                   source=meta.get("source", "local"),
                   discovered=meta.get("discovered"),
                   cov_hash=meta.get("cov_hash"),
                   state_sig=meta.get("state_sig"),
                   provenance=meta.get("provenance"),
                   tier=meta.get("tier"),
                   validation=meta.get("validation"))


def _atomic_write(path: str, data: bytes) -> None:
    # chaos seam: every store write (entries, sidecars, campaign /
    # solver state, checkpoint epochs) can be made to tear, hit
    # ENOSPC, or die mid-write under --chaos
    chaos_point("persist", path=path, data=data)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)               # atomic on POSIX


class CorpusStore:
    """Directory-backed corpus with atomic entry/state writes.

    The store is the durable tier under the in-memory scheduler arms:
    admissions write through immediately (a kill after an admission
    loses nothing), arm stats and campaign state flush periodically
    (bounded staleness, bandit scores re-converge within one decay
    period).  All store I/O degrades to warnings — persistence must
    never kill a campaign over a full disk.
    """

    def __init__(self, root: str):
        self.root = str(root)
        ensure_dir(self.root)
        #: last checkpoint doc THIS process saved (single-writer
        #: cache; None until the first save — readers then hit disk)
        self._ckpt_doc: Optional[Dict[str, Any]] = None
        # continue the admission counter past any existing entries:
        # writing into a pre-populated store without load() (e.g.
        # --corpus-dir reused without --resume) must not mint
        # colliding seq numbers — resume's seq-ordered rebuild
        # depends on a monotone timeline
        self._next_seq = 0
        try:
            for name in os.listdir(self.root):
                if not name.endswith(".json") or name in _RESERVED:
                    continue
                try:
                    with open(os.path.join(self.root, name)) as f:
                        seq = int(json.load(f).get("seq", -1))
                    self._next_seq = max(self._next_seq, seq + 1)
                except (OSError, ValueError):
                    continue
        except OSError:
            pass

    # -- entries --------------------------------------------------------

    def entry_path(self, md5: str) -> str:
        return os.path.join(self.root, md5)

    def meta_path(self, md5: str) -> str:
        return os.path.join(self.root, md5 + ".json")

    def next_seq(self) -> int:
        n = self._next_seq
        self._next_seq += 1
        return n

    def put(self, entry: CorpusEntry) -> bool:
        """Write one entry (buf + sidecar, both atomic); returns False
        when an entry with this md5 already exists (content dedup)."""
        path = self.entry_path(entry.md5)
        if os.path.exists(path):
            return False
        try:
            _atomic_write(path, entry.buf)
            _atomic_write(self.meta_path(entry.md5),
                          json.dumps(entry.meta_dict()).encode())
        except OSError as e:
            WARNING_MSG("corpus store write failed for %s: %s",
                        entry.md5, e)
            return False
        self._next_seq = max(self._next_seq, entry.seq + 1)
        return True

    def update_meta(self, entry: CorpusEntry) -> None:
        """Rewrite one entry's sidecar (stats flush)."""
        try:
            _atomic_write(self.meta_path(entry.md5),
                          json.dumps(entry.meta_dict()).encode())
        except OSError as e:
            WARNING_MSG("corpus sidecar update failed for %s: %s",
                        entry.md5, e)

    def load(self) -> List[CorpusEntry]:
        """Every readable entry, in admission (seq) order.  A missing
        or torn sidecar degrades to default metadata — the input bytes
        are the artifact that must never be lost."""
        entries: List[CorpusEntry] = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return entries
        for name in sorted(names):
            if name in _RESERVED or \
                    name.endswith((".json", ".tmp", ".prev")):
                continue
            path = os.path.join(self.root, name)
            if not os.path.isfile(path):
                continue
            try:
                with open(path, "rb") as f:
                    buf = f.read()
            except OSError as e:
                WARNING_MSG("corpus entry %s unreadable: %s", name, e)
                continue
            meta: Dict[str, Any] = {}
            try:
                with open(self.meta_path(name)) as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                meta = {"md5": name, "seq": self._next_seq}
            entries.append(CorpusEntry.from_meta(buf, meta))
        entries.sort(key=lambda e: e.seq)
        if entries:
            self._next_seq = max(self._next_seq,
                                 max(e.seq for e in entries) + 1)
        return entries

    # -- crash-consistent checkpoint (resilience/checkpoint.py) ---------

    def save_checkpoint(self, doc: Dict[str, Any]) -> Optional[int]:
        """Write ONE atomic checkpoint epoch covering campaign state,
        solver cache, event seq and component states — a kill at any
        instruction resumes to a consistent campaign.  Sections the
        caller omits (e.g. ``solver`` on a crack-less interval
        persist) carry forward from the previous epoch instead of
        being dropped; ``components`` carries forward PER KEY, so a
        transient ``get_state()`` failure on one component cannot
        erase its last good state from the epoch chain."""
        prev = self.load_checkpoint()
        if prev:
            for section in ("campaign", "solver", "vsa",
                            "event_seq"):
                if section not in doc and section in prev:
                    doc[section] = prev[section]
            pc = prev.get("components")
            if isinstance(pc, dict):
                dc = doc.get("components")
                if isinstance(dc, dict):
                    for k, v in pc.items():
                        dc.setdefault(k, v)
                elif "components" not in doc:
                    doc["components"] = pc
            if not doc.get("epoch"):
                doc["epoch"] = int(prev.get("epoch", 0)) + 1
        epoch = _ckpt.save(self.root, doc, atomic_write=_atomic_write)
        if epoch is not None:
            cached = dict(doc)
            cached["epoch"] = epoch
            self._ckpt_doc = cached
        return epoch

    def load_checkpoint(self) -> Optional[Dict[str, Any]]:
        # this process is the only checkpoint writer for its corpus
        # dir, so the last successfully saved doc is authoritative —
        # interval persists never re-read/re-parse the (potentially
        # large) document from disk
        if self._ckpt_doc is not None:
            return self._ckpt_doc
        return _ckpt.load(self.root)

    # -- campaign state -------------------------------------------------
    #
    # load_state / load_component_state read the CHECKPOINT first (the
    # unified epoch is the source of truth) and fall back to the
    # legacy per-file layout, so pre-checkpoint campaigns keep
    # working.  The solver cache and the VSA document of a JAX
    # campaign ride the checkpoint's sections, which save_checkpoint
    # carries forward; the port reads neither yet.

    def save_state(self, state: Dict[str, Any]) -> None:
        try:
            _atomic_write(os.path.join(self.root, STATE_FILE),
                          json.dumps(state).encode())
        except OSError as e:
            WARNING_MSG("campaign state write failed: %s", e)

    def load_state(self) -> Optional[Dict[str, Any]]:
        ck = self.load_checkpoint()
        if ck and isinstance(ck.get("campaign"), dict):
            return ck["campaign"]
        try:
            with open(os.path.join(self.root, STATE_FILE)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def load_component_state(self, which: str) -> Optional[str]:
        ck = self.load_checkpoint()
        if ck:
            comp = ck.get("components") or {}
            if isinstance(comp.get(which), str):
                return comp[which]
        name = (MUTATOR_STATE_FILE if which == "mutator"
                else INSTR_STATE_FILE)
        try:
            with open(os.path.join(self.root, name)) as f:
                return f.read()
        except OSError:
            return None
