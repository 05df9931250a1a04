"""Poisoned-entry quarantine — the fleet's immune system.

Corpus exchange (manager-mediated ``sync.py`` or peer-to-peer
``gossip.py``) admits inputs produced by MACHINES WE DO NOT TRUST: a
misbehaving worker, a corrupted store, a manager whose disk tore a
row, or an attacker on the fleet network can all ship entries that
are oversized, malformed, or lie about their coverage.  Admitting
them poisons the rotation (the scheduler fuzzes garbage), poisons
the dedup sets (a forged ``cov_hash`` masks a real frontier), and —
worst — a crash while *parsing* one kills the worker.

Every synced-in entry therefore passes :class:`EntryValidator`
before admission:

  * **schema** — the row must be a dict with the documented fields
    at the documented types (``content_b64`` str, ``md5`` hex str,
    ``cov_hash`` str, ``meta`` dict-or-None, ``sig`` int-list…);
  * **size caps** — content and metadata are bounded (defaults: 4 MB
    input, 256 KB meta, 65536 signature slots) so one entry cannot
    OOM the worker or bloat every peer's store;
  * **cov_hash recomputed** — the dedup key is re-derived from the
    claimed signature/content (``store.coverage_hash``) and compared;
    a mismatch means the peer lied about (or corrupted) the one field
    the whole exchange dedups by;
  * **optional re-execution** — callers with a local instrumentation
    can pass ``executor(buf) -> sig`` and the entry's claimed
    signature is checked against a real execution.

Failures never raise into the caller: the entry is written to the
quarantine directory (``<corpus>/quarantine/<md5>{,.json}``) for the
operator, the ``sync_quarantined`` counter increments, and — on the
peer path — the offending peer's strike count rises until
:class:`PeerBans` bans it for a decorrelated-backoff interval
(``U[base, 3x previous]``, capped), the same anti-lockstep discipline
as the sync round gate.
"""

from __future__ import annotations

import base64
import binascii
import json
import os
import random
import time
from typing import Any, Callable, Dict, Optional, Tuple

from ..utils.fileio import ensure_dir, md5_hex
from ..utils.logging import WARNING_MSG
from .store import (
    CorpusEntry, MAX_VALIDATION_REPEATS, REPAIR_VERDICTS,
    VALIDATION_VERDICTS,
    coverage_hash,
)

#: quarantine subdirectory under a corpus store root
QUARANTINE_DIR = "quarantine"


class EntryValidator:
    """Validate one exchange row before it becomes a corpus entry.

    ``validate(row)`` returns ``(entry, reason)``: a
    :class:`CorpusEntry` and ``None`` on success, or ``None`` and a
    short machine-greppable reason string on failure.  Pure and
    exception-free — a validator that crashes on hostile input is
    itself the vulnerability.
    """

    def __init__(self, max_content_bytes: int = 4 << 20,
                 max_meta_bytes: int = 256 << 10,
                 max_sig_slots: int = 65536,
                 executor: Optional[Callable[[bytes], Any]] = None):
        self.max_content_bytes = int(max_content_bytes)
        self.max_meta_bytes = int(max_meta_bytes)
        self.max_sig_slots = int(max_sig_slots)
        #: optional re-execution hook: bytes -> edge-slot list (the
        #: local instrumentation); claimed signatures must reproduce
        self.executor = executor

    def validate(self, row: Any) -> Tuple[Optional[CorpusEntry],
                                          Optional[str]]:
        try:
            return self._validate(row)
        except Exception as e:      # hostile input must never raise
            return None, f"validator-error:{type(e).__name__}"

    def _validate(self, row: Any) -> Tuple[Optional[CorpusEntry],
                                           Optional[str]]:
        if not isinstance(row, dict):
            return None, "schema:not-a-dict"
        b64 = row.get("content_b64")
        if not isinstance(b64, str):
            return None, "schema:content_b64"
        # cheap pre-decode cap: 4 b64 chars ~ 3 bytes
        if len(b64) > (self.max_content_bytes * 4) // 3 + 8:
            return None, "size:content"
        try:
            buf = base64.b64decode(b64, validate=True)
        except (binascii.Error, ValueError):
            return None, "schema:content_b64-decode"
        if len(buf) > self.max_content_bytes:
            return None, "size:content"
        if not buf:
            return None, "schema:empty-content"
        md5 = row.get("md5")
        if md5 is not None and md5 != "":
            if not (isinstance(md5, str) and len(md5) == 32 and
                    all(c in "0123456789abcdef" for c in md5)):
                return None, "schema:md5"
            if md5 != md5_hex(buf):
                return None, "integrity:md5-mismatch"
        meta = row.get("meta")
        if meta is None:
            meta = {}
        if not isinstance(meta, dict):
            return None, "schema:meta"
        try:
            if len(json.dumps(meta)) > self.max_meta_bytes:
                return None, "size:meta"
        except (TypeError, ValueError):
            return None, "schema:meta-not-json"
        sig = meta.get("sig")
        if sig is not None:
            if not isinstance(sig, list) or \
                    len(sig) > self.max_sig_slots or \
                    not all(isinstance(s, int) and 0 <= s < (1 << 32)
                            for s in sig):
                return None, "schema:sig"
        ssig = meta.get("state_sig")
        if ssig is not None:
            if not isinstance(ssig, list) or \
                    len(ssig) > self.max_sig_slots or \
                    not all(isinstance(p, list) and len(p) == 2
                            and all(isinstance(v, int)
                                    and 0 <= v < (1 << 32) for v in p)
                            for p in ssig):
                return None, "schema:state_sig"
        hits = meta.get("edge_hits")
        if hits is not None:
            if not isinstance(hits, dict) or \
                    len(hits) > self.max_sig_slots:
                return None, "schema:edge_hits"
            try:
                for k, v in hits.items():
                    int(k), int(v)
            except (TypeError, ValueError):
                return None, "schema:edge_hits"
        prov = meta.get("provenance")
        if prov is not None:
            # mutation provenance (learn tier, optional): mutator id,
            # stage, packed mutated-byte bitmap.  Bounded and typed —
            # a peer must not be able to ship a multi-megabyte
            # "bitmap" or a non-string mutator through the learn
            # tier's label path.  Old rows without it pass untouched.
            if not isinstance(prov, dict):
                return None, "schema:provenance"
            if not isinstance(prov.get("mutator"), str) or \
                    len(prov["mutator"]) > 64:
                return None, "schema:provenance"
            stage = prov.get("stage")
            if stage is not None and not (isinstance(stage, str)
                                          and len(stage) <= 64):
                return None, "schema:provenance"
            bm = prov.get("bitmap")
            if bm is not None:
                # packbits over the content: ~len(buf)/6 b64 chars
                if not isinstance(bm, str) or \
                        len(bm) > (len(buf) // 8) * 2 + 16:
                    return None, "schema:provenance"
            nb = prov.get("bytes")
            if nb is not None and not (isinstance(nb, int)
                                       and 0 <= nb <= len(buf)):
                return None, "schema:provenance"
        tier = meta.get("tier")
        if tier is not None:
            # hybrid tier tag (docs/HYBRID.md): a short identifier —
            # a peer must not be able to ship arbitrary blobs through
            # the per-tier fold.  Old rows without it pass untouched.
            if not isinstance(tier, str) or not (0 < len(tier) <= 32) \
                    or not all(c.isalnum() or c in "-_" for c in tier):
                return None, "schema:tier"
        val = meta.get("validation")
        if val is not None:
            # cross-tier verdict write-back (hybrid bridge): verdict
            # from the fixed taxonomy plus bounded numeric fields —
            # the claim "native-confirmed" steers scheduling, so its
            # shape is checked as strictly as provenance.
            if not isinstance(val, dict):
                return None, "schema:validation"
            if val.get("verdict") not in VALIDATION_VERDICTS:
                return None, "schema:validation"
            vtier = val.get("tier")
            if vtier is not None and not (isinstance(vtier, str)
                                          and len(vtier) <= 32):
                return None, "schema:validation"
            for key in ("repro", "repeats", "attempts"):
                v = val.get(key)
                if v is not None and not (isinstance(v, int)
                                          and 0 <= v <= 4096):
                    return None, "schema:validation"
            t = val.get("t")
            if t is not None and not isinstance(t, (int, float)):
                return None, "schema:validation"
            sts = val.get("statuses")
            if sts is not None:
                if not isinstance(sts, list) or \
                        len(sts) > MAX_VALIDATION_REPEATS or \
                        not all(isinstance(s, int) for s in sts):
                    return None, "schema:validation"
            detail = val.get("detail")
            if detail is not None and not (isinstance(detail, str)
                                           and len(detail) <= 256):
                return None, "schema:validation"
            repair = val.get("repair")
            if repair is not None:
                # kb-repair / --auto-repair write-back: verdict from
                # the fixed (honest) taxonomy, bounded strings — a
                # "repaired" claim changes which proxy peers trust,
                # so its shape syncs as strictly as the verdict's
                if not isinstance(repair, dict) or \
                        repair.get("verdict") not in REPAIR_VERDICTS:
                    return None, "schema:repair"
                rt = repair.get("t")
                if rt is not None and not isinstance(rt,
                                                     (int, float)):
                    return None, "schema:repair"
                for key in ("patch", "reason"):
                    v = repair.get(key)
                    if v is not None and not (isinstance(v, str)
                                              and len(v) <= 256):
                        return None, "schema:repair"
        for key in ("selections", "finds", "discovered", "seq"):
            v = meta.get(key)
            if v is not None and not isinstance(v, (int, float)):
                return None, f"schema:{key}"
        for key in ("parent", "source"):
            v = meta.get(key)
            if v is not None and not isinstance(v, str):
                return None, f"schema:{key}"
        # the field the whole exchange dedups by: re-derive and compare
        claimed = row.get("cov_hash", meta.get("cov_hash"))
        if claimed is not None:
            if not isinstance(claimed, str) or len(claimed) > 256:
                return None, "schema:cov_hash"
            if claimed != coverage_hash(sig, buf, ssig):
                return None, "integrity:cov_hash-mismatch"
        if self.executor is not None and sig:
            try:
                got = self.executor(bytes(buf))
            except Exception as e:
                return None, f"reexec-error:{type(e).__name__}"
            if got is not None and \
                    sorted(set(int(s) for s in got)) != \
                    sorted(set(int(s) for s in sig)):
                return None, "integrity:reexec-sig-mismatch"
        entry_meta = dict(meta)
        entry_meta.setdefault("md5", md5 or None)
        if claimed is not None:
            entry_meta["cov_hash"] = claimed
        return CorpusEntry.from_meta(buf, entry_meta), None


class QuarantineStore:
    """On-disk quarantine: rejected entries land in
    ``<root>/quarantine/`` as ``<md5>`` (raw bytes) + ``<md5>.json``
    (reason, peer, wall time) so an operator can inspect what the
    fleet refused — and a bug in the validator itself never silently
    destroys a real finding."""

    def __init__(self, root: str):
        self.root = os.path.join(str(root), QUARANTINE_DIR)
        self._ready = False

    def put(self, buf: bytes, reason: str,
            peer: Optional[str] = None) -> None:
        try:
            if not self._ready:
                ensure_dir(self.root)
                self._ready = True
            digest = md5_hex(buf)
            path = os.path.join(self.root, digest)
            if not os.path.exists(path):
                with open(path, "wb") as f:
                    f.write(buf)
            with open(path + ".json", "w") as f:
                json.dump({"md5": digest, "reason": reason,
                           "peer": peer, "t": time.time()}, f)
        except OSError as e:    # quarantine must never kill the loop
            WARNING_MSG("quarantine write failed: %s", e)

    def load(self):
        """[(md5, reason-record dict)] for tools/tests."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in sorted(names):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.root, name)) as f:
                    out.append((name[:-5], json.load(f)))
            except (OSError, ValueError):
                continue
        return out

    def __len__(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.root)
                       if n.endswith(".json"))
        except OSError:
            return 0


class PeerBans:
    """Strike ledger: ``threshold`` quarantined entries from one peer
    ban it for a decorrelated-backoff interval (next ban length ~
    U[base, 3x previous], capped) — repeat offenders stay out longer,
    and a fleet full of healthy peers never bans in lockstep.  A
    clean pull resets the peer's strike count (transient corruption
    is forgiven; persistent poisoning is not)."""

    def __init__(self, threshold: int = 3, base_s: float = 60.0,
                 cap_s: float = 3600.0,
                 rng: Optional[random.Random] = None,
                 time_fn=time.time):
        self.threshold = int(threshold)
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self._rng = rng or random.Random()
        self._time = time_fn
        #: peer -> consecutive quarantined-entry strikes
        self.strikes: Dict[str, int] = {}
        #: peer -> ban expiry (wall clock)
        self.banned_until: Dict[str, float] = {}
        #: peer -> previous ban length (decorrelated backoff state)
        self._prev_ban: Dict[str, float] = {}
        #: lifetime ban count (the ``peers_banned`` counter delta
        #: source)
        self.total_bans = 0

    def strike(self, peer: str, n: int = 1) -> bool:
        """Record ``n`` quarantined entries from ``peer``; returns
        True when this crossed the threshold and the peer is now
        banned."""
        s = self.strikes.get(peer, 0) + int(n)
        self.strikes[peer] = s
        if s < self.threshold or self.is_banned(peer):
            return False
        prev = self._prev_ban.get(peer, 0.0)
        length = min(self.cap_s,
                     self._rng.uniform(self.base_s,
                                      max(self.base_s, 3.0 * prev)))
        self._prev_ban[peer] = length
        self.banned_until[peer] = self._time() + length
        self.strikes[peer] = 0          # strikes reset per ban epoch
        self.total_bans += 1
        WARNING_MSG("gossip: banning peer %s for %.0fs "
                    "(%d poisoned entries)", peer, length, s)
        return True

    def clean(self, peer: str) -> None:
        """A pull from ``peer`` validated clean: forgive its strikes
        (the ban backoff state keeps its memory)."""
        self.strikes.pop(peer, None)

    def is_banned(self, peer: str) -> bool:
        until = self.banned_until.get(peer)
        if until is None:
            return False
        if self._time() >= until:
            del self.banned_until[peer]
            return False
        return True

    def active(self) -> Dict[str, float]:
        """{peer: seconds remaining} for every live ban."""
        now = self._time()
        return {p: round(u - now, 1)
                for p, u in self.banned_until.items() if u > now}
