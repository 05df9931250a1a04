"""Lineage -> labeled training data for the byte-saliency model.

The corpus store already records WHO produced every admitted entry
(the ``parent`` sidecar field); this module adds WHAT was mutated —
a mutated-byte bitmap (child vs parent diff) recorded at admission
time as the ``provenance`` sidecar field — and turns the accumulated
lineage into (parent bytes, position, label) samples:

  * **positives** — parent positions whose mutation produced an
    admitted edge-novel child (the provenance bitmap, one sample per
    set bit);
  * **negatives** — parent positions whose mutation produced nothing
    the campaign kept: the loop feeds the diff of REJECTED
    interesting lanes (bucket-only new paths that did not admit)
    through ``add_negative``, and ``add_background`` samples parent
    positions no admitted child ever touched.

Samples live in a bounded FIFO buffer (oldest evicted) keyed by
parent md5 so one parent buffer is stored once no matter how many
children it labels.  ``samples_from_entries`` rebuilds positives
from persisted provenance sidecars on ``--resume`` — old sidecars
without the field simply contribute nothing (the learn tier skips
them, by design).

Provenance sidecar schema (optional, docs/LEARN.md)::

    {"mutator": "havoc", "stage": "havoc" | null,
     "bitmap": <base64 packbits over child length>, "bytes": N}
"""

from __future__ import annotations

import base64
import binascii
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

#: hard cap on positions one admission may contribute (a havoc block
#: op can rewrite half the buffer — unbounded, one admission would
#: flood the buffer with near-duplicate samples)
MAX_POSITIONS_PER_SAMPLE = 32


def diff_bitmap(parent: bytes, child: bytes,
                max_len: int = 0) -> np.ndarray:
    """uint8[len(child)] bitmap of the mutated CHILD positions:
    1 where the child byte differs from the parent's (positions past
    the common length — inserted/garbage tail bytes — count as
    mutated).  ``max_len`` truncates (0 = no cap)."""
    c = np.frombuffer(bytes(child), dtype=np.uint8)
    p = np.frombuffer(bytes(parent), dtype=np.uint8)
    if max_len:
        c = c[:max_len]
        p = p[:max_len]
    n = len(c)
    out = np.ones(n, dtype=np.uint8)
    m = min(n, len(p))
    out[:m] = (c[:m] != p[:m]).astype(np.uint8)
    return out


def bitmap_to_b64(bitmap: np.ndarray) -> str:
    return base64.b64encode(
        np.packbits(np.asarray(bitmap, np.uint8) != 0).tobytes()
    ).decode()


def b64_to_bitmap(s: str, n: int) -> Optional[np.ndarray]:
    """Decode a packed bitmap back to uint8[n]; None on garbage (a
    torn or hostile sidecar must never raise into the loop)."""
    try:
        raw = base64.b64decode(s, validate=True)
    except (binascii.Error, ValueError, TypeError):
        return None
    bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8))
    if len(bits) < n:
        return None
    return bits[:n].astype(np.uint8)


def make_provenance(parent: bytes, child: bytes, mutator: str,
                    stage: Optional[str] = None) -> Dict[str, Any]:
    """The admission-time provenance record: mutator id, stage, and
    the child-vs-parent mutated-byte bitmap."""
    bm = diff_bitmap(parent, child)
    return {"mutator": str(mutator),
            "stage": (str(stage) if stage is not None else None),
            "bitmap": bitmap_to_b64(bm),
            "bytes": int(bm.sum())}


def provenance_positions(prov: Dict[str, Any],
                         n: int) -> Optional[np.ndarray]:
    """Mutated positions from one provenance record (clipped to
    ``n``); None when the record is absent/garbage."""
    if not isinstance(prov, dict):
        return None
    bm = b64_to_bitmap(prov.get("bitmap", ""), n) \
        if isinstance(prov.get("bitmap"), str) else None
    if bm is None:
        return None
    return np.flatnonzero(bm)


class LabelBuffer:
    """Bounded (parent, position, label) sample store.

    Parent buffers are interned by md5 (one copy regardless of how
    many samples reference them); samples evict FIFO at ``cap``.
    ``make_batch`` materializes a training batch as padded arrays
    for ``model.batch_features``."""

    def __init__(self, cap: int = 8192, max_len: int = 4096,
                 seed: int = 0x5eed):
        self.cap = int(cap)
        self.max_len = int(max_len)
        self._bufs: Dict[str, np.ndarray] = {}
        self._lens: Dict[str, int] = {}
        #: (parent_key, position, label)
        self._samples: deque = deque()
        self._rng = np.random.default_rng(seed)
        self.positives = 0
        self.negatives = 0
        #: MONOTONE intake counter (never decremented by eviction) —
        #: the "new labels arrived" signal.  len(self) pins at cap
        #: once the FIFO saturates, so a length comparison would
        #: stall training forever on a long campaign.
        self.total_added = 0

    def __len__(self) -> int:
        return len(self._samples)

    def _intern(self, key: str, buf: bytes) -> Optional[str]:
        if key in self._bufs:
            return key
        raw = np.frombuffer(bytes(buf)[:self.max_len], dtype=np.uint8)
        if raw.size == 0:
            return None
        self._bufs[key] = raw
        self._lens[key] = raw.size
        return key

    def _evict(self) -> None:
        while len(self._samples) > self.cap:
            key, _pos, label = self._samples.popleft()
            if label:
                self.positives -= 1
            else:
                self.negatives -= 1
        # drop interned buffers no remaining sample references
        # (cheap: only when the intern table outgrew the samples)
        if len(self._bufs) > len(self._samples) + 8:
            live = {k for k, _p, _l in self._samples}
            for k in list(self._bufs):
                if k not in live:
                    del self._bufs[k], self._lens[k]

    def add(self, key: str, buf: bytes, positions, label: int,
            cap: int = MAX_POSITIONS_PER_SAMPLE) -> int:
        """Add samples for ``positions`` of one parent buffer (the
        per-admission position cap samples down deterministically via
        the buffer's own RNG).  Returns how many were added."""
        key = self._intern(key, buf)
        if key is None:
            return 0
        n = self._lens[key]
        pos = np.asarray([p for p in np.asarray(positions).ravel()
                          if 0 <= int(p) < n], dtype=np.int64)
        if pos.size == 0:
            return 0
        if pos.size > cap:
            pos = self._rng.choice(pos, size=cap, replace=False)
        for p in pos:
            self._samples.append((key, int(p), int(bool(label))))
        if label:
            self.positives += int(pos.size)
        else:
            self.negatives += int(pos.size)
        self.total_added += int(pos.size)
        self._evict()
        return int(pos.size)

    def add_background(self, key: str, buf: bytes, bitmap,
                       n: int = 8) -> int:
        """Sample ``n`` never-mutated parent positions as weak
        negatives (the complement of an admission's bitmap) — keeps
        the classes from degenerating when the loop sees few
        explicit rejects."""
        bm = np.asarray(bitmap, np.uint8)
        zeros = np.flatnonzero(bm == 0)
        if zeros.size == 0:
            return 0
        take = min(n, zeros.size)
        picks = self._rng.choice(zeros, size=take, replace=False)
        return self.add(key, buf, picks, 0, cap=take)

    def make_batch(self, n: int
                   ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                       np.ndarray, np.ndarray]]:
        """(bufs uint8[N, L], lens int32[N], positions int32[N],
        labels float32[N]) — N random samples padded to one static
        width; None while the buffer is empty."""
        if not self._samples:
            return None
        idx = self._rng.integers(0, len(self._samples), size=int(n))
        samples = [self._samples[int(i)] for i in idx]
        L = max(self._lens[k] for k, _p, _l in samples)
        L = max(((L + 7) // 8) * 8, 8)
        bufs = np.zeros((len(samples), L), np.uint8)
        lens = np.zeros(len(samples), np.int32)
        poss = np.zeros(len(samples), np.int32)
        ys = np.zeros(len(samples), np.float32)
        for i, (k, p, label) in enumerate(samples):
            raw = self._bufs[k]
            bufs[i, :raw.size] = raw
            lens[i] = raw.size
            poss[i] = p
            ys[i] = float(label)
        return bufs, lens, poss, ys


def samples_from_entries(buffer: LabelBuffer, entries, parent_bytes,
                         informative_diff: int =
                         MAX_POSITIONS_PER_SAMPLE) -> int:
    """Rebuild positive (and background-negative) samples from
    persisted provenance sidecars — the ``--resume`` path.  ``entries``
    are CorpusEntry-likes (md5 / buf / parent / provenance attrs);
    ``parent_bytes(md5_or_base) -> bytes|None`` resolves parents.
    Entries without provenance (pre-learn sidecars) are skipped, and
    so are diffs wider than ``informative_diff`` — the caller passes
    the tier's live threshold so a resumed campaign trains on
    exactly the samples the uninterrupted one would have.  Returns
    the number of labeled entries consumed."""
    used = 0
    for e in entries:
        prov = getattr(e, "provenance", None)
        if not isinstance(prov, dict):
            continue
        parent = parent_bytes(getattr(e, "parent", None) or "base")
        if not parent:
            continue
        pos = provenance_positions(prov, len(e.buf))
        if pos is None or pos.size == 0 or \
                pos.size > informative_diff:
            # large diffs carry ~no positional signal (the tier's
            # informative-diff rule, applied on replay too)
            continue
        # positions index the CHILD; label the PARENT positions that
        # were rewritten (clip to the parent's length)
        key = getattr(e, "parent", None) or "base"
        added = buffer.add(key, parent, pos, 1)
        if added:
            used += 1
            bm = np.zeros(min(len(parent), buffer.max_len), np.uint8)
            inb = pos[pos < bm.size]
            bm[inb] = 1
            buffer.add_background(key, parent, bm)
    return used
