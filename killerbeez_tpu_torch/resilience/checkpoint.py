"""Crash-consistent campaign checkpoints — one atomic epoch.

Before this module the campaign's durable state was scattered across
files written at different times: ``campaign.json`` (scheduler +
counters), ``solver.json`` (crack verdicts), ``mutator.state`` /
``instrumentation.state`` (component resume state), plus the
``events.jsonl`` seq implicit in the log tail.  Each write was
individually atomic, but a kill BETWEEN writes left them mutually
inconsistent — e.g. a kill after the corpus persist but before the
solver-cache save forgets crack verdicts the corpus already reflects,
and the next plateau re-solves (or re-injects) them.

``checkpoint.json`` replaces that with one document written in one
``tmp + fsync + rename`` step under a **monotone epoch counter**::

    {"epoch": N, "saved_at": t,
     "campaign":   {...},      # what campaign.json used to hold
     "solver":     {...},      # what solver.json used to hold
     "event_seq":  M,          # events.jsonl high-water at save time
     "components": {"mutator": "...", "instrumentation": "..."}}

A kill at ANY instruction leaves either the previous epoch or the new
one — never a blend.  Two extra defenses, both pinned by the chaos
suite:

  * before each save the current file is hardlinked to
    ``checkpoint.json.prev``, so even a filesystem that tears the
    rename itself (or a chaos ``torn`` fault writing garbage straight
    over the live file) falls back to the last good epoch;
  * ``load`` validates shape + epoch and silently steps back through
    ``.prev`` on any parse failure.

Legacy files remain readable: loaders in ``CorpusStore`` fall back to
``campaign.json`` / ``solver.json`` / ``*.state`` when no checkpoint
exists (a pre-checkpoint campaign resumes fine), and offline tools
keep working against either layout.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from ..utils.logging import WARNING_MSG

CHECKPOINT_FILE = "checkpoint.json"
PREV_SUFFIX = ".prev"

#: current checkpoint document version
VERSION = 1


def _paths(root: str):
    p = os.path.join(root, CHECKPOINT_FILE)
    return p, p + PREV_SUFFIX


def _read_doc(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or "epoch" not in doc:
        return None
    return doc


def load(root: str) -> Optional[Dict[str, Any]]:
    """The newest readable checkpoint: the live file, else the
    ``.prev`` fallback (torn-write healing), else None."""
    live, prev = _paths(root)
    for p in (live, prev):
        doc = _read_doc(p)
        if doc is not None:
            if p == prev:
                WARNING_MSG("checkpoint: %s unreadable; resumed from "
                            "previous epoch %s", live, doc.get("epoch"))
            return doc
    return None


def last_epoch(root: str) -> int:
    doc = load(root)
    return int(doc.get("epoch", 0)) if doc else 0


def save(root: str, doc: Dict[str, Any],
         atomic_write=None) -> Optional[int]:
    """Write one checkpoint epoch atomically; returns the epoch
    number (None when the write failed — persistence degrades to
    warnings, it must never kill a campaign).

    ``atomic_write(path, bytes)`` is injected by the corpus store so
    the chaos harness's ``persist`` point covers this path exactly
    like every other store write."""
    live, prev = _paths(root)
    epoch = int(doc.get("epoch") or 0)
    if epoch <= 0:
        epoch = last_epoch(root) + 1
    doc = dict(doc)
    doc["version"] = doc.get("version", VERSION)
    doc["epoch"] = epoch
    # keep the CURRENT epoch reachable while the new one replaces the
    # live file: hardlink (same directory, so same filesystem); a
    # kill between the link and the rename leaves .prev == live,
    # which load() handles (same doc twice).  Only a live file that
    # PARSES may refresh .prev — linking an unvalidated (torn) live
    # file would destroy the last good epoch, and a kill before the
    # rename would then leave NO readable checkpoint at all
    if _read_doc(live) is not None:
        try:
            tmp_link = prev + ".tmp"
            try:
                os.unlink(tmp_link)
            except OSError:
                pass
            os.link(live, tmp_link)
            os.replace(tmp_link, prev)
        except OSError:
            pass                        # no .prev safety net this epoch
    if atomic_write is None:
        atomic_write = _default_atomic_write
    try:
        atomic_write(live, json.dumps(doc).encode())
    except OSError as e:
        WARNING_MSG("checkpoint write failed (epoch %d): %s", epoch, e)
        return None
    return epoch


def _default_atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
