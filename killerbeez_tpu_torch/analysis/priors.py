"""Static per-position value priors from VSA (consumer (c) of
``analysis/vsa.py``) — the ``kbz-value-prior-v1`` sidecar.

ROADMAP item 4's value-conditioned model ("Not all bytes are equal",
arxiv 1711.04596) predicts which VALUES a position should take, not
just which positions matter.  Training starts from zero today; this
module ships the static initialization surface — a histogram per
input-byte position derived before a single exec:

* every affine guard inversion contributes its satisfying byte
  values, weighted by how many distinct guards select them (a value
  three compares agree on outweighs a value one compare admits);
* the residual probability mass sits on the position's VSA domain
  interval (``lo``/``hi``/``stride``), so sampling can fall back to
  the interval when the explicit histogram misses;
* positions VSA says nothing about are absent — the model treats
  them as uniform, exactly like an untrained prior.

The sidecar is plain JSON keyed by ``program_sig``, so a consumer
can reject a stale prior the same way the corpus store rejects a
stale VSA doc.  The model that consumes these lands later (ROADMAP
item 4); nothing in the fuzzing loop reads them yet.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

from .vsa import VsaResult, analyze_vsa, affine_sat_set

PRIOR_SCHEMA = "kbz-value-prior-v1"


def value_priors(program, vsa: Optional[VsaResult] = None,
                 target: str = "") -> Dict:
    """Build the ``kbz-value-prior-v1`` document for ``program``.

    Returns ``{"schema", "target", "program_sig", "positions"}``
    where ``positions`` maps the stringified byte index to::

        {"values": [v, ...],     # explicit histogram support
         "weights": [w, ...],    # guard-agreement counts, same order
         "interval": [lo, hi],   # VSA domain hull for the position
         "stride": s}

    Deterministic: values sorted ascending, positions sorted
    numerically (JSON keys as strings for sidecar friendliness).
    """
    from ..models.vm import CMP_EQ
    if vsa is None:
        vsa = analyze_vsa(program)

    hist: Dict[int, Dict[int, int]] = {}
    for f in vsa.branches:
        for aff, other in ((f.x_affine, f.y_dom),
                           (f.y_affine, f.x_dom)):
            if aff is None or other.const_val is None:
                continue
            if f.cmp not in ("eq", "ne"):
                continue
            sat = affine_sat_set(aff, CMP_EQ, other.const_val, True)
            if not sat or len(sat) > 16:
                continue
            h = hist.setdefault(aff[0], {})
            for v in sat:
                h[v] = h.get(v, 0) + 1

    positions: Dict[str, Dict] = {}
    seen = set(hist) | set(vsa.byte_domains)
    for i in sorted(seen):
        dom = vsa.byte_domains.get(i)
        h = hist.get(i, {})
        vals = sorted(h)
        entry: Dict = {
            "values": vals,
            "weights": [h[v] for v in vals],
            "interval": [dom.lo, dom.hi] if dom is not None
            else [0, 255],
            "stride": dom.stride if dom is not None else 1,
        }
        # a domain small enough to enumerate IS a histogram — merge
        # its members at weight 1 so interval-only positions still
        # carry explicit support
        if dom is not None and not vals:
            ev = dom.enum(16)
            if ev:
                entry["values"] = sorted(v for v in ev
                                         if 0 <= v <= 255)
                entry["weights"] = [1] * len(entry["values"])
        positions[str(i)] = entry

    return {
        "schema": PRIOR_SCHEMA,
        "target": target,
        "program_sig": vsa.program_sig,
        "positions": positions,
    }


def save_priors(path, doc: Dict) -> None:
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")


def load_priors(path, program=None) -> Optional[Dict]:
    """Read a prior sidecar; ``None`` on schema mismatch, or on
    ``program_sig`` mismatch when ``program`` is given (stale prior
    for a different build of the target)."""
    from .vsa import program_sig
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != PRIOR_SCHEMA:
        return None
    if program is not None and doc.get("program_sig") != \
            program_sig(program):
        return None
    return doc
