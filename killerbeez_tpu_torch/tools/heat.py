"""Per-byte mutation-heat rendering (FMViz-style) from the corpus
store's mutation-provenance sidecars.

Every admitted entry records WHICH child byte positions its mutation
rewrote (the learn tier's provenance bitmap, corpus/store.py).
Folding those bitmaps back onto each PARENT's buffer yields a
per-byte heat count: how many admitted, edge-novel children came
from mutating that byte.  Rendered over a hex dump it is the classic
FMViz picture — hot bytes are where the format yields, cold runs are
the magic words, length fields and framing the campaign never
profited from touching (exactly the bytes a grammar pin protects;
docs/GRAMMAR.md).

Shared by ``kb-corpus heat`` (store-wide, per-parent panels) and
``kb-timeline --heat`` (the campaign output dir's ``corpus/`` store
next to the flight recorder's time axis).  Pure stdlib + numpy; the
ANSI ramp degrades to a character ramp under ``color=False``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

#: character ramp for the no-color heat line (cold -> hot)
RAMP = " .:-=+*#%@"

#: ANSI SGR per heat bucket (cold -> hot): dim, green, yellow, red
_COLORS = ("2", "32", "33", "31")


class _BaseEntry:
    """Pseudo-entry for the campaign's base seed (lineage root
    ``parent == "base"`` — not itself a store entry)."""

    def __init__(self, buf: bytes):
        self.md5 = "base"
        self.buf = bytes(buf)


def accumulate_heat(entries, base: Optional[bytes] = None
                    ) -> List[Tuple[object, np.ndarray, int]]:
    """Fold every child's provenance bitmap onto its parent buffer.

    ``entries`` are CorpusEntry-likes (md5 / buf / parent /
    provenance attrs); ``base`` optionally supplies the campaign's
    base seed bytes so first-generation children (lineage root
    ``"base"``) render too.  Returns ``[(parent_entry, counts,
    children), ...]`` sorted hottest-first, where ``counts`` is
    int64[len(parent.buf)] admitted-children-per-position and
    ``children`` is how many labeled children contributed.  Parents
    that cannot be resolved to bytes (evicted entries, ``base``
    without the seed) are skipped; children without provenance (pre-
    learn sidecars) contribute nothing, by design."""
    from ..learn.dataset import provenance_positions

    by_md5 = {e.md5: e for e in entries}
    if base:
        by_md5.setdefault("base", _BaseEntry(base))
    counts: Dict[str, np.ndarray] = {}
    kids: Dict[str, int] = {}
    for e in entries:
        prov = getattr(e, "provenance", None)
        if not isinstance(prov, dict):
            continue
        parent = by_md5.get(getattr(e, "parent", None) or "base")
        if parent is None or not parent.buf:
            continue
        pos = provenance_positions(prov, len(e.buf))
        if pos is None or pos.size == 0:
            continue
        acc = counts.setdefault(
            parent.md5, np.zeros(len(parent.buf), np.int64))
        # positions index the CHILD; heat lands on the parent bytes
        # that were rewritten (clip to the parent's length)
        inb = pos[pos < acc.size]
        if inb.size == 0:
            continue
        acc[inb] += 1
        kids[parent.md5] = kids.get(parent.md5, 0) + 1
    out = [(by_md5[m], c, kids.get(m, 0)) for m, c in counts.items()]
    out.sort(key=lambda t: (-int(t[1].sum()), t[0].md5))
    return out


def _bucket(count: int, peak: int) -> int:
    """0..len(_COLORS)-1 heat bucket (0 = never mutated)."""
    if count <= 0 or peak <= 0:
        return 0
    return 1 + min(int(3 * (count - 1) / max(peak, 1)),
                   len(_COLORS) - 2)


def render_heat(buf: bytes, counts: np.ndarray, width: int = 16,
                color: bool = True) -> str:
    """One parent's heat panel: a hex dump with each byte shaded by
    its admitted-mutation count (ANSI ramp), or — with ``color``
    off — a character-ramp line under each hex row."""
    buf = bytes(buf)
    counts = np.asarray(counts, np.int64)
    peak = int(counts.max()) if counts.size else 0
    lines = []
    for off in range(0, len(buf), width):
        row = buf[off:off + width]
        hexes, chars, heats = [], [], []
        for j, b in enumerate(row):
            c = int(counts[off + j]) if off + j < counts.size else 0
            h = f"{b:02x}"
            if color:
                h = f"\x1b[{_COLORS[_bucket(c, peak)]}m{h}\x1b[0m"
            hexes.append(h)
            chars.append(chr(b) if 32 <= b < 127 else ".")
            heats.append(RAMP[min(int(9 * c / peak) if peak else 0,
                                  9)] * 2)
        pad = "   " * (width - len(row))
        lines.append(f"{off:08x}  {' '.join(hexes)}{pad}  "
                     f"|{''.join(chars)}|")
        if not color:
            lines.append(f"{'':8}  {' '.join(heats)}")
    return "\n".join(lines)


def render_store_heat(entries, top: int = 4, width: int = 16,
                      color: bool = True,
                      only_md5: Optional[str] = None,
                      base: Optional[bytes] = None) -> str:
    """The store-wide view: the ``top`` hottest parents' panels (or
    one specific parent via ``only_md5``), each headed by its
    lineage stats, plus a legend."""
    panels = accumulate_heat(entries, base=base)
    if only_md5:
        panels = [p for p in panels
                  if p[0].md5.startswith(only_md5)]
        if not panels:
            return (f"no mutation provenance accumulated on parent "
                    f"{only_md5!r} (children carry the bitmaps; the "
                    f"parent must still be in the store)")
    if not panels:
        return ("no renderable mutation provenance — run a campaign "
                "with the learn tier's sidecars to collect heat, "
                "and pass the base seed (--base) when the lineage "
                "still roots at it")
    lines = []
    for e, counts, children in panels[:max(top, 1)]:
        hot = int(np.argmax(counts)) if counts.size else 0
        lines.append(
            f"parent {e.md5}  ({len(e.buf)} bytes, {children} "
            f"admitted children, hottest byte {hot} "
            f"x{int(counts[hot]) if counts.size else 0})")
        lines.append(render_heat(e.buf, counts, width=width,
                                 color=color))
        lines.append("")
    legend = ("legend: " + ("dim/green/yellow/red = never/cool/warm/"
                            "hot" if color else
                            f"ramp '{RAMP}' cold -> hot"))
    lines.append(legend)
    return "\n".join(lines)


def heat_report(entries, top: int = 4,
                base: Optional[bytes] = None) -> List[Dict]:
    """JSON-able per-parent heat summary (kb-timeline --json)."""
    out = []
    for e, counts, children in accumulate_heat(entries,
                                               base=base)[:top]:
        nz = np.flatnonzero(counts)
        out.append({
            "parent": e.md5, "bytes": len(e.buf),
            "children": int(children),
            "mutated_positions": int(nz.size),
            "peak": int(counts.max()) if counts.size else 0,
            "counts": counts.tolist(),
        })
    return out
