"""kb-corpus — inspect and minimize a persistent corpus store.

Operator-side companion to ``--corpus-dir`` (corpus/store.py): list
entries with their bandit stats and lineage, summarize coverage, and
compact the store offline.  Wires the existing side tools together:
signatures for unsigned entries come from one showmap-style execution
per entry (tools/showmap.py), compaction is the greedy edge cover the
minimize tool and the manager's ``/api/minimize`` already use, and
``stats --states`` folds serialized instrumentation states through
the merger (tools/merger.py) to report fleet coverage next to the
store's.  Run as ``python -m killerbeez_tpu_torch.tools.corpus_tool``
(``kb-corpus`` below); ``--sign`` and ``--states`` run on the card
unless ``--device cpu`` asks for the plain versions.

    kb-corpus ls out/corpus
    kb-corpus heat out/corpus --top 4
    kb-corpus stats out/corpus --states node0.state node1.state -I afl
    kb-corpus compact out/corpus --dry-run
    kb-corpus compact out/corpus --sign file afl \\
        -d '{"path": "corpus/build/test", "arguments": "@@"}'
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

from ..corpus.store import CorpusEntry, CorpusStore
from ..tools.minimize import greedy_edge_cover
from ..utils.logging import INFO_MSG, setup_logging


def _fmt_age(seconds: float) -> str:
    for unit, div in (("d", 86400), ("h", 3600), ("m", 60)):
        if seconds >= div:
            return f"{seconds / div:.1f}{unit}"
    return f"{seconds:.0f}s"


def render_ls(entries: List[CorpusEntry]) -> str:
    lines = [f"{'md5':<32}  {'size':>6}  {'edges':>5}  {'states':>6}  "
             f"{'sel':>6}  {'finds':>6}  {'src':<5}  {'age':>6}  "
             f"parent"]
    now = time.time()
    for e in entries:
        n_states = (len({p[0] for p in e.state_sig})
                    if e.state_sig else None)
        lines.append(
            f"{e.md5:<32}  {len(e.buf):>6}  "
            f"{len(e.sig) if e.sig else '-':>5}  "
            f"{n_states if n_states is not None else '-':>6}  "
            f"{e.selections:>6.2f}  {e.finds:>6.2f}  "
            f"{e.source:<5}  {_fmt_age(max(now - e.discovered, 0)):>6}"
            f"  {e.parent or '-'}")
    return "\n".join(lines)


def render_stats(entries: List[CorpusEntry],
                 merged_coverage: Optional[int] = None) -> str:
    signed = [e for e in entries if e.sig]
    edges: Dict[int, int] = {}
    for e in signed:
        for s in e.sig:
            edges[s] = edges.get(s, 0) + 1
    lines = [
        f"entries        : {len(entries)} "
        f"({len(signed)} signed, {len(entries) - len(signed)} unsigned)",
        f"total bytes    : {sum(len(e.buf) for e in entries)}",
        f"distinct edges : {len(edges)}",
    ]
    if edges:
        rare = sorted(edges.items(), key=lambda kv: (kv[1], kv[0]))[:5]
        lines.append("rarest edges   : " + ", ".join(
            f"{s} (hit by {n})" for s, n in rare))
    # stateful session tier: the corpus-wide state x edge frontier
    # (entries carry their state_sig sidecars from the session
    # signer; kb-corpus is the offline view of the state_cov gauges)
    st_entries = [e for e in entries if e.state_sig]
    if st_entries:
        pairs = {tuple(p) for e in st_entries for p in e.state_sig}
        per_state: Dict[int, int] = {}
        for s, _slot in pairs:
            per_state[s] = per_state.get(s, 0) + 1
        lines.append(
            f"state coverage : {len(per_state)} protocol states, "
            f"{len(pairs)} state x edge pairs across "
            f"{len(st_entries)} session entries ("
            + ", ".join(f"s{s}:{n}" for s, n in
                        sorted(per_state.items())) + ")")
    # mutation-provenance summary (learn tier): do this campaign's
    # sidecars carry enough byte-diff labels to train on?
    labeled = [e for e in entries
               if isinstance(getattr(e, "provenance", None), dict)]
    if entries:
        line = (f"provenance     : {len(labeled)} labeled / "
                f"{len(entries) - len(labeled)} unlabeled entries "
                f"(byte-diff training labels)")
        if labeled:
            from ..learn.dataset import provenance_positions
            hist: Dict[int, int] = {}
            for e in labeled:
                pos = provenance_positions(e.provenance, len(e.buf))
                if pos is None:
                    continue
                for p in pos.tolist():
                    hist[p] = hist.get(p, 0) + 1
            if hist:
                top = sorted(hist.items(),
                             key=lambda kv: (-kv[1], kv[0]))[:5]
                line += "; top mutated positions: " + ", ".join(
                    f"{p} (x{n})" for p, n in top)
        lines.append(line)
    by_src: Dict[str, int] = {}
    for e in entries:
        by_src[e.source] = by_src.get(e.source, 0) + 1
    lines.append("sources        : " + ", ".join(
        f"{k} {v}" for k, v in sorted(by_src.items())))
    top = sorted(entries, key=lambda e: -e.finds)[:5]
    if top and top[0].finds > 0:
        lines.append("top finders    : " + ", ".join(
            f"{e.md5[:8]} ({e.finds:.2f})" for e in top
            if e.finds > 0))
    if merged_coverage is not None:
        lines.append(f"state coverage : {merged_coverage} virgin "
                     "bytes touched (merged instrumentation states)")
    return "\n".join(lines)


def make_showmap_signer(driver_name: str, instr_name: str,
                        driver_opts: Optional[str],
                        instr_opts: Optional[str], device="cuda"):
    """One showmap-style execution per entry: build the driver +
    instrumentation pair once on ``device`` (edges forced on, exactly
    like the showmap tool) and return ``bytes -> [edge slot, ...]``."""
    from ..drivers.factory import driver_factory
    from ..instrumentation.factory import instrumentation_factory
    from .tracer import force_edges_option

    instr = instrumentation_factory(instr_name,
                                    force_edges_option(instr_opts),
                                    device=device)
    driver = driver_factory(driver_name, driver_opts, instr, None,
                            device=device)

    def sign(buf: bytes) -> Optional[List[int]]:
        driver.test_input(buf)
        edges = instr.get_edges()
        return [e for e, _ in edges] if edges else None

    return sign


def compact(store: CorpusStore, entries: List[CorpusEntry],
            signer=None, dry_run: bool = False) -> List[str]:
    """Drop entries whose edges are fully covered by the rest of the
    store (greedy edge cover — the minimize tool's algorithm).
    Unsigned entries are kept — redundancy can't be proven without a
    signature (pass --sign to compute them).  Returns the removed
    md5s."""
    if signer is not None:
        from ..corpus.store import coverage_hash
        for e in entries:
            if e.sig is None:
                sig = signer(e.buf)
                if sig:
                    e.sig = sorted(set(sig))
                    e.cov_hash = coverage_hash(e.sig, e.buf,
                                               e.state_sig)
                    if not dry_run:
                        store.update_meta(e)
    signed = {e.md5: set(e.sig) for e in entries if e.sig}
    kept = set(greedy_edge_cover(signed))
    removed = [md5 for md5 in signed if md5 not in kept]
    if not dry_run:
        for md5 in removed:
            store.remove(md5)
    return removed


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="kb-corpus",
        description="inspect / summarize / compact a persistent "
                    "corpus store (--corpus-dir)")
    p.add_argument("command", choices=["ls", "stats", "compact",
                                       "heat"])
    p.add_argument("store", help="corpus store directory")
    p.add_argument("--sign", nargs=2, metavar=("DRIVER", "INSTR"),
                   help="sign unsigned entries with one execution "
                        "each through this driver/instrumentation "
                        "pair (showmap semantics, edges forced on)")
    p.add_argument("-d", "--driver-options", help="driver JSON options")
    p.add_argument("-i", "--instrumentation-options",
                   help="instrumentation JSON options for --sign")
    p.add_argument("-I", "--instrumentation",
                   help="instrumentation name for --states merging")
    p.add_argument("--states", nargs="+",
                   help="serialized instrumentation states to fold "
                        "through the merger and report coverage for "
                        "(stats)")
    p.add_argument("--dry-run", action="store_true",
                   help="compact: report what would be removed, "
                        "remove nothing")
    p.add_argument("--entry", metavar="MD5",
                   help="heat: one parent's panel (md5 prefix ok) "
                        "instead of the hottest parents")
    p.add_argument("--top", type=int, default=4,
                   help="heat: how many parent panels (default 4)")
    p.add_argument("--hex-width", type=int, default=16,
                   help="heat: bytes per hex-dump row (default 16)")
    p.add_argument("--no-color", action="store_true",
                   help="heat: character ramp instead of ANSI")
    p.add_argument("--base", metavar="FILE",
                   help="heat: the campaign's base seed file, so "
                        "first-generation lineage (parent 'base') "
                        "renders too")
    p.add_argument("--device", default="cuda",
                   help='--sign / --states: "cuda" (default: the card) '
                        'or "cpu" (the plain PyTorch versions)')
    p.add_argument("-l", "--logging-options", help="logging JSON options")
    args = p.parse_args(argv)
    try:
        setup_logging(args.logging_options)
        store = CorpusStore(args.store)
        entries = store.load()
        if args.command == "ls":
            print(render_ls(entries))
            return 0
        if args.command == "heat":
            # FMViz-style per-byte mutation heat from the lineage's
            # provenance bitmaps (tools/heat.py)
            from .heat import render_store_heat
            base = None
            if args.base:
                with open(args.base, "rb") as f:
                    base = f.read()
            print(render_store_heat(
                entries, top=args.top, width=args.hex_width,
                color=not args.no_color, only_md5=args.entry,
                base=base))
            return 0
        if args.command == "stats":
            merged_cov = None
            if args.states:
                if not args.instrumentation:
                    print("error: --states needs -I/--instrumentation",
                          file=sys.stderr)
                    return 2
                from ..instrumentation.factory import (
                    instrumentation_factory,
                )
                from .merger import merge_state_files
                merged = merge_state_files(
                    args.instrumentation,
                    args.instrumentation_options, args.states,
                    args.device)
                probe = instrumentation_factory(
                    args.instrumentation,
                    args.instrumentation_options, device=args.device)
                probe.set_state(merged)
                cov_fn = getattr(probe, "coverage_bytes", None)
                merged_cov = cov_fn() if cov_fn else None
                probe.cleanup()
            print(render_stats(entries, merged_cov))
            return 0
        signer = None
        if args.sign:
            signer = make_showmap_signer(
                args.sign[0], args.sign[1], args.driver_options,
                args.instrumentation_options, args.device)
        removed = compact(store, entries, signer=signer,
                          dry_run=args.dry_run)
        verb = "would remove" if args.dry_run else "removed"
        INFO_MSG("compact: %s %d of %d entries (edges covered by "
                 "the rest)", verb, len(removed), len(entries))
        for md5 in removed:
            print(md5)
        return 0
    except (ValueError, FileNotFoundError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
