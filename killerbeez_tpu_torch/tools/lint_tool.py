"""kb-lint — static analysis lint over KBVM programs.

Runs the analysis subsystem (``killerbeez_tpu_torch/analysis/``) over
built-in targets and/or compiled ``.npz`` programs and reports
defects: unreachable blocks, AFL map-slot collisions, duplicate
coverage ids, empty modules, ``max_steps`` shortfalls, statically
dead and must-crash blocks.  Exit code 1 when any error-severity
finding exists (the CI lint lane gates on this), else 0.  Run as
``python -m killerbeez_tpu_torch.tools.lint_tool`` (``kb-lint`` below).
``--gaps-dir`` adds the conformance checks over a hybrid campaign's
``proxy_gaps/`` directory (alone, it lints only those).

Usage:
    kb-lint                       # all built-in targets
    kb-lint tlvstack_vm test      # specific targets
    kb-lint --program-file p.npz  # a compiled program
    kb-lint --json                # machine-readable report
    kb-lint --dict tlvstack_vm    # print the auto-dictionary too
    kb-lint --vsa                 # + value-set checks (infeasible-
                                  # edge, value-range-contradiction,
                                  # guaranteed-oob-store)
    kb-lint --gaps-dir out/proxy_gaps --sarif
                                  # conformance checks (proxy-gap-
                                  # backlog, conformance-drift)
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from ..analysis import (
    analyze_dataflow, build_cfg, extract_dictionary, lint_program,
)
from ..analysis.lint import SEV_ERROR, SEV_WARNING, universe_stats


def _target_location(name) -> Dict:
    """Repo-relative source location of a built-in target's builder —
    GitHub's SARIF ingestion renders results only through a
    physicalLocation, so findings anchor on the target definition."""
    import inspect
    import os
    from ..models import targets
    try:
        fn = targets._REGISTRY[name]
        path = inspect.getsourcefile(fn)
        _, line = inspect.getsourcelines(fn)
        return {"uri": os.path.relpath(path).replace(os.sep, "/"),
                "line": int(line)}
    except (KeyError, OSError, TypeError, ValueError):
        return {"uri": f"kbvm/{name}", "line": 1}


def _load_programs(args) -> List:
    """[(program, sarif location)] for every requested target."""
    # import both registries: targets_cgc registers on import
    from ..models import targets, targets_cgc  # noqa: F401
    import os

    names = list(args.targets)
    if args.all_targets or (not names and not args.program_file
                            and not args.gaps_dir):
        names = targets.target_names()
    progs = []
    for name in names:
        progs.append((targets.get_target(name),
                      _target_location(name)))
    for path in args.program_file or []:
        progs.append((targets.load_program_from_options(
            {"program_file": path}, "program_file missing"),
            {"uri": os.path.relpath(path).replace(os.sep, "/"),
             "line": 1}))
    return progs


def lint_report(program, want_dict: bool = False,
                want_vsa: bool = False) -> Dict:
    """One target's full report (the --json per-target payload).
    Stateful targets (registered in models.targets_stateful) get the
    session-tier checks automatically: state-unreachable /
    state-clip warnings and the dead-block -> session-only-block
    downgrade.  ``want_vsa`` runs the value-set fixpoint, enables
    the infeasible-edge / value-range-contradiction /
    guaranteed-oob-store checks, and adds a ``vsa`` stats section
    mirroring ``stats``; off (the default) the report is
    bit-identical to the pre-VSA tool."""
    from ..models.targets_stateful import get_stateful_spec
    cfg = build_cfg(program)
    df = analyze_dataflow(program)
    vsa = None
    if want_vsa:
        from ..analysis.vsa import analyze_vsa
        vsa = analyze_vsa(program)
    findings = lint_program(program, cfg, df,
                            stateful=get_stateful_spec(program.name),
                            vsa=vsa)
    rep = {
        "stats": universe_stats(program, cfg),
        "findings": [f.as_dict() for f in findings],
        "errors": sum(f.severity == SEV_ERROR for f in findings),
        "warnings": sum(f.severity == SEV_WARNING for f in findings),
    }
    if vsa is not None:
        from ..analysis.vsa import vsa_stats
        rep["vsa"] = vsa_stats(vsa)
    if want_dict:
        rep["dictionary"] = [t.decode("latin-1")
                             for t in extract_dictionary(program, df)]
    return rep


def conformance_reports(gaps_dir: str, threshold: int
                        ) -> Dict[str, Dict]:
    """Conformance findings as per-BINDING pseudo-reports, so each
    SARIF result anchors a physicalLocation on that binding's proxy
    program source line (the same gap the original checks closed) —
    key ``conformance:<binding>`` -> {report, sarif location}."""
    from ..analysis.conformance import conformance_lint
    from ..hybrid.registry import get_binding

    findings = conformance_lint(gaps_dir, threshold)
    by_binding: Dict[str, List] = {}
    for f in findings:
        by_binding.setdefault(
            f.data.get("binding") or "?", []).append(f)
    out: Dict[str, Dict] = {}
    for binding, fs in sorted(by_binding.items()):
        loc = {"uri": f"kbvm/{binding}", "line": 1}
        try:
            loc = _target_location(
                get_binding(binding).proxy_target)
        except Exception:
            pass                    # unknown binding: logical anchor
        out[f"conformance:{binding}"] = {
            "report": {
                "findings": [f.as_dict() for f in fs],
                "errors": sum(f.severity == SEV_ERROR for f in fs),
                "warnings": sum(f.severity == SEV_WARNING
                                for f in fs),
            },
            "location": loc,
        }
    return out


_SARIF_LEVELS = {"error": "error", "warning": "warning", "info": "note"}


def sarif_report(reports: Dict,
                 locations: Optional[Dict[str, Dict]] = None) -> Dict:
    """SARIF 2.1.0 document over per-target reports — one rule per
    check id, one result per finding.  Each result carries BOTH a
    logical location addressing ``<target>:pc<N>`` (KBVM programs
    have no per-pc source) and a physical location anchored on the
    target's builder source (``locations``: report key -> {uri,
    line}) — GitHub's SARIF ingestion requires the physical location
    to render PR annotations at all."""
    locations = locations or {}
    rules: Dict[str, Dict] = {}
    results = []
    for name, rep in reports.items():
        phys = locations.get(name, {"uri": f"kbvm/{name}", "line": 1})
        for f in rep["findings"]:
            code = f["code"]
            if code not in rules:
                rules[code] = {
                    "id": code,
                    "shortDescription": {"text": code},
                    "defaultConfiguration": {
                        "level": _SARIF_LEVELS[f["severity"]]},
                }
            data = f.get("data", {})
            loc = name if "pc" not in data else f"{name}:pc{data['pc']}"
            results.append({
                "ruleId": code,
                "level": _SARIF_LEVELS[f["severity"]],
                "message": {"text": f["message"]},
                "locations": [{
                    "physicalLocation": {
                        "artifactLocation": {"uri": phys["uri"]},
                        "region": {"startLine": phys["line"]},
                    },
                    "logicalLocations": [{
                        "name": name,
                        "fullyQualifiedName": loc,
                        "kind": "module",
                    }],
                }],
                "properties": {"target": name, **data},
            })
    return {
        "$schema": "https://raw.githubusercontent.com/oasis-tcs/"
                   "sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "kb-lint",
                "informationUri":
                    "https://github.com/grimm-co/killerbeez",
                "rules": sorted(rules.values(),
                                key=lambda r: r["id"]),
            }},
            "results": results,
        }],
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="kb-lint",
        description="static-analysis lint over KBVM programs "
                    "(CFG + dataflow defect checks)")
    p.add_argument("targets", nargs="*",
                   help="built-in target names (default: all)")
    p.add_argument("--all", action="store_true", dest="all_targets",
                   help="lint every built-in target (the default "
                        "when no names are given; explicit for CI)")
    p.add_argument("--program-file", action="append",
                   help="compiled .npz program (repeatable)")
    fmt = p.add_mutually_exclusive_group()
    fmt.add_argument("--json", action="store_true",
                     help="machine-readable report on stdout")
    fmt.add_argument("--sarif", action="store_true",
                     help="SARIF 2.1.0 report on stdout (one rule "
                          "per check id) — the CI lane uploads this "
                          "to annotate findings on PRs")
    p.add_argument("--dict", action="store_true", dest="want_dict",
                   help="include the extracted auto-dictionary")
    p.add_argument("--vsa", action="store_true", dest="want_vsa",
                   help="run the value-set fixpoint: enables the "
                        "infeasible-edge / value-range-contradiction"
                        " / guaranteed-oob-store checks and a 'vsa' "
                        "stats section in --json")
    p.add_argument("--gaps-dir",
                   help="a campaign's proxy_gaps/ directory: run the "
                        "conformance checks (proxy-gap-backlog, "
                        "conformance-drift) over its index + repair "
                        "ledger")
    p.add_argument("--gap-backlog", type=int, default=8,
                   help="unconsumed gap reports tolerated before "
                        "proxy-gap-backlog fires (default 8)")
    args = p.parse_args(argv)
    try:
        progs = _load_programs(args)
    except (ValueError, FileNotFoundError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    reports = {}
    locs = {}
    errors = warnings = 0
    for prog, loc in progs:
        rep = lint_report(prog, want_dict=args.want_dict,
                          want_vsa=args.want_vsa)
        key, n = prog.name, 2
        while key in reports:           # same-named programs must not
            key = f"{prog.name}#{n}"    # overwrite each other
            n += 1
        reports[key] = rep
        locs[key] = loc
        errors += rep["errors"]
        warnings += rep["warnings"]

    if args.gaps_dir:
        for key, ent in conformance_reports(
                args.gaps_dir, args.gap_backlog).items():
            reports[key] = ent["report"]
            locs[key] = ent["location"]
            errors += ent["report"]["errors"]
            warnings += ent["report"]["warnings"]

    if args.json:
        print(json.dumps({"targets": reports, "errors": errors,
                          "warnings": warnings}, indent=2))
        return 1 if errors else 0

    if args.sarif:
        print(json.dumps(sarif_report(reports, locs), indent=2))
        return 1 if errors else 0

    for name, rep in reports.items():
        s = rep.get("stats")
        if s is None:               # conformance pseudo-reports
            print(f"{name}:")
        else:
            print(f"{name}: {s['n_blocks']} blocks, {s['n_edges']} "
                  f"edges ({s['n_slots']} slots, {s['n_modules']} "
                  f"module(s)), longest loop-free path "
                  f"{s['longest_acyclic_path']} of max_steps "
                  f"{s['max_steps']}")
        for f in rep["findings"]:
            print(f"  {f['severity']}: [{f['code']}] {f['message']}")
        if args.want_dict:
            toks = ", ".join(repr(t.encode('latin-1'))
                             for t in rep["dictionary"][:16])
            print(f"  dictionary ({len(rep['dictionary'])} tokens): "
                  f"{toks}")
    total = f"{errors} error(s), {warnings} warning(s) across " \
            f"{len(reports)} program(s)"
    print(total if errors or warnings else f"clean: {total}")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
