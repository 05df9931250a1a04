"""kb-repair — counterexample-guided proxy conformance repair.

Consumes a campaign's accumulated ``kbz-proxy-gap-v1`` reports
(``<output>/proxy_gaps/``), localizes each divergence cluster to the
guard it indicts, searches the bounded typed patch space, and emits
either a VERIFIED patched proxy or an honest ``unrepairable`` verdict
with a machine-readable reason (docs/ANALYSIS.md, "Conformance &
repair").

Usage:
    kb-repair --binding test_safe --gaps-dir out/proxy_gaps
    kb-repair ... --json                # machine-readable result
    kb-repair ... --apply               # save the patched .npz,
                                        #   install <name>+repaired
                                        #   (re-certified), write the
                                        #   repair ledger
    kb-repair ... --require-repaired    # exit 1 unless repaired
    kb-repair --binding test_safe --probe --gaps-dir d
                                        # generate the gap corpus by
                                        #   probing BOTH tiers with
                                        #   solver witnesses (needs
                                        #   the native substrate)

Run as ``python -m killerbeez_tpu_torch.tools.repair_tool`` (``kb-repair``
above).  ``--device`` (default ``cuda``) is where the probe's proxy
verdicts and ``--apply``'s re-certification run the proxy: one
``kbz_vm_kernel`` launch per input on the card, the plain VM with
``--device cpu``.  The native binaries of the built-in bindings are
built into ``build/torch_native/corpus/`` on first use.

Exit codes: 0 done; 1 ``--require-repaired`` unmet; 2 usage or
substrate error (unknown binding, no CUDA card for ``--device cuda``,
native tier unavailable for ``--probe``/``--apply``
re-certification).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import List, Optional

from ..analysis.repair import (
    run_repair, save_patched_program, write_repair_ledger,
)


def _probe(binding, gaps_dir: str, repeats: int = 3,
           device="cuda") -> int:
    """Mint gap reports by probing both tiers with solver-synthesized
    must-crash witnesses (+ benign seed + crash seeds).  Divergences
    land through the same GapIndex path the campaign bridge uses;
    agreements write nothing.  Returns the number of gap reports."""
    import numpy as np

    from .. import FUZZ_CRASH, FUZZ_HANG
    from ..analysis.dataflow import analyze_dataflow
    from ..analysis.solver import solve_edge
    from ..hybrid.gaps import GapIndex, make_gap_report, \
        proxy_trace_edge
    from ..hybrid.registry import proxy_verdict
    from ..hybrid.validate import NativeValidator, ValidationItem

    program = binding.program()
    df = analyze_dataflow(program)
    probes: List[bytes] = [bytes(binding.benign_seed)]
    probes += [bytes(s) for s in binding.crash_seeds]
    ef = np.asarray(program.edge_from)
    et = np.asarray(program.edge_to)
    for i in range(len(ef)):
        if int(et[i]) not in df.must_crash_blocks:
            continue
        res = solve_edge(program, (int(ef[i]), int(et[i])))
        if res.status == "solved" and res.input is not None:
            probes.append(res.input)
            # variants: same guard, distinct inputs — a CLUSTER of
            # counterexamples, not a single sample
            probes.append(res.input + b"xx")
            probes.append(res.input + b"\x00\x01")
    validator = NativeValidator(binding, repeats=repeats)
    index = GapIndex(gaps_dir)
    n = 0
    seen = set()
    try:
        for buf in probes:
            if buf in seen:
                continue
            seen.add(buf)
            status = proxy_verdict(binding, buf, device)
            if status not in (FUZZ_CRASH, FUZZ_HANG):
                continue            # proxy-benign: nothing to claim
            kind = "crash" if status == FUZZ_CRASH else "hang"
            md5 = hashlib.md5(buf).hexdigest()
            result = validator.validate(
                ValidationItem(kind, buf, md5, proxy_status=status))
            if result["verdict"] != "proxy_only":
                continue
            report = make_gap_report(
                md5=md5, kind=kind, binding=binding.name,
                proxy_target=binding.proxy_target,
                proxy_status=status,
                native_argv=binding.native.argv,
                native_delivery=binding.native.delivery,
                statuses=result.get("statuses", []),
                repro=result.get("repro", 0),
                repeats=result.get("repeats", 0),
                t=result.get("t"),
                input_bytes=buf,
                edge=proxy_trace_edge(program, buf))
            if index.admit(report):
                n += 1
    finally:
        validator.close()
    return n


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="kb-repair",
        description="counterexample-guided proxy repair over "
                    "accumulated kbz-proxy-gap-v1 reports")
    p.add_argument("--binding", required=True,
                   help="proxy binding name (hybrid registry)")
    p.add_argument("--gaps-dir", required=True,
                   help="the campaign's proxy_gaps/ directory")
    p.add_argument("--json", action="store_true",
                   help="machine-readable kbz-proxy-repair-v1 result "
                        "on stdout")
    p.add_argument("--apply", action="store_true",
                   help="on a repaired verdict: save the patched "
                        ".npz, install the re-certified "
                        "<binding>+repaired binding, and write the "
                        "repair ledger (unrepairable/no-gaps runs "
                        "write only the ledger)")
    p.add_argument("--out",
                   help="patched program path for --apply (default "
                        "<gaps-dir>/repaired_<binding>.npz)")
    p.add_argument("--require-repaired", action="store_true",
                   help="exit 1 unless the verdict is 'repaired' "
                        "(CI conformance gate)")
    p.add_argument("--probe", action="store_true",
                   help="FIRST mint gap reports by probing both "
                        "tiers with solver witnesses (requires the "
                        "native substrate)")
    p.add_argument("--repeats", type=int, default=3,
                   help="native replays per probe input (default 3)")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default: the card) or "cpu": where the '
                        "probe's and the re-certification's proxy "
                        "verdicts run")
    args = p.parse_args(argv)

    from .. import resolve_device
    from ..hybrid.registry import ensure_native_binary, get_binding
    try:
        binding = get_binding(args.binding)
        resolve_device(args.device)
    except (KeyError, RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.probe:
        from ..native.build import build_error, native_available
        exe = binding.native.argv[0]
        if not native_available():
            print(f"error: --probe needs the native tier: "
                  f"{build_error()}", file=sys.stderr)
            return 2
        try:
            ensure_native_binary(exe)
        except RuntimeError as e:
            print(f"error: --probe needs the native binary: {e}",
                  file=sys.stderr)
            return 2
        if not os.path.exists(exe):
            print(f"error: --probe needs the native binary: {exe} "
                  f"(make -C corpus)", file=sys.stderr)
            return 2
        n = _probe(binding, args.gaps_dir, repeats=args.repeats,
                   device=args.device)
        if not args.json:
            print(f"probe: {n} gap report(s) in {args.gaps_dir}")

    result, patched = run_repair(binding, args.gaps_dir)

    if args.apply:
        write_repair_ledger(args.gaps_dir, result)
        if patched is not None:
            out = args.out or os.path.join(
                args.gaps_dir, f"repaired_{binding.name}.npz")
            save_patched_program(patched, out)
            result["program_file"] = out
            from ..hybrid.registry import (
                CertificationError, install_repaired,
            )
            try:
                installed = install_repaired(binding, out,
                                             device=args.device)
                result["installed"] = installed.name
            except CertificationError as e:
                # honesty: a patch the native tier refuses to
                # re-certify is NOT a repair
                result["status"] = "unrepairable"
                result["reason"] = f"recertify:{e}"
                result["installed"] = None
                patched = None

    if args.json:
        print(json.dumps(result, indent=2))
    else:
        print(f"{binding.name}: {result['status']}"
              + (f" ({result['reason']})" if result.get("reason")
                 else ""))
        for crec in result.get("clusters") or []:
            blame = crec.get("blame") or {}
            print(f"  edge {crec.get('edge')} "
                  f"{crec.get('proxy_cls')}->{crec.get('native_cls')}"
                  f" [{len(crec.get('inputs') or [])} input(s)]: "
                  f"{crec['status']}"
                  + (f" blame pc {blame.get('pc')} "
                     f"cmp {blame.get('cmp')}" if blame else "")
                  + (f" patch {crec.get('patch_desc')}"
                     if crec.get("patch_desc") else "")
                  + (f" reason {crec.get('reason')}"
                     if crec.get("reason") else ""))

    if args.require_repaired and result["status"] != "repaired":
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
