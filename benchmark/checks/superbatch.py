"""The check of a host-driven superbatch: K fused batches of one seed
(``Fuzzer.run``'s dispatch), each triaged in turn against the virgin
maps, and the findings they leave on disk."""

import torch

from kbbench import check as c
from reference import triage


def _reference(ctx, d, before, max_steps=0):
    """Per batch (bytes, lengths, VM results, verdict bytes), the maps
    after the last batch and the findings, as the reference works
    them out (``max_steps`` overrides the program's budget)."""
    maps = tuple(m.clone() for m in before["maps"][:3])
    muts = [c.mutants(ctx, before["seed"], before["L"], d.it0 + j * d.n,
                      d.n) for j in range(d.k)]
    rb = torch.cat([m[0] for m in muts])
    rl = torch.cat([m[1] for m in muts])
    out = c.vm_rows(ctx, rb, rl, max_steps)
    batches, expect = [], []
    for j in range(d.k):
        sl = slice(j * d.n, (j + 1) * d.n)
        o = c.row(out, sl)
        st, rets, uc, uh, maps = c.triage_batch(ctx, maps, o)
        batches.append((rb[sl], rl[sl], o, triage.pack(st, rets, uc, uh)))
        expect += c.findings_of(st, rets, rb[sl], rl[sl])
    return batches, maps, expect


def check(ctx, pairs, found):
    r = c.new_readings()
    info = {"checked_lanes": 0, "expected_findings": 0}
    for d, before in pairs:
        batches, maps, expect = _reference(ctx, d, before)
        packed, bufs, lens = d.after["out"][:3]
        vms = c.kept(d)
        for j, (rb, rl, out, rpacked) in enumerate(batches):
            r["mutant_mismatch"] += int((c.lanes_differ(bufs[j], rb)
                                         | c.lanes_differ(lens[j], rl)).sum())
            r["vm_mismatch"] += c.vm_mismatch(
                None if vms is None else vms[j][0], out)
            r["verdict_mismatch"] += int(
                c.lanes_differ(packed[j], rpacked).sum())
        r["map_mismatch"] += c.maps_differ(d.after["maps"][:3], maps)
        r["finding_missing"] += sum(1 for k, b in expect if not found(k, b))
        r["seed_unknown"] += int(not c.seed_known(
            before["seed"], ctx.seed_bytes, ctx.out_dir))
        info["checked_lanes"] += d.n * d.k
        info["expected_findings"] += len(expect)
    return r, info


def control(ctx, pairs):
    made = set()
    out = []
    for d, before in pairs:
        batches, maps, expect = _reference(ctx, d, before,
                                           c.control_steps(ctx))
        made.update(expect)
        cols = list(zip(*batches))
        after = {"out": (torch.stack(cols[3]), torch.stack(cols[0]),
                         torch.stack(cols[1])), "maps": maps}
        out.append((c.stand_in(d, after, [(o,) for o in cols[2]]), before))
    return out, lambda k, b: (k, b) in made
