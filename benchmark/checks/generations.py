"""The check of ``-G`` dispatches: G generations each, from the
device's seed-slot ring, all replayed in lockstep (one VM call a
generation).

The ring's sizes are the instrumentation's options, which the traffic
states: ``gen_ring_slots`` slots, ``gen_admits`` admissions a
generation (at most the ring's slots less one), ``gen_findings_cap``
rows of the findings ring.
"""

import torch

from kbbench import check as c
from reference import generations as ref_gen


def _sizes(ctx):
    """(ring slots, admissions a generation, findings-ring rows)."""
    o = ctx.options
    slots = max(int(o["gen_ring_slots"]), 2)
    return (slots, min(max(int(o["gen_admits"]), 1), slots - 1),
            int(o["gen_findings_cap"]))


def _fresh_ring(ctx, state):
    """The ring the first dispatch finds: the base seed in slot 0."""
    slots = _sizes(ctx)[0]
    dev, seed = ctx.dev, ctx.seed_bytes
    z = [torch.zeros(slots, dtype=torch.int32, device=dev)
         for _ in range(4)]
    bufs = torch.zeros((slots, state["L"]), dtype=torch.uint8, device=dev)
    bufs[0, :len(seed)] = torch.tensor(list(seed), dtype=torch.uint8,
                                       device=dev)
    z[0][0], z[1][0] = len(seed), 1
    return {"bufs": bufs, "lens": z[0], "filled": z[1], "hits": z[2],
            "finds": z[3],
            "ptr": torch.zeros((), dtype=torch.int32, device=dev)}


def _replays(ctx, pairs, max_steps=0):
    _slots, adm_cap, fcap = _sizes(ctx)
    return ref_gen.run_all(ctx.prog, [ref_gen.replay(
        ctx.prog, before.get("ring") or _fresh_ring(ctx, before),
        tuple(m.clone() for m in before["maps"][:3]), ctx.key, d.it0, d.n,
        d.gen0, ctx.salt, d.k, adm_cap, fcap, ctx.stack_pow2, ctx.u_slots,
        ctx.seg_id) for d, before in pairs], max_steps)


def _ring_findings(rep, fcap):
    stored = min(rep["fr_ptr"], fcap)
    pk = rep["fr_pack"][:stored].to(torch.int64)
    return c.findings_of(pk & 7, (pk >> 3) & 3, rep["fr_bufs"][:stored],
                         rep["fr_len"][:stored])


def _program_report(out):
    return {"fr_pack": out.fr_pack, "fr_gen": out.fr_gen,
            "fr_iter": out.fr_iter, "fr_len": out.fr_len,
            "fr_bufs": out.fr_bufs, "fr_ptr": int(out.fr_ptr),
            "sel": [int(s) for s in out.sel.tolist()],
            "adm_raw": [int(a) for a in out.adm_raw.tolist()],
            "adm_valid": out.adm_valid, "adm_slot": out.adm_slot,
            "adm_iter": out.adm_iter, "adm_len": out.adm_len,
            "adm_bufs": out.adm_bufs, "ring_filled": out.ring_filled}


def _dict_differ(got, ref):
    """Entries that differ between two dicts of tensors, ints and int
    lists (a missing or misshapen field counts whole)."""
    bad = 0
    for k, v in ref.items():
        g = got.get(k)
        if isinstance(v, torch.Tensor):
            if not isinstance(g, torch.Tensor) or g.shape != v.shape:
                bad += max(v.numel(), 1)
                continue
            bad += int((g.to(v.device).to(torch.int64)
                        != v.to(torch.int64)).sum())
        elif isinstance(v, list):
            g = list(g) if g is not None else []
            bad += sum(1 for a, b in zip(g, v) if int(a) != int(b)) \
                + abs(len(g) - len(v))
        else:
            bad += int(g is None or int(g) != int(v))
    return bad


def check(ctx, pairs, found):
    r = c.new_readings()
    fcap = _sizes(ctx)[2]
    findings = 0
    for (d, _before), (rep, ring, maps, per_gen) in zip(
            pairs, _replays(ctx, pairs)):
        vms = c.kept(d) or [None] * d.k
        for (rb, rl, rout), got in zip(per_gen, vms):
            if got is None:
                r["mutant_mismatch"] += d.n
            else:
                r["mutant_mismatch"] += int(
                    (c.lanes_differ(got[1], rb)
                     | c.lanes_differ(got[2], rl)).sum())
            r["vm_mismatch"] += c.vm_mismatch(
                None if got is None else got[0], rout)
        report = d.after.get("report") or _program_report(d.after["out"])
        r["ring_mismatch"] += _dict_differ(report, rep) \
            + _dict_differ(d.after["ring"], ring)
        r["map_mismatch"] += c.maps_differ(d.after["maps"][:3], maps)
        # the findings the drain writes: the stored rows of the
        # findings ring
        expect = _ring_findings(rep, fcap)
        findings += len(expect)
        r["finding_missing"] += sum(1 for k, b in expect if not found(k, b))
    return r, {"checked_lanes": sum(d.n * d.k for d, _ in pairs),
               "expected_findings": findings}


def control(ctx, pairs):
    fcap = _sizes(ctx)[2]
    made = set()
    out = []
    for (d, before), (rep, ring, maps, per_gen) in zip(
            pairs, _replays(ctx, pairs, c.control_steps(ctx))):
        made.update(_ring_findings(rep, fcap))
        after = {"report": rep, "ring": ring, "maps": maps}
        out.append((c.stand_in(d, after, [(v, b, n) for b, n, v in per_gen]),
                    before))
    return out, lambda k, b: (k, b) in made
