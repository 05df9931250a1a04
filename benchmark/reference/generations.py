"""The ``-G`` generation loop: G generations per dispatch, each
seeded from a slot of a seed ring that edge-novel lanes refill.

Generation j (global index ``gen0 + j``) picks the k-th filled slot
for k = ``mix32(gen * 0x9E3779B9 ^ salt) % filled``, mutates it with
the lanes' keys ``fold_in(base_key, its0 + j * n)``, runs and triages
the mutants, appends its interesting lanes (crash, hang or new path)
to a findings ring in lane order (the write pointer counts the ones
past its capacity), credits the slot (hits + 1, finds + edge-novel
lanes) and admits its first ``adm_cap`` edge-novel lanes FIFO into
slots 1..S-1, recording each admission in a ledger.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import havoc as havoc_mod
from . import prng, triage, vm

M32 = 0xFFFFFFFF


def slot_draw(gen_id: int, salt: int) -> int:
    x = ((int(gen_id) * 0x9E3779B9) & M32) ^ (int(salt) & M32)
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def select_slot(filled: List[int], gen_id: int, salt: int) -> int:
    k = slot_draw(gen_id, salt) % max(sum(filled), 1)
    seen = 0
    for s, f in enumerate(filled):
        seen += f
        if seen > k:
            return s
    return len(filled) - 1


def first_lanes(mask: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` lanes where ``mask`` holds, in lane order,
    padded with lane 0."""
    idx = torch.nonzero(mask).flatten()[:n]
    pad = torch.zeros(n - idx.shape[0], dtype=idx.dtype, device=idx.device)
    return torch.cat([idx, pad])


def replay(prog: vm.Program, ring: Dict[str, torch.Tensor], maps,
           base_key, its0: int, n: int, gen0: int, salt: int, g: int,
           adm_cap: int, findings_cap: int, stack_pow2: int, u_slots,
           seg_id):
    """One dispatch from the ring (dict of bufs [S, L], lens, filled,
    hits, finds, ptr) and the maps (vb, vc, vh), as a generator: it
    yields each generation's mutants (bufs, lens) and takes their VM
    results (``send``), so that the caller can run several dispatches'
    generations through one VM call.  Returns (report dict, ring',
    maps', per-generation (bufs, lens, VMOut)) as its value."""
    dev = base_key.device
    ring = {k: v.clone() for k, v in ring.items()}
    S, L = ring["bufs"].shape
    F = int(findings_cap)
    vb, vc, vh = maps
    fr = {"pack": torch.zeros(F, dtype=torch.uint8, device=dev),
          "gen": torch.zeros(F, dtype=torch.int32, device=dev),
          "iter": torch.zeros(F, dtype=torch.int64, device=dev),
          "len": torch.zeros(F, dtype=torch.int32, device=dev),
          "bufs": torch.zeros((F, L), dtype=torch.uint8, device=dev)}
    ptr = 0
    sels, araws = [], []
    led = {k: [] for k in ("valid", "slot", "iter", "len", "bufs")}
    per_gen = []
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    for j in range(g):
        gen_id = (gen0 + j) & M32
        sel = select_slot([int(f) for f in ring["filled"].tolist()],
                          gen_id, salt)
        its = (its0 + j * n + lane) & M32
        words = prng.havoc_words(base_key, its, stack_pow2)
        bufs, lens = havoc_mod.havoc(ring["bufs"][sel],
                                     int(ring["lens"][sel]), words,
                                     stack_pow2)
        out = yield bufs, lens
        per_gen.append((bufs, lens, out))
        st = torch.where(out.status == vm.FUZZ_RUNNING, vm.FUZZ_HANG,
                         out.status).to(torch.int32)
        rets, uc, uh, vb, vc, vh = triage.triage(
            vb, vc, vh, out.counts, u_slots, seg_id, st == vm.FUZZ_CRASH,
            st == vm.FUZZ_HANG)
        packed = triage.pack(st, rets, uc, uh)
        flags = (st != vm.FUZZ_NONE) | (rets > 0)
        aflags = rets == 2
        raw = int(flags.sum())
        rows = torch.nonzero(flags).flatten()[:max(min(F - ptr, raw), 0)]
        at = slice(ptr, ptr + rows.shape[0])
        fr["pack"][at] = packed[rows]
        fr["gen"][at] = ((gen_id ^ (1 << 31)) - (1 << 31))
        fr["iter"][at] = its[rows]
        fr["len"][at] = lens[rows]
        fr["bufs"][at] = bufs[rows]
        ptr += raw
        araw = int(aflags.sum())
        ring["hits"][sel] += 1
        ring["finds"][sel] += araw
        aidx = first_lanes(aflags, adm_cap)
        n_adm = min(araw, adm_cap)
        valid = torch.arange(adm_cap, device=dev) < n_adm
        slots = 1 + (int(ring["ptr"]) + torch.arange(adm_cap, device=dev)) \
            % (S - 1)
        for a in range(n_adm):
            s = int(slots[a])
            ring["bufs"][s] = bufs[aidx[a]]
            ring["lens"][s] = lens[aidx[a]]
            ring["filled"][s] = 1
            ring["hits"][s] = 0
            ring["finds"][s] = 0
        ring["ptr"] = ring["ptr"] + n_adm
        vi = valid.to(torch.int32)
        led["valid"].append(vi)
        led["slot"].append(slots.to(torch.int32) * vi)
        led["iter"].append(its[aidx] * vi)
        led["len"].append(lens[aidx].to(torch.int32) * vi)
        led["bufs"].append(bufs[aidx])
        sels.append(sel)
        araws.append(araw)
    report = {"fr_" + k: v for k, v in fr.items()}
    report["fr_ptr"] = ptr
    report["sel"] = sels
    report["adm_raw"] = araws
    report.update({"adm_" + k: torch.stack(v) for k, v in led.items()})
    report["ring_filled"] = ring["filled"].clone()
    return report, ring, (vb, vc, vh), per_gen


def run_all(prog: vm.Program, replays, max_steps: int = 0) -> list:
    """Drive ``replay`` generators in lockstep, each generation's
    mutants of all of them through one VM call (``max_steps``
    overrides the program's budget).  Returns their values."""
    results = [None] * len(replays)
    pending = {i: next(r) for i, r in enumerate(replays)}
    while pending:
        keys = sorted(pending)
        bufs = torch.cat([pending[i][0] for i in keys])
        lens = torch.cat([pending[i][1] for i in keys])
        out = vm.run(prog, bufs, lens, max_steps)
        at = 0
        for i in keys:
            n = pending[i][0].shape[0]
            part = vm.VMOut(*(t[at:at + n] for t in out))
            at += n
            try:
                pending[i] = replays[i].send(part)
            except StopIteration as done:
                results[i] = done.value
                del pending[i]
    return results


def run(prog: vm.Program, *args, max_steps: int = 0):
    """One dispatch (``replay``'s arguments), alone."""
    return run_all(prog, [replay(prog, *args)], max_steps)[0]
