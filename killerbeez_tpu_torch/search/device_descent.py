"""Device-resident descent — R full rank -> probe -> mutate ->
re-score iterations per host dispatch.

The host engine (``descent.py``) round-trips every candidate
population through the host on every iteration: the host ranks the
returned distances, regenerates the probe batch in Python, and
dispatches again.  This module keeps the descent loop ON the device:
one dispatch runs

    rank elites -> emit probe/i2s/ES candidates -> execute with
    curriculum distances + operand capture -> re-rank -> append
    witnesses

R times as torch ops on the card, with the carry (elite population,
per-center probe rotation cursors, captured compare operands, a
bounded best-witness ring) held in device tensors, and the host only
drains one witness report per R iterations.  The JAX package runs the
same loop as one ``lax.scan``; here it is a Python loop over the same
carry, and the only host read per iteration is the witness pointer
that decides the early stop.

Probe families mirror the host engine's — single-coordinate
+/-{1,2,4,16,64} probes, compensated pair probes, dictionary-token
insertion sweeps, ES mutants — but are keyed by DETERMINISTIC
per-lane rotation counters (pure uint32 mixing, no host RNG), so the
stepped mode (``scan_iters=1``: one device iteration per dispatch,
the host driving the loop) and the in-scan mode (``scan_iters=R``)
generate bit-identical candidate streams, and both are bit-identical
to the JAX package's.  uint32 values travel in int64 tensors, masked
to 32 bits after every operation that can carry.

NEW vs the host engine: **input-to-state operand matching**
(Redqueen, with Angora's distance framework underneath).  The
distance engine already observes the concrete compare operands at
every curriculum branch; ``vm.run_batch_distances(...,
capture_operands=True)`` returns them, and a dedicated lane block
copies the OBSERVED operand value back into the candidate at the
branch's dynamic byte-dependency positions — both endianness orders
plus +/-1 variants.

Honesty contract unchanged: a witness ring row is only ever REPORTED
after the pure-Python reference interpreter confirms the edge
traversal on the host.  The engine stands down to the host engine
when an edge has no deciding branches (unconditional edges descend
on block coverage alone, which the host engine handles).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.vm import DIST_UNREACHED, M32, _dist_loop_core, _mix32
from ..utils.logging import DEBUG_MSG
from .descent import (
    _PROBE_DELTAS, MAX_GUARDS, N_ELITE, DescentResult, _concrete_trace,
    _edge_index, _pack, _path_guards, descend_edge,
)
from .objective import BranchObjective, edge_objectives
from .soft import slice_operand_deps, soft_refine, trace_slice

#: iterations fused into one device dispatch (the R of the module
#: docstring); the stepped parity mode passes 1
DEFAULT_SCAN_ITERS = 8

#: best-witness ring capacity per dispatch (append-bounded like the
#: generations findings ring: the FIRST W edge-traversing lanes are
#: kept in (iteration, lane) order, the pointer counts overflow)
WITNESS_RING = 32

#: byte-dependency positions considered per guard for the i2s writes
#: (32-bit operands: four bytes)
I2S_DEPS = 4

#: i2s lanes per guard: 2 operand sides x {0, +1, -1} x {LE, BE}
I2S_PER_GUARD = 12

#: lane-family tags recorded in the witness ring (telemetry: a
#: witness with family FAM_I2S is an input-to-state crack)
FAM_ELITE, FAM_I2S, FAM_ONE, FAM_TWO, FAM_INS, FAM_ES = range(6)

_FNV_PRIME = 0x01000193
#: DIST_UNREACHED as the float32 the distance engine stores
_UNREACHED_F32 = float(np.float32(DIST_UNREACHED))


def _layout(lanes: int, k: int) -> Dict[str, int]:
    """Static lane-block layout: [elites][i2s][one][two][ins][es].
    Pure function of the static config so the stepped and in-scan
    modes agree by construction."""
    n_el = N_ELITE
    n_i2s = I2S_PER_GUARD * k
    rest = max(lanes - n_el - n_i2s, 8)
    n_ins = rest // 6             # window-dup variants exist even
    probe = rest - n_ins          # with an empty dictionary
    n_one = (probe * 2 // 5) & ~1          # even: split over 2 roles
    n_two = (probe * 2 // 5) & ~1
    n_es = rest - n_ins - n_one - n_two
    return {"el": n_el, "i2s": n_i2s, "one": n_one, "two": n_two,
            "ins": n_ins, "es": n_es,
            "total": n_el + n_i2s + n_one + n_two + n_ins + n_es}


def _family_tags(lay: Dict[str, int]) -> np.ndarray:
    fams = []
    for name, tag in (("el", FAM_ELITE), ("i2s", FAM_I2S),
                      ("one", FAM_ONE), ("two", FAM_TWO),
                      ("ins", FAM_INS), ("es", FAM_ES)):
        fams.extend([tag] * lay[name])
    return np.asarray(fams, dtype=np.int32)


def _onehot_write(rows, pos, val):
    """rows[r, pos[r]] = val[r] as a compare-select over the L axis (a
    position outside [0, L) writes nothing)."""
    L = rows.shape[1]
    m = torch.arange(L, device=rows.device)[None, :] == pos[:, None]
    return torch.where(m, val[:, None], rows)


def _take(rows, pos):
    """rows[r, pos[r]] (0 where pos lies outside [0, L))."""
    L = rows.shape[1]
    ok = (pos >= 0) & (pos < L)
    v = rows.gather(1, pos.clamp(0, L - 1)[:, None])[:, 0]
    return torch.where(ok, v, 0)


def _clip_pos(raw, clen):
    """Map a rotation position into the live prefix: in-range raw
    positions pass through, out-of-range ones wrap (deterministic in
    both modes; double-weighting early bytes of short centers is
    acceptable)."""
    return torch.where(raw < clen, raw, raw % clen.clamp(min=1))


def _empty(L: int, dev):
    return (torch.zeros((0, L), dtype=torch.int64, device=dev),
            torch.zeros((0,), dtype=torch.int64, device=dev))


def _gen_i2s(e_bufs, e_lens, cap_x, cap_y, cap_valid, dep_pos, n_dep,
             k: int, L: int):
    """Input-to-state lane block: for every guard, copy each observed
    compare operand (+/-1 variants) into the best elite at the
    guard's byte-dependency positions, little- and big-endian byte
    orders.  Guards never sampled (cap_valid 0) degenerate to plain
    copies of the base.  Operands are int32 values in int64: their
    low 32 bits are the JAX package's wrapped int32 sums, and only
    those bits reach a byte."""
    dev = e_bufs.device
    n = I2S_PER_GUARD * k
    r = np.arange(n)
    k_r = torch.as_tensor(r // I2S_PER_GUARD, device=dev)
    sub = r % I2S_PER_GUARD
    side = torch.as_tensor(sub // 6, device=dev)          # 0 = x, 1 = y
    delta = torch.as_tensor(np.array([0, 1, -1])[(sub % 6) // 2],
                            device=dev)
    order = torch.as_tensor(sub % 2, device=dev)          # 0 LE, 1 BE

    base = e_bufs[0].to(torch.int64)
    blen = e_lens[0].to(torch.int64)
    vals = torch.where(side == 0, cap_x[k_r], cap_y[k_r]).to(torch.int64) \
        + delta
    valid = cap_valid[k_r] > 0
    w = n_dep[k_r].clamp(0, I2S_DEPS)
    rows = base[None, :].expand(n, L)
    md = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lidx = torch.arange(L, device=dev)[None, :]
    for j in range(I2S_DEPS):
        p = dep_pos[k_r, j]
        active = (j < w) & (p >= 0) & valid
        # an inactive row's shift is never used: clamp it defined
        byte_sel = torch.where(order == 0, j, w - 1 - j).clamp(min=0)
        byte = (vals >> (8 * byte_sel)) & 0xFF
        rows = torch.where((lidx == p[:, None]) & active[:, None],
                           byte[:, None], rows)
        md = torch.maximum(md, torch.where(active, p, -1))
    lens = torch.where(valid, torch.maximum(blen, md + 1), blen)
    return rows, lens


def _roles(n: int, cur0, cur1, len0, len1, dev):
    """Per-lane rotation counter and live length of a two-center
    probe block: the first half probes center 0, the second center
    1."""
    half = n // 2
    local = np.arange(n)
    role = torch.as_tensor((local >= half).astype(np.int64), device=dev)
    off = torch.as_tensor(np.where(local < half, local, local - half),
                          device=dev)
    c = torch.where(role == 0, cur0, cur1) + off
    clen = torch.where(role == 0, len0, len1)
    return role, c, clen


def _gen_one(base0, len0, base1, len1, cur0, cur1, pos_order,
             n_one: int, L: int):
    """Single-coordinate finite-difference probes around the two
    centers, rotating through (position, signed delta) combos."""
    dev = base0.device
    if not n_one:
        return _empty(L, dev)
    role, c, clen = _roles(n_one, cur0, cur1, len0, len1, dev)
    # signed delta fastest, position next — one full sweep of the
    # LIVE prefix costs ~10 * clen combos, so short centers cycle
    # every iteration or two instead of dragging the whole L axis
    raw = pos_order[(c // 10) % clen.clamp(min=1)]
    pos = _clip_pos(raw, clen)
    deltas = torch.as_tensor(_PROBE_DELTAS, device=dev)
    d = deltas[(c % 10) // 2] * (1 - 2 * (c % 2))
    cb = torch.where(role[:, None] == 0, base0[None, :], base1[None, :])
    at = _take(cb, pos)
    return _onehot_write(cb, pos, (at + d) & 0xFF), clen


def _gen_two(base0, len0, base1, len1, cur0, cur1, pos_order,
             n_two: int, L: int):
    """Compensated pair probes: +d on byte i, a compensating
    {+d,-d,+2d,-2d} on byte j — moves an operand THROUGH sum-style
    integrity checks instead of dying at them."""
    dev = base0.device
    if not n_two:
        return _empty(L, dev)
    role, c, clen = _roles(n_two, cur0, cur1, len0, len1, dev)
    # compensator sign fastest, then the compensating position j,
    # then the operand position i (over the 8 hottest focus
    # positions), then the magnitude — the host engine's combo order
    smul = torch.as_tensor([1, -1, 2, -2], device=dev)[c % 4]
    jm = (clen - 1).clamp(min=1)
    j_off = 1 + (c // 4) % jm
    i_pos = _clip_pos(pos_order[(c // (4 * jm)) % 8], clen)
    d = torch.as_tensor([1, 4, 16, 64], device=dev)[(c // (32 * jm)) % 4]
    j_pos = (i_pos + j_off) % clen.clamp(min=1)
    cb = torch.where(role[:, None] == 0, base0[None, :], base1[None, :])
    rows = _onehot_write(cb, i_pos, (_take(cb, i_pos) + d) & 0xFF)
    return _onehot_write(rows, j_pos,
                         (_take(rows, j_pos) + d * smul) & 0xFF), clen


def _gen_ins(base, blen, cur, tok_bufs, tok_lens, n_ins: int,
             n_tokens: int, L: int):
    """Structural insertion sweep around the best elite, tail
    shifted: dictionary-token splices, token + argument-byte splices
    (command-stream records are opcode + operand) and duplicated
    windows of {1, 2, 4} preceding bytes (re-inserting a well-formed
    record that is already there), every variant x position rotated
    across iterations.  Depth-counter guards need whole records ADDED
    before the branch — no fixed-position byte move can."""
    dev = base.device
    if not n_ins:
        return _empty(L, dev)
    T = max(n_tokens, 0)
    n_var = 2 * T + 3             # raw token, token+arg, dup {1,2,4}
    c = cur + torch.arange(n_ins, device=dev)
    # variant-MINOR: consecutive combos cycle the variant list so
    # every token/dup width gets tried each iteration even under
    # small per-iteration quotas; the position advances once per full
    # variant cycle
    p = (c // n_var) % (blen + 1).clamp(min=1)
    v = c % n_var
    is_dup = v >= 2 * T
    is_arg = (v >= T) & ~is_dup
    t = torch.where(is_dup, 0, v % max(T, 1))
    w = torch.as_tensor([1, 2, 4], device=dev)[(v - 2 * T).clamp(0, 2)]
    base_tl = tok_lens[t] if T else torch.zeros_like(c)
    tl = torch.where(is_dup, torch.minimum(w, blen.clamp(min=1)),
                     base_tl + is_arg.to(torch.int64))
    new_len = (blen + tl).clamp(max=L)
    q = torch.arange(L, device=dev)[None, :]
    rel = q - p[:, None]
    TL = tok_bufs.shape[1]
    tok_rows = tok_bufs[t]
    tok_byte = torch.where(
        (rel >= 0) & (rel < TL),
        tok_rows.gather(1, rel.clamp(0, TL - 1)), 0)
    # the argument byte trailing a token splice rotates with the
    # cursor so every opcode sweeps many operand values over time
    arg = ((((c & M32) * 0x9E3779B9) & M32) >> 13) & 0xFF
    tok_byte = torch.where(is_arg[:, None] & (rel == base_tl[:, None]),
                           arg[:, None], tok_byte)
    # duplicated-window bytes read the ORIGINAL buffer just before p
    dup_src = (p[:, None] - tl[:, None] + rel).clamp(0, L - 1)
    ins_byte = torch.where(is_dup[:, None], base[dup_src], tok_byte)
    in_ins = (rel >= 0) & (rel < tl[:, None])
    shifted = base[(q - tl[:, None]).clamp(0, L - 1)]
    rows = torch.where(q < p[:, None], base[None, :],
                       torch.where(in_ins, ins_byte,
                                   torch.where(q < new_len[:, None],
                                               shifted, 0)))
    return rows, new_len


def _gen_es(e_bufs, e_lens, it: int, salt: int, lane0: int, n_es: int,
            L: int):
    """ES mutants: rank-picked parent, three byte edits (value or
    signed delta) + occasional zero-extension, all derived from
    ``_mix32`` counter mixing — deterministic, host-replayable, and
    fresh every iteration (the loop's restart-free diversity
    source)."""
    dev = e_bufs.device
    if not n_es:
        return _empty(L, dev)
    lane = torch.arange(lane0, lane0 + n_es, device=dev)
    seed = _mix32(_mix32(((it & M32) * 0x9E3779B9 & M32) ^ salt)
                  ^ ((lane * 0x85EBCA6B) & M32))
    # rank-weighted parent pick (min of two uniforms ~ the host
    # engine's geometric bias toward the front)
    rank = torch.minimum(seed % N_ELITE, (seed >> 16) % N_ELITE)
    rows = e_bufs[rank]
    plen = e_lens[rank]
    deltas = torch.as_tensor(_PROBE_DELTAS, device=dev)
    for e in range(3):
        h = _mix32((seed + ((0x6B8B4567 * (e + 1)) & M32)) & M32)
        pos = h % plen.clamp(min=1)
        use_val = (h >> 8) & 1
        val = (h >> 16) & 0xFF
        didx = (h >> 9) % 5
        sgn = 1 - 2 * ((h >> 12) & 1)
        nb = torch.where(use_val == 1, val,
                         (_take(rows, pos) + deltas[didx] * sgn) & 0xFF)
        rows = _onehot_write(rows, pos, nb)
    grow = ((seed >> 3) % 4) == 0
    glen = 1 + ((seed >> 5) % 8)
    lens = torch.where(grow, (plen + glen).clamp(max=L), plen)
    return rows, lens


def _first_true(m):
    """Per row of a bool matrix: (any, index of the first True; 0 when
    none) — ``jnp.argmax`` over booleans."""
    return m.any(dim=-1), m.to(torch.int8).argmax(dim=-1)


def _descent_iteration(tabs, carry, it: int, salt: int, *, mem_size,
                       max_steps, n_edges, specs, e_idx, lay, fam,
                       pows, n_tokens, i2s):
    """One descent iteration over the carry (all device tensors, int64
    working values); returns the new carry."""
    (instrs, edge_table, pos_order, dep_pos, n_dep, tok_bufs,
     tok_lens) = tabs
    (e_bufs, e_lens, e_stage, e_dist, cursors, cap_x, cap_y,
     cap_valid, wit_bufs, wit_lens, wit_src, wit_iter, wit_ptr,
     best_primary) = carry
    dev = e_bufs.device
    K = len(specs)
    L = int(e_bufs.shape[1])
    B = lay["total"]
    wcap = min(WITNESS_RING, B)
    # -- probe centers: the best elite, plus ONE of (in priority
    # order) the leading distinct-LENGTH elite (the structurally
    # different tie — e.g. the zero-extended sibling whose extra
    # positions a moved counter/checksum must land on), the first
    # next-stage-back elite (the repair lane), or elite 1
    idxs = torch.arange(N_ELITE, device=dev)
    dl = torch.where(e_lens != e_lens[0], idxs, N_ELITE).min()
    bk = torch.where(e_stage > e_stage[0], idxs, N_ELITE).min()
    c1 = torch.where(dl < N_ELITE, dl,
                     torch.where(bk < N_ELITE, bk, 1)).view(1)
    eb = e_bufs.to(torch.int64)
    el = e_lens.to(torch.int64)
    base0, len0 = eb[0], el[0]
    base1 = eb.index_select(0, c1)[0]
    len1 = el.index_select(0, c1)[0]

    # -- generate the candidate batch block by block
    blocks = [(eb, el)]
    if i2s:
        blocks.append(_gen_i2s(e_bufs, e_lens, cap_x, cap_y, cap_valid,
                               dep_pos, n_dep, K, L))
    else:
        # i2s disabled (the ablation lane): plain base copies so the
        # layout — and every other family's cursor stream — stays
        # identical at equal budget
        blocks.append((base0[None, :].expand(lay["i2s"], L),
                       len0.expand(lay["i2s"])))
    blocks.append(_gen_one(base0, len0, base1, len1, cursors[0],
                           cursors[1], pos_order, lay["one"], L))
    blocks.append(_gen_two(base0, len0, base1, len1, cursors[2],
                           cursors[3], pos_order, lay["two"], L))
    blocks.append(_gen_ins(base0, len0, cursors[4], tok_bufs, tok_lens,
                           lay["ins"], max(n_tokens, 1), L))
    blocks.append(_gen_es(eb, el, it, salt,
                          lay["el"] + lay["i2s"] + lay["one"]
                          + lay["two"] + lay["ins"], lay["es"], L))
    cand = torch.cat([b for b, _ in blocks], dim=0)
    lens = torch.cat([ln for _, ln in blocks], dim=0).clamp(0, L)
    # the zeros-past-length invariant (hashing + extension moves rely
    # on it)
    lidx = torch.arange(L, device=dev)[None, :]
    cand = torch.where(lidx < lens[:, None], cand, 0) & 0xFF

    # -- execute: curriculum distances + operand capture
    res, dists, cx, cy = _dist_loop_core(
        instrs, edge_table, cand.to(torch.uint8), lens.to(torch.int32),
        mem_size, max_steps, n_edges, specs, True)

    # -- capture update: min-distance lane per guard
    m = dists.argmin(dim=0)
    sampled = dists.min(dim=0).values < _UNREACHED_F32
    ksel = torch.arange(K, device=dev)
    cap_x = torch.where(sampled, cx[m, ksel], cap_x)
    cap_y = torch.where(sampled, cy[m, ksel], cap_y)
    cap_valid = torch.where(sampled, 1, cap_valid)

    # -- witness ring: lanes that traversed the edge, (iteration,
    # lane) order, pointer counts overflow
    hits = res.counts[:, e_idx] > 0
    raw = hits.sum().to(torch.int32)
    lane_ix = torch.arange(B, device=dev)
    hidx = torch.where(hits, lane_ix, B).sort().values[:wcap]
    hidx = torch.where(hidx < B, hidx, 0)
    wpos = wit_ptr + torch.arange(wcap, device=dev)
    valid = (torch.arange(wcap, device=dev) < raw.clamp(max=wcap)) \
        & (wpos < WITNESS_RING)
    tgt = torch.where(valid, wpos, WITNESS_RING)     # row W: a sink

    def ring_put(ring, vals):
        ext = torch.cat([ring, ring[:1]], dim=0)
        ext[tgt] = vals.to(ring.dtype)
        return ext[:WITNESS_RING]

    wit_bufs = ring_put(wit_bufs, cand[hidx])
    wit_lens = ring_put(wit_lens, lens[hidx])
    wit_src = ring_put(wit_src, fam[hidx])
    wit_iter = ring_put(wit_iter, torch.full_like(hidx, it))
    wit_ptr = wit_ptr + raw

    # -- device-side curriculum ranking: staged key per lane
    sampled_m = dists < _UNREACHED_F32
    any_s, last = _first_true(sampled_m.flip(1))
    deep = (K - 1) - last
    stage = torch.where(any_s, (K - 1) - deep, K)
    dist_at = dists.gather(1, deep[:, None])[:, 0]
    dist_l = torch.where(any_s, dist_at, _UNREACHED_F32)

    # content hash (order-aware, length-mixed) for the dedup cut
    h = (cand * pows[None, :]).sum(dim=1) & M32
    h = _mix32(h ^ lens)
    # lexsort by (stage, dist_l, lane): stable sorts, minor key first
    o1 = torch.sort(dist_l, stable=True).indices
    srt = o1[torch.sort(stage[o1], stable=True).indices]
    hs = h[srt]
    earlier = lane_ix[:, None] > lane_ix[None, :]
    dup = ((hs[:, None] == hs[None, :]) & earlier).any(dim=1)
    sel_rank = torch.cumsum((~dup).to(torch.int64), 0) - 1
    svals = torch.arange(N_ELITE, device=dev)[:, None]
    found, fpos = _first_true((sel_rank[None, :] == svals) & (~dup)[None, :])
    pos = torch.where(found, fpos, torch.arange(N_ELITE, device=dev))
    # stratified tail: the last two slots go to the best lanes of a
    # LATER curriculum stage than the front's, when one exists — the
    # deceptive-fitness repair reservation
    stage_s = stage[srt]
    back_m = (stage_s > stage_s[0]) & ~dup
    brank = torch.cumsum(back_m.to(torch.int64), 0) - 1
    for slot, want in ((N_ELITE - 2, 0), (N_ELITE - 1, 1)):
        bfound, bpos = _first_true(back_m & (brank == want))
        pos[slot] = torch.where(bfound, bpos, pos[slot])
    # ... and one for the best distinct-LENGTH lane, so the structural
    # sibling the second probe center wants never falls off the front
    # while it still ranks mid-pack
    lens_s = lens[srt]
    dfound, dpos = _first_true((lens_s != lens_s[0]) & ~dup)
    pos[N_ELITE - 3] = torch.where(dfound, dpos, pos[N_ELITE - 3])
    sel = srt[pos]
    e_bufs = cand[sel].to(torch.uint8)
    e_lens = lens[sel].to(torch.int32)
    e_stage = stage[sel].to(torch.int32)
    e_dist = dist_l[sel]

    best_primary = torch.minimum(best_primary, dists[:, K - 1].min())
    cursors = cursors + torch.as_tensor(
        [lay["one"] // 2, lay["one"] - lay["one"] // 2,
         lay["two"] // 2, lay["two"] - lay["two"] // 2,
         lay["ins"]], device=dev)
    return (e_bufs, e_lens, e_stage, e_dist, cursors, cap_x, cap_y,
            cap_valid, wit_bufs, wit_lens, wit_src, wit_iter, wit_ptr,
            best_primary)


def _fnv_pows(L: int) -> np.ndarray:
    pows = np.empty(L, dtype=np.int64)
    acc = 1
    for i in range(L):
        pows[i] = acc
        acc = (acc * _FNV_PRIME) & 0xFFFFFFFF
    return pows


class DeviceDescent:
    """One edge's device-resident descent: owns the carry state and
    the per-dispatch drive.  ``descend_edge_device`` is the
    engine-shaped wrapper; the parity tests drive this class directly
    (stepped vs in-scan at matched schedules)."""

    def __init__(self, program, edge: Tuple[int, int],
                 seeds: Sequence[bytes], *,
                 mask: Optional[Sequence[int]] = None,
                 lanes: int = 256,
                 scan_iters: int = DEFAULT_SCAN_ITERS,
                 max_len: int = 64, i2s: bool = True,
                 trace_cache: Optional[Dict] = None,
                 device="cuda"):
        self.device = dev = resolve_device(device)
        self.program = program
        self.edge = (int(edge[0]), int(edge[1]))
        self.e_idx = _edge_index(program, self.edge)
        if self.e_idx is None:
            raise ValueError("edge not in the static universe")
        seeds = [bytes(s) for s in seeds if s] or [b"\x00"]
        own = edge_objectives(program, self.edge)
        guards = _path_guards(program, self.edge, seeds,
                              cap=max(MAX_GUARDS - len(own), 0),
                              trace_cache=trace_cache)
        self.specs_objs: List[BranchObjective] = \
            (guards + own)[-MAX_GUARDS:]
        if not self.specs_objs:
            raise ValueError("unconditional edge (no deciding "
                             "branches) — host engine handles it")
        self.scan_iters = max(int(scan_iters), 1)
        self.i2s = bool(i2s)
        K = len(self.specs_objs)
        max_len = max(int(max_len), max(len(s) for s in seeds))
        self.L = max(8, ((max_len + 7) // 8) * 8)
        lay = _layout(max(int(lanes), N_ELITE + I2S_PER_GUARD * K
                          + 48), K)
        self.lanes = lay["total"]

        # per-guard dynamic byte deps (Angora's taint, read off one
        # concrete slice): the i2s write positions + probe priority
        self._mask = [p for p in (mask or []) if 0 <= p < self.L]
        deps_by_guard: List[List[int]] = []
        for obj in self.specs_objs:
            d: List[int] = []
            for s in seeds[:8]:
                sl = trace_slice(program, s, obj)
                if sl.reached:
                    d = slice_operand_deps(program, sl, obj)
                    break
            deps_by_guard.append([p for p in d if 0 <= p < self.L])
        self._set_focus(deps_by_guard)

        try:
            from ..analysis.dataflow import extract_dictionary
            toks = [bytes(t) for t in extract_dictionary(program) if t]
        except Exception:
            toks = []
        toks = [t for t in toks if len(t) <= 6][:12]
        self.n_tokens = len(toks)
        tl = max((len(t) for t in toks), default=1)
        tok_bufs = np.zeros((max(self.n_tokens, 1), tl), np.uint8)
        tok_lens = np.zeros((max(self.n_tokens, 1),), np.int32)
        for i, t in enumerate(toks):
            tok_bufs[i, :len(t)] = np.frombuffer(t, np.uint8)
            tok_lens[i] = len(t)
        self.tok_bufs, self.tok_lens = tok_bufs, tok_lens

        # zero-extended seed variants ride along (length guards need
        # longer inputs than any corpus entry — same move as the host
        # engine's population init)
        pool: List[bytes] = []
        for s in seeds:
            pool.append(s[:self.L])
            for ext in (4, 8, 16):
                if len(s) + ext <= self.L:
                    pool.append(s + b"\x00" * ext)
        e_bufs, e_lens = _pack(pool, N_ELITE, self.L)

        def i32(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        self.carry = (
            torch.as_tensor(e_bufs, device=dev),
            torch.as_tensor(e_lens, device=dev),
            torch.full((N_ELITE,), K, dtype=torch.int32, device=dev),
            torch.full((N_ELITE,), DIST_UNREACHED, dtype=torch.float32,
                       device=dev),
            torch.zeros((5,), dtype=torch.int64, device=dev),
            i32(K), i32(K), i32(K),
            torch.zeros((WITNESS_RING, self.L), dtype=torch.uint8,
                        device=dev),
            i32(WITNESS_RING), i32(WITNESS_RING), i32(WITNESS_RING),
            i32(),
            torch.tensor(DIST_UNREACHED, dtype=torch.float32, device=dev))
        self.it = 0
        self.salt = (((self.edge[0] & 0xFFFF) << 16)
                     ^ (self.edge[1] & 0xFFFF) ^ 0x6465) & M32
        lay = _layout(self.lanes, K)
        self._static = dict(
            mem_size=program.mem_size, max_steps=program.max_steps,
            n_edges=program.n_edges, specs=self.specs, e_idx=self.e_idx,
            lay=lay, fam=torch.as_tensor(_family_tags(lay), device=dev),
            pows=torch.as_tensor(_fnv_pows(self.L), device=dev),
            n_tokens=self.n_tokens, i2s=self.i2s)
        self._tables = (torch.as_tensor(program.instrs, device=dev),
                        torch.as_tensor(program.edge_table, device=dev))
        self._wit_seen = 0
        self.last_worked = 0

    def _set_focus(self, deps_by_guard: List[List[int]]) -> None:
        K = len(self.specs_objs)
        dep_pos = np.full((K, I2S_DEPS), -1, dtype=np.int32)
        n_dep = np.zeros((K,), dtype=np.int32)
        for k, d in enumerate(deps_by_guard):
            d = d[:I2S_DEPS]
            dep_pos[k, :len(d)] = d
            n_dep[k] = len(d)
        prio: List[int] = []
        for d in deps_by_guard:
            for p in d:
                if p not in prio:
                    prio.append(p)
        for p in self._mask:
            if p not in prio:
                prio.append(p)
        rest = [p for p in range(self.L) if p not in prio]
        self.pos_order = np.asarray(prio + rest, dtype=np.int32)
        self.dep_pos, self.n_dep = dep_pos, n_dep
        self._deps_by_guard = deps_by_guard

    def refresh_focus(self) -> None:
        """Between dispatches: re-derive every guard's dynamic byte
        deps from the CURRENT best elite's concrete slice (the host
        engine recomputes its probe focus per iteration; here the
        cadence is per dispatch — R iterations).  Guards the new best
        does not reach keep their previous deps, so curriculum
        progress only ever ADDS focus.  The parity pin drives
        ``dispatch()`` directly without refreshing — focus arrays are
        part of the matched schedule."""
        bufs, lens, _stage, _dist = self.elite_front()
        best = bufs[0, :int(lens[0])].tobytes()
        deps: List[List[int]] = []
        for k, obj in enumerate(self.specs_objs):
            sl = trace_slice(self.program, best, obj)
            d = slice_operand_deps(self.program, sl, obj) \
                if sl.reached else []
            d = [p for p in d if 0 <= p < self.L]
            deps.append(d or self._deps_by_guard[k])
        self._set_focus(deps)

    @property
    def specs(self) -> tuple:
        return tuple(o.spec() for o in self.specs_objs)

    def inject_candidates(self, rows: Sequence[bytes]) -> int:
        """Host-proposed candidates (the soft-KBVM gradient
        steps, chained witnesses, ...) overwrite the tail of the
        elite front between dispatches: they ride in the next batch's
        elite lanes and are scored/ranked on device like any other
        lane — proposals only, never witnesses (the honesty contract
        is enforced at the ring drain)."""
        rows = [bytes(r)[:self.L] for r in rows if r][:N_ELITE // 4]
        if not rows:
            return 0
        bufs, lens, stage, dist = self.elite_front()
        K = len(self.specs_objs)
        for i, r in enumerate(rows):
            slot = N_ELITE - 1 - i
            row = np.zeros((self.L,), np.uint8)
            row[:len(r)] = np.frombuffer(r, np.uint8)
            bufs[slot] = row
            lens[slot] = len(r)
            stage[slot] = K
            dist[slot] = np.float32(DIST_UNREACHED)
        self.carry = tuple(torch.as_tensor(a, device=self.device)
                           for a in (bufs, lens, stage, dist)) \
            + self.carry[4:]
        return len(rows)

    def soft_propose(self) -> int:
        """Host-side soft-KBVM refinement at per-dispatch cadence:
        when the current best elite's path slice to its frontier
        guard is arithmetic-only, one gradient of the relaxed
        distance proposes multi-byte steps that are injected into the
        elite tail (the host engine runs the same tier every 4th
        iteration; here it rides the dispatch boundary the engine
        already returns to the host on)."""
        bufs, lens, stage, _dist = self.elite_front()
        best = bufs[0, :int(lens[0])].tobytes()
        K = len(self.specs_objs)
        k_idx = min(max(K - 1 - int(stage[0]), 0), K - 1)
        obj = self.specs_objs[k_idx]
        sl = trace_slice(self.program, best, obj)
        if not sl.eligible:
            return 0
        return self.inject_candidates(
            soft_refine(self.program, best, obj, slice_=sl))

    def dispatch(self, iters: Optional[int] = None
                 ) -> List[Tuple[bytes, int, int]]:
        """Run ``iters`` (default ``scan_iters``) descent iterations
        on the device; returns the NEW witness ring rows as ``(buf,
        family, iteration)`` tuples in (iteration, lane) order
        (already deduped against rows seen in earlier dispatches of
        this descent).  ``iters`` exists for the TAIL dispatch of a
        budget that ``scan_iters`` does not divide — the engine never
        runs more iterations than asked (the equal-effort contract of
        every host-vs-device comparison).  ``last_worked`` holds how
        many of the dispatch's iterations actually searched: once any
        witness is in the ring the remaining iterations idle (the
        host drains, verifies and stops dispatching), so a mid-dispatch
        crack does not burn the rest of the budget executing deep
        candidates."""
        dev = self.device
        si = int(iters) if iters else self.scan_iters
        tabs = self._tables + tuple(
            torch.as_tensor(a, dtype=torch.int64, device=dev)
            for a in (self.pos_order, self.dep_pos, self.n_dep,
                      self.tok_bufs, self.tok_lens))
        carry = self.carry
        worked = 0
        for it in range(self.it, self.it + si):
            if int(carry[12]) > 0:      # early stop: a witness landed
                continue
            carry = _descent_iteration(tabs, carry, it, self.salt,
                                       **self._static)
            worked += 1
        self.carry = carry
        self.it += si
        self.last_worked = worked
        wit_bufs, wit_lens, wit_src, wit_iter = (
            a.cpu().numpy() for a in carry[8:12])
        ptr = int(carry[12])
        rows = []
        for r in range(self._wit_seen, min(ptr, WITNESS_RING)):
            rows.append((wit_bufs[r, :int(wit_lens[r])].tobytes(),
                         int(wit_src[r]), int(wit_iter[r])))
        self._wit_seen = min(ptr, WITNESS_RING)
        return rows

    def reset_witnesses(self) -> None:
        """Clear the witness ring and its host cursor.  The driver
        calls this when EVERY drained row failed reference
        verification (a device/reference divergence the honesty
        contract exists to catch): a nonzero ring pointer would
        otherwise idle every remaining iteration via the early-stop,
        silently burning the budget with zero search."""
        c = list(self.carry)
        for i in (8, 9, 10, 11, 12):
            c[i] = torch.zeros_like(c[i])
        self.carry = tuple(c)
        self._wit_seen = 0

    # -- inspection (parity pin / reports) ---------------------------

    def elite_front(self):
        """(bufs, lens, stage, dist) as numpy — the ranked order the
        parity pin compares between stepped and in-scan schedules."""
        return tuple(a.cpu().numpy() for a in self.carry[:4])

    @property
    def best_primary(self) -> float:
        return float(self.carry[13])

    @property
    def witnesses_total(self) -> int:
        """Total edge-traversing lanes observed (overflow included)."""
        return int(self.carry[12])


def descend_edge_device(program, edge: Tuple[int, int],
                        seeds: Sequence[bytes], *,
                        mask: Optional[Sequence[int]] = None,
                        lanes: int = 256,
                        budget: int = 48,
                        scan_iters: int = DEFAULT_SCAN_ITERS,
                        max_len: int = 64,
                        i2s: bool = True,
                        trace=None,
                        trace_cache: Optional[Dict] = None,
                        registry=None, device="cuda") -> DescentResult:
    """Device-resident twin of ``descent.descend_edge``: descend
    ``edge``'s branch-distance curriculum with R iterations fused per
    dispatch until a verified witness traverses it or ``budget``
    ITERATIONS are spent (budget is iteration-denominated so host/
    device comparisons run at equal search effort; dispatches =
    ceil(budget / scan_iters)).  Stands down to the host engine on
    unconditional edges.  Every witness is re-verified by the
    reference interpreter on the host before it is reported —
    identical honesty contract.  Runs on ``device`` (the card unless
    the caller passes ``"cpu"``)."""
    f_idx, t_idx = int(edge[0]), int(edge[1])
    try:
        eng = DeviceDescent(program, edge, seeds, mask=mask,
                            lanes=lanes, scan_iters=scan_iters,
                            max_len=max_len, i2s=i2s,
                            trace_cache=trace_cache, device=device)
    except ValueError as e:
        DEBUG_MSG("device descent stand-down on %d:%d (%s) — host "
                  "engine takes it", f_idx, t_idx, e)
        res = descend_edge(program, edge, seeds, mask=mask,
                           lanes=lanes, budget=budget,
                           max_len=max_len, trace=trace,
                           trace_cache=trace_cache, device=device)
        res.engine = "host"
        res.iterations = res.steps
        res.dispatches = res.steps
        return res
    if registry is not None:
        registry.gauge("descent_iterations_per_dispatch",
                       eng.scan_iters)
    dispatches = 0
    evals = 0
    soft_used = False
    remaining = max(int(budget), 1)
    first = True
    while remaining > 0:
        if not first:
            eng.refresh_focus()
            soft_used = bool(eng.soft_propose()) or soft_used
        first = False
        si = min(eng.scan_iters, remaining)
        span = (trace.span("descend_scan", lane="descent",
                           args={"edge": f"{f_idx}:{t_idx}",
                                 "iter0": eng.it,
                                 "scan_iters": si,
                                 "lanes": eng.lanes,
                                 "guards": len(eng.specs_objs)})
                if trace is not None else contextlib.nullcontext())
        with span:
            rows = eng.dispatch(si)
        dispatches += 1
        remaining -= si
        evals += eng.last_worked * eng.lanes
        for buf, fam_tag, it in rows:
            # honesty contract: the reference interpreter must agree
            # before the witness is reported
            if (f_idx, t_idx) in _concrete_trace(program, buf,
                                                 trace_cache).edges:
                if registry is not None and fam_tag == FAM_I2S:
                    registry.count("search_i2s_matches")
                return DescentResult(
                    edge=(f_idx, t_idx), status="descended",
                    input=buf, steps=it + 1, evals=evals,
                    best_dist=0.0,
                    objective=eng.specs_objs[-1].desc,
                    soft_used=soft_used,
                    engine="device", dispatches=dispatches,
                    iterations=it + 1, i2s=(fam_tag == FAM_I2S))
        if rows:
            # every drained row failed verification: clear the ring
            # or the early-stop idles the rest of the budget
            DEBUG_MSG("descend %d:%d: %d witness rows failed "
                      "reference verification — ring reset",
                      f_idx, t_idx, len(rows))
            eng.reset_witnesses()
    return DescentResult(
        edge=(f_idx, t_idx), status="exhausted",
        steps=eng.it, evals=evals, best_dist=eng.best_primary,
        objective=eng.specs_objs[-1].desc, soft_used=soft_used,
        reason=f"iteration budget exhausted ({eng.it} iterations / "
               f"{dispatches} dispatches)",
        engine="device", dispatches=dispatches, iterations=eng.it)
