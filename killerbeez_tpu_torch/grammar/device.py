"""Structured mutation — the device half of the grammar tier.

The port of the JAX package's ``grammar/device.py``.  There each
function is one lane's, vmapped in XLA (no Pallas kernel); here each
takes the whole batch at once in torch ops on the seed's device, the
card included.  Every lane of a batch mutates the same seed, so the
seed is parsed once (``parse_fields``) and the parse is broadcast.

``grammar_havoc_at`` is the structured twin of ``havoc_at``: each lane
is either BLIND (plain havoc, bit-identical stream) or STRUCTURED,
selected by a per-lane stage byte.  Structured lanes interleave
mask-constrained havoc (edits land only on mutable bytes — token
slots, free bytes, the unparsed tail; literals and length fields are
protected) with four structured ops:

* token substitution — a token from the picked field's alphabet
  overwrites the slot;
* field-aware splice — one field's bytes overwrite another's;
* subtree regeneration — every mutable byte of one rule-instance
  group is redrawn;
* length-field repair — a length field is rewritten to cover the
  net insert/delete the lane's blind edits applied.

RNG discipline (the parity anchor): the base words ``bits(key,
(n_steps+1, 8))`` and the stack draw are ``havoc_at``'s; ALL grammar
randomness comes from a side key ``fold_in(key, GRAMMAR_SALT)``, drawn
by the port's threefry (ops/prng.py) bit for bit.  Under the
degenerate grammar (``meta[0] == 0``) every lane is blind with an
all-ones mask, and an all-ones mask is bit-identical to unmasked havoc
(``_havoc_one``), so ``grammar_havoc_at`` IS ``havoc_at``.

The JAX kernels index with one-hot sums: an index out of range reads
0 (``_at``), and a rank-select over no set entry picks 0 (``_pick``).
Here they are gathers, clamped and masked so that both edge cases give
the same 0.  uint32 values travel in int64 tensors, masked to 32 bits.
The tables come twice: the host ``GrammarTables`` (numpy) gives the
parse its static field plan, and ``GrammarTables.device(dev)`` the
tensors the per-lane picks gather from.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..models.vm import _mix32
from ..ops import prng
from ..ops.mutate_core import M32, _havoc_one
from .tables import KIND_ALPHA, KIND_BLOB, KIND_LEN, GrammarTables

#: fold_in salt deriving the grammar side stream from the lane key —
#: the base havoc stream never sees it, so blind lanes (and every
#: degenerate-grammar lane) keep their exact havoc bytes
GRAMMAR_SALT = 0x6772616D


class ParsedFields(NamedTuple):
    """One forward parse of a seed against the field program."""
    offs: torch.Tensor        # int64[P] field start offsets
    effw: torch.Tensor        # int64[P] effective widths
    valid: torch.Tensor       # bool[P]  starts inside the live prefix
    mut_mask: torch.Tensor    # uint8[L] 1 = mutation may touch the byte
    grp_byte: torch.Tensor    # int64[L] rule-instance group id (-1 tail)
    edit_byte: torch.Tensor   # bool[L]  byte belongs to a mutable field


def _width_mask(w):
    """uint32 value mask for a 1/2/4-byte length field (a host int or
    an int64 tensor)."""
    if isinstance(w, int):
        return 0xFF if w == 1 else 0xFFFF if w == 2 else M32
    return torch.where(w == 1, 0xFF, torch.where(w == 2, 0xFFFF, M32))


def _scalar(x, dev) -> torch.Tensor:
    """An int or a one-element tensor as an int64 0-dim tensor on
    ``dev`` (an int is filled there, copying nothing)."""
    if isinstance(x, torch.Tensor):
        return x.reshape(()).to(device=dev, dtype=torch.int64)
    return torch.full((), int(x), dtype=torch.int64, device=dev)


def parse_fields(buf: torch.Tensor, length, tables: GrammarTables,
                 gt: Tuple) -> ParsedFields:
    """Sequential offset walk over the P field-program entries of
    ``tables`` (``gt`` = ``tables.device(dev)``) for one seed ``buf``
    uint8[L] of ``length`` (an int or a 0-dim tensor on its device).
    Length fields read their little-endian value from the buffer and
    size the entry they measure; width-0 free bytes take the measured
    width, or the rest of the live prefix.  The parse is TOTAL: any
    buffer parses, and bytes past the last entry stay mutable.  The
    field plan (kinds, widths, links) is read on the host, so the walk
    issues only the data-dependent ops."""
    dev = buf.device
    L = buf.shape[-1]
    b = buf.reshape(L).to(torch.int64)
    ln = _scalar(length, dev)
    kinds = tables.fp_kind.tolist()
    widths = tables.fp_width.tolist()
    auxs = tables.fp_aux.tolist()
    ar4 = torch.arange(4, device=dev)
    off = torch.zeros((), dtype=torch.int64, device=dev)
    offs, effw = [], []
    measured = {}       # entry -> the width a length field gave it
    for p, (kind, w, aux) in enumerate(zip(kinds, widths, auxs)):
        if kind == KIND_LEN and aux >= 0:
            # little-endian read at the current offset (positions
            # clamp into the buffer), masked to the field width, as
            # int32
            picked = b[(off + ar4).clamp(0, L - 1)]
            val = (picked << (8 * ar4)).sum() & _width_mask(w)
            val = val - ((val >> 31) << 32)
            measured[aux] = val.clamp(0, L)
        if kind == KIND_BLOB and w == 0:
            w_eff = measured.get(p, (ln - off).clamp(min=0))
        else:
            w_eff = torch.full((), w, dtype=torch.int64, device=dev)
        w_eff = torch.minimum(w_eff.clamp(min=0), (L - off).clamp(min=0))
        offs.append(off)
        effw.append(w_eff)
        off = off + w_eff
    offs = torch.stack(offs)
    effw = torch.stack(effw)
    valid = (effw > 0) & (offs < ln.clamp(min=1))
    idx = torch.arange(L, device=dev)[None, :]
    in_f = (idx >= offs[:, None]) & (idx < (offs + effw)[:, None])
    editable = (gt[0] == KIND_ALPHA) | (gt[0] == KIND_BLOB)
    edit_byte = (in_f & editable[:, None]).any(dim=0)
    covered = in_f.any(dim=0)
    # the first entry covering a byte names its group
    first = (in_f.to(torch.int64).cumsum(0) == 0).sum(0)
    P = len(kinds)
    grp = gt[3].to(torch.int64)
    grp_byte = torch.where(first < P, grp[first.clamp(max=P - 1)], -1)
    mut_mask = (edit_byte | ~covered).to(torch.uint8)
    return ParsedFields(offs=offs, effw=effw, valid=valid,
                        mut_mask=mut_mask, grp_byte=grp_byte,
                        edit_byte=edit_byte)


def _pick(pred: torch.Tensor, word: torch.Tensor):
    """Per lane, the ``word % count``-th set entry of ``pred`` (bool[P],
    one for every lane), and the count.  No set entry picks 0, as the
    JAX argmax of all-False does."""
    cs = pred.to(torch.int64).cumsum(0)
    cnt = cs[-1]
    k = word % cnt.clamp(min=1)
    f = torch.searchsorted(cs, k, right=True)
    return torch.where(f < pred.shape[0], f, 0), cnt


def _at(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """arr[i] per lane (int64), 0 where ``i`` is out of range."""
    n = arr.shape[0]
    ok = (i >= 0) & (i < n)
    return torch.where(ok, arr.to(torch.int64)[i.clamp(0, n - 1)], 0)


def _structured_one(buf, length, seed_len, gw, pf: ParsedFields, gt):
    """One structured edit for every lane: op = ``gw[:, 0] % 4`` over
    (token sub, field splice, subtree regen, length repair).  ``buf``
    int64[B, L], ``length`` int64[B], ``seed_len`` the parsed seed's
    length (0-dim), ``gw`` int64[B, 8] side words.  Every op guards its
    own applicability (no alphabet fields / a single field / no length
    fields -> no-op) so any grammar is safe on any buffer."""
    fp_kind, fp_width, fp_aux, fp_grp = gt[0], gt[1], gt[2], gt[3]
    tok, tok_len, alpha_tok, alpha_n = gt[4], gt[5], gt[6], gt[7]
    dev = buf.device
    L = buf.shape[-1]
    idx = torch.arange(L, device=dev)[None, :]
    sop = gw[:, 0] % 4

    # -- op 0: token substitution ------------------------------------
    pred_a = pf.valid & (fp_kind == KIND_ALPHA)
    f_a, cnt_a = _pick(pred_a, gw[:, 1])
    off_a = _at(pf.offs, f_a)
    w_a = _at(pf.effw, f_a)
    row = _at(fp_aux, f_a)
    K, AC = alpha_tok.shape
    an = _at(alpha_n, row)
    slot = gw[:, 2] % an.clamp(min=1)
    row_ok = (row >= 0) & (row < K)
    tid = torch.where(
        row_ok & (slot < AC),
        alpha_tok.to(torch.int64)[row.clamp(0, K - 1),
                                  slot.clamp(max=AC - 1)], 0)
    T, TW = tok.shape
    tl = _at(tok_len, tid)
    tid_ok = (tid >= 0) & (tid < T)
    tbytes = torch.where(tid_ok[:, None],
                         tok.to(torch.int64)[tid.clamp(0, T - 1)], 0)
    rel_a = idx - off_a[:, None]
    wlim = torch.minimum(tl.clamp(min=1), w_a.clamp(min=1))
    tval = tbytes.gather(1, rel_a.clamp(0, TW - 1))
    in_a = (rel_a >= 0) & (rel_a < wlim[:, None]) \
        & ((cnt_a > 0) & (an > 0))[:, None]
    out0 = torch.where(in_a, tval, buf)

    # -- op 1: field-aware splice (field g's bytes over field f) -----
    f_s, cnt_s = _pick(pf.valid, gw[:, 1])
    g_s, _ = _pick(pf.valid, gw[:, 3])
    off_f = _at(pf.offs, f_s)[:, None]
    off_g = _at(pf.offs, g_s)[:, None]
    wmin = torch.minimum(_at(pf.effw, f_s), _at(pf.effw, g_s))[:, None]
    spliced = buf.gather(1, (idx - off_f + off_g).clamp(0, L - 1))
    in_s = (idx >= off_f) & (idx < off_f + wmin) & (cnt_s >= 2)
    out1 = torch.where(in_s, spliced, buf)

    # -- op 2: subtree regeneration ----------------------------------
    # pick a mutable field, redraw every mutable byte of its rule-
    # instance group; literals and length fields in the group keep
    # their bytes — structure survives its own regeneration
    pred_e = pf.valid & ((fp_kind == KIND_ALPHA) | (fp_kind == KIND_BLOB))
    f_e, cnt_e = _pick(pred_e, gw[:, 1])
    grp_f = _at(fp_grp, f_e)
    rnd = _mix32(((idx * 0x9E3779B9) & M32) ^ gw[:, 4:5]) & 0xFF
    in_g = (pf.grp_byte[None, :] == grp_f[:, None]) \
        & pf.edit_byte[None, :] & (cnt_e > 0)
    out2 = torch.where(in_g, rnd, buf)

    # -- op 3: length-field repair -----------------------------------
    # rewrite one length field to its parse-time measured width plus
    # the lane's net length delta, so the structure the parser sees
    # tracks the blind edits
    pred_l = pf.valid & (fp_kind == KIND_LEN) & (fp_aux >= 0)
    f_l, cnt_l = _pick(pred_l, gw[:, 1])
    w_m = _at(pf.effw, _at(fp_aux, f_l))
    off_l = _at(pf.offs, f_l)
    w_l = _at(fp_width, f_l)
    new_u = (w_m + (length - seed_len)).clamp(0, 0x7FFFFFFF) \
        & _width_mask(w_l)
    rel_l = idx - off_l[:, None]
    lbytes = (new_u[:, None] >> (8 * rel_l.clamp(0, 3))) & 0xFF
    in_l = (rel_l >= 0) & (rel_l < w_l[:, None]) & (cnt_l > 0)
    out3 = torch.where(in_l, lbytes, buf)

    sop = sop[:, None]
    return torch.where(sop == 0, out0,
                       torch.where(sop == 1, out1,
                                   torch.where(sop == 2, out2, out3)))


def grammar_from_ring(ring, ring_lens, sel, base_key, its, tables, gt,
                      stack_pow2=4):
    """``havoc_from_ring``'s structured twin: ring row ``sel`` (an int32
    scalar tensor, read on the device) mutated by ``grammar_havoc_at``
    with each lane's key ``fold_in(base_key, its)``.  Returns (bufs
    uint8[B, L], lens int32[B])."""
    slot = sel.reshape(1).long()
    seed = ring.index_select(0, slot)[0]
    seed_len = ring_lens.index_select(0, slot)[0]
    return grammar_havoc_at(seed, seed_len, prng.fold_in(base_key, its),
                            tables, gt, stack_pow2)


def grammar_havoc_at(buf: torch.Tensor, length, keys: torch.Tensor,
                     tables: GrammarTables, gt: Tuple,
                     stack_pow2: int = 4):
    """``havoc_at`` with grammar-structured stages interleaved, for
    every lane of one seed: ``buf`` uint8[L] and ``length`` (an int or
    a 0-dim tensor) on the keys' device, ``keys`` int64[B, 2] raw lane
    keys, ``tables`` the compiled grammar and ``gt`` its
    ``tables.device(dev)`` tensors.  Returns (uint8[B, L], int32[B]).

    The base words and stack draw are ``havoc_at``'s; grammar
    randomness comes only from the ``GRAMMAR_SALT`` side key.  A lane's
    stage byte (side stream) selects blind or structured: blind lanes
    run unmasked-equivalent havoc (all-ones mask); structured lanes
    constrain havoc to mutable bytes and replace 3 of every 4 stacked
    edits with a structured op.  ``meta[0] == 0`` (the degenerate
    grammar) makes every lane blind: the bit-exactness anchor."""
    dev = keys.device
    n_steps = 1 << stack_pow2
    n_words = (n_steps + 1) * 8
    b = keys.shape[0]
    L = buf.shape[-1]
    words = prng.bits(keys, n_words)
    gwords = prng.bits(prng.fold_in(keys, GRAMMAR_SALT), n_words)
    stack = 1 << (1 + words[:, 0] % stack_pow2)
    seed = buf.reshape(L).to(dev)
    seed_len = _scalar(length, dev)
    pf = parse_fields(seed, seed_len, tables, gt)
    meta = gt[8]
    structured = (meta[0] != 0) & ((gwords[:, 0] % 256) < meta[1])
    mask = torch.where(structured[:, None], pf.mut_mask[None, :], 1)
    out = seed.to(torch.int64).expand(b, L)
    ln = seed_len.expand(b)
    for i in range(n_steps):
        w = words[:, (i + 1) * 8:(i + 2) * 8]
        gw = gwords[:, (i + 1) * 8:(i + 2) * 8]
        nb, nln = _havoc_one(out, ln, w, mask=mask)
        sb = _structured_one(out, ln, seed_len, gw, pf, gt)
        use_s = structured & ((gw[:, 7] & 3) != 0)
        nb = torch.where(use_s[:, None], sb, nb)
        nln = torch.where(use_s, ln, nln)
        active = i < stack
        out = torch.where(active[:, None], nb, out)
        ln = torch.where(active, nln, ln)
    return out.to(torch.uint8), ln.to(torch.int32)
