"""Mutation over fixed-size byte tensors, batched in PyTorch.

The port of the JAX package's ``ops/mutate_core.py``.  There every
kernel is a pure function of ``(buf uint8[L], length, iteration or
PRNG key)`` vmapped over the lane axis; here each function takes the
whole batch at once — ``buf`` uint8[L] (one seed, broadcast) or
uint8[B, L], ``length`` an int or an int tensor [B], and one
iteration number or key per lane — and returns ``(uint8[B, L],
int32[B])``.  Deterministic walks decode an iteration number into an
exact mutation (AFL's walking order); keyed edits draw from
``ops/prng.py``, bit-identical to ``jax.random``.

Buffers are padded to a static L; ``length`` tracks the live prefix.
JAX gathers clamp an out-of-range index and its scatters drop one;
every read here clamps explicitly and every write is a compare-select
against the position, so nothing indexes out of range on the card.

``havoc_at`` is the plain version of the fused CUDA kernel's havoc
prologue (``csrc/vm_kernel.cu``) and the unfused havoc mutator's path.
Its random bits are an INPUT: ``words`` holds each lane's
``(2**stack_pow2 + 1) * 8`` uint32 words, drawn by
``ops/vm_kernel.havoc_words_for_keys`` exactly as ``havoc_at`` draws
them in JAX (one ``jax.random.bits(key, (n_steps + 1, 8))`` per lane).
Every havoc edit reads the whole PRE-edit buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prng

M32 = 0xFFFFFFFF
ARITH_MAX = 35  # AFL's bound for +/- arithmetic walks

INTERESTING_8 = np.array(
    [-128, -1, 0, 1, 16, 32, 64, 100, 127], dtype=np.int32)
INTERESTING_16 = np.array(
    [-32768, -129, 128, 255, 256, 512, 1000, 1024, 4096, 32767],
    dtype=np.int32)
INTERESTING_32 = np.array(
    [-2147483648, -100663046, -32769, 32768, 65535, 65536, 100663045,
     2147483647], dtype=np.int64)

N_HAVOC_OPS = 15


# the interesting-value tables on each device they were asked for:
# copying them from the host on every edit would wait for the device's
# queued work
_TABLES_ON = {}


def _table(values, mask, device):
    key = (id(values), mask, device)
    t = _TABLES_ON.get(key)
    if t is None:
        t = _TABLES_ON[key] = torch.as_tensor(
            values.astype(np.int64) & mask, dtype=torch.int64,
            device=device)
    return t


def _havoc_one(buf, length, w, positions=None, mask=None):
    """One stacked havoc edit for every lane.

    buf int64[B, L] byte values, length int64[B], w int64[B, 8] uint32
    words, ``positions`` an optional int64[P] focus byte set, ``mask``
    an optional dense uint8 mask ([L] for every lane, or [B, L]).
    Returns (buf', length').  Op table (AFL havoc mix): 0 bit flip, 1-3
    interesting 8/16/32, 4-9 arith +/- on 8/16/32, 10 xor byte, 11-12
    delete block, 13 insert clone/fill block, 14 overwrite clone/fill
    block — each expressed as

        out[i] = set_mask[i] ? set_val[i] : buf[src[i]] ^ xor_mask[i]
    """
    dev = buf.device
    L = buf.shape[1]
    w0, w1, w2, w3, w4, w5, w6, w7 = w.unbind(1)
    op = w0 % N_HAVOC_OPS
    maxlen = length.clamp(min=1)
    pos = w1 % maxlen
    pos2 = w2 % maxlen
    rbyte = w3 % 256
    rint = w4 & 0x7FFFFFFF
    be = (w5 & 1) == 1
    blk_span = torch.div(length, 2, rounding_mode="floor").clamp(min=2) - 1
    blk = 1 + w6 % blk_span.clamp(min=1)
    bit = w7 % (length * 8).clamp(min=1)
    if positions is not None:
        # Angora-style focus: anchor the primary edit position (and
        # the bit-flip byte) on the frontier-dependency byte set
        # instead of the whole buffer.  Clone sources (pos2) and block
        # spans stay unrestricted: material may come from anywhere, it
        # just lands on a frontier byte.
        n_pos = positions.shape[0]
        lim = maxlen - 1
        pos = torch.minimum(positions[w1 % n_pos], lim)
        bit = torch.minimum(positions[w7 % n_pos], lim) * 8 \
            + (w7 >> 16) % 8
    elif mask is not None:
        # dense per-byte mask (the grammar tier's mutable bytes, the
        # learn tier's saliency): the primary edit position and the
        # bit-flip byte are the k-th allowed byte of the live prefix for
        # k = word % count.  An ALL-ONES mask is bit-identical to the
        # unmasked draw (count == maxlen, the k-th allowed byte is byte
        # k, and maxlen * 8 == max(length * 8, 1) for length >= 1); an
        # all-zero mask falls back to uniform over the live prefix.
        # Clone sources and block spans stay unrestricted, as in the
        # ``positions`` focus variant.
        live = torch.arange(L, device=dev)[None, :] < maxlen[:, None]
        allowed = (mask != 0) & live
        allowed = allowed | (~allowed.any(dim=1, keepdim=True) & live)
        cs = allowed.to(torch.int64).cumsum(1)
        cnt = cs[:, -1]

        def rank(k):
            # the first byte whose running count passes k (k < cnt)
            return torch.searchsorted(cs, k[:, None], right=True)[:, 0]

        pos = rank(w1 % cnt)
        bk = w7 % (cnt * 8)
        bit = rank(bk >> 3) * 8 + (bk & 7)
    delta = rint % ARITH_MAX + 1
    use_fill = (rint % 4) == 0

    is_flip = op == 0
    is_int = (op >= 1) & (op <= 3)
    is_arith = (op >= 4) & (op <= 9)
    is_xor = op == 10
    is_del = (op == 11) | (op == 12)
    is_ins = op == 13
    is_ovw = op == 14
    is_write = is_int | is_arith

    one, two, four = (torch.full_like(op, v) for v in (1, 2, 4))
    width = torch.where(
        is_int, torch.where(op == 1, one, torch.where(op == 2, two, four)),
        torch.where(is_arith,
                    torch.where(op <= 5, one,
                                torch.where(op <= 7, two, four)),
                    one))
    i8 = _table(INTERESTING_8, 0xFF, dev)
    i16 = _table(INTERESTING_16, 0xFFFF, dev)
    i32 = _table(INTERESTING_32, M32, dev)
    int_val = torch.where(
        op == 1, i8[rint % len(INTERESTING_8)],
        torch.where(op == 2, i16[rint % len(INTERESTING_16)],
                    i32[rint % len(INTERESTING_32)]))

    # LE dword at pos, bytes at clipped positions
    k4 = (pos[:, None] + torch.arange(4, device=dev)[None, :]).clamp(
        0, L - 1)
    b4 = buf.gather(1, k4)
    cur = b4[:, 0] | (b4[:, 1] << 8) | (b4[:, 2] << 16) | (b4[:, 3] << 24)
    swap2 = ((cur & 0xFF) << 8) | ((cur >> 8) & 0xFF)
    swap4 = (((cur & 0xFF) << 24) | ((cur & 0xFF00) << 8)
             | ((cur >> 8) & 0xFF00) | ((cur >> 24) & 0xFF))
    cur_w = torch.where(
        width == 1, cur & 0xFF,
        torch.where(width == 2, torch.where(be, swap2, cur & 0xFFFF),
                    torch.where(be, swap4, cur)))
    sign_add = (op == 5) | (op == 7) | (op == 9)
    d = torch.where(sign_add, delta, (-delta) & M32)
    arith_val = (cur_w + d) & M32
    wmask = torch.where(width == 1, 0xFF,
                        torch.where(width == 2, 0xFFFF, M32))
    write_val = torch.where(is_arith, arith_val, int_val) & wmask

    idx = torch.arange(L, device=dev)[None, :]
    pos_, pos2_, blk_ = pos[:, None], pos2[:, None], blk[:, None]
    src_del = torch.where(idx >= pos_, idx + blk_, idx)
    in_ins = (idx >= pos_) & (idx < pos_ + blk_)
    src_ins = torch.where(idx >= pos_ + blk_, idx - blk_,
                          torch.where(in_ins, pos2_ + (idx - pos_), idx))
    src_ovw = torch.where(in_ins & ~use_fill[:, None],
                          pos2_ + (idx - pos_), idx)
    src = torch.where(is_del[:, None], src_del,
                      torch.where(is_ins[:, None], src_ins,
                                  torch.where(is_ovw[:, None], src_ovw,
                                              idx)))
    gathered = buf.gather(1, src.clamp(0, L - 1))

    xval = torch.where(is_flip, 128 >> (bit & 7), rbyte.clamp(min=1))
    xbyte = torch.where(is_flip, bit >> 3, pos)
    xor_mask = torch.where((idx == xbyte[:, None])
                           & (is_flip | is_xor)[:, None],
                           xval[:, None], 0)

    off = idx - pos_
    k = torch.where(be[:, None], width[:, None] - 1 - off, off)
    vbytes = (write_val[:, None] >> (8 * k.clamp(0, 3))) & 0xFF
    in_write = is_write[:, None] & (off >= 0) & (off < width[:, None])
    in_fill = ((is_ins | is_ovw) & use_fill)[:, None] & in_ins
    set_val = torch.where(in_write, vbytes, rbyte[:, None])
    out = torch.where(in_write | in_fill, set_val, gathered ^ xor_mask)
    new_len = torch.where(is_del, (length - blk).clamp(min=1),
                          torch.where(is_ins, (length + blk).clamp(max=L),
                                      length))
    return out, new_len


def havoc_at(buf: torch.Tensor, length, words: torch.Tensor,
             stack_pow2: int = 4, positions=None, mask=None):
    """AFL-style havoc for every lane: ``buf`` uint8[L] (one seed,
    broadcast) or uint8[B, L], ``length`` int or int[B], ``words``
    [B, (2**stack_pow2 + 1) * 8] uint32 bits (int32 or int64 tensor).
    Lane b applies ``1 << (1 + words[b, 0] % stack_pow2)`` stacked
    edits.  ``positions`` (``havoc_focus_at``) anchors each edit on a
    focus byte set, ``mask`` (``havoc_mask_at``) on the set bytes of a
    dense mask.  Returns (uint8[B, L], int32[B])."""
    n_steps = 1 << stack_pow2
    b = words.shape[0]
    w = words.to(torch.int64) & M32
    if w.shape[1] != (n_steps + 1) * 8:
        raise ValueError(f"words has {w.shape[1]} columns but "
                         f"stack_pow2={stack_pow2} needs "
                         f"{(n_steps + 1) * 8}")
    dev = words.device
    out = buf.to(device=dev, dtype=torch.int64).expand(
        b, buf.shape[-1]).clone()
    ln = lanes(out, length, b)[1].clone()
    stack = 1 << (1 + w[:, 0] % stack_pow2)
    if positions is not None:
        positions = torch.as_tensor(positions, dtype=torch.int64,
                                    device=dev)
    for i in range(n_steps):
        nb, nln = _havoc_one(out, ln, w[:, (i + 1) * 8:(i + 2) * 8],
                             positions, mask)
        active = i < stack
        out = torch.where(active[:, None], nb, out)
        ln = torch.where(active, nln, ln)
    return out.to(torch.uint8), ln.to(torch.int32)


def havoc_focus_at(buf: torch.Tensor, length, words: torch.Tensor,
                   positions, stack_pow2: int = 4):
    """``havoc_at`` with edit positions drawn from ``positions``
    (int[P], the frontier-dependency byte set from the static layer).
    The words are drawn exactly as for ``havoc_at`` (one threefry bulk
    draw per lane key); only the edit positions differ, so a campaign
    without a mask keeps its exact unfocused candidate stream."""
    return havoc_at(buf, length, words, stack_pow2, positions=positions)


def havoc_mask_at(buf: torch.Tensor, length, words: torch.Tensor,
                  mask: torch.Tensor, stack_pow2: int = 4):
    """``havoc_at`` with edit positions drawn from the SET bytes of a
    dense uint8 ``mask`` ([L] for every lane, or [B, L]), on the mask's
    device.  The words are ``havoc_at``'s; with an all-ones mask every
    edit is bit-identical to ``havoc_at``'s."""
    return havoc_at(buf, length, words, stack_pow2,
                    mask=mask.to(words.device))


# --------------------------------------------------------------------
# lanes and primitive byte/bit edits (compare-select; reads clamp)
# --------------------------------------------------------------------

def lanes(buf: torch.Tensor, length, n: int):
    """(uint8[n, L], int64[n]): a seed uint8[L] broadcast to ``n``
    lanes (a batch [n, L] as it is) and its length per lane.  A Python
    int length is filled on the device, copying nothing."""
    b = buf.expand(n, buf.shape[-1]) if buf.dim() == 1 else buf
    if isinstance(length, torch.Tensor):
        ln = length.to(device=buf.device, dtype=torch.int64).expand(n)
    else:
        ln = torch.full((n,), int(length), dtype=torch.int64,
                        device=buf.device)
    return b, ln


def _idx(L: int, dev) -> torch.Tensor:
    return torch.arange(L, device=dev)[None, :]


def _col(x):
    """A per-lane parameter as a [B, 1] column (Python scalars stay)."""
    return x[:, None] if isinstance(x, torch.Tensor) and x.dim() == 1 \
        else x


def _sel(cond, a, b):
    """``torch.where`` that also takes a Python bool condition."""
    if isinstance(cond, bool):
        return a if cond else b
    return torch.where(cond, a, b)


def _fill(fill):
    """A fill byte per lane as a uint8 column (a Python int stays)."""
    return _col(fill.to(torch.uint8)) if isinstance(fill, torch.Tensor) \
        else fill


def flip_bits(buf: torch.Tensor, start_bit: torch.Tensor,
              num_bits: int) -> torch.Tensor:
    """Flip ``num_bits`` consecutive bits from ``start_bit`` (int64[B])
    in each lane of ``buf`` (uint8[B, L]), MSB-first within each byte
    (AFL's FLIP_BIT: 128 >> (b & 7)); bits past L are dropped."""
    idx = _idx(buf.shape[-1], buf.device)
    mask = torch.zeros(buf.shape, dtype=torch.int64, device=buf.device)
    for j in range(num_bits):
        b = start_bit[:, None] + j
        mask = mask | torch.where(idx == b >> 3, 128 >> (b & 7), 0)
    return buf ^ mask.to(torch.uint8)


def write_bytes(buf: torch.Tensor, pos, value, width: int,
                big_endian=False) -> torch.Tensor:
    """Overwrite ``width`` bytes at ``pos`` with the uint32 ``value``
    (int64 per lane), little- or big-endian (a bool per lane, or one
    for all)."""
    off = _idx(buf.shape[-1], buf.device) - _col(pos)
    k = _sel(_col(big_endian), width - 1 - off, off)
    vbytes = (_col(value) >> (8 * k.clamp(0, width - 1))) & 0xFF
    in_range = (off >= 0) & (off < width)
    return torch.where(in_range, vbytes.to(torch.uint8), buf)


def read_bytes(buf: torch.Tensor, pos: torch.Tensor, width: int,
               big_endian=False) -> torch.Tensor:
    """Read ``width`` bytes at ``pos`` (clamped into the buffer) as a
    uint32 per lane (int64[B])."""
    L = buf.shape[-1]
    k = (pos[:, None] + torch.arange(width, device=buf.device)).clamp(
        0, L - 1)
    picked = buf.gather(1, k).to(torch.int64)
    le = sum(picked[:, j] << (8 * j) for j in range(width))
    be = sum(picked[:, j] << (8 * (width - 1 - j)) for j in range(width))
    return _sel(big_endian, be, le)


def delete_block(buf, length, pos, del_len):
    """Remove ``del_len`` bytes at ``pos`` (a shift-left gather)."""
    L = buf.shape[-1]
    idx = _idx(L, buf.device)
    src = torch.where(idx >= _col(pos), idx + _col(del_len), idx)
    out = buf.gather(1, src.clamp(0, L - 1))
    return out, (length - del_len).clamp(min=1)


def insert_block(buf, length, pos, ins_len, src_pos, fill, use_fill):
    """Insert ``ins_len`` bytes at ``pos``: a copy from ``src_pos``
    (clone) or the constant byte ``fill``; the length is clamped to
    the buffer."""
    L = buf.shape[-1]
    idx = _idx(L, buf.device)
    pos_, n_, src_ = _col(pos), _col(ins_len), _col(src_pos)
    after = idx >= pos_ + n_
    inside = (idx >= pos_) & ~after
    shifted = buf.gather(1, (idx - n_).clamp(0, L - 1).expand(buf.shape))
    cloned = buf.gather(1, (src_ + (idx - pos_)).clamp(0, L - 1).expand(
        buf.shape))
    ins = _sel(_col(use_fill), _fill(fill), cloned)
    out = torch.where(after, shifted, torch.where(inside, ins, buf))
    return out, (length + ins_len).clamp(max=L)


def overwrite_block(buf, pos, blk_len, src_pos, fill, use_fill):
    """Overwrite ``blk_len`` bytes at ``pos`` with a copy from
    ``src_pos`` or the constant byte ``fill``."""
    L = buf.shape[-1]
    idx = _idx(L, buf.device)
    pos = _col(pos)
    inside = (idx >= pos) & (idx < pos + _col(blk_len))
    cloned = buf.gather(1, (_col(src_pos) + (idx - pos)).clamp(
        0, L - 1).expand(buf.shape))
    return torch.where(inside, _sel(_col(use_fill), _fill(fill), cloned),
                       buf)


# --------------------------------------------------------------------
# deterministic walks (iteration number -> exact mutation), vectorised
# over one iteration number per lane; JAX decodes them in int32
# --------------------------------------------------------------------

def bit_flip_total(length_bytes: int, num_bits: int) -> int:
    """Iterations of a bit_flip walk: one start per bit, each
    flipping ``num_bits`` consecutive bits."""
    return max(length_bytes * 8 - (num_bits - 1), 0)


def bit_flip_at(buf, length, its: torch.Tensor, num_bits: int = 1):
    """Iteration ``its[i]`` of the bit_flip walk for lane i: flip bits
    [it, it + num_bits)."""
    b, ln = lanes(buf, length, its.shape[0])
    return flip_bits(b, prng.wrap_i32(its), num_bits), ln.to(torch.int32)


def arithmetic_total(length_bytes: int) -> int:
    """Iterations of the arithmetic walk: widths 1/2/4 bytes x
    positions x ARITH_MAX deltas x {+,-} x {LE, BE for w > 1}."""
    n = 0
    for w, ends in ((1, 1), (2, 2), (4, 2)):
        n += max(length_bytes - w + 1, 0) * ARITH_MAX * 2 * ends
    return n


def _split_walk(local, inner, ends):
    """local = ((pos * inner + v) * ends + e) -> (pos, v, e)."""
    e = local % ends
    rest = local // ends
    return rest // inner, rest % inner, e


def _arith_decode(it, length):
    """Iteration numbers -> (width_sel 0/1/2 for 1/2/4 bytes, pos,
    delta 1..35, sign, big-endian), per lane.  Stage layout per width
    w: position-major, then delta, then sign, then endianness; stage
    sizes follow each lane's live length."""
    it = prng.wrap_i32(it)
    s1, s2, _ = ((length - w + 1).clamp(min=0) * ARITH_MAX * 2 * ends
                 for w, ends in ((1, 1), (2, 2), (4, 2)))
    in1 = it < s1
    in2 = ~in1 & (it < s1 + s2)
    local = torch.where(in1, it, torch.where(in2, it - s1, it - s1 - s2))
    width_sel = torch.where(in1, 0, torch.where(in2, 1, 2))
    # ((pos * ARITH_MAX + (delta - 1)) * 2 + sign) * ends + be
    p1, r1, b1 = _split_walk(local, 2 * ARITH_MAX, 1)
    p2, r2, b2 = _split_walk(local, 2 * ARITH_MAX, 2)
    pos = torch.where(in1, p1, p2)
    rest = torch.where(in1, r1, r2)
    be = torch.where(in1, b1, b2)
    return width_sel, pos, rest // 2 + 1, rest % 2, be


def arithmetic_at(buf, length, its: torch.Tensor):
    """Iteration ``its[i]`` of the arithmetic walk for lane i: add or
    subtract a delta at a position, width 1/2/4, both endiannesses for
    the wide ones."""
    b, ln = lanes(buf, length, its.shape[0])
    width_sel, pos, delta, sign, be = _arith_decode(its, ln)
    sdelta = torch.where(sign == 0, delta, -delta) & M32
    big = be == 1
    outs = [write_bytes(b, pos, (read_bytes(b, pos, w, big) + sdelta)
                        & ((1 << (8 * w)) - 1), w, big)
            for w in (1, 2, 4)]
    ws = width_sel[:, None]
    out = torch.where(ws == 0, outs[0],
                      torch.where(ws == 1, outs[1], outs[2]))
    return out, ln.to(torch.int32)


def interesting_total(length_bytes: int) -> int:
    n = max(length_bytes, 0) * len(INTERESTING_8)
    n += max(length_bytes - 1, 0) * len(INTERESTING_16) * 2
    n += max(length_bytes - 3, 0) * len(INTERESTING_32) * 2
    return n


def _interesting_decode(it, length):
    """Iteration numbers -> (width_sel, pos, value index, big-endian)
    per lane: 8-bit values (one end), then 16 and 32 (both ends)."""
    it = prng.wrap_i32(it)
    n8, n16, n32 = len(INTERESTING_8), len(INTERESTING_16), \
        len(INTERESTING_32)
    s8 = length.clamp(min=0) * n8
    s16 = (length - 1).clamp(min=0) * n16 * 2
    in8 = it < s8
    in16 = ~in8 & (it < s8 + s16)
    local = torch.where(in8, it, torch.where(in16, it - s8, it - s8 - s16))
    width_sel = torch.where(in8, 0, torch.where(in16, 1, 2))
    p8, v8, _ = _split_walk(local, n8, 1)
    p16, v16, b16 = _split_walk(local, n16, 2)
    p32, v32, b32 = _split_walk(local, n32, 2)
    pos = torch.where(in8, p8, torch.where(in16, p16, p32))
    val_i = torch.where(in8, v8, torch.where(in16, v16, v32))
    be = torch.where(in8, 0, torch.where(in16, b16, b32))
    return width_sel, pos, val_i, be


def interesting_at(buf, length, its: torch.Tensor):
    """Iteration ``its[i]`` of the interesting-value walk for lane i."""
    b, ln = lanes(buf, length, its.shape[0])
    width_sel, pos, val_i, be = _interesting_decode(its, ln)
    dev = b.device
    big = be == 1
    outs = []
    for w, vals, mask in ((1, INTERESTING_8, 0xFF),
                          (2, INTERESTING_16, 0xFFFF),
                          (4, INTERESTING_32, M32)):
        v = _table(vals, mask, dev)[val_i.clamp(0, len(vals) - 1)]
        outs.append(write_bytes(b, pos, v, w, big if w > 1 else False))
    ws = width_sel[:, None]
    out = torch.where(ws == 0, outs[0],
                      torch.where(ws == 1, outs[1], outs[2]))
    return out, ln.to(torch.int32)


def dictionary_total(length_bytes: int, n_tokens: int) -> int:
    # per token: overwrite at each position + insert at each position
    return n_tokens * (2 * max(length_bytes, 1))


def dictionary_at(buf, length, its: torch.Tensor, tokens: torch.Tensor,
                  token_lens: torch.Tensor):
    """Iteration ``its[i]`` of the dictionary walk for lane i: token t
    overwritten at position p (first half of t's block) or inserted at
    p (second half).  ``tokens`` uint8[N, TL] zero-padded,
    ``token_lens`` int[N]."""
    b, ln = lanes(buf, length, its.shape[0])
    it = prng.wrap_i32(its)
    n_tokens, tl = tokens.shape
    L = b.shape[-1]
    m = ln.clamp(min=1)
    per_tok = 2 * m
    tok_i = ((it // per_tok) % n_tokens).clamp(0, n_tokens - 1)
    local = it % per_tok
    insert = local >= m
    pos = torch.where(insert, local - m, local)
    tok = tokens[tok_i]
    tlen = token_lens.to(torch.int64)[tok_i]
    idx = _idx(L, b.device)
    inside = (idx >= pos[:, None]) & (idx < (pos + tlen)[:, None])
    tbytes = tok.gather(1, (idx - pos[:, None]).clamp(0, tl - 1))
    ow = torch.where(inside, tbytes, b)
    ow_len = torch.maximum(ln, (pos + tlen).clamp(max=L))
    ins, ins_len = insert_block(b, ln, pos, tlen, 0, 0, False)
    ins = torch.where(inside, tbytes, ins)
    out = torch.where(insert[:, None], ins, ow)
    return out, torch.where(insert, ins_len, ow_len).to(torch.int32)


# --------------------------------------------------------------------
# keyed edits: keys int64[B, 2], one jax.random key per lane
# --------------------------------------------------------------------

def zzuf_at(buf, length, keys: torch.Tensor, ratio: float = 0.004):
    """zzuf: flip each bit of the live prefix independently with
    probability ``ratio`` (a float32 comparison, as in JAX)."""
    b, ln = lanes(buf, length, keys.shape[0])
    n, L = b.shape
    hit = prng.bernoulli(keys, ratio, L * 8).view(n, L, 8)
    weights = torch.full((8,), 128, dtype=torch.int64, device=b.device) \
        >> torch.arange(8, device=b.device)
    mask = (hit.to(torch.int64) * weights).sum(-1)       # packbits, big
    mask = torch.where(_idx(L, b.device) < ln[:, None], mask, 0)
    return b ^ mask.to(torch.uint8), ln.to(torch.int32)


def zzuf_focus_at(buf, length, keys: torch.Tensor, positions,
                  ratio: float = 0.004):
    """``zzuf_at`` restricted to the focus byte set, with the flip
    ratio rescaled by buffer/mask size (in float32, as the JAX package
    rescales it) so the EXPECTED flip count is preserved — a 2-byte
    mask on a 64-byte buffer at the default ratio would otherwise
    leave ~94% of candidates byte-identical to the seed."""
    L = buf.shape[-1]
    scaled = np.minimum(np.float32(ratio) * np.float32(L)
                        / np.float32(positions.shape[0]), np.float32(1.0))
    out, ln = zzuf_at(buf, length, keys, scaled)
    positions = torch.as_tensor(positions, device=out.device)
    allowed = (_idx(L, out.device)[0, :, None]
               == positions[None, :]).any(dim=1)
    return torch.where(allowed, out, buf.to(out.device)), ln


def splice_at(buf_a, len_a, buf_b: torch.Tensor, len_b: torch.Tensor,
              keys: torch.Tensor):
    """Splice: the head of A up to a random cut, then the tail of B
    (uint8[B, L] partners, one per lane) from its own random cut (the
    AFL splice stage)."""
    a, la = lanes(buf_a, len_a, keys.shape[0])
    lb = len_b.to(torch.int64)
    L = a.shape[-1]
    cut_a, cut_b = prng.randint(
        prng.split(keys, 2), 1,
        torch.stack([la.clamp(min=2), lb.clamp(min=2)], dim=-1)).unbind(-1)
    idx = _idx(L, a.device)
    # JAX clips to L - 1 and its gather clamps again to B's own width
    from_b = buf_b.gather(1, (cut_b[:, None] + idx - cut_a[:, None]).clamp(
        0, min(L, buf_b.shape[-1]) - 1))
    out = torch.where(idx < cut_a[:, None], a, from_b)
    new_len = (cut_a + lb - cut_b).clamp(1, L)
    out = torch.where(idx < new_len[:, None], out, 0)
    return out, new_len.to(torch.int32)


# --------------------------------------------------------------------
# honggfuzz-style mangle (a distinct op mix from havoc)
# --------------------------------------------------------------------

MANGLE_MAGICS = np.array([0x00, 0x01, 0x7F, 0x80, 0xFF, 0x41, 0x25, 0x2F],
                         dtype=np.int64)


def _mangle_draws(keys, length):
    """The six draws of one mangle op for each key (``keys`` [..., 2],
    ``length`` broadcast to [...]): op, pos, pos2, run, rbyte and the
    magic index, as one ``randint`` over the six split keys."""
    ks = prng.split(keys, 6)
    live = length.clamp(min=1)
    hi = torch.stack([torch.full_like(live, 6), live, live,
                      (length // 4).clamp(min=2),
                      torch.full_like(live, 256), torch.full_like(live, 8)],
                     dim=-1)
    lo = torch.zeros_like(hi)
    lo[..., 3] = 1
    return prng.randint(ks, lo, hi).unbind(-1)


def _mangle_apply(b, draws):
    """Apply one mangle op per lane of ``b`` (uint8[B, L]) from its
    draws (each int64[B]).  JAX's ``lax.switch`` under vmap computes
    every branch and selects one per lane; so does this."""
    L = b.shape[-1]
    op, pos, pos2, run, rbyte, magic_i = (d[:, None] for d in draws)
    rbyte = rbyte & 0xFF
    magic = _table(MANGLE_MAGICS, 0xFF, b.device)[magic_i]
    idx = _idx(L, b.device)
    inside = (idx >= pos) & (idx < pos + run)
    copied = b.gather(1, (pos2 + (idx - pos)).clamp(0, L - 1))
    is_digit = (b >= ord("0")) & (b <= ord("9"))
    digit = rbyte % 10 + ord("0")
    branches = (
        torch.where(inside, rbyte, b),                      # byte set
        torch.where(inside, copied, b),                     # memcpy
        torch.where(inside, magic, b),                      # magic
        torch.where(inside, b + 1, b),                      # inc
        torch.where(inside, b - 1, b),                      # dec
        torch.where(inside & is_digit, digit, b),           # digit
    )
    out = branches[5].to(torch.int64)
    for i in range(4, -1, -1):
        out = torch.where(op == i, branches[i], out)
    return out.to(torch.uint8)


def _mangle_one(buf, length, keys):
    """One honggfuzz-style mangle op per lane: byte-run set or copy,
    a magic value, inc or dec runs, ASCII digit corruption.  No op
    changes the length."""
    b, ln = lanes(buf, length, keys.shape[0])
    return _mangle_apply(b, _mangle_draws(keys, ln)), ln


def mangle_at(buf, length, keys: torch.Tensor, max_ops: int = 8):
    """honggfuzz-style mangle: 1..max_ops stacked run-oriented edits,
    edit i keyed by ``fold_in(k1, i)``.  No edit changes the length, so
    every edit's draws are made up front, in one batch."""
    b, ln = lanes(buf, length, keys.shape[0])
    sub = prng.split(keys, 2)
    n_ops = prng.randint(sub[:, 0], 1, max_ops + 1)
    steps = prng.fold_in(sub[:, None, 1],
                         torch.arange(max_ops, device=b.device))
    draws = _mangle_draws(steps, ln[:, None])          # each [B, max_ops]
    out = b
    for i in range(max_ops):
        nb = _mangle_apply(out, [d[:, i] for d in draws])
        out = torch.where((i < n_ops)[:, None], nb, out)
    return out, ln.to(torch.int32)
