"""AFL havoc over a batch of lanes: the stacked random edits a
campaign's candidates are made of.

Lane b starts from the seed (uint8[L], ``length`` live bytes) and
applies ``1 << (1 + w[b, 0] % stack_pow2)`` edits, edit i decoded from
``w[b, 8 (i + 1): 8 (i + 2)]``.  Every edit reads the whole pre-edit
buffer: ``out[i] = set ? value : buf[src[i]] ^ xor[i]``.  Op table
(``w0 % 15``): 0 bit flip, 1-3 interesting 8/16/32, 4-9 arith -/+ on
8/16/32 (little- or big-endian), 10 xor byte, 11-12 delete block, 13
insert clone/fill block, 14 overwrite clone/fill block.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
ARITH_MAX = 35
N_HAVOC_OPS = 15
INTERESTING_8 = np.array([-128, -1, 0, 1, 16, 32, 64, 100, 127],
                         dtype=np.int64)
INTERESTING_16 = np.array([-32768, -129, 128, 255, 256, 512, 1000, 1024,
                           4096, 32767], dtype=np.int64)
INTERESTING_32 = np.array([-2147483648, -100663046, -32769, 32768, 65535,
                           65536, 100663045, 2147483647], dtype=np.int64)


def _edit(buf, length, w, tables):
    """One stacked edit for every lane: buf int64[B, L], length
    int64[B], w int64[B, 8] uint32 words.  Returns (buf', length')."""
    dev = buf.device
    L = buf.shape[1]
    i8, i16, i32 = tables
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
    int_val = torch.where(
        op == 1, i8[rint % i8.shape[0]],
        torch.where(op == 2, i16[rint % i16.shape[0]],
                    i32[rint % i32.shape[0]]))

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


def havoc(seed: torch.Tensor, seed_len: int, words: torch.Tensor,
          stack_pow2: int):
    """Every lane's mutant of ``seed`` (uint8[L]) under its ``words``
    (int64[B, (2**stack_pow2 + 1) * 8]).  Returns (uint8[B, L],
    int32[B])."""
    n_steps = 1 << stack_pow2
    b = words.shape[0]
    dev = words.device
    w = words.to(torch.int64) & M32
    tables = tuple(torch.as_tensor(t & m, dtype=torch.int64, device=dev)
                   for t, m in ((INTERESTING_8, 0xFF),
                                (INTERESTING_16, 0xFFFF),
                                (INTERESTING_32, M32)))
    out = seed.to(device=dev, dtype=torch.int64).expand(
        b, seed.shape[-1]).clone()
    ln = torch.full((b,), int(seed_len), dtype=torch.int64, device=dev)
    stack = 1 << (1 + w[:, 0] % stack_pow2)
    for i in range(n_steps):
        nb, nln = _edit(out, ln, w[:, (i + 1) * 8:(i + 2) * 8], tables)
        active = i < stack
        out = torch.where(active[:, None], nb, out)
        ln = torch.where(active, nln, ln)
    return out.to(torch.uint8), ln.to(torch.int32)
