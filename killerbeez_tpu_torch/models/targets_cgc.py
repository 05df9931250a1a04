"""CGC-grade KBVM targets — device-side ports of the realistic corpus
parsers (corpus/tlvstack.c, corpus/imgparse.c).

These are the bench/flagship targets: ~100+ basic blocks, loops with
hit-count variation, multi-stage validation, and planted memory bugs
expressed through the KBVM's native unsafety (out-of-bounds LDM/STM
crashes the lane — the analogue of the C versions' wild-pointer
SIGSEGVs).  They replace the role of the reference's prebuilt CGC
challenge binaries (its corpus/cgc/) with original
programs.

Register conventions (r0 is never written => always 0):
  tlvstack_vm: r1=ip  r2=op  r3=arg  r4,r5,r7=scratch  r6=sp
  imgparse_vm: r1=off r2=type r3=len r4,r5,r7=scratch  r6=field
"""

from __future__ import annotations

from .compiler import Assembler
from .vm import Program
from .targets import register_target

# tlvstack_vm memory map (mem_size=72):
#   [0..31]  operand stack     [32..47] slots
#   [48]     privilege flag    [49..71] scratch for PRIV leaves
_STACK_BASE = 0
_STACK_MAX = 32
_SLOT_BASE = 32
_PRIV_FLAG = 48
_KEYWORD = b"KBVMLOCK"


def _need_stack(a: Assembler, min_depth: int, bad: str) -> None:
    """Branch to ``bad`` unless sp (r6) >= min_depth; starts a block
    on the ok path."""
    a.ldi(5, min_depth)
    a.br("lt", 6, 5, bad)
    a.block()


def _need_room(a: Assembler, bad: str) -> None:
    """Branch to ``bad`` unless sp (r6) < STACK_MAX."""
    a.ldi(5, _STACK_MAX)
    a.br("ge", 6, 5, bad)


@register_target("tlvstack_vm")
def tlvstack_vm() -> Program:
    """KBVM port of corpus/tlvstack.c: "STK1" magic then [op][arg]
    command pairs driving an operand-stack machine.

    Ops 0x01..0x0b mirror the C target (PUSH/POP/ADD/MUL/DUP/STORE/
    LOAD/PICK/SWAP/SIND/HALT) including both planted bugs:

      * PICK bounds `depth` against sp*8 instead of sp — out-of-range
        picks read clamped garbage (the C build reads mapped garbage
        below the stack; the VM clamps to 0 for the same effect);
      * SIND range-checks the popped address with a SIGNED `addr < 16`
        so a negative address (e.g. from MUL wraparound) passes and
        the store lands below the slot array — far-negative addresses
        leave the VM memory entirely (lane crash, the SIGSEGV
        analogue) while small negatives silently corrupt the stack.

    Two extra tiers give the target CGC-scale block count:
      * 0x0c KEY — match the next 8 input bytes against "KBVMLOCK"
        byte-by-byte (one block per matched byte) to set a privilege
        flag;
      * 0x0d PRIV — requires the flag; dispatches arg through a
        5-level binary tree to one of 32 leaf routines (63 blocks).
    """
    a = Assembler("tlvstack_vm", mem_size=72, max_steps=1024)

    a.block()                                     # entry
    a.load_len(4)
    a.ldi(5, 4)
    a.br("lt", 4, 5, "bad")
    a.block()
    a.expect_byte(4, 5, 0, ord("S"), "bad")
    a.expect_byte(4, 5, 1, ord("T"), "bad")
    a.expect_byte(4, 5, 2, ord("K"), "bad")
    a.expect_byte(4, 5, 3, ord("1"), "bad")
    a.ldi(1, 4)                                   # ip = 4
    a.ldi(6, _STACK_BASE)                         # sp = 0

    a.label("loop")
    a.block()                                     # loop head
    a.load_len(4)
    a.addi(5, 1, 2)
    a.br("lt", 4, 5, "bad")                       # need ip+2 <= len
    a.block()                                     # fetch block
    a.ldb(2, 1)                                   # op = input[ip]
    a.addi(5, 1, 1)
    a.ldb(3, 5)                                   # arg = input[ip+1]
    a.addi(1, 1, 2)
    for op, handler in [(0x01, "op_push"), (0x02, "op_pop"),
                        (0x03, "op_add"), (0x04, "op_mul"),
                        (0x05, "op_dup"), (0x06, "op_store"),
                        (0x07, "op_load"), (0x08, "op_pick"),
                        (0x09, "op_swap"), (0x0a, "op_sind"),
                        (0x0b, "op_halt"), (0x0c, "op_key"),
                        (0x0d, "op_priv")]:
        a.ldi(5, op)
        a.br("eq", 2, 5, handler)
    a.jmp("bad")

    a.label("op_push")
    a.block()
    _need_room(a, "bad")
    a.block()
    a.stm(6, 3)                                   # mem[sp] = arg
    a.addi(6, 6, 1)
    a.jmp("loop")

    a.label("op_pop")
    a.block()
    _need_stack(a, 1, "bad")
    a.addi(6, 6, -1)
    a.jmp("loop")

    for name, alu in [("op_add", "add"), ("op_mul", "mul")]:
        a.label(name)
        a.block()
        _need_stack(a, 2, "bad")
        a.addi(6, 6, -1)
        a.ldm(4, 6)                               # a = pop
        a.addi(6, 6, -1)
        a.ldm(5, 6)                               # b = pop
        a.alu(alu, 4, 4, 5)
        a.stm(6, 4)                               # push result
        a.addi(6, 6, 1)
        a.jmp("loop")

    a.label("op_dup")
    a.block()
    _need_stack(a, 1, "bad")
    _need_room(a, "bad")
    a.addi(5, 6, -1)
    a.ldm(4, 5)
    a.stm(6, 4)
    a.addi(6, 6, 1)
    a.jmp("loop")

    a.label("op_store")
    a.block()
    a.ldi(5, 16)
    a.br("ge", 3, 5, "bad")                       # arg < 16
    a.block()
    _need_stack(a, 1, "bad")
    a.addi(6, 6, -1)
    a.ldm(4, 6)
    a.addi(5, 3, _SLOT_BASE)
    a.stm(5, 4)                                   # slots[arg] = pop
    a.jmp("loop")

    a.label("op_load")
    a.block()
    a.ldi(5, 16)
    a.br("ge", 3, 5, "bad")
    a.block()
    _need_room(a, "bad")
    a.addi(5, 3, _SLOT_BASE)
    a.ldm(4, 5)
    a.stm(6, 4)
    a.addi(6, 6, 1)
    a.jmp("loop")

    a.label("op_pick")
    a.block()
    _need_stack(a, 1, "bad")
    _need_room(a, "bad")
    a.ldi(7, 3)
    a.alu("shl", 5, 6, 7)                         # r5 = sp * 8
    a.br("ge", 3, 5, "bad")                       # BUG: depth < sp*8
    a.block()
    a.addi(5, 6, -1)
    a.alu("sub", 5, 5, 3)                         # idx = sp-1-depth
    a.br("ge", 5, 0, "pick_ok")                   # idx >= 0?
    a.block()                                     # under-stack pick:
    a.ldi(5, 0)                                   # clamped garbage read
    a.label("pick_ok")
    a.block()
    a.ldm(4, 5)
    a.stm(6, 4)
    a.addi(6, 6, 1)
    a.jmp("loop")

    a.label("op_swap")
    a.block()
    _need_stack(a, 2, "bad")
    a.addi(5, 6, -1)
    a.ldm(4, 5)                                   # top
    a.addi(7, 6, -2)
    a.ldm(2, 7)                                   # below (r2 free now)
    a.stm(5, 2)
    a.stm(7, 4)
    a.jmp("loop")

    a.label("op_sind")
    a.block()
    _need_stack(a, 2, "bad")
    a.addi(6, 6, -1)
    a.ldm(4, 6)                                   # addr = pop
    a.addi(6, 6, -1)
    a.ldm(7, 6)                                   # val = pop
    a.ldi(5, 16)
    a.br("ge", 4, 5, "bad")                       # BUG: signed compare,
    a.block()                                     # negatives pass
    a.addi(5, 4, _SLOT_BASE)
    a.stm(5, 7)                                   # far-negative addr ->
    a.jmp("loop")                                 # OOB store -> crash

    a.label("op_halt")
    a.block()
    a.halt(0)

    # --- 0x0c KEY: byte-wise keyword match sets the privilege flag ---
    a.label("op_key")
    a.block()
    a.load_len(4)
    a.addi(5, 1, len(_KEYWORD))
    a.br("lt", 4, 5, "bad")                       # need 8 more bytes
    a.block()
    for i, ch in enumerate(_KEYWORD):
        a.addi(4, 1, i)
        a.ldb(4, 4)                               # input[ip+i]
        a.ldi(5, ch)
        a.br("ne", 4, 5, "bad")
        a.block()                                 # one block per match
    a.addi(1, 1, len(_KEYWORD))                   # consume keyword
    a.ldi(4, _PRIV_FLAG)
    a.ldi(5, 1)
    a.stm(4, 5)                                   # priv = 1
    a.jmp("loop")

    # --- 0x0d PRIV: 5-level binary dispatch to 32 leaf routines ---
    a.label("op_priv")
    a.block()
    a.ldi(4, _PRIV_FLAG)
    a.ldm(4, 4)
    a.ldi(5, 1)
    a.br("ne", 4, 5, "bad")                       # needs privilege
    a.block()

    # root: reject arg >= 32, then walk the tree
    a.ldi(5, 32)
    a.br("lt", 3, 5, "node_0_32")
    a.jmp("bad")

    def _tree(lo: int, hi: int) -> None:
        """Emit the arg-dispatch subtree for leaves [lo, hi): internal
        nodes branch on arg >= mid; each node and leaf is one block."""
        if hi - lo == 1:
            a.label(f"leaf_{lo}")
            a.block()                             # leaf block
            # distinct tiny computation: scratch[49 + lo % 23] += lo+1
            a.ldi(4, 49 + lo % 23)
            a.ldm(5, 4)
            a.addi(5, 5, lo + 1)
            a.stm(4, 5)
            a.jmp("loop")
            return
        mid = (lo + hi) // 2
        a.label(f"node_{lo}_{hi}")
        a.block()                                 # internal node block
        a.ldi(5, mid)
        hi_target = f"node_{mid}_{hi}" if hi - mid > 1 else f"leaf_{mid}"
        a.br("ge", 3, 5, hi_target)
        lo_target = f"node_{lo}_{mid}" if mid - lo > 1 else f"leaf_{lo}"
        a.jmp(lo_target)
        _tree(lo, mid)
        _tree(mid, hi)

    _tree(0, 32)

    a.label("bad")
    a.block()
    a.halt(1)
    return a.build(block_seed=0x57AC)


# imgparse_vm memory map (mem_size=136):
#   [0..63]    framebuffer (8x8 max at first-header time)
#   [64..127]  palette (64 entries)
#   [128] w  [129] h  [130] have_header  [131] pal_count  [132] rows
_FB_BASE = 0
_FB_CAP = 64                  # 8x8
_PAL_BASE = 64
_F_W, _F_H, _F_HAVE, _F_PALCNT, _F_ROWS = 128, 129, 130, 131, 132


@register_target("imgparse_vm")
def imgparse_vm() -> Program:
    """KBVM port of corpus/imgparse.c: "QIMG" magic then chunks
    [type][len][payload...][cksum], cksum = sum(payload) & 0xFF.

    Chunk types mirror the C target ('H' header / 'P' palette /
    'D' data row / 'C' comment / 'E' end) with both planted bugs:

      * header re-send skips the framebuffer bound check (only the
        FIRST header is validated against the 8x8 buffer; later ones
        just overwrite w/h up to the 40x40 "sanity" cap), so a second,
        larger header makes the next row store at row*w past the
        framebuffer — out of VM memory entirely -> lane crash;
      * palette lookup indexes mem[PAL_BASE + pixel] without checking
        the pixel against pal_count: pixels >= 72 run off the end of
        VM memory -> lane crash (the C build reads mapped garbage;
        the VM's bound is tighter so the same bug is observable).
    """
    a = Assembler("imgparse_vm", mem_size=136, max_steps=1024)

    a.block()                                     # entry
    a.load_len(4)
    a.ldi(5, 4)
    a.br("lt", 4, 5, "bad")
    a.block()
    a.expect_byte(4, 5, 0, ord("Q"), "bad")
    a.expect_byte(4, 5, 1, ord("I"), "bad")
    a.expect_byte(4, 5, 2, ord("M"), "bad")
    a.expect_byte(4, 5, 3, ord("G"), "bad")
    a.ldi(1, 4)                                   # off = 4

    a.label("chunk_loop")
    a.block()
    a.load_len(4)
    a.addi(5, 1, 2)
    a.br("lt", 4, 5, "bad")                       # need type+len bytes
    a.block()
    a.ldb(2, 1)                                   # type
    a.addi(5, 1, 1)
    a.ldb(3, 5)                                   # len
    a.addi(1, 1, 2)                               # off -> payload
    a.addi(5, 1, 1)
    a.alu("add", 5, 5, 3)
    a.br("lt", 4, 5, "bad")                       # payload+cksum present

    # checksum loop: r6 = i, r7 = acc
    a.block()
    a.ldi(6, 0)
    a.ldi(7, 0)
    a.label("ck_loop")
    a.br("ge", 6, 3, "ck_done")
    a.block()                                     # hit-count bucket
    a.alu("add", 4, 1, 6)
    a.ldb(4, 4)
    a.alu("add", 7, 7, 4)
    a.addi(6, 6, 1)
    a.jmp("ck_loop")
    a.label("ck_done")
    a.block()
    a.ldi(5, 255)
    a.alu("and", 7, 7, 5)
    a.alu("add", 4, 1, 3)
    a.ldb(4, 4)                                   # stored cksum
    a.br("ne", 7, 4, "bad")
    a.block()

    for ch, handler in [("H", "h_chunk"), ("P", "p_chunk"),
                        ("D", "d_chunk"), ("C", "consume"),
                        ("E", "e_chunk")]:
        a.ldi(5, ord(ch))
        a.br("eq", 2, 5, handler)
    a.jmp("bad")

    a.label("consume")                            # shared chunk epilogue
    a.block()
    a.addi(1, 1, 1)
    a.alu("add", 1, 1, 3)                         # off += len + 1
    a.jmp("chunk_loop")

    # ---- 'H': [w, h, depth] ----
    a.label("h_chunk")
    a.block()
    a.ldi(5, 3)
    a.br("ne", 3, 5, "bad")                       # len == 3
    a.block()
    a.ldb(4, 1)                                   # w = payload[0]
    a.addi(5, 1, 1)
    a.ldb(6, 5)                                   # h = payload[1]
    a.addi(5, 1, 2)
    a.ldb(7, 5)                                   # d = payload[2]
    a.ldi(5, 1)
    a.br("lt", 4, 5, "bad")                       # w >= 1
    a.br("lt", 6, 5, "bad")                       # h >= 1
    a.ldi(5, 40)
    a.br("ge", 4, 5, "bad")                       # w < 40 ("sanity")
    a.br("ge", 6, 5, "bad")                       # h < 40
    a.block()
    for d, lbl in [(1, "d_ok"), (2, "d_ok"), (4, "d_ok"), (8, "d_ok")]:
        a.ldi(5, d)
        a.br("eq", 7, 5, lbl)
    a.jmp("bad")
    a.label("d_ok")
    a.block()
    a.ldi(5, _F_HAVE)
    a.ldm(5, 5)
    a.ldi(7, 1)
    a.br("eq", 5, 7, "h_store")                   # BUG: re-send skips
    a.block()                                     # the fb bound check
    a.ldi(5, 9)
    a.br("ge", 4, 5, "bad")                       # first header: w <= 8
    a.br("ge", 6, 5, "bad")                       # first header: h <= 8
    a.block()
    a.label("h_store")
    a.block()
    a.ldi(5, _F_W)
    a.stm(5, 4)
    a.ldi(5, _F_H)
    a.stm(5, 6)
    a.ldi(5, _F_HAVE)
    a.ldi(4, 1)
    a.stm(5, 4)
    a.jmp("consume")

    # ---- 'P': [count, colors...] ----
    a.label("p_chunk")
    a.block()
    a.ldi(5, 1)
    a.br("lt", 3, 5, "bad")                       # len >= 1
    a.block()
    a.ldb(4, 1)                                   # count = payload[0]
    a.ldi(5, 1)
    a.br("lt", 4, 5, "bad")
    a.ldi(5, 65)
    a.br("ge", 4, 5, "bad")                       # count <= 64
    a.block()
    a.addi(5, 4, 1)
    a.br("ne", 3, 5, "bad")                       # len == 1 + count
    a.block()
    a.ldi(6, 0)                                   # i = 0
    a.label("pal_loop")
    a.br("ge", 6, 4, "pal_done")
    a.block()                                     # hit-count bucket
    a.addi(5, 1, 1)
    a.alu("add", 5, 5, 6)
    a.ldb(7, 5)                                   # color byte
    a.addi(5, 6, _PAL_BASE)
    a.stm(5, 7)
    a.addi(6, 6, 1)
    a.jmp("pal_loop")
    a.label("pal_done")
    a.block()
    a.ldi(5, _F_PALCNT)
    a.stm(5, 4)
    a.jmp("consume")

    # ---- 'D': [row, pixels...] ----
    a.label("d_chunk")
    a.block()
    a.ldi(5, _F_HAVE)
    a.ldm(5, 5)
    a.ldi(4, 1)
    a.br("ne", 5, 4, "bad")                       # need a header
    a.block()
    a.ldi(5, 1)
    a.br("lt", 3, 5, "bad")                       # len >= 1
    a.block()
    a.ldb(4, 1)                                   # row = payload[0]
    a.ldi(5, _F_H)
    a.ldm(5, 5)
    a.br("ge", 4, 5, "bad")                       # row < h (validated!)
    a.block()
    a.ldi(5, _F_W)
    a.ldm(5, 5)                                   # r5 = w
    a.addi(7, 3, -1)
    a.br("lt", 7, 5, "bad")                       # len-1 >= w
    a.block()
    a.alu("mul", 4, 4, 5)                         # dst = row * w (BUG:
    a.ldi(6, 0)                                   # unchecked vs FB_CAP)
    a.label("row_loop")
    a.br("ge", 6, 5, "row_done")
    a.block()                                     # hit-count bucket
    a.addi(7, 1, 1)
    a.alu("add", 7, 7, 6)
    a.ldb(7, 7)                                   # px = payload[1+i]
    # palette indirection when pal_count > 0
    a.ldi(2, _F_PALCNT)                           # r2 free post-dispatch
    a.ldm(2, 2)
    a.br("eq", 2, 0, "px_store")
    a.block()
    a.addi(2, 7, _PAL_BASE)                       # BUG: px unchecked
    a.ldm(7, 2)                                   # vs pal_count
    a.label("px_store")
    a.block()
    a.alu("add", 2, 4, 6)                         # fb index = dst + i
    a.stm(2, 7)                                   # OOB when resized
    a.addi(6, 6, 1)
    a.jmp("row_loop")
    a.label("row_done")
    a.block()
    a.ldi(5, _F_ROWS)
    a.ldm(4, 5)
    a.addi(4, 4, 1)
    a.stm(5, 4)
    a.jmp("consume")

    # ---- 'E' ----
    a.label("e_chunk")
    a.block()
    a.halt(0)

    a.label("bad")
    a.block()
    a.halt(1)
    return a.build(block_seed=0x16C)


# rledec_vm memory map (mem_size=80):
#   [0..63]  output buffer (OUT_CAP=64)   [64..79] scratch "heap"
_RLE_CAP = 64


@register_target("rledec_vm")
def rledec_vm() -> Program:
    """KBVM port of corpus/rledec.c: "RLE2" [out_len u16le] then
    run / literal / back-reference tokens decoded into a 64-byte
    output region (the C build uses 1024; the VM scales the cap to
    its memory, same bug shape).

    The planted bug is the classic decompressor CVE: output space is
    accounted with a SIGNED 16-bit budget instead of checking the
    cursor, and the reject only fires while the cursor still LOOKS
    in-bounds (`op + cnt <= CAP`) — the first token that both
    exhausts the budget and crosses the buffer end slips through,
    and the emit loop walks past the output region: bytes 64..79
    silently corrupt scratch (the C version's heap walk), then the
    cursor leaves VM memory entirely and the lane crashes.

    Registers: r1=ip r2=out-cursor r3=budget r4,r5=scratch
    r6=tok/byte/dist r7=cnt.  Exit codes mirror the C returns
    (1=short/bad magic, 2=out_len too big, 3=truncated token,
    4=zero count, 5=budget reject, 6=bad distance, 7=bad token,
    8=stream ended without 0x03).
    """
    a = Assembler("rledec_vm", mem_size=80, max_steps=1024)

    def budget_reject(tag: str) -> None:
        """budget -= cnt (signed-16 wrap); reject ONLY when negative
        AND op+cnt <= CAP — the conditioned check from the C."""
        a.alu("sub", 3, 3, 7)
        a.ldi(5, 0xFFFF)
        a.alu("and", 3, 3, 5)                     # short truncation
        a.ldi(4, 15)
        a.alu("shr", 5, 3, 4)                     # sign bit
        a.br("eq", 5, 0, f"bgt_ok_{tag}")         # budget >= 0
        a.block()                                 # negative budget
        a.alu("add", 4, 2, 7)                     # op + cnt
        a.ldi(5, _RLE_CAP + 1)
        a.br("lt", 4, 5, "x5")                    # looks in-bounds
        a.block()                                 # ESCAPE: overflow
        a.label(f"bgt_ok_{tag}")
        a.block()

    a.block()                                     # entry
    a.load_len(4)
    a.ldi(5, 6)
    a.br("lt", 4, 5, "x1")
    a.block()
    a.expect_byte(4, 5, 0, ord("R"), "x1")
    a.expect_byte(4, 5, 1, ord("L"), "x1")
    a.expect_byte(4, 5, 2, ord("E"), "x1")
    a.expect_byte(4, 5, 3, ord("2"), "x1")
    a.ldi(4, 4)                                   # out_len = LE16
    a.ldb(4, 4)
    a.ldi(5, 5)
    a.ldb(5, 5)
    a.ldi(7, 8)
    a.alu("shl", 5, 5, 7)
    a.alu("or", 3, 4, 5)                          # budget = out_len
    a.ldi(5, _RLE_CAP + 1)
    a.br("ge", 3, 5, "x2")
    a.block()
    a.ldi(1, 6)                                   # ip = 6
    a.ldi(2, 0)                                   # op = 0

    a.label("loop")
    a.block()
    a.load_len(4)
    a.br("ge", 1, 4, "x8")                        # stream ran out
    a.block()                                     # fetch token
    a.ldb(6, 1)
    a.addi(1, 1, 1)
    a.ldi(5, 0x03)
    a.br("eq", 6, 5, "done")
    a.block()
    a.load_len(4)
    a.br("ge", 1, 4, "x3")
    a.block()                                     # fetch count
    a.ldb(7, 1)
    a.addi(1, 1, 1)
    a.br("eq", 7, 0, "x4")
    a.block()
    a.ldi(5, 0x00)
    a.br("eq", 6, 5, "t_run")
    a.ldi(5, 0x01)
    a.br("eq", 6, 5, "t_lit")
    a.ldi(5, 0x02)
    a.br("eq", 6, 5, "t_bref")
    a.jmp("x7")

    a.label("t_run")                              # emit byte n times
    a.block()
    a.load_len(4)
    a.br("ge", 1, 4, "x3")
    a.block()
    a.ldb(6, 1)                                   # fill byte
    a.addi(1, 1, 1)
    budget_reject("run")
    a.label("run_emit")
    a.block()                                     # per-byte hit count
    a.br("eq", 7, 0, "loop")
    a.stm(2, 6)                                   # out[op] = byte
    a.addi(2, 2, 1)
    a.addi(7, 7, -1)
    a.jmp("run_emit")

    a.label("t_lit")                              # verbatim copy
    a.block()
    a.alu("add", 5, 1, 7)
    a.load_len(4)
    a.br("lt", 4, 5, "x3")                        # ip + cnt > len
    a.block()
    budget_reject("lit")
    a.label("lit_emit")
    a.block()
    a.br("eq", 7, 0, "loop")
    a.ldb(6, 1)
    a.stm(2, 6)
    a.addi(1, 1, 1)
    a.addi(2, 2, 1)
    a.addi(7, 7, -1)
    a.jmp("lit_emit")

    a.label("t_bref")                             # back-reference
    a.block()
    a.load_len(4)
    a.br("ge", 1, 4, "x3")
    a.block()
    a.ldb(6, 1)                                   # dist
    a.addi(1, 1, 1)
    a.br("eq", 6, 0, "x6")
    a.block()
    a.br("lt", 2, 6, "x6")                        # dist > op
    a.block()
    budget_reject("bref")
    a.label("bref_emit")
    a.block()
    a.br("eq", 7, 0, "loop")
    a.alu("sub", 5, 2, 6)                         # src = op - dist
    a.ldm(4, 5)
    a.stm(2, 4)
    a.addi(2, 2, 1)
    a.addi(7, 7, -1)
    a.jmp("bref_emit")

    a.label("done")
    a.block()
    a.halt(0)
    for code in (1, 2, 3, 4, 5, 6, 7, 8):
        a.label(f"x{code}")
        a.block()
        a.halt(code)
    return a.build(block_seed=0x41E)


#: fixedform_vm field offsets (everything else is NEVER loaded)
_FORM_LEN = 96
_FORM_HANDLERS = 8
_FORM_FIELD_VALUES = 16


@register_target("fixedform_vm")
def fixedform_vm() -> Program:
    """Fixed-offset form parser — the "not all bytes are equal"
    target family (arxiv 1711.04596; the learn tier's bench regime,
    docs/LEARN.md).

    Real-world headers put their meaning at FIXED offsets and ignore
    the bytes between: this family makes that structure exact and
    provable.  A 96-byte form carries ~16 live positions —

      [0..1]  magic "FM"            [8]   version ladder (6 values)
      [16]    type -> 8 handlers    [24+k] handler k's field ladder
                                           (16 values each)
      [32]    repeat count (hit-count-bucket loop that reads NOTHING)
      [64]^[65] key/lock gate -> bonus ladder at [72]
      [80]    0xEE arms the planted bug; [81] is the unchecked
              store index (version 6 + type 7 only)

    — and every other byte is never the operand of an LDB: mutating
    it cannot change ANY branch, ever (the dataflow layer proves the
    dead regions; kb-lint shows no dependency on them).  Uniform
    havoc therefore wastes ~5/6 of its primary edits; a mask that
    concentrates on the live offsets is worth ~6x effective mutation
    density — and because the SAME offsets keep yielding new ladder
    values all campaign long, positional saliency is stable, which
    is exactly what a lineage-trained model can learn.  Coverage is
    wide (magic partials + 6 + 8 + 8x16 value blocks + count buckets
    + bonus ladder) so short campaigns don't saturate.
    """
    a = Assembler("fixedform_vm", mem_size=32, max_steps=512)
    a.block()                                   # entry
    a.load_len(1)
    a.ldi(2, 82)
    a.br("lt", 1, 2, "bad")                     # short form
    a.block()
    a.expect_byte(3, 4, 0, ord("F"), "bad")     # magic
    a.expect_byte(3, 4, 1, ord("M"), "bad")

    def ladder(tag: str, off: int, values: int, done: str) -> None:
        """One value ladder over input[off]: each matched value gets
        its own coverage block (walking coverage at a fixed
        position), unmatched values fall through to ``done``."""
        a.ldi(3, off)
        a.ldb(2, 3)                             # r2 = input[off]
        for v in range(values):
            a.ldi(4, v + 1)
            a.br("ne", 2, 4, f"{tag}_n{v}")
            a.block()                           # value-(v+1) block
            a.jmp(done)
            a.label(f"{tag}_n{v}")
            a.block()
        a.jmp(done)

    # version ladder at [8] (r7 keeps the raw byte for the bug gate)
    a.ldi(3, 8)
    a.ldb(7, 3)
    ladder("ver", 8, 6, "ver_done")
    a.label("ver_done")
    a.block()

    # type dispatch at [16] -> handler k's own field ladder at [24+k]
    a.ldi(3, 16)
    a.ldb(6, 3)                                 # r6 = type
    for k in range(_FORM_HANDLERS):
        a.ldi(2, k + 1)
        a.br("ne", 6, 2, f"ty_n{k}")
        a.block()                               # handler-k block
        ladder(f"h{k}", 24 + k, _FORM_FIELD_VALUES, f"h{k}_done")
        a.label(f"h{k}_done")
        a.block()
        a.jmp("ty_done")
        a.label(f"ty_n{k}")
        a.block()
    a.label("ty_done")
    a.block()

    # repeat-count loop at [32]: the body block's hit count walks the
    # AFL buckets; the body READS no input (count buckets only)
    a.ldi(3, 32)
    a.ldb(2, 3)                                 # r2 = count
    a.ldi(4, 24)
    a.br("ge", 4, 2, "cnt_ok")                  # clamp to 24
    a.block()
    a.alu("add", 2, 4, 0)                       # r2 = 24 (r0 == 0)
    a.label("cnt_ok")
    a.block()
    a.ldi(3, 0)                                 # r3 = i
    a.label("cnt_loop")
    a.br("ge", 3, 2, "cnt_done")
    a.block()                                   # bucket body
    a.addi(3, 3, 1)
    a.jmp("cnt_loop")
    a.label("cnt_done")
    a.block()

    # key/lock gate: input[64] ^ input[65] == 0x5A opens the bonus
    # ladder at [72] (two-byte coupled fields — compensated edits)
    a.ldi(3, 64)
    a.ldb(4, 3)
    a.ldi(3, 65)
    a.ldb(5, 3)
    a.alu("xor", 4, 4, 5)
    a.ldi(5, 0x5A)
    a.br("ne", 4, 5, "no_bonus")
    a.block()                                   # gate open
    ladder("bonus", 72, _FORM_FIELD_VALUES, "bonus_done")
    a.label("bonus_done")
    a.block()
    a.label("no_bonus")
    a.block()

    # planted bug: version 6 + type 7 + input[80] == 0xEE stores to
    # the UNCHECKED index input[81] (mem_size 32 -> OOB crash)
    a.ldi(2, 6)
    a.br("ne", 7, 2, "done")
    a.ldi(2, 7)
    a.br("ne", 6, 2, "done")
    a.block()
    a.expect_byte(3, 4, 80, 0xEE, "done")
    a.ldi(3, 81)
    a.ldb(4, 3)                                 # r4 = store index
    a.stm(4, 2)                                 # BUG: unchecked
    a.block()
    a.label("done")
    a.block()
    a.halt(0)
    a.label("bad")
    a.block()
    a.halt(1)
    return a.build(block_seed=0xF1F)


@register_target("magicsum_vm")
def magicsum_vm() -> Program:
    """The input-to-state micro-family (Redqueen's motivating shape):
    a 32-bit value assembled VERBATIM from the first four input bytes
    (little-endian) must equal a multiply-accumulate checksum of the
    remaining payload.

        [b0 b1 b2 b3 | payload...],  len >= 6
        stored = b0 + 256*b1 + 65536*b2 + 16777216*b3
        acc    = fold(payload, 0x51D5A3, acc*33 + byte)
        stored == acc  ->  the win block (planted wild store)

    Why it exists: the exact solver reports the compare ``unknown``
    (the checksum loop's length-dependent revisits blow the visit
    cap), and coordinate probe walks need ~30+ iterations to carry a
    byte-granular descent across all four stored bytes — but the
    engine OBSERVES both operands at the compare, so input-to-state
    matching writes the observed checksum straight into b0..b3 and
    cracks it in one generation.  ``bench.py --descend`` gates that
    separation (i2s-on vs i2s-off at equal budget) and
    tests/test_device_descent.py pins the <= 2-dispatch crack."""
    a = Assembler("magicsum_vm", mem_size=8, max_steps=512)
    a.block()                                     # 0: entry
    a.load_len(5)
    a.ldi(2, 6)
    a.br("lt", 5, 2, "exit")                      # len < 6 -> exit
    a.block()                                     # 1: assemble stored
    a.ldi(6, 256)
    a.ldi(1, 3)
    a.ldb(3, 1)                                   # r3 = b3
    a.alu("mul", 3, 3, 6)
    a.ldi(1, 2)
    a.ldb(2, 1)
    a.alu("add", 3, 3, 2)                         # (b3*256)+b2
    a.alu("mul", 3, 3, 6)
    a.ldi(1, 1)
    a.ldb(2, 1)
    a.alu("add", 3, 3, 2)
    a.alu("mul", 3, 3, 6)
    a.ldi(1, 0)
    a.ldb(2, 1)
    a.alu("add", 3, 3, 2)                         # r3 = stored (LE)
    a.ldi(4, 0x51D5A3)                            # acc seed constant
    a.ldi(1, 4)                                   # i = 4
    a.block()                                     # 2: loop head
    a.label("msum_loop")
    a.br("ge", 1, 5, "msum_cmp")                  # i >= len -> compare
    a.block()                                     # 3: body
    a.ldb(2, 1)
    a.ldi(7, 33)
    a.alu("mul", 4, 4, 7)
    a.alu("add", 4, 4, 2)                         # acc = acc*33 + b
    a.addi(1, 1, 1)
    a.jmp("msum_loop")
    a.label("msum_cmp")
    a.block()                                     # 4: compare
    a.br("ne", 3, 4, "exit")                      # stored != acc
    a.block()                                     # 5: win
    a.ldi(6, -1)
    a.ldi(7, 1)
    a.stm(6, 7)                                   # planted wild store
    a.halt(0)
    a.label("exit")
    a.block()                                     # 6
    a.halt(0)
    return a.build(block_seed=0x3A61)


# --------------------------------------------------------------------
# Seeds and crash reproducers (tests + bench starting corpus)
# --------------------------------------------------------------------

def _chunk(type_byte: bytes, payload: bytes) -> bytes:
    return type_byte + bytes([len(payload)]) + payload + \
        bytes([sum(payload) & 0xFF])


def tlvstack_vm_seed() -> bytes:
    """Happy path: arithmetic, slots, and an unlocked PRIV call."""
    ops = [(0x01, 5), (0x01, 7), (0x03, 0), (0x06, 0), (0x07, 0),
           (0x02, 0)]
    body = b"".join(bytes(p) for p in ops)
    body += bytes([0x0C, 0]) + _KEYWORD            # unlock
    body += bytes([0x0D, 11])                      # one PRIV leaf
    body += bytes([0x0B, 0])                       # halt
    return b"STK1" + body


def tlvstack_vm_crash() -> bytes:
    """MUL wraparound -> negative address passes SIND's signed bound
    check -> store far below the slot array -> lane crash."""
    ops = [(0x01, 255), (0x05, 0), (0x04, 0),      # 255*255
           (0x05, 0), (0x04, 0),                   # ^2 wraps negative
           (0x01, 1), (0x09, 0), (0x0A, 0)]        # val, swap, SIND
    return b"STK1" + b"".join(bytes(p) for p in ops)


def imgparse_vm_seed() -> bytes:
    out = b"QIMG"
    out += _chunk(b"H", bytes([4, 4, 1]))
    out += _chunk(b"P", bytes([2, 0x10, 0x20]))
    out += _chunk(b"D", bytes([0]) + bytes([i & 1 for i in range(4)]))
    out += _chunk(b"C", b"hi")
    out += _chunk(b"E", b"")
    return out


def imgparse_vm_crash() -> bytes:
    """Header re-send resizes past the framebuffer: row 38 x width 39
    stores far outside VM memory."""
    out = b"QIMG"
    out += _chunk(b"H", bytes([4, 4, 1]))          # first header: sane
    out += _chunk(b"H", bytes([39, 39, 1]))        # BUG: unchecked resize
    out += _chunk(b"D", bytes([38]) + bytes(39))
    return out


def fixedform_vm_seed() -> bytes:
    """Happy path: magic + version 1, type 1, field 1, count 1 —
    every other byte zero (the live offsets all hold their lowest
    ladder value, so the whole ladder space is left to the fuzzer)."""
    form = bytearray(_FORM_LEN)
    form[0:2] = b"FM"
    form[8] = 1                                # version
    form[16] = 1                               # type -> handler 0
    form[24] = 1                               # handler 0 field
    form[32] = 1                               # repeat count
    return bytes(form)


def fixedform_vm_crash() -> bytes:
    """version 6 + type 7 + 0xEE arm byte -> unchecked store at
    index 200 (mem_size 32)."""
    form = bytearray(_FORM_LEN)
    form[0:2] = b"FM"
    form[8] = 6
    form[16] = 7
    form[80] = 0xEE
    form[81] = 200
    return bytes(form)


def rledec_vm_seed() -> bytes:
    """Byte-identical to the native seed (corpus/seeds.py
    rledec_seed): every token type, 16 bytes emitted, budget exact."""
    out = b"RLE2" + (16).to_bytes(2, "little")
    out += bytes([0x00, 8, ord("A")])             # run of 8 'A'
    out += bytes([0x01, 4]) + b"abcd"             # literal
    out += bytes([0x02, 4, 4])                    # back-reference
    out += bytes([0x03])
    return out


def rledec_vm_crash() -> bytes:
    """Budget down to 4, then a 60-byte run: budget goes negative
    AND the cursor crosses the cap, so the conditioned reject never
    fires — the emit loop walks off the output region (the native
    repro's shape, scaled to the VM's 64-byte cap)."""
    out = b"RLE2" + (64).to_bytes(2, "little")
    out += bytes([0x00, 60, ord("A")])            # budget 4, op 60
    out += bytes([0x00, 60, ord("B")])            # escapes the check
    return out


def magicsum_vm_seed() -> bytes:
    """Blind seed: zero stored field + two zero payload bytes (the
    checksum of which is far from 0 thanks to the acc constant, so
    the compare edge starts a full 32-bit distance away)."""
    return bytes(6)


def magicsum_vm_crash() -> bytes:
    """stored == checksum(payload): acc = (0x51D5A3*33 + 0)*33 + 0,
    written little-endian into b0..b3."""
    acc = 0x51D5A3
    for b in (0, 0):
        acc = (acc * 33 + b) & 0xFFFFFFFF
    return acc.to_bytes(4, "little") + bytes(2)


VM_SEEDS = {
    "tlvstack_vm": (tlvstack_vm_seed, tlvstack_vm_crash),
    "magicsum_vm": (magicsum_vm_seed, magicsum_vm_crash),
    "imgparse_vm": (imgparse_vm_seed, imgparse_vm_crash),
    "rledec_vm": (rledec_vm_seed, rledec_vm_crash),
    "fixedform_vm": (fixedform_vm_seed, fixedform_vm_crash),
}
