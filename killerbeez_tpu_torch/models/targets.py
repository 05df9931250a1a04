"""Built-in KBVM targets — fresh re-creations of the reference's
corpus fixtures (SURVEY §2.9), written against the assembler API (no
code taken from the reference Killerbeez source; semantics described
in SURVEY).

  * ``test``     — the canonical 4-byte "ABCD" -> wild-pointer-write
                   crasher (reference corpus/test behavior): each
                   matched prefix byte enters a new basic block, so
                   coverage deepens as the fuzzer homes in.
  * ``hang``     — input starting with 'H' spins forever (step-budget
                   hang, reference corpus/hang).
  * ``libtest``  — main + a "shared library" routine with its own
                   block-id range (reference corpus/libtest, used for
                   coverage_libraries-style tests).
  * ``cgc_like`` — a small packet parser (magic, type, length,
                   checksum loop, type-specific handlers, one
                   memory-safety bug) standing in for the CGC corpus.
"""

from __future__ import annotations

from typing import Callable, Dict

from .compiler import Assembler
from .vm import Program

_REGISTRY: Dict[str, Callable[[], Program]] = {}


def register_target(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def target_names():
    return sorted(_REGISTRY)


def get_target(name: str) -> Program:
    if name.startswith("zoo:"):
        # generated target zoo (models/zoo.py): parameterized family
        # instances with certified planted bugs, resolved by name so
        # every --target consumer takes them unchanged
        from .zoo import zoo_program
        return zoo_program(name)
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown target {name!r}; known: {', '.join(target_names())}")
    return _REGISTRY[name]()


def load_program_from_options(options: Dict, missing_hint: str
                              ) -> Program:
    """Resolve an instrumentation option dict to a Program: either a
    compiled ``program_file`` (.npz) or a built-in ``target`` name,
    with an optional ``max_steps`` override. Shared by the device
    instrumentations (jit_harness, ipt)."""
    import numpy as np

    if "program_file" in options:
        d = np.load(options["program_file"], allow_pickle=False)
        modules = ()
        if "module_names" in d:
            modules = tuple(
                (str(n), int(lo), int(hi)) for n, lo, hi in
                zip(d["module_names"], d["modules_lo"],
                    d["modules_hi"]))
        prog = Program(
            instrs=d["instrs"].astype(np.int32),
            name=str(d["name"]) if "name" in d else "file",
            mem_size=int(d["mem_size"]), max_steps=int(d["max_steps"]),
            n_blocks=int(d.get("n_blocks", 0)),
            block_ids=tuple(int(b) for b in d.get("block_ids", ())),
            modules=modules)
    else:
        target = options.get("target")
        if not target:
            raise ValueError(missing_hint)
        prog = get_target(target)
    if "max_steps" in options:
        prog = Program(instrs=prog.instrs, name=prog.name,
                       mem_size=prog.mem_size,
                       max_steps=int(options["max_steps"]),
                       n_blocks=prog.n_blocks,
                       block_ids=prog.block_ids,
                       modules=prog.modules)
    return prog


def load_program_file(path: str) -> Program:
    """Load one compiled ``.npz`` program (kb-compile output, or a
    kb-repair ``--apply`` patched proxy)."""
    return load_program_from_options(
        {"program_file": path}, missing_hint="program_file")


@register_target("test")
def test_target() -> Program:
    """'ABCD' crasher: nested per-byte checks, crash = store through a
    wild pointer (mem index -1), like the reference's NULL write."""
    a = Assembler("test", mem_size=16, max_steps=64)
    a.block()                       # entry block
    a.load_len(1)
    a.ldi(2, 4)
    a.br("lt", 1, 2, "exit")        # len < 4 -> plain exit
    a.block()                       # len-ok block
    a.expect_byte(3, 4, 0, ord("A"), "exit")
    a.expect_byte(3, 4, 1, ord("B"), "exit")
    a.expect_byte(3, 4, 2, ord("C"), "exit")
    a.expect_byte(3, 4, 3, ord("D"), "exit")
    # full match: write through a wild pointer -> crash
    a.ldi(5, -1)
    a.ldi(6, 1)
    a.stm(5, 6)
    a.halt(0)                       # unreachable
    a.label("exit")
    a.block()
    a.halt(0)
    return a.build(block_seed=0x7E57)


@register_target("hang")
def hang_target() -> Program:
    """Spins forever when input[0] == 'H' (hang = step budget
    exhausted), else exits clean."""
    a = Assembler("hang", mem_size=8, max_steps=128)
    a.block()
    a.ldi(1, 0)
    a.ldb(1, 1)
    a.ldi(2, ord("H"))
    a.br("ne", 1, 2, "exit")
    a.block()                       # the spin block
    a.label("spin")
    a.jmp("spin")
    a.label("exit")
    a.block()
    a.halt(0)
    return a.build(block_seed=0x4A46)


@register_target("libtest")
def libtest_target() -> Program:
    """Main program plus a 'library' routine: when input[0] == 'L' the
    lane runs the library blocks (built with a distinct block-id seed
    range via a second assembler pass is not needed — the ids live in
    the same map, but the library block ids are queryable from
    Program.block_ids[3:], which the per-module coverage tests use)."""
    a = Assembler("libtest", mem_size=8, max_steps=128)
    a.block()                       # 0: main entry
    a.ldi(1, 0)
    a.ldb(1, 1)
    a.ldi(2, ord("L"))
    a.br("ne", 1, 2, "exit")
    a.block()                       # 1: call-site block
    a.jmp("lib")
    a.label("ret")
    a.block()                       # 2: return block
    a.halt(0)
    a.label("exit")
    a.block()                       # 3: plain-exit block
    a.halt(0)
    # --- "library": its own coverage module (own 64KB map + virgin
    # state, like the reference's per-library target_module_t) ---
    a.module("libtest1")
    a.label("lib")
    a.block()                       # 4: lib entry
    a.ldi(3, 1)
    a.ldb(3, 3)
    a.ldi(4, ord("X"))
    a.br("ne", 3, 4, "libout")
    a.block()                       # 5: lib deep block
    a.label("libout")
    a.block()                       # 6: lib exit block
    a.jmp("ret")
    return a.build(block_seed=0x11B7)


@register_target("cgc_like")
def cgc_like_target() -> Program:
    """Packet parser in the spirit of the CGC corpus binaries:

      bytes: 'C' 'G' <type> <len> <payload...>

    type 1: sums payload (loop blocks -> hit-count buckets);
    type 2: stores payload bytes into mem at offsets read from the
    payload itself — an unchecked index is the planted memory bug;
    type 3: echoes (distinct block).
    """
    a = Assembler("cgc_like", mem_size=32, max_steps=256)
    a.block()                                   # entry
    a.load_len(1)
    a.ldi(2, 4)
    a.br("lt", 1, 2, "bad")                     # too short
    a.block()
    a.expect_byte(3, 4, 0, ord("C"), "bad")     # magic
    a.expect_byte(3, 4, 1, ord("G"), "bad")
    # r5 = type, r6 = declared payload len
    a.ldi(3, 2)
    a.ldb(5, 3)
    a.ldi(3, 3)
    a.ldb(6, 3)
    # clamp declared len to actual remaining bytes: r7 = len - 4
    a.addi(7, 1, -4)
    a.br("ge", 7, 6, "len_ok")                  # remaining >= declared?
    a.block()
    a.alu("add", 6, 7, 0)                       # r6 = remaining (r0==0)
    a.label("len_ok")
    a.block()
    # dispatch on type
    a.ldi(2, 1)
    a.br("eq", 5, 2, "type1")
    a.ldi(2, 2)
    a.br("eq", 5, 2, "type2")
    a.ldi(2, 3)
    a.br("eq", 5, 2, "type3")
    a.jmp("bad")

    a.label("type1")                            # checksum loop
    a.block()
    a.ldi(2, 0)                                 # r2 = acc
    a.ldi(3, 0)                                 # r3 = i
    a.label("t1_loop")
    a.br("ge", 3, 6, "t1_done")
    a.block()                                   # loop body block (hit counts)
    a.addi(4, 3, 4)                             # r4 = 4 + i
    a.ldb(4, 4)
    a.alu("add", 2, 2, 4)
    a.addi(3, 3, 1)
    a.jmp("t1_loop")
    a.label("t1_done")
    a.block()
    a.halt(0)

    a.label("type2")                            # keyed store: planted bug
    a.block()
    a.ldi(3, 4)
    a.ldb(4, 3)                                 # r4 = payload[0] = index
    a.ldi(3, 5)
    a.ldb(2, 3)                                 # r2 = payload[1] = value
    # BUG: index used unchecked; mem_size=32, payload[0] can be 0..255
    a.stm(4, 2)
    a.block()
    a.halt(0)

    a.label("type3")                            # echo
    a.block()
    a.halt(0)

    a.label("bad")
    a.block()
    a.halt(1)
    return a.build(block_seed=0xC6C)
