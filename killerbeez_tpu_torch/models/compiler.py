"""Assembler for KBVM programs.

Plays the role of the reference's compile-time instrumentation
(afl_progs/afl-as.c): targets are written against a tiny assembler
API; ``block()`` marks basic-block heads and ``build()`` assigns each
one a deterministic pseudo-random coverage id — the same scheme
afl-as uses (random cur_loc per block, edge = cur ^ prev).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .. import MAP_SIZE
from .vm import (
    ALU_ADD, ALU_AND, ALU_MUL, ALU_OR, ALU_SHL, ALU_SHR, ALU_SUB, ALU_XOR,
    CMP_EQ, CMP_GE, CMP_LT, CMP_NE, N_REGS,
    OP_ALU, OP_ADDI, OP_BLOCK, OP_BR, OP_CRASH, OP_HALT, OP_JMP, OP_LDB,
    OP_LDI, OP_LDM, OP_LEN, OP_STM, Program,
)

_ALU_NAMES = {"add": ALU_ADD, "sub": ALU_SUB, "and": ALU_AND, "or": ALU_OR,
              "xor": ALU_XOR, "shl": ALU_SHL, "shr": ALU_SHR,
              "mul": ALU_MUL}
_CMP_NAMES = {"eq": CMP_EQ, "ne": CMP_NE, "lt": CMP_LT, "ge": CMP_GE}

Ref = Union[str, int]  # label name or absolute pc


class Assembler:
    """Builds a Program. Registers are r0..r7; labels are strings."""

    def __init__(self, name: str = "anon", mem_size: int = 64,
                 max_steps: int = 256):
        self.name = name
        self.mem_size = mem_size
        self.max_steps = max_steps
        self.rows: List[List[Union[int, str]]] = []
        self.labels: Dict[str, int] = {}
        self._n_blocks = 0
        # (module_name, first_block_index) marks; blocks before the
        # first mark belong to the default "target" module
        self._module_marks: List[Tuple[str, int]] = []

    # -- assembly -------------------------------------------------------

    def _reg(self, r: int) -> int:
        if not (0 <= r < N_REGS):
            raise ValueError(f"register r{r} out of range")
        return r

    def _emit(self, op: int, a: Union[int, str] = 0,
              b: Union[int, str] = 0, c: Union[int, str] = 0) -> int:
        for field in (a, b, c):
            # the batched engine fetches instructions through an f32
            # matmul (vm._step_batched), exact only below 2^24
            if isinstance(field, int) and abs(field) >= (1 << 24):
                raise ValueError(
                    f"instruction field {field} exceeds the engine's "
                    f"2^24 exact-integer bound; build large constants "
                    f"with shl/or")
        self.rows.append([op, a, b, c])
        return len(self.rows) - 1

    def label(self, name: str) -> None:
        if name in self.labels:
            raise ValueError(f"duplicate label {name!r}")
        self.labels[name] = len(self.rows)

    def block(self) -> None:
        """Basic-block head: coverage point (id assigned at build)."""
        self._n_blocks += 1
        self._emit(OP_BLOCK, f"__block_{self._n_blocks - 1}")

    def module(self, name: str) -> None:
        """Start a coverage module: subsequent blocks belong to it
        (the reference's per-module maps — a target's shared libraries
        each get their own map + virgin state,
        dynamorio_instrumentation.h:27-41; here modules are
        block-index ranges with their own 64KB slot space)."""
        if self._module_marks and \
                self._module_marks[-1][1] == self._n_blocks:
            raise ValueError(
                f"module {name!r} would start at the same block as "
                f"{self._module_marks[-1][0]!r} (empty module)")
        self._module_marks.append((name, self._n_blocks))

    def halt(self, code: int = 0) -> None:
        self._emit(OP_HALT, code)

    def crash(self) -> None:
        self._emit(OP_CRASH)

    def ldb(self, rd: int, rs: int) -> None:
        """rd = input[r[rs]] (0 when out of bounds)."""
        self._emit(OP_LDB, self._reg(rd), self._reg(rs))

    def ldi(self, rd: int, imm: int) -> None:
        self._emit(OP_LDI, self._reg(rd), int(imm))

    def alu(self, op: str, rd: int, ra: int, rb: int) -> None:
        sel = _ALU_NAMES[op]
        self._emit(OP_ALU, self._reg(rd), self._reg(ra),
                   sel | (self._reg(rb) << 3))

    def addi(self, rd: int, ra: int, imm: int) -> None:
        self._emit(OP_ADDI, self._reg(rd), self._reg(ra), int(imm))

    def jmp(self, target: Ref) -> None:
        self._emit(OP_JMP, target)

    def br(self, cmp: str, ra: int, rb: int, target: Ref) -> None:
        """if r[ra] <cmp> r[rb]: goto target."""
        sel = _CMP_NAMES[cmp]
        self._emit(OP_BR, self._reg(ra), sel | (self._reg(rb) << 2),
                   target)

    def load_len(self, rd: int) -> None:
        self._emit(OP_LEN, self._reg(rd))

    def ldm(self, rd: int, ra: int) -> None:
        """rd = mem[r[ra]]; out-of-bounds crashes the lane."""
        self._emit(OP_LDM, self._reg(rd), self._reg(ra))

    def stm(self, ra: int, rb: int) -> None:
        """mem[r[ra]] = r[rb]; out-of-bounds crashes the lane."""
        self._emit(OP_STM, self._reg(ra), self._reg(rb))

    # -- convenience macros --------------------------------------------

    def expect_byte(self, index_reg_scratch: int, value_reg_scratch: int,
                    index: int, value: int, fail: Ref) -> None:
        """if input[index] != value: goto fail  (burns two scratch regs).
        Starts a new coverage block on the match path."""
        self.ldi(index_reg_scratch, index)
        self.ldb(index_reg_scratch, index_reg_scratch)
        self.ldi(value_reg_scratch, value)
        self.br("ne", index_reg_scratch, value_reg_scratch, fail)
        self.block()

    # -- build ----------------------------------------------------------

    def build(self, block_seed: int = 0xB10C) -> Program:
        # a trailing module() with no blocks after it passes the
        # consecutive-mark check in module() but would build a
        # (name, lo, hi) range with lo == hi — reject it the same way
        if self._module_marks and \
                self._module_marks[-1][1] == self._n_blocks:
            raise ValueError(
                f"module {self._module_marks[-1][0]!r} would start "
                f"at the same block as the program ends "
                f"(empty module)")
        ids = assign_block_ids(self._n_blocks, block_seed)
        instrs = np.zeros((len(self.rows), 4), dtype=np.int32)
        for i, row in enumerate(self.rows):
            out = []
            for field in row:
                if isinstance(field, str):
                    if field.startswith("__block_"):
                        out.append(int(ids[int(field[8:])]))
                    elif field in self.labels:
                        out.append(self.labels[field])
                    else:
                        raise ValueError(f"undefined label {field!r}")
                else:
                    out.append(int(field))
            instrs[i] = out
        marks = self._module_marks
        if not marks or marks[0][1] > 0:
            marks = [("target", 0)] + marks
        modules = tuple(
            (name, lo, marks[i + 1][1] if i + 1 < len(marks)
             else self._n_blocks)
            for i, (name, lo) in enumerate(marks))
        return Program(instrs=instrs, name=self.name,
                       mem_size=self.mem_size, max_steps=self.max_steps,
                       n_blocks=self._n_blocks,
                       block_ids=tuple(int(x) for x in ids),
                       modules=modules)


def assign_block_ids(n_blocks: int, seed: int = 0xB10C) -> np.ndarray:
    """Deterministic pseudo-random coverage ids, one per basic block
    (afl-as picks ``random() % MAP_SIZE`` per block; deterministic
    here so programs are reproducible artifacts)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, MAP_SIZE, size=n_blocks, dtype=np.int64)
