"""Target execution models: the KBVM bytecode VM (plain PyTorch
engine) and its registered targets.  Targets are compiled to a fixed
int32 instruction tensor and executed batched on the device, with
AFL-style edge coverage (``trace[cur ^ prev]++``, ``prev = cur >> 1``)
recorded from BLOCK instructions at basic-block heads."""

from .vm import Program, VMResult, compile_runner, run_batch
from .compiler import Assembler, assign_block_ids
from . import targets
from . import targets_cgc  # registers the CGC-grade targets
from . import targets_stateful  # registers the session-tier targets

__all__ = ["Program", "VMResult", "compile_runner", "run_batch",
           "Assembler", "assign_block_ids", "targets"]
