"""Driver base class (reference driver/driver.h:26-34).

Vtable parity: cleanup / test_input / test_next_input /
get_last_input.  ``test_next_input`` returns the FUZZ_* verdict or
``None`` when the mutator is exhausted.

``test_batch(n)`` mutates and executes ``n`` candidates in one device
step when both the mutator and the instrumentation batch; with a
fusable mutator the instrumentation generates the candidates inside
the VM kernel.  A short unfused batch may be padded to a fixed lane
count with copies of lane 0, as the JAX package pads its tail batches:
the copies are coverage no-ops, the loop triages only the real lanes,
and the instrumentation counts every executed lane, as the JAX
package's does.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional

import torch

from .. import resolve_device
from ..instrumentation.base import BatchResult, Instrumentation
from ..mutators.base import Mutator
from ..utils.options import format_help, parse_options


class BatchOutcome(NamedTuple):
    result: Optional[BatchResult]
    inputs: Any           # uint8[B, L] (device tensor)
    lengths: Any          # int32[B]
    #: device-compacted interesting-lane report (fused path only)
    compact: Optional[Any] = None


class Driver:
    name = "base"
    OPTION_SCHEMA: Dict[str, type] = {}
    OPTION_DESCS: Dict[str, str] = {}
    DEFAULTS: Dict[str, Any] = {}

    #: telemetry StageTimer installed by the Fuzzer; drivers time the
    #: mutate/execute boundary with it (enqueue time only: the device
    #: work runs on asynchronously, so no wait is forced here)
    stage_timer = None

    def _span(self, stage: str):
        t = self.stage_timer
        return t(stage) if t is not None else contextlib.nullcontext()

    def __init__(self, options: Optional[str],
                 instrumentation: Instrumentation,
                 mutator: Optional[Mutator] = None, device="cuda"):
        self.options = parse_options(options, self.OPTION_SCHEMA,
                                     self.DEFAULTS)
        self.device = resolve_device(device)
        for part in (instrumentation, mutator):
            dev = getattr(part, "device", None)
            if dev is not None and dev.type != self.device.type:
                raise ValueError(
                    f"{self.name} driver on {self.device} was given "
                    f"{type(part).__name__} on {dev}")
        self.instrumentation = instrumentation
        self.mutator = mutator
        self.last_input: Optional[bytes] = None
        self._last_batch_tail = None
        self._check_input_info()

    def _check_input_info(self) -> None:
        """Single-input drivers require num_inputs == 1."""
        if self.mutator is not None:
            num, _ = self.mutator.get_input_info()
            if num != 1:
                raise ValueError(
                    f"{self.name} driver requires a single-input mutator, "
                    f"got {num} parts")

    @property
    def supports_batch(self) -> bool:
        return (self.instrumentation.supports_batch
                and self.instrumentation.device_backed
                and self.mutator is not None
                and self.mutator.batch_capable)

    # -- single-exec ----------------------------------------------------

    def test_input(self, buf: bytes) -> int:
        raise NotImplementedError

    def test_next_input(self) -> Optional[int]:
        """Mutate then test. None = mutator exhausted."""
        if self.mutator is None:
            raise RuntimeError(f"{self.name}: no mutator attached")
        buf = self.mutator.mutate()
        if buf is None:
            return None
        return self.test_input(buf)

    def get_last_input(self) -> Optional[bytes]:
        if self.last_input is None and self._last_batch_tail is not None:
            bufs, lens, i = self._last_batch_tail
            self.last_input = bufs[i, :int(lens[i])].cpu().numpy().tobytes()
            self._last_batch_tail = None
        return self.last_input

    # -- batched --------------------------------------------------------

    def _wants_fused(self) -> bool:
        wants = getattr(self.instrumentation, "wants_fused", None)
        return wants is not None and wants(self.mutator)

    def test_batch(self, n: int, pad_to: Optional[int] = None
                   ) -> BatchOutcome:
        """Mutate + execute ``n`` candidates; results stay on the
        device.  ``pad_to`` pads an unfused batch of fewer lanes with
        copies of lane 0 (the fused kernel runs only ``n``)."""
        if not self.supports_batch:
            raise RuntimeError(f"{self.name}: batch path unavailable")
        if self._wants_fused():
            its = self.mutator.peek_iterations(n)
            with self._span("execute"):     # mutation is in-kernel
                result, bufs, lens, compact = \
                    self.instrumentation.run_batch_fused(self.mutator,
                                                         its)
            self.mutator.advance(n)
        else:
            with self._span("mutate"):
                bufs, lens = self.mutator.mutate_batch(n)
            if pad_to is not None and pad_to > n:
                pad = pad_to - n
                bufs = torch.cat([bufs, bufs[:1].expand(pad, -1)])
                lens = torch.cat([lens, lens[:1].expand(pad)])
            with self._span("execute"):
                result = self.instrumentation.run_batch(bufs, lens)
            compact = None
        self._last_batch_tail = (bufs, lens, n - 1)
        self.last_input = None
        return BatchOutcome(result=result, inputs=bufs, lengths=lens,
                            compact=compact)

    def supports_fused_multi(self) -> bool:
        """True when test_batch_fused_multi can run: the fused device
        path with a multi-step instrumentation."""
        return (self.supports_batch
                and hasattr(self.instrumentation, "run_batch_fused_multi")
                # edges mode keeps each batch's counts, which the
                # multi path does not
                and not getattr(self.instrumentation, "options",
                                {}).get("edges")
                and self._wants_fused())

    def test_batch_fused_multi(self, n: int, k: int):
        """K consecutive fused batches of ``n`` in one call; candidate
        and verdict streams are bit-identical to k test_batch(n)
        calls.  Returns the stacked device tensors (packed[k, B],
        bufs[k, B, L], lens[k, B], stacked compact)."""
        its = self.mutator.peek_iterations(n)
        with self._span("execute"):
            packed, bufs, lens, compact = \
                self.instrumentation.run_batch_fused_multi(self.mutator,
                                                           its, k)
        self.mutator.advance(k * n)
        self._last_batch_tail = (bufs[k - 1], lens[k - 1], n - 1)
        self.last_input = None
        return packed, bufs, lens, compact

    def supports_batch_generations(self) -> bool:
        """True when test_batch_generations can run: a device-backed
        instrumentation with the generation loop (jit_harness) and a
        fused-capable mutator with no focus mask installed.  Re-checked
        per dispatch — the stand-down discipline of the fused
        superbatch path."""
        supports = getattr(self.instrumentation, "supports_generations",
                           None)
        return (self.supports_batch and supports is not None
                and supports(self.mutator))

    def test_batch_generations(self, n: int, g: int,
                               pad_to: Optional[int] = None,
                               reseed: bool = True):
        """``g`` full fuzzing generations in one device dispatch
        (mutate -> execute -> triage -> ring reseed all on the device);
        the host gets back only the bounded findings ring + admission
        ledger (a GenerationOutcome of device tensors).  Generation j
        consumed iterations ``it0 + j*n``; the mutator advances by
        g*n."""
        its = self.mutator.peek_iterations(n)
        with self._span("execute"):     # the whole loop is on the device
            out = self.instrumentation.run_batch_generations(
                self.mutator, its, g, pad_to=pad_to, reseed=reseed)
        self.mutator.advance(g * n)
        # the per-exec last-input contract doesn't apply: candidate
        # tensors never leave the device in this mode
        self._last_batch_tail = None
        self.last_input = None
        return out

    def cleanup(self) -> None:
        pass

    @classmethod
    def help(cls) -> str:
        head = f"{cls.name} driver"
        doc = (cls.__doc__ or "").strip().splitlines()
        if doc:
            head += f" — {doc[0]}"
        return head + "\n" + format_help(cls.name, cls.OPTION_SCHEMA,
                                         cls.OPTION_DESCS)
