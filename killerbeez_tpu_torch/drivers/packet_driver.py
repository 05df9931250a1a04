"""Shared base for packet-sequence drivers (network_server /
network_client): both deliver the input as an ordered sequence of
network packets, mutate multi-part inputs via
``mutate_extended(MUTATE_MULTIPLE_INPUTS|i)`` and serialize the last
input with ``encode_mem_array`` (reference driver/network_*_driver.c
share the same glue through driver.c helpers)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .. import FUZZ_NONE
from ..instrumentation.base import BatchResult
from ..mutators.base import MUTATE_MULTIPLE_INPUTS, pack_byte_rows
from ..utils.serialization import decode_mem_array, encode_mem_array
from .base import BatchOutcome, Driver


class PacketDriver(Driver):
    """Delivers inputs as packet sequences; subclasses implement
    ``_run(parts)`` for their connection direction."""

    def __init__(self, options, instrumentation, mutator=None,
                 device="cuda"):
        super().__init__(options, instrumentation, mutator, device=device)
        if "path" not in self.options or "port" not in self.options:
            raise ValueError(
                f'{self.name} needs {{"path": ..., "port": ...}}')
        self.port = int(self.options["port"])
        self.udp = bool(self.options["udp"])
        self.num_inputs = 1
        self.input_sizes: List[int] = []
        if self.mutator is not None:
            self.num_inputs, self.input_sizes = \
                self.mutator.get_input_info()

    def _check_input_info(self) -> None:
        # Multi-input is the point of packet drivers; any part count.
        pass

    @property
    def supports_batch(self) -> bool:
        # candidate generation batches (the manager mutator runs
        # every child's turns in one call); delivery stays per exec:
        # live sockets can't be vectorized
        return self.mutator is not None and self.mutator.batch_capable

    def test_batch(self, n: int, pad_to: Optional[int] = None,
                   prefetch_next=True) -> BatchOutcome:
        """Batch-mutate ``n`` packet sequences, deliver them one
        connection at a time, and assemble host-side result arrays
        (statuses/novelty from the instrumentation after each run).
        Saved inputs are encoded mem arrays, like the single-exec
        path's last_input."""
        if not self.supports_batch:
            raise RuntimeError(f"{self.name}: batch path unavailable")
        if hasattr(self.mutator, "mutate_batch_parts"):
            seqs = self.mutator.mutate_batch_parts(n)
        else:
            # one bulk copy to the host, not 2n per-lane round trips
            bufs, lens = self.mutator.mutate_batch_host(n)
            seqs = [[bufs[j, :int(lens[j])].tobytes()] for j in range(n)]
        instr = self.instrumentation
        total = pad_to if (pad_to is not None and pad_to > n) else n
        statuses = np.full(total, FUZZ_NONE, dtype=np.int32)
        new_paths = np.zeros(total, dtype=np.int32)
        uc = np.zeros(total, dtype=bool)
        uh = np.zeros(total, dtype=bool)
        encoded: List[bytes] = []
        for j, parts in enumerate(seqs):
            statuses[j] = self._run(parts)
            new_paths[j] = instr.is_new_path()
            uc[j] = instr.last_unique_crash()
            uh[j] = instr.last_unique_hang()
            encoded.append(encode_mem_array(parts).encode())
        self.last_input = encoded[-1] if encoded else None
        inputs, lengths = pack_byte_rows(encoded or [b""])
        if total > inputs.shape[0]:
            inputs = np.concatenate(
                [inputs, np.zeros((total - inputs.shape[0],
                                   inputs.shape[1]), np.uint8)])
            lengths = np.concatenate(
                [lengths, np.zeros(total - lengths.shape[0], np.int32)])
        result = BatchResult(statuses=statuses, new_paths=new_paths,
                             unique_crashes=uc, unique_hangs=uh,
                             exit_codes=np.zeros(total, dtype=np.int32))
        return BatchOutcome(result=result, inputs=inputs,
                            lengths=lengths)

    def _cmd_line(self) -> str:
        return (f'{self.options["path"]} '
                f'{self.options["arguments"]}').strip()

    def _run(self, parts: List[bytes]) -> int:
        raise NotImplementedError

    # -- vtable ---------------------------------------------------------

    def test_input(self, buf: bytes) -> int:
        """Input is an encoded mem array of packets (reference
        decode_mem_array contract); raw bytes = one packet."""
        try:
            parts = decode_mem_array(buf.decode())
        except Exception:
            parts = [buf]
        self.last_input = encode_mem_array(parts).encode()
        return self._run(parts)

    def test_next_input(self) -> Optional[int]:
        if self.mutator is None:
            raise RuntimeError(f"{self.name}: no mutator attached")
        parts: List[bytes] = []
        if self.num_inputs > 1:
            for i in range(self.num_inputs):
                part = self.mutator.mutate_extended(
                    MUTATE_MULTIPLE_INPUTS | i)
                if part is None:
                    return None
                parts.append(part)
        else:
            buf = self.mutator.mutate()
            if buf is None:
                return None
            parts = [buf]
        self.last_input = encode_mem_array(parts).encode()
        return self._run(parts)

    def get_last_input(self) -> Optional[bytes]:
        return self.last_input
