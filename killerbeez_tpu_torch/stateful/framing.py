"""Sequence framing codec — one buffer, many messages.

A framed sequence is the stateful tier's wire format: the whole
session travels as ONE candidate buffer so every existing surface
(mutators, corpus store, findings files, sync, the device rings)
carries sequences without change, and the device parses the framing
itself inside the jitted session scan.

Layout (``m_max`` is a static per-target constant, StatefulSpec):

    byte 0              message count c
    bytes 1 .. m_max    per-message length bytes l_0 .. l_{m_max-1}
    bytes 1+m_max ..    message payloads, concatenated in order

Parsing is TOTAL — any byte string decodes to a valid sequence, so
havoc-mutated buffers always execute (a fuzzer's codec must never
reject its own mutants):

    * bytes at/past the buffer's logical length read as 0;
    * the count clips into [1, m_max];
    * message k starts where message k-1 ended and its length clips
      to the bytes actually remaining (possibly 0 — an empty message
      is a legal zero-length exec).

``unframe`` (host, numpy-free), ``parse_frames_np`` (host numpy,
batched) and ``parse_frames`` (torch, on the buffers' device)
implement the SAME clipping rules — the host-driven and in-scan
session executors must agree on where every message boundary sits.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

#: per-message length field is one byte
MAX_MSG_LEN = 255


def header_len(m_max: int) -> int:
    return 1 + int(m_max)


def frame_messages(msgs: Sequence[bytes], m_max: int) -> bytes:
    """Encode a message list into one framed buffer (strict: callers
    framing seeds must fit the format; the PARSER is the total one)."""
    if not 1 <= len(msgs) <= m_max:
        raise ValueError(
            f"sequence has {len(msgs)} messages, format allows "
            f"1..{m_max}")
    for k, m in enumerate(msgs):
        if len(m) > MAX_MSG_LEN:
            raise ValueError(
                f"message {k} is {len(m)} bytes (> {MAX_MSG_LEN})")
    hdr = bytearray(header_len(m_max))
    hdr[0] = len(msgs)
    for k, m in enumerate(msgs):
        hdr[1 + k] = len(m)
    return bytes(hdr) + b"".join(msgs)


def unframe(buf: bytes, m_max: int) -> List[bytes]:
    """Total host-side parse: ``buf`` (its full length is the logical
    length) -> the list of messages the device would execute."""
    n = len(buf)

    def byte_at(i: int) -> int:
        return buf[i] if 0 <= i < n else 0

    m = min(max(byte_at(0), 1), m_max)
    out: List[bytes] = []
    off = header_len(m_max)
    for k in range(m):
        want = byte_at(1 + k)
        ln = min(want, max(n - off, 0))
        out.append(bytes(buf[off:off + ln]))
        off += ln
    return out


def parse_frames_np(bufs: np.ndarray, lengths: np.ndarray,
                    m_max: int) -> Tuple[np.ndarray, np.ndarray,
                                         np.ndarray]:
    """Batched numpy parse (host replay / tools): uint8[B, L] +
    int32[B] -> (m int32[B], offs int32[B, m_max], mlens
    int32[B, m_max]).  Messages k >= m have offset/length 0."""
    bufs = np.asarray(bufs, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int64)
    b, L = bufs.shape
    hdr = header_len(m_max)

    def byte_at(i):
        ok = (i < lengths) & (i < L)
        return np.where(ok, bufs[:, min(i, L - 1)], 0).astype(np.int64)

    m = np.clip(byte_at(0), 1, m_max)
    offs = np.zeros((b, m_max), dtype=np.int32)
    mlens = np.zeros((b, m_max), dtype=np.int32)
    off = np.full(b, hdr, dtype=np.int64)
    for k in range(m_max):
        live = k < m
        want = byte_at(1 + k)
        ln = np.minimum(want, np.maximum(lengths - off, 0))
        ln = np.where(live, ln, 0)
        offs[:, k] = np.where(live, off, 0)
        mlens[:, k] = ln
        off = off + ln
    return m.astype(np.int32), offs, mlens


def parse_frames(bufs, lengths, m_max: int):
    """Batched parse on the buffers' device, bit-identical to
    ``parse_frames_np`` (and to ``unframe`` row-wise): uint8[B, L]
    + int[B] tensors -> (m int32[B], offs int32[B, m_max], mlens
    int32[B, m_max])."""
    import torch

    L = bufs.shape[1]
    hdr = header_len(m_max)
    lengths = lengths.to(device=bufs.device, dtype=torch.int64)

    def byte_at(i: int):
        ok = (i < lengths) & (i < L)
        return torch.where(ok, bufs[:, min(i, L - 1)].to(torch.int64), 0)

    m = byte_at(0).clamp(1, m_max)
    offs, mlens = [], []
    off = torch.full_like(lengths, hdr)
    for k in range(m_max):
        live = k < m
        want = byte_at(1 + k)
        ln = torch.minimum(want, (lengths - off).clamp(min=0))
        ln = torch.where(live, ln, 0)
        offs.append(torch.where(live, off, 0))
        mlens.append(ln)
        off = off + ln
    return (m.to(torch.int32), torch.stack(offs, 1).to(torch.int32),
            torch.stack(mlens, 1).to(torch.int32))


def reframe(buf: bytes, msgs: Sequence[bytes], m_max: int) -> bytes:
    """Re-encode mutated per-message payloads over an existing framed
    buffer's shape (the multipart round-trip primitive): message
    boundaries come from the NEW payload lengths, count from the
    message list — ``unframe(reframe(...))`` always returns exactly
    ``msgs`` (clipped to the strict-format bounds)."""
    del buf  # shape comes entirely from msgs; kept for call symmetry
    clipped = [bytes(m[:MAX_MSG_LEN]) for m in list(msgs)[:m_max]]
    if not clipped:
        clipped = [b""]
    return frame_messages(clipped, m_max)


def compose_manager_seed(msgs: Sequence[bytes]) -> bytes:
    """Encode a message list as a multipart (manager) mutator seed —
    the mem-array form whose parts become the children's seeds.
    Pair with the manager mutator's ``{"framed": 1}`` option so the
    composites come out as framed sequences."""
    from ..utils.serialization import encode_mem_array
    return encode_mem_array(list(msgs)).encode("ascii")


def main(argv=None) -> int:
    """kb-frame — frame message files/strings into one sequence file.

    Usage: kb-frame -o seq.bin [--m-max 4] msg1.bin msg2.bin ...
           kb-frame -o seq.bin -s 'Lpw' -s 'Q' -s 'X'
    """
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="kb-frame",
        description="frame messages into a stateful-tier sequence")
    p.add_argument("msgs", nargs="*", help="message files, in order")
    p.add_argument("-s", "--string", action="append", default=[],
                   help="literal message string (repeatable; "
                        "appended after file messages)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--m-max", type=int, default=4,
                   help="sequence capacity (must match the target's "
                        "StatefulSpec; default 4)")
    args = p.parse_args(argv)
    try:
        parts: List[bytes] = []
        for path in args.msgs:
            with open(path, "rb") as f:
                parts.append(f.read())
        parts.extend(s.encode() for s in args.string)
        framed = frame_messages(parts, args.m_max)
        with open(args.output, "wb") as f:
            f.write(framed)
        print(f"{args.output}: {len(parts)} message(s), "
              f"{len(framed)} bytes")
        return 0
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    import sys
    sys.exit(main())
