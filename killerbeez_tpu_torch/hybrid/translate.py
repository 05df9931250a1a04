"""Seed translation between device-tier byte buffers and native
delivery.

The device tier's unit of work is a flat byte buffer (a KBVM input,
or a framed message sequence of the stateful tier).  The native tier's
unit of work is a DELIVERY: bytes on stdin, a file path in argv, or a
message train replayed over TCP/stdin (the reference's
``network_client`` / ``send_tcp_input`` driver layer).  Translation
must be LOSSLESS in the direction that matters — a native-confirmed
finding must map back to the exact buffer the device tier minted, or
the verdict is about a different input.

Two invariants, property-tested over arbitrary byte soup
(tests/test_torch_hybrid.py):

  * delivery round-trip identity:
        ``from_delivery(to_delivery(buf, spec)) == buf``
    for every delivery mode — the delivery carries the raw buffer,
    so translation never loses bytes even though the framed DECODE
    is deliberately lossy (``unframe`` is total: count and lengths
    clip).
  * framed fixpoint: ``unframe`` then ``frame_messages`` is
    idempotent — ``canonical = train_to_buffer(buffer_to_train(buf))``
    satisfies ``buffer_to_train(canonical) == buffer_to_train(buf)``
    and re-encoding ``canonical`` returns ``canonical``.  The message
    train a native target consumes is therefore exactly the train the
    device's stateful tier executed, whatever byte soup the mutator
    made.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..stateful.framing import frame_messages, unframe

#: delivery modes a :class:`~.registry.NativeSpec`
#: may name.  ``stdin`` / ``file`` / ``argv`` are single-shot (the
#: whole buffer is one payload); ``stdin_train`` / ``tcp`` are message
#: trains (the buffer is a framed sequence, replayed
#: message-by-message).
DELIVERY_MODES = ("stdin", "file", "argv", "stdin_train", "tcp")
TRAIN_MODES = ("stdin_train", "tcp")


class NativeDelivery:
    """One translated seed, ready for native replay.

    ``raw`` is always the exact device-side buffer (the lossless back
    channel); ``payload`` is the single-shot byte string; ``messages``
    is the decoded train for train modes (None otherwise).
    """

    __slots__ = ("mode", "raw", "payload", "messages")

    def __init__(self, mode: str, payload: bytes,
                 raw: Optional[bytes] = None,
                 messages: Optional[List[bytes]] = None):
        self.mode = mode
        # None = built native-side (no device buffer to preserve);
        # to_delivery always sets it
        self.raw = bytes(raw) if raw is not None else None
        self.payload = bytes(payload)
        self.messages = ([bytes(m) for m in messages]
                         if messages is not None else None)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        n = len(self.messages) if self.messages is not None else 0
        r = len(self.raw) if self.raw is not None else -1
        return (f"NativeDelivery(mode={self.mode!r}, "
                f"raw={r}B, msgs={n})")


def buffer_to_train(buf: bytes, m_max: int) -> List[bytes]:
    """Decode a device-tier buffer as the message train the stateful tier
    would execute.  Total on any byte soup (``unframe`` clips)."""
    return unframe(bytes(buf), m_max)


def train_to_buffer(msgs: Sequence[bytes], m_max: int) -> bytes:
    """Encode a message train as a canonical framed buffer (strict
    format; clips to the format bounds like ``reframe``)."""
    from ..stateful.framing import MAX_MSG_LEN
    clipped = [bytes(m[:MAX_MSG_LEN]) for m in list(msgs)[:m_max]]
    if not clipped:
        clipped = [b""]
    return frame_messages(clipped, m_max)


def to_delivery(buf: bytes, mode: str = "stdin",
                m_max: int = 0) -> NativeDelivery:
    """Translate one device-tier buffer into a native delivery."""
    buf = bytes(buf)
    if mode not in DELIVERY_MODES:
        raise ValueError(f"unknown delivery mode {mode!r} "
                         f"(choose from {', '.join(DELIVERY_MODES)})")
    if mode in TRAIN_MODES:
        if m_max <= 0:
            raise ValueError(f"delivery mode {mode!r} needs m_max > 0")
        msgs = buffer_to_train(buf, m_max)
        return NativeDelivery(mode, payload=b"".join(msgs),
                              raw=buf, messages=msgs)
    return NativeDelivery(mode, payload=buf, raw=buf)


def from_delivery(d: NativeDelivery, m_max: int = 0) -> bytes:
    """Translate a delivery back to the device-side buffer.  The raw
    buffer rides in the delivery, so this is the identity for
    anything :func:`to_delivery` produced; a delivery built native-
    side (no raw) re-encodes canonically."""
    if d.raw is not None:
        return d.raw
    if d.messages is not None:
        return train_to_buffer(d.messages, m_max or len(d.messages))
    return d.payload
