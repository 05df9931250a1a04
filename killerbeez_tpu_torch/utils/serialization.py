"""Serialization helpers for component state and multi-part inputs.

The reference serializes instrumentation/mutator state as JSON strings
with base64 payloads (reference afl_instrumentation.c:62-79) and
multi-part inputs via encode_mem_array/decode_mem_array (reference
network_server_driver.c:544). Same contracts here.
"""

from __future__ import annotations

import base64
import json
import zlib
from typing import Any, Dict, List, Sequence, Union

import numpy as np

Buf = Union[bytes, bytearray, memoryview]


def b64(buf: Buf) -> str:
    return base64.b64encode(bytes(buf)).decode("ascii")


def unb64(s: str) -> bytes:
    return base64.b64decode(s)


def encode_array(arr: np.ndarray, compress: bool = True) -> Dict[str, Any]:
    """Encode a numpy array as a JSON-safe dict (base64, optionally
    zlib-compressed — virgin maps are mostly 0xFF and compress ~1000x)."""
    raw = np.ascontiguousarray(arr).tobytes()
    payload = zlib.compress(raw) if compress else raw
    return {
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
        "zlib": bool(compress),
        "data": b64(payload),
    }


def decode_array(d: Dict[str, Any]) -> np.ndarray:
    raw = unb64(d["data"])
    if d.get("zlib"):
        raw = zlib.decompress(raw)
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(d["shape"]).copy()


def encode_mem_array(bufs: Sequence[Buf]) -> str:
    """Serialize a list of byte buffers to a JSON string (multi-part
    last-input serialization, reference network_server_driver.c:544)."""
    return json.dumps([b64(b) for b in bufs])


def decode_mem_array(s: str) -> List[bytes]:
    return [unb64(x) for x in json.loads(s)]


def state_dumps(state: Dict[str, Any]) -> str:
    """Component get_state contract: a self-contained JSON string."""
    return json.dumps(state)


def state_loads(s: str) -> Dict[str, Any]:
    if not s:
        return {}
    return json.loads(s)
