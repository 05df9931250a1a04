"""File IO helpers (reference killerbeez-utils: read_file,
write_buffer_to_file, file_exists, get_temp_filename, md5)."""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Optional, Union

Buf = Union[bytes, bytearray, memoryview]


def read_file(path: Union[str, os.PathLike]) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def write_buffer_to_file(path: Union[str, os.PathLike], buf: Buf) -> None:
    # chaos seam (resilience/chaos.py): finding writes can be made to
    # tear, hit ENOSPC, or die mid-write under --chaos
    from ..resilience.chaos import chaos_point
    data = bytes(buf)
    chaos_point("fs_write", path=str(path), data=data)
    with open(path, "wb") as f:
        f.write(data)


def file_exists(path: Union[str, os.PathLike]) -> bool:
    return os.path.isfile(path)


def get_temp_filename(prefix: str = "kbz", suffix: str = "") -> str:
    fd, path = tempfile.mkstemp(prefix=prefix, suffix=suffix)
    os.close(fd)
    return path


def md5_hex(buf: Buf) -> str:
    """Findings are deduped by md5 of the input buffer
    (reference fuzzer/main.c:410-413)."""
    return hashlib.md5(bytes(buf)).hexdigest()


def ensure_dir(path: Union[str, os.PathLike]) -> None:
    os.makedirs(path, exist_ok=True)
