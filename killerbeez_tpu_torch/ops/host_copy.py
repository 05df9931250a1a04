"""Host copies of device tensors that start without blocking.

The fuzzing loop and the generation loop's report read device results
on the host one or more dispatches after enqueueing them, and the
mutators' prefetch reads candidates for host-executed targets: each
copy goes to pinned memory with a non-blocking copy on the current
stream and a CUDA event, and the host waits on the event only when it
reads the values.
"""

from __future__ import annotations

import numpy as np
import torch


class HostCopy:
    """A device tensor's host copy, started without blocking: a
    non-blocking copy into pinned memory plus a CUDA event, waited on
    only when the host reads it.  CPU tensors and numpy arrays (the
    results of host-executed targets) are used as they are."""

    def __init__(self, t):
        self._event = None
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t
        self._np = None

    def ready(self) -> bool:
        """Whether the copy has landed — a probe that never waits."""
        return self._np is not None or self._event is None \
            or self._event.query()

    def materialize(self) -> np.ndarray:
        if self._np is None:
            if self._event is not None:
                self._event.synchronize()
            self._np = self._host.numpy()
        return self._np

    def __array__(self, dtype=None, copy=None):
        a = self.materialize()
        return a.astype(dtype) if dtype is not None else a

    def row(self, i: int) -> "LazyRow":
        return LazyRow(self, i)


class LazyRow:
    """numpy-coercible view of one row of a stacked HostCopy."""

    def __init__(self, holder: HostCopy, i: int):
        self._holder = holder
        self._i = i

    def ready(self) -> bool:
        return self._holder.ready()

    def __array__(self, dtype=None, copy=None):
        r = np.asarray(self._holder.materialize()[self._i])
        return r.astype(dtype) if dtype is not None else r
