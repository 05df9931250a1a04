"""LearnTier — the campaign-side owner of learned mutation shaping.

One instance rides a Fuzzer (fuzzer/loop.py, ``--learn``): it collects
labels from the admission stream (positives) and the rejected-lane
stream (negatives), trains the byte-saliency model (learn/model.py) on
its device (the card, unless the caller asks for the CPU) between
fuzzing dispatches, and serves the result through two mask paths:

  * ``scan_params()`` — the raw weights, handed to the generation loops
    (-G on one device and --mesh), which run inference per generation
    on the selected seed-ring slot without the host;
  * ``focus_positions_for()`` — host-loop mode: the quantized mask of
    the freshly rotated seed, installed via ``Mutator.set_focus_mask``.

Stand-down / parity doctrine: until the first training round
(``version`` 0) the model's output layer is zero, masks quantize to
all-ones, and the shaped loops are bit-identical to the unshaped ones;
host-loop masks are only installed once the model has trained AND the
mask actually excludes something.  State (weights + version + label
counters) persists through the campaign checkpoint epoch so
``--resume`` restores the model, in the JAX package's format; label
samples rebuild from provenance sidecars
(dataset.samples_from_entries) — explicit reject negatives restart
empty, which only slows re-sharpening, never corrupts it.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..utils.logging import WARNING_MSG
from . import dataset, model


class LearnTier:
    """Labels in, trained masks out (see module doc)."""

    def __init__(self, train_interval_s: float = 5.0,
                 min_labels: int = 64, steps_per_round: int = 8,
                 batch: int = 256, lr: float = model.LEARN_RATE,
                 sample_cap: int = 8192, max_len: int = 4096,
                 time_fn=time.time, device="cuda"):
        self.device = resolve_device(device)
        self.params = model.init_params(device=self.device)
        #: 0 = untrained (all-ones masks, the parity regime); each
        #: completed training round increments it
        self.version = 0
        self.labels = dataset.LabelBuffer(cap=sample_cap,
                                          max_len=max_len)
        self.train_interval_s = float(train_interval_s)
        self.min_labels = int(min_labels)
        self.steps_per_round = int(steps_per_round)
        self.batch = int(batch)
        self.lr = float(lr)
        self._time = time_fn
        self._last_train = 0.0
        self._labels_at_train = 0
        self.train_steps = 0
        self.masks_applied = 0
        #: bounded budget of reject negatives per admission-free
        #: stretch (rejected bucket-only lanes can vastly outnumber
        #: admissions — unbounded they drown the positives)
        self._reject_budget = 64
        #: positive-label informativeness cap: a stacked-havoc child
        #: whose diff rewrites more than this many positions carries
        #: ~no positional signal, so the tier trains only on small,
        #: attributable diffs (its provenance is still recorded)
        self.informative_diff = 24

    # -- label intake ----------------------------------------------------

    def note_admission(self, parent_key: str, parent: bytes,
                       child: bytes, mutator: str,
                       stage: Optional[str] = None
                       ) -> Optional[Dict[str, Any]]:
        """One admitted edge-novel child: label the parent positions
        its mutation touched as positive, sample untouched positions
        as background negatives, and return the provenance record the
        admission writes into the child's sidecar.  Never raises — a
        label failure must not stop triage."""
        try:
            prov = dataset.make_provenance(parent, child, mutator,
                                           stage)
            bm = dataset.diff_bitmap(parent, child,
                                     self.labels.max_len)
            pos = np.flatnonzero(bm)
            if pos.size and pos.size <= self.informative_diff:
                # small diff: the mutated positions are attributable
                self.labels.add(parent_key, parent, pos, 1)
                pm = np.zeros(min(len(parent), self.labels.max_len),
                              np.uint8)
                inb = pos[pos < pm.size]
                pm[inb] = 1
                self.labels.add_background(parent_key, parent, pm)
            self._reject_budget = 64
            return prov
        except Exception as e:
            WARNING_MSG("learn: admission label failed: %s", e)
            return None

    def note_reject(self, parent_key: str, parent: bytes,
                    child: bytes) -> None:
        """One interesting-but-not-admitted lane (bucket-only new
        path): its mutated positions are explicit negatives,
        budget-capped between admissions."""
        if self._reject_budget <= 0:
            return
        try:
            bm = dataset.diff_bitmap(parent, child,
                                     self.labels.max_len)
            pos = np.flatnonzero(bm)
            if pos.size and pos.size <= self.informative_diff:
                self._reject_budget -= 1
                self.labels.add(parent_key, parent, pos, 0, cap=8)
        except Exception as e:
            WARNING_MSG("learn: reject label failed: %s", e)

    def bootstrap(self, entries, parent_bytes) -> int:
        """Rebuild labels from persisted provenance sidecars (--resume
        / a pre-populated corpus)."""
        try:
            return dataset.samples_from_entries(
                self.labels, entries, parent_bytes,
                informative_diff=self.informative_diff)
        except Exception as e:
            WARNING_MSG("learn: bootstrap failed: %s", e)
            return 0

    # -- training --------------------------------------------------------

    def ready_to_train(self) -> bool:
        if len(self.labels) < self.min_labels or \
                self.labels.positives == 0:
            return False
        if self._time() - self._last_train < self.train_interval_s:
            return False
        # retrain only when new labels arrived since the last round,
        # judged on the MONOTONE intake counter (the buffer length pins
        # at cap once the FIFO saturates)
        return self.labels.total_added != self._labels_at_train \
            or self.version == 0

    def train_round(self) -> Optional[float]:
        """``steps_per_round`` SGD steps on fresh sample batches, on
        the tier's device.  Returns the final batch loss (the round's
        one host read), or None if there was nothing to train on."""
        loss = None
        for _ in range(self.steps_per_round):
            b = self.labels.make_batch(self.batch)
            if b is None:
                return None if loss is None else float(loss)
            bufs, lens, poss, ys = b
            X = model.batch_features(
                torch.as_tensor(bufs, device=self.device), lens, poss)
            # class rebalance: admissions are rare — upweight
            # positives to parity with the negative mass
            npos = max(float(ys.sum()), 1.0)
            nneg = max(float(len(ys) - ys.sum()), 1.0)
            w = np.where(ys > 0, nneg / npos, 1.0).astype(np.float32)
            self.params, loss = model.train_step(
                self.params, X, ys, w, self.lr)
            self.train_steps += 1
        self.version += 1
        self._last_train = self._time()
        self._labels_at_train = self.labels.total_added
        return None if loss is None else float(loss)

    def maybe_train(self, registry=None, telemetry=None) -> bool:
        """The loop's between-dispatches hook: train when due, fold the
        counters/gauges, emit one ``learn_update`` campaign event per
        completed round."""
        if registry is not None:
            registry.counters["learn_masks_applied"] = \
                self.masks_applied
            registry.gauge("learn_label_count", len(self.labels))
        if not self.ready_to_train():
            return False
        loss = self.train_round()
        if registry is not None:
            registry.counters["learn_train_steps"] = self.train_steps
            registry.gauge("learn_model_version", self.version)
            registry.gauge("learn_label_count", len(self.labels))
        if telemetry is not None:
            telemetry.event(
                "learn_update", version=int(self.version),
                labels=int(len(self.labels)),
                positives=int(self.labels.positives),
                train_steps=int(self.train_steps),
                loss=(round(loss, 5) if loss is not None else None))
        return True

    # -- mask serving ----------------------------------------------------

    def scan_params(self):
        """The weights for in-loop inference (the generation loops run
        model.masked_saliency per generation themselves)."""
        return self.params

    def mask_for(self, seed: bytes) -> Optional[np.ndarray]:
        """uint8 mask over ``seed`` under the current model, or None
        while untrained (version 0 — all-ones by construction, not
        worth a device call)."""
        if self.version == 0 or not seed:
            return None
        L = max(((len(seed) + 7) // 8) * 8, 8)
        buf = np.zeros(L, np.uint8)
        buf[:len(seed)] = np.frombuffer(bytes(seed), np.uint8)
        return model.masked_saliency(
            self.params, torch.as_tensor(buf, device=self.device),
            len(seed)).cpu().numpy()

    def focus_positions_for(self, seed: bytes
                            ) -> Optional[List[int]]:
        """Host-loop mask source: the positions the model keeps, or
        None when shaping would be a no-op (untrained, mask all-ones
        over the live prefix, or mask empty — an empty mask must never
        pin mutation to nothing, the set_focus_mask contract)."""
        mask = self.mask_for(seed)
        if mask is None:
            return None
        live = mask[:len(seed)]
        pos = np.flatnonzero(live).tolist()
        if not pos or len(pos) == len(seed):
            return None
        self.masks_applied += 1
        return pos

    # -- persistence (the campaign checkpoint epoch) ---------------------

    def state_dict(self) -> Dict[str, Any]:
        return {"version": int(self.version),
                "train_steps": int(self.train_steps),
                "masks_applied": int(self.masks_applied),
                "params": model.encode_params(self.params)}

    def load_state(self, d: Dict[str, Any]) -> None:
        try:
            if isinstance(d.get("params"), dict):
                self.params = model.decode_params(d["params"],
                                                  self.device)
            self.version = int(d.get("version", 0))
            self.train_steps = int(d.get("train_steps", 0))
            self.masks_applied = int(d.get("masks_applied", 0))
        except (KeyError, TypeError, ValueError) as e:
            WARNING_MSG("learn: checkpoint restore failed (fresh "
                        "model): %s", e)
            self.params = model.init_params(device=self.device)
            self.version = 0
