"""Byte-saliency model — "Not all bytes are equal" (arxiv 1711.04596)
scaled down to live on the fuzzing card.

A tiny MLP over sliding byte windows predicts, per seed byte position,
the probability that mutating that position produces an admitted
(edge-novel) child.  These are plain functions on tensors, on the
device of their inputs, serving three callers:

  * **training** — plain SGD through ``torch.autograd`` (no optimizer
    state to checkpoint beyond the weights) on labeled (parent bytes,
    position) samples, run on the card between fuzzing dispatches
    (learn/tier.py owns the cadence);
  * **in-loop inference** — ``masked_saliency`` over every position of
    the selected seed-ring slot inside the generation loop
    (ops/generations.py and the mesh's), quantized to the focus mask
    the masked havoc consumes;
  * **host-loop inference** — ``LearnTier.focus_positions_for`` feeds
    ``Mutator.set_focus_mask`` at rotation boundaries.

The parity anchor the tier rests on: ``init_params`` zeroes the OUTPUT
layer, so an untrained (version-0) model emits logit exactly 0.0 for
every input, ``quantize_mask`` maps that to the all-ones mask, and the
masked havoc with an all-ones mask is bit-identical to the unmasked one
(ops/mutate_core.py): a campaign with learning on but no training yet
IS the historical campaign.

The weights, their shapes and order, the initial draw (the JAX
package's ``jax.random.normal`` stream through the port's threefry),
the features (bit for bit) and the checkpoint encoding are the JAX
package's, so a checkpoint written by either package restores in the
other.  The products are sums of float32 products, so no matmul
precision setting (TF32) can touch them.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops import prng
from ..utils.serialization import decode_array, encode_array

#: byte-window width per position (centered; zero-padded at the buffer
#: edges) — the model's whole receptive field
WINDOW = 9
#: hidden layer widths (D -> H1 -> H2 -> 1); ~1k parameters in all
HIDDEN = (32, 16)
#: feature dimension: WINDOW byte values + relative position +
#: normalized length
FEATURES = WINDOW + 2
#: default SGD learning rate (plain, no momentum — nothing beyond the
#: weights needs checkpointing)
LEARN_RATE = 0.5

Params = Tuple[torch.Tensor, ...]   # (w1, b1, w2, b2, w3, b3)

_PARAM_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")
_SHAPES = ((FEATURES, HIDDEN[0]), (HIDDEN[0],), HIDDEN, (HIDDEN[1],),
           (HIDDEN[1],), ())


def _normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: uniform bits in
    ``(nextafter(-1, 0), 1)`` as JAX draws them, then ``sqrt(2) *
    erfinv(u)``."""
    n = int(np.prod(shape))
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    span = float(np.float32(1.0) - lo)
    f = prng.uniform(key, n)
    u = torch.maximum(f * span + float(lo),
                      torch.full_like(f, float(lo)))
    return (float(np.float32(np.sqrt(2))) * torch.erfinv(u)).reshape(shape)


def init_params(seed: int = 0x6b7a, device="cpu") -> Params:
    """Deterministic init: small random hidden layers, ZERO output
    layer — logits are exactly 0.0 until the first train step, which is
    what makes the version-0 mask all-ones."""
    k1, k2 = prng.split(prng.key(seed, device), 2).unbind(0)
    h1, h2 = HIDDEN
    w1 = _normal(k1, (FEATURES, h1)) * float(1.0 / np.sqrt(FEATURES))
    w2 = _normal(k2, (h1, h2)) * float(1.0 / np.sqrt(h1))
    z = [torch.zeros(s, dtype=torch.float32, device=device)
         for s in ((h1,), (h2,), (h2,), ())]
    return (w1, z[0], w2, z[1], z[2], z[3])


def params_from_numpy(arrays: Sequence[Any], device="cpu") -> Params:
    """The six parameters given as arrays (the JAX package's weights
    through ``np.asarray``, in its order) as the port's ``Params``."""
    out = tuple(torch.tensor(np.asarray(a, np.float32), device=device)
                for a in arrays)
    for name, p, shape in zip(_PARAM_NAMES, out, _SHAPES):
        if tuple(p.shape) != shape:
            raise ValueError(f"learn model param {name}: shape "
                             f"{tuple(p.shape)} != {shape}")
    return out


def n_params(params: Params) -> int:
    return int(sum(p.numel() for p in params))


def batch_features(bufs, lengths, positions) -> torch.Tensor:
    """Features of N (buffer, position) pairs: the WINDOW bytes around
    each position (zero outside the live prefix), the relative position
    and the normalized length.  ``bufs`` uint8[N, L] (or [L], shared by
    every row), ``lengths`` and ``positions`` int[N] (or scalars);
    arrays are placed on ``bufs``' device.  Returns float32[N, D].  The
    ONE featurizer: training and both inference paths call it, so a
    model never sees train/serve skew."""
    bufs = torch.as_tensor(bufs)
    dev = bufs.device
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int64)
    positions = torch.as_tensor(positions, device=dev).to(torch.int64)
    L = bufs.shape[-1]
    n = positions.shape[0] if positions.dim() else 1
    b2 = bufs.reshape(-1, L).expand(n, L) if bufs.dim() == 1 \
        else bufs.reshape(-1, L)
    length = lengths.clamp(min=1).expand(n)[:, None]
    pos = positions.reshape(-1).expand(n)[:, None]
    half = WINDOW // 2
    wpos = pos + torch.arange(-half, half + 1, device=dev)[None, :]
    # a gather where the JAX package sums a one-hot: positions past
    # the buffer read 0 there, so the window stops at min(length, L)
    valid = (wpos >= 0) & (wpos < length) & (wpos < L)
    win = torch.gather(b2, 1, wpos.clamp(0, L - 1)).to(torch.float32)
    win = torch.where(valid, win / 255.0, torch.zeros_like(win))
    lf = length.to(torch.float32)
    rel = pos.to(torch.float32) / lf
    scale = length.clamp(max=256).to(torch.float32) / 256.0
    return torch.cat([win, rel, scale], dim=1)


def feature_at(buf, length, pos) -> torch.Tensor:
    """Features of ONE (buffer, position) pair: float32[D]."""
    buf = torch.as_tensor(buf)
    return batch_features(buf, torch.as_tensor(length).reshape(1),
                          torch.as_tensor(pos).reshape(1))[0]


def _dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as a float32 sum of products over the last axis of
    ``x`` (no matmul kernel, so no TF32)."""
    if w.dim() == 1:
        return (x * w).sum(-1)
    return (x[..., :, None] * w).sum(-2)


def apply_model(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits for feature rows ``x`` float32[..., D]."""
    w1, b1, w2, b2, w3, b3 = params
    h = torch.tanh(_dense(x, w1) + b1)
    h = torch.tanh(_dense(h, w2) + b2)
    return _dense(h, w3) + b3


def saliency_logits(params: Params, buf, length) -> torch.Tensor:
    """Per-byte saliency logits for one seed buffer ``buf`` uint8[L]
    (``length`` an int or a 0-dim tensor on its device): float32[L].
    Reads nothing on the host — the generation loops call it once per
    generation."""
    buf = torch.as_tensor(buf)
    L = buf.shape[-1]
    pos = torch.arange(L, device=buf.device)
    return apply_model(params, batch_features(buf, length, pos))


def quantize_mask(logits: torch.Tensor, length) -> torch.Tensor:
    """Saliency to the uint8[L] focus mask the masked havoc consumes
    (1 = mutable).  Threshold logit 0 (p = 0.5), so the version-0
    model's exact zeros give ALL-ONES.  Positions past the live prefix
    stay 1: the model has no labels there, and havoc edits grow the
    candidate mid-stack.  An all-zero mask falls back to uniform inside
    the havoc kernel, never here."""
    L = logits.shape[-1]
    idx = torch.arange(L, device=logits.device)
    length = torch.as_tensor(length, device=logits.device).clamp(min=1)
    return torch.where(idx < length, (logits >= 0.0).to(torch.uint8),
                       torch.ones_like(idx, dtype=torch.uint8))


def masked_saliency(params: Params, buf, length) -> torch.Tensor:
    """saliency -> mask in one call (the generation loop's
    per-generation inference step)."""
    return quantize_mask(saliency_logits(params, buf, length), length)


def _loss(params: Params, X, y, w) -> torch.Tensor:
    """Weighted sigmoid binary cross-entropy (stable log1p form); ``w``
    rebalances the classes."""
    logits = apply_model(params, X)
    # every logit of a version-0 model is exactly 0, so the gradients at
    # 0 are the JAX package's: torch.maximum splits it at the tie as
    # jnp.maximum does, and |x| is written so that its slope at 0 is 1,
    # as jnp.abs's is (torch.abs's is 0)
    mag = torch.where(logits >= 0, logits, -logits)
    per = torch.maximum(logits, torch.zeros_like(logits)) - logits * y \
        + torch.log1p(torch.exp(-mag))
    return (per * w).sum() / w.sum().clamp(min=1e-6)


def train_step(params: Params, X, y, w, lr) -> Tuple[Params,
                                                     torch.Tensor]:
    """One plain-SGD step on a labeled feature batch on the weights'
    device; returns (params', loss) with the loss a 0-dim tensor."""
    dev = params[0].device
    X, y, w = (torch.as_tensor(a, dtype=torch.float32, device=dev)
               for a in (X, y, w))
    ps = [p.detach().requires_grad_(True) for p in params]
    with torch.enable_grad():
        loss = _loss(ps, X, y, w)
        grads = torch.autograd.grad(loss, ps)
    with torch.no_grad():
        new = tuple(p - float(lr) * g for p, g in zip(ps, grads))
    return new, loss.detach()


# -- (de)serialization (the checkpoint epoch) ----------------------------

def encode_params(params: Params) -> Dict[str, Any]:
    return {name: encode_array(np.asarray(p.detach().cpu().numpy(),
                                          np.float32))
            for name, p in zip(_PARAM_NAMES, params)}


def decode_params(d: Dict[str, Any], device="cpu") -> Params:
    out = []
    for name, shape in zip(_PARAM_NAMES, _SHAPES):
        arr = decode_array(d[name]).astype(np.float32)
        if arr.shape != shape:
            raise ValueError(
                f"learn model param {name}: shape {arr.shape} != "
                f"{shape} (incompatible checkpoint)")
        out.append(torch.as_tensor(arr, device=device))
    return tuple(out)
