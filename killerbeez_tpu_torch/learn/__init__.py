"""killerbeez_tpu_torch.learn — learned mutation shaping.

A byte-saliency model ("Not all bytes are equal", arxiv 1711.04596)
trained from the corpus store's own lineage: which parent byte
positions, when mutated, produced admitted children.  Training runs on
the fuzzing card between dispatches (plain SGD through
``torch.autograd``), and inference runs inside the generation loops —
the model and the fuzzer share the card, so shaping happens per
generation without the host.  ``dataset.py`` turns lineage into
labels, ``model.py`` holds the model, ``tier.py`` the loop's tier.
"""

from .dataset import (
    LabelBuffer, b64_to_bitmap, bitmap_to_b64, diff_bitmap,
    make_provenance, provenance_positions, samples_from_entries,
)
from .model import (
    FEATURES, WINDOW, apply_model, batch_features, decode_params,
    encode_params, feature_at, init_params, masked_saliency,
    n_params, params_from_numpy, quantize_mask, saliency_logits,
    train_step,
)
from .tier import LearnTier

__all__ = [
    "FEATURES", "WINDOW", "LabelBuffer", "LearnTier", "apply_model",
    "b64_to_bitmap", "batch_features", "bitmap_to_b64",
    "decode_params", "diff_bitmap", "encode_params", "feature_at",
    "init_params", "make_provenance", "masked_saliency", "n_params",
    "params_from_numpy", "provenance_positions", "quantize_mask",
    "saliency_logits", "samples_from_entries", "train_step",
]
