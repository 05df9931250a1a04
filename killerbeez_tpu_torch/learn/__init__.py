"""killerbeez_tpu_torch.learn — learned mutation shaping.

So far the dataset half: lineage -> labeled training data
(``dataset.py``: mutated-byte provenance bitmaps, the bounded label
buffer, ``provenance_positions`` that kb-corpus and the heat panels
read).  The byte-saliency model and the learn tier of the loop are not
ported yet.
"""

from .dataset import (
    LabelBuffer, b64_to_bitmap, bitmap_to_b64, diff_bitmap,
    make_provenance, provenance_positions, samples_from_entries,
)

__all__ = [
    "LabelBuffer", "b64_to_bitmap", "bitmap_to_b64", "diff_bitmap",
    "make_provenance", "provenance_positions", "samples_from_entries",
]
