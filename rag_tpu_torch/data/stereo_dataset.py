"""The search split of a scene's training set.

Counterpart of ``split_half`` in rag_tpu/data/stereo_dataset.py (the
file-backed datasets of that module are not ported yet).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def split_half(n: int, seed: Optional[int] = None, frac: float = 0.5):
    """The reference's search split: a random permutation of range(n),
    whose first ``frac`` trains weights and the rest scores architectures.
    seed=None keeps the prefix split. Returns (train, valid) index lists."""
    split = int(np.floor(frac * n))
    if seed is None:
        return list(range(split)), list(range(split, n))
    perm = np.random.default_rng(seed).permutation(n)
    return perm[:split].tolist(), perm[split:].tolist()
