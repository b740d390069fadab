"""Synthetic request corpus (the port's copy of
``repro.data.pipeline.synthetic_corpus``).

No external datasets are available offline, so the corpus is a synthetic
Zipf-distributed "marketing material" stream.
"""
from __future__ import annotations

from typing import List

import numpy as np

_WORDS = [
    "brand", "market", "click", "user", "offer", "sale", "quality",
    "product", "smart", "fast", "trust", "deal", "value", "shop", "tech",
    "cloud", "model", "learn", "data", "search", "video", "music", "photo",
    "travel", "home", "auto", "game", "news", "health", "food", "style",
    "price", "best", "new", "top", "win", "free", "plus", "pro", "max",
]


def synthetic_corpus(num_lines: int, *, seed: int = 0,
                     min_len: int = 4, max_len: int = 24) -> List[str]:
    """Zipf-weighted word salad; rank-frequency matches real text well
    enough for serving experiments."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, len(_WORDS) + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    lines = []
    for _ in range(num_lines):
        n = int(rng.integers(min_len, max_len + 1))
        idx = rng.choice(len(_WORDS), size=n, p=probs)
        lines.append(" ".join(_WORDS[i] for i in idx))
    return lines
