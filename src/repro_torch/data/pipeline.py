"""Data pipeline (the port's copy of ``repro.data.pipeline``): the
synthetic corpus and the training batchers.

No external datasets are available offline, so the corpus is a synthetic
Zipf-distributed "marketing material" stream.  The batchers draw with
numpy from the same seeds as the reference's, so both packages train on
the same batches bit for bit; they yield numpy arrays, and the training
loop moves them to the device.
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np

from repro_torch.core.tokenizer import PAD, FastTokenizer

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


def token_stream(tokenizer: FastTokenizer, corpus: List[str]
                 ) -> Iterator[int]:
    """Every line's ids, each line between BOS and EOS."""
    for line in corpus:
        yield from tokenizer.encode(line, bos=True, eos=True)


def packed_batches(tokenizer: FastTokenizer, corpus: List[str], *,
                   batch_size: int, seq_len: int, repeat: bool = True,
                   seed: int = 0) -> Iterator[dict]:
    """Dense packed LM batches cut from the token stream: {"tokens" (B,S)
    int32, "labels" (B,S) int32 (the next tokens), "loss_mask" (B,S)
    float32 (0 at PAD labels)}.  The stream starts over at the corpus's
    end while ``repeat``."""
    need = batch_size * (seq_len + 1)
    buf: List[int] = []
    while True:
        for t in token_stream(tokenizer, corpus):
            buf.append(t)
            if len(buf) >= need:
                arr = np.asarray(buf[:need], np.int32).reshape(
                    batch_size, seq_len + 1)
                buf = buf[need:]
                yield {"tokens": arr[:, :-1],
                       "labels": arr[:, 1:].astype(np.int32),
                       "loss_mask": (arr[:, 1:] != PAD).astype(np.float32)}
        if not repeat:
            return


def random_batches(vocab_size: int, *, batch_size: int, seq_len: int,
                   num_codebooks: int = 0, seed: int = 0) -> Iterator[dict]:
    """Uniform-random token batches (ids 4 .. V-1), (B, S) or (B, S, C)
    for a multi-codebook model, with a full loss mask (B, S)."""
    rng = np.random.default_rng(seed)
    while True:
        shape = ((batch_size, seq_len, num_codebooks) if num_codebooks
                 else (batch_size, seq_len))
        toks = rng.integers(4, vocab_size, size=shape, dtype=np.int32)
        labels = rng.integers(4, vocab_size, size=shape, dtype=np.int32)
        yield {"tokens": toks, "labels": labels,
               "loss_mask": np.ones(shape[:2], np.float32)}
