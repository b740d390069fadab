"""Trie-based longest-match tokenizer — the paper's "Faster Tokenizer".

The paper uses PaddleNLP's FasterTokenizer (a linear-time WordPiece, Song
et al. 2020).  This is the same idea: a character trie over a trained
vocabulary, greedy longest-match-first in a single left-to-right pass, no
backtracking.  It also tracks corpus token frequencies — the input to the
paper's embedding-layer pruning (P2).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List

PAD, UNK, BOS, EOS = 0, 1, 2, 3
SPECIALS = ["<pad>", "<unk>", "<bos>", "<eos>"]


class FastTokenizer:
    """Greedy longest-match trie tokenizer with trained vocab."""

    def __init__(self, vocab: List[str]):
        assert vocab[:4] == SPECIALS, "vocab must start with the specials"
        self.vocab = list(vocab)
        self.token_to_id: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        self._trie: dict = {}
        for tok, idx in self.token_to_id.items():
            if idx < 4:
                continue
            node = self._trie
            for ch in tok:
                node = node.setdefault(ch, {})
            node["\0"] = idx

    # -- construction -------------------------------------------------------
    @classmethod
    def train(cls, corpus: Iterable[str], vocab_size: int) -> "FastTokenizer":
        """Vocab = specials + all seen chars + most frequent words/subwords."""
        word_freq: Counter = Counter()
        char_set = set()
        for line in corpus:
            for w in line.split():
                word_freq[w] += 1
                char_set.update(w)
            char_set.add(" ")
        chars = sorted(char_set)
        room = max(0, vocab_size - 4 - len(chars))
        words = [w for w, _ in word_freq.most_common(room) if len(w) > 1]
        vocab = SPECIALS + chars + words
        return cls(vocab[:vocab_size] if len(vocab) > vocab_size else vocab)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- encode / decode ------------------------------------------------------
    def encode(self, text: str, bos: bool = True, eos: bool = False
               ) -> List[int]:
        ids = [BOS] if bos else []
        i, n = 0, len(text)
        while i < n:
            node, j = self._trie, i
            best, best_end = None, i
            while j < n and text[j] in node:
                node = node[text[j]]
                j += 1
                if "\0" in node:
                    best, best_end = node["\0"], j
            if best is None:
                ids.append(UNK)
                i += 1
            else:
                ids.append(best)
                i = best_end
        if eos:
            ids.append(EOS)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i in (PAD, BOS):
                continue
            if i == EOS:
                break
            out.append(self.vocab[i] if 0 <= i < len(self.vocab) else "<unk>")
        return "".join(out)

    # -- frequency stats for pruning (P2) -----------------------------------
    def count_frequencies(self, corpus: Iterable[str]) -> Counter:
        freq: Counter = Counter({i: 0 for i in range(4)})
        for line in corpus:
            for tid in self.encode(line, bos=False):
                freq[tid] += 1
        return freq
