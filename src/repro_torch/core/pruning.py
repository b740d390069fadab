"""Embedding-layer pruning, the paper's §3.2 (the port's copy of
``repro.core.pruning``).

  1. **Vocabulary pruning**: keep only high-frequency tokens (from corpus
     statistics), gather the kept rows of the token-embedding matrix (and
     of an untied head), and remap ids.  Out-of-keep-set tokens map to
     <unk>.
  2. **Position-table trimming**: for learned-position models, slice the
     position-embedding table to the serving context (the paper's
     512 x 1024 -> 128 x 1024).  RoPE models have no table: a no-op.

Both are functional transforms of the port's parameter dict:
(params, cfg) -> (params', cfg'); the maps are numpy.  Logits over kept
tokens equal the unpruned model's at those entries.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclass
class PruneMaps:
    """Id remapping produced by vocabulary pruning."""

    keep_ids: np.ndarray          # (V_new,) old ids kept, ascending
    old_to_new: np.ndarray        # (V_old,) new id, or UNK's new id
    new_to_old: np.ndarray        # (V_new,) inverse

    @property
    def new_vocab(self) -> int:
        return len(self.keep_ids)


def select_keep_ids(freqs: Dict[int, int], vocab_size: int, *,
                    max_vocab: Optional[int] = None,
                    coverage: Optional[float] = None,
                    always_keep: Sequence[int] = (0, 1, 2, 3)) -> np.ndarray:
    """The token ids to keep: the ``max_vocab`` most frequent, or the
    fewest most frequent that reach ``coverage`` of the corpus mass (ids
    never seen are dropped), plus ``always_keep``."""
    if (max_vocab is None) == (coverage is None):
        raise ValueError("specify exactly one of max_vocab / coverage")
    counts = np.zeros(vocab_size, np.int64)
    for tid, c in freqs.items():
        if 0 <= tid < vocab_size:
            counts[tid] = c
    order = np.argsort(-counts, kind="stable")
    if coverage is not None:
        csum = np.cumsum(counts[order])
        total = max(csum[-1], 1)
        cut = int(np.searchsorted(csum / total, coverage) + 1)
        chosen = order[:cut]
        chosen = chosen[counts[chosen] > 0]
    else:
        chosen = order[:max_vocab]
    return np.sort(np.union1d(np.asarray(always_keep, np.int64), chosen))


def build_maps(keep_ids: np.ndarray, vocab_size: int,
               unk_id: int = 1) -> PruneMaps:
    keep_ids = np.sort(np.asarray(keep_ids, np.int64))
    if unk_id not in keep_ids:
        raise ValueError("UNK must be kept")
    old_to_new = np.full(vocab_size, -1, np.int64)
    old_to_new[keep_ids] = np.arange(len(keep_ids))
    old_to_new[old_to_new < 0] = old_to_new[unk_id]
    return PruneMaps(keep_ids=keep_ids, old_to_new=old_to_new,
                     new_to_old=keep_ids.copy())


def prune_vocab(params: dict, cfg: ModelConfig, maps: PruneMaps):
    """Gather the kept rows of the embedding (and the kept columns of an
    untied (d, V) head); a multi-codebook model keeps the same ids in
    each of its (C, V, d) tables (and ``heads``)."""
    embed = params["embed"]
    keep = torch.as_tensor(maps.keep_ids, device=embed["tokens"].device)
    new_embed = dict(embed)
    if cfg.num_codebooks:
        for k in ("tokens", "heads"):
            if k in embed:
                new_embed[k] = embed[k].index_select(1, keep)
    else:
        new_embed["tokens"] = embed["tokens"].index_select(0, keep)
        if "head" in embed:
            new_embed["head"] = embed["head"].index_select(1, keep)
    return ({**params, "embed": new_embed},
            cfg.replace(vocab_size=maps.new_vocab))


def trim_positions(params: dict, cfg: ModelConfig, new_max_len: int):
    """The paper's position-table trim to ``new_max_len`` rows."""
    if cfg.pos_emb != "learned":
        return params, cfg          # RoPE / sinusoidal / none: no table
    new_embed = dict(params["embed"])
    new_embed["pos"] = params["embed"]["pos"][:new_max_len]
    return ({**params, "embed": new_embed},
            cfg.replace(max_seq_len=new_max_len))


def prune_model(params: dict, cfg: ModelConfig, freqs: Dict[int, int], *,
                max_vocab: Optional[int] = None,
                coverage: Optional[float] = None,
                new_max_len: Optional[int] = None):
    """The whole transform.  Returns (params', cfg', maps)."""
    keep = select_keep_ids(freqs, cfg.vocab_size, max_vocab=max_vocab,
                           coverage=coverage)
    maps = build_maps(keep, cfg.vocab_size)
    params, cfg = prune_vocab(params, cfg, maps)
    if new_max_len is not None:
        params, cfg = trim_positions(params, cfg, new_max_len)
    return params, cfg, maps


def remap_tokens(tokens, maps: PruneMaps) -> np.ndarray:
    """Map old-id token arrays into the pruned id space."""
    return maps.old_to_new[np.asarray(tokens)]


def unmap_tokens(tokens, maps: PruneMaps) -> np.ndarray:
    """Map pruned-space ids back to original ids."""
    return maps.new_to_old[np.asarray(tokens)]
