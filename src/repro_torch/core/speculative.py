"""Speculative decoding: the drafters of the draft-verify serving loop (the
port's counterpart of ``repro.core.speculative``).

A drafter proposes K continuation tokens per slot; one verify forward
(``models.transformer.forward_verify``) scores all of them against the
paged pools, and the rejection sampler (``sampling.speculative_verify``)
keeps the longest valid prefix, so the emitted stream is distributed
exactly as non-speculative sampling and equals it under greedy decoding.

  * :class:`NgramDrafter`: prompt lookup.  Propose what followed the most
    recent earlier occurrence of the context's trailing n-gram; no
    weights.
  * :class:`DraftModelDrafter`: a draft model decoded greedily for K
    tokens by full forwards (``forward_train``, whose attention is the
    flash kernel on the card) over right-padded contexts.  Without a
    draft model of its own it drafts with the target model (self-drafting,
    acceptance 1 under greedy).

Drafting runs on the host side of the loop (the n-gram scan reads the
emitted history); the verify forward, acceptance rule and KV rewind run on
the device (``engine.InferenceEngine.serve_continuous``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.precision import FP32, Policy


@dataclass
class SpecConfig:
    """Speculative-decoding knobs for ``engine.serve_continuous``.

    k: drafted tokens per slot per step (the verify window is k+1 wide).
    drafter: "ngram" (prompt lookup, no weights) or "draft_model".
    max_ngram/min_ngram: longest/shortest trailing n-gram the lookup
    drafter tries to match (longest first).
    draft_cfg/draft_params: the draft model; omitted for
    drafter="draft_model", the target model drafts for itself.
    """
    k: int = 4
    drafter: str = "ngram"
    max_ngram: int = 3
    min_ngram: int = 1
    draft_cfg: Any = None
    draft_params: Any = None


class Drafter:
    """Proposes K continuation tokens per slot from its token context."""

    name = "base"

    def __init__(self, k: int):
        self.k = k

    def propose(self, context: Sequence[int]) -> List[int]:
        raise NotImplementedError

    def propose_slots(self, contexts: List[Optional[Sequence[int]]]
                      ) -> np.ndarray:
        """(slots, k) int32 proposals; ``None`` rows (inactive slots) draft
        zeros, which the engine masks out of the verify write."""
        out = np.zeros((len(contexts), self.k), np.int32)
        for i, ctx in enumerate(contexts):
            if ctx:
                out[i] = self.propose(ctx)
        return out


class NgramDrafter(Drafter):
    """Prompt-lookup drafting: match the context's trailing n-gram against
    its own history (n = max_ngram .. min_ngram, most recent occurrence
    first, within the trailing ``scan_window`` tokens) and propose what
    followed, padded with its last token; with no match, the last token
    repeated."""

    name = "ngram"

    def __init__(self, k: int, max_ngram: int = 3, min_ngram: int = 1,
                 scan_window: int = 1024):
        super().__init__(k)
        self.max_ngram = max_ngram
        self.min_ngram = max(1, min_ngram)
        self.scan_window = scan_window

    def propose(self, context: Sequence[int]) -> List[int]:
        ctx = list(context[max(0, len(context) - self.scan_window):])
        k, n_ctx = self.k, len(ctx)
        for n in range(min(self.max_ngram, n_ctx - 1), self.min_ngram - 1,
                       -1):
            pat = ctx[-n:]
            for i in range(n_ctx - n - 1, -1, -1):
                if ctx[i:i + n] == pat:
                    cont = ctx[i + n:i + n + k]
                    if cont:
                        return (cont + [cont[-1]] * k)[:k]
        return [ctx[-1]] * k


class DraftModelDrafter(Drafter):
    """Greedy K-token drafting with a draft model.

    Live contexts are right-padded into a (B, W + K) buffer, B and W the
    next powers of two of the live count and the longest context (the
    reference's buckets; pad rows hold one token), and drafted in one
    batched call: K full forwards, each writing its argmax after every
    row's last token.  Padding beyond a row's length is causally invisible
    to the positions read.  ``calls`` counts the batched calls (each runs
    K forwards).
    """

    name = "draft_model"

    def __init__(self, cfg, params, k: int, policy: Policy = FP32):
        super().__init__(k)
        self.cfg = cfg
        self.params = params
        self.policy = policy
        self.calls = 0

    @torch.no_grad()
    def _draft(self, buf, lens):
        from repro_torch.models import transformer as T
        b_idx = torch.arange(buf.shape[0], device=buf.device)
        for j in range(self.k):
            logits = T.forward_train(self.params, self.cfg, buf,
                                     policy=self.policy, remat=False)[0]
            buf[b_idx, lens + j] = torch.argmax(
                logits[b_idx, lens - 1 + j], dim=-1).to(buf.dtype)
        pos = lens[:, None] + torch.arange(self.k, device=buf.device)
        return torch.gather(buf, 1, pos)

    def propose_slots(self, contexts: List[Optional[Sequence[int]]]
                      ) -> np.ndarray:
        live = [(i, list(ctx)) for i, ctx in enumerate(contexts) if ctx]
        out = np.zeros((len(contexts), self.k), np.int32)
        if not live:
            return out
        B = 1 << (len(live) - 1).bit_length()          # batch bucket
        W = 1 << (max(len(c) for _, c in live) - 1).bit_length()
        buf = np.zeros((B, W + self.k), np.int32)
        lens = np.ones((B,), np.int64)                 # pad rows: 1 token
        for r, (_, ctx) in enumerate(live):
            buf[r, :len(ctx)] = ctx
            lens[r] = len(ctx)
        dev = self.params["embed"]["tokens"].device
        drafted = self._draft(torch.from_numpy(buf).to(dev),
                              torch.from_numpy(lens).to(dev)).cpu().numpy()
        self.calls += 1
        for r, (i, _) in enumerate(live):
            out[i] = drafted[r]
        return out

    def propose(self, context: Sequence[int]) -> List[int]:
        return [int(t) for t in self.propose_slots([context])[0]]


def get_drafter(spec: SpecConfig, target_cfg=None, target_params=None,
                policy: Policy = FP32) -> Drafter:
    """Resolve a :class:`SpecConfig` into a drafter; the target model backs
    drafter="draft_model" when no draft model is given (self-drafting)."""
    if spec.k < 1:
        raise ValueError(f"SpecConfig.k must be >= 1, got {spec.k}")
    if spec.drafter == "ngram":
        return NgramDrafter(spec.k, max_ngram=spec.max_ngram,
                            min_ngram=spec.min_ngram)
    if spec.drafter == "draft_model":
        cfg = spec.draft_cfg if spec.draft_cfg is not None else target_cfg
        params = spec.draft_params if spec.draft_params is not None \
            else target_params
        if cfg is None or params is None:
            raise ValueError("drafter='draft_model' needs draft_cfg/"
                             "draft_params (or a target model to self-"
                             "draft with)")
        return DraftModelDrafter(cfg, params, spec.k, policy=policy)
    raise ValueError(f"unknown drafter {spec.drafter!r}; "
                     f"one of ('ngram', 'draft_model')")
