"""Token sampling for the decode loop (the port's counterpart of
``repro.core.sampling.sample``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0      # 0 -> greedy
    top_k: int = 0                # 0 -> full distribution
    top_p: float = 1.0            # 1 -> no nucleus filtering


def _filter_logits(logits, sp: SamplingParams):
    """Temperature / top-k / top-p (nucleus) filtering.  logits: (..., V)
    with sp.temperature > 0.  Removed tokens become -inf."""
    logits = logits / sp.temperature
    if sp.top_k:
        cutoff = torch.topk(logits, sp.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= cutoff, logits, -torch.inf)
    if sp.top_p < 1.0:
        # keep a token iff the probability of strictly higher-ranked
        # tokens is < top_p (the crossing token stays; one always does)
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < sp.top_p
        thresh = torch.where(keep, sorted_logits, torch.inf).min(
            dim=-1, keepdim=True).values
        logits = torch.where(logits >= thresh, logits, -torch.inf)
    return logits


def sample(logits, gen: torch.Generator, sp: SamplingParams):
    """logits: (B, V) fp32 -> (B,) int64 token ids.  Greedy is argmax
    (first index on ties); sampling draws from ``gen``, which must live
    on the logits' device."""
    if sp.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_filter_logits(logits.float(), sp), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]
