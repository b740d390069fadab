"""Token sampling for the decode loop and the speculative rejection
sampler (the port's counterpart of ``repro.core.sampling``).

``speculative_verify`` is the acceptance rule of draft-verify decoding:
given the target model's logits over a drafted window it returns how many
drafts survive and the token that follows them, so that the emitted
stream is distributed exactly as non-speculative sampling from the same
filtered distribution (and equals greedy decoding at temperature 0).
Random draws come from a ``torch.Generator``, whose bits differ from the
reference's ``jax.random``: only the distributions agree.
"""
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


def target_probs(logits, sp: SamplingParams):
    """The distribution :func:`sample` draws from: softmax of the filtered
    logits.  logits: (..., V) -> probs (..., V)."""
    return torch.softmax(_filter_logits(logits.float(), sp), dim=-1)


def speculative_verify(logits, drafts, gen: torch.Generator,
                       sp: SamplingParams):
    """Rejection-sample a drafted window against the target logits.

    logits: (B, K+1, V), position j scoring the input [current token,
    d_1 .. d_j]; drafts: (B, K) proposed tokens.  Returns (accept_len (B,)
    in [0, K], next_token (B,)), both int64: drafts[:, :accept_len] are
    kept and ``next_token`` follows them.

    The drafters propose point masses, so the standard rule reduces to:
    accept d_{j+1} with probability p_j(d_{j+1}), else resample from p_j
    with d_{j+1} removed and renormalized; each emitted token is then
    distributed as p_j.  At temperature 0 it is exact-match greedy: accept
    while argmax == draft, then emit the argmax at the first mismatch.
    """
    B, K = drafts.shape
    b_idx = torch.arange(B, device=logits.device)
    drafts = drafts.long()
    if sp.temperature <= 0.0:
        pred = torch.argmax(logits, dim=-1)                    # (B, K+1)
        ok = (pred[:, :K] == drafts).long()
        accept_len = torch.cumprod(ok, dim=1).sum(dim=1)
        return accept_len, pred[b_idx, accept_len]
    p = target_probs(logits, sp)                               # (B, K+1, V)
    p_draft = torch.gather(p[:, :K], 2, drafts[..., None])[..., 0]
    u = torch.rand((B, K), generator=gen, device=logits.device)
    accept_len = torch.cumprod((u < p_draft).long(), dim=1).sum(dim=1)
    # residual at the first rejected position: p without the rejected
    # draft, renormalized; after a full acceptance, the bonus position's p
    p_next = p[b_idx, accept_len]                              # (B, V)
    rejected = accept_len < K
    rej_tok = drafts[b_idx, accept_len.clamp_max(K - 1)]
    hole = torch.zeros_like(p_next, dtype=torch.bool)
    hole[b_idx, rej_tok] = True
    p_next = torch.where(rejected[:, None] & hole, 0.0, p_next)
    # all mass on the rejected token cannot happen exactly (it would have
    # been accepted), but guard round-off: fall back to p
    total = p_next.sum(dim=-1, keepdim=True)
    p_next = torch.where(total > 0.0, p_next, p[b_idx, accept_len])
    nxt = torch.multinomial(p_next, 1, generator=gen)[:, 0]
    return accept_len, nxt
