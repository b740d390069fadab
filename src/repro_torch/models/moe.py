"""Mixture-of-Experts FFN, the port's counterpart of ``repro.models.moe``'s
default path: softmax top-k routing (Qwen3-MoE) or sigmoid scores
normalised over the chosen top-k (DeepSeek-V3), and optional shared
experts, a dense FFN every token runs.

Dispatch is sort-based with a static capacity (GShard-style): each
expert takes at most C = :func:`_capacity` of the batch's (token, expert)
assignments, in the order of a stable sort by expert (so, for one
expert, by token), and drops the rest.  The kept tokens are gathered
into an (E, C, d) buffer and run through the expert stacks by the dense
FFN's code (``layers.ffn_apply``), whose products become batched ones
(the reference leaves them to XLA as einsums, outside any Pallas
kernel).  Each token then sums its kept contributions in ascending
expert order, the order in which the reference's scatter-add applies
them, with no atomics, so a serve gives the same stream twice on the
card; the shared experts' output is added after.  Nothing here reads a
value back to the host.

:func:`moe_apply` also returns the reference's load-balance auxiliary
loss (:func:`load_balance_loss` over the router's outputs), which training
adds to its loss and the serving forwards drop.  The router's top-k
weights stay differentiable, as in the reference: the gradient reaches
the router through them and through the auxiliary loss.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


# fp32 bytes of the expert slices moe_init draws at a time: a full-width
# stack (deepseek-v3's 256 x 7168 x 2048 is 15 GB in fp32) is drawn a
# slice at a time and cast to the parameter dtype as it is drawn
EXPERT_SLICE_BYTES = 1 << 30


def moe_init(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype = torch.float32):
    """Router (d, E), the (E, d, f) / (E, f, d) expert stacks, each expert
    at the reference's dense init scale, and the shared experts' dense
    FFN of width ``num_shared_experts * f`` where the config has them.
    The stacks are stored at ``dtype``, drawn in fp32 slices of at most
    EXPERT_SLICE_BYTES."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    dev = gen.device

    def expert_stack(i, o):
        per = max(1, EXPERT_SLICE_BYTES // (i * o * 4))
        out = torch.empty(E, i, o, dtype=dtype, device=dev)
        for e0 in range(0, E, per):
            n = min(per, E - e0)
            out[e0:e0 + n] = torch.randn(n, i, o, generator=gen,
                                         device=dev) * i ** -0.5
        return out
    p = {"router": L.dense_init(gen, d, E), "wi": expert_stack(d, f),
         "wg": expert_stack(d, f), "wo": expert_stack(f, d)}
    if m.num_shared_experts:
        p["shared"] = L.ffn_init(gen, cfg, m.num_shared_experts * f)
    return p


def _capacity(num_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: the reference's rule, a multiple of 8, >= 8."""
    m = cfg.moe
    c = int(num_tokens * m.top_k * m.capacity_factor / m.num_experts) + 1
    return max(8, -(-c // 8) * 8)


def router_kind_of(cfg: ModelConfig) -> str:
    """The reference's choice: sigmoid routing for DeepSeek (the models
    with MLA), softmax otherwise."""
    return "sigmoid" if cfg.mla is not None else "softmax"


def route(cfg: ModelConfig, p, xf):
    """The router: xf (T, d) -> (probs (T, E) for the load-balance loss,
    topw (T, k) fp32 renormalised over the chosen experts, tope (T, k)
    expert ids, ties to the lower id as ``jax.lax.top_k`` breaks them).
    The config's kind (:func:`router_kind_of`): "softmax" ranks softmax
    probabilities (Qwen3-MoE), "sigmoid" sigmoid scores (DeepSeek-V3;
    probs are then the scores normalised over E)."""
    scores = xf.float() @ p["router"].float()
    if router_kind_of(cfg) == "sigmoid":
        probs = torch.sigmoid(scores)
        lb_probs = probs / (probs.sum(-1, keepdim=True) + 1e-9)
    else:
        probs = lb_probs = torch.softmax(scores, dim=-1)
    topw, tope = torch.topk(probs, cfg.moe.top_k, dim=-1)
    topw = topw / (topw.sum(-1, keepdim=True) + 1e-9)
    return lb_probs, topw, tope


def load_balance_loss(cfg: ModelConfig, probs, tope):
    """The reference's auxiliary loss: ``router_aux_coef * E * sum_e f_e
    P_e``, f_e the share of the T x k assignments routed to expert e and
    P_e its mean router probability."""
    m = cfg.moe
    T, k = tope.shape
    frac = torch.zeros(m.num_experts, device=tope.device).scatter_add_(
        0, tope.reshape(-1), torch.ones(T * k, device=tope.device)) / (T * k)
    return m.router_aux_coef * m.num_experts * torch.sum(
        frac * probs.mean(0))


def moe_apply(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> (out (B, S, d), the load-balance loss, a scalar),
    routed by the config's kind (:func:`route`).  Every one of the B x S
    tokens, padding lanes too, is routed and counts towards the capacity,
    as in the reference."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.num_experts, m.top_k
    C = _capacity(T, cfg)
    dev = x.device
    xf = x.reshape(T, d)
    probs, topw, tope = route(cfg, p, xf)

    # sort-based dispatch: assignment i of token i // k, stable by expert
    e_flat = tope.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    se = e_flat[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=dev) - offsets[se]
    slot = torch.where(pos_in_e < C, se * C + pos_in_e, E * C)  # E*C: drop
    table = torch.full((E * C + 1,), T, dtype=torch.long, device=dev)
    table.scatter_(0, slot, order // k)
    wtab = torch.zeros(E * C + 1, device=dev)
    wtab.scatter_(0, slot, topw.reshape(-1)[order])
    xpad = torch.cat([xf, xf.new_zeros(1, d)])                 # sentinel row
    gathered = xpad[table[:-1].view(E, C)]                     # (E, C, d)

    eo = L.ffn_apply(cfg, p, gathered)                         # (E, C, d)
    eo = eo * wtab[:-1].view(E, C, 1).to(eo.dtype)

    # combine: each token's k slots (the sentinel row for a dropped one),
    # summed from zero in ascending expert order
    slot_of = torch.empty_like(slot).scatter_(0, order, slot).view(T, k)
    slot_of = slot_of.gather(1, torch.argsort(tope, dim=1))
    eo = torch.cat([eo.reshape(E * C, d), eo.new_zeros(1, d)])
    out = torch.zeros(T, d, dtype=eo.dtype, device=dev)
    for j in range(k):
        out = out + eo[slot_of[:, j]]
    if "shared" in p:
        out = out + L.ffn_apply(cfg, p["shared"], xf)
    return out.reshape(B, S, d), load_balance_loss(cfg, probs, tope)
