"""Mixture-of-Experts FFN, the port's counterpart of ``repro.models.moe``:
softmax top-k routing (Qwen3-MoE) or sigmoid scores normalised over the
chosen top-k (DeepSeek-V3), and optional shared experts, a dense FFN every
token runs.  :func:`moe_apply` dispatches as the reference does, by the
``moe_ragged`` flag of ``REPRO_PERF_OPTS`` (``perf_flags``), read at each
call:

  * capacity (the default, :func:`moe_apply_capacity`): sort-based with a
    static capacity (GShard-style).  Each expert takes at most C =
    :func:`_capacity` of the batch's (token, expert) assignments, in the
    order of a stable sort by expert (so, for one expert, by token), and
    drops the rest.  The kept tokens are gathered into an (E, C, d)
    buffer and run through the expert stacks by the dense FFN's code
    (``layers.ffn_apply``), whose products become batched ones (the
    reference leaves them to XLA as einsums, outside any Pallas kernel),
    so every expert's weights are read on every forward.
  * ragged (``moe_ragged``, :func:`moe_apply_ragged`): no capacity and no
    drops.  The assignments, stably sorted by expert, are gathered as rows
    and run through three grouped products (``ops.ragged_matmul``; the
    reference's ``jax.lax.ragged_dot``), which on the card read only the
    experts that received rows.

Either way each token then sums its contributions from zero in ascending
expert order, the order in which the reference's scatter-add applies
them, with no atomics, so a serve gives the same stream twice on the
card; the shared experts' output is added after.  Nothing here reads a
value back to the host.

:func:`moe_apply` also returns the reference's load-balance auxiliary
loss (:func:`load_balance_loss` over the router's outputs), which training
adds to its loss and the serving forwards drop.  The router's top-k
weights stay differentiable, as in the reference: the gradient reaches
the router through them and through the auxiliary loss.

On a mesh (DTensor parameters, ``sharding.partition``: expert stacks over
``model``) the reference leaves the communication to GSPMD; the port's
scheme (:func:`_moe_apply_sharded`) is this: every device gathers all
tokens of the batch and the whole router, routes them all (so capacity
and drops are those of the unsharded layer), runs only its own experts on
them, and its partial combine is summed over ``model`` (an all-reduce or
reduce-scatter back to the tokens' layout).  The token gather and that
sum are the scheme's collectives.  The shared experts run as a dense FFN
on the tokens' own layout.  Under ``moe_ragged`` the experts must be
whole on every device (a model axis of one).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import perf_flags
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding import partition as SH
from repro_torch.sharding import spmd as SP


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
    routed by the config's kind (:func:`route`): through
    :func:`moe_apply_ragged` under the ``moe_ragged`` flag, else
    :func:`moe_apply_capacity`; a DTensor x (a meshed forward) through
    :func:`_moe_apply_sharded`."""
    if SP.is_dtensor(x):
        return _moe_apply_sharded(cfg, p, x)
    if perf_flags.flag("moe_ragged"):
        return moe_apply_ragged(cfg, p, x)
    return moe_apply_capacity(cfg, p, x)


def _moe_apply_sharded(cfg: ModelConfig, p, x):
    """The module docstring's scheme for DTensor x and parameters: each
    device routes every token and runs its own slab of experts, the
    partial outputs are summed over ``model``, the shared experts added
    after."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    E = cfg.moe.num_experts
    tp = SH.axis_size(mesh, "model")
    split = tp > 1 and E % tp == 0
    if perf_flags.flag("moe_ragged") and tp > 1:
        raise NotImplementedError(
            "moe_ragged on a mesh with a model axis > 1 is not ported: "
            "its grouped product takes all of an expert's rows")
    rep = [Replicate()] * mesh.ndim
    # a slab of experts a device: its outputs, and the gradients of the
    # tokens and the router it gives, are partial sums over model; the
    # load-balance loss (the same on every device) counts on the first
    part = SP.with_model(rep, mesh, Partial()) if split else rep
    w_pl = SP.with_model(rep, mesh, Shard(0)) if split else rep
    coord = SP.coordinate(mesh, "model")
    first = coord * (E // tp) if split else 0
    experts = {k: p[k] for k in ("wi", "wg", "wo") if k in p}
    ragged = perf_flags.flag("moe_ragged")

    def local(x, router, *ws):
        q = {"router": router, **dict(zip(experts, ws))}
        if ragged:
            return moe_apply_ragged(cfg, q, x, shared=False)
        out, aux = moe_apply_capacity(cfg, q, x, first=first, shared=False)
        return out, (aux * (coord == 0) if split else aux)

    pls = (rep, rep) + (w_pl,) * len(experts)
    out, aux = local_map(
        local, out_placements=(part, part), in_placements=pls,
        in_grad_placements=(part, part) + (w_pl,) * len(experts),
        device_mesh=mesh, redistribute_inputs=True)(
        x, p["router"], *experts.values())
    out = out.redistribute(mesh, x.placements)
    if "shared" in p:
        out = out + L.ffn_apply(cfg, p["shared"], x)
    return out, aux


def _combine(eo, pos):
    """out (T, d): row t the sum, from zero, of eo's rows pos[t, 0],
    pos[t, 1], ... in that order (pos (T, k), each row in ascending expert
    order)."""
    out = torch.zeros(pos.shape[0], eo.shape[1], dtype=eo.dtype,
                      device=eo.device)
    for j in range(pos.shape[1]):
        out = out + eo[pos[:, j]]
    return out


def moe_apply_ragged(cfg: ModelConfig, p, x, shared: bool = True):
    """The reference's ``moe_apply_ragged``: every one of the B x S x k
    assignments, stably sorted by expert, is a row of three grouped
    products over the expert stacks at x's dtype (sizes counted on the
    device), scaled by its top-k weight at that dtype and summed into its
    token in ascending expert order."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.num_experts, m.top_k
    dev = x.device
    xf = x.reshape(T, d)
    probs, topw, tope = route(cfg, p, xf)
    e_flat = tope.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    sizes = torch.zeros(E, dtype=torch.int32, device=dev).scatter_add_(
        0, e_flat, torch.ones(T * k, dtype=torch.int32, device=dev))
    rows = xf[order // k]                                      # (T k, d)
    L._check_activation(cfg)
    h = ops.ragged_matmul(rows, p["wi"].to(x.dtype), sizes)
    if cfg.activation in ("swiglu", "geglu"):
        g = ops.ragged_matmul(rows, p["wg"].to(x.dtype), sizes)
        h = (F.silu(g) if cfg.activation == "swiglu"
             else F.gelu(g, approximate="tanh")) * h
    else:
        h = F.gelu(h, approximate="tanh")
    eo = ops.ragged_matmul(h, p["wo"].to(x.dtype), sizes)       # (T k, d)
    eo = eo * topw.reshape(-1)[order][:, None].to(eo.dtype)
    # a token's k rows sit in expert order in the sorted stream (its
    # experts are distinct), so their positions sorted are that order
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * k, device=dev)).view(T, k)
    out = _combine(eo, pos.sort(dim=1).values)
    if shared and "shared" in p:
        out = out + L.ffn_apply(cfg, p["shared"], xf)
    return out.reshape(B, S, d), load_balance_loss(cfg, probs, tope)


def moe_apply_capacity(cfg: ModelConfig, p, x, first: int = 0,
                       shared: bool = True):
    """Capacity dispatch (see the module's docstring).  Every one of the
    B x S tokens, padding lanes too, is routed and counts towards the
    capacity, as in the reference.  The expert stacks in ``p`` may be a
    slab of ``p["wi"].shape[0]`` experts from expert ``first`` on (one
    device's, :func:`_moe_apply_sharded`): the others' assignments then
    add nothing.  ``shared=False`` leaves the shared experts out."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.num_experts, m.top_k
    n_loc = p["wi"].shape[0]
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
    lo, hi = first * C, (first + n_loc) * C
    gathered = xpad[table[lo:hi].view(n_loc, C)]               # (E, C, d)

    eo = L.ffn_apply(cfg, p, gathered)                         # (E, C, d)
    eo = eo * wtab[lo:hi].view(n_loc, C, 1).to(eo.dtype)

    # combine: each token's k slots (the sentinel row for a dropped one,
    # or for another device's expert), summed from zero in ascending
    # expert order
    slot_of = torch.empty_like(slot).scatter_(0, order, slot).view(T, k)
    slot_of = slot_of.gather(1, torch.argsort(tope, dim=1))
    if n_loc != E:
        slot_of = torch.where((slot_of >= lo) & (slot_of < hi),
                              slot_of - lo, n_loc * C)
    out = _combine(torch.cat([eo.reshape(n_loc * C, d),
                              eo.new_zeros(1, d)]), slot_of)
    if shared and "shared" in p:
        out = out + L.ffn_apply(cfg, p["shared"], xf)
    return out.reshape(B, S, d), load_balance_loss(cfg, probs, tope)
