"""The training step and loop (the port's counterpart of
``repro.training.train_loop``): cross-entropy LM loss (per codebook for
an audio model), the MoE load-balance loss and DeepSeek's multi-token
prediction loss, gradients by autograd (on the card through the flash
attention kernels' forward and backward, ``ops.FlashAttentionFn``), then
AdamW (:mod:`repro_torch.training.optimizer`).

Gradient accumulation splits the batch into contiguous row blocks, as the
reference's ``lax.scan`` over its reshaped batch does, sums the
microbatches' gradients in the parameter dtype and divides by their
number; the loss is their mean and the other parts are the last
microbatch's.  A step reads nothing back from the device: metrics stay
device scalars until the loop logs them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import MIXED, Policy
from repro_torch.models import transformer as T
from repro_torch.sharding import spmd as SP
from repro_torch.training import optimizer as OPT

MTP_WEIGHT = 0.3


def cross_entropy(logits, labels, mask):
    """logits (B,S,V) fp32, labels (B,S) int, mask (B,S) -> mean nats over
    the masked positions."""
    logz, gold = SP.logsumexp_gold(logits, labels)
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)


def _codebook_ce(logits, labels, mask):
    """Audio: logits (B,S,C,V), labels (B,S,C); the mean over positions
    and codebooks."""
    logz, gold = SP.logsumexp_gold(logits, labels)
    nll = ((logz - gold) * mask[..., None]).sum(-1)
    return nll.sum() / torch.clamp_min(mask.sum() * labels.shape[-1], 1.0)


def loss_fn(params, cfg: ModelConfig, batch, policy: Policy,
            remat: bool = True):
    """(total loss, {"ce", "moe_aux"}) of a batch {"tokens", "labels",
    "loss_mask"[, "prefix_embeds"]}: the LM loss of the text positions
    (after the prefix embeddings), plus the MoE load-balance loss, plus
    MTP_WEIGHT x the MTP head's loss on token i + 2 where the model has
    one."""
    logits, aux = T.forward_train(
        params, cfg, batch["tokens"],
        prefix_embeds=batch.get("prefix_embeds"), policy=policy,
        remat=remat)
    labels, mask = batch["labels"], batch["loss_mask"]
    P = cfg.num_prefix_embeds
    if P:
        logits = logits[:, P:]
    if cfg.num_codebooks:
        loss = _codebook_ce(logits, labels, mask)
    else:
        loss = cross_entropy(logits, labels, mask)
    total = loss + aux["moe_aux"]
    if "mtp_logits" in aux:
        total = total + MTP_WEIGHT * cross_entropy(
            aux["mtp_logits"][:, :-1], labels[:, 2:], mask[:, 2:])
    return total, {"ce": loss, "moe_aux": aux["moe_aux"]}


def _grads(params, cfg, batch, policy, remat):
    """(loss, parts, gradients of every floating leaf, path -> tensor); a
    leaf the loss does not reach gets zeros, as jax.grad gives it."""
    leaves = {p: t for p, t in OPT.flatten(params).items()
              if t.is_floating_point()}
    for t in leaves.values():
        t.requires_grad_(True)
    loss, parts = loss_fn(params, cfg, batch, policy, remat)
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    # on a mesh each gradient is reduced once into its parameter's layout
    # (partial sums over the batch axes: the data-parallel all-reduce)
    grads = {p: torch.zeros_like(t) if g is None else SP.like(g, t)
             for (p, t), g in zip(leaves.items(), gs)}
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: OPT.AdamWConfig,
                    policy: Policy = MIXED, remat: bool = True,
                    grad_accum: int = 1):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), the parameters and moments updated in place; ``batch``
    holds tensors on the parameters' device, B divisible by
    ``grad_accum``."""

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            loss, parts, grads = _grads(params, cfg, batch, policy, remat)
        else:
            mb = next(iter(batch.values())).shape[0] // grad_accum
            gsum, lsum = None, 0.0
            for i in range(grad_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, parts, g = _grads(params, cfg, micro, policy, remat)
                if gsum is None:
                    gsum = g
                else:               # in place: one sum of the grads lives
                    for p, x in g.items():
                        gsum[p] += x
                del g
                lsum = lsum + loss
            grads = gsum
            for x in grads.values():
                x /= grad_accum
            loss = lsum / grad_accum
        tree = OPT.unflatten_like(params, {**OPT.flatten(params), **grads})
        params, opt_state, om = OPT.apply_updates(opt_cfg, params, tree,
                                                  opt_state)
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step


def make_eval_step(cfg: ModelConfig, policy: Policy = MIXED):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, parts = loss_fn(params, cfg, batch, policy, remat=False)
        return {"loss": loss, **parts}
    return eval_step


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``: pinned and copied without
    blocking the host on a card."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)) \
            if isinstance(v, np.ndarray) else v
        if dev.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t.to(dev)
    return out


def train(cfg: ModelConfig, params, batches, *, steps: int,
          opt_cfg: Optional[OPT.AdamWConfig] = None,
          policy: Policy = MIXED, log_every: int = 10, callback=None):
    """Single-device training loop on the parameters' device.  Returns
    (params, opt_state, history: one dict of floats a logged step)."""
    opt_cfg = opt_cfg or OPT.AdamWConfig(total_steps=steps)
    step_fn = make_train_step(cfg, opt_cfg, policy)
    opt_state = OPT.init_state(params, factored=opt_cfg.factored,
                               model_cfg=cfg)
    device = params["embed"]["tokens"].device
    history = []
    for i in range(steps):
        batch = to_device(next(batches), device)
        params, opt_state, m = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in m.items()}
            history.append({"step": i, **m})
            if callback:
                callback(i, m)
    return params, opt_state, history
