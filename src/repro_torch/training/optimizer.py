"""AdamW and its learning-rate schedule (the port's counterpart of
``repro.training.optimizer``), in two second-moment modes:

  * full      standard AdamW (the default);
  * factored  Adafactor-style: for a parameter of two or more dims the
    second moment is a row statistic (shape[:-1]) and a column statistic
    (shape[:-2] + last), reconstructed as ``v_ij ~ r_i c_j / mean(r)``,
    and the first moment is dropped.

The reference stacks every layer leaf over its stack's repeats (a leading
``repeats`` dim, even for one repeat) and applies its rules to those
stacked leaves; the port keeps one entry per layer, so it reproduces what
the stacking implies:

  * weight decay applies to a leaf of rank >= 2 in the reference: every
    layer leaf (its norms, biases, ``a_log`` and ``dt_bias`` too, which
    stacking makes 2-D), and ``embed`` / ``mtp`` / ``final_norm`` leaves
    by their own rank;
  * in factored mode a layer leaf that is 1-D per layer is one (R, n)
    stacked leaf in the reference, factored across the R repeats of its
    stack and pattern position: one row statistic (R,) and one column
    statistic (n,) shared by the R layers, kept here under a group key
    ``stacks/<stack>/<position>/<leaf path>``; a layer leaf of two or more
    dims is factored per layer (the leading repeats dim only batches).

The state is path-keyed: ``mu`` / ``nu`` map a leaf's path in the
parameter tree (``layers/3/attn/wq``) to its moment (a {"r", "c"} dict
where factored), and ``step`` is a host int, so computing the learning
rate and the bias corrections reads nothing back from the device.  The
update writes the parameters and moments in place (under
``torch.no_grad``), which keeps one copy of each on the card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

LAYERS = "layers"


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    factored: bool = False


class AdamWState(NamedTuple):
    step: int
    mu: Optional[dict]       # path -> first moment; None when factored
    nu: dict                 # path (or group key) -> second moment
    groups: Optional[dict] = None   # factored: group key -> member paths


# ---------------------------------------------------------------------------
# Trees <-> paths
# ---------------------------------------------------------------------------


def flatten(tree, prefix: str = "") -> dict:
    """{path: tensor} of a nested dict / list tree, paths joined by "/"
    (list entries by index), in the tree's order."""
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten_like(tree, flat: dict, prefix: str = ""):
    """A tree shaped like ``tree`` whose leaves are ``flat[path]``."""
    if isinstance(tree, dict):
        return {k: unflatten_like(v, flat, f"{prefix}/{k}" if prefix
                                  else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unflatten_like(v, flat, f"{prefix}/{i}" if prefix
                                         else str(i))
                          for i, v in enumerate(tree))
    return flat[prefix]


def _is_layer(path: str) -> bool:
    return path.startswith(LAYERS + "/")


def reference_ndim(path: str, t: torch.Tensor) -> int:
    """The rank of the leaf in the reference's tree: a layer leaf carries
    its stack's repeats dim there."""
    return t.ndim + 1 if _is_layer(path) else t.ndim


def layer_groups(cfg: ModelConfig) -> dict:
    """{(stack, pattern position): [layer indices]}: the layers the
    reference stacks into one leaf, in repeat order."""
    groups, base = {}, 0
    for si, stack in enumerate(cfg.stacks):
        n = len(stack.pattern)
        for pi in range(n):
            groups[si, pi] = [base + r * n + pi
                              for r in range(stack.repeats)]
        base += stack.num_layers
    return groups


def _split_layer_path(path: str):
    """"layers/<l>/<rest>" -> (l, rest)."""
    _, l, rest = path.split("/", 2)
    return int(l), rest


def _shared_groups(params: dict, cfg: ModelConfig) -> dict:
    """{group key: [member paths]} for the layer leaves that are 1-D per
    layer (factored across their stack's repeats in the reference)."""
    of_layer = {l: (si, pi) for (si, pi), ls in layer_groups(cfg).items()
                for l in ls}
    groups = {}
    for path, t in flatten(params).items():
        if _is_layer(path) and t.ndim == 1 and t.is_floating_point():
            l, rest = _split_layer_path(path)
            si, pi = of_layer[l]
            groups.setdefault(f"stacks/{si}/{pi}/{rest}", []).append(path)
    return groups


def _float_leaves(params) -> dict:
    return {p: t for p, t in flatten(params).items() if t.is_floating_point()}


def _factored_zeros(t: torch.Tensor) -> dict:
    return {"r": torch.zeros(t.shape[:-1], device=t.device),
            "c": torch.zeros(t.shape[:-2] + t.shape[-1:], device=t.device)}


def init_state(params, moment_dtype=torch.float32, factored: bool = False,
               *, model_cfg: Optional[ModelConfig] = None) -> AdamWState:
    """Zero moments for every floating leaf of ``params``.  Full mode keeps
    mu and nu at ``moment_dtype`` (bf16 is the low-memory mode); factored
    mode keeps fp32 statistics only and needs the model's config, whose
    stacks say which layers share a statistic."""
    leaves = _float_leaves(params)
    if not factored:
        mu = {p: torch.zeros_like(t, dtype=moment_dtype)
              for p, t in leaves.items()}
        nu = {p: torch.zeros_like(t, dtype=moment_dtype)
              for p, t in leaves.items()}
        return AdamWState(0, mu, nu)
    if model_cfg is None and any(_is_layer(p) for p in leaves):
        raise ValueError("factored AdamW needs model_cfg: a layer leaf's "
                         "statistics follow its stack")
    groups = _shared_groups(params, model_cfg) if model_cfg else {}
    shared = {m for ms in groups.values() for m in ms}
    nu = {}
    for p, t in leaves.items():
        if p in shared:
            continue
        nu[p] = (_factored_zeros(t) if reference_ndim(p, t) >= 2
                 else torch.zeros_like(t, dtype=torch.float32))
    for key, members in groups.items():
        t = leaves[members[0]]
        nu[key] = {"r": torch.zeros(len(members), device=t.device),
                   "c": torch.zeros(t.shape, device=t.device)}
    return AdamWState(0, None, nu, groups)


def factored_nu_pspecs(param_specs, params, cfg: ModelConfig) -> dict:
    """Partition specs of the factored state's ``nu``, keyed as
    :func:`init_state` keys it, from the parameters' specs (a tree of
    ``sharding.partition.P`` shaped like ``params``): a statistic drops
    the dim it reduces over.  Factoring follows the reference's rank, as
    ``init_state`` does: a leaf of two or more dims per layer keeps its
    spec's rows ([:-1]) and columns ([:-2] + [-1:]); a 1-D layer leaf's
    shared (R,) x (n,) pair takes the reference's spec of the stacked (R,
    n) leaf (the repeats dim, never sharded, then the leaf's own); any
    other 1-D leaf keeps its spec."""
    from repro_torch.sharding.partition import P, flat_specs
    specs = flat_specs(param_specs)
    leaves = _float_leaves(params)

    def padded(path):
        t = tuple(specs[path])
        return t + (None,) * (leaves[path].ndim - len(t))
    groups = _shared_groups(params, cfg)
    shared = {m for ms in groups.values() for m in ms}
    out = {}
    for path, t in leaves.items():
        if path in shared:
            continue
        sp = padded(path)
        out[path] = ({"r": P(*sp[:-1]), "c": P(*(sp[:-2] + sp[-1:]))}
                     if reference_ndim(path, t) >= 2 else P(*sp))
    for key, members in groups.items():
        sp = (None,) + padded(members[0])
        out[key] = {"r": P(*sp[:-1]), "c": P(*(sp[:-2] + sp[-1:]))}
    return out


# ---------------------------------------------------------------------------
# Schedule, norm, update
# ---------------------------------------------------------------------------


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup, then cosine decay to ``min_lr_frac`` of ``lr``, in
    fp32 as the reference's jitted train step computes it (returned as a
    Python float holding that fp32 value).  XLA folds the constants
    (``lr / warmup`` and the schedule's divisions become products with
    fp32 reciprocals) and fuses ``min_lr_frac + c (1 + cos)`` into one
    rounding; the cosine is the correctly rounded fp32 value.  The
    eager formula differs from it by an fp32 unit at some steps."""
    f = np.float32
    s = f(step)
    if step < cfg.warmup_steps:
        return float(s * f(f(cfg.lr) * f(f(1) / f(max(cfg.warmup_steps, 1)))))
    span = f(max(cfg.total_steps - cfg.warmup_steps, 1))
    prog = min(max(f(f(s - f(cfg.warmup_steps)) * f(f(1) / span)), f(0)),
               f(1))
    cos = f(math.cos(float(f(f(math.pi) * prog))))
    inner = f(np.float64(f((1 - cfg.min_lr_frac) * 0.5))
              * np.float64(f(1) + cos) + np.float64(f(cfg.min_lr_frac)))
    return float(f(cfg.lr) * inner)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32, on the device."""
    leaves = [g for g in flatten(grads).values() if g.is_floating_point()]
    return torch.stack([g.float().square().sum() for g in leaves]).sum() \
        .sqrt()


def _bias_correction(b: float, step: int) -> float:
    return float(1 - _f32(b) ** _f32(step))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState):
    """One AdamW step: clip by the global norm (``grad_clip``), update the
    moments and the parameters in place.  ``grads`` is shaped like
    ``params``.  Returns (params, the new state, {"lr": float, "gnorm":
    the pre-clip global norm, a device scalar})."""
    leaves = _float_leaves(params)
    flat_g = flatten(grads)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = _bias_correction(cfg.b1, step)
    b2c = _bias_correction(cfg.b2, step)

    def decay_and_write(path, p, delta):
        if reference_ndim(path, p) >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    if not cfg.factored:
        for path, p in leaves.items():
            g = flat_g[path].float() * scale
            m, v = state.mu[path], state.nu[path]
            m_new = cfg.b1 * m + (1 - cfg.b1) * g
            v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
            mhat = m_new.float() / b1c
            vhat = v_new.float() / b2c
            decay_and_write(path, p, mhat / (torch.sqrt(vhat) + cfg.eps))
            m.copy_(m_new.to(m.dtype))
            v.copy_(v_new.to(v.dtype))
        return params, AdamWState(step, state.mu, state.nu), \
            {"lr": lr, "gnorm": gnorm}

    def factored_delta(g, nu):
        g2 = g * g
        if isinstance(nu, dict):
            r = cfg.b2 * nu["r"] + (1 - cfg.b2) * g2.mean(-1)
            c = cfg.b2 * nu["c"] + (1 - cfg.b2) * g2.mean(-2)
            rmean = r.mean(-1, keepdim=True)
            vhat = (r[..., :, None] * c[..., None, :]
                    / torch.clamp_min(rmean[..., None], 1e-30)) / b2c
            nu["r"].copy_(r)
            nu["c"].copy_(c)
        else:
            vfull = cfg.b2 * nu + (1 - cfg.b2) * g2
            vhat = vfull / b2c
            nu.copy_(vfull)
        return g / (torch.sqrt(vhat) + cfg.eps)

    groups = state.groups or {}
    shared = {m for ms in groups.values() for m in ms}
    for path, p in leaves.items():
        if path not in shared:
            delta = factored_delta(flat_g[path].float() * scale,
                                   state.nu[path])
            decay_and_write(path, p, delta)
    for key, members in groups.items():
        # the reference's (R, n) stacked leaf: one row per repeat
        g = torch.stack([flat_g[m].float() for m in members]) * scale
        delta = factored_delta(g, state.nu[key])
        for i, m in enumerate(members):
            decay_and_write(m, leaves[m], delta[i])
    return params, AdamWState(step, None, state.nu, state.groups), \
        {"lr": lr, "gnorm": gnorm}
