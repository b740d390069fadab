"""Conversions between the reference's JAX trees (as numpy arrays) and the
port's tensors, so that the same parameters and the same pool contents can
be fed to both packages.

The reference stacks each stack's pattern positions over their scan
repeats (a leading ``repeats`` dim on every leaf); the port keeps one
entry per layer, in execution order (stack, repeat, pattern position).
The optimizer state converts the same way (:func:`opt_state_from_jax`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.training.optimizer import AdamWState, flatten, layer_groups


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: exact via fp32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unstack(stacks) -> list:
    """Per-layer trees, execution order, from stacked pattern positions."""
    layers = []
    for stack in stacks:
        repeats = len(next(iter(_leaves(stack[0]))))
        for r in range(repeats):
            for pat in stack:
                layers.append(_map(lambda a, r=r: _to_torch(np.asarray(a)[r]),
                                   pat))
    return layers


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def params_from_jax(tree) -> dict:
    """The port's parameter dict from a reference ``T.init_params`` tree
    whose leaves were converted to numpy (``jax.tree.map(np.asarray, ...)``):
    every layer's leaves (attention, MLA, Mamba, MoE with its shared
    experts), and DeepSeek's multi-token prediction module (``mtp``, not
    stacked) where the tree has one."""
    out = {"embed": _map(_to_torch, tree["embed"]),
           "final_norm": _map(_to_torch, tree["final_norm"]),
           "layers": _unstack(tree["stacks"])}
    if "mtp" in tree:
        out["mtp"] = _map(_to_torch, tree["mtp"])
    return out


def _unstack_specs(stacks, cfg: ModelConfig) -> list:
    """Per-layer spec trees, execution order, from the reference's stacked
    pattern positions: each spec loses its leading repeats entry."""
    from repro_torch.sharding.partition import P
    layers = []
    for stack, pats in zip(cfg.stacks, stacks):
        for _ in range(stack.repeats):
            layers.extend(_map(lambda s: P(*tuple(s)[1:]), pat)
                          for pat in pats)
    return layers


def pspecs_from_jax(specs, cfg: ModelConfig) -> dict:
    """The port's parameter spec tree (a ``sharding.partition.P`` a leaf,
    one tree a layer) from the reference's ``param_pspecs`` of its
    ``init_params`` tree: a layer's spec is its stack's spec without the
    leading repeats entry; ``embed`` / ``final_norm`` / ``mtp`` as they
    are."""
    from repro_torch.sharding.partition import P

    def conv(s):
        return P(*tuple(s))
    out = {"embed": _map(conv, specs["embed"]),
           "final_norm": _map(conv, specs["final_norm"]),
           "layers": _unstack_specs(specs["stacks"], cfg)}
    if "mtp" in specs:
        out["mtp"] = _map(conv, specs["mtp"])
    return out


def cache_pspecs_from_jax(specs, cfg: ModelConfig) -> dict:
    """The port's dense-cache spec tree from the reference's
    ``cache_pspecs`` of its ``cache_struct`` (stacked like its
    parameters)."""
    return {"layers": _unstack_specs(specs["layers"], cfg)}


def pool_from_numpy(tree) -> dict:
    """The port's paged cache ``{"layers": [pool per layer]}`` from a
    reference paged cache whose leaves are numpy arrays."""
    return {"layers": _unstack(tree["layers"])}


def pool_to_numpy(cache: dict, cfg: ModelConfig) -> dict:
    """The reference's stacked paged-cache layout, as numpy arrays, from
    the port's per-layer pools (bf16 pools come back as float32)."""
    stacks, base = [], 0
    layers = cache["layers"]
    for stack in cfg.stacks:
        n = len(stack.pattern)
        stacks.append(tuple(
            {k: np.stack([_to_numpy(layers[base + r * n + pi][k])
                          for r in range(stack.repeats)])
             for k in layers[base + pi]}
            for pi in range(n)))
        base += stack.num_layers
    return {"layers": tuple(stacks)}


def _jax_order(tree, path=()):
    """(path, leaf) of a reference tree in ``jax.tree_util`` flatten
    order: dict keys sorted, tuples and lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_order(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _jax_order(v, path + (i,))
    elif tree is not None:
        yield path, tree


def opt_state_from_jax(state, params_tree, cfg: ModelConfig):
    """The port's ``training.optimizer.AdamWState`` from a reference
    ``AdamWState`` whose leaves were converted to numpy, and the
    reference parameter tree it belongs to (numpy too, for the factored
    mode's leaf order).  Full mode: mu and nu unstacked like the
    parameters.  Factored mode: the reference's nu tuple follows its
    parameters' flatten order; a stacked leaf's statistics are split per
    layer, except those of a leaf that is 1-D per layer, which stay one
    (R,) x (n,) pair under the port's group key."""
    step = int(np.asarray(state.step))
    if state.mu is not None:
        def per_layer(tree):
            return flatten(params_from_jax(tree))
        return AdamWState(step, per_layer(state.mu), per_layer(state.nu))
    layers = layer_groups(cfg)
    nu, groups = {}, {}
    leaves = list(_jax_order(params_tree))
    assert len(leaves) == len(state.nu), (len(leaves), len(state.nu))
    for (path, leaf), v in zip(leaves, state.nu):
        if path[0] != "stacks":
            key = "/".join(map(str, path))
            nu[key] = (_map(_to_torch, v) if isinstance(v, dict)
                       else _to_torch(v))
            continue
        si, pi, rest = path[1], path[2], "/".join(map(str, path[3:]))
        members = [f"layers/{l}/{rest}" for l in layers[si, pi]]
        if np.ndim(leaf) == 2:          # 1-D per layer: one shared pair
            key = f"stacks/{si}/{pi}/{rest}"
            nu[key] = _map(_to_torch, v)
            groups[key] = members
            continue
        for r, m in enumerate(members):
            nu[m] = (_map(lambda a, r=r: _to_torch(np.asarray(a)[r]), v)
                     if isinstance(v, dict) else _to_torch(np.asarray(v)[r]))
    return AdamWState(step, None, nu, groups)
