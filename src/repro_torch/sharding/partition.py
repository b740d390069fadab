"""Sharding rules (the port's counterpart of ``repro.sharding.partition``):
parameter, batch and cache specs, and DTensor placements from them.

Scheme (the reference's):
  * Megatron tensor parallelism over the ``model`` axis: column-parallel
    up-projections (wq/wk/wv/wi/wg/wuq/wukv/w_up/w_in...), row-parallel
    down-projections (wo/w_down/w_out).
  * Expert parallelism: MoE expert stacks shard their expert axis over
    ``model``.
  * Data parallel over ``data`` (and ``pod`` across pods); optional FSDP
    shards the non-TP dim of large matrices over ``data``.
  * Caches: batch over (pod, data) when divisible; for single-stream
    long-context decode the KV sequence dim shards over ``data``
    (context parallelism).

A spec (:class:`P`) is a tuple with one entry per tensor dim: None, a
mesh axis name, or a tuple of names, so that it compares entry by entry
with the reference's ``PartitionSpec``.  :func:`placements` turns it into
a ``DeviceMesh``'s DTensor placement list.  The reference stacks each
pattern position over its scan repeats and expresses its rules over the
trailing dims of those stacked leaves; the port keeps one tree per layer
(``params["layers"][i]``), so a rule is evaluated at the reference's rank
(the port's rank + 1 under ``layers/``) and the leading repeats entry,
which no rule shards, is dropped.  ``embed/...`` and ``mtp/...`` are
stacked in neither package.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from repro_torch import perf_flags
from repro_torch.configs.base import ModelConfig


class P(tuple):
    """A partition spec: ``P("model", None)``; ``P()`` replicates.  A
    one-name tuple entry is that name, as in the reference's spec."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


# rule: leaf name -> spec over trailing dims, with "fsdp" placeholders
_COL = (("fsdp", "model"), 2)            # (in, out): out dim TP
_ROW = (("model", "fsdp"), 2)            # (in, out): in dim TP
_REP2 = ((None, None), 2)

_RULES = {
    # attention / dense ffn / mla / mlstm / mamba projections
    "wq": _COL, "wk": _COL, "wv": _COL, "wi": _COL, "wg": _COL,
    "wuq": _COL, "wukv": _COL, "w_up": _COL, "w_gate": _COL, "w_in": _COL,
    "w_if": _REP2, "w_bc": (("model", None), 2), "w_dt": (("model", None), 2),
    "wo": _ROW, "w_down": _ROW, "w_out": _ROW,
    "wdq": (("fsdp", None), 2), "wdkv": (("fsdp", None), 2),
    "wkr": _REP2, "proj": _COL, "router": ((None, "model"), 2),
}

# MoE expert stacks: (E, in, out) trailing dims; expert axis over model.
_MOE_COL = (("model", "fsdp", None), 3)
_MOE_ROW = (("model", None, "fsdp"), 3)


def _ref_leaf_spec(names: Sequence[str], ndim: int, fsdp: bool,
                   replicate_attn: bool) -> P:
    """The reference's ``_leaf_spec`` for a leaf of (reference) rank
    ``ndim`` at path ``names``."""
    name = names[-1]
    # tp_attn_guard: when head counts don't divide the TP degree, GSPMD
    # reshuffles full activations around every per-head op; cheaper to
    # keep attention weights replicated and data-parallel
    if replicate_attn and "attn" in names and name in ("wq", "wk", "wv",
                                                       "wo"):
        return P(*(None,) * ndim)

    def fill(rule):
        tpl, n = rule
        if ndim < n:
            return P()
        spec = tuple(("data" if a == "fsdp" and fsdp else
                      None if a == "fsdp" else a) for a in tpl)
        return P(*((None,) * (ndim - n) + spec))

    if name == "tokens":
        if ndim == 3:                         # (C, V, d) codebooks
            return P(None, "model", "data" if fsdp else None)
        return P("model", "data" if fsdp else None)
    if name == "heads":
        return P(None, "model", None)
    if name == "head":
        return fill(_COL)
    if name == "pos":
        return P()
    # MoE expert stacks: wi/wg/wo with expert + scan-repeat dims (rank 4
    # in the reference); stacked dense FFN weights are rank 3 there and
    # fall through to _RULES
    if name in ("wi", "wg", "wo") and ndim >= 4 and "ffn" in names:
        return fill(_MOE_COL if name in ("wi", "wg") else _MOE_ROW)
    if name in _RULES:
        return fill(_RULES[name])
    return P()                                 # norms, biases, gates, conv, r


def _stacked(names: Sequence[str]) -> bool:
    return names[0] == "layers"


def leaf_pspec(names: Sequence[str], ndim: int, fsdp: bool = False,
               replicate_attn: bool = False) -> P:
    """The spec of the port's leaf at path ``names`` (``("layers", "3",
    "attn", "wq")``) of rank ``ndim``: the reference's rule at the
    reference's rank, its leading repeats entry dropped for a layer
    leaf."""
    if not _stacked(names):
        return _ref_leaf_spec(names, ndim, fsdp, replicate_attn)
    spec = _ref_leaf_spec(names, ndim + 1, fsdp, replicate_attn)
    if spec and spec[0] is not None:
        raise ValueError(f"{'/'.join(names)}: the rule shards the "
                         f"reference's repeats dim ({spec})")
    return P(*spec[1:])


def _walk(tree, names=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, names + (str(k),))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from _walk(v, names + (str(i),))
    else:
        yield names, tree


def flat_specs(specs) -> dict:
    """{path: spec} of a spec tree, paths joined by "/" (as
    ``training.optimizer.flatten`` keys tensors)."""
    return {"/".join(n): sp for n, sp in _walk(specs)}


def map_tree(fn, tree, names=()):
    """``tree`` with each leaf replaced by ``fn(names, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_tree(fn, v, names + (str(i),))
                          for i, v in enumerate(tree))
    return fn(names, tree)


def param_pspecs(params_tree, cfg: ModelConfig, fsdp: bool = False,
                 mesh=None):
    """A tree of :class:`P` matching ``params_tree`` (tensors, fake or
    real).  Under ``tp_attn_guard``, with a mesh whose ``model`` axis does
    not divide the head count, attention weights stay replicated."""
    replicate_attn = False
    if mesh is not None and perf_flags.flag("tp_attn_guard"):
        replicate_attn = cfg.num_heads % axis_size(mesh, "model") != 0
    return map_tree(lambda names, t: leaf_pspec(names, t.ndim, fsdp,
                                                replicate_attn), params_tree)


class AbstractMesh:
    """A mesh's axis names and sizes without devices, for computing specs
    (the reference's tests use ``jax.sharding.AbstractMesh``): what the
    rules read of a ``DeviceMesh``."""

    def __init__(self, shape, names):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(names)
        self.ndim = len(self.shape)


# concrete mesh for in-model sharding constraints (seq_parallel); set by
# the launcher that owns the mesh
_CURRENT_MESH: list = [None]


def set_current_mesh(mesh) -> None:
    _CURRENT_MESH[0] = mesh


def current_mesh():
    return _CURRENT_MESH[0]


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name`` (1 when the mesh has no such
    axis)."""
    names = mesh.mesh_dim_names
    return mesh.shape[names.index(name)] if name in names else 1


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def data_parallel_size(mesh) -> int:
    size = 1
    for a in batch_axes(mesh):
        size *= axis_size(mesh, a)
    return size


def batch_pspec(mesh, batch_size: int, extra_dims: int = 1) -> P:
    """Shard dim0 over (pod, data) when divisible, else replicate."""
    dp = data_parallel_size(mesh)
    if batch_size % dp == 0 and batch_size >= dp:
        return P(batch_axes(mesh), *(None,) * extra_dims)
    return P(*(None,) * (extra_dims + 1))


def cache_pspecs(cache_tree, mesh, batch_size: int):
    """Cache sharding: batch-parallel when possible; otherwise shard the
    KV sequence dim over ``data`` (context parallelism for long_500k).
    The port's per-layer caches have no repeats dim: dim 0 is the batch,
    dim 1 the sequence (dims 1 and 2 in the reference)."""
    dp = data_parallel_size(mesh)
    batch_sharded = batch_size % dp == 0 and batch_size >= dp
    axes = batch_axes(mesh)

    def spec(names, leaf):
        name = names[-1]
        ndim = leaf.ndim
        positional = name in ("k", "v", "ckv", "kr", "pos")
        if positional and ndim >= 2:
            # (B, S, ...): cache allocations are 256-multiples, so the
            # sequence dim always shards evenly
            seq_ok = leaf.shape[1] % 256 == 0
            if batch_sharded:
                seq = "model" if seq_ok else None
                return P(axes, seq, *(None,) * (ndim - 2))
            seq = ("data", "model") if seq_ok else None
            return P(None, seq, *(None,) * (ndim - 2))
        if batch_sharded:
            return P(axes, *(None,) * (ndim - 1))
        if name == "ssm" and ndim == 3:        # (B, d_inner, N)
            return P(None, "model", None)
        if name == "C" and ndim == 4:          # (B, H, dh, dh)
            return P(None, None, "model", None)
        return P(*(None,) * ndim)

    return map_tree(spec, cache_tree)


def sanitize_spec(spec: P, shape, mesh) -> P:
    """Drop sharding on dims the mesh axes don't divide evenly (e.g. a
    32001-row vocab on a 16-way model axis stays replicated): DTensor
    would shard such a dim unevenly, the reference keeps it whole."""
    out = []
    for i, axes in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axes is None:
            out.append(None)
            continue
        size = 1
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            size *= axis_size(mesh, a)
        out.append(axes if shape[i] % size == 0 else None)
    return P(*out)


def placements(spec: P, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on
    every mesh dim that tensor dim i lists (several axes, e.g. ("pod",
    "data"), shard that dim over each of them, in mesh order),
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            out[names.index(a)] = Shard(i)
    return out


def local_shape(shape, spec: P, mesh) -> tuple:
    """A device's shard shape of a tensor of ``shape`` under the
    sanitized ``spec``."""
    spec = sanitize_spec(spec, shape, mesh)
    out = list(shape)
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            out[i] //= axis_size(mesh, a)
    return tuple(out)


def with_sharding(tree, specs, mesh):
    """Each tensor of ``tree`` (fake tensors in the dry run, real ones on
    the card) distributed over ``mesh`` as its sanitized spec in
    ``specs`` (a tree of the same structure) says: the DTensor
    counterpart of attaching NamedShardings to ShapeDtypeStructs."""
    from torch.distributed.tensor import distribute_tensor
    flat = dict(_walk(specs))

    def one(names, t):
        spec = sanitize_spec(flat[names], t.shape, mesh)
        return distribute_tensor(t, mesh, placements(spec, mesh))
    return map_tree(one, tree)
