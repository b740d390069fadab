"""How the port's forwards run on DTensors (parameters and caches
distributed with :mod:`repro_torch.sharding.partition`'s rules).

Most ops go through DTensor's own sharding propagation, which inserts the
collectives GSPMD would (the dry run's op analysis counts them).  The
rest is stated here, each as a ``local_map`` (the counterpart of
``shard_map``) over explicit placements:

  * **Kernels.**  A DTensor never reaches a kernel: each ``ops.*`` call
    of a meshed forward runs on the local shards.  Attention
    (:func:`attention`) takes the batch over the batch axes where it
    divides and the query heads over ``model`` where they divide; K/V
    heads follow when they divide too, else every ``model`` rank gathers
    all K/V heads and slices the few its query heads read (GQA), and
    their gradient is a partial sum over ``model``.  Heads that do not
    divide run replicated over ``model`` (what ``tp_attn_guard``'s
    replicated weights give).  A K/V cache sharded on its sequence dim is
    gathered over that axis first: the port attends whole rows, so
    context parallelism costs an all-gather a layer, which the dry run's
    collectives show.  :func:`batch_local` runs a kernel (the mLSTM's) on
    batch shards, replicated over ``model``.
  * **Cache writes** (:func:`write_cache`): in place, on each device's
    own shard of the cache; rows of a sequence-sharded cache are written
    only by the shard that holds them.
  * **seq_parallel** (:func:`seq_parallel`): the embedded activation's
    sequence dim over ``model``.

On a mesh whose every shard is whole (one card: a (1, 1) mesh), each
local call is the unmeshed call on the same tensors, so a meshed step
equals the unmeshed one bit for bit and launches the same kernels.
"""
from __future__ import annotations

import sys

import torch

from repro_torch import perf_flags
from repro_torch.sharding import partition as SH


def is_dtensor(t) -> bool:
    """Whether t is a DTensor; cheap on the unmeshed paths, which call it
    for every layer (no DTensor exists before its module is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def replicated(t, mesh):
    """``t`` as a DTensor on ``mesh``: a plain tensor (an index or a
    position array the forward made) is the same on every device."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _batch_placements(mesh, batch: int) -> list:
    """Dim 0 over the batch axes where the batch divides them, replicated
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    axes = SH.batch_axes(mesh)
    split = batch % SH.data_parallel_size(mesh) == 0
    return [Shard(0) if split and n in axes else Replicate()
            for n in mesh.mesh_dim_names]


def with_model(pl: list, mesh, placement) -> list:
    """Placements ``pl`` with ``placement`` on the ``model`` axis."""
    names = mesh.mesh_dim_names
    if "model" not in names:
        return pl
    pl = list(pl)
    pl[names.index("model")] = placement
    return pl


def coordinate(mesh, name: str) -> int:
    """This device's index along mesh axis ``name`` (0 without it)."""
    return mesh.get_local_rank(name) if name in mesh.mesh_dim_names else 0


def batch_layout(x):
    """A DTensor activation (B, ...) with its batch over the batch axes
    where it divides and whole on ``model``: the residual stream's layout
    (``seq_parallel`` then shards its sequence), and where a rule-less
    layout would leave DTensor's backward a shard it cannot multiply;
    anything else as is."""
    if not is_dtensor(x):
        return x
    pl = _batch_placements(x.device_mesh, x.shape[0])
    if list(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)


def gather_rows(table, ids):
    """``table[ids]`` for a (V, d) table.  A DTensor table is looked up on
    each device's rows: where they are sharded, each device looks up the
    ids in its slice (zeros elsewhere) and the lookups are summed over the
    slices, where DTensor would gather the whole table."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if not is_dtensor(table):
        return table[ids]
    mesh = table.device_mesh
    ids = replicated(ids, mesh)
    id_pl = _batch_placements(mesh, ids.shape[0])
    split = [p == Shard(0) and mesh.size(i) > 1
             for i, p in enumerate(table.placements)]
    tab_pl = [Shard(0) if s else Replicate() for s in split]
    out_pl = [Partial() if s else id_pl[i] for i, s in enumerate(split)]
    # the table's gradient: its own slice, summed over the batch shards
    grad_pl = [Shard(0) if s else Partial() if id_pl[i] == Shard(0)
               else Replicate() for i, s in enumerate(split)]
    first = _shard_index(table, 0) * table.to_local().shape[0] \
        if any(split) else 0

    def local(tab, ids):
        if not any(split):
            return tab[ids]
        rel = ids - first
        ok = (rel >= 0) & (rel < tab.shape[0])
        rows = tab[rel.clamp(0, tab.shape[0] - 1)]
        return torch.where(ok[..., None], rows, 0.0)

    return local_map(local, out_placements=out_pl,
                     in_placements=(tab_pl, id_pl),
                     in_grad_placements=(grad_pl, id_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, ids)


def pointwise(fn, t):
    """``fn(t)`` elementwise where DTensor has no rule for ``fn``: on the
    local shards, partial sums reduced first."""
    if not is_dtensor(t):
        return fn(t)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = [Replicate() if p.is_partial() else p for p in t.placements]
    return local_map(fn, out_placements=pl, in_placements=(pl,),
                     device_mesh=t.device_mesh, redistribute_inputs=True)(t)


def like(t, ref):
    """DTensor ``t`` laid out as ``ref`` (the residual stream a block's
    output is added to: a row-parallel output's partial sums are reduced
    into the stream's layout, as GSPMD keeps it); anything else as is."""
    if is_dtensor(t) and is_dtensor(ref) and t.placements != ref.placements:
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def gather_rows_for(x, w):
    """Activation x (..., in) for a product with weight w: where a mesh
    axis shards both one of x's leading (token) dims and w, x is gathered
    on that axis first (``seq_parallel``'s all-gather before a
    column-parallel product: DTensor cannot multiply such a pair)."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_shard() and p.dim < x.ndim - 1
          and q.is_shard() else p
          for p, q in zip(x.placements, w.placements)]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def split_last(t, n: int):
    """``t`` (..., n * m) viewed as (..., n, m).  A DTensor whose last dim
    is sharded over a mesh axis that does not divide ``n`` is gathered
    over that axis first: DTensor cannot split such a shard (GSPMD
    would reshard the same way)."""
    shape = tuple(t.shape[:-1]) + (n, t.shape[-1] // n)
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        last = t.ndim - 1
        pl = [Replicate() if p == Shard(last) and n % t.device_mesh.size(i)
              else p for i, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(shape)


def attention(fn, q, k, v, q_pos, k_pos, **kw):
    """``fn(q, k, v, q_pos, k_pos, **kw)`` (``layers.mha_attention``) on
    the local shards of DTensors q (B,Sq,Hq,D), k / v (B,Sk,Hkv,D), as the
    module's docstring says; returns a DTensor (B, Sq, Hq * Dv) placed as
    the local q, its heads merged on the device (DTensor cannot split
    heads that do not divide the mesh again in the backward)."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    tp = SH.axis_size(mesh, "model")
    B, _, Hq, _ = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    hq_loc = Hq // tp
    bat = _batch_placements(mesh, B)
    q_pl = kv_pl = kv_grad = bat
    kv_slice = None
    if tp > 1 and Hq % tp == 0:
        q_pl = with_model(bat, mesh, Shard(2))
        if Hkv % tp == 0:
            kv_pl = kv_grad = q_pl
        elif hq_loc % g == 0 or g % hq_loc == 0:
            # GQA with fewer K/V heads than model ranks: gather them all,
            # slice the ones this rank's query heads read
            kv_grad = with_model(bat, mesh, Partial())
            lo = coordinate(mesh, "model") * hq_loc // g
            kv_slice = (lo, max(1, hq_loc // g))
        else:
            q_pl = bat
    q_pos, k_pos = replicated(q_pos, mesh), replicated(k_pos, mesh)

    def local(q, k, v, q_pos, k_pos):
        if kv_slice is not None:
            lo, n = kv_slice
            k, v = k[:, :, lo:lo + n], v[:, :, lo:lo + n]
        return fn(q, k, v, q_pos, k_pos, **kw).flatten(2)

    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl, bat, bat),
                     in_grad_placements=(q_pl, kv_grad, kv_grad, bat, bat),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, q_pos, k_pos)


def batch_local(fn, n_out: int, *args, weights: int = 0):
    """``fn(*args)`` on batch shards, replicated over every other mesh
    axis.  The first ``weights`` arguments are parameters, whole on every
    device (their gradients partial sums over the batch axes); every other
    tensor (DTensors and plain ones alike, in dicts too) has its batch in
    dim 0, and so has each of the ``n_out`` tensors ``fn`` returns
    (flattened, dicts too)."""
    from torch.utils import _pytree as pytree
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    flat, spec = pytree.tree_flatten(args)
    n_w = len(pytree.tree_leaves(args[:weights]))
    first = next(t for t in flat[n_w:] if is_dtensor(t))
    mesh = first.device_mesh
    bat = _batch_placements(mesh, first.shape[0])
    rep = [Replicate()] * mesh.ndim
    w_grad = [Partial() if p == Shard(0) else p for p in bat]
    flat = [replicated(t, mesh) if isinstance(t, torch.Tensor) else t
            for t in flat]

    def pl(i, t, w, b):
        return None if not isinstance(t, torch.Tensor) else (
            w if i < n_w else b)

    def local(*flat_local):
        return fn(*pytree.tree_unflatten(list(flat_local), spec))

    return local_map(
        local, out_placements=(bat,) * n_out,
        in_placements=tuple(pl(i, t, rep, bat) for i, t in enumerate(flat)),
        in_grad_placements=tuple(pl(i, t, w_grad, bat)
                                 for i, t in enumerate(flat)),
        device_mesh=mesh, redistribute_inputs=True)(*flat)


def write_cache(write_fn, cache: dict, new: dict, index):
    """``write_fn(cache, new, index, shard=...)`` (``kv_cache.
    write_prefill`` / ``write_decode``) on each device's shard of a
    DTensor cache, in place.  ``new`` and ``index`` (positions or lengths)
    follow the cache's batch placement and are whole on every other axis;
    where the cache's sequence dim (dim 1) is sharded, ``shard`` =
    (global rows, this shard's first row) tells the write which rows are
    its own."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    pos = cache["pos"]
    mesh = pos.device_mesh
    keys = list(new)
    cache_pls = [tuple(cache[key].placements) for key in keys + ["pos"]]
    row_pl = tuple(Shard(0) if p == Shard(0) else Replicate()
                   for p in pos.placements)
    rows, local_rows = pos.shape[1], pos.to_local().shape[1]
    shard = ((rows, _shard_index(pos, 1) * local_rows)
             if local_rows != rows else None)

    def local(*t):
        n = len(keys)
        lc = dict(zip(keys + ["pos"], t[:n + 1]))
        write_fn(lc, dict(zip(keys, t[n + 1:2 * n + 1])), t[-1], shard=shard)
        return t[n]

    new_t = [replicated(new[key], mesh) for key in keys]
    local_map(local, out_placements=list(cache_pls[-1]),
              in_placements=(*cache_pls, *(row_pl,) * len(keys), row_pl),
              device_mesh=mesh, redistribute_inputs=True)(
        *(cache[key] for key in keys), pos, *new_t,
        replicated(index, mesh))
    return cache


def _shard_index(t, dim: int) -> int:
    """This device's place among the shards of DTensor t's dim ``dim``
    (the mesh dims that shard it, in mesh order)."""
    from torch.distributed.tensor import Shard
    mesh, index = t.device_mesh, 0
    for i, (p, c) in enumerate(zip(t.placements, mesh.get_coordinate())):
        if p == Shard(dim):
            index = index * mesh.size(i) + c
    return index


def logsumexp_gold(logits, labels):
    """(logsumexp of ``logits`` over its last dim, ``logits`` at the
    integer ``labels``), for a cross-entropy.  DTensor logits are reduced
    on each device's shard; where the last dim (the vocabulary) is
    sharded, each device takes the log-sum-exp of its slice and the logit
    of the labels inside it, then the slices' log-sum-exps are combined (a
    gather of one value a slice and token) and the labels' logits summed
    over the slices, where DTensor would gather the whole vocabulary."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if not is_dtensor(logits):
        return (torch.logsumexp(logits, dim=-1),
                logits.gather(-1, labels[..., None].long())[..., 0])
    mesh = logits.device_mesh
    last = logits.ndim - 1
    split = [p == Shard(last) and mesh.size(i) > 1
             for i, p in enumerate(logits.placements)]
    labels = replicated(labels, mesh)
    lg_pl = [Shard(last) if s else Replicate() if p == Shard(last) else p
             for s, p in zip(split, logits.placements)]
    lab_pl = [labels.placements[i] if p == Shard(last) else p
              for i, p in enumerate(lg_pl)]
    row_pl = [Replicate() if p == Shard(last) else p for p in lg_pl]
    if not any(split):
        def whole(lg, lab):
            return (torch.logsumexp(lg, dim=-1),
                    lg.gather(-1, lab[..., None].long())[..., 0])
        return local_map(whole, out_placements=(row_pl, row_pl),
                         in_placements=(lg_pl, lab_pl), device_mesh=mesh,
                         redistribute_inputs=True)(logits, labels)
    gold_pl = [Partial() if s else p for s, p in zip(split, row_pl)]
    first = _shard_index(logits, last) * logits.to_local().shape[-1]

    def local(lg, lab):
        rel = lab.long() - first
        ok = (rel >= 0) & (rel < lg.shape[-1])
        g = lg.gather(-1, rel.clamp(0, lg.shape[-1] - 1)[..., None])
        return (torch.logsumexp(lg, dim=-1)[..., None],
                torch.where(ok, g[..., 0], 0.0))

    lse, gold = local_map(local, out_placements=(lg_pl, gold_pl),
                          in_placements=(lg_pl, lab_pl), device_mesh=mesh,
                          redistribute_inputs=True)(logits, labels)
    # every device takes all slices' log-sum-exps of its tokens
    lse = lse.redistribute(mesh, row_pl)
    return torch.logsumexp(lse, dim=-1), gold


def seq_parallel(x):
    """seq_parallel (perf flag): shard the token / sequence dim of the
    embedded activation (B, S, d) over ``model``, when the flag is on, a
    current mesh is set, x is a DTensor and S divides; DTensor gathers
    what each later op needs (counted by the dry run)."""
    from torch.distributed.tensor import Shard
    if not perf_flags.flag("seq_parallel"):
        return x
    mesh = SH.current_mesh()
    if (mesh is None or "model" not in mesh.mesh_dim_names
            or not is_dtensor(x)
            or x.shape[1] % SH.axis_size(mesh, "model") != 0):
        return x
    return x.redistribute(x.device_mesh,
                          with_model(x.placements, x.device_mesh, Shard(1)))
