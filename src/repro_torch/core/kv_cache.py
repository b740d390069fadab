"""KV caches (the port's counterpart of ``repro.core.kv_cache``): the
dense per-slot cache of the batched generation path, and the paged pools
of continuous batching.

**Dense.**  Each attention layer holds ``{"k", "v": (B, S, H_kv, D),
"pos": (B, S)}``, the absolute position of every entry (-1 = empty), so
masks stay exact for padded batches and ring caches alike.  ``S`` is the
context (or the window) plus one "dump" slot, the last, where prompt
padding lands with pos = -1; above 256 it is rounded up to a multiple of
256, as in the reference (ring arithmetic uses ``S - 1``; the entries
between the context and the rounded size stay empty).  Recurrent layers
keep their fp32 state.

**Paged.**  K/V live in a shared pool of fixed-size pages, one pool per
attention layer:

  pk / pv : (P, page, H_kv, D)   physical page pool
  ppos    : (P, page)            absolute position per entry, -1 = empty

and, when ``kv_dtype="int8"``, ``pk``/``pv`` hold int8 codes beside

  pk_scale / pv_scale : (P, page, H_kv)   fp32 absmax scale per entry/head

(:func:`quantize_kv`).  A token's codes depend only on its own K/V, so a
shared prefix stores the same bytes whoever wrote it, and the scales
travel with their pages through COW copies.

plus one global block table (slots, pages_per_slot) of physical page ids
shared by every layer (page id p belongs to the same request in all
layers' pools).  Page P-1 is the reserved "dump" page: writes from padding
lanes, inactive slots and unallocated table entries land there with
pos = -1, so masking stays exact without branching.

A model cache is ``{"layers": [pool per layer]}`` in execution order.
Per-slot state stays dense, one row per slot, behind the same slot API:
recurrent layers (mLSTM, sLSTM) keep their fp32 state instead of a pool,
MLA layers their latent cache (``ckv``, ``kr``, ``pos``), and hybrid
layers their SSM and conv state beside their pool.  :func:`slot_view`
hands an admission fresh empty rows (zeros, ``pos`` = -1) and
:func:`slot_merge` scatters the prefilled rows into the admitted slots.

Unlike the reference, whose updates are functional, every update here
writes the cache tensors **in place** (``index_put_``) and returns the
same cache object: the engine owns one persistent pool (and one dense
cache per batch) and never needs the previous contents.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import (ATTN, HYBRID, MLA, MLSTM, SLSTM,
                                      LayerSpec, ModelConfig)
from repro_torch.core.precision import kv_store_dtype
from repro_torch.models import ssm as SSM
from repro_torch.sharding import spmd as SP

PAGED_KEYS = ("pk", "pv", "ppos", "pk_scale", "pv_scale")
PAGED_DATA_KEYS = ("pk", "pv", "pk_scale", "pv_scale")

INT8_QMAX = 127.0


def quantize_kv(x):
    """Quantize K/V rows to int8 with per-entry, per-head absmax scales.

    x: (..., H, D) float -> (int8 codes (..., H, D), fp32 scales (..., H)).
    Codes round half to even into [-127, 127]; all-zero rows get scale 0
    (codes 0, which dequantize to exact 0).
    """
    xf = x.float()
    scale = xf.abs().amax(-1) / INT8_QMAX
    q = torch.round(xf / scale.clamp_min(1e-30)[..., None])
    return q.clamp(-INT8_QMAX, INT8_QMAX).to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_kv` (up to rounding): one fp32 multiply
    per element."""
    return (q.float() * scale[..., None].float()).to(dtype)


def effective_window(cfg: ModelConfig, spec: LayerSpec,
                     max_len: int) -> Optional[int]:
    """Layer window, with the long-context override applied to global
    attention and MLA layers when serving beyond the native context."""
    w = spec.window
    if (w is None and spec.mixer in (ATTN, MLA)
            and cfg.long_context_override is not None
            and max_len > cfg.native_context):
        w = cfg.long_context_override
    return w


# ---------------------------------------------------------------------------
# Dense per-slot cache
# ---------------------------------------------------------------------------


def layer_cache_shape(cfg: ModelConfig, spec: LayerSpec, batch: int,
                      max_len: int, dtype, device="cpu") -> dict:
    """Dense cache of one layer for ``batch`` rows: K/V and positions for
    attention (the context, or the window, plus the dump slot, rounded up
    to a multiple of 256 above 256), plus a hybrid layer's SSM state
    (fp32) and conv state; an MLA layer's latent ``ckv`` and rotated key
    ``kr`` over the same rows; the fp32 state for mLSTM / sLSTM."""
    if spec.mixer in (MLSTM, SLSTM):
        zero = (SSM.mlstm_zero_state if spec.mixer == MLSTM
                else SSM.slstm_zero_state)
        return zero(cfg, batch, device=device)
    window = effective_window(cfg, spec, max_len)
    s = (min(window, max_len) if window else max_len) + 1
    s = -(-s // 256) * 256 if s > 256 else s

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    pos = torch.full((batch, s), -1, dtype=torch.int32, device=device)
    if spec.mixer == MLA:
        m = cfg.mla
        return {"ckv": z(batch, s, m.kv_lora_rank),
                "kr": z(batch, s, m.rope_head_dim), "pos": pos}
    shape = (batch, s, cfg.num_kv_heads, cfg.resolved_head_dim)
    out = {"k": z(*shape), "v": z(*shape), "pos": pos}
    if spec.mixer == HYBRID:
        out["ssm"], out["conv"] = SSM.mamba_zero_state(cfg, batch, dtype,
                                                       device=device)
    return out


def write_prefill(cache: dict, new: dict, positions, shard=None) -> dict:
    """Write whole prompts into a (possibly ring) dense cache, in place.

    new: {"k"/"v": (B, S, H, D)} aligned with ``positions`` (B, S); a
    position of -1 marks right-padding and goes to the dump slot.  A ring
    (fewer slots than S) keeps only each row's last valid tokens.  A
    DTensor cache is written shard by shard (``sharding.spmd.write_cache``:
    ``shard`` = (the cache's rows, this shard's first row) where its
    sequence dim is split)."""
    if shard is None and SP.is_dtensor(cache["pos"]):
        return SP.write_cache(write_prefill, cache, new, positions)
    ring = (shard[0] if shard else cache["pos"].shape[1]) - 1  # last = dump
    B, S = positions.shape
    take = min(S, ring)
    pos = positions.long()
    dev = pos.device
    # per row the last `take` valid tokens (positions are contiguous or
    # -1 for padding, so the valid end is max(pos) + 1)
    valid = (pos.amax(1) + 1).clamp_min(0)
    start = (valid - take).clamp(0, S - take)
    idx = start[:, None] + torch.arange(take, device=dev)[None, :]
    b_idx = torch.arange(B, device=dev)[:, None]
    pos_w = pos[b_idx, idx]
    slots = torch.where(pos_w >= 0, pos_w % ring, ring)
    for key, val in new.items():
        _put(cache[key], b_idx, slots, val[b_idx, idx], shard)
    _put(cache["pos"], b_idx, slots, pos_w, shard)
    return cache


def write_decode(cache: dict, new: dict, lengths, shard=None) -> dict:
    """Write one token per row at absolute position ``lengths`` (B,), in
    place; ``new``: {"k"/"v": (B, 1, H, D)}.  A DTensor cache as in
    :func:`write_prefill`."""
    if shard is None and SP.is_dtensor(cache["pos"]):
        return SP.write_cache(write_decode, cache, new, lengths)
    ring = (shard[0] if shard else cache["pos"].shape[1]) - 1
    lengths = lengths.long()
    slots = lengths % ring
    b_idx = torch.arange(lengths.shape[0], device=lengths.device)
    for key, val in new.items():
        _put(cache[key], b_idx, slots, val[:, 0], shard)
    _put(cache["pos"], b_idx, slots, lengths, shard)
    return cache


def _put(t, b_idx, slots, vals, shard) -> None:
    """``t[b_idx, slots] = vals`` (at t's dtype).  With ``shard`` = (rows,
    first row), t holds rows [first, first + t.shape[1]) of the cache, and
    a write to a row outside them is replaced by a repeat of a kept write
    of the same batch row (or, where it keeps none, by a write of its own
    row 0's value back), so that no value lands twice on one row unless
    it is the same value."""
    vals = vals.to(t.dtype)
    if shard is None:
        t[b_idx, slots] = vals
        return
    two_d = slots.dim() == 2
    if not two_d:                           # one token a batch row
        b_idx, slots, vals = b_idx[:, None], slots[:, None], vals[:, None]
    rel = slots - shard[1]
    ok = (rel >= 0) & (rel < t.shape[1])
    has = ok.any(1, keepdim=True)
    first = ok.to(torch.int32).argmax(1, keepdim=True)
    a_idx = torch.where(has, rel.gather(1, first), 0)
    tail = (1,) * (vals.dim() - 2)
    pick = first.reshape(first.shape + tail).expand(
        (-1, 1) + vals.shape[2:])
    b1 = b_idx.expand_as(rel)[:, :1]
    a_val = torch.where(has.reshape(has.shape + tail), vals.gather(1, pick),
                        t[b1, torch.zeros_like(a_idx)])
    okv = ok.reshape(ok.shape + tail)
    t[b_idx.expand_as(rel), torch.where(ok, rel, a_idx)] = torch.where(
        okv, vals, a_val)


def cache_mask(cache_pos, q_pos, window: Optional[int]):
    """(B, Sq, Sk) bool mask from stored absolute positions: empty entries
    (-1) are never visible, a key is visible at or before the query's
    position and, with a window, inside it."""
    valid = cache_pos[:, None, :] >= 0
    m = (cache_pos[:, None, :] <= q_pos[:, :, None]) & valid
    if window is not None:
        m &= cache_pos[:, None, :] > (q_pos[:, :, None] - window)
    return m


# ---------------------------------------------------------------------------
# Paged pools
# ---------------------------------------------------------------------------


def paged_pool_bytes(cache: dict) -> int:
    """Total bytes of every paged-pool tensor (K/V pages, scale pools and
    positions) across a full model cache; dense recurrent state is not
    counted."""
    return sum(c[k].numel() * c[k].element_size()
               for c in cache["layers"] for k in PAGED_KEYS if k in c)


def paged_layer_cache_shape(cfg: ModelConfig, spec: LayerSpec,
                            num_pages: int, page_size: int, dtype,
                            kv_dtype: str = "auto", *, max_slots: int = 0,
                            max_len: int = 0, device="cpu") -> dict:
    """Paged pool for one attention layer: ``num_pages`` + 1 dump page.
    Only pure attention pools store int8 (``kv_dtype="int8"``: the codes
    and their two scale pools); a hybrid layer's pool stays at the compute
    dtype (int8 falls back, as in the reference), beside its dense SSM and
    conv state of ``max_slots`` rows.  An MLA layer keeps its dense latent
    cache of ``max_slots`` rows for contexts up to ``max_len``, and an
    mLSTM or sLSTM layer its dense fp32 state (at any ``kv_dtype``)."""
    if spec.mixer != ATTN and max_slots < 1:
        raise ValueError(f"'{spec.mixer}' layers keep per-slot state: they "
                         f"need max_slots >= 1")
    if spec.mixer in (MLSTM, SLSTM):
        zero = (SSM.mlstm_zero_state if spec.mixer == MLSTM
                else SSM.slstm_zero_state)
        return zero(cfg, max_slots, device=device)
    if spec.mixer == MLA:
        if max_len < 1:
            raise ValueError("MLA layers need max_len for their latent "
                             "cache")
        return layer_cache_shape(cfg, spec, max_slots, max_len, dtype,
                                 device=device)
    hd = cfg.resolved_head_dim
    quant = kv_dtype == "int8" and spec.mixer == ATTN
    pool_dtype = torch.int8 if quant else kv_store_dtype(
        kv_dtype, dtype, allow_int8=False)
    P = num_pages + 1                                  # +1 dump page
    shape = (P, page_size, cfg.num_kv_heads, hd)
    pool = {"pk": torch.zeros(shape, dtype=pool_dtype, device=device),
            "pv": torch.zeros(shape, dtype=pool_dtype, device=device),
            "ppos": torch.full((P, page_size), -1, dtype=torch.int32,
                               device=device)}
    if quant:
        for key in ("pk_scale", "pv_scale"):
            pool[key] = torch.zeros(shape[:3], dtype=torch.float32,
                                    device=device)
    if spec.mixer == HYBRID:
        pool["ssm"], pool["conv"] = SSM.mamba_zero_state(
            cfg, max_slots, dtype, device=device)
    return pool


def paged_ring_len(window: Optional[int], page_size: int,
                   pages_per_slot: int) -> int:
    """Logical ring length (multiple of page_size) a layer writes into.
    Full attention uses the whole per-slot page range; windowed layers
    cycle through ceil((window+1)/page) logical pages."""
    if window is None:
        return pages_per_slot * page_size
    pages_w = -(-(window + 1) // page_size)
    return min(pages_w, pages_per_slot) * page_size


def _scatter(cache: dict, new: dict, phys, off, pos) -> None:
    """Write K/V rows ``new["k"/"v"]`` (..., H, D) and their positions at
    pool entries (phys, off), in place; an int8 pool stores the rows'
    codes and scales (:func:`quantize_kv`)."""
    for key, pool_key in (("k", "pk"), ("v", "pv")):
        pool = cache[pool_key]
        if pool_key + "_scale" in cache:
            q, sc = quantize_kv(new[key])
            pool[phys, off] = q
            cache[pool_key + "_scale"][phys, off] = sc
        else:
            pool[phys, off] = new[key].to(pool.dtype)
    cache["ppos"][phys, off] = pos.to(torch.int32)


def paged_write_prefill(cache: dict, new: dict, cache_pos, block_tables,
                        *, ring_len: int) -> dict:
    """Scatter whole prompts' K/V into their slots' pages, in place.

    new: {"k"/"v": (B, S, H, D)}; cache_pos: (B, S) absolute positions
    (-1 = padding); block_tables: (B, pages_per_slot) physical page ids
    (-1 = unallocated).  Only each row's last min(S, ring_len) valid
    tokens are written (a ring layer would otherwise write one entry
    twice); padding and unallocated pages go to the dump page."""
    page = cache["ppos"].shape[1]
    dump = cache["ppos"].shape[0] - 1
    B, S = cache_pos.shape
    take = min(S, ring_len)
    pos = cache_pos.long()
    dev = pos.device
    valid = (pos.amax(1) + 1).clamp_min(0)
    start = (valid - take).clamp(0, S - take)
    idx = start[:, None] + torch.arange(take, device=dev)[None, :]
    b_idx = torch.arange(B, device=dev)[:, None]
    pos_w = pos[b_idx, idx]                                    # (B, take)
    rp = torch.where(pos_w >= 0, pos_w % ring_len, 0)
    lp, off = rp // page, rp % page
    phys = torch.gather(block_tables.long(), 1, lp)
    ok = (pos_w >= 0) & (phys >= 0)
    phys = torch.where(ok, phys, dump)
    _scatter(cache, {key: new[key][b_idx, idx] for key in ("k", "v")},
             phys, off, torch.where(ok, pos_w, -1))
    return cache


def paged_write_decode(cache: dict, new: dict, lengths, block_tables,
                       active=None, *, ring_len: int) -> dict:
    """Write one token per slot at absolute position ``lengths`` (B,).
    Inactive slots (active == False) are routed to the dump page.
    ``new``: {"k"/"v": (B, 1, H, D)}.  Updates the pool in place."""
    page = cache["ppos"].shape[1]
    dump = cache["ppos"].shape[0] - 1
    lengths = lengths.long()
    B = lengths.shape[0]
    rp = lengths % ring_len
    lp, off = rp // page, rp % page
    phys = block_tables.long()[torch.arange(B, device=lengths.device), lp]
    ok = phys >= 0
    if active is not None:
        ok &= active
    phys = torch.where(ok, phys, dump)
    _scatter(cache, {key: new[key][:, 0] for key in ("k", "v")}, phys, off,
             torch.where(ok, lengths, -1))
    return cache


def paged_write_decode_multi(cache: dict, new: dict, lengths, block_tables,
                             active=None, *, ring_len: int) -> dict:
    """Write a window of K1 tokens per slot at absolute positions
    ``lengths[b] .. lengths[b] + K1 - 1``: a speculative verify window
    (the pending token and the drafts; rejected entries are rewound
    afterwards by :func:`paged_truncate`) or one prefill chunk.

    new: {"k"/"v": (B, K1, H, D)}; ``active``: (B,) or (B, K1) bool,
    masked entries go to the dump page.  Unlike the single-token write,
    positions at or beyond ``ring_len`` are dumped, never wrapped (a
    wrapped speculative write would overwrite live context that a
    rejection cannot restore).  Updates the pool in place."""
    page = cache["ppos"].shape[1]
    dump = cache["ppos"].shape[0] - 1
    K1 = new["k"].shape[1]
    pos = lengths.long()[:, None] + torch.arange(K1, device=lengths.device)
    ok = (pos >= 0) & (pos < ring_len)
    rp = torch.where(ok, pos, 0)
    lp, off = rp // page, rp % page
    phys = torch.gather(block_tables.long(), 1, lp)          # (B, K1)
    ok &= phys >= 0
    if active is not None:
        ok &= active if active.dim() == 2 else active[:, None]
    phys = torch.where(ok, phys, dump)
    _scatter(cache, new, phys, off, torch.where(ok, pos, -1))
    return cache


def paged_write_packed(cache: dict, new: dict, slot_ids, positions,
                       block_tables, *, ring_len: int) -> dict:
    """Scatter a token-packed stream's K/V: token t of the flat stream
    belongs to slot ``slot_ids[t]`` at absolute position ``positions[t]``
    and lands in that slot's pages via ``block_tables``.

    new: {"k"/"v": (1, T, H, D)}; slot_ids/positions: (T,) with -1 =
    padding lane.  Positions at or beyond ``ring_len`` are dumped, never
    wrapped.  Padding lanes, unallocated pages and out-of-range positions
    all route to the dump page.  Updates the pool in place.
    """
    page = cache["ppos"].shape[1]
    dump = cache["ppos"].shape[0] - 1
    B = block_tables.shape[0]
    slot_ids, positions = slot_ids.long(), positions.long()
    ok = (slot_ids >= 0) & (positions >= 0) & (positions < ring_len)
    rp = torch.where(ok, positions, 0)
    lp, off = rp // page, rp % page
    phys = block_tables.long()[slot_ids.clamp(0, B - 1), lp]      # (T,)
    ok &= phys >= 0
    phys = torch.where(ok, phys, dump)
    _scatter(cache, {key: new[key][0] for key in ("k", "v")}, phys, off,
             torch.where(ok, positions, -1))
    return cache


def paged_truncate(cache: dict, block_tables, keep_len) -> dict:
    """Rewind speculative writes: every entry of the slots' pages whose
    absolute position is ``>= keep_len[b]`` becomes empty (pos = -1).

    Only ``ppos`` is rewritten, in place; the K/V codes and int8 scales
    of rewound entries stay in the pools, unreachable once their
    positions are -1 (as :func:`reset_pages` leaves them).  Safe under
    sharing: a shared prefix page holds only positions below every
    sharer's ``keep_len``, so writing it back changes nothing, and rows
    of unallocated table entries land on the dump page, which is all -1
    already."""
    dump = cache["ppos"].shape[0] - 1
    bt = block_tables.long()
    safe = torch.where(bt >= 0, bt, dump)                    # (B, npages)
    pos = cache["ppos"][safe]                        # (B, npages, page)
    cache["ppos"][safe] = torch.where(
        pos < keep_len.to(pos.dtype)[:, None, None], pos, -1)
    return cache


def paged_truncate_all(cache: dict, block_tables, keep_len) -> dict:
    """:func:`paged_truncate` over every layer of a full model cache."""
    for c in cache["layers"]:
        paged_truncate(c, block_tables, keep_len)
    return cache


def paged_gather(cache: dict, block_tables):
    """Dense per-slot view of the pool: (B, pages*page, H, D) k/v plus
    (B, pages*page) positions.  Unallocated table entries read the dump
    page and are masked to pos = -1.  Int8 pools are dequantized (fp32
    out; callers cast to their compute dtype)."""
    dump = cache["ppos"].shape[0] - 1
    bt = block_tables.long()
    safe = torch.where(bt >= 0, bt, dump)
    k = cache["pk"][safe]                      # (B, pages, page, H, D)
    v = cache["pv"][safe]
    if "pk_scale" in cache:
        k = dequantize_kv(k, cache["pk_scale"][safe])
        v = dequantize_kv(v, cache["pv_scale"][safe])
    kp = torch.where((bt >= 0)[..., None], cache["ppos"][safe], -1)
    B, npg, page = kp.shape
    return (k.reshape(B, npg * page, *k.shape[3:]),
            v.reshape(B, npg * page, *v.shape[3:]),
            kp.reshape(B, npg * page))


def copy_pages(cache: dict, src, dst, keep_below) -> dict:
    """Copy-on-write clone: page ``dst[i]`` becomes a copy of ``src[i]``
    with only the entries at absolute positions ``0 <= pos <
    keep_below[i]`` kept valid (the rest are masked to pos = -1).  Rows
    may be padded with src = dst = dump, keep_below = 0.  In place."""
    src, dst = src.long(), dst.long()
    pos = cache["ppos"][src]                             # (N, page)
    keep = (pos >= 0) & (pos < keep_below[:, None])
    data = {k: cache[k][src] for k in PAGED_DATA_KEYS
            if k in cache}                               # read before write
    cache["ppos"][dst] = torch.where(keep, pos, -1)
    for k, v in data.items():
        cache[k][dst] = v
    return cache


def copy_pages_all(cache: dict, src, dst, keep_below) -> dict:
    """:func:`copy_pages` over every layer of a full model cache."""
    for c in cache["layers"]:
        copy_pages(c, src, dst, keep_below)
    return cache


def reset_pages(cache: dict, pages) -> dict:
    """Mark freshly (re)allocated physical pages empty (``pages`` may be
    padded with the dump page id).  Only ``ppos`` needs clearing: stale
    K/V from a page's previous owner is unreachable once its positions
    are -1.  Layers without a pool (recurrent state) are left alone.  In
    place."""
    if "ppos" in cache:
        cache["ppos"][pages.long()] = -1
    return cache


def reset_pages_all(cache: dict, pages) -> dict:
    """:func:`reset_pages` over every layer of a full model cache."""
    for c in cache["layers"]:
        reset_pages(c, pages)
    return cache


def slot_view(cache: dict, n_view: int) -> dict:
    """An ``n_view``-slot working view of a persistent model cache for an
    admission prefill: paged pool tensors pass through (shared, indexed
    through block tables); every per-slot tensor comes back as ``n_view``
    fresh empty rows, zeros and, for an MLA latent cache's positions, -1,
    so an admitted request always starts from clean state and never sees
    a phantom key at position 0."""
    def fresh(k, v):
        shape = (n_view,) + v.shape[1:]
        if k == "pos":
            return torch.full(shape, -1, dtype=v.dtype, device=v.device)
        return torch.zeros(shape, dtype=v.dtype, device=v.device)
    return {"layers": [
        {k: (v if k in PAGED_KEYS else fresh(k, v)) for k, v in c.items()}
        for c in cache["layers"]]}


def slot_merge(cache: dict, view: dict, slots) -> dict:
    """Scatter the per-slot state of a :func:`slot_view` (after its
    prefill) into the persistent cache's rows ``slots`` (n_view,), in
    place."""
    idx = slots.long()
    for c, vv in zip(cache["layers"], view["layers"]):
        for k in c:
            if k not in PAGED_KEYS:
                c[k][idx] = vv[k].to(c[k].dtype)
    return cache


# -- host-memory offload / restore: the overload escape valve ---------------
#
# Under pool pressure the scheduler preempts a slot: its pages' bytes move
# to host memory (``offload_pages``) so that the device pages can be freed,
# and move back verbatim (``restore_pages``) when the request is
# re-admitted; decode then resumes where it stopped, with no recompute.
# The same two functions back the prefix cache's host spill tier.


def _page_index(cache: dict, pages) -> torch.Tensor:
    dev = next(c["ppos"].device for c in cache["layers"] if "ppos" in c)
    return torch.as_tensor(np.asarray(pages, np.int64), device=dev)


def offload_pages(cache: dict, pages) -> list:
    """Snapshot the full contents of physical ``pages`` to host memory.

    Returns a blob with one entry per layer: ``{leaf key: CPU tensor}``
    over every paged leaf (K/V codes, the int8 scale pools, positions:
    ``PAGED_KEYS``) for a paged layer, ``None`` for a layer of dense
    per-slot state.  From a pool on the card each leaf is gathered there
    and copied into pinned host memory; the function waits on an event
    recorded after the last copy, so the blob is complete when it
    returns and the pages may be freed and rewritten at once.
    """
    idx = _page_index(cache, pages)
    blob = []
    for c in cache["layers"]:
        if "ppos" not in c:
            blob.append(None)
            continue
        row = {}
        for k in PAGED_KEYS:
            if k not in c:
                continue
            rows = c[k].index_select(0, idx)
            if rows.is_cuda:
                host = torch.empty(rows.shape, dtype=rows.dtype,
                                   pin_memory=True)
                host.copy_(rows, non_blocking=True)
                rows = host
            row[k] = rows
        blob.append(row)
    if idx.is_cuda:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    return blob


def restore_pages(cache: dict, blob: list, pages) -> dict:
    """Scatter an :func:`offload_pages` blob into physical ``pages`` (any
    pages: a restore need not land where the snapshot was taken), in
    place.  Every paged leaf row of those pages is overwritten, so no
    prior :func:`reset_pages` is needed.  On the card each leaf is copied
    from pinned memory without blocking, on the current stream, and
    scattered on the same stream; PyTorch's pinned-memory allocator keeps
    the host block from reuse until its copy has run, so the caller may
    drop the blob at once."""
    idx = _page_index(cache, pages)
    if len(blob) != len(cache["layers"]):
        raise ValueError(f"blob has {len(blob)} layers, the cache "
                         f"{len(cache['layers'])}")
    for c, b in zip(cache["layers"], blob):
        if b is None:
            continue
        for k, rows in b.items():
            if rows.shape[0] != idx.shape[0]:
                raise ValueError(f"blob holds {rows.shape[0]} pages, "
                                 f"restoring into {idx.shape[0]}")
            c[k][idx] = rows.to(c[k].device, non_blocking=True)
    return cache


def blob_bytes(blob: list) -> int:
    """Host bytes an :func:`offload_pages` blob occupies (what the
    byte-budgeted host tier accounts against its capacity)."""
    return sum(t.numel() * t.element_size() for d in blob if d
               for t in d.values())
