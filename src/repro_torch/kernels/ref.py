"""Plain PyTorch versions of the port's kernels (the counterparts of
``repro.kernels.ref``): the CPU path of every kernel wrapper and the
target each CUDA kernel is held against on the card."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.3819763e38


def _mask(q_pos, k_pos, window):
    m = (k_pos[:, None, :] <= q_pos[:, :, None]) & (k_pos[:, None, :] >= 0)
    if window is not None:
        m &= k_pos[:, None, :] > (q_pos[:, :, None] - window)
    return m


def flash_attention_ref(q, k, v, q_pos, k_pos, *, window: Optional[int],
                        scale: float, attn_softcap: Optional[float] = None):
    """q: (B,Sq,Hq,D), k/v: (B,Sk,Hkv,D) -> (B,Sq,Hq,Dv)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, g, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if attn_softcap is not None:
        logits = torch.tanh(logits / attn_softcap) * attn_softcap
    mask = _mask(q_pos, k_pos, window)
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask.any(-1)[:, None, None, :, None], p, 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def decode_attention_ref(q, k, v, k_pos, q_pos, *, window: Optional[int],
                         scale: float, attn_softcap: Optional[float] = None):
    """q: (B,1,Hq,D) vs cache k/v: (B,Sk,Hkv,D) -> (B,1,Hq,Dv)."""
    return flash_attention_ref(q, k, v, q_pos, k_pos, window=window,
                               scale=scale, attn_softcap=attn_softcap)


def _pool(kpool, vpool, ppos, k_scale, v_scale):
    pool = {"pk": kpool, "pv": vpool, "ppos": ppos}
    if k_scale is not None:
        pool["pk_scale"], pool["pv_scale"] = k_scale, v_scale
    return pool


def paged_decode_attention_ref(q, kpool, vpool, ppos, block_tables, q_pos,
                               *, window: Optional[int], scale: float,
                               attn_softcap: Optional[float] = None,
                               k_scale=None, v_scale=None):
    """Plain version of the paged decode kernel: resolve each slot's block
    table into a contiguous (B, npages*page, ...) view
    (``kv_cache.paged_gather``), then run the dense decode reference.
    With ``k_scale``/``v_scale`` the pools hold int8 codes and the gather
    dequantizes them (the plain version of the ``_q8`` kernel)."""
    from repro_torch.core.kv_cache import paged_gather
    k, v, kp = paged_gather(_pool(kpool, vpool, ppos, k_scale, v_scale),
                            block_tables)
    return decode_attention_ref(q, k.to(q.dtype), v.to(q.dtype), kp, q_pos,
                                window=window, scale=scale,
                                attn_softcap=attn_softcap)


def paged_mixed_attention_ref(q, kpool, vpool, ppos, block_tables, q_pos,
                              *, window: Optional[int], scale: float,
                              attn_softcap: Optional[float] = None,
                              k_scale=None, v_scale=None):
    """Plain version of the multi-query paged kernel: q (B, W, Hq, D), lane
    w of row b a query of slot b at position ``q_pos[b, w]`` (-1 = padding
    lane, output zero), over either pool type (int8 pools dequantize in
    the gather).  The window's own K/V are already in the pool, so the
    stored positions give each lane its causal mask.  The single-query
    version is its W == 1 case, and it is exactly that computation."""
    return paged_decode_attention_ref(
        q, kpool, vpool, ppos, block_tables, q_pos, window=window,
        scale=scale, attn_softcap=attn_softcap, k_scale=k_scale,
        v_scale=v_scale)


def paged_packed_attention_ref(q, kpool, vpool, ppos, block_tables, q_pos,
                               slot_ids, *, window: Optional[int],
                               scale: float,
                               attn_softcap: Optional[float] = None,
                               k_scale=None, v_scale=None):
    """Plain version of the token-packed ragged kernel: q (1, T, Hq, D)
    is one flat stream where token t belongs to slot ``slot_ids[t]`` and
    attends that slot's paged history only.  Gathers each slot's pages
    densely once (dequantizing int8 pools, as above), then runs every
    stream token as its own single-query attention against its slot's
    gathered context.  Padding lanes (slot_ids == -1) come back as
    zeros."""
    from repro_torch.core.kv_cache import paged_gather
    k, v, kp = paged_gather(_pool(kpool, vpool, ppos, k_scale, v_scale),
                            block_tables)                 # (B, ctx, H, D)
    B = block_tables.shape[0]
    _, T, Hq, _ = q.shape
    sid = slot_ids.reshape(T).long()
    safe = sid.clamp(0, B - 1)
    kp_t = torch.where((sid >= 0)[:, None], kp[safe], -1)
    out = decode_attention_ref(
        q.reshape(T, 1, Hq, -1), k[safe].to(q.dtype), v[safe].to(q.dtype),
        kp_t, q_pos.reshape(T, 1), window=window, scale=scale,
        attn_softcap=attn_softcap)
    return out.reshape(1, T, Hq, -1)


def quant_matmul_ref(x, q, s):
    """Plain version of the weight-only int8 matmul: x (..., K) @ int8
    codes q (K, N), accumulated in fp32, times the per-output-channel fp32
    scales s (N,) once per output (``x @ (q * s) == (x @ q) * s`` column
    by column).  Returns fp32 (..., N)."""
    return (x.float() @ q.float()) * s.float()
