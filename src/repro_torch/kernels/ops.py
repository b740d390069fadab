"""Device dispatch for the port's kernels.

There is no mode switch: a tensor on the CPU goes to the kernel's plain
PyTorch version, and any other tensor goes to the CUDA kernel's wrapper,
which launches the kernel or raises (wrong device, dtype, layout or an
unsupported shape).  Nothing falls back to the plain version on the card.
Attention over an int8 pool (``k_scale``/``v_scale`` given) goes to the
``_q8`` kernels.  Each wrapper counts its launches; :func:`launch_counts`
reads them all.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mlstm_chunk as MC
from repro_torch.kernels import quant_matmul as QM
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as RN


def paged_decode_attention(q, kpool, vpool, ppos, block_tables, q_pos, *,
                           window, scale, attn_softcap=None, k_scale=None,
                           v_scale=None):
    """Single-query paged attention: q (B,1,Hq,D) against each slot's
    pages; see :func:`decode_attention.paged_decode_attention`."""
    kw = dict(window=window, scale=scale, attn_softcap=attn_softcap)
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(
            q, kpool, vpool, ppos, block_tables, q_pos, k_scale=k_scale,
            v_scale=v_scale, **kw)
    if k_scale is not None:
        return DA.paged_decode_attention_q8(
            q, kpool, k_scale, vpool, v_scale, ppos, block_tables, q_pos,
            **kw)
    return DA.paged_decode_attention(q, kpool, vpool, ppos, block_tables,
                                     q_pos, **kw)


def paged_mixed_attention(q, kpool, vpool, ppos, block_tables, q_pos, *,
                          window, scale, attn_softcap=None, k_scale=None,
                          v_scale=None):
    """Multi-query paged attention: q (B,W,Hq,D), a window of W lanes per
    slot (-1 positions are padding lanes); see
    :func:`decode_attention.paged_mixed_attention`."""
    kw = dict(window=window, scale=scale, attn_softcap=attn_softcap)
    if q.device.type == "cpu":
        return ref.paged_mixed_attention_ref(
            q, kpool, vpool, ppos, block_tables, q_pos, k_scale=k_scale,
            v_scale=v_scale, **kw)
    if k_scale is not None:
        return DA.paged_mixed_attention_q8(
            q, kpool, k_scale, vpool, v_scale, ppos, block_tables, q_pos,
            **kw)
    return DA.paged_mixed_attention(q, kpool, vpool, ppos, block_tables,
                                    q_pos, **kw)


def paged_packed_attention(q, kpool, vpool, ppos, block_tables, q_pos,
                           slot_ids, meta, *, window, scale,
                           attn_softcap=None, k_scale=None, v_scale=None):
    """Token-packed ragged paged attention: q (1,T,Hq,D) as one flat
    stream; the plain version reads ``slot_ids``, the kernel walks the
    ``meta`` work table (:func:`decode_attention.packed_meta_table`)."""
    kw = dict(window=window, scale=scale, attn_softcap=attn_softcap)
    if q.device.type == "cpu":
        return ref.paged_packed_attention_ref(
            q, kpool, vpool, ppos, block_tables, q_pos, slot_ids,
            k_scale=k_scale, v_scale=v_scale, **kw)
    if k_scale is not None:
        return DA.paged_packed_attention_q8(
            q, kpool, k_scale, vpool, v_scale, ppos, block_tables, q_pos,
            meta, **kw)
    return DA.paged_packed_attention(q, kpool, vpool, ppos, block_tables,
                                     q_pos, meta, **kw)


def flash_attention(q, k, v, q_pos, k_pos, *, window, scale,
                    attn_softcap=None):
    """Dense attention driven by positions: q (B,Sq,Hq,D) against k/v
    (B,Sk,Hkv,D); see :func:`flash_attention.flash_attention`."""
    kw = dict(window=window, scale=scale, attn_softcap=attn_softcap)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, q_pos, k_pos, **kw)
    return FA.flash_attention(q, k, v, q_pos, k_pos, **kw)


def quant_matmul(x, q, s):
    """``(x @ q) * s`` in fp32 for int8 weight records; see
    :func:`quant_matmul.quant_matmul`."""
    if x.device.type == "cpu":
        return ref.quant_matmul_ref(x, q, s)
    return QM.quant_matmul(x, q, s)


def mlstm_chunked(q, k, v, i_pre, logf, state):
    """Chunkwise stabilised mLSTM over a whole sequence: (h (B,S,H,dh)
    fp32, final state); see :func:`mlstm_chunk.mlstm_chunked`."""
    if q.device.type == "cpu":
        return ref.mlstm_chunked_ref(q, k, v, i_pre, logf, state)
    return MC.mlstm_chunked(q, k, v, i_pre, logf, state)


def rmsnorm(x, w, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` at x's dtype; see
    :func:`rmsnorm.fused_rmsnorm`.  No model code calls it (as in the
    reference)."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps)
    return RN.fused_rmsnorm(x, w, eps=eps)


def decode_attention(q, k, v, k_pos, q_pos, *, window, scale,
                     attn_softcap=None):
    """Single-query attention against a contiguous cache: q (B,1,Hq,D)
    vs k/v (B,Sk,Hkv,D); see :func:`decode_attention.decode_attention`.
    The dense decode step of ``generate_batch`` calls it
    (``layers.mha_attention`` with one query against the dense cache),
    where the reference computes the same function in plain jnp."""
    kw = dict(window=window, scale=scale, attn_softcap=attn_softcap)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, k_pos, q_pos, **kw)
    return DA.decode_attention(q, k, v, k_pos, q_pos, **kw)


_SINGLE = (FA.flash_attention, QM.quant_matmul, MC.mlstm_chunked,
           RN.fused_rmsnorm)


def reset_launch_counts() -> None:
    DA.reset_launch_counts()
    for k in _SINGLE:
        k.launches = 0


def launch_counts() -> dict:
    """Launches of every kernel of the port since the last reset."""
    return {**DA.launch_counts(), **{k.__name__: k.launches
                                     for k in _SINGLE}}
