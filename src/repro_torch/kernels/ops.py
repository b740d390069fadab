"""Device dispatch for the port's kernels.

There is no mode switch: a tensor on the CPU goes to the kernel's plain
PyTorch version, and any other tensor goes to the CUDA kernel's wrapper,
which launches the kernel or raises (wrong device, dtype, layout or an
unsupported shape).  Nothing falls back to the plain version on the card.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ref


def paged_decode_attention(q, kpool, vpool, ppos, block_tables, q_pos, *,
                           window, scale, attn_softcap=None):
    """Single-query paged attention: q (B,1,Hq,D) against each slot's
    pages; see :func:`decode_attention.paged_decode_attention`."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(
            q, kpool, vpool, ppos, block_tables, q_pos, window=window,
            scale=scale, attn_softcap=attn_softcap)
    return DA.paged_decode_attention(
        q, kpool, vpool, ppos, block_tables, q_pos, window=window,
        scale=scale, attn_softcap=attn_softcap)


def paged_packed_attention(q, kpool, vpool, ppos, block_tables, q_pos,
                           slot_ids, meta, *, window, scale,
                           attn_softcap=None):
    """Token-packed ragged paged attention: q (1,T,Hq,D) as one flat
    stream; the plain version reads ``slot_ids``, the kernel walks the
    ``meta`` work table (:func:`decode_attention.packed_meta_table`)."""
    if q.device.type == "cpu":
        return ref.paged_packed_attention_ref(
            q, kpool, vpool, ppos, block_tables, q_pos, slot_ids,
            window=window, scale=scale, attn_softcap=attn_softcap)
    return DA.paged_packed_attention(
        q, kpool, vpool, ppos, block_tables, q_pos, meta, window=window,
        scale=scale, attn_softcap=attn_softcap)
