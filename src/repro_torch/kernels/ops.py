"""Device dispatch for the port's kernels.

There is no mode switch: a tensor on the CPU goes to the kernel's plain
PyTorch version, and any other tensor goes to the CUDA kernel's wrapper,
which launches the kernel or raises (wrong device, dtype, layout or an
unsupported shape).  Nothing falls back to the plain version on the card.
Attention over an int8 pool (``k_scale``/``v_scale`` given) goes to the
``_q8`` kernels.  Each wrapper counts its launches; :func:`launch_counts`
reads them all.

Training: on the CPU the plain versions are differentiated by autograd.
On the card, with grad enabled and an input that requires it,
``flash_attention`` runs :class:`FlashAttentionFn`, ``mlstm_chunked``
:class:`MlstmChunkedFn` and ``ragged_matmul`` :class:`RaggedMatmulFn`,
whose backwards are hand-written kernels; every
other kernel here (the paged and dense decode attention, ``quant_matmul``,
``fused_rmsnorm``) has no backward, so its dispatcher raises in that case
(:func:`no_backward`) rather than return a tensor that silently carries
no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mlstm_chunk as MC
from repro_torch.kernels import quant_matmul as QM
from repro_torch.kernels import ragged_matmul as RM
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as RN


# set by the dry run's op analysis (``launch.op_analysis``) while it
# counts: it then runs a kernel's plain version as one op, as the kernel
kernel_scope = None


def _plain(name: str, fn, *args, **kwargs):
    """A kernel's plain version on CPU tensors."""
    if kernel_scope is None:
        return fn(*args, **kwargs)
    return kernel_scope(name, fn, *args, **kwargs)


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on these tensors (None
    entries are skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def no_backward(name: str, *tensors) -> None:
    """Raise for a kernel without a backward reached with grad enabled and
    an input that requires it: its output would carry no gradient."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"the CUDA kernel {name} has no backward: it cannot be "
            f"differentiated on the card (run under torch.no_grad, or on "
            f"the CPU, where the plain version is differentiable)")


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention on the card with a gradient: the forward kernel
    (keeping its log-sum-exp), and the backward kernel
    (:func:`flash_attention.flash_attention_bwd`) for dq, dk and dv; the
    positions take none."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, window, scale, attn_softcap):
        out, lse = FA.flash_attention(q, k, v, q_pos, k_pos, window=window,
                                      scale=scale, attn_softcap=attn_softcap,
                                      return_lse=True)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, lse)
        ctx.kw = dict(window=window, scale=scale, attn_softcap=attn_softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, k_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = FA.flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse,
                                            do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


class MlstmChunkedFn(torch.autograd.Function):
    """The chunkwise mLSTM on the card with a gradient: the forward kernel
    (keeping the state at every chunk's start) and the backward kernel
    (:func:`mlstm_chunk.mlstm_chunked_bwd`) for q, k, v, i_pre and logf.
    Outputs h and the final C, n, m.  Only h's gradient is taken: a
    cotangent that reaches the final state, or an initial state that
    requires grad, raises.  Training never does either: every train step
    (``transformer.forward_train`` through ``_recurrent_apply``, as the
    reference's ``_layer_apply`` in "train" mode) starts each mLSTM layer
    from ``ssm.mlstm_zero_state`` and drops its final state.  Unused
    cotangents arrive as None (``set_materialize_grads(False)``), so
    telling them apart reads no tensor on the card."""

    @staticmethod
    def forward(ctx, q, k, v, i_pre, logf, C0, n0, m0):
        h, final, states = MC.mlstm_chunked(
            q, k, v, i_pre, logf, {"C": C0, "n": n0, "m": m0},
            return_states=True)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, i_pre, logf, states["C"],
                              states["n"], states["m"], h)
        return h, final["C"], final["n"], final["m"]

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        if any(ctx.needs_input_grad[5:]):
            raise NotImplementedError(
                "the CUDA kernel mlstm_chunked_bwd takes no gradient of the "
                "initial state (C, n, m): train from the zero state, as "
                "forward_train does")
        if dC is not None or dn is not None or dm is not None:
            raise NotImplementedError(
                "the CUDA kernel mlstm_chunked_bwd takes no cotangent of the "
                "final state (C, n, m): only h may be differentiated")
        if dh is None:
            return (None,) * 8
        q, k, v, i_pre, logf, Cs, ns, ms, h = ctx.saved_tensors
        grads = MC.mlstm_chunked_bwd(q, k, v, i_pre, logf,
                                     {"C": Cs, "n": ns, "m": ms}, h,
                                     dh.contiguous())
        return (*grads, None, None, None)


class RaggedMatmulFn(torch.autograd.Function):
    """The grouped product on the card with a gradient: the forward kernel
    and :func:`ragged_matmul.ragged_matmul_bwd` (the same kernel reading w
    transposed for rows, a kernel over w's tiles for w); the group sizes
    take none."""

    @staticmethod
    def forward(ctx, rows, w, sizes):
        ctx.save_for_backward(rows, w, sizes)
        return RM.ragged_matmul(rows, w, sizes)

    @staticmethod
    def backward(ctx, dout):
        rows, w, sizes = ctx.saved_tensors
        drows, dw = RM.ragged_matmul_bwd(
            rows, w, sizes, dout.contiguous(),
            need_rows=ctx.needs_input_grad[0],
            need_w=ctx.needs_input_grad[1])
        return drows, dw, None


def paged_decode_attention(q, kpool, vpool, ppos, block_tables, q_pos, *,
                           window, scale, attn_softcap=None, k_scale=None,
                           v_scale=None):
    """Single-query paged attention: q (B,1,Hq,D) against each slot's
    pages; see :func:`decode_attention.paged_decode_attention`."""
    kw = dict(window=window, scale=scale, attn_softcap=attn_softcap)
    if q.device.type == "cpu":
        return _plain(
            "paged_decode_attention", ref.paged_decode_attention_ref, q,
            kpool, vpool, ppos, block_tables, q_pos, k_scale=k_scale,
            v_scale=v_scale, **kw)
    no_backward("paged_decode_attention", q, kpool, vpool, k_scale, v_scale)
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
        return _plain(
            "paged_mixed_attention", ref.paged_mixed_attention_ref, q,
            kpool, vpool, ppos, block_tables, q_pos, k_scale=k_scale,
            v_scale=v_scale, **kw)
    no_backward("paged_mixed_attention", q, kpool, vpool, k_scale, v_scale)
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
        return _plain(
            "paged_packed_attention", ref.paged_packed_attention_ref, q,
            kpool, vpool, ppos, block_tables, q_pos, slot_ids,
            k_scale=k_scale, v_scale=v_scale, **kw)
    no_backward("paged_packed_attention", q, kpool, vpool, k_scale, v_scale)
    if k_scale is not None:
        return DA.paged_packed_attention_q8(
            q, kpool, k_scale, vpool, v_scale, ppos, block_tables, q_pos,
            meta, **kw)
    return DA.paged_packed_attention(q, kpool, vpool, ppos, block_tables,
                                     q_pos, meta, **kw)


def flash_attention(q, k, v, q_pos, k_pos, *, window, scale,
                    attn_softcap=None):
    """Dense attention driven by positions: q (B,Sq,Hq,D) against k/v
    (B,Sk,Hkv,D); see :func:`flash_attention.flash_attention`.  On the
    card with grad enabled and an input requiring it, through
    :class:`FlashAttentionFn` (forward and backward kernels)."""
    kw = dict(window=window, scale=scale, attn_softcap=attn_softcap)
    if q.device.type == "cpu":
        return _plain("flash_attention", ref.flash_attention_ref, q, k, v,
                      q_pos, k_pos, **kw)
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, q_pos, k_pos, window, scale,
                                      attn_softcap)
    return FA.flash_attention(q, k, v, q_pos, k_pos, **kw)


def quant_matmul(x, q, s):
    """``(x @ q) * s`` in fp32 for int8 weight records; see
    :func:`quant_matmul.quant_matmul`."""
    if x.device.type == "cpu":
        return _plain("quant_matmul", ref.quant_matmul_ref, x, q, s)
    no_backward("quant_matmul", x, s)
    return QM.quant_matmul(x, q, s)


def ragged_matmul(rows, w, sizes):
    """Grouped product: rows (R, K) sorted by group, group e's ``sizes[e]``
    rows times w[e] (K, N) -> (R, N) at rows' dtype; see
    :func:`ragged_matmul.ragged_matmul`.  On the card with grad enabled and
    rows or w requiring it, through :class:`RaggedMatmulFn`."""
    if rows.device.type == "cpu":
        return _plain("ragged_matmul", ref.ragged_matmul_ref, rows, w,
                      sizes)
    if needs_grad(rows, w):
        return RaggedMatmulFn.apply(rows, w, sizes)
    return RM.ragged_matmul(rows, w, sizes)


def mlstm_chunked(q, k, v, i_pre, logf, state):
    """Chunkwise stabilised mLSTM over a whole sequence: (h (B,S,H,dh)
    fp32, final state); see :func:`mlstm_chunk.mlstm_chunked`.  On the
    card with grad enabled and an input requiring it, through
    :class:`MlstmChunkedFn` (forward and backward kernels)."""
    if q.device.type == "cpu":
        return _plain("mlstm_chunked", ref.mlstm_chunked_ref, q, k, v,
                      i_pre, logf, state)
    if needs_grad(q, k, v, i_pre, logf, *state.values()):
        h, C, n, m = MlstmChunkedFn.apply(q, k, v, i_pre, logf, state["C"],
                                          state["n"], state["m"])
        return h, {"C": C, "n": n, "m": m}
    return MC.mlstm_chunked(q, k, v, i_pre, logf, state)


def rmsnorm(x, w, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` at x's dtype; see
    :func:`rmsnorm.fused_rmsnorm`.  No model code calls it (as in the
    reference)."""
    if x.device.type == "cpu":
        return _plain("rmsnorm", ref.rmsnorm_ref, x, w, eps)
    no_backward("fused_rmsnorm", x, w)
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
        return _plain("decode_attention", ref.decode_attention_ref, q, k,
                      v, k_pos, q_pos, **kw)
    no_backward("decode_attention", q, k, v)
    return DA.decode_attention(q, k, v, k_pos, q_pos, **kw)


_SINGLE = (FA.flash_attention, FA.flash_attention_bwd, QM.quant_matmul,
           MC.mlstm_chunked, MC.mlstm_chunked_bwd, RN.fused_rmsnorm,
           RM.ragged_matmul, RM.ragged_matmul_bwd)


def reset_launch_counts() -> None:
    DA.reset_launch_counts()
    for k in _SINGLE:
        k.launches = 0


def launch_counts() -> dict:
    """Launches of every kernel of the port since the last reset."""
    return {**DA.launch_counts(), **{k.__name__: k.launches
                                     for k in _SINGLE}}
