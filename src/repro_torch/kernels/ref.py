"""Plain PyTorch versions of the port's kernels (the counterparts of
``repro.kernels.ref``): the CPU path of every kernel wrapper and the
target each CUDA kernel is held against on the card."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -2.3819763e38
MLSTM_CHUNK = 128      # the reference oracle's chunk length


def _mask(q_pos, k_pos, window):
    m = (k_pos[:, None, :] <= q_pos[:, :, None]) & (k_pos[:, None, :] >= 0)
    if window is not None:
        m &= k_pos[:, None, :] > (q_pos[:, :, None] - window)
    return m


def flash_attention_ref(q, k, v, q_pos, k_pos, *, window: Optional[int],
                        scale: float, attn_softcap: Optional[float] = None):
    """q: (B,Sq,Hq,D), k/v: (B,Sk,Hkv,D) -> (B,Sq,Hq,Dv).  Scores and
    probabilities in fp32, as ``repro.kernels.ref.flash_attention_ref``;
    the reference's model path at its default precision (``attn_bf16``)
    and the tensor-core kernels round the probabilities to v's dtype
    before the product with v, so at bf16 / fp16 they differ from this by
    up to one unit of the output's type (the kernels are held to it at
    2e-2)."""
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


def _scores(q, k, q_pos, k_pos, window, scale, attn_softcap):
    """fp32 scores (B, Hkv, g, Sq, Sk) of q (B,Sq,Hq,D) against k, softcapped
    where asked, with tanh(s / cap) (None without a softcap), and the
    visibility mask (B, 1, 1, Sq, Sk)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    t = None
    if attn_softcap is not None:
        t = torch.tanh(s / attn_softcap)
        s = t * attn_softcap
    return s, t, _mask(q_pos, k_pos, window)[:, None, None]


def flash_attention_lse_ref(q, k, v, q_pos, k_pos, *,
                            window: Optional[int], scale: float,
                            attn_softcap: Optional[float] = None):
    """The forward with what its backward keeps: (out (B,Sq,Hq,Dv) at q's
    dtype, lse (B,Hq,Sq) fp32), lse the log-sum-exp of each row's visible
    scores, +inf for a row that sees no key (so that ``exp(s - lse)`` is
    exactly 0 there)."""
    s, _, mask = _scores(q, k, q_pos, k_pos, window, scale, attn_softcap)
    lse = torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1)
    lse = torch.where(mask.any(-1), lse, torch.inf)
    out = flash_attention_ref(q, k, v, q_pos, k_pos, window=window,
                              scale=scale, attn_softcap=attn_softcap)
    B, Sq, Hq, _ = q.shape
    return out, lse.reshape(B, Hq, Sq)


def flash_attention_bwd_ref(q, k, v, q_pos, k_pos, o, lse, do, *,
                            window: Optional[int], scale: float,
                            attn_softcap: Optional[float] = None):
    """Plain backward of :func:`flash_attention_ref` from what the forward
    kernel keeps (o and lse (B,Hq,Sq)) and the output's gradient do
    (B,Sq,Hq,Dv), in fp32: P = exp(S - lse) on visible entries (0 on
    masked ones and on rows that see no key), D = rowsum(dO o),
    dP = dO V^T, dS = P (dP - D), times 1 - tanh^2(s / cap) under a
    softcap and the scale; dQ = dS K, dK = dS^T Q and dV = P^T dO, the
    last two summed over the g query heads of each kv head.  Returns
    (dq, dk, dv) at q's, k's and v's dtypes."""
    B, Sq, Hq, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    g = Hq // Hkv
    s, t, mask = _scores(q, k, q_pos, k_pos, window, scale, attn_softcap)
    lse_g = lse.float().reshape(B, Hkv, g, Sq, 1)
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    dof = do.float().reshape(B, Sq, Hkv, g, Dv)
    delta = (dof * o.float().reshape(B, Sq, Hkv, g, Dv)).sum(-1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    qg = q.reshape(B, Sq, Hkv, g, D).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def ragged_matmul_ref(rows, w, sizes):
    """Plain version of the grouped product (``jax.lax.ragged_dot``): rows
    (R, K) sorted by group, group e owning the ``sizes[e]`` (E,) rows after
    those of the groups before it, each times w[e] (K, N); rows past the
    last group are zeros.  Returns (R, N) at rows' dtype.  It reads the
    sizes on the host and runs a product an expert, so it serves the CPU
    and the tests; autograd gives its gradients."""
    R, N = rows.shape[0], w.shape[2]
    ends = torch.cumsum(sizes.long().clamp(0, R), 0).clamp(max=R).tolist()
    pieces, start = [], 0
    for e, end in enumerate(ends):
        if end > start:
            pieces.append(rows[start:end] @ w[e])
            start = end
    if start < R:
        pieces.append(rows.new_zeros(R - start, N))
    return torch.cat(pieces) if pieces else rows.new_zeros(R, N)


def rmsnorm_ref(x, w, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` over the last dim, in
    fp32, returned at x's dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def mlstm_chunked_ref(q, k, v, i_pre, logf, state, *,
                      chunk: int = MLSTM_CHUNK, return_states: bool = False):
    """Chunkwise-parallel stabilised mLSTM (the reference's
    ``ssm.mlstm_chunked``).

    q, k, v: (B,S,H,dh); i_pre / logf: (B,S,H) fp32 input-gate
    pre-activations and log forget gates; state: {"C": (B,H,dh,dh),
    "n": (B,H,dh), "m": (B,H)} fp32.  The sequence is cut into chunks of
    ``chunk`` steps (the last one padded with no-op steps: forget 1,
    input -1e30); inside a chunk, L x L decay-weighted scores, across
    chunks the carried state.  The stabiliser m is a running max over the
    same terms however the sequence is cut, so every chunk length gives
    the same result up to fp32 rounding.  Returns h (B,S,H,dh) fp32 and
    the final state; with ``return_states`` also the state at the start of
    every chunk, {"C": (B,H,NC,dh,dh), "n": (B,H,NC,dh), "m": (B,H,NC)}
    (what :func:`mlstm_chunked_bwd_ref` takes).  It computes in fp32, or
    in fp64 where the gates are fp64 (with every other input: the
    kernel's fp32 accuracy is held against that on the card)."""
    B, S, H, dh = q.shape
    pad = (-S) % chunk
    acc = torch.float64 if i_pre.dtype == torch.float64 else torch.float32
    qf, kf, vf = (F.pad(t.to(acc), (0, 0, 0, 0, 0, pad))
                  for t in (q, k, v))
    ig = F.pad(i_pre.to(acc), (0, 0, 0, pad), value=-1e30)
    lf = F.pad(logf.to(acc), (0, 0, 0, pad), value=0.0)
    tri = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=q.device).tril()
    C, n, m = state["C"], state["n"], state["m"]
    hs, starts = [], []
    for c0 in range(0, S + pad, chunk):
        starts.append((C, n, m))
        qb, kb, vb, ib, fb = (t[:, c0:c0 + chunk]
                              for t in (qf, kf, vf, ig, lf))
        Fc = torch.cumsum(fb, dim=1)                             # (B,L,H)
        Ftot = Fc[:, -1]                                         # (B,H)
        Ft = Fc.transpose(1, 2)                                  # (B,H,L)
        # intra-chunk log weights F_i - F_j + i_j (j <= i)      (B,H,L,L)
        logw = Ft[..., :, None] - Ft[..., None, :] \
            + ib.transpose(1, 2)[..., None, :]
        logw = torch.where(tri, logw, -torch.inf)
        logst = Ft + m[..., None]              # state path F_i + m_prev
        m_i = torch.maximum(logw.amax(-1), logst)
        m_i = torch.where(torch.isfinite(m_i), m_i, 0.0)
        w = torch.exp(logw - m_i[..., None])
        st_w = torch.exp(logst - m_i)
        scores = torch.einsum("blhd,bmhd->bhlm", qb, kb) * w
        num = (torch.einsum("bhlm,bmhd->bhld", scores, vb)
               + st_w[..., None] * torch.einsum("blhd,bhde->bhle", qb, C))
        den = scores.sum(-1) + st_w * torch.einsum("blhd,bhd->bhl", qb, n)
        h = num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None]
        hs.append(h.transpose(1, 2))                             # (B,L,H,dh)
        # state to the chunk's end
        m_new = torch.maximum(m + Ftot, (Ftot[:, None] - Fc + ib).amax(1))
        decay = torch.exp(m + Ftot - m_new)                      # (B,H)
        wk = torch.exp(Ftot[:, None] - Fc + ib - m_new[:, None])  # (B,L,H)
        C = decay[..., None, None] * C + torch.einsum(
            "blh,blhd,blhe->bhde", wk, kb, vb)
        n = decay[..., None] * n + torch.einsum("blh,blhd->bhd", wk, kb)
        m = m_new
    h, final = torch.cat(hs, 1)[:, :S], {"C": C, "n": n, "m": m}
    if not return_states:
        return h, final
    return h, final, {key: torch.stack([st[i] for st in starts], 2)
                      for i, key in enumerate(("C", "n", "m"))}


def mlstm_chunked_bwd_ref(q, k, v, i_pre, logf, states, h, dh, *,
                          chunk: int):
    """Plain backward of :func:`mlstm_chunked_ref` from the state at the
    start of every chunk of ``chunk`` steps (``states``, as its
    ``return_states`` gives them), its output h and h's gradient dh
    (B,S,H,dh), in fp32, chunk by chunk from the last.  No cotangent
    reaches the final state, and the initial state takes none.

    It differentiates h, not the stabiliser: within a chunk, with F the
    cumulative log forget gate, D_ij = e^{F_i - F_j + i_j} (j <= i),
    b_i = e^{F_i} and the unscaled state (e^{m_prev} C, e^{m_prev} n),
    h_i = N_i / max(|Den_i|, 1) with N_i = sum_j (q_i.k_j) D_ij v_j +
    b_i C~^T q_i and Den_i likewise with 1 for v_j and n~ for C~, and
    every e^{-m} of the stabilised formulas cancels; so m is a constant
    here, and each exponential is taken relative to the forward's m_i
    (scores), m_prev (state path) and m_new (key weights, carried
    cotangents), which keeps all of them at most 1.  Per chunk, dN_i =
    dh_i / r_i (r_i the stabilised floor max(|den_i|, e^{-m_i})), dDen_i
    = -sign(den_i) (dh_i.h_i) / r_i where |den_i| passes the floor, dS_ij
    = (dN_i.v_j + dDen_i) w_ij; dq, dk, dv from dS, the scores P and the
    cotangent G of the carried C (dh_k x dh_v) and g of n; each log gate
    weight takes its cotangent times its value (the scores dS_ij qk_ij,
    the state path q_i.dq_state_i, the key weights k_j.dk_state_j, the
    decay e^{F_L} (<G, C> + <g, n>)); the input gate sums its columns and
    key weight, the forget gate collects +F_i / -F_j of every term and
    +F_L of the carried ones, and dlogf is the reverse cumulative sum of
    dF within the chunk.  Returns (dq, dk, dv) at q's, k's and v's dtypes
    and (di, dlogf) fp32 (B,S,H)."""
    B, S, H, dh_ = q.shape
    pad = (-S) % chunk
    qf, kf, vf, hf, gf = (F.pad(t.float(), (0, 0, 0, 0, 0, pad))
                          for t in (q, k, v, h, dh))
    ig = F.pad(i_pre.float(), (0, 0, 0, pad), value=-1e30)
    lf = F.pad(logf.float(), (0, 0, 0, pad), value=0.0)
    tri = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=q.device).tril()
    G = torch.zeros(B, H, dh_, dh_, device=q.device)
    g = torch.zeros(B, H, dh_, device=q.device)
    grads = []
    for c in reversed(range((S + pad) // chunk)):
        c0 = c * chunk
        qb, kb, vb, hb, gb = (t[:, c0:c0 + chunk].transpose(1, 2)
                              for t in (qf, kf, vf, hf, gf))  # (B,H,L,dh)
        ib, fb = (t[:, c0:c0 + chunk].transpose(1, 2) for t in (ig, lf))
        C, n, m = (states[key][:, :, c] for key in ("C", "n", "m"))
        Fc = torch.cumsum(fb, dim=-1)                            # (B,H,L)
        Ftot = Fc[..., -1]
        logw = torch.where(tri, Fc[..., :, None] - Fc[..., None, :]
                           + ib[..., None, :], -torch.inf)
        logst = Fc + m[..., None]
        m_i = torch.maximum(logw.amax(-1), logst)
        m_i = torch.where(torch.isfinite(m_i), m_i, 0.0)
        w = torch.exp(logw - m_i[..., None])                     # (B,H,L,L)
        sw = torch.exp(logst - m_i)
        qk = qb @ kb.transpose(-1, -2)
        P = qk * w
        den = P.sum(-1) + sw * (qb @ n[..., None])[..., 0]
        floor = torch.exp(-m_i)
        r = torch.maximum(den.abs(), floor)
        m_new = torch.maximum(m + Ftot, (Ftot[..., None] - Fc + ib).amax(-1))
        decay = torch.exp(m + Ftot - m_new)
        wk = torch.exp(Ftot[..., None] - Fc + ib - m_new[..., None])
        dN = gb / r[..., None]
        dDen = torch.where(den.abs() > floor,
                           -torch.sign(den) * (gb * hb).sum(-1) / r, 0.0)
        dS = (dN @ vb.transpose(-1, -2) + dDen[..., None]) * w
        dlogD = dS * qk
        dq_st = sw[..., None] * (dN @ C.transpose(-1, -2)
                                 + dDen[..., None] * n[..., None, :])
        dk_st = wk[..., None] * (vb @ G.transpose(-1, -2) + g[..., None, :])
        dq = dS @ kb + dq_st
        dk = dS.transpose(-1, -2) @ qb + dk_st
        dv = P.transpose(-1, -2) @ dN + wk[..., None] * (kb @ G)
        dlogw = (kb * dk_st).sum(-1)
        di = dlogD.sum(-2) + dlogw
        dF = dlogD.sum(-1) + (qb * dq_st).sum(-1) - di
        dF[..., -1] += dlogw.sum(-1) + decay * (
            (G * C).sum((-2, -1)) + (g * n).sum(-1))
        dlf = dF.flip(-1).cumsum(-1).flip(-1)
        grads.append((dq, dk, dv, di, dlf))
        G = (sw[..., None] * qb).transpose(-1, -2) @ dN \
            + decay[..., None, None] * G
        g = ((sw * dDen)[..., None] * qb).sum(-2) + decay[..., None] * g
    dq, dk, dv, di, dlf = (torch.cat([gr[i] for gr in reversed(grads)], 2)
                           .transpose(1, 2)[:, :S] for i in range(5))
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            di.contiguous(), dlf.contiguous())
