"""Recurrent mixers: xLSTM's mLSTM and sLSTM, and the Mamba-style
selective SSM branch of Hymba's hybrid layers (the port's counterpart of
``repro.models.ssm``).

The xLSTM mixers expose ``*_apply(cfg, p, x, state, mode) -> (y,
new_state)`` with ``mode`` in {"prefill", "decode", "train"} ("train"
runs whole rows as "prefill" does, from the zero state); the Mamba branch
``mamba_apply(cfg, p, x, state, conv_state, mode) -> (y, state,
conv_state)``, also in "train" (from zero state).  States are fp32 (the
Mamba conv state at the activations' dtype) and take the place of the KV
cache for attention-free layers: dense, one row per slot.  The mLSTM
prefill runs chunkwise through ``ops.mlstm_chunked`` (the CUDA kernel on
the card, its plain version on the CPU); its decode step, the whole sLSTM
(a true time recurrence) and the Mamba branch (chunkwise, CHUNK steps a
chunk) are plain PyTorch, as in the reference, which has no Pallas kernel
for them.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding import spmd as SP

CHUNK = 128


def _zeros(*shape, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def mlstm_zero_state(cfg: ModelConfig, batch: int, device="cpu"):
    H, dh = cfg.num_heads, (2 * cfg.d_model) // cfg.num_heads
    return {"C": _zeros(batch, H, dh, dh, device=device),
            "n": _zeros(batch, H, dh, device=device),
            "m": _zeros(batch, H, device=device)}


def slstm_zero_state(cfg: ModelConfig, batch: int, device="cpu"):
    H, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    return {"c": _zeros(batch, H, dh, device=device),
            "n": _zeros(batch, H, dh, device=device),
            "h": _zeros(batch, H, dh, device=device),
            "m": _zeros(batch, H, device=device)}


# ---------------------------------------------------------------------------
# mLSTM (matrix memory)
# ---------------------------------------------------------------------------


def mlstm_init(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    di, H = 2 * d, cfg.num_heads
    dev = gen.device
    return {
        "w_up": L.dense_init(gen, d, di),
        "w_gate": L.dense_init(gen, d, di),
        "wq": L.dense_init(gen, di, di),
        "wk": L.dense_init(gen, di, di),
        "wv": L.dense_init(gen, di, di),
        "w_if": L.dense_init(gen, di, 2 * H),
        "b_if": torch.cat([torch.zeros(H, device=dev),
                           torch.full((H,), 3.0, device=dev)]),
        "out_norm": {"w": torch.zeros(di, device=dev)},
        "w_down": L.dense_init(gen, di, d),
    }


def _mlstm_qkvgates(cfg: ModelConfig, p, x):
    B, S, _ = x.shape
    H = cfg.num_heads
    xi = x @ p["w_up"].to(x.dtype)
    z = x @ p["w_gate"].to(x.dtype)
    dh = xi.shape[-1] // H
    q = SP.split_last(xi @ p["wq"].to(x.dtype), H)
    k = SP.split_last(xi @ p["wk"].to(x.dtype), H) * dh ** -0.5
    v = SP.split_last(xi @ p["wv"].to(x.dtype), H)
    gates = SP.batch_layout(xi.float() @ p["w_if"].float()) \
        + p["b_if"].float()
    i_pre, f_pre = gates[..., :H], gates[..., H:]               # (B,S,H)
    return q, k, v, i_pre, SP.pointwise(F.logsigmoid, f_pre), z


def mlstm_step(q, k, v, i_pre, logf, state):
    """Single-token recurrent update.  q, k, v: (B,1,H,dh); i_pre / logf:
    (B,1,H).  Returns h (B,1,H,dh) fp32 and the new state."""
    qf, kf, vf = (t[:, 0].float() for t in (q, k, v))
    ib, fb = i_pre[:, 0], logf[:, 0]                             # (B,H)
    C_p, n_p, m_p = state["C"], state["n"], state["m"]
    m_new = torch.maximum(fb + m_p, ib)
    fw = torch.exp(fb + m_p - m_new)
    iw = torch.exp(ib - m_new)
    C_n = fw[..., None, None] * C_p + iw[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", kf, vf)
    n_n = fw[..., None] * n_p + iw[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C_n)
    den = torch.einsum("bhd,bhd->bh", qf, n_n)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h[:, None], {"C": C_n, "n": n_n, "m": m_new}


def mlstm_apply(cfg: ModelConfig, p, x, state, mode: str):
    q, k, v, i_pre, logf, z = _mlstm_qkvgates(cfg, p, x)
    step = mlstm_step if mode == "decode" else ops.mlstm_chunked

    def fn(*args):
        h, new_state = step(*args)
        return h.flatten(2), new_state
    args = (q.contiguous(), k.contiguous(), v.contiguous(),
            i_pre.contiguous(), logf.contiguous(), state)
    # a meshed forward runs the recurrence (the kernel) on batch shards
    h, new_state = (SP.batch_local(fn, 4, *args) if SP.is_dtensor(q)
                    else fn(*args))
    h = h.to(x.dtype)
    h = L.rmsnorm(h, p["out_norm"]["w"])
    return (h * F.silu(z)) @ p["w_down"].to(x.dtype), new_state


# ---------------------------------------------------------------------------
# sLSTM (scalar memory): a true time recurrence
# ---------------------------------------------------------------------------


def slstm_init(gen: torch.Generator, cfg: ModelConfig):
    d, H = cfg.d_model, cfg.num_heads
    dh = d // H
    dev = gen.device
    return {
        "w_in": L.dense_init(gen, d, 4 * d),                     # i, f, z, o
        "r": torch.randn(H, dh, 4 * dh, generator=gen, device=dev)
        * dh ** -0.5,
        "b": torch.cat([torch.zeros(d, device=dev),
                        torch.full((d,), 3.0, device=dev),
                        torch.zeros(2 * d, device=dev)]),
        "out_norm": {"w": torch.zeros(d, device=dev)},
        "w_out": L.dense_init(gen, d, d),
    }


def _slstm_cell(cfg: ModelConfig, p, wx_t, st):
    """wx_t: (B, 4d) input pre-activations of one step; st: the state,
    {"c", "n", "h"}: (B,H,dh) and "m": (B,H)."""
    H = cfg.num_heads
    B = wx_t.shape[0]
    d = wx_t.shape[-1] // 4
    dh = d // H
    rec = torch.einsum("bhd,hde->bhe", st["h"], p["r"].float())
    pre = wx_t.reshape(B, 4, H, dh).transpose(1, 2).reshape(B, H, 4 * dh)
    pre = pre + rec + p["b"].float().reshape(4, H, dh).transpose(0, 1) \
        .reshape(H, 4 * dh)
    i_pre, f_pre, z_pre, o_pre = pre.split(dh, dim=-1)           # (B,H,dh)
    logf = F.logsigmoid(f_pre)
    # one stabiliser per head (shared across dims), as the reference
    m_prev = st["m"][:, :, None]                                 # (B,H,1)
    m_new = torch.maximum(logf + m_prev, i_pre).amax(-1)         # (B,H)
    fw = torch.exp(logf + m_prev - m_new[..., None])
    iw = torch.exp(i_pre - m_new[..., None])
    c = fw * st["c"] + iw * torch.tanh(z_pre)
    n = fw * st["n"] + iw
    h = torch.sigmoid(o_pre) * c / n.clamp_min(1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_scan(cfg: ModelConfig, r, b, wx, state):
    """The sLSTM cell over wx's steps from ``state``: (the h of every
    step (B, S, H * dh), the final state)."""
    p = {"r": r, "b": b}
    st, hs = state, []
    for t in range(wx.shape[1]):
        st = _slstm_cell(cfg, p, wx[:, t], st)
        hs.append(st["h"])
    return torch.stack(hs, 1).flatten(2), st


def slstm_apply(cfg: ModelConfig, p, x, state, mode: str):
    """The sLSTM block (``"decode"`` is one step of the same scan).  On a
    mesh the recurrence runs on batch shards, its weights whole on every
    device (``sharding.spmd.batch_local``)."""
    wx = x.float() @ p["w_in"].float()                           # (B,S,4d)
    if SP.is_dtensor(wx):
        h, st = SP.batch_local(functools.partial(_slstm_scan, cfg), 5,
                               p["r"], p["b"], wx, state, weights=2)
    else:
        h, st = _slstm_scan(cfg, p["r"], p["b"], wx, state)
    h = L.rmsnorm(h.to(x.dtype), p["out_norm"]["w"])
    return h @ p["w_out"].to(x.dtype), st


# ---------------------------------------------------------------------------
# Mamba-style selective SSM branch (Hymba's hybrid heads)
# ---------------------------------------------------------------------------
# A scalar decay per head (the Mamba-2 form), so that the recurrence runs
# chunkwise: quadratic products inside a chunk, the state carried between
# chunks.


def mamba_zero_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cpu"):
    """(ssm (B, d_inner, N) fp32, conv (B, K-1, d_inner) at ``dtype``)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return (_zeros(batch, di, s.state_size, device=device),
            torch.zeros(batch, s.conv_size - 1, di, dtype=dtype,
                        device=device))


def mamba_init(gen: torch.Generator, cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    Hs = s.num_ssm_heads or cfg.num_heads
    dev = gen.device
    return {
        "w_in": L.dense_init(gen, d, di),
        "w_gate": L.dense_init(gen, d, di),
        "conv": torch.randn(s.conv_size, di, generator=gen, device=dev)
        * 0.2,
        "w_bc": L.dense_init(gen, di, 2 * s.state_size),
        "w_dt": L.dense_init(gen, di, Hs),
        "dt_bias": torch.zeros(Hs, device=dev),
        "a_log": torch.log(torch.linspace(1.0, float(Hs), Hs, device=dev)),
        "skip_d": torch.ones(Hs, device=dev),
        "out_norm": {"w": torch.zeros(di, device=dev)},
        "w_out": L.dense_init(gen, di, d),
    }


def _causal_conv(x, w, conv_state):
    """Depthwise causal conv.  x: (B, S, di), w: (K, di), conv_state:
    (B, K-1, di), the inputs before x.  Returns (out (B, S, di), the last
    K-1 inputs), both at x's dtype."""
    K, S = w.shape[0], x.shape[1]
    xc = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = sum(xc[:, i:i + S] * w[i].to(x.dtype) for i in range(K))
    return out, (xc[:, -(K - 1):] if K > 1 else conv_state)


def mamba_apply(cfg: ModelConfig, p, x, state, conv_state, mode: str):
    """Selective SSM over x (B, S, d) from ``state`` (B, d_inner, N) fp32
    and ``conv_state`` (B, K-1, d_inner): one recurrence step in
    "decode" (S == 1), chunkwise otherwise.  Returns (y (B, S, d) at x's
    dtype, the new state, the new conv state)."""
    s = cfg.ssm
    di = s.expand * x.shape[-1]
    Hs = s.num_ssm_heads or cfg.num_heads
    dh = di // Hs
    N = s.state_size

    xi = x @ p["w_in"].to(x.dtype)
    z = x @ p["w_gate"].to(x.dtype)
    xi, new_conv = _causal_conv(xi, p["conv"], conv_state)
    xi = F.silu(xi)
    bc = SP.batch_layout(xi @ p["w_bc"].to(x.dtype))
    Bt, Ct = bc[..., :N].float(), bc[..., N:].float()
    # fp32 throughout (jnp promotes a bf16 w_dt silently; torch would not)
    dt = F.softplus(SP.batch_layout(xi.float() @ p["w_dt"].float())
                    + p["dt_bias"].float())
    logdec = dt * -torch.exp(p["a_log"]).float()  # exp at a_log's dtype

    def scan(skip_d, xi, Bt, Ct, dt, logdec, state):
        # (y (B, S, di), the final state (B, di, N))
        Bl, Sl = xi.shape[:2]
        xh = xi.reshape(Bl, Sl, Hs, dh)
        h_state = state.reshape(Bl, Hs, dh, N)
        if mode == "decode":
            dec = torch.exp(logdec[:, 0])                        # (B,Hs)
            upd = torch.einsum("bhd,bn,bh->bhdn", xh[:, 0], Bt[:, 0],
                               dt[:, 0])
            h_final = dec[..., None, None] * h_state + upd
            y = torch.einsum("bhdn,bn->bhd", h_final, Ct[:, 0])[:, None]
        else:
            y, h_final = _mamba_chunked(xh, Bt, Ct, dt, logdec, h_state)
        y = y + xh * skip_d.float()[:, None]
        return y.flatten(2), h_final.flatten(1, 2)
    args = (p["skip_d"], xi.float(), Bt, Ct, dt, logdec, state)
    # a meshed forward runs the recurrence on batch shards
    y, h_final = (SP.batch_local(scan, 2, *args, weights=1)
                  if SP.is_dtensor(x) else scan(*args))
    y = L.rmsnorm(y.to(x.dtype), p["out_norm"]["w"])
    out = (y * F.silu(z)) @ p["w_out"].to(x.dtype)
    return out, h_final, new_conv


def _pad_steps(t, pad):
    """t (B, S, ...) with ``pad`` zero steps appended."""
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1) \
        if pad else t


def _mamba_chunked(xh, Bt, Ct, dt, logdec, h0):
    """Chunkwise linear recurrence.  xh: (B, S, H, dh), Bt / Ct: (B, S, N),
    dt / logdec: (B, S, H), h0: (B, H, dh, N), all fp32.  S is padded to a
    multiple of CHUNK with zero steps, which neither decay nor feed the
    state.  Returns (y (B, S, H, dh), the final state)."""
    B, S, H, dh = xh.shape
    pad = -S % CHUNK
    xh, Bt, Ct, dt, logdec = (_pad_steps(t, pad)
                              for t in (xh, Bt, Ct, dt, logdec))
    tri = torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                     device=xh.device).tril()
    h, ys = h0, []
    for c0 in range(0, S + pad, CHUNK):
        xb, bb, cb, db, lb = (t[:, c0:c0 + CHUNK]
                              for t in (xh, Bt, Ct, dt, logdec))
        Fc = torch.cumsum(lb, dim=1)                             # (B,L,H)
        Ftot = Fc[:, -1]
        Ft = Fc.transpose(1, 2)                                  # (B,H,L)
        # intra-chunk weights exp(F_i - F_j) for j <= i, 0 above the
        # diagonal, where the exponent is positive and may overflow: the
        # exponent is masked to -inf before exp, so neither the forward
        # (inf * 0) nor the backward (where's zero gradient times exp's
        # inf) makes a NaN.  The reference masks after exp: the same
        # forward, NaN gradients once a chunk overflows.
        w = torch.exp(torch.where(tri, Ft[..., :, None] - Ft[..., None, :],
                                  -torch.inf))
        scores = torch.einsum("bln,bmn->blm", cb, bb)[:, None] * w \
            * db.transpose(1, 2)[:, :, None, :]                  # (B,H,L,L)
        y_intra = torch.einsum("bhlm,bmhd->blhd", scores, xb)
        y_state = torch.einsum("bln,bhdn,blh->blhd", cb, h, torch.exp(Fc))
        wk = torch.exp(Ftot[:, None] - Fc) * db                  # (B,L,H)
        upd = torch.einsum("blh,blhd,bln->bhdn", wk, xb, bb)
        h = torch.exp(Ftot)[..., None, None] * h + upd
        ys.append(y_intra + y_state)
    return torch.cat(ys, 1)[:, :S], h
