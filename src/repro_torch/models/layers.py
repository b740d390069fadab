"""Core building blocks in plain PyTorch (the port's counterpart of
``repro.models.layers``).  Parameters are nested dicts of tensors; the
paged attention calls go through ``repro_torch.kernels.ops``, which sends
CPU tensors to the plain versions and CUDA tensors to the CUDA kernels.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

NEG_INF = -2.3819763e38  # most-negative bf16-representable; safe in fp32 too

# ---------------------------------------------------------------------------
# Init helpers (the reference's scales, drawn from a torch.Generator)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int):
    return torch.randn(in_dim, out_dim, generator=gen,
                       device=gen.device) * in_dim ** -0.5


def embed_init(gen: torch.Generator, vocab: int, dim: int):
    return torch.randn(vocab, dim, generator=gen, device=gen.device) * 0.02


def norm_init(cfg: ModelConfig, device):
    d = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"w": torch.zeros(d, device=device)}
    return {"w": torch.ones(d, device=device),
            "b": torch.zeros(d, device=device)}


# ---------------------------------------------------------------------------
# Dense matmul, norms, softcap
# ---------------------------------------------------------------------------


def dense_matmul(x, w):
    """``x @ w`` for a plain serve-path weight, cast to ``x.dtype`` at
    point of use (a library GEMM, as the reference leaves it to XLA)."""
    return x @ w.to(x.dtype)


def rmsnorm(x, w, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def layernorm(x, w, b, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def apply_norm(cfg: ModelConfig, p, x):
    if "b" in p:
        return layernorm(x, p["w"], p["b"])
    return rmsnorm(x, p["w"])


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def position_mask(q_pos, k_pos, window: Optional[int]):
    """(B,Sq,Sk) bool: causal, windowed, and k_pos>=0 validity."""
    m = (k_pos[:, None, :] <= q_pos[:, :, None]) & (k_pos[:, None, :] >= 0)
    if window is not None:
        m &= k_pos[:, None, :] > (q_pos[:, :, None] - window)
    return m


def attention_ref(q, k, v, q_pos, k_pos, *, window, scale,
                  attn_softcap=None):
    """Causal GQA attention driven by absolute positions, fp32 scores.
    q: (B,Sq,Hq,D), k/v: (B,Sk,Hkv,D), -1 positions mark invalid keys."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, g, D).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    logits = softcap(logits, attn_softcap)
    mask = position_mask(q_pos, k_pos, window)
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    # rows with no valid key (all masked) -> softmax gives uniform; zero them
    p = torch.where(mask.any(-1)[:, None, None, :, None], p, 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def mha_attention(q, k, v, q_pos, k_pos, *, window: Optional[int],
                  scale: float, attn_softcap: Optional[float] = None):
    """Dense attention; the port runs it through the plain reference
    (the flash kernel it replaces in the reference is not ported yet)."""
    return attention_ref(q, k, v, q_pos, k_pos, window=window, scale=scale,
                         attn_softcap=attn_softcap)


def mha_attention_paged(q, pool, block_tables, q_pos, *,
                        window: Optional[int], scale: float,
                        attn_softcap: Optional[float] = None):
    """Single-token decode attention against a paged KV pool.

    q: (B,1,Hq,D); pool: {"pk"/"pv": (P,page,Hkv,D), "ppos": (P,page)};
    block_tables: (B, pages_per_slot) physical page ids (-1 = none);
    q_pos: (B,1).  Multi-query windows (the reference's mixed kernel,
    speculative verify and the ``packed=False`` path) are not ported.
    """
    if q.shape[1] != 1:
        raise NotImplementedError(
            "multi-query paged attention (paged_mixed_attention) is not "
            "ported; the port serves decode steps with one query per slot")
    return ops.paged_decode_attention(
        q, pool["pk"], pool["pv"], pool["ppos"], block_tables, q_pos,
        window=window, scale=scale, attn_softcap=attn_softcap)


def mha_attention_paged_packed(q, pool, block_tables, q_pos, slot_ids,
                               meta, *, window: Optional[int], scale: float,
                               attn_softcap: Optional[float] = None):
    """Token-packed ragged attention against a paged KV pool: one flat
    (1, T) query stream covering every slot's decode token and
    prefill-chunk tokens for a whole scheduler iteration.

    q: (1, T, Hq, D); q_pos: (1, T) absolute positions (-1 = padding
    lane, output zero); slot_ids: (T,) owning slot per lane; meta: the
    (n_work, 4) work table from ``decode_attention.packed_meta_table``.
    The stream's own K/V must already be in the pool.
    """
    return ops.paged_packed_attention(
        q, pool["pk"], pool["pv"], pool["ppos"], block_tables, q_pos,
        slot_ids, meta, window=window, scale=scale,
        attn_softcap=attn_softcap)


def attn_init(gen: torch.Generator, cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {"wq": dense_init(gen, d, cfg.num_heads * hd),
            "wk": dense_init(gen, d, cfg.num_kv_heads * hd),
            "wv": dense_init(gen, d, cfg.num_kv_heads * hd),
            "wo": dense_init(gen, cfg.num_heads * hd, d)}


def attn_qkv(cfg: ModelConfig, p, x):
    """Project to q, k, v.  x: (B,S,d) -> q (B,S,Hq,D), k/v (B,S,Hkv,D).
    Learned absolute positions only: RoPE and qk-norm are not ported."""
    if cfg.pos_emb == "rope" or cfg.qk_norm:
        raise NotImplementedError("RoPE / qk-norm attention is not ported")
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dense_matmul(x, p["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = dense_matmul(x, p["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = dense_matmul(x, p["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    return q, k, v


def attn_out(cfg: ModelConfig, p, ctx):
    B, S = ctx.shape[:2]
    return dense_matmul(ctx.reshape(B, S, -1), p["wo"])


def attn_scale(cfg: ModelConfig) -> float:
    return (cfg.attn_scale if cfg.attn_scale is not None
            else cfg.resolved_head_dim ** -0.5)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def ffn_init(gen: torch.Generator, cfg: ModelConfig):
    if cfg.activation != "gelu":
        raise NotImplementedError(
            f"activation {cfg.activation!r} is not ported (only 'gelu')")
    return {"wi": dense_init(gen, cfg.d_model, cfg.d_ff),
            "wo": dense_init(gen, cfg.d_ff, cfg.d_model)}


def ffn_apply(cfg: ModelConfig, p, x):
    """Dense GELU FFN.  The reference's ``jax.nn.gelu`` defaults to the
    tanh approximation, so the port asks for it explicitly."""
    if cfg.activation != "gelu":
        raise NotImplementedError(
            f"activation {cfg.activation!r} is not ported (only 'gelu')")
    h = F.gelu(dense_matmul(x, p["wi"]), approximate="tanh")
    return dense_matmul(h, p["wo"])


# ---------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ModelConfig, params, tokens):
    """tokens: (B,S) int -> (B,S,d) at the embedding table's dtype."""
    x = params["embed"]["tokens"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def unembed(cfg: ModelConfig, params, x):
    """x: (B,S,d) -> fp32 logits through the tied embedding table."""
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied unembedding heads are not ported")
    logits = x.float() @ params["embed"]["tokens"].float().T
    return softcap(logits, cfg.final_softcap)
