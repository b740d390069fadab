"""Core building blocks in plain PyTorch (the port's counterpart of
``repro.models.layers``).  Parameters are nested dicts of tensors; the
paged attention calls go through ``repro_torch.kernels.ops``, which sends
CPU tensors to the plain versions and CUDA tensors to the CUDA kernels.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import perf_flags
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.sharding import spmd as SP

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
    """``x @ w`` for a serve-path weight: a plain (in, out) tensor, cast
    to ``x.dtype`` at point of use (a library GEMM, as the reference
    leaves it to XLA), or an int8 record ``{"q", "s"}``
    (``precision.quantize_weights``), which goes to
    ``ops.quant_matmul`` and comes back at ``x.dtype``."""
    if isinstance(w, dict):
        return ops.quant_matmul(x, w["q"], w["s"]).to(x.dtype)
    return SP.gather_rows_for(x, w) @ w.to(x.dtype)


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


def rope(x, positions, theta: float):
    """Rotary position embedding, rotating halves (not interleaved pairs).
    x: (..., S, H, D); positions: broadcastable to (..., S).  Angles are
    fp32; the result is at x's dtype."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


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
    q: (B,Sq,Hq,D), k/v: (B,Sk,Hkv,D), -1 positions mark invalid keys.
    It follows the reference's ``attn_bf16`` flag (``perf_flags``, on by
    default): on, the probabilities are rounded to v's dtype before the
    product with v, as the port's tensor-core kernels do; off
    (``REPRO_PERF_OPTS=""``), they stay fp32.  The scores are exact
    either way (products of bf16 / fp16 values are exact in fp32)."""
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
    if perf_flags.flag("attn_bf16"):
        p = p.to(v.dtype).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def mha_attention(q, k, v, q_pos, k_pos, *, window: Optional[int],
                  scale: float, attn_softcap: Optional[float] = None):
    """Dense attention driven by absolute positions (q: (B,Sq,Hq,D),
    k/v: (B,Sk,Hkv,D), -1 positions invalid), the same math as
    :func:`attention_ref`.  A single query (Sq == 1: the decode step
    against a dense cache) goes to ``ops.decode_attention``, every other
    shape (prefill, prefix-attend, full forwards) to
    ``ops.flash_attention``: the kernels on the card, their plain
    versions on the CPU.  DTensors (a meshed forward) attend on their
    local shards (``sharding.spmd.attention``) and come back with their
    heads merged, (B, Sq, Hq * D)."""
    if SP.is_dtensor(q):
        return SP.attention(mha_attention, q, k, v, q_pos, k_pos,
                            window=window, scale=scale,
                            attn_softcap=attn_softcap)

    def i32(t):
        return t.to(torch.int32).contiguous()
    qkv = (q.contiguous(), k.contiguous(), v.contiguous())
    kw = dict(window=window, scale=scale, attn_softcap=attn_softcap)
    if q.shape[1] == 1:
        return ops.decode_attention(*qkv, i32(k_pos), i32(q_pos), **kw)
    return ops.flash_attention(*qkv, i32(q_pos), i32(k_pos), **kw)


def mha_attention_paged(q, pool, block_tables, q_pos, *,
                        window: Optional[int], scale: float,
                        attn_softcap: Optional[float] = None):
    """Attention of per-slot query windows against a paged KV pool.

    q: (B,W,Hq,D): W == 1 for a decode step (the decode kernel), W > 1
    for a speculative verify window or a prefill chunk (the mixed kernel),
    with q_pos (B,W) absolute positions, -1 marking padding lanes (their
    outputs are zeros).  The window's own K/V must already be in the pool,
    so the stored positions give each lane its causal mask.  pool:
    {"pk"/"pv": (P,page,Hkv,D), "ppos": (P,page)}, plus
    "pk_scale"/"pv_scale" (P,page,Hkv) when the pool stores int8;
    block_tables: (B, pages_per_slot) physical page ids (-1 = none).
    """
    attend = (ops.paged_decode_attention if q.shape[1] == 1
              else ops.paged_mixed_attention)
    return attend(q, pool["pk"], pool["pv"], pool["ppos"], block_tables,
                  q_pos, window=window, scale=scale,
                  attn_softcap=attn_softcap, k_scale=pool.get("pk_scale"),
                  v_scale=pool.get("pv_scale"))


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
        attn_softcap=attn_softcap, k_scale=pool.get("pk_scale"),
        v_scale=pool.get("pv_scale"))


def attn_init(gen: torch.Generator, cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {"wq": dense_init(gen, d, cfg.num_heads * hd),
         "wk": dense_init(gen, d, cfg.num_kv_heads * hd),
         "wv": dense_init(gen, d, cfg.num_kv_heads * hd),
         "wo": dense_init(gen, cfg.num_heads * hd, d)}
    if cfg.qk_norm:
        p["q_norm"] = {"w": torch.zeros(hd, device=gen.device)}
        p["k_norm"] = {"w": torch.zeros(hd, device=gen.device)}
    return p


def attn_qkv(cfg: ModelConfig, p, x, positions,
             theta: Optional[float] = None):
    """Project to q, k, v.  x: (B,S,d) -> q (B,S,Hq,D), k/v (B,S,Hkv,D);
    with qk-norm, a per-head RMSNorm of q and k, then RoPE (for
    ``pos_emb == "rope"``) at ``positions`` (B,S).  Padding lanes (position
    -1) are rotated too; attention masks them out."""
    B, S, _ = x.shape
    theta = theta if theta is not None else cfg.rope_theta
    hd = cfg.resolved_head_dim
    q = SP.split_last(dense_matmul(x, p["wq"]), cfg.num_heads)
    k = SP.split_last(dense_matmul(x, p["wk"]), cfg.num_kv_heads)
    v = SP.split_last(dense_matmul(x, p["wv"]), cfg.num_kv_heads)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"]["w"])
        k = rmsnorm(k, p["k_norm"]["w"])
    if cfg.pos_emb == "rope":
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
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


FFN_ACTIVATIONS = ("gelu", "swiglu", "geglu")


def _check_activation(cfg: ModelConfig):
    if cfg.activation not in FFN_ACTIVATIONS:
        raise NotImplementedError(
            f"activation {cfg.activation!r} is not ported (one of "
            f"{FFN_ACTIVATIONS})")


def ffn_init(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None):
    """A dense FFN of width ``d_ff`` (the config's by default)."""
    _check_activation(cfg)
    f = d_ff or cfg.d_ff
    p = {"wi": dense_init(gen, cfg.d_model, f),
         "wo": dense_init(gen, f, cfg.d_model)}
    if cfg.activation in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, cfg.d_model, f)
    return p


def ffn_apply(cfg: ModelConfig, p, x):
    """Dense FFN: SwiGLU ``silu(x @ wg) * (x @ wi)`` or GeGLU
    ``gelu(x @ wg) * (x @ wi)`` (``wg`` is the gate), or GELU.  The
    reference's ``jax.nn.gelu(approximate=True)`` is the tanh
    approximation, so the port asks for it explicitly."""
    _check_activation(cfg)
    h = dense_matmul(x, p["wi"])
    if cfg.activation == "swiglu":
        h = F.silu(dense_matmul(x, p["wg"])) * h
    elif cfg.activation == "geglu":
        h = F.gelu(dense_matmul(x, p["wg"]), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return dense_matmul(h, p["wo"])


# ---------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ModelConfig, params, tokens):
    """tokens: (B,S) int -> (B,S,d) at the embedding table's dtype; for a
    multi-codebook audio model (B,S,C), the sum of each codebook's gather
    from its (V, d) table of the (C, V, d) ``tokens``."""
    emb = params["embed"]["tokens"]
    if cfg.num_codebooks:
        x = SP.gather_rows(emb[0], tokens[..., 0].long())
        for c in range(1, cfg.num_codebooks):
            x = x + SP.gather_rows(emb[c], tokens[..., c].long())
    else:
        x = SP.gather_rows(emb, tokens.long())
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def unembed(cfg: ModelConfig, params, x):
    """x: (B,S,d) -> fp32 logits ((B,S,C,V) for a multi-codebook model)
    through the untied head ``embed["head"]`` (d, V), or the tied
    embedding table, or its int8 copy ``embed["head_q8"]`` (the
    transposed (d, V) record ``precision.compress_weights`` makes) when
    the policy quantized one; the gather table itself is never
    quantized.  An int8 head record goes
    to ``ops.quant_matmul``."""
    embed = params["embed"]
    if cfg.num_codebooks:
        # (B,S,C,V): through (C, V, d) output heads where present, else
        # the tied codebook tables
        heads = embed.get("heads", embed["tokens"])
        if SP.is_dtensor(x):
            # one vocab-sharded product a codebook (DTensor has no rule
            # for the batched one over a sharded vocabulary)
            return softcap(torch.stack(
                [x.float() @ heads[c].float().T
                 for c in range(heads.shape[0])], dim=2), cfg.final_softcap)
        return softcap(torch.einsum("bsd,cvd->bscv", x.float(),
                                    heads.float()), cfg.final_softcap)
    head = embed.get("head") if not cfg.tie_embeddings \
        else embed.get("head_q8")
    if isinstance(head, dict):
        # x at its own type: a bf16 / fp16 value is exact in fp32, so the
        # products equal those of x.float(), and quant_matmul returns fp32
        # logits either way (bf16 / fp16 x runs its tensor-core body)
        logits = ops.quant_matmul(x.contiguous(), head["q"], head["s"])
    else:
        w = head.float() if head is not None else embed["tokens"].float().T
        logits = SP.gather_rows_for(x, w).float() @ w
    return softcap(logits, cfg.final_softcap)
