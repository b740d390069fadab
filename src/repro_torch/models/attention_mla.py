"""DeepSeek-V3 multi-head latent attention (MLA), the port's counterpart
of ``repro.models.attention_mla``.

Two forms, as in the reference:

  * **naive** (:func:`mla_full`, :func:`mla_prefill_cached`): decompress
    the latent into per-head K (nope + rope = 192 wide at full width) and
    V (128) and run dense attention through ``layers.mha_attention``, so
    on the card the prefill goes to the flash kernel with D != Dv;
  * **absorbed** (:func:`mla_decode`): only the normalised latent ``ckv``
    (kv_lora_rank) and the shared rotated key ``kr`` are cached; a decode
    step absorbs the query through the key decompression and attends in
    latent space, in plain PyTorch (the reference has no Pallas kernel for
    it).  It follows the reference's default precision (its ``attn_bf16``
    flag, on by default): the scores and the context are products at the
    cache's dtype with fp32 accumulation, the absorbed query, the rotated
    query and the probabilities rounded to that dtype first, and no fp32
    copy of the cache is made.  With the flag off (``REPRO_PERF_OPTS=""``,
    the reference's baseline) it attends over fp32 copies of ``ckv`` and
    ``kr`` with the fp32 absorbed query and probabilities, as the
    reference does.

The cache of an MLA layer is dense, one row per slot: ``{"ckv": (B, S, r),
"kr": (B, S, rope), "pos": (B, S)}`` (``kv_cache.layer_cache_shape``),
updated in place.
"""
from __future__ import annotations

import torch

from repro_torch import perf_flags
from repro_torch.configs.base import ModelConfig
from repro_torch.core import kv_cache as KV
from repro_torch.models import layers as L
from repro_torch.sharding import spmd as SP


def mla_init(gen: torch.Generator, cfg: ModelConfig):
    m, d, H = cfg.mla, cfg.d_model, cfg.num_heads
    dev = gen.device
    qh = m.nope_head_dim + m.rope_head_dim
    return {
        "wdq": L.dense_init(gen, d, m.q_lora_rank),
        "q_norm": {"w": torch.zeros(m.q_lora_rank, device=dev)},
        "wuq": L.dense_init(gen, m.q_lora_rank, H * qh),
        "wdkv": L.dense_init(gen, d, m.kv_lora_rank),
        "kv_norm": {"w": torch.zeros(m.kv_lora_rank, device=dev)},
        "wukv": L.dense_init(gen, m.kv_lora_rank,
                             H * (m.nope_head_dim + m.v_head_dim)),
        "wkr": L.dense_init(gen, d, m.rope_head_dim),
        "wo": L.dense_init(gen, H * m.v_head_dim, d),
    }


def _mm(x, w):
    return x @ w.to(x.dtype)


def _project(cfg: ModelConfig, p, x, positions):
    """The common projections of x (B, S, d) at ``positions`` (B, S):
    (q_nope (B,S,H,nope), q_rope (B,S,H,rope) rotated, the normalised
    latent ckv (B,S,r), the rotated shared key kr (B,S,rope))."""
    m, H = cfg.mla, cfg.num_heads
    B, S, _ = x.shape
    cq = L.rmsnorm(_mm(x, p["wdq"]), p["q_norm"]["w"])
    q = SP.split_last(_mm(cq, p["wuq"]), H)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    q_rope = L.rope(q_rope, positions, cfg.rope_theta)
    ckv = L.rmsnorm(_mm(x, p["wdkv"]), p["kv_norm"]["w"])
    kr = L.rope(_mm(x, p["wkr"])[:, :, None, :], positions,
                cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, kr


def mla_scale(cfg: ModelConfig) -> float:
    m = cfg.mla
    return (m.nope_head_dim + m.rope_head_dim) ** -0.5


def _naive_attend(cfg, p, q_nope, q_rope, ckv, kr, q_pos, k_pos, window,
                  dtype):
    """Decompress latents ckv (B, Sk, r) / kr (B, Sk, rope) into per-head
    K and V and attend the queries to them; returns the output
    projection (B, Sq, d)."""
    m, H = cfg.mla, cfg.num_heads
    B, Sk = ckv.shape[:2]
    kv = SP.split_last(_mm(ckv.to(dtype), p["wukv"]), H)
    k_nope, v = kv[..., :m.nope_head_dim], kv[..., m.nope_head_dim:]
    k = torch.cat([k_nope, kr.to(dtype)[:, :, None, :].expand(
        B, Sk, H, m.rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    ctx = L.mha_attention(q, k, v, q_pos, k_pos, window=window,
                          scale=mla_scale(cfg), attn_softcap=None)
    return _mm(ctx.reshape(B, q.shape[1], H * m.v_head_dim), p["wo"])


def mla_full(cfg: ModelConfig, p, x, positions, k_pos, window=None):
    """The naive form over the in-context tokens (a full forward or an
    admission prefill).  Returns (out (B, S, d), {"ckv", "kr"} to
    cache)."""
    q_nope, q_rope, ckv, kr = _project(cfg, p, x, positions)
    out = _naive_attend(cfg, p, q_nope, q_rope, ckv, kr, positions, k_pos,
                        window, x.dtype)
    return out, {"ckv": ckv, "kr": kr}


def mla_prefill_cached(cfg: ModelConfig, p, x, cache, positions, cache_pos,
                       window=None):
    """A prefill that continues from a filled latent cache: write the new
    latents at ``cache_pos`` (-1 = padding, the dump slot), then
    decompress the whole cache and attend it.  Returns the output; the
    cache is updated in place."""
    q_nope, q_rope, ckv, kr = _project(cfg, p, x, positions)
    KV.write_prefill(cache, {"ckv": ckv, "kr": kr}, cache_pos)
    return _naive_attend(cfg, p, q_nope, q_rope, cache["ckv"], cache["kr"],
                         positions, cache["pos"], window, x.dtype)


def _f32_bmm(a, b):
    """The batched product a @ b summed in fp32, as the reference's
    ``preferred_element_type=float32``: fp32 operands multiply as they
    are; bf16 / fp16 ones multiply at their own dtype into an fp32 result
    (on the card cuBLAS's product with an fp32 output, so b, the latent
    cache, is not copied; the CPU has no such product, and multiplies the
    same values upcast, which gives the same fp32 sum)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def mla_decode(cfg: ModelConfig, p, x, cache, lengths):
    """The absorbed form: one token per row (x (B, 1, d)) at positions
    ``lengths`` (B,), written into the latent cache, then attended in
    latent space at the cache's dtype with fp32 accumulation (the
    reference's default), or over fp32 copies of the cache with
    ``attn_bf16`` off (see the module's docstring).  Returns (B, 1, d)."""
    m, H = cfg.mla, cfg.num_heads
    B = x.shape[0]
    positions = lengths[:, None]
    q_nope, q_rope, ckv_new, kr_new = _project(cfg, p, x, positions)
    KV.write_decode(cache, {"ckv": ckv_new, "kr": kr_new}, lengths)
    wukv = SP.split_last(p["wukv"].float(), H)
    wk, wv = wukv[..., :m.nope_head_dim], wukv[..., m.nope_head_dim:]
    # absorb q through the key decompression: (B,H,nope) x (r,H,nope)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), wk)
    ckv, kr = cache["ckv"], cache["kr"]
    if not perf_flags.flag("attn_bf16"):
        ckv, kr = ckv.float(), kr.float()
    scores = (_f32_bmm(q_lat.to(ckv.dtype), ckv.transpose(1, 2))
              + _f32_bmm(q_rope[:, 0].to(kr.dtype), kr.transpose(1, 2))) \
        * mla_scale(cfg)                                         # (B,H,Sc)
    mask = KV.cache_mask(cache["pos"], positions, None)[:, 0]   # (B, Sc)
    scores = torch.where(mask[:, None, :], scores,
                         torch.tensor(L.NEG_INF, device=x.device))
    probs = torch.softmax(scores, dim=-1)
    ctx_lat = _f32_bmm(probs.to(ckv.dtype), ckv)                  # (B,H,r)
    ctx = torch.einsum("bhr,rhd->bhd", ctx_lat, wv)               # (B,H,v)
    ctx = SP.batch_layout(ctx)            # a mesh: heads whole a device
    return _mm(ctx.reshape(B, H * m.v_head_dim).to(x.dtype),
               p["wo"])[:, None, :]
