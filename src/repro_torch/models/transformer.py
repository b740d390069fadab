"""Decoder forward for the serving path (the port's counterpart of
``repro.models.transformer``), for every layer family of the reference:
attention layers with a dense FFN or a capacity-routed MoE FFN
(:mod:`repro_torch.models.moe`: softmax or sigmoid routing, shared
experts), DeepSeek's multi-head latent attention
(:mod:`repro_torch.models.attention_mla`) with either FFN, Hymba's hybrid
layers (attention and a Mamba-style SSM branch on the same input, their
normalised outputs averaged, then a dense FFN) and xLSTM's recurrent
layers (mLSTM / sLSTM with no FFN, no positional embedding); learned,
sinusoidal or RoPE positions (a windowed layer's own theta too), optional
qk-norm, sliding windows, softcaps and sandwich norms, GELU, SwiGLU or
GeGLU FFNs, tied or untied embeddings, prefix embeddings in front of the
text (a vision model's patches), multi-codebook tokens (an audio model's
(C, V, d) tables, (B, S, C, V) logits) and DeepSeek's multi-token
prediction head (:func:`forward_mtp`, which no serving path calls).

Parameters are a dict ``{"embed": {"tokens"[, "head"][, "pos"]},
"final_norm", "layers": [per-layer dict][, "mtp"]}`` with the layers in
execution order (:func:`repro_torch.configs.base.layer_specs`); the
reference stacks each pattern position over its scan repeats instead
(``bridge.params_from_jax`` converts).  The modes of the reference's
``layer_apply``:

* against the paged KV pool: ``"decode"`` (one token per slot),
  ``"verify"`` (a window of tokens per slot: a speculative verify window
  or a prefill chunk), ``"packed"`` (one flat token stream per scheduler
  iteration) and ``"prefill"`` (whole bucket-padded prompts of an
  admission, optionally resuming after a shared prefix); ``"verify"`` and
  ``"packed"`` only for pure attention layers;
* against a dense per-slot cache (:func:`init_cache`): ``"prefill"``
  (optionally attending what the cache already holds) and ``"decode"``;
* ``"train"``: a full causal forward with no cache, recurrent layers from
  the zero state (:func:`forward_train`: training, which differentiates
  it; the no-cache baseline and the draft model of speculative decoding,
  which run it under ``torch.no_grad``).

Per-slot state (recurrent layers, the hybrid layers' SSM and conv state,
MLA's latent cache) lives in the layer's cache dict, dense, one row per
slot, also beside a paged pool; recurrent and SSM states are replaced in
the dict, every other cache entry is updated in place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, DENSE_FFN, HYBRID, MLA, MLSTM,
                                      MOE_FFN, NO_FFN, SLSTM, LayerSpec,
                                      ModelConfig, layer_specs)
from repro_torch.core import kv_cache as KV
from repro_torch.core.precision import FP32, Policy
from repro_torch.models import attention_mla as MLAT
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.sharding import spmd as SP

RECURRENT = (MLSTM, SLSTM)
# the FFNs each mixer is ported with (the reference's configs use no other)
_FFNS = {ATTN: (DENSE_FFN, MOE_FFN), MLA: (DENSE_FFN, MOE_FFN),
         HYBRID: (DENSE_FFN,), MLSTM: (NO_FFN,), SLSTM: (NO_FFN,)}
MTP_SPEC = LayerSpec(mixer=ATTN, ffn=DENSE_FFN)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for configs outside the port."""
    for spec in layer_specs(cfg):
        if spec.ffn not in _FFNS[spec.mixer]:
            raise NotImplementedError(
                f"layer family {spec.mixer}/{spec.ffn} is not ported "
                f"(attention or MLA + dense or MoE FFN, hybrid + dense "
                f"FFN, or mLSTM/sLSTM without FFN)")
        for mixer, sub in ((MLA, cfg.mla), (HYBRID, cfg.ssm)):
            if spec.mixer == mixer and sub is None:
                raise ValueError(f"{cfg.name}: a {mixer} layer needs the "
                                 f"config's {mixer} block")
    if cfg.pos_emb not in ("rope", "learned", "sinusoidal", "none") \
            or cfg.activation not in L.FFN_ACTIVATIONS:
        raise NotImplementedError(
            f"{cfg.name}: only RoPE, learned, sinusoidal or no positions "
            f"and {'/'.join(L.FFN_ACTIVATIONS)} FFNs are ported")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig,
                policy: Policy = FP32):
    """Random parameters with the reference's shapes and init scales,
    drawn from ``gen`` on ``gen.device``.  Each leaf is drawn in fp32 and
    cast to the policy's dtype as soon as its part of the tree is drawn,
    so a model never sits whole in fp32 (gemma3-27b would need twice its
    bf16 bytes)."""
    check_supported(cfg)
    dev = gen.device
    if cfg.num_codebooks:
        # one (V, d) table per codebook, tied to the unembedding as the
        # reference draws them
        embed = {"tokens": torch.stack([
            L.embed_init(gen, cfg.vocab_size, cfg.d_model)
            for _ in range(cfg.num_codebooks)])}
    else:
        embed = {"tokens": L.embed_init(gen, cfg.vocab_size, cfg.d_model)}
        if not cfg.tie_embeddings:
            embed["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size)
    if cfg.pos_emb == "learned":
        embed["pos"] = L.embed_init(gen, cfg.max_seq_len, cfg.d_model)
    cast = policy.cast_params
    dt = policy.param_dtype
    params = {
        "embed": cast(embed),
        "final_norm": cast(L.norm_init(cfg, dev)),
        "layers": [cast(_layer_init(gen, cfg, spec, dev, dt))
                   for spec in layer_specs(cfg)],
    }
    if cfg.mtp:
        params["mtp"] = cast(mtp_init(gen, cfg, dt))
    return params


def _layer_init(gen, cfg: ModelConfig, spec: LayerSpec, dev,
                dtype=torch.float32):
    """One layer's parameters (MoE expert stacks stored at ``dtype``)."""
    if spec.mixer == MLSTM:
        return {"norm1": L.norm_init(cfg, dev),
                "mixer": SSM.mlstm_init(gen, cfg)}
    if spec.mixer == SLSTM:
        return {"norm1": L.norm_init(cfg, dev),
                "mixer": SSM.slstm_init(gen, cfg)}
    p = {"norm1": L.norm_init(cfg, dev),
         "attn": (MLAT.mla_init(gen, cfg) if spec.mixer == MLA
                  else L.attn_init(gen, cfg))}
    if spec.mixer == HYBRID:
        p["mamba"] = SSM.mamba_init(gen, cfg)
        p["bn_attn"] = L.norm_init(cfg, dev)
        p["bn_ssm"] = L.norm_init(cfg, dev)
    p["norm2"] = L.norm_init(cfg, dev)
    p["ffn"] = (MOE.moe_init(gen, cfg, dtype) if spec.ffn == MOE_FFN
                else L.ffn_init(gen, cfg))
    if cfg.sandwich_norm:
        p["norm1_post"] = L.norm_init(cfg, dev)
        p["norm2_post"] = L.norm_init(cfg, dev)
    return p


def mtp_init(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32):
    """DeepSeek's multi-token prediction module: two norms, the (2d, d)
    merge projection and one attention layer with a dense FFN."""
    dev = gen.device
    return {"norm_h": L.norm_init(cfg, dev), "norm_e": L.norm_init(cfg, dev),
            "proj": L.dense_init(gen, 2 * cfg.d_model, cfg.d_model),
            "layer": _layer_init(gen, cfg, MTP_SPEC, dev, dtype)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu"):
    """Dense model cache of ``batch`` rows for contexts up to ``max_len``
    (``kv_cache.layer_cache_shape`` per layer, in execution order)."""
    return {"layers": [KV.layer_cache_shape(cfg, spec, batch, max_len,
                                            dtype, device=device)
                       for spec in layer_specs(cfg)]}


def init_paged_cache(cfg: ModelConfig, *, num_pages: int, page_size: int,
                     dtype=torch.bfloat16, kv_dtype: str = "auto",
                     max_slots: int = 0, max_len: int = 0, device="cpu"):
    """Paged-pool model cache: every attention layer (a hybrid layer's
    attention too) gets ``num_pages`` fixed-size pages (+1 reserved dump
    page) indexed through per-slot block tables; per-slot state (a
    recurrent layer's, a hybrid layer's SSM and conv state, an MLA
    layer's latent cache for contexts up to ``max_len``) ``max_slots``
    dense rows."""
    return {"layers": [KV.paged_layer_cache_shape(
        cfg, spec, num_pages, page_size, dtype, kv_dtype,
        max_slots=max_slots, max_len=max_len, device=device)
        for spec in layer_specs(cfg)]}


# ---------------------------------------------------------------------------
# One layer
# ---------------------------------------------------------------------------


def layer_apply(cfg: ModelConfig, spec: LayerSpec, p, x, *, positions,
                cache, mode: str, max_len: int, paged, cache_pos=None,
                attend_cache: bool = False):
    """One layer: a recurrent block (:func:`_recurrent_apply`) or, below,
    a mixer (attention, MLA or hybrid) + FFN block.  Against a paged pool
    (``"pk"`` in the cache), paged: {"block_tables", "active"} for
    ``"decode"``, ``"verify"`` (``active`` (B,) or (B, W)) and
    ``"prefill"``; {"block_tables", "slot_ids", "packed_meta"} for
    ``"packed"``.  A dense cache takes ``"prefill"`` and ``"decode"`` with
    paged None (an MLA layer's latent cache is dense beside a pool too).
    ``cache_pos`` (B, S): where prefill writes each token (-1 = padding,
    the dump slot or page); ``attend_cache``: the prefill resumes after
    entries already in the cache and attends them too.  ``"train"`` takes
    no cache: every token attends the earlier ones directly.  Returns (x,
    the MoE load-balance loss of the layer, or None without MoE)."""
    if spec.mixer in RECURRENT:
        return _recurrent_apply(cfg, spec, p, x, cache, mode), None
    if mode in ("verify", "packed") and (
            spec.mixer != ATTN or cache is None or "pk" not in cache):
        # multi-token windows are defined over paged pure-attention layers
        # only: rings, SSM state and MLA latents have no per-position
        # rewind (the reference's backstop; the engine gates before
        # dispatch)
        raise NotImplementedError(
            f"{mode} mode needs a paged pure-attention layer (not "
            f"'{spec.mixer}' / a dense cache)")
    window = KV.effective_window(cfg, spec, max_len)
    h = L.apply_norm(cfg, p["norm1"], x)
    kw = dict(positions=positions, cache=cache, mode=mode, paged=paged,
              cache_pos=cache_pos, attend_cache=attend_cache, window=window)
    if spec.mixer == MLA:
        out = _mla_apply(cfg, p["attn"], h, **kw)
    else:
        out = _attention_apply(cfg, p["attn"], h, **kw)
        if spec.mixer == HYBRID:
            out = _hybrid_mix(cfg, p, h, out, cache, mode)
    out = SP.like(out, x)
    if cfg.sandwich_norm:
        out = L.apply_norm(cfg, p["norm1_post"], out)
    x = x + out
    h = L.apply_norm(cfg, p["norm2"], x)
    aux = None
    if spec.ffn == MOE_FFN:
        # routed by the config's kind (sigmoid where the model has MLA)
        out, aux = MOE.moe_apply(cfg, p["ffn"], h)
    else:
        out = L.ffn_apply(cfg, p["ffn"], h)
    out = SP.like(out, x)
    if cfg.sandwich_norm:
        out = L.apply_norm(cfg, p["norm2_post"], out)
    return x + out, aux


def _attention_apply(cfg, p, h, *, positions, cache, mode, paged,
                     cache_pos, attend_cache, window):
    """GQA attention of the normed input h, its K/V written into the
    layer's paged pool or dense cache first where the mode has one;
    returns the output projection."""
    # windowed layers rotate at their own theta where the config has one
    theta = (cfg.rope_theta_local if window is not None
             and cfg.rope_theta_local is not None else cfg.rope_theta)
    q, k, v = L.attn_qkv(cfg, p, h, positions, theta=theta)
    kw = dict(window=window, scale=L.attn_scale(cfg),
              attn_softcap=cfg.attn_softcap)
    new = {"k": k, "v": v}
    is_paged = cache is not None and "pk" in cache
    if mode == "train":
        ctx = L.mha_attention(q, k, v, positions, positions, **kw)
    elif is_paged:
        if paged is None:
            raise ValueError("a paged pool needs paged={'block_tables': "
                             "...}")
        bt = paged["block_tables"]
        ring = KV.paged_ring_len(window, cache["ppos"].shape[1],
                                 bt.shape[1])
        if mode == "packed":
            # scatter every lane's K/V into its OWN slot's pages, then
            # attend each lane to its slot's whole paged history
            KV.paged_write_packed(cache, new, paged["slot_ids"],
                                  positions[0], bt, ring_len=ring)
            ctx = L.mha_attention_paged_packed(
                q, cache, bt, positions, paged["slot_ids"],
                paged["packed_meta"], **kw)
        elif mode in ("decode", "verify"):
            # write the token (decode) or the whole window (verify, from
            # positions[:, 0] on) first, then attend: the stored positions
            # give each lane its causal mask over the window's earlier
            # tokens.  The engine rewinds rejected drafts afterwards
            # (kv_cache.paged_truncate_all).
            write = (KV.paged_write_decode if mode == "decode"
                     else KV.paged_write_decode_multi)
            write(cache, new, positions[:, 0], bt, paged.get("active"),
                  ring_len=ring)
            ctx = L.mha_attention_paged(q, cache, bt, positions, **kw)
        elif attend_cache or ("pk_scale" in cache and window is None):
            # prefix-attend admission: write the suffix into the slot's own
            # pages, then attend the gathered block table (shared prefix
            # pages and the fresh suffix alike).  An int8 pool takes this
            # branch even with no prefix, so every query sees the
            # dequantized K/V decode will read (bucketed int8 == chunked
            # int8).  The gather is fp32 for int8 pools: cast to the
            # compute dtype, contiguous, for flash.
            KV.paged_write_prefill(cache, new, cache_pos, bt,
                                   ring_len=ring)
            kk, vv, kp = KV.paged_gather(cache, bt)
            ctx = L.mha_attention(q, kk.to(h.dtype), vv.to(h.dtype),
                                  positions, kp, **kw)
        else:                                       # admission prefill
            ctx = L.mha_attention(q, k, v, positions, positions, **kw)
            KV.paged_write_prefill(cache, new, cache_pos, bt,
                                   ring_len=ring)
    elif mode == "decode":
        # the dense decode step: write the token, then one query against
        # the whole cache (ops.decode_attention inside mha_attention)
        KV.write_decode(cache, new, positions[:, 0])
        ctx = L.mha_attention(q, cache["k"].to(h.dtype),
                              cache["v"].to(h.dtype), positions,
                              cache["pos"], **kw)
    elif mode == "prefill" and attend_cache:
        KV.write_prefill(cache, new, cache_pos)
        ctx = L.mha_attention(q, cache["k"].to(h.dtype),
                              cache["v"].to(h.dtype), positions,
                              cache["pos"], **kw)
    elif mode == "prefill":
        ctx = L.mha_attention(q, k, v, positions, positions, **kw)
        KV.write_prefill(cache, new, cache_pos)
    else:
        raise NotImplementedError(
            f"layer mode {mode!r} is not ported for attention layers")
    return L.attn_out(cfg, p, ctx)


def _hybrid_mix(cfg, p, h, attn_out, cache, mode):
    """Hymba's parallel heads: the Mamba branch on the same normed input
    h, from the state in the layer's cache (zero state in ``"train"``),
    whose new SSM and conv state replace the old there; the layer's mixer
    output is the mean of both branches' normed outputs."""
    if mode == "train":
        ssm, conv = SSM.mamba_zero_state(cfg, h.shape[0], h.dtype,
                                         device=h.device)
    else:
        ssm, conv = cache["ssm"], cache["conv"]
    ssm_out, ssm, conv = SSM.mamba_apply(cfg, p["mamba"], h, ssm, conv,
                                         mode)
    if mode != "train":
        cache["ssm"], cache["conv"] = ssm, conv
    return 0.5 * (L.apply_norm(cfg, p["bn_attn"], SP.like(attn_out, h))
                  + L.apply_norm(cfg, p["bn_ssm"], SP.like(ssm_out, h)))


def _mla_apply(cfg, p, h, *, positions, cache, mode, paged, cache_pos,
               attend_cache, window):
    """MLA of the normed input h: the absorbed form against the latent
    cache in ``"decode"``, the naive form otherwise (a prefill writes its
    latents into the cache)."""
    if mode == "decode":
        return MLAT.mla_decode(cfg, p, h, cache, positions[:, 0])
    if mode == "prefill" and attend_cache:
        return MLAT.mla_prefill_cached(cfg, p, h, cache, positions,
                                       cache_pos, window=window)
    if mode not in ("prefill", "train"):
        raise NotImplementedError(
            f"layer mode {mode!r} is not ported for MLA layers")
    out, new = MLAT.mla_full(cfg, p, h, positions, positions,
                             window=window)
    if mode == "prefill":
        KV.write_prefill(cache, new, cache_pos)
    return out


def _recurrent_apply(cfg, spec, p, x, cache, mode):
    """An mLSTM / sLSTM block (no FFN): ``"prefill"`` runs whole rows from
    the state in ``cache`` (a fresh slot view at admission), ``"decode"``
    one token per slot, and the new state replaces the old in ``cache``;
    ``"train"`` runs whole rows from the zero state and keeps none."""
    if mode not in ("prefill", "decode", "train"):
        raise NotImplementedError(
            f"layer mode {mode!r} is not ported for recurrent layers")
    mlstm = spec.mixer == MLSTM
    fn = SSM.mlstm_apply if mlstm else SSM.slstm_apply
    if mode == "train":
        zero = SSM.mlstm_zero_state if mlstm else SSM.slstm_zero_state
        cache = zero(cfg, x.shape[0], device=x.device)
    out, state = fn(cfg, p["mixer"], L.apply_norm(cfg, p["norm1"], x),
                    cache, mode)
    if mode != "train":
        cache.update(state)
    return x + SP.like(out, x)


def _run_all(cfg, params, x, *, positions, cache, mode, max_len, paged,
             cache_pos=None, attend_cache=False, remat=False):
    """Every layer in execution order; returns (x, the layers' summed MoE
    load-balance loss, None without MoE).  ``remat`` (training)
    recomputes each layer's activations in the backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
    over its scan body."""
    caches = cache["layers"] if cache is not None \
        else [None] * len(params["layers"])
    aux = None
    for spec, p, c in zip(layer_specs(cfg), params["layers"], caches):
        def run(x, spec=spec, p=p, c=c):
            return layer_apply(cfg, spec, p, x, positions=positions,
                               cache=c, mode=mode, max_len=max_len,
                               paged=paged, cache_pos=cache_pos,
                               attend_cache=attend_cache)
        x, a = checkpoint(run, x, use_reentrant=False) if remat else run(x)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _cache_max_len(cfg: ModelConfig, cache) -> int:
    """The max_len a dense cache was built with (its largest position dim
    minus the dump slot), else the config's context."""
    best = max((c["pos"].shape[-1] - 1 for c in cache["layers"]
                if "pos" in c), default=0)
    return best or cfg.max_seq_len


def _embed(cfg, params, tokens, positions, policy, prefix_embeds=None):
    """Token embeddings, after ``prefix_embeds`` (B, P, d) where given,
    plus learned or sinusoidal positions at ``positions`` (B, P + S)."""
    x = L.embed_tokens(cfg, params, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    if cfg.pos_emb == "learned":
        pe = params["embed"]["pos"]
        x = x + pe[positions.long().clamp(0, pe.shape[0] - 1)].to(x.dtype)
    elif cfg.pos_emb == "sinusoidal":
        half = cfg.d_model // 2
        freqs = torch.exp(-torch.arange(half, device=x.device) / half
                          * math.log(10000.0))
        ang = positions[..., None].float() * freqs
        x = x + torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(x.dtype)
    return _maybe_seq_parallel(SP.batch_layout(x.to(policy.compute_dtype)))


def _maybe_seq_parallel(x):
    """seq_parallel (perf flag): shard the token / sequence dim of
    activations over the ``model`` axis of the current mesh instead of
    tensor-parallel weights, the scheme for head counts that do not
    divide the TP degree (``sharding.spmd.seq_parallel``: a DTensor x
    whose sequence divides the axis; anything else passes)."""
    return SP.seq_parallel(x)


def _logits(cfg, params, x, policy):
    h_final = L.apply_norm(cfg, params["final_norm"], x)
    return policy.output_cast(L.unembed(cfg, params, h_final))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def forward_prefill(params, cfg: ModelConfig, tokens, prompt_lengths,
                    cache, *, prefix_embeds=None, policy: Policy = FP32,
                    max_len: Optional[int] = None, last_only: bool = False,
                    start=0, paged=None):
    """Process whole right-padded prompts and fill the cache: a dense
    cache (:func:`init_cache`), the paged pool through ``paged``
    ({"block_tables", "active"}) or recurrent slot state.

    tokens: (B, S), or (B, S, C) for a multi-codebook model;
    ``prefix_embeds`` (B, P, d) go in front of the tokens (a vision
    model's patch embeddings), so the rows hold P + S entries;
    prompt_lengths: (B,) valid entries per row, the prefix included and
    ``start`` not.  ``start`` > 0 (an int, or a (B,) tensor of
    per-row offsets: each admitted request resumes after its own matched
    prefix) continues from entries already in the cache and attends them.
    Tokens sit at positions ``start + 0 .. S-1``; padding lanes keep their
    positions (they attend and are discarded) but write to the dump slot
    or page.  Padding would fold into a recurrent state, so the engine
    admits recurrent models at exact lengths.  Returns (logits (B, S, V),
    or (B, 1, V) at each row's last prompt token with ``last_only``,
    cache)."""
    max_len = max_len or _cache_max_len(cfg, cache)
    B, S = tokens.shape[:2]
    if prefix_embeds is not None:
        S += prefix_embeds.shape[1]
    dev = tokens.device
    attend = not (isinstance(start, int) and start == 0)
    start = torch.as_tensor(start, device=dev).to(torch.int32).reshape(-1, 1)
    positions = (start + torch.arange(S, dtype=torch.int32, device=dev)
                 ).expand(B, S)
    cache_pos = torch.where(
        positions < start + prompt_lengths.to(torch.int32)[:, None],
        positions, -1)
    x = _embed(cfg, params, tokens, positions, policy, prefix_embeds)
    x, _ = _run_all(cfg, params, x, positions=positions, cache=cache,
                    mode="prefill", max_len=max_len, paged=paged,
                    cache_pos=cache_pos, attend_cache=attend)
    if last_only:
        last = (prompt_lengths.long() - 1).clamp_min(0)
        x = x[torch.arange(B, device=dev), last][:, None]
    return _logits(cfg, params, x, policy), cache


def forward_decode(params, cfg: ModelConfig, tokens, cache, lengths, *,
                   policy: Policy = FP32, max_len: Optional[int] = None,
                   paged=None):
    """One new token per slot, against the paged pool (``paged``) or a
    dense cache.  tokens: (B,1) (or (B,1,C)); lengths: (B,) current
    context length (the new token's absolute position).  Writes the
    tokens' K/V into the cache in place.  Returns (logits (B,1,V), or
    (B,1,C,V), cache)."""
    max_len = max_len or _cache_max_len(cfg, cache)
    positions = lengths.to(torch.int32)[:, None]
    x = _embed(cfg, params, tokens, positions, policy)
    x, _ = _run_all(cfg, params, x, positions=positions, cache=cache,
                    mode="decode", max_len=max_len, paged=paged)
    return _logits(cfg, params, x, policy), cache


def forward_verify(params, cfg: ModelConfig, tokens, cache, lengths, *,
                   policy: Policy = FP32, max_len: Optional[int] = None,
                   paged=None):
    """Speculative verify: score a window of K+1 tokens per slot in one
    forward against the paged pool.

    tokens: (B, K+1), the pending token then K drafted tokens; lengths:
    (B,) the pending token's absolute position (:func:`forward_decode` is
    the K == 0 case).  Every layer writes the window's K/V into its pool
    (masked by ``paged["active"]``), then each lane attends causally
    through the stored positions.  Returns (logits (B, K+1, V), cache);
    logits[:, j] scores the token after tokens[:, j].  The caller rewinds
    rejected entries (``kv_cache.paged_truncate_all``)."""
    max_len = max_len or cfg.max_seq_len
    K1 = tokens.shape[1]
    positions = lengths.to(torch.int32)[:, None] + torch.arange(
        K1, dtype=torch.int32, device=tokens.device)
    x = _embed(cfg, params, tokens, positions, policy)
    x, _ = _run_all(cfg, params, x, positions=positions, cache=cache,
                    mode="verify", max_len=max_len, paged=paged)
    return _logits(cfg, params, x, policy), cache


def forward_mixed(params, cfg: ModelConfig, tokens, cache, row_start, n_q,
                  *, policy: Policy = FP32, max_len: Optional[int] = None,
                  paged=None):
    """Per-slot windows of variable length against the paged pool in one
    pass (the engine's ``packed=False`` path sends one (1, W-bucket) row
    per prefill chunk).

    tokens: (B, W), row b holding ``n_q[b]`` real tokens left-aligned;
    row_start: (B,) the absolute position of each row's first token.
    Every real token's K/V is written into the slot's pages, then each
    attends the slot's paged history (earlier chunks, shared prefix pages
    and the window's own earlier tokens); padding lanes carry position -1,
    write to the dump page and return zeros.  Returns (logits (B, 1, V)
    at each row's last real token, cache)."""
    max_len = max_len or cfg.max_seq_len
    B, W = tokens.shape[:2]
    lane = torch.arange(W, dtype=torch.int32, device=tokens.device)
    valid = lane[None, :] < n_q[:, None]
    positions = torch.where(valid, row_start.to(torch.int32)[:, None]
                            + lane[None, :], -1).to(torch.int32)
    paged = dict(paged or {})
    paged["active"] = valid
    x = _embed(cfg, params, tokens, positions, policy)
    x, _ = _run_all(cfg, params, x, positions=positions, cache=cache,
                    mode="verify", max_len=max_len, paged=paged)
    last = (n_q.long() - 1).clamp_min(0)
    x = x[torch.arange(B, device=x.device), last][:, None]
    return _logits(cfg, params, x, policy), cache


def forward_train(params, cfg: ModelConfig, tokens, *, prefix_embeds=None,
                  policy: Policy = FP32, remat: bool = True):
    """A full causal forward with no cache (the reference's
    ``forward_train``): tokens (B, S) (or (B, S, C)), after
    ``prefix_embeds`` (B, P, d) where given, at positions 0 .. P+S-1.
    Returns (logits (B, P+S, V) (or (B, S, C, V)), aux): ``aux["moe_aux"]``
    the layers' summed load-balance loss (a zero fp32 scalar without MoE)
    and, where the config has multi-token prediction and the params its
    module, ``aux["mtp_logits"]`` (B, S-1, V) from the same trunk.
    ``remat`` recomputes each layer in the backward.  Training
    differentiates it; the no-cache baseline and the draft model call it
    under ``torch.no_grad``."""
    x, positions, aux = _trunk(params, cfg, tokens, prefix_embeds, policy,
                               remat)
    aux_d = {"moe_aux": aux}
    if cfg.mtp and "mtp" in params:
        aux_d["mtp_logits"] = _mtp_logits(params, cfg, x, tokens, positions,
                                          policy)
    return _logits(cfg, params, x, policy), aux_d


def _trunk(params, cfg, tokens, prefix_embeds, policy, remat=False):
    """The no-cache forward up to the final norm: (hidden states (B,
    P+S, d), positions (B, P+S), the summed MoE load-balance loss)."""
    B, S = tokens.shape[:2]
    if prefix_embeds is not None:
        S += prefix_embeds.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = _embed(cfg, params, tokens, positions, policy, prefix_embeds)
    x, aux = _run_all(cfg, params, x, positions=positions, cache=None,
                      mode="train", max_len=S, paged=None, remat=remat)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, positions, aux


def _mtp_logits(params, cfg, x, tokens, positions, policy):
    """DeepSeek's multi-token prediction from the trunk's hidden states x
    (B, S, d): the state at i, normed, beside the normed embedding of
    token i + 1, merged by ``mtp["proj"]`` and run through the MTP layer
    (attention + dense FFN) to predict token i + 2 -> (B, S - 1, V)."""
    p = params["mtp"]
    emb_next = L.embed_tokens(cfg, params, tokens[:, 1:]).to(x.dtype)
    merged = torch.cat([L.apply_norm(cfg, p["norm_h"], x[:, :-1]),
                        L.apply_norm(cfg, p["norm_e"], emb_next)], dim=-1)
    h, _ = layer_apply(cfg, MTP_SPEC, p["layer"],
                       SP.batch_layout(merged @ p["proj"].to(x.dtype)),
                       positions=positions[:, :-1], cache=None, mode="train",
                       max_len=positions.shape[1], paged=None)
    return _logits(cfg, params, h, policy)


def forward_mtp(params, cfg: ModelConfig, tokens, *, policy: Policy = FP32):
    """DeepSeek's multi-token prediction (the reference's
    ``_mtp_forward``, which its ``forward_train`` returns as
    ``aux["mtp_logits"]``): the trunk's hidden state at i, normed, beside
    the normed embedding of token i + 1, merged by ``mtp["proj"]`` and run
    through the MTP layer (attention + dense FFN) to predict token i + 2.
    tokens (B, S) -> (logits (B, S, V), MTP logits (B, S - 1, V)).  No
    serving path calls it, as in the reference."""
    if not cfg.mtp or "mtp" not in params:
        raise ValueError(f"{cfg.name} has no multi-token prediction head")
    x, positions, _ = _trunk(params, cfg, tokens, None, policy)
    return (_logits(cfg, params, x, policy),
            _mtp_logits(params, cfg, x, tokens, positions, policy))


def forward_packed(params, cfg: ModelConfig, tokens, cache, slot_ids,
                   positions, seg_last, *, policy: Policy = FP32,
                   max_len: Optional[int] = None, paged=None):
    """Token-packed ragged forward: a whole scheduler iteration — every
    live slot's decode token plus every admitting slot's prefill-chunk
    tokens — as one (1, T) pass against the paged pool.

    tokens: (1, T) flat stream; slot_ids: (T,) owning slot per lane (-1 =
    padding); positions: (T,) absolute positions (-1 = padding);
    seg_last: (S,) stream index of each segment's last real token;
    paged: {"block_tables", "packed_meta"}.  Returns (logits (1, S, V) at
    each segment's last token, cache)."""
    max_len = max_len or cfg.max_seq_len
    pos2 = positions[None, :]
    paged = dict(paged or {})
    paged["slot_ids"] = slot_ids
    x = _embed(cfg, params, tokens, pos2, policy)
    x, _ = _run_all(cfg, params, x, positions=pos2, cache=cache,
                    mode="packed", max_len=max_len, paged=paged)
    x = x[:, seg_last.long()]
    return _logits(cfg, params, x, policy), cache
