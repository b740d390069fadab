"""The port's qwen3-4b path against the reference on reduced qwen3-4b
(fp32, 2 layers, GQA 8/2, head_dim 32, the reference's parameters
converted by ``bridge``; JAX kernel mode "off", the jnp path its own
tests hold equal to its kernels).

RoPE, qk-norm and SwiGLU are held to 1e-5 on numpy inputs: ``pow``,
``cos`` and ``sin`` may differ by an ulp between XLA and PyTorch, and the
matmuls sum in another order.  Logits of ``forward_packed`` (with padding
lanes at position -1) and ``forward_decode`` are held to 1e-4, as on
unimo-text (``test_torch_model.py``), and greedy ``serve_continuous``
streams must equal the reference's on a mixed trace and a shared-prefix
trace.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.core.engine import InferenceEngine as JEngine
from repro.core.precision import FP32 as J_FP32
from repro.core.scheduler import Request as JRequest
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs.registry import get_reduced
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.precision import FP32
from repro_torch.core.scheduler import Request
from repro_torch.kernels import decode_attention as DA
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

SLOTS, PAGE, MAX_LEN = 3, 8, 64
PPS = MAX_LEN // PAGE
NUM_PAGES = SLOTS * PPS


def _np(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    """Reduced qwen3-4b with random (non-zero) q/k-norm and block-norm
    weights, so that the norms' (1 + w) scaling is exercised."""
    jcfg = j_get_reduced("qwen3-4b")
    jparams = jax.tree.map(np.asarray,
                           JT.init_params(jax.random.PRNGKey(0), jcfg,
                                          J_FP32))
    rng = np.random.default_rng(0)
    for pat in jparams["stacks"][0]:
        for n in ("q_norm", "k_norm"):
            pat["attn"][n]["w"] = 0.3 * _np(rng, *pat["attn"][n]["w"].shape)
        for n in ("norm1", "norm2"):
            pat[n]["w"] = 0.3 * _np(rng, *pat[n]["w"].shape)
    jparams = jax.tree.map(jnp.asarray, jparams)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, get_reduced("qwen3-4b"), params


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rope_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = _np(rng, 2, 5, 3, 16)
    pos = np.asarray([[0, 1, 7, 300, -1], [5, 6, 7, 8, 9]], np.int32)
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    ref = np.asarray(JL.rope(jx, jnp.asarray(pos), 1e6).astype(jnp.float32))
    tx = torch.from_numpy(x)
    if dtype == "bfloat16":
        tx = tx.to(torch.bfloat16)
    out = L.rope(tx, torch.from_numpy(pos), 1e6)
    assert out.dtype == tx.dtype
    tol = 1e-5 if dtype == np.float32 else 1e-2
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=tol)


def test_attn_qkv_with_qk_norm_matches_reference(model):
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(2)
    x = _np(rng, 2, 6, cfg.d_model)
    pos = np.asarray([[0, 1, 2, 3, 4, 5], [9, 10, 11, -1, -1, -1]],
                     np.int32)
    jp = jax.tree.map(lambda a: a[0], jparams["stacks"][0][0]["attn"])
    ref = JL.attn_qkv(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    out = L.attn_qkv(cfg, params["layers"][0]["attn"], torch.from_numpy(x),
                     torch.from_numpy(pos))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_swiglu_ffn_matches_reference(model):
    jcfg, jparams, cfg, params = model
    x = _np(np.random.default_rng(3), 2, 4, cfg.d_model)
    jp = jax.tree.map(lambda a: a[0], jparams["stacks"][0][0]["ffn"])
    assert set(params["layers"][0]["ffn"]) == {"wi", "wg", "wo"}
    ref = JL.ffn_apply(jcfg, jp, jnp.asarray(x))
    out = L.ffn_apply(cfg, params["layers"][0]["ffn"], torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def _block_tables():
    bt = np.full((SLOTS, PPS), -1, np.int32)
    for s in range(SLOTS):
        bt[s, :5] = np.arange(5) * SLOTS + s
    return bt


def _stream(rng, vocab, segs, T_):
    tokens = np.zeros(T_, np.int32)
    slot_ids = np.full(T_, -1, np.int32)
    positions = np.full(T_, -1, np.int32)
    starts, lens, slots, last, t = [], [], [], [], 0
    for slot, start, ln in segs:
        tokens[t:t + ln] = rng.integers(4, vocab, size=ln)
        slot_ids[t:t + ln] = slot
        positions[t:t + ln] = np.arange(start, start + ln)
        starts.append(t), lens.append(ln), slots.append(slot)
        t += ln
        last.append(t - 1)
    seg_last = np.zeros(SLOTS, np.int32)
    seg_last[:len(last)] = last
    meta = DA.packed_meta_table(starts, lens, slots, T_,
                                T_ // DA.PACKED_BLOCK_Q + SLOTS)
    return tokens, slot_ids, positions, seg_last, meta


def _jax_packed(model, jcache, bt, stream):
    jcfg, jparams = model[:2]
    tokens, slot_ids, positions, seg_last, meta = stream
    return JT.forward_packed(
        jparams, jcfg, jnp.asarray(tokens[None]), jcache,
        jnp.asarray(slot_ids), jnp.asarray(positions), jnp.asarray(seg_last),
        policy=J_FP32, max_len=MAX_LEN,
        paged={"block_tables": jnp.asarray(bt),
               "packed_meta": jnp.asarray(meta)})


def _history(model, kv_dtype="auto"):
    """The reference's pools after a first iteration (chunks of 14 and 10
    prompt tokens for slots 0 and 1), and the same pools for the port."""
    jcfg = model[0]
    rng = np.random.default_rng(4)
    bt = _block_tables()
    jcache = JT.init_paged_cache(jcfg, num_pages=NUM_PAGES, page_size=PAGE,
                                 max_slots=SLOTS, max_len=MAX_LEN,
                                 dtype=jnp.float32, kv_dtype=kv_dtype)
    first = _stream(rng, jcfg.vocab_size, [(0, 0, 14), (1, 0, 10)], 24)
    _, jcache = _jax_packed(model, jcache, bt, first)
    cache = bridge.pool_from_numpy(jax.tree.map(np.asarray, jcache))
    return rng, bt, jcache, cache


def test_forward_packed_matches_reference(model):
    jcfg, jparams, cfg, params = model
    rng, bt, jcache, cache = _history(model)
    # decode lane, continuing chunk, fresh chunk, 7 padding lanes (-1)
    stream = _stream(rng, jcfg.vocab_size,
                     [(0, 14, 1), (1, 10, 7), (2, 0, 9)], 24)
    assert (stream[2] == -1).sum() == 7
    jl, _ = _jax_packed(model, jcache, bt, stream)
    t = [torch.from_numpy(a) for a in stream]
    tl, _ = T.forward_packed(
        params, cfg, t[0][None], cache, t[1], t[2], t[3], policy=FP32,
        max_len=MAX_LEN, paged={"block_tables": torch.from_numpy(bt),
                                "packed_meta": t[4]})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)


def test_forward_decode_matches_reference(model):
    jcfg, jparams, cfg, params = model
    rng, bt, jcache, cache = _history(model)
    tok = rng.integers(4, jcfg.vocab_size, size=(SLOTS, 1)).astype(np.int32)
    lens = np.asarray([14, 10, 0], np.int32)
    active = np.asarray([True, True, False])
    jl, _ = JT.forward_decode(
        jparams, jcfg, jnp.asarray(tok), jcache, jnp.asarray(lens),
        policy=J_FP32, max_len=MAX_LEN,
        paged={"block_tables": jnp.asarray(bt),
               "active": jnp.asarray(active)})
    tl, _ = T.forward_decode(
        params, cfg, torch.from_numpy(tok), cache, torch.from_numpy(lens),
        policy=FP32, max_len=MAX_LEN,
        paged={"block_tables": torch.from_numpy(bt),
               "active": torch.from_numpy(active)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)


def trace_prompts(kind):
    """"mixed": prompts of mixed length; "shared": the later ones share
    prompt prefixes with the first (one match ends inside a page)."""
    rng = np.random.default_rng(5)

    def body(n):
        return [int(t) for t in rng.integers(4, 500, size=n)]
    first = [[2] + body(n) for n in (19, 30, 11, 23)]
    if kind == "mixed":
        return first + [[2] + body(n) for n in (3, 40, 17)]
    return first + [first[0][:12] + body(9), first[1][:17] + body(12),
                    first[3][:8] + body(6)]


def serve_both(model, policy, j_policy, kind, **serve):
    """Greedy streams of both packages on one trace (8 new tokens each,
    3 slots, 8-token pages, a 24-token budget)."""
    jcfg, jparams, cfg, params = model
    kw = dict(page_size=PAGE, max_batched_tokens=24, **serve)
    prompts = trace_prompts(kind)
    jeng = JEngine(jcfg, jparams, policy=j_policy, max_len=MAX_LEN,
                   max_batch=SLOTS)
    jdone, _ = jeng.serve_continuous(
        [JRequest(uid=i, tokens=p, max_new_tokens=8)
         for i, p in enumerate(prompts)], **kw)
    eng = InferenceEngine(cfg, params, policy=policy, max_len=MAX_LEN,
                          max_batch=SLOTS, device="cpu")
    done, m = eng.serve_continuous(
        [Request(uid=i, tokens=p, max_new_tokens=8)
         for i, p in enumerate(prompts)], **kw)
    return ([r.result for r in jdone], [r.result for r in done], m)


@pytest.mark.parametrize("kind", ["mixed", "shared"])
def test_serve_greedy_matches_reference(model, kind):
    ref, ours, m = serve_both(model, FP32, J_FP32, kind)
    assert ours == ref
    assert m.mixed_iters > 0 and m.dispatches_per_iter == 1.0
    assert m.steps > m.mixed_dispatches
    if kind == "shared":
        assert m.prefix_hits > 0 and m.cow_copies > 0


def test_init_params_shapes_match_reference(model):
    jcfg, jparams, cfg, params = model
    ours = T.init_params(torch.Generator().manual_seed(0), cfg)
    assert "pos" not in ours["embed"]
    flat = {}

    def walk(tree, prefix, out):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}", out)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}/{i}", out)
        else:
            out[prefix] = (tuple(tree.shape), tree.dtype)
    walk(ours, "", flat)
    ref = {}
    walk(params, "", ref)
    assert flat == ref
