"""The port's multi-query paged path against the reference: the plain
``paged_mixed_attention[_q8]`` (the CPU path of the CUDA mixed kernels),
the speculative multi-write and truncation of the paged pools,
``forward_verify`` / ``forward_mixed`` / ``forward_train``, and the
``packed=False`` serve.

Inputs are made by numpy from a seed and fed to both packages.  Attention
and forwards are fp32 and differ only in summation order: kernels within
1e-5 of the reference's Pallas kernels (interpret mode) and oracles,
logits within 1e-4 and pool K/V within 1e-5 (as in test_torch_model;
the dump page's K/V data is excluded, several padding lanes write it).
Positions and int8 scale pools must be bit-equal.  Greedy streams must
be equal.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.core import kv_cache as JKV
from repro.core.engine import InferenceEngine as JEngine
from repro.core.engine import mixed_width_buckets as j_mixed_width_buckets
from repro.core.precision import FP32 as J_FP32
from repro.core.scheduler import Request as JRequest
from repro.kernels import decode_attention as JDA
from repro.kernels import ref as JREF
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs.registry import get_reduced
from repro_torch.core import kv_cache as KV
from repro_torch.core.engine import InferenceEngine, mixed_width_buckets
from repro_torch.core.precision import FP32
from repro_torch.core.scheduler import Request
from repro_torch.kernels import ops
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The plain mixed attention against the Pallas kernels and oracle
# ---------------------------------------------------------------------------

P, PAGE, NPAGES, HKV, D = 14, 8, 4, 2, 16
# (n_q, before): a k+1 = 5 verify window over four slots (one cut short,
# one idle), and one 19-token chunk in a (1, 24) row
SHAPES = {"verify": ([5, 3, 0, 5], [9, 20, 0, 0]), "chunk": ([19], [6])}


def _mixed_case(rng, shape, g, quant):
    n_q, before = SHAPES[shape]
    W = 5 if shape == "verify" else 24
    ctx = [b + n for b, n in zip(before, n_q)]
    ppos = np.full((P, PAGE), -1, np.int32)
    bt = np.full((len(ctx), NPAGES), -1, np.int32)
    perm = rng.permutation(P - 1)
    nxt = 0
    for b, n in enumerate(ctx):
        used = -(-n // PAGE)
        bt[b, :used] = perm[nxt:nxt + used]
        nxt += used
        for t in range(n):
            ppos[bt[b, t // PAGE], t % PAGE] = t
    q_pos = np.full((len(ctx), W), -1, np.int32)
    for b, (b0, n) in enumerate(zip(before, n_q)):
        q_pos[b, :n] = b0 + np.arange(n)
    q = rng.normal(size=(len(ctx), W, HKV * g, D)).astype(np.float32)
    if quant:
        pools = [rng.integers(-127, 128, size=(P, PAGE, HKV, D)).astype(
            np.int8) for _ in range(2)]
        scales = [rng.uniform(0.001, 0.05, size=(P, PAGE, HKV)).astype(
            np.float32) for _ in range(2)]
    else:
        pools = [rng.normal(size=(P, PAGE, HKV, D)).astype(np.float32)
                 for _ in range(2)]
        scales = [None, None]
    return q, pools, scales, ppos, bt, q_pos, n_q


@pytest.mark.parametrize("shape", ["verify", "chunk"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("g,window,softcap", [(1, None, None),
                                              (4, 8, 30.0)])
def test_paged_mixed_matches_reference(shape, quant, g, window, softcap):
    rng = np.random.default_rng(30 + g + 2 * quant)
    q, (kp, vp), (ks, vs), ppos, bt, q_pos, n_q = _mixed_case(
        rng, shape, g, quant)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    sc = dict(k_scale=_t(ks), v_scale=_t(vs)) if quant else {}
    ours = ops.paged_mixed_attention(_t(q), _t(kp), _t(vp), _t(ppos),
                                     _t(bt), _t(q_pos), **sc, **kw).numpy()
    j = {k: jnp.asarray(v) for k, v in dict(q=q, kp=kp, vp=vp, ppos=ppos,
                                             bt=bt, q_pos=q_pos).items()}
    if quant:
        jks, jvs = jnp.asarray(ks), jnp.asarray(vs)
        pallas = JDA.paged_mixed_attention_q8(
            j["q"], j["kp"], jks, j["vp"], jvs, j["ppos"], j["bt"],
            j["q_pos"], interpret=True, **kw)
        oracle = JREF.paged_mixed_attention_ref(
            j["q"], j["kp"], j["vp"], j["ppos"], j["bt"], j["q_pos"],
            k_scale=jks, v_scale=jvs, **kw)
    else:
        pallas = JDA.paged_mixed_attention(
            j["q"], j["kp"], j["vp"], j["ppos"], j["bt"], j["q_pos"],
            interpret=True, **kw)
        oracle = JREF.paged_mixed_attention_ref(
            j["q"], j["kp"], j["vp"], j["ppos"], j["bt"], j["q_pos"], **kw)
    np.testing.assert_allclose(ours, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(ours, np.asarray(oracle), **TOL)
    for b, n in enumerate(n_q):
        assert not ours[b, n:].any()           # padding lanes are exactly 0


# ---------------------------------------------------------------------------
# Speculative multi-write and truncation
# ---------------------------------------------------------------------------

WP, WNPAGES = 12, 4
WDUMP = WP - 1
RING = WNPAGES * PAGE
# slot 0 runs past the ring (positions 30..33: the last two are dumped),
# slot 1 crosses a page boundary, slot 2 has no pages, slot 3 is masked
WBT = np.asarray([[0, 3, 5, 7], [2, 9, -1, -1], [-1] * 4, [1, 4, -1, -1]],
                 np.int32)
WLENS = np.asarray([30, 6, 0, 12], np.int32)
K1 = 4


def _write_pool(rng, quant, layers):
    """A stacked reference pool (``layers`` scan repeats of one pattern
    position) holding slot histories below WLENS, as numpy arrays."""
    ppos = np.full((layers, WP, PAGE), -1, np.int32)
    for s, n in enumerate(WLENS):
        for t in range(n):
            if WBT[s, t // PAGE] >= 0:
                ppos[:, WBT[s, t // PAGE], t % PAGE] = t
    pool = {"ppos": ppos}
    for k in ("pk", "pv"):
        x = rng.normal(size=(layers, WP, PAGE, HKV, D)).astype(np.float32)
        if quant:
            q, s = JKV.quantize_kv(jnp.asarray(x))
            pool[k], pool[k + "_scale"] = np.asarray(q), np.asarray(s)
        else:
            pool[k] = x
    return pool


def _assert_pool_equal(ours, ref):
    """Positions and scale pools bit-equal, K/V within 1e-5 (off the dump
    page)."""
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert set(ours) == set(ref)
    np.testing.assert_array_equal(ours["ppos"].numpy(), ref["ppos"])
    for k in ("pk_scale", "pv_scale"):
        if k in ref:
            np.testing.assert_array_equal(ours[k].numpy()[:WDUMP],
                                          ref[k][:WDUMP])
    for k in ("pk", "pv"):
        np.testing.assert_allclose(ours[k].numpy()[:WDUMP].astype(
            np.float32), ref[k][:WDUMP].astype(np.float32), rtol=0,
            atol=1e-5)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("active", ["rows", "lanes"])
def test_multi_write_and_truncate_match_reference(quant, active):
    rng = np.random.default_rng(40 + quant)
    stacked = _write_pool(rng, quant, layers=2)
    new = {k: rng.normal(size=(4, K1, HKV, D)).astype(np.float32)
           for k in ("k", "v")}
    new["v"][1, 2] = 0.0                      # a zero row: int8 scale 0
    if active == "rows":
        act = np.asarray([True, True, True, False])
    else:
        act = np.ones((4, K1), bool)
        act[0, 1] = act[1, 3] = False
        act[3] = False
    # the write, on layer 0
    layer0 = {k: v[0] for k, v in stacked.items()}
    ours = {k: _t(v) for k, v in layer0.items()}
    KV.paged_write_decode_multi(ours, {k: _t(v) for k, v in new.items()},
                                _t(WLENS), _t(WBT), _t(act), ring_len=RING)
    ref = JKV.paged_write_decode_multi(
        {k: jnp.asarray(v) for k, v in layer0.items()},
        {k: jnp.asarray(v) for k, v in new.items()}, jnp.asarray(WLENS),
        jnp.asarray(WBT), jnp.asarray(act), ring_len=RING)
    _assert_pool_equal(ours, ref)
    # slot 0's positions 32, 33 are past the ring: dumped, not wrapped
    assert ours["ppos"][0, :2].tolist() == [0, 1]
    assert (ours["ppos"][WDUMP] == -1).all()
    # the rewind, over both layers of a model cache
    keep = WLENS + np.asarray([2, 3, 0, 0], np.int32)
    stacked = {k: np.array(v) for k, v in stacked.items()}
    for k, v in ref.items():
        stacked[k][0] = np.asarray(v)
    cache = {"layers": [{k: _t(v[r]) for k, v in stacked.items()}
                        for r in range(2)]}
    KV.paged_truncate_all(cache, _t(WBT), _t(keep))
    jcache = JKV.paged_truncate_all(
        {"layers": (({k: jnp.asarray(v) for k, v in stacked.items()},),)},
        jnp.asarray(WBT), jnp.asarray(keep))
    jl = jcache["layers"][0][0]
    for r in range(2):
        _assert_pool_equal(cache["layers"][r],
                           {k: np.asarray(v)[r] for k, v in jl.items()})
    for s, n in enumerate(keep):
        for pg in WBT[s][WBT[s] >= 0]:
            assert (cache["layers"][0]["ppos"][pg] < max(n, 1)).all()


# ---------------------------------------------------------------------------
# forward_verify / forward_mixed / forward_train
# ---------------------------------------------------------------------------

SLOTS, MAX_LEN = 3, 64
PPS = MAX_LEN // PAGE
NUM_PAGES = SLOTS * PPS
DUMP = NUM_PAGES


@pytest.fixture(scope="module", params=["unimo-text", "qwen3-4b"])
def model(request):
    """Reduced ``arch``; qwen3-4b gets random (non-zero) q/k-norm and
    block-norm weights, so that their (1 + w) scaling is exercised."""
    jcfg = j_get_reduced(request.param)
    jparams = jax.tree.map(np.asarray, JT.init_params(
        jax.random.PRNGKey(0), jcfg, J_FP32))
    if request.param == "qwen3-4b":
        rng = np.random.default_rng(0)
        for pat in jparams["stacks"][0]:
            for n in ("q_norm", "k_norm"):
                w = pat["attn"][n]["w"]
                pat["attn"][n]["w"] = 0.3 * rng.normal(size=w.shape).astype(
                    np.float32)
            for n in ("norm1", "norm2"):
                pat[n]["w"] = 0.3 * rng.normal(
                    size=pat[n]["w"].shape).astype(np.float32)
    params = bridge.params_from_jax(jparams)
    return (jcfg, jax.tree.map(jnp.asarray, jparams),
            get_reduced(request.param), params)


def _block_tables():
    bt = np.full((SLOTS, PPS), -1, np.int32)
    for s in range(SLOTS):
        bt[s, :5] = np.arange(5) * SLOTS + s      # interleaved pages
    return bt


def _history(model):
    """Both packages' pools after the same first mixed forward: 14 and 10
    prompt tokens in slots 0 and 1 (slot 2 idle)."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(0)
    bt = _block_tables()
    jcache = JT.init_paged_cache(jcfg, num_pages=NUM_PAGES, page_size=PAGE,
                                 max_slots=SLOTS, max_len=MAX_LEN,
                                 dtype=jnp.float32)
    toks = rng.integers(4, 400, size=(SLOTS, 16)).astype(np.int32)
    _, jcache = JT.forward_mixed(
        jparams, jcfg, jnp.asarray(toks), jcache,
        jnp.asarray([0, 0, 0], jnp.int32), jnp.asarray([14, 10, 0]),
        policy=J_FP32, max_len=MAX_LEN,
        paged={"block_tables": jnp.asarray(bt)})
    cache = bridge.pool_from_numpy(jax.tree.map(np.asarray, jcache))
    return rng, bt, jcache, cache


def _assert_pools_close(ours, ref_cache, cfg):
    ref = jax.tree.map(np.asarray, ref_cache)
    mine = bridge.pool_to_numpy(ours, cfg)
    for mc, rc in zip(mine["layers"][0], ref["layers"][0]):
        np.testing.assert_array_equal(mc["ppos"], rc["ppos"])
        for k in ("pk", "pv"):
            np.testing.assert_allclose(mc[k][:, :DUMP], rc[k][:, :DUMP],
                                       rtol=0, atol=1e-5)


def test_forward_verify_matches_reference(model):
    jcfg, jparams, cfg, params = model
    rng, bt, jcache, cache = _history(model)
    toks = rng.integers(4, 400, size=(SLOTS, 4)).astype(np.int32)
    lens = np.asarray([14, 10, 0], np.int32)
    act = np.asarray([True, True, False])          # slot 2 rides inactive
    jlogits, jcache = JT.forward_verify(
        jparams, jcfg, jnp.asarray(toks), jcache, jnp.asarray(lens),
        policy=J_FP32, max_len=MAX_LEN,
        paged={"block_tables": jnp.asarray(bt), "active": jnp.asarray(act)})
    logits, cache = T.forward_verify(
        params, cfg, _t(toks), cache, _t(lens), policy=FP32,
        max_len=MAX_LEN, paged={"block_tables": _t(bt), "active": _t(act)})
    assert logits.shape == (SLOTS, 4, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-4)
    _assert_pools_close(cache, jcache, cfg)


@pytest.mark.parametrize("rows", ["chunk", "mixed"])
def test_forward_mixed_matches_reference(model, rows):
    """"chunk": one (1, 16) row continuing slot 1 by 7 tokens (the
    ``packed=False`` engine's shape); "mixed": a decode row, a chunk row
    and an idle row in one call."""
    jcfg, jparams, cfg, params = model
    rng, bt, jcache, cache = _history(model)
    if rows == "chunk":
        start, n_q, bt = [10], [7], bt[1:2]
    else:
        start, n_q = [14, 10, 0], [1, 7, 0]
    toks = rng.integers(4, 400, size=(len(n_q), 16)).astype(np.int32)
    start, n_q = np.asarray(start, np.int32), np.asarray(n_q, np.int32)
    jlogits, jcache = JT.forward_mixed(
        jparams, jcfg, jnp.asarray(toks), jcache, jnp.asarray(start),
        jnp.asarray(n_q), policy=J_FP32, max_len=MAX_LEN,
        paged={"block_tables": jnp.asarray(bt)})
    logits, cache = T.forward_mixed(
        params, cfg, _t(toks), cache, _t(start), _t(n_q), policy=FP32,
        max_len=MAX_LEN, paged={"block_tables": _t(bt)})
    assert logits.shape == (len(n_q), 1, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-4)
    _assert_pools_close(cache, jcache, cfg)


def test_forward_train_matches_reference(model):
    jcfg, jparams, cfg, params = model
    toks = np.random.default_rng(1).integers(4, 400, size=(2, 13)).astype(
        np.int32)
    jlogits, _ = JT.forward_train(jparams, jcfg, jnp.asarray(toks),
                                  policy=J_FP32, remat=False)
    with torch.no_grad():
        logits = T.forward_train(params, cfg, _t(toks), policy=FP32)[0]
    assert logits.shape == (2, 13, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# The packed=False serve
# ---------------------------------------------------------------------------


def test_mixed_width_buckets_match_reference():
    for budget in (8, 20, 32, 256, 1000):
        assert mixed_width_buckets(budget) == j_mixed_width_buckets(budget)


def _prompts():
    """Mixed lengths; the later prompts share prefixes with the first
    (one match ends inside a page: a COW copy)."""
    rng = np.random.default_rng(5)

    def body(n):
        return [int(t) for t in rng.integers(4, 400, size=n)]
    first = [[2] + body(n) for n in (19, 30, 11, 23)]
    return first + [first[0][:12] + body(9), first[1][:17] + body(12),
                    [2] + body(40)]


COUNTERS = ("mixed_iters", "mixed_dispatches", "prefill_chunks",
            "prefill_tokens", "prefill_padded", "steps", "slot_steps_active",
            "decode_tokens", "host_syncs", "prefix_hits", "cow_copies",
            "generated_tokens")


@pytest.mark.parametrize("arch,kv_dtype", [("unimo-text", "auto"),
                                           ("qwen3-4b", "int8")])
def test_packed_off_serve_matches_reference(arch, kv_dtype):
    """Greedy streams of the port's ``packed=False`` serve equal its
    packed serve's and the reference's ``packed=False`` serve's, with the
    reference's counters."""
    jcfg = j_get_reduced(arch)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, J_FP32)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    policy = dataclasses.replace(FP32, kv_dtype=kv_dtype)
    j_policy = dataclasses.replace(J_FP32, kv_dtype=kv_dtype)
    serve = dict(page_size=PAGE, max_batched_tokens=32)
    prompts = _prompts()
    jeng = JEngine(jcfg, jparams, policy=j_policy, max_len=MAX_LEN,
                   max_batch=SLOTS)
    jdone, jm = jeng.serve_continuous(
        copy.deepcopy([JRequest(uid=i, tokens=p, max_new_tokens=10)
                       for i, p in enumerate(prompts)]), packed=False,
        **serve)
    out = {}
    for packed in (False, None):
        eng = InferenceEngine(get_reduced(arch), params, policy=policy,
                              max_len=MAX_LEN, max_batch=SLOTS, device="cpu")
        done, m = eng.serve_continuous(
            [Request(uid=i, tokens=p, max_new_tokens=10)
             for i, p in enumerate(prompts)], packed=packed, **serve)
        out[packed] = ([r.result for r in done], m)
    ref = [r.result for r in jdone]
    ours, m = out[False]
    assert ours == ref == out[None][0]
    assert m.mixed_dispatches > m.mixed_iters > 0    # several per iteration
    assert m.prefill_padded > m.prefill_tokens and m.cow_copies > 0
    assert out[None][1].dispatches_per_iter == 1.0
    for k in COUNTERS:
        assert getattr(m, k) == getattr(jm, k), k
