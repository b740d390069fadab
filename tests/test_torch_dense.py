"""The port's dense KV cache and its prefill / decode forwards, and the
paged admission prefill, against the reference package.

The cache updates only move data, so the port's caches must equal the
reference's exactly after the same update, except the K/V data of the
dump slot (or page), where several padding lanes may write in one scatter
and either framework keeps an unspecified one: its positions must stay
-1, which is all the dump promises.  Forwards (fp32, the kernels' plain
versions) hold logits and caches to 1e-5: XLA and PyTorch sum fp32
matmuls in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.registry import get_reduced as j_get_reduced
from repro.core import kv_cache as JKV
from repro.core.precision import FP32 as J_FP32
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs.base import LayerSpec
from repro_torch.configs.registry import get_reduced
from repro_torch.core import kv_cache as KV
from repro_torch.core.precision import FP32
from repro_torch.models import transformer as T

TOL = 1e-5
INT8_TOL = 2e-2
B, H, D = 3, 2, 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread keeps them fast when several
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jprefill(jparams, jcfg, toks, lens, cache, *, start=0, paged=None,
              **kw):
    """The reference's ``forward_prefill`` compiled whole, as its engine
    runs it (op by op it takes seconds a call).  An int ``start`` stays
    static: the reference attends the cache only for a start that is not
    the int 0."""
    static = isinstance(start, int)

    def f(p, t, n, c, s, pg):
        return JT.forward_prefill(p, jcfg, t, n, c, start=start if static
                                  else s, paged=pg, **kw)
    return jax.jit(f)(jparams, jnp.asarray(toks), jnp.asarray(lens), cache,
                      None if static else jnp.asarray(start), paged)


def _assert_dense_same(ours, ref):
    """Positions everywhere, K/V outside the dump slot, exactly."""
    np.testing.assert_array_equal(ours["pos"].numpy(), np.asarray(ref["pos"]))
    assert (np.asarray(ref["pos"])[:, -1] == -1).all()
    for k in ("k", "v"):
        np.testing.assert_array_equal(ours[k].numpy()[:, :-1],
                                      np.asarray(ref[k])[:, :-1])


@pytest.mark.parametrize("max_len,window", [(64, None), (256, None),
                                            (300, None), (300, 40)])
def test_layer_cache_shape_matches_reference(max_len, window):
    """Shapes, dtypes and the empty positions, including the dump slot and
    the rounding of the sequence axis to a multiple of 256 above 256
    (300 + 1 -> 512) and a window's ring (40 + 1)."""
    ours = KV.layer_cache_shape(get_reduced("qwen3-4b"),
                                LayerSpec(window=window), 2, max_len,
                                torch.bfloat16)
    ref = JKV.layer_cache_shape(j_get_reduced("qwen3-4b"),
                                JLayerSpec(window=window), 2, max_len,
                                jnp.bfloat16)
    assert set(ours) == set(ref)
    for k in ref:
        assert tuple(ours[k].shape) == ref[k].shape, k
        np.testing.assert_array_equal(bridge._to_numpy(ours[k]),
                                      np.asarray(ref[k], np.float32)
                                      if k != "pos" else np.asarray(ref[k]))
    assert ours["k"].dtype == torch.bfloat16 and ours["pos"].dtype == \
        torch.int32


@pytest.mark.parametrize("arch", ["unimo-text", "qwen3-4b", "xlstm-125m"])
def test_init_cache_matches_reference(arch):
    ours = bridge.pool_to_numpy(T.init_cache(get_reduced(arch), 2, 48,
                                             torch.float32),
                                get_reduced(arch))
    ref = JT.init_cache(j_get_reduced(arch), 2, 48, jnp.float32)
    flat_o = jax.tree_util.tree_leaves_with_path(ours)
    flat_r = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in flat_o] == [p for p, _ in flat_r]
    for (path, a), (_, b) in zip(flat_o, flat_r):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))


def _dense(rng, S):
    pos = rng.integers(-1, 30, size=(B, S)).astype(np.int32)
    pos[:, -1] = -1
    return {"k": rng.normal(size=(B, S, H, D)).astype(np.float32),
            "v": rng.normal(size=(B, S, H, D)).astype(np.float32),
            "pos": pos}


@pytest.mark.parametrize("S,ring", [(7, 12), (14, 8)])
def test_write_prefill_matches_reference(S, ring):
    """Right-padded prompts of 7, 3 and 0 valid tokens (S = 7), or 14, 9
    and 2 (S = 14) against a ring of 8 entries: only each row's last 8
    valid tokens land, wrapping."""
    rng = np.random.default_rng(2)
    cache = _dense(rng, ring + 1)
    lens = [7, 3, 0] if S == 7 else [14, 9, 2]
    pos = np.full((B, S), -1, np.int32)
    for b, n in enumerate(lens):
        pos[b, :n] = np.arange(n)
    new = {k: rng.normal(size=(B, S, H, D)).astype(np.float32)
           for k in ("k", "v")}
    ours = KV.write_prefill({k: _t(v) for k, v in cache.items()},
                            {k: _t(v) for k, v in new.items()}, _t(pos))
    ref = JKV.write_prefill({k: jnp.asarray(v) for k, v in cache.items()},
                            {k: jnp.asarray(v) for k, v in new.items()},
                            jnp.asarray(pos))
    _assert_dense_same(ours, ref)


def test_write_decode_and_cache_mask_match_reference():
    """One token per row at positions 3, 11 (wrapping a ring of 8) and 0;
    then the mask over the written positions, with and without a
    window."""
    rng = np.random.default_rng(3)
    cache = _dense(rng, 9)
    lens = np.asarray([3, 11, 0], np.int32)
    new = {k: rng.normal(size=(B, 1, H, D)).astype(np.float32)
           for k in ("k", "v")}
    ours = KV.write_decode({k: _t(v) for k, v in cache.items()},
                           {k: _t(v) for k, v in new.items()}, _t(lens))
    ref = JKV.write_decode({k: jnp.asarray(v) for k, v in cache.items()},
                           {k: jnp.asarray(v) for k, v in new.items()},
                           jnp.asarray(lens))
    _assert_dense_same(ours, ref)
    q_pos = np.asarray([[3], [11], [0]], np.int32)
    for window in (None, 4):
        np.testing.assert_array_equal(
            KV.cache_mask(ours["pos"], _t(q_pos), window).numpy(),
            np.asarray(JKV.cache_mask(ref["pos"], jnp.asarray(q_pos),
                                      window)))


@pytest.mark.parametrize("quant", [False, True])
def test_paged_write_prefill_matches_reference(quant):
    """Bucket-padded prompts (one resuming at position 5, one with an
    unallocated tail page, one all padding) scattered into bf16 or int8
    pools through the block tables: codes, scales and positions equal the
    reference's outside the dump page."""
    rng = np.random.default_rng(4)
    P, page, npages, S = 10, 4, 3, 8
    dump = P - 1
    kv = rng.normal(size=(2, P, page, H, D)).astype(np.float32)
    ppos = rng.integers(-1, 9, size=(P, page)).astype(np.int32)
    ppos[dump] = -1
    if quant:
        (pk, pks), (pv, pvs) = (JKV.quantize_kv(jnp.asarray(x)) for x in kv)
        pool = {k: np.asarray(v) for k, v in (
            ("pk", pk), ("pv", pv), ("pk_scale", pks), ("pv_scale", pvs))}
    else:                    # bf16 values, exact in fp32 on both sides
        pool = {"pk": np.asarray(jnp.asarray(kv[0], jnp.bfloat16),
                                 np.float32),
                "pv": np.asarray(jnp.asarray(kv[1], jnp.bfloat16),
                                 np.float32)}
    pool["ppos"] = ppos
    bt = np.asarray([[0, 1, 2], [3, 4, -1], [5, 6, 7]], np.int32)
    cache_pos = np.full((B, S), -1, np.int32)
    cache_pos[0, :6] = 5 + np.arange(6)
    cache_pos[1] = np.arange(S) + 2
    new = {k: rng.normal(size=(B, S, H, D)).astype(np.float32)
           for k in ("k", "v")}
    bf16 = {"pk", "pv"} if not quant else set()
    ref = JKV.paged_write_prefill(
        {k: jnp.asarray(v, jnp.bfloat16 if k in bf16 else None)
         for k, v in pool.items()},
        {k: jnp.asarray(v) for k, v in new.items()},
        jnp.asarray(cache_pos), jnp.asarray(bt), ring_len=npages * page)
    ours = KV.paged_write_prefill(
        {k: _t(v).to(torch.bfloat16) if k in bf16 else _t(v)
         for k, v in pool.items()},
        {k: _t(v) for k, v in new.items()}, _t(cache_pos), _t(bt),
        ring_len=npages * page)
    np.testing.assert_array_equal(ours["ppos"].numpy(),
                                  np.asarray(ref["ppos"]))
    for k in ref:
        np.testing.assert_array_equal(
            bridge._to_numpy(ours[k])[:dump],
            np.asarray(ref[k]).astype(bridge._to_numpy(ours[k]).dtype)
            [:dump], err_msg=k)


@pytest.fixture(scope="module", params=["unimo-text", "qwen3-4b"])
def model(request):
    jcfg = j_get_reduced(request.param)
    jparams = jax.jit(lambda key: JT.init_params(key, jcfg, J_FP32))(
        jax.random.PRNGKey(0))
    return (jcfg, jparams, get_reduced(request.param),
            bridge.params_from_jax(jax.tree.map(np.asarray, jparams)))


def test_dense_forwards_match_reference(model):
    """A ragged prefill (9, 5 and 1 valid tokens of 9) into a fresh dense
    cache, a prefill resuming at position 9 that attends the cache
    (``start > 0``), then a decode step: logits and caches within 1e-5
    of the reference's."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(6)
    toks = rng.integers(4, 400, size=(B, 9)).astype(np.int32)
    lens = np.asarray([9, 5, 1], np.int32)
    more = rng.integers(4, 400, size=(B, 4)).astype(np.int32)
    nxt = rng.integers(4, 400, size=(B, 1)).astype(np.int32)
    jc = JT.init_cache(jcfg, B, 40, jnp.float32)
    tc = T.init_cache(cfg, B, 40, torch.float32)
    outs = []
    with torch.no_grad():
        jl, jc = _jprefill(jparams, jcfg, toks, lens, jc, policy=J_FP32)
        tl, tc = T.forward_prefill(params, cfg, _t(toks), _t(lens), tc,
                                   policy=FP32)
        outs.append((tl, jl, bridge.pool_to_numpy(tc, cfg), jc))
        full = np.full((B,), 4, np.int32)
        jl, jc = _jprefill(jparams, jcfg, more, full, jc, policy=J_FP32,
                           start=9)
        tl, tc = T.forward_prefill(params, cfg, _t(more), _t(full), tc,
                                   policy=FP32, start=9)
        outs.append((tl, jl, bridge.pool_to_numpy(tc, cfg), jc))
        jl, jc = jax.jit(lambda p, t, c, n: JT.forward_decode(
            p, jcfg, t, c, n, policy=J_FP32))(
                jparams, jnp.asarray(nxt), jc,
                jnp.asarray(np.full(B, 13, np.int32)))
        tl, tc = T.forward_decode(params, cfg, _t(nxt), tc,
                                  _t(np.full(B, 13, np.int32)), policy=FP32)
        outs.append((tl, jl, bridge.pool_to_numpy(tc, cfg), jc))
    # (the port updates its cache in place: each step's copy was taken
    # as it ran)
    for step, (tl, jl, tn, jcache) in enumerate(outs):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL, err_msg=f"logits {step}")
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(tn),
                jax.tree_util.tree_leaves_with_path(jcache)):
            b = np.asarray(b)
            if a.ndim == 5:               # K/V: the dump slot is unspecified
                a, b = a[:, :, :-1], b[:, :, :-1]
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL,
                                       err_msg=f"cache {step} {path}")


@pytest.mark.parametrize("kind", ["admit", "prefix", "int8"])
def test_paged_prefill_forwards_match_reference(model, kind):
    """The bucketed admission's forward against the paged pool: whole
    prompts from position 0 (``admit``), suffixes resuming after prefix
    pages already in the pool and attending them (``prefix``: per-row
    starts 8 and 0), and whole prompts over an int8 pool, which attend
    their written-then-gathered pages.  Last-token logits and pools within
    1e-5 of the reference's (outside the dump page)."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(7)
    page, npages, S = 4, 5, 8
    slots = 2
    num_pages = slots * npages
    kv_dtype = "int8" if kind == "int8" else "auto"
    jpool = JT.init_paged_cache(jcfg, num_pages=num_pages, page_size=page,
                                max_slots=slots, max_len=npages * page,
                                dtype=jnp.float32, kv_dtype=kv_dtype)
    bt = np.arange(num_pages, dtype=np.int32).reshape(slots, npages)
    start = np.asarray([8, 0] if kind == "prefix" else [0, 0], np.int32)
    if kind == "prefix":
        # row 0's first 8 positions were prefilled earlier
        pre = rng.integers(4, 400, size=(1, 8)).astype(np.int32)
        _, jpool = _jprefill(
            jparams, jcfg, pre, np.asarray([8], np.int32), jpool,
            policy=J_FP32, max_len=npages * page, last_only=True,
            paged={"block_tables": jnp.asarray(bt[:1])})
    tpool = bridge.pool_from_numpy(jax.tree.map(np.asarray, jpool))
    toks = rng.integers(4, 400, size=(slots, S)).astype(np.int32)
    lens = np.asarray([6, 8], np.int32)
    jl, jpool = _jprefill(
        jparams, jcfg, toks, lens, jpool, policy=J_FP32,
        max_len=npages * page, last_only=True,
        start=start if kind == "prefix" else 0,
        paged={"block_tables": jnp.asarray(bt)})
    with torch.no_grad():
        tl, tpool = T.forward_prefill(
            params, cfg, _t(toks), _t(lens), tpool, policy=FP32,
            max_len=npages * page, last_only=True,
            start=_t(start) if kind == "prefix" else 0,
            paged={"block_tables": _t(bt)})
    tn = bridge.pool_to_numpy(tpool, cfg)
    flips = codes = 0
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(tn),
                                 jax.tree_util.tree_leaves_with_path(jpool)):
        b = np.asarray(b)
        if a.ndim >= 3 and a.shape[1] == num_pages + 1:
            a, b = a[:, :num_pages], b[:, :num_pages]      # not the dump
        if a.dtype == np.int8:
            # a K/V value an ulp apart on a rounding boundary takes the
            # next code
            d = np.abs(a.astype(int) - b.astype(int))
            assert d.max() <= 1, path
            flips, codes = flips + int(d.sum()), codes + d.size
        else:
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL,
                                       err_msg=str(path))
    # equal codes give logits within 1e-5.  A flipped code moves an
    # attention output by up to 1/127 of its row's absmax, and the next
    # layer's K/V with it (reduced unimo-text: one flip in layer 0, 18
    # in layer 1, of 40,960 codes)
    assert flips <= 1e-3 * codes
    tol = TOL if flips == 0 else INT8_TOL
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                               rtol=tol)
