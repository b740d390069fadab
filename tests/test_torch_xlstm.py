"""The port's xLSTM path against the reference on reduced xlstm-125m (fp32,
2 layers: one mLSTM, one sLSTM; the reference's parameters converted by
``bridge``), on the CPU.

* The mLSTM plain version against the reference's chunked oracle
  (``repro.models.ssm.mlstm_chunked``) at ragged S with a nonzero state,
  and at the CUDA kernel's chunk length (32) as well as the oracle's
  (128): h is held to atol = rtol = 5e-5 (it divides by a denominator
  that passes near zero for random inputs, so fp32 sums in another order
  move it by up to ~1e-5 of its magnitude), C, n and m to atol 1e-5.
* One mLSTM decode step and one sLSTM cell against the reference's
  (fp32: 1e-6, and 1e-5 relative for the mLSTM h, a quotient of two
  128-term dot products).
* ``forward_prefill`` and one ``forward_decode`` from the same weights:
  logits within 1e-4 of the reference's, states within 1e-5.
* ``serve_continuous`` (the bucketed admission fallback): greedy streams
  token for token equal to the reference engine's on the requests of
  ``tests/test_continuous.py`` (mixed lengths; three equal lengths, so
  one batched admission covers several slots), with the same scheduler
  counters.  The options the reference turns off for recurrent families
  warn here as there and leave the streams unchanged.
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
from repro.core import precision as JP
from repro.core.engine import InferenceEngine as JEngine
from repro.core.scheduler import Request as JRequest
from repro.models import ssm as JSSM
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs.registry import get_reduced
from repro_torch.core import kv_cache as KV
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.precision import FP32, compress_weights
from repro_torch.core.scheduler import Request
from repro_torch.core.speculative import SpecConfig
from repro_torch.kernels import ref
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T

ARCH = "xlstm-125m"


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model():
    jcfg = j_get_reduced(ARCH)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, JP.FP32)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, get_reduced(ARCH), params


def test_reduced_config_matches_reference():
    jcfg, cfg = j_get_reduced(ARCH), get_reduced(ARCH)
    for f in ("d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
              "norm", "pos_emb", "tie_embeddings", "num_layers"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert [(s.repeats, [(p.mixer, p.ffn) for p in s.pattern])
            for s in cfg.stacks] == [
        (s.repeats, [(p.mixer, p.ffn) for p in s.pattern])
        for s in jcfg.stacks]
    assert cfg.d_model == 128 and cfg.num_heads == 2 and cfg.num_layers == 2


@pytest.mark.parametrize("chunk", [128, 32])
@pytest.mark.parametrize("S", [64, 128, 200, 300])
def test_mlstm_ref_matches_reference_oracle(S, chunk):
    rng = np.random.default_rng(S)
    B, H, dh = 2, 2, 16
    q, k, v = (rng.normal(size=(B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    k *= dh ** -0.5
    i_pre = rng.normal(size=(B, S, H)).astype(np.float32)
    logf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(
        rng.normal(size=(B, S, H)) + 2, jnp.float32)))
    st = {"C": (rng.normal(size=(B, H, dh, dh)) * 0.1).astype(np.float32),
          "n": np.abs(rng.normal(size=(B, H, dh))).astype(np.float32),
          "m": rng.normal(size=(B, H)).astype(np.float32)}
    h_j, st_j = JSSM.mlstm_chunked(*map(jnp.asarray, (q, k, v, i_pre,
                                                      logf)),
                                   {n: jnp.asarray(a) for n, a in st.items()})
    h, st_t = ref.mlstm_chunked_ref(*map(_t, (q, k, v, i_pre, logf)),
                                    {n: _t(a) for n, a in st.items()},
                                    chunk=chunk)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), rtol=5e-5,
                               atol=5e-5)
    for n in ("C", "n", "m"):
        np.testing.assert_allclose(st_t[n].numpy(), np.asarray(st_j[n]),
                                   rtol=0, atol=1e-5, err_msg=n)


def test_mlstm_step_and_slstm_cell_match_reference(model):
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(1)
    B, H = 3, cfg.num_heads
    dh = 2 * cfg.d_model // H
    q, k, v = (rng.normal(size=(B, 1, H, dh)).astype(np.float32)
               for _ in range(3))
    i_pre, logf = (rng.normal(size=(B, 1, H)).astype(np.float32)
                   for _ in range(2))
    logf = -np.abs(logf)
    st = {"C": (rng.normal(size=(B, H, dh, dh)) * 0.1).astype(np.float32),
          "n": np.abs(rng.normal(size=(B, H, dh))).astype(np.float32),
          "m": rng.normal(size=(B, H)).astype(np.float32)}
    h_j, s_j = JSSM.mlstm_step(*map(jnp.asarray, (q, k, v, i_pre, logf)),
                               {n: jnp.asarray(a) for n, a in st.items()})
    h, s = SSM.mlstm_step(*map(_t, (q, k, v, i_pre, logf)),
                          {n: _t(a) for n, a in st.items()})
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), rtol=1e-5,
                               atol=1e-6)
    for n in s:
        np.testing.assert_allclose(s[n].numpy(), np.asarray(s_j[n]),
                                   rtol=1e-6, atol=1e-6)
    d = cfg.d_model
    dhs = d // H
    jp = jax.tree.map(lambda a: a[0], jparams["stacks"][0][1]["mixer"])
    wx = rng.normal(size=(B, 4 * d)).astype(np.float32)
    st = {n: rng.normal(size=(B, H, dhs)).astype(np.float32)
          for n in ("c", "h")}
    st["n"] = np.abs(rng.normal(size=(B, H, dhs))).astype(np.float32) + 0.5
    st["m"] = rng.normal(size=(B, H)).astype(np.float32)
    out_j = JSSM._slstm_cell(jcfg, jp, jnp.asarray(wx),
                             {n: jnp.asarray(a) for n, a in st.items()})
    out = SSM._slstm_cell(cfg, params["layers"][1]["mixer"], _t(wx),
                          {n: _t(a) for n, a in st.items()})
    for n in ("c", "n", "h", "m"):
        np.testing.assert_allclose(out[n].numpy(), np.asarray(out_j[n]),
                                   rtol=1e-6, atol=1e-6, err_msg=n)


def test_forward_prefill_and_decode_match_reference(model):
    """Three rows of 37 tokens (more than one 32-step kernel chunk): full
    prefill logits and the dense state of every slot, then one decode
    step from that state."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(2)
    B, S = 3, 37
    toks = rng.integers(4, cfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.full((B,), S, np.int32)
    jcache = JT.init_paged_cache(jcfg, num_pages=4, page_size=8,
                                 max_slots=B, max_len=64,
                                 dtype=jnp.float32)
    lj, jcache = JT.forward_prefill(jparams, jcfg, jnp.asarray(toks),
                                    jnp.asarray(lens), jcache,
                                    policy=JP.FP32, max_len=64)
    cache = T.init_paged_cache(cfg, num_pages=4, page_size=8,
                               dtype=torch.float32, max_slots=B)
    with torch.no_grad():
        lt, cache = T.forward_prefill(params, cfg, _t(toks), _t(lens), cache,
                                      policy=FP32, max_len=64)
        last, _ = T.forward_prefill(
            params, cfg, _t(toks), _t(lens),
            T.init_paged_cache(cfg, num_pages=4, page_size=8,
                               dtype=torch.float32, max_slots=B),
            policy=FP32, max_len=64, last_only=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(last.numpy(), lt[:, -1:].numpy(), rtol=0,
                               atol=1e-5)
    _assert_states_close(cache, cfg, jcache)

    nxt = rng.integers(4, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    dj, jcache = JT.forward_decode(jparams, jcfg, jnp.asarray(nxt), jcache,
                                   jnp.asarray(lens), policy=JP.FP32,
                                   max_len=64)
    with torch.no_grad():
        dt, cache = T.forward_decode(params, cfg, _t(nxt), cache, _t(lens),
                                     policy=FP32, max_len=64)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                               atol=1e-4)
    _assert_states_close(cache, cfg, jcache)


def _assert_states_close(cache, cfg, jcache):
    ours = bridge.pool_to_numpy(cache, cfg)["layers"]
    for pos, (a, b) in enumerate(zip(ours[0], jcache["layers"][0])):
        assert set(a) == set(b), (set(a), set(b))
        for n in a:
            np.testing.assert_allclose(a[n], np.asarray(b[n]), rtol=0,
                                       atol=1e-5, err_msg=f"{pos}/{n}")


def test_recurrent_cache_and_slot_api():
    """Dense per-slot state of the reference's shapes, no paged bytes,
    fresh zero rows in a slot view, and a merge that lands only in the
    given slots; the bridge carries the state both ways."""
    cfg, jcfg = get_reduced(ARCH), j_get_reduced(ARCH)
    cache = T.init_paged_cache(cfg, num_pages=6, page_size=8,
                               dtype=torch.float32, max_slots=3)
    jc = JT.init_paged_cache(jcfg, num_pages=6, page_size=8, max_slots=3,
                             max_len=64, dtype=jnp.float32)
    back = bridge.pool_from_numpy(jax.tree.map(np.asarray, jc))
    assert [{n: tuple(t.shape) for n, t in c.items()}
            for c in cache["layers"]] == [
        {n: tuple(t.shape) for n, t in c.items()} for c in back["layers"]]
    assert cache["layers"][0]["C"].shape == (3, 2, 128, 128)
    assert KV.paged_pool_bytes(cache) == JKV.paged_pool_bytes(jc) == 0
    for c in cache["layers"]:
        for t in c.values():
            t.fill_(7.0)
    KV.reset_pages_all(cache, torch.tensor([[6, 6]]))    # no pools: no-op
    view = KV.slot_view(cache, 2)
    assert all(not t.any() and t.shape[0] == 2
               for c in view["layers"] for t in c.values())
    for c in view["layers"]:
        for t in c.values():
            t.copy_(torch.arange(2.0).reshape((2,) + (1,) * (t.dim() - 1)))
    KV.slot_merge(cache, view, torch.tensor([2, 0]))
    for c in cache["layers"]:
        for t in c.values():
            assert (t[2] == 0).all() and (t[0] == 1).all() \
                and (t[1] == 7).all()
    with pytest.raises(ValueError, match="max_slots"):
        T.init_paged_cache(cfg, num_pages=6, page_size=8)


def _requests(cls, lens_new, vocab):
    rng = np.random.default_rng(0)
    return [cls(uid=i, tokens=[2] + list(map(int, rng.integers(
        4, min(vocab, 400), size=ln))), max_new_tokens=mn)
        for i, (ln, mn) in enumerate(lens_new)]


SERVES = {
    # tests/test_continuous.py: mixed lengths, 2 slots; three equal
    # lengths in 3 slots (one batched admission of 2, then 1)
    "mixed": (dict(max_len=64, max_batch=2), dict(page_size=8,
                                                  steps_per_sync=3),
              [(5, 5), (11, 4), (3, 6), (20, 5)]),
    "equal": (dict(max_len=64, max_batch=3), dict(page_size=8,
                                                  steps_per_sync=2),
              [(7, 4), (7, 4), (7, 4)]),
}


def _serve_port(params, name, **kw):
    eng_kw, serve_kw, lens = SERVES[name]
    cfg = get_reduced(ARCH)
    eng = InferenceEngine(cfg, params, policy=FP32, device="cpu", **eng_kw)
    done, m = eng.serve_continuous(_requests(Request, lens, cfg.vocab_size),
                                   **serve_kw, **kw)
    return {r.uid: r.result for r in done}, m


@pytest.mark.parametrize("name", sorted(SERVES))
def test_serve_matches_reference_greedy(model, name):
    jcfg, jparams, _, params = model
    eng_kw, serve_kw, lens = SERVES[name]
    jeng = JEngine(jcfg, jparams, policy=JP.FP32, **eng_kw)
    jdone, jm = jeng.serve_continuous(
        copy.deepcopy(_requests(JRequest, lens, jcfg.vocab_size)),
        **serve_kw)
    ours, m = _serve_port(params, name)
    assert ours == {r.uid: r.result for r in jdone}
    assert m.scheduler == jm.scheduler == "bucketed"
    assert m.max_batched_tokens == jm.max_batched_tokens == 0
    assert m.kv_bytes_per_token == jm.kv_bytes_per_token == 0
    for k in ("admitted", "retired", "generated_tokens", "prefill_tokens",
              "prefill_padded", "host_syncs", "steps", "slot_steps_active",
              "slot_steps_total", "peak_pages_in_use", "admission_stalls",
              "decode_tokens", "prefix_hits"):
        assert getattr(m, k) == getattr(jm, k), k
    assert m.prefill_padded == m.prefill_tokens
    assert m.outcome_counts == {"completed": len(lens)}


def test_turned_off_options_warn_and_change_nothing(model):
    """spec, packed, prefix_cache, chunked_prefill and preemption are
    turned off for a recurrent model with the reference's warnings; the
    streams stay those of the default serve."""
    *_, params = model
    base, _ = _serve_port(params, "equal")
    cases = {"speculative decoding requested but disabled":
             dict(spec=SpecConfig(k=2)),
             "packed execution requested but disabled":
             dict(packed=True),
             "prefix_cache requested but disabled": dict(prefix_cache=True),
             "chunked prefill requested but disabled":
             dict(chunked_prefill=True),
             "preemption requested but disabled": dict(preemption="lru")}
    for msg, kw in cases.items():
        with pytest.warns(UserWarning, match=msg):
            out, m = _serve_port(params, "equal", **kw)
        assert out == base, msg
        assert m.spec_mode == "off" and m.prefix_hits == 0
        assert m.preemptions == 0


def test_attention_refusals_that_still_stand():
    """What the port still refuses for attention layers: a paged prefill
    without block tables, and a verify window against a dense cache
    (multi-token windows need the paged pool, as in the reference)."""
    cfg = get_reduced("qwen3-4b")
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    cache = T.init_paged_cache(cfg, num_pages=2, page_size=8,
                               dtype=torch.float32)
    with pytest.raises(ValueError, match="block_tables"):
        T.forward_prefill(params, cfg, torch.zeros(1, 3, dtype=torch.int32),
                          torch.tensor([3]), cache, max_len=32)
    dense = T.init_cache(cfg, 1, 32, torch.float32)
    with pytest.raises(NotImplementedError, match="paged"):
        T.forward_verify(params, cfg, torch.zeros(1, 3, dtype=torch.int32),
                         dense, torch.tensor([0]), max_len=32)


def test_int8_weights_quantize_only_the_tied_head(model):
    """The serve-weight walker finds no dense attention/FFN weight in
    xLSTM's mixers: int8 weights quantize exactly the tied head, to the
    reference's codes and scales."""
    jcfg, jparams, _, params = model
    jnew, jstats = JP.compress_weights(jparams, dataclasses.replace(
        JP.FP32, weights_dtype="int8"))
    new, stats = compress_weights(params, dataclasses.replace(
        FP32, weights_dtype="int8"))
    assert stats["n_quantized"] == jstats["n_quantized"] == 1
    for k in ("weight_bytes", "weight_bytes_dense", "weight_bytes_saved"):
        assert stats[k] == jstats[k], k
    np.testing.assert_array_equal(new["embed"]["head_q8"]["q"].numpy(),
                                  np.asarray(jnew["embed"]["head_q8"]["q"]))
    np.testing.assert_allclose(new["embed"]["head_q8"]["s"].numpy(),
                               np.asarray(jnew["embed"]["head_q8"]["s"]),
                               rtol=1e-7)
