"""phi3-mini-3.8b, gemma2-2b and gemma3-27b on the port, against the
reference package.

Their reduced configs in fp32 (the kernels' plain versions), the same
parameters in both packages (``bridge.params_from_jax``): phi3's untied
head, gemma's sandwich norms, GeGLU, softcaps and (gemma3) qk-norm and a
windowed layer's own RoPE theta.  Every sequence is longer than the
reduced window of 64, so the windowed layers' rings wrap: the dense ring
holds 64 entries at max_len 128, the paged ring 9 pages of 8.

Tolerances: logits and caches 1e-5 (XLA and PyTorch sum fp32 matmuls in
other orders, ~3e-6 at these widths), positions exactly; greedy streams,
warnings and counters exactly.  int8 serves are held against the
reference's int8 path, not against fp32.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import kv_cache as JKV
from repro.core import pipeline as JPIPE
from repro.core import precision as JP
from repro.core.engine import InferenceEngine as JEngine
from repro.core.scheduler import Request as JRequest
from repro.core.speculative import SpecConfig as JSpecConfig
from repro.core.tokenizer import FastTokenizer as JTokenizer
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.configs.base import LayerSpec, layer_specs
from repro_torch.core import kv_cache as KV
from repro_torch.core import pipeline as PIPE
from repro_torch.core import precision as P
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.scheduler import Request
from repro_torch.core.speculative import SpecConfig
from repro_torch.core.tokenizer import FastTokenizer
from repro_torch.models import transformer as T

ARCHS = ["phi3-mini-3.8b", "gemma2-2b", "gemma3-27b"]
GEMMAS = ["gemma2-2b", "gemma3-27b"]
ENGINE = dict(max_len=128, max_batch=3)
PAGE = 8
TOL = 1e-5
COUNTERS = ("admitted", "retired", "prefill_tokens", "prefill_padded",
            "prefix_hits", "pages_shared", "cow_copies", "host_syncs",
            "steps", "mixed_iters", "mixed_dispatches", "prefill_chunks",
            "generated_tokens", "peak_pages_in_use")
INT8 = dict(kv_dtype="int8", weights_dtype="int8")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread keeps them fast when several
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """Both packages' reduced configs and parameters of ``arch`` (the
    reference's init compiled whole)."""
    jcfg = JR.get_reduced(arch)
    jparams = jax.jit(lambda key: JT.init_params(key, jcfg, JP.FP32))(
        jax.random.PRNGKey(0))
    return (jcfg, jparams, R.get_reduced(arch),
            bridge.params_from_jax(jax.tree.map(np.asarray, jparams)))


def _prompts(n_tokens, seed=5):
    rng = np.random.default_rng(seed)
    return [[2] + [int(t) for t in rng.integers(4, 400, size=n - 1)]
            for n in n_tokens]


# lengths past the window (64), one wrapping the 72-entry paged ring
LONG = (70, 100, 20, 45)


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------


def _stacks(cfg):
    return [([(s.mixer, s.ffn, s.window) for s in st.pattern], st.repeats)
            for st in cfg.stacks]


@pytest.mark.parametrize("which", ["get_config", "get_reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, which):
    """Every field the port's config has equals the reference's (the
    reference's MoE / MLA / SSM / multimodal fields are unset for these
    three); the registry lists the arch and ``check_supported`` admits
    it."""
    ours, ref = getattr(R, which)(arch), getattr(JR, which)(arch)
    for f in dataclasses.fields(ours):
        if f.name == "stacks":
            assert _stacks(ours) == _stacks(ref)
        else:
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert (ref.moe, ref.mla, ref.ssm, ref.num_prefix_embeds,
            ref.num_codebooks, ref.mtp) == (None, None, None, 0, 0, False)
    assert arch in R.list_archs()
    T.check_supported(ours)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_match_port_init(arch):
    """The bridge carries the untied ``embed.head`` and the sandwich
    post-norms; the port's own init draws the same tree, leaf for leaf in
    shape, at the policy's dtype."""
    *_, cfg, params = _weights(arch)
    ours = T.init_params(torch.Generator().manual_seed(0), cfg, P.BF16)

    def shapes(t, pre=""):
        if isinstance(t, dict):
            return {k: v for key, sub in t.items()
                    for k, v in shapes(sub, f"{pre}/{key}").items()}
        if isinstance(t, list):
            return {k: v for i, sub in enumerate(t)
                    for k, v in shapes(sub, f"{pre}/{i}").items()}
        return {pre: (tuple(t.shape), t.dtype)}
    got = shapes(ours)
    assert {k: s for k, (s, _) in got.items()} == {
        k: s for k, (s, _) in shapes(params).items()}
    assert {d for _, d in got.values()} == {torch.bfloat16}
    assert ("/embed/head" in got) == (arch == "phi3-mini-3.8b")
    if arch == "phi3-mini-3.8b":
        assert got["/embed/head"][0] == (cfg.d_model, cfg.vocab_size)
    assert ("/layers/0/norm2_post/w" in got) == cfg.sandwich_norm


@pytest.mark.parametrize("mode", ["int8", "bf16", "auto"])
def test_compress_weights_untied_head_matches_reference(mode):
    """phi3's untied head is quantized (or cast) in place as one more
    record; byte counts, record counts and codes equal the reference's."""
    jcfg, jparams, cfg, params = _weights("phi3-mini-3.8b")
    jnew, jstats = JP.compress_weights(
        jparams, dataclasses.replace(JP.FP32, weights_dtype=mode))
    new, stats = P.compress_weights(
        params, dataclasses.replace(P.FP32, weights_dtype=mode))
    for k in ("weights_dtype", "weight_bytes", "weight_bytes_dense",
              "weight_bytes_saved"):
        assert stats[k] == jstats[k], k
    n = 0 if mode == "auto" else 7 * cfg.num_layers + 1
    assert stats["n_quantized"] == n
    assert "head_q8" not in new["embed"]
    if mode == "int8":
        mine = bridge.params_from_jax(jax.tree.map(np.asarray, jnew))
        for f in ("q", "s"):
            np.testing.assert_array_equal(new["embed"]["head"][f].numpy(),
                                          mine["embed"]["head"][f].numpy())


# ---------------------------------------------------------------------------
# Forwards over a dense ring cache
# ---------------------------------------------------------------------------


def _assert_caches_close(ours, cfg, ref):
    """Per layer: positions exactly, K/V to TOL outside the dump slot."""
    mine = bridge.pool_to_numpy(ours, cfg)
    for a, b in zip(jax.tree_util.tree_leaves_with_path(mine),
                    jax.tree_util.tree_leaves_with_path(ref)):
        (path, x), (_, y) = a, b
        y = np.asarray(y)
        if "pos" in str(path):
            np.testing.assert_array_equal(x, y, err_msg=str(path))
        else:
            np.testing.assert_allclose(x[..., :-1, :, :], y[..., :-1, :, :],
                                       rtol=TOL, atol=TOL,
                                       err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_forwards_match_reference(arch):
    """``forward_train`` over 90 tokens; ``forward_prefill`` of rows of
    90 and 71 valid tokens into a dense cache at max_len 128 (the windowed
    layers' 64-entry rings keep each row's last 64), all logits and with
    ``last_only``; then two ``forward_decode`` steps through the rings.
    Logits and caches within TOL of the reference's."""
    jcfg, jparams, cfg, params = _weights(arch)
    rng = np.random.default_rng(7)
    toks = rng.integers(4, 400, size=(2, 90)).astype(np.int32)
    lens = np.asarray([90, 71], np.int32)
    jl, _ = jax.jit(lambda p, t: JT.forward_train(p, jcfg, t,
                                                  policy=JP.FP32))(
        jparams, jnp.asarray(toks))
    with torch.no_grad():
        tl = T.forward_train(params, cfg, torch.from_numpy(toks))[0]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)

    @jax.jit
    def jrun(p, t, n, steps):
        c = JT.init_cache(jcfg, 2, 128, jnp.float32)
        lp, c = JT.forward_prefill(p, jcfg, t, n, c, policy=JP.FP32,
                                   max_len=128)
        ll, _ = JT.forward_prefill(p, jcfg, t, n, JT.init_cache(
            jcfg, 2, 128, jnp.float32), policy=JP.FP32, max_len=128,
            last_only=True)
        outs = []
        for i in range(2):
            ld, c = JT.forward_decode(p, jcfg, steps[:, i:i + 1], c, n + i,
                                      policy=JP.FP32, max_len=128)
            outs.append(ld)
        return lp, ll, outs, c
    steps = rng.integers(4, 400, size=(2, 2)).astype(np.int32)
    jlp, jll, jld, jc = jrun(jparams, jnp.asarray(toks), jnp.asarray(lens),
                             jnp.asarray(steps))
    cache = T.init_cache(cfg, 2, 128, torch.float32)
    t_toks, t_lens = torch.from_numpy(toks), torch.from_numpy(lens)
    with torch.no_grad():
        lp, _ = T.forward_prefill(params, cfg, t_toks, t_lens, cache,
                                  max_len=128)
        ll, _ = T.forward_prefill(params, cfg, t_toks, t_lens,
                                  T.init_cache(cfg, 2, 128, torch.float32),
                                  max_len=128, last_only=True)
        ld = [T.forward_decode(params, cfg, torch.from_numpy(
            steps[:, i:i + 1]), cache, t_lens + i, max_len=128)[0]
            for i in range(2)]
    # the windowed layers' rings are full: every entry written
    win = [c for c, s in zip(cache["layers"], layer_specs(cfg)) if s.window]
    assert len(win) == (arch != "phi3-mini-3.8b") and all(
        c["pos"].shape[1] == 65 and (c["pos"][:, :-1] >= 0).all()
        for c in win)
    for a, b in [(lp, jlp), (ll, jll)] + list(zip(ld, jld)):
        # padding lanes of row 1 attend and are discarded: compare the
        # valid ones
        a, b = a.numpy(), np.asarray(b)
        if a.shape[1] == 90:
            a, b = a[:, :71], b[:, :71]
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    _assert_caches_close(cache, cfg, jc)


def test_long_context_override_ring():
    """The counterpart of the reference's long-context ring test: past
    phi3's native context its global layers get the override window and a
    ring of window + 1 entries; decoding one token at a time through the
    ring equals a full forward in which every layer has that window (the
    port's own), and that forward equals the reference's."""
    jcfg, jparams, cfg, params = _weights("phi3-mini-3.8b")
    over = dict(long_context_override=32, native_context=48)
    cfg, jcfg = cfg.replace(**over), jcfg.replace(**over)
    spec = LayerSpec()
    assert KV.effective_window(cfg, spec, 40) is None
    assert KV.effective_window(cfg, spec, 128) == 32
    assert KV.layer_cache_shape(cfg, spec, 1, 128, torch.float32)[
        "k"].shape[1] == 33
    toks = np.random.default_rng(3).integers(4, 400, size=(1, 96)).astype(
        np.int32)
    cache = T.init_cache(cfg, 1, 128, torch.float32)
    outs = []
    with torch.no_grad():
        T.forward_prefill(params, cfg, torch.from_numpy(toks[:, :1]),
                          torch.ones(1, dtype=torch.int32), cache,
                          max_len=128)
        for t in range(1, 96):
            lg, _ = T.forward_decode(params, cfg,
                                     torch.from_numpy(toks[:, t:t + 1]),
                                     cache, torch.full((1,), t), max_len=128)
            outs.append(lg[:, 0])

    def windowed(c):
        return c.replace(stacks=tuple(
            type(st)(tuple(type(sp)(mixer=sp.mixer, ffn=sp.ffn, window=32)
                           for sp in st.pattern), st.repeats)
            for st in c.stacks))
    with torch.no_grad():
        full = T.forward_train(params, windowed(cfg),
                               torch.from_numpy(toks))[0]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               full[:, 1:].numpy(), rtol=TOL, atol=TOL)
    jfull, _ = JT.forward_train(jparams, windowed(jcfg), jnp.asarray(toks),
                                policy=JP.FP32, remat=False)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=TOL,
                               atol=TOL)
    assert KV.layer_cache_shape(cfg, spec, 1, 128, torch.float32)[
        "k"].shape == JKV.layer_cache_shape(jcfg, spec, 1, 128,
                                            jnp.float32)["k"].shape


# ---------------------------------------------------------------------------
# serve_continuous: packed phi3, bucketed gemma over ring pages
# ---------------------------------------------------------------------------


class _Pair:
    """One reference engine and one port engine on the same weights."""

    def __init__(self, arch, kv_dtype="auto", weights_dtype="auto"):
        jcfg, jparams, self.cfg, self.params = _weights(arch)
        kw = dict(kv_dtype=kv_dtype, weights_dtype=weights_dtype)
        self.policy = dataclasses.replace(P.FP32, **kw)
        self.jeng = JEngine(jcfg, jparams, policy=dataclasses.replace(
            JP.FP32, **kw), **ENGINE)
        self.eng = InferenceEngine(self.cfg, self.params,
                                   policy=self.policy, device="cpu",
                                   **ENGINE)

    def serve(self, prompts, spec=False, **kw):
        """Both packages' serves from a cold pool: (reference streams,
        metrics and warnings, ours)."""
        out = []
        for eng, req, sc in ((self.jeng, JRequest, JSpecConfig),
                             (self.eng, Request, SpecConfig)):
            eng.reset_prefix_cache()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                done, m = eng.serve_continuous(
                    [req(uid=i, tokens=list(p), max_new_tokens=8)
                     for i, p in enumerate(prompts)], page_size=PAGE,
                    max_batched_tokens=48, spec=sc(k=3) if spec else None,
                    **kw)
            out.append(({r.uid: r.result for r in done}, m,
                        [str(w.message) for w in caught
                         if issubclass(w.category, UserWarning)]))
        return out


@pytest.fixture(scope="module")
def pairs():
    made = {}

    def get(arch, **kw):
        key = (arch, tuple(sorted(kw.items())))
        if key not in made:
            made[key] = _Pair(arch, **kw)
        return made[key]
    return get


@pytest.mark.parametrize("arch,mode", [
    ("phi3-mini-3.8b", "fp32"), ("phi3-mini-3.8b", "int8"),
    ("gemma2-2b", "fp32"), ("gemma2-2b", "int8"), ("gemma3-27b", "fp32")])
def test_serve_matches_reference(pairs, arch, mode):
    """phi3 serves packed (the unified scheduler: chunks of the 48-token
    budget); the gemmas take the bucketed path over ring pages (their
    windowed layers cannot share pages), four prompts of 20-100 tokens, 3
    slots.  int8 is int8 KV + int8 weights in both packages.  Streams and
    counters exactly equal; no warning when no option was asked for."""
    pair = pairs(arch, **(INT8 if mode == "int8" else {}))
    (ref, jm, jw), (ours, m, w) = pair.serve(_prompts(LONG))
    assert ours == ref
    for k in COUNTERS:
        assert getattr(m, k) == getattr(jm, k), k
    assert m.scheduler == jm.scheduler == (
        "unified" if arch.startswith("phi3") else "bucketed")
    assert m.outcome_counts == {"completed": len(LONG)}
    assert w == jw == []
    if arch.startswith("phi3"):
        assert m.mixed_iters > 0 and m.dispatches_per_iter == 1.0
    else:
        assert m.prefix_hits == 0 and m.prefill_padded > m.prefill_tokens


@pytest.mark.parametrize("arch", GEMMAS)
def test_windowed_serve_warns_off_options_as_reference(pairs, arch):
    """Asked for speculation, prefix sharing, chunked prefill, packing and
    preemption, a windowed model warns for each in the reference's words
    and order and serves bucketed with the plain serve's streams."""
    pair = pairs(arch)
    prompts = _prompts(LONG, seed=8)
    (ref, jm, jw), (ours, m, w) = pair.serve(
        prompts, spec=True, prefix_cache=True, chunked_prefill=True,
        packed=True, preemption="lru")
    assert w == jw and len(w) == 5
    assert ours == ref
    assert m.spec_mode == "off" and m.scheduler == "bucketed"
    assert m.preemptions == 0 and m.prefix_hits == 0
    (_, _, _), (plain, _, _) = pair.serve(prompts)
    assert ours == plain


# ---------------------------------------------------------------------------
# The dense path over ring caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kv_cache", [True, False])
@pytest.mark.parametrize("arch", GEMMAS)
def test_generate_batch_over_rings_matches_reference(arch, use_kv_cache):
    """Rows of 100, 75 and 30 tokens x 6 new at max_len 128: the dense
    prefill writes each row's last 64 tokens into the windowed layers'
    rings and decode wraps them; the no-cache baseline re-runs full
    forwards with the window.  Greedy ids equal the reference's, and the
    two paths equal each other."""
    jcfg, jparams, cfg, params = _weights(arch)
    kw = dict(ENGINE, use_kv_cache=use_kv_cache)
    rng = np.random.default_rng(4)
    toks = rng.integers(4, 400, size=(3, 100)).astype(np.int32)
    lens = np.asarray([100, 75, 30], np.int32)
    ref = JEngine(jcfg, jparams, policy=JP.FP32, **kw).generate_batch(
        toks.copy(), lens.copy(), 6)
    ours = InferenceEngine(cfg, params, policy=P.FP32, device="cpu",
                           **kw).generate_batch(toks.copy(), lens.copy(), 6)
    np.testing.assert_array_equal(ours, ref)
    assert (ours >= 0).sum() > 0


def test_run_pipelined_over_rings_matches_reference():
    """gemma2 through the staged pipeline (tokenize || infer ||
    detokenize) at max_len 128 on texts long enough to pass the window:
    the same ids and texts as the reference's."""
    jcfg, jparams, cfg, params = _weights("gemma2-2b")
    words = ["the", "model", "serves", "tokens", "quickly", "with", "a",
             "ring", "of", "pages", "window", "cache"]
    rng = np.random.default_rng(6)
    texts = [" ".join(rng.choice(words, size=n)) for n in (40, 48, 20)]
    corpus = [" ".join(words)] * 4
    jtok, tok = JTokenizer.train(corpus, 300), FastTokenizer.train(corpus,
                                                                   300)
    ref = JPIPE.run_pipelined(texts, jtok, JEngine(
        jcfg, jparams, policy=JP.FP32, **ENGINE), max_new_tokens=5,
        max_batch=3)
    ours = PIPE.run_pipelined(texts, tok, InferenceEngine(
        cfg, params, policy=P.FP32, device="cpu", **ENGINE),
        max_new_tokens=5, max_batch=3)
    assert [(r.uid, r.token_ids, r.text) for r in ours] == \
        [(r.uid, r.token_ids, r.text) for r in ref]
    assert max(len(tok.encode(t)) for t in texts) > 64


def test_dense_ring_shapes_match_reference():
    """The windowed layers' dense ring at max_len 128 (64 + 1 entries)
    and past 256 (rounded up to a multiple of 256) equal the
    reference's."""
    jcfg, _, cfg, _ = _weights("gemma3-27b")
    for max_len in (128, 600):
        ours = T.init_cache(cfg, 2, max_len, torch.float32)
        ref = JT.init_cache(jcfg, 2, max_len, jnp.float32)
        mine = bridge.pool_to_numpy(ours, cfg)
        assert [a.shape for a in jax.tree.leaves(mine)] == \
            [a.shape for a in jax.tree.leaves(ref)]
