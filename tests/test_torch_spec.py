"""The port's speculative decoding against the reference: the plain flash
attention (the CPU path of the CUDA flash kernel, which the draft model's
forwards run), the drafters, the rejection sampler, and speculative
serves.

Inputs are made by numpy from a seed and fed to both packages.  Flash
attention is fp32 and differs only in summation order (1e-5).  Greedy
results must be equal: drafter proposals, accept lengths, and the token
streams and draft counters of whole serves (fp32, int8 KV pools, int8
weights, prefix sharing on).  The sampled rejection rule draws from a
``torch.Generator``, whose bits differ from ``jax.random``: it is held to
the distribution it must preserve (0.02, as the reference's own test).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.core import sampling as JSMP
from repro.core import speculative as JSPEC
from repro.core.engine import InferenceEngine as JEngine
from repro.core.precision import FP32 as J_FP32
from repro.core.scheduler import Request as JRequest
from repro.kernels import flash_attention as JFA
from repro.kernels import ref as JREF
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs.registry import get_reduced
from repro_torch.core import engine as E
from repro_torch.core import sampling as SMP
from repro_torch.core import speculative as SPEC
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.precision import FP32
from repro_torch.core.scheduler import Request
from repro_torch.core.tokenizer import EOS
from repro_torch.kernels import ops

PAGE, MAX_LEN, SLOTS = 8, 64, 3


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Flash attention (the draft model's attention)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g,window,softcap", [(1, None, None),
                                              (2, 6, None),
                                              (4, None, 20.0)])
def test_flash_matches_reference(g, window, softcap):
    """Right-padded rows (-1 positions), one row wholly invalid, GQA,
    window and softcap: the plain version against the Pallas kernel in
    interpret mode and the oracle."""
    rng = np.random.default_rng(50 + g)
    B, S, Hkv, D = 3, 24, 2, 16
    q = rng.normal(size=(B, S, Hkv * g, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    pos = np.full((B, S), -1, np.int32)
    pos[0] = np.arange(S)
    pos[1, :17] = np.arange(17)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    ours = ops.flash_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                               **kw).numpy()
    j = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    pallas = JFA.flash_attention(*j, interpret=True, **kw)
    oracle = JREF.flash_attention_ref(*j, **kw)
    np.testing.assert_allclose(ours, np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ours, np.asarray(oracle), rtol=1e-5,
                               atol=1e-5)
    assert not ours[pos < 0].any()             # invalid rows are exactly 0


# ---------------------------------------------------------------------------
# Drafters
# ---------------------------------------------------------------------------


def test_ngram_drafter_matches_reference():
    rng = np.random.default_rng(3)
    for k, max_ngram in ((3, 3), (4, 2), (2, 1)):
        ours = SPEC.NgramDrafter(k, max_ngram=max_ngram)
        ref = JSPEC.NgramDrafter(k, max_ngram=max_ngram)
        contexts = [[int(t) for t in rng.integers(4, 9, size=n)]
                    for n in (1, 2, 5, 17, 40)]    # small vocab: repeats
        contexts.append(None)                      # an inactive slot
        np.testing.assert_array_equal(ours.propose_slots(contexts),
                                      ref.propose_slots(contexts))


@pytest.fixture(scope="module")
def unimo():
    jcfg = j_get_reduced("unimo-text")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, J_FP32)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, get_reduced("unimo-text"), params


def test_draft_model_drafter_matches_reference(unimo):
    """Three live contexts of mixed length and an inactive slot: one
    (4, 32 + k) bucket, k greedy full forwards."""
    jcfg, jparams, cfg, params = unimo
    rng = np.random.default_rng(4)
    contexts = [[2] + [int(t) for t in rng.integers(4, 400, size=n)]
                for n in (5, 30, 12)]
    contexts.insert(1, None)
    ours = SPEC.DraftModelDrafter(cfg, params, 3, policy=FP32)
    ref = JSPEC.DraftModelDrafter(jcfg, jparams, 3, policy=J_FP32)
    got = ours.propose_slots(contexts)
    np.testing.assert_array_equal(got, ref.propose_slots(contexts))
    assert ours.calls == 1 and not got[1].any()


def test_get_drafter_resolution(unimo):
    _, _, cfg, params = unimo
    assert isinstance(SPEC.get_drafter(SPEC.SpecConfig(k=2)),
                      SPEC.NgramDrafter)
    d = SPEC.get_drafter(SPEC.SpecConfig(k=2, drafter="draft_model"), cfg,
                         params)
    assert isinstance(d, SPEC.DraftModelDrafter) and d.params is params
    for bad in (SPEC.SpecConfig(k=0), SPEC.SpecConfig(drafter="x"),
                SPEC.SpecConfig(drafter="draft_model")):
        with pytest.raises(ValueError):
            SPEC.get_drafter(bad)


# ---------------------------------------------------------------------------
# The rejection sampler
# ---------------------------------------------------------------------------


def test_speculative_verify_greedy_matches_reference():
    rng = np.random.default_rng(6)
    B, K, V = 5, 3, 12
    logits = rng.normal(size=(B, K + 1, V)).astype(np.float32)
    drafts = logits[:, :K].argmax(-1).astype(np.int32)
    drafts[1, 1] = (drafts[1, 1] + 1) % V        # mismatch at j = 1
    drafts[2, 0] = (drafts[2, 0] + 1) % V        # mismatch at j = 0
    drafts[4, 2] = (drafts[4, 2] + 1) % V        # mismatch at j = 2
    a, nxt = SMP.speculative_verify(_t(logits), _t(drafts),
                                    torch.Generator(), SMP.SamplingParams())
    ja, jn = JSMP.speculative_verify(jnp.asarray(logits),
                                     jnp.asarray(drafts),
                                     jax.random.PRNGKey(0),
                                     JSMP.SamplingParams())
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jn))
    assert a.tolist() == [K, 1, 0, K, 2]


def test_target_probs_match_reference():
    logits = np.random.default_rng(7).normal(size=(3, 2, 30)).astype(
        np.float32)
    for sp in (SMP.SamplingParams(temperature=0.7, top_k=5),
               SMP.SamplingParams(temperature=1.3, top_p=0.8)):
        jsp = JSMP.SamplingParams(sp.temperature, sp.top_k, sp.top_p)
        np.testing.assert_allclose(
            SMP.target_probs(_t(logits), sp).numpy(),
            np.asarray(JSMP.target_probs(jnp.asarray(logits), jsp)),
            rtol=1e-5, atol=1e-6)


def test_speculative_verify_distribution_preserving():
    """The emitted token at a drafted position is distributed as p,
    whatever was drafted; the acceptance rate is p(draft)."""
    V, B = 6, 8000
    row = np.log(np.asarray([0.35, 0.25, 0.2, 0.1, 0.07, 0.03], np.float32))
    logits = torch.from_numpy(row).expand(B, 2, V).contiguous()
    sp = SMP.SamplingParams(temperature=1.0)
    for d in (0, 3, 5):                      # well-, mid- and badly-drafted
        gen = torch.Generator().manual_seed(d)
        a, nxt = SMP.speculative_verify(
            logits, torch.full((B, 1), d, dtype=torch.int32), gen, sp)
        emitted = torch.where(a == 1, d, nxt).numpy()
        freq = np.bincount(emitted, minlength=V) / B
        np.testing.assert_allclose(freq, np.exp(row), atol=0.02)
        assert abs(a.float().mean().item() - np.exp(row[d])) < 0.02


# ---------------------------------------------------------------------------
# Speculative serves
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen3():
    jcfg = j_get_reduced("qwen3-4b")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, J_FP32)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, get_reduced("qwen3-4b"), params


def _shared_prompts():
    """Prompts of mixed length; the later ones share prefixes with the
    first (one match ends inside a page: a COW copy)."""
    rng = np.random.default_rng(5)

    def body(n):
        return [int(t) for t in rng.integers(4, 500, size=n)]
    first = [[2] + body(n) for n in (19, 30, 11, 23)]
    return first + [first[0][:12] + body(9), first[1][:17] + body(12)]


def _serves(model, prompts, max_new, spec_kw, *, kv_dtype="auto",
            weights_dtype="auto"):
    """Greedy streams and metrics: the reference's speculative serve, the
    port's speculative serve and the port's serve without speculation."""
    jcfg, jparams, cfg, params = model
    policy = dataclasses.replace(FP32, kv_dtype=kv_dtype,
                                 weights_dtype=weights_dtype)
    j_policy = dataclasses.replace(J_FP32, kv_dtype=kv_dtype,
                                   weights_dtype=weights_dtype)
    serve = dict(page_size=PAGE, max_batched_tokens=24, prefix_cache=True)
    news = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    jeng = JEngine(jcfg, jparams, policy=j_policy, max_len=MAX_LEN,
                   max_batch=SLOTS)
    jdone, jm = jeng.serve_continuous(
        copy.deepcopy([JRequest(uid=i, tokens=p, max_new_tokens=n)
                       for i, (p, n) in enumerate(zip(prompts, news))]),
        spec=JSPEC.SpecConfig(**spec_kw), **serve)
    out = {}
    for spec in (SPEC.SpecConfig(**spec_kw), None):
        eng = InferenceEngine(cfg, params, policy=policy, max_len=MAX_LEN,
                              max_batch=SLOTS, device="cpu")
        done, m = eng.serve_continuous(
            [Request(uid=i, tokens=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, news))], spec=spec,
            **serve)
        out[spec is not None] = ([r.result for r in done], m)
    return [r.result for r in jdone], jm, out[True], out[False]


SPEC_COUNTERS = ("drafted_tokens", "accepted_tokens", "decode_tokens",
                 "steps", "slot_steps_active", "mixed_iters",
                 "prefix_hits", "cow_copies", "generated_tokens")


@pytest.mark.parametrize("drafter,kv_dtype,weights_dtype", [
    ("ngram", "auto", "auto"), ("ngram", "int8", "auto"),
    ("ngram", "auto", "int8"), ("draft_model", "auto", "auto")])
def test_spec_serve_matches_reference(qwen3, drafter, kv_dtype,
                                      weights_dtype):
    ref, jm, (ours, m), (plain, _) = _serves(
        qwen3, _shared_prompts(), 8, dict(k=3, drafter=drafter),
        kv_dtype=kv_dtype, weights_dtype=weights_dtype)
    assert ours == ref == plain
    assert m.spec_mode == drafter and m.spec_k == 3
    assert m.drafted_tokens > 0 and m.prefix_hits > 0 and m.cow_copies > 0
    for k in SPEC_COUNTERS:
        assert getattr(m, k) == getattr(jm, k), k
    assert m.acceptance_rate == jm.acceptance_rate
    if drafter == "draft_model":      # self-drafting: nearly all kept
        assert m.acceptance_rate > 0.5 and m.tokens_per_forward > 1.5


def test_spec_serve_budget_edges(qwen3):
    """max_new of 0, 1 and 2 under speculation: no budget overshoots."""
    news = [0, 1, 2, 7, 2, 5]
    ref, jm, (ours, m), (plain, _) = _serves(
        qwen3, _shared_prompts(), news, dict(k=3, drafter="draft_model"))
    assert ours == ref == plain
    assert [len(r) for r in ours] == news
    assert m.accepted_tokens == jm.accepted_tokens


def test_spec_serve_eos_inside_verify_window(qwen3):
    """The EOS row of the tied embedding is set to 1.001 x that of the
    token the model most often emits, so greedy decoding emits EOS where
    it would have emitted that token.  Self-drafting drafts the EOS inside
    a verify window: the request ends there, EOS itself not emitted,
    exactly as without speculation and as in the reference."""
    jcfg, jparams, cfg, params = qwen3
    prompts = _shared_prompts()
    eng = InferenceEngine(cfg, params, policy=FP32, max_len=MAX_LEN,
                          max_batch=SLOTS, device="cpu")
    done, _ = eng.serve_continuous(
        [Request(uid=i, tokens=p, max_new_tokens=12)
         for i, p in enumerate(prompts)], page_size=PAGE)
    top = np.bincount(np.concatenate([r.result for r in done])).argmax()
    jp = jax.tree.map(np.array, jparams)
    jp["embed"]["tokens"][EOS] = 1.001 * jp["embed"]["tokens"][top]
    model = (jcfg, jax.tree.map(jnp.asarray, jp), cfg,
             bridge.params_from_jax(jp))
    ref, jm, (ours, m), (plain, _) = _serves(
        model, prompts, 12, dict(k=3, drafter="draft_model"))
    assert ours == ref == plain
    assert all(EOS not in r for r in ours)
    # some request stopped early, after a verify step had emitted for it
    assert any(1 < len(r) < 12 for r in ours)
    assert m.accepted_tokens == jm.accepted_tokens


def test_spec_budget_floor_warns(qwen3):
    """A budget below one verify window per slot is raised to it."""
    _, _, cfg, params = qwen3
    eng = InferenceEngine(cfg, params, policy=FP32, max_len=MAX_LEN,
                          max_batch=SLOTS, device="cpu")
    with pytest.warns(UserWarning, match="raising to 12"):
        _, m = eng.serve_continuous(
            [Request(uid=0, tokens=[2, 5, 6, 7], max_new_tokens=3)],
            page_size=PAGE, max_batched_tokens=8,
            spec=SPEC.SpecConfig(k=3))
    assert m.max_batched_tokens == 12


def test_spec_drafter_kept_across_serves(qwen3, monkeypatch):
    """The engine builds the drafter once per SpecConfig object."""
    _, _, cfg, params = qwen3
    built = []
    real = E.get_drafter
    monkeypatch.setattr(E, "get_drafter",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    eng = InferenceEngine(cfg, params, policy=FP32, max_len=MAX_LEN,
                          max_batch=SLOTS, device="cpu")
    spec = SPEC.SpecConfig(k=2)
    for _ in range(2):
        eng.serve_continuous([Request(uid=0, tokens=[2, 5, 6, 7],
                                      max_new_tokens=3)], page_size=PAGE,
                             spec=spec)
    assert len(built) == 1
