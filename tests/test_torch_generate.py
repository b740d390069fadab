"""The paper's serving path on the port, against the reference package:
``generate_batch`` over the dense KV cache and the no-cache baseline,
``serve``, the staged pipeline, dynamic batching and the serve CLI
without ``--continuous``.

Reduced unimo-text and qwen3-4b in fp32 with the kernels' plain versions;
the same parameters in both packages (``bridge.params_from_jax``).
Greedy ids must equal the reference's exactly.  The sampled path draws
from a ``torch.Generator`` whose bits differ from ``jax.random``, so it
is checked for shape, EOS and range only.
"""
import copy
import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.core import engine as JE
from repro.core import pipeline as JPIPE
from repro.core import scheduler as JS
from repro.core.precision import FP32 as J_FP32
from repro.core.tokenizer import FastTokenizer as JTokenizer
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs.registry import get_reduced
from repro_torch.core import engine as E
from repro_torch.core import pipeline as PIPE
from repro_torch.core import scheduler as S
from repro_torch.core.precision import FP32
from repro_torch.core.sampling import SamplingParams
from repro_torch.core.tokenizer import FastTokenizer

ENGINE = dict(max_len=64, max_batch=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread keeps them fast when several
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["unimo-text", "qwen3-4b"])
def model(request):
    jcfg = j_get_reduced(request.param)
    jparams = jax.jit(lambda key: JT.init_params(key, jcfg, J_FP32))(
        jax.random.PRNGKey(0))
    return (jcfg, jparams, get_reduced(request.param),
            bridge.params_from_jax(jax.tree.map(np.asarray, jparams)))


def _engines(model, **kw):
    jcfg, jparams, cfg, params = model
    return (JE.InferenceEngine(jcfg, jparams, policy=J_FP32, **ENGINE, **kw),
            E.InferenceEngine(cfg, params, policy=FP32, device="cpu",
                              **ENGINE, **kw))


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, 400, size=(3, 12)).astype(np.int32)
    lens = np.asarray([12, 7, 3], np.int32)
    return toks, lens


@pytest.mark.parametrize("use_kv_cache", [True, False])
def test_generate_batch_matches_reference(model, use_kv_cache):
    """Right-padded rows of 12, 7 and 3 tokens x 6 new: the dense-cache
    prefill + decode, or the no-cache full forwards, give the reference's
    greedy ids; inside the port the two paths agree, and ``stats`` books
    the prefill, decode or no-cache seconds."""
    jeng, eng = _engines(model, use_kv_cache=use_kv_cache)
    toks, lens = _batch()
    ref = jeng.generate_batch(toks.copy(), lens.copy(), 6)
    ours = eng.generate_batch(toks.copy(), lens.copy(), 6)
    np.testing.assert_array_equal(ours, ref)
    other = E.InferenceEngine(model[2], model[3], policy=FP32, device="cpu",
                              use_kv_cache=not use_kv_cache, **ENGINE)
    np.testing.assert_array_equal(
        other.generate_batch(toks.copy(), lens.copy(), 6), ours)
    st = eng.stats
    assert st.batches == 1 and st.generated_tokens == int((ours >= 0).sum())
    assert st.prompt_tokens == 22
    assert (st.decode_s > 0) if use_kv_cache else (st.nocache_s > 0)


def test_batched_equals_individual(model):
    """Batching must not change any row's greedy output."""
    *_, cfg, params = model
    eng = E.InferenceEngine(cfg, params, policy=FP32, device="cpu", **ENGINE)
    toks, lens = _batch(2)
    gb = eng.generate_batch(toks.copy(), lens.copy(), 5)
    for b in range(3):
        np.testing.assert_array_equal(
            eng.generate_batch(toks[b:b + 1].copy(), lens[b:b + 1], 5)[0],
            gb[b], err_msg=f"row {b}")


def test_eos_stops_row_as_in_reference(model, monkeypatch):
    """With the end-of-sequence id set to a token row 0 first emits at
    step k, both packages stop row 0 there (EOS itself is not emitted, -1
    follows) and give equal ids for every row."""
    toks, lens = _batch(3)
    *_, cfg, params = model
    base = E.InferenceEngine(cfg, params, policy=FP32, device="cpu",
                             **ENGINE).generate_batch(toks.copy(), lens, 6)
    # the first step of row 0 whose token it has not emitted before
    k = next(i for i in range(1, 6) if base[0, i] not in base[0, :i])
    eos = int(base[0, k])
    monkeypatch.setattr(JE, "EOS", eos)
    monkeypatch.setattr(E, "EOS", eos)
    for use_kv_cache in (True, False):
        jeng, eng = _engines(model, use_kv_cache=use_kv_cache)
        ref = jeng.generate_batch(toks.copy(), lens.copy(), 6)
        ours = eng.generate_batch(toks.copy(), lens.copy(), 6)
        np.testing.assert_array_equal(ours, ref)
        assert (ours[0, k:] == -1).all() and (ours[0, :k] == base[0, :k]).all()
    # the step-by-step path (stop_at_eos with a single new token, and
    # sampling) keeps the rule: -1 from the first EOS on, ids in range
    eng = E.InferenceEngine(cfg, params, policy=FP32, device="cpu", seed=3,
                            **ENGINE)
    out = eng.generate_batch(toks.copy(), lens.copy(), 12,
                             SamplingParams(temperature=1.0, top_k=20))
    assert out.shape == (3, 12) and out.dtype == np.int64
    for row in out:
        tail = np.flatnonzero(row < 0)
        if tail.size:
            assert (row[tail[0]:] == -1).all()
        assert ((row == -1) | ((row >= 0) & (row < cfg.vocab_size))).all()
        assert eos not in row


def test_serve_and_pipeline_match_reference(model):
    """Six texts in one bucket: the port's ``serve``, ``run_pipelined``
    and ``run_sequential`` give the reference's ``run_sequential`` ids
    (the same tokenizer, trained on the same corpus, in both packages)."""
    jcfg, jparams, cfg, params = model
    texts = ["the quick fox", "hello world", "lazy dog", "fast engines",
             "the the fox dog", "quick brown"]
    corpus = ["the quick brown fox jumps over the lazy dog",
              "hello world of fast inference engines"]
    tok, jtok = FastTokenizer.train(corpus, 256), JTokenizer.train(corpus,
                                                                   256)
    jeng, eng = _engines(model)
    ref = JPIPE.run_sequential(texts, jtok, jeng, max_new_tokens=5,
                               max_batch=8)
    pipe = PIPE.run_pipelined(texts, tok, eng, max_new_tokens=5,
                              max_batch=8)
    seq = PIPE.run_sequential(texts, tok, eng, max_new_tokens=5,
                              max_batch=8)
    reqs = [S.Request(uid=i, tokens=tok.encode(t), max_new_tokens=5)
            for i, t in enumerate(texts)]
    served = {r.uid: r.result for r in E.InferenceEngine(
        cfg, params, policy=FP32, device="cpu", max_len=64,
        max_batch=8).serve(reqs)}
    assert [r.uid for r in pipe] == list(range(len(texts)))
    for a, b, c in zip(pipe, seq, ref):
        assert a.token_ids == b.token_ids == c.token_ids == served[a.uid]
        assert a.text == b.text == c.text


@pytest.mark.parametrize("overflow", ["truncate", "reject"])
def test_dynamic_batcher_and_pad_batch_match_reference(overflow):
    """Sort by length, group by bucket up to max_batch, truncate or
    reject an over-long prompt, pad: batches equal the reference's."""
    rng = np.random.default_rng(4)
    lengths = [5, 40, 3, 17, 33, 70, 8, 31]
    prompts = [[int(t) for t in rng.integers(4, 400, size=n)]
               for n in lengths]

    def batches(mod):
        b = mod.DynamicBatcher(max_batch=3, buckets=(8, 32, 64),
                               overflow=overflow)
        try:
            for i, p in enumerate(prompts):
                b.add(mod.Request(uid=i, tokens=list(p)))
        except mod.PromptOverflowError as e:
            return str(e)
        out = []
        while (batch := b.next_batch()) is not None:
            toks, lens = mod.pad_batch(batch)
            out.append(([r.uid for r in batch.requests], batch.padded_len,
                        toks.tolist(), lens.tolist()))
        return out
    if overflow == "truncate":
        with pytest.warns(UserWarning, match="keeping the last 64"):
            ours = batches(S)
        with pytest.warns(UserWarning, match="keeping the last 64"):
            ref = batches(JS)
        assert len(ours) == 3 and ours[-1][1] == 64
    else:
        ours, ref = batches(S), batches(JS)
        assert "exceeds the largest bucket" in ours
    assert ours == ref
    with pytest.raises(S.PromptOverflowError):
        S.pad_batch(S.Batch([S.Request(uid=0, tokens=[1] * 9)], 8))


def test_pipelined_stage_exception_raises_in_caller():
    """An exception in the inference stage stops the pipeline and is
    raised in the caller, however many batches are still queued."""
    class Broken:
        device = torch.device("cpu")

        def prompt_buckets(self):
            return (8, 16)

        def generate_batch(self, *a, **kw):
            raise RuntimeError("kernel failed")

    tok = FastTokenizer.train(["a b c d e f g"], 64)
    err = []

    def run():
        try:
            PIPE.run_pipelined(["a b", "c d e", "f", "g a"] * 8, tok,
                               Broken(), max_batch=1, queue_depth=1)
        except RuntimeError as e:
            err.append(e)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=20)
    assert not t.is_alive(), "the pipeline hung on a stage's exception"
    assert len(err) == 1 and "kernel failed" in str(err[0])


def test_pruned_generate_batch_maps_ids(model):
    """On a pruned vocabulary ``generate_batch`` takes and returns the
    original ids, with the greedy ids of the pruned serve_continuous."""
    from repro_torch.core import pruning as PR
    *_, cfg, params = model
    rng = np.random.default_rng(6)
    freqs = {int(t): int(rng.integers(1, 50)) for t in range(4, 300)}
    p2, cfg2, maps = PR.prune_model(params, cfg, freqs, max_vocab=120)
    keep = set(maps.keep_ids.tolist())
    ids = sorted(keep - {0, 1, 2, 3})
    toks = np.asarray([ids[:10], ids[10:20]], np.int32)
    lens = np.asarray([10, 6], np.int32)
    eng = E.InferenceEngine(cfg2, p2, policy=FP32, device="cpu",
                            prune_maps=maps, **ENGINE)
    out = eng.generate_batch(toks.copy(), lens.copy(), 5)
    assert all(t in keep for t in out[out >= 0].tolist())
    reqs = [S.Request(uid=i, tokens=[int(t) for t in toks[i, :n]],
                      max_new_tokens=5) for i, n in enumerate(lens)]
    done, _ = eng.serve_continuous(copy.deepcopy(reqs), page_size=8)
    for i, r in enumerate(done):
        assert r.result == [int(t) for t in out[i] if t >= 0]


@pytest.mark.parametrize("flags", [[], ["--no-kv-cache", "--no-pipeline"]])
def test_cli_serves_without_continuous(flags, capsys):
    """``launch/serve.py`` without ``--continuous`` on the CPU: pipelined
    over the dense cache, or the sequential no-cache baseline."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--policy", "fp32", "--requests", "4",
                "--max-new-tokens", "3", "--max-len", "128"] + flags)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["requests"] == 4 and line["device"] == "cpu"
    assert line["generated_tokens"] > 0
    assert line["mode"] == ("baseline-nocache" if flags else "kv-cache")
    assert line["pipelined"] is not bool(flags)
