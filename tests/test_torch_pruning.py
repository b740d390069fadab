"""Vocabulary pruning and the position-table trim in the port, against the
reference's, on the CPU (reduced unimo-text and qwen3-4b at fp32; the
reference's parameters converted by ``bridge``).

* ``select_keep_ids`` and ``build_maps`` give the reference's arrays,
  exactly, by budget and by coverage; the maps round-trip kept ids and
  send dropped ids to UNK.
* ``prune_model`` (with the trim) gives the reference's pruned
  parameters, exactly (a gather and a slice move values unchanged), and
  its config.
* Kept-token logits of the pruned model equal the unpruned model's at the
  kept entries to 1e-5 (fp32; the two heads are matmuls over different
  column counts, so the sums may round apart), and the trimmed table
  leaves the logits of short sequences unchanged (1e-6).
* The reference's pruned ``serve_continuous`` parity holds port against
  JAX (greedy streams equal), and inside the port pruned against
  unpruned wherever the unpruned stream stays in the kept vocabulary;
  results come back in the original id space.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.core import pruning as JPR
from repro.core.engine import InferenceEngine as JEngine
from repro.core.precision import FP32 as J_FP32
from repro.core.scheduler import Request as JRequest
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs.registry import get_reduced
from repro_torch.core import pruning as PR
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.precision import FP32
from repro_torch.core.scheduler import Request
from repro_torch.models import transformer as T


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These serves are many small ops: one intra-op thread keeps them
    fast when several test workers share the cores (with a thread per
    core in every worker they ran up to 100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("unimo-text", "qwen3-4b"):
        jparams = JT.init_params(jax.random.PRNGKey(0), j_get_reduced(arch),
                                 J_FP32)
        out[arch] = (jparams, bridge.params_from_jax(
            jax.tree.map(np.asarray, jparams)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_keep_ids_and_maps_match_reference(seed):
    rng = np.random.default_rng(seed)
    V = 256
    counts = rng.zipf(1.5, size=V) * (rng.random(V) < 0.8)
    freqs = {int(i): int(c) for i, c in enumerate(counts)}
    for kw in ({"max_vocab": int(rng.integers(8, 64))},
               {"coverage": float(rng.uniform(0.1, 0.999))}):
        keep = PR.select_keep_ids(freqs, V, **kw)
        np.testing.assert_array_equal(
            keep, JPR.select_keep_ids(freqs, V, **kw))
        maps, jmaps = PR.build_maps(keep, V), JPR.build_maps(keep, V)
        for f in ("keep_ids", "old_to_new", "new_to_old"):
            np.testing.assert_array_equal(getattr(maps, f),
                                          getattr(jmaps, f))
        assert {0, 1, 2, 3} <= set(keep.tolist())
        np.testing.assert_array_equal(
            PR.unmap_tokens(PR.remap_tokens(keep, maps), maps), keep)
        dropped = np.setdiff1d(np.arange(V), keep)
        assert (maps.old_to_new[dropped] == maps.old_to_new[1]).all()
        if "coverage" in kw:
            assert counts[keep].sum() / counts.sum() >= kw["coverage"] - 1e-9
    with pytest.raises(ValueError):
        PR.select_keep_ids(freqs, V, max_vocab=8, coverage=0.5)


def test_pruned_params_match_reference(models):
    jparams, tparams = models["unimo-text"]
    cfg, jcfg = get_reduced("unimo-text"), j_get_reduced("unimo-text")
    freqs = {i: (i * 7919) % 1000 for i in range(cfg.vocab_size)}
    p2, cfg2, maps = PR.prune_model(tparams, cfg, freqs, coverage=0.9,
                                    new_max_len=48)
    jp2, jcfg2, jmaps = JPR.prune_model(jparams, jcfg, freqs, coverage=0.9,
                                        new_max_len=48)
    np.testing.assert_array_equal(maps.keep_ids, jmaps.keep_ids)
    assert (cfg2.vocab_size, cfg2.max_seq_len) == (
        jcfg2.vocab_size, jcfg2.max_seq_len) == (maps.new_vocab, 48)
    ref = bridge.params_from_jax(jax.tree.map(np.asarray, jp2))
    assert set(p2["embed"]) == set(ref["embed"]) == {"tokens", "pos"}
    for k in ("tokens", "pos"):
        assert torch.equal(p2["embed"][k], ref["embed"][k]), k
    assert p2["layers"] is tparams["layers"]     # layers untouched
    # RoPE models have no table to trim
    qcfg = get_reduced("qwen3-4b")
    _, qtparams = models["qwen3-4b"]
    assert PR.trim_positions(qtparams, qcfg, 32) == (qtparams, qcfg)


@pytest.mark.parametrize("arch", ["unimo-text", "qwen3-4b"])
def test_kept_token_logits_invariant(models, arch):
    _, params = models[arch]
    cfg = get_reduced(arch)
    freqs = {i: 1000 - i for i in range(300)}
    p2, cfg2, maps = PR.prune_model(params, cfg, freqs, max_vocab=128)
    rng = np.random.default_rng(0)
    toks = rng.choice(maps.keep_ids[:100], size=(2, 8))
    with torch.no_grad():
        lg1 = T.forward_train(params, cfg, torch.from_numpy(toks))[0]
        lg2 = T.forward_train(p2, cfg2, torch.from_numpy(
            PR.remap_tokens(toks, maps)))[0]
    assert lg2.shape[-1] == maps.new_vocab
    torch.testing.assert_close(lg1[..., torch.from_numpy(maps.keep_ids)],
                               lg2, rtol=1e-5, atol=1e-5)


def test_position_trim_invariance(models):
    _, params = models["unimo-text"]
    cfg = get_reduced("unimo-text")
    p2, cfg2 = PR.trim_positions(params, cfg, 32)
    assert p2["embed"]["pos"].shape[0] == cfg2.max_seq_len == 32
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        4, cfg.vocab_size, size=(2, 16)))
    with torch.no_grad():
        torch.testing.assert_close(T.forward_train(params, cfg, toks)[0],
                                   T.forward_train(p2, cfg2, toks)[0],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-4b", "unimo-text"])
def test_serve_continuous_pruned_parity(models, arch):
    """The reference's pruned serve (``tests/test_pruning.py``): prompts
    are remapped at submission and results unmapped at the end.  Port
    and reference pruned serves give equal streams; inside the port the
    pruned serve equals the unpruned one wherever the unpruned stream
    stays inside the kept vocabulary (and at least once)."""
    jparams, tparams = models[arch]
    cfg, jcfg = get_reduced(arch), j_get_reduced(arch)
    # keep the most frequent V - 64 ids; prompts sample 4..400, so every
    # prompt token survives the prune
    freqs = {i: 10_000 - i for i in range(cfg.vocab_size)}
    trim = {"new_max_len": 64} if cfg.pos_emb == "learned" else {}
    p2, cfg2, maps = PR.prune_model(tparams, cfg, freqs,
                                    max_vocab=cfg.vocab_size - 64, **trim)
    jp2, jcfg2, jmaps = JPR.prune_model(jparams, jcfg, freqs,
                                        max_vocab=jcfg.vocab_size - 64,
                                        **trim)
    rng = np.random.default_rng(0)
    prompts = [([2] + [int(t) for t in rng.integers(4, 400, size=ln)], mn)
               for ln, mn in [(21, 5), (9, 4), (30, 5)]]
    serve = dict(page_size=8, max_batched_tokens=16)

    def port(c, p, maps=None):
        eng = InferenceEngine(c, p, policy=FP32, max_len=64, max_batch=2,
                              device="cpu", prune_maps=maps)
        done, _ = eng.serve_continuous(
            [Request(uid=i, tokens=list(t), max_new_tokens=mn)
             for i, (t, mn) in enumerate(prompts)], **serve)
        return [r.result for r in done]

    jeng = JEngine(jcfg2, jp2, policy=J_FP32, max_len=64, max_batch=2,
                   prune_maps=jmaps)
    jdone, _ = jeng.serve_continuous(
        [JRequest(uid=i, tokens=list(t), max_new_tokens=mn)
         for i, (t, mn) in enumerate(prompts)], chunked_prefill=True,
        **serve)
    pruned = port(cfg2, p2, maps)
    assert pruned == [r.result for r in jdone]
    base = port(cfg, tparams)
    keep = set(maps.keep_ids.tolist())
    compared = 0
    for a, b in zip(base, pruned):
        if all(t in keep for t in a):
            assert b == a
            compared += 1
    assert compared > 0                   # parity actually exercised
    assert all(t in keep for r in pruned for t in r)   # original ids
