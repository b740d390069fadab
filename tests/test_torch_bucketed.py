"""Bucketed admission of attention models (``serve_continuous(
chunked_prefill=False)``) and ``set_prefix`` on the port, against the
reference package.

Reduced unimo-text and qwen3-4b in fp32 (the kernels' plain versions),
the same parameters in both packages.  Eight requests, the later ones
sharing prompt prefixes with the earlier ones (one match ends inside a
page, so its tail page is copied on write), 4 slots, 8-token pages:
admissions group by the bucket of their unmatched suffix and prefill in
one dispatch each, resuming after their matched prefix pages.  Greedy
streams and the admission counters must equal the reference's exactly;
inside the port the bucketed streams equal the chunked ones.
"""
import copy
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.core.engine import InferenceEngine as JEngine
from repro.core.precision import FP32 as J_FP32
from repro.core.scheduler import Request as JRequest
from repro.core.speculative import SpecConfig as JSpecConfig
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs.registry import get_reduced
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.precision import FP32
from repro_torch.core.scheduler import Request
from repro_torch.core.speculative import SpecConfig
from repro_torch.models import transformer as T

ENGINE = dict(max_len=64, max_batch=4)
PAGE = 8
COUNTERS = ("admitted", "retired", "prefill_tokens", "prefill_padded",
            "prefix_hits", "prefix_matched_tokens", "pages_shared",
            "cow_copies", "host_syncs", "steps", "generated_tokens",
            "drafted_tokens", "accepted_tokens", "peak_pages_in_use")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread keeps them fast when several
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts():
    rng = np.random.default_rng(5)

    def body(n):
        return [int(t) for t in rng.integers(4, 400, size=n)]
    first = [[2] + body(n) for n in (19, 30, 11, 23)]
    later = [first[0][:12] + body(9),          # match ends inside a page
             first[1][:17] + body(12),
             first[3][:8] + body(6),           # page-aligned match
             [2] + body(25)]
    return first + later


SYSTEM = [2] + [int(t) for t in np.random.default_rng(9).integers(
    4, 400, size=20)]


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """Both packages' configs and parameters of ``arch`` (the reference's
    init compiled whole: op by op it takes seconds)."""
    jcfg = j_get_reduced(arch)
    jparams = jax.jit(lambda key: JT.init_params(key, jcfg, J_FP32))(
        jax.random.PRNGKey(0))
    return (jcfg, jparams, get_reduced(arch),
            bridge.params_from_jax(jax.tree.map(np.asarray, jparams)))


class _Pair:
    """One reference engine and one port engine on the same weights; the
    reference's jit caches survive ``reset_prefix_cache``, so every mode
    after the first pays no retrace."""

    def __init__(self, arch, kv_dtype="auto"):
        jcfg, jparams, self.cfg, self.params = _weights(arch)
        self.policy = dataclasses.replace(FP32, kv_dtype=kv_dtype)
        self.jeng = JEngine(jcfg, jparams, policy=dataclasses.replace(
            J_FP32, kv_dtype=kv_dtype), **ENGINE)
        self.eng = self.engine()

    def engine(self):
        return InferenceEngine(self.cfg, self.params, policy=self.policy,
                               device="cpu", **ENGINE)

    def serve(self, prompts, prefix=None, spec=False, **kw):
        """Both packages' bucketed serves from a cold pool (``set_prefix``
        first when given): (reference streams and metrics, ours)."""
        out = []
        for eng, req, sc in ((self.jeng, JRequest, JSpecConfig),
                             (self.eng, Request, SpecConfig)):
            eng.reset_prefix_cache()
            if prefix is not None:
                eng.set_prefix(prefix, page_size=PAGE)
            done, m = eng.serve_continuous(
                [req(uid=i, tokens=list(p), max_new_tokens=8)
                 for i, p in enumerate(prompts)], page_size=PAGE,
                chunked_prefill=False, spec=sc(k=3) if spec else None, **kw)
            out.append(({r.uid: r.result for r in done}, m))
        return out


@pytest.fixture(scope="module")
def pairs():
    """Engine pairs by (arch, kv_dtype), built once for the module."""
    made = {}

    def get(arch, kv_dtype="auto"):
        if (arch, kv_dtype) not in made:
            made[arch, kv_dtype] = _Pair(arch, kv_dtype)
        return made[arch, kv_dtype]
    return get


@pytest.mark.parametrize("arch", ["unimo-text", "qwen3-4b"])
@pytest.mark.parametrize("mode", ["shared", "unshared", "set_prefix",
                                  "int8", "spec"])
def test_bucketed_serve_matches_reference(pairs, arch, mode):
    """``shared``: the radix cache on (prefix hits, a COW copy); the
    same with ``prefix_cache=False``; a 21-token system prompt pinned by
    ``set_prefix`` before requests that all start with it; int8 pools
    (whole prompts attend their written pages); n-gram speculation
    (k = 3) on the bucketed path."""
    pair = pairs(arch, "int8" if mode == "int8" else "auto")
    prompts = _prompts()
    kw = {}
    if mode == "unshared":
        kw["prefix_cache"] = False
    if mode == "set_prefix":
        prompts = [SYSTEM + p[1:] for p in prompts[:5]]
    (ref, jm), (ours, m) = pair.serve(
        prompts, prefix=SYSTEM if mode == "set_prefix" else None,
        spec=mode == "spec", **kw)
    assert ours == ref
    for k in COUNTERS:
        assert getattr(m, k) == getattr(jm, k), k
    assert m.scheduler == jm.scheduler == "bucketed"
    assert m.outcome_counts == {"completed": len(prompts)}
    assert m.mixed_iters == 0 and m.prefill_padded > m.prefill_tokens
    if mode in ("shared", "int8", "spec"):
        assert m.prefix_hits > 0 and m.cow_copies > 0
    if mode == "set_prefix":
        assert m.prefix_hits == len(prompts)
        assert m.prefix_matched_tokens >= len(prompts) * 16
    if mode == "spec":
        assert m.spec_mode == "ngram" and m.drafted_tokens > 0
    # inside the port: bucketed == chunked (and == the non-speculative
    # bucketed serve under spec)
    eng = pair.engine()
    if mode == "set_prefix":
        eng.set_prefix(SYSTEM, page_size=PAGE)
    done, mc = eng.serve_continuous(
        [Request(uid=i, tokens=list(p), max_new_tokens=8)
         for i, p in enumerate(prompts)], page_size=PAGE,
        max_batched_tokens=32, **kw)
    assert {r.uid: r.result for r in done} == ours
    assert mc.scheduler == "unified"


def test_set_prefix_clear_and_reset():
    """As the reference's ``test_prefix_caching_equivalence``: a pinned
    prefix leaves ``generate_batch`` unchanged and every bucketed
    admission hits it with the dense path's greedy ids; pinned pages
    survive a pool squeeze, ``clear_prefix`` makes them evictable, and
    ``reset_prefix_cache`` drops the pool."""
    cfg = get_reduced("qwen3-4b")
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    eng = InferenceEngine(cfg, params, policy=FP32, max_len=96,
                          device="cpu")
    rng = np.random.default_rng(2)
    prefix = [2] + [int(t) for t in rng.integers(4, 400, size=11)]
    full = np.concatenate([np.tile(prefix, (2, 1)), rng.integers(
        4, 400, size=(2, 5))], axis=1).astype(np.int32)
    lens = np.full(2, full.shape[1], np.int32)
    g_ref = eng.generate_batch(full.copy(), lens, 5)
    eng.set_prefix(prefix, page_size=PAGE)
    np.testing.assert_array_equal(eng.generate_batch(full.copy(), lens, 5),
                                  g_ref)
    reqs = [Request(uid=i, tokens=[int(t) for t in full[i]],
                    max_new_tokens=5) for i in range(2)]
    done, m = eng.serve_continuous(copy.deepcopy(reqs), page_size=PAGE,
                                   chunked_prefill=False)
    for i, r in enumerate(done):
        assert r.result == [int(t) for t in g_ref[i] if t >= 0]
    assert m.prefix_hits == len(reqs)
    trie = eng._paged_ctx["trie"]
    trie.evict(10 ** 6)                       # the pinned path stays
    assert trie.match(prefix)[0] == len(prefix)
    eng.clear_prefix()
    trie.evict(10 ** 6)
    assert trie.num_nodes == 0
    eng.reset_prefix_cache()
    assert eng._paged_ctx is None


def test_set_prefix_optout_warns_noop():
    cfg = get_reduced("xlstm-125m")
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    eng = InferenceEngine(cfg, params, policy=FP32, max_len=64, max_batch=2,
                          device="cpu")
    with pytest.warns(UserWarning, match="sharing disabled"):
        eng.set_prefix([2, 3, 4, 5])
    assert eng._paged_ctx is None
