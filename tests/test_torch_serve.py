"""The port's ``serve_continuous`` against the reference on reduced
unimo-text (fp32, greedy), same parameters and same requests.

Eight requests of mixed length, the later four sharing prompt prefixes
with the first four — one mid-page, so the radix cache maps a shared
page and copies a partial tail page on write — with 4 slots, 8-token
pages, a 32-token budget and 12 new tokens each.  The run has mixed
(packed) iterations, decode-only iterations, prefix hits and COW copies.
Greedy token streams must equal the reference's, and inside the port
they must not change with the prefix cache off.
"""
import copy

import jax
import numpy as np
import pytest

from repro.configs.registry import get_reduced as j_get_reduced
from repro.core.engine import InferenceEngine as JEngine
from repro.core.precision import FP32 as J_FP32
from repro.core.scheduler import Request as JRequest
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs.registry import get_reduced
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.precision import FP32
from repro_torch.core.scheduler import Request

SERVE = dict(page_size=8, max_batched_tokens=32)
ENGINE = dict(max_len=64, max_batch=4)


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


@pytest.fixture(scope="module")
def params():
    jparams = JT.init_params(jax.random.PRNGKey(0),
                             j_get_reduced("unimo-text"), J_FP32)
    return jparams, bridge.params_from_jax(jax.tree.map(np.asarray, jparams))


def _serve_port(params, prefix_cache=None, num_pages=None):
    eng = InferenceEngine(get_reduced("unimo-text"), params, policy=FP32,
                          device="cpu", **ENGINE)
    reqs = [Request(uid=i, tokens=p, max_new_tokens=12)
            for i, p in enumerate(_prompts())]
    done, m = eng.serve_continuous(reqs, prefix_cache=prefix_cache,
                                   num_pages=num_pages, **SERVE)
    return {r.uid: r.result for r in done}, m


@pytest.mark.parametrize("num_pages", [None, 14])
def test_serve_matches_reference_greedy(params, num_pages):
    """``num_pages=14`` is under half the default pool: admissions stall
    on pages and the radix cache evicts."""
    jparams, tparams = params
    jeng = JEngine(j_get_reduced("unimo-text"), jparams, policy=J_FP32,
                   **ENGINE)
    jreqs = [JRequest(uid=i, tokens=p, max_new_tokens=12)
             for i, p in enumerate(_prompts())]
    jdone, jm = jeng.serve_continuous(copy.deepcopy(jreqs),
                                      num_pages=num_pages, **SERVE)
    ref = {r.uid: r.result for r in jdone}
    ours, m = _serve_port(tparams, num_pages=num_pages)
    assert ours == ref
    # the run exercised every part of the slice
    assert m.mixed_iters > 0 and m.dispatches_per_iter == 1.0
    assert m.steps > m.mixed_dispatches            # decode-only steps ran
    assert m.prefix_hits > 0 and m.pages_shared > 0
    assert m.outcome_counts == {"completed": 8}
    if num_pages is None:
        assert m.cow_copies > 0
    else:
        assert m.admission_stalls > 0 and m.prefix_evicted_pages > 0
    for k in ("mixed_iters", "prefix_hits", "prefix_matched_tokens",
              "cow_copies", "pages_shared", "generated_tokens",
              "packed_tokens_real", "packed_tokens_padded", "steps",
              "admission_stalls", "prefix_evicted_pages",
              "peak_pages_in_use"):
        assert getattr(m, k) == getattr(jm, k), k


def test_serve_prefix_cache_off_identical(params):
    _, tparams = params
    on, m_on = _serve_port(tparams)
    off, m_off = _serve_port(tparams, prefix_cache=False)
    assert on == off
    assert m_on.prefix_hits > 0 and m_off.prefix_hits == 0
    assert m_off.dispatches_per_iter == 1.0


def test_serve_takes_every_reference_option(params):
    """The port's ``serve_continuous`` takes every keyword of the
    reference's, with the same defaults for the overload options;
    ``debug_audit=True`` runs, auditing the allocator on every iteration,
    with the streams of the unaudited serve; ``chunked_prefill=False``
    (bucketed admission of attention models) runs too, with the chunked
    serve's streams."""
    import inspect
    ref = inspect.signature(JEngine.serve_continuous).parameters
    ours = inspect.signature(InferenceEngine.serve_continuous).parameters
    assert set(ref) <= set(ours)
    for k in ("max_preemptions", "debug_audit", "preemption"):
        assert ours[k].default == ref[k].default, k
    _, tparams = params
    eng = InferenceEngine(get_reduced("unimo-text"), tparams, policy=FP32,
                          device="cpu", **ENGINE)
    reqs = [Request(uid=0, tokens=[2, 7, 9, 11], max_new_tokens=3)]
    done, m = eng.serve_continuous(copy.deepcopy(reqs), max_preemptions=5,
                                   debug_audit=False, **SERVE)
    assert m.outcome_counts == {"completed": 1} and len(done[0].result) == 3
    audited, m2 = eng.serve_continuous(copy.deepcopy(reqs), debug_audit=True,
                                       **SERVE)
    assert audited[0].result == done[0].result
    assert m2.outcome_counts == {"completed": 1}
    bucketed, m3 = eng.serve_continuous(copy.deepcopy(reqs),
                                        chunked_prefill=False, **SERVE)
    assert bucketed[0].result == done[0].result
    assert m3.scheduler == "bucketed" and m3.outcome_counts == {
        "completed": 1}
