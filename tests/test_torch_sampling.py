"""The port's sampling against the reference: the filtered distribution
(temperature, top-k, top-p) must equal the reference's on the same logits,
greedy picks the first maximum, and a sampled serve is reproducible from
the engine's seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampling as JS
from repro_torch.configs.registry import get_reduced
from repro_torch.core import sampling as S
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.precision import FP32
from repro_torch.core.scheduler import Request
from repro_torch.models import transformer as T


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 0, 1.0), (1.0, 5, 1.0), (0.8, 0, 0.9), (1.3, 40, 0.5)])
def test_filtered_distribution_matches_reference(temperature, top_k, top_p):
    logits = np.random.default_rng(0).normal(size=(4, 97)).astype(np.float32)
    sp = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    ours = torch.softmax(S._filter_logits(torch.from_numpy(logits),
                                          S.SamplingParams(**sp)), -1)
    ref = JS.target_probs(jnp.asarray(logits), JS.SamplingParams(**sp))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


def test_greedy_takes_the_first_maximum():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert S.sample(logits, None, S.SamplingParams()).tolist() == [1, 0]


def test_sampled_serve_is_reproducible_and_in_filter():
    cfg = get_reduced("unimo-text")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    sp = S.SamplingParams(temperature=0.8, top_k=20, top_p=0.9)
    prompts = [[2, 5, 6, 7, 8, 9], [2] + list(range(10, 30))]

    def serve(seed):
        eng = InferenceEngine(cfg, params, policy=FP32, max_len=64,
                              max_batch=2, device="cpu", seed=seed)
        done, _ = eng.serve_continuous(
            [Request(uid=i, tokens=p, max_new_tokens=8)
             for i, p in enumerate(prompts)], sp, page_size=8)
        return [r.result for r in done]

    a, b, c = serve(1), serve(1), serve(2)
    assert a == b and a != c
    assert all(0 <= t < cfg.vocab_size for r in a for t in r)
