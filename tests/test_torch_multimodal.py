"""internvl2-1b (image prefix embeddings) and musicgen-medium (codebooks,
sinusoidal positions) on the port, against the reference package.

Their reduced configs in fp32 (the kernels' plain versions), the same
parameters in both packages (``bridge.params_from_jax``): internvl2's 16
prefix embeddings go in front of the text and count towards the prompt
lengths; musicgen's (B, S, 2) tokens sum two codebook tables and its
logits are (B, S, 2, V).  Only text-only internvl2 reaches the engine;
musicgen-medium is refused there (the reference's engine has no
multi-codebook decoding either).

Tolerances: logits 1e-5 (XLA and PyTorch sum fp32 matmuls in other
orders, ~3e-6 at these widths); decode against teacher forcing 1e-5;
greedy streams and counters exactly.
"""
import functools
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import precision as JP
from repro.core import pruning as JPR
from repro.core.engine import InferenceEngine as JEngine
from repro.core.scheduler import Request as JRequest
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.core import precision as P
from repro_torch.core import pruning as PR
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.scheduler import Request
from repro_torch.models import transformer as T

VLM, AUDIO = "internvl2-1b", "musicgen-medium"
TOL = 1e-5
MAX_LEN = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """Both packages' reduced configs and parameters (the reference's init
    compiled whole)."""
    jcfg = JR.get_reduced(arch)
    jparams = jax.jit(lambda key: JT.init_params(key, jcfg, JP.FP32))(
        jax.random.PRNGKey(0))
    return (jcfg, jparams, R.get_reduced(arch),
            bridge.params_from_jax(jax.tree.map(np.asarray, jparams)))


def _inputs(arch, B=2, S=12, seed=7):
    """Tokens ((B, S) or (B, S, C)), prefix embeddings (internvl2: (B, P,
    d) at 0.02 x normal, else None) and one more token per row (the next
    decode step's), from numpy."""
    cfg = R.get_reduced(arch)
    rng = np.random.default_rng(seed)
    shape = (B, S + 3) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    toks = rng.integers(4, cfg.vocab_size, size=shape).astype(np.int32)
    pre = (rng.normal(size=(B, cfg.num_prefix_embeds, cfg.d_model)) * 0.02
           ).astype(np.float32) if cfg.num_prefix_embeds else None
    return toks, pre


def _shapes(t, pre=""):
    if isinstance(t, dict):
        return {k: v for key, sub in t.items()
                for k, v in _shapes(sub, f"{pre}/{key}").items()}
    if isinstance(t, list):
        return {k: v for i, sub in enumerate(t)
                for k, v in _shapes(sub, f"{pre}/{i}").items()}
    return {pre: tuple(t.shape)}


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_params_from_jax_match_port_init(arch):
    """The bridge carries musicgen's (C, V, d) codebook tables; the port's
    own init draws the same tree."""
    _, _, cfg, params = _weights(arch)
    ours = T.init_params(torch.Generator().manual_seed(0), cfg, P.FP32)
    assert _shapes(ours) == _shapes(params)
    want = ((cfg.num_codebooks, cfg.vocab_size, cfg.d_model)
            if cfg.num_codebooks else (cfg.vocab_size, cfg.d_model))
    assert tuple(params["embed"]["tokens"].shape) == want


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_forwards_match_reference(arch):
    """``forward_train``, then ``forward_prefill`` of rows of 12 and 9
    valid tokens (internvl2: after its prefix embeddings, which the
    lengths count) into a dense cache and three ``forward_decode`` steps:
    logits within TOL of the reference's, musicgen's (B, S, C, V) with
    its sinusoidal positions."""
    jcfg, jparams, cfg, params = _weights(arch)
    toks, pre = _inputs(arch)
    P_ = cfg.num_prefix_embeds
    lens = np.asarray([12 + P_, 9 + P_], np.int32)
    jpre = None if pre is None else jnp.asarray(pre)

    @jax.jit
    def jrun(p, t, n, pe):
        tl, _ = JT.forward_train(p, jcfg, t[:, :12], prefix_embeds=pe,
                                 policy=JP.FP32)
        c = JT.init_cache(jcfg, 2, MAX_LEN, jnp.float32)
        lp, c = JT.forward_prefill(p, jcfg, t[:, :12], n, c,
                                   prefix_embeds=pe, policy=JP.FP32,
                                   max_len=MAX_LEN)
        outs = []
        for i in range(3):
            ld, c = JT.forward_decode(p, jcfg, t[:, 12 + i:13 + i], c,
                                      n + i, policy=JP.FP32,
                                      max_len=MAX_LEN)
            outs.append(ld)
        return tl, lp, outs
    jtl, jlp, jld = jrun(jparams, jnp.asarray(toks), jnp.asarray(lens),
                         jpre)
    t_toks, t_lens = torch.from_numpy(toks), torch.from_numpy(lens)
    tpre = None if pre is None else torch.from_numpy(pre)
    cache = T.init_cache(cfg, 2, MAX_LEN, torch.float32)
    with torch.no_grad():
        tl = T.forward_train(params, cfg, t_toks[:, :12],
                             prefix_embeds=tpre)[0]
        lp, _ = T.forward_prefill(params, cfg, t_toks[:, :12], t_lens, cache,
                                  prefix_embeds=tpre, max_len=MAX_LEN)
        ld = [T.forward_decode(params, cfg, t_toks[:, 12 + i:13 + i], cache,
                               t_lens + i, max_len=MAX_LEN)[0]
              for i in range(3)]
    S = 12 + P_
    want = (2, S) + ((cfg.num_codebooks,) if cfg.num_codebooks else ()) \
        + (cfg.vocab_size,)
    assert tuple(tl.shape) == tuple(lp.shape) == want
    np.testing.assert_allclose(tl.numpy(), np.asarray(jtl), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lp.numpy()[0], np.asarray(jlp)[0], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lp.numpy()[1, :9 + P_],
                               np.asarray(jlp)[1, :9 + P_], rtol=TOL,
                               atol=TOL)
    for a, b in zip(ld, jld):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_decode_equals_teacher_forcing(arch):
    """The counterpart of ``tests/test_cache.py``'s check: prefill 12
    tokens (after the prefix), then decode the next three one at a time
    through the dense cache; each step's logits (and the prefill's last)
    equal ``forward_train``'s at the same position within TOL."""
    _, _, cfg, params = _weights(arch)
    toks, pre = _inputs(arch, B=1, seed=3)
    t = torch.from_numpy(toks)
    tpre = None if pre is None else torch.from_numpy(pre)
    P_ = cfg.num_prefix_embeds
    cache = T.init_cache(cfg, 1, MAX_LEN, torch.float32)
    with torch.no_grad():
        full = T.forward_train(params, cfg, t, prefix_embeds=tpre)[0][0]
        lp, _ = T.forward_prefill(
            params, cfg, t[:, :12], torch.tensor([12 + P_]), cache,
            prefix_embeds=tpre, max_len=MAX_LEN, last_only=True)
        got = [lp[0, 0]]
        for i in range(12, 14):
            ld, _ = T.forward_decode(params, cfg, t[:, i:i + 1], cache,
                                     torch.tensor([P_ + i]), max_len=MAX_LEN)
            got.append(ld[0, 0])
    torch.testing.assert_close(torch.stack(got), full[P_ + 11:P_ + 14],
                               rtol=TOL, atol=TOL)


def test_text_only_packed_serve_matches_reference():
    """internvl2 without an image serves packed like any GQA model (g =
    2 here, 7 at full width): four prompts of 5-30 tokens x 6 new, 3
    slots, the unified scheduler's 48-token budget; streams and counters
    equal the reference's."""
    jcfg, jparams, cfg, params = _weights(VLM)
    rng = np.random.default_rng(5)
    prompts = [[2] + [int(t) for t in rng.integers(4, 400, size=n - 1)]
               for n in (30, 5, 17, 9)]
    out = []
    for eng, req in ((JEngine(jcfg, jparams, policy=JP.FP32,
                              max_len=MAX_LEN, max_batch=3), JRequest),
                     (InferenceEngine(cfg, params, policy=P.FP32,
                                      max_len=MAX_LEN, max_batch=3,
                                      device="cpu"), Request)):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            done, m = eng.serve_continuous(
                [req(uid=i, tokens=list(p), max_new_tokens=6)
                 for i, p in enumerate(prompts)], page_size=8,
                max_batched_tokens=48)
        out.append(({r.uid: r.result for r in done}, m))
    (ref, jm), (ours, m) = out
    assert ours == ref
    for k in ("admitted", "retired", "prefill_tokens", "steps",
              "mixed_iters", "generated_tokens", "host_syncs",
              "peak_pages_in_use"):
        assert getattr(m, k) == getattr(jm, k), k
    assert m.scheduler == "unified" and m.mixed_iters > 0


def test_prune_vocab_codebooks_matches_reference():
    """``prune_vocab`` keeps the same ids in each codebook table."""
    jcfg, jparams, cfg, params = _weights(AUDIO)
    keep = np.unique(np.r_[0, 1, 2, 3, np.random.default_rng(2).integers(
        4, cfg.vocab_size, size=60)])
    maps, jmaps = (PR.build_maps(keep, cfg.vocab_size),
                   JPR.build_maps(keep, cfg.vocab_size))
    new, ncfg = PR.prune_vocab(params, cfg, maps)
    jnew, jncfg = JPR.prune_vocab(jparams, jcfg, jmaps)
    assert ncfg.vocab_size == jncfg.vocab_size == len(keep)
    np.testing.assert_array_equal(new["embed"]["tokens"].numpy(),
                                  np.asarray(jnew["embed"]["tokens"]))
    assert tuple(new["embed"]["tokens"].shape) == (
        cfg.num_codebooks, len(keep), cfg.d_model)
    # a table of output heads, where present, is pruned the same way
    heads = {**params, "embed": {**params["embed"],
                                 "heads": params["embed"]["tokens"] * 2}}
    jheads = {**jparams, "embed": {**jparams["embed"],
                                   "heads": jparams["embed"]["tokens"] * 2}}
    np.testing.assert_array_equal(
        PR.prune_vocab(heads, cfg, maps)[0]["embed"]["heads"].numpy(),
        np.asarray(JPR.prune_vocab(jheads, jcfg, jmaps)[0]["embed"][
            "heads"]))


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_serve_cli_refuses_multimodal_as_reference(arch, monkeypatch):
    """Both serving CLIs refuse the audio and VLM backbones with the same
    message."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as ours:
        serve.main(["--arch", arch, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch])
    with pytest.raises(SystemExit) as ref:
        jserve.main()
    assert str(ours.value) == str(ref.value)
    assert "audio/VLM" in str(ours.value)


def test_engine_refuses_codebooks():
    """A deliberate difference: the reference's engine takes musicgen and
    fails inside ``generate_batch`` with a shape error; the port's
    refuses it when built, naming ``num_codebooks``."""
    _, _, cfg, params = _weights(AUDIO)
    with pytest.raises(NotImplementedError, match="num_codebooks=2"):
        InferenceEngine(cfg, params, policy=P.FP32, device="cpu")
