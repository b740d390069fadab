"""Training on the port (``repro_torch.training``, ``data.pipeline``'s
batchers, ``launch/train.py``), against the reference package.

The same parameters (``bridge.params_from_jax``) and the same numpy
batches go into both packages, in fp32 (the kernels' plain versions,
which autograd differentiates on the CPU).  Tolerances:

* batches: bit for bit (both draw with numpy from the same seeds);
* ``apply_updates`` from the same parameters and gradients: 1e-6 of each
  leaf's largest magnitude (the same elementwise fp32 formulas; only a
  reduction's order differs);
* ``loss_fn``: the value within 1e-5, every gradient leaf within 1e-4 of
  its largest magnitude (XLA and PyTorch sum in other orders);
* whole train steps: loss and gnorm within 1e-5, parameters within 1e-5
  of each leaf's largest magnitude.  The full-AdamW steps use eps = 1e-3:
  the first update is g / (|g| + eps), whose slope at g = 0 is 1 / eps, so
  at the default 1e-8 a gradient entry within rounding of zero (1e-9
  apart between the packages) may move its parameter by up to a tenth of
  the learning rate either way; factored AdamW divides by row and column
  statistics instead and keeps the default.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import precision as JP
from repro.core.tokenizer import FastTokenizer as JTok
from repro.data import pipeline as JD
from repro.models import transformer as JT
from repro.training import optimizer as JOPT
from repro.training import train_loop as JTL
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.core import precision as P
from repro_torch.core.tokenizer import FastTokenizer
from repro_torch.data import pipeline as D
from repro_torch.launch import train as LT
from repro_torch.models import ssm as SSM
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_loop as TL

ARCHS = ("unimo-text", "qwen3-4b", "gemma2-2b", "qwen3-moe-235b-a22b",
         "deepseek-v3-671b", "hymba-1.5b", "xlstm-125m", "internvl2-1b",
         "musicgen-medium")
# gemma2-2b past its reduced window (64); hymba-1.5b at 24 tokens: from
# 40 on the reference's Mamba chunk overflows above the diagonal and its
# gradient is NaN (the port's is finite, which the last test holds)
SEQ = {"gemma2-2b": 72, "hymba-1.5b": 24}


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
    """Both packages' reduced configs and the reference's parameters (as
    JAX arrays and as numpy), drawn once per arch."""
    jcfg, cfg = JR.get_reduced(arch), R.get_reduced(arch)
    jp = jax.jit(JT.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   jcfg)
    return jcfg, cfg, jp, jax.tree.map(np.asarray, jp)


def _params(arch):
    """A fresh copy of the port's parameters (the port updates in
    place)."""
    return bridge.params_from_jax(_weights(arch)[3])


@functools.lru_cache(maxsize=None)
def _batch(arch, B=2, S=None):
    """A numpy batch: random tokens (codebooks for an audio model) and,
    for a vision model, prefix embeddings."""
    cfg = R.get_reduced(arch)
    b = next(D.random_batches(cfg.vocab_size, batch_size=B,
                              seq_len=S or SEQ.get(arch, 40),
                              num_codebooks=cfg.num_codebooks, seed=3))
    if cfg.num_prefix_embeds:
        b["prefix_embeds"] = 0.02 * np.random.default_rng(4).normal(
            size=(B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    return b


def _flat_np(tree) -> dict:
    return {k: (v.detach().float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in OPT.flatten(tree).items()}


def _close_leaves(got: dict, want: dict, rel: float):
    """Every leaf of ``got`` within ``rel`` of the largest magnitude of
    ``want``'s leaf (the keys equal)."""
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k], np.float32), np.asarray(got[k])
        assert g.shape == w.shape, k
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale + 1e-30,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# Batches and policy
# ---------------------------------------------------------------------------


def test_packed_batches_equal_reference():
    """``packed_batches`` over the Zipf corpus, past the corpus's end (the
    stream starts over), and ``repeat=False``'s last batch: the same
    arrays, dtypes included, as the reference's."""
    corpus = D.synthetic_corpus(60, seed=1)
    assert corpus == JD.synthetic_corpus(60, seed=1)
    tok, jtok = FastTokenizer.train(corpus, 300), JTok.train(corpus, 300)
    kw = dict(batch_size=3, seq_len=16)
    got = D.packed_batches(tok, corpus, **kw)
    want = JD.packed_batches(jtok, corpus, **kw)
    n = 3 * len(list(D.token_stream(tok, corpus))) // (3 * 17) + 2
    for _ in range(n):
        g, w = next(got), next(want)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
            assert g[k].dtype == w[k].dtype
    once = list(D.packed_batches(tok, corpus, repeat=False, **kw))
    jonce = list(JD.packed_batches(jtok, corpus, repeat=False, **kw))
    assert len(once) == len(jonce) > 0
    np.testing.assert_array_equal(once[-1]["labels"], jonce[-1]["labels"])


@pytest.mark.parametrize("codebooks", [0, 4])
def test_random_batches_equal_reference(codebooks):
    got = D.random_batches(300, batch_size=2, seq_len=9,
                           num_codebooks=codebooks, seed=5)
    want = JD.random_batches(300, batch_size=2, seq_len=9,
                             num_codebooks=codebooks, seed=5)
    for _ in range(3):
        g, w = next(got), next(want)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
            assert g[k].dtype == w[k].dtype


def test_mixed_policy_is_the_reference_mixed_train():
    m = P.get_policy("mixed")
    assert m is P.MIXED
    assert (m.param_dtype, m.compute_dtype, m.output_dtype) == (
        torch.float32, torch.bfloat16, torch.float32)
    jm = JP.get_policy("mixed")
    assert (jm.param_dtype, jm.compute_dtype, jm.output_dtype) == (
        jnp.float32, jnp.bfloat16, jnp.float32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 100, 150])
def test_lr_at_matches_reference(step):
    c = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    assert OPT.lr_at(OPT.AdamWConfig(**c), step) == float(
        JOPT.lr_at(JOPT.AdamWConfig(**c), jnp.asarray(step)))


@pytest.mark.parametrize("lr,warmup,total", [
    (1e-4, 1, 10), (3e-3, 2, 10), (3e-4, 5, 30), (1e-3, 7, 100)])
def test_lr_at_matches_jitted_reference(lr, warmup, total):
    """Every step's learning rate equals the one the reference's jitted
    train step computes, bit for bit (XLA folds and fuses the schedule's
    fp32 arithmetic; the eager formula differs by a unit at some of
    these steps, e.g. step 2 at lr 1e-4, warmup 1)."""
    c = dict(lr=lr, warmup_steps=warmup, total_steps=total)
    jlr = jax.jit(lambda s: JOPT.lr_at(JOPT.AdamWConfig(**c), s))
    for step in range(total + 2):
        assert OPT.lr_at(OPT.AdamWConfig(**c), step) == float(
            jlr(jnp.asarray(step))), step


@pytest.mark.parametrize("arch", ["unimo-text", "deepseek-v3-671b"])
@pytest.mark.parametrize("factored", [False, True])
def test_apply_updates_matches_reference(arch, factored):
    """Three AdamW steps from the same parameters and gradients (larger
    than the clip on the first step).  On unimo-text's stacks of 2 repeats
    the layer norms' weights and biases and the learned positions decay,
    the final norm does not, and in factored mode the layers' 1-D leaves
    share one (2,) x (n,) statistic per stack; deepseek-v3's unstacked MTP
    module decays and factors by its own ranks.  Parameters, moments
    (converted by ``bridge.opt_state_from_jax``), lr and gnorm equal."""
    jcfg, cfg, jp, jnp_params = _weights(arch)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, factored=factored)
    params = _params(arch)
    state = OPT.init_state(params, factored=factored, model_cfg=cfg)
    jstate = JOPT.init_state(jp, factored=factored)
    japply = jax.jit(functools.partial(JOPT.apply_updates,
                                       JOPT.AdamWConfig(**ocfg)))
    rng = np.random.default_rng(7)
    for i in range(3):
        gnp = jax.tree.map(lambda a: (rng.normal(size=a.shape)
                                      * (0.5 if i else 3.0)).astype(
                                          np.float32), jnp_params)
        jp, jstate, jm = japply(jp, jax.tree.map(jnp.asarray, gnp), jstate)
        params, state, m = OPT.apply_updates(
            OPT.AdamWConfig(**ocfg), params, bridge.params_from_jax(gnp),
            state)
        assert m["lr"] == float(jm["lr"])
        np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]),
                                   rtol=1e-6)
    want = bridge.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                     jnp_params, cfg)
    assert state.step == want.step == 3
    _close_leaves(_flat_np(params),
                  _flat_np(bridge.params_from_jax(
                      jax.tree.map(np.asarray, jp))), 1e-6)
    for got_t, want_t in ((state.mu, want.mu), (state.nu, want.nu)):
        if want_t is None:
            assert got_t is None
            continue
        _close_leaves(_flat_np(got_t), _flat_np(want_t), 1e-6)
    if factored:
        assert state.groups == want.groups
        if arch == "unimo-text":
            assert state.groups["stacks/0/0/norm1/w"] == [
                "layers/0/norm1/w", "layers/1/norm1/w"]


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, S=None):
    jcfg, _, jp, _ = _weights(arch)
    f = jax.jit(jax.value_and_grad(JTL.loss_fn, has_aux=True),
                static_argnums=(1, 3, 4))
    (loss, parts), grads = f(jp, jcfg, {k: jnp.asarray(v) for k, v in
                                        _batch(arch, S=S).items()},
                             JP.FP32, False)
    return (float(loss), {k: float(v) for k, v in parts.items()},
            bridge.params_from_jax(jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_reference(arch):
    """``loss_fn`` (rematerialised layers) and its gradient on every leaf
    equal ``jax.value_and_grad`` of the reference's: the LM loss (per
    codebook for musicgen, after the prefix for internvl2), the MoE
    load-balance loss (qwen3-moe, deepseek-v3) and the MTP loss
    (deepseek-v3); the mLSTM and sLSTM layers from the zero state."""
    cfg = R.get_reduced(arch)
    jloss, jparts, jgrads = _jax_loss_and_grads(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    loss, parts, grads = TL._grads(_params(arch), cfg, batch, P.FP32,
                                   remat=True)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    for k in ("ce", "moe_aux"):
        np.testing.assert_allclose(float(parts[k]), jparts[k], rtol=1e-5,
                                   atol=1e-7)
    assert (jparts["moe_aux"] > 0) == (cfg.moe is not None)
    _close_leaves({k: v.numpy() for k, v in grads.items()},
                  _flat_np(jgrads), 1e-4)


# ---------------------------------------------------------------------------
# Train steps, checkpoints, the CLI
# ---------------------------------------------------------------------------


# (arch, factored, microbatches, eps, lr, warmup_steps, steps)
STEPS = {"unimo-text full": ("unimo-text", False, 1, 1e-3, 3e-3, 2, 2),
         "qwen3-4b factored accum 2": ("qwen3-4b", True, 2, 1e-8, 3e-3, 2,
                                       2),
         # the optimizer settings of chip_smoke.py's full-width qwen3-4b
         # run, whose loss rose at its third step on the card
         "qwen3-4b factored accum 2, 3 steps at lr 1e-4": (
             "qwen3-4b", True, 2, 1e-8, 1e-4, 1, 3)}


@pytest.mark.parametrize("case", list(STEPS))
def test_train_steps_match_reference(case):
    """``make_train_step`` steps on packed batches of 4 x 32: two of full
    AdamW on unimo-text; two and three of factored AdamW with two
    microbatches of 2 rows on qwen3-4b.  Loss, ce, lr and gnorm of each
    step and every parameter after them equal the reference's."""
    arch, factored, accum, eps, lr, warmup, steps = STEPS[case]
    jcfg, cfg, jp, _ = _weights(arch)
    ocfg = dict(lr=lr, warmup_steps=warmup, total_steps=10, eps=eps,
                factored=factored)
    corpus = D.synthetic_corpus(80, seed=2)
    tok = FastTokenizer.train(corpus, min(cfg.vocab_size, 400))
    batches = D.packed_batches(tok, corpus, batch_size=4, seq_len=32)
    jstep = jax.jit(JTL.make_train_step(jcfg, JOPT.AdamWConfig(**ocfg),
                                        policy=JP.FP32, grad_accum=accum))
    step = TL.make_train_step(cfg, OPT.AdamWConfig(**ocfg), policy=P.FP32,
                              grad_accum=accum)
    params = _params(arch)
    state = OPT.init_state(params, factored=factored, model_cfg=cfg)
    jstate = JOPT.init_state(jp, factored=factored)
    for _ in range(steps):
        b = next(batches)
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        params, state, m = step(params, state, TL.to_device(b, "cpu"))
        assert m["lr"] == float(jm["lr"])
        for k in ("loss", "ce", "gnorm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    _close_leaves(_flat_np(params), _flat_np(bridge.params_from_jax(
        jax.tree.map(np.asarray, jp))), 1e-5)


def test_train_loop_loss_decreases():
    """``train`` (the reference's ``test_loss_decreases``): reduced
    unimo-text at a 256-token vocabulary, packed batches of 4 x 32, 30
    steps; the loss falls by 0.3 nats and the history logs steps 0 and
    29."""
    cfg = R.get_reduced("unimo-text").replace(vocab_size=256)
    corpus = D.synthetic_corpus(300, seed=1)
    tok = FastTokenizer.train(corpus, 256)
    params = OPT.unflatten_like(_params("unimo-text"), {
        k: v[:256] if k == "embed/tokens" else v
        for k, v in OPT.flatten(_params("unimo-text")).items()})
    batches = D.packed_batches(tok, corpus, batch_size=4, seq_len=32)
    _, state, hist = TL.train(cfg, params, batches, steps=30, policy=P.FP32,
                              log_every=29)
    assert [h["step"] for h in hist] == [0, 29] and state.step == 30
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3


def test_eval_step_matches_loss_fn():
    cfg = R.get_reduced("qwen3-4b")
    batch = {k: torch.from_numpy(v) for k, v in _batch("qwen3-4b").items()}
    m = TL.make_eval_step(cfg, P.FP32)(_params("qwen3-4b"), batch)
    assert float(m["loss"]) == pytest.approx(
        _jax_loss_and_grads("qwen3-4b")[0], rel=1e-5)
    assert not m["loss"].requires_grad


@pytest.mark.parametrize("factored", [False, True])
def test_checkpoint_round_trip_is_exact(tmp_path, factored):
    """Parameters at bf16 and fp32, and the optimizer state after a step
    (bf16 moments in full mode; the factored statistics, shared groups
    included), restore bit for bit into their templates' dtypes; a shape
    that does not fit the template raises."""
    cfg = R.get_reduced("unimo-text")
    params = P.BF16.cast_params(_params("unimo-text"))
    params["final_norm"]["w"] = params["final_norm"]["w"].float()
    state = OPT.init_state(params, torch.bfloat16, factored=factored,
                           model_cfg=cfg)
    grads = OPT.unflatten_like(params, {
        k: torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
        .to(v.dtype) for k, v in OPT.flatten(params).items()})
    params, state, _ = OPT.apply_updates(OPT.AdamWConfig(factored=factored),
                                         params, grads, state)
    path = str(tmp_path / "ckpt")
    CKPT.save(path, params, state, meta={"arch": cfg.name})
    assert json.load(open(path + ".meta.json")) == {"arch": cfg.name}
    zero = OPT.unflatten_like(params, {k: torch.zeros_like(v) for k, v in
                                       OPT.flatten(params).items()})
    template = OPT.init_state(zero, torch.bfloat16, factored=factored,
                              model_cfg=cfg)
    p2, s2 = CKPT.restore(path, zero, template)
    for a, b in ((params, p2), (state.nu, s2.nu)) + (
            ((state.mu, s2.mu),) if not factored else ()):
        fa, fb = OPT.flatten(a), OPT.flatten(b)
        assert sorted(fa) == sorted(fb)
        for k in fa:
            assert fa[k].dtype == fb[k].dtype
            assert torch.equal(fa[k], fb[k]), k
    assert s2.step == 1 and s2.groups == state.groups
    bad = OPT.unflatten_like(zero, {**OPT.flatten(zero), "final_norm/w":
                                    torch.zeros(3)})
    with pytest.raises(ValueError, match="final_norm/w"):
        CKPT.restore(path, bad)


def test_launch_train_runs_on_the_cpu(tmp_path, capsys):
    """``launch/train.py --device cpu --reduced``: JSON lines with the
    reference's keys, a loss that falls, a checkpoint that restores."""
    ck = str(tmp_path / "run")
    LT.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
             "--steps", "6", "--log-every", "5", "--batch-size", "2",
             "--seq-len", "32", "--lr", "3e-3", "--checkpoint", ck])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln["step"] for ln in lines] == [0, 5]
    assert set(lines[0]) == {"step", "loss", "lr", "gnorm", "tok_per_s"}
    assert lines[-1]["loss"] < lines[0]["loss"]
    cfg = R.get_reduced("qwen3-4b")
    params, _ = CKPT.restore(ck, _params("qwen3-4b"))
    assert params["layers"][1]["attn"]["wq"].shape == (
        cfg.d_model, cfg.num_heads * cfg.resolved_head_dim)


def test_launch_train_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LT.main(["--arch", "unimo-text", "--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# Mamba's masked exponent
# ---------------------------------------------------------------------------


def test_mamba_chunk_gradient_is_finite_where_the_exponent_overflows():
    """One Mamba chunk whose decays sum past fp32's range above the
    diagonal (dt * exp(a_log) ~ 2 over 128 steps: exponents up to ~250):
    the forward equals the reference's formula (exp, then the mask) and
    the gradient is finite, where masking after exp gives NaN."""
    rng = np.random.default_rng(0)
    B, S, H, dh, N = 1, SSM.CHUNK, 2, 4, 3
    xh, Bt, Ct = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((B, S, H, dh), (B, S, N), (B, S, N)))
    dt = torch.full((B, S, H), 2.0, requires_grad=True)
    h0 = torch.zeros(B, H, dh, N)
    y, h = SSM._mamba_chunked(xh, Bt, Ct, dt, -dt * 1.0, h0)
    Fc = torch.cumsum(-dt * 1.0, 1).transpose(1, 2)
    diff = Fc[..., :, None] - Fc[..., None, :]
    assert diff.max() > 88.8              # exp overflows fp32 above it
    tri = torch.ones(S, S, dtype=torch.bool).tril()
    old_w = torch.where(tri, torch.exp(diff), 0.0)
    y_old = torch.einsum("bln,bmn->blm", Ct, Bt)[:, None] * old_w \
        * dt.transpose(1, 2)[:, :, None, :]
    y_old = torch.einsum("bhlm,bmhd->blhd", y_old, xh)
    torch.testing.assert_close(y, y_old, rtol=1e-6, atol=1e-6)
    (g,) = torch.autograd.grad(y.sum() + h.sum(), dt)
    assert torch.isfinite(g).all()
    (g_old,) = torch.autograd.grad(y_old.sum(), dt)
    assert torch.isnan(g_old).any()


def test_hymba_gradient_is_finite_where_the_reference_is_nan():
    """Reduced hymba-1.5b over 72 tokens: the same loss as the
    reference's, whose gradient is NaN (its Mamba chunk masks after exp),
    while every leaf of the port's is finite."""
    jloss, _, jgrads = _jax_loss_and_grads("hymba-1.5b", S=72)
    assert any(not np.isfinite(v).all() for v in _flat_np(jgrads).values())
    batch = {k: torch.from_numpy(v)
             for k, v in _batch("hymba-1.5b", S=72).items()}
    loss, _, grads = TL._grads(_params("hymba-1.5b"),
                               R.get_reduced("hymba-1.5b"), batch, P.FP32,
                               remat=False)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    assert all(torch.isfinite(g).all() for g in grads.values())
