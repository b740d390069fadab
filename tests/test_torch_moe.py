"""qwen3-moe-235b-a22b on the port, against the reference package.

The reduced config (4 experts, top-2, capacity factor 1.5) in fp32 (the
kernels' plain versions), the same parameters in both packages
(``bridge.params_from_jax``).  ``moe_apply`` is held against the
reference's ``moe_apply_capacity`` where the capacity drops assignments,
at a raised capacity, with padding rows and at bf16; the model through
every serving path of the reference that admits it.

Tolerances: MoE outputs 1e-5 at fp32 (XLA and PyTorch sum the expert
products in other orders, ~1e-6 at these widths), the auxiliary loss
1e-6, bf16 2e-2 (one bf16 ulp of values of order one); logits 1e-5;
greedy streams, warnings and counters exactly.  The int8 serve is held
against the reference's int8 path, not against fp32.
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
from repro.core import precision as JP
from repro.core.engine import InferenceEngine as JEngine
from repro.core.scheduler import Request as JRequest
from repro.core.speculative import SpecConfig as JSpecConfig
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.configs.base import MoEConfig
from repro_torch.core import precision as P
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.scheduler import Request
from repro_torch.core.speculative import SpecConfig
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

ARCH = "qwen3-moe-235b-a22b"
NEW_ARCHS = [ARCH, "internvl2-1b", "musicgen-medium"]
ENGINE = dict(max_len=64, max_batch=3)
PAGE = 8
TOL = 1e-5
COUNTERS = ("admitted", "retired", "prefill_tokens", "prefill_padded",
            "prefix_hits", "pages_shared", "cow_copies", "host_syncs",
            "steps", "mixed_iters", "generated_tokens", "peak_pages_in_use",
            "preemptions")
INT8 = dict(kv_dtype="int8", weights_dtype="int8")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread keeps them fast when several
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raised(cfg, factor):
    return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=factor))


@functools.lru_cache(maxsize=None)
def _weights(factor=None):
    """Both packages' reduced configs (capacity factor ``factor``, else
    the config's own) and parameters (the reference's init compiled
    whole)."""
    jcfg, cfg = JR.get_reduced(ARCH), R.get_reduced(ARCH)
    if factor is not None:
        jcfg, cfg = _raised(jcfg, factor), _raised(cfg, factor)
    jparams = jax.jit(lambda key: JT.init_params(key, jcfg, JP.FP32))(
        jax.random.PRNGKey(0))
    return (jcfg, jparams, cfg,
            bridge.params_from_jax(jax.tree.map(np.asarray, jparams)))


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------


def _stacks(cfg):
    return [([(s.mixer, s.ffn, s.window) for s in st.pattern], st.repeats)
            for st in cfg.stacks]


@pytest.mark.parametrize("which", ["get_config", "get_reduced"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_matches_reference(arch, which):
    """Every field the port's config has equals the reference's, the MoE
    block field by field; the reference's MLA / SSM / MTP fields are
    unset; the registry lists the arch and ``check_supported`` admits
    it."""
    ours, ref = getattr(R, which)(arch), getattr(JR, which)(arch)
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if f.name == "stacks":
            assert _stacks(ours) == _stacks(ref)
        elif f.name == "moe":
            assert (a is None) == (b is None)
            if a is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    assert (ref.mla, ref.ssm, ref.mtp) == (None, None, False)
    assert arch in R.list_archs()
    T.check_supported(ours)


def test_check_supported_refuses_the_rest():
    """Every family of the reference is ported now, shared experts too;
    what stays outside: FFNs the reference pairs with no such mixer (a
    hybrid layer with a MoE FFN, MLA or attention without an FFN), and an
    MLA or hybrid layer in a config without its MLA / SSM block."""
    from repro_torch.configs.base import (HYBRID, MLA, NO_FFN, LayerSpec,
                                          SSMConfig)
    cfg = R.get_reduced(ARCH)

    def one(spec, **kw):
        return cfg.replace(stacks=(type(cfg.stacks[0])((spec,), 1),), **kw)
    for spec in (LayerSpec(mixer=HYBRID, ffn="moe"),
                 LayerSpec(mixer=MLA, ffn=NO_FFN), LayerSpec(ffn=NO_FFN)):
        with pytest.raises(NotImplementedError, match="is not ported"):
            T.check_supported(one(spec, ssm=SSMConfig()))
    for mixer in (MLA, HYBRID):
        with pytest.raises(ValueError, match=f"needs the config's {mixer}"):
            T.check_supported(one(LayerSpec(mixer=mixer)))
    T.check_supported(cfg.replace(moe=MoEConfig(
        num_experts=4, top_k=2, num_shared_experts=1, d_ff_expert=8)))


def _shapes(t, pre=""):
    if isinstance(t, dict):
        return {k: v for key, sub in t.items()
                for k, v in _shapes(sub, f"{pre}/{key}").items()}
    if isinstance(t, list):
        return {k: v for i, sub in enumerate(t)
                for k, v in _shapes(sub, f"{pre}/{i}").items()}
    return {pre: (tuple(t.shape), t.dtype)}


def test_params_from_jax_match_port_init():
    """The bridge carries the router and the (E, d, f) / (E, f, d) expert
    stacks of each layer (the reference's (repeats, E, d, f) leaves cut
    per layer, values unchanged); the port's own init draws the same tree
    at the policy's dtype."""
    jcfg, jparams, cfg, params = _weights()
    ours = _shapes(T.init_params(torch.Generator().manual_seed(0), cfg,
                                 P.BF16))
    assert {k: s for k, (s, _) in ours.items()} == {
        k: s for k, (s, _) in _shapes(params).items()}
    assert {d for _, d in ours.values()} == {torch.bfloat16}
    m = cfg.moe
    assert ours["/layers/1/ffn/wg"][0] == (m.num_experts, cfg.d_model,
                                           m.d_ff_expert)
    assert ours["/layers/1/ffn/wo"][0] == (m.num_experts, m.d_ff_expert,
                                           cfg.d_model)
    ref = np.asarray(jparams["stacks"][0][0]["ffn"]["wi"])
    for layer in range(cfg.num_layers):
        np.testing.assert_array_equal(
            params["layers"][layer]["ffn"]["wi"].numpy(), ref[layer])


# ---------------------------------------------------------------------------
# moe_apply against the reference's moe_apply_capacity
# ---------------------------------------------------------------------------


def _moe_params(cfg, jcfg):
    jp = JM.moe_init(jax.random.PRNGKey(3), jcfg)
    return jp, bridge._map(bridge._to_torch, jax.tree.map(np.asarray, jp))


def _dropped(cfg, p, x):
    """Assignments beyond an expert's capacity in ``moe_apply``'s routing
    of x (B, S, d)."""
    xf = x.reshape(-1, x.shape[-1])
    _, _, tope = M.route(cfg, p, xf)
    counts = torch.bincount(tope.reshape(-1), minlength=cfg.moe.num_experts)
    return int((counts - M._capacity(xf.shape[0], cfg)).clamp_min(0).sum())


def _moe_input(case, cfg, p):
    """x (B, S, d) for a case: tokens pulled towards expert 0's router
    column, so that at the reduced capacity factor 1.5 it overflows
    ("drops"); ``padding``: each row's last lanes one repeated vector (a
    right-padded batch's pad tokens), which compete for capacity in token
    order."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 24, cfg.d_model)).astype(np.float32)
    if case in ("drops", "padding", "bf16"):
        col = p["router"][:, 0].numpy()
        x += 2.0 * col / np.linalg.norm(col) * np.sqrt(cfg.d_model) / 4
    if case == "padding":
        x[:, 15:] = x[0, 0]
    return torch.from_numpy(x)


@pytest.mark.parametrize("case", ["drops", "raised", "padding", "bf16"])
def test_moe_apply_matches_reference(case):
    """Outputs within TOL (bf16: one ulp) and the load-balance loss
    within 1e-6 of the reference's; the same top-k experts chosen; at the
    reduced capacity factor 1.5 assignments are dropped, at the factor
    ``test_moe.py`` raises to (8) none."""
    factor = 8.0 if case == "raised" else None
    jcfg, cfg = JR.get_reduced(ARCH), R.get_reduced(ARCH)
    if factor is not None:
        jcfg, cfg = _raised(jcfg, factor), _raised(cfg, factor)
    jp, p = _moe_params(cfg, jcfg)
    x = _moe_input(case, cfg, p)
    dropped = _dropped(cfg, p, x)
    assert (dropped > 0) == (case != "raised")
    dt = torch.bfloat16 if case == "bf16" else torch.float32
    jdt = jnp.bfloat16 if case == "bf16" else jnp.float32
    jout, jaux = jax.jit(lambda p_, x_: JM.moe_apply_capacity(
        jcfg, p_, x_))(jax.tree.map(lambda a: a.astype(jdt), jp),
                       jnp.asarray(x.numpy()).astype(jdt))
    pd = {k: v.to(dt) for k, v in p.items()}
    out = M.moe_apply(cfg, pd, x.to(dt))[0]
    assert out.dtype == dt
    tol = 2e-2 if case == "bf16" else TOL
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    probs, _, tope = M.route(cfg, pd, x.to(dt).reshape(-1, cfg.d_model))
    _, jtope = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x.to(dt).float().numpy()).reshape(-1, cfg.d_model)
        @ jnp.asarray(pd["router"].float().numpy()), -1), cfg.moe.top_k)
    np.testing.assert_array_equal(tope.numpy(), np.asarray(jtope))
    np.testing.assert_allclose(float(M.load_balance_loss(cfg, probs, tope)),
                               float(jaux), rtol=1e-6, atol=1e-6)


def _oracle(cfg, p, x):
    """Dense per-token expert mixture (no capacity, no dispatch): the
    counterpart of ``tests/test_moe.py``'s oracle."""
    xf = x.reshape(-1, x.shape[-1])
    _, topw, tope = M.route(cfg, p, xf)
    outs = torch.stack([(torch.nn.functional.silu(xf @ p["wg"][e])
                         * (xf @ p["wi"][e])) @ p["wo"][e]
                        for e in range(cfg.moe.num_experts)], 1)
    w = torch.zeros(xf.shape[0], cfg.moe.num_experts).scatter_(1, tope,
                                                               topw)
    return torch.einsum("te,ted->td", w, outs).reshape(x.shape)


def test_moe_matches_dense_oracle():
    """With a generous capacity nothing drops, and the dispatch equals the
    per-token mixture (``tests/test_moe.py``'s tolerance)."""
    cfg = _raised(R.get_reduced(ARCH), 8.0)
    p = M.moe_init(torch.Generator().manual_seed(3), cfg)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)) * 0.3
    torch.testing.assert_close(M.moe_apply(cfg, p, x)[0], _oracle(cfg, p, x),
                               rtol=5e-4, atol=5e-4)


def test_moe_capacity_drops_and_aux():
    """A tight capacity drops assignments and stays finite; a collapsed
    router has a larger load-balance loss than a random one."""
    cfg = R.get_reduced(ARCH).replace(moe=MoEConfig(
        num_experts=4, top_k=2, d_ff_expert=64, capacity_factor=0.5))
    p = M.moe_init(torch.Generator().manual_seed(4), cfg)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 32, cfg.d_model)).astype(np.float32))
    assert _dropped(cfg, p, x) > 0
    assert torch.isfinite(M.moe_apply(cfg, p, x)[0]).all()
    # inputs of positive sum, so the collapsed router's column of 50s
    # sends every token to expert 0
    xf = x.reshape(-1, cfg.d_model).abs()
    probs, _, tope = M.route(cfg, p, xf)
    rand = M.load_balance_loss(cfg, probs, tope)
    p2 = dict(p, router=torch.zeros_like(p["router"]))
    p2["router"][:, 0] = 50.0
    probs, _, tope = M.route(cfg, p2, xf)
    assert float(M.load_balance_loss(cfg, probs, tope)) > float(rand)


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------


def test_forwards_match_reference():
    """``forward_train`` over 40 tokens; ``forward_prefill`` of rows of 40
    and 27 valid tokens (the padding lanes are routed as in the
    reference) into a dense cache at max_len 64; two ``forward_decode``
    steps.  Logits within TOL, the valid lanes of the prefill."""
    jcfg, jparams, cfg, params = _weights()
    rng = np.random.default_rng(7)
    toks = rng.integers(4, 400, size=(2, 40)).astype(np.int32)
    lens = np.asarray([40, 27], np.int32)
    steps = rng.integers(4, 400, size=(2, 2)).astype(np.int32)

    @jax.jit
    def jrun(p, t, n, st):
        tl, _ = JT.forward_train(p, jcfg, t, policy=JP.FP32)
        c = JT.init_cache(jcfg, 2, 64, jnp.float32)
        lp, c = JT.forward_prefill(p, jcfg, t, n, c, policy=JP.FP32,
                                   max_len=64)
        outs = []
        for i in range(2):
            ld, c = JT.forward_decode(p, jcfg, st[:, i:i + 1], c, n + i,
                                      policy=JP.FP32, max_len=64)
            outs.append(ld)
        return tl, lp, outs
    jtl, jlp, jld = jrun(jparams, jnp.asarray(toks), jnp.asarray(lens),
                         jnp.asarray(steps))
    t_toks, t_lens = torch.from_numpy(toks), torch.from_numpy(lens)
    cache = T.init_cache(cfg, 2, 64, torch.float32)
    with torch.no_grad():
        tl = T.forward_train(params, cfg, t_toks)[0]
        lp, _ = T.forward_prefill(params, cfg, t_toks, t_lens, cache,
                                  max_len=64)
        ld = [T.forward_decode(params, cfg, torch.from_numpy(
            steps[:, i:i + 1]), cache, t_lens + i, max_len=64)[0]
            for i in range(2)]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jtl), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lp.numpy()[1, :27], np.asarray(jlp)[1, :27],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lp.numpy()[0], np.asarray(jlp)[0], rtol=TOL,
                               atol=TOL)
    for a, b in zip(ld, jld):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


# ---------------------------------------------------------------------------
# serve_continuous (bucketed at exact lengths) and the dense path
# ---------------------------------------------------------------------------


# two equal lengths in a row: admitted as one batched prefill
LENS = (5, 11, 11, 20, 7)


def _prompts(lens=LENS, seed=5, repeat=False):
    """Prompts of ``lens`` tokens; with ``repeat`` each is one token
    repeated, so that its tokens route alike: the 20-token one then
    overflows its experts' capacity of 16 at the factor 1.5."""
    rng = np.random.default_rng(seed)
    if repeat:
        return [[2] + [int(rng.integers(4, 400))] * (n - 1) for n in lens]
    return [[2] + [int(t) for t in rng.integers(4, 400, size=n - 1)]
            for n in lens]


class _Pair:
    """One reference engine and one port engine on the same weights."""

    def __init__(self, factor=None, kv_dtype="auto", weights_dtype="auto"):
        jcfg, jparams, self.cfg, self.params = _weights(factor)
        kw = dict(kv_dtype=kv_dtype, weights_dtype=weights_dtype)
        self.jeng = JEngine(jcfg, jparams, policy=dataclasses.replace(
            JP.FP32, **kw), **ENGINE)
        self.eng = InferenceEngine(self.cfg, self.params,
                                   policy=dataclasses.replace(P.FP32, **kw),
                                   device="cpu", **ENGINE)

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
                    [req(uid=i, tokens=list(p), max_new_tokens=6)
                     for i, p in enumerate(prompts)], page_size=PAGE,
                    spec=sc(k=3) if spec else None, **kw)
            out.append(({r.uid: r.result for r in done}, m,
                        [str(w.message) for w in caught
                         if issubclass(w.category, UserWarning)]))
        return out


@pytest.fixture(scope="module")
def pairs():
    made = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in made:
            made[key] = _Pair(**kw)
        return made[key]
    return get


def _assert_same(ref, ours):
    (r, jm, jw), (o, m, w) = ref, ours
    assert o == r
    for k in COUNTERS:
        assert getattr(m, k) == getattr(jm, k), k
    assert w == jw
    assert m.scheduler == jm.scheduler == "bucketed"
    return m


@pytest.mark.parametrize("mode", ["own capacity", "raised capacity",
                                  "int8"])
def test_serve_matches_reference(pairs, mode, monkeypatch):
    """Bucketed admission at exact prompt lengths (the default for a
    capacity-routed model: no warning), 3 slots, the two 11-token prompts
    admitted as one batched prefill.  At the config's own capacity factor
    (1.5) prompts of one repeated token overflow an expert and drop
    assignments; at the reference's raised factor (E,
    ``tests/test_continuous.py``) ordinary prompts; int8 is int8 KV + int8
    weights in both packages.  Streams and counters exactly equal."""
    kw = {"raised capacity": dict(factor=4.0), "int8": INT8}.get(mode, {})
    pair = pairs(**kw)
    drops, shapes = [], []
    apply = M.moe_apply

    def spy(cfg, p, x):
        drops.append(_dropped(cfg, p, x))
        shapes.append(tuple(x.shape[:2]))
        return apply(cfg, p, x)
    monkeypatch.setattr(M, "moe_apply", spy)
    m = _assert_same(*pair.serve(_prompts(repeat=mode == "own capacity")))
    assert m.outcome_counts == {"completed": len(LENS)}
    assert m.prefill_padded == m.prefill_tokens     # exact lengths
    assert (2, 11) in shapes
    if mode != "int8":
        assert (max(drops) > 0) == (mode == "own capacity")


def test_serve_warns_off_options_as_reference(pairs):
    """Asked for speculation, prefix sharing, chunked prefill, packing and
    preemption, qwen3-moe warns for each in the reference's words and
    order (capacity-routed experts drop tokens by batch composition) and
    serves bucketed with the plain serve's streams."""
    pair = pairs()
    prompts = _prompts(seed=8)
    ref, ours = pair.serve(prompts, spec=True, prefix_cache=True,
                           chunked_prefill=True, packed=True,
                           preemption="lru")
    m = _assert_same(ref, ours)
    assert len(ours[2]) == 5
    assert all("MoE" in w or "chunked scheduler" in w for w in ours[2])
    assert m.spec_mode == "off" and m.prefix_hits == 0
    (_, _, _), (plain, _, _) = pair.serve(prompts)
    assert ours[0] == plain


def test_set_prefix_warns_noop_as_reference(pairs):
    pair = pairs()
    for eng in (pair.jeng, pair.eng):
        with pytest.warns(UserWarning, match="capacity-routed MoE"):
            eng.set_prefix([2, 5, 6, 7, 8, 9, 10, 11, 12], page_size=PAGE)


@pytest.mark.parametrize("use_kv_cache", [True, False])
def test_generate_batch_matches_reference(use_kv_cache):
    """Rows of 30, 17 and 5 tokens x 5 new at max_len 64 (the padding
    lanes are routed as in the reference), with and without the KV
    cache: greedy ids equal."""
    jcfg, jparams, cfg, params = _weights()
    kw = dict(ENGINE, use_kv_cache=use_kv_cache)
    rng = np.random.default_rng(4)
    toks = rng.integers(4, 400, size=(3, 30)).astype(np.int32)
    lens = np.asarray([30, 17, 5], np.int32)
    ref = JEngine(jcfg, jparams, policy=JP.FP32, **kw).generate_batch(
        toks.copy(), lens.copy(), 5)
    ours = InferenceEngine(cfg, params, policy=P.FP32, device="cpu",
                           **kw).generate_batch(toks.copy(), lens.copy(), 5)
    np.testing.assert_array_equal(ours, ref)
    assert (ours >= 0).sum() > 0


@pytest.mark.parametrize("mode", ["int8", "bf16", "auto"])
def test_compress_weights_matches_reference(mode):
    """int8 quantizes the attention projections and the untied head and
    leaves the router and the expert stacks alone: byte counts and
    record counts equal the reference's."""
    jcfg, jparams, cfg, params = _weights()
    jnew, jstats = JP.compress_weights(
        jparams, dataclasses.replace(JP.FP32, weights_dtype=mode))
    new, stats = P.compress_weights(
        params, dataclasses.replace(P.FP32, weights_dtype=mode))
    for k in ("weights_dtype", "weight_bytes", "weight_bytes_dense",
              "weight_bytes_saved"):
        assert stats[k] == jstats[k], k
    # the port counts a record per layer and weight, the reference one per
    # weight of its stacked (repeats, ...) layer tree: 4 attention
    # projections a layer, plus the head
    assert stats["n_quantized"] == (0 if mode == "auto"
                                    else 4 * cfg.num_layers + 1)
    assert jstats["n_quantized"] == (0 if mode == "auto" else 4 + 1)
    for layer in new["layers"]:
        for k in ("router", "wi", "wg", "wo"):
            assert isinstance(layer["ffn"][k], torch.Tensor)
            assert layer["ffn"][k].dtype == torch.float32
