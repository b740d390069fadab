"""deepseek-v3-671b on the port, against the reference package.

The reduced config (1 dense + 1 MoE layer, MLA with a latent of 32 and
rope / nope / v head dims 16 / 32 / 32, 4 sigmoid-routed experts, top-2,
one shared expert, the MTP module) in fp32 (the kernels' plain
versions), the same parameters in both packages
(``bridge.params_from_jax``).  The MLA functions, the sigmoid + shared
MoE (at the config's capacity factor 1.5, where assignments drop, and
raised) and the MTP head against the reference's, then the model, its
capacity factor raised to E as the reference's ``test_continuous.py``
raises it, through every serving path of the reference that admits
it.

Tolerances: the MLA and MoE functions 1e-5 at fp32 (XLA and PyTorch sum
in other orders, ~1e-6 at these widths); the model's logits 2e-5 (two
such layers and an untied head: up to 1.1e-5 seen); greedy streams,
warnings and counters exactly.  The int8 serve is held against the
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
from repro.core import precision as JP
from repro.core.engine import InferenceEngine as JEngine
from repro.core.scheduler import Request as JRequest
from repro.core.speculative import SpecConfig as JSpecConfig
from repro.models import attention_mla as JMLA
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.core import kv_cache as KV
from repro_torch.core import precision as P
from repro_torch.core.precision import map_params
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.scheduler import Request
from repro_torch.core.speculative import SpecConfig
from repro_torch.models import attention_mla as MLA
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

ARCH = "deepseek-v3-671b"
ENGINE = dict(max_len=64, max_batch=3)
PAGE = 8
TOL = 1e-5
LOGITS_TOL = 2e-5
COUNTERS = ("admitted", "retired", "prefill_tokens", "prefill_padded",
            "prefix_hits", "host_syncs", "steps", "mixed_iters",
            "generated_tokens", "peak_pages_in_use", "preemptions")
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
def _weights():
    """Both packages' reduced configs, the capacity factor raised to E
    (no assignment drops: a serve's streams then do not depend on how the
    requests are batched), and parameters (the reference's init compiled
    whole)."""
    jcfg, cfg = (_raised(c, float(c.moe.num_experts))
                 for c in (JR.get_reduced(ARCH), R.get_reduced(ARCH)))
    jparams = jax.jit(lambda key: JT.init_params(key, jcfg, JP.FP32))(
        jax.random.PRNGKey(0))
    return (jcfg, jparams, cfg,
            bridge.params_from_jax(jax.tree.map(np.asarray, jparams)))


def _close(ours, ref, tol=TOL):
    np.testing.assert_allclose(ours.detach().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["get_config", "get_reduced"])
def test_config_matches_reference(which):
    """Every field equals the reference's, the MLA and MoE blocks field by
    field, ``mtp`` set; the registry lists the arch and
    ``check_supported`` admits it."""
    ours, ref = getattr(R, which)(ARCH), getattr(JR, which)(ARCH)
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if f.name == "stacks":
            assert [([(s.mixer, s.ffn, s.window) for s in st.pattern],
                     st.repeats) for st in a] == [
                ([(s.mixer, s.ffn, s.window) for s in st.pattern],
                 st.repeats) for st in b]
        elif f.name in ("mla", "moe"):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    assert ref.ssm is None and ours.mtp
    assert ARCH in R.list_archs()
    T.check_supported(ours)


def _shapes(t, pre=""):
    if isinstance(t, dict):
        return {k: v for key, sub in t.items()
                for k, v in _shapes(sub, f"{pre}/{key}").items()}
    if isinstance(t, list):
        return {k: v for i, sub in enumerate(t)
                for k, v in _shapes(sub, f"{pre}/{i}").items()}
    return {pre: (tuple(t.shape), t.dtype)}


def test_params_from_jax_match_port_init():
    """The bridge carries the MLA factors, the shared expert and the MTP
    module (not stacked in the reference); the port's own init draws the
    same tree at the policy's dtype, the expert stacks sliced or not."""
    *_, cfg, params = _weights()
    ours = _shapes(T.init_params(torch.Generator().manual_seed(0), cfg,
                                 P.BF16))
    assert {k: s for k, (s, _) in ours.items()} == {
        k: s for k, (s, _) in _shapes(params).items()}
    assert {d for _, d in ours.values()} == {torch.bfloat16}
    assert "/mtp/layer/attn/wq" in ours and "/layers/1/ffn/shared/wi" in ours
    # a stack drawn in expert slices keeps the scale and the dtype
    small = dataclasses.replace(cfg.moe, num_experts=5)
    old = M.EXPERT_SLICE_BYTES
    try:
        M.EXPERT_SLICE_BYTES = 2 * cfg.d_model * small.d_ff_expert * 4
        p = M.moe_init(torch.Generator().manual_seed(1),
                       cfg.replace(moe=small), torch.bfloat16)
    finally:
        M.EXPERT_SLICE_BYTES = old
    assert p["wi"].shape == (5, cfg.d_model, small.d_ff_expert)
    assert p["wi"].dtype == torch.bfloat16
    std = p["wi"].float().std(dim=(1, 2)) * cfg.d_model ** 0.5
    assert ((std > 0.9) & (std < 1.1)).all()


# ---------------------------------------------------------------------------
# MLA, the sigmoid + shared MoE and the MTP head against the reference's
# ---------------------------------------------------------------------------


def _mla_case():
    jcfg, jparams, cfg, params = _weights()
    jp = jax.tree.map(lambda a: a[0], jparams["stacks"][0][0]["attn"])
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    return jcfg, jp, cfg, params["layers"][0]["attn"], x


def test_mla_full_matches_reference():
    """The naive form over 12 tokens: output and the latents to cache."""
    jcfg, jp, cfg, p, x = _mla_case()
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    jout, jnew = jax.jit(lambda p_, x_: JMLA.mla_full(
        jcfg, p_, x_, pos, pos))(jp, jnp.asarray(x))
    tp = torch.from_numpy(pos.copy())
    out, new = MLA.mla_full(cfg, p, torch.from_numpy(x), tp, tp)
    _close(out, jout)
    for k in ("ckv", "kr"):
        _close(new[k], jnew[k])


def test_mla_prefill_cached_and_decode_match_reference():
    """A latent cache (max_len 32) filled with the first 8 tokens
    (``mla_full`` + ``write_prefill``; row 1 holds 5), a resumed prefill
    of 3 more tokens attending it (``mla_prefill_cached``), then one
    absorbed ``mla_decode`` step: outputs and caches within TOL."""
    jcfg, jp, cfg, p, x = _mla_case()
    spec = cfg.stacks[0].pattern[0]
    lens = np.asarray([8, 5], np.int32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    cpos = np.where(pos < lens[:, None], pos, -1).astype(np.int32)
    rpos = (lens[:, None] + np.arange(3, dtype=np.int32)).astype(np.int32)

    pos, cpos, rpos = map(jnp.asarray, (pos, cpos, rpos))
    jlens = jnp.asarray(lens)

    @jax.jit
    def jrun(p_, x_):
        jc = JKV.layer_cache_shape(jcfg, spec, 2, 32, jnp.float32)
        _, jnew = JMLA.mla_full(jcfg, p_, x_[:, :8], pos, pos)
        jc = JKV.write_prefill(jc, jnew, cpos)
        jout, jc = JMLA.mla_prefill_cached(jcfg, p_, x_[:, 8:11], jc, rpos,
                                           rpos)
        jdec, jc = JMLA.mla_decode(jcfg, p_, x_[:, 11:], jc, jlens + 3)
        return jout, jdec, jc
    jout, jdec, jc = jrun(jp, jnp.asarray(x))
    c = KV.layer_cache_shape(cfg, spec, 2, 32, torch.float32)
    tp = torch.from_numpy(np.array(pos))
    _, new = MLA.mla_full(cfg, p, torch.from_numpy(x[:, :8]), tp, tp)
    KV.write_prefill(c, new, torch.from_numpy(np.array(cpos)))
    out = MLA.mla_prefill_cached(cfg, p, torch.from_numpy(x[:, 8:11]), c,
                                 torch.from_numpy(np.array(rpos)),
                                 torch.from_numpy(np.array(rpos)))
    dec = MLA.mla_decode(cfg, p, torch.from_numpy(x[:, 11:]), c,
                         torch.from_numpy(lens + 3))
    _close(out, jout)
    _close(dec, jdec)
    for k in ("ckv", "kr", "pos"):
        _close(c[k].float(), jc[k])


@pytest.mark.parametrize("activations", ["fp32", "bf16"])
def test_mla_decode_follows_reference_default_precision(monkeypatch,
                                                        activations):
    """A bf16 latent cache (8 tokens; row 1 holds 5) and one absorbed
    ``mla_decode`` step against the reference's default precision
    (``REPRO_PERF_OPTS`` unset: ``attn_bf16`` on), which attends at the
    cache's dtype with fp32 accumulation, rounding the absorbed query, the
    rotated query and the probabilities to bf16 first.  With fp32
    activations and parameters the two agree to TOL; with bf16 ones
    (outputs rounded to bf16) at most 2% of the outputs may differ, by
    one bf16 unit at most (the same fp32 sums rounded; none differ here).
    Attending over an fp32 copy of the cache misses both (3.6e-3, and 271
    of the 512 bf16 outputs)."""
    monkeypatch.delenv("REPRO_PERF_OPTS", raising=False)
    jcfg, jp, cfg, p, x = _mla_case()
    spec = cfg.stacks[0].pattern[0]
    if activations == "bf16":
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        p = map_params(lambda t: t.to(torch.bfloat16), p)
    jdt, tdt = ((jnp.float32, torch.float32) if activations == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    lens = np.asarray([8, 5], np.int32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    cpos = np.where(pos < lens[:, None], pos, -1).astype(np.int32)

    @jax.jit
    def jrun(p_, x_):
        jc = JKV.layer_cache_shape(jcfg, spec, 2, 32, jnp.bfloat16)
        _, jnew = JMLA.mla_full(jcfg, p_, x_[:, :8], jnp.asarray(pos),
                                jnp.asarray(pos))
        jc = JKV.write_prefill(jc, jnew, jnp.asarray(cpos))
        return JMLA.mla_decode(jcfg, p_, x_[:, 8:9], jc, jnp.asarray(lens))
    jdec, jc = jrun(jp, jnp.asarray(x).astype(jdt))
    c = KV.layer_cache_shape(cfg, spec, 2, 32, torch.bfloat16)
    tx = torch.from_numpy(x).to(tdt)
    tp = torch.from_numpy(np.array(pos))
    _, new = MLA.mla_full(cfg, p, tx[:, :8], tp, tp)
    KV.write_prefill(c, new, torch.from_numpy(cpos))
    dec = MLA.mla_decode(cfg, p, tx[:, 8:9], c, torch.from_numpy(lens))
    assert dec.dtype == tdt and c["ckv"].dtype == torch.bfloat16
    for k in ("ckv", "kr"):
        _close(c[k].float(), jnp.asarray(jc[k], jnp.float32))
    ref = np.asarray(jdec, np.float32)
    if activations == "fp32":
        _close(dec, ref)
    else:
        got = dec.float().numpy()
        ulp = np.spacing(np.abs(ref).astype(np.float32)) * 2 ** 16
        assert (np.abs(got - ref) <= ulp).all()
        assert (got != ref).mean() <= 0.02


def _moe_input(cfg, p):
    """x (4, 24, d) pulled towards expert 0's router column: at the
    reduced capacity factor 1.5 it overflows ("drops")."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 24, cfg.d_model)).astype(np.float32)
    col = p["router"][:, 0].numpy()
    x += 2.0 * col / np.linalg.norm(col) * np.sqrt(cfg.d_model) / 4
    return torch.from_numpy(x)


@pytest.mark.parametrize("factor", [None, 4.0])
def test_sigmoid_shared_moe_matches_reference(factor):
    """``moe_apply`` with sigmoid routing and the shared expert against
    ``moe_apply_capacity(..., "sigmoid")``: outputs within TOL, the same
    top-k experts, the load-balance loss within 1e-6; at the config's
    factor 1.5 assignments drop, at the raised factor (E) none."""
    jcfg, cfg = JR.get_reduced(ARCH), R.get_reduced(ARCH)
    if factor is not None:
        jcfg, cfg = _raised(jcfg, factor), _raised(cfg, factor)
    jp = JM.moe_init(jax.random.PRNGKey(3), jcfg)
    p = bridge._map(bridge._to_torch, jax.tree.map(np.asarray, jp))
    assert "shared" in p and M.router_kind_of(cfg) == "sigmoid"
    x = _moe_input(cfg, p)
    xf = x.reshape(-1, cfg.d_model)
    probs, _, tope = M.route(cfg, p, xf)
    counts = torch.bincount(tope.reshape(-1), minlength=4)
    dropped = int((counts - M._capacity(xf.shape[0], cfg)).clamp_min(0)
                  .sum())
    assert (dropped > 0) == (factor is None)
    jout, jaux = jax.jit(lambda p_, x_: JM.moe_apply_capacity(
        jcfg, p_, x_, "sigmoid"))(jp, jnp.asarray(x.numpy()))
    _close(M.moe_apply(cfg, p, x)[0], jout)
    jscores = jax.nn.sigmoid(jnp.asarray(xf.numpy())
                             @ jnp.asarray(p["router"].numpy()))
    np.testing.assert_array_equal(tope.numpy(), np.asarray(
        jax.lax.top_k(jscores, cfg.moe.top_k)[1]))
    np.testing.assert_allclose(float(M.load_balance_loss(cfg, probs, tope)),
                               float(jaux), rtol=1e-6, atol=1e-6)


def test_forward_mtp_matches_reference():
    """``forward_mtp`` over 24 tokens: the trunk's logits and the MTP
    head's equal the reference's ``forward_train`` logits and
    ``aux["mtp_logits"]``."""
    jcfg, jparams, cfg, params = _weights()
    toks = np.random.default_rng(9).integers(4, 400, size=(2, 24)).astype(
        np.int32)
    jl, aux = jax.jit(lambda p, t: JT.forward_train(
        p, jcfg, t, policy=JP.FP32, remat=False))(jparams, jnp.asarray(toks))
    with torch.no_grad():
        logits, mtp = T.forward_mtp(params, cfg, torch.from_numpy(toks))
    assert mtp.shape == (2, 23, cfg.vocab_size)
    _close(logits, jl, LOGITS_TOL)
    _close(mtp, aux["mtp_logits"], LOGITS_TOL)
    with pytest.raises(ValueError, match="multi-token"):
        T.forward_mtp({k: v for k, v in params.items() if k != "mtp"}, cfg,
                      torch.from_numpy(toks))


def test_forwards_match_reference():
    """``forward_prefill`` of rows of 30 and 17 valid tokens (the padding
    lanes are routed as in the reference) into a dense latent cache at
    max_len 64, then three absorbed ``forward_decode`` steps: logits
    within LOGITS_TOL, the valid lanes of the prefill."""
    jcfg, jparams, cfg, params = _weights()
    rng = np.random.default_rng(7)
    toks = rng.integers(4, 400, size=(2, 30)).astype(np.int32)
    lens = np.asarray([30, 17], np.int32)
    steps = rng.integers(4, 400, size=(2, 3)).astype(np.int32)

    @jax.jit
    def jprefill(p, t, n):
        c = JT.init_cache(jcfg, 2, 64, jnp.float32)
        return JT.forward_prefill(p, jcfg, t, n, c, policy=JP.FP32,
                                  max_len=64)

    # one decode step compiled once (an unrolled loop compiles each step)
    jdecode = jax.jit(lambda p, s, c, n: JT.forward_decode(
        p, jcfg, s, c, n, policy=JP.FP32, max_len=64))
    jlp, c = jprefill(jparams, jnp.asarray(toks), jnp.asarray(lens))
    jld = []
    for i in range(3):
        ld, c = jdecode(jparams, jnp.asarray(steps[:, i:i + 1]), c,
                        jnp.asarray(lens + i))
        jld.append(ld)
    t_lens = torch.from_numpy(lens)
    cache = T.init_cache(cfg, 2, 64, torch.float32)
    assert set(cache["layers"][0]) == {"ckv", "kr", "pos"}
    with torch.no_grad():
        lp, _ = T.forward_prefill(params, cfg, torch.from_numpy(toks),
                                  t_lens, cache, max_len=64)
        ld = [T.forward_decode(params, cfg, torch.from_numpy(
            steps[:, i:i + 1]), cache, t_lens + i, max_len=64)[0]
            for i in range(3)]
    _close(lp[0], jlp[0], LOGITS_TOL)
    _close(lp[1, :17], jlp[1, :17], LOGITS_TOL)
    for a, b in zip(ld, jld):
        _close(a, b, LOGITS_TOL)


# ---------------------------------------------------------------------------
# Slot views, serve_continuous (bucketed at exact lengths), the dense path
# ---------------------------------------------------------------------------


def test_slot_view_gives_empty_latent_rows():
    """A fresh slot view of the paged model cache: MLA latent rows are
    zeros with every position -1 (no phantom key at position 0), as the
    reference's ``slot_view``; ``slot_merge`` writes them back into the
    admitted slots only."""
    cfg = R.get_reduced(ARCH)
    cache = T.init_paged_cache(cfg, num_pages=4, page_size=8,
                               dtype=torch.float32, max_slots=3, max_len=64)
    for c in cache["layers"]:
        c["pos"].fill_(5)
        c["ckv"].fill_(1.0)
    view = KV.slot_view(cache, 2)
    for c in view["layers"]:
        assert c["pos"].shape == (2, 65) and (c["pos"] == -1).all()
        assert (c["ckv"] == 0).all() and (c["kr"] == 0).all()
    KV.slot_merge(cache, view, torch.tensor([2, 0]))
    for c in cache["layers"]:
        assert (c["pos"][[0, 2]] == -1).all() and (c["pos"][1] == 5).all()
    with pytest.raises(ValueError, match="max_len"):
        T.init_paged_cache(cfg, num_pages=4, page_size=8, max_slots=3)


def _prompts(lens, seed=5):
    rng = np.random.default_rng(seed)
    return [[2] + [int(t) for t in rng.integers(4, 400, size=n - 1)]
            for n in lens]


class _Pair:
    """One reference engine and one port engine on the same weights."""

    def __init__(self, kv_dtype="auto", weights_dtype="auto"):
        jcfg, jparams, self.cfg, self.params = _weights()
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
                    [req(uid=i, tokens=list(p), max_new_tokens=5)
                     for i, p in enumerate(prompts)], page_size=PAGE,
                    steps_per_sync=2, spec=sc(k=3) if spec else None, **kw)
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


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_serve_matches_reference(pairs, mode):
    """Bucketed admission at exact lengths, 3 slots: three 7-token
    prompts admitted as one batched prefill (the reference's
    ``test_continuous_batched_admission_equal_lengths``: each row's MLA
    latents must land in its own slot), then 12.  In fp32 every stream
    also equals the port's single-request ``generate_batch`` (the
    reference's contract); int8 is int8 KV (warned: no pure attention
    layer) + int8 weights in both packages.  Streams, counters and
    warnings exactly equal."""
    pair = pairs(**(INT8 if mode == "int8" else {}))
    prompts = _prompts((7, 7, 7, 12))
    ref, ours = pair.serve(prompts)
    m = _assert_same(ref, ours)
    assert m.outcome_counts == {"completed": len(prompts)}
    assert m.prefill_padded == m.prefill_tokens     # exact lengths
    assert ours[2] == ([] if mode != "int8" else [
        "kv_dtype=int8 requested but no attention layer has a paged pool "
        "to quantize; state stays at full precision"])
    if mode == "fp32":
        for uid, p in enumerate(prompts):
            row = pair.eng.generate_batch(np.asarray([p], np.int32),
                                          np.asarray([len(p)], np.int32),
                                          5)[0]
            assert ours[0][uid] == [int(t) for t in row[row >= 0]]


def test_serve_warns_off_options_as_reference(pairs):
    """Asked for speculation, prefix sharing, chunked prefill, packing and
    preemption, deepseek warns for each in the reference's words and
    order (MLA keeps dense latent state) and serves bucketed with the
    plain serve's streams; ``set_prefix`` warns and does nothing."""
    pair = pairs()
    prompts = _prompts((7, 7, 7, 12), seed=8)
    ref, ours = pair.serve(prompts, spec=True, prefix_cache=True,
                           chunked_prefill=True, packed=True,
                           preemption="lru")
    _assert_same(ref, ours)
    assert len(ours[2]) == 5
    assert all("'mla'" in w or "chunked scheduler" in w for w in ours[2])
    (_, _, _), (plain, _, _) = pair.serve(prompts)
    assert ours[0] == plain
    for eng in (pair.jeng, pair.eng):
        with pytest.warns(UserWarning, match="layer family 'mla'"):
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


def test_compress_weights_matches_reference():
    """int8 quantizes the dense FFN, the shared expert, the MTP layer and
    the untied head, never the MLA factors, the router or the expert
    stacks: byte counts equal the reference's."""
    jcfg, jparams, cfg, params = _weights()
    policy = dataclasses.replace(P.FP32, weights_dtype="int8")
    _, jstats = JP.compress_weights(
        jparams, dataclasses.replace(JP.FP32, weights_dtype="int8"))
    new, stats = P.compress_weights(params, policy)
    for k in ("weight_bytes", "weight_bytes_dense", "weight_bytes_saved"):
        assert stats[k] == jstats[k], k
    # 3 FFN records a layer (dense or shared), the MTP layer's 4 + 3, head
    assert stats["n_quantized"] == 3 * cfg.num_layers + 7 + 1
    moe = new["layers"][1]["ffn"]
    assert isinstance(moe["shared"]["wi"], dict)
    assert all(isinstance(moe[k], torch.Tensor)
               for k in ("router", "wi", "wg", "wo"))
    assert all(isinstance(v, torch.Tensor) or k.endswith("norm")
               for k, v in new["layers"][0]["attn"].items())
