"""hymba-1.5b on the port, against the reference package.

The reduced config (2 hybrid layers: one global, one windowed at 64; 5 /
1 x 32 heads; a Mamba branch of 5 heads, state 8) in fp32 (the kernels'
plain versions), the same parameters in both packages
(``bridge.params_from_jax``).  The Mamba functions against the
reference's, then the model through its forwards over rings that wrap and
through every serving path of the reference that admits it.

Tolerances: the Mamba functions and logits 1e-5 at fp32 (XLA and PyTorch
sum in other orders, ~1e-6 at these widths); greedy streams, warnings and
counters exactly.  The int8 serve is held against the reference's int8
path, not against fp32.
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
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.core import kv_cache as KV
from repro_torch.core import precision as P
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.scheduler import Request
from repro_torch.core.speculative import SpecConfig
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

ARCH = "hymba-1.5b"
ENGINE = dict(max_len=128, max_batch=3)
PAGE = 8
TOL = 1e-5
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


@functools.lru_cache(maxsize=None)
def _weights():
    """Both packages' reduced configs and parameters (the reference's
    init compiled whole)."""
    jcfg, cfg = JR.get_reduced(ARCH), R.get_reduced(ARCH)
    jparams = jax.jit(lambda key: JT.init_params(key, jcfg, JP.FP32))(
        jax.random.PRNGKey(0))
    return (jcfg, jparams, cfg,
            bridge.params_from_jax(jax.tree.map(np.asarray, jparams)))


def _np(t):
    return np.asarray(t, np.float32)


def _close(ours, ref, tol=TOL):
    np.testing.assert_allclose(ours.detach().numpy(), _np(ref), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["get_config", "get_reduced"])
def test_config_matches_reference(which):
    """Every field equals the reference's, the SSM block field by field;
    the registry lists the arch and ``check_supported`` admits it."""
    ours, ref = getattr(R, which)(ARCH), getattr(JR, which)(ARCH)
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if f.name == "stacks":
            assert [([(s.mixer, s.ffn, s.window) for s in st.pattern],
                     st.repeats) for st in a] == [
                ([(s.mixer, s.ffn, s.window) for s in st.pattern],
                 st.repeats) for st in b]
        elif f.name == "ssm":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    assert (ref.moe, ref.mla, ref.mtp) == (None, None, False)
    assert ARCH in R.list_archs()
    T.check_supported(ours)


def _shapes(t, pre=""):
    if isinstance(t, dict):
        return {k: v for key, sub in t.items()
                for k, v in _shapes(sub, f"{pre}/{key}").items()}
    if isinstance(t, list):
        return {k: v for i, sub in enumerate(t)
                for k, v in _shapes(sub, f"{pre}/{i}").items()}
    return {pre: tuple(t.shape)}


def test_params_from_jax_match_port_init():
    """The bridge carries each layer's attention, Mamba dict and branch
    norms; the port's own init draws the same tree, at the policy's
    dtype, with the reference's constant leaves (a_log, dt_bias,
    skip_d)."""
    *_, cfg, params = _weights()
    ours = T.init_params(torch.Generator().manual_seed(0), cfg, P.BF16)
    assert _shapes(ours) == _shapes(params)
    assert {t.dtype for t in _leaves(ours)} == {torch.bfloat16}
    for key in ("a_log", "dt_bias", "skip_d"):
        torch.testing.assert_close(ours["layers"][1]["mamba"][key].float(),
                                   params["layers"][1]["mamba"][key].to(
                                       torch.bfloat16).float())


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    elif isinstance(t, list):
        for v in t:
            yield from _leaves(v)
    else:
        yield t


# ---------------------------------------------------------------------------
# The Mamba branch against the reference's
# ---------------------------------------------------------------------------


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(1)
    x, w, st = (rng.normal(size=s).astype(np.float32)
                for s in ((2, 9, 24), (4, 24), (2, 3, 24)))
    jout, jst = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(st))
    out, new = S._causal_conv(*map(torch.from_numpy, (x, w, st)))
    _close(out, jout)
    _close(new, jst)


@pytest.mark.parametrize("S_", [200, 1])
def test_mamba_chunked_matches_reference(S_):
    """S = 200: two chunks of 128, the second padded with 56 no-op steps,
    from a nonzero state; S = 1: one step through the chunked form."""
    rng = np.random.default_rng(2)
    B, H, dh, N = 2, 3, 8, 4
    xh = rng.normal(size=(B, S_, H, dh)).astype(np.float32)
    Bt, Ct = (rng.normal(size=(B, S_, N)).astype(np.float32)
              for _ in range(2))
    dt = rng.uniform(0.01, 0.5, size=(B, S_, H)).astype(np.float32)
    logdec = dt * -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    h0 = rng.normal(size=(B, H, dh, N)).astype(np.float32) * 0.3
    args = (xh, Bt, Ct, dt, logdec, h0)
    jy, jh = JS._mamba_chunked(*map(jnp.asarray, args))
    y, h = S._mamba_chunked(*map(torch.from_numpy, args))
    assert y.shape == (B, S_, H, dh)
    _close(y, jy)
    _close(h, jh)


def test_mamba_apply_prefill_then_decode_matches_reference():
    """``mamba_apply`` of the reduced layer: a 150-token prefill (two
    chunks) from zero state, then 3 decode steps, outputs, SSM and conv
    states within TOL of the reference's."""
    jcfg, jparams, cfg, params = _weights()
    jp = jparams["stacks"][1][0]["mamba"]
    jp = jax.tree.map(lambda a: a[0], jp)
    p = params["layers"][1]["mamba"]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 153, cfg.d_model)).astype(np.float32)
    jst, jconv = JS.mamba_zero_state(jcfg, 2)
    st, conv = S.mamba_zero_state(cfg, 2)
    xs = [(0, 150, "prefill")] + [(150 + i, 151 + i, "decode")
                                   for i in range(3)]
    japply = {mode: jax.jit(functools.partial(JS.mamba_apply, jcfg,
                                              mode=mode))
              for mode in ("prefill", "decode")}
    for a, b, mode in xs:
        jy, jst, jconv = japply[mode](jp, jnp.asarray(x[:, a:b]), jst,
                                      jconv)
        y, st, conv = S.mamba_apply(cfg, p, torch.from_numpy(x[:, a:b]),
                                    st, conv, mode)
        _close(y, jy)
        _close(st, jst)
        _close(conv, jconv)


# ---------------------------------------------------------------------------
# Forwards over rings that wrap
# ---------------------------------------------------------------------------


def test_hybrid_forwards_match_reference_past_the_window():
    """``forward_train`` over 100 tokens; ``forward_prefill`` of rows of
    90 and 70 valid tokens into a dense cache at max_len 128 (the windowed
    layer's ring of 64 + 1 entries wraps); 4 ``forward_decode`` steps.
    Logits within TOL (the prefill's valid lanes); the prefilled SSM
    states too."""
    jcfg, jparams, cfg, params = _weights()
    rng = np.random.default_rng(7)
    toks = rng.integers(4, 400, size=(2, 100)).astype(np.int32)
    lens = np.asarray([90, 70], np.int32)
    steps = rng.integers(4, 400, size=(2, 4)).astype(np.int32)

    @jax.jit
    def jprefill(p, t, n):
        tl, _ = JT.forward_train(p, jcfg, t, policy=JP.FP32, remat=False)
        c = JT.init_cache(jcfg, 2, 128, jnp.float32)
        lp, c = JT.forward_prefill(p, jcfg, t[:, :90], n, c,
                                   policy=JP.FP32, max_len=128)
        return tl, lp, c

    # one decode step compiled once (an unrolled loop compiles each step)
    jdecode = jax.jit(lambda p, s, c, n: JT.forward_decode(
        p, jcfg, s, c, n, policy=JP.FP32, max_len=128))
    jtl, jlp, c = jprefill(jparams, jnp.asarray(toks), jnp.asarray(lens))
    jssm = c["layers"][1][0]["ssm"][0]
    jld = []
    for i in range(4):
        ld, c = jdecode(jparams, jnp.asarray(steps[:, i:i + 1]), c,
                        jnp.asarray(lens + i))
        jld.append(ld)
    t_lens = torch.from_numpy(lens)
    cache = T.init_cache(cfg, 2, 128, torch.float32)
    assert cache["layers"][1]["pos"].shape[1] == 65          # the ring
    with torch.no_grad():
        tl = T.forward_train(params, cfg, torch.from_numpy(toks))[0]
        lp, _ = T.forward_prefill(params, cfg, torch.from_numpy(toks[:, :90]),
                                  t_lens, cache, max_len=128)
        ssm = cache["layers"][1]["ssm"].clone()
        ld = [T.forward_decode(params, cfg, torch.from_numpy(
            steps[:, i:i + 1]), cache, t_lens + i, max_len=128)[0]
            for i in range(4)]
    _close(tl, jtl)
    _close(lp[0], jlp[0])
    _close(lp[1, :70], jlp[1, :70])
    _close(ssm, jssm)
    for a, b in zip(ld, jld):
        _close(a, b)


# ---------------------------------------------------------------------------
# serve_continuous (bucketed at exact lengths) and the dense path
# ---------------------------------------------------------------------------


# two equal lengths in a row (one batched prefill); 5 and 7 share a
# bucket but not a length; 80 wraps the windowed layer's ring of 72 paged
# entries
LENS = (5, 7, 7, 80)


def _prompts(lens=LENS, seed=5):
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


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_serve_matches_reference(pairs, mode):
    """Bucketed admission at exact prompt lengths (the default for a
    hybrid model: no warning), 3 slots, the windowed layer's paged ring
    wrapping for the 80-token prompt; int8 is int8 KV + int8
    weights in both packages: the KV request warns (no pure attention
    layer) and the pool stays fp32.  Streams, counters and warnings
    exactly equal; each stream also equals the port's single-request
    ``generate_batch`` (the reference's ``test_continuous.py``
    contract)."""
    pair = pairs(**(INT8 if mode == "int8" else {}))
    ref, ours = pair.serve(_prompts(LENS if mode == "fp32" else (7, 7, 80)))
    m = _assert_same(ref, ours)
    assert m.outcome_counts == {"completed": len(ours[0])}
    assert m.prefill_padded == m.prefill_tokens     # exact lengths
    pool = pair.eng._paged_ctx["cache"]["layers"][0]
    assert pool["pk"].dtype == torch.float32 and "pk_scale" not in pool
    assert ours[2] == ([] if mode == "fp32" else [
        "kv_dtype=int8 requested but no attention layer has a paged pool "
        "to quantize; state stays at full precision"])
    if mode == "fp32":
        for uid, p in enumerate(_prompts()):
            row = pair.eng.generate_batch(np.asarray([p], np.int32),
                                          np.asarray([len(p)], np.int32),
                                          6)[0]
            assert ours[0][uid] == [int(t) for t in row[row >= 0]]


def test_pad_sensitive_admission_runs_at_exact_lengths(pairs, monkeypatch):
    """The 5- and 7-token prompts share a prompt bucket; a hybrid model
    folds pad steps into its SSM state, so they must be admitted apart,
    at their own lengths (the 7s together): the prefills' row widths are
    the prompt lengths."""
    pair = pairs()
    widths = []
    prefill = T.forward_prefill

    def spy(params, cfg, tokens, *a, **kw):
        widths.append(tuple(tokens.shape))
        return prefill(params, cfg, tokens, *a, **kw)
    monkeypatch.setattr(T, "forward_prefill", spy)
    pair.eng.reset_prefix_cache()
    pair.eng.serve_continuous([Request(uid=i, tokens=p, max_new_tokens=2)
                               for i, p in enumerate(_prompts())],
                              page_size=PAGE)
    assert sorted(widths) == [(1, 5), (1, 80), (2, 7)]


def test_serve_warns_off_options_as_reference(pairs):
    """Asked for speculation, prefix sharing, chunked prefill, packing and
    preemption, hymba warns for each in the reference's words and order
    (its layers keep dense / ring state) and serves bucketed with the
    plain serve's streams; ``set_prefix`` warns and does nothing."""
    pair = pairs()
    prompts = _prompts(seed=8)
    ref, ours = pair.serve(prompts, spec=True, prefix_cache=True,
                           chunked_prefill=True, packed=True,
                           preemption="lru")
    m = _assert_same(ref, ours)
    assert len(ours[2]) == 5
    assert all("hybrid" in w or "chunked scheduler" in w for w in ours[2])
    assert m.spec_mode == "off" and m.prefix_hits == 0
    (_, _, _), (plain, _, _) = pair.serve(prompts)
    assert ours[0] == plain
    for eng in (pair.jeng, pair.eng):
        with pytest.warns(UserWarning, match="layer family 'hybrid'"):
            eng.set_prefix([2, 5, 6, 7, 8, 9, 10, 11, 12], page_size=PAGE)


@pytest.mark.parametrize("use_kv_cache", [True, False])
def test_generate_batch_matches_reference(use_kv_cache):
    """Rows of 90, 40 and 5 tokens x 6 new at max_len 128 (right-padded:
    pad steps fold into the SSM state in both packages), with and
    without the KV cache: greedy ids equal."""
    jcfg, jparams, cfg, params = _weights()
    kw = dict(ENGINE, use_kv_cache=use_kv_cache)
    rng = np.random.default_rng(4)
    toks = rng.integers(4, 400, size=(3, 90)).astype(np.int32)
    lens = np.asarray([90, 40, 5], np.int32)
    ref = JEngine(jcfg, jparams, policy=JP.FP32, **kw).generate_batch(
        toks.copy(), lens.copy(), 6)
    ours = InferenceEngine(cfg, params, policy=P.FP32, device="cpu",
                           **kw).generate_batch(toks.copy(), lens.copy(), 6)
    np.testing.assert_array_equal(ours, ref)
    assert (ours >= 0).sum() > 0


def test_int8_weights_skip_the_mamba_branch():
    """int8 weights quantize the attention projections, the dense FFN and
    the tied head (an int8 copy), never the Mamba dict: byte and record
    counts equal the reference's."""
    jcfg, jparams, cfg, params = _weights()
    jnew, jstats = JP.compress_weights(
        jparams, dataclasses.replace(JP.FP32, weights_dtype="int8"))
    new, stats = P.compress_weights(
        params, dataclasses.replace(P.FP32, weights_dtype="int8"))
    for k in ("weight_bytes", "weight_bytes_dense", "weight_bytes_saved"):
        assert stats[k] == jstats[k], k
    assert stats["n_quantized"] == 7 * cfg.num_layers + 1
    for layer in new["layers"]:
        assert all(isinstance(v, torch.Tensor) or k == "out_norm"
                   for k, v in layer["mamba"].items())
        assert isinstance(layer["attn"]["wq"], dict)


def test_hybrid_pool_never_stores_int8():
    """The reference's rule per mixer: an int8 KV request gives pure
    attention layers int8 pools with scales, and a hybrid layer a pool at
    the compute dtype beside its SSM (fp32) and conv state."""
    cfg = R.get_reduced(ARCH)
    spec = cfg.stacks[0].pattern[0]
    pool = KV.paged_layer_cache_shape(cfg, spec, 4, 8, torch.bfloat16,
                                      "int8", max_slots=2)
    assert pool["pk"].dtype == torch.bfloat16
    assert set(pool) == {"pk", "pv", "ppos", "ssm", "conv"}
    assert pool["ssm"].dtype == torch.float32
    assert pool["conv"].shape == (2, 3, 2 * cfg.d_model)
    attn = KV.paged_layer_cache_shape(cfg, dataclasses.replace(
        spec, mixer="attn"), 4, 8, torch.bfloat16, "int8")
    assert attn["pk"].dtype == torch.int8 and "pk_scale" in attn
