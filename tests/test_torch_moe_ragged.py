"""The reference's perf flags on the port (``repro_torch.perf_flags``):
``moe_ragged`` (``moe.moe_apply_ragged`` and its grouped product
``ops.ragged_matmul``) and the ``REPRO_PERF_OPTS=""`` baseline of
``attn_bf16`` (MLA's absorbed decode, ``layers.attention_ref``), against
the reference package under the same flags.

Each test sets ``REPRO_PERF_OPTS`` for both packages (``monkeypatch``).
The reference reads its flags while JAX traces, and ``jax.jit`` keeps a
trace across a change of the variable, so every JAX side here is a
freshly made ``jax.jit`` closure or a fresh engine (whose jitted
functions are its own), and the module ends with ``jax.clear_caches()``.
Each whole-path case runs at the
reduced configs' own capacity factor (1.5) with inputs that make the
capacity dispatch drop assignments, so that ragged and capacity differ
there, and spies show that both packages took the ragged path.

Tolerances: the grouped product's plain version against
``jax.lax.ragged_dot`` 1e-6 at fp32, 2e-2 at bf16; MoE outputs, the
auxiliary loss and gradients 1e-5 at fp32 (XLA and PyTorch sum in other
orders), bf16 outputs 2e-2 (one bf16 unit of values of order one);
greedy streams, counters and train-step losses as in
``tests/test_torch_{moe,mla,train}.py``.
"""
import dataclasses
import functools
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import perf_flags as JPF
from repro.configs import registry as JR
from repro.core import kv_cache as JKV
from repro.core import precision as JP
from repro.core.engine import InferenceEngine as JEngine
from repro.core.scheduler import Request as JRequest
from repro.models import attention_mla as JMLA
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.training import optimizer as JOPT
from repro.training import train_loop as JTL
from repro_torch import bridge
from repro_torch import perf_flags as PF
from repro_torch.configs import registry as R
from repro_torch.core import kv_cache as KV
from repro_torch.core import precision as P
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.precision import map_params
from repro_torch.core.scheduler import Request
from repro_torch.data import pipeline as D
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models import attention_mla as MLA
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_loop as TL

QWEN, DEEPSEEK = "qwen3-moe-235b-a22b", "deepseek-v3-671b"
TOL = 1e-5
ENGINE = dict(max_len=64, max_batch=3)
COUNTERS = ("admitted", "retired", "prefill_tokens", "prefill_padded",
            "host_syncs", "steps", "mixed_iters", "generated_tokens",
            "peak_pages_in_use", "preemptions")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (many small ops); no JAX trace made here under
    ``moe_ragged`` outlives the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    jax.clear_caches()
    torch.set_num_threads(n)


def _flags(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("REPRO_PERF_OPTS", raising=False)
    else:
        monkeypatch.setenv("REPRO_PERF_OPTS", raw)


# ---------------------------------------------------------------------------
# perf_flags
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw", [None, "", "attn_bf16,grad_accum=4",
                                 " moe_ragged , tp_attn_guard",
                                 "moe_ragged"])
def test_perf_flags_parse_as_reference(monkeypatch, raw):
    """``flag``, ``flag_value`` (with and without a default) and
    ``active`` equal the reference's for each setting: unset (the
    default ``attn_bf16``), empty (none), values, spaces."""
    _flags(monkeypatch, raw)
    assert PF.active() == JPF.active()
    for name in ("attn_bf16", "moe_ragged", "tp_attn_guard", "grad_accum",
                 "seq_parallel"):
        assert PF.flag(name) == JPF.flag(name), name
        assert PF.flag_value(name) == JPF.flag_value(name), name
        assert PF.flag_value(name, "d") == JPF.flag_value(name, "d"), name


# ---------------------------------------------------------------------------
# The grouped product's plain version against jax.lax.ragged_dot
# ---------------------------------------------------------------------------


SIZES = {"empty groups": [0, 5, 0, 3, 0], "a one-row group": [1, 6, 1],
         "all rows in one group": [0, 0, 8, 0],
         "rows past the groups": [2, 0, 3]}
R_ROWS, K_IN, N_OUT = 8, 12, 10


def _ragged_case(sizes, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(R_ROWS, K_IN)).astype(np.float32)
    w = rng.normal(size=(len(sizes), K_IN, N_OUT)).astype(np.float32)
    return rows, w, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(SIZES))
def test_ragged_matmul_ref_matches_ragged_dot(case, dtype):
    """Outputs within 1e-6 (fp32) / 2e-2 (bf16, at the operands' dtype)
    of ``jax.lax.ragged_dot``; rows past the last group are zero."""
    rows, w, sizes = _ragged_case(SIZES[case])
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jax.lax.ragged_dot(jnp.asarray(rows, jdt), jnp.asarray(w, jdt),
                              jnp.asarray(sizes))
    got = ref.ragged_matmul_ref(torch.from_numpy(rows).to(tdt),
                                torch.from_numpy(w).to(tdt),
                                torch.from_numpy(sizes))
    assert got.dtype == tdt and got.shape == (R_ROWS, N_OUT)
    tol = 1e-6 if dtype == "fp32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    assert (got[int(sizes.sum()):] == 0).all()


@pytest.mark.parametrize("case", list(SIZES))
def test_ragged_matmul_ref_grads_match_jax(case):
    """Autograd of the plain version against ``jax.grad`` of
    ``ragged_dot`` for rows and w, fp32, within 1e-6: an empty group's
    slab of w and rows past the groups get zeros."""
    rows, w, sizes = _ragged_case(SIZES[case], seed=1)
    cot = np.random.default_rng(2).normal(size=(R_ROWS, N_OUT)).astype(
        np.float32)
    jd_rows, jd_w = jax.grad(lambda a, b: jnp.sum(jax.lax.ragged_dot(
        a, b, jnp.asarray(sizes)) * cot), argnums=(0, 1))(
        jnp.asarray(rows), jnp.asarray(w))
    trows = torch.from_numpy(rows).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    (ops.ragged_matmul(trows, tw, torch.from_numpy(sizes))
     * torch.from_numpy(cot)).sum().backward()
    for got, want in ((trows.grad, jd_rows), (tw.grad, jd_w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    for e in np.flatnonzero(sizes == 0):
        assert (tw.grad[e] == 0).all()


# ---------------------------------------------------------------------------
# moe_apply under moe_ragged against the reference's
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _moe_params(arch):
    """The reference's ``moe_init`` of the reduced config, compiled."""
    jp = jax.jit(JM.moe_init, static_argnums=1)(jax.random.PRNGKey(3),
                                                JR.get_reduced(arch))
    return jax.tree.map(np.asarray, jp)


def _moe_case(arch, factor=None):
    """Reduced configs (capacity factor ``factor``, else the config's own
    1.5), the reference's ``moe_init`` in both packages, and x (4, 24, d)
    pulled towards expert 0's router column, which overflows its capacity
    at the factor 1.5."""
    jcfg, cfg = JR.get_reduced(arch), R.get_reduced(arch)
    if factor is not None:
        jcfg, cfg = (c.replace(moe=dataclasses.replace(
            c.moe, capacity_factor=factor)) for c in (jcfg, cfg))
    jp = jax.tree.map(jnp.asarray, _moe_params(arch))
    p = bridge._map(bridge._to_torch, _moe_params(arch))
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 24, cfg.d_model)).astype(np.float32)
    col = p["router"][:, 0].numpy()
    x += 2.0 * col / np.linalg.norm(col) * np.sqrt(cfg.d_model) / 4
    return jcfg, jp, cfg, p, x


def _dropped(cfg, p, x):
    """Assignments the capacity dispatch would drop for x (B, S, d)."""
    xf = x.reshape(-1, x.shape[-1])
    _, _, tope = M.route(cfg, p, xf)
    counts = torch.bincount(tope.reshape(-1), minlength=cfg.moe.num_experts)
    return int((counts - M._capacity(xf.shape[0], cfg)).clamp_min(0).sum())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", [QWEN, DEEPSEEK])
def test_moe_apply_ragged_matches_reference(monkeypatch, arch, dtype):
    """Softmax routing (qwen3-moe) and sigmoid with a shared expert
    (deepseek-v3): output and load-balance loss within 1e-5 at fp32 (the
    output 2e-2 at bf16) of the reference's ``moe_apply`` under
    ``moe_ragged``, where the capacity dispatch drops assignments and so
    gives another output."""
    _flags(monkeypatch, "moe_ragged")
    jcfg, jp, cfg, p, x = _moe_case(arch)
    kind = M.router_kind_of(cfg)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    jout, jaux = jax.jit(lambda p_, x_: JM.moe_apply(jcfg, p_, x_, kind))(
        jax.tree.map(lambda a: a.astype(jdt), jp), jnp.asarray(x, jdt))
    pd = map_params(lambda t: t.to(tdt), p)
    tx = torch.from_numpy(x).to(tdt)
    out, aux = M.moe_apply(cfg, pd, tx)
    assert out.dtype == tdt
    tol = TOL if dtype == "fp32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)
    assert _dropped(cfg, pd, tx) > 0
    cap = M.moe_apply_capacity(cfg, pd, tx)[0]
    assert (cap.float() - out.float()).abs().max() > 0.1


@pytest.mark.parametrize("arch", [QWEN, DEEPSEEK])
def test_moe_apply_ragged_grads_match_reference(monkeypatch, arch):
    """The gradients of ``sum(out * c) + aux`` for every parameter (router,
    expert stacks, shared expert) and for x against ``jax.grad`` of the
    reference's under ``moe_ragged``, fp32: each leaf within 1e-5 of its
    largest magnitude (as ``tests/test_torch_train.py`` holds
    gradients)."""
    _flags(monkeypatch, "moe_ragged")
    jcfg, jp, cfg, p, x = _moe_case(arch)
    kind = M.router_kind_of(cfg)
    cot = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jloss(p_, x_):
        out, aux = JM.moe_apply(jcfg, p_, x_, kind)
        return jnp.sum(out * cot) + aux
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = map_params(lambda t: t.clone().requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = M.moe_apply(cfg, tp, tx)
    ((out * torch.from_numpy(cot)).sum() + aux).backward()
    want = OPT.flatten(bridge._map(bridge._to_torch,
                                   jax.tree.map(np.asarray, jgp)))
    got = OPT.flatten(map_params(lambda t: t.grad, tp))
    assert sorted(got) == sorted(want)
    want["x"], got["x"] = torch.from_numpy(np.array(jgx)), tx.grad
    for k in want:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=TOL * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("arch", [QWEN, DEEPSEEK])
def test_moe_ragged_equals_capacity_without_drops(monkeypatch, arch):
    """At the capacity factor 8 nothing drops, and the port's ragged
    dispatch equals its capacity dispatch (``tests/test_moe.py``'s
    ``test_moe_ragged_matches_capacity`` for the reference); the flag
    picks the path."""
    _flags(monkeypatch, "moe_ragged")
    _, _, cfg, p, x = _moe_case(arch, factor=8.0)
    tx = torch.from_numpy(x)
    assert _dropped(cfg, p, tx) == 0
    out_r, aux_r = M.moe_apply(cfg, p, tx)
    out_c, aux_c = M.moe_apply_capacity(cfg, p, tx)
    np.testing.assert_allclose(out_r.numpy(), out_c.numpy(), rtol=TOL,
                               atol=TOL)
    assert float(aux_r) == float(aux_c)
    calls = []
    monkeypatch.setattr(M, "moe_apply_ragged",
                        lambda *a: calls.append(1) or out_r)
    M.moe_apply(cfg, p, tx)
    _flags(monkeypatch, None)
    M.moe_apply(cfg, p, tx)
    assert calls == [1]


# ---------------------------------------------------------------------------
# Whole paths under moe_ragged: bucketed serves, generate_batch, training
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """Both packages' reduced configs (the own capacity factor 1.5) and
    parameters (the reference's init compiled whole)."""
    jcfg, cfg = JR.get_reduced(arch), R.get_reduced(arch)
    jparams = jax.jit(lambda key: JT.init_params(key, jcfg, JP.FP32))(
        jax.random.PRNGKey(0))
    return (jcfg, jparams, cfg,
            bridge.params_from_jax(jax.tree.map(np.asarray, jparams)))


def _spy_ragged(monkeypatch):
    """Count the reference's ragged traces and the port's ragged calls,
    and record how many assignments the capacity dispatch would drop in
    each of the port's."""
    seen = {"jax": 0, "port": 0, "drops": []}
    japply, apply = JM.moe_apply_ragged, M.moe_apply_ragged

    def jspy(*a, **kw):
        seen["jax"] += 1
        return japply(*a, **kw)

    def spy(cfg, p, x):
        seen["port"] += 1
        seen["drops"].append(_dropped(cfg, p, x))
        return apply(cfg, p, x)
    monkeypatch.setattr(JM, "moe_apply_ragged", jspy)
    monkeypatch.setattr(M, "moe_apply_ragged", spy)
    return seen


@pytest.mark.parametrize("arch", [QWEN, DEEPSEEK])
def test_serve_ragged_matches_reference(monkeypatch, arch):
    """A bucketed serve (3 slots, exact-length admission, the two equal
    prompts admitted together) under ``moe_ragged``: greedy streams and
    counters equal the reference's.  The prompts repeat one token, so the
    capacity dispatch would drop assignments in their prefills."""
    _flags(monkeypatch, "moe_ragged")
    seen = _spy_ragged(monkeypatch)
    jcfg, jparams, cfg, params = _weights(arch)
    rng = np.random.default_rng(5)
    prompts = [[2] + [int(rng.integers(4, 400))] * (n - 1)
               for n in (11, 11, 20)]
    out = []
    for eng, req in ((JEngine(jcfg, jparams, policy=JP.FP32, **ENGINE),
                      JRequest),
                     (InferenceEngine(cfg, params, policy=P.FP32,
                                      device="cpu", **ENGINE), Request)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            done, m = eng.serve_continuous(
                [req(uid=i, tokens=list(p), max_new_tokens=5)
                 for i, p in enumerate(prompts)], page_size=8)
        out.append(({r.uid: r.result for r in done}, m))
    (jres, jm), (res, m) = out
    assert res == jres
    for k in COUNTERS:
        assert getattr(m, k) == getattr(jm, k), k
    assert m.scheduler == "bucketed"
    assert seen["jax"] > 0 and seen["port"] > 0 and max(seen["drops"]) > 0


@pytest.mark.parametrize("arch", [QWEN, DEEPSEEK])
def test_generate_batch_ragged_matches_reference(monkeypatch, arch):
    """``generate_batch`` with the KV cache, rows of 30, 17 and 5 tokens
    (each one repeated token: the capacity dispatch would drop) x 5 new
    at max_len 64 under ``moe_ragged``: greedy ids equal."""
    _flags(monkeypatch, "moe_ragged")
    seen = _spy_ragged(monkeypatch)
    jcfg, jparams, cfg, params = _weights(arch)
    toks = np.full((3, 30), 9, np.int32)
    lens = np.asarray([30, 17, 5], np.int32)
    want = JEngine(jcfg, jparams, policy=JP.FP32, **ENGINE).generate_batch(
        toks.copy(), lens.copy(), 5)
    got = InferenceEngine(cfg, params, policy=P.FP32, device="cpu",
                          **ENGINE).generate_batch(toks.copy(), lens.copy(),
                                                   5)
    np.testing.assert_array_equal(got, want)
    assert seen["jax"] > 0 and seen["port"] > 0 and max(seen["drops"]) > 0


def test_train_steps_ragged_match_reference(monkeypatch):
    """Two ``make_train_step`` steps of reduced qwen3-moe (fp32, full
    AdamW at eps 1e-3 as ``tests/test_torch_train.py`` holds them) under
    ``moe_ragged``, on batches of 4 x 32 whose first three rows repeat one
    token (the capacity dispatch would drop): loss, ce, lr and gnorm of
    each step within 1e-5 and every parameter after them within 1e-5 of
    its leaf's scale."""
    _flags(monkeypatch, "moe_ragged")
    seen = _spy_ragged(monkeypatch)
    jcfg, jparams, cfg, params = _weights(QWEN)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=10, eps=1e-3)
    jstep = jax.jit(JTL.make_train_step(jcfg, JOPT.AdamWConfig(**ocfg),
                                        policy=JP.FP32))
    step = TL.make_train_step(cfg, OPT.AdamWConfig(**ocfg), policy=P.FP32)
    state, jstate = OPT.init_state(params), JOPT.init_state(jparams)
    batches = D.random_batches(cfg.vocab_size, batch_size=4, seq_len=32,
                               seed=3)
    jp = jparams
    for i in range(2):
        b = dict(next(batches))
        b["tokens"] = b["tokens"].copy()
        b["tokens"][:3] = 7 + i
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        params, state, m = step(params, state, TL.to_device(b, "cpu"))
        assert m["lr"] == float(jm["lr"])
        for k in ("loss", "ce", "gnorm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL)
    want = OPT.flatten(bridge.params_from_jax(jax.tree.map(np.asarray, jp)))
    got = OPT.flatten(params)
    assert sorted(got) == sorted(want)
    for k in want:
        w = want[k].float().numpy()
        np.testing.assert_allclose(got[k].detach().float().numpy(), w,
                                   rtol=0, atol=TOL * np.abs(w).max()
                                   + 1e-30, err_msg=k)
    assert seen["jax"] > 0 and seen["port"] > 0 and max(seen["drops"]) > 0


# ---------------------------------------------------------------------------
# attn_bf16 off: MLA's absorbed decode and the plain attention
# ---------------------------------------------------------------------------


def test_mla_decode_baseline_matches_reference(monkeypatch):
    """A bf16 latent cache (8 tokens; row 1 holds 5) and one absorbed
    ``mla_decode`` step, bf16 activations and parameters, under
    ``REPRO_PERF_OPTS=""``: the port attends over fp32 copies of the
    cache as the reference does.  Outputs and caches within 1e-5 of the
    reference's (the same fp32 sums, rounded to bf16 at the end); under
    the default the outputs differ from these (the cache's dtype in the
    products)."""
    _flags(monkeypatch, "")
    jcfg, jparams, cfg, params = _weights(DEEPSEEK)
    jp = jax.tree.map(lambda a: a[0].astype(jnp.bfloat16),
                      jparams["stacks"][0][0]["attn"])
    p = map_params(lambda t: t.to(torch.bfloat16),
                   params["layers"][0]["attn"])
    spec = cfg.stacks[0].pattern[0]
    x = np.random.default_rng(3).normal(size=(2, 9, cfg.d_model)).astype(
        np.float32)
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
    jdec, jc = jrun(jp, jnp.asarray(x, jnp.bfloat16))

    def run():
        c = KV.layer_cache_shape(cfg, spec, 2, 32, torch.bfloat16)
        tx = torch.from_numpy(x).bfloat16()
        tp = torch.from_numpy(np.array(pos))
        _, new = MLA.mla_full(cfg, p, tx[:, :8], tp, tp)
        KV.write_prefill(c, new, torch.from_numpy(cpos))
        return MLA.mla_decode(cfg, p, tx[:, 8:9], c,
                              torch.from_numpy(lens)), c
    dec, c = run()
    assert dec.dtype == torch.bfloat16
    for k in ("ckv", "kr"):
        np.testing.assert_allclose(c[k].float().numpy(),
                                   np.asarray(jc[k], np.float32), rtol=TOL,
                                   atol=TOL)
    want = np.asarray(jdec, np.float32)
    np.testing.assert_allclose(dec.float().numpy(), want, rtol=TOL,
                               atol=TOL)
    _flags(monkeypatch, None)
    assert (run()[0].float().numpy() != want).any()


ATTN = [(2, 5, 19, 4, 2, 16, None, None), (2, 1, 40, 8, 2, 64, 16, 30.0),
        (1, 33, 33, 4, 4, 16, 8, None)]


@pytest.mark.parametrize("raw", [None, ""])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,window,softcap", ATTN)
def test_attention_ref_follows_reference_flag(monkeypatch, raw, B, Sq, Sk,
                                              Hq, Hkv, D, window, softcap):
    """``layers.attention_ref`` at bf16 q, k, v against the reference's
    ``attention_ref`` under the same setting (unset: ``attn_bf16`` on, P
    rounded to bf16 before the product with v; empty: P in fp32): every
    output equal to the reference's rounding (at most one in a thousand
    a bf16 unit apart, where the two frameworks' fp32 sums land on two
    sides of a rounding boundary); fp32 inputs within 1e-5."""
    _flags(monkeypatch, raw)
    rng = np.random.default_rng(Sq + D)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
            for _ in range(2))
    kp = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    qp = kp[:, Sk - Sq:].copy()
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = np.asarray(jax.jit(lambda *a: JL.attention_ref(*a, **kw))(
            *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(qp),
            jnp.asarray(kp)), np.float32)
        got = L.attention_ref(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)), torch.from_numpy(qp),
                              torch.from_numpy(kp), **kw)
        assert got.dtype == tdt
        got = got.float().numpy()
        if tdt == torch.float32:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        else:
            ulp = np.spacing(np.abs(want)) * 2 ** 16
            assert (np.abs(got - want) <= ulp).all()
            assert (got != want).mean() <= 1e-3


def test_serve_cli_records_perf_flags(monkeypatch, tmp_path, capsys):
    """``launch/serve.py --continuous --metrics-json`` serves reduced
    qwen3-moe under ``moe_ragged`` on the CPU through the ragged path and
    records the active flags beside the other metrics."""
    from repro_torch.launch import serve
    _flags(monkeypatch, "moe_ragged")
    calls = []
    apply = M.moe_apply_ragged
    monkeypatch.setattr(M, "moe_apply_ragged",
                        lambda *a: calls.append(1) or apply(*a))
    path = tmp_path / "metrics.json"
    serve.main(["--arch", QWEN, "--continuous", "--device", "cpu",
                "--policy", "fp32", "--requests", "3", "--max-new-tokens", "3",
                "--metrics-json", str(path)])
    capsys.readouterr()
    got = json.loads(path.read_text())
    assert got["perf_opts"] == {"moe_ragged": "1"} and got["requests"] == 3
    assert calls
