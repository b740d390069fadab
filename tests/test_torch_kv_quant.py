"""The port's int8 KV pools (``kv_dtype="int8"``) against the reference.

``quantize_kv`` rounds half to even in both frameworks and divides by the
same fp32 scale, so on equal fp32 input its codes and scales are
bit-equal, zero rows included.  The paged writes, the gather, the COW
copy and ``paged_pool_bytes`` only move (or dequantize) those bytes, so
the port's int8 pools must equal the reference's exactly, the dump page's
data aside (several padding lanes write it in one scatter).  The plain
q8 attention matches the reference's Pallas ``_q8`` kernels (interpret
mode) within 1e-5, fp32 summation order.

Across the packages, int8 serve streams can part for one reason: a K/V
value computed by a forward differs by a few ulp between XLA and PyTorch
(up to ~2.7e-6, ``test_torch_model.py``), and where that value lies on a
rounding boundary its int8 code rounds the other way.
``test_int8_kv_streams_match_reference`` shows this cause where it
happens and asserts the match it measured.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kv_cache as JKV
from repro.core.precision import FP32 as J_FP32
from repro.kernels import decode_attention as JDA
from repro_torch.core import kv_cache as KV
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.precision import FP32
from repro_torch.core.scheduler import Request
from repro_torch.kernels import decode_attention as DA
from test_torch_qwen3 import model, serve_both  # noqa: F401

P, PAGE, NPAGES, H, D = 12, 8, 4, 2, 16
DUMP = P - 1
INT8 = dataclasses.replace(FP32, kv_dtype="int8")
J_INT8 = dataclasses.replace(J_FP32, kv_dtype="int8")


def _t(a):
    return torch.from_numpy(np.array(a))


def test_quantize_kv_bit_equal_to_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7, H, D)).astype(np.float32)
    x[1, 2] = 0.0                                   # all-zero rows
    x[3, 4, 0] = 0.0
    x[2] *= 1e-20                                    # tiny scales
    x[4] *= 3e4
    x[0, 0, 1, :4] = [127.0, -63.5, 0.5, 1.5]       # exact half codes
    q, s = KV.quantize_kv(_t(x))
    jq, js = JKV.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (s[1, 2] == 0).all() and (q[1, 2] == 0).all()
    assert q.abs().max() <= 127
    np.testing.assert_array_equal(
        KV.dequantize_kv(q, s).numpy(),
        np.asarray(JKV.dequantize_kv(jq, js)))


def _int8_pool(rng):
    ppos = rng.integers(-1, 40, size=(P, PAGE)).astype(np.int32)
    ppos[DUMP] = -1
    pool = {"ppos": ppos}
    for k in ("pk", "pv"):
        q, s = JKV.quantize_kv(jnp.asarray(
            rng.normal(size=(P, PAGE, H, D)).astype(np.float32)))
        pool[k], pool[k + "_scale"] = np.asarray(q), np.asarray(s)
    return pool


def _assert_same(ours, ref):
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert set(ours) == set(ref) == set(KV.PAGED_KEYS)
    np.testing.assert_array_equal(ours["ppos"].numpy(), ref["ppos"])
    for k in KV.PAGED_DATA_KEYS:
        assert ours[k].dtype == (torch.int8 if k in ("pk", "pv")
                                 else torch.float32)
        np.testing.assert_array_equal(ours[k].numpy()[:DUMP], ref[k][:DUMP])


BT = np.asarray([[0, 3, 5, 7], [2, 9, -1, -1], [-1, -1, -1, -1]], np.int32)


@pytest.mark.parametrize("op", ["decode", "packed", "copy", "gather"])
def test_int8_pool_updates_match_reference(op):
    rng = np.random.default_rng({"decode": 1, "packed": 2, "copy": 3,
                                 "gather": 4}[op])
    pool = _int8_pool(rng)
    ours = {k: _t(v) for k, v in pool.items()}
    ref = {k: jnp.asarray(v) for k, v in pool.items()}
    if op == "decode":
        lens = np.asarray([13, 20, 3], np.int32)
        new = {k: rng.normal(size=(3, 1, H, D)).astype(np.float32)
               for k in ("k", "v")}
        active = np.asarray([True, True, False])
        KV.paged_write_decode(ours, {k: _t(v) for k, v in new.items()},
                              _t(lens), _t(BT), _t(active),
                              ring_len=NPAGES * PAGE)
        ref = JKV.paged_write_decode(
            ref, {k: jnp.asarray(v) for k, v in new.items()},
            jnp.asarray(lens), jnp.asarray(BT), jnp.asarray(active),
            ring_len=NPAGES * PAGE)
        assert ours["ppos"][3, 13 % PAGE] == 13
    elif op == "packed":
        T = 16
        sid = np.full(T, -1, np.int32)
        pos = np.full(T, -1, np.int32)
        sid[:1], pos[:1] = 0, 21
        sid[1:12], pos[1:12] = 1, np.arange(10, 21)
        new = {k: rng.normal(size=(1, T, H, D)).astype(np.float32)
               for k in ("k", "v")}
        new["k"][0, 3] = 0.0                        # a zero row: scale 0
        KV.paged_write_packed(ours, {k: _t(v) for k, v in new.items()},
                              _t(sid), _t(pos), _t(BT),
                              ring_len=NPAGES * PAGE)
        ref = JKV.paged_write_packed(
            ref, {k: jnp.asarray(v) for k, v in new.items()},
            jnp.asarray(sid), jnp.asarray(pos), jnp.asarray(BT),
            ring_len=NPAGES * PAGE)
    elif op == "copy":
        src, dst = np.asarray([DUMP, 4, 2]), np.asarray([DUMP, 6, 8])
        keep = np.asarray([0, 11, 40], np.int32)
        KV.copy_pages(ours, _t(src), _t(dst), _t(keep))
        ref = JKV.copy_pages(ref, jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(keep))
        np.testing.assert_array_equal(ours["pk_scale"][6].numpy(),
                                      pool["pk_scale"][4])
    else:
        out = KV.paged_gather(ours, _t(BT))
        jout = JKV.paged_gather(ref, jnp.asarray(BT))
        assert out[0].dtype == torch.float32
        for o, r in zip(out, jout):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        return
    _assert_same(ours, ref)


def test_int8_pool_layout_and_bytes_match_reference(model):  # noqa: F811
    jcfg, _, cfg, _ = model
    from repro.models import transformer as JT
    from repro_torch.models import transformer as T
    kw = dict(num_pages=6, page_size=PAGE)
    jc = JT.init_paged_cache(jcfg, max_slots=2, max_len=32,
                             dtype=jnp.float32, kv_dtype="int8", **kw)
    c = T.init_paged_cache(cfg, dtype=torch.float32, kv_dtype="int8", **kw)
    jpool = jc["layers"][0][0]
    for k, v in c["layers"][0].items():
        assert tuple(v.shape) == jpool[k].shape[1:], k
        assert str(v.dtype).removeprefix("torch.") == str(jpool[k].dtype)
    assert KV.paged_pool_bytes(c) == JKV.paged_pool_bytes(jc)
    fp = T.init_paged_cache(cfg, dtype=torch.float32, **kw)
    assert KV.paged_pool_bytes(c) < 0.5 * KV.paged_pool_bytes(fp)


def _q8_case(rng, ctx):
    kpool, vpool = (rng.normal(size=(P, PAGE, H, D)).astype(np.float32)
                    for _ in range(2))
    (kq, ks), (vq, vs) = (JKV.quantize_kv(jnp.asarray(a))
                          for a in (kpool, vpool))
    ppos = np.full((P, PAGE), -1, np.int32)
    bt = np.full((len(ctx), NPAGES), -1, np.int32)
    perm, nxt = rng.permutation(P - 1), 0
    for b, n in enumerate(ctx):
        used = -(-n // PAGE)
        bt[b, :used] = perm[nxt:nxt + used]
        nxt += used
        for t in range(n):
            ppos[bt[b, t // PAGE], t % PAGE] = t
    return [np.asarray(a) for a in (kq, ks, vq, vs)] + [ppos, bt]


@pytest.mark.parametrize("window,softcap", [(None, None), (8, 30.0)])
def test_q8_plain_matches_reference_kernels(window, softcap):
    """The plain versions of both _q8 kernels against the reference's
    Pallas kernels in interpret mode, GQA g = 4."""
    rng = np.random.default_rng(7)
    ctx = [9, 27, 1, 0]
    kq, ks, vq, vs, ppos, bt = _q8_case(rng, ctx)
    Hq = 4 * H
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    q = rng.normal(size=(len(ctx), 1, Hq, D)).astype(np.float32)
    q_pos = np.asarray([[n - 1] for n in ctx], np.int32)
    ours = DA.paged_decode_attention_ref(
        _t(q), _t(kq), _t(vq), _t(ppos), _t(bt), _t(q_pos), k_scale=_t(ks),
        v_scale=_t(vs), **kw)
    ref = JDA.paged_decode_attention_q8(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), jnp.asarray(ppos), jnp.asarray(bt),
        jnp.asarray(q_pos), interpret=True, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # packed: slot 1's decode lane, a 9-token chunk of slot 0, padding
    T = 16
    sid = np.full(T, -1, np.int32)
    pos = np.full(T, -1, np.int32)
    sid[0], pos[0] = 1, 26
    sid[1:10], pos[1:10] = 0, np.arange(9)
    meta = DA.packed_meta_table([0, 1], [1, 9], [1, 0], T,
                                T // DA.PACKED_BLOCK_Q + len(ctx))
    qp = rng.normal(size=(1, T, Hq, D)).astype(np.float32)
    ours = DA.paged_packed_attention_ref(
        _t(qp), _t(kq), _t(vq), _t(ppos), _t(bt), _t(pos[None]), _t(sid),
        k_scale=_t(ks), v_scale=_t(vs), **kw)
    ref = JDA.paged_packed_attention_q8(
        jnp.asarray(qp), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), jnp.asarray(ppos), jnp.asarray(bt),
        jnp.asarray(pos[None]), jnp.asarray(meta), interpret=True, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert not ours[0, 10:].any()


def test_int8_shared_prefix_bit_identical_to_unshared(model):  # noqa: F811
    """Within the port, an int8 pool's shared-prefix serve gives the same
    greedy streams as the unshared one: a token's codes depend only on
    its own K/V, whichever request wrote them."""
    cfg, params = model[2], model[3]
    rng = np.random.default_rng(8)
    prefix = [int(t) for t in rng.integers(4, 400, size=21)]
    reqs = [[2] + prefix + [int(t) for t in rng.integers(4, 400, size=n)]
            for n in (5, 3, 7, 4, 6)]
    out = {}
    for share in (False, True):
        eng = InferenceEngine(cfg, params, policy=INT8, max_len=64,
                              max_batch=2, device="cpu")
        done, m = eng.serve_continuous(
            [Request(uid=i, tokens=p, max_new_tokens=5)
             for i, p in enumerate(reqs)], page_size=8, steps_per_sync=3,
            prefix_cache=share)
        out[share] = ([r.result for r in done], m)
    assert out[True][0] == out[False][0]
    assert all(out[False][0])
    m_on, m_off = out[True][1], out[False][1]
    assert m_on.prefix_matched_tokens > 0 and m_on.pages_shared > 0
    assert m_on.cow_copies > 0
    assert m_off.kv_dtype == "int8"


@pytest.mark.parametrize("kind", ["mixed", "shared"])
def test_int8_kv_streams_match_reference(model, kind):  # noqa: F811
    """Reduced qwen3-4b with int8 pools in both packages: the greedy
    streams are equal token for token on both traces."""
    ref, ours, m = serve_both(model, INT8, J_INT8, kind)
    assert m.kv_dtype == "int8"
    assert ours == ref
