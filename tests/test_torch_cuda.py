"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here carries the ``cuda`` marker and skips without a CUDA
device; run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 pools differ from the plain version only in summation
order (1e-4); bf16/fp16 outputs are rounded to the working type by both,
so they may differ by an ulp of it (2e-2 on values of order one).  Over
int8 pools the kernel and the plain version dequantize to the same fp32
values; the plain version then rounds them to q's dtype, which the
bf16/fp16 tolerance covers.  ``quant_matmul`` sums the same fp32 products
as the plain version in another order, so it is held to 1e-5 of the
output's largest magnitude.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_reduced
from repro_torch.core import kv_cache as KV
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.kv_cache import quantize_kv
from repro_torch.core.precision import FP32, map_params
from repro_torch.core.scheduler import Request
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as QM
from repro_torch.kernels import scratch
from repro_torch.models import transformer as T

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pools(rng, ctx, *, Hkv, D, page, npages, dtype, dev):
    P = len(ctx) * npages + 1
    k = torch.from_numpy(rng.normal(size=(P, page, Hkv, D)).astype(
        np.float32)).to(dev, dtype)
    v = torch.from_numpy(rng.normal(size=(P, page, Hkv, D)).astype(
        np.float32)).to(dev, dtype)
    ppos = np.full((P, page), -1, np.int32)
    bt = np.full((len(ctx), npages), -1, np.int32)
    perm = rng.permutation(P - 1)
    nxt = 0
    for b, n in enumerate(ctx):
        used = -(-n // page)
        bt[b, :used] = perm[nxt:nxt + used]
        nxt += used
        for t in range(n):
            ppos[bt[b, t // page], t % page] = t
    return k, v, torch.from_numpy(ppos).to(dev), torch.from_numpy(bt).to(dev)


CASES = [(torch.float32, 16, 16, 64, 16, None, None),
         (torch.bfloat16, 16, 16, 64, 16, None, None),
         (torch.float16, 8, 2, 32, 8, 13, None),
         (torch.bfloat16, 32, 8, 128, 16, 40, 30.0),
         (torch.float32, 4, 4, 256, 32, None, 20.0)]


@pytest.mark.parametrize("dtype,Hq,Hkv,D,page,window,softcap", CASES)
def test_decode_kernel_matches_plain(dev, dtype, Hq, Hkv, D, page, window,
                                     softcap):
    rng = np.random.default_rng(0)
    ctx = [1, 37, 0, 130, 64]
    k, v, ppos, bt = _pools(rng, ctx, Hkv=Hkv, D=D, page=page,
                            npages=-(-max(ctx) // page) + 1, dtype=dtype,
                            dev=dev)
    q = torch.from_numpy(rng.normal(size=(len(ctx), 1, Hq, D)).astype(
        np.float32)).to(dev, dtype)
    q_pos = torch.tensor([[n - 1] for n in ctx], dtype=torch.int32,
                         device=dev)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    n0 = DA.paged_decode_attention.launches
    out = DA.paged_decode_attention(q, k, v, ppos, bt, q_pos, **kw)
    ref = DA.paged_decode_attention_ref(q, k, v, ppos, bt, q_pos, **kw)
    torch.cuda.synchronize()
    assert DA.paged_decode_attention.launches == n0 + 1
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert not out[2].any()                   # a slot with no keys


@pytest.mark.parametrize("dtype,Hq,Hkv,D,page,window,softcap", CASES)
def test_packed_kernel_matches_plain(dev, dtype, Hq, Hkv, D, page, window,
                                     softcap):
    rng = np.random.default_rng(1)
    before, seg = [40, 0, 7, 0], [1, 21, 9, 3]
    k, v, ppos, bt = _pools(rng, [b + s for b, s in zip(before, seg)],
                            Hkv=Hkv, D=D, page=page, npages=6, dtype=dtype,
                            dev=dev)
    T_ = 40
    sid = np.full(T_, -1, np.int32)
    pos = np.full(T_, -1, np.int32)
    starts, t = [], 0
    for s, (b0, ln) in enumerate(zip(before, seg)):
        starts.append(t)
        sid[t:t + ln], pos[t:t + ln] = s, b0 + np.arange(ln)
        t += ln
    meta = DA.packed_meta_table(starts, seg, range(4), T_,
                                T_ // DA.PACKED_BLOCK_Q + 4)
    q = torch.from_numpy(rng.normal(size=(1, T_, Hq, D)).astype(
        np.float32)).to(dev, dtype)
    q_pos = torch.from_numpy(pos[None]).to(dev)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    out = DA.paged_packed_attention(q, k, v, ppos, bt, q_pos,
                                    torch.from_numpy(meta).to(dev), **kw)
    ref = DA.paged_packed_attention_ref(q, k, v, ppos, bt, q_pos,
                                        torch.from_numpy(sid).to(dev), **kw)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert not out[0, t:].any()               # padding lanes are zero


Q8_CASES = [(torch.float32, 32, 8, 128, 16, None, None),
            (torch.bfloat16, 32, 8, 128, 16, None, None),
            (torch.bfloat16, 32, 8, 128, 16, 40, 30.0),
            (torch.float16, 8, 2, 32, 8, 13, None)]


def _q8(k, v):
    (kq, ks), (vq, vs) = quantize_kv(k.float()), quantize_kv(v.float())
    return kq, ks, vq, vs


@pytest.mark.parametrize("dtype,Hq,Hkv,D,page,window,softcap", Q8_CASES)
def test_decode_q8_kernel_matches_plain(dev, dtype, Hq, Hkv, D, page,
                                        window, softcap):
    rng = np.random.default_rng(3)
    ctx = [1, 37, 0, 130, 64]
    k, v, ppos, bt = _pools(rng, ctx, Hkv=Hkv, D=D, page=page,
                            npages=-(-max(ctx) // page) + 1,
                            dtype=torch.float32, dev=dev)
    kq, ks, vq, vs = _q8(k, v)
    q = torch.from_numpy(rng.normal(size=(len(ctx), 1, Hq, D)).astype(
        np.float32)).to(dev, dtype)
    q_pos = torch.tensor([[n - 1] for n in ctx], dtype=torch.int32,
                         device=dev)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    n0 = DA.paged_decode_attention_q8.launches
    out = DA.paged_decode_attention_q8(q, kq, ks, vq, vs, ppos, bt, q_pos,
                                       **kw)
    ref = DA.paged_decode_attention_ref(q, kq, vq, ppos, bt, q_pos,
                                        k_scale=ks, v_scale=vs, **kw)
    torch.cuda.synchronize()
    assert DA.paged_decode_attention_q8.launches == n0 + 1
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert not out[2].any()


@pytest.mark.parametrize("dtype,Hq,Hkv,D,page,window,softcap", Q8_CASES)
def test_packed_q8_kernel_matches_plain(dev, dtype, Hq, Hkv, D, page,
                                        window, softcap):
    rng = np.random.default_rng(4)
    before, seg = [40, 0, 7, 0], [1, 21, 9, 3]
    k, v, ppos, bt = _pools(rng, [b + s for b, s in zip(before, seg)],
                            Hkv=Hkv, D=D, page=page, npages=6,
                            dtype=torch.float32, dev=dev)
    kq, ks, vq, vs = _q8(k, v)
    T_ = 40
    sid = np.full(T_, -1, np.int32)
    pos = np.full(T_, -1, np.int32)
    starts, t = [], 0
    for s, (b0, ln) in enumerate(zip(before, seg)):
        starts.append(t)
        sid[t:t + ln], pos[t:t + ln] = s, b0 + np.arange(ln)
        t += ln
    meta = DA.packed_meta_table(starts, seg, range(4), T_,
                                T_ // DA.PACKED_BLOCK_Q + 4)
    q = torch.from_numpy(rng.normal(size=(1, T_, Hq, D)).astype(
        np.float32)).to(dev, dtype)
    q_pos = torch.from_numpy(pos[None]).to(dev)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    out = DA.paged_packed_attention_q8(q, kq, ks, vq, vs, ppos, bt, q_pos,
                                       torch.from_numpy(meta).to(dev), **kw)
    ref = DA.paged_packed_attention_ref(q, kq, vq, ppos, bt, q_pos,
                                        torch.from_numpy(sid).to(dev),
                                        k_scale=ks, v_scale=vs, **kw)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert not out[0, t:].any()


# quant_matmul's bodies: CUDA cores at fp32, tensor cores at bf16 / fp16
# (the bytes-bound body at M <= 8, the tiled one above), over edge shapes
# and every (M, K, N) of the grid below; products are exact, so only the
# fp32 sums' order differs from the plain version
QM_SHAPES = ([(1, 64, 32), (3, 100, 130), (8, 2560, 1024), (17, 300, 257),
              (40, 9728, 64), (256, 512, 384)]
             + [(M, K, N) for M in (1, 3, 8, 9, 16, 40, 256, 300)
                for K in (100, 1024, 2560, 9728) for N in (130, 1024, 9728)])
QM_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _qmm_inputs(dev, M, K, N, dtype, seed, lead=()):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(*lead, M, K, generator=g, device=dev).to(dtype)
    q = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand(N, generator=g, device=dev) * 0.01
    return x, q, s


def _qmm_check(x, q, s):
    torch.backends.cuda.matmul.allow_tf32 = False
    n0 = QM.quant_matmul.launches
    out = QM.quant_matmul(x, q, s)
    ref = QM.quant_matmul_ref(x, q, s)
    torch.cuda.synchronize()
    assert QM.quant_matmul.launches == n0 + 1
    assert out.dtype == torch.float32 and out.shape == ref.shape
    err = (out - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err
    return out


@pytest.mark.parametrize("dtype", QM_DTYPES)
@pytest.mark.parametrize("M,K,N", QM_SHAPES)
def test_quant_matmul_kernel_matches_plain(dev, M, K, N, dtype):
    _qmm_check(*_qmm_inputs(dev, M, K, N, dtype, M * K + N))


def test_quant_matmul_keeps_lead_dims(dev):
    x = torch.randn(2, 3, 64, device=dev)
    q = torch.randint(-127, 128, (64, 48), dtype=torch.int8, device=dev)
    s = torch.rand(48, device=dev)
    out = ops.quant_matmul(x, q, s)
    assert out.shape == (2, 3, 48)
    torch.testing.assert_close(out, QM.quant_matmul_ref(x, q, s),
                               atol=1e-4, rtol=1e-5)


def test_quant_matmul_wrapper_rejects_bad_inputs(dev):
    x = torch.randn(4, 64, device=dev)
    q = torch.randint(-127, 128, (64, 32), dtype=torch.int8, device=dev)
    s = torch.rand(32, device=dev)
    with pytest.raises(ValueError, match="q int8"):
        QM.quant_matmul(x, q.float(), s)
    with pytest.raises(ValueError, match="q int8"):
        QM.quant_matmul(x.double(), q, s)
    with pytest.raises(ValueError, match="CUDA tensors"):
        QM.quant_matmul(x.cpu(), q, s)
    with pytest.raises(ValueError, match="contiguous"):
        QM.quant_matmul(x.T.contiguous().T, q, s)
    with pytest.raises(ValueError, match="shapes"):
        QM.quant_matmul(x, q, s[:16])


def test_q8_wrapper_rejects_bad_scales(dev):
    q = torch.zeros(2, 1, 4, 16, device=dev)
    pool = torch.zeros(5, 8, 2, 16, dtype=torch.int8, device=dev)
    sc = torch.zeros(5, 8, 2, device=dev)
    ppos = torch.full((5, 8), -1, dtype=torch.int32, device=dev)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    qp = torch.zeros(2, 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="scale"):
        DA.paged_decode_attention_q8(q, pool, sc.half(), pool, sc, ppos, bt,
                                     qp, window=None, scale=1.0)
    with pytest.raises(ValueError, match="dtypes"):
        DA.paged_decode_attention_q8(q, pool.float(), sc, pool.float(), sc,
                                     ppos, bt, qp, window=None, scale=1.0)


def test_wrapper_rejects_unsupported_shapes(dev):
    q = torch.zeros(2, 1, 4, 12, device=dev)            # D not a multiple of 8
    pool = torch.zeros(5, 8, 4, 12, device=dev)
    ppos = torch.full((5, 8), -1, dtype=torch.int32, device=dev)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    qp = torch.zeros(2, 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiples of 8"):
        DA.paged_decode_attention(q, pool, pool, ppos, bt, qp, window=None,
                                  scale=1.0)
    with pytest.raises(ValueError, match="dtypes"):
        DA.paged_decode_attention(q.half(), pool, pool, ppos, bt, qp,
                                  window=None, scale=1.0)


def _mixed_inputs(rng, *, W, n_q, before, Hq, Hkv, D, page, dtype, dev):
    """Row b holds ``n_q[b]`` real lanes at positions before[b] ..; the
    window's own K/V are already in the pool; other lanes are padding."""
    npages = -(-(max(before) + W) // page) + 1
    k, v, ppos, bt = _pools(rng, [b + n for b, n in zip(before, n_q)],
                            Hkv=Hkv, D=D, page=page, npages=npages,
                            dtype=dtype, dev=dev)
    pos = np.full((len(n_q), W), -1, np.int32)
    for r, (b0, n) in enumerate(zip(before, n_q)):
        pos[r, :n] = b0 + np.arange(n)
    q = torch.from_numpy(rng.normal(size=(len(n_q), W, Hq, D)).astype(
        np.float32)).to(dev, dtype)
    return q, k, v, ppos, bt, torch.from_numpy(pos).to(dev)


# (W, n_q, before): a verify window of k + 1 = 5 over five slots (one
# idle, one cut short), and a prefill chunk in a (1, W-bucket) row
MIXED_SHAPES = [(5, [5, 5, 0, 3, 5], [10, 37, 0, 130, 64]),
                (64, [45], [21])]


@pytest.mark.parametrize("W,n_q,before", MIXED_SHAPES)
@pytest.mark.parametrize("dtype,Hq,Hkv,D,page,window,softcap", CASES)
def test_mixed_kernel_matches_plain(dev, dtype, Hq, Hkv, D, page, window,
                                    softcap, W, n_q, before):
    rng = np.random.default_rng(7)
    q, k, v, ppos, bt, q_pos = _mixed_inputs(
        rng, W=W, n_q=n_q, before=before, Hq=Hq, Hkv=Hkv, D=D, page=page,
        dtype=dtype, dev=dev)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    n0 = DA.paged_mixed_attention.launches
    out = DA.paged_mixed_attention(q, k, v, ppos, bt, q_pos, **kw)
    ref = DA.paged_mixed_attention_ref(q, k, v, ppos, bt, q_pos, **kw)
    torch.cuda.synchronize()
    assert DA.paged_mixed_attention.launches == n0 + 1
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    for r, n in enumerate(n_q):
        assert not out[r, n:].any()           # padding lanes are zero


@pytest.mark.parametrize("W,n_q,before", MIXED_SHAPES)
@pytest.mark.parametrize("dtype,Hq,Hkv,D,page,window,softcap", Q8_CASES)
def test_mixed_q8_kernel_matches_plain(dev, dtype, Hq, Hkv, D, page,
                                       window, softcap, W, n_q, before):
    rng = np.random.default_rng(8)
    q, k, v, ppos, bt, q_pos = _mixed_inputs(
        rng, W=W, n_q=n_q, before=before, Hq=Hq, Hkv=Hkv, D=D, page=page,
        dtype=torch.float32, dev=dev)
    q = q.to(dtype)
    kq, ks, vq, vs = _q8(k, v)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    out = DA.paged_mixed_attention_q8(q, kq, ks, vq, vs, ppos, bt, q_pos,
                                      **kw)
    ref = DA.paged_mixed_attention_ref(q, kq, vq, ppos, bt, q_pos,
                                       k_scale=ks, v_scale=vs, **kw)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    for r, n in enumerate(n_q):
        assert not out[r, n:].any()


# dtype, B, Sq, Sk, Hq, Hkv, D, window, softcap: Sq and Sk off the 32-row
# tile, GQA, a window, a softcap, D up to 256
FLASH_CASES = [(torch.float32, 2, 37, 37, 4, 4, 64, None, None),
               (torch.bfloat16, 3, 70, 70, 8, 2, 128, None, None),
               (torch.float16, 2, 45, 61, 4, 1, 32, 16, 30.0),
               (torch.float32, 1, 20, 100, 2, 2, 256, 40, None),
               (torch.bfloat16, 2, 1, 9, 4, 2, 64, None, 20.0)]


def _flash_inputs(rng, B, Sq, Sk, Hq, Hkv, D, dtype, dev):
    """Right-padded rows (-1 positions past each row's length), queries
    at the tail of the keys' positions, one row wholly invalid."""
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev, dtype)
    q, k, v = t(B, Sq, Hq, D), t(B, Sk, Hkv, D), t(B, Sk, Hkv, D)
    k_pos = np.full((B, Sk), -1, np.int32)
    q_pos = np.full((B, Sq), -1, np.int32)
    for b in range(B - 1 if B > 1 else B):
        n = int(rng.integers(max(1, Sk // 2), Sk + 1))
        k_pos[b, :n] = np.arange(n)
        nq = min(Sq, n)
        q_pos[b, :nq] = np.arange(n - nq, n)
    return (q, k, v, torch.from_numpy(q_pos).to(dev),
            torch.from_numpy(k_pos).to(dev))


@pytest.mark.parametrize("dtype,B,Sq,Sk,Hq,Hkv,D,window,softcap",
                         FLASH_CASES)
def test_flash_kernel_matches_plain(dev, dtype, B, Sq, Sk, Hq, Hkv, D,
                                    window, softcap):
    rng = np.random.default_rng(9)
    q, k, v, q_pos, k_pos = _flash_inputs(rng, B, Sq, Sk, Hq, Hkv, D,
                                          dtype, dev)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    n0 = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v, q_pos, k_pos, **kw)
    ref = FA.flash_attention_ref(q, k, v, q_pos, k_pos, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == n0 + 1
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert not out[(q_pos < 0)].any()         # invalid rows are zero


def test_mixed_and_flash_wrappers_reject_bad_inputs(dev):
    q = torch.zeros(2, 3, 4, 16, device=dev)
    pool = torch.zeros(5, 8, 2, 16, device=dev)
    ppos = torch.full((5, 8), -1, dtype=torch.int32, device=dev)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    qp = torch.zeros(2, 3, dtype=torch.int32, device=dev)
    kw = dict(window=None, scale=1.0)
    with pytest.raises(ValueError, match="q_pos"):
        DA.paged_mixed_attention(q, pool, pool, ppos, bt,
                                 qp[:, :2].contiguous(), **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        DA.paged_mixed_attention(q.cpu(), pool, pool, ppos, bt, qp, **kw)
    with pytest.raises(ValueError, match="scale"):
        DA.paged_mixed_attention_q8(q, pool.to(torch.int8), ppos.float(),
                                    pool.to(torch.int8), ppos.float(), ppos,
                                    bt, qp, **kw)
    k = torch.zeros(2, 5, 2, 16, device=dev)
    kp = torch.zeros(2, 5, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="CUDA tensors"):
        FA.flash_attention(q.cpu(), k, k, qp, kp, **kw)
    with pytest.raises(ValueError, match="share one"):
        FA.flash_attention(q.half(), k, k, qp, kp, **kw)
    with pytest.raises(ValueError, match="int32"):
        FA.flash_attention(q, k, k, qp.long(), kp, **kw)
    with pytest.raises(ValueError, match="shapes"):
        FA.flash_attention(q, k, k, qp, kp[:, :4].contiguous(), **kw)
    with pytest.raises(ValueError, match="multiples of 8"):
        FA.flash_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                           k[..., :12].contiguous(), qp, kp, **kw)


# The tensor-core bodies (bf16 / fp16): flash and the mixed pair over head
# dims 32..256 and one D = 40 (not a multiple of 16, zero-padded in shared
# memory), GQA groups g = 1, 4, 8, windows of 1, 5, 24 (ragged) and 256
# lanes, pools at q's dtype and int8.
MMA_DTYPES = [torch.bfloat16, torch.float16]
MMA_DIMS = [32, 40, 64, 128, 256]


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("D", MMA_DIMS)
@pytest.mark.parametrize("dtype", MMA_DTYPES)
def test_flash_mma_matches_plain(dev, dtype, D, g):
    rng = np.random.default_rng(20 + D + g)
    q, k, v, q_pos, k_pos = _flash_inputs(rng, 3, 70, 75, 2 * g, 2, D,
                                          dtype, dev)
    kw = dict(window=None, scale=D ** -0.5, attn_softcap=None)
    out = FA.flash_attention(q, k, v, q_pos, k_pos, **kw)
    ref = FA.flash_attention_ref(q, k, v, q_pos, k_pos, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert not out[(q_pos < 0)].any()         # invalid rows are zero


@pytest.mark.parametrize("dtype", MMA_DTYPES)
def test_flash_mma_window_softcap_and_split_dv(dev, dtype):
    rng = np.random.default_rng(31)
    q, k, v, q_pos, k_pos = _flash_inputs(rng, 2, 100, 100, 8, 2, 64,
                                          dtype, dev)
    v = torch.from_numpy(rng.normal(size=(2, 100, 2, 40)).astype(
        np.float32)).to(dev, dtype)           # Dv 40 beside D 64
    for kw in (dict(window=24, attn_softcap=30.0), dict(window=7),
               dict(attn_softcap=5.0)):
        kw = dict(dict(window=None, attn_softcap=None), **kw,
                  scale=64 ** -0.5)
        out = FA.flash_attention(q, k, v, q_pos, k_pos, **kw)
        ref = FA.flash_attention_ref(q, k, v, q_pos, k_pos, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        assert not out[(q_pos < 0)].any()


# (W, n_q, before): one-token windows, the k + 1 = 5 verify window, a
# ragged 24-lane window (one row all padding) and a 256-lane chunk
MMA_MIXED_SHAPES = [(1, [1, 1, 0], [10, 70, 3]),
                    (5, [5, 5, 0, 3, 5], [10, 37, 0, 130, 64]),
                    (24, [24, 0, 17, 1], [3, 0, 100, 40]),
                    (256, [230], [20])]


def _mixed_call(q, k, v, ppos, bt, q_pos, quant, **kw):
    """The mixed kernel and its plain version over a pool at q's dtype, or
    over the int8 codes of the same K/V (``quant``)."""
    if quant:
        kq, ks, vq, vs = _q8(k, v)
        n0 = DA.paged_mixed_attention_q8.launches
        out = DA.paged_mixed_attention_q8(q, kq, ks, vq, vs, ppos, bt, q_pos,
                                          **kw)
        assert DA.paged_mixed_attention_q8.launches == n0 + 1
        ref = DA.paged_mixed_attention_ref(q, kq, vq, ppos, bt, q_pos,
                                           k_scale=ks, v_scale=vs, **kw)
    else:
        n0 = DA.paged_mixed_attention.launches
        out = DA.paged_mixed_attention(q, k, v, ppos, bt, q_pos, **kw)
        assert DA.paged_mixed_attention.launches == n0 + 1
        ref = DA.paged_mixed_attention_ref(q, k, v, ppos, bt, q_pos, **kw)
    torch.cuda.synchronize()
    return out, ref


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("W,n_q,before", MMA_MIXED_SHAPES)
@pytest.mark.parametrize("D", MMA_DIMS)
@pytest.mark.parametrize("dtype", MMA_DTYPES)
def test_mixed_mma_matches_plain(dev, dtype, D, W, n_q, before, quant):
    rng = np.random.default_rng(40 + D + W)
    q, k, v, ppos, bt, q_pos = _mixed_inputs(
        rng, W=W, n_q=n_q, before=before, Hq=8, Hkv=2, D=D, page=16,
        dtype=dtype, dev=dev)
    out, ref = _mixed_call(q, k, v, ppos, bt, q_pos, quant, window=None,
                           scale=D ** -0.5, attn_softcap=None)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    for r, n in enumerate(n_q):
        assert not out[r, n:].any()           # padding lanes are zero


def _split_case(rng, case, dtype, dev):
    """The split-K edges, each at a shape where the page walk is split
    (few blocks): a context of one page; unallocated pages between
    allocated ones; a slot whose every lane is padding; a slot with far
    fewer pages than splits (most splits see only unallocated pages);
    window + softcap across split boundaries."""
    kw = dict(window=None, scale=64 ** -0.5, attn_softcap=None)
    if case == "one page":
        W, n_q, before = 5, [5], [3]
    elif case == "holes":
        W, n_q, before = 5, [5, 5], [150, 90]
    elif case == "all padding":
        W, n_q, before = 5, [5, 0, 4], [40, 60, 100]
    elif case == "more splits than pages":
        W, n_q, before = 5, [5], [2]
    else:
        W, n_q, before = 24, [24, 9], [200, 31]
        kw.update(window=40, attn_softcap=30.0)
    q, k, v, ppos, bt, q_pos = _mixed_inputs(
        rng, W=W, n_q=n_q, before=before, Hq=4, Hkv=1, D=64, page=16,
        dtype=dtype, dev=dev)
    if case == "holes":                       # pages 1 and 4 unallocated
        bt[:, 1] = -1
        bt[0, 4] = -1
    if case == "more splits than pages":      # a 32-page table, one used
        bt = torch.cat([bt, torch.full((1, 30), -1, dtype=torch.int32,
                                       device=dev)], 1)
    return q, k, v, ppos, bt, q_pos, n_q, kw


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("case", ["one page", "holes", "all padding",
                                  "more splits than pages",
                                  "window + softcap"])
@pytest.mark.parametrize("dtype", MMA_DTYPES)
def test_mixed_mma_split_edges(dev, dtype, case, quant):
    rng = np.random.default_rng(50)
    q, k, v, ppos, bt, q_pos, n_q, kw = _split_case(rng, case, dtype, dev)
    B, W = q_pos.shape
    splits, _ = DA.mixed_splits(B, DA.mixed_row_tiles(W, 4), 1,
                                bt.shape[1], scratch.sm_count(dev.index or 0))
    assert splits > 1 or bt.shape[1] == 1
    out, ref = _mixed_call(q, k, v, ppos, bt, q_pos, quant, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    for r, n in enumerate(n_q):
        assert not out[r, n:].any()           # exactly zero
    # a second launch finds the arrival counters reset
    again, _ = _mixed_call(q, k, v, ppos, bt, q_pos, quant, **kw)
    assert torch.equal(again, out)


# -- quant_matmul at the tied head, with zero scales and lead dims, and
# at the split-K edges


@pytest.mark.parametrize("dtype", QM_DTYPES)
def test_quant_matmul_tied_head(dev, dtype):
    _qmm_check(*_qmm_inputs(dev, 8, 2560, 151936, dtype, 11))


@pytest.mark.parametrize("M", [3, 8, 40])
@pytest.mark.parametrize("dtype", QM_DTYPES)
def test_quant_matmul_zero_scale_column_and_lead_dims(dev, dtype, M):
    x, q, s = _qmm_inputs(dev, M, 1024, 1024, dtype, 13, lead=(2,))
    s[5] = 0.0
    out = _qmm_check(x, q, s)
    assert out.shape == (2, M, 1024)
    assert not out[..., 5].any()              # exactly zero


# (M, K, N): K under one 64-row tile, exactly one, one row into a second;
# far more K splits than output tiles (2 column tiles, 16 splits)
QMM_SPLIT_EDGES = [(8, 40, 1024), (8, 64, 1024), (8, 65, 1024),
                   (8, 2560, 130), (40, 2560, 130), (1, 9728, 16),
                   (17, 40, 130)]


@pytest.mark.parametrize("M,K,N", QMM_SPLIT_EDGES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_quant_matmul_split_edges(dev, dtype, M, K, N):
    x, q, s = _qmm_inputs(dev, M, K, N, dtype, 17)
    plan = QM.qmm_plan(M, K, N, dtype, scratch.sm_count(dev.index or 0))
    if K >= 2 * QM.MMA_K_TILE and N <= 130:
        assert plan.splits > plan.tiles
    out = _qmm_check(x, q, s)
    # deterministic: the splits are added in order, the counters reset
    assert torch.equal(QM.quant_matmul(x, q, s), out)


def test_quant_matmul_launcher_refuses_other_bodies(dev):
    """The C launcher checks the plan: no bf16/fp16 shape reaches the
    CUDA-core body, fp32 never reaches the tensor cores, and splits must
    cover K."""
    from repro_torch.kernels import build
    lib = build.load()
    x, q, s = _qmm_inputs(dev, 8, 256, 128, torch.bfloat16, 19)
    out = torch.empty(8, 128, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(xx, dtype_code, body, splits, kps):
        return lib.quant_matmul_launch(
            xx.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), None,
            None, dtype_code, 8, 256, 128, body, splits, kps, stream)
    assert launch(x, 2, 1, 1, 256) == 0       # the plan's own body
    assert launch(x, 2, 0, 1, 256) != 0       # bf16 on CUDA cores
    assert launch(x, 2, 2, 1, 256) != 0       # M = 8 on the tiled body
    assert launch(x.float(), 0, 1, 1, 256) != 0   # fp32 on tensor cores
    assert launch(x, 2, 1, 1, 128) != 0       # one split short of K
    assert launch(x, 2, 1, 2, 64) != 0        # two splits short of K
    torch.cuda.synchronize()


# -- the paged decode kernels on the tensor-core core (bf16 / fp16 q): one
# query lane, g rows of a kv head per block, the page walk split


def _decode_call(q, k, v, ppos, bt, q_pos, quant, **kw):
    """The decode kernel and its plain version over a pool at q's dtype,
    or over the int8 codes of the same K/V (``quant``)."""
    if quant:
        kq, ks, vq, vs = _q8(k, v)
        n0 = DA.paged_decode_attention_q8.launches
        out = DA.paged_decode_attention_q8(q, kq, ks, vq, vs, ppos, bt,
                                           q_pos, **kw)
        assert DA.paged_decode_attention_q8.launches == n0 + 1
        ref = DA.paged_decode_attention_ref(q, kq, vq, ppos, bt, q_pos,
                                            k_scale=ks, v_scale=vs, **kw)
    else:
        n0 = DA.paged_decode_attention.launches
        out = DA.paged_decode_attention(q, k, v, ppos, bt, q_pos, **kw)
        assert DA.paged_decode_attention.launches == n0 + 1
        ref = DA.paged_decode_attention_ref(q, k, v, ppos, bt, q_pos, **kw)
    torch.cuda.synchronize()
    return out, ref


def _decode_inputs(rng, ctx, *, g, Hkv, D, dtype, dev, npages=None,
                   page=16):
    npages = npages or -(-max(ctx) // page) + 1
    k, v, ppos, bt = _pools(rng, ctx, Hkv=Hkv, D=D, page=page,
                            npages=npages, dtype=dtype, dev=dev)
    q = torch.from_numpy(rng.normal(size=(len(ctx), 1, g * Hkv, D)).astype(
        np.float32)).to(dev, dtype)
    q_pos = torch.tensor([[n - 1] for n in ctx], dtype=torch.int32,
                         device=dev)
    return q, k, v, ppos, bt, q_pos


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("D", [40, 64, 128, 256])
@pytest.mark.parametrize("dtype", MMA_DTYPES)
def test_decode_mma_matches_plain(dev, dtype, D, g, quant):
    rng = np.random.default_rng(60 + D + g)
    ctx = [1, 37, 0, 130, 64]                 # slot 2 sees no key
    q, k, v, ppos, bt, q_pos = _decode_inputs(rng, ctx, g=g, Hkv=2, D=D,
                                              dtype=dtype, dev=dev)
    out, ref = _decode_call(q, k, v, ppos, bt, q_pos, quant, window=None,
                            scale=D ** -0.5, attn_softcap=None)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert not out[2].any()                   # exactly zero


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("case", ["window + softcap", "one page", "holes",
                                  "no visible key",
                                  "more splits than pages"])
@pytest.mark.parametrize("dtype", MMA_DTYPES)
def test_decode_mma_split_edges(dev, dtype, case, quant):
    """Split-K edges of the decode body, each at a shape where the page
    walk is split: window + softcap across split boundaries, a context of
    one page, unallocated (-1) pages between allocated ones, a slot whose
    query sees no key (position -1, and a window past every key), a
    32-page table with one page used."""
    rng = np.random.default_rng(70)
    kw = dict(window=None, scale=64 ** -0.5, attn_softcap=None)
    ctx, npages = [200, 31, 150], None
    if case == "window + softcap":
        kw.update(window=40, attn_softcap=30.0)
    elif case == "one page":
        ctx = [5, 16, 9]
    elif case == "more splits than pages":
        ctx, npages = [3, 12, 7], 32
    q, k, v, ppos, bt, q_pos = _decode_inputs(rng, ctx, g=4, Hkv=1, D=64,
                                              dtype=dtype, dev=dev,
                                              npages=npages)
    if case == "holes":                       # pages 1 and 4 unallocated
        bt[:, 1] = -1
        bt[0, 4] = -1
    if case == "no visible key":
        q_pos[1, 0] = -1
        ppos[bt[2][bt[2] >= 0].long()] = -1   # slot 2's keys all unwritten
    splits, _ = DA.mixed_splits(len(ctx), 1, 1, bt.shape[1],
                                scratch.sm_count(dev.index or 0))
    assert splits > 1
    out, ref = _decode_call(q, k, v, ppos, bt, q_pos, quant, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if case == "no visible key":
        assert not out[1:].any()              # exactly zero
    again, _ = _decode_call(q, k, v, ppos, bt, q_pos, quant, **kw)
    assert torch.equal(again, out)            # counters were reset


def test_split_launches_on_two_streams(dev):
    """Split decode, split mixed, split packed and split quant_matmul
    launches in flight at once on four streams: each stream has its own
    scratch and arrival counters, so every output equals the plain
    version's."""
    rng = np.random.default_rng(80)
    dtype = torch.bfloat16
    ctx = [100, 37, 250, 5, 64, 180]
    k, v, ppos, bt = _pools(rng, ctx, Hkv=2, D=128, page=16, npages=17,
                            dtype=dtype, dev=dev)
    qd = torch.from_numpy(rng.normal(size=(6, 1, 8, 128)).astype(
        np.float32)).to(dev, dtype)
    qpd = torch.tensor([[n - 1] for n in ctx], dtype=torch.int32,
                       device=dev)
    qm = torch.from_numpy(rng.normal(size=(6, 5, 8, 128)).astype(
        np.float32)).to(dev, dtype)
    qpm = torch.tensor([[n - 5 + i for i in range(5)] for n in ctx],
                       dtype=torch.int32, device=dev)
    kw = dict(window=None, scale=128 ** -0.5, attn_softcap=None)
    x, q8, s8 = _qmm_inputs(dev, 8, 2560, 1024, dtype, 23)
    qpp, sid, meta, _ = _packed_stream(ctx, [1, 1, 20, 5, 1, 30], 64, dev)
    qp = torch.from_numpy(rng.normal(size=(1, 64, 8, 128)).astype(
        np.float32)).to(dev, dtype)
    sm = scratch.sm_count(dev.index or 0)
    assert DA.mixed_splits(6, 1, 2, 17, sm)[0] > 1
    assert DA.packed_plan(meta.shape[0], 2, 4, 17, dtype, sm).splits > 1
    assert QM.qmm_plan(8, 2560, 1024, dtype, sm).splits > 1
    ref_d = DA.paged_decode_attention_ref(qd, k, v, ppos, bt, qpd, **kw)
    ref_m = DA.paged_mixed_attention_ref(qm, k, v, ppos, bt, qpm, **kw)
    ref_p = DA.paged_packed_attention_ref(qp, k, v, ppos, bt, qpp, sid,
                                          **kw)
    ref_q = QM.quant_matmul_ref(x, q8, s8)
    streams = [torch.cuda.Stream() for _ in range(4)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(20):
        with torch.cuda.stream(streams[0]):
            od = DA.paged_decode_attention(qd, k, v, ppos, bt, qpd, **kw)
        with torch.cuda.stream(streams[1]):
            om = DA.paged_mixed_attention(qm, k, v, ppos, bt, qpm, **kw)
        with torch.cuda.stream(streams[2]):
            oq = QM.quant_matmul(x, q8, s8)
        with torch.cuda.stream(streams[3]):
            op = DA.paged_packed_attention(qp, k, v, ppos, bt, qpp, meta,
                                           **kw)
        outs.append((od, om, oq, op))
    torch.cuda.synchronize()
    for od, om, oq, op in outs:
        torch.testing.assert_close(op.float(), ref_p.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        torch.testing.assert_close(od.float(), ref_d.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        torch.testing.assert_close(om.float(), ref_m.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        assert (oq - ref_q).abs().max().item() <= \
            1e-5 * ref_q.abs().max().item()


def test_mma_wrappers_reject_misaligned_inputs(dev):
    buf = torch.zeros(2 * 3 * 4 * 16 + 1, dtype=torch.bfloat16, device=dev)
    q = buf[1:].view(2, 3, 4, 16)             # 2 bytes off 16-byte alignment
    pool = torch.zeros(5, 8, 2, 16, dtype=torch.bfloat16, device=dev)
    ppos = torch.full((5, 8), -1, dtype=torch.int32, device=dev)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    qp = torch.zeros(2, 3, dtype=torch.int32, device=dev)
    kw = dict(window=None, scale=1.0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        DA.paged_mixed_attention(q, pool, pool, ppos, bt, qp, **kw)
    k = torch.zeros(2, 5, 2, 16, dtype=torch.bfloat16, device=dev)
    kp = torch.zeros(2, 5, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.flash_attention(q, k, k, qp, kp, **kw)


def test_serve_on_card_matches_cpu(dev):
    """Reduced unimo-text, fp32, greedy: the card's serve (through both
    kernels) gives the CPU's token streams, and every attention call of
    the card's run was a kernel launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("unimo-text")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    rng = np.random.default_rng(2)
    prompts = [[2] + [int(t) for t in rng.integers(4, 400, size=n)]
               for n in (19, 30, 11, 23)]
    prompts += [prompts[0][:12] + [5, 6, 7], prompts[2][:9] + [8, 9]]
    out = {}
    for d in ("cpu", "cuda"):
        eng = InferenceEngine(cfg, params, policy=FP32, max_len=64,
                              max_batch=3, device=d)
        DA.reset_launch_counts()
        done, m = eng.serve_continuous(
            [Request(uid=i, tokens=p, max_new_tokens=10)
             for i, p in enumerate(prompts)],
            page_size=8, max_batched_tokens=24)
        out[d] = [r.result for r in done]
    assert out["cuda"] == out["cpu"]
    counts = DA.launch_counts()
    assert counts["paged_packed_attention"] == 2 * m.mixed_dispatches > 0
    assert counts["paged_decode_attention"] == \
        2 * (m.steps - m.mixed_dispatches) > 0


@pytest.mark.parametrize("kv_dtype,weights_dtype",
                         [("auto", "auto"), ("int8", "int8")])
def test_qwen3_serve_on_card(dev, kv_dtype, weights_dtype):
    """Reduced qwen3-4b, fp32, greedy: at (auto, auto) the card's streams
    equal the CPU's; at (int8, int8) every attention call went to the
    _q8 kernels and every dense matmul to quant_matmul (the streams may
    part where a K/V code rounds the other way on the card)."""
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("qwen3-4b")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    policy = dataclasses.replace(FP32, kv_dtype=kv_dtype,
                                 weights_dtype=weights_dtype)
    rng = np.random.default_rng(6)
    prompts = [[2] + [int(t) for t in rng.integers(4, 500, size=n)]
               for n in (19, 30, 11, 23)]
    prompts += [prompts[0][:12] + [5, 6, 7]]
    out = {}
    for d in ("cpu", "cuda"):
        eng = InferenceEngine(cfg, params, policy=policy, max_len=64,
                              max_batch=3, device=d)
        ops.reset_launch_counts()
        done, m = eng.serve_continuous(
            [Request(uid=i, tokens=p, max_new_tokens=8)
             for i, p in enumerate(prompts)],
            page_size=8, max_batched_tokens=24)
        out[d] = [r.result for r in done]
    counts = ops.launch_counts()
    decode_steps = m.steps - m.mixed_dispatches
    q8 = "_q8" if kv_dtype == "int8" else ""
    assert counts["paged_packed_attention" + q8] == 2 * m.mixed_dispatches
    assert counts["paged_decode_attention" + q8] == 2 * decode_steps
    n_mm = 7 * 2 + 1 if weights_dtype == "int8" else 0
    assert counts["quant_matmul"] == n_mm * (m.mixed_dispatches
                                             + decode_steps)
    assert all(r and all(0 <= t < cfg.vocab_size for t in r)
               for r in out["cuda"])
    if kv_dtype == "auto":
        assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("mode", ["ngram", "draft_model", "packed_off"])
def test_spec_and_packed_off_serves_on_card(dev, mode):
    """Reduced qwen3-4b, fp32, greedy: the card's speculative serves
    (n-gram, self-drafting) and its ``packed=False`` serve give the CPU's
    streams, and the card's run launched exactly the kernels of its path:
    the mixed kernel once per layer and verify step or chunk, flash once
    per layer and draft forward."""
    from repro_torch.core.speculative import SpecConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("qwen3-4b")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    rng = np.random.default_rng(6)
    prompts = [[2] + [int(t) for t in rng.integers(4, 500, size=n)]
               for n in (19, 30, 11, 23)]
    prompts += [prompts[0][:12] + [5, 6, 7]]
    spec = None if mode == "packed_off" else SpecConfig(k=3, drafter=mode)
    out, drafts = {}, 0
    for d in ("cpu", "cuda"):
        eng = InferenceEngine(cfg, params, policy=FP32, max_len=64,
                              max_batch=3, device=d)
        ops.reset_launch_counts()
        done, m = eng.serve_continuous(
            [Request(uid=i, tokens=p, max_new_tokens=8)
             for i, p in enumerate(prompts)], page_size=8,
            max_batched_tokens=24, spec=spec, packed=mode != "packed_off")
        out[d] = [r.result for r in done]
        if spec is not None and spec.drafter == "draft_model":
            drafts = eng.drafter.calls
    assert out["cuda"] == out["cpu"]
    counts = ops.launch_counts()
    L = cfg.num_layers
    if mode == "packed_off":
        assert counts["paged_packed_attention"] == 0
        assert counts["paged_mixed_attention"] == L * m.prefill_chunks > 0
        assert counts["paged_decode_attention"] == L * m.steps > 0
    else:
        verify_steps = m.steps - m.mixed_iters
        assert counts["paged_mixed_attention"] == L * verify_steps > 0
        assert counts["paged_packed_attention"] == L * m.mixed_iters > 0
        assert counts["paged_decode_attention"] == 0
        assert counts["flash_attention"] == L * 3 * drafts
        assert (drafts > 0) == (mode == "draft_model")


# -- the mLSTM, RMSNorm and dense decode kernels ----------------------------
# mlstm_chunked: the kernel's 32-step chunks against the plain version's
# 128 (the result does not depend on the chunk length beyond rounding).
# h divides by a denominator that passes near zero for random inputs, so
# it is held to 1e-4 of its largest magnitude; the state C, n, m to 1e-5
# of theirs; bf16 q/k/v are read exactly by both, so the same bounds hold,
# and the tensor-core body's bf16 parts of its fp32 operands are chosen to
# keep within a quarter of them (tests/test_torch_mlstm_plan.py).


def _mlstm_inputs(rng, B, S, H, dh, dtype, dev, state=True):
    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)
    q, k, v = (rng.normal(size=(B, S, H, dh)) for _ in range(3))
    i_pre = rng.normal(size=(B, S, H))
    logf = -np.log1p(np.exp(-(rng.normal(size=(B, S, H)) + 2)))
    state = {"C": t(rng.normal(size=(B, H, dh, dh)) * 0.1 * state),
             "n": t(np.abs(rng.normal(size=(B, H, dh))) * state),
             "m": t(rng.normal(size=(B, H)) * state)}
    return (t(q, dtype), t(k * dh ** -0.5, dtype), t(v, dtype), t(i_pre),
            t(logf)), state


def _assert_mlstm_close(out, ref_out):
    (h, st), (h_r, st_r) = out, ref_out
    for a, b, rel in [(h, h_r, 1e-4)] + [(st[n], st_r[n], 1e-5)
                                          for n in ("C", "n", "m")]:
        assert a.shape == b.shape and a.dtype == torch.float32
        scale = max(b.abs().max().item(), 1.0)
        assert (a - b).abs().max().item() <= rel * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,dh", [(2, 300, 4, 384), (1, 64, 4, 384),
                                      (3, 37, 2, 128), (2, 5, 3, 72),
                                      (1, 1, 1, 8)])
def test_mlstm_kernel_matches_plain(dev, B, S, H, dh, dtype):
    from repro_torch.kernels import mlstm_chunk as MC
    rng = np.random.default_rng(S)
    args, state = _mlstm_inputs(rng, B, S, H, dh, dtype, dev)
    before = MC.mlstm_chunked.launches
    out = ops.mlstm_chunked(*args, state)
    assert MC.mlstm_chunked.launches == before + 1
    torch.cuda.synchronize()
    _assert_mlstm_close(out, MC.mlstm_chunked_ref(*args, state))


def test_mlstm_wrapper_rejects_bad_inputs(dev):
    from repro_torch.kernels import mlstm_chunk as MC
    rng = np.random.default_rng(0)
    (q, k, v, i_pre, logf), st = _mlstm_inputs(rng, 1, 8, 2, 16,
                                                torch.float32, dev)
    with pytest.raises(ValueError, match="fp32"):
        MC.mlstm_chunked(q, k, v, i_pre.half(), logf, st)
    with pytest.raises(ValueError, match="contiguous"):
        MC.mlstm_chunked(q.transpose(1, 2), k, v, i_pre, logf, st)
    with pytest.raises(ValueError, match="shapes"):
        MC.mlstm_chunked(q, k, v, i_pre, logf, {**st, "m": st["m"][:, :1]})
    big = torch.zeros(1, 2, 1, 1024, device=dev)
    gates = torch.zeros(1, 2, 1, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        MC.mlstm_chunked(big, big, big, gates, gates,
                         {"C": torch.zeros(1, 1, 1024, 1024, device=dev),
                          "n": torch.zeros(1, 1, 1024, device=dev),
                          "m": torch.zeros(1, 1, device=dev)})


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dh", [128, 384])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 64, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_mlstm_body_by_dtype_matches_plain(dev, dtype, S, dh, state):
    """Every dtype runs the tensor-core body (fp16 / fp32 as bf16 parts):
    each to the gates, from a zero and a nonzero state, over ragged
    chunks."""
    from repro_torch.kernels import mlstm_chunk as MC
    rng = np.random.default_rng(S + dh + state)
    args, st = _mlstm_inputs(rng, 2, S, 4, dh, dtype, dev, state)
    out = MC.mlstm_chunked(*args, st)
    torch.cuda.synchronize()
    _assert_mlstm_close(out, MC.mlstm_chunked_ref(*args, st))


def _device_kernels(fn):
    """Names of the device kernels one call of ``fn`` launches (a profile
    that catches no device event is taken again)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            return names
    raise AssertionError("the profiler caught no device kernel")


def test_mlstm_bodies_in_the_profile(dev):
    """xlstm-125m's width at every dtype: the tensor-core body's instance
    of q's type; a head dim off 8: the CUDA-core body."""
    from repro_torch.kernels import mlstm_chunk as MC
    rng = np.random.default_rng(3)
    for dtype, dh, body in [
            (torch.bfloat16, 384, "mlstm_chunk_mma_kernel<__nv_bfloat16"),
            (torch.float16, 384, "mlstm_chunk_mma_kernel<__half"),
            (torch.float32, 384, "mlstm_chunk_mma_kernel<float"),
            (torch.float32, 20, "mlstm_chunk_kernel<float")]:
        args, st = _mlstm_inputs(rng, 2, 40, 4, dh, dtype, dev)
        names = _device_kernels(lambda: MC.mlstm_chunked(*args, st))
        ours = [n for n in names if "mlstm_chunk_" in n]
        assert len(ours) == 1 and body in ours[0], (dtype, dh, names)


def test_mlstm_launcher_refuses_a_bad_plan(dev):
    """The C launcher checks the plan: te a multiple of 16 within the
    block's warps, q/k/v 16-byte aligned on the tensor cores (every dtype
    there), known bodies and dtypes."""
    from repro_torch.kernels import build
    rng = np.random.default_rng(4)
    B, S, H, dh = 1, 8, 2, 64
    (q, k, v, i_pre, logf), st = _mlstm_inputs(rng, B, S, H, dh,
                                                torch.bfloat16, dev)
    lib = build.load()
    h = torch.empty(B, S, H, dh, device=dev)
    C, n, m = (torch.empty_like(t) for t in (st["C"], st["n"], st["m"]))
    stream = torch.cuda.current_stream().cuda_stream

    def launch(xs, code, body, te):
        return lib.mlstm_chunk_launch(
            *(t.data_ptr() for t in (*xs, i_pre, logf, st["C"], st["n"],
                                     st["m"], h, C, n, m)),
            code, B, S, H, dh, body, te, stream)
    assert launch((q, k, v), 2, 1, 64) == 0     # the plan's own
    assert launch((q, k, v), 2, 1, 24) != 0     # te not a multiple of 16
    assert launch((q, k, v), 2, 1, 208) != 0    # 13 warps
    assert launch((q, k, v), 2, 2, 64) != 0     # no such body
    qf, kf, vf = (t.float() for t in (q, k, v))
    assert launch((qf, kf, vf), 0, 1, 64) == 0  # fp32 on the tensor cores
    qh, kh, vh = (t.half() for t in (q, k, v))
    assert launch((qh, kh, vh), 1, 1, 64) == 0  # fp16 on the tensor cores
    assert launch((q, k, v), 3, 1, 64) != 0     # no such dtype
    off = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:]
    qo = off.view_as(q).copy_(q)
    assert launch((qo, k, v), 2, 1, 64) != 0    # q off a 16-byte boundary
    torch.cuda.synchronize()


def test_mlstm_shared_memory_figures_agree_with_the_kernel(dev):
    from repro_torch.kernels import build
    from repro_torch.kernels import mlstm_chunk as MC
    lib = build.load()
    for dh in (8, 72, 128, 200, 384):
        assert lib.mlstm_chunk_smem_bytes(0, 2, dh, 0) == \
            MC.simt_smem_bytes(dh)
        for dtype, code in [(torch.float32, 0), (torch.float16, 1),
                            (torch.bfloat16, 2)]:
            for te in (16, 32, 48, 96):
                assert lib.mlstm_chunk_smem_bytes(1, code, dh, te) == \
                    MC.mma_smem_bytes(dh, te, dtype)
            assert (lib.mlstm_chunk_bwd_smem_bytes(dh, code, 0),
                    lib.mlstm_chunk_bwd_smem_bytes(dh, code, 1)) == \
                MC.mlstm_bwd_plan(dh, dtype, 232448).smem_bytes


def _mlstm_fp64(args, st):
    """The plain mLSTM evaluated in fp64 on the same inputs."""
    from repro_torch.kernels import mlstm_chunk as MC
    return MC.mlstm_chunked_ref(*(t.double() for t in args),
                                {k: t.double() for k, t in st.items()})


@pytest.mark.parametrize("B,S,H,dh,state", [(2, 300, 4, 384, True),
                                            (2, 64, 4, 384, False),
                                            (3, 37, 2, 128, True)])
def test_mlstm_fp32_body_holds_fp64_gate(dev, B, S, H, dh, state):
    """The tensor-core body at fp32 (three bf16 parts an operand) against
    the plain version in fp64: h, C, n and m each within four times the
    plain fp32 version's own error or 1e-6 of the output's scale; two
    calls give the same bits."""
    from repro_torch.kernels import mlstm_chunk as MC
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(S + dh)
    args, st = _mlstm_inputs(rng, B, S, H, dh, torch.float32, dev, state)
    h, fin = MC.mlstm_chunked(*args, st)
    h2, fin2 = MC.mlstm_chunked(*args, st)
    h_p, fin_p = MC.mlstm_chunked_ref(*args, st)
    h_t, fin_t = _mlstm_fp64(args, st)
    assert torch.equal(h, h2) and all(torch.equal(fin[k], fin2[k])
                                      for k in fin)
    for got, plain, truth in [(h, h_p, h_t)] + [
            (fin[k], fin_p[k], fin_t[k]) for k in ("C", "n", "m")]:
        scale = max(truth.abs().max().item(), 1e-30)
        err = (got.double() - truth).abs().max().item() / scale
        perr = (plain.double() - truth).abs().max().item() / scale
        assert err <= max(4 * perr, 1e-6), (err, perr)


# -- the mLSTM backward ------------------------------------------------------
# The backward kernel against its plain version on the same chunk states
# and h (the forward kernel's): fp32 arithmetic in both, so di and dlogf
# and the fp32 gradients differ only in summation order, amplified where a
# denominator passes near zero (1e-4 of each gradient's largest
# magnitude); bf16 / fp16 dq, dk, dv are rounded to their type by both
# (2e-2).


# every dtype at each shape, and the long training context (4 x 2048) at
# the mixed policy's bf16
MLSTM_BWD_CASES = [(dtype, *shape) for shape in [(2, 128, 4, 384, False),
                                                 (2, 300, 4, 384, True),
                                                 (3, 37, 2, 128, True),
                                                 (2, 5, 3, 72, False),
                                                 (1, 1, 1, 8, True)]
                   for dtype in (torch.float32, torch.bfloat16,
                                 torch.float16)] + \
    [(torch.bfloat16, 4, 2048, 4, 384, False)]


@pytest.mark.parametrize("dtype,B,S,H,dh,state", MLSTM_BWD_CASES)
def test_mlstm_bwd_kernel_matches_plain(dev, dtype, B, S, H, dh, state):
    """The forward kept the state at every chunk's start (to the plain
    version's, and its h bit-equal to the serving launch's); the backward
    kernel gives the plain backward's dq, dk, dv (at q's dtype), di and
    dlogf from them; two calls give the same bits; one launch each
    counted."""
    from repro_torch.kernels import mlstm_chunk as MC
    rng = np.random.default_rng(S + dh)
    args, st = _mlstm_inputs(rng, B, S, H, dh, dtype, dev, state)
    dh_out = torch.from_numpy(rng.normal(size=(B, S, H, dh)).astype(
        np.float32)).to(dev)
    h_serve, _ = MC.mlstm_chunked(*args, st)
    n0 = (MC.mlstm_chunked.launches, MC.mlstm_chunked_bwd.launches)
    h, final, states = MC.mlstm_chunked(*args, st, return_states=True)
    got = MC.mlstm_chunked_bwd(*args, states, h, dh_out)
    again = MC.mlstm_chunked_bwd(*args, states, h, dh_out)
    torch.cuda.synchronize()
    assert (MC.mlstm_chunked.launches, MC.mlstm_chunked_bwd.launches) == \
        (n0[0] + 1, n0[1] + 2)
    assert torch.equal(h, h_serve)
    _, _, want_st = MC.mlstm_chunked_ref(*args, st, chunk=MC.CHUNK,
                                         return_states=True)
    for key in ("C", "n", "m"):
        scale = max(want_st[key].abs().max().item(), 1.0)
        assert (states[key] - want_st[key]).abs().max().item() \
            <= 1e-5 * scale, key
    want = MC.mlstm_chunked_bwd_ref(*args, states, h, dh_out,
                                    chunk=MC.CHUNK)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        tol = TOL[dtype] if i < 3 else 1e-4
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= tol * scale, i
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_mlstm_bwd_kernels_in_the_profile(dev):
    """One backward call launches its four chunk-parallel kernels (per
    chunk dq, the reverse scan, per chunk dk and dv, dlogf) at q's dtype,
    and no other kernel of its own; one chunk needs no scan."""
    from repro_torch.kernels import mlstm_chunk as MC
    rng = np.random.default_rng(8)
    for dtype, tag in [(torch.bfloat16, "__nv_bfloat16"),
                       (torch.float16, "__half"), (torch.float32, "float")]:
        for S, scan in [(70, True), (20, False)]:
            args, st = _mlstm_inputs(rng, 2, S, 4, 384, dtype, dev, False)
            h, _, states = MC.mlstm_chunked(*args, st, return_states=True)
            dh_out = torch.randn(h.shape, device=dev)
            names = _device_kernels(
                lambda: MC.mlstm_chunked_bwd(*args, states, h, dh_out))
            ours = [n for n in names if "mlstm_bwd_" in n]
            want = ["mlstm_bwd_dq_kernel<" + tag,
                    "mlstm_bwd_dkdv_kernel<" + tag, "mlstm_bwd_dlogf_kernel"]
            want += ["mlstm_bwd_scan_kernel"] if scan else []
            assert len(ours) == len(want) and all(
                sum(w in n for n in ours) == 1 for w in want), (dtype, names)


def test_mlstm_bwd_launcher_refuses_a_bad_plan(dev):
    """The C launcher checks the plan it is handed against what its
    kernels were built for: 512 threads, the dtype's bf16 parts, both
    passes' shared memory, dh a multiple of 8 up to 384."""
    from repro_torch.kernels import build
    from repro_torch.kernels import mlstm_chunk as MC
    rng = np.random.default_rng(6)
    B, S, H, dh = 1, 40, 2, 64
    args, st = _mlstm_inputs(rng, B, S, H, dh, torch.bfloat16, dev, False)
    h, _, states = MC.mlstm_chunked(*args, st, return_states=True)
    g = torch.randn(h.shape, device=dev)
    lib = build.load()
    NC = -(-S // MC.CHUNK)
    outs = [torch.empty_like(t) for t in args[:3]] + \
        [torch.empty_like(args[3]), torch.empty_like(args[4])]
    scratch = [torch.zeros(n, device=dev) for n in (
        B * H * NC * dh * (dh + 1), B * S * H * dh, B * S * H * dh,
        B * S * H, B * S * H, B * H * NC, B * H * NC, B * H * NC)]
    plan = MC.mlstm_bwd_plan(dh, torch.bfloat16, 232448)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(threads=plan.threads, parts=plan.parts,
               smem=plan.smem_bytes, D=dh):
        return lib.mlstm_chunk_bwd_launch(
            *(t.data_ptr() for t in (*args, states["C"], states["n"],
                                     states["m"], h, g, *outs, *scratch)),
            2, B, S, H, D, threads, *parts, *smem, stream)
    assert launch() == 0
    assert launch(threads=256) != 0
    assert launch(parts=(3, 3, 3)) != 0          # fp32's parts at bf16
    assert launch(smem=(plan.smem_bytes[0] + 16, plan.smem_bytes[1])) != 0
    assert launch(D=60) != 0
    torch.cuda.synchronize()


def test_mlstm_bwd_takes_unaligned_inputs(dev):
    """Inputs off a 16-byte boundary (contiguous views at an offset, as
    the pieces of cat's gradient are) are copied onto one before the
    kernels read their rows: the gradients equal the aligned call's bit
    for bit."""
    from repro_torch.kernels import mlstm_chunk as MC
    rng = np.random.default_rng(12)
    args, st = _mlstm_inputs(rng, 2, 70, 2, 128, torch.bfloat16, dev, False)
    h, _, states = MC.mlstm_chunked(*args, st, return_states=True)
    g = torch.randn(h.shape, device=dev)
    want = MC.mlstm_chunked_bwd(*args, states, h, g)

    def shifted(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype,
                          device=dev)[1:].view(t.shape)
        return out.copy_(t)
    q, k, v, gs = (shifted(t) for t in (*args[:3], g))
    assert all(t.data_ptr() % 16 for t in (q, k, v, gs))
    got = MC.mlstm_chunked_bwd(q, k, v, *args[3:], states, h, gs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_mlstm_grads_through_ops_on_card(dev):
    """``ops.mlstm_chunked`` with grad on the card runs the forward and
    backward kernels (one launch each) and gives autograd's gradient of
    the plain version for q, k, v and both gates (fp32, 1e-4 of each
    gradient's largest magnitude); an initial state that requires grad
    raises naming the backward kernel."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(7)
    args, st = _mlstm_inputs(rng, 2, 70, 4, 128, torch.float32, dev, False)
    dh_out = torch.from_numpy(rng.normal(size=(2, 70, 4, 128)).astype(
        np.float32)).to(dev)
    leaves = [t.clone().requires_grad_() for t in args]
    ops.reset_launch_counts()
    h, _ = ops.mlstm_chunked(*leaves, st)
    got = torch.autograd.grad(h, leaves, dh_out)
    counts = ops.launch_counts()
    assert counts["mlstm_chunked"] == 1 and counts["mlstm_chunked_bwd"] == 1
    cpu = [t.detach().cpu().requires_grad_() for t in args]
    want = torch.autograd.grad(
        ref.mlstm_chunked_ref(*cpu, {k: v.cpu() for k, v in st.items()})[0],
        cpu, dh_out.cpu())
    for g, w in zip(got, want):
        scale = w.abs().max().item()
        assert (g.cpu() - w).abs().max().item() <= 1e-4 * scale
    grown = {k: v.clone().requires_grad_() for k, v in st.items()}
    h, _ = ops.mlstm_chunked(*leaves, grown)
    with pytest.raises(NotImplementedError, match="mlstm_chunked_bwd"):
        torch.autograd.grad(h, leaves, dh_out)


# -- the packed pair on the tensor-core core (bf16 / fp16 q): one block per
# (work row of up to 8 lanes, kv head), the page walk split in narrow
# streams


def _packed_stream(ctx, lanes, T, dev):
    """A T-lane stream holding the last ``lanes[s]`` tokens of slot s
    (whose pool holds ``ctx[s]`` tokens, the stream's own included), then
    padding lanes: (q_pos, slot_ids, meta, used lanes)."""
    sid = np.full(T, -1, np.int32)
    pos = np.full(T, -1, np.int32)
    starts, t = [], 0
    for s, (n, ln) in enumerate(zip(ctx, lanes)):
        starts.append(t)
        sid[t:t + ln], pos[t:t + ln] = s, n - ln + np.arange(ln)
        t += ln
    meta = DA.packed_meta_table(starts, lanes, range(len(ctx)), T,
                                T // DA.PACKED_BLOCK_Q + len(ctx))
    return (torch.from_numpy(pos[None]).to(dev),
            torch.from_numpy(sid).to(dev), torch.from_numpy(meta).to(dev), t)


def _packed_call(q, k, v, ppos, bt, q_pos, sid, meta, quant, **kw):
    """The packed kernel and its plain version over a pool at q's dtype,
    or over the int8 codes of the same K/V (``quant``)."""
    if quant:
        kq, ks, vq, vs = _q8(k, v)
        n0 = DA.paged_packed_attention_q8.launches
        out = DA.paged_packed_attention_q8(q, kq, ks, vq, vs, ppos, bt,
                                           q_pos, meta, **kw)
        assert DA.paged_packed_attention_q8.launches == n0 + 1
        ref = DA.paged_packed_attention_ref(q, kq, vq, ppos, bt, q_pos, sid,
                                            k_scale=ks, v_scale=vs, **kw)
    else:
        n0 = DA.paged_packed_attention.launches
        out = DA.paged_packed_attention(q, k, v, ppos, bt, q_pos, meta, **kw)
        assert DA.paged_packed_attention.launches == n0 + 1
        ref = DA.paged_packed_attention_ref(q, k, v, ppos, bt, q_pos, sid,
                                            **kw)
    torch.cuda.synchronize()
    return out, ref


# (pool tokens per slot, stream tokens per slot, T, kv heads, window,
# softcap): decode lanes only; chunks only, with ragged last work rows and
# padding lanes; both; both under a window and a softcap; the smoke's
# 256-lane stream over 8 kv heads (no split)
PACKED_STREAMS = {
    "decode only": ([41, 8, 131, 4], [1, 1, 1, 1], 8, 2, None, None),
    "chunks only": ([21, 16, 3, 77], [21, 9, 3, 17], 56, 2, None, None),
    "mixed": ([41, 21, 16, 3], [1, 21, 9, 3], 40, 2, None, None),
    "window + softcap": ([41, 21, 16, 3], [1, 21, 9, 3], 40, 2, 13, 30.0),
    "256 lanes": ([101, 38, 202, 10, 150, 70, 50, 30],
                  [1, 1, 1, 1, 90, 70, 50, 30], 256, 8, None, None)}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("stream", list(PACKED_STREAMS))
@pytest.mark.parametrize("g,D", [(1, 64), (4, 128), (16, 64)])
@pytest.mark.parametrize("dtype", MMA_DTYPES)
def test_packed_mma_matches_plain(dev, dtype, g, D, stream, quant):
    ctx, lanes, T_, Hkv, window, softcap = PACKED_STREAMS[stream]
    rng = np.random.default_rng(60 + g + T_)
    k, v, ppos, bt = _pools(rng, ctx, Hkv=Hkv, D=D, page=16,
                            npages=-(-max(ctx) // 16) + 1, dtype=dtype,
                            dev=dev)
    q_pos, sid, meta, used = _packed_stream(ctx, lanes, T_, dev)
    q = torch.from_numpy(rng.normal(size=(1, T_, g * Hkv, D)).astype(
        np.float32)).to(dev, dtype)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    plan = DA.packed_plan(meta.shape[0], Hkv, g, bt.shape[1], dtype,
                          scratch.sm_count(dev.index or 0))
    assert plan.body == "mma"
    assert (plan.splits > 1) == (stream != "256 lanes")
    out, ref = _packed_call(q, k, v, ppos, bt, q_pos, sid, meta, quant,
                            **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert not out[0, used:].any()            # padding lanes are zero
    again, _ = _packed_call(q, k, v, ppos, bt, q_pos, sid, meta, quant,
                            **kw)
    assert torch.equal(again, out)            # the counters were reset


def test_packed_bodies_in_the_profile(dev):
    """bf16 and fp16 q take the tensor-core body, fp32 q attend_rows."""
    rng = np.random.default_rng(61)
    ctx, lanes, T_, Hkv, _, _ = PACKED_STREAMS["mixed"]
    q_pos, sid, meta, _ = _packed_stream(ctx, lanes, T_, dev)
    for dtype, body in [(torch.bfloat16, "paged_packed_mma_kernel<"),
                        (torch.float16, "paged_packed_mma_kernel<"),
                        (torch.float32, "paged_packed_kernel<")]:
        k, v, ppos, bt = _pools(rng, ctx, Hkv=Hkv, D=64, page=16,
                                npages=4, dtype=dtype, dev=dev)
        q = torch.from_numpy(rng.normal(size=(1, T_, 4 * Hkv, 64)).astype(
            np.float32)).to(dev, dtype)
        kw = dict(window=None, scale=0.125, attn_softcap=None)
        for quant in (False, True):
            names = _device_kernels(lambda: _packed_call(
                q, k, v, ppos, bt, q_pos, sid, meta, quant, **kw))
            ours = [n for n in names if "paged_packed" in n]
            assert ours and all(body in n for n in ours), (dtype, names)


@pytest.mark.parametrize("dtype,wdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.bfloat16, torch.float32),
                                          (torch.float16, torch.float32)])
@pytest.mark.parametrize("shape", [(4096, 2560), (3, 100), (2, 5, 768),
                                   (1, 100), (4099, 100), (1, 2560),
                                   (4099, 2560), (1, 8192), (4099, 8192),
                                   (1, 16384), (4099, 16384)])
def test_rmsnorm_kernel_matches_plain(dev, shape, dtype, wdtype):
    """fp32: 1e-5 relative (rsqrtf and the sum's order); bf16/fp16 may
    round an ulp apart (2e-2).  The shapes reach every body of the plan:
    rows of one, two and four warps, and the scalar body (D = 100 at
    16-bit types; fp32 rows of D = 16384, wider than the registers hold)."""
    from repro_torch.kernels import rmsnorm as RN
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = (torch.randn(shape[-1], generator=g, device=dev) * 0.1).to(wdtype)
    before = RN.fused_rmsnorm.launches
    out = ops.rmsnorm(x, w)
    assert RN.fused_rmsnorm.launches == before + 1
    ref_out = RN.rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == x.shape
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,D", [(7, 100), (4099, 2560), (3, 16384)])
def test_rmsnorm_kernel_takes_unaligned_rows(dev, dtype, rows, D):
    """A contiguous view one element off a 16-byte boundary is legal input:
    the plan sends it to the scalar body, which matches the plain
    version at the tolerances above."""
    from repro_torch.kernels import rmsnorm as RN
    g = torch.Generator(device=dev).manual_seed(2)
    buf = torch.randn(rows * D + 1, generator=g, device=dev).to(dtype)
    x = buf[1:].view(rows, D)
    assert x.is_contiguous() and x.data_ptr() % 16
    assert RN.rmsnorm_plan(rows, D, x.element_size(), False,
                           scratch.sm_count(dev.index or 0)).body == "scalar"
    w = (torch.randn(D, generator=g, device=dev) * 0.1).to(dtype)
    out = ops.rmsnorm(x, w)
    ref_out = RN.rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol,
                               atol=tol)


def test_rmsnorm_launcher_refuses_a_plan_the_shape_does_not_fit(dev):
    """The C launcher checks the plan it is given: the rows body needs x
    16-byte aligned, whole vectors and a row its warps hold; there is no
    body but scalar (0) and rows (1)."""
    from repro_torch.kernels import build
    lib = build.load()
    x = torch.zeros(4, 2560, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(2560, device=dev, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(xp, D, body, wpr, nv):
        return lib.rmsnorm_launch(xp, w.data_ptr(), out.data_ptr(), 2, 0, 4,
                                  D, 1e-6, body, wpr, nv, 4, stream)
    assert launch(x.data_ptr(), 2560, 1, 1, 16) == 0
    assert launch(x.data_ptr(), 2560, 1, 1, 8) != 0      # 10 vectors a lane
    assert launch(x.data_ptr(), 2560, 1, 3, 16) != 0     # warps a row
    assert launch(x.data_ptr() + 2, 2560, 1, 1, 16) != 0  # misaligned
    assert launch(x.data_ptr(), 2556, 1, 1, 16) != 0     # not whole vectors
    assert launch(x.data_ptr(), 2560, 2, 1, 16) != 0     # no such body
    torch.cuda.synchronize()


def test_rmsnorm_wrapper_rejects_bad_inputs(dev):
    from repro_torch.kernels import rmsnorm as RN
    x = torch.zeros(4, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="w at x's dtype"):
        RN.fused_rmsnorm(x, torch.zeros(16, device=dev,
                                        dtype=torch.float16))
    with pytest.raises(ValueError, match=r"\(D,\)"):
        RN.fused_rmsnorm(x, torch.zeros(8, device=dev, dtype=x.dtype))
    with pytest.raises(ValueError, match="contiguous"):
        RN.fused_rmsnorm(x.t(), torch.zeros(4, device=dev, dtype=x.dtype))


DENSE_CASES = [(torch.bfloat16, 8, 256, 32, 8, 128, None, None),
               (torch.bfloat16, 8, 256, 32, 8, 128, 64, 30.0),
               (torch.float32, 3, 37, 16, 16, 64, None, None),
               (torch.float16, 2, 300, 8, 2, 32, 13, 20.0),
               (torch.float32, 4, 1, 4, 1, 256, None, None)] + [
    # the tensor-core body: g = 1 / 4 / 8 / 16 heads a kv head, every head
    # dim bucket, one key, a ragged tile and a split walk
    (dtype, 3, Sk, 2 * g, 2, D, None, None)
    for dtype in (torch.bfloat16, torch.float16) for g in (1, 4, 8, 16)
    for D in (64, 96, 128, 256) for Sk in (1, 33, 4096)] + [
    (torch.bfloat16, 3, 4096, 8, 2, 128, 700, 30.0),     # split + window
    (torch.float16, 2, 77, 64, 2, 40, 30, None),         # 4 row tiles
    (torch.bfloat16, 8, 4096, 32, 8, 128, None, None)]   # qwen3-4b, split


@pytest.mark.parametrize("dtype,B,Sk,Hq,Hkv,D,window,softcap", DENSE_CASES)
def test_dense_decode_kernel_matches_plain(dev, dtype, B, Sk, Hq, Hkv, D,
                                           window, softcap):
    """Row 0 sees a ragged valid prefix; the last row has q_pos = -1 and
    comes back exactly 0 (from both)."""
    rng = np.random.default_rng(Sk)

    def t(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev, dtype)
    q, k, v = t((B, 1, Hq, D)), t((B, Sk, Hkv, D)), t((B, Sk, Hkv, D))
    k_pos = torch.arange(Sk, dtype=torch.int32, device=dev).repeat(B, 1)
    k_pos[0, Sk // 2 + 1:] = -1
    q_pos = torch.full((B, 1), Sk - 1, dtype=torch.int32, device=dev)
    q_pos[0] = Sk // 2
    q_pos[-1] = -1
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    before = DA.decode_attention.launches
    out = ops.decode_attention(q, k, v, k_pos, q_pos, **kw)
    assert DA.decode_attention.launches == before + 1
    ref_out = DA.decode_attention_ref(q, k, v, k_pos, q_pos, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref_out.float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    _assert_within_output_scale(out, ref_out, dtype)
    assert not out[-1].any()


def _assert_within_output_scale(out, ref_out, dtype):
    """Over many keys the outputs shrink (about sqrt(e / Sk) at random
    inputs, 0.026 at 4096 keys), so TOL alone could pass a kernel that
    skipped tiles: the error is held to TOL of the output's scale too."""
    err = (out.float() - ref_out.float()).abs().max().item()
    assert err <= TOL[dtype] * ref_out.float().abs().max().item()


def _dense_inputs(rng, dtype, B, Sk, Hq, Hkv, D, dev, Dv=None):
    def t(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev, dtype)
    q, k, v = t((B, 1, Hq, D)), t((B, Sk, Hkv, D)), t((B, Sk, Hkv, Dv or D))
    k_pos = torch.arange(Sk, dtype=torch.int32, device=dev).repeat(B, 1)
    q_pos = torch.full((B, 1), Sk - 1, dtype=torch.int32, device=dev)
    return q, k, v, k_pos, q_pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("Sk", [40, 4096])
def test_dense_decode_window_past_every_key(dev, dtype, Sk):
    """Every row's window lies past its last key: no key is visible and
    the output is exactly 0, as the plain version's."""
    rng = np.random.default_rng(5)
    q, k, v, k_pos, q_pos = _dense_inputs(rng, dtype, 3, Sk, 8, 2, 128, dev)
    q_pos += 50
    kw = dict(window=20, scale=128 ** -0.5, attn_softcap=None)
    out = ops.decode_attention(q, k, v, k_pos, q_pos, **kw)
    ref_out = DA.decode_attention_ref(q, k, v, k_pos, q_pos, **kw)
    torch.cuda.synchronize()
    assert not out.any() and not ref_out.any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_dense_decode_value_dim_differs(dev, dtype):
    """Dv != D: the tensor-core body takes the larger head-dim bucket."""
    rng = np.random.default_rng(6)
    q, k, v, k_pos, q_pos = _dense_inputs(rng, dtype, 2, 300, 8, 2, 64, dev,
                                          Dv=128)
    kw = dict(window=None, scale=64 ** -0.5, attn_softcap=None)
    out = ops.decode_attention(q, k, v, k_pos, q_pos, **kw)
    ref_out = DA.decode_attention_ref(q, k, v, k_pos, q_pos, **kw)
    torch.cuda.synchronize()
    assert out.shape == (2, 1, 8, 128)
    torch.testing.assert_close(out.float(), ref_out.float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_dense_decode_unaligned_inputs_take_the_cuda_core_body(dev):
    """bf16 k one element off a 16-byte boundary is legal input: the plan
    sends it to the CUDA-core body, which matches the plain version."""
    rng = np.random.default_rng(7)
    dtype = torch.bfloat16
    q, k, v, k_pos, q_pos = _dense_inputs(rng, dtype, 2, 70, 8, 2, 64, dev)
    buf = torch.empty(k.numel() + 1, dtype=dtype, device=dev)
    k_off = buf[1:].view(k.shape)
    k_off.copy_(k)
    assert k_off.is_contiguous() and k_off.data_ptr() % 16
    assert DA.dense_decode_plan(2, 2, 4, 70, dtype, False, 132).body == "simt"
    kw = dict(window=None, scale=64 ** -0.5, attn_softcap=None)
    before = DA.decode_attention.launches
    out = ops.decode_attention(q, k_off, v, k_pos, q_pos, **kw)
    assert DA.decode_attention.launches == before + 1
    ref_out = DA.decode_attention_ref(q, k, v, k_pos, q_pos, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref_out.float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_dense_split_launches_on_two_streams(dev):
    """Two split dense launches in flight at once on two streams, twenty
    times: each stream has its own scratch and arrival counters, so every
    output equals the plain version's."""
    rng = np.random.default_rng(81)
    dtype = torch.bfloat16
    sm = scratch.sm_count(dev.index or 0)
    cases = []
    for B, Hq, Hkv in ((2, 8, 2), (1, 32, 8)):
        args = _dense_inputs(rng, dtype, B, 4096, Hq, Hkv, 128, dev)
        assert DA.dense_decode_plan(B, Hkv, Hq // Hkv, 4096, dtype, True,
                                    sm).splits > 1
        cases.append(args)
    kw = dict(window=None, scale=128 ** -0.5, attn_softcap=None)
    refs = [DA.decode_attention_ref(*a, **kw) for a in cases]
    streams = [torch.cuda.Stream() for _ in cases]
    torch.cuda.synchronize()
    outs = []
    for _ in range(20):
        for st, a in zip(streams, cases):
            with torch.cuda.stream(st):
                outs.append(DA.decode_attention(*a, **kw))
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        torch.testing.assert_close(out.float(), refs[i % 2].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        _assert_within_output_scale(out, refs[i % 2], dtype)


def test_dense_decode_launcher_refuses_a_bad_plan(dev):
    """The C launcher checks the plan it is given: whole tiles, no empty
    split, scratch with more than one split."""
    from repro_torch.kernels import build
    lib = build.load()
    rng = np.random.default_rng(8)
    q, k, v, k_pos, q_pos = _dense_inputs(rng, torch.bfloat16, 1, 100, 4,
                                          1, 64, dev)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(splits, kps):
        return lib.dense_decode_mma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(), None, None, 2, 1, 4, 1, 64, 64,
            100, splits, kps, 0.125, 0.0, 0, stream)
    assert launch(1, 128) == 0
    assert launch(1, 100) != 0          # not whole tiles
    assert launch(1, 64) != 0           # keys past the splits
    assert launch(2, 32 * 4) != 0       # an empty split
    assert launch(2, 64) != 0           # two splits, no scratch
    torch.cuda.synchronize()


def test_dense_decode_wrapper_rejects_bad_inputs(dev):
    q = torch.zeros(2, 1, 4, 16, device=dev)
    k = torch.zeros(2, 5, 2, 16, device=dev)
    kp = torch.zeros(2, 5, dtype=torch.int32, device=dev)
    qp = torch.zeros(2, 1, dtype=torch.int32, device=dev)
    kw = dict(window=None, scale=0.25)
    with pytest.raises(ValueError, match="int32"):
        DA.decode_attention(q, k, k, kp.long(), qp, **kw)
    with pytest.raises(ValueError, match="shapes"):
        DA.decode_attention(q.expand(2, 2, 4, 16).contiguous(), k, k, kp, qp,
                            **kw)
    with pytest.raises(ValueError, match="share one of"):
        DA.decode_attention(q, k.half(), k, kp, qp, **kw)


def test_xlstm_serve_on_card_matches_cpu(dev):
    """Reduced xlstm-125m, fp32, greedy, through the bucketed admission
    path: the card's streams equal the CPU's, every mLSTM prefill ran the
    kernel (one mLSTM layer, one launch per admission dispatch) and no
    attention kernel ran."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("xlstm-125m")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    rng = np.random.default_rng(4)
    prompts = [[2] + [int(t) for t in rng.integers(4, 400, size=n)]
               for n in (40, 40, 9, 70, 40, 3)]
    out = {}
    for d in ("cpu", "cuda"):
        eng = InferenceEngine(cfg, params, policy=FP32, max_len=128,
                              max_batch=3, device=d)
        ops.reset_launch_counts()
        done, m = eng.serve_continuous(
            [Request(uid=i, tokens=p, max_new_tokens=8)
             for i, p in enumerate(prompts)], page_size=8, steps_per_sync=2)
        out[d] = [r.result for r in done]
    counts = ops.launch_counts()
    assert out["cuda"] == out["cpu"]
    decode_dispatches = m.steps // 2
    assert counts["mlstm_chunked"] == m.host_syncs - decode_dispatches > 0
    assert counts["mlstm_chunked"] < len(prompts)        # a batched group
    assert sum(counts.values()) == counts["mlstm_chunked"]


# the unimo-text head pruned as the serve CLI prunes it (--prune-coverage
# 0.999 on the synthetic corpus keeps 45 of 12800 ids): K = d_model, N not
# a multiple of 16, at a decode step's and a packed stream's rows
@pytest.mark.parametrize("M", [8, 256])
def test_quant_matmul_pruned_head(dev, M):
    _qmm_check(*_qmm_inputs(dev, M, 1024, 45, torch.bfloat16, 45 + M))


def _random_pool(cfg, kv_dtype, dev, num_pages=12, seed=5):
    cache = T.init_paged_cache(cfg, num_pages=num_pages, page_size=8,
                               dtype=torch.bfloat16, kv_dtype=kv_dtype,
                               device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    for c in cache["layers"]:
        for t in c.values():
            if t.dtype in (torch.int8, torch.int32):
                t.copy_(torch.randint(-100, 100, t.shape, generator=g,
                                      device=dev))
            else:
                t.copy_(torch.randn(t.shape, generator=g, device=dev))
    return cache


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_offload_restore_round_trip_on_card(dev, kv_dtype):
    """Pages of a bf16 or int8 pool go out to pinned host memory and back
    into other pages bit-identically, every leaf (codes, scale pools,
    positions), and the blob has the bytes of the CPU pool's blob."""
    cfg = get_reduced("qwen3-4b")
    cache = _random_pool(cfg, kv_dtype, dev)
    src, dst = [1, 4, 7], [2, 9, 10]
    want = [{k: t[src].clone() for k, t in c.items()}
            for c in cache["layers"]]
    blob = KV.offload_pages(cache, src)
    assert all(t.device.type == "cpu" and t.is_pinned()
               for d in blob for t in d.values())
    KV.reset_pages_all(cache, torch.tensor(src, device=dev))
    KV.restore_pages(cache, blob, dst)
    torch.cuda.synchronize()
    for c, w in zip(cache["layers"], want):
        for k in w:
            assert torch.equal(c[k][dst], w[k]), k
    cpu = T.init_paged_cache(cfg, num_pages=12, page_size=8,
                             dtype=torch.bfloat16, kv_dtype=kv_dtype)
    assert KV.blob_bytes(blob) == KV.blob_bytes(KV.offload_pages(cpu, src))


def test_restore_on_one_stream_while_packed_runs_on_another(dev):
    """A restore into free pages issued on one stream while the packed
    kernel reads other pages of the same pool on the next: each restore's
    pinned blob is dropped as soon as it is issued and fresh pinned
    blocks are written at once, and still every restore lands the
    snapshot's bytes and every packed output equals the plain version's."""
    rng = np.random.default_rng(81)
    dtype = torch.bfloat16
    ctx = [100, 37, 250, 5, 64, 180]
    k, v, ppos, bt = _pools(rng, ctx, Hkv=2, D=128, page=16, npages=17,
                            dtype=dtype, dev=dev)
    cache = {"layers": [{"pk": k, "pv": v, "ppos": ppos}]}
    used = set(bt[bt >= 0].tolist())
    free = [p for p in range(k.shape[0] - 1) if p not in used]
    src, dst = free[:8], free[8:16]
    blob = KV.offload_pages(cache, src)
    want = {n: t[src].clone() for n, t in cache["layers"][0].items()}
    qpp, sid, meta, _ = _packed_stream(ctx, [1, 1, 20, 5, 1, 30], 64, dev)
    qp = torch.from_numpy(rng.normal(size=(1, 64, 8, 128)).astype(
        np.float32)).to(dev, dtype)
    kw = dict(window=None, scale=128 ** -0.5, attn_softcap=None)
    ref = DA.paged_packed_attention_ref(qp, k, v, ppos, bt, qpp, sid, **kw)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    outs, junk = [], []
    for _ in range(10):
        with torch.cuda.stream(s2):
            outs.append(DA.paged_packed_attention(qp, k, v, ppos, bt, qpp,
                                                  meta, **kw))
        with torch.cuda.stream(s1):
            KV.reset_pages_all(cache, torch.tensor(dst, device=dev))
            KV.restore_pages(cache, [{n: t.clone().pin_memory()
                                      for n, t in blob[0].items()}], dst)
        junk.append([torch.full(t.shape, 7, dtype=t.dtype).pin_memory()
                     for t in blob[0].values()])
    torch.cuda.synchronize()
    for n, t in cache["layers"][0].items():
        assert torch.equal(t[dst], want[n]), n
    for out in outs:
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


# The heads of phi3-mini (32 / 32 x 96: the 128 head-dim bucket over
# 192-byte rows) and gemma2-2b (8 / 4 x 256, its local layers' window 4096
# and softcap 50, over contexts past the window), at bf16, over int8 pools
# and at fp32 (the CUDA-core bodies)
FAMILIES = {
    "phi3": dict(heads=dict(Hq=32, Hkv=32, D=96),
                 kw=dict(window=None, attn_softcap=None),
                 ctx=[1, 37, 0, 300, 256], before=[10, 37, 0, 130, 64],
                 packed=[40, 0, 7, 0]),
    "gemma2": dict(heads=dict(Hq=8, Hkv=4, D=256),
                   kw=dict(window=4096, attn_softcap=50.0),
                   ctx=[4200, 37, 0, 4500, 130],
                   before=[4100, 37, 0, 4200, 64],
                   packed=[4300, 0, 4150, 9]),
    # qwen3-moe's g = 16 (64 / 4 x 128: one decode lane fills a warp, a
    # verify window of 5 lanes takes two 64-row tiles), internvl2-1b's
    # g = 7 (14 / 2 x 64: a 16-row warp, a 64-row tile and an 8-head dense
    # block none divide) and musicgen-medium's 24-head MHA at 64
    "qwen3moe": dict(heads=dict(Hq=64, Hkv=4, D=128),
                     kw=dict(window=None, attn_softcap=None),
                     ctx=[1, 37, 0, 300, 78], before=[10, 37, 0, 130, 64],
                     packed=[40, 0, 7, 0]),
    "internvl2": dict(heads=dict(Hq=14, Hkv=2, D=64),
                      kw=dict(window=None, attn_softcap=None),
                      ctx=[1, 321, 0, 300, 17], before=[10, 37, 0, 290, 64],
                      packed=[300, 0, 7, 0]),
    "musicgen": dict(heads=dict(Hq=24, Hkv=24, D=64),
                     kw=dict(window=None, attn_softcap=None),
                     ctx=[1, 37, 0, 96, 65], before=[10, 37, 0, 60, 64],
                     packed=[40, 0, 7, 0]),
    # hymba-1.5b's g = 5 (25 / 5 x 64) with its window of 1024, contexts
    # past it
    "hymba": dict(heads=dict(Hq=25, Hkv=5, D=64),
                  kw=dict(window=1024, attn_softcap=None),
                  ctx=[1, 37, 0, 1500, 1100], before=[10, 37, 0, 1200, 64],
                  packed=[1300, 0, 7, 0]),
}
FAMILY_DTYPES = [torch.bfloat16, torch.float32]


def _family_attend(name, quant, q, k, v, ppos, bt, q_pos, extra, kw):
    """A paged kernel (over int8 codes and scales with ``quant``) and its
    plain version on the same inputs: (out, ref)."""
    fn = getattr(DA, name + ("_q8" if quant else ""))
    plain = getattr(DA, name + "_ref")
    if not quant:
        return (fn(q, k, v, ppos, bt, q_pos, *extra[:1], **kw),
                plain(q, k, v, ppos, bt, q_pos, *extra[1:], **kw))
    kq, ks, vq, vs = _q8(k, v)
    return (fn(q, kq, ks, vq, vs, ppos, bt, q_pos, *extra[:1], **kw),
            plain(q, kq, vq, ppos, bt, q_pos, *extra[1:], k_scale=ks,
                  v_scale=vs, **kw))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", FAMILY_DTYPES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_decode_pair_matches_plain(dev, family, dtype, quant):
    f = FAMILIES[family]
    D = f["heads"]["D"]
    rng = np.random.default_rng(21)
    ctx = f["ctx"]
    k, v, ppos, bt = _pools(rng, ctx, Hkv=f["heads"]["Hkv"], D=D, page=16,
                            npages=-(-max(ctx) // 16) + 1,
                            dtype=torch.float32 if quant else dtype, dev=dev)
    q = torch.from_numpy(rng.normal(size=(len(ctx), 1, f["heads"]["Hq"],
                                          D)).astype(np.float32)).to(
        dev, dtype)
    q_pos = torch.tensor([[n - 1] for n in ctx], dtype=torch.int32,
                         device=dev)
    kw = dict(f["kw"], scale=D ** -0.5)
    out, ref = _family_attend("paged_decode_attention", quant, q, k, v,
                              ppos, bt, q_pos, (), kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert not out[2].any()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", FAMILY_DTYPES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_packed_pair_matches_plain(dev, family, dtype, quant):
    f = FAMILIES[family]
    D = f["heads"]["D"]
    rng = np.random.default_rng(22)
    before, seg = f["packed"], [1, 21, 9, 3]
    ctx = [b + s for b, s in zip(before, seg)]
    k, v, ppos, bt = _pools(rng, ctx, Hkv=f["heads"]["Hkv"], D=D, page=16,
                            npages=-(-max(ctx) // 16) + 1,
                            dtype=torch.float32 if quant else dtype, dev=dev)
    T_ = 40
    sid = np.full(T_, -1, np.int32)
    pos = np.full(T_, -1, np.int32)
    starts, t = [], 0
    for s, (b0, ln) in enumerate(zip(before, seg)):
        starts.append(t)
        sid[t:t + ln], pos[t:t + ln] = s, b0 + np.arange(ln)
        t += ln
    meta = DA.packed_meta_table(starts, seg, range(4), T_,
                                T_ // DA.PACKED_BLOCK_Q + 4)
    q = torch.from_numpy(rng.normal(size=(1, T_, f["heads"]["Hq"], D))
                         .astype(np.float32)).to(dev, dtype)
    kw = dict(f["kw"], scale=D ** -0.5)
    out, ref = _family_attend(
        "paged_packed_attention", quant, q, k, v, ppos, bt,
        torch.from_numpy(pos[None]).to(dev),
        (torch.from_numpy(meta).to(dev), torch.from_numpy(sid).to(dev)), kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert not out[0, t:].any()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", FAMILY_DTYPES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_mixed_pair_matches_plain(dev, family, dtype, quant):
    """A verify window of k + 1 = 5 lanes over five slots."""
    f = FAMILIES[family]
    D = f["heads"]["D"]
    n_q = [5, 5, 0, 3, 5]
    q, k, v, ppos, bt, q_pos = _mixed_inputs(
        np.random.default_rng(23), W=5, n_q=n_q, before=f["before"],
        page=16, dtype=torch.float32 if quant else dtype, dev=dev,
        **f["heads"])
    q = q.to(dtype)
    kw = dict(f["kw"], scale=D ** -0.5)
    out, ref = _family_attend("paged_mixed_attention", quant, q, k, v, ppos,
                              bt, q_pos, (), kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    for r, n in enumerate(n_q):
        assert not out[r, n:].any()


@pytest.mark.parametrize("dtype", FAMILY_DTYPES)
@pytest.mark.parametrize("family,B,S", [("phi3", 2, 200),
                                        ("gemma2", 1, 4400),
                                        ("qwen3moe", 1, 77),
                                        ("qwen3moe", 8, 78),
                                        ("internvl2", 8, 320),
                                        ("musicgen", 8, 64),
                                        ("hymba", 1, 77),
                                        ("hymba", 8, 78),
                                        ("hymba", 2, 1400)])
def test_family_flash_matches_plain(dev, family, B, S, dtype):
    """Causal prefill over (B, S) tokens; gemma2's past its window,
    qwen3-moe's and hymba's exact-length admissions (an odd S), hymba's
    long prompts past its window, internvl2's 256 prefix embeddings + 64
    text tokens."""
    f = FAMILIES[family]
    D = f["heads"]["D"]
    rng = np.random.default_rng(24)

    def t(h):
        return torch.from_numpy(rng.normal(size=(B, S, h, D)).astype(
            np.float32)).to(dev, dtype)
    q, k, v = t(f["heads"]["Hq"]), t(f["heads"]["Hkv"]), t(f["heads"]["Hkv"])
    pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
    kw = dict(f["kw"], scale=D ** -0.5)
    out = FA.flash_attention(q, k, v, pos, pos, **kw)
    ref = FA.flash_attention_ref(q, k, v, pos, pos, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", FAMILY_DTYPES)
def test_family_dense_decode_matches_plain(dev, dtype):
    """gemma2's heads over a dense cache of 4400 keys, window 4096 and
    softcap 50, one row with a ragged valid prefix, one all padding."""
    f = FAMILIES["gemma2"]
    D = f["heads"]["D"]
    q, k, v, k_pos, q_pos = _dense_inputs(np.random.default_rng(25), dtype,
                                          4, 4400, dev=dev, **f["heads"])
    k_pos[0, 4300:] = -1
    q_pos[0] = 4299
    q_pos[-1] = -1
    kw = dict(f["kw"], scale=D ** -0.5)
    out = ops.decode_attention(q, k, v, k_pos, q_pos, **kw)
    ref = DA.decode_attention_ref(q, k, v, k_pos, q_pos, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    _assert_within_output_scale(out, ref, dtype)
    assert not out[-1].any()


@pytest.mark.parametrize("dtype", FAMILY_DTYPES)
@pytest.mark.parametrize("family", ["qwen3moe", "internvl2", "musicgen",
                                    "hymba"])
def test_family_dense_decode_new_heads_matches_plain(dev, family, dtype):
    """g = 16, g = 7, 24-head MHA and g = 5 over the dense cache of
    ``generate_batch`` at max_len 256 (512 rows), a ragged valid prefix
    in row 0, the last row all padding."""
    f = FAMILIES[family]
    D = f["heads"]["D"]
    q, k, v, k_pos, q_pos = _dense_inputs(np.random.default_rng(26), dtype,
                                          4, 512, dev=dev, **f["heads"])
    k_pos[:, 288:] = -1
    q_pos[:] = 287
    k_pos[0, 100:] = -1
    q_pos[0] = 99
    q_pos[-1] = -1
    kw = dict(f["kw"], scale=D ** -0.5)
    out = ops.decode_attention(q, k, v, k_pos, q_pos, **kw)
    ref = DA.decode_attention_ref(q, k, v, k_pos, q_pos, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    _assert_within_output_scale(out, ref, dtype)
    assert not out[-1].any()


@pytest.mark.parametrize("K,N", [(3072, 32064), (2304, 256000),
                                 (4096, 151936), (4096, 8192),
                                 (8192, 4096), (1600, 32001),
                                 (7168, 129280)])
def test_quant_matmul_family_heads(dev, K, N):
    """phi3's untied head, gemma2's tied head, qwen3-moe's untied head
    and attention projections (q, o), hymba's tied head (an odd N) and
    deepseek-v3's untied head, at a decode step's 8 rows, bf16 x."""
    _qmm_check(*_qmm_inputs(dev, 8, K, N, torch.bfloat16, K + N))


# ---------------------------------------------------------------------------
# The capacity-routed MoE FFN on the card
# ---------------------------------------------------------------------------


def _moe_case(cf=1.5):
    from repro_torch.models import moe as M
    cfg = get_reduced("qwen3-moe-235b-a22b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    p = M.moe_init(torch.Generator().manual_seed(3), cfg)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(4, 24, cfg.d_model)).astype(np.float32))
    # pulled towards expert 0, so that it overflows at the factor 1.5
    col = p["router"][:, 0]
    x += 2.0 * col / col.norm() * cfg.d_model ** 0.5 / 4
    return M, cfg, p, x


def test_moe_apply_on_card_matches_cpu(dev):
    """fp32 (TF32 off), with dropped assignments: the card's output
    equals the CPU's within 1e-5 (the products' summation order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    M, cfg, p, x = _moe_case()
    ref = M.moe_apply(cfg, p, x)[0]
    out = M.moe_apply(cfg, {k: v.to(dev) for k, v in p.items()},
                      x.to(dev))[0]
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_apply_on_card_is_deterministic_without_host_sync(dev, dtype):
    """Two calls give bit-equal outputs (the combine sums each token's
    contributions in a fixed order, no atomics), and neither reads a
    value back to the host (CUDA sync debug mode raises on one)."""
    M, cfg, p, x = _moe_case()
    pd = {k: v.to(dev, dtype) for k, v in p.items()}
    xd = x.to(dev, dtype)
    M.moe_apply(cfg, pd, xd)                     # warm-up: allocations
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = M.moe_apply(cfg, pd, xd)[0]
        b = M.moe_apply(cfg, pd, xd)[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(a, b)


def test_qwen3_moe_serve_on_card_matches_cpu(dev):
    """Reduced qwen3-moe, fp32, greedy, at its own capacity factor:
    bucketed admission at exact lengths through the decode kernel at g =
    4; the card's streams and counters equal the CPU's, twice."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("qwen3-moe-235b-a22b")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    rng = np.random.default_rng(2)
    prompts = [[2] + [int(t) for t in rng.integers(4, 400, size=n)]
               for n in (19, 30, 11, 11, 23)]
    out = {}
    for d in ("cpu", "cuda", "cuda"):
        eng = InferenceEngine(cfg, params, policy=FP32, max_len=64,
                              max_batch=3, device=d)
        DA.reset_launch_counts()
        done, m = eng.serve_continuous(
            [Request(uid=i, tokens=p, max_new_tokens=10)
             for i, p in enumerate(prompts)], page_size=8)
        got = ([r.result for r in done], m.admitted, m.steps, m.host_syncs)
        if d in out:
            assert got == out[d]
        out[d] = got
    assert out["cuda"] == out["cpu"]
    assert m.scheduler == "bucketed"
    assert DA.launch_counts()["paged_decode_attention"] == 2 * m.steps > 0


# ---------------------------------------------------------------------------
# hymba-1.5b and deepseek-v3: MLA's naive form and the forwards on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", FAMILY_DTYPES)
@pytest.mark.parametrize("B,S", [(1, 77), (8, 78), (2, 19)])
def test_flash_mla_head_dims_match_plain(dev, B, S, dtype):
    """deepseek-v3's naive MLA: 128 heads, keys of 192 (nope 128 + rope
    64) against values of 128, at its exact-length admissions; the
    kernel buckets on the larger of D and Dv."""
    rng = np.random.default_rng(27)

    def t(D):
        return torch.from_numpy(rng.normal(size=(B, S, 128, D)).astype(
            np.float32)).to(dev, dtype)
    q, k, v = t(192), t(192), t(128)
    pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
    kw = dict(window=None, scale=192 ** -0.5)
    out = FA.flash_attention(q, k, v, pos, pos, **kw)
    ref = FA.flash_attention_ref(q, k, v, pos, pos, **kw)
    torch.cuda.synchronize()
    assert out.shape == (B, S, 128, 128)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_mla_decode_bf16_on_card_matches_cpu(dev):
    """MLA's absorbed decode over a bf16 latent cache (reduced deepseek-v3,
    bf16 parameters and activations): on the card the scores and context
    are bf16 products with fp32 outputs (no fp32 copy of the cache), on
    the CPU the same rounded values upcast; the two agree to the bf16
    tolerance, and the cache stays bf16."""
    from repro_torch.configs.base import MLA as MLA_MIXER, layer_specs
    from repro_torch.core.precision import BF16
    from repro_torch.models import attention_mla as MLA
    cfg = get_reduced("deepseek-v3-671b")
    spec = next(s for s in layer_specs(cfg) if s.mixer == MLA_MIXER)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, BF16)
    p = params["layers"][0]["attn"]
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(3, 13, cfg.d_model)).astype(
        np.float32)).bfloat16()
    lens = torch.tensor([12, 5, 9], dtype=torch.int32)
    out = {}
    for d in ("cpu", "cuda"):
        c = KV.layer_cache_shape(cfg, spec, 3, 32, torch.bfloat16, device=d)
        pos = torch.arange(12, dtype=torch.int32).repeat(3, 1)
        cpos = torch.where(pos < lens[:, None], pos, -1)
        pd = map_params(lambda t: t.to(d), p)
        _, new = MLA.mla_full(cfg, pd, x[:, :12].to(d), pos.to(d), pos.to(d))
        KV.write_prefill(c, new, cpos.to(d))
        out[d] = MLA.mla_decode(cfg, pd, x[:, 12:].to(d), c, lens.to(d))
        assert c["ckv"].dtype == torch.bfloat16
    assert out["cuda"].dtype == torch.bfloat16
    torch.testing.assert_close(out["cuda"].float().cpu(), out["cpu"].float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "deepseek-v3-671b"])
def test_hybrid_mla_forwards_on_card_match_cpu(dev, arch):
    """Reduced hymba (a Mamba branch beside attention; window 64, rows of
    90 tokens wrap its ring) and deepseek (MLA, sigmoid + shared MoE),
    fp32 (TF32 off): ``forward_train``, a dense-cache prefill and three
    decode steps on the card within 1e-4 of the CPU's (deepseek's
    ``forward_mtp`` too)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced(arch)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    toks = torch.from_numpy(np.random.default_rng(28).integers(
        4, 400, size=(2, 93)).astype(np.int32))
    lens = torch.tensor([90, 61], dtype=torch.int32)
    out = {}
    for d in ("cpu", "cuda"):
        p = map_params(lambda t: t.to(d), params)
        t, n = toks.to(d), lens.to(d)
        with torch.no_grad():
            res = [T.forward_train(p, cfg, t)[0]]
            cache = T.init_cache(cfg, 2, 128, torch.float32, device=d)
            res.append(T.forward_prefill(p, cfg, t[:, :90], n, cache,
                                         max_len=128, last_only=True)[0])
            res += [T.forward_decode(p, cfg, t[:, 90 + i:91 + i], cache,
                                     n + i, max_len=128)[0]
                    for i in range(3)]
            if cfg.mtp:
                res += list(T.forward_mtp(p, cfg, t[:, :40]))
        out[d] = [r.cpu() for r in res]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_sigmoid_shared_moe_on_card_matches_cpu(dev):
    """deepseek's reduced MoE (sigmoid routing, a shared expert) at its
    capacity factor 1.5 with dropped assignments, fp32: the card equals
    the CPU within 1e-5."""
    from repro_torch.models import moe as M
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("deepseek-v3-671b")
    p = M.moe_init(torch.Generator().manual_seed(3), cfg)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(4, 24, cfg.d_model)).astype(np.float32))
    col = p["router"][:, 0]
    x += 2.0 * col / col.norm() * cfg.d_model ** 0.5 / 4
    ref = M.moe_apply(cfg, p, x)[0]
    out = M.moe_apply(cfg, map_params(lambda t: t.to(dev), p),
                      x.to(dev))[0]
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "deepseek-v3-671b"])
def test_hybrid_mla_serve_on_card_matches_cpu(dev, arch):
    """Reduced, fp32, greedy: bucketed admission at exact lengths (two
    equal lengths in one prefill), hymba's rings wrapping past 64; the
    card's streams and counters equal the CPU's; hymba's decode steps go
    through the paged decode kernel (once per layer and step), deepseek's
    through none (MLA's absorbed decode is plain torch)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced(arch)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    rng = np.random.default_rng(2)
    prompts = [[2] + [int(t) for t in rng.integers(4, 400, size=n)]
               for n in (19, 80, 11, 11, 23)]
    out = {}
    for d in ("cpu", "cuda"):
        eng = InferenceEngine(cfg, params, policy=FP32, max_len=128,
                              max_batch=3, device=d)
        DA.reset_launch_counts()
        done, m = eng.serve_continuous(
            [Request(uid=i, tokens=p, max_new_tokens=10)
             for i, p in enumerate(prompts)], page_size=8)
        out[d] = ([r.result for r in done], m.admitted, m.steps,
                  m.host_syncs, m.prefill_padded)
    assert out["cuda"] == out["cpu"]
    assert m.scheduler == "bucketed"
    n_paged = cfg.num_layers if cfg.mla is None else 0
    assert DA.launch_counts()["paged_decode_attention"] == n_paged * m.steps


# ---------------------------------------------------------------------------
# Training: the flash backward kernel, autograd through it, train steps
# ---------------------------------------------------------------------------

# (B, Sq, Sk, Hq, Hkv, D, Dv, window, softcap, ragged)
BWD_CASES = [(2, 77, 77, 4, 4, 64, 64, None, None, False),
             (2, 130, 130, 8, 2, 128, 128, None, None, False),
             (2, 100, 100, 4, 2, 256, 256, 48, 50.0, False),
             (1, 70, 70, 8, 8, 192, 128, None, None, False),
             (3, 45, 45, 8, 2, 32, 32, 16, 30.0, True),
             (2, 20, 90, 4, 1, 64, 64, None, None, True),
             # phi3-mini's head dim 96 (the 128 bucket's general kernels)
             (2, 70, 70, 4, 4, 96, 96, None, None, False),
             # internvl2-1b's g = 7 (14 / 2 heads) at D 64
             (2, 50, 50, 14, 2, 64, 64, None, None, False),
             # one query against Sk = 77, not a multiple of a key block
             (3, 1, 77, 4, 2, 64, 64, None, None, False),
             # a dK/dV grid under one wave: 2 x 8 x 1 blocks, the g = 4
             # heads split over blocks and their partials summed
             (1, 128, 128, 32, 8, 128, 128, None, None, False)]


def _bwd_inputs(dev, dtype, B, Sq, Sk, Hq, Hkv, D, Dv, ragged, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev, dtype)
    q, k, v, do = t(B, Sq, Hq, D), t(B, Sk, Hkv, D), t(B, Sk, Hkv, Dv), \
        t(B, Sq, Hq, Dv)
    kp = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    qp = kp[:, Sk - Sq:].copy()
    if ragged:
        kp[1, 3:9] = -1
        qp[1, -5:] = -1
        qp[-1] = -1
    return q, k, v, do, torch.from_numpy(qp).to(dev), \
        torch.from_numpy(kp).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,Dv,window,softcap,ragged",
                         BWD_CASES)
def test_flash_bwd_kernel_matches_plain(dev, dtype, B, Sq, Sk, Hq, Hkv, D,
                                        Dv, window, softcap, ragged):
    """The backward kernel (from the forward kernel's o and lse) against
    the plain backward on the same o and lse, within 1e-4 (fp32) / 2e-2
    (bf16, fp16) of each gradient's largest magnitude; the forward's lse
    within the same of the plain version's, +inf where a row sees no key;
    padding queries get zero dq."""
    q, k, v, do, qp, kp = _bwd_inputs(dev, dtype, B, Sq, Sk, Hq, Hkv, D, Dv,
                                      ragged)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    o, lse = FA.flash_attention(q, k, v, qp, kp, return_lse=True, **kw)
    _, lse_ref = FA.flash_attention_lse_ref(q, k, v, qp, kp, **kw)
    got = FA.flash_attention_bwd(q, k, v, qp, kp, o, lse, do, **kw)
    want = FA.flash_attention_bwd_ref(q, k, v, qp, kp, o, lse, do, **kw)
    torch.cuda.synchronize()
    rel = TOL[dtype]
    fin = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], lse_ref[fin], rtol=rel, atol=rel)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= rel * scale
    assert not got[0][qp < 0].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,Dv,window,softcap,ragged",
                         BWD_CASES)
def test_flash_bwd_kernel_is_deterministic(dev, dtype, B, Sq, Sk, Hq, Hkv, D,
                                           Dv, window, softcap, ragged):
    """Two calls of the bf16 (mma) or fp32 (split) backward on the same
    inputs give bit-identical dq, dk and dv: no atomics, and a head split's
    partials are added in split order."""
    q, k, v, do, qp, kp = _bwd_inputs(dev, dtype, B, Sq, Sk, Hq, Hkv, D, Dv,
                                      ragged)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    o, lse = FA.flash_attention(q, k, v, qp, kp, return_lse=True, **kw)
    first = FA.flash_attention_bwd(q, k, v, qp, kp, o, lse, do, **kw)
    second = FA.flash_attention_bwd(q, k, v, qp, kp, o, lse, do, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_splits", [1, 2, 4])
@pytest.mark.parametrize("D,Dv", [(128, 128), (192, 128), (40, 40)])
def test_flash_bwd_plans_match_plain(dev, dtype, head_splits, D, Dv):
    """Every split of the g = 4 heads over dK/dV blocks (none, two, four)
    gives the plain backward's gradients at bf16 (mma body) and fp32
    (split body), at a head dim of each bucket (a fixed-dim kernel at bf16,
    MLA's and a general one): the batch is the fewest rows (two at least:
    the ragged inputs) whose own plan on this card picks the split."""
    from repro_torch.kernels import scratch
    S, Hq, Hkv = 100, 8, 2
    sm = scratch.sm_count(torch.cuda.current_device())
    B = next(b for b in range(2, 4 * sm)
             if FA.bwd_plan(b, S, S, Hq, Hkv, D, Dv, dtype,
                            sm).head_splits == head_splits)
    q, k, v, do, qp, kp = _bwd_inputs(dev, dtype, B, S, S, Hq, Hkv, D, Dv,
                                      True)
    kw = dict(window=None, scale=D ** -0.5, attn_softcap=None)
    o, lse = FA.flash_attention(q, k, v, qp, kp, return_lse=True, **kw)
    got = FA.flash_attention_bwd(q, k, v, qp, kp, o, lse, do, **kw)
    want = FA.flash_attention_bwd_ref(q, k, v, qp, kp, o, lse, do, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() \
            <= TOL[dtype] * scale
    assert not got[0][qp < 0].any()


@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 1),
                                          (torch.bfloat16, 4),
                                          (torch.float32, 1),
                                          (torch.float32, 2)])
def test_flash_kernels_refuse_misaligned_views(dev, dtype, offset):
    """The tensor-core bodies copy with 16-byte cp.async: a bf16 or fp32
    view whose storage starts ``offset`` elements into its buffer (2, 8,
    4 or 8 bytes off) is refused by the forward's and the backward's
    wrappers before any launch."""
    B, S, H, D = 1, 16, 2, 64
    q, k, v, do, qp, kp = _bwd_inputs(dev, dtype, B, S, S, H, H, D, D,
                                      False)
    kw = dict(window=None, scale=D ** -0.5, attn_softcap=None)
    o, lse = FA.flash_attention(q, k, v, qp, kp, return_lse=True, **kw)
    buf = torch.zeros(q.numel() + offset, dtype=q.dtype, device=dev)
    bad = buf[offset:].view(q.shape)
    bad.copy_(q)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    launches = (FA.flash_attention.launches,
                FA.flash_attention_bwd.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.flash_attention(bad, k, v, qp, kp, **kw)
    for args in ((bad, k, v, qp, kp, o, lse, do),
                 (q, k, v, qp, kp, o, lse, bad)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            FA.flash_attention_bwd(*args, **kw)
    assert (FA.flash_attention.launches,
            FA.flash_attention_bwd.launches) == launches


def test_flash_fp32_launches_only_split_kernels(dev):
    """At fp32 the forward and the backward (with a head split, so its sum
    kernel too) launch only the tensor-core kernels' fp32 (split)
    instances, by their profiled names: no CUDA-core body is left."""
    from repro_torch.kernels import scratch
    S, Hq, Hkv, D = 100, 8, 2, 64
    sm = scratch.sm_count(torch.cuda.current_device())
    B = next(b for b in range(2, 4 * sm)
             if FA.bwd_plan(b, S, S, Hq, Hkv, D, D, torch.float32,
                            sm).head_splits > 1)
    q, k, v, do, qp, kp = _bwd_inputs(dev, torch.float32, B, S, S, Hq, Hkv,
                                      D, D, True)
    kw = dict(window=None, scale=D ** -0.5, attn_softcap=None)
    o, lse = FA.flash_attention(q, k, v, qp, kp, return_lse=True, **kw)
    # the names of three profiles each (a profile may miss an event)
    fwd, bwd = set(), set()
    for _ in range(3):
        fwd |= _device_kernels(lambda: FA.flash_attention(q, k, v, qp, kp,
                                                          **kw))
        bwd |= _device_kernels(lambda: FA.flash_attention_bwd(
            q, k, v, qp, kp, o, lse, do, **kw))
    assert fwd and all("flash_mma_kernel<float" in n for n in fwd), fwd
    parts = ("attn_bwd_dq_mma_kernel<float", "attn_bwd_dkdv_mma_kernel<float",
             "attn_bwd_dkdv_sum_kernel<float")
    assert all(any(s in n for n in bwd) for s in parts), bwd
    assert all(any(s in n for s in parts) for n in bwd), bwd


def test_flash_attention_grads_through_ops_on_card(dev):
    """``ops.flash_attention`` with grad on the card runs the forward and
    backward kernels (one launch each, none of the forward-only path) and
    gives autograd's gradient of the plain version (fp32)."""
    from repro_torch.kernels import ref
    q, k, v, do, qp, kp = _bwd_inputs(dev, torch.float32,
                                      *BWD_CASES[1][:7], False)
    kw = dict(window=None, scale=128 ** -0.5)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    out = ops.flash_attention(*leaves, qp, kp, **kw)
    got = torch.autograd.grad(out, leaves, do)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == 1
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        ref.flash_attention_ref(*cpu, qp.cpu(), kp.cpu(), **kw), cpu,
        do.cpu())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["unimo-text", "qwen3-4b",
                                  "deepseek-v3-671b"])
def test_train_step_on_card_matches_cpu(dev, arch):
    """One fp32 train step (TF32 off) of the reduced config on the card
    equals the CPU's: loss and gnorm within 1e-5, every parameter within
    1e-5 of its leaf's largest magnitude plus a gradient error of 1e-4 of
    the leaf's largest gradient carried through the first update (lr /
    eps times it: g / (|g| + eps) has slope at most 1 / eps; eps 1e-3, as
    in ``tests/test_torch_train.py``); attention ran through the forward
    and backward kernels (deepseek-v3: MLA's naive form at D 192 / Dv
    128, the MTP layer, the MoE's load-balance loss)."""
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_loop as TL
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced(arch)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(4, 400, size=(2, 48)).astype(np.int32),
             "labels": rng.integers(4, 400, size=(2, 48)).astype(np.int32),
             "loss_mask": np.ones((2, 48), np.float32)}
    ocfg = OPT.AdamWConfig(lr=1e-3, warmup_steps=1, eps=1e-3)
    res = {}
    for d in ("cpu", "cuda"):
        # a copy on each device: the step updates its parameters in place
        _, _, grads = TL._grads(map_params(lambda t: t.to(d, copy=True),
                                           params), cfg,
                                TL.to_device(batch, d), FP32, True)
        p = map_params(lambda t: t.to(d, copy=True), params)
        st = OPT.init_state(p)
        ops.reset_launch_counts()
        p, st, m = TL.make_train_step(cfg, ocfg, FP32)(
            p, st, TL.to_device(batch, d))
        res[d] = (float(m["loss"]), float(m["gnorm"]),
                  {k: t.detach().cpu() for k, t in OPT.flatten(p).items()},
                  {k: g.abs().max().item() for k, g in grads.items()})
    # one backward per attention layer (and the MTP layer); the forward
    # once more per rematerialised layer
    counts = ops.launch_counts()
    assert counts["flash_attention_bwd"] == cfg.num_layers + cfg.mtp
    assert counts["flash_attention"] == 2 * cfg.num_layers + cfg.mtp
    for a, b in zip(res["cuda"][:2], res["cpu"][:2]):
        assert a == pytest.approx(b, rel=1e-5)
    lr1 = OPT.lr_at(ocfg, 1)
    for k, w in res["cpu"][2].items():
        tol = 1e-5 * w.abs().max().item() \
            + lr1 * 1e-4 * res["cpu"][3][k] / ocfg.eps
        assert (res["cuda"][2][k] - w).abs().max().item() <= tol, k


def test_xlstm_training_on_card_matches_cpu(dev):
    """One fp32 train step (TF32 off) of reduced xlstm-125m on the card
    equals the CPU's, under the tolerances of
    ``test_train_step_on_card_matches_cpu``: the mLSTM layers ran through
    the forward kernel (twice: the step rematerialises each layer) and the
    backward kernel, once a layer; sLSTM in plain torch."""
    from repro_torch.configs.base import MLSTM, layer_specs
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_loop as TL
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("xlstm-125m")
    n_mlstm = sum(s.mixer == MLSTM for s in layer_specs(cfg))
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(4, 400, size=(2, 48)).astype(np.int32),
             "labels": rng.integers(4, 400, size=(2, 48)).astype(np.int32),
             "loss_mask": np.ones((2, 48), np.float32)}
    ocfg = OPT.AdamWConfig(lr=1e-3, warmup_steps=1, eps=1e-3)
    res = {}
    for d in ("cpu", "cuda"):
        _, _, grads = TL._grads(map_params(lambda t: t.to(d, copy=True),
                                           params), cfg,
                                TL.to_device(batch, d), FP32, True)
        p = map_params(lambda t: t.to(d, copy=True), params)
        ops.reset_launch_counts()
        p, _, m = TL.make_train_step(cfg, ocfg, FP32)(
            p, OPT.init_state(p), TL.to_device(batch, d))
        res[d] = (float(m["loss"]), float(m["gnorm"]),
                  {k: t.detach().cpu() for k, t in OPT.flatten(p).items()},
                  {k: g.abs().max().item() for k, g in grads.items()},
                  {k: g.cpu() for k, g in grads.items()})
    counts = ops.launch_counts()
    assert n_mlstm > 0 and counts["mlstm_chunked_bwd"] == n_mlstm
    assert counts["mlstm_chunked"] == 2 * n_mlstm
    assert sum(counts.values()) == 3 * n_mlstm
    for a, b in zip(res["cuda"][:2], res["cpu"][:2]):
        assert a == pytest.approx(b, rel=1e-5)
    for k, w in res["cpu"][4].items():
        assert (res["cuda"][4][k] - w).abs().max().item() \
            <= 1e-4 * max(res["cpu"][3][k], 1e-30), k
    lr1 = OPT.lr_at(ocfg, 1)
    for k, w in res["cpu"][2].items():
        tol = 1e-5 * w.abs().max().item() \
            + lr1 * 1e-4 * res["cpu"][3][k] / ocfg.eps
        assert (res["cuda"][2][k] - w).abs().max().item() <= tol, k


@pytest.mark.parametrize("arch", ["qwen3-4b", "xlstm-125m"])
def test_train_step_on_card_reads_nothing_back(dev, arch):
    """A train step of reduced qwen3-4b or xlstm-125m (the mLSTM kernels'
    forward and backward) on the card (factored AdamW, two microbatches,
    mixed precision) makes no host sync once warm: CUDA's sync debug mode
    raises on any."""
    from repro_torch.core.precision import MIXED
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_loop as TL
    cfg = get_reduced(arch)
    p = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                      MIXED)
    st = OPT.init_state(p, factored=True, model_cfg=cfg)
    step = TL.make_train_step(cfg, OPT.AdamWConfig(factored=True), MIXED,
                              grad_accum=2)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(4, 400, size=(4, 32)).astype(np.int32),
             "labels": rng.integers(4, 400, size=(4, 32)).astype(np.int32),
             "loss_mask": np.ones((4, 32), np.float32)}
    b = TL.to_device(batch, dev)
    p, st, _ = step(p, st, b)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p, st, m = step(p, st, b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(m["loss"]).item() and st.step == 2


# ---------------------------------------------------------------------------
# ragged_matmul: the grouped product of moe_ragged (forward, dRows, dW)
# ---------------------------------------------------------------------------

# (group sizes, K, N): empty experts, one-row experts and tiles cut by a
# group's end; K and N off the 64-wide tiles, off 8 (the element copies),
# and one group holding every row
RAGGED_CASES = [([1, 0, 17, 0, 3, 33, 0, 10], 64, 128),
                ([0, 0, 40, 0], 100, 70),
                ([5, 0, 0, 11], 96, 72),
                ([2] * 32, 256, 192)]
RAGGED_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _ragged_inputs(sizes, K, N, dtype, dev, seed=0, tail=0):
    """rows (sum(sizes) + tail, K) ~ N(0, 1), w (E, K, N) ~ N(0, 1 / K)
    (outputs of order one), int32 sizes, all on ``dev``."""
    rng = np.random.default_rng(seed)
    R = sum(sizes) + tail
    rows = torch.from_numpy(rng.normal(size=(R, K)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(len(sizes), K, N)).astype(
        np.float32) / K ** 0.5)
    return (rows.to(dev, dtype), w.to(dev, dtype),
            torch.tensor(sizes, dtype=torch.int32, device=dev))


def _close_scaled(got, want, tol):
    """Within ``tol`` of the larger of 1 and want's largest magnitude."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), err


@pytest.mark.parametrize("dtype", RAGGED_DTYPES)
@pytest.mark.parametrize("sizes,K,N", RAGGED_CASES)
def test_ragged_matmul_matches_plain(dev, sizes, K, N, dtype):
    """The forward kernel against ``ragged_matmul_ref`` at the same dtype
    (TF32 off): 1e-4 at fp32, 2e-2 at bf16 / fp16; 5 rows past the last
    group come out zero."""
    from repro_torch.kernels import ragged_matmul as RM
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, w, sz = _ragged_inputs(sizes, K, N, dtype, dev, tail=5)
    n0 = RM.ragged_matmul.launches
    out = RM.ragged_matmul(rows, w, sz)
    torch.cuda.synchronize()
    assert RM.ragged_matmul.launches == n0 + 1 and out.dtype == dtype
    _close_scaled(out, RM.ragged_matmul_ref(rows, w, sz), TOL[dtype])
    assert (out[sum(sizes):] == 0).all()


@pytest.mark.parametrize("dtype", RAGGED_DTYPES)
@pytest.mark.parametrize("sizes,K,N", RAGGED_CASES)
def test_ragged_matmul_bwd_matches_plain_autograd(dev, sizes, K, N, dtype):
    """dRows (the kernel reading w transposed) and dW (summed over each
    group's rows; zeros for an empty expert) against autograd of the
    plain version, through ``ops.ragged_matmul`` (``RaggedMatmulFn``)."""
    from repro_torch.kernels import ragged_matmul as RM
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, w, sz = _ragged_inputs(sizes, K, N, dtype, dev, seed=1)
    cot = torch.randn(rows.shape[0], N, generator=torch.Generator(
        device=dev).manual_seed(2), device=dev).to(dtype)
    grads = []
    for fn in (ops.ragged_matmul, RM.ragged_matmul_ref):
        r, ww = (t.clone().requires_grad_() for t in (rows, w))
        fn(r, ww, sz).backward(cot)
        grads.append((r.grad, ww.grad))
    (dr, dw), (pr, pw) = grads
    _close_scaled(dr, pr, TOL[dtype])
    _close_scaled(dw, pw, TOL[dtype])
    for e in np.flatnonzero(np.asarray(sizes) == 0):
        assert (dw[e] == 0).all()


@pytest.mark.parametrize("dtype", RAGGED_DTYPES)
def test_ragged_matmul_bit_identical_twice(dev, dtype):
    """No atomics: two calls of the forward and of the backward give the
    same bits."""
    from repro_torch.kernels import ragged_matmul as RM
    rows, w, sz = _ragged_inputs(*RAGGED_CASES[0], dtype, dev)
    dout = torch.randn(rows.shape[0], w.shape[2], device=dev).to(dtype)
    a = [RM.ragged_matmul(rows, w, sz),
         *RM.ragged_matmul_bwd(rows, w, sz, dout)]
    b = [RM.ragged_matmul(rows, w, sz),
         *RM.ragged_matmul_bwd(rows, w, sz, dout)]
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", RAGGED_DTYPES)
def test_ragged_matmul_never_reads_unrouted_experts(dev, dtype):
    """Every expert that received no rows has its slab of w filled with
    NaN: the forward and dRows stay finite and equal to the same call
    with zeros there, and those experts' dW is zero."""
    from repro_torch.kernels import ragged_matmul as RM
    sizes, K, N = RAGGED_CASES[0]
    rows, w, sz = _ragged_inputs(sizes, K, N, dtype, dev)
    empty = torch.from_numpy(np.asarray(sizes) == 0).to(dev)
    w_nan = w.clone()
    w_nan[empty] = float("nan")
    w_zero = w.clone()
    w_zero[empty] = 0
    dout = torch.randn(rows.shape[0], N, device=dev).to(dtype)
    out = RM.ragged_matmul(rows, w_nan, sz)
    dr, dw = RM.ragged_matmul_bwd(rows, w_nan, sz, dout)
    assert torch.isfinite(out).all() and torch.isfinite(dr).all()
    assert torch.equal(out, RM.ragged_matmul(rows, w_zero, sz))
    assert torch.equal(dr, RM.ragged_matmul_bwd(rows, w_zero, sz, dout)[0])
    assert (dw[empty] == 0).all()


def test_ragged_matmul_wrapper_rejects_bad_inputs(dev):
    """Wrong device, dtype, sizes dtype, shape or layout raise; nothing
    falls back to the plain version."""
    from repro_torch.kernels import ragged_matmul as RM
    rows, w, sz = _ragged_inputs([3, 5], 16, 8, torch.bfloat16, dev)
    bad = [(rows.cpu(), w, sz), (rows.float(), w, sz),
           (rows, w, sz.long()), (rows[:, :8], w, sz),
           (rows, w.transpose(1, 2).contiguous().transpose(1, 2), sz),
           (rows, w, sz[:1])]
    for args in bad:
        with pytest.raises(ValueError):
            RM.ragged_matmul(*args)
    with pytest.raises(ValueError):
        RM.ragged_matmul_bwd(rows, w, sz, torch.zeros(7, 8, device=dev,
                                                      dtype=rows.dtype))


# the wgmma bodies' edges: groups of more than 64 and 128 rows (several
# 64-row items of one expert, dW's chunks), group starts off 8 and 16
# rows, K and N multiples of 8 but not of 64 (partial TMA boxes, a second
# B box past N), E = 256 with most experts empty, 5 rows past the groups
RAGGED_EDGE_CASES = [([70, 0, 130, 5], 256, 192),
                     ([3, 13, 7, 21, 0, 9, 1], 128, 128),
                     ([10, 37, 0, 70], 200, 136),
                     ([0] * 100 + [3] + [0] * 100 + [40] + [0] * 50
                      + [1, 2, 0, 5], 128, 256)]


@pytest.mark.parametrize("dtype", RAGGED_DTYPES)
@pytest.mark.parametrize("sizes,K,N", RAGGED_EDGE_CASES)
def test_ragged_matmul_edges_match_plain(dev, sizes, K, N, dtype):
    """Forward, dRows and dW at the wgmma bodies' edges against the plain
    version (autograd through it for the gradients), as the cases above;
    zeros past the groups and for the empty experts' dW."""
    from repro_torch.kernels import ragged_matmul as RM
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, w, sz = _ragged_inputs(sizes, K, N, dtype, dev, tail=5)
    out = RM.ragged_matmul(rows, w, sz)
    _close_scaled(out, RM.ragged_matmul_ref(rows, w, sz), TOL[dtype])
    assert (out[sum(sizes):] == 0).all()
    dout = torch.randn(rows.shape[0], N, generator=torch.Generator(
        device=dev).manual_seed(3), device=dev).to(dtype)
    dr, dw = RM.ragged_matmul_bwd(rows, w, sz, dout)
    r, ww = rows.clone().requires_grad_(), w.clone().requires_grad_()
    pr, pw = torch.autograd.grad(RM.ragged_matmul_ref(r, ww, sz), (r, ww),
                                 dout)
    _close_scaled(dr, pr, TOL[dtype])
    _close_scaled(dw, pw, TOL[dtype])
    empty = torch.from_numpy(np.asarray(sizes) == 0).to(dev)
    assert (dw[empty] == 0).all()


@pytest.mark.parametrize("dtype", RAGGED_DTYPES)
@pytest.mark.parametrize("sizes,K,N", RAGGED_EDGE_CASES[:3])
def test_ragged_matmul_dw_reads_no_row_of_the_next_group(dev, sizes, K, N,
                                                         dtype):
    """dW sums each group over its own rows only: with the rows and dOut
    of every group after the first set to NaN, the first group's dw[e]
    stays finite and equal to the call with those rows finite (the wgmma
    body loads 16-row boxes past a group's end and zeroes them)."""
    from repro_torch.kernels import ragged_matmul as RM
    rows, w, sz = _ragged_inputs(sizes, K, N, dtype, dev, seed=4)
    dout = torch.randn(rows.shape[0], N, device=dev).to(dtype)
    e = next(i for i, n in enumerate(sizes) if n)
    end = sum(sizes[:e + 1])
    dw = RM.ragged_matmul_bwd(rows, w, sz, dout, need_rows=False)[1]
    rn, dn = rows.clone(), dout.clone()
    rn[end:] = float("nan")
    dn[end:] = float("nan")
    got = RM.ragged_matmul_bwd(rn, w, sz, dn, need_rows=False)[1]
    assert torch.isfinite(got[e]).all()
    assert torch.equal(got[e], dw[e])


@pytest.mark.parametrize("dtype", RAGGED_DTYPES)
def test_ragged_matmul_edges_bit_identical_without_host_sync(dev, dtype):
    """Every edge shape twice: the same bits, and no call reads a value
    back to the host (CUDA sync debug mode raises on one)."""
    from repro_torch.kernels import ragged_matmul as RM
    runs = []
    for sizes, K, N in RAGGED_EDGE_CASES:
        rows, w, sz = _ragged_inputs(sizes, K, N, dtype, dev)
        dout = torch.randn(rows.shape[0], N, device=dev).to(dtype)
        RM.ragged_matmul(rows, w, sz)                # the build, warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(2):
                runs.append([RM.ragged_matmul(rows, w, sz),
                             *RM.ragged_matmul_bwd(rows, w, sz, dout)])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(runs[::2], runs[1::2]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ragged_matmul_16bit_runs_the_wgmma_bodies(dev, dtype):
    """At K, N multiples of 8 the forward, dRows and dW launch the wgmma +
    TMA kernels alone; at K = 100 the mma.sync ones."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ragged_matmul as RM

    def names(sizes, K, N):
        rows, w, sz = _ragged_inputs(sizes, K, N, dtype, dev)
        dout = torch.randn(rows.shape[0], N, device=dev).to(dtype)
        RM.ragged_matmul(rows, w, sz)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            RM.ragged_matmul(rows, w, sz)
            RM.ragged_matmul_bwd(rows, w, sz, dout)
            torch.cuda.synchronize()
        return {e.name for e in prof.events() if "ragged_" in e.name}
    tma = names(*RAGGED_EDGE_CASES[0])
    assert any("ragged_mm_tma_kernel" in n for n in tma)
    assert any("ragged_dw_tma_kernel" in n for n in tma)
    assert all("_tma_kernel" in n for n in tma), tma
    mma = names([0, 0, 40, 0], 100, 70)
    assert mma and not any("_tma_kernel" in n for n in mma), mma


def test_ragged_matmul_fp32_runs_the_split_wgmma_bodies(dev):
    """At fp32 with K, N multiples of 4 the forward, dRows and dW launch
    the wgmma + TMA kernels that cut fp32 tiles into bf16 parts
    (``_f32_tma_kernel``) alone; at N = 70 the CUDA-core ones."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ragged_matmul as RM

    def names(sizes, K, N):
        rows, w, sz = _ragged_inputs(sizes, K, N, torch.float32, dev)
        dout = torch.randn(rows.shape[0], N, device=dev)
        RM.ragged_matmul(rows, w, sz)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            RM.ragged_matmul(rows, w, sz)
            RM.ragged_matmul_bwd(rows, w, sz, dout)
            torch.cuda.synchronize()
        return {e.name for e in prof.events() if "ragged_" in e.name}
    split = names(*RAGGED_EDGE_CASES[0])
    assert any("ragged_mm_f32_tma_kernel" in n for n in split)
    assert any("ragged_dw_f32_tma_kernel" in n for n in split)
    assert all("_f32_tma_kernel" in n for n in split), split
    cores = names([0, 0, 40, 0], 100, 70)
    assert cores and not any("_tma_kernel" in n for n in cores), cores


def _fp64_gate(got, plain, truth):
    """The kernel's error against the fp64 evaluation at most four times
    the plain fp32 version's, or 1e-6 of the output's scale."""
    scale = max(truth.abs().max().item(), 1e-30)
    err = (got.double() - truth).abs().max().item() / scale
    perr = (plain.double() - truth).abs().max().item() / scale
    assert err <= max(4 * perr, 1e-6), (err, perr)


@pytest.mark.parametrize("sizes,K,N", RAGGED_EDGE_CASES + [
    ([8] * 16, 512, 256)])
def test_ragged_matmul_fp32_holds_fp64_gate(dev, sizes, K, N):
    """The fp32 wgmma bodies (three bf16 parts an operand) against the
    plain version in fp64: the forward, dRows and dW each within four
    times the plain fp32 version's error or 1e-6 of the scale."""
    from repro_torch.kernels import ragged_matmul as RM
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, w, sz = _ragged_inputs(sizes, K, N, torch.float32, dev, tail=3)
    dout = torch.randn(rows.shape[0], N, generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    _fp64_gate(RM.ragged_matmul(rows, w, sz),
               RM.ragged_matmul_ref(rows, w, sz),
               RM.ragged_matmul_ref(rows.double(), w.double(), sz))
    got = RM.ragged_matmul_bwd(rows, w, sz, dout)
    grads = []
    for dt in (torch.float32, torch.float64):
        r = rows.to(dt).requires_grad_()
        ww = w.to(dt).requires_grad_()
        grads.append(torch.autograd.grad(RM.ragged_matmul_ref(r, ww, sz),
                                         (r, ww), dout.to(dt)))
    for g, p, t in zip(got, *grads):
        _fp64_gate(g, p, t)


def _ragged_moe(monkeypatch):
    monkeypatch.setenv("REPRO_PERF_OPTS", "moe_ragged")
    torch.backends.cuda.matmul.allow_tf32 = False
    return _moe_case()


def test_moe_apply_ragged_on_card_matches_cpu(dev, monkeypatch):
    """``moe_apply`` under ``moe_ragged``, fp32, at the capacity factor
    1.5 (where capacity dispatch would drop): the card's output equals the
    CPU's within 1e-5, two calls are bit-equal, neither reads a value back
    to the host (CUDA sync debug mode raises on one), and each runs the
    three grouped products through the kernel."""
    from repro_torch.kernels import ragged_matmul as RM
    M, cfg, p, x = _ragged_moe(monkeypatch)
    want = M.moe_apply(cfg, p, x)[0]
    pd = {k: v.to(dev) for k, v in p.items()}
    xd = x.to(dev)
    M.moe_apply(cfg, pd, xd)                     # warm-up: the build
    torch.cuda.synchronize()
    n0 = RM.ragged_matmul.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = M.moe_apply(cfg, pd, xd)[0]
        b = M.moe_apply(cfg, pd, xd)[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert RM.ragged_matmul.launches == n0 + 6
    assert torch.equal(a, b)
    torch.testing.assert_close(a.cpu(), want, rtol=1e-5, atol=1e-5)


def test_moe_apply_ragged_grads_on_card_match_cpu(dev, monkeypatch):
    """The gradients of ``sum(out * c) + aux`` under ``moe_ragged``, fp32,
    for every parameter and x: card (``RaggedMatmulFn``: one backward call
    a product) == CPU within 1e-5 of each leaf's largest magnitude."""
    from repro_torch.kernels import ragged_matmul as RM
    M, cfg, p, x = _ragged_moe(monkeypatch)
    cot = torch.from_numpy(np.random.default_rng(6).normal(
        size=x.shape).astype(np.float32))
    grads = {}
    n0 = RM.ragged_matmul_bwd.launches
    for d in ("cpu", "cuda"):
        pd = {k: v.to(d, copy=True).requires_grad_() for k, v in p.items()}
        xd = x.to(d, copy=True).requires_grad_()
        out, aux = M.moe_apply(cfg, pd, xd)
        ((out * cot.to(d)).sum() + aux).backward()
        grads[d] = {"x": xd.grad, **{k: v.grad for k, v in pd.items()}}
    assert RM.ragged_matmul_bwd.launches == n0 + 3
    for k, want in grads["cpu"].items():
        _close_scaled(grads["cuda"][k].cpu() / want.abs().max(),
                      want / want.abs().max(), 1e-5)


def test_host_mesh_targets_match_unmeshed(dev):
    """Reduced qwen3-4b through ``specs.make_target`` on the card's real
    (1, 1) mesh (``make_host_mesh``: nccl, one rank): a train step and a
    prefill equal the same steps unmeshed on the same parameters, bit for
    bit (every shard is whole), with the same kernel launches."""
    import torch.distributed as dist
    from repro_torch.core.precision import BF16, MIXED
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs as SPC
    from repro_torch.sharding import partition as SH
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train_loop import make_train_step

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    cfg = get_reduced("qwen3-4b")
    mesh = M.make_host_mesh()
    try:
        t = SPC.train_target(cfg, mesh, {"kind": "train", "seq": 64,
                                         "batch": 2}, policy=MIXED,
                             factored=True, grad_accum=1,
                             moment_dtype=torch.float32, fsdp=False)
        params, _, batch = t.args
        plain = SH.map_tree(lambda n, x: local(x).clone(), params)
        pbatch = {k: local(v).clone() for k, v in batch.items()}
        ops.reset_launch_counts()
        _, _, m = t.fn(*t.args)
        l_mesh = ops.launch_counts()
        step = make_train_step(cfg, OPT.AdamWConfig(factored=True),
                               policy=MIXED, remat=True)
        ops.reset_launch_counts()
        _, _, mu = step(plain, OPT.init_state(plain, factored=True,
                                              model_cfg=cfg), pbatch)
        assert ops.launch_counts() == l_mesh
        assert l_mesh["flash_attention"] > 0
        assert float(local(m["loss"])) == float(mu["loss"])
        for path, p in OPT.flatten(params).items():
            assert torch.equal(local(p), OPT.flatten(plain)[path]), path

        tp = SPC.make_target(cfg, "prefill", mesh,
                             info={"kind": "prefill", "seq": 64, "batch": 4})
        ops.reset_launch_counts()
        lp, _ = tp.fn(*tp.args)
        l_mesh = ops.launch_counts()
        pl = SH.map_tree(lambda n, x: local(x), tp.args[0])
        cache = T.init_cache(cfg, 4, 64, torch.bfloat16, device=dev)
        ops.reset_launch_counts()
        lu, _ = T.forward_prefill(pl, cfg, local(tp.args[1]),
                                  local(tp.args[2]), cache, policy=BF16,
                                  max_len=64, last_only=True)
        assert ops.launch_counts() == l_mesh
        assert torch.equal(local(lp), lu)
    finally:
        SH.set_current_mesh(None)
        dist.destroy_process_group()
