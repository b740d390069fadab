"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here carries the ``cuda`` marker and skips without a CUDA
device; run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 pools differ from the plain version only in summation
order (1e-4); bf16/fp16 outputs are rounded to the working type by both,
so they may differ by an ulp of it (2e-2 on values of order one).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_reduced
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.precision import FP32
from repro_torch.core.scheduler import Request
from repro_torch.kernels import decode_attention as DA
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
