"""The arithmetic of flash attention's fp32 bodies on the tensor cores,
emulated on the CPU.

At fp32 the forward (``csrc/flash_attention.cu`` over ``csrc/attn_mma.cuh``)
and the backward's "split" body (``csrc/flash_attention_bwd.cu``) run every
product on bf16 tensor cores: each fp32 operand, the softmax weights P and
dS included, is cut into ``flash_attention.SPLIT_PARTS`` bf16 parts (each
part the bf16 rounding of what the parts before it left), and of the part
pairs (i, j) those with i + j below the count are multiplied
(``mma_parts_apart``), the leading pair's products in one accumulator and
the rest in another, added once.  The products over a 32-key (or 32-pair)
tile that feed O, dQ, dK and dV sum in fresh accumulators that are added
to the running sums with fp32 adds (``mma_xb_split``).

The emulation repeats that walk tile by tile: the online softmax of the
forward (base-2 exponents, running max and denominator, the rescale) and
the backward's two kernels (dQ over key tiles; dK and dV over tiles of
(query, head) pairs), with each ``mma.m16n8k16`` modelled pessimistically:
products exact, every term aligned to the largest one's exponent with
truncation, the sum truncated to fp32 (the tensor cores' fp32 accumulation
rounds toward zero).  With the plan's part count every output is within
1e-5 of its scale of the same formulas evaluated in fp64 on the same
inputs; with one part per operand (bf16 operands) none is.  The kernels
themselves are held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA

TOL = 1e-5            # of each output's largest magnitude
TILE = 32             # keys (forward, dQ) or (query, head) pairs a tile
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)


def _rz32(x):
    """fp64 values rounded toward zero to fp32."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _mma(c, a, b):
    """One mma.m16n8k16 with fp32 accumulators: c (M, N) + a (M, 16) .
    b (16, N), the operands bf16 values.  Products exact; each of the 16
    products and c is truncated to the ulp of the largest term's
    exponent, the exact sum of those truncated to fp32."""
    terms = np.concatenate([a.astype(np.float64)[:, :, None]
                            * b.astype(np.float64)[None],
                            c.astype(np.float64)[:, None]], axis=1)
    mx = np.abs(terms).max(axis=1, keepdims=True)
    ulp = np.exp2(np.floor(np.log2(np.where(mx > 0, mx, 1.0))) - 23)
    return _rz32((np.trunc(terms / ulp) * ulp).sum(axis=1))


def _parts(x, n):
    """x (fp32) as n bf16 parts: each the bf16 rounding of the rest."""
    out, r = [], torch.from_numpy(np.ascontiguousarray(x, np.float32))
    for _ in range(n):
        p = r.to(torch.bfloat16).float()
        out.append(p.numpy())
        r = r - p
    return out


def _mm_parts(a, b, n, acc=None):
    """a (M, K) . b (K, N), K a multiple of 16, as the kernels take it:
    per 16-wide k-step the parts' products, pair (0, 0) into ``hi`` and
    the pairs 0 < i + j < n into ``lo`` (mma_parts_apart's order), then
    hi + lo; added to ``acc`` with an fp32 add when given."""
    M, N = a.shape[0], b.shape[1]
    hi = np.zeros((M, N), np.float32)
    lo = np.zeros((M, N), np.float32)
    for k0 in range(0, a.shape[1], 16):
        ap, bp = _parts(a[:, k0:k0 + 16], n), _parts(b[k0:k0 + 16], n)
        hi = _mma(hi, ap[0], bp[0])
        for i in range(n):
            for j in range(n):
                if 0 < i + j < n:
                    lo = _mma(lo, ap[i], bp[j])
    tile = hi + lo
    return tile if acc is None else acc + tile


def _pad16(x):
    return np.pad(x, ((0, 0), (0, -x.shape[1] % 16)))


def _fma32(x, y, z):
    return (x.astype(np.float64) * y + z).astype(np.float32)


def _visible(kp, qp, window):
    v = (kp[None] >= 0) & (kp[None] <= qp[:, None])
    if window:
        v &= kp[None] > qp[:, None] - window
    return v


def forward_split(q, k, v, qp, kp, scale, cap, window, n):
    """One head's rows q (R, D) against k (S, D), v (S, Dv), as the fp32
    forward computes them with n parts: (out (R, Dv), lse (R,))."""
    R, S = q.shape[0], k.shape[0]
    Dv = v.shape[1]
    qq, kk = _pad16(q), _pad16(k)
    to2 = np.float32(LOG2E if cap else np.float32(scale) * LOG2E)
    o = np.zeros((R, Dv), np.float32)
    m = np.full(R, -np.inf, np.float32)
    ll = np.zeros(R, np.float32)
    for t0 in range(0, S, TILE):
        kt = np.zeros((TILE, kk.shape[1]), np.float32)
        vt = np.zeros((TILE, Dv), np.float32)
        kpt = np.full(TILE, -1, np.int32)
        nt = min(TILE, S - t0)
        kt[:nt], vt[:nt], kpt[:nt] = kk[t0:t0 + nt], v[t0:t0 + nt], \
            kp[t0:t0 + nt]
        s = _mm_parts(qq, kt.T, n)
        if cap:
            s = (np.tanh(s * np.float32(scale) / np.float32(cap))
                 * np.float32(cap)).astype(np.float32)
        s = np.where(_visible(kpt, qp, window), s, -np.inf)
        m_new = np.maximum(m, s.max(axis=1))
        m_use = np.where(m_new == -np.inf, np.float32(0),
                         m_new * to2).astype(np.float32)
        with np.errstate(invalid="ignore"):
            # rescale from the rounded m * to2 the last tile's exponents
            # used, not from the exact product
            alpha = np.exp2((m * to2).astype(np.float32) - m_use)
            p = np.exp2(_fma32(s, to2, -m_use[:, None]))
        alpha = np.where(m == -np.inf, np.float32(0), alpha)
        p = np.where(s == -np.inf, np.float32(0), p).astype(np.float32)
        m = m_new
        ll = ll * alpha + p.sum(axis=1, dtype=np.float32)
        o = _mm_parts(p, vt, n, acc=o * alpha[:, None])
    inv = np.where(ll > 0, np.float32(1) / np.where(ll > 0, ll, 1), 0)
    lse = np.where(ll > 0, (m * to2 + np.log2(np.where(ll > 0, ll, 1)))
                   * LN2, np.inf).astype(np.float32)
    return (o * inv[:, None]).astype(np.float32), lse


def backward_split(q, k, v, qp, kp, o, lse, do, scale, cap, window, n, g):
    """The fp32 backward's two kernels with n parts, for the g query heads
    of one kv head: q, o, do (Sq, g, D[v]), lse (Sq, g); k (Sk, D), v (Sk,
    Dv).  Returns (dq (Sq, g, D), dk (Sk, D), dv (Sk, Dv))."""
    Sq, _, D = q.shape
    Dv = v.shape[1]
    to2 = np.float32(LOG2E if cap else np.float32(scale) * LOG2E)
    delta = (do * o).sum(axis=-1, dtype=np.float32)
    l2 = (lse * LOG2E).astype(np.float32)

    def probs(s, dp, l2r, dl, vis):
        chain = np.float32(1)
        if cap:
            th = np.tanh(s * np.float32(scale) / np.float32(cap))
            s = (th * np.float32(cap)).astype(np.float32)
            chain = (np.float32(1) - th * th).astype(np.float32)
        with np.errstate(invalid="ignore"):
            p = np.exp2(_fma32(s, to2, -l2r)).astype(np.float32)
        p = np.where(vis, p, np.float32(0))
        return p, (p * (dp - dl) * chain).astype(np.float32)

    # dQ: rows (query, head) in order qi * g + hi, 32-key tiles
    rows_q = _pad16(q.reshape(Sq * g, D))
    rows_do = _pad16(do.reshape(Sq * g, Dv))
    rqp = np.repeat(qp, g)
    dq = np.zeros((Sq * g, rows_q.shape[1]), np.float32)
    kk, vv = _pad16(k), _pad16(v)
    for t0 in range(0, k.shape[0], TILE):
        sl = slice(t0, t0 + TILE)
        kt = np.zeros((TILE, kk.shape[1]), np.float32)
        vt = np.zeros((TILE, vv.shape[1]), np.float32)
        kpt = np.full(TILE, -1, np.int32)
        nt = len(kp[sl])
        kt[:nt], vt[:nt], kpt[:nt] = kk[sl], vv[sl], kp[sl]
        s = _mm_parts(rows_q, kt.T, n)
        dp = _mm_parts(rows_do, vt.T, n)
        _, ds = probs(s, dp, l2.reshape(-1)[:, None],
                      delta.reshape(-1)[:, None], _visible(kpt, rqp, window))
        dq = _mm_parts(ds, kt, n, acc=dq)
    dq = (dq[:, :D] * np.float32(scale)).reshape(Sq, g, D)

    # dK / dV: rows the keys, tiles of 32 (query, head) pairs
    pq, pdo = rows_q, rows_do
    pl2, pdl = l2.reshape(-1), delta.reshape(-1)
    dk = np.zeros((k.shape[0], kk.shape[1]), np.float32)
    dv = np.zeros((k.shape[0], vv.shape[1]), np.float32)
    for t0 in range(0, Sq * g, TILE):
        nt = min(TILE, Sq * g - t0)
        qt = np.zeros((TILE, pq.shape[1]), np.float32)
        dot = np.zeros((TILE, pdo.shape[1]), np.float32)
        l2t = np.full(TILE, np.inf, np.float32)
        dlt = np.zeros(TILE, np.float32)
        qpt = np.full(TILE, -1, np.int32)
        sl = slice(t0, t0 + nt)
        qt[:nt], dot[:nt], l2t[:nt], dlt[:nt], qpt[:nt] = \
            pq[sl], pdo[sl], pl2[sl], pdl[sl], rqp[sl]
        st = _mm_parts(kk, qt.T, n)
        dpt = _mm_parts(vv, dot.T, n)
        pt, dst = probs(st, dpt, l2t[None], dlt[None],
                        _visible(kp, qpt, window).T)
        dv = _mm_parts(pt, dot, n, acc=dv)
        dk = _mm_parts(dst, qt, n, acc=dk)
    return dq, dk[:, :D] * np.float32(scale), dv[:, :Dv]


def _truth(q, k, v, qp, kp, o, lse, do, scale, cap, window):
    """The plain forward and backward (kernels/ref.py's formulas) in fp64,
    for one kv head's g query heads: the forward from q, k, v; the backward
    from the given o and lse."""
    q, k, v, o, do = (x.astype(np.float64) for x in (q, k, v, o, do))
    s = np.einsum("qhd,kd->hqk", q, k) * scale
    t = None
    if cap:
        t = np.tanh(s / cap)
        s = t * cap
    vis = _visible(kp, qp, window)[None]
    sm = np.where(vis, s, -np.inf)
    mx = sm.max(-1, keepdims=True)
    e = np.where(vis, np.exp(sm - np.where(np.isfinite(mx), mx, 0)), 0)
    den = e.sum(-1, keepdims=True)
    out = np.einsum("hqk,kd->qhd", e / np.where(den > 0, den, 1), v)
    lse_t = np.where(den[..., 0] > 0, np.log(np.where(den > 0, den, 1))[..., 0]
                     + mx[..., 0], np.inf).T
    p = np.where(vis, np.exp(s - lse.astype(np.float64).T[..., None]), 0)
    delta = (do * o).sum(-1).T[..., None]
    ds = p * (np.einsum("qhd,kd->hqk", do, v) - delta)
    if t is not None:
        ds = ds * (1 - t * t)
    ds = ds * scale
    return (out, lse_t, np.einsum("hqk,kd->qhd", ds, k),
            np.einsum("hqk,qhd->kd", ds, q), np.einsum("hqk,qhd->kd", p, do))


def _rel(got, want):
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    return float(np.abs(np.asarray(got, np.float64)[fin] - want[fin]).max()
                 / np.abs(want[fin]).max())


# (S, g, D, Dv, window, softcap, ragged): unimo-text's head dim 64; GQA with
# a ragged walk (-1 keys, padding queries) under a window and a softcap; MLA
# 192 / 128 style unequal dims
CASES = [(70, 1, 64, 64, None, None, False),
         (45, 2, 32, 32, 16, 30.0, True),
         (40, 1, 48, 32, None, None, False)]


def _inputs(S, g, D, Dv, ragged, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, g, D)).astype(np.float32)
    k = rng.normal(size=(S, D)).astype(np.float32)
    v = rng.normal(size=(S, Dv)).astype(np.float32)
    do = rng.normal(size=(S, g, Dv)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    kp, qp = pos.copy(), pos.copy()
    if ragged:
        kp[3:9] = -1
        qp[-5:] = -1
    return q, k, v, do, qp, kp


def _run(S, g, D, Dv, window, cap, ragged, n):
    q, k, v, do, qp, kp = _inputs(S, g, D, Dv, ragged)
    scale = D ** -0.5
    rows_qp = np.repeat(qp, g)
    out, lse = forward_split(q.reshape(S * g, D), k, v, rows_qp, kp, scale,
                             cap, window, n)
    out, lse = out.reshape(S, g, Dv), lse.reshape(S, g)
    # the backward from the fp64 forward's o and lse, rounded to fp32: the
    # inputs the truth's backward takes too
    t_out, t_lse = _truth(q, k, v, qp, kp, out, lse, do, scale, cap,
                          window)[:2]
    o32, lse32 = t_out.astype(np.float32), t_lse.astype(np.float32)
    truth = _truth(q, k, v, qp, kp, o32, lse32, do, scale, cap, window)
    grads = backward_split(q, k, v, qp, kp, o32, lse32, do, scale, cap,
                           window, n, g)
    return {"out": _rel(out, truth[0]), "lse": _rel(lse, truth[1]),
            "dq": _rel(grads[0], truth[2]), "dk": _rel(grads[1], truth[3]),
            "dv": _rel(grads[2], truth[4])}


@pytest.mark.parametrize("S,g,D,Dv,window,cap,ragged", CASES)
def test_plan_parts_hold_fp32_accuracy(S, g, D, Dv, window, cap, ragged):
    errs = _run(S, g, D, Dv, window, cap, ragged, FA.SPLIT_PARTS)
    assert all(e <= TOL for e in errs.values()), errs


@pytest.mark.parametrize("S,g,D,Dv,window,cap,ragged", CASES[:2])
def test_one_part_per_operand_misses(S, g, D, Dv, window, cap, ragged):
    # bf16 operands (what a plain bf16 body would multiply): every output
    # but the log-sum-exp, whose scores' errors largely cancel, misses
    errs = _run(S, g, D, Dv, window, cap, ragged, 1)
    assert all(errs[n] > TOL for n in ("out", "dq", "dk", "dv")), errs


def test_long_row_lse_keeps_one_base():
    """The last 64 rows over 4,096 keys at the fp32 body's arithmetic:
    their log-sum-exp within the card's fp64 gate (four times the plain
    fp32 version's error, or 1e-6 of the scale).  Rescaling the running
    sum from the exact max times to2, where the exponents used its
    rounding, drifts past it by that rounding at every new maximum."""
    S, D, R = 4096, 64, 64
    rng = np.random.default_rng(3)
    q = rng.normal(size=(R, D)).astype(np.float32)
    k = rng.normal(size=(S, D)).astype(np.float32)
    v = rng.normal(size=(S, 8)).astype(np.float32)
    kp = np.arange(S, dtype=np.int32)
    qp = kp[-R:]
    scale = D ** -0.5
    _, lse = forward_split(q, k, v, qp, kp, scale, None, None,
                           FA.SPLIT_PARTS)
    vis = _visible(kp, qp, None)
    s64 = np.where(vis, (q.astype(np.float64) @ k.T.astype(np.float64))
                   * scale, -np.inf)
    mx = s64.max(axis=1, keepdims=True)
    truth = (mx + np.log(np.exp(s64 - mx).sum(axis=1, keepdims=True)))[:, 0]
    s32 = np.where(vis, (q @ k.T) * np.float32(scale), -np.inf)
    mx32 = s32.max(axis=1, keepdims=True)
    plain = (mx32 + np.log(np.exp(s32 - mx32).sum(
        axis=1, keepdims=True, dtype=np.float32)))[:, 0].astype(np.float32)
    scale_t = np.abs(truth).max()
    err = np.abs(lse - truth).max() / scale_t
    perr = np.abs(plain - truth).max() / scale_t
    assert err <= max(4 * perr, 1e-6), (err, perr)


def test_parts_sum_to_the_value():
    # three bf16 parts hold an fp32 value to 2^-24 of its size or better;
    # the pairs i + j < 3 drop only products below 2^-24 of the leading one
    x = np.random.default_rng(1).normal(size=4096).astype(np.float32) \
        * np.float32(2.0) ** np.arange(-20, 20, 10, dtype=np.float32)[:, None]
    ps = _parts(x, FA.SPLIT_PARTS)
    rest = x.astype(np.float64) - sum(p.astype(np.float64) for p in ps)
    assert np.all(np.abs(rest) <= np.abs(x) * 2.0 ** -24)
    assert np.all(np.abs(ps[1]) <= np.abs(x) * 2.0 ** -8)
