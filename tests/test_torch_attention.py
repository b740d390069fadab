"""The port's paged attention against the reference package.

The port's plain ``paged_decode_attention`` / ``paged_packed_attention``
(the CPU path of its CUDA kernels, and the target the kernels are held
against on the card) must match the reference's Pallas kernels run in
interpret mode and the reference's jnp oracles on the same inputs, made
from a seed with numpy.  Everything is fp32, so the two frameworks differ
only in summation order: atol = rtol = 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.kernels import decode_attention as JDA
from repro.kernels import ref as JREF
from repro.models import layers as JL
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)
P, PAGE, NPAGES, HKV, D = 14, 8, 4, 2, 16


def _pools(rng, ctx_lens):
    """Pools, positions and block tables for slots holding ``ctx_lens``
    tokens (a slot of length 0 has no pages: an all -1 table row).  The
    pages are scattered over the pool; the last pool page is the dump."""
    kpool = rng.normal(size=(P, PAGE, HKV, D)).astype(np.float32)
    vpool = rng.normal(size=(P, PAGE, HKV, D)).astype(np.float32)
    ppos = np.full((P, PAGE), -1, np.int32)
    bt = np.full((len(ctx_lens), NPAGES), -1, np.int32)
    perm = rng.permutation(P - 1)
    nxt = 0
    for b, n in enumerate(ctx_lens):
        used = -(-n // PAGE)
        bt[b, :used] = perm[nxt:nxt + used]
        nxt += used
        for t in range(n):
            ppos[bt[b, t // PAGE], t % PAGE] = t
    return kpool, vpool, ppos, bt


def _t(a):
    return torch.from_numpy(np.asarray(a))


CASES = [(g, w, c) for g in (1, 4) for w, c in
         [(None, None), (8, None), (None, 30.0), (8, 30.0)]]


@pytest.mark.parametrize("g,window,softcap", CASES)
def test_paged_decode_matches_reference(g, window, softcap):
    rng = np.random.default_rng(10 + g)
    # slot 2 holds one token in a table with three unallocated entries;
    # slot 3 holds nothing at all (its row comes back zero)
    ctx = [9, 27, 1, 0]
    kpool, vpool, ppos, bt = _pools(rng, ctx)
    B, Hq = len(ctx), HKV * g
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    q_pos = np.asarray([[n - 1] for n in ctx], np.int32)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    ours = ops.paged_decode_attention(_t(q), _t(kpool), _t(vpool), _t(ppos),
                                      _t(bt), _t(q_pos), **kw).numpy()
    pallas = JDA.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool),
        jnp.asarray(ppos), jnp.asarray(bt), jnp.asarray(q_pos),
        interpret=True, **kw)
    oracle = JREF.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool),
        jnp.asarray(ppos), jnp.asarray(bt), jnp.asarray(q_pos), **kw)
    np.testing.assert_allclose(ours, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(ours, np.asarray(oracle), **TOL)
    assert not ours[3].any()


def _packed_stream(rng, g):
    """A decode lane for slot 0, a 19-token chunk for slot 1 (three 8-lane
    windows) and a 5-token chunk for slot 2, padded to T = 32."""
    before = [9, 6, 0]                  # context already in the pool
    seg_len = [1, 19, 5]
    kpool, vpool, ppos, bt = _pools(
        rng, [b + s for b, s in zip(before, seg_len)])
    T = 32
    slot_ids = np.full(T, -1, np.int32)
    q_pos = np.full(T, -1, np.int32)
    starts, t = [], 0
    for b, (n0, ln) in enumerate(zip(before, seg_len)):
        starts.append(t)
        slot_ids[t:t + ln] = b
        q_pos[t:t + ln] = n0 + np.arange(ln)
        t += ln
    meta = DA.packed_meta_table(starts, seg_len, [0, 1, 2], T,
                                T // DA.PACKED_BLOCK_Q + 3)
    q = rng.normal(size=(1, T, HKV * g, D)).astype(np.float32)
    return q, kpool, vpool, ppos, bt, q_pos[None], slot_ids, meta, t


@pytest.mark.parametrize("g,window,softcap", CASES)
def test_paged_packed_matches_reference(g, window, softcap):
    rng = np.random.default_rng(20 + g)
    q, kpool, vpool, ppos, bt, q_pos, slot_ids, meta, n_real = \
        _packed_stream(rng, g)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    ours = ops.paged_packed_attention(
        _t(q), _t(kpool), _t(vpool), _t(ppos), _t(bt), _t(q_pos),
        _t(slot_ids), _t(meta), **kw).numpy()
    j = [jnp.asarray(a) for a in (q, kpool, vpool, ppos, bt, q_pos)]
    pallas = JDA.paged_packed_attention(*j, jnp.asarray(meta),
                                        interpret=True, **kw)
    oracle = JREF.paged_packed_attention_ref(*j, jnp.asarray(slot_ids), **kw)
    np.testing.assert_allclose(ours, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(ours, np.asarray(oracle), **TOL)
    assert not ours[0, n_real:].any()          # padding lanes are zero


@pytest.mark.parametrize("seed", range(4))
def test_packed_meta_table_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n_seg = int(rng.integers(1, 7))
    lens = rng.integers(1, 30, size=n_seg).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    slots = rng.permutation(8)[:n_seg].astype(np.int32)
    T = int(-(-(int(lens.sum()) + int(rng.integers(0, 9))) // 8) * 8)
    n_work = T // DA.PACKED_BLOCK_Q + n_seg
    ours = DA.packed_meta_table(starts, lens, slots, T, n_work)
    ref = JDA.packed_meta_table(starts, lens, slots, T, n_work)
    np.testing.assert_array_equal(ours, ref)
    assert DA.PACKED_BLOCK_Q == JDA.PACKED_BLOCK_Q


# (B, Sq, Sk, Hq, Hkv, D, window, softcap): a prefill, a decode step with a
# window and a softcap, a prefill with a window
DENSE_BF16 = [(2, 24, 24, 4, 2, 32, None, None),
              (2, 1, 40, 8, 2, 64, 16, 30.0),
              (2, 33, 33, 4, 4, 16, 8, None)]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,window,softcap", DENSE_BF16)
def test_dense_attention_bf16_within_tolerance_of_reference_default(
        monkeypatch, B, Sq, Sk, Hq, Hkv, D, window, softcap):
    """The port's dense attention on the CPU (``layers.mha_attention``:
    the kernels' plain versions, which take the probabilities in fp32,
    as ``repro.kernels.ref`` does) against the reference's model path at
    its default precision (``REPRO_PERF_OPTS`` unset: ``attn_bf16`` on,
    which rounds the probabilities to v's dtype before the fp32-accumulated
    product with v), bf16 q, k, v: within the bf16 tolerance the kernels
    are held to against the plain versions (2e-2; the outputs differ by
    one bf16 unit at most, in about a third of them)."""
    monkeypatch.delenv("REPRO_PERF_OPTS", raising=False)
    rng = np.random.default_rng(Sq + D)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
            for _ in range(2))
    kp = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    qp = kp[:, Sk - Sq:].copy()
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    want = jax.jit(lambda *a: JL.mha_attention(*a, **kw))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(qp), jnp.asarray(kp))
    got = L.mha_attention(*(torch.from_numpy(a).bfloat16()
                            for a in (q, k, v)),
                          torch.from_numpy(qp), torch.from_numpy(kp), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)
