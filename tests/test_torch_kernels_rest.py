"""The plain versions of the last three ported kernels against the
reference's Pallas kernels (interpret mode) and oracles, on the CPU.

* ``mlstm_chunked_ref`` against ``repro.kernels.mlstm_chunk.
  mlstm_chunked_kernel(..., interpret=True)`` at the shapes of the
  reference's own kernel sweep (``tests/test_kernels.py``), fp32, with a
  nonzero initial state.  h = num / max(|den|, e^-m) divides by a
  denominator that passes near zero for random inputs, so fp32 sums taken
  in another order move h by up to ~1e-5 of its magnitude: h is held to
  atol = rtol = 5e-5, the state (C, n, m) to atol 1e-5.
* ``rmsnorm_ref`` against ``repro.kernels.rmsnorm.fused_rmsnorm`` and the
  reference's ``rmsnorm_ref`` (fp32 1e-6 relative; bf16/fp16 one unit in
  the last place of the output's type, as both round one fp32 result).
* ``decode_attention_ref`` against ``repro.kernels.decode_attention.
  decode_attention`` and the reference's oracle, with GQA, a window, a
  softcap and rows that see no key (q_pos = -1, a window past every key),
  which must come back exactly 0 (fp32: 2e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as JDA
from repro.kernels import ref as JR
from repro.kernels import rmsnorm as JRN
from repro.kernels.mlstm_chunk import mlstm_chunked_kernel
from repro_torch.kernels import ops, ref


def _t(a):
    return torch.from_numpy(np.array(a))


def _mlstm_inputs(rng, B, S, H, dh):
    q, k, v = (rng.normal(size=(B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    i_pre = rng.normal(size=(B, S, H)).astype(np.float32)
    logf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(
        rng.normal(size=(B, S, H)) + 2, jnp.float32)))
    state = {"C": (rng.normal(size=(B, H, dh, dh)) * 0.1).astype(np.float32),
             "n": np.abs(rng.normal(size=(B, H, dh))).astype(np.float32),
             "m": rng.normal(size=(B, H)).astype(np.float32)}
    return (q, k * dh ** -0.5, v, i_pre, logf), state


def assert_mlstm_close(h, st, h_ref, st_ref):
    np.testing.assert_allclose(np.asarray(h), np.asarray(h_ref), rtol=5e-5,
                               atol=5e-5)
    for key in ("C", "n", "m"):
        np.testing.assert_allclose(np.asarray(st[key]),
                                   np.asarray(st_ref[key]), rtol=0,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("B,S,H,dh,chunk", [
    (1, 128, 2, 16, 128),
    (2, 256, 2, 32, 128),
    (1, 64, 4, 8, 64),        # single chunk
    (2, 512, 1, 64, 128),
])
def test_mlstm_ref_matches_pallas_kernel(B, S, H, dh, chunk):
    rng = np.random.default_rng(S + dh)
    args, state = _mlstm_inputs(rng, B, S, H, dh)
    h_k, st_k = mlstm_chunked_kernel(
        *map(jnp.asarray, args), {k: jnp.asarray(v) for k, v in
                                  state.items()},
        chunk=chunk, interpret=True)
    h, st = ref.mlstm_chunked_ref(*map(_t, args),
                                  {k: _t(v) for k, v in state.items()})
    assert_mlstm_close(h.numpy(), {k: v.numpy() for k, v in st.items()},
                       h_k, st_k)


@pytest.mark.parametrize("shape", [(4, 256), (2, 64, 512), (1, 8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_rmsnorm_ref_matches_pallas_kernel(shape, dtype):
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=shape[-1:]) * 0.1).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    out_k = JRN.fused_rmsnorm(jx, jnp.asarray(w), interpret=True)
    out = ref.rmsnorm_ref(_t(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)), _t(w))
    assert out.dtype == getattr(torch, dtype)
    got, want = out.float().numpy(), np.asarray(out_k, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        ulp = np.abs(want) * (2.0 ** -7 if dtype == "bfloat16" else 2 ** -10)
        assert (np.abs(got - want) <= ulp + 1e-6).all()


@pytest.mark.parametrize("rows,D", [(3, 100), (7, 24)])
def test_rmsnorm_ref_matches_oracle_on_ragged_shapes(rows, D):
    """Shapes the Pallas wrapper would refuse (D % 8, or rows that do not
    tile) against the reference's oracle; w at bf16 beside fp32 x."""
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, D)).astype(np.float32)
    w = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    want = np.asarray(JR.rmsnorm_ref(jnp.asarray(x), jnp.asarray(
        w, jnp.bfloat16)))
    got = ref.rmsnorm_ref(_t(x), _t(w).to(torch.bfloat16)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,Sk,Hq,Hkv,D,window,cap", [
    (2, 256, 4, 4, 64, None, None),       # MHA
    (2, 64, 8, 2, 32, None, None),        # GQA 4:1
    (3, 128, 4, 1, 16, 16, None),         # MQA + window
    (2, 128, 6, 2, 32, 32, 30.0),         # window + softcap
])
def test_decode_attention_ref_matches_pallas_kernel(B, Sk, Hq, Hkv, D,
                                                    window, cap):
    """Row 0 attends a ragged valid prefix (-1 positions past it); the
    last row's q_pos is -1, so it sees no key and must be exactly 0."""
    rng = np.random.default_rng(Sk + Hq)
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    k_pos = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    k_pos[0, Sk // 2:] = -1
    q_pos = np.full((B, 1), Sk - 1, np.int32)
    q_pos[0] = Sk // 2 - 1
    q_pos[-1] = -1
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=cap)
    out_k = JDA.decode_attention(*map(jnp.asarray, (q, k, v, k_pos, q_pos)),
                                 interpret=True, **kw)
    out_o = JR.decode_attention_ref(*map(jnp.asarray,
                                         (q, k, v, k_pos, q_pos)), **kw)
    out = ref.decode_attention_ref(*map(_t, (q, k, v, k_pos, q_pos)), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_k), rtol=2e-6,
                               atol=2e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_o), rtol=2e-6,
                               atol=2e-6)
    assert not out[-1].any() and out[0].abs().sum() > 0


def test_decode_attention_window_past_every_key_is_zero():
    """A window that ends before the row's first valid key leaves it no
    visible key: exactly 0, as the Pallas body's max(l, 1e-37) gives."""
    rng = np.random.default_rng(7)
    q = _t(rng.normal(size=(2, 1, 2, 8)).astype(np.float32))
    k = _t(rng.normal(size=(2, 16, 2, 8)).astype(np.float32))
    k_pos = torch.arange(16, dtype=torch.int32).expand(2, 16).clone()
    k_pos[1] = -1
    k_pos[1, :4] = torch.arange(4)
    q_pos = torch.tensor([[15], [40]], dtype=torch.int32)
    out = ref.decode_attention_ref(q, k, k, k_pos, q_pos, window=8,
                                   scale=0.35)
    assert out[0].abs().sum() > 0 and not out[1].any()
    want = JDA.decode_attention(*(jnp.asarray(t.numpy()) for t in
                                  (q, k, k, k_pos, q_pos)), window=8,
                                scale=0.35, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-6)


def test_cpu_dispatch_of_the_new_kernels_uses_the_plain_versions():
    """``ops`` sends CPU tensors of the three kernels to their plain
    versions, exactly, and counts no launch."""
    rng = np.random.default_rng(3)
    args, state = _mlstm_inputs(rng, 2, 40, 2, 8)
    targs, tstate = list(map(_t, args)), {k: _t(v) for k, v in state.items()}
    h, st = ops.mlstm_chunked(*targs, tstate)
    h_r, st_r = ref.mlstm_chunked_ref(*targs, tstate)
    assert torch.equal(h, h_r) and all(torch.equal(st[k], st_r[k])
                                       for k in st)
    x, w = _t(rng.normal(size=(5, 24)).astype(np.float32)), torch.zeros(24)
    assert torch.equal(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w))
    q = _t(rng.normal(size=(2, 1, 4, 8)).astype(np.float32))
    k = _t(rng.normal(size=(2, 5, 2, 8)).astype(np.float32))
    kp = torch.arange(5, dtype=torch.int32).expand(2, 5).contiguous()
    qp = torch.tensor([[4], [-1]], dtype=torch.int32)
    kw = dict(window=None, scale=0.3)
    assert torch.equal(ops.decode_attention(q, k, k, kp, qp, **kw),
                       ref.decode_attention_ref(q, k, k, kp, qp, **kw))
    assert all(n == 0 for n in ops.launch_counts().values())
