"""The gradient of dense flash attention in the port, against the
reference package.

The reference's Pallas ``flash_attention`` has no backward: it trains by
differentiating its plain attention (``repro.kernels.ref.
flash_attention_ref``) with ``jax.grad``.  On the CPU the port
differentiates its own plain version with autograd, and on the card its
backward kernel computes ``kernels.ref.flash_attention_bwd_ref`` from the
forward's output and log-sum-exp.  Both are held here against
``jax.grad`` of the reference in fp32, over -1 positions, rows that see
no key, a window, a softcap, GQA and Dv != D (1e-5: the same formulas,
summed in another order).  ``ops.FlashAttentionFn``, which ties the
kernels together for autograd on the card, is checked on the CPU with its
two kernels replaced by their plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref

TOL = 1e-5

# (B, Sq, Sk, Hq, Hkv, D, Dv, window, softcap, ragged)
CASES = {
    "mha causal": (2, 13, 13, 4, 4, 16, 16, None, None, False),
    "gqa window softcap": (2, 21, 21, 6, 2, 8, 8, 5, 3.0, False),
    "dv != d": (1, 9, 9, 4, 2, 24, 16, None, None, False),
    "ragged empty rows": (3, 11, 11, 4, 2, 8, 8, 4, 2.5, True),
    "prefix keys": (2, 5, 17, 2, 1, 16, 8, None, None, True),
}


def _inputs(B, Sq, Sk, Hq, Hkv, D, Dv, ragged, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, Dv)).astype(np.float32)
    do = rng.normal(size=(B, Sq, Hq, Dv)).astype(np.float32)
    kp = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    qp = kp[:, Sk - Sq:].copy()
    if ragged:
        # row 0 whole; row 1 with -1 keys in the middle and padding
        # queries; the last row's queries all padding (they see no key)
        kp[1, 2:4] = -1
        qp[1, -2:] = -1
        qp[-1] = -1
    return q, k, v, do, qp, kp


def _jax_grads(q, k, v, do, qp, kp, kw):
    def f(q, k, v, do, qp, kp):
        return jnp.sum(JREF.flash_attention_ref(q, k, v, qp, kp, **kw) * do)
    grad = jax.jit(jax.grad(f, argnums=(0, 1, 2)))
    return [np.asarray(g) for g in grad(*map(jnp.asarray,
                                            (q, k, v, do, qp, kp)))]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_grad(case):
    """``flash_attention_bwd_ref`` (from the forward's o and lse) and
    autograd through ``flash_attention_ref`` both equal ``jax.grad`` of
    the reference's plain attention; padding queries and masked keys get
    zero gradient."""
    B, Sq, Sk, Hq, Hkv, D, Dv, window, cap, ragged = CASES[case]
    q, k, v, do, qp, kp = _inputs(B, Sq, Sk, Hq, Hkv, D, Dv, ragged)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=cap)
    want = _jax_grads(q, k, v, do, qp, kp, kw)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tqp, tkp, tdo = (torch.from_numpy(a) for a in (qp, kp, do))
    out = ref.flash_attention_ref(tq, tk, tv, tqp, tkp, **kw)
    auto = torch.autograd.grad(out, (tq, tk, tv), tdo)
    with torch.no_grad():
        o, lse = ref.flash_attention_lse_ref(tq, tk, tv, tqp, tkp, **kw)
        plain = ref.flash_attention_bwd_ref(tq, tk, tv, tqp, tkp, o, lse,
                                            tdo, **kw)
    for got in (auto, plain):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)
    if ragged:
        assert not plain[0][torch.from_numpy(qp < 0)].any()
        assert torch.isinf(lse[-1]).all() and torch.isfinite(lse[0]).all()
    np.testing.assert_array_equal(o.numpy(), out.detach().numpy())


def test_flash_attention_fn_wires_forward_and_backward(monkeypatch):
    """``ops.FlashAttentionFn`` with its kernels replaced by their plain
    versions: the forward keeps o and lse, the backward hands a
    non-contiguous output gradient over contiguous and returns dq, dk, dv
    (none for the positions), equal to autograd through the plain
    version; each kernel is called once."""
    B, Sq, Sk, Hq, Hkv, D, Dv, window, cap, ragged = CASES[
        "ragged empty rows"]
    q, k, v, do, qp, kp = _inputs(B, Sq, Sk, Hq, Hkv, D, Dv, ragged, seed=1)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=cap)
    calls = []

    def fwd(q, k, v, q_pos, k_pos, *, return_lse=False, **kw):
        calls.append("fwd")
        assert return_lse
        return ref.flash_attention_lse_ref(q, k, v, q_pos, k_pos, **kw)

    def bwd(q, k, v, q_pos, k_pos, o, lse, do, **kw):
        calls.append("bwd")
        assert do.is_contiguous()
        return ref.flash_attention_bwd_ref(q, k, v, q_pos, k_pos, o, lse,
                                           do, **kw)
    monkeypatch.setattr(FA, "flash_attention", fwd)
    monkeypatch.setattr(FA, "flash_attention_bwd", bwd)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tqp, tkp = torch.from_numpy(qp), torch.from_numpy(kp)
    # the gradient arrives transposed, as a (B, Hq, Sq, Dv) buffer would
    tdo = torch.from_numpy(do).transpose(1, 2).contiguous().transpose(1, 2)
    assert not tdo.is_contiguous()
    out = ops.FlashAttentionFn.apply(tq, tk, tv, tqp, tkp, window, D ** -0.5,
                                     cap)
    got = torch.autograd.grad(out, (tq, tk, tv), tdo)
    assert calls == ["fwd", "bwd"]
    want = torch.autograd.grad(
        ref.flash_attention_ref(tq, tk, tv, tqp, tkp, **kw), (tq, tk, tv),
        tdo)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


def _meta_calls():
    """(kernel name, a call of its ``ops`` dispatcher on meta tensors, the
    first float input of which requires grad when asked).  A meta tensor
    takes the card's path through ``ops``."""
    def z(*shape, dtype=torch.float32, grad=False):
        return torch.zeros(shape, dtype=dtype, device="meta",
                           requires_grad=grad)
    i32 = dict(dtype=torch.int32)
    kw = dict(window=None, scale=0.25)

    def paged(fn, W):
        return lambda g: fn(z(2, W, 2, 16, grad=g), z(4, 8, 2, 16),
                            z(4, 8, 2, 16), z(4, 8, **i32), z(2, 2, **i32),
                            z(2, W, **i32), **kw)
    return {
        "paged_decode_attention": paged(ops.paged_decode_attention, 1),
        "paged_mixed_attention": paged(ops.paged_mixed_attention, 3),
        "paged_packed_attention": lambda g: ops.paged_packed_attention(
            z(1, 4, 2, 16, grad=g), z(4, 8, 2, 16), z(4, 8, 2, 16),
            z(4, 8, **i32), z(2, 2, **i32), z(1, 4, **i32), z(4, **i32),
            z(3, 4, **i32), **kw),
        "quant_matmul": lambda g: ops.quant_matmul(
            z(3, 16, grad=g), z(16, 8, dtype=torch.int8), z(8)),
        "fused_rmsnorm": lambda g: ops.rmsnorm(z(3, 16, grad=g), z(16)),
        "decode_attention": lambda g: ops.decode_attention(
            z(2, 1, 4, 16, grad=g), z(2, 5, 2, 16), z(2, 5, 2, 16),
            z(2, 5, **i32), z(2, 1, **i32), **kw),
    }


@pytest.mark.parametrize("name", list(_meta_calls()))
def test_kernels_without_backward_raise_under_grad(name):
    """Every card dispatcher of a kernel without a backward: with grad
    enabled and an input that requires it, it raises naming the kernel
    (``ops.no_backward``) before any launch; under ``torch.no_grad`` it
    goes on to the kernel's wrapper (which refuses a meta tensor).  No
    launch is counted."""
    call = _meta_calls()[name]
    with pytest.raises(NotImplementedError, match=f"{name} has no backward"):
        call(True)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        call(True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(False)
    assert all(n == 0 for n in ops.launch_counts().values())


def test_flash_under_grad_goes_to_its_autograd_function(monkeypatch):
    """Flash attention has a backward: with grad on the card's path it
    enters ``FlashAttentionFn`` (whose forward kernel refuses a meta
    tensor) rather than raising for a missing backward."""
    entered = []
    apply = ops.FlashAttentionFn.apply

    def spy(*args):
        entered.append(True)
        return apply(*args)
    monkeypatch.setattr(ops.FlashAttentionFn, "apply", spy)
    q = torch.zeros(2, 3, 2, 16, device="meta", requires_grad=True)
    pos = torch.zeros(2, 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention(q, q.detach(), q.detach(), pos, pos, window=None,
                            scale=0.25)
    assert entered == [True]
