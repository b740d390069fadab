"""The gradient of the chunkwise mLSTM in the port, against the reference
package.

The reference's Pallas ``mlstm_chunked_kernel`` has no backward: it trains
xlstm by differentiating its jnp path (``repro.models.ssm.mlstm_chunked``)
with ``jax.grad``.  On the CPU the port differentiates its plain version
with autograd; on the card the backward kernel
(``csrc/mlstm_chunk_bwd.cu``) computes ``kernels.ref.mlstm_chunked_bwd_ref``
from the state at the start of every 32-step chunk, h and h's gradient.
Both are held here against ``jax.grad`` of the reference in fp32, over one
chunk and three (the last ragged), from a zero and a nonzero initial
state.  The gradients divide by a denominator that passes near zero for
random inputs, so they reach magnitudes of ~100 and fp32 sums taken in
another order move them by a few 1e-6 of that: each is held to 2e-5 of
its largest magnitude.  The plain backward treats the stabiliser m as a
constant (h does not depend on it); ``jax.grad`` differentiates the max
too, and those terms cancel up to rounding.  ``ops.MlstmChunkedFn``, which
ties the kernels together for autograd on the card, is checked on the CPU
with its two kernels replaced by their plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JSSM
from repro_torch.kernels import mlstm_chunk as MC
from repro_torch.kernels import ops, ref

TOL = 2e-5
B, H, DH = 2, 2, 16
NAMES = ("q", "k", "v", "i_pre", "logf")


def _inputs(S, nonzero, seed=0):
    """q, k (scaled by dh^-1/2, as the model does), v, the gates, h's
    gradient and an initial state (zeros, or random with n > 0), numpy
    fp32."""
    rng = np.random.default_rng(seed + S + 10 * nonzero)
    q, k, v, dh = (rng.normal(size=(B, S, H, DH)).astype(np.float32)
                   for _ in range(4))
    k *= DH ** -0.5
    i_pre = rng.normal(size=(B, S, H)).astype(np.float32)
    logf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(
        rng.normal(size=(B, S, H)) + 2, jnp.float32)))
    state = {"C": (rng.normal(size=(B, H, DH, DH)) * 0.1 * nonzero),
             "n": np.abs(rng.normal(size=(B, H, DH))) * nonzero,
             "m": rng.normal(size=(B, H)) * nonzero}
    state = {key: a.astype(np.float32) for key, a in state.items()}
    return (q, k, v, i_pre, logf), state, dh


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_grads(args, state, dh):
    def f(q, k, v, i_pre, logf):
        h, _ = JSSM.mlstm_chunked(q, k, v, i_pre, logf, state)
        return jnp.sum(h * dh)
    grad = jax.jit(jax.grad(f, argnums=tuple(range(5))))
    return [np.asarray(g) for g in grad(*map(jnp.asarray, args))]


def _close(got, want, tol=TOL):
    for name, g, w in zip(NAMES, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        scale = np.abs(w).max()
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= tol * scale, (
            name, np.abs(g - w).max() / scale)


@pytest.mark.parametrize("nonzero", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("S", [32, 70])
def test_plain_backward_matches_jax_grad(S, nonzero):
    """``mlstm_chunked_bwd_ref`` (from the chunk states of
    ``mlstm_chunked_ref(..., chunk=32, return_states=True)``, its h and
    h's gradient) and autograd through ``mlstm_chunked_ref`` (chunks of
    128) both equal ``jax.grad`` of the reference's jnp path for q, k, v,
    i_pre and logf: one chunk (S = 32) and three, the last ragged (S =
    70)."""
    args, state, dh = _inputs(S, nonzero)
    want = _jax_grads(args, state, dh)
    targs, tstate, tdh = [_t(a) for a in args], \
        {key: _t(a) for key, a in state.items()}, _t(dh)
    leaves = [t.clone().requires_grad_() for t in targs]
    h, _ = ref.mlstm_chunked_ref(*leaves, tstate)
    auto = torch.autograd.grad(h, leaves, tdh)
    h32, final, states = ref.mlstm_chunked_ref(*targs, tstate, chunk=32,
                                               return_states=True)
    plain = ref.mlstm_chunked_bwd_ref(*targs, states, h32, tdh, chunk=32)
    _close(auto, want)
    _close(plain, want)
    # the chunk states: the initial state first, one per 32 steps
    assert states["C"].shape == (B, H, -(-S // 32), DH, DH)
    for key in ("C", "n", "m"):
        torch.testing.assert_close(states[key][:, :, 0], tstate[key])
    torch.testing.assert_close(h32, h.detach(), rtol=1e-5, atol=1e-5)


def test_plain_backward_is_its_chunkings_gradient():
    """Chunks of 16 (eight over S = 120, the last ragged) give the same
    gradients as autograd through the plain forward: the backward does not
    depend on the chunk length beyond rounding."""
    args, state, dh = _inputs(120, True, seed=3)
    targs = [_t(a) for a in args]
    tstate = {key: _t(a) for key, a in state.items()}
    leaves = [t.clone().requires_grad_() for t in targs]
    h, _ = ref.mlstm_chunked_ref(*leaves, tstate)
    auto = torch.autograd.grad(h, leaves, _t(dh))
    h16, _, states = ref.mlstm_chunked_ref(*targs, tstate, chunk=16,
                                           return_states=True)
    plain = ref.mlstm_chunked_bwd_ref(*targs, states, h16, _t(dh), chunk=16)
    _close(plain, [a.numpy() for a in auto])


def _plain_kernels(monkeypatch, calls):
    """Replace the forward and backward kernels of ``MlstmChunkedFn`` by
    their plain versions at the kernels' 32-step chunks."""
    def fwd(q, k, v, i_pre, logf, state, *, return_states=False):
        calls.append("fwd")
        assert return_states
        return ref.mlstm_chunked_ref(q, k, v, i_pre, logf, state,
                                     chunk=MC.CHUNK, return_states=True)

    def bwd(q, k, v, i_pre, logf, states, h, dh):
        calls.append("bwd")
        assert dh.is_contiguous()
        return ref.mlstm_chunked_bwd_ref(q, k, v, i_pre, logf, states, h,
                                         dh, chunk=MC.CHUNK)
    monkeypatch.setattr(MC, "mlstm_chunked", fwd)
    monkeypatch.setattr(MC, "mlstm_chunked_bwd", bwd)


def test_mlstm_fn_wires_forward_and_backward(monkeypatch):
    """``ops.MlstmChunkedFn`` with its kernels replaced by their plain
    versions: the forward keeps the chunk states and h, the backward hands
    a non-contiguous gradient of h over contiguous and returns the
    gradients of q, k, v and both gates (none for the state), equal to
    autograd through the plain version; each kernel is called once, and
    the final state, unused, sends no cotangent."""
    calls = []
    _plain_kernels(monkeypatch, calls)
    args, state, dh = _inputs(70, True, seed=1)
    leaves = [_t(a).requires_grad_() for a in args]
    tstate = {key: _t(a) for key, a in state.items()}
    # the gradient arrives transposed, as a (B, H, S, dh) buffer would
    tdh = _t(dh).transpose(1, 2).contiguous().transpose(1, 2)
    assert not tdh.is_contiguous()
    h, C, n, m = ops.MlstmChunkedFn.apply(*leaves, tstate["C"], tstate["n"],
                                          tstate["m"])
    got = torch.autograd.grad(h, leaves, tdh)
    assert calls == ["fwd", "bwd"]
    want = torch.autograd.grad(
        ref.mlstm_chunked_ref(*leaves, tstate)[0], leaves, tdh)
    _close(got, [w.numpy() for w in want])
    _, final = ref.mlstm_chunked_ref(*map(_t, args), tstate)
    for a, key in zip((C, n, m), ("C", "n", "m")):
        torch.testing.assert_close(a.detach(), final[key], rtol=1e-5,
                                   atol=1e-5)


def test_mlstm_fn_refuses_state_gradients(monkeypatch):
    """The backward kernel differentiates h alone: a cotangent reaching the
    final state (C, n or m), or an initial state that requires grad,
    raises naming the kernel; the backward kernel is then never called."""
    calls = []
    _plain_kernels(monkeypatch, calls)
    args, state, dh = _inputs(40, True, seed=2)
    leaves = [_t(a).requires_grad_() for a in args]
    tstate = {key: _t(a) for key, a in state.items()}
    for i in range(1, 4):
        out = ops.MlstmChunkedFn.apply(*leaves, tstate["C"], tstate["n"],
                                       tstate["m"])
        with pytest.raises(NotImplementedError,
                           match="mlstm_chunked_bwd takes no cotangent"):
            torch.autograd.grad(out[0].sum() + out[i].sum(), leaves)
    grown = {key: t.clone().requires_grad_() for key, t in tstate.items()}
    out = ops.MlstmChunkedFn.apply(*leaves, grown["C"], grown["n"],
                                   grown["m"])
    with pytest.raises(NotImplementedError,
                       match="mlstm_chunked_bwd takes no gradient of the "
                             "initial state"):
        torch.autograd.grad(out[0].sum(), leaves)
    assert "bwd" not in calls


def test_mlstm_under_grad_goes_to_its_autograd_function(monkeypatch):
    """The mLSTM kernel has a backward: with grad on the card's path (a
    meta tensor takes it) ``ops.mlstm_chunked`` enters ``MlstmChunkedFn``
    (whose forward kernel refuses a meta tensor) rather than raising for a
    missing backward; without grad it goes straight to the kernel's
    wrapper."""
    entered = []
    apply = ops.MlstmChunkedFn.apply

    def spy(*args):
        entered.append(True)
        return apply(*args)
    monkeypatch.setattr(ops.MlstmChunkedFn, "apply", spy)

    def z(*shape, grad=False):
        return torch.zeros(shape, device="meta", requires_grad=grad)
    state = {"C": z(1, 2, 8, 8), "n": z(1, 2, 8), "m": z(1, 2)}
    for which in range(5):
        args = [z(1, 4, 2, 8), z(1, 4, 2, 8), z(1, 4, 2, 8), z(1, 4, 2),
                z(1, 4, 2)]
        args[which].requires_grad_()
        with pytest.raises(ValueError, match="CUDA tensors"):
            ops.mlstm_chunked(*args, state)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        ops.mlstm_chunked(*args, state)
    assert entered == [True] * 5
    assert ops.launch_counts()["mlstm_chunked_bwd"] == 0


def test_backward_shared_memory_fits_xlstm_widths():
    """Both chunk passes of the backward (the chunk's q, k, v rows at their
    type and dh in fp32 for pass 1; k and v for pass 3) fit a Hopper block
    at xlstm-125m's head dim 384 and the reduced config's 128 at every
    dtype, grow with dh as the kernel lays them out, and the plan hands
    the launcher exactly those figures."""
    limit = 227 * 1024
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        small, big = MC.bwd_smem_bytes(128, dtype), MC.bwd_smem_bytes(384,
                                                                     dtype)
        assert max(big) <= limit and all(a < b for a, b in zip(small, big))
        assert MC.mlstm_bwd_plan(384, dtype, limit).smem_bytes == big
        # rows padded to a multiple of 16 (+ 8): dh 376 takes 384's
        # layout, dh 368 16 elements fewer in each row of q, k, v and dh
        # and in n
        el = torch.empty((), dtype=dtype).element_size()
        assert MC.bwd_smem_bytes(376, dtype) == big
        assert big[0] - MC.bwd_smem_bytes(368, dtype)[0] == \
            32 * 16 * (3 * el + 4) + 16 * 4
