"""The launch plan of ``mlstm_chunked_bwd`` and the arithmetic of its
chunk-parallel tensor-core passes, on the CPU.

``mlstm_chunk.mlstm_bwd_plan`` gives the backward's one body, its blocks
and the bf16 parts of each operand by q's dtype.  The kernels run only on
the card (``tests/test_torch_cuda.py``); these are the rules they rely on:
both chunk passes fit a Hopper block at xlstm-125m's widths, a block holds
16 warps, and a head dim or a shared-memory limit the kernels were not
built for is refused.  The emulation below repeats the kernels' four
passes in plain torch (per chunk the score side, dq and the chunk's
increments; the reverse scan of the carried cotangents; per chunk dk and
dv; dlogf from the chunks' sums, with no product of G and C), every
product's fp32 operands cut into the plan's number of bf16 parts, and
holds it to the plain backward (``ref.mlstm_chunked_bwd_ref``, itself held
to ``jax.grad`` in ``tests/test_torch_mlstm_bwd.py``) at a quarter of the
gates ``chip_smoke.py`` applies on the card: 2e-2 (bf16, fp16) or 1e-4
(fp32) for dq, dk and dv and 1e-4 for di and dlogf, relative to each
gradient's largest magnitude.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import mlstm_chunk as MC
from repro_torch.kernels import ref

SMEM = 232448                 # an H100's opt-in shared memory per block
SM = 132                      # its SMs
GATES = {torch.bfloat16: 2e-2, torch.float16: 2e-2, torch.float32: 1e-4}
GATE_GATES = 1e-4             # di and dlogf
L = MC.CHUNK


def _parts(x, n):
    out, r = [], x
    for _ in range(n):
        p = r.to(torch.bfloat16).float()
        out.append(p)
        r = r - p
    return out


def _mm(a, pa, b, pb):
    """a @ b with a cut into pa bf16 parts and b into pb, the part pairs
    (i, j) with i + j below the larger count multiplied and summed in
    fp32, as the kernels' ``mma_parts``."""
    A, Bp, top = _parts(a, pa), _parts(b, pb), max(pa, pb)
    return sum(A[i] @ Bp[j] for i in range(pa) for j in range(pb)
               if i + j < top)


def split_operand_backward(q, k, v, i_pre, logf, states, h, dh, parts):
    """The kernels' arithmetic: ``parts`` = (q/k/v, chunk-local fp32
    operands, state products' fp32 operands).  Returns what
    ``mlstm_chunked_bwd`` returns."""
    pt, pi, ps = parts
    B, S, H, D = q.shape
    pad = (-S) % L
    qf, kf, vf, hf, gf = (F.pad(t.float(), (0, 0, 0, 0, 0, pad))
                          .transpose(1, 2) for t in (q, k, v, h, dh))
    ig = F.pad(i_pre, (0, 0, 0, pad), value=-1e30).transpose(1, 2)
    lf = F.pad(logf, (0, 0, 0, pad), value=0.0).transpose(1, 2)
    NC = (S + pad) // L
    tri = torch.ones(L, L, dtype=torch.bool).tril()
    one = {key: [] for key in ("dq", "dk", "dv", "a", "csum", "wk", "lb",
                               "decay", "dG", "dg")}
    # pass 1: per chunk, the score side, dq and the chunk's increments
    for c in range(NC):
        sl = slice(c * L, (c + 1) * L)
        Q, K, V, Hh, Dh = (t[:, :, sl] for t in (qf, kf, vf, hf, gf))
        ib, fb = ig[:, :, sl], lf[:, :, sl]
        C, n, m = (states[key][:, :, c] for key in ("C", "n", "m"))
        Fc = torch.cumsum(fb, -1)
        Ft = Fc[..., -1]
        logw = torch.where(tri, Fc[..., :, None] - Fc[..., None, :]
                           + ib[..., None, :], -torch.inf)
        logst = Fc + m[..., None]
        mi = torch.maximum(logw.amax(-1), logst)
        mi = torch.where(torch.isfinite(mi), mi, 0.0)
        W = torch.exp(logw - mi[..., None])
        sw = torch.exp(logst - mi)
        m_new = torch.maximum(m + Ft, (Ft[..., None] - Fc + ib).amax(-1))
        wk = torch.exp(Ft[..., None] - Fc + ib - m_new[..., None])
        Sc = _mm(Q, pt, K.transpose(-1, -2), pt)
        dhV = _mm(Dh, pi, V.transpose(-1, -2), pt)
        qn = (Q @ n[..., None])[..., 0]
        P = Sc * W
        den = P.sum(-1) + sw * qn
        floor = torch.exp(-mi)
        r = torch.maximum(den.abs(), floor)
        dd = torch.where(den.abs() > floor,
                         -torch.sign(den) * (Dh * Hh).sum(-1) / r, 0.0)
        dS = (dhV / r[..., None] + dd[..., None]) * W
        dN = Dh * (sw / r)[..., None]
        dq_st = _mm(dN, ps, C.transpose(-1, -2), ps)
        lb = (Q * dq_st).sum(-1) + sw * dd * qn
        one["dq"].append(dq_st + _mm(dS, pi, K, pt)
                         + (sw * dd)[..., None] * n[..., None, :])
        one["dk"].append(_mm(dS.transpose(-1, -2), pi, Q, pt))
        one["dv"].append(_mm((P / r[..., None]).transpose(-1, -2), pi, Dh,
                             pi))
        one["a"].append((dS * Sc).sum(-1) + lb)
        one["csum"].append((dS * Sc).sum(-2))
        one["wk"].append(wk)
        one["lb"].append(lb.sum(-1))
        one["decay"].append(torch.exp(m + Ft - m_new))
        one["dG"].append(_mm(Q.transpose(-1, -2), pt, dN, ps))
        one["dg"].append(((sw * dd)[..., None] * Q).sum(-2))
    # pass 2: G and g at each chunk's end, from the last chunk back
    G_end, g_end = [None] * NC, [None] * NC
    G, g = torch.zeros_like(one["dG"][0]), torch.zeros_like(one["dg"][0])
    for c in reversed(range(NC)):
        G_end[c], g_end[c] = G, g
        G = one["dG"][c] + one["decay"][c][..., None, None] * G
        g = one["dg"][c] + one["decay"][c][..., None] * g
    # pass 3: per chunk, dk and dv's state parts and di
    dk, dv, di, lw = [], [], [], []
    for c in range(NC):
        sl = slice(c * L, (c + 1) * L)
        K, V, wk = kf[:, :, sl], vf[:, :, sl], one["wk"][c]
        dk_st = wk[..., None] * (_mm(V, pt, G_end[c].transpose(-1, -2), ps)
                                 + g_end[c][..., None, :])
        dk.append(one["dk"][c] + dk_st)
        dv.append(one["dv"][c] + wk[..., None] * _mm(K, pt, G_end[c], ps))
        lwj = (K * dk_st).sum(-1)
        di.append(one["csum"][c] + lwj)
        lw.append(lwj.sum(-1))
    # pass 4: dlogf, the chunk's reverse cumulative sum plus the later
    # chunks' lb - lw
    dlf, later = [None] * NC, torch.zeros_like(lw[0])
    for c in reversed(range(NC)):
        x = one["a"][c] - di[c]
        dlf[c] = x.flip(-1).cumsum(-1).flip(-1) + later[..., None]
        later = later + one["lb"][c] - lw[c]

    def cat(xs):
        return torch.cat(xs, 2).transpose(1, 2)[:, :S].contiguous()
    return (cat(one["dq"]).to(q.dtype), cat(dk).to(q.dtype),
            cat(dv).to(q.dtype), cat(di), cat(dlf))


def _inputs(rng, B, S, H, dh, state, dtype):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    q, k, v, g = (rng.normal(size=(B, S, H, dh)) for _ in range(4))
    i_pre = rng.normal(size=(B, S, H))
    logf = -np.log1p(np.exp(-(rng.normal(size=(B, S, H)) + 2)))
    st = {"C": t(rng.normal(size=(B, H, dh, dh)) * 0.1 * state),
          "n": t(np.abs(rng.normal(size=(B, H, dh))) * state),
          "m": t(rng.normal(size=(B, H)) * state)}
    args = (t(q).to(dtype), t(k * dh ** -0.5).to(dtype), t(v).to(dtype),
            t(i_pre), t(logf))
    h, _, states = ref.mlstm_chunked_ref(*args, st, chunk=L,
                                         return_states=True)
    return args, states, h, t(g)


def _rel_errors(got, want):
    return [((a.float() - b.float()).abs().max()
             / b.float().abs().max()).item() for a, b in zip(got, want)]


# reduced xlstm-125m (2 heads x 128): ragged chunks from a nonzero state,
# the zero state, one step, four chunks; one case at the full head dim 384
CASES = [(2, 70, 2, 128, 1.0), (2, 33, 2, 128, 0.0), (1, 1, 2, 128, 1.0),
         (2, 128, 2, 128, 0.0), (1, 40, 1, 384, 1.0)]


@pytest.mark.parametrize("dtype", list(GATES), ids=str)
@pytest.mark.parametrize("B,S,H,dh,state", CASES)
def test_split_operands_hold_a_quarter_of_each_gate(B, S, H, dh, state,
                                                    dtype):
    rng = np.random.default_rng(S + dh)
    args, states, h, g = _inputs(rng, B, S, H, dh, state, dtype)
    want = ref.mlstm_chunked_bwd_ref(*args, states, h, g, chunk=L)
    got = split_operand_backward(*args, states, h, g, MC.BWD_PARTS[dtype])
    for name, err, gate in zip(("dq", "dk", "dv", "di", "dlogf"),
                               _rel_errors(got, want),
                               [GATES[dtype]] * 3 + [GATE_GATES] * 2):
        assert err <= gate / 4, (name, err, gate)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_one_part_per_operand_misses_the_gates(dtype):
    # the check has teeth: fp32 operands rounded once to bf16 miss the
    # 1e-4 gates of di and dlogf (and at fp32 every gate) by far
    rng = np.random.default_rng(5)
    args, states, h, g = _inputs(rng, 2, 70, 2, 128, 1.0, dtype)
    want = ref.mlstm_chunked_bwd_ref(*args, states, h, g, chunk=L)
    errs = _rel_errors(
        split_operand_backward(*args, states, h, g, (1, 1, 1)), want)
    assert min(errs[3:]) > 3 * GATE_GATES
    if dtype == torch.float32:
        assert min(errs[:3]) > 10 * GATES[dtype]


def test_the_decay_term_needs_no_product_of_g_and_c():
    """The term decay_c (<G_c, C_c> + <g_c, n_c>) that the plain backward
    adds at each chunk's last step equals sum_{c' > c} (lb(c') - lw(c'))
    - lw(c) from the chunks' sums alone (C_{c+1} = decay_c C_c + the
    chunk's update): with every operand in fp32 the emulated passes give
    the plain backward's dlogf to rounding over five chunks."""
    rng = np.random.default_rng(9)
    args, states, h, g = _inputs(rng, 2, 150, 2, 32, 1.0, torch.float32)
    want = ref.mlstm_chunked_bwd_ref(*args, states, h, g, chunk=L)
    got = split_operand_backward(*args, states, h, g, (3, 3, 3))
    assert _rel_errors(got, want)[4] < 1e-5


@pytest.mark.parametrize("dtype", list(GATES), ids=str)
def test_plan_fits_a_hopper_block_at_xlstm_widths(dtype):
    for dh in (128, 384):
        plan = MC.mlstm_bwd_plan(dh, dtype, SMEM)
        assert plan.parts == MC.BWD_PARTS[dtype]
        assert plan.smem_bytes == MC.bwd_smem_bytes(dh, dtype)
        assert max(plan.smem_bytes) <= SMEM
    # the q/k/v rows grow with dh and with the dtype's width
    assert MC.bwd_smem_bytes(128, dtype)[0] < MC.bwd_smem_bytes(384,
                                                               dtype)[0]
    assert MC.bwd_smem_bytes(384, torch.bfloat16)[0] < \
        MC.bwd_smem_bytes(384, torch.float32)[0]


def test_plan_puts_sixteen_warps_on_an_sm_at_the_train_shape():
    # xlstm-125m's 8 x 128, 4 heads of 384: 4 chunks x 32 (row, head)
    # blocks of 16 warps, one wave on 132 SMs; a block's shared memory
    # leaves room for one block an SM at fp32 and bf16
    B, S, H, dh = 8, 128, 4, 384
    for dtype in (torch.bfloat16, torch.float32):
        plan = MC.mlstm_bwd_plan(dh, dtype, SMEM)
        assert plan.threads // 32 >= 16
        assert -(-S // L) * B * H <= SM
        assert SMEM // max(plan.smem_bytes) >= 1


def test_plan_refuses_what_the_kernels_were_not_built_for():
    # a small shared-memory limit refuses (no narrower layout exists: the
    # chunk's rows are the unit of work); so do head dims off the
    # multiples of 8 or above 384, and other dtypes
    need = max(MC.bwd_smem_bytes(384, torch.float32))
    assert max(MC.mlstm_bwd_plan(384, torch.float32, need).smem_bytes) \
        == need
    with pytest.raises(ValueError, match="shared memory"):
        MC.mlstm_bwd_plan(384, torch.float32, need - 1)
    with pytest.raises(ValueError, match="shared memory"):
        MC.mlstm_bwd_plan(128, torch.bfloat16, 48 * 1024)
    for dh in (4, 12, 100, 392, 512):
        with pytest.raises(ValueError, match="multiples of 8"):
            MC.mlstm_bwd_plan(dh, torch.bfloat16, SMEM)
    with pytest.raises(ValueError, match="fp32, fp16 or bf16"):
        MC.mlstm_bwd_plan(128, torch.float64, SMEM)
