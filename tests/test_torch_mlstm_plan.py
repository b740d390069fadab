"""The launch plan of ``mlstm_chunked`` and the arithmetic of its
tensor-core body, on the CPU.

``mlstm_chunk.mlstm_plan`` picks the body by q's dtype and shape and, for
the tensor-core body, the tile of value columns each block carries.  The
kernel runs only on the card (``tests/test_torch_cuda.py``); these are the
rules it relies on: fp32 and fp16 never reach the tensor-core body, a
block's warps and shared memory stay within the kernel's limits, and at
xlstm-125m's width the grid is one wave.  The emulation below repeats the
tensor-core body's chunk step in plain torch, fp32 operands cut into the
kernel's number of bf16 parts and every product summed in fp32, and holds
it to the plain version at the gates ``chip_smoke.py`` applies on the card
(1e-4 of h's scale, 1e-5 of C's, n's and m's), with a margin of four.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mlstm_chunk as MC

SM = 132                      # an H100 SXM's SMs
SMEM = 232448                 # its opt-in shared memory per block
GATES = {"h": 1e-4, "C": 1e-5, "n": 1e-5, "m": 1e-5}
DHS = [1, 5, 8, 16, 20, 64, 72, 128, 130, 192, 200, 256, 384, 392, 512]
BH = [(1, 1), (1, 4), (2, 4), (3, 2), (4, 4), (8, 4), (16, 4), (64, 4)]


def _mma_ok(dh):
    return dh % 8 == 0 and dh <= 2 * MC.MMA_MAX_DW


@pytest.mark.parametrize("dh", DHS)
def test_body_by_dtype_alignment_and_head_dim(dh):
    for B, H in BH:
        for dtype in (torch.float32, torch.float16):
            plan = MC.mlstm_plan(B, H, dh, dtype, True, SM, SMEM)
            assert plan == MC.MlstmPlan("simt", MC.SIMT_TILE_E, MC.CHUNK,
                                        MC.simt_smem_bytes(dh))
        assert MC.mlstm_plan(B, H, dh, torch.bfloat16, False, SM,
                             SMEM).body == "simt"
        plan = MC.mlstm_plan(B, H, dh, torch.bfloat16, True, SM, SMEM)
        assert plan.body == ("mma" if _mma_ok(dh) else "simt")
        assert plan.L == MC.CHUNK == 32


@pytest.mark.parametrize("dh", [d for d in DHS if _mma_ok(d)])
def test_tensor_core_blocks_fit_the_kernel(dh):
    groups = -(-(-(-dh // 16) * 16) // MC.MMA_MAX_DW)
    for B, H in BH:
        plan = MC.mlstm_plan(B, H, dh, torch.bfloat16, True, SM, SMEM)
        assert plan.te % 16 == 0 and 16 <= plan.te <= -(-dh // 16) * 16
        assert plan.te // 16 * groups <= MC.MMA_MAX_WARPS
        assert plan.smem_bytes == MC.mma_smem_bytes(dh, plan.te) <= SMEM
        # no other tile makes fewer waves of its (weighed) blocks
        waves = -(-(B * H * -(-dh // plan.te)) // SM)
        for te in range(16, plan.te, 16):
            w = -(-(B * H * -(-dh // te)) // SM)
            assert w * max(te // 16 * groups, 4) >= \
                waves * max(plan.te // 16 * groups, 4)


def test_xlstm_125m_fills_one_wave():
    # 8 rows x 4 heads x dh 384: 96 columns a block in 12 warps (two
    # column groups of 192), 4 x 32 = 128 blocks on 132 SMs
    plan = MC.mlstm_plan(8, 4, 384, torch.bfloat16, True, SM, SMEM)
    assert plan == MC.MlstmPlan("mma", 96, 32, MC.mma_smem_bytes(384, 96))
    assert 4 * 32 <= SM
    # the serve's smaller admission groups take narrower tiles, so that
    # their blocks spread over more of the card
    assert MC.mlstm_plan(4, 4, 384, torch.bfloat16, True, SM, SMEM).te == 48
    assert MC.mlstm_plan(1, 4, 384, torch.bfloat16, True, SM, SMEM).te == 32


def test_a_small_shared_memory_limit_narrows_or_refuses_the_tile():
    full = MC.mlstm_plan(8, 4, 384, torch.bfloat16, True, SM, SMEM)
    tight = MC.mlstm_plan(8, 4, 384, torch.bfloat16, True, SM,
                          full.smem_bytes - 1)
    assert tight.body == "mma" and tight.te < full.te
    assert tight.smem_bytes < full.smem_bytes
    # below the narrowest tile's need: the CUDA-core body's figure, which
    # the wrapper then refuses
    plan = MC.mlstm_plan(8, 4, 384, torch.bfloat16, True, SM, 1024)
    assert plan.body == "simt" and plan.smem_bytes > 1024


def _parts(x, n):
    out, r = [], x
    for _ in range(n):
        p = r.to(torch.bfloat16).float()
        out.append(p)
        r = r - p
    return out


def split_operand_mlstm(q, k, v, i_pre, logf, state, parts):
    """The tensor-core body's arithmetic in plain torch: chunks of
    MC.CHUNK steps; raw scores from the bf16 q and k, and three products
    whose fp32 operand is cut into ``parts[name]`` bf16 parts, each
    part's product summed in fp32: q C (C), S V (the weighted scores) and
    the update (w_j v_j); the state weight applied after q C."""
    B, S, H, dh = q.shape
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    ig, lf = i_pre.transpose(1, 2), logf.transpose(1, 2)
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for c0 in range(0, S, MC.CHUNK):
        qb, kb, vb = (t[:, :, c0:c0 + MC.CHUNK] for t in (qf, kf, vf))
        ib, fb = ig[:, :, c0:c0 + MC.CHUNK], lf[:, :, c0:c0 + MC.CHUNK]
        Lc = qb.shape[2]
        Fc = torch.cumsum(fb, -1)
        Ft = Fc[..., -1]
        logw = Fc[..., :, None] - Fc[..., None, :] + ib[..., None, :]
        logw = torch.where(torch.ones(Lc, Lc, dtype=torch.bool).tril(),
                           logw, -torch.inf)
        logst = Fc + m[..., None]
        mi = torch.maximum(logw.amax(-1), logst)
        mi = torch.where(torch.isfinite(mi), mi, 0.0)
        sw = torch.exp(logst - mi)
        s = (qb @ kb.transpose(-1, -2)) * torch.exp(logw - mi[..., None])
        sv = sum(p @ vb for p in _parts(s, parts["S"]))
        qc = sum(qb @ p for p in _parts(C, parts["C"]))
        num = sv + sw[..., None] * qc
        den = s.sum(-1) + sw * (qb @ n[..., None])[..., 0]
        hs.append(num / torch.maximum(den.abs(), torch.exp(-mi))[..., None])
        m_new = torch.maximum(m + Ft, (Ft[..., None] - Fc + ib).amax(-1))
        decay = torch.exp(m + Ft - m_new)
        wk = torch.exp(Ft[..., None] - Fc + ib - m_new[..., None])
        C = decay[..., None, None] * C + sum(
            kb.transpose(-1, -2) @ p
            for p in _parts(wk[..., None] * vb, parts["W"]))
        n = decay[..., None] * n + (wk[..., None] * kb).sum(-2)
        m = m_new
    return torch.cat(hs, 2).transpose(1, 2), {"C": C, "n": n, "m": m}


def _inputs(rng, B, S, H, dh, state):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    q, k, v = (rng.normal(size=(B, S, H, dh)) for _ in range(3))
    i_pre = rng.normal(size=(B, S, H))
    logf = -np.log1p(np.exp(-(rng.normal(size=(B, S, H)) + 2)))
    st = {"C": t(rng.normal(size=(B, H, dh, dh)) * 0.1 * state),
          "n": t(np.abs(rng.normal(size=(B, H, dh))) * state),
          "m": t(rng.normal(size=(B, H)) * state)}
    bf = torch.bfloat16
    return (t(q).to(bf), t(k * dh ** -0.5).to(bf), t(v).to(bf), t(i_pre),
            t(logf)), st


def _scaled_errors(out, ref):
    (h, st), (h_r, st_r) = out, ref
    errs = {"h": (h - h_r).abs().max().item()
            / max(h_r.abs().max().item(), 1.0)}
    for key in ("C", "n", "m"):
        errs[key] = ((st[key] - st_r[key]).abs().max().item()
                     / max(st_r[key].abs().max().item(), 1.0))
    return errs


# reduced xlstm-125m (2 heads x 128), ragged chunks, zero and nonzero
# state; one case at the full head dim 384
CASES = [(2, 70, 2, 128, 1.0), (2, 33, 2, 128, 0.0), (1, 1, 2, 128, 1.0),
         (1, 40, 1, 384, 1.0)]


@pytest.mark.parametrize("B,S,H,dh,state", CASES)
def test_split_operands_hold_a_quarter_of_each_gate(B, S, H, dh, state):
    rng = np.random.default_rng(S + dh)
    args, st = _inputs(rng, B, S, H, dh, state)
    ref = MC.mlstm_chunked_ref(*args, st)
    errs = _scaled_errors(split_operand_mlstm(*args, st, MC.MMA_PARTS), ref)
    for key, gate in GATES.items():
        assert errs[key] <= gate / 4, (key, errs[key], gate)


def test_one_part_per_operand_misses_the_gates():
    # the check has teeth: fp32 operands rounded once to bf16 miss the
    # gates of h and C by orders of magnitude
    rng = np.random.default_rng(5)
    args, st = _inputs(rng, 2, 70, 2, 128, 1.0)
    errs = _scaled_errors(
        split_operand_mlstm(*args, st, {"C": 1, "S": 1, "W": 1}),
        MC.mlstm_chunked_ref(*args, st))
    assert errs["h"] > 10 * GATES["h"] and errs["C"] > 10 * GATES["C"]
