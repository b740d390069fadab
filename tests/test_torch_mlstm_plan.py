"""The launch plan of ``mlstm_chunked`` and the arithmetic of its
tensor-core body, on the CPU.

``mlstm_chunk.mlstm_plan`` picks the body by q's dtype and shape and, for
the tensor-core body, the tile of value columns each block carries.  The
kernel runs only on the card (``tests/test_torch_cuda.py``); these are the
rules it relies on: every dtype (bf16, fp16, fp32) reaches the tensor-core
body where the shape allows it, a block's warps and shared memory stay
within the kernel's limits at each dtype's layout, and at xlstm-125m's
width the grid is one wave.  The emulation below repeats the tensor-core
body's chunk step in plain torch, q/k/v and the fp32 operands cut into the
kernel's number of bf16 parts (``MMA_PARTS`` by dtype) and the part pairs
i + j < 3 summed in fp32, and holds it at the gates ``chip_smoke.py``
applies on the card (1e-4 of h's scale, 1e-5 of C's, n's and m's), with a
margin of four, to the plain version evaluated in fp64 on the same
inputs; at fp32 also to the card's fp64 gate (four times the plain fp32
version's own error).  The fp64 evaluation is the yardstick because the
plain fp32 version is not one: h divides by a denominator that passes
near zero, and the fp32 version's rounding there differs from one process
to another (its einsums' CPU kernels), by up to ~7e-5 of h's scale at the
first case below.
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


DTYPES = [torch.bfloat16, torch.float16, torch.float32]


@pytest.mark.parametrize("dh", DHS)
def test_body_by_dtype_alignment_and_head_dim(dh):
    """Every dtype takes the tensor-core body at aligned head dims that are
    multiples of 8 up to 384; unaligned inputs and other head dims the
    CUDA-core body."""
    for B, H in BH:
        for dtype in DTYPES:
            plan = MC.mlstm_plan(B, H, dh, dtype, True, SM, SMEM)
            assert plan.body == ("mma" if _mma_ok(dh) else "simt")
            assert plan.L == MC.CHUNK == 32
            if plan.body == "simt":
                assert plan == MC.MlstmPlan("simt", MC.SIMT_TILE_E, MC.CHUNK,
                                            MC.simt_smem_bytes(dh))
            assert MC.mlstm_plan(B, H, dh, dtype, False, SM,
                                 SMEM).body == "simt"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [d for d in DHS if _mma_ok(d)])
def test_tensor_core_blocks_fit_the_kernel(dh, dtype):
    groups = -(-(-(-dh // 16) * 16) // MC.MMA_MAX_DW)
    for B, H in BH:
        plan = MC.mlstm_plan(B, H, dh, dtype, True, SM, SMEM)
        assert plan.te % 16 == 0 and 16 <= plan.te <= -(-dh // 16) * 16
        assert plan.te // 16 * groups <= MC.MMA_MAX_WARPS
        assert plan.smem_bytes == MC.mma_smem_bytes(dh, plan.te, dtype) \
            <= SMEM
        # no other tile makes fewer waves of its (weighed) blocks
        waves = -(-(B * H * -(-dh // plan.te)) // SM)
        for te in range(16, plan.te, 16):
            w = -(-(B * H * -(-dh // te)) // SM)
            assert w * max(te // 16 * groups, 4) >= \
                waves * max(plan.te // 16 * groups, 4)


@pytest.mark.parametrize("dtype,smem", [(torch.bfloat16, 165392),
                                        (torch.float16, 165136),
                                        (torch.float32, 224528)])
def test_xlstm_125m_fills_one_wave(dtype, smem):
    # 8 rows x 4 heads x dh 384: 96 columns a block in 12 warps (two
    # column groups of 192), 4 x 32 = 128 blocks on 132 SMs, at every
    # dtype: fp32's one stage of three bf16 planes still fits 227 KB
    plan = MC.mlstm_plan(8, 4, 384, dtype, True, SM, SMEM)
    assert plan == MC.MlstmPlan("mma", 96, 32, smem)
    assert MC.mma_smem_bytes(384, 96, dtype) == smem <= SMEM
    assert 4 * 32 <= SM
    # the serve's smaller admission groups take narrower tiles, so that
    # their blocks spread over more of the card
    assert MC.mlstm_plan(4, 4, 384, dtype, True, SM, SMEM).te == 48
    assert MC.mlstm_plan(1, 4, 384, dtype, True, SM, SMEM).te == 32


def test_shared_memory_layout_by_dtype():
    """bf16 keeps two cp.async stages of its rows; fp16 / fp32 one stage
    of bf16 planes, one a part of q/k/v (the backward's part counts),
    because two stages of raw fp32 Q and K rows (200,704 bytes at dh =
    384) would not fit beside the rest of the block's layout."""
    for dtype in (torch.float16, torch.float32):
        assert MC.MMA_PARTS[dtype]["Q"] == MC.BWD_PARTS[dtype][0]
    assert MC.MMA_PARTS[torch.bfloat16]["Q"] == 1
    L, row = MC.CHUNK, (384 + 8) * 2
    rest = MC.mma_smem_bytes(384, 96, torch.float32) - 3 * L * (2 * row +
                                                                 (96 + 8) * 2)
    assert 2 * 2 * L * (384 + 8) * 4 == 200704 and rest + 200704 > SMEM
    # each plane is the bf16 layout's stage: bf16's two stages, fp32's
    # three planes, with fp32's parts of S beside them
    diff = (MC.mma_smem_bytes(384, 96, torch.float32)
            - MC.mma_smem_bytes(384, 96, torch.bfloat16))
    assert diff == L * (2 * row + (96 + 8) * 2) - 2 * L * 4 + L * (L + 8) * 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_small_shared_memory_limit_narrows_or_refuses_the_tile(dtype):
    full = MC.mlstm_plan(8, 4, 384, dtype, True, SM, SMEM)
    tight = MC.mlstm_plan(8, 4, 384, dtype, True, SM, full.smem_bytes - 1)
    assert tight.body == "mma" and tight.te < full.te
    assert tight.smem_bytes < full.smem_bytes
    # below the narrowest tile's need: the CUDA-core body's figure, which
    # the wrapper then refuses
    plan = MC.mlstm_plan(8, 4, 384, dtype, True, SM, 1024)
    assert plan.body == "simt" and plan.smem_bytes > 1024


def _parts(x, n):
    out, r = [], x
    for _ in range(n):
        p = r.to(torch.bfloat16).float()
        out.append(p)
        r = r - p
    return out


def _pairs(a, b, pa, pb):
    """a @ b over the part pairs (i, j) with i + j < 3 (every pair whose
    product is at least 2^-16 of the leading one's: the kernel's
    part_pair), each pair's product in fp32."""
    return sum(x @ y for i, x in enumerate(_parts(a, pa))
               for j, y in enumerate(_parts(b, pb)) if i + j < 3)


def split_operand_mlstm(q, k, v, i_pre, logf, state, parts):
    """The tensor-core body's arithmetic in plain torch: chunks of
    MC.CHUNK steps; q, k and v cut into ``parts["Q"]`` bf16 parts (bf16:
    one, exact), and every product over the part pairs i + j below the
    larger count, each pair's product summed in fp32: the raw scores (Q
    K^T), q C (C in ``parts["C"]``), S V (the weighted scores in
    ``parts["S"]``) and the update (w_j v_j in ``parts["W"]``); q . n
    from every part of q against n (exact: its three parts are the key
    tile's columns); n's update from k's exact value; the state weight
    applied after q C."""
    B, S, H, dh = q.shape
    pq = parts["Q"]
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
        s = _pairs(qb, kb.transpose(-1, -2), pq, pq) \
            * torch.exp(logw - mi[..., None])
        sv = _pairs(s, vb, parts["S"], pq)
        qc = _pairs(qb, C, pq, parts["C"])
        num = sv + sw[..., None] * qc
        qn = sum(p @ n[..., None] for p in _parts(qb, pq))[..., 0]
        den = s.sum(-1) + sw * qn
        hs.append(num / torch.maximum(den.abs(), torch.exp(-mi))[..., None])
        m_new = torch.maximum(m + Ft, (Ft[..., None] - Fc + ib).amax(-1))
        decay = torch.exp(m + Ft - m_new)
        wk = torch.exp(Ft[..., None] - Fc + ib - m_new[..., None])
        C = decay[..., None, None] * C + _pairs(
            kb.transpose(-1, -2), wk[..., None] * vb, pq, parts["W"])
        n = decay[..., None] * n + (wk[..., None] * kb).sum(-2)
        m = m_new
    return torch.cat(hs, 2).transpose(1, 2), {"C": C, "n": n, "m": m}


def _inputs(rng, B, S, H, dh, state, dtype=torch.bfloat16):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    q, k, v = (rng.normal(size=(B, S, H, dh)) for _ in range(3))
    i_pre = rng.normal(size=(B, S, H))
    logf = -np.log1p(np.exp(-(rng.normal(size=(B, S, H)) + 2)))
    st = {"C": t(rng.normal(size=(B, H, dh, dh)) * 0.1 * state),
          "n": t(np.abs(rng.normal(size=(B, H, dh))) * state),
          "m": t(rng.normal(size=(B, H)) * state)}
    return (t(q).to(dtype), t(k * dh ** -0.5).to(dtype), t(v).to(dtype),
            t(i_pre), t(logf)), st


def _fp64(args, st):
    """The plain version evaluated in fp64 on these inputs."""
    return MC.mlstm_chunked_ref(*(t.double() for t in args),
                                {k: t.double() for k, t in st.items()})


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,dh,state", CASES)
def test_split_operands_hold_a_quarter_of_each_gate(B, S, H, dh, state,
                                                    dtype):
    rng = np.random.default_rng(S + dh)
    args, st = _inputs(rng, B, S, H, dh, state, dtype)
    errs = _scaled_errors(
        split_operand_mlstm(*args, st, MC.MMA_PARTS[dtype]), _fp64(args, st))
    for key, gate in GATES.items():
        assert errs[key] <= gate / 4, (key, errs[key], gate)


@pytest.mark.parametrize("dtype", DTYPES)
def test_one_part_per_operand_misses_the_gates(dtype):
    # the check has teeth: operands rounded once to bf16 (q/k/v too at
    # fp16 / fp32) miss the gates of h and C by orders of magnitude
    rng = np.random.default_rng(5)
    args, st = _inputs(rng, 2, 70, 2, 128, 1.0, dtype)
    errs = _scaled_errors(
        split_operand_mlstm(*args, st, {"Q": 1, "C": 1, "S": 1, "W": 1}),
        _fp64(args, st))
    assert errs["h"] > 10 * GATES["h"] and errs["C"] > 10 * GATES["C"]


def _fp64_err(got, plain, truth):
    scale = truth.abs().max().item()
    return ((got.double() - truth).abs().max().item() / scale,
            (plain.double() - truth).abs().max().item() / scale)


def test_fp32_parts_hold_the_fp64_gate():
    """At fp32 the plan's parts keep h and the state within the card's
    fp64 gate (four times the plain fp32 version's error against the
    plain version in fp64, or 1e-6 of the scale); two parts of q/k/v do
    not."""
    rng = np.random.default_rng(9)
    args, st = _inputs(rng, 2, 70, 2, 128, 1.0, torch.float32)
    (h_p, st_p) = MC.mlstm_chunked_ref(*args, st)
    h_t, st_t = _fp64(args, st)
    assert h_t.dtype == torch.float64
    h, fin = split_operand_mlstm(*args, st, MC.MMA_PARTS[torch.float32])
    for got, plain, truth in [(h, h_p, h_t)] + [
            (fin[k], st_p[k], st_t[k]) for k in ("C", "n", "m")]:
        err, perr = _fp64_err(got, plain, truth)
        assert err <= max(4 * perr, 1e-6), (err, perr)
    h2, fin2 = split_operand_mlstm(*args, st, {**MC.MMA_PARTS[torch.float32],
                                               "Q": 2})
    err, perr = _fp64_err(h2, h_p, h_t)
    assert err > 4 * max(perr, 1e-6)
