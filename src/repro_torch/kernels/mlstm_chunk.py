"""Chunkwise mLSTM on the card: the wrapper around the hand-written CUDA
kernel in ``repro_torch/csrc/mlstm_chunk.cu`` (built for ``sm_90a`` by
:mod:`repro_torch.kernels.build`), with its plain PyTorch version beside
it.

:func:`mlstm_chunked` replaces the reference's Pallas kernel
``repro.kernels.mlstm_chunk.mlstm_chunked_kernel``: the stabilised xLSTM
matrix-memory recurrence over a whole prompt, carrying C, n and m from
chunk to chunk.  In the port it carries every mLSTM prefill
(``models.ssm.mlstm_apply``), i.e. every xLSTM admission.  Unlike the
reference's wrapper, any S is taken: the kernel masks the ragged last
chunk itself, and its chunk length (32) is its own choice (the result
does not depend on it beyond fp32 rounding).

:func:`mlstm_plan` picks the body and the tile of value columns each
block carries: q/k/v at every dtype run on the tensor cores, each fp32 or
fp16 operand cut into bf16 parts (MMA_PARTS) and the part pairs' products
summed in fp32; only shapes that body does not take stay on CUDA cores
(see ``csrc/mlstm_chunk.cu``).

:func:`mlstm_chunked_bwd` is its backward, the hand-written kernels in
``repro_torch/csrc/mlstm_chunk_bwd.cu`` (the reference has none: it
differentiates its jnp path with ``jax.grad``).  It takes the state at
the start of every chunk, which the forward keeps when asked
(``return_states=True``), h and h's gradient, and returns the gradients
of q, k, v and both gates; ``ops.MlstmChunkedFn`` ties the two together
for autograd.  :func:`mlstm_bwd_plan` gives its launch: chunk-parallel
passes on the tensor cores, the operands cut into bf16 parts by dtype.

The wrappers take CUDA tensors only: they check device, dtype, layout,
shapes and the shared memory the launch needs, allocate the outputs,
launch on the current stream and raise if the launch failed.  They never
fall back to the plain version; dispatch by device lives in
:mod:`repro_torch.kernels.ops`.  They count their launches in
``mlstm_chunked.launches`` and ``mlstm_chunked_bwd.launches``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import scratch
from repro_torch.kernels.ref import (mlstm_chunked_bwd_ref,  # noqa: F401
                                     mlstm_chunked_ref)

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
BODIES = ("simt", "mma")      # codes 0, 1 in the kernel
CHUNK = 32                    # L, both bodies
SIMT_TILE_E = 64              # value columns per CUDA-core block
MMA_MAX_WARPS = 12            # kMmaMaxWarps in csrc/mlstm_chunk.cu
MMA_MAX_DW = 192              # columns of C^T a warp holds (kMmaMaxDW)
# bf16 parts of the tensor-core body's operands by q's dtype (MmaParts in
# csrc/mlstm_chunk.cu): q/k/v themselves (Q), C in q C, the weighted
# scores in S V, w_j v_j in the update of C; the products run over the
# part pairs (i, j) with i + j < 3
MMA_PARTS = {torch.bfloat16: {"Q": 1, "C": 2, "S": 2, "W": 3},
             torch.float16: {"Q": 2, "C": 2, "S": 2, "W": 3},
             torch.float32: {"Q": 3, "C": 3, "S": 3, "W": 3}}
BWD_THREADS = 512             # the backward's chunk passes (kThreads)
BWD_MAX_DIM = 384             # kMaxDim: dq's 48 n-tiles over 16 warps
# bf16 parts of the backward's operands by q's dtype (Parts in
# csrc/mlstm_chunk_bwd.cu): q/k/v, the chunk-local fp32 operands (dh, P /
# r, dS), the state products' fp32 operands (sw dN / r, C, G)
BWD_PARTS = {torch.bfloat16: (1, 2, 2), torch.float16: (2, 2, 2),
             torch.float32: (3, 3, 3)}


class MlstmPlan(NamedTuple):
    body: str            # one of BODIES
    te: int              # value columns of C per block
    L: int               # steps per chunk
    smem_bytes: int      # dynamic shared memory a block takes


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def mma_smem_bytes(dh: int, te: int, dtype: torch.dtype) -> int:
    """Shared memory of a tensor-core block (``MlstmMmaSmem`` in
    ``csrc/mlstm_chunk.cu``) for q/k/v of ``dtype``: at bf16 two stages of
    Q and K rows (dh padded to a multiple of 16, plus 8), of V columns and
    of gates; at fp16 / fp32 one stage of Q, K and V, each as bf16 planes
    (one a part), and of gates; then n's bf16 parts as an 8-row key tile,
    the raw scores, the bf16 parts of the scores and of w_j v_j, the other
    column groups' partial h, n and the per-row values."""
    L, dhp = CHUNK, _round16(dh)
    parts = MMA_PARTS[dtype]
    bufs, gate_stages = (2, 2) if parts["Q"] == 1 else (parts["Q"], 1)
    groups = -(-dhp // MMA_MAX_DW)
    q_stride, v_stride = (dhp + 8) * 2, (te + 8) * 2
    return (bufs * L * (2 * q_stride + v_stride) + gate_stages * 2 * L * 4
            + 8 * q_stride
            + L * (L + 4) * 4 + parts["S"] * L * (L + 8) * 2
            + parts["W"] * L * v_stride
            + (groups - 1) * L * (te + 4) * 4 + dhp * 4 + 7 * L * 4 + 16)


def simt_smem_bytes(dh: int) -> int:
    """Shared memory of a CUDA-core block: q and k rows (dh + 1 floats),
    the dh x 64 slice of C, the v tile, n, the scores and six per-row
    values, all fp32."""
    L = CHUNK
    return 4 * (2 * L * (dh + 1) + dh * SIMT_TILE_E + L * SIMT_TILE_E + dh
                + L * L + 6 * L)


def mlstm_plan(B: int, H: int, dh: int, dtype: torch.dtype, aligned: bool,
               sm_count: int, smem_limit: int) -> MlstmPlan:
    """The launch plan of :func:`mlstm_chunked` for B x H heads of dim dh,
    q/k/v of ``dtype`` (16-byte ``aligned`` or not) on a card of
    ``sm_count`` SMs whose blocks may take ``smem_limit`` bytes of shared
    memory.  Aligned, dh a multiple of 8 up to 2 x MMA_MAX_DW: the
    tensor-core body at every dtype (fp16 / fp32 as bf16 parts); else the
    CUDA-core body with its 64 columns.  The tensor-core block holds te
    columns of C in te / 16 x ceil(dh / MMA_MAX_DW) warps (at most
    MMA_MAX_WARPS), one block per SM; te is the multiple of 16 that makes
    the fewest waves of blocks, each weighed by its warps beyond one per
    SM sub-partition (ties to the larger te, which recomputes the scores
    fewer times), among those whose shared memory (``mma_smem_bytes`` at
    ``dtype``) fits.  At xlstm-125m's B = 8, H = 4, dh = 384: te = 96, 128
    blocks, one wave, at every dtype (fp32: 224,528 bytes a block)."""
    if dtype in MMA_PARTS and aligned and dh % 8 == 0 \
            and dh <= 2 * MMA_MAX_DW:
        groups = -(-_round16(dh) // MMA_MAX_DW)
        best = None
        for te in range(16, _round16(dh) + 1, 16):
            warps = te // 16 * groups
            smem = mma_smem_bytes(dh, te, dtype)
            if warps > MMA_MAX_WARPS or smem > smem_limit:
                break
            waves = -(-(B * H * -(-dh // te)) // sm_count)
            key = (waves * max(warps, 4), -te)
            if best is None or key < best[0]:
                best = (key, MlstmPlan("mma", te, CHUNK, smem))
        if best is not None:
            return best[1]
    return MlstmPlan("simt", SIMT_TILE_E, CHUNK, simt_smem_bytes(dh))


def _check(name, q, k, v, i_pre, logf, C0, n0, m0, *more):
    """The common checks of both wrappers: CUDA tensors on one device,
    contiguous, q/k/v of one kernel dtype, the rest fp32, the shapes of
    (B, S, H, dh) heads and a (B, H, dh, dh) state (C0: the initial state,
    or the chunk states (B, H, NC, dh, dh) with ``n0`` / ``m0`` likewise);
    ``more`` are fp32 (B, S, H, dh) tensors.  Returns (B, S, H, dh)."""
    tensors = (q, k, v, i_pre, logf, C0, n0, m0, *more)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"the CUDA {name} kernel takes CUDA tensors only "
                         "(CPU tensors go to the plain version through "
                         "repro_torch.kernels.ops)")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"the {name} kernel needs contiguous inputs")
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q/k/v must share one of fp32, fp16, bf16 (got "
                         f"{q.dtype}, {k.dtype}, {v.dtype})")
    if not all(t.dtype == torch.float32
               for t in (i_pre, logf, C0, n0, m0, *more)):
        raise ValueError("gates and state must be fp32")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, dh), got {tuple(q.shape)}")
    B, S, H, dh = q.shape
    lead = C0.shape[:-2]
    if k.shape != q.shape or v.shape != q.shape \
            or i_pre.shape != (B, S, H) or logf.shape != (B, S, H) \
            or lead[:2] != (B, H) or C0.shape[-2:] != (dh, dh) \
            or n0.shape != (*lead, dh) or m0.shape != lead \
            or any(t.shape != q.shape for t in more):
        raise ValueError(f"shapes do not fit q {tuple(q.shape)}: k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, gates "
                         f"{tuple(i_pre.shape)}/{tuple(logf.shape)}, state "
                         f"{tuple(C0.shape)}/{tuple(n0.shape)}/"
                         f"{tuple(m0.shape)}, "
                         f"{[tuple(t.shape) for t in more]}")
    if S < 1 or dh < 1:
        raise ValueError(f"S={S}, dh={dh}: both must be at least 1")
    return B, S, H, dh


def mlstm_chunked(q, k, v, i_pre, logf, state, *, return_states=False):
    """q, k, v: (B, S, H, dh) at one of fp32, fp16, bf16; i_pre / logf:
    (B, S, H) fp32; state: {"C": (B,H,dh,dh), "n": (B,H,dh), "m": (B,H)}
    fp32.  Returns h (B, S, H, dh) fp32 and the final state (new tensors;
    the initial state is not written).  With ``return_states`` (training)
    also the state at the start of every 32-step chunk, {"C":
    (B,H,NC,dh,dh), "n": (B,H,NC,dh), "m": (B,H,NC)}, NC = ceil(S / 32),
    written by the same launch (what :func:`mlstm_chunked_bwd` takes);
    without, the launch is the serving path's and writes none."""
    from repro_torch.kernels import build
    C0, n0, m0 = state["C"], state["n"], state["m"]
    if C0.dim() != 4:
        raise ValueError(f"the initial state C must be (B, H, dh, dh), got "
                         f"{tuple(C0.shape)}")
    B, S, H, dh = _check("mLSTM", q, k, v, i_pre, logf, C0, n0, m0)
    lib = build.load()
    limit = torch.cuda.get_device_properties(
        q.device).shared_memory_per_block_optin
    plan = mlstm_plan(B, H, dh, q.dtype,
                      not any(t.data_ptr() % 16 for t in (q, k, v)),
                      scratch.sm_count(q.device.index), limit)
    if plan.smem_bytes > limit:
        raise ValueError(f"dh={dh} needs {plan.smem_bytes} bytes of shared "
                         f"memory per block; the device allows {limit}")
    h = torch.empty((B, S, H, dh), dtype=torch.float32, device=q.device)
    C, n, m = (torch.empty_like(t) for t in (C0, n0, m0))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
            logf.data_ptr(), C0.data_ptr(), n0.data_ptr(), m0.data_ptr(),
            h.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr())
    tail = (_DTYPE_CODES[q.dtype], B, S, H, dh, BODIES.index(plan.body),
            plan.te, torch.cuda.current_stream().cuda_stream)
    if return_states:
        NC = -(-S // CHUNK)
        states = {"C": q.new_empty((B, H, NC, dh, dh), dtype=torch.float32),
                  "n": q.new_empty((B, H, NC, dh), dtype=torch.float32),
                  "m": q.new_empty((B, H, NC), dtype=torch.float32)}
    with torch.cuda.device(q.device):
        if return_states:
            err = lib.mlstm_chunk_states_launch(
                *args, *(states[key].data_ptr() for key in ("C", "n", "m")),
                *tail)
        else:
            err = lib.mlstm_chunk_launch(*args, *tail)
    _raise_on(lib, err, "mlstm_chunked")
    mlstm_chunked.launches += 1
    if return_states:
        return h, {"C": C, "n": n, "m": m}, states
    return h, {"C": C, "n": n, "m": m}


mlstm_chunked.launches = 0


def _raise_on(lib, err, name):
    if err:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({msg})")


class MlstmBwdPlan(NamedTuple):
    threads: int         # a block of the chunk passes (1 and 3)
    parts: tuple         # bf16 parts: q/k/v, chunk-local, state operands
    smem_bytes: tuple    # dynamic shared memory of passes 1 and 3


def bwd_smem_bytes(dh: int, dtype: torch.dtype) -> tuple:
    """Shared memory of the backward's two chunk passes (``BwdSmem`` in
    ``csrc/mlstm_chunk_bwd.cu``), rows of dh padded to a multiple of 16
    plus 8 elements.  Pass 1: the chunk's Q, K, V at their type, dh in
    fp32, three 32 x 40 fp32 tiles (the scores, P / r, dS), n, 12 per-row
    values, the warps' row sums and the decay.  Pass 3: K and V, g, two
    per-row values and the warps' row sums."""
    L, dp = CHUNK, _round16(dh)
    row_t = L * (dp + 8) * dtype.itemsize
    row_f = L * (dp + 8) * 4
    warps = BWD_THREADS // 32
    pass1 = (3 * row_t + row_f + 3 * L * (L + 8) * 4 + dp * 4 + 12 * L * 4
             + warps * L * 4 + 16)
    pass3 = 2 * row_t + dp * 4 + 2 * L * 4 + warps * L * 4
    return pass1, pass3


def mlstm_bwd_plan(dh: int, dtype: torch.dtype,
                   smem_limit: int) -> MlstmBwdPlan:
    """The launch plan of :func:`mlstm_chunked_bwd` for heads of dim dh
    and q/k/v of ``dtype`` on a card whose blocks may take ``smem_limit``
    bytes of shared memory.  One body for every dtype: chunk-parallel
    passes whose products run on the tensor cores, each operand cut into
    BWD_PARTS[dtype] bf16 parts (bf16 q/k/v exact in one; fp32 in three,
    which holds the plain fp32 backward to 1e-4); blocks of BWD_THREADS
    (16 warps, one block per SM), one per (chunk, batch row, head).
    Raises ValueError for a dh that is not a multiple of 8 up to
    BWD_MAX_DIM, or whose passes need more shared memory than the card
    gives a block."""
    if dtype not in BWD_PARTS:
        raise ValueError(f"the mLSTM backward takes fp32, fp16 or bf16 "
                         f"q/k/v, not {dtype}")
    if dh % 8 or not 8 <= dh <= BWD_MAX_DIM:
        raise ValueError(f"dh={dh}: the mLSTM backward takes head dims that "
                         f"are multiples of 8 up to {BWD_MAX_DIM}")
    smem = bwd_smem_bytes(dh, dtype)
    if max(smem) > smem_limit:
        raise ValueError(f"dh={dh} at {dtype} needs {max(smem)} bytes of "
                         f"shared memory per backward block; the device "
                         f"allows {smem_limit}")
    return MlstmBwdPlan(BWD_THREADS, BWD_PARTS[dtype], smem)


def _aligned(t):
    """``t``, or a copy of it on a 16-byte boundary (the kernels read rows
    16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def mlstm_chunked_bwd(q, k, v, i_pre, logf, states, h, dh):
    """The backward of :func:`mlstm_chunked` on the card: q, k, v, i_pre,
    logf as the forward took them, ``states`` the chunk states its
    ``return_states`` gave, h its output and dh h's gradient (B, S, H, dh)
    fp32.  Returns (dq, dk, dv) at q's dtype and (di, dlogf) (B, S, H)
    fp32, the gradient of h alone (no cotangent of the final state; the
    initial state takes none); see :func:`ref.mlstm_chunked_bwd_ref`, its
    plain version at ``chunk=CHUNK``.  One call is up to four launches
    (per chunk dq and the chunk's increments, their reverse scan, per
    chunk dk and dv, dlogf; :func:`mlstm_bwd_plan`) and counts one.  Its
    scratch is fp32: the increments and carried cotangents, B x H x NC x
    dh x (dh + 1) (the size of the chunk states), the chunk-local dk and
    dv, and a few values per step and per chunk."""
    from repro_torch.kernels import build
    Cs, ns, ms = states["C"], states["n"], states["m"]
    if Cs.dim() != 5:
        raise ValueError(f"the chunk states C must be (B, H, NC, dh, dh), "
                         f"got {tuple(Cs.shape)}")
    B, S, H, D = _check("mLSTM backward", q, k, v, i_pre, logf, Cs, ns, ms,
                        h, dh)
    NC = -(-S // CHUNK)
    if Cs.shape[2] != NC:
        raise ValueError(f"{Cs.shape[2]} chunk states for S={S}: the "
                         f"forward keeps one per {CHUNK} steps")
    plan = mlstm_bwd_plan(D, q.dtype, torch.cuda.get_device_properties(
        q.device).shared_memory_per_block_optin)
    lib = build.load()
    q, k, v, Cs, h, dh = map(_aligned, (q, k, v, Cs, h, dh))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    di, dlogf = torch.empty_like(i_pre), torch.empty_like(logf)
    # one fp32 scratch, each piece on a 16-byte boundary
    sizes = (B * H * NC * D * (D + 1), B * S * H * D, B * S * H * D,
             B * S * H, B * S * H, B * H * NC, B * H * NC, B * H * NC)
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + -(-n // 4) * 4)
    scratch = torch.empty(starts[-1], dtype=torch.float32, device=q.device)
    pieces = [scratch[a:a + n] for a, n in zip(starts, sizes)]
    with torch.cuda.device(q.device):
        err = lib.mlstm_chunk_bwd_launch(
            *(t.data_ptr() for t in (q, k, v, i_pre, logf, Cs, ns, ms, h, dh,
                                     dq, dk, dv, di, dlogf, *pieces)),
            _DTYPE_CODES[q.dtype], B, S, H, D, plan.threads, *plan.parts,
            *plan.smem_bytes, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "mlstm_chunked_bwd")
    mlstm_chunked_bwd.launches += 1
    return dq, dk, dv, di, dlogf


mlstm_chunked_bwd.launches = 0
