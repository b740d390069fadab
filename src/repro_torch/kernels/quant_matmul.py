"""Weight-only int8 matmul on the card: the wrapper around the hand-written
CUDA kernels in ``repro_torch/csrc/quant_matmul.cu`` (built for ``sm_90a``
by :mod:`repro_torch.kernels.build`), with its plain PyTorch version
beside it.

:func:`quant_matmul` replaces the reference's Pallas kernel
``repro.kernels.quant_matmul.quant_matmul``: ``(x @ q) * s`` in fp32 for
activations x (..., K), int8 codes q (K, N) and per-output-channel fp32
scales s (N,) (``core.precision.quantize_weights``).  It serves every
dense matmul of the serve path when ``weights_dtype="int8"``.

:func:`qmm_plan` picks the body, by x's dtype and row count, and the
split of K: fp32 x runs on CUDA cores (a tensor-core body would multiply
in TF32 and break the fp32 card-vs-CPU greedy parity); bf16/fp16 x runs on
the tensor cores, in a body bound by the code bytes for M <= 8 (decode
steps, the tied head) and a tiled one above (verify and prefill streams).

The wrapper takes CUDA tensors only: it checks device, dtype and layout,
allocates the output, launches on the current stream (split-K scratch
comes from :mod:`repro_torch.kernels.scratch`) and raises if the launch
failed.  It never falls back to the plain version; dispatch by device
lives in :mod:`repro_torch.kernels.ops`.  It counts its launches in
``quant_matmul.launches``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import scratch
from repro_torch.kernels.ref import quant_matmul_ref  # noqa: F401

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
MAX_ROWS = 65535 * 32          # the CUDA-core body's grid limit on x's rows
BODIES = ("simt", "mma_decode", "mma_tiled")   # codes 0, 1, 2 in the kernel
DECODE_MAX_ROWS = 8            # M <= 8: the bytes-bound tensor-core body
MMA_COLS, MMA_K_TILE = 128, 64  # a tensor-core block's columns, K tile
MMA_TILE_ROWS = {"mma_decode": 8, "mma_tiled": 64}   # x rows per block
SIMT_COLS, SIMT_K_CHUNK = 32, 256
MAX_SPLITS = 16
# blocks per SM the split-K plan aims for: the decode body is bound by
# bytes in flight, the others need fewer blocks to stay busy
BLOCKS_PER_SM = {"simt": 4, "mma_decode": 4, "mma_tiled": 2}


class QmmPlan(NamedTuple):
    body: str            # one of BODIES
    splits: int          # slices of K, each in its own blocks
    k_per_split: int     # rows of q per split (the last may have fewer)
    tiles: int           # output tiles (blocks per split)
    scratch_floats: int  # fp32 partials the splits write (0 with one)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def qmm_plan(M: int, K: int, N: int, dtype: torch.dtype,
             sm_count: int) -> QmmPlan:
    """The launch plan of ``quant_matmul`` for x (M, K) of ``dtype`` and q
    (K, N) on a card of ``sm_count`` SMs.  Where the output tiles alone
    give fewer blocks than ``BLOCKS_PER_SM[body] * sm_count``, K is cut
    into ``splits`` runs of ``k_per_split`` rows (a whole number of the
    body's K tiles; split s takes rows [s * k_per_split, min((s + 1) *
    k_per_split, K))), so every row lies in exactly one split and none is
    empty, with ``want/2 < splits <= want`` for ``want`` = min(K tiles,
    ceil(target / tiles), MAX_SPLITS).  One split when the grid already
    fills the card or K is one tile."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"quant_matmul takes fp32, fp16 or bf16 x, not "
                         f"{dtype}")
    if dtype == torch.float32:
        body, unit = "simt", SIMT_K_CHUNK
        mt = 8 if M <= 8 else 16 if M <= 16 else 32
        tiles = _cdiv(N, SIMT_COLS) * _cdiv(M, mt)
    else:
        body = "mma_decode" if M <= DECODE_MAX_ROWS else "mma_tiled"
        unit = MMA_K_TILE
        tiles = _cdiv(N, MMA_COLS) * _cdiv(M, MMA_TILE_ROWS[body])
    k_tiles = _cdiv(K, unit)
    want = min(k_tiles, _cdiv(BLOCKS_PER_SM[body] * sm_count, max(tiles, 1)),
               MAX_SPLITS)
    if want <= 1:
        return QmmPlan(body, 1, max(k_tiles, 1) * unit, tiles, 0)
    per = _cdiv(k_tiles, want)
    splits = _cdiv(k_tiles, per)
    if splits == 1:
        return QmmPlan(body, 1, k_tiles * unit, tiles, 0)
    floats = (splits * M * N if body == "simt"
              else tiles * splits * MMA_TILE_ROWS[body] * MMA_COLS)
    return QmmPlan(body, splits, per * unit, tiles, floats)


def quant_matmul(x, q, s):
    """``x @ (q * s)`` in fp32 on the card: x (..., K) fp32/fp16/bf16,
    q (K, N) int8 row-major, s (N,) fp32, all contiguous on one CUDA
    device.  Returns (..., N) fp32 (callers cast back to their compute
    dtype)."""
    from repro_torch.kernels import build
    if not (x.is_cuda and q.is_cuda and s.is_cuda):
        raise ValueError("the CUDA quant_matmul kernel takes CUDA tensors "
                         "only (CPU tensors go to the plain version through "
                         "repro_torch.kernels.ops)")
    if not x.device == q.device == s.device:
        raise ValueError("x, q and s must be on one device")
    if x.dtype not in _DTYPE_CODES or q.dtype != torch.int8 \
            or s.dtype != torch.float32:
        raise ValueError(f"quant_matmul takes x fp32/fp16/bf16, q int8 and "
                         f"s fp32 (got {x.dtype}, {q.dtype}, {s.dtype})")
    if q.dim() != 2 or s.shape != (q.shape[1],) or x.dim() < 1 \
            or x.shape[-1] != q.shape[0]:
        raise ValueError(f"shapes do not fit x (..., K) @ q (K, N), s (N,): "
                         f"{tuple(x.shape)}, {tuple(q.shape)}, "
                         f"{tuple(s.shape)}")
    if not (x.is_contiguous() and q.is_contiguous() and s.is_contiguous()):
        raise ValueError("quant_matmul needs contiguous x, q and s")
    K, N = q.shape
    M = x.shape[:-1].numel()
    if M > MAX_ROWS:
        raise ValueError(f"{M} rows exceed the kernel's limit of {MAX_ROWS}")
    out = torch.empty((*x.shape[:-1], N), dtype=torch.float32,
                      device=x.device)
    if M == 0 or N == 0:
        return out
    lib = build.load()
    plan = qmm_plan(M, K, N, x.dtype, scratch.sm_count(x.device.index))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws = counters = None                      # kept alive over the launch
    if plan.splits > 1:
        ws = scratch.split_scratch(x.device, stream, plan.scratch_floats)
        if plan.body != "simt":
            counters = scratch.split_counters(x.device, stream, plan.tiles)
    with torch.cuda.device(x.device):
        err = lib.quant_matmul_launch(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (ws, counters)),
            _DTYPE_CODES[x.dtype], M, K, N, BODIES.index(plan.body),
            plan.splits, plan.k_per_split, stream)
    if err:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"quant_matmul launch failed: CUDA error {err} "
                           f"({msg})")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
