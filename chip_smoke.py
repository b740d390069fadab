#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --src OTHER_CHECKOUT/src
    python3 chip_smoke.py --only flash --only train [--src ...]
    python3 chip_smoke.py --only ragged [--src ...]
    python3 chip_smoke.py --only mlstm [--src ...]
    python3 chip_smoke.py --only attn [--src ...]

Phases, one JSON line each, each with its ``seconds`` (a kernel case's
own time, else the time since the previous line) and ``elapsed_s``; any
failure exits non-zero before the last line (``--src`` runs every phase on
another checkout's port, such as a ``git archive`` of a parent commit, so
that two versions are timed in one call on one card; ``--only flash``
runs only the flash forward and backward cases at the train shapes,
``--only train`` only the full-width unimo-text fp32 train run, ``--only
ragged`` only the grouped product's kernel cases, ``--only mlstm`` only the
mLSTM forward's kernel cases and the full-width xlstm-125m train runs
(fp32 and mixed), ``--only attn`` only the timed bf16 cases of the flash
forward and the paged decode, packed and mixed kernels, for such an A/B):

  1. device   the card's name, power limit, torch / CUDA versions
  2. build    compile the CUDA kernels from ``src/repro_torch/csrc`` (one
              nvcc per source, in parallel, sm_90a: ``paged_attention.cu``,
              ``paged_{decode,mixed,packed}_mma.cu``,
              ``dense_decode.cu``, ``flash_attention.cu``,
              ``quant_matmul.cu``, ``mlstm_chunk.cu``, ``rmsnorm.cu``,
              ``flash_attention_bwd.cu`` and its kernels in
              ``flash_attention_bwd_{bf16,fp16,fp32}.cu``,
              ``mlstm_chunk_bwd.cu`` and ``ragged_matmul.cu``) and
              report the build seconds, each
              source's nvcc seconds (``source_seconds``) and ptxas
              resource use (registers, spills; the grouped product's
              kernels again on the ``ragged_kernels`` line)
  3. kernels  each kernel against its plain PyTorch version on the card at
              the main path's shapes: the paged attention kernels at
              unimo-text's (Hq = Hkv = 16, D = 64) and qwen3-4b's (Hq 32,
              Hkv 8, D 128) heads, 16-token pages, 8 slots and a 256-lane
              packed stream, over bf16 / fp16 / fp32 pools and, for the
              ``_q8`` kernels, over int8 pools with q at bf16, fp16 and
              fp32, each with a window + softcap case; ``quant_matmul`` at
              every qwen3-4b decode shape (M = 8; the tied head also at
              fp16), at M = 256 and M = 40 and on ragged shapes; the
              mixed kernels (and ``_q8``, q at bf16 and fp32) at qwen3-4b's
              verify shape (8 slots, k + 1 = 5 lanes) and at a (1, 256)
              prefill-chunk row; flash attention at unimo-text's draft
              shape (8 x 260, 16 heads x 64), at qwen3-4b's GQA heads and
              on a small case with -1 positions, a window and a softcap;
              ``mlstm_chunked`` at xlstm-125m's width (8 rows, 4 heads x
              384; S = 300 from a nonzero state and S = 64, timed at bf16
              and fp32, S = 300 at fp16) and at the reduced head dim 128,
              q/k/v at bf16, fp32 and fp16, each output's error also as a
              fraction of its gate (``gate_frac``), fp32's also against
              the plain version in fp64; the unwired
              ``fused_rmsnorm`` (4096 x 2560 bf16 and fp32, both timed, a
              ragged row count) and dense ``decode_attention`` (qwen3-4b's
              heads over 8 x 256 and 8 x 4096 keys, both timed; fp16, a
              window + softcap; a ragged fp32 case; the dense KV cache's
              own shape, 8 x 512 rows with 256 valid, timed).  Flash also
              at the paper's serving shapes: qwen3-4b's 8 x 128 bucket
              prefill (timed; a ragged variant) and the prefix-attend
              admission, 8 suffix buckets of 32 lanes against 256
              gathered keys with -1 holes (timed; fp32 too).  The mixed,
              decode and packed pairs, dense decode and ``quant_matmul``
              run their tensor-core bodies at bf16 / fp16 and their
              CUDA-core bodies at fp32; flash (forward and backward),
              ``mlstm_chunked`` and the grouped product their tensor-core
              bodies at every dtype, fp32 as bf16 parts, each fp32 case's
              error also against the plain version evaluated in fp64,
              beside the plain fp32 version's own (gated at 4x that, or
              1e-6 of the output's scale); every timed case of the mLSTM
              forward, of the packed pair at bf16 and of flash, the mLSTM
              forward and the grouped product at fp32 must show that body
              (its fp32 instance) in the profile.  Times the
              kernel, the plain version and a PyTorch yardstick the port
              never calls (``library_ms``) with CUDA events around each
              call (host path included), and the device time per call of
              the kernel alone (``device_ms``) and of the yardstick's
              kernels (``library_device_ms``) with ``torch.profiler``
  4. parity   reduced unimo-text and reduced qwen3-4b in fp32 (TF32 off):
              packed, decode, verify, mixed and train forwards on the card
              against the same forwards through the plain versions on the
              CPU, and short greedy serves on both (packed; speculative with
              the n-gram drafter and self-drafting; ``packed=False``), whose
              streams must all be equal; qwen3-4b also at int8 KV + int8
              weights (packed forwards and serve); reduced xlstm-125m:
              prefill and decode logits and states within 1e-5 of the
              CPU's, and equal greedy streams through the bucketed
              admission path; ``parity_dense`` (reduced unimo-text and
              qwen3-4b, fp32): dense-cache prefill, resumed prefill and
              decode logits, then ``generate_batch`` with and without the
              KV cache, ``run_pipelined`` and bucketed ``serve_continuous``
              (plain, behind a ``set_prefix`` prefix, over an int8 pool),
              whose streams and admission counters must equal the CPU's,
              with KV == no-cache and bucketed == chunked
  5. overload reduced qwen3-4b in fp32 on the card and the CPU: a pool of
              11 pages with ``preemption="lru"`` and a host KV tier, the
              same under ``FaultConfig(host_full=True)``, and
              ``preemption="priority"``, with ``debug_audit=True``, and a
              pruned-vocabulary serve: streams, outcomes and overload
              counters must equal the CPU's, and each preempting serve's
              streams the uncontended serve's
  6. serve    full-width unimo-text (24 layers, bf16) and full-width
              qwen3-4b (36 layers, bf16, then int8 KV + int8 weights), random
              weights from a seeded torch.Generator, through
              ``serve_continuous``; the launch counts of each run must equal
              layers x the packed iterations and layers x the decode steps
              for the attention kernels of its pool, and 253 x the forwards
              for ``quant_matmul`` under int8 weights.  Then four serves
              off the packed decode path, k = 4: qwen3-4b with the n-gram
              drafter at bf16 and at int8 KV + int8 weights (the mixed
              kernel of the pool's type once per layer and verify step, no
              decode kernel), qwen3-4b bf16 with ``packed=False`` (the mixed
              kernel once per layer and chunk, the decode kernel once per
              layer and decode step, no packed kernel) and unimo-text bf16
              self-drafting (flash once per layer and draft forward).  Each
              serve then runs once more under ``torch.profiler``
              (``profile`` lines): device time by kernel, the port's
              kernels' share of the busy time, the device's idle share and
              the total device time of the tensor-core packed and mLSTM
              bodies.  Last, full-width xlstm-125m (12 layers, bf16)
              through the bucketed admission path: 16 requests (4 of them
              150-300 tokens) x 32 new tokens, 8 slots, max_len 512; the
              mLSTM kernel must run 6 x the admission dispatches and no
              other kernel may run.  Between them, this slice's serves:
              qwen3-4b on a contended pool (a third of the uncontended
              serve's peak pages, ``preemption="lru"``, a host tier that
              holds every snapshot, the per-iteration audit) at bf16 and
              at int8 KV + int8 weights, which must preempt and resume
              every preempted request (``contended`` lines: the greedy
              match against the uncontended serve, the offload and
              restore time and bytes per page); the n-gram serve again
              with a ``ServeTracer`` whose JSONL and Perfetto exports go
              to ``build/`` (the JSONL must validate and its device spans
              sum to ``metrics.device_s``; ``tracing_cost``: wall and busy
              time beside the untraced serve's); and unimo-text pruned as
              ``--prune-coverage 0.999`` prunes it, its position table
              trimmed to max_len, at int8 weights (``pruned``: V_new, the
              embedding bytes before and after), whose results must lie in
              the original id space.  The kernel phase also holds
              ``quant_matmul`` at the pruned head's K = 1024, N = V_new.
              The paper's own path: qwen3-4b bf16 through
              ``run_pipelined`` and ``run_sequential`` over the dense KV
              cache and the no-cache baseline (16 prompts x 8 tokens), its
              bucketed admission behind a 32-token prefix pinned by
              ``set_prefix`` at bf16 and at int8 KV + int8 weights (beside
              the packed serve of the same requests), and unimo-text as the
              paper serves it (fp16, pruned to coverage 0.999, pipelined):
              flash layers x prefill (or admission) dispatches, plus layers
              x full forwards without the cache; the dense decode kernel
              layers x dense decode steps; no packed or mixed launch.
              Depth: only the qwen3-4b packed bf16 and int8 serves (whose
              byte checks are full-width figures) run all 36 layers; the
              n-gram (bf16, int8, traced), ``packed=False``, dense
              (sequential, pipelined, no-cache), prefix (packed, bucketed
              bf16 and int8) and contended serves run 12 of 36
              (QWEN3_CUT_LAYERS), beside a packed bf16 and int8 serve of
              the same 12 layers, whose streams and peak pages they are
              compared with
  7. families phi3-mini-3.8b, gemma2-2b and gemma3-27b: the kernel phase
              also holds every paged pair, flash and dense decode at
              phi3-mini's heads (32 / 32 x 96, the 128 head-dim bucket)
              and gemma2-2b's (8 / 4 x 256, window 4096, softcap 50; also
              past the window), gemma3-27b's decode pair past its window
              of 1024, and ``quant_matmul`` at phi3's untied head (3072
              -> 32064) and gemma2's tied head (2304 -> 256000), bf16
              timed, fp32 checked; ``parity_family``: the three reduced
              configs (window 64) in fp32, ``forward_train``, a packed
              (phi3) or bucketed (gemma, ring pages wrapping) serve and
              ``generate_batch`` with and without the cache (dense rings
              wrapping), card == CPU; full-width phi3-mini (32 layers:
              packed; at 12 of 32 int8 KV + int8 weights, n-gram,
              ``packed=False``), gemma2-2b (26 layers: bucketed at bf16;
              at 10 of 26 int8 / int8, pipelined over the dense rings,
              no-cache) and gemma3-27b at
              12 of its 62 layers (bucketed), each with its launch gates
              and profile; one sampled serve per path (packed phi3,
              bucketed and dense gemma2: shape, range, no EOS);
              ``long_serve``: gemma3-27b (12 layers) on 4 prompts of
              1,100-1,400 tokens at max_len 2048, its rings wrapping;
              ``teacher_forced``: gemma2-2b in fp32, a 4,400-token prompt
              and 16 decode steps through the wrapped dense ring against
              the full forward's logits (TEACHER_TOL)
  8. moe, mm   qwen3-moe-235b-a22b, internvl2-1b and musicgen-medium:
              the kernel phase also holds the decode, mixed and dense decode
              kernels at qwen3-moe's heads (64 / 4 x 128, g = 16), flash at
              its exact-length admissions (1 x 77, 8 x 78) and
              ``quant_matmul`` at its untied head (4096 -> 151936) and q /
              o projections; the packed and decode pairs, dense decode and
              flash (8 x 320: 256 prefix embeddings + 64 tokens) at
              internvl2-1b's (14 / 2 x 64, g = 7); flash and dense decode
              at musicgen-medium's (24 / 24 x 64); ``parity_moe_mm``:
              reduced qwen3-moe in fp32 at its own capacity factor 1.5
              (assignments dropped: counted on the CPU run), bucketed
              ``serve_continuous`` and ``generate_batch`` with and without
              the cache, card == CPU; reduced internvl2-1b (prefix
              embeddings) and musicgen-medium (codebooks, sinusoidal
              positions) train, prefill and decode logits, card == CPU;
              full-width qwen3-moe at 8 of its 94 layers (42.3 GB of bf16
              weights): bucketed at exact lengths at bf16, then at 4 of 94
              layers at int8 / int8 (4 records a layer and the head
              through ``quant_matmul``), the bf16 serve again (equal
              streams), pipelined over the dense cache at 4 of 94 layers,
              sampled, and ``moe_expert_bound`` (every forward
              reads all 128 experts: 38.7 GB, 11.5 ms at 3.35 TB/s, beside
              the profiled busy time); full-width internvl2-1b packed
              (text-only) and ``forward_mm`` (8 rows of 256 prefix
              embeddings + 64 tokens, prefill and 32 greedy decode steps
              over the dense cache), musicgen-medium ``forward_mm`` (8 x 64
              steps x 4 codebooks, an argmax per codebook); and the fp32
              ``teacher_forced`` checks of both (16 decode steps against
              ``forward_train``, TEACHER_TOL, argmax equal)
  9. hybrid, hymba-1.5b and deepseek-v3-671b: the kernel phase also holds
     mla      the decode pair (and its int8 twin) at hymba's heads (25 / 5
              x 64: g = 5, window 1024) over up to 2048 keys, flash at the
              exact-length admissions 1 x 77 and 8 x 78 at hymba's heads
              and at deepseek's MLA naive form (128 heads, D 192 against
              Dv 128), dense decode at g = 5 and ``quant_matmul`` at
              hymba's tied head (1600 -> 32001) and deepseek's untied head
              (7168 -> 129280); ``parity_hybrid_mla``: both reduced
              configs in fp32, bucketed ``serve_continuous`` and
              ``generate_batch`` with and without the cache, card == CPU,
              and deepseek's equal-length batched admission (== single
              requests); full-width hymba: bucketed at bf16 (32 layers);
              at its first 8 layers (the global one and 7 windowed) int8
              / int8 (the int8 KV request warns, the pool stays bf16),
              pipelined over the dense cache, no-cache, sampled and
              ``long_serve`` past its window; the fp32
              ``teacher_forced`` check past it (32 layers, 1400 tokens); deepseek-v3
              at full width, 1 dense + 2 MoE layers of 61 (53 GB of bf16
              weights, drawn a 1 GB expert slice at a time): bucketed at
              bf16 and int8 / int8, pipelined, sampled,
              ``moe_expert_bound`` (512 experts, 45.1 GB a forward), then
              the fp32 check of the absorbed decode against the naive full
              forward at 1 dense + 1 MoE layer (2 rows x 64 tokens)
 10. train    the build includes ``flash_attention_bwd.cu`` (its and
              ``mlstm_chunk_bwd.cu``'s kernels' registers and spills on
              the ``bwd_kernels`` line); the kernel
              phase also holds the flash backward kernel (from the forward
              kernel's o and log-sum-exp) against the plain backward and
              against autograd through the plain forward at unimo-text's
              train shape (8 x 128, 16 x 64), qwen3-4b's microbatch (4 x
              128, 32 / 8 x 128), gemma2-2b's (4 x 256, 8 / 4 x 256,
              window 4096, softcap 50), MLA's naive form (1 x 128, 128
              heads, D 192 / Dv 128) and a ragged case with rows that see
              no key, at fp32, bf16 and fp16 (timed against SDPA's
              backward), and the forward with its log-sum-exp at
              unimo-text's train shape, fp32 and bf16 (timed against
              SDPA's forward with the same mask, TF32 off); the mLSTM
              backward kernel (from the forward
              kernel's chunk states and h) against the plain backward at
              xlstm-125m's width (8 rows, 4 heads x 384: S = 128 from the
              zero state, S = 300 from a nonzero one), fp32 and bf16, and
              the long training context 4 x 2048 at bf16, two calls
              bit-identical (S = 128 timed at both, S = 300 and 2048 at
              bf16, each of its kernels' device ms);
              ``train_parity``: one fp32 ``make_train_step`` of each of
              nine reduced configs (xlstm-125m's through both mLSTM
              kernels) on the card equals the CPU's (loss, gnorm, every
              gradient and parameter; the step's peak memory, xlstm-125m's
              mLSTM kernels' device ms); ``train``: full-width unimo-text
              (24 layers) on packed batches of 8 x 128 over the Zipf
              corpus, 30 steps at fp32 and at mixed precision, whose loss
              must fall by 0.3 nats, qwen3-4b at all 36 layers, mixed,
              factored AdamW, two microbatches, 3 steps (finite, every
              leaf moved), and xlstm-125m (12 layers) at fp32 (the
              trainer's default) and at mixed precision, 6 steps each
              whose loss must fall by 0.3 nats (each profiled step's
              mLSTM forward the tensor-core body's instance at its
              dtype: fp32, bf16), each with step seconds,
              train tokens/s, peak memory, launches (flash forward twice a
              layer and step, its backward once; xlstm: the mLSTM forward
              twice an mLSTM layer and step, its backward once; nothing
              else) and one profiled step
 11. mesh     the sharding rules and the dry run (``--only mesh`` runs it
              alone): ``dryrun`` lines, the production combos qwen3-4b
              train_4k and decode_32k and deepseek-v3-671b decode_32k on
              the fake 16 x 16 mesh (this host's CPU, nothing allocated):
              per-device parameter, optimizer and cache bytes, the peak,
              FLOPs, bytes, collectives by type; gated on FLOPs and bytes,
              the train step's collectives and the parameter bytes the
              rules give each device; then full-width qwen3-4b through
              ``make_target`` on the card's real (1, 1) mesh (nccl, one
              rank): a factored mixed train step (2 x 1024), a prefill (8
              x 2048) and one decode step, each bit-identical to the same
              step unmeshed on the same parameters with equal launches
              (``mesh_truth``), and the dry run's predicted peak (a fake
              (1, 1) mesh) within MESH_PEAK_BAND of the card's
              ``max_memory_allocated``; the dry runs and the predictions
              run in spawned child processes beside the card's part

It then prints the kernels' JSON summary, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  It needs one
CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float16": 2e-2, "float32": 1e-4}
REPLACES = {
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:165",
    "paged_packed_attention": "src/repro/kernels/decode_attention.py:639",
    "paged_decode_attention_q8": "src/repro/kernels/decode_attention.py:256",
    "paged_packed_attention_q8": "src/repro/kernels/decode_attention.py:756",
    "quant_matmul": "src/repro/kernels/quant_matmul.py:89",
    "paged_mixed_attention": "src/repro/kernels/decode_attention.py:380",
    "paged_mixed_attention_q8": "src/repro/kernels/decode_attention.py:484",
    "flash_attention": "src/repro/kernels/flash_attention.py:96",
    "mlstm_chunked": "src/repro/kernels/mlstm_chunk.py:94",
    "fused_rmsnorm": "src/repro/kernels/rmsnorm.py:37",
    "decode_attention": "src/repro/kernels/decode_attention.py:821",
    # no TPU kernel: the reference's flash and mLSTM kernels have no
    # backward
    "flash_attention_bwd": None,
    "mlstm_chunked_bwd": None,
    # no TPU kernel: the reference's moe_apply_ragged computes its grouped
    # products with jax.lax.ragged_dot (src/repro/models/moe.py:102-110)
    "ragged_matmul": None,
    "ragged_matmul_bwd": None,
}
SOURCE = {name: "src/repro_torch/csrc/paged_attention.cu"
          for name in REPLACES}
SOURCE["quant_matmul"] = "src/repro_torch/csrc/quant_matmul.cu"
SOURCE["flash_attention"] = "src/repro_torch/csrc/flash_attention.cu"
SOURCE["mlstm_chunked"] = "src/repro_torch/csrc/mlstm_chunk.cu"
SOURCE["fused_rmsnorm"] = "src/repro_torch/csrc/rmsnorm.cu"
SOURCE["decode_attention"] = "src/repro_torch/csrc/dense_decode.cu"
SOURCE["flash_attention_bwd"] = "src/repro_torch/csrc/flash_attention_bwd.cu"
SOURCE["mlstm_chunked_bwd"] = "src/repro_torch/csrc/mlstm_chunk_bwd.cu"
SOURCE["ragged_matmul"] = SOURCE["ragged_matmul_bwd"] = \
    "src/repro_torch/csrc/ragged_matmul.cu"
# the device kernels each wrapper launches, by a part of their names
KERNEL_SYMBOLS = {
    "paged_decode_attention": ("paged_decode_",),
    "paged_packed_attention": ("paged_packed_",),
    "paged_decode_attention_q8": ("paged_decode_",),
    "paged_packed_attention_q8": ("paged_packed_",),
    "quant_matmul": ("quant_matmul_",),
    "paged_mixed_attention": ("paged_mixed_",),
    "paged_mixed_attention_q8": ("paged_mixed_",),
    "flash_attention": ("flash_",),
    "mlstm_chunked": ("mlstm_chunk_",),
    "fused_rmsnorm": ("rmsnorm_",),
    "decode_attention": ("dense_decode_",),
    "flash_attention_bwd": ("attn_bwd_",),
    "mlstm_chunked_bwd": ("mlstm_bwd_",),
    "ragged_matmul": ("ragged_mm_",),
    "ragged_matmul_bwd": ("ragged_mm_", "ragged_dw_"),
}
# the grouped product's halves of the backward, timed apart
RAGGED_BWD_PARTS = {"drows": ("ragged_mm_",), "dw": ("ragged_dw_",)}
# the tensor-core bodies that the timed cases must reach in the
# redesigned kernels (the packed pair's at bf16, the mLSTM forward's at
# every dtype)
REDESIGNED = {"mlstm_chunked": "mlstm_chunk_mma_kernel",
              "paged_packed_attention": "paged_packed_mma_kernel",
              "paged_packed_attention_q8": "paged_packed_mma_kernel"}
# ... and that every grouped product at the models' widths must reach: the
# wgmma + TMA bodies (forward, dRows and dW; bf16, fp16 and fp32)
REDESIGNED_16BIT = {"ragged_matmul": "_tma_kernel",
                    "ragged_matmul_bwd": "_tma_kernel"}
# ... and that fp32 must reach: every device kernel of a timed fp32 case
# holds one of these (the bodies' fp32 instances, operands as bf16 parts)
REDESIGNED_FP32 = {"flash_attention": ("flash_mma_kernel<float",),
                   "flash_attention_bwd": ("attn_bwd_dq_mma_kernel<float",
                                           "attn_bwd_dkdv_mma_kernel<float",
                                           "attn_bwd_dkdv_sum_kernel<float"),
                   "mlstm_chunked": ("mlstm_chunk_mma_kernel<float",),
                   "ragged_matmul": ("ragged_mm_f32_tma_kernel",),
                   "ragged_matmul_bwd": ("ragged_mm_f32_tma_kernel",
                                         "ragged_dw_f32_tma_kernel")}
# ... and the CUDA-core bodies that fp32 shapes the tensor-core bodies
# refuse still run (head dims off 8; K or N off 4): a case held on them
# runs every one of these and nothing else
CUDA_CORE_FP32 = {"mlstm_chunked": ("mlstm_chunk_kernel<float",),
                  "ragged_matmul": ("ragged_mm_kernel<float",),
                  "ragged_matmul_bwd": ("ragged_mm_kernel<float",
                                        "ragged_dw_kernel<float")}
# fp32 flash cases against the plain version evaluated in fp64: the
# kernel's error at most FP64_GATE_FACTOR times the plain fp32 version's,
# or FP64_GATE_FLOOR of the output's largest magnitude, the larger
FP64_GATE_FACTOR = 4.0
FP64_GATE_FLOOR = 1e-6
# the split bodies' own floor: each fp32 product as six bf16 products
SPLIT_PRODUCTS = 6
NOTES = {
    "mlstm_chunked": "library_ms null: no single PyTorch call computes the "
                     "chunkwise mLSTM",
    "fused_rmsnorm": "no model call site (as in the reference): launches 0 "
                     "in the serves",
    "flash_attention": "launches: the qwen3-4b pipelined dense serve at "
                       "12 of 36 layers (one per layer and prefill); its "
                       "timed case is the draft shape, the serving shapes "
                       "are in regimes",
    "decode_attention": "launches: the qwen3-4b pipelined dense serve at 12 "
                        "of 36 layers (one per layer and decode step)",
    "paged_mixed_attention": "launches: the qwen3-4b n-gram serve at 12 of "
                             "36 layers",
    "paged_mixed_attention_q8": "launches: the qwen3-4b int8 n-gram serve "
                                "at 12 of 36 layers",
    "flash_attention_bwd": "replaces null: the reference differentiates its "
                           "jnp path (its Pallas flash kernel has no "
                           "backward); launches: the full-width unimo-text "
                           "fp32 training run (one per layer and step); "
                           "library: SDPA's backward with the same boolean "
                           "mask; one call is two or three launches at "
                           "every dtype (dQ with D, dK/dV, and the head "
                           "splits' sum where the plan splits; fp32 the "
                           "split body's instances)",
    "mlstm_chunked_bwd": "replaces null: the reference differentiates its "
                         "jnp path (its Pallas mLSTM kernel has no "
                         "backward); library_ms null: no single PyTorch "
                         "call computes the chunkwise mLSTM's gradient; "
                         "launches: the full-width xlstm-125m fp32 "
                         "training run (one per mLSTM layer and step; the "
                         "mixed run beside it launches as many); one "
                         "call is up to four chunk-parallel launches (per "
                         "chunk dq and the increments, their reverse scan, "
                         "per chunk dk / dv, dlogf; device_ms_by_kernel); "
                         "timed case: the train shape 8 x 128 at bf16",
    "ragged_matmul": "replaces null: the reference's moe_apply_ragged "
                     "(REPRO_PERF_OPTS=moe_ragged) computes its grouped "
                     "products with jax.lax.ragged_dot, "
                     "src/repro/models/moe.py:102-110, outside Pallas; "
                     "launches: the full-width qwen3-moe bucketed serve "
                     "under moe_ragged (three a MoE layer and forward); "
                     "bodies: bf16 / fp16 at K, N multiples of 8 "
                     "ragged_mm_tma_kernel (wgmma fed by TMA), other "
                     "16-bit shapes ragged_mm_kernel (mma.sync), fp32 at "
                     "K, N multiples of 4 ragged_mm_f32_tma_kernel (wgmma "
                     "on three bf16 parts an operand), other fp32 shapes "
                     "ragged_mm_kernel (CUDA cores); "
                     "library: torch._grouped_mm where it runs at the "
                     "dtype, else null with the reason; timed case: a "
                     "decode step's 64 rows through wi, the other shapes "
                     "in regimes",
    "ragged_matmul_bwd": "replaces null: the gradient of jax.lax.ragged_dot "
                         "(the reference differentiates XLA's); "
                         "library_ms null: no single PyTorch call computes "
                         "both gradients (each half's torch._grouped_mm is "
                         "in its regime's drows / dw); launches: "
                         "train_parity of reduced qwen3-moe under "
                         "moe_ragged (one a grouped product a backward); "
                         "one call is two launches (dRows through "
                         "ragged_mm_tma_kernel reading w transposed, dW "
                         "through ragged_dw_tma_kernel; fp32: "
                         "ragged_mm_f32_tma_kernel, "
                         "ragged_dw_f32_tma_kernel)",
}
SPEC_K = 4
# quant_matmul sums the plain version's fp32 products in another order:
# its error is held to this fraction of the output's largest magnitude
QM_REL_TOL = 1e-5
# mlstm_chunked: h divides by a denominator that passes near zero for
# random inputs, so h is held to 1e-4 and the state (C, n, m) to 1e-5 of
# the largest magnitude of each (at least 1); the kernel's 32-step chunks
# and the plain version's 128 differ only in rounding.  RMSNorm in fp32:
# 1e-5 relative (rsqrtf, the sum's order).
MLSTM_REL_TOL = {"h": 1e-4, "C": 1e-5, "n": 1e-5, "m": 1e-5}
RMSNORM_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# profiles of one timed call before device_ms gives up: CUPTI now and then
# hands back a profile with no device event at all
PROFILE_ATTEMPTS = 6
# the serve CLI's vocabulary pruning of unimo-text (--prune-coverage)
PRUNE_COVERAGE = 0.999
# the contended serves' pool: the uncontended serve's peak pages over this
# (the reference's overload bench: a third of the demand), at least the
# longest request's, and a host tier that holds every snapshot
CONTENDED_POOL_DIV = 3
HOST_KV_BYTES = 1 << 36


T_START = time.perf_counter()
_LAST_LINE = [T_START]


def emit(phase, **kw):
    """One JSON line; ``elapsed_s`` counts from the script's start and
    ``seconds`` is the phase's own time: what it measured itself (a
    kernel case, the build), else the time since the previous line."""
    now = time.perf_counter()
    kw.setdefault("seconds", now - _LAST_LINE[0])
    _LAST_LINE[0] = now
    print(json.dumps({"phase": phase, **kw, "elapsed_s": now - T_START}),
          flush=True)


def timed_case(fn):
    """A kernel case runner whose result carries its own ``seconds``
    (the cases are printed together after the last one ran)."""
    @functools.wraps(fn)
    def run(*args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        res["seconds"] = time.perf_counter() - t0
        return res
    return run


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def time_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of ``fn`` over ``reps`` calls: the wrapper's
    host path plus its device work, on an idle card."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, symbols=None, reps=20):
    """Device time per call of ``fn``: the durations of the CUDA kernels it
    launches over ``reps`` calls under ``torch.profiler``, divided by
    ``reps``, the same per kernel name, and the number of profiles it
    took (a profile that catches no device event at all is taken again,
    up to PROFILE_ATTEMPTS times).  With ``symbols`` only
    kernels whose name holds one of them count (a wrapper's own kernel,
    not a fill it launches beside it), and finding none is an error;
    without, every kernel counts (a library call's device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    names = set()
    for attempt in range(PROFILE_ATTEMPTS):
        if attempt:             # the last profile caught no device event
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        names |= {e.name[:80] for e in dev}
        by_name = {}
        for e in dev:
            if symbols is None or any(s in e.name for s in symbols):
                by_name[e.name[:80]] = (by_name.get(e.name[:80], 0.0)
                                        + e.time_range.elapsed_us() / 1e3
                                        / reps)
        if by_name:
            return sum(by_name.values()), by_name, attempt + 1
    raise SystemExit(f"device_ms: no device kernel matching {symbols} in "
                     f"{PROFILE_ATTEMPTS} profiles (device events: "
                     f"{sorted(names)})")


def timings(kname, kernel, plain, library):
    """The timed figures of a kernel case: ``kernel_ms`` / ``plain_ms`` /
    ``library_ms`` (CUDA events around each call) and the device time per
    call of the kernel alone (``device_ms``; by device function,
    ``device_ms_by_kernel``) and of the library call
    (``library_device_ms``), with the names of the kernel's device
    functions that ran (``device_kernels``) and the profiles each device
    time took (``profile_attempts``: kernel, library); ``library`` None
    gives nulls."""
    ms, by_name, tries = device_ms(kernel, KERNEL_SYMBOLS[kname])
    lib_ms, _, lib_tries = (device_ms(library) if library
                            else (None, None, None))
    return {"kernel_ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "library_ms": time_ms(library) if library else None,
            "device_ms": ms, "device_kernels": sorted(by_name),
            "device_ms_by_kernel": by_name,
            "library_device_ms": lib_ms,
            "profile_attempts": [tries, lib_tries]}


# ---------------------------------------------------------------------------
# Kernel cases
# ---------------------------------------------------------------------------


def paged_case(rng, *, slots, ctx_lens, Hq, Hkv, D, page, npages, dtype,
               device, quant=False):
    """Pools holding ``ctx_lens`` tokens per slot on pages scattered over
    the pool (plus the dump page), and a block table per slot.  With
    ``quant`` the pools are int8 codes of random K/V with their fp32 scale
    pools (``kv_cache.quantize_kv``), else random K/V at ``dtype``."""
    import torch
    from repro_torch.core.kv_cache import quantize_kv
    P = slots * npages + 1
    k = torch.randn(P, page, Hkv, D, generator=rng, device=device)
    v = torch.randn(P, page, Hkv, D, generator=rng, device=device)
    ppos = np.full((P, page), -1, np.int32)
    bt = np.full((slots, npages), -1, np.int32)
    perm = np.random.default_rng(int(torch.randint(
        0, 2 ** 31, (1,), generator=rng, device=device))).permutation(P - 1)
    nxt = 0
    for b, n in enumerate(ctx_lens):
        used = -(-n // page)
        bt[b, :used] = perm[nxt:nxt + used]
        nxt += used
        for t in range(n):
            ppos[bt[b, t // page], t % page] = t
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = {"k_scale": ks, "v_scale": vs}
    else:
        k, v, scales = k.to(dtype), v.to(dtype), {}
    return (k, v, scales, torch.from_numpy(ppos).to(device),
            torch.from_numpy(bt).to(device), ppos, bt)


def visible(kp, qp, window):
    m = (kp >= 0) & (kp <= qp)
    if window is not None:
        m &= kp > qp - window
    return m


def _flash_fwd64(q, k, v, qp, kp, window, scale, softcap):
    """The plain forward (kernels/ref.py's formulas) evaluated in fp64:
    (out (B, Sq, Hq, Dv), lse (B, Hq, Sq), +inf where a row sees no key)."""
    import torch
    B, Sq, Hq, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    g = Hq // Hkv
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.double().reshape(B, Sq, Hkv, g, D), k.double()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    mask = visible(kp[:, None, :], qp[:, :, None], window)[:, None, None]
    s = s.masked_fill(~mask, -torch.inf)
    lse = torch.logsumexp(s, -1)
    seen = mask.any(-1)
    p = torch.where(mask, torch.exp(s - torch.where(seen, lse, 0.0)[
        ..., None]), 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.double())
    lse = torch.where(seen.expand_as(lse), lse, torch.inf)
    return out.reshape(B, Sq, Hq, Dv), lse.reshape(B, Hq, Sq)


def _flash_bwd64(q, k, v, qp, kp, o, lse, do, window, scale, softcap):
    """The plain backward (kernels/ref.py's flash_attention_bwd_ref)
    evaluated in fp64 from the same o and lse: (dq, dk, dv)."""
    import torch
    B, Sq, Hq, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    g = Hq // Hkv
    qg = q.double().reshape(B, Sq, Hkv, g, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double()) * scale
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = t * softcap
    mask = visible(kp[:, None, :], qp[:, :, None], window)[:, None, None]
    p = torch.where(mask, torch.exp(
        s - lse.double().reshape(B, Hkv, g, Sq, 1)), 0.0)
    dof = do.double().reshape(B, Sq, Hkv, g, Dv)
    delta = (dof * o.double().reshape(B, Sq, Hkv, g, Dv)).sum(-1)
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", dof, v.double())
              - delta.permute(0, 2, 3, 1)[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    return (torch.einsum("bhgqk,bkhd->bqhgd", ds, k.double()).reshape(
                B, Sq, Hq, D),
            torch.einsum("bhgqk,bqhgd->bkhd", ds, qg),
            torch.einsum("bhgqk,bqhgd->bkhd", p, dof))


def _fp64_errors(names, got, plain, truth):
    """Each output's error against the fp64 evaluation ``truth``, the
    plain fp32 version's beside it, both as fractions of the output's
    largest magnitude (finite entries), and whether the kernel's is at
    most FP64_GATE_FACTOR times the plain version's or FP64_GATE_FLOOR."""
    import torch
    out = {}
    for n, g, p, t in zip(names, got, plain, truth):
        fin = torch.isfinite(t)
        scale = max(t[fin].abs().max().item(), 1e-30)
        e = (g.double()[fin] - t[fin]).abs().max().item() / scale
        pe = (p.double()[fin] - t[fin]).abs().max().item() / scale
        out[n] = {"err": e, "plain_err": pe,
                  "ok": e <= max(FP64_GATE_FACTOR * pe, FP64_GATE_FLOOR)}
    return out


def _bound(nbytes, flops, dtype):
    """(ms, "bytes" or "operations"): the larger of bytes over the memory
    rate and operations over the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(*, ppos, bt, lane_slots, lane_pos, Hq, Hkv, D, entry_bytes,
          window, extra_bytes, dtype):
    """Least time the card needs for this call: the K/V entries some query
    can see (each read once per kv head, ``entry_bytes`` for its K and V
    of one head: codes plus scales for int8 pools), the positions of the
    pages the block tables reference, and q/out/tables once; the flops
    those visible keys need, at the peak rate of q's type."""
    needed, flops = set(), 0
    for s, qp in zip(lane_slots, lane_pos):
        if s < 0 or qp < 0:
            continue
        for pg in bt[s][bt[s] >= 0]:
            vis = np.nonzero(visible(ppos[pg], qp, window))[0]
            needed.update((int(pg), int(o)) for o in vis)
            flops += 2 * (2 * D) * Hq * len(vis)
    pages = {int(p) for row in bt for p in row if p >= 0}
    nbytes = (len(needed) * Hkv * entry_bytes
              + len(pages) * ppos.shape[1] * 4 + extra_bytes)
    return _bound(nbytes, flops, dtype)


def _attention_fns(quant, packed, mixed=False):
    """The wrapper and plain version of one of the six paged attention
    kernels as (name, kernel(q, k, v, scales, ppos, bt, q_pos, meta, **kw),
    plain(q, k, v, scales, ppos, bt, q_pos, slot_ids, **kw))."""
    from repro_torch.kernels import decode_attention as DA
    name = ("paged_packed_attention" if packed
            else "paged_mixed_attention" if mixed
            else "paged_decode_attention") + ("_q8" if quant else "")

    def kernel(q, k, v, sc, ppos, bt, q_pos, meta, **kw):
        extra = (meta,) if packed else ()
        if quant:
            return getattr(DA, name)(q, k, sc["k_scale"], v, sc["v_scale"],
                                     ppos, bt, q_pos, *extra, **kw)
        return getattr(DA, name)(q, k, v, ppos, bt, q_pos, *extra, **kw)

    def plain(q, k, v, sc, ppos, bt, q_pos, sid, **kw):
        if packed:
            return DA.paged_packed_attention_ref(q, k, v, ppos, bt, q_pos,
                                                 sid, **sc, **kw)
        ref = (DA.paged_mixed_attention_ref if mixed
               else DA.paged_decode_attention_ref)
        return ref(q, k, v, ppos, bt, q_pos, **sc, **kw)
    return name, kernel, plain


def _gathered(k, v, sc, ppos, bt, dtype, g):
    """Each slot's K/V gathered densely (and dequantized) beforehand, at
    ``dtype``, each kv head repeated for its g query heads: the input of
    the SDPA yardstick, which thus reads pre-dequantized data."""
    from repro_torch.core.kv_cache import paged_gather
    pool = {"pk": k, "pv": v, "ppos": ppos}
    if sc:
        pool["pk_scale"], pool["pv_scale"] = sc["k_scale"], sc["v_scale"]
    kk, vv, kp = paged_gather(pool, bt)
    return (kk.to(dtype).repeat_interleave(g, 2),
            vv.to(dtype).repeat_interleave(g, 2), kp)


def _entry_bytes(k, D, quant):
    """Bytes of one entry's K and V for one kv head."""
    return 2 * D * k.element_size() + (2 * 4 if quant else 0)


@timed_case
def run_decode_case(rng, name, *, Hq, Hkv, D, dtype, window=None,
                    softcap=None, timed=False, quant=False, npages=16):
    """8 slots of 1 .. ``npages`` x 16 tokens on 16-token pages."""
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda")
    slots, page = 8, 16
    ctx = [int(x) for x in torch.randint(1, npages * page + 1, (slots,),
                                         generator=rng, device=dev)]
    k, v, sc, ppos, bt, ppos_np, bt_np = paged_case(
        rng, slots=slots, ctx_lens=ctx, Hq=Hq, Hkv=Hkv, D=D, page=page,
        npages=npages, dtype=dtype, device=dev, quant=quant)
    q = torch.randn(slots, 1, Hq, D, generator=rng, device=dev).to(dtype)
    q_pos = torch.tensor([[n - 1] for n in ctx], dtype=torch.int32,
                         device=dev)
    kname, kernel, plain = _attention_fns(quant, packed=False)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    out = kernel(q, k, v, sc, ppos, bt, q_pos, None, **kw)
    ref = plain(q, k, v, sc, ppos, bt, q_pos, None, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[str(dtype).removeprefix("torch.")]
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
    res = {"case": name, "kernel": kname, "max_abs_err": err, "tol": tol,
           "ok": bool(ok)}
    if timed:
        kk, vv, kp = _gathered(k, v, sc, ppos, bt, dtype, Hq // Hkv)
        mask = visible(kp[:, None, None, :], q_pos[:, :, None, None], window)
        qs, ks, vs = (q.transpose(1, 2), kk.transpose(1, 2),
                      vv.transpose(1, 2))
        res.update(timings(
            kname, lambda: kernel(q, k, v, sc, ppos, bt, q_pos, None, **kw),
            lambda: plain(q, k, v, sc, ppos, bt, q_pos, None, **kw),
            lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, scale=D ** -0.5)))
        res["bound_ms"], res["bound_by"] = bound(
            ppos=ppos_np, bt=bt_np, lane_slots=range(slots),
            lane_pos=[n - 1 for n in ctx], Hq=Hq, Hkv=Hkv, D=D,
            entry_bytes=_entry_bytes(k, D, quant), window=window,
            dtype=str(dtype).removeprefix("torch."),
            extra_bytes=2 * q.numel() * q.element_size() + bt_np.nbytes
            + 4 * slots)
    return res


@timed_case
def run_packed_case(rng, name, *, Hq, Hkv, D, dtype, window=None,
                    softcap=None, timed=False, quant=False):
    """A full 256-lane stream: decode lanes for four slots and prefill
    chunks for the other four (one continuing, three fresh), as a
    256-token budget iteration with 8 slots schedules them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.engine import packed_width_buckets
    from repro_torch.kernels import decode_attention as DA
    dev = torch.device("cuda")
    slots, page, npages = 8, 16, 16
    T = packed_width_buckets(256)[-1]
    before = [100, 37, 201, 9, 60, 0, 0, 0]          # context in the pool
    seg = [1, 1, 1, 1, 90, 70, 50, 30]               # decode x4, chunks x4
    k, v, sc, ppos, bt, ppos_np, bt_np = paged_case(
        rng, slots=slots, ctx_lens=[b + s for b, s in zip(before, seg)],
        Hq=Hq, Hkv=Hkv, D=D, page=page, npages=npages, dtype=dtype,
        device=dev, quant=quant)
    slot_ids = np.full(T, -1, np.int32)
    pos = np.full(T, -1, np.int32)
    starts, t = [], 0
    for s, (b0, ln) in enumerate(zip(before, seg)):
        starts.append(t)
        slot_ids[t:t + ln] = s
        pos[t:t + ln] = b0 + np.arange(ln)
        t += ln
    meta = DA.packed_meta_table(starts, seg, range(slots), T,
                                T // DA.PACKED_BLOCK_Q + slots)
    q = torch.randn(1, T, Hq, D, generator=rng, device=dev).to(dtype)
    q_pos = torch.from_numpy(pos[None]).to(dev)
    sid = torch.from_numpy(slot_ids).to(dev)
    meta_t = torch.from_numpy(meta).to(dev)
    kname, kernel, plain = _attention_fns(quant, packed=True)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    out = kernel(q, k, v, sc, ppos, bt, q_pos, meta_t, **kw)
    ref = plain(q, k, v, sc, ppos, bt, q_pos, sid, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[str(dtype).removeprefix("torch.")]
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol) \
        and not out[0, t:].any().item()
    res = {"case": name, "kernel": kname, "max_abs_err": err, "tol": tol,
           "ok": bool(ok), "T": T}
    if timed:
        kk, vv, kp = _gathered(k, v, sc, ppos, bt, dtype, Hq // Hkv)
        safe = sid.long().clamp(0, slots - 1)
        ks, vs = kk[safe].transpose(1, 2), vv[safe].transpose(1, 2)
        kpt = torch.where((sid >= 0)[:, None], kp[safe], -1)
        mask = visible(kpt[:, None, None, :], q_pos[0][:, None, None, None],
                       window)
        qs = q[0][:, None].transpose(1, 2)           # (T, Hq, 1, D)
        res.update(timings(
            kname, lambda: kernel(q, k, v, sc, ppos, bt, q_pos, meta_t, **kw),
            lambda: plain(q, k, v, sc, ppos, bt, q_pos, sid, **kw),
            lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, scale=D ** -0.5)))
        res["bound_ms"], res["bound_by"] = bound(
            ppos=ppos_np, bt=bt_np, lane_slots=slot_ids, lane_pos=pos,
            Hq=Hq, Hkv=Hkv, D=D, entry_bytes=_entry_bytes(k, D, quant),
            window=window, dtype=str(dtype).removeprefix("torch."),
            extra_bytes=(2 * q.numel() * q.element_size() + bt_np.nbytes
                         + 4 * T + meta.nbytes))
    return res


@timed_case
def run_mixed_case(rng, name, *, Hq, Hkv, D, dtype, W, n_q, before,
                   window=None, softcap=None, timed=False, quant=False):
    """Row b of (len(n_q), W) lanes holds ``n_q[b]`` real queries at
    positions before[b] .. (the window's own K/V already in the pool, as
    the verify and chunk forwards write them); the rest are padding lanes,
    which must come back as zeros."""
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda")
    page = 16
    npages = -(-(max(before) + W) // page)
    B = len(n_q)
    k, v, sc, ppos, bt, ppos_np, bt_np = paged_case(
        rng, slots=B, ctx_lens=[b + n for b, n in zip(before, n_q)], Hq=Hq,
        Hkv=Hkv, D=D, page=page, npages=npages, dtype=dtype, device=dev,
        quant=quant)
    pos = np.full((B, W), -1, np.int32)
    for r, (b0, n) in enumerate(zip(before, n_q)):
        pos[r, :n] = b0 + np.arange(n)
    q = torch.randn(B, W, Hq, D, generator=rng, device=dev).to(dtype)
    q_pos = torch.from_numpy(pos).to(dev)
    kname, kernel, plain = _attention_fns(quant, packed=False, mixed=True)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    out = kernel(q, k, v, sc, ppos, bt, q_pos, None, **kw)
    ref = plain(q, k, v, sc, ppos, bt, q_pos, None, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[str(dtype).removeprefix("torch.")]
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol) \
        and not any(out[r, n:].any().item() for r, n in enumerate(n_q))
    res = {"case": name, "kernel": kname, "max_abs_err": err, "tol": tol,
           "ok": bool(ok), "B": B, "W": W}
    if timed:
        kk, vv, kp = _gathered(k, v, sc, ppos, bt, dtype, Hq // Hkv)
        mask = visible(kp[:, None, None, :], q_pos[:, None, :, None],
                       window)
        qs, ks, vs = (q.transpose(1, 2), kk.transpose(1, 2),
                      vv.transpose(1, 2))
        res.update(timings(
            kname, lambda: kernel(q, k, v, sc, ppos, bt, q_pos, None, **kw),
            lambda: plain(q, k, v, sc, ppos, bt, q_pos, None, **kw),
            lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, scale=D ** -0.5)))
        res["bound_ms"], res["bound_by"] = bound(
            ppos=ppos_np, bt=bt_np, lane_slots=np.repeat(np.arange(B), W),
            lane_pos=pos.reshape(-1), Hq=Hq, Hkv=Hkv, D=D,
            entry_bytes=_entry_bytes(k, D, quant), window=window,
            dtype=str(dtype).removeprefix("torch."),
            extra_bytes=2 * q.numel() * q.element_size() + bt_np.nbytes
            + pos.nbytes)
    return res


@timed_case
def run_flash_case(rng, name, *, B, S, Hq, Hkv, D, dtype, ragged=False,
                   window=None, softcap=None, timed=False, Dv=None,
                   lse=False):
    """Flash attention over (B, S) tokens at positions 0 .. S-1, as the
    draft model's forwards run it; ``ragged`` right-pads the rows with -1
    positions and leaves the last row wholly invalid; ``Dv``: a value
    head dim other than D (MLA's naive form).  ``lse``: the training
    forward, which also returns each row's log-sum-exp (timed that way,
    against the plain version's and SDPA's forward).  fp32: the output's
    (and lse's) error against the plain version evaluated in fp64, beside
    the plain fp32 version's own (``fp64``; gated)."""
    Dv = Dv or D
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    dev = torch.device("cuda")
    q = torch.randn(B, S, Hq, D, generator=rng, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=rng, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, Dv, generator=rng, device=dev).to(dtype)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    if ragged:
        for b in range(B):
            pos[b, S - 3 * b - 1 if b < B - 1 else 0:] = -1
    p = torch.from_numpy(pos).to(dev)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    out, got_lse = FA.flash_attention(q, k, v, p, p, return_lse=True, **kw)
    ref, ref_lse = FA.flash_attention_lse_ref(q, k, v, p, p, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    dn = str(dtype).removeprefix("torch.")
    tol = TOL[dn]
    fin = torch.isfinite(ref_lse)
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol) \
        and not out[p < 0].any().item() \
        and torch.equal(torch.isfinite(got_lse), fin) \
        and torch.allclose(got_lse[fin], ref_lse[fin], atol=tol, rtol=tol)
    res = {"case": name, "kernel": "flash_attention", "max_abs_err": err,
           "tol": tol, "ok": bool(ok), "B": B, "S": S, "D": D, "Dv": Dv,
           "Hq": Hq, "Hkv": Hkv, "dtype": dn}
    if dtype == torch.float32:
        res["fp64"] = _fp64_errors(
            ("out", "lse"), (out, got_lse), (ref, ref_lse),
            _flash_fwd64(q, k, v, p, p, window, D ** -0.5, softcap))
        res["ok"] &= all(e["ok"] for e in res["fp64"].values())
    if timed:
        g = Hq // Hkv
        mask = visible(p[:, None, None, :], p[:, None, :, None], window)
        qs = q.transpose(1, 2)
        ks = k.repeat_interleave(g, 2).transpose(1, 2)
        vs = v.repeat_interleave(g, 2).transpose(1, 2)
        # SDPA at fp32 with TF32 off (PyTorch's default for matmul, set
        # here for cuDNN too)
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            res.update(timings(
                "flash_attention",
                lambda: FA.flash_attention(q, k, v, p, p, return_lse=lse,
                                           **kw),
                (lambda: FA.flash_attention_lse_ref(q, k, v, p, p, **kw))
                if lse else (lambda: FA.flash_attention_ref(q, k, v, p, p,
                                                            **kw)),
                lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, scale=D ** -0.5)))
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        res["lse"] = lse
        # the visible (query, key) pairs of this run's positions, 2 D + 2
        # Dv flops each per query head (QK^T and PV); bytes: q, k, v, out
        # (and lse) and positions once
        pairs = int(visible(pos[:, None, :], pos[:, :, None], window).sum())
        flops = 2 * (D + Dv) * Hq * pairs
        nbytes = (q.numel() * (D + Dv) // D + k.numel() + v.numel()) \
            * q.element_size() + 2 * pos.nbytes \
            + (got_lse.numel() * 4 if lse else 0)
        res["bound_ms"], res["bound_by"] = _bound(nbytes, flops, dtype)
        if dtype == torch.float32:
            res["split_floor_ms"] = (SPLIT_PRODUCTS * flops
                                     / PEAK_FLOPS["bfloat16"] * 1e3)
    return res


@timed_case
def run_flash_prefix_case(rng, name, *, B, Sq, npages, page, prefix, lens,
                          Hq, Hkv, D, dtype, timed=False):
    """Flash attention at the prefix-attend admission's shape: each row's
    ``Sq``-lane suffix bucket (positions ``prefix + 0 .. Sq-1``) against
    the slot's gathered pages, ``npages * page`` keys holding the shared
    prefix and the suffix's ``lens[b]`` tokens at their positions and -1
    holes (unwritten entries) after them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    dev = torch.device("cuda")
    Sk = npages * page
    q = torch.randn(B, Sq, Hq, D, generator=rng, device=dev).to(dtype)
    k = torch.randn(B, Sk, Hkv, D, generator=rng, device=dev).to(dtype)
    v = torch.randn(B, Sk, Hkv, D, generator=rng, device=dev).to(dtype)
    kp = np.full((B, Sk), -1, np.int32)
    for b, n in enumerate(lens):
        kp[b, :prefix + n] = np.arange(prefix + n)
    qp = np.tile(prefix + np.arange(Sq, dtype=np.int32), (B, 1))
    q_pos, k_pos = (torch.from_numpy(a).to(dev) for a in (qp, kp))
    kw = dict(window=None, scale=D ** -0.5, attn_softcap=None)
    out = FA.flash_attention(q, k, v, q_pos, k_pos, **kw)
    ref = FA.flash_attention_ref(q, k, v, q_pos, k_pos, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[str(dtype).removeprefix("torch.")]
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
    res = {"case": name, "kernel": "flash_attention", "max_abs_err": err,
           "tol": tol, "ok": bool(ok), "B": B, "S": Sq, "Sk": Sk,
           "dtype": str(dtype).removeprefix("torch.")}
    if dtype == torch.float32:
        res["fp64"] = _fp64_errors(
            ("out",), (out,), (ref,),
            _flash_fwd64(q, k, v, q_pos, k_pos, None, D ** -0.5, None)[:1])
        res["ok"] &= all(e["ok"] for e in res["fp64"].values())
    if timed:
        g = Hq // Hkv
        mask = visible(k_pos[:, None, None, :], q_pos[:, None, :, None],
                       None)
        qs = q.transpose(1, 2)
        ks = k.repeat_interleave(g, 2).transpose(1, 2)
        vs = v.repeat_interleave(g, 2).transpose(1, 2)
        res.update(timings(
            "flash_attention",
            lambda: FA.flash_attention(q, k, v, q_pos, k_pos, **kw),
            lambda: FA.flash_attention_ref(q, k, v, q_pos, k_pos, **kw),
            lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, scale=D ** -0.5)))
        seen = visible(kp[:, None, :], qp[:, :, None], None)
        pairs = int(seen.sum())
        # K/V only of the keys some query sees: the -1 holes are not read
        n_vis = int(seen.any(axis=1).sum())
        nbytes = (n_vis * Hkv * 2 * D * k.element_size() + kp.nbytes
                  + qp.nbytes + 2 * q.numel() * q.element_size())
        res["bound_ms"], res["bound_by"] = _bound(nbytes,
                                                  4 * D * Hq * pairs, dtype)
    return res


@timed_case
def run_quant_matmul_case(rng, name, *, M, K, N, dtype, timed=False):
    """``quant_matmul`` on random int8 codes and scales against its plain
    version; timed cases add ``torch.matmul`` against a bf16 weight that
    was dequantized beforehand (a yardstick that reads pre-dequantized,
    twice as many weight bytes)."""
    import torch
    from repro_torch.core.precision import dequantize_weights
    from repro_torch.kernels import quant_matmul as QM
    dev = torch.device("cuda")
    x = torch.randn(M, K, generator=rng, device=dev).to(dtype)
    q = torch.randint(-127, 128, (K, N), generator=rng, device=dev,
                      dtype=torch.int8)
    s = torch.rand(N, generator=rng, device=dev) * 0.02
    out = QM.quant_matmul(x, q, s)
    ref = QM.quant_matmul_ref(x, q, s)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    res = {"case": name, "kernel": "quant_matmul", "M": M, "K": K, "N": N,
           "max_abs_err": err, "ref_max_abs": scale,
           "tol": QM_REL_TOL * scale, "ok": bool(err <= QM_REL_TOL * scale)}
    if timed:
        w = dequantize_weights({"q": q, "s": s}, torch.bfloat16)
        xb = x.to(torch.bfloat16)
        res.update(timings("quant_matmul", lambda: QM.quant_matmul(x, q, s),
                           lambda: QM.quant_matmul_ref(x, q, s),
                           lambda: torch.matmul(xb, w)))
        nbytes = K * N + 4 * N + x.numel() * x.element_size() + 4 * M * N
        res["bound_ms"], res["bound_by"] = _bound(nbytes, 2 * M * K * N,
                                                  dtype)
    return res


@timed_case
def run_mlstm_case(rng, name, *, B, S, H, dh, dtype, state=False,
                   timed=False):
    """``mlstm_chunked`` on random q, k (scaled by dh^-1/2 as the model
    does), v, gates and (with ``state``) a nonzero initial state, against
    its plain version: h, C, n and m (fp32 also against the plain version
    in fp64); two calls bit-identical."""
    import torch
    from repro_torch.kernels import mlstm_chunk as MC
    dev = torch.device("cuda")

    def r(*shape):
        return torch.randn(*shape, generator=rng, device=dev)
    q, k, v = (r(B, S, H, dh).to(dtype) for _ in range(3))
    k = (k.float() * dh ** -0.5).to(dtype)
    i_pre = r(B, S, H)
    logf = torch.nn.functional.logsigmoid(r(B, S, H) + 2)
    st = {"C": r(B, H, dh, dh) * 0.1 if state else
          torch.zeros(B, H, dh, dh, device=dev),
          "n": r(B, H, dh).abs() if state else torch.zeros(B, H, dh,
                                                           device=dev),
          "m": r(B, H) if state else torch.zeros(B, H, device=dev)}
    args = (q, k, v, i_pre, logf, st)
    h, out = MC.mlstm_chunked(*args)
    h2, out2 = MC.mlstm_chunked(*args)
    h_r, ref = MC.mlstm_chunked_ref(*args)
    torch.cuda.synchronize()
    twice = torch.equal(h, h2) and all(torch.equal(out[n], out2[n])
                                       for n in out)
    del h2, out2
    errs, gate_frac = {}, {}
    for key, a, b in [("h", h, h_r)] + [(n, out[n], ref[n])
                                         for n in ("C", "n", "m")]:
        errs[key] = (a - b).abs().max().item()
        gate_frac[key] = errs[key] / (MLSTM_REL_TOL[key]
                                      * max(b.abs().max().item(), 1.0))
    dn = str(dtype).removeprefix("torch.")
    res = {"case": name, "kernel": "mlstm_chunked", "B": B, "S": S, "H": H,
           "dh": dh, "dtype": dn, "max_abs_err": max(errs.values()),
           "errs": errs, "tol": MLSTM_REL_TOL, "gate_frac": gate_frac,
           "body": _mlstm_body(MC, B, H, dh, dtype),
           "bit_identical_twice": twice,
           "ok": twice and all(f <= 1.0 for f in gate_frac.values())}
    if dtype == torch.float32 and _SRC[0] == str((ROOT / "src").resolve()):
        # against the plain version in fp64, gated as fp32 flash is (this
        # checkout's plain version computes in fp64 on fp64 inputs; another
        # checkout's, an A/B's parent, need not: no fp64 figure there)
        h64, ref64 = MC.mlstm_chunked_ref(
            *(t.double() for t in args[:5]),
            {key: t.double() for key, t in st.items()})
        names = ("h", "C", "n", "m")
        res["fp64"] = _fp64_errors(
            names, [h] + [out[n] for n in names[1:]],
            [h_r] + [ref[n] for n in names[1:]],
            [h64] + [ref64[n] for n in names[1:]])
        res["ok"] &= all(f["ok"] for f in res["fp64"].values())
        del h64, ref64
    if timed:
        res.update(timings("mlstm_chunked", lambda: MC.mlstm_chunked(*args),
                           lambda: MC.mlstm_chunked_ref(*args), None))
        # the chunkwise algorithm at the kernel's 32-step chunks: per step
        # q C and the k v^T update (dh^2 each), q n and the n update (dh
        # each), and the causal intra-chunk scores and s v ((L + 1) dh on
        # average); bytes: q, k, v and the gates read once, h written
        # once, the state read and written once
        L = 32
        flops = 2 * B * H * S * dh * (2 * dh + 2 + (L + 1))
        nbytes = (3 * q.numel() * q.element_size() + 2 * 4 * i_pre.numel()
                  + 4 * h.numel()
                  + 2 * 4 * sum(t.numel() for t in st.values()))
        res["bound_ms"], res["bound_by"] = _bound(nbytes, flops, dtype)
        if dtype != torch.bfloat16:
            # the split body's own floor: each product as bf16 part pairs
            # (six at fp32, three at fp16) at the bf16 peak
            pairs = SPLIT_PRODUCTS if dtype == torch.float32 else 3
            res["split_floor_ms"] = (pairs * flops
                                     / PEAK_FLOPS["bfloat16"] * 1e3)
    return res


def _mlstm_body(MC, B, H, dh, dtype):
    """The body the wrapper plans for these heads on this card (a
    checkout before the fp32 / fp16 tensor-core bodies planned them the
    same way: its plan is asked the same question)."""
    import torch
    props = torch.cuda.get_device_properties(0)
    return MC.mlstm_plan(B, H, dh, dtype, True, props.multi_processor_count,
                         props.shared_memory_per_block_optin).body


def mlstm_kernel_cases(rng):
    """``mlstm_chunked`` at xlstm-125m's width (4 heads x 384) over 8 rows:
    a ragged 300-step prompt from a nonzero state and a 64-step one, q/k/v
    at bf16 and fp32 (the trainer's default policy; fp32 also against the
    plain version in fp64), all timed; the 300-step prompt at fp16, timed;
    the reduced config's head dim 128 at each; last, the CUDA-core body
    that fp32 shapes the tensor cores refuse still run (head dim 380, off
    8), timed, on inputs of its own generator (the cases drawn after these
    keep their inputs)."""
    import torch
    cases = []
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        dn = str(dtype).removeprefix("torch.")
        cases.append(run_mlstm_case(
            rng, f"xlstm-125m S=300 nonzero state {dn}", B=8, S=300, H=4,
            dh=384, dtype=dtype, state=True, timed=True))
        if dtype != torch.float16:
            cases.append(run_mlstm_case(
                rng, f"xlstm-125m S=64 {dn}", B=8, S=64, H=4, dh=384,
                dtype=dtype, timed=True))
        cases.append(run_mlstm_case(rng, f"reduced dh=128 S=37 {dn}", B=3,
                                    S=37, H=2, dh=128, dtype=dtype,
                                    state=True))
    own = torch.Generator(device="cuda").manual_seed(380)
    cases.append(held_on_cuda_cores(run_mlstm_case(
        own, "head dim off 8: 8 x 300 dh=380 nonzero state float32", B=8,
        S=300, H=4, dh=380, dtype=torch.float32, state=True, timed=True)))
    return cases


def held_on_cuda_cores(case):
    """Marks a case whose point is a CUDA-core body (a shape the tensor-core
    bodies refuse): :func:`_check_bodies` requires that body of it."""
    case["held_body"] = "cuda_cores"
    return case


@timed_case
def run_rmsnorm_case(rng, name, *, rows, D, dtype, wdtype, timed=False):
    """``fused_rmsnorm`` against its plain version; the yardstick is
    ``torch.nn.functional.rms_norm`` with weight ``1 + w``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as RN
    dev = torch.device("cuda")
    x = torch.randn(rows, D, generator=rng, device=dev).to(dtype)
    w = (torch.randn(D, generator=rng, device=dev) * 0.1).to(wdtype)
    out = RN.fused_rmsnorm(x, w)
    ref = RN.rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = RMSNORM_TOL[str(dtype).removeprefix("torch.")]
    ok = out.dtype == dtype and torch.allclose(out.float(), ref.float(),
                                               atol=tol, rtol=tol)
    res = {"case": name, "kernel": "fused_rmsnorm", "rows": rows, "D": D,
           "max_abs_err": err, "tol": tol, "ok": bool(ok)}
    if timed:
        w1 = (1.0 + w.float()).to(dtype)
        res.update(timings("fused_rmsnorm", lambda: RN.fused_rmsnorm(x, w),
                           lambda: RN.rmsnorm_ref(x, w),
                           lambda: F.rms_norm(x, (D,), w1, 1e-6)))
        res["bound_ms"], res["bound_by"] = _bound(
            2 * x.numel() * x.element_size() + w.numel() * w.element_size(),
            4 * x.numel(), dtype)
    return res


@timed_case
def run_dense_decode_case(rng, name, *, B, Sk, Hq, Hkv, D, dtype,
                          window=None, softcap=None, valid=None,
                          timed=False):
    """The dense ``decode_attention`` on contiguous caches: row 0 sees a
    ragged valid prefix, the others the whole cache, the last row has
    q_pos = -1 (it must come back 0).  With ``valid`` every row holds
    ``valid`` entries and -1 after them, as the dense KV cache of
    ``generate_batch`` does (its rows rounded up past the context), and
    queries sit at position ``valid - 1``.  Yardstick: SDPA with the mask,
    on K/V repeated per query head beforehand."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    dev = torch.device("cuda")
    q = torch.randn(B, 1, Hq, D, generator=rng, device=dev).to(dtype)
    k = torch.randn(B, Sk, Hkv, D, generator=rng, device=dev).to(dtype)
    v = torch.randn(B, Sk, Hkv, D, generator=rng, device=dev).to(dtype)
    kp = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    qp = np.full((B, 1), Sk - 1, np.int32)
    if valid is None:
        kp[0, Sk // 2 + 1:] = -1
        qp[0] = Sk // 2
    else:
        kp[:, valid:] = -1
        qp[:] = valid - 1
    qp[-1] = -1
    k_pos, q_pos = (torch.from_numpy(a).to(dev) for a in (kp, qp))
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    out = DA.decode_attention(q, k, v, k_pos, q_pos, **kw)
    ref = DA.decode_attention_ref(q, k, v, k_pos, q_pos, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[str(dtype).removeprefix("torch.")]
    # over many keys the outputs shrink (about sqrt(e / Sk) at random
    # inputs, 0.026 at 4096), so TOL alone could pass a kernel that skipped
    # tiles: the error is held to TOL of the output's scale as well
    ref_max = ref.float().abs().max().item()
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol) \
        and err <= tol * ref_max and not out[-1].any().item()
    res = {"case": name, "kernel": "decode_attention", "B": B, "Sk": Sk,
           "max_abs_err": err, "tol": tol, "ref_max_abs": ref_max,
           "scaled_tol": tol * ref_max, "ok": bool(ok)}
    if timed:
        g = Hq // Hkv
        mask = visible(k_pos[:, None, None, :], q_pos[:, :, None, None],
                       window)
        qs = q.transpose(1, 2)
        ks = k.repeat_interleave(g, 2).transpose(1, 2)
        vs = v.repeat_interleave(g, 2).transpose(1, 2)
        res.update(timings(
            "decode_attention",
            lambda: DA.decode_attention(q, k, v, k_pos, q_pos, **kw),
            lambda: DA.decode_attention_ref(q, k, v, k_pos, q_pos, **kw),
            lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, scale=D ** -0.5)))
        # the keys some query can see (K and V of each kv head once), the
        # positions, q and out once; 4 D flops per visible key and head
        n_vis = int(visible(kp, qp, window).sum())
        nbytes = (n_vis * Hkv * 2 * D * k.element_size() + kp.nbytes
                  + qp.nbytes + 2 * q.numel() * q.element_size())
        res["bound_ms"], res["bound_by"] = _bound(nbytes,
                                                  4 * D * Hq * n_vis, dtype)
    return res


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_kernels(check_bodies=True):
    """Every kernel against its plain version.  Returns, per kernel, its
    timed case at qwen3-4b's shapes (the ``kernels`` summary); the
    unimo-text timing of kernels 1-2 stays in its own line.  With
    ``check_bodies`` the timed cases of the redesigned kernels must have
    run their tensor-core bodies (off for another checkout's port, which
    may predate them)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = torch.Generator(device="cuda")
    rng.manual_seed(1234)
    bf16, fp32 = torch.bfloat16, torch.float32
    unimo = dict(Hq=16, Hkv=16, D=64)
    qwen3 = dict(Hq=32, Hkv=8, D=128)
    wsc = dict(window=64, softcap=30.0)
    cases = []
    for run in (run_decode_case, run_packed_case):
        cases.append(run(rng, "unimo-text bf16", dtype=bf16, timed=True,
                         **unimo))
        cases.append(run(rng, "qwen3-4b bf16", dtype=bf16, timed=True,
                         **qwen3))
        cases.append(run(rng, "window 64 + softcap 30 bf16", dtype=bf16,
                         **wsc, **unimo))
        cases.append(run(rng, "unimo-text fp32", dtype=fp32, **unimo))
        cases.append(run(rng, "qwen3-4b window 64 + softcap 30 fp32",
                         dtype=fp32, **wsc, **qwen3))
        # the _q8 kernels: int8 pools, q at bf16 and fp32
        cases.append(run(rng, "qwen3-4b int8 pool, bf16 q", dtype=bf16,
                         quant=True, timed=True, **qwen3))
        cases.append(run(rng, "qwen3-4b int8 pool, fp32 q", dtype=fp32,
                         quant=True, **qwen3))
        cases.append(run(rng, "qwen3-4b int8 pool window 64 + softcap 30, "
                         "bf16 q", dtype=bf16, quant=True, **wsc, **qwen3))
        cases.append(run(rng, "unimo-text int8 pool window 64 + softcap "
                         "30, fp32 q", dtype=fp32, quant=True, **wsc,
                         **unimo))
        # fp16 q over fp16 and int8 pools
        cases.append(run(rng, "qwen3-4b fp16", dtype=torch.float16,
                         **qwen3))
        cases.append(run(rng, "qwen3-4b int8 pool, fp16 q",
                         dtype=torch.float16, quant=True, **qwen3))
    # quant_matmul: every qwen3-4b decode shape (q / k+v / o / ffn in /
    # ffn out / tied head: the bytes-bound tensor-core body), a 256-row
    # packed stream and a 40-row verify stream (8 slots x k + 1: the tiled
    # body), the tied head at fp16; ragged shapes on every body
    shapes = [(8, 2560, 4096), (8, 2560, 1024), (8, 4096, 2560),
              (8, 2560, 9728), (8, 9728, 2560), (8, 2560, 151936),
              (256, 2560, 9728), (40, 2560, 9728)]
    for M, K, N in shapes:
        cases.append(run_quant_matmul_case(
            rng, f"qwen3-4b {K}->{N} M={M} bf16", M=M, K=K, N=N, dtype=bf16,
            timed=True))
    cases.append(run_quant_matmul_case(
        rng, "qwen3-4b 2560->151936 M=8 fp16", M=8, K=2560, N=151936,
        dtype=torch.float16, timed=True))
    for dtype in (bf16, torch.float16, fp32):
        name = str(dtype).removeprefix("torch.")
        for M in (3, 40):
            cases.append(run_quant_matmul_case(
                rng, f"ragged 100->130 M={M} {name}", M=M, K=100, N=130,
                dtype=dtype))
        cases.append(run_quant_matmul_case(
            rng, f"qwen3-4b 2560->4096 M=8 {name}", M=8, K=2560, N=4096,
            dtype=dtype))
    # the mixed kernels: qwen3-4b's verify windows (8 slots, k + 1 lanes,
    # contexts up to 256) and a prefill chunk in a (1, 256) row
    ctx = [int(x) for x in torch.randint(0, 256 - SPEC_K, (8,),
                                         generator=rng, device="cuda")]
    verify = dict(W=SPEC_K + 1, n_q=[SPEC_K + 1] * 8, before=ctx)
    chunk = dict(W=256, n_q=[230], before=[20])
    for quant in (False, True):
        q8 = " int8 pool," if quant else ""
        cases.append(run_mixed_case(
            rng, f"qwen3-4b verify{q8} bf16 q", dtype=bf16, quant=quant,
            timed=True, **verify, **qwen3))
        cases.append(run_mixed_case(
            rng, f"qwen3-4b chunk (1, 256){q8} bf16 q", dtype=bf16,
            quant=quant, timed=True, **chunk, **qwen3))
        cases.append(run_mixed_case(
            rng, f"qwen3-4b verify{q8} fp32 q", dtype=fp32, quant=quant,
            **verify, **qwen3))
        cases.append(run_mixed_case(
            rng, f"unimo-text verify{q8} window 64 + softcap 30 bf16 q",
            dtype=bf16, quant=quant, **wsc, **verify, **unimo))
        cases.append(run_mixed_case(
            rng, f"qwen3-4b ragged rows{q8} fp32 q", dtype=fp32,
            quant=quant, W=24, n_q=[24, 0, 17, 1], before=[3, 0, 100, 40],
            **qwen3))
    # flash: unimo-text's draft forwards (8 rows of 256 + k tokens), GQA
    # at qwen3-4b's heads, and -1 positions + window + softcap
    cases.append(run_flash_case(rng, "unimo-text draft 8 x 260 bf16", B=8,
                                S=256 + SPEC_K, dtype=bf16, timed=True,
                                **unimo))
    cases.append(run_flash_case(rng, "qwen3-4b GQA 8 x 256 bf16", B=8,
                                S=256, dtype=bf16, timed=True, **qwen3))
    cases.append(run_flash_case(rng, "unimo-text draft 8 x 68 fp32", B=8,
                                S=64 + SPEC_K, dtype=fp32, **unimo))
    cases.append(run_flash_case(rng, "ragged -1 + window 16 + softcap 30 "
                                "fp32", B=3, S=45, Hq=8, Hkv=2, D=32,
                                dtype=fp32, ragged=True, window=16,
                                softcap=30.0))
    cases.append(run_flash_case(rng, "ragged -1 + window 16 + softcap 30 "
                                "bf16", B=3, S=45, Hq=8, Hkv=2, D=32,
                                dtype=bf16, ragged=True, window=16,
                                softcap=30.0))
    # flash on the paper's serving path: the bucket prefill of qwen3-4b
    # (8 rows of a 128 bucket, causal) and the prefix-attend admission
    # (a 32-lane suffix bucket against 16 gathered 16-token pages: a
    # 32-token shared prefix, suffixes of 5-32 tokens, -1 holes after)
    cases.append(run_flash_case(rng, "qwen3-4b prefill 8 x 128 bf16", B=8,
                                S=128, dtype=bf16, timed=True, **qwen3))
    cases.append(run_flash_case(rng, "qwen3-4b prefill 8 x 128 ragged "
                                "bf16", B=8, S=128, dtype=bf16, ragged=True,
                                **qwen3))
    cases.append(run_flash_prefix_case(
        rng, "qwen3-4b prefix-attend 8 x 32 vs 256 bf16", B=8, Sq=32,
        npages=16, page=16, prefix=32, lens=[32, 5, 17, 29, 8, 32, 12, 21],
        dtype=bf16, timed=True, **qwen3))
    cases.append(run_flash_prefix_case(
        rng, "qwen3-4b prefix-attend 4 x 32 vs 256 fp32", B=4, Sq=32,
        npages=16, page=16, prefix=32, lens=[32, 5, 17, 1], dtype=fp32,
        **qwen3))
    cases += mlstm_kernel_cases(rng)
    # fused_rmsnorm (no model call site): qwen3-4b's width over 4096 rows,
    # and a ragged row count with fp32 w
    cases.append(run_rmsnorm_case(rng, "4096 x 2560 bf16", rows=4096,
                                  D=2560, dtype=bf16, wdtype=bf16,
                                  timed=True))
    cases.append(run_rmsnorm_case(rng, "4096 x 2560 fp32", rows=4096,
                                  D=2560, dtype=fp32, wdtype=fp32,
                                  timed=True))
    cases.append(run_rmsnorm_case(rng, "ragged 4099 x 2560 bf16, fp32 w",
                                  rows=4099, D=2560, dtype=bf16,
                                  wdtype=fp32))
    # the dense decode_attention: qwen3-4b's heads,
    # over 256 keys (6.8 MB of visible K/V) and 4096 (109 MB, more than
    # the 50 MB L2 holds, so it is timed at the memory's rate)
    cases.append(run_dense_decode_case(rng, "qwen3-4b heads 8 x 256 bf16",
                                       B=8, Sk=256, dtype=bf16, timed=True,
                                       **qwen3))
    cases.append(run_dense_decode_case(rng, "qwen3-4b heads 8 x 4096 bf16",
                                       B=8, Sk=4096, dtype=bf16, timed=True,
                                       **qwen3))
    cases.append(run_dense_decode_case(rng, "qwen3-4b heads 8 x 256 fp16",
                                       B=8, Sk=256, dtype=torch.float16,
                                       **qwen3))
    cases.append(run_dense_decode_case(
        rng, "qwen3-4b heads window 64 + softcap 30 bf16", B=8, Sk=256,
        dtype=bf16, window=64, softcap=30.0, **qwen3))
    cases.append(run_dense_decode_case(
        rng, "unimo-text heads ragged Sk=300 fp32", B=4, Sk=300, dtype=fp32,
        **unimo))
    # the dense KV cache of generate_batch at max_len 256: 257 rows rounded
    # up to 512, at most 256 + 32 of them written
    cases.append(run_dense_decode_case(
        rng, "qwen3-4b dense cache 8 x 512, 256 valid bf16", B=8, Sk=512,
        valid=256, dtype=bf16, timed=True, **qwen3))
    cases.append(run_dense_decode_case(
        rng, "unimo-text dense cache 8 x 512, 200 valid fp32", B=8, Sk=512,
        valid=200, dtype=fp32, **unimo))
    # last, so that the cases above draw the inputs they drew before it:
    # the pruned unimo-text head (--prune-coverage 0.999 on the smoke's
    # corpus): K = 1024, N = V_new, not a multiple of 16, at a decode
    # step's rows and a packed stream's
    v_new = _pruned_unimo_vocab()
    for M in (8, 256):
        cases.append(run_quant_matmul_case(
            rng, f"pruned unimo-text head 1024->{v_new} M={M} bf16", M=M,
            K=1024, N=v_new, dtype=bf16, timed=True))
    cases += family_kernel_cases(rng)
    cases += moe_mm_kernel_cases(rng)
    cases += hybrid_mla_kernel_cases(rng)
    cases += train_kernel_cases(rng)
    cases += ragged_kernel_cases(rng)
    for c in cases:
        emit("kernels", **c)
    bad = [c["case"] + " / " + c["kernel"] for c in cases if not c["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    if check_bodies:
        _check_bodies(cases)
    # each kernel's timed case at its main path's shape: qwen3-4b for the
    # paged kernels (its verify window for the mixed pair), the tied head
    # for quant_matmul (its M = 256 prefill stream beside it), the draft
    # shape for flash
    main = {"qwen3-4b bf16", "qwen3-4b int8 pool, bf16 q",
            "qwen3-4b verify bf16 q", "qwen3-4b verify int8 pool, bf16 q",
            "unimo-text draft 8 x 260 bf16",
            "xlstm-125m S=300 nonzero state bfloat16", "4096 x 2560 bf16",
            "qwen3-4b heads 8 x 256 bf16",
            "qwen3-4b 2560->151936 M=8 bf16",
            "unimo-text train 8 x 128 float32",
            "xlstm-125m train 8 x 128 bfloat16",
            "ragged qwen3-moe decode 64 rows 4096->1536 bf16",
            "ragged qwen3-moe train 4 x 128, 4096 rows 4096->1536 "
            "bfloat16"}
    summary = {c["kernel"]: c for c in cases
               if "kernel_ms" in c and c["case"] in main}
    summary["quant_matmul"]["regimes"] = [
        c for c in cases if c["case"] in ("qwen3-4b 2560->151936 M=8 bf16",
                                          "qwen3-4b 2560->9728 M=256 bf16")
        or c["case"].startswith("pruned unimo-text head")]
    summary["decode_attention"]["regimes"] = [
        c for c in cases if c["case"] in (
            "qwen3-4b heads 8 x 256 bf16", "qwen3-4b heads 8 x 4096 bf16",
            "qwen3-4b dense cache 8 x 512, 256 valid bf16")]
    summary["flash_attention"]["regimes"] = [
        c for c in cases if c["kernel"] == "flash_attention"
        and "kernel_ms" in c]
    summary["mlstm_chunked"]["regimes"] = [
        c for c in cases if c["kernel"] == "mlstm_chunked"
        and "kernel_ms" in c]
    summary["paged_packed_attention"]["regimes"] = [
        c for c in cases if c["kernel"] == "paged_packed_attention"
        and "kernel_ms" in c]
    # the phi3-mini, gemma2-2b, qwen3-moe, internvl2-1b and musicgen-medium
    # shapes: every timed case of the families
    for c in cases:
        if c["case"].startswith(FAMILY_CASES) and "kernel_ms" in c:
            row = summary[c["kernel"]]
            row.setdefault("regimes", [row]).append(c)
    summary["fused_rmsnorm"]["regimes"] = [
        c for c in cases if c["case"] in ("4096 x 2560 bf16",
                                          "4096 x 2560 fp32")]
    for name in ("flash_attention_bwd", "mlstm_chunked_bwd",
                 "ragged_matmul", "ragged_matmul_bwd"):
        summary[name]["regimes"] = [
            c for c in cases if c["kernel"] == name and "kernel_ms" in c]
    return summary


def attention_kernel_cases(rng):
    """The timed bf16 cases of the kernels built on the paged and flash
    attention core (``csrc/attn_mma.cuh``), at phase 3's shapes: the
    paged decode and packed kernels at unimo-text's and qwen3-4b's heads,
    the mixed kernel at qwen3-4b's verify window and (1, 256) chunk, and
    the flash forward at unimo-text's draft, qwen3-4b's GQA and its 8 x 128
    prefill.  An A/B of that core (``--only attn``)."""
    import torch
    bf16 = torch.bfloat16
    unimo = dict(Hq=16, Hkv=16, D=64)
    qwen3 = dict(Hq=32, Hkv=8, D=128)
    cases = []
    for run in (run_decode_case, run_packed_case):
        for name, heads in (("unimo-text", unimo), ("qwen3-4b", qwen3)):
            cases.append(run(rng, f"{name} bf16", dtype=bf16, timed=True,
                             **heads))
    ctx = [int(x) for x in torch.randint(0, 256 - SPEC_K, (8,),
                                         generator=rng, device="cuda")]
    cases.append(run_mixed_case(
        rng, "qwen3-4b verify bf16 q", dtype=bf16, timed=True,
        W=SPEC_K + 1, n_q=[SPEC_K + 1] * 8, before=ctx, **qwen3))
    cases.append(run_mixed_case(
        rng, "qwen3-4b chunk (1, 256) bf16 q", dtype=bf16, timed=True,
        W=256, n_q=[230], before=[20], **qwen3))
    for name, B, S, heads in (("unimo-text draft 8 x 260", 8, 256 + SPEC_K,
                               unimo),
                              ("qwen3-4b GQA 8 x 256", 8, 256, qwen3),
                              ("qwen3-4b prefill 8 x 128", 8, 128, qwen3)):
        cases.append(run_flash_case(rng, f"{name} bf16", B=B, S=S,
                                    dtype=bf16, timed=True, **heads))
    return cases


def _check_bodies(cases):
    """Every timed case of the redesigned kernels ran its tensor-core body
    (the packed pair's at bf16; the mLSTM forward's at every dtype), fp32
    flash, mLSTM and grouped-product cases their fp32 instances (bf16
    parts), and every grouped product at the models' widths (bf16, fp16,
    fp32) the wgmma bodies alone; the cases held on the CUDA-core bodies
    (``held_body``) planned those bodies and ran each of their kernels
    (CUDA_CORE_FP32) and nothing else; raises otherwise."""
    def ran(c, parts):
        return all(any(s in n for s in parts) for n in c["device_kernels"])
    held = [c for c in cases if c.get("held_body") == "cuda_cores"]
    stale = [c["case"] + " / " + c["kernel"] for c in held
             if c["body"] not in ("simt", "cuda_cores")
             or not c.get("device_kernels")
             or not ran(c, CUDA_CORE_FP32[c["kernel"]])
             or not all(any(s in n for n in c["device_kernels"])
                        for s in CUDA_CORE_FP32[c["kernel"]])]
    cases = [c for c in cases if c.get("held_body") != "cuda_cores"]
    stale += [c["case"] + " / " + c["kernel"] for c in cases
             if c["kernel"] in REDESIGNED and "device_kernels" in c
             and not ran(c, (REDESIGNED[c["kernel"]],))]
    stale += [c["case"] + " / " + c["kernel"] for c in cases
              if c["kernel"] in REDESIGNED_FP32
              and c.get("dtype") == "float32" and "device_kernels" in c
              and not ran(c, REDESIGNED_FP32[c["kernel"]])]
    stale += [c["case"] + " / " + c["kernel"] for c in cases
              if c["kernel"] in REDESIGNED_16BIT
              and (c.get("body") != "wgmma_tma" or "device_kernels" in c
                   and not ran(c, (REDESIGNED_16BIT[c["kernel"]],)))]
    stale += [c["case"] + " / " + c["kernel"] for c in cases
              if c["kernel"] == "mlstm_chunked" and c["dh"] % 8 == 0
              and c["body"] != "mma"]
    if stale:
        raise SystemExit(f"case did not run the redesigned tensor-core "
                         f"body: {stale}")


FAMILY_CASES = ("phi3-mini", "gemma2-2b", "gemma3-27b", "qwen3-moe",
                "internvl2-1b", "musicgen-medium", "hymba-1.5b",
                "deepseek-v3")


def family_kernel_cases(rng):
    """The kernels at the heads of this slice's families, each against its
    plain version: phi3-mini (32 / 32 heads x 96, the 128 head-dim bucket
    over 192-byte rows; its untied head), gemma2-2b (8 / 4 x 256, the
    local layers' window 4096 and softcap 50; its tied head of 256000
    rows) and gemma3-27b (32 / 16 x 128, window 1024).  bf16 cases at the
    serves' shapes are timed; fp32 (the CUDA-core bodies; flash's split
    body, also against fp64) and the cases past a window check values
    only.  The packed pair at gemma2's heads
    and dense decode at phi3's run in no serve of theirs (gemma2 serves
    bucketed, phi3 is served packed) but give each kernel both new head
    dims."""
    import torch
    bf16, fp32 = torch.bfloat16, torch.float32
    phi3 = dict(Hq=32, Hkv=32, D=96)
    gemma2 = dict(Hq=8, Hkv=4, D=256, window=4096, softcap=50.0)
    gemma3 = dict(Hq=32, Hkv=16, D=128, window=1024)
    ctx = [int(x) for x in torch.randint(0, 256 - SPEC_K, (8,),
                                         generator=rng, device="cuda")]
    verify = dict(W=SPEC_K + 1, n_q=[SPEC_K + 1] * 8, before=ctx)
    cases = []
    for quant in (False, True):
        q8 = " int8 pool," if quant else ""
        for run in (run_decode_case, run_packed_case):
            cases.append(run(rng, f"phi3-mini{q8} bf16", dtype=bf16,
                             quant=quant, timed=True, **phi3))
            cases.append(run(rng, f"phi3-mini{q8} fp32", dtype=fp32,
                             quant=quant, **phi3))
        cases.append(run_mixed_case(rng, f"phi3-mini verify{q8} bf16 q",
                                    dtype=bf16, quant=quant, timed=True,
                                    **verify, **phi3))
        cases.append(run_decode_case(
            rng, f"gemma2-2b window 4096 + softcap 50{q8} bf16", dtype=bf16,
            quant=quant, timed=True, **gemma2))
        cases.append(run_decode_case(
            rng, f"gemma2-2b past the window, up to 4608 keys{q8} bf16",
            dtype=bf16, quant=quant, npages=288, **gemma2))
        cases.append(run_decode_case(
            rng, f"gemma2-2b past the window{q8} fp32", dtype=fp32,
            quant=quant, npages=288, **gemma2))
        cases.append(run_decode_case(
            rng, f"gemma3-27b past the window, up to 2048 keys{q8} bf16",
            dtype=bf16, quant=quant, npages=128, **gemma3))
    for quant in (False, True):
        q8 = " int8 pool," if quant else ""
        cases.append(run_packed_case(
            rng, f"gemma2-2b window 4096 + softcap 50{q8} bf16", dtype=bf16,
            quant=quant, timed=True, **gemma2))
    cases.append(run_dense_decode_case(
        rng, "phi3-mini dense cache 8 x 512, 256 valid bf16", B=8, Sk=512,
        valid=256, dtype=bf16, timed=True, **phi3))
    cases.append(run_flash_case(rng, "phi3-mini prefill 8 x 128 bf16", B=8,
                                S=128, dtype=bf16, timed=True, **phi3))
    cases.append(run_flash_case(rng, "phi3-mini prefill 8 x 128 ragged "
                                "fp32", B=8, S=128, dtype=fp32, ragged=True,
                                **phi3))
    for dtype in (bf16, fp32):
        dn = str(dtype).removeprefix("torch.")
        cases.append(run_flash_case(
            rng, f"gemma2-2b prefill 8 x 128 window 4096 + softcap 50 {dn}",
            B=8, S=128, dtype=dtype, timed=dtype == bf16, **gemma2))
        cases.append(run_flash_case(
            rng, f"gemma2-2b 1 x 4416 past the window {dn}", B=1, S=4416,
            dtype=dtype, **gemma2))
        cases.append(run_dense_decode_case(
            rng, f"gemma2-2b dense cache 8 x 512, 256 valid, window 4096 + "
            f"softcap 50 {dn}", B=8, Sk=512, valid=256, dtype=dtype,
            timed=dtype == bf16, **gemma2))
        cases.append(run_dense_decode_case(
            rng, f"gemma2-2b dense ring 2 x 4352 past the window {dn}", B=2,
            Sk=4352, dtype=dtype, **gemma2))
    cases.append(run_flash_case(rng, "gemma3-27b 2 x 1400 past the window "
                                "bf16", B=2, S=1400, dtype=bf16, **gemma3))
    for name, K, N in (("phi3-mini untied head", 3072, 32064),
                       ("gemma2-2b tied head", 2304, 256000)):
        cases.append(run_quant_matmul_case(
            rng, f"{name} {K}->{N} M=8 bf16", M=8, K=K, N=N, dtype=bf16,
            timed=True))
    return cases


# int8 parity: where a K/V value the card computes differs from the CPU's
# by an ulp and lies on a rounding boundary, its int8 code rounds the other
# way and moves by one scale step (1/127 of its row's absmax); fp32
# elsewhere.  The greedy match of int8 streams is recorded, not gated.
PARITY_TOL = {"auto": 1e-3, "int8": 2e-2}


def phase_parity(arch, kv_dtype="auto", weights_dtype="auto"):
    """Reduced ``arch``, fp32 (TF32 off): packed, decode, verify, mixed and
    train forwards on the card against the same forwards through the
    plain versions on the CPU, from the same pools and weights; then short
    greedy serves on both devices.  At (auto, auto) the streams of every
    serving mode on both devices must be identical."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_reduced
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.kv_cache import quantize_kv
    from repro_torch.core.precision import FP32, compress_weights, map_params
    from repro_torch.core.scheduler import Request
    from repro_torch.core.speculative import SpecConfig
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    policy = dataclasses.replace(FP32, kv_dtype=kv_dtype,
                                 weights_dtype=weights_dtype)
    quant = kv_dtype == "int8"
    cfg = get_reduced(arch)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    fwd_params, _ = compress_weights(params, policy)
    rng = np.random.default_rng(3)
    slots, page, npages = 4, 8, 8
    P = slots * npages + 1
    ctx = [20, 9, 0, 33]
    kv = [torch.from_numpy(rng.normal(size=(
        P, page, cfg.num_kv_heads, cfg.resolved_head_dim)).astype(
        np.float32)) for _ in range(2)]
    pool = {"ppos": np.full((P, page), -1, np.int32)}
    if quant:
        (pool["pk"], pool["pk_scale"]), (pool["pv"], pool["pv_scale"]) = \
            (quantize_kv(t) for t in kv)
    else:
        pool["pk"], pool["pv"] = kv
    bt = np.full((slots, npages), -1, np.int32)
    for s, n in enumerate(ctx):
        used = -(-(n + 8) // page)
        bt[s, :used] = s * npages + np.arange(used)
        for t in range(n):
            pool["ppos"][bt[s, t // page], t % page] = t
    # packed: decode lanes for slots 0 and 3, a 6-token chunk continuing
    # slot 1 and a 5-token chunk starting slot 2, 5 padding lanes
    segs = [(0, 20, 1), (3, 33, 1), (1, 9, 6), (2, 0, 5)]
    W = 16
    toks = np.zeros(W, np.int32)
    sid = np.full(W, -1, np.int32)
    pos = np.full(W, -1, np.int32)
    starts, last, t = [], [], 0
    vocab = min(cfg.vocab_size, 400)
    for s, p0, ln in segs:
        starts.append(t)
        toks[t:t + ln] = rng.integers(4, vocab, size=ln)
        sid[t:t + ln], pos[t:t + ln] = s, p0 + np.arange(ln)
        t += ln
        last.append(t - 1)
    meta = DA.packed_meta_table(starts, [g[2] for g in segs],
                                [g[0] for g in segs], W,
                                W // DA.PACKED_BLOCK_Q + slots)
    dec_tok = rng.integers(4, vocab, size=(slots, 1)).astype(np.int32)
    dec_len = np.asarray([21, 15, 5, 34], np.int32)
    ver_tok = rng.integers(4, vocab, size=(slots, SPEC_K + 1)).astype(
        np.int32)
    ver_act = np.asarray([True, True, False, True])
    mix_tok = rng.integers(4, vocab, size=(1, 16)).astype(np.int32)
    train_tok = rng.integers(4, vocab, size=(2, 13)).astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        def put(a):                    # a copy: every layer owns its pool
            return torch.as_tensor(np.asarray(a)).clone().to(dev)
        p = {"layers": [{k: put(v) for k, v in pool.items()}
                        for _ in range(cfg.num_layers)]}
        prm = map_params(lambda t: t.to(dev), fwd_params)
        with torch.no_grad():
            lp, _ = T.forward_packed(
                prm, cfg, put(toks[None]), p, put(sid), put(pos),
                put(np.asarray(last, np.int32)), policy=policy, max_len=64,
                paged={"block_tables": put(bt), "packed_meta": put(meta)})
            ld, _ = T.forward_decode(
                prm, cfg, put(dec_tok), p, put(dec_len), policy=policy,
                max_len=64, paged={"block_tables": put(bt),
                                   "active": put(np.ones(slots, bool))})
            # a verify window of k + 1 tokens per slot (slot 2 inactive),
            # then a 6-token chunk continuing slot 1 in a (1, 16) row
            lv, _ = T.forward_verify(
                prm, cfg, put(ver_tok), p, put(dec_len), policy=policy,
                max_len=64, paged={"block_tables": put(bt),
                                   "active": put(ver_act)})
            lm, _ = T.forward_mixed(
                prm, cfg, put(mix_tok), p, put(np.asarray([9], np.int32)),
                put(np.asarray([6], np.int32)), policy=policy, max_len=64,
                paged={"block_tables": put(bt[1:2])})
            lt = T.forward_train(prm, cfg, put(train_tok), policy=policy)[0]
        out[dev] = (lp.cpu(), ld.cpu(), lv.cpu(), lm.cpu(), lt.cpu())
    errs = [(a - b).abs().max().item() for a, b in zip(out["cuda"],
                                                       out["cpu"])]
    prompts = [[2] + [int(t) for t in rng.integers(4, vocab, size=n)]
               for n in (19, 30, 11, 23, 7, 15)]
    prompts += [prompts[0][:12] + [5, 6, 7, 8], prompts[1][:17] + [9, 10]]
    # the packed serve; at (auto, auto) also speculative serves (n-gram,
    # self-drafting) and the packed=False serve, whose greedy streams must
    # all equal the packed serve's
    modes = {"packed": {}}
    if (kv_dtype, weights_dtype) == ("auto", "auto"):
        modes.update({
            "spec_ngram": {"spec": SpecConfig(k=SPEC_K)},
            "spec_draft": {"spec": SpecConfig(k=SPEC_K,
                                              drafter="draft_model")},
            "packed_off": {"packed": False}})
    streams = {}
    for dev in ("cuda", "cpu"):
        for mode, kw in modes.items():
            eng = InferenceEngine(cfg, params, policy=policy, max_len=64,
                                  max_batch=4, device=dev)
            reqs = [Request(uid=i, tokens=p, max_new_tokens=12)
                    for i, p in enumerate(prompts)]
            done, m = eng.serve_continuous(reqs, page_size=8,
                                           max_batched_tokens=32, **kw)
            streams[dev, mode] = [r.result for r in done]
    toks_all = sum(len(s) for s in streams["cpu", "packed"])
    same = sum(a == b for x, y in zip(streams["cuda", "packed"],
                                      streams["cpu", "packed"])
               for a, b in zip(x, y))
    tol = PARITY_TOL[kv_dtype if quant else weights_dtype]
    identical = {f"{dev}/{mode}": st == streams["cpu", "packed"]
                 for (dev, mode), st in streams.items()}
    emit("parity", arch=arch, kv_dtype=kv_dtype,
         weights_dtype=weights_dtype, logits_tol=tol,
         logits_max_abs_err=dict(zip(
             ("packed", "decode", "verify", "mixed", "train"), errs)),
         greedy_token_match=same / max(toks_all, 1), tokens=toks_all,
         streams_equal_cpu_packed=identical)
    if not all(np.isfinite(e) and e <= tol for e in errs):
        raise SystemExit(f"{arch} ({kv_dtype}, {weights_dtype}): card "
                         f"forwards differ from the plain path: {errs}")
    if (kv_dtype, weights_dtype) == ("auto", "auto") \
            and not all(identical.values()):
        raise SystemExit(f"{arch}: greedy streams differ across devices or "
                         f"serving modes: {identical}")


def phase_parity_dense(arch):
    """Reduced ``arch``, fp32 (TF32 off), on the card and on the CPU: the
    dense-cache forwards (a ragged prefill, a prefill resuming at position
    9 that attends the cache, a decode step), then the paper's serving
    path (``generate_batch`` with and without the KV cache, 6 rows of 12,
    7, ... tokens x 10 new; ``run_pipelined`` over 6 texts) and the
    bucketed ``serve_continuous`` (8 requests with shared prefixes; with a
    16-token prefix pinned by ``set_prefix``; over an int8 pool), each
    beside the chunked serve of the same requests.  Every stream on the
    card must equal the CPU's token for token, KV == no-cache and
    bucketed == chunked on both devices."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_reduced
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.pipeline import run_pipelined
    from repro_torch.core.precision import FP32, map_params
    from repro_torch.core.scheduler import Request
    from repro_torch.core.tokenizer import FastTokenizer
    from repro_torch.data.pipeline import synthetic_corpus
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_reduced(arch)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    rng = np.random.default_rng(11)
    vocab = min(cfg.vocab_size, 400)
    B = 3
    toks = rng.integers(4, vocab, size=(B, 9)).astype(np.int32)
    lens = np.asarray([9, 5, 1], np.int32)
    more = rng.integers(4, vocab, size=(B, 4)).astype(np.int32)
    nxt = rng.integers(4, vocab, size=(B, 1)).astype(np.int32)
    logits = {}
    for dev in ("cuda", "cpu"):
        def put(a):
            return torch.as_tensor(a).to(dev)
        prm = map_params(lambda t: t.to(dev), params)
        cache = T.init_cache(cfg, B, 40, torch.float32, device=dev)
        with torch.no_grad():
            lp, _ = T.forward_prefill(prm, cfg, put(toks), put(lens), cache,
                                      policy=FP32)
            lr, _ = T.forward_prefill(prm, cfg, put(more),
                                      put(np.full(B, 4, np.int32)), cache,
                                      policy=FP32, start=9)
            ld, _ = T.forward_decode(prm, cfg, put(nxt), cache,
                                     put(np.full(B, 13, np.int32)),
                                     policy=FP32)
        logits[dev] = [t.cpu() for t in (lp, lr, ld)]
    errs = dict(zip(("prefill", "resumed_prefill", "decode"),
                    ((a - b).abs().max().item() for a, b in zip(
                        logits["cuda"], logits["cpu"]))))
    batch = rng.integers(4, vocab, size=(6, 12)).astype(np.int32)
    blens = np.asarray([12, 7, 3, 12, 9, 1], np.int32)
    prompts = [[2] + [int(t) for t in rng.integers(4, vocab, size=n)]
               for n in (19, 30, 11, 23)]
    prompts += [prompts[0][:12] + [5, 6, 7], prompts[1][:17] + [9, 10],
                prompts[3][:8] + [11, 12, 13], [2, 14, 15, 16]]
    system = [2] + [int(t) for t in rng.integers(4, vocab, size=15)]
    tok = FastTokenizer.train(synthetic_corpus(50), min(cfg.vocab_size,
                                                        300))
    texts = synthetic_corpus(6, seed=3, min_len=3, max_len=12)
    int8 = dataclasses.replace(FP32, kv_dtype="int8")
    out = {}
    for dev in ("cuda", "cpu"):
        def engine(policy=FP32, **kw):
            return InferenceEngine(cfg, params, policy=policy, max_len=64,
                                   max_batch=4, device=dev, **kw)
        out[dev, "kv"] = engine().generate_batch(batch.copy(), blens, 10)
        out[dev, "nocache"] = engine(use_kv_cache=False).generate_batch(
            batch.copy(), blens, 10)
        out[dev, "pipelined"] = [r.token_ids for r in run_pipelined(
            texts, tok, engine(), max_new_tokens=8, max_batch=4)]
        for name, policy, prefix in (("serve", FP32, None),
                                     ("set_prefix", FP32, system),
                                     ("int8", int8, None)):
            reqs = [p if prefix is None else prefix + p[1:]
                    for p in prompts]
            for chunked in (False, None):
                eng = engine(policy)
                if prefix is not None:
                    eng.set_prefix(prefix, page_size=8)
                done, m = eng.serve_continuous(
                    [Request(uid=i, tokens=list(p), max_new_tokens=8)
                     for i, p in enumerate(reqs)], page_size=8,
                    max_batched_tokens=32, chunked_prefill=chunked)
                key = name + ("_bucketed" if chunked is False else
                              "_chunked")
                out[dev, key] = [r.result for r in done]
                if chunked is False:
                    out[dev, key + "_counters"] = [
                        m.admitted, m.prefill_padded, m.prefix_hits,
                        m.cow_copies, m.host_syncs]

    def same(a, b):
        return bool(np.array_equal(np.asarray(a), np.asarray(b))) \
            if isinstance(a, np.ndarray) else a == b
    keys = sorted({k for _, k in out})
    card_eq_cpu = {k: same(out["cuda", k], out["cpu", k]) for k in keys}
    inner = {f"{dev}: kv == nocache": same(out[dev, "kv"],
                                           out[dev, "nocache"])
             for dev in ("cuda", "cpu")}
    for dev in ("cuda", "cpu"):
        for name in ("serve", "set_prefix", "int8"):
            inner[f"{dev}: {name} bucketed == chunked"] = same(
                out[dev, name + "_bucketed"], out[dev, name + "_chunked"])
    emit("parity_dense", arch=arch, logits_tol=PARITY_TOL["auto"],
         logits_max_abs_err=errs, card_equals_cpu=card_eq_cpu,
         invariants=inner, tokens=int((out["cpu", "kv"] >= 0).sum()),
         bucketed_counters=out["cuda", "serve_bucketed_counters"])
    if not all(np.isfinite(e) and e <= PARITY_TOL["auto"]
               for e in errs.values()):
        raise SystemExit(f"{arch}: dense forwards on the card differ from "
                         f"the plain path: {errs}")
    failed = [k for k, v in {**card_eq_cpu, **inner}.items() if not v]
    if failed:
        raise SystemExit(f"{arch}: dense / bucketed parity failed: "
                         f"{failed}")


# reduced xlstm on the card against the CPU, fp32: logits and states
XLSTM_PARITY_TOL = 1e-5


def phase_parity_xlstm():
    """Reduced xlstm-125m, fp32 (TF32 off): ``forward_prefill`` logits and
    every layer's state, then one ``forward_decode`` from that state, on
    the card (the mLSTM kernel) against the CPU (its plain version), from
    the same weights and tokens; then a short greedy serve through the
    bucketed admission path on both, whose streams must be equal (three
    prompts of one length, so one admission dispatch covers two slots)."""
    import torch
    from repro_torch.configs.registry import get_reduced
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.precision import FP32, map_params
    from repro_torch.core.scheduler import Request
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("xlstm-125m")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    rng = np.random.default_rng(5)
    B, S = 3, 45
    toks = rng.integers(4, cfg.vocab_size, size=(B, S)).astype(np.int32)
    nxt = rng.integers(4, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        prm = map_params(lambda t: t.to(dev), params)
        cache = T.init_paged_cache(cfg, num_pages=4, page_size=8,
                                   dtype=torch.float32, max_slots=B,
                                   device=dev)
        lens = torch.full((B,), S, dtype=torch.int32, device=dev)
        with torch.no_grad():
            lp, cache = T.forward_prefill(
                prm, cfg, torch.from_numpy(toks).to(dev), lens, cache,
                policy=FP32, max_len=64)
            st_p = [{k: t.cpu() for k, t in c.items()}
                    for c in cache["layers"]]
            ld, cache = T.forward_decode(
                prm, cfg, torch.from_numpy(nxt).to(dev), cache, lens,
                policy=FP32, max_len=64)
        out[dev] = (lp.cpu(), ld.cpu(), st_p,
                    [{k: t.cpu() for k, t in c.items()}
                     for c in cache["layers"]])
    errs = {"prefill_logits": (out["cuda"][0] - out["cpu"][0]).abs().max()
            .item(),
            "decode_logits": (out["cuda"][1] - out["cpu"][1]).abs().max()
            .item()}
    state_ok = True
    for tag, i in (("prefill_state", 2), ("decode_state", 3)):
        worst = 0.0
        for a, b in zip(out["cuda"][i], out["cpu"][i]):
            for k in a:
                e = (a[k] - b[k]).abs().max().item()
                worst = max(worst, e)
                state_ok &= e <= XLSTM_PARITY_TOL * max(
                    b[k].abs().max().item(), 1.0)
        errs[tag] = worst
    prompts = [[2] + [int(t) for t in rng.integers(4, 400, size=n)]
               for n in (40, 40, 9, 70, 40, 3)]
    streams, launches = {}, {}
    for dev in ("cuda", "cpu"):
        eng = InferenceEngine(cfg, params, policy=FP32, max_len=128,
                              max_batch=3, device=dev)
        ops.reset_launch_counts()
        done, m = eng.serve_continuous(
            [Request(uid=i, tokens=p, max_new_tokens=10)
             for i, p in enumerate(prompts)], page_size=8)
        streams[dev] = [r.result for r in done]
        launches[dev] = ops.launch_counts()["mlstm_chunked"]
    emit("parity", arch="xlstm-125m", logits_tol=XLSTM_PARITY_TOL,
         max_abs_err=errs, greedy_streams_equal=streams["cuda"]
         == streams["cpu"], tokens=sum(map(len, streams["cpu"])),
         mlstm_launches_card_serve=launches["cuda"])
    if not (errs["prefill_logits"] <= XLSTM_PARITY_TOL
            and errs["decode_logits"] <= XLSTM_PARITY_TOL and state_ok):
        raise SystemExit(f"xlstm-125m: card forwards differ from the plain "
                         f"path: {errs}")
    if streams["cuda"] != streams["cpu"] or launches["cuda"] == 0:
        raise SystemExit("xlstm-125m: greedy streams differ across devices "
                         "or the card serve did not run the mLSTM kernel")


# the reduced overload parity: the reference's overload test's requests
# (6 prompts of 20-30 tokens x 8 new, 3 slots, 8-token pages, a 16-token
# budget) on a pool of 11 pages, about a third of their 30
OVERLOAD_SHAPES = (30, 28, 26, 24, 22, 20)
OVERLOAD_COUNTERS = ("preemptions", "resumed", "offloaded_pages",
                     "restored_pages", "host_bytes_peak", "timed_out",
                     "deadline_misses", "rejected", "admission_stalls",
                     "generated_tokens", "steps", "mixed_iters")


def phase_parity_overload():
    """Reduced qwen3-4b, fp32 (TF32 off), on the card and on the CPU: the
    uncontended serve, then a pool of 11 pages with ``preemption="lru"``
    and a host tier, the same with ``FaultConfig(host_full=True)``
    (recompute-resume), and ``preemption="priority"`` with one request at
    priority 5, all with ``debug_audit=True``; then a serve of the model
    pruned to its 448 most frequent ids.  On the card each preempting
    serve's greedy streams must equal the uncontended card serve's, and
    every serve's streams, outcomes and overload counters must equal the
    CPU's."""
    import torch
    from repro_torch.configs.registry import get_reduced
    from repro_torch.core import pruning as PR
    from repro_torch.core.continuous import FaultConfig
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.precision import FP32
    from repro_torch.core.scheduler import Request
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("qwen3-4b")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    freqs = {i: 10_000 - i for i in range(cfg.vocab_size)}
    p2, cfg2, maps = PR.prune_model(params, cfg, freqs,
                                    max_vocab=cfg.vocab_size - 64)
    rng = np.random.default_rng(11)
    prompts = [[2] + [int(t) for t in rng.integers(4, 400, size=n)]
               for n in OVERLOAD_SHAPES]
    pool = dict(num_pages=11, preemption="lru", host_kv_bytes=1 << 30,
                debug_audit=True)
    # case -> (requests, serve options, priorities, uncontended twin)
    cases = {"uncontended": (6, {}, {}, None),
             "lru": (6, pool, {}, "uncontended"),
             "host_full": (6, {**pool,
                               "faults": FaultConfig(host_full=True)}, {},
                           "uncontended"),
             "uncontended_4": (4, {}, {}, None),
             "priority": (4, {**pool, "preemption": "priority"}, {2: 5},
                          "uncontended_4"),
             "pruned": (6, {}, {}, None)}
    out = {}
    for dev in ("cuda", "cpu"):
        for name, (n, kw, prio, _) in cases.items():
            c, p = (cfg2, p2) if name == "pruned" else (cfg, params)
            eng = InferenceEngine(c, p, policy=FP32, max_len=64,
                                  max_batch=3, device=dev,
                                  prune_maps=maps if name == "pruned"
                                  else None)
            done, m = eng.serve_continuous(
                [Request(uid=i, tokens=list(t), max_new_tokens=8,
                         priority=prio.get(i, 0))
                 for i, t in enumerate(prompts[:n])],
                page_size=8, max_batched_tokens=16, **kw)
            out[dev, name] = {
                "streams": [r.result for r in done],
                "outcomes": [r.outcome.status for r in done],
                "counters": {k: getattr(m, k) for k in OVERLOAD_COUNTERS}}
    checks = {f"{name}: card == CPU": out["cuda", name] == out["cpu", name]
              for name in cases}
    for name, (*_, twin) in cases.items():
        if twin is not None:
            checks[f"{name}: streams == {twin}"] = (
                out["cuda", name]["streams"] == out["cuda", twin]["streams"])
            checks[f"{name}: preempted"] = (
                out["cuda", name]["counters"]["preemptions"] >= 1)
    checks["lru: offloaded"] = out["cuda", "lru"]["counters"][
        "offloaded_pages"] > 0
    checks["host_full: nothing offloaded"] = out["cuda", "host_full"][
        "counters"]["offloaded_pages"] == 0
    emit("parity", arch="qwen3-4b", serves="overload+pruning",
         counters={name: out["cuda", name]["counters"] for name in cases},
         pruned_vocab=cfg2.vocab_size, checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"overload/pruning parity failed: {failed}")


@functools.lru_cache(maxsize=None)
def _smoke_tokenizer():
    """The tokenizer of the serves, trained once on the synthetic corpus
    (as ``launch/serve.py`` trains it)."""
    from repro_torch.core.tokenizer import FastTokenizer
    from repro_torch.data.pipeline import synthetic_corpus
    return FastTokenizer.train(synthetic_corpus(600), 4000)


@functools.lru_cache(maxsize=None)
def _smoke_prompts():
    """The serves' 16 prompts: synthetic-corpus texts of 4-40 words,
    tokenized by a tokenizer trained once on the corpus."""
    from repro_torch.data.pipeline import synthetic_corpus
    tok = _smoke_tokenizer()
    return tuple(tuple(tok.encode(t)) for t in synthetic_corpus(
        16, seed=7, min_len=4, max_len=40))


@functools.lru_cache(maxsize=None)
def _smoke_freqs():
    """Token frequencies of the corpus, as the serve CLI counts them for
    ``--prune-coverage``."""
    from repro_torch.data.pipeline import synthetic_corpus
    return tuple(sorted(_smoke_tokenizer().count_frequencies(
        synthetic_corpus(600)).items()))


@functools.lru_cache(maxsize=None)
def _system_prompt():
    """A 32-token shared system prompt, as the serve CLI's
    ``--shared-prefix 32`` builds it."""
    from repro_torch.data.pipeline import synthetic_corpus
    return tuple(_smoke_tokenizer().encode(" ".join(synthetic_corpus(
        3, seed=11)))[:32])


def _pruned_unimo_vocab() -> int:
    """V_new of unimo-text pruned to coverage 0.999 of the corpus."""
    from repro_torch.core import pruning as PR
    return len(PR.select_keep_ids(dict(_smoke_freqs()), 12800,
                                  coverage=PRUNE_COVERAGE))


def _serve_kw(mode):
    """serve_continuous options of a serving mode."""
    from repro_torch.core.speculative import SpecConfig
    return {"packed": {}, "bucketed": {"chunked_prefill": False},
            "spec_ngram": {"spec": SpecConfig(k=SPEC_K)},
            "spec_draft": {"spec": SpecConfig(k=SPEC_K,
                                              drafter="draft_model")},
            "packed_off": {"packed": False}}[mode]


def _launch_checks(mode, m, launches, cfg, q8, weights_dtype, drafts,
                   mm_per_forward=None):
    """The exact launch counts a serve of ``mode`` of ``cfg`` must show
    (``mm_per_forward``: the int8 weight records one forward reads,
    qwen3-4b's 7 per layer and the head by default).  Every layer's
    decode step attends through the paged decode kernel but an MLA
    layer's, whose absorbed decode is plain torch."""
    from repro_torch.configs.base import MLA, layer_specs
    other = "" if q8 else "_q8"
    n_layers = cfg.num_layers
    decode_layers = sum(s.mixer != MLA for s in layer_specs(cfg))
    if mm_per_forward is None:
        mm_per_forward = 7 * n_layers + 1
    if weights_dtype != "int8":
        mm_per_forward = 0
    if mode == "packed":
        decode_steps = m.steps - m.mixed_dispatches
        forwards = m.mixed_dispatches + decode_steps
        return {
            "one dispatch per mixed iteration": m.dispatches_per_iter == 1.0,
            f"packed{q8} kernel ran {n_layers} x mixed dispatches": (
                launches["paged_packed_attention" + q8]
                == n_layers * m.mixed_dispatches > 0),
            f"decode{q8} kernel ran {n_layers} x decode steps": (
                launches["paged_decode_attention" + q8]
                == n_layers * decode_steps > 0),
            f"the{other} attention kernels did not run": (
                launches["paged_packed_attention" + other]
                == launches["paged_decode_attention" + other] == 0),
            "the mixed kernels and flash did not run": (
                launches["paged_mixed_attention"]
                == launches["paged_mixed_attention_q8"]
                == launches["flash_attention"] == 0),
            f"quant_matmul ran {mm_per_forward} x forwards": (
                launches["quant_matmul"] == mm_per_forward * forwards),
        }
    if mode == "bucketed":
        # decode dispatches fuse 4 steps each; every other host sync is
        # an admission dispatch
        admissions = m.host_syncs - m.steps // 4
        forwards = admissions + m.steps
        # under moe_ragged: three grouped products a MoE layer and forward
        ragged = 3 * sum(s.ffn == "moe" for s in layer_specs(cfg)) \
            if _ragged_on() else 0
        return {
            f"ragged_matmul ran {ragged} x forwards": (
                launches.get("ragged_matmul", 0) == ragged * forwards),
            "bucketed admission": m.scheduler == "bucketed"
            and m.mixed_iters == 0,
            f"flash ran {n_layers} x admission dispatches ({admissions})": (
                launches["flash_attention"] == n_layers * admissions > 0),
            f"decode{q8} kernel ran {decode_layers} x decode steps": (
                launches["paged_decode_attention" + q8]
                == decode_layers * m.steps and m.steps > 0),
            "no packed, mixed, dense decode or other-pool kernel ran": (
                launches["paged_packed_attention"]
                == launches["paged_packed_attention_q8"]
                == launches["paged_mixed_attention"]
                == launches["paged_mixed_attention_q8"]
                == launches["paged_decode_attention" + other]
                == launches["decode_attention"] == 0),
            f"quant_matmul ran {mm_per_forward} x forwards": (
                launches["quant_matmul"] == mm_per_forward * forwards),
        }
    if mode == "packed_off":
        return {
            f"mixed{q8} kernel ran {n_layers} x prefill chunks": (
                launches["paged_mixed_attention" + q8]
                == n_layers * m.prefill_chunks > 0),
            f"decode{q8} kernel ran {n_layers} x decode steps (one-step "
            f"and fused)": (launches["paged_decode_attention" + q8]
                            == n_layers * m.steps > 0),
            "the packed kernels, flash and the other pool's kernels did "
            "not run": (launches["paged_packed_attention"]
                        == launches["paged_packed_attention_q8"]
                        == launches["paged_mixed_attention" + other]
                        == launches["paged_decode_attention" + other]
                        == launches["flash_attention"] == 0),
            "several dispatches per mixed iteration": (
                m.mixed_dispatches > m.mixed_iters > 0),
        }
    verify_steps = m.steps - m.mixed_iters
    forwards = m.mixed_iters + verify_steps + SPEC_K * drafts
    return {
        "one dispatch per mixed iteration": m.dispatches_per_iter == 1.0,
        f"mixed{q8} kernel ran {n_layers} x verify steps": (
            launches["paged_mixed_attention" + q8]
            == n_layers * verify_steps > 0),
        f"packed{q8} kernel ran {n_layers} x packed iterations": (
            launches["paged_packed_attention" + q8]
            == n_layers * m.mixed_iters > 0),
        "the decode kernels and the other pool's kernels did not run": (
            launches["paged_decode_attention"]
            == launches["paged_decode_attention_q8"]
            == launches["paged_mixed_attention" + other]
            == launches["paged_packed_attention" + other] == 0),
        f"flash ran {n_layers} x {SPEC_K} x draft calls ({drafts})": (
            launches["flash_attention"] == n_layers * SPEC_K * drafts
            and (drafts > 0) == (mode == "spec_draft")),
        f"quant_matmul ran {mm_per_forward} x forwards": (
            launches["quant_matmul"] == mm_per_forward * forwards),
        "drafts were verified": m.drafted_tokens > 0,
    }


def phase_serve(arch, params, *, kv_dtype="auto", weights_dtype="auto",
                mode="packed", profile=False, cfg=None, extra=None,
                prune_maps=None, traced=False, label=None, prefix=None,
                mm_per_forward=None, expect_warnings=()):
    """Full-width ``arch`` (bf16 weights ``params``; ``cfg`` defaults to
    the arch's published config) through ``serve_continuous``: 16
    synthetic requests x 32 new tokens, 8 slots, max_len 256, 16-token
    pages, a 256-token budget, in serving ``mode`` (packed; speculative
    with the n-gram drafter or self-drafting, k = 4; ``packed=False``;
    bucketed admission), with ``extra`` serve options (a contended pool
    and preemption) and ``prune_maps`` given to the engine.  With
    ``prefix`` every request starts with it and each engine pins it by
    ``set_prefix`` first; ``mm_per_forward``: the int8 weight records a
    forward reads, where not qwen3-4b's 7 a layer and the head;
    ``expect_warnings``: parts of warnings the serve must give.  Each
    paged layer's pool must be what the request and the config call for:
    int8 codes and scales for a pure attention layer under
    ``kv_dtype="int8"``, bf16 otherwise (a hybrid layer's pool never
    quantizes).  The launch counts of this run
    (set to 0 just before it, read just after) must show every attention
    call in the kernels of its mode and that pool, every draft forward's
    attention in flash and, under int8 weights, every dense matmul in
    ``quant_matmul``.  With ``traced`` the run carries a ``ServeTracer``
    whose JSONL and Perfetto exports go to ``build/``; the JSONL must
    validate and its device spans sum to ``metrics.device_s``.  With
    ``profile`` the same serve runs once more under ``torch.profiler``
    (traced too when ``traced``).  Returns the run's metrics, launch
    counts, greedy streams, wall seconds and the profile's device busy
    seconds (None without ``profile``)."""
    import dataclasses

    import torch
    from repro_torch.configs.base import ATTN, HYBRID, layer_specs
    from repro_torch.configs.registry import get_config
    from repro_torch.core import trace as TR
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.precision import BF16
    from repro_torch.core.scheduler import Request
    from repro_torch.kernels import ops
    cfg = cfg or get_config(arch)
    label = label or mode
    policy = dataclasses.replace(BF16, kv_dtype=kv_dtype,
                                 weights_dtype=weights_dtype)
    serve_kw = {**_serve_kw(mode), **(extra or {})}

    def requests(n, max_new):
        return [Request(uid=i, tokens=list(prefix or []) + list(t),
                        max_new_tokens=max_new)
                for i, t in enumerate(_smoke_prompts()[:n])]

    def engine():
        eng = InferenceEngine(cfg, params, policy=policy, max_batch=8,
                              max_len=256, device="cuda",
                              prune_maps=prune_maps)
        if prefix is not None:        # pinned before the counts are reset
            eng.set_prefix(prefix)
        return eng

    # warm-up on its own engine (cuBLAS handles, allocator pools)
    engine().serve_continuous(requests(4, 4), **serve_kw)
    eng = engine()
    reqs = requests(16, 32)
    tracer = TR.ServeTracer() if traced else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        done, m = eng.serve_continuous(reqs, trace=tracer, **serve_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    said = [str(w.message) for w in caught
            if issubclass(w.category, UserWarning)]
    # each paged layer's pool as built, and as the request calls for it
    specs = list(layer_specs(cfg))
    pools = [(str(c["pk"].dtype).removeprefix("torch."), "pk_scale" in c)
             for c in eng._paged_ctx["cache"]["layers"] if "pk" in c]
    want = [(("int8", True) if kv_dtype == "int8" and s.mixer == ATTN
             else ("bfloat16", False))
            for s in specs if s.mixer in (ATTN, HYBRID)]
    q8 = "_q8" if any(sc for _, sc in want) else ""
    pool_dtype = pools[0][0] if pools else None
    drafts = eng.drafter.calls if mode == "spec_draft" else 0
    n_layers = cfg.num_layers
    keep = set(prune_maps.keep_ids.tolist()) if prune_maps is not None \
        else range(cfg.vocab_size)
    out_ok = all(r.outcome is not None and r.outcome.status == "completed"
                 and all(t in keep for t in r.result) for r in done)
    emit("serve", arch=cfg.name, layers=n_layers, policy="bf16", mode=label,
         kv_dtype=m.kv_dtype, weights_dtype=m.weight_dtype,
         requests=len(done), generated_tokens=m.generated_tokens,
         wall_s=wall, tokens_per_s=m.generated_tokens / wall,
         ttft_p50_s=m.ttft_p50, ttft_p99_s=m.ttft_p99, itl_p50_s=m.itl_p50,
         itl_p99_s=m.itl_p99, host_frac=m.host_frac, host_s=m.host_s,
         device_s=m.device_s, steps=m.steps, mixed_iters=m.mixed_iters,
         mixed_dispatches=m.mixed_dispatches,
         dispatches_per_iter=m.dispatches_per_iter,
         prefill_chunks=m.prefill_chunks,
         padded_token_frac=m.padded_token_frac, spec_mode=m.spec_mode,
         spec_k=m.spec_k, drafted_tokens=m.drafted_tokens,
         accepted_tokens=m.accepted_tokens,
         acceptance_rate=m.acceptance_rate,
         tokens_per_forward=m.tokens_per_forward, draft_calls=drafts,
         prefix_hits=m.prefix_hits, cow_copies=m.cow_copies,
         prefix_matched_tokens=m.prefix_matched_tokens,
         scheduler=m.scheduler, host_syncs=m.host_syncs,
         prefill_tokens=m.prefill_tokens, prefill_padded=m.prefill_padded,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         kv_pool_bytes=m.kv_pool_bytes,
         kv_bytes_per_token=m.kv_bytes_per_token,
         weight_bytes=m.weight_bytes,
         weight_bytes_saved=m.weight_bytes_saved, launches=launches,
         peak_pages_in_use=m.peak_pages_in_use,
         preemptions=m.preemptions, resumed=m.resumed,
         offloaded_pages=m.offloaded_pages, restored_pages=m.restored_pages,
         host_bytes_peak=m.host_bytes_peak,
         admission_stalls=m.admission_stalls, outcomes=m.outcome_counts,
         pool_dtype=pool_dtype, warnings=said)
    checks = {"all requests completed with in-vocab tokens": out_ok}
    checks.update({f"warned: {w}": any(w in x for x in said)
                   for w in expect_warnings})
    checks[f"paged pools at {sorted(set(want))} as requested"] = (
        pools == want)
    checks.update(_launch_checks(
        mode, m, launches, cfg, q8, weights_dtype, drafts,
        eng.weight_stats["n_quantized"] if prune_maps is not None
        else mm_per_forward))
    if tracer is not None:
        checks.update(_trace_checks(tracer, m, f"{arch}_{label}"))
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"{arch} {label} serve ({kv_dtype}, "
                         f"{weights_dtype}) failed: {failed}")
    busy = None
    if profile:
        del eng
        if traced:
            serve_kw["trace"] = TR.ServeTracer()
        busy = phase_profile(engine(), requests(16, 32), wall, arch,
                             kv_dtype, weights_dtype, label, serve_kw)
    return m, launches, [r.result for r in done], wall, busy


@functools.lru_cache(maxsize=None)
def _smoke_texts():
    """The texts the smoke prompts were tokenized from (the paper's path
    tokenizes in its pipeline)."""
    from repro_torch.data.pipeline import synthetic_corpus
    return tuple(synthetic_corpus(16, seed=7, min_len=4, max_len=40))


def _forwards_nocache(eng, results, max_new):
    """Full forwards of the no-cache runs of ``run_sequential``: per
    batch (the pipeline's ``DynamicBatcher`` grouping over the engine's
    buckets, recomputed), ``max_new`` unless every row met EOS earlier
    (the loop stops one step after the last row's EOS)."""
    from repro_torch.core.scheduler import DynamicBatcher, Request
    tok = _smoke_tokenizer()
    batcher = DynamicBatcher(max_batch=eng.max_batch,
                             buckets=eng.prompt_buckets())
    for uid, text in enumerate(_smoke_texts()):
        batcher.add(Request(uid=uid, tokens=tok.encode(text)))
    n_out = {r.uid: len(r.token_ids) for r in results}
    total = 0
    while (batch := batcher.next_batch()) is not None:
        longest = max(n_out[r.uid] for r in batch.requests)
        total += max_new if longest == max_new else longest + 1
    return total


def _greedy_streams(cfg, params, mode="bucketed"):
    """The greedy streams of the smoke's 16 prompts x 32 new tokens served
    at bf16 in ``mode``, with no gate and no launch count: the base that
    a cut model's dense runs are matched against."""
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.precision import BF16
    from repro_torch.core.scheduler import Request
    done, _ = InferenceEngine(cfg, params, policy=BF16, max_batch=8,
                              max_len=256, device="cuda").serve_continuous(
        [Request(uid=i, tokens=list(t), max_new_tokens=32)
         for i, t in enumerate(_smoke_prompts())], **_serve_kw(mode))
    return [r.result for r in done]


def phase_dense(arch, params, label, *, policy="bf16", pipelined=True,
                use_kv_cache=True, max_new=32, cfg=None, prune_maps=None,
                base=None):
    """Full-width ``arch`` through the paper's own serving path: the
    smoke's 16 texts tokenized and batched by length bucket
    (``DynamicBatcher``, 8 rows, max_len 256), each batch prefilled into a
    dense KV cache and decoded (or, without the cache, re-run in full for
    every token), through ``run_pipelined`` or ``run_sequential``.  Gates:
    every request served with in-vocabulary ids; flash launched layers x
    prefill dispatches (or layers x full forwards without the cache), the
    dense ``decode_attention`` layers x decode steps (but an MLA layer,
    whose absorbed decode is plain torch), no paged kernel.
    Prints tokens/s, decode tokens/s (engine stats), the greedy match
    against ``base`` (the packed serve's streams of the same prompts) and
    then the profile.  Returns (launch counts, streams)."""
    import torch
    from repro_torch.configs.base import MLA, layer_specs
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.pipeline import run_pipelined, run_sequential
    from repro_torch.core.precision import get_policy
    from repro_torch.kernels import ops
    cfg = cfg or get_config(arch)
    runner = run_pipelined if pipelined else run_sequential
    tok, texts = _smoke_tokenizer(), list(_smoke_texts())

    def engine():
        return InferenceEngine(cfg, params, policy=get_policy(policy),
                               max_batch=8, max_len=256,
                               use_kv_cache=use_kv_cache, device="cuda",
                               prune_maps=prune_maps)

    def run(eng, n=16, new=max_new):
        return runner(texts[:n], tok, eng, max_new_tokens=new,
                      max_batch=eng.max_batch)

    run(engine(), 4, 4)                                  # warm-up
    eng = engine()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = run(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    st = eng.stats
    streams = [r.token_ids for r in results]
    n_layers = cfg.num_layers
    prefills = st.batches if use_kv_cache else 0
    steps = st.batches * (max_new - 1) if use_kv_cache else 0
    forwards = 0 if use_kv_cache else _forwards_nocache(eng, results,
                                                        max_new)
    keep = set(prune_maps.keep_ids.tolist()) if prune_maps is not None \
        else range(cfg.vocab_size)
    match = None
    if base is not None:
        n = max(sum(min(len(a), len(b)) for a, b in zip(base, streams)), 1)
        match = sum(x == y for a, b in zip(base, streams)
                    for x, y in zip(a, b)) / n
    emit("serve", arch=cfg.name, layers=n_layers, policy=policy,
         mode=label, pipelined=pipelined, use_kv_cache=use_kv_cache,
         requests=len(results), generated_tokens=st.generated_tokens,
         wall_s=wall, tokens_per_s=st.generated_tokens / wall,
         decode_tok_per_s=st.generated_tokens / st.decode_s
         if st.decode_s else None, prefill_s=st.prefill_s,
         decode_s=st.decode_s, nocache_s=st.nocache_s, batches=st.batches,
         decode_steps=steps, full_forwards=forwards,
         greedy_match_packed=match,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         launches=launches)
    dense = {"flash_attention": n_layers * (prefills + forwards),
             "decode_attention": steps * sum(s.mixer != MLA
                                             for s in layer_specs(cfg))}
    checks = {
        "16 requests with in-vocabulary ids": len(results) == 16 and all(
            t in keep for s in streams for t in s) and st.generated_tokens
        == sum(map(len, streams)) > 0,
        f"flash ran {n_layers} x (prefills {prefills} + full forwards "
        f"{forwards})": launches["flash_attention"]
        == dense["flash_attention"] > 0,
        f"dense decode_attention ran {dense['decode_attention']} times "
        f"({steps} decode steps)": (
            launches["decode_attention"] == dense["decode_attention"]),
        "no other attention kernel ran": all(
            n == 0 for k, n in launches.items()
            if k not in dense and k != "quant_matmul"),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"{arch} {label} dense serve failed: {failed}")
    del eng
    phase_profile(None, None, wall, arch, policy, "auto", label,
                  run=lambda: run(engine()))
    return launches, streams


def _trace_checks(tracer, m, name):
    """Export a serve's trace into ``build/`` (JSONL and Perfetto) and
    check it: the JSONL validates, nothing was dropped, the device spans
    sum to ``metrics.device_s`` (1e-9 relative: the same clock reads feed
    both) and every request's lifecycle closes."""
    from repro_torch.core import trace as TR
    out = ROOT / "build" / f"trace_{name}.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    paths = TR.export(tracer, str(out), "both")
    n, errs = TR.validate_jsonl(paths[0])
    spans = sum(e["dur"] for e in tracer.iter_events("span")
                if e["track"] == "device")
    kinds = {}
    for e in tracer.events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    emit("trace", name=name, events=n, dropped=tracer.dropped,
         errors=errs[:5], kinds=kinds, device_span_s=spans,
         device_s=m.device_s, files=[Path(p).name for p in paths],
         bytes=[Path(p).stat().st_size for p in paths])
    uids = {e["uid"] for e in tracer.iter_events("enqueue")}
    return {"trace JSONL validates": not errs and n > 0,
            "no trace event dropped": tracer.dropped == 0,
            "device spans sum to metrics.device_s": abs(
                spans - m.device_s) <= 1e-9 * max(m.device_s, 1.0),
            "every enqueued request retired in the trace": uids == {
                e["uid"] for e in tracer.iter_events("retire")}}


def phase_profile(eng, reqs, wall, arch, kv_dtype, weights_dtype, mode,
                  serve_kw=None, run=None):
    """The same serve once more, on a fresh engine, under torch.profiler
    (``run`` instead of ``eng.serve_continuous(reqs)`` when given): device
    time by kernel, and the device's busy share of the measured
    (unprofiled) wall time.  Returns the device busy seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # device activity only: the host-side events of ~10^5 launches would
    # cost minutes to collect and are not read
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if run is not None:
            run()
        else:
            eng.serve_continuous(reqs, **(_serve_kw(mode) if serve_kw is None
                                          else serve_kw))
        torch.cuda.synchronize()
    # the profiler's raw device records: building its Python event list
    # for 10^5-10^6 launches takes minutes, reading the records seconds
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            us, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    busy_s = sum(us for us, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    ours = {}
    redesigned = {}
    for name in ("paged_decode_kernel", "paged_decode_mma_kernel",
                 "paged_packed_kernel", "paged_packed_mma_kernel",
                 "paged_mixed_kernel", "paged_mixed_mma_kernel",
                 "flash_mma_kernel",
                 "dense_decode_kernel", "dense_decode_mma_kernel",
                 "quant_matmul_kernel", "quant_matmul_reduce_kernel",
                 "quant_matmul_mma_decode_kernel",
                 "quant_matmul_mma_tiled_kernel", "mlstm_chunk_kernel",
                 "mlstm_chunk_mma_kernel", "ragged_mm_kernel",
                 "ragged_dw_kernel", "ragged_mm_tma_kernel",
                 "ragged_dw_tma_kernel"):
        for k, (us, n) in by_name.items():
            if name + "<" in k or k.endswith(name) or name + "(" in k:
                ours[k[:90]] = {"ms": us / 1e3, "count": n,
                                "busy_frac": us / 1e6 / busy_s}
                if name in REDESIGNED.values():
                    redesigned[name] = redesigned.get(name, 0.0) + us / 1e3
    # the redesigned kernels' total device time beside the busy time
    emit("profile", arch=arch, mode=mode, kv_dtype=kv_dtype,
         weights_dtype=weights_dtype, device_busy_s=busy_s,
         redesigned_kernels_ms=redesigned,
         measured_wall_s=wall, device_idle_frac=max(0.0, 1.0 - busy_s / wall),
         kernels_launched=sum(n for _, n in by_name.values()),
         port_kernels=ours, port_kernels_busy_frac=sum(
             v["busy_frac"] for v in ours.values()),
         top=[{"kernel": k[:90], "ms": us / 1e3, "count": n}
              for k, (us, n) in top])
    return busy_s


# the depth of qwen3-4b's secondary serves (of its 36 layers): only the
# packed bf16 and int8 serves, whose byte checks are exact full-width
# figures, stay at full depth
QWEN3_CUT_LAYERS = 12


def _cut(cfg, params, layers):
    """``cfg`` and its ``params`` cut to their first ``layers`` layers, the
    first stack's pattern repeated (full width; the tensors are
    shared)."""
    from repro_torch.configs.base import patterned_stacks
    return (cfg.replace(stacks=patterned_stacks(layers,
                                                cfg.stacks[0].pattern)),
            {**params, "layers": params["layers"][:layers]})


def _depth(label, cfg, of):
    """A serve's label with the depth it runs at, where cut."""
    return label if cfg.num_layers == of \
        else f"{label}, {cfg.num_layers} of {of} layers"


def phase_serves():
    """The unimo-text serve, then qwen3-4b at bf16 and at int8 KV + int8
    weights, each with its profile, and the exact byte checks of the two
    qwen3-4b runs.  Then, at QWEN3_CUT_LAYERS of qwen3-4b's 36 layers
    (full width; beside a packed bf16 and an int8 / int8 serve of the cut
    model, their streams and peak pages the base of the comparisons):
    speculative (n-gram) at bf16 and at int8, ``packed=False`` at bf16;
    the paper's own path (pipelined and sequential over the dense KV
    cache, the no-cache baseline) and its bucketed admission behind a
    pinned 32-token prefix (bf16, int8 KV + int8 weights); the contended
    serves; the n-gram serve again, traced.  Then unimo-text
    self-drafting and pruned; last unimo-text as the paper serves it
    (fp16, pruned, pipelined over the dense cache).  Returns the launch
    counts of each
    kernel's main-path run: the qwen3-4b bf16 run's for kernels 1-2, its
    int8 run's for the ``_q8`` kernels and ``quant_matmul``, the
    speculative runs' for the mixed pair and the pipelined dense run's for
    flash and the dense decode kernel."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.precision import BF16
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    unimo = T.init_params(gen, get_config("unimo-text"), BF16)
    _, _, s_unimo, _, _ = phase_serve("unimo-text", unimo, profile=True)
    gen.manual_seed(0)
    params = T.init_params(gen, get_config("qwen3-4b"), BF16)
    m16, l16, s16, _, _ = phase_serve("qwen3-4b", params, profile=True)
    m8, l8, s8, _, _ = phase_serve("qwen3-4b", params, kv_dtype="int8",
                                   weights_dtype="int8", profile=True)
    same = sum(a == b for x, y in zip(s16, s8) for a, b in zip(x, y))
    checks = {
        "int8 weight_bytes == 4,027,303,424": m8.weight_bytes == 4027303424,
        "bf16 weight_bytes == 8,044,544,000": m16.weight_bytes == 8044544000,
        "int8 kv_bytes_per_token == 76,176": m8.kv_bytes_per_token == 76176,
        "bf16 kv_bytes_per_token == 147,600": m16.kv_bytes_per_token
        == 147600,
    }
    emit("qwen3_int8_vs_bf16", weight_bytes_ratio=m8.weight_bytes
         / m16.weight_bytes, kv_bytes_per_token_ratio=m8.kv_bytes_per_token
         / m16.kv_bytes_per_token, greedy_token_match=same / max(
             sum(len(x) for x in s16), 1), checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"qwen3-4b byte checks failed: {failed}")
    # the secondary serves at QWEN3_CUT_LAYERS layers, beside the cut
    # model's own packed serves
    cut, pc = _cut(get_config("qwen3-4b"), params, QWEN3_CUT_LAYERS)

    def lab(label):
        return _depth(label, cut, 36)
    mc16, _, sc16, _, _ = phase_serve("qwen3-4b", pc, cfg=cut,
                                      label=lab("packed"))
    mc8, _, sc8, _, _ = phase_serve("qwen3-4b", pc, cfg=cut,
                                    kv_dtype="int8", weights_dtype="int8",
                                    label=lab("packed"))
    _, la, sa, wall_ng, busy_ng = phase_serve(
        "qwen3-4b", pc, cfg=cut, mode="spec_ngram", profile=True,
        label=lab("spec_ngram"))
    _, lb, _, _, _ = phase_serve("qwen3-4b", pc, cfg=cut, kv_dtype="int8",
                                 weights_dtype="int8", mode="spec_ngram",
                                 profile=True, label=lab("spec_ngram"))
    _, _, sc, _, _ = phase_serve("qwen3-4b", pc, cfg=cut, mode="packed_off",
                                 profile=True, label=lab("packed_off"))
    # the paper's own path: bucket batches over a dense KV cache,
    # sequentially, then through the pipeline, and the no-cache baseline
    phase_dense("qwen3-4b", pc, lab("sequential"), pipelined=False,
                base=sc16, cfg=cut)
    l_dense, _ = phase_dense("qwen3-4b", pc, lab("pipelined"), base=sc16,
                             cfg=cut)
    phase_dense("qwen3-4b", pc, lab("nocache"), pipelined=False,
                use_kv_cache=False, max_new=8, base=sc16, cfg=cut)
    # bucketed admission behind a 32-token system prompt pinned by
    # set_prefix, beside the packed serve of the same requests
    prefix = _system_prompt()
    _, _, spp, _, _ = phase_serve("qwen3-4b", pc, cfg=cut, prefix=prefix,
                                  label=lab("packed_prefix"))
    _, _, sb16, _, _ = phase_serve("qwen3-4b", pc, cfg=cut,
                                   mode="bucketed", prefix=prefix,
                                   profile=True,
                                   label=lab("bucketed_prefix"))
    _, _, sb8, _, _ = phase_serve("qwen3-4b", pc, cfg=cut, kv_dtype="int8",
                                  weights_dtype="int8", mode="bucketed",
                                  prefix=prefix, profile=True,
                                  label=lab("bucketed_prefix"))
    n_pp = max(sum(len(x) for x in spp), 1)
    emit("qwen3_bucketed_vs_packed", layers=cut.num_layers,
         prefix_tokens=len(prefix),
         bf16=sum(a == b for x, y in zip(spp, sb16) for a, b in zip(x, y))
         / n_pp,
         int8_kv_int8_weights=sum(a == b for x, y in zip(spp, sb8)
                                  for a, b in zip(x, y)) / n_pp)
    # overload: a contended pool at bf16 and at int8 KV + int8 weights
    phase_contended(pc, cut, mc16, sc16, "auto", "auto")
    phase_contended(pc, cut, mc8, sc8, "int8", "int8")
    # tracing: the n-gram serve again, with a ServeTracer
    _, _, st, wall_t, busy_t = phase_serve(
        "qwen3-4b", pc, cfg=cut, mode="spec_ngram", profile=True,
        traced=True, label=lab("spec_ngram_traced"))
    del pc
    n_ng = max(sum(len(x) for x in sa), 1)
    emit("tracing_cost", traced_wall_s=wall_t, untraced_wall_s=wall_ng,
         wall_ratio=wall_t / wall_ng, traced_busy_s=busy_t,
         untraced_busy_s=busy_ng,
         greedy_match_untraced=sum(a == b for x, y in zip(sa, st)
                                   for a, b in zip(x, y)) / n_ng)
    del params
    phase_serve("unimo-text", unimo, mode="spec_draft", profile=True)
    # the paper's embedding-layer pruning, as the serve CLI applies it
    phase_pruned(unimo)
    # unimo-text as the paper serves it: fp16, the vocabulary pruned to
    # coverage 0.999, pipelined over the dense KV cache
    from repro_torch.core import pruning as PR
    p2, cfg2, maps = PR.prune_model(unimo, get_config("unimo-text"),
                                    dict(_smoke_freqs()),
                                    coverage=PRUNE_COVERAGE)
    phase_dense("unimo-text", p2, "paper_fp16_pruned", policy="fp16",
                cfg=cfg2, prune_maps=maps, base=s_unimo)
    # bf16 matmuls over 5-token windows and 1-token steps round
    # differently: recorded, not gated (the fp32 parity phase gates them)
    n16 = max(sum(len(x) for x in sc16), 1)
    emit("qwen3_bf16_stream_agreement", layers=cut.num_layers,
         spec_ngram_vs_packed=sum(a == b for x, y in zip(sc16, sa)
                                  for a, b in zip(x, y)) / n16,
         packed_off_vs_packed=sum(a == b for x, y in zip(sc16, sc)
                                  for a, b in zip(x, y)) / n16)
    return {**{k: l16[k] for k in ("paged_decode_attention",
                                   "paged_packed_attention")},
            **{k: l8[k] for k in ("paged_decode_attention_q8",
                                  "paged_packed_attention_q8",
                                  "quant_matmul")},
            "paged_mixed_attention": la["paged_mixed_attention"],
            "paged_mixed_attention_q8": lb["paged_mixed_attention_q8"],
            **{k: l_dense[k] for k in ("flash_attention",
                                       "decode_attention")}}


def offload_restore_cost(cfg, kv_dtype, num_pages, n_pages, reps=10):
    """``offload_pages`` and ``restore_pages`` on a full-width pool of
    ``num_pages`` pages filled with random bytes: ``n_pages`` pages out to
    pinned host memory and back into other pages, which must then hold
    the same bytes in every leaf.  Median host-clock times (each call
    ends synchronized: offload waits on its copies' event, restore is
    followed by a synchronize) per page, and the blob's bytes per page."""
    import torch
    from repro_torch.core import kv_cache as KV
    from repro_torch.models import transformer as T
    cache = T.init_paged_cache(cfg, num_pages=num_pages, page_size=16,
                               dtype=torch.bfloat16, kv_dtype=kv_dtype,
                               max_slots=8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    for c in cache["layers"]:
        for k, t in c.items():
            if t.dtype in (torch.int8, torch.int32):
                t.copy_(torch.randint(-100, 100, t.shape, generator=gen,
                                      device="cuda"))
            else:
                t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    src = list(range(n_pages))
    dst = list(range(n_pages, 2 * n_pages))
    want = [{k: t[src].clone() for k, t in c.items()}
            for c in cache["layers"]]
    t_off, t_res = [], []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = KV.offload_pages(cache, src)
        t1 = time.perf_counter()
        KV.restore_pages(cache, blob, dst)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        t_off.append(t1 - t0)
        t_res.append(t2 - t1)
    same = all(torch.equal(c[k][dst], w[k]) for c, w in
               zip(cache["layers"], want) for k in w)
    return {"n_pages": n_pages,
            "offload_ms_per_page": statistics.median(t_off[2:]) * 1e3
            / n_pages,
            "restore_ms_per_page": statistics.median(t_res[2:]) * 1e3
            / n_pages,
            "bytes_per_page": KV.blob_bytes(blob) // n_pages,
            "round_trip_bit_identical": same}


def phase_contended(params, cfg, base_m, base_streams, kv_dtype,
                    weights_dtype):
    """qwen3-4b (``cfg``: full width, cut in depth) on a contended pool:
    the smoke's 16 requests x
    32 new tokens and 8 slots, a pool of a third of the uncontended
    serve's peak pages (at least the longest request's), ``preemption=
    "lru"``, a host tier that holds every snapshot and the per-iteration
    audit.  It must preempt, resume every preempted request and complete
    every request, with the launch counts of a packed serve; the greedy
    match against the uncontended serve is recorded (bf16 kernels choose
    their bodies and splits by batch shape, so it is not gated).  Then
    the cost of an offload and a restore per page on this pool."""
    from repro_torch.core.scheduler import TERMINAL_STATUSES
    longest = max(-(-(len(p) + 32) // 16) for p in _smoke_prompts())
    pool = max(-(-base_m.peak_pages_in_use // CONTENDED_POOL_DIV), longest)
    extra = dict(num_pages=pool, preemption="lru",
                 host_kv_bytes=HOST_KV_BYTES, debug_audit=True)
    m, _, streams, wall, busy = phase_serve(
        "qwen3-4b", params, cfg=cfg, kv_dtype=kv_dtype,
        weights_dtype=weights_dtype, profile=True, extra=extra,
        label=_depth("contended", cfg, 36))
    n = max(sum(len(x) for x in base_streams), 1)
    cost = [offload_restore_cost(cfg, kv_dtype, pool, k)
            for k in (1, longest)]
    checks = {
        "preempted at least once": m.preemptions >= 1,
        "every preempted request resumed": m.resumed == m.preemptions,
        "restored from the host tier": m.restored_pages > 0,
        "every request in a terminal status": (
            sum(m.outcome_counts.get(k, 0) for k in TERMINAL_STATUSES)
            == 16),
        "offload/restore round trip bit-identical": all(
            c["round_trip_bit_identical"] for c in cost),
    }
    emit("contended", layers=cfg.num_layers, kv_dtype=kv_dtype,
         weights_dtype=weights_dtype, pool_pages=pool, uncontended_peak_pages=base_m.peak_pages_in_use,
         pool_frac=pool / base_m.peak_pages_in_use,
         longest_request_pages=longest, host_kv_bytes=HOST_KV_BYTES,
         preemptions=m.preemptions, resumed=m.resumed,
         offloaded_pages=m.offloaded_pages, restored_pages=m.restored_pages,
         host_bytes_peak=m.host_bytes_peak,
         admission_stalls=m.admission_stalls, wall_s=wall,
         device_busy_s=busy,
         greedy_match_uncontended=sum(
             a == b for x, y in zip(base_streams, streams)
             for a, b in zip(x, y)) / n, offload_restore=cost,
         checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"qwen3-4b contended serve ({kv_dtype}, "
                         f"{weights_dtype}) failed: {failed}")


def phase_pruned(unimo):
    """Full-width unimo-text pruned as the serve CLI prunes it
    (``--prune-coverage 0.999`` on the smoke's corpus) with the learned
    position table trimmed to the serve's max_len, at int8 weights: its
    tied head runs ``quant_matmul`` at N = V_new.  The serve must complete
    every request with tokens of the original id space (unmapped), with
    the launch counts of a packed serve."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import pruning as PR
    cfg = get_config("unimo-text")
    p2, cfg2, maps = PR.prune_model(unimo, cfg, dict(_smoke_freqs()),
                                    coverage=PRUNE_COVERAGE, new_max_len=256)

    def embed_bytes(p):
        return sum(t.numel() * t.element_size()
                   for t in p["embed"].values())
    longest = max(len(p) for p in _smoke_prompts()) + 32
    m, _, streams, _, _ = phase_serve(
        "unimo-text", p2, cfg=cfg2, weights_dtype="int8", prune_maps=maps,
        profile=True, label="pruned")
    emit("pruned", arch=cfg.name, coverage=PRUNE_COVERAGE,
         vocab_before=cfg.vocab_size, vocab_after=cfg2.vocab_size,
         pos_rows_before=cfg.max_seq_len, pos_rows_after=cfg2.max_seq_len,
         embed_bytes_before=embed_bytes(unimo), embed_bytes_after=embed_bytes(
             p2), longest_context=longest, weight_bytes=m.weight_bytes,
         tokens_outside_kept_ids=sum(
             t not in set(maps.keep_ids.tolist()) for r in streams
             for t in r))
    if cfg2.vocab_size != _pruned_unimo_vocab() or longest > 256:
        raise SystemExit("pruned unimo-text: V_new or the trimmed table "
                         "does not match the kernel cases' shapes")


def phase_serve_xlstm():
    """Full-width xlstm-125m (12 layers, bf16, random weights from a
    seeded torch.Generator) through ``serve_continuous``'s bucketed
    admission path: 16 requests x 32 new tokens, 8 slots, max_len 512,
    12 of the smoke prompts and 4 prompts of 150-300 tokens (so the mLSTM
    kernel carries state across its chunks inside the serve).  Gates:
    16/16 admitted and retired, no padded prefill token, the mLSTM kernel
    launched 6 x the admission dispatches and no other kernel launched;
    then the profile.  Returns the run's launch counts."""
    import torch
    from repro_torch.configs.base import MLSTM, layer_specs
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.precision import BF16
    from repro_torch.core.scheduler import Request
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    cfg = get_config("xlstm-125m")
    n_mlstm = sum(s.mixer == MLSTM for s in layer_specs(cfg))    # 6 of 12
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(gen, cfg, BF16)
    rng = np.random.default_rng(9)
    long = [[2] + [int(t) for t in rng.integers(4, 4000, size=n)]
            for n in (150, 211, 257, 299)]
    prompts = [list(p) for p in _smoke_prompts()[:12]] + long
    steps_per_sync = 4

    def requests(n, max_new):
        return [Request(uid=i, tokens=list(p), max_new_tokens=max_new)
                for i, p in enumerate(prompts[:n])]

    def engine():
        return InferenceEngine(cfg, params, policy=BF16, max_batch=8,
                               max_len=512, device="cuda")

    engine().serve_continuous(requests(4, 4))            # warm-up
    eng = engine()
    reqs = requests(16, 32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done, m = eng.serve_continuous(reqs, steps_per_sync=steps_per_sync)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    decode_dispatches = m.steps // steps_per_sync
    admissions = m.host_syncs - decode_dispatches
    emit("serve", arch=cfg.name, layers=cfg.num_layers, policy="bf16",
         mode="bucketed", requests=len(done),
         generated_tokens=m.generated_tokens, wall_s=wall,
         tokens_per_s=m.generated_tokens / wall, ttft_p50_s=m.ttft_p50,
         ttft_p99_s=m.ttft_p99, itl_p50_s=m.itl_p50, itl_p99_s=m.itl_p99,
         host_frac=m.host_frac, host_s=m.host_s, device_s=m.device_s,
         scheduler=m.scheduler, steps=m.steps, host_syncs=m.host_syncs,
         admission_dispatches=admissions, prefill_tokens=m.prefill_tokens,
         prefill_padded=m.prefill_padded,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         kv_bytes_per_token=m.kv_bytes_per_token,
         weight_bytes=m.weight_bytes, launches=launches,
         outcomes=m.outcome_counts)
    checks = {
        "16/16 requests admitted and retired": (
            m.admitted == m.retired == len(done) == 16
            and m.outcome_counts == {"completed": 16}),
        "in-vocab tokens": all(0 <= t < cfg.vocab_size for r in done
                               for t in r.result),
        "prefill_padded == prefill_tokens": (
            m.prefill_padded == m.prefill_tokens > 0),
        f"mlstm_chunked ran {n_mlstm} x admission dispatches "
        f"({admissions})": (launches["mlstm_chunked"]
                            == n_mlstm * admissions > 0),
        "no other kernel ran": all(n == 0 for k, n in launches.items()
                                   if k != "mlstm_chunked"),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"xlstm-125m serve failed: {failed}")
    del eng
    phase_profile(engine(), requests(16, 32), wall, "xlstm-125m", "auto",
                  "auto", "bucketed")
    return launches


# ---------------------------------------------------------------------------
# phi3-mini-3.8b, gemma2-2b and gemma3-27b
# ---------------------------------------------------------------------------

FAMILIES = ("phi3-mini-3.8b", "gemma2-2b", "gemma3-27b")
# gemma3-27b at full width but 12 of its 62 layers: two of its 5:1
# local/global patterns (6.4 B parameters, 12.7 GB at bf16; 62 layers
# would be 54 GB of weights alone)
GEMMA3_LAYERS = 12
# the depth of the secondary serves: phi3-mini's int8, n-gram and
# packed=False (of 32 layers) and gemma2-2b's int8, pipelined and no-cache
# (of 26: five local / global pairs); the first serve of each, the sampled
# serves and gemma2's teacher-forced check run at full depth
PHI3_CUT_LAYERS, GEMMA2_CUT_LAYERS = 12, 10
# the full-width gemma2-2b teacher-forced check in fp32: decode logits
# through the dense ring against the full forward's logits at the same
# positions (fp32 sums in other orders over 26 layers; logits of order 1)
TEACHER_TOL = 1e-3
# a sampled serve's parameters and engine seed
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)


def _gemma3_cut():
    """gemma3-27b's published config at GEMMA3_LAYERS layers."""
    from repro_torch.configs.base import patterned_stacks
    from repro_torch.configs.registry import get_config
    cfg = get_config("gemma3-27b")
    return cfg.replace(stacks=patterned_stacks(GEMMA3_LAYERS,
                                               cfg.stacks[0].pattern))


def phase_parity_families():
    """Reduced phi3-mini, gemma2-2b and gemma3-27b (window 64), fp32 (TF32
    off), on the card and on the CPU: ``forward_train`` logits over 200
    tokens; ``serve_continuous`` of 8 requests of 20-200 tokens x 8 new at
    max_len 256 (packed for phi3, bucketed over ring pages for the
    gemmas, whose rings of 80 entries wrap); ``generate_batch`` with and
    without the KV cache over rows of 200, 130 and 40 tokens (dense rings
    of 64).  Streams and counters on the card must equal the CPU's, and
    KV == no-cache on both."""
    import torch
    from repro_torch.configs.registry import get_reduced
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.precision import FP32, map_params
    from repro_torch.core.scheduler import Request
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(21)
    lens = (70, 150, 20, 45, 200, 66, 100, 130)
    prompts = [[2] + [int(t) for t in rng.integers(4, 400, size=n - 1)]
               for n in lens]
    batch = rng.integers(4, 400, size=(3, 200)).astype(np.int32)
    blens = np.asarray([200, 130, 40], np.int32)
    for arch in FAMILIES:
        cfg = get_reduced(arch)
        params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
        out, logits = {}, {}
        for dev in ("cuda", "cpu"):
            with torch.no_grad():
                logits[dev] = T.forward_train(
                    map_params(lambda t: t.to(dev), params), cfg,
                    torch.as_tensor(batch[:1]).to(dev))[0].cpu()

            def engine(**kw):
                return InferenceEngine(cfg, params, policy=FP32,
                                       max_len=256, max_batch=4,
                                       device=dev, **kw)
            done, m = engine().serve_continuous(
                [Request(uid=i, tokens=list(p), max_new_tokens=8)
                 for i, p in enumerate(prompts)], page_size=16,
                max_batched_tokens=64)
            out[dev, "serve"] = [r.result for r in done]
            out[dev, "counters"] = [
                m.scheduler, m.admitted, m.retired, m.prefill_padded,
                m.host_syncs, m.steps, m.mixed_iters, m.generated_tokens,
                m.peak_pages_in_use]
            for kv in (True, False):
                out[dev, f"kv={kv}"] = engine(
                    use_kv_cache=kv).generate_batch(batch.copy(), blens,
                                                    8).tolist()
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        keys = sorted({k for _, k in out})
        card_eq_cpu = {k: out["cuda", k] == out["cpu", k] for k in keys}
        inner = {f"{dev}: kv == nocache": out[dev, "kv=True"]
                 == out[dev, "kv=False"] for dev in ("cuda", "cpu")}
        emit("parity_family", arch=arch, train_logits_max_abs_err=err,
             logits_tol=PARITY_TOL["auto"], card_equals_cpu=card_eq_cpu,
             invariants=inner, counters=out["cuda", "counters"],
             tokens=sum(map(len, out["cpu", "serve"])))
        failed = [k for k, v in {**card_eq_cpu, **inner}.items() if not v]
        if failed or not err <= PARITY_TOL["auto"]:
            raise SystemExit(f"{arch}: reduced parity failed: {failed}, "
                             f"train logits {err}")


def _long_prompts(targets=(1100, 1200, 1300, 1400)):
    """Prompts of ``targets`` tokens: synthetic-corpus texts concatenated
    and tokenized by the serves' tokenizer, each cut to its length."""
    from repro_torch.data.pipeline import synthetic_corpus
    tok = _smoke_tokenizer()
    out = []
    for i, n in enumerate(targets):
        ids = []
        for text in synthetic_corpus(400, seed=100 + i, min_len=20,
                                     max_len=60):
            ids += tok.encode(text)[1:] if ids else tok.encode(text)
            if len(ids) >= n:
                break
        out.append(ids[:n])
    return out


def phase_sampled(params, cfg, label, *, mode, policy):
    """One sampled serve (SAMPLED, a CUDA generator seeded 1) through
    ``mode``: "packed" or "bucketed" ``serve_continuous`` (16 requests x
    32 new tokens) or "dense" ``generate_batch`` (8 rows x 32).  Gates, as
    the CPU tests check sampling: every request completed with at most 32
    ids, all in the vocabulary, none the EOS id; the dense rows (8, 32)
    with -1 only after a row's last id."""
    import torch
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.sampling import SamplingParams
    from repro_torch.core.scheduler import Batch, Request, pad_batch
    from repro_torch.core.tokenizer import EOS
    sp = SamplingParams(**SAMPLED)
    eng = InferenceEngine(cfg, params, policy=policy, max_batch=8,
                          max_len=256, device="cuda", seed=1)
    prompts = [list(p) for p in _smoke_prompts()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if mode == "dense":
        reqs = [Request(uid=i, tokens=p) for i, p in enumerate(prompts[:8])]
        toks, lens = pad_batch(Batch(requests=reqs, padded_len=max(
            len(p) for p in prompts[:8])))
        out = eng.generate_batch(toks, lens, 32, sp)
        streams = [[int(t) for t in row if t >= 0] for row in out]
        shape_ok = out.shape == (8, 32) and all(
            (row[np.flatnonzero(row < 0)[0]:] == -1).all()
            if (row < 0).any() else True for row in out)
        completed = True
    else:
        done, m = eng.serve_continuous(
            [Request(uid=i, tokens=p, max_new_tokens=32)
             for i, p in enumerate(prompts)], sp,
            **({"chunked_prefill": False} if mode == "bucketed" else {}))
        streams = [r.result for r in done]
        shape_ok = len(done) == 16 and all(len(s) <= 32 for s in streams)
        completed = m.outcome_counts == {"completed": 16} and (
            m.scheduler == ("bucketed" if mode == "bucketed"
                            else "unified"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    checks = {
        "shape": bool(shape_ok), "completed": completed,
        "ids in the vocabulary": all(0 <= t < cfg.vocab_size
                                     for s in streams for t in s),
        "EOS never emitted": all(EOS not in s for s in streams),
        "tokens generated": sum(map(len, streams)) > 0}
    emit("sampled", arch=cfg.name, layers=cfg.num_layers, mode=mode,
         label=label, sampling=SAMPLED, seed=1, wall_s=wall,
         tokens=sum(map(len, streams)), checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"{cfg.name} sampled {mode} serve failed: "
                         f"{failed}")


def phase_long_serve(params, cfg):
    """A windowed model (bf16: gemma3-27b at GEMMA3_LAYERS layers, or
    hymba-1.5b) where its window of 1024 bites: 4 requests of 1100-1400
    prompt tokens x 32 new, 4 slots, max_len 2048, bucketed admission.
    The windowed layers' paged rings (1040 entries: 65 pages of 16) wrap
    during the prefill and the decode (hymba's Mamba branch runs 9-11
    chunks a prompt).  Records the greedy streams and the wall time;
    gates the completions and the bucketed path's launch counts."""
    import torch
    from repro_torch.core import kv_cache as KV
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.precision import BF16
    from repro_torch.core.scheduler import Request
    from repro_torch.kernels import ops
    from repro_torch.configs.base import layer_specs
    prompts = _long_prompts()
    window = max(s.window or 0 for s in layer_specs(cfg))
    ring = KV.paged_ring_len(window, 16, -(-2048 // 16))

    def serve(n, new):
        eng = InferenceEngine(cfg, params, policy=BF16, max_batch=4,
                              max_len=2048, device="cuda")
        return eng.serve_continuous(
            [Request(uid=i, tokens=list(p), max_new_tokens=new)
             for i, p in enumerate(prompts[:n])], chunked_prefill=False)
    serve(1, 2)                                          # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done, m = serve(4, 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    streams = [r.result for r in done]
    checks = {"prompts longer than the paged ring": min(map(len, prompts))
              > ring > window,
              "all 4 completed with in-vocab ids": m.outcome_counts
              == {"completed": 4} and all(0 <= t < cfg.vocab_size
                                          for s in streams for t in s)}
    checks.update(_launch_checks("bucketed", m, launches, cfg, "", "auto",
                                 0))
    emit("long_serve", arch=cfg.name, layers=cfg.num_layers,
         prompt_tokens=[len(p) for p in prompts], window=window,
         paged_ring_entries=ring, max_len=2048, wall_s=wall,
         generated_tokens=m.generated_tokens,
         tokens_per_s=m.generated_tokens / wall, ttft_p50_s=m.ttft_p50,
         itl_p50_s=m.itl_p50, host_syncs=m.host_syncs, steps=m.steps,
         prefill_padded=m.prefill_padded, launches=launches,
         streams=streams, checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"{cfg.name} long serve failed: {failed}")


def phase_teacher_forced(arch="gemma2-2b", n_prompt=4400, steps=16):
    """Full-width ``arch`` in fp32 (TF32 off; gemma2-2b: 10.5 GB of
    weights, a 4400-token prompt; hymba-1.5b: 6.4 GB, 1400 tokens): one
    prompt of ``n_prompt`` tokens prefilled into a dense cache at max_len
    n_prompt + ``steps`` (the windowed layers' ring holds fewer entries,
    so it wraps: gemma2's 4351 of 4416, hymba's 1279 of 1416), then
    ``steps`` decode steps through the rings fed the next tokens of the
    sequence; each step's logits must equal the full forward's
    (``forward_train`` over the whole sequence, flash with the window;
    hymba's Mamba branch chunkwise there, one recurrence step a token in
    decode) at the same position within TEACHER_TOL, as must the
    prefill's last logits, with the argmax equal."""
    import torch
    from repro_torch.configs.base import layer_specs
    from repro_torch.configs.registry import get_config
    from repro_torch.core.precision import FP32
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(gen, cfg, FP32)
    S = n_prompt + steps
    toks = torch.tensor([_long_prompts((S,))[0]], dtype=torch.int32,
                        device="cuda")
    t0 = time.perf_counter()
    with torch.no_grad():
        full = T.forward_train(params, cfg, toks, policy=FP32)[0][
            0, n_prompt - 1:].clone()
        cache = T.init_cache(cfg, 1, S, torch.float32, device="cuda")
        lp, _ = T.forward_prefill(
            params, cfg, toks[:, :n_prompt],
            torch.tensor([n_prompt], dtype=torch.int32, device="cuda"),
            cache, policy=FP32, max_len=S, last_only=True)
        got = [lp[0, 0]]
        for t in range(n_prompt, S):
            ld, _ = T.forward_decode(
                params, cfg, toks[:, t:t + 1], cache,
                torch.tensor([t], dtype=torch.int32, device="cuda"),
                policy=FP32, max_len=S)
            got.append(ld[0, 0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = torch.stack(got)
    diff = (got - full).abs()
    ring = min(c["pos"].shape[1] for c in cache["layers"]) - 1
    err = diff.max().item()
    argmax_equal = bool((got.argmax(1) == full.argmax(1)).all())
    emit("teacher_forced", arch=cfg.name, layers=cfg.num_layers,
         policy="fp32", prompt_tokens=n_prompt, decode_steps=steps,
         window=max(s.window or 0 for s in layer_specs(cfg)),
         dense_ring_entries=ring, max_abs_err=err,
         max_abs_err_by_step=diff.amax(1).tolist(),
         logits_max_abs=full.abs().max().item(), tol=TEACHER_TOL,
         argmax_equal=argmax_equal, wall_s=wall)
    if not (np.isfinite(err) and err <= TEACHER_TOL and ring < S
            and argmax_equal):
        raise SystemExit(f"{arch} teacher-forced ring check failed: max "
                         f"|diff| {err} (tol {TEACHER_TOL}), argmax equal "
                         f"{argmax_equal}, ring {ring} of {S} tokens")


def phase_serves_families():
    """phi3-mini-3.8b, gemma2-2b and gemma3-27b at full width, random
    weights from a seeded torch.Generator, bf16: phi3-mini-3.8b (32
    layers) packed, then at PHI3_CUT_LAYERS layers at int8 KV + int8
    weights (its untied head through ``quant_matmul``), with n-gram
    speculation and ``packed=False``; gemma2-2b (26 layers) bucketed over
    ring pages at bf16, then at GEMMA2_CUT_LAYERS layers at int8 / int8,
    ``run_pipelined`` over the dense ring cache and the no-cache baseline;
    gemma3-27b at
    GEMMA3_LAYERS layers, bucketed, then its long serve past the window.
    Each with its launch gates and profile; one sampled serve per path
    (packed phi3, bucketed and dense gemma2).  Then the gemma2-2b fp32
    teacher-forced check.  Returns each serve's launch counts by
    label."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.precision import BF16
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda")
    seen = {}
    gen.manual_seed(0)
    cfg = get_config("phi3-mini-3.8b")
    params = T.init_params(gen, cfg, BF16)
    _, seen["phi3 packed"], _, _, _ = phase_serve(cfg.name, params,
                                                  profile=True)
    cut, pc = _cut(cfg, params, PHI3_CUT_LAYERS)
    for label, kw in (("packed int8", dict(
            kv_dtype="int8", weights_dtype="int8")),
            ("spec_ngram", dict(mode="spec_ngram")),
            ("packed_off", dict(mode="packed_off"))):
        _, seen[f"phi3 {label}"], _, _, _ = phase_serve(
            cfg.name, pc, cfg=cut, profile=True,
            label=_depth(label, cut, 32), **kw)
    del pc
    phase_sampled(params, cfg, "phi3 packed", mode="packed", policy=BF16)
    del params
    gen.manual_seed(0)
    cfg = get_config("gemma2-2b")
    params = T.init_params(gen, cfg, BF16)
    _, seen["gemma2 bucketed"], _, _, _ = phase_serve(
        cfg.name, params, mode="bucketed", profile=True)
    cut, pc = _cut(cfg, params, GEMMA2_CUT_LAYERS)
    _, seen["gemma2 bucketed int8"], _, _, _ = phase_serve(
        cfg.name, pc, cfg=cut, kv_dtype="int8", weights_dtype="int8",
        mode="bucketed", profile=True,
        label=_depth("bucketed int8", cut, 26))
    base = _greedy_streams(cut, pc)
    seen["gemma2 pipelined"], _ = phase_dense(
        cfg.name, pc, _depth("pipelined", cut, 26), cfg=cut, base=base)
    seen["gemma2 nocache"], _ = phase_dense(
        cfg.name, pc, _depth("nocache", cut, 26), cfg=cut, pipelined=False,
        use_kv_cache=False, max_new=8, base=base)
    del pc
    phase_sampled(params, cfg, "gemma2 bucketed", mode="bucketed",
                  policy=BF16)
    phase_sampled(params, cfg, "gemma2 dense", mode="dense", policy=BF16)
    del params
    gen.manual_seed(0)
    cfg = _gemma3_cut()
    params = T.init_params(gen, cfg, BF16)
    _, seen["gemma3 bucketed"], _, _, _ = phase_serve(
        "gemma3-27b", params, cfg=cfg, mode="bucketed", profile=True)
    phase_long_serve(params, cfg)
    del params
    torch.cuda.empty_cache()
    phase_teacher_forced()
    torch.cuda.empty_cache()
    return seen


# ---------------------------------------------------------------------------
# qwen3-moe-235b-a22b, internvl2-1b and musicgen-medium
# ---------------------------------------------------------------------------

MOE_ARCH, VLM_ARCH, AUDIO_ARCH = ("qwen3-moe-235b-a22b", "internvl2-1b",
                                  "musicgen-medium")
# qwen3-moe at full width but 8 of its 94 layers: one layer is 2.49 B
# parameters (2.42 B of them the 128 experts), 4.98 GB at bf16; 8 layers
# with the embedding and the untied head 21.2 B, 42.3 GB (94 would be
# 468 GB)
MOE_LAYERS = 8
# the depth of qwen3-moe's int8 and pipelined serves
MOE_CUT_LAYERS = 4
# the forward-level runs: 8 rows of internvl2's 256 prefix embeddings + 64
# text tokens, or musicgen's 64 steps x 4 codebooks, then greedy decode
MM_ROWS, MM_TEXT, MM_DECODE = 8, 64, 32
# the fp32 teacher-forced checks: decode steps after the prefill
MM_TEACHER_STEPS = 16


def moe_mm_kernel_cases(rng):
    """The kernels at the heads of qwen3-moe (64 / 4 x 128: g = 16, a
    decode lane fills a 16-row warp and a 5-lane verify window two 64-row
    tiles), internvl2-1b (14 / 2 x 64: g = 7, which divides neither a warp,
    a 64-row tile nor the dense body's 8-head block) and musicgen-medium
    (24 / 24 x 64), each against its plain version: the decode, mixed and
    dense decode at qwen3-moe's heads and flash at its exact-length
    admissions (1 x 77, 8 x 78), ``quant_matmul`` at its untied head and
    attention projections (M = 8); the packed and decode pairs, dense
    decode over ``generate_batch``'s cache (max_len 352: 512 rows) and
    flash over 256 prefix embeddings + 64 text tokens at internvl2's; flash
    over 8 x 64 steps and dense decode over the 97-row cache of max_len 96
    at musicgen's.  bf16 cases on a path are timed; fp32 (the CUDA-core
    bodies; flash's split body, also against fp64) and int8 pools off any
    serve check values only."""
    import torch
    bf16, fp32 = torch.bfloat16, torch.float32
    moe = dict(Hq=64, Hkv=4, D=128)
    vlm = dict(Hq=14, Hkv=2, D=64)
    audio = dict(Hq=24, Hkv=24, D=64)
    ctx = [int(x) for x in torch.randint(0, 256 - SPEC_K, (8,),
                                         generator=rng, device="cuda")]
    verify = dict(W=SPEC_K + 1, n_q=[SPEC_K + 1] * 8, before=ctx)
    cases = []
    for quant in (False, True):
        q8 = " int8 pool," if quant else ""
        cases.append(run_decode_case(rng, f"qwen3-moe{q8} bf16", dtype=bf16,
                                     quant=quant, timed=True, **moe))
        cases.append(run_decode_case(rng, f"qwen3-moe{q8} fp32", dtype=fp32,
                                     quant=quant, **moe))
        cases.append(run_mixed_case(rng, f"qwen3-moe verify{q8} bf16 q",
                                    dtype=bf16, quant=quant, timed=True,
                                    **verify, **moe))
        cases.append(run_mixed_case(rng, f"qwen3-moe ragged rows{q8} fp32 q",
                                    dtype=fp32, quant=quant, W=24,
                                    n_q=[24, 0, 17, 1],
                                    before=[3, 0, 100, 40], **moe))
        for run in (run_packed_case, run_decode_case):
            cases.append(run(rng, f"internvl2-1b{q8} bf16", dtype=bf16,
                             quant=quant, timed=not quant, **vlm))
            cases.append(run(rng, f"internvl2-1b{q8} fp32", dtype=fp32,
                             quant=quant, **vlm))
    for dtype in (bf16, fp32):
        dn = str(dtype).removeprefix("torch.")
        timed = dtype == bf16
        cases.append(run_dense_decode_case(
            rng, f"qwen3-moe dense cache 8 x 512, 256 valid {dn}", B=8,
            Sk=512, valid=256, dtype=dtype, timed=timed, **moe))
        cases.append(run_flash_case(rng, f"qwen3-moe admission 1 x 77 {dn}",
                                    B=1, S=77, dtype=dtype, timed=timed,
                                    **moe))
        cases.append(run_flash_case(rng, f"qwen3-moe admission 8 x 78 {dn}",
                                    B=8, S=78, dtype=dtype, timed=timed,
                                    **moe))
        cases.append(run_dense_decode_case(
            rng, f"internvl2-1b dense cache 8 x 512, 352 valid {dn}", B=8,
            Sk=512, valid=352, dtype=dtype, timed=timed, **vlm))
        cases.append(run_flash_case(
            rng, f"internvl2-1b prefix + text 8 x 320 {dn}", B=8, S=320,
            dtype=dtype, timed=timed, **vlm))
        cases.append(run_flash_case(rng, f"musicgen-medium 8 x 64 {dn}",
                                    B=8, S=64, dtype=dtype, timed=timed,
                                    **audio))
        cases.append(run_dense_decode_case(
            rng, f"musicgen-medium dense cache 8 x 97, 96 valid {dn}", B=8,
            Sk=97, valid=96, dtype=dtype, timed=timed, **audio))
    cases.append(run_flash_case(rng, "qwen3-moe ragged 8 x 78 bf16", B=8,
                                S=78, dtype=bf16, ragged=True, **moe))
    for name, K, N in (("qwen3-moe untied head", 4096, 151936),
                       ("qwen3-moe q projection", 4096, 8192),
                       ("qwen3-moe o projection", 8192, 4096)):
        cases.append(run_quant_matmul_case(
            rng, f"{name} {K}->{N} M=8 bf16", M=8, K=K, N=N, dtype=bf16,
            timed=True))
    return cases


def _moe_cut():
    """qwen3-moe's published config at MOE_LAYERS layers."""
    from repro_torch.configs.base import uniform_stack
    from repro_torch.configs.registry import get_config
    cfg = get_config(MOE_ARCH)
    return cfg.replace(stacks=uniform_stack(MOE_LAYERS,
                                            cfg.stacks[0].pattern[0]))


def _moe_dropped(cfg, p, x):
    """Assignments beyond an expert's capacity in the routing of x."""
    import torch
    from repro_torch.models import moe as MOE
    xf = x.reshape(-1, x.shape[-1])
    _, _, tope = MOE.route(cfg, p, xf)
    counts = torch.bincount(tope.reshape(-1),
                            minlength=cfg.moe.num_experts)
    return int((counts - MOE._capacity(xf.shape[0], cfg)).clamp_min(0)
               .sum())


def _mm_inputs(cfg, gen, B, S):
    """A forward-level batch from ``gen``: tokens (B, S), or (B, S, C) for
    musicgen, in [4, V), and (internvl2) its prefix embeddings (B, P, d)
    at 0.02 x normal, else None."""
    import torch
    shape = (B, S) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    toks = torch.randint(4, cfg.vocab_size, shape, generator=gen,
                         device=gen.device, dtype=torch.int32)
    pre = (torch.randn(B, cfg.num_prefix_embeds, cfg.d_model, generator=gen,
                       device=gen.device) * 0.02
           if cfg.num_prefix_embeds else None)
    return toks, pre


def phase_parity_moe_mm():
    """Reduced qwen3-moe, internvl2-1b and musicgen-medium in fp32 (TF32
    off), card against CPU.  qwen3-moe at its own capacity factor 1.5:
    ``serve_continuous`` (bucketed at exact lengths) of 8 requests, half
    of them one repeated token (whose tokens route alike, so experts
    overflow: the CPU run must drop assignments), and ``generate_batch``
    with and without the KV cache; streams and counters equal.
    internvl2-1b (16 prefix embeddings) and musicgen-medium (2 codebooks,
    sinusoidal positions): ``forward_train`` logits, and the logits of a
    dense-cache prefill and 4 decode steps, within PARITY_TOL."""
    import torch
    from repro_torch.configs.registry import get_reduced
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.precision import FP32, map_params
    from repro_torch.core.scheduler import Request
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(22)
    cfg = get_reduced(MOE_ARCH)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    lens = (20, 31, 9, 40, 20, 14, 33, 7)
    prompts = [[2] + ([int(rng.integers(4, 400))] * (n - 1) if i % 2 else
                      [int(t) for t in rng.integers(4, 400, size=n - 1)])
               for i, n in enumerate(lens)]
    batch = rng.integers(4, 400, size=(3, 40)).astype(np.int32)
    blens = np.asarray([40, 23, 6], np.int32)
    out, drops = {}, []
    apply = MOE.moe_apply

    def counting(c, p, x):
        drops.append(_moe_dropped(c, p, x))
        return apply(c, p, x)
    for dev in ("cuda", "cpu"):
        if dev == "cpu":                 # counted off the card: no sync
            MOE.moe_apply = counting
        try:
            def engine(**kw):
                return InferenceEngine(cfg, params, policy=FP32, max_len=64,
                                       max_batch=4, device=dev, **kw)
            done, m = engine().serve_continuous(
                [Request(uid=i, tokens=list(p), max_new_tokens=8)
                 for i, p in enumerate(prompts)], page_size=8)
            out[dev, "serve"] = [r.result for r in done]
            out[dev, "counters"] = [m.scheduler, m.admitted, m.retired,
                                    m.prefill_tokens, m.prefill_padded,
                                    m.host_syncs, m.steps,
                                    m.generated_tokens, m.peak_pages_in_use]
            for kv in (True, False):
                out[dev, f"kv={kv}"] = engine(
                    use_kv_cache=kv).generate_batch(batch.copy(), blens,
                                                    6).tolist()
        finally:
            MOE.moe_apply = apply
    keys = sorted({k for _, k in out})
    card_eq_cpu = {k: out["cuda", k] == out["cpu", k] for k in keys}
    emit("parity_moe_mm", arch=cfg.name, capacity_factor=cfg.moe
         .capacity_factor, dropped_assignments_cpu=sum(drops),
         card_equals_cpu=card_eq_cpu, counters=out["cuda", "counters"],
         tokens=sum(map(len, out["cpu", "serve"])))
    failed = [k for k, v in card_eq_cpu.items() if not v]
    if failed or not sum(drops) > 0 or out["cuda", "counters"][0] \
            != "bucketed":
        raise SystemExit(f"{cfg.name}: reduced parity failed: {failed}, "
                         f"dropped {sum(drops)}")
    for arch in (VLM_ARCH, AUDIO_ARCH):
        cfg = get_reduced(arch)
        params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
        toks, pre = _mm_inputs(cfg, torch.Generator().manual_seed(1), 2, 24)
        P_ = cfg.num_prefix_embeds
        plens = torch.tensor([20 + P_, 13 + P_], dtype=torch.int32)
        logits = {}
        for dev in ("cuda", "cpu"):
            p = map_params(lambda t: t.to(dev), params)
            t, n = toks.to(dev), plens.to(dev)
            pe = None if pre is None else pre.to(dev)
            with torch.no_grad():
                lt = T.forward_train(p, cfg, t[:, :20], prefix_embeds=pe)[0]
                cache = T.init_cache(cfg, 2, 64, torch.float32, device=dev)
                lp, _ = T.forward_prefill(p, cfg, t[:, :20], n, cache,
                                          prefix_embeds=pe, max_len=64,
                                          last_only=True)
                ld = [T.forward_decode(p, cfg, t[:, 20 + i:21 + i], cache,
                                       n + i, max_len=64)[0]
                      for i in range(4)]
            logits[dev] = [lt.cpu(), lp.cpu()] + [x.cpu() for x in ld]
        errs = [(a - b).abs().max().item()
                for a, b in zip(logits["cuda"], logits["cpu"])]
        emit("parity_moe_mm", arch=arch, logits_max_abs_err={
            "train": errs[0], "prefill": errs[1], "decode": max(errs[2:])},
            logits_shape=list(logits["cuda"][0].shape),
            logits_tol=PARITY_TOL["auto"])
        if not max(errs) <= PARITY_TOL["auto"]:
            raise SystemExit(f"{arch}: reduced parity failed: {errs}")


def phase_forward_mm(params, cfg, label):
    """internvl2-1b or musicgen-medium at full width, bf16, at the forward
    level: MM_ROWS rows (internvl2: its 256 prefix embeddings + MM_TEXT
    text tokens; musicgen: MM_TEXT steps x 4 codebooks) prefilled into a
    dense cache, then MM_DECODE greedy ``forward_decode`` steps (musicgen:
    an argmax per codebook).  Gates: finite logits of the expected shape,
    ids in the vocabulary, flash launched once per layer (the prefill) and
    the dense decode kernel layers x steps, no other attention kernel.
    Returns the launch counts."""
    import torch
    from repro_torch.core.precision import BF16
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    toks, pre = _mm_inputs(cfg, gen, MM_ROWS, MM_TEXT)
    S = MM_TEXT + cfg.num_prefix_embeds
    max_len = S + MM_DECODE
    lens = torch.full((MM_ROWS,), S, dtype=torch.int32, device="cuda")

    def run():
        cache = T.init_cache(cfg, MM_ROWS, max_len, torch.bfloat16,
                             device="cuda")
        with torch.no_grad():
            lp, _ = T.forward_prefill(params, cfg, toks, lens, cache,
                                      prefix_embeds=pre, policy=BF16,
                                      max_len=max_len, last_only=True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ids, finite = [lp.argmax(-1)], [torch.isfinite(lp).all()]
            for i in range(MM_DECODE):
                ld, _ = T.forward_decode(params, cfg, ids[-1], cache,
                                         lens + i, policy=BF16,
                                         max_len=max_len)
                finite.append(torch.isfinite(ld).all())
                ids.append(ld.argmax(-1))
            torch.cuda.synchronize()
        return lp, ld, torch.cat(ids, 1), bool(torch.stack(finite).all()), t1
    run()                                               # warm-up
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lp, ld, ids, finite, t1 = run()
    t2 = time.perf_counter()
    launches = ops.launch_counts()
    L = cfg.num_layers
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    checks = {
        "finite logits of shape (rows, 1, [C,] V)": finite and tuple(
            lp.shape) == tuple(ld.shape) == (MM_ROWS, 1) + cb
        + (cfg.vocab_size,),
        "ids in the vocabulary": tuple(ids.shape) == (
            MM_ROWS, MM_DECODE + 1) + cb and bool(
                ((ids >= 0) & (ids < cfg.vocab_size)).all()),
        f"flash ran {L} x 1 prefill": launches["flash_attention"] == L,
        f"dense decode ran {L} x {MM_DECODE} steps": launches[
            "decode_attention"] == L * MM_DECODE,
        "no other attention kernel ran": all(
            n == 0 for k, n in launches.items()
            if k not in ("flash_attention", "decode_attention")),
    }
    emit("forward_mm", arch=cfg.name, layers=L, policy="bf16", label=label,
         rows=MM_ROWS, prefix_embeds=cfg.num_prefix_embeds,
         text_tokens=MM_TEXT, codebooks=cfg.num_codebooks,
         decode_steps=MM_DECODE, max_len=max_len, prefill_s=t1 - t0,
         decode_s=t2 - t1, decode_tok_per_s=MM_ROWS * MM_DECODE / (t2 - t1),
         launches=launches, checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"{cfg.name} forward-level run failed: {failed}")
    return launches


def phase_teacher_forced_mm(arch):
    """Full-width ``arch`` in fp32 (TF32 off): one row of MM_TEXT +
    MM_TEACHER_STEPS tokens (internvl2 after its 256 prefix embeddings;
    musicgen over 4 codebooks) through ``forward_train``; the same row's
    first MM_TEXT tokens prefilled into a dense cache, then
    MM_TEACHER_STEPS decode steps fed the next tokens.  The prefill's last
    logits and each step's must equal ``forward_train``'s at the same
    position within TEACHER_TOL, with the argmax equal (per codebook for
    musicgen)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.precision import FP32
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(gen, cfg, FP32)
    toks, pre = _mm_inputs(cfg, gen, 1, MM_TEXT + MM_TEACHER_STEPS)
    P_ = cfg.num_prefix_embeds
    S = P_ + MM_TEXT + MM_TEACHER_STEPS
    t0 = time.perf_counter()
    with torch.no_grad():
        full = T.forward_train(params, cfg, toks, prefix_embeds=pre,
                               policy=FP32)[0][0, P_ + MM_TEXT - 1:]
        cache = T.init_cache(cfg, 1, S, torch.float32, device="cuda")
        lp, _ = T.forward_prefill(
            params, cfg, toks[:, :MM_TEXT],
            torch.tensor([P_ + MM_TEXT], dtype=torch.int32, device="cuda"),
            cache, prefix_embeds=pre, policy=FP32, max_len=S,
            last_only=True)
        got = [lp[0, 0]]
        for t in range(MM_TEXT, MM_TEXT + MM_TEACHER_STEPS):
            ld, _ = T.forward_decode(
                params, cfg, toks[:, t:t + 1], cache,
                torch.tensor([P_ + t], dtype=torch.int32, device="cuda"),
                policy=FP32, max_len=S)
            got.append(ld[0, 0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = torch.stack(got)
    diff = (got - full).abs()
    err = diff.max().item()
    argmax_equal = bool((got.argmax(-1) == full.argmax(-1)).all())
    emit("teacher_forced", arch=cfg.name, layers=cfg.num_layers,
         policy="fp32", prefix_embeds=P_, prompt_tokens=MM_TEXT,
         codebooks=cfg.num_codebooks, decode_steps=MM_TEACHER_STEPS,
         max_abs_err=err, max_abs_err_by_step=diff.reshape(
             diff.shape[0], -1).amax(1).tolist(),
         logits_max_abs=full.abs().max().item(), tol=TEACHER_TOL,
         argmax_equal=argmax_equal, wall_s=wall)
    if not (np.isfinite(err) and err <= TEACHER_TOL and argmax_equal):
        raise SystemExit(f"{arch} teacher-forced check failed: max |diff| "
                         f"{err} (tol {TEACHER_TOL}), argmax equal "
                         f"{argmax_equal}")


def phase_serves_moe_mm():
    """qwen3-moe, internvl2-1b and musicgen-medium at full width, random
    weights from a seeded torch.Generator, bf16: qwen3-moe at MOE_LAYERS
    layers bucketed at exact lengths (bf16; then at MOE_CUT_LAYERS layers
    int8 KV + int8 weights: its attention projections and untied head
    through ``quant_matmul``, 4 records a layer and the head), the bf16
    serve once more (its streams must repeat exactly: the MoE combine has
    no atomics), pipelined over the dense cache at MOE_CUT_LAYERS layers,
    one sampled serve, and the experts' byte bound beside the
    profiled busy time (``moe_expert_bound``); internvl2-1b packed
    (text-only) and at the forward level with its 256 prefix embeddings;
    musicgen-medium at the forward level; then both fp32 teacher-forced
    checks.  Returns each run's launch counts by label."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.precision import BF16
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda")
    seen = {}
    gen.manual_seed(0)
    cfg = _moe_cut()
    params = T.init_params(gen, cfg, BF16)
    L = cfg.num_layers
    m, seen["qwen3-moe bucketed"], s_b, wall, busy = phase_serve(
        MOE_ARCH, params, cfg=cfg, mode="bucketed", profile=True,
        label=_depth("bucketed", cfg, 94))
    seen["qwen3-moe bucketed moe_ragged"] = phase_serve_ragged(
        MOE_ARCH, params, cfg, _depth("bucketed moe_ragged", cfg, 94), s_b,
        busy, wall)
    # the int8 and pipelined serves at MOE_CUT_LAYERS layers
    cut, pc = _cut(cfg, params, MOE_CUT_LAYERS)
    _, seen["qwen3-moe bucketed int8"], _, _, _ = phase_serve(
        MOE_ARCH, pc, cfg=cut, kv_dtype="int8", weights_dtype="int8",
        mode="bucketed", profile=True,
        label=_depth("bucketed int8", cut, 94),
        mm_per_forward=4 * MOE_CUT_LAYERS + 1)
    again = _greedy_streams(cfg, params, "packed")
    # every forward reads every expert's weights: the capacity gives each
    # expert C >= 8 rows, which the batched products compute whether or
    # not a token was routed there
    mo = cfg.moe
    expert_bytes = L * 3 * mo.num_experts * cfg.d_model * mo.d_ff_expert * 2
    forwards = m.host_syncs - m.steps // 4 + m.steps
    bound_s = forwards * expert_bytes / HBM_BYTES_PER_S
    emit("moe_expert_bound", arch=cfg.name, layers=L,
         expert_bytes_per_forward=expert_bytes,
         bound_ms_per_forward=expert_bytes / HBM_BYTES_PER_S * 1e3,
         forwards=forwards, bound_s=bound_s, device_busy_s=busy,
         busy_over_bound=busy / bound_s, wall_s=wall,
         streams_repeat=again == s_b)
    if again != s_b:
        raise SystemExit("qwen3-moe: a second bucketed serve gave other "
                         "streams")
    seen["qwen3-moe pipelined"], _ = phase_dense(
        MOE_ARCH, pc, _depth("pipelined", cut, 94), cfg=cut,
        base=_greedy_streams(cut, pc))
    del pc
    phase_sampled(params, cfg, "qwen3-moe bucketed", mode="bucketed",
                  policy=BF16)
    del params
    torch.cuda.empty_cache()
    gen.manual_seed(0)
    cfg = get_config(VLM_ARCH)
    params = T.init_params(gen, cfg, BF16)
    _, seen["internvl2 packed"], _, _, _ = phase_serve(
        VLM_ARCH, params, cfg=cfg, profile=True)
    seen["internvl2 forward"] = phase_forward_mm(params, cfg, "prefix")
    del params
    gen.manual_seed(0)
    cfg = get_config(AUDIO_ARCH)
    params = T.init_params(gen, cfg, BF16)
    seen["musicgen forward"] = phase_forward_mm(params, cfg, "codebooks")
    del params
    torch.cuda.empty_cache()
    phase_teacher_forced_mm(VLM_ARCH)
    torch.cuda.empty_cache()
    phase_teacher_forced_mm(AUDIO_ARCH)
    torch.cuda.empty_cache()
    return seen


# ---------------------------------------------------------------------------
# hymba-1.5b and deepseek-v3-671b
# ---------------------------------------------------------------------------

HYMBA_ARCH, DEEPSEEK_ARCH = "hymba-1.5b", "deepseek-v3-671b"
# deepseek-v3 at full width but 1 dense + 2 MoE layers of its 3 + 58: a MoE
# layer is 11.5 B parameters (11.3 B of them the 256 experts), 23.0 GB at
# bf16; with the dense layer, the embedding, the untied head and the MTP
# module about 53 GB (61 layers would be 1.3 TB)
DEEPSEEK_DENSE, DEEPSEEK_MOE = 1, 2
# the absorbed-against-naive check: rows, prefilled tokens, decode steps
DS_TEACHER = (2, 48, 16)
INT8_KV_WARNING = ("kv_dtype=int8 requested but no attention layer has a "
                   "paged pool to quantize")
# the depth of hymba-1.5b's secondary serves (int8 / int8, pipelined,
# no-cache, sampled, the long serve): its first 8 of 32 layers, the global
# layer and 7 windowed ones (each of its ~5,350-kernel forwards is host
# bound; at 32 layers these serves took ~170 s of the smoke on a slow host)
HYMBA_CUT_LAYERS = 8


def _cut_keep_specs(cfg, params, layers):
    """``cfg`` and its ``params`` cut to their first ``layers`` layers,
    each keeping its own spec (hymba's global and windowed layers), runs of
    equal specs as one stack; the tensors are shared."""
    from repro_torch.configs.base import Stack, layer_specs
    stacks = []
    for spec in list(layer_specs(cfg))[:layers]:
        if stacks and stacks[-1].pattern == (spec,):
            stacks[-1] = Stack((spec,), stacks[-1].repeats + 1)
        else:
            stacks.append(Stack((spec,), 1))
    return (cfg.replace(stacks=tuple(stacks)),
            {**params, "layers": params["layers"][:layers]})


def _deepseek_cut(moe_layers=DEEPSEEK_MOE, **kw):
    """deepseek-v3's published config at DEEPSEEK_DENSE dense + ``moe_layers``
    MoE layers (``kw``: other fields replaced)."""
    from repro_torch.configs.base import Stack
    from repro_torch.configs.registry import get_config
    cfg = get_config(DEEPSEEK_ARCH)
    dense, moe = (st.pattern[0] for st in cfg.stacks)
    return cfg.replace(stacks=(Stack((dense,), DEEPSEEK_DENSE),
                               Stack((moe,), moe_layers)), **kw)


def hybrid_mla_kernel_cases(rng):
    """The kernels at the heads of hymba-1.5b (25 / 5 x 64: g = 5, window
    1024) and deepseek-v3's MLA naive form (128 heads, D 192 against Dv
    128), each against its plain version: the decode pair at g = 5 over
    up to 2048 keys past the window (the int8 pair too, which no hymba
    serve launches: its pools stay at the compute dtype); flash at the
    exact-length admissions 1 x 77 and 8 x 78 for both; dense decode over
    ``generate_batch``'s cache at hymba's heads; ``quant_matmul`` at
    hymba's tied head (1600 -> 32001) and deepseek's untied head (7168 ->
    129280).  bf16 cases are timed; fp32 (the CUDA-core bodies; flash's
    split body, also against fp64) check values only."""
    import torch
    bf16, fp32 = torch.bfloat16, torch.float32
    hymba = dict(Hq=25, Hkv=5, D=64, window=1024)
    mla = dict(Hq=128, Hkv=128, D=192, Dv=128)
    cases = []
    for quant in (False, True):
        q8 = " int8 pool," if quant else ""
        cases.append(run_decode_case(
            rng, f"hymba-1.5b window 1024, up to 2048 keys{q8} bf16",
            dtype=bf16, quant=quant, timed=True, npages=128, **hymba))
        cases.append(run_decode_case(
            rng, f"hymba-1.5b window 1024, up to 2048 keys{q8} fp32",
            dtype=fp32, quant=quant, npages=128, **hymba))
    for dtype in (bf16, fp32):
        dn = str(dtype).removeprefix("torch.")
        timed = dtype == bf16
        for B, S in ((1, 77), (8, 78)):
            cases.append(run_flash_case(
                rng, f"hymba-1.5b admission {B} x {S} window 1024 {dn}",
                B=B, S=S, dtype=dtype, timed=timed, **hymba))
            cases.append(run_flash_case(
                rng, f"deepseek-v3 MLA admission {B} x {S} D 192 Dv 128 "
                f"{dn}", B=B, S=S, dtype=dtype, timed=timed, **mla))
        cases.append(run_dense_decode_case(
            rng, f"hymba-1.5b dense cache 8 x 512, 256 valid {dn}", B=8,
            Sk=512, valid=256, dtype=dtype, timed=timed, **hymba))
    for name, K, N in (("hymba-1.5b tied head", 1600, 32001),
                       ("deepseek-v3 untied head", 7168, 129280)):
        cases.append(run_quant_matmul_case(
            rng, f"{name} {K}->{N} M=8 bf16", M=8, K=K, N=N, dtype=bf16,
            timed=True))
    return cases


def phase_parity_hybrid_mla():
    """Reduced hymba-1.5b (window 64) and deepseek-v3 in fp32 (TF32 off),
    card against CPU: bucketed ``serve_continuous`` (exact lengths) of 8
    requests x 8 new (hymba: 20-200 tokens at max_len 256, its rings of
    72 paged entries wrapping; deepseek: 7-40 tokens at max_len 64, at
    its own capacity factor 1.5) and ``generate_batch`` with and without
    the KV cache; then deepseek's equal-length batched admission (three
    7-token prompts in one prefill at the capacity factor E: each row's
    latents must land in its own slot), whose streams must also equal
    single-request ``generate_batch`` runs.  Streams and counters on the
    card must equal the CPU's.  KV == no-cache is recorded, not gated:
    over right-padded rows the prefill folds pad steps into hymba's SSM
    state and lets pad tokens compete for deepseek's expert capacity,
    which the no-cache buffer does not, as in the reference."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_reduced
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.precision import FP32
    from repro_torch.core.scheduler import Request
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(23)
    setups = {HYMBA_ARCH: ((70, 150, 20, 45, 200, 66, 100, 130), 256, 200,
                           (200, 130, 40)),
              DEEPSEEK_ARCH: ((20, 31, 9, 40, 20, 14, 33, 7), 64, 40,
                              (40, 23, 6))}
    for arch, (lens, max_len, width, blens) in setups.items():
        cfg = get_reduced(arch)
        params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
        prompts = [[2] + [int(t) for t in rng.integers(4, 400, size=n - 1)]
                   for n in lens]
        batch = rng.integers(4, 400, size=(3, width)).astype(np.int32)
        out = {}
        for dev in ("cuda", "cpu"):
            def engine(**kw):
                return InferenceEngine(cfg, params, policy=FP32,
                                       max_len=max_len, max_batch=4,
                                       device=dev, **kw)
            done, m = engine().serve_continuous(
                [Request(uid=i, tokens=list(p), max_new_tokens=8)
                 for i, p in enumerate(prompts)], page_size=8)
            out[dev, "serve"] = [r.result for r in done]
            out[dev, "counters"] = [
                m.scheduler, m.admitted, m.retired, m.prefill_tokens,
                m.prefill_padded, m.host_syncs, m.steps,
                m.generated_tokens, m.peak_pages_in_use]
            for kv in (True, False):
                out[dev, f"kv={kv}"] = engine(
                    use_kv_cache=kv).generate_batch(
                        batch.copy(), np.asarray(blens, np.int32),
                        8).tolist()
        extra = {}
        if cfg.mla is not None:
            # the reference's batched-admission contract, at capacity E
            cr = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
            same = [[2] + [int(t) for t in rng.integers(4, 400, size=6)]
                    for _ in range(3)]
            for dev in ("cuda", "cpu"):
                eng = InferenceEngine(cr, params, policy=FP32, max_len=64,
                                      max_batch=3, device=dev)
                done, _ = eng.serve_continuous(
                    [Request(uid=i, tokens=p, max_new_tokens=4)
                     for i, p in enumerate(same)], page_size=8,
                    steps_per_sync=2)
                out[dev, "equal-length admission"] = [r.result
                                                      for r in done]
                single = []
                for p in same:
                    row = eng.generate_batch(np.asarray([p], np.int32),
                                             np.asarray([7], np.int32),
                                             4)[0]
                    single.append([int(t) for t in row[row >= 0]])
                extra[f"{dev}: equal-length admission == single-request"] \
                    = single == out[dev, "equal-length admission"]
        keys = sorted({k for _, k in out})
        card_eq_cpu = {k: out["cuda", k] == out["cpu", k] for k in keys}
        inner = dict(extra)
        inner["bucketed at exact lengths"] = (
            out["cuda", "counters"][0] == "bucketed"
            and out["cuda", "counters"][3] == out["cuda", "counters"][4])
        emit("parity_hybrid_mla", arch=arch, card_equals_cpu=card_eq_cpu,
             invariants=inner, counters=out["cuda", "counters"],
             kv_equals_nocache=out["cpu", "kv=True"]
             == out["cpu", "kv=False"],
             tokens=sum(map(len, out["cpu", "serve"])))
        failed = [k for k, v in {**card_eq_cpu, **inner}.items() if not v]
        if failed:
            raise SystemExit(f"{arch}: reduced parity failed: {failed}")


def phase_teacher_forced_mla():
    """deepseek-v3 at full width in fp32 (TF32 off): 1 dense + 1 MoE layer
    (45 GB of fp32 experts), no MTP module, the capacity factor raised to
    E / top_k = 32, so that an expert's capacity C = T + 1 exceeds the T
    assignments it can get at most: neither form drops one, in a full
    forward or a decode step (capacity depends on the batch).  Two rows of
    64 tokens through ``forward_train`` (MLA's naive form, flash at D 192
    / Dv 128); their first 48 tokens prefilled into a dense latent cache,
    then 16 decode steps in the absorbed form fed the next tokens.  The
    prefill's last logits and each step's must equal ``forward_train``'s
    at the same positions within TEACHER_TOL, argmax equal."""
    import dataclasses

    import torch
    from repro_torch.core.precision import FP32
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _deepseek_cut(1, mtp=False)
    mo = cfg.moe
    cfg = cfg.replace(moe=dataclasses.replace(
        mo, capacity_factor=mo.num_experts / mo.top_k))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(gen, cfg, FP32)
    B, n_prompt, steps = DS_TEACHER
    S = n_prompt + steps
    toks = torch.randint(4, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    t0 = time.perf_counter()
    with torch.no_grad():
        full = T.forward_train(params, cfg, toks, policy=FP32)[0][
            :, n_prompt - 1:]
        cache = T.init_cache(cfg, B, S, torch.float32, device="cuda")
        lens = torch.full((B,), n_prompt, dtype=torch.int32, device="cuda")
        lp, _ = T.forward_prefill(params, cfg, toks[:, :n_prompt], lens,
                                  cache, policy=FP32, max_len=S,
                                  last_only=True)
        got = [lp[:, 0]]
        for t in range(n_prompt, S):
            ld, _ = T.forward_decode(params, cfg, toks[:, t:t + 1], cache,
                                     lens + (t - n_prompt), policy=FP32,
                                     max_len=S)
            got.append(ld[:, 0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = torch.stack(got, 1)
    diff = (got - full).abs()
    err = diff.max().item()
    argmax_equal = bool((got.argmax(-1) == full.argmax(-1)).all())
    emit("teacher_forced", arch=cfg.name, layers=cfg.num_layers,
         policy="fp32", form="absorbed decode vs naive full forward",
         rows=B, prompt_tokens=n_prompt, decode_steps=steps,
         capacity_factor=cfg.moe.capacity_factor, max_abs_err=err,
         max_abs_err_by_step=diff.amax((0, 2)).tolist(),
         logits_max_abs=full.abs().max().item(), tol=TEACHER_TOL,
         argmax_equal=argmax_equal,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), wall_s=wall)
    if not (np.isfinite(err) and err <= TEACHER_TOL and argmax_equal):
        raise SystemExit(f"deepseek-v3 absorbed-vs-naive check failed: max "
                         f"|diff| {err} (tol {TEACHER_TOL}), argmax equal "
                         f"{argmax_equal}")


def phase_serves_hybrid_mla():
    """hymba-1.5b and deepseek-v3 (DEEPSEEK_DENSE dense + DEEPSEEK_MOE MoE
    layers) at full width, random bf16 weights from a seeded
    torch.Generator.  hymba: bucketed at exact lengths at bf16 at all 32
    layers; at its first HYMBA_CUT_LAYERS (labels say so) at int8 KV +
    int8 weights (the KV request warns and the pool stays bf16; attention,
    FFN and the tied head through ``quant_matmul``, 7 records a layer and
    the head, never the Mamba branch), pipelined over the dense cache, the
    no-cache baseline (both matched against the cut model's bucketed
    streams), a sampled serve, the long serve past its 1024 window at
    max_len 2048; then the fp32 teacher-forced check past the window at all
    32 layers.  deepseek: bucketed at bf16 and
    int8 / int8 (the KV request warns: MLA keeps its latent cache; the
    dense FFN, the shared experts and the head through ``quant_matmul``,
    3 records a layer and the head), pipelined over the dense latent
    cache, sampled, ``moe_expert_bound`` (every forward reads all 512
    experts: 45.1 GB, 13.5 ms at 3.35 TB/s); flash once per layer and
    admission, and no attention kernel in its decode steps (the absorbed
    form is plain torch, as in the reference); then the fp32
    absorbed-against-naive check.  Returns each run's launch counts by
    label."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.precision import BF16
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda")
    seen = {}
    gen.manual_seed(0)
    cfg = get_config(HYMBA_ARCH)
    params = T.init_params(gen, cfg, BF16)
    _, seen["hymba bucketed"], _, _, _ = phase_serve(
        HYMBA_ARCH, params, mode="bucketed", profile=True)
    cut, pc = _cut_keep_specs(cfg, params, HYMBA_CUT_LAYERS)
    lab = functools.partial(_depth, cfg=cut, of=cfg.num_layers)
    _, seen["hymba bucketed int8"], _, _, _ = phase_serve(
        HYMBA_ARCH, pc, cfg=cut, kv_dtype="int8", weights_dtype="int8",
        mode="bucketed", profile=True, label=lab("bucketed int8"),
        expect_warnings=(INT8_KV_WARNING,))
    s_b = _greedy_streams(cut, pc)
    seen["hymba pipelined"], _ = phase_dense(
        HYMBA_ARCH, pc, lab("pipelined"), cfg=cut, base=s_b)
    seen["hymba nocache"], _ = phase_dense(
        HYMBA_ARCH, pc, lab("nocache"), pipelined=False, use_kv_cache=False,
        max_new=8, cfg=cut, base=s_b)
    phase_sampled(pc, cut, lab("hymba bucketed"), mode="bucketed",
                  policy=BF16)
    phase_long_serve(pc, cut)
    del params, pc
    torch.cuda.empty_cache()
    phase_teacher_forced(HYMBA_ARCH, n_prompt=1400)
    torch.cuda.empty_cache()
    cfg = _deepseek_cut()
    L = cfg.num_layers
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(gen, cfg, BF16)
    torch.cuda.synchronize()
    emit("init", arch=cfg.name, layers=L, seconds=time.perf_counter() - t0,
         parameters=sum(t.numel() for t in _tensors(params)),
         param_bytes=sum(t.numel() * t.element_size()
                         for t in _tensors(params)),
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    lab = functools.partial(_depth, cfg=cfg, of=61)
    m, seen["deepseek bucketed"], s_b, wall, busy = phase_serve(
        DEEPSEEK_ARCH, params, cfg=cfg, mode="bucketed", profile=True,
        label=lab("bucketed"))
    seen["deepseek bucketed moe_ragged"] = phase_serve_ragged(
        DEEPSEEK_ARCH, params, cfg, lab("bucketed moe_ragged"), s_b, busy,
        wall)
    _, seen["deepseek bucketed int8"], _, _, _ = phase_serve(
        DEEPSEEK_ARCH, params, cfg=cfg, kv_dtype="int8",
        weights_dtype="int8", mode="bucketed", profile=True,
        mm_per_forward=3 * L + 1,
        expect_warnings=(INT8_KV_WARNING,), label=lab("bucketed int8"))
    mo = cfg.moe
    expert_bytes = DEEPSEEK_MOE * 3 * mo.num_experts * cfg.d_model \
        * mo.d_ff_expert * 2
    forwards = m.host_syncs - m.steps // 4 + m.steps
    bound_s = forwards * expert_bytes / HBM_BYTES_PER_S
    emit("moe_expert_bound", arch=cfg.name, layers=L,
         moe_layers=DEEPSEEK_MOE, expert_bytes_per_forward=expert_bytes,
         bound_ms_per_forward=expert_bytes / HBM_BYTES_PER_S * 1e3,
         forwards=forwards, bound_s=bound_s, device_busy_s=busy,
         busy_over_bound=busy / bound_s, wall_s=wall)
    seen["deepseek pipelined"], _ = phase_dense(
        DEEPSEEK_ARCH, params, lab("pipelined"), cfg=cfg, base=s_b)
    phase_sampled(params, cfg, "deepseek-v3 bucketed", mode="bucketed",
                  policy=BF16)
    del params
    torch.cuda.empty_cache()
    phase_teacher_forced_mla()
    torch.cuda.empty_cache()
    return seen


# ---------------------------------------------------------------------------
# REPRO_PERF_OPTS: moe_ragged's grouped product and attn_bf16's baseline
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def perf_opts(value):
    """``REPRO_PERF_OPTS`` set to ``value`` inside, restored after (the
    port reads it at each call)."""
    old = os.environ.get("REPRO_PERF_OPTS")
    os.environ["REPRO_PERF_OPTS"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_PERF_OPTS", None)
        else:
            os.environ["REPRO_PERF_OPTS"] = old


def _ragged_on():
    return "moe_ragged" in os.environ.get("REPRO_PERF_OPTS", "").split(",")


def _routed(rng, T, E, k, K, dtype):
    """T tokens routed as the model routes them (top-k of random router
    scores): their rows (T k, K) stably sorted by expert and the int32
    group sizes (E,)."""
    import torch
    dev = torch.device("cuda")
    x = torch.randn(T, K, generator=rng, device=dev).to(dtype)
    scores = torch.randn(T, E, generator=rng, device=dev)
    tope = scores.topk(k, dim=-1).indices.reshape(-1)
    order = torch.argsort(tope, stable=True)
    sizes = torch.bincount(tope, minlength=E).to(torch.int32)
    return x[order // k].contiguous(), sizes


def _grouped_mm(a, b, sizes, want):
    """``torch._grouped_mm(a, b, offs=...)`` (offs: the groups' cumulative
    ends) on these inputs, the yardstick the port never calls: (a function
    of no arguments, its max abs error against ``want``, None), or (None,
    None, the reason it does not run).  Tried with each operand as given,
    then as a contiguous copy of its transpose, transposed back (a copy
    made here, outside the timing): the other memory order."""
    import torch
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)

    def other(t):
        return t.transpose(-1, -2).contiguous().transpose(-1, -2)
    reasons = []
    for x, y in ((a, b), (a, other(b)), (other(a), b), (other(a),
                                                        other(b))):
        def f(x=x, y=y):
            return torch._grouped_mm(x, y, offs=offs)
        try:
            got = f()
            torch.cuda.synchronize()
        except Exception as e:                 # the reason goes in the row
            reasons.append(f"{type(e).__name__}: {str(e)[:160]}")
            continue
        return f, (got.float() - want.float()).abs().max().item(), None
    return None, None, "torch._grouped_mm refused: " + " | ".join(
        dict.fromkeys(reasons))


def _ragged_bytes(rows, w, sizes):
    """Bytes a grouped product must move: the weights of the experts that
    received rows (counted from the sizes here, outside any timing), the
    rows in, the output and the sizes."""
    E, K, N = w.shape
    routed = int((sizes > 0).sum().item())
    return (routed * K * N + rows.shape[0] * (K + N)) * w.element_size() \
        + E * 4, routed


def _ragged_body(RM, dtype, K, N):
    """The body the wrapper picks for these operands (a checkout before
    the wgmma bodies has no plan: its 16-bit body was mma.sync)."""
    if hasattr(RM, "ragged_body"):
        return RM.ragged_body(dtype, K, N)
    return "cuda_cores" if str(dtype) == "torch.float32" else "mma_sync"


def _ragged_fp64(rows, w, sizes):
    """The grouped product evaluated in fp64, one routed expert at a time
    (the sizes read on the host, outside any timing)."""
    import torch
    out = torch.zeros(rows.shape[0], w.shape[2], dtype=torch.float64,
                      device=rows.device)
    start = 0
    for e, n in enumerate(sizes.tolist()):
        if n:
            out[start:start + n] = rows[start:start + n].double() \
                @ w[e].double()
        start += n
    return out


@timed_case
def run_ragged_case(rng, name, *, T, E, k, K, N, dtype, timed=False,
                    fp64=False):
    """``ragged_matmul`` over T tokens' top-k assignments (rows sorted by
    expert) and an (E, K, N) stack at ``dtype`` (entries ~ N(0, 1 / K)),
    against its plain version; two calls bit-identical; fp32 also against
    the plain version in fp64 (``fp64``; gated as fp32 flash is), bf16 /
    fp16 with ``fp64`` too (recorded beside the plain version's: both
    round the output to the dtype).  ``body``: the one the wrapper picked.
    Timed cases add ``torch._grouped_mm`` where it runs at the dtype (else
    null, with the reason)."""
    import torch
    from repro_torch.kernels import ragged_matmul as RM
    dev = torch.device("cuda")
    rows, sizes = _routed(rng, T, E, k, K, dtype)
    w = torch.randn(E, K, N, generator=rng, device=dev,
                    dtype=dtype).mul_(K ** -0.5)
    out = RM.ragged_matmul(rows, w, sizes)
    again = RM.ragged_matmul(rows, w, sizes)
    ref = RM.ragged_matmul_ref(rows, w, sizes)
    torch.cuda.synchronize()
    dn = str(dtype).removeprefix("torch.")
    tol = TOL[dn]
    err = (out.float() - ref.float()).abs().max().item()
    nbytes, routed = _ragged_bytes(rows, w, sizes)
    res = {"case": name, "kernel": "ragged_matmul", "T": T, "E": E,
           "k": k, "K": K, "N": N, "rows": rows.shape[0],
           "experts_routed": routed, "dtype": dn,
           "body": _ragged_body(RM, dtype, K, N), "max_abs_err": err,
           "tol": tol, "bit_identical_twice": torch.equal(out, again),
           "ok": bool(torch.allclose(out.float(), ref.float(), atol=tol,
                                     rtol=tol) and torch.equal(out, again))}
    if dtype == torch.float32:
        truth = RM.ragged_matmul_ref(rows.double(), w.double(), sizes)
        res["fp64"] = _fp64_errors(("out",), (out,), (ref,), (truth,))
        res["ok"] &= res["fp64"]["out"]["ok"]
        del truth
    elif fp64:
        f = _fp64_errors(("out",), (out,), (ref,),
                         (_ragged_fp64(rows, w, sizes),))["out"]
        res["fp64"] = {"out": {"err": f["err"], "plain_err": f["plain_err"],
                               "gated": False}}
    if timed:
        lib, lib_err, why = _grouped_mm(rows, w, sizes, ref)
        res.update(timings("ragged_matmul",
                           lambda: RM.ragged_matmul(rows, w, sizes),
                           lambda: RM.ragged_matmul_ref(rows, w, sizes),
                           lib))
        res["library"] = "torch._grouped_mm" if lib else why
        res["library_max_abs_err"] = lib_err
        res["bound_ms"], res["bound_by"] = _bound(
            nbytes, 2 * rows.shape[0] * K * N, dtype)
    return res


@timed_case
def run_ragged_bwd_case(rng, name, *, T, E, k, K, N, dtype, timed=False):
    """``ragged_matmul_bwd`` (dRows through the forward kernel reading w
    transposed, dW over each group's rows) against autograd of the plain
    version; two calls bit-identical.  No single PyTorch call computes
    both gradients: library null.  Timed cases also time each half alone
    (``drows``, ``dw``: the wrapper with the other gradient off, its
    kernel's device time, its bound) beside its own
    ``torch._grouped_mm`` (dRows: dOut x w^T by group; dW: rows^T x dOut
    with the groups along K)."""
    import torch
    from repro_torch.kernels import ragged_matmul as RM
    dev = torch.device("cuda")
    rows, sizes = _routed(rng, T, E, k, K, dtype)
    w = torch.randn(E, K, N, generator=rng, device=dev,
                    dtype=dtype).mul_(K ** -0.5)
    dout = torch.randn(rows.shape[0], N, generator=rng, device=dev,
                       dtype=dtype)
    got = RM.ragged_matmul_bwd(rows, w, sizes, dout)
    again = RM.ragged_matmul_bwd(rows, w, sizes, dout)
    r, ww = rows.clone().requires_grad_(), w.clone().requires_grad_()

    def plain():
        return torch.autograd.grad(RM.ragged_matmul_ref(r, ww, sizes),
                                   (r, ww), dout)
    want = plain()
    torch.cuda.synchronize()
    dn = str(dtype).removeprefix("torch.")
    tol = TOL[dn]
    errs, ok = {}, True
    for n, g, p in zip(("drows", "dw"), got, want):
        scale = max(1.0, p.float().abs().max().item())
        errs[n] = (g.float() - p.float()).abs().max().item()
        ok &= errs[n] <= tol * scale
    twice = all(torch.equal(a, b) for a, b in zip(got, again))
    res = {"case": name, "kernel": "ragged_matmul_bwd", "T": T, "E": E,
           "k": k, "K": K, "N": N, "rows": rows.shape[0], "dtype": dn,
           "body": _ragged_body(RM, dtype, K, N), "errs": errs,
           "max_abs_err": max(errs.values()), "tol": tol,
           "bit_identical_twice": twice, "ok": bool(ok and twice)}
    if timed:
        res.update(timings(
            "ragged_matmul_bwd",
            lambda: RM.ragged_matmul_bwd(rows, w, sizes, dout), plain,
            None))
        res["library"] = ("null: no single PyTorch call computes both "
                          "gradients")
        # inputs rows, dout, the routed experts' weights (dRows) and the
        # sizes once; outputs drows and the whole dw (zeros included)
        wbytes, _ = _ragged_bytes(rows, w, sizes)
        nbytes = wbytes + (rows.numel() + E * K * N) * w.element_size()
        res["bound_ms"], res["bound_by"] = _bound(
            nbytes, 4 * rows.shape[0] * K * N, dtype)
        el, R = w.element_size(), rows.shape[0]
        halves = {
            # dRows: dout and the routed experts' weights in, drows out
            "drows": (dict(need_w=False), (dout, w.transpose(1, 2)),
                      want[0], wbytes),
            # dW: rows and dout in, every expert's dw out
            "dw": (dict(need_rows=False), (rows.t(), dout), want[1],
                   (R * (K + N) + E * K * N) * el + E * 4)}
        for part, (kw, lib_args, ref, part_bytes) in halves.items():
            def fn(kw=kw):
                return RM.ragged_matmul_bwd(rows, w, sizes, dout, **kw)
            lib, lib_err, why = _grouped_mm(*lib_args, sizes, ref)
            dms, by_name, tries = device_ms(fn, RAGGED_BWD_PARTS[part])
            lib_dms = device_ms(lib)[0] if lib else None
            bms, bby = _bound(part_bytes, 2 * R * K * N, dtype)
            res[part] = {"kernel_ms": time_ms(fn), "device_ms": dms,
                         "device_ms_by_kernel": by_name,
                         "library_ms": time_ms(lib) if lib else None,
                         "library_device_ms": lib_dms,
                         "library": "torch._grouped_mm" if lib else why,
                         "library_max_abs_err": lib_err,
                         "bound_ms": bms, "bound_by": bby,
                         "profile_attempts": tries}
    del got, again, want
    return res


def ragged_kernel_cases(rng):
    """The grouped product at the main path's shapes, routing from random
    router scores (top-8): qwen3-moe (E 128, d 4096, f 1536) and
    deepseek-v3 (E 256, d 7168, f 2048) at a decode step (8 slots x top-8
    = 64 rows) through wi / wg (d -> f) and wo (f -> d), and at an 8 x 78
    admission (4,992 rows) through wi, bf16, timed (deepseek's admission's
    error against fp64 recorded); qwen3-moe at 8 x 1,024 tokens (65,536
    rows); the forward at fp32 (against fp64 too) at the decode and
    admission shapes, timed, and at fp16; the backward at qwen3-moe's
    widths over 4 x 128 tokens (4,096 rows) at bf16 and fp32, timed, each
    half apart; last, the CUDA-core bodies that fp32 shapes TMA cannot
    describe still run (K 100, N 70: rows of 400 and 280 bytes), forward
    and backward over 64 tokens, timed, on inputs of their own
    generator."""
    import torch
    bf16, fp32, fp16 = torch.bfloat16, torch.float32, torch.float16
    qwen = dict(E=128, k=8)
    ds = dict(E=256, k=8)
    cases = []
    for arch, m, d, f in (("qwen3-moe", qwen, 4096, 1536),
                          ("deepseek-v3", ds, 7168, 2048)):
        cases.append(run_ragged_case(
            rng, f"ragged {arch} decode 64 rows {d}->{f} bf16", T=8, K=d,
            N=f, dtype=bf16, timed=True, **m))
        cases.append(run_ragged_case(
            rng, f"ragged {arch} decode 64 rows {f}->{d} bf16", T=8, K=f,
            N=d, dtype=bf16, timed=True, **m))
        cases.append(run_ragged_case(
            rng, f"ragged {arch} admission 8 x 78, 4992 rows {d}->{f} bf16",
            T=8 * 78, K=d, N=f, dtype=bf16, timed=True,
            fp64=arch == "deepseek-v3", **m))
        torch.cuda.empty_cache()
    # the reference's long-prompt trace (--long-prompt-len 1024): 8 x 1024
    # tokens, ~512 rows an expert, where the tensor cores decide
    cases.append(run_ragged_case(
        rng, "ragged qwen3-moe admission 8 x 1024, 65536 rows 4096->1536 "
        "bf16", T=8 * 1024, K=4096, N=1536, dtype=bf16, timed=True, **qwen))
    torch.cuda.empty_cache()
    # fp32 (the default train policy's; fp64-gated) timed at the decode and
    # admission shapes, fp16 checked
    for dtype in (fp32, fp16):
        dn = str(dtype).removeprefix("torch.")
        cases.append(run_ragged_case(
            rng, f"ragged qwen3-moe decode 64 rows 4096->1536 {dn}", T=8,
            K=4096, N=1536, dtype=dtype, timed=dtype == fp32, **qwen))
    cases.append(run_ragged_case(
        rng, "ragged qwen3-moe admission 8 x 78, 4992 rows 4096->1536 "
        "float32", T=8 * 78, K=4096, N=1536, dtype=fp32, timed=True, **qwen))
    torch.cuda.empty_cache()
    for dtype in (bf16, fp32):
        dn = str(dtype).removeprefix("torch.")
        cases.append(run_ragged_bwd_case(
            rng, f"ragged qwen3-moe train 4 x 128, 4096 rows 4096->1536 "
            f"{dn}", T=512, K=4096, N=1536, dtype=dtype, timed=True,
            **qwen))
        torch.cuda.empty_cache()
    own = torch.Generator(device="cuda").manual_seed(100)
    for run in (run_ragged_case, run_ragged_bwd_case):
        cases.append(held_on_cuda_cores(run(
            own, "ragged K, N off 4: 512 rows 100->70 float32", T=64, K=100,
            N=70, dtype=fp32, timed=True, **qwen)))
    return cases


def _moe_prompts(rng, lens):
    """Prompts of ``lens`` tokens, every other one a single repeated token
    (whose tokens route alike, so that capacity dispatch would drop)."""
    return [[2] + ([int(rng.integers(4, 400))] * (n - 1) if i % 2 else
                   [int(t) for t in rng.integers(4, 400, size=n - 1)])
            for i, n in enumerate(lens)]


def phase_parity_ragged():
    """Reduced qwen3-moe and deepseek-v3 in fp32 (TF32 off) under
    ``REPRO_PERF_OPTS=moe_ragged``, card against CPU: a bucketed
    ``serve_continuous`` of 8 requests x 8 new (half of them one
    repeated token: the CPU run counts the assignments capacity dispatch
    would drop, which must be some) and ``generate_batch`` with the KV
    cache; streams and counters equal, the card's serve through the
    grouped product (3 launches a MoE layer and forward).  Then deepseek
    under ``REPRO_PERF_OPTS=""`` (MLA's absorbed decode over fp32 copies
    of the latent cache): the same serve and ``generate_batch``, card ==
    CPU.  Then ``train_parity`` of reduced qwen3-moe under moe_ragged
    (its experts' gradients through the backward kernels).  Returns the
    card's ragged serve's launch counts."""
    import torch
    from repro_torch.configs.registry import get_reduced
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.precision import FP32
    from repro_torch.core.scheduler import Request
    from repro_torch.kernels import ops
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(29)
    lens = (20, 31, 9, 40, 20, 14, 33, 7)
    seen = {}
    for opts, arch in (("moe_ragged", MOE_ARCH),
                       ("moe_ragged", DEEPSEEK_ARCH), ("", DEEPSEEK_ARCH)):
        cfg = get_reduced(arch)
        params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
        prompts = _moe_prompts(rng, lens)
        batch = rng.integers(4, 400, size=(3, 40)).astype(np.int32)
        blens = np.asarray([40, 23, 6], np.int32)
        out, drops = {}, []
        apply = MOE.moe_apply_ragged

        def counting(c, p, x):
            drops.append(_moe_dropped(c, p, x))
            return apply(c, p, x)
        with perf_opts(opts):
            for dev in ("cuda", "cpu"):
                if dev == "cpu":            # counted off the card: no sync
                    MOE.moe_apply_ragged = counting
                try:
                    ops.reset_launch_counts()
                    done, m = InferenceEngine(
                        cfg, params, policy=FP32, max_len=64, max_batch=4,
                        device=dev).serve_continuous(
                        [Request(uid=i, tokens=list(p), max_new_tokens=8)
                         for i, p in enumerate(prompts)], page_size=8)
                    if dev == "cuda":
                        torch.cuda.synchronize()
                        counts = ops.launch_counts()
                        forwards = m.host_syncs - m.steps // 4 + m.steps
                    out[dev, "serve"] = [r.result for r in done]
                    out[dev, "counters"] = [
                        m.scheduler, m.admitted, m.retired,
                        m.prefill_tokens, m.prefill_padded, m.host_syncs,
                        m.steps, m.generated_tokens, m.peak_pages_in_use]
                    out[dev, "kv=True"] = InferenceEngine(
                        cfg, params, policy=FP32, max_len=64, max_batch=4,
                        device=dev).generate_batch(batch.copy(), blens,
                                                   6).tolist()
                finally:
                    MOE.moe_apply_ragged = apply
        moe_layers = sum(s.ffn == "moe" for st in cfg.stacks
                         for s in st.pattern * st.repeats)
        want = 3 * moe_layers * forwards if opts else 0
        keys = sorted({k for _, k in out})
        card_eq_cpu = {k: out["cuda", k] == out["cpu", k] for k in keys}
        checks = {**card_eq_cpu,
                  f"ragged_matmul ran {want} times": counts["ragged_matmul"]
                  == want,
                  "capacity dispatch would drop": (sum(drops) > 0
                                                   or not opts)}
        emit("parity_ragged", arch=arch, perf_opts=opts,
             dropped_by_capacity_cpu=sum(drops), checks=checks,
             counters=out["cuda", "counters"],
             launches={k: v for k, v in counts.items() if v},
             tokens=sum(map(len, out["cpu", "serve"])))
        failed = [k for k, v in checks.items() if not v]
        if failed:
            raise SystemExit(f"{arch} under REPRO_PERF_OPTS={opts!r}: "
                             f"reduced parity failed: {failed}")
        if opts:
            seen[arch] = counts
    with perf_opts("moe_ragged"):
        seen["train"] = phase_train_parity(archs=(MOE_ARCH,),
                                           phase="train_parity_ragged")
    return seen


def _routed_expert_bytes(cfg, params, mode="bucketed"):
    """The smoke's serve (16 prompts x 32 new, bf16) once more under
    moe_ragged, each grouped product's read of expert weights counted on
    the device (the experts with rows times their slab's bytes) and
    copied back once at the end: (bytes summed over the serve's forwards,
    the MoE layers' forwards, its greedy streams).  Not timed."""
    import torch
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.precision import BF16
    from repro_torch.core.scheduler import Request
    from repro_torch.kernels import ops
    total = torch.zeros((), dtype=torch.int64, device="cuda")
    calls = [0]
    ragged = ops.ragged_matmul

    def counting(rows, w, sizes):
        nonlocal total
        total = total + (sizes > 0).sum() * (w[0].numel()
                                             * w.element_size())
        calls[0] += 1
        return ragged(rows, w, sizes)
    ops.ragged_matmul = counting
    try:
        done, _ = InferenceEngine(cfg, params, policy=BF16, max_batch=8,
                                  max_len=256, device="cuda") \
            .serve_continuous([Request(uid=i, tokens=list(t),
                                       max_new_tokens=32)
                               for i, t in enumerate(_smoke_prompts())],
                              **_serve_kw(mode))
    finally:
        ops.ragged_matmul = ragged
    return int(total.item()), calls[0] // 3, [r.result for r in done]


def phase_serve_ragged(arch, params, cfg, label, cap_streams, cap_busy,
                       cap_wall):
    """The capacity serve of ``params`` once more under moe_ragged (its
    launch gates: the grouped product 3 x the MoE layers x the forwards),
    profiled; then the expert bytes it actually read per forward
    (``_routed_expert_bytes``) beside the capacity path's (every expert,
    every forward), its busy time beside that bound and the capacity
    serve's, and the greedy match with the capacity serve (recorded: bf16
    sums differ).  Returns the ragged serve's launch counts."""
    mo = cfg.moe
    moe_layers = sum(s.ffn == "moe" for st in cfg.stacks
                     for s in st.pattern * st.repeats)
    cap_bytes = moe_layers * 3 * mo.num_experts * cfg.d_model \
        * mo.d_ff_expert * 2
    with perf_opts("moe_ragged"):
        m, launches, streams, wall, busy = phase_serve(
            arch, params, cfg=cfg, mode="bucketed", profile=True,
            label=label)
        read, layer_forwards, again = _routed_expert_bytes(cfg, params)
    forwards = layer_forwards // moe_layers
    pairs = [(a, b) for s, t in zip(streams, cap_streams)
             for a, b in zip(s, t)]
    emit("moe_ragged", arch=cfg.name, layers=cfg.num_layers,
         moe_layers=moe_layers, mode=label, forwards=forwards,
         expert_bytes_read=read,
         expert_bytes_read_per_forward=read / max(forwards, 1),
         capacity_expert_bytes_per_forward=cap_bytes,
         read_over_capacity=read / max(forwards, 1) / cap_bytes,
         bound_s=read / HBM_BYTES_PER_S, device_busy_s=busy,
         busy_over_bound=busy / (read / HBM_BYTES_PER_S),
         capacity_device_busy_s=cap_busy, wall_s=wall,
         capacity_wall_s=cap_wall, tokens_per_s=m.generated_tokens / wall,
         ragged_matmul_launches=launches["ragged_matmul"],
         greedy_match_with_capacity=(sum(a == b for a, b in pairs)
                                     / max(len(pairs), 1)),
         streams_repeat=again == streams)
    if again != streams:
        raise SystemExit(f"{arch} moe_ragged: a second serve gave other "
                         f"streams")
    return launches


# ---------------------------------------------------------------------------
# Training: the flash backward kernel, card == CPU train steps, full width
# ---------------------------------------------------------------------------

BWD_SYMBOLS = ("attn_bwd_",)
# the reduced configs whose fp32 train step on the card must equal the
# CPU's (xlstm-125m's through the mLSTM forward and backward kernels, the
# rest through flash's)
TRAIN_PARITY_ARCHS = ("unimo-text", "qwen3-4b", "gemma2-2b",
                      "qwen3-moe-235b-a22b", "deepseek-v3-671b",
                      "hymba-1.5b", "internvl2-1b", "musicgen-medium",
                      "xlstm-125m")
TRAIN_PARITY_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
# full AdamW's first update g / (|g| + eps) has slope 1 / eps at g = 0: at
# eps 1e-8 a gradient entry within rounding of zero may move its parameter
# by a tenth of the learning rate between two summation orders, so the
# parity steps take eps 1e-3 (tests/test_torch_train.py does the same)
TRAIN_PARITY_EPS = 1e-3
# the full-width runs: unimo-text (the paper's model) at fp32 and mixed,
# 30 steps of 8 x 128 packed tokens; qwen3-4b at all 36 layers, mixed,
# factored AdamW, two microbatches, 3 steps
TRAIN_STEPS, TRAIN_B, TRAIN_S = 30, 8, 128
TRAIN_LOSS_DROP = 0.3
QWEN3_TRAIN_LAYERS = 36
QWEN3_TRAIN_STEPS = 3
# full-width xlstm-125m (all 12 layers) at fp32, the trainer's default
# policy, and at mixed precision: 6 steps each (2.2-3.6 s a step on the
# H100: the sLSTM's per-step recurrence launches ~89k kernels a step) take
# the loss down ~4-6.6 nats, far past TRAIN_LOSS_DROP
XLSTM_TRAIN_STEPS = 6


@timed_case
def run_flash_bwd_case(rng, name, *, B, S, Hq, Hkv, D, dtype, Dv=None,
                       window=None, softcap=None, ragged=False,
                       timed=False):
    """The flash backward kernel at (B, S) tokens, positions 0 .. S-1
    (``ragged``: -1 keys and padding queries, the last row all padding),
    from the forward kernel's o and lse, against the plain backward on the
    same o and lse and against autograd through the plain forward; each
    gradient's error as a fraction of its largest magnitude (TOL).
    ``timed``: the kernel, the plain backward and SDPA's backward with the
    same boolean mask (its yardstick; no softcap), and the bound: q, k, v,
    o, dO and lse read, dq, dk, dv written once, or 2.5x the forward's
    flops over the visible pairs, the larger."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    Dv = Dv or D
    dev = torch.device("cuda")

    def rnd(*shape):
        return torch.randn(*shape, generator=rng, device=dev).to(dtype)
    q, k, v = rnd(B, S, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, Dv)
    do = rnd(B, S, Hq, Dv)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    qpos = pos.copy()
    if ragged:
        pos[min(1, B - 1), 3:9] = -1
        qpos[min(1, B - 1), -5:] = -1
        qpos[B - 1] = -1
    kp, qp = (torch.from_numpy(a).to(dev) for a in (pos, qpos))
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    o, lse = FA.flash_attention(q, k, v, qp, kp, return_lse=True, **kw)
    got = FA.flash_attention_bwd(q, k, v, qp, kp, o, lse, do, **kw)
    again = FA.flash_attention_bwd(q, k, v, qp, kp, o, lse, do, **kw)
    plain = FA.flash_attention_bwd_ref(q, k, v, qp, kp, o, lse, do, **kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(
        FA.flash_attention_ref(*leaves, qp, kp, **kw), leaves, do)
    torch.cuda.synchronize()
    tol = TOL[str(dtype).removeprefix("torch.")]
    errs, rels = {}, {}
    for n, g, a, b in zip(("dq", "dk", "dv"), got, plain, auto):
        scale = max(a.float().abs().max().item(), 1e-30)
        e = [(g.float() - w.float()).abs().max().item() for w in (a, b)]
        errs[n], rels[n] = e, [x / scale for x in e]
    # two calls on the same inputs: the same bits (no atomics)
    deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = all(r <= tol for rs in rels.values() for r in rs) \
        and not got[0][qp < 0].any().item() and deterministic
    plan = FA.bwd_plan(B, S, S, Hq, Hkv, D, Dv, dtype,
                       torch.cuda.get_device_properties(0)
                       .multi_processor_count)
    res = {"case": name, "kernel": "flash_attention_bwd",
           "max_abs_err": max(e[0] for e in errs.values()),
           "errs": errs, "rel_errs": rels, "tol": tol, "ok": bool(ok),
           "deterministic": deterministic, "plan": plan._asdict(),
           "B": B, "S": S, "D": D, "Dv": Dv, "Hq": Hq, "Hkv": Hkv,
           "dtype": str(dtype).removeprefix("torch.")}
    if dtype == torch.float32:
        res["fp64"] = _fp64_errors(
            ("dq", "dk", "dv"), got, plain,
            _flash_bwd64(q, k, v, qp, kp, o, lse, do, window, D ** -0.5,
                         softcap))
        res["ok"] &= all(e["ok"] for e in res["fp64"].values())
    if timed:
        g = Hq // Hkv
        mask = visible(kp[:, None, None, :], qp[:, None, :, None], window)
        sd = [t.detach().transpose(1, 2).requires_grad_() for t in (
            q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2))]
        sdpa = F.scaled_dot_product_attention(*sd, attn_mask=mask,
                                              scale=D ** -0.5)
        do_t = do.transpose(1, 2)
        res.update(timings(
            "flash_attention_bwd",
            lambda: FA.flash_attention_bwd(q, k, v, qp, kp, o, lse, do,
                                           **kw),
            lambda: FA.flash_attention_bwd_ref(q, k, v, qp, kp, o, lse, do,
                                               **kw),
            lambda: torch.autograd.grad(sdpa, sd, do_t, retain_graph=True)))
        if plan.body == "mma":
            # the tensor-core kernels ran, and nothing else of the port's
            res["ok"] &= all("_mma_" in n or "_sum_" in n
                             for n in res["device_kernels"])
        elif plan.body == "split":
            # the fp32 instances of the same kernels, and nothing else
            res["ok"] &= all(any(s in n for s in
                                 REDESIGNED_FP32["flash_attention_bwd"])
                             for n in res["device_kernels"])
        pairs = int(visible(pos[:, None, :], qpos[:, :, None], window).sum())
        el = q.element_size()
        nbytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                  + 2 * o.numel()) * el + lse.numel() * 4 \
            + pos.nbytes + qpos.nbytes
        flops = 2.5 * 2 * (D + Dv) * Hq * pairs
        res["bound_ms"], res["bound_by"] = _bound(nbytes, flops, dtype)
        if dtype == torch.float32:
            res["split_floor_ms"] = (SPLIT_PRODUCTS * flops
                                     / PEAK_FLOPS["bfloat16"] * 1e3)
    return res


def ptxas_report(log, part):
    """Registers, spills and static shared memory of each kernel whose
    (mangled) name matches the pattern ``part``, from nvcc's ``-Xptxas
    -v`` log: entries {"kernel": its name from the match on, mangled
    template arguments cut at 48 characters, "registers", "spill_stores",
    "spill_loads", "smem_bytes"}."""
    import re
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(f"(?:{part})\\w*", m.group(1))
            cur = {"kernel": k.group(0)[:48]} if k else None
            if cur is not None:
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def bwd_kernel_attrs(lib):
    """Registers and local memory (spills) a thread of each kernel of the
    two backward files, ``flash_attention_bwd.cu`` and
    ``mlstm_chunk_bwd.cu``, from cudaFuncGetAttributes."""
    import ctypes
    out, attrs = [], (ctypes.c_int * 2)()
    for query in (lib.flash_attention_bwd_kernel_attrs,
                  lib.mlstm_chunk_bwd_kernel_attrs):
        i = 0
        while True:
            name = query(i, attrs)
            if name is None:
                break
            out.append({"kernel": name.decode(), "registers": attrs[0],
                        "local_bytes": attrs[1]})
            i += 1
    return out


@timed_case
def run_mlstm_bwd_case(rng, name, *, B, S, H, dh, dtype, state=False,
                       timed=False):
    """The mLSTM backward kernel on random q, k (scaled by dh^-1/2), v,
    gates, h's gradient and (with ``state``) a nonzero initial state, from
    the chunk states and h of the forward kernel's training launch, which
    must give the serving launch's h bit for bit and the plain version's
    chunk states (MLSTM_REL_TOL["C"]); against the plain backward on the
    same states and h: dq, dk, dv within TOL of their dtype and di, dlogf
    within TOL["float32"] of each gradient's largest magnitude; two calls
    bit-identical.  ``timed``: the kernel and the plain backward (no
    PyTorch call computes it), and the bound: q, k, v, the gates, the
    chunk states, h and dh read, the five gradients written once, or the
    backward's products (per step the four dh x dh state products and
    five causal intra-chunk ones of dh each), the larger."""
    import torch
    from repro_torch.kernels import mlstm_chunk as MC
    dev = torch.device("cuda")

    def r(*shape):
        return torch.randn(*shape, generator=rng, device=dev)
    q, k, v = (r(B, S, H, dh).to(dtype) for _ in range(3))
    k = (k.float() * dh ** -0.5).to(dtype)
    i_pre = r(B, S, H)
    logf = torch.nn.functional.logsigmoid(r(B, S, H) + 2)
    st = {"C": r(B, H, dh, dh) * 0.1 if state else
          torch.zeros(B, H, dh, dh, device=dev),
          "n": r(B, H, dh).abs() if state else torch.zeros(B, H, dh,
                                                           device=dev),
          "m": r(B, H) if state else torch.zeros(B, H, device=dev)}
    dh_out = r(B, S, H, dh)
    args = (q, k, v, i_pre, logf)
    h_serve, _ = MC.mlstm_chunked(*args, st)
    h, _, states = MC.mlstm_chunked(*args, st, return_states=True)
    got = MC.mlstm_chunked_bwd(*args, states, h, dh_out)
    again = MC.mlstm_chunked_bwd(*args, states, h, dh_out)
    plain = MC.mlstm_chunked_bwd_ref(*args, states, h, dh_out,
                                     chunk=MC.CHUNK)
    _, _, plain_st = MC.mlstm_chunked_ref(*args, st, chunk=MC.CHUNK,
                                          return_states=True)
    torch.cuda.synchronize()
    st_err = {key: (states[key] - plain_st[key]).abs().max().item()
              / max(plain_st[key].abs().max().item(), 1.0)
              for key in ("C", "n", "m")}
    tol = TOL[str(dtype).removeprefix("torch.")]
    errs, rels = {}, {}
    for i, (n, g, w) in enumerate(zip(("dq", "dk", "dv", "di", "dlogf"),
                                      got, plain)):
        errs[n] = (g.float() - w.float()).abs().max().item()
        rels[n] = errs[n] / max(w.float().abs().max().item(), 1e-30)
    deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = (deterministic and torch.equal(h, h_serve)
          and all(e <= MLSTM_REL_TOL["C"] for e in st_err.values())
          and all(rels[n] <= (tol if i < 3 else TOL["float32"])
                  for i, n in enumerate(rels)))
    res = {"case": name, "kernel": "mlstm_chunked_bwd", "B": B, "S": S,
           "H": H, "dh": dh, "max_abs_err": max(errs.values()),
           "errs": errs, "rel_errs": rels, "state_rel_errs": st_err,
           "tol": {"dq_dk_dv": tol, "di_dlogf": TOL["float32"],
                   "chunk_states": MLSTM_REL_TOL["C"]},
           "deterministic": deterministic,
           "h_equals_serving_launch": torch.equal(h, h_serve),
           "ok": bool(ok)}
    if timed:
        res.update(timings(
            "mlstm_chunked_bwd",
            lambda: MC.mlstm_chunked_bwd(*args, states, h, dh_out),
            lambda: MC.mlstm_chunked_bwd_ref(*args, states, h, dh_out,
                                             chunk=MC.CHUNK), None))
        L = MC.CHUNK
        flops = 2 * B * H * S * dh * (4 * dh + 5 * (L + 1) / 2)
        el = q.element_size()
        nbytes = (2 * 3 * q.numel() * el + 4 * 4 * i_pre.numel()
                  + 4 * sum(t.numel() for t in states.values())
                  + 4 * (h.numel() + dh_out.numel()))
        res["bound_ms"], res["bound_by"] = _bound(nbytes, flops, dtype)
    return res


def mlstm_bwd_cases(rng):
    """The mLSTM backward kernel at xlstm-125m's width (4 heads x 384): the
    train shape 8 x 128 from the zero state, a ragged 8 x 300 from a
    nonzero state (which takes no gradient), at fp32 and bf16 (8 x 128
    timed at both, 8 x 300 at bf16), and the long training context 4 x
    2048 from the zero state at bf16, timed (64 chunks: the chunk-parallel
    passes' case)."""
    import torch
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).removeprefix("torch.")
        cases.append(run_mlstm_bwd_case(
            rng, f"xlstm-125m train 8 x 128 {dn}", B=8, S=128, H=4, dh=384,
            dtype=dtype, timed=True))
        cases.append(run_mlstm_bwd_case(
            rng, f"xlstm-125m 8 x 300 nonzero state {dn}", B=8, S=300, H=4,
            dh=384, dtype=dtype, state=True, timed=dtype == torch.bfloat16))
    cases.append(run_mlstm_bwd_case(
        rng, "xlstm-125m train 4 x 2048 bfloat16", B=4, S=2048, H=4, dh=384,
        dtype=torch.bfloat16, timed=True))
    return cases


def train_kernel_cases(rng):
    """The training kernels at the train shapes: flash's
    (:func:`flash_train_cases`), then the mLSTM backward
    (:func:`mlstm_bwd_cases`)."""
    return flash_train_cases(rng) + mlstm_bwd_cases(rng)


def flash_train_cases(rng):
    """Flash at the train shapes.  The forward with its log-sum-exp at
    unimo-text's (8 x 128, 16 x 64), fp32 (the default train policy's) and
    bf16, timed.  The backward at unimo-text's, qwen3-4b's microbatch (4 x
    128, 32 / 8 x 128), gemma2-2b's (4 x 256, 8 / 4 x 256, window 4096,
    softcap 50), MLA's naive form (1 x 128, 128 heads, D 192 / Dv 128) and
    a ragged case with -1 positions and rows that see no key; each at
    fp32, bf16 and fp16, the train shapes timed at bf16 (and unimo-text at
    fp32, the fp32 run's dtype, and qwen3-4b at fp16).  Every backward
    case runs the kernel twice and must get the same bits."""
    import torch
    cases = [run_flash_case(rng, f"unimo-text train 8 x 128 {dn} lse",
                            B=8, S=128, Hq=16, Hkv=16, D=64, dtype=dtype,
                            timed=True, lse=True)
             for dtype, dn in ((torch.float32, "float32"),
                               (torch.bfloat16, "bfloat16"))]
    shapes = {
        "unimo-text train 8 x 128": dict(B=8, S=128, Hq=16, Hkv=16, D=64),
        "qwen3-4b train 4 x 128": dict(B=4, S=128, Hq=32, Hkv=8, D=128),
        "gemma2-2b train 4 x 256 window 4096 softcap 50": dict(
            B=4, S=256, Hq=8, Hkv=4, D=256, window=4096, softcap=50.0),
        "deepseek-v3 MLA train 1 x 128 D 192 / Dv 128": dict(
            B=1, S=128, Hq=128, Hkv=128, D=192, Dv=128),
        "ragged -1 + empty rows window 16 softcap 30": dict(
            B=3, S=45, Hq=8, Hkv=2, D=32, window=16, softcap=30.0,
            ragged=True)}
    for name, kw in shapes.items():
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            dn = str(dtype).removeprefix("torch.")
            timed = not kw.get("ragged") and (
                dtype == torch.bfloat16
                or (dtype == torch.float32 and name.startswith("unimo"))
                or (dtype == torch.float16 and name.startswith("qwen3")))
            cases.append(run_flash_bwd_case(rng, f"{name} {dn}",
                                            dtype=dtype, timed=timed, **kw))
    return cases


def _train_batch(cfg, rng, B, S):
    """A numpy batch of random tokens (codebooks for an audio model) and,
    for a vision model, prefix embeddings."""
    shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks else (B, S)
    vocab = min(cfg.vocab_size, 400)
    b = {"tokens": rng.integers(4, vocab, size=shape).astype(np.int32),
         "labels": rng.integers(4, vocab, size=shape).astype(np.int32),
         "loss_mask": np.ones((B, S), np.float32)}
    if cfg.num_prefix_embeds:
        b["prefix_embeds"] = (0.02 * rng.normal(size=(
            B, cfg.num_prefix_embeds, cfg.d_model))).astype(np.float32)
    return b


def phase_train_parity(archs=TRAIN_PARITY_ARCHS, phase="train_parity"):
    """Reduced configs (``archs``) in fp32 (TF32 off), on the card and on
    the CPU from
    the same parameters and batch: the gradient of ``loss_fn`` (every leaf
    within TRAIN_GRAD_TOL of its largest magnitude, the CPU tests'
    tolerance against the reference), then one ``make_train_step`` (full
    AdamW, remat): loss and gnorm within TRAIN_PARITY_TOL, and every
    parameter after the step within TRAIN_PARITY_TOL of its leaf's
    largest magnitude plus the gradient's tolerance carried through the
    first update (lr x TRAIN_GRAD_TOL x the leaf's largest gradient / eps:
    g / (|g| + eps) has slope at most 1 / eps).  On the card the
    attention ran through the flash forward and backward kernels, and
    xlstm-125m's mLSTM layers through the mLSTM ones, and under
    moe_ragged the experts through the grouped product's forward and
    backward kernels.  Each line has the card step's peak memory,
    xlstm-125m's also the mLSTM kernels' device ms of one more step,
    profiled.  Returns the launch counts of the card's steps, summed."""
    import torch
    from repro_torch.configs.registry import get_reduced
    from repro_torch.core.precision import FP32, map_params
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_loop as TL
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ocfg = OPT.AdamWConfig(lr=1e-3, warmup_steps=1, eps=TRAIN_PARITY_EPS)
    lr1 = OPT.lr_at(ocfg, 1)
    failed, total = [], {}
    for arch in archs:
        cfg = get_reduced(arch)
        params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
        batch = _train_batch(cfg, np.random.default_rng(11), 2, 48)
        res = {}
        for dev in ("cuda", "cpu"):
            # copies: the step updates its parameters in place
            b = TL.to_device(batch, dev)
            _, _, grads = TL._grads(
                map_params(lambda t: t.to(dev, copy=True), params), cfg, b,
                FP32, True)
            p = map_params(lambda t: t.to(dev, copy=True), params)
            ops.reset_launch_counts()
            if dev == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            p, _, m = TL.make_train_step(cfg, ocfg, FP32)(
                p, OPT.init_state(p), b)
            if dev == "cuda":
                counts = ops.launch_counts()
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                if arch == "xlstm-125m":
                    # one more step, profiled, from a copy of the weights
                    pc = map_params(lambda t: t.to(dev, copy=True), params)
                    prof = _profile_step(
                        lambda: TL.make_train_step(cfg, ocfg, FP32)(
                            pc, OPT.init_state(pc), b), arch, 1.0)
                    extra = {"mlstm_fwd_ms": prof["mlstm_fwd_ms"],
                             "mlstm_bwd_ms": prof["mlstm_bwd_ms"]}
            res[dev] = (float(m["loss"]), float(m["gnorm"]),
                        {k: t.detach().cpu()
                         for k, t in OPT.flatten(p).items()},
                        {k: g.cpu() for k, g in grads.items()})
        rel = {n: abs(res["cuda"][i] - res["cpu"][i]) / abs(res["cpu"][i])
               for i, n in enumerate(("loss", "gnorm"))}
        worst = {"grad": (0.0, None), "param": (0.0, None)}
        ok = True
        for k, w in res["cpu"][3].items():
            gmax = w.abs().max().item()
            e = (res["cuda"][3][k] - w).abs().max().item() / max(gmax,
                                                                  1e-30)
            if e > worst["grad"][0]:
                worst["grad"] = (e, k)
            ok &= e <= TRAIN_GRAD_TOL
            pw = res["cpu"][2][k]
            tol = (TRAIN_PARITY_TOL * pw.abs().max().item()
                   + lr1 * TRAIN_GRAD_TOL * gmax / ocfg.eps)
            e = (res["cuda"][2][k] - pw).abs().max().item()
            if e / max(tol, 1e-30) > worst["param"][0]:
                worst["param"] = (e / max(tol, 1e-30), k)
            ok &= e <= tol
        bwd = ("mlstm_chunked_bwd" if arch == "xlstm-125m"
               else "flash_attention_bwd")
        ok &= (all(v <= TRAIN_PARITY_TOL for v in rel.values())
               and counts[bwd] > 0)
        if _ragged_on() and cfg.moe is not None:
            ok &= counts["ragged_matmul_bwd"] > 0
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        emit(phase, arch=arch, loss=res["cuda"][0],
             peak_gb=peak_gb, **(extra if arch == "xlstm-125m" else {}),
             loss_cpu=res["cpu"][0], rel_err=rel,
             worst_grad_rel_err=worst["grad"],
             worst_param_err_over_tol=worst["param"],
             tol={"loss_gnorm_param": TRAIN_PARITY_TOL,
                  "grad": TRAIN_GRAD_TOL},
             launches={k: v for k, v in counts.items() if v}, ok=bool(ok))
        if not ok:
            failed.append(arch)
    if failed:
        raise SystemExit(f"{phase} failed: {failed}")
    return total


def _profile_step(step, label, wall):
    """One more train step under torch.profiler (device activity): busy
    time, its share of ``wall`` (the run's unprofiled seconds a step),
    the device ms of the flash and mLSTM forward and backward kernels,
    the top device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            us, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    busy = sum(us for us, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    def ms(part):
        return sum(us for k, (us, _) in by_name.items() if part in k) / 1e3
    return {"label": label, "step_wall_s": wall, "device_busy_s": busy,
            "device_idle_frac": max(0.0, 1.0 - busy / wall),
            "kernels_launched": sum(n for _, n in by_name.values()),
            "flash_fwd_ms": ms("flash_"), "flash_bwd_ms": ms("attn_bwd_"),
            "mlstm_fwd_ms": ms("mlstm_chunk_"),
            "mlstm_bwd_ms": ms("mlstm_bwd_"),
            "mlstm_fwd_kernels": sorted({k[:90] for k in by_name
                                         if "mlstm_chunk_" in k}),
            "top": [{"kernel": k[:90], "ms": us / 1e3, "count": n}
                    for k, (us, n) in top]}


def _train_run(cfg, params, batches, *, label, policy, policy_name, steps,
               opt_cfg, grad_accum=1, check_moved=False):
    """``steps`` train steps of full-width ``cfg`` on the card, then one
    profiled step: loss per step, step seconds (host clock over the steps
    after the first, one synchronize at the end), train tokens/s, peak
    memory, kernel launches.  ``check_moved``: every leaf's first 4096
    entries must have changed."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_loop as TL
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = OPT.init_state(params, factored=opt_cfg.factored, model_cfg=cfg)
    step = TL.make_train_step(cfg, opt_cfg, policy, grad_accum=grad_accum)
    before = ({k: t.detach().flatten()[:4096].clone()
               for k, t in OPT.flatten(params).items()}
              if check_moved else None)
    ops.reset_launch_counts()
    losses, gnorms, ms = [], [], []
    t0 = t1 = time.perf_counter()
    for i in range(steps):
        b = TL.to_device(next(batches), "cuda")
        params, state, m = step(params, state, b)
        losses.append(m["loss"])
        gnorms.append(m["gnorm"])
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = ops.launch_counts()
    losses = [float(x) for x in losses]
    gnorms = [float(x) for x in gnorms]
    step_s = (t2 - t1) / max(steps - 1, 1)
    tokens = TRAIN_B * TRAIN_S
    moved = None
    if check_moved:
        moved = {k: not torch.equal(t.detach().flatten()[:4096], before[k])
                 for k, t in OPT.flatten(params).items()}
    nxt = TL.to_device(next(batches), "cuda")
    prof = _profile_step(lambda: step(params, state, nxt), label, step_s)
    out = {"label": label, "arch": cfg.name, "layers": cfg.num_layers,
           "policy": policy_name, "factored": opt_cfg.factored,
           "grad_accum": grad_accum, "steps": steps, "B": TRAIN_B,
           "S": TRAIN_S, "losses": losses, "gnorms": gnorms,
           "first_step_s": t1 - t0, "step_s": step_s,
           "train_tokens_per_s": tokens / step_s,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
           / 1e9, "launches": {k: v for k, v in launches.items() if v},
           "profile": prof}
    if moved is not None:
        out["leaves"] = len(moved)
        out["leaves_not_moved"] = [k for k, v in moved.items() if not v]
    emit("train", **out)
    return out, launches


def phase_train(unimo_fp32_only=False, check_bodies=True):
    """Full-width training on the card: unimo-text (24 layers, 1024 wide,
    the paper's model) on ``packed_batches`` over ``synthetic_corpus(2000)``,
    8 x 128 tokens, 30 steps, lr 1e-3, warmup 5, under fp32 and under
    mixed (fp32 master weights, bf16 compute): the loss must fall by
    TRAIN_LOSS_DROP nats in each.  Then qwen3-4b at QWEN3_TRAIN_LAYERS
    layers, mixed, factored AdamW, two microbatches of 4 rows, 3 steps:
    finite losses and gnorms, every leaf moved.  Each run's attention ran
    through the flash forward and backward kernels and nothing else of the
    port's.  Last, xlstm-125m (all 12 layers) at fp32 and at mixed
    precision as unimo-text, XLSTM_TRAIN_STEPS steps each: the loss must
    fall by TRAIN_LOSS_DROP, its six mLSTM layers through the mLSTM
    forward kernel (twice a layer and step: remat) and the backward
    kernel (once), nothing else of the port's (:func:`_xlstm_train_run`).
    Returns (the unimo-text fp32 run's launch counts, the xlstm-125m fp32
    run's, each run's launch counts by label).  ``unimo_fp32_only``: the
    unimo-text fp32 run alone (an A/B of the fp32 training path; the
    xlstm-125m counts are then None)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.precision import FP32, MIXED
    from repro_torch.core.tokenizer import FastTokenizer
    from repro_torch.data.pipeline import packed_batches, synthetic_corpus
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as OPT
    torch.backends.cuda.matmul.allow_tf32 = False
    corpus = synthetic_corpus(2000)
    seen, failed = {}, []
    cfg = get_config("unimo-text")
    tok = FastTokenizer.train(corpus, min(cfg.vocab_size, 4000))
    opt = OPT.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS)
    policies = (("fp32", FP32),) if unimo_fp32_only else (("fp32", FP32),
                                                          ("mixed", MIXED))
    for name, policy in policies:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = T.init_params(gen, cfg, policy)
        batches = packed_batches(tok, corpus, batch_size=TRAIN_B,
                                 seq_len=TRAIN_S)
        label = f"unimo-text {name}"
        out, seen[label] = _train_run(cfg, params, batches, label=label,
                                      policy=policy, policy_name=name,
                                      steps=TRAIN_STEPS, opt_cfg=opt)
        drop = out["losses"][0] - out["losses"][-1]
        n_attn = cfg.num_layers * TRAIN_STEPS
        if not (drop >= TRAIN_LOSS_DROP
                and seen[label]["flash_attention_bwd"] == n_attn
                and seen[label]["flash_attention"] == 2 * n_attn
                and sum(seen[label].values()) == 3 * n_attn):
            failed.append((label, drop, seen[label]))
        del params
    if unimo_fp32_only:
        if failed:
            raise SystemExit(f"training on the card failed: {failed}")
        return seen["unimo-text fp32"], None, seen
    cfg, params = _qwen3_train_model()
    tok = FastTokenizer.train(corpus, min(cfg.vocab_size, 4000))
    batches = packed_batches(tok, corpus, batch_size=TRAIN_B,
                             seq_len=TRAIN_S)
    label = _depth("qwen3-4b mixed factored accum 2", cfg, 36)
    out, seen[label] = _train_run(
        cfg, params, batches, label=label, policy=MIXED,
        policy_name="mixed", steps=QWEN3_TRAIN_STEPS, grad_accum=2, check_moved=True,
        opt_cfg=OPT.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10,
                                factored=True))
    n_attn = cfg.num_layers * QWEN3_TRAIN_STEPS * 2
    if not (all(np.isfinite(out["losses"] + out["gnorms"]))
            and not out["leaves_not_moved"]
            and seen[label]["flash_attention_bwd"] == n_attn):
        failed.append((label, out["losses"], out["leaves_not_moved"][:5]))
    del params
    torch.cuda.empty_cache()
    for name in ("fp32", "mixed"):
        label, seen[label], bad = _xlstm_train_run(corpus, check_bodies,
                                                   name)
        failed += bad
    if failed:
        raise SystemExit(f"training on the card failed: {failed}")
    return seen["unimo-text fp32"], seen["xlstm-125m fp32"], seen


# the mLSTM forward's tensor-core instance that each train policy's
# compute dtype runs (MIXED computes in bf16)
XLSTM_TRAIN_BODIES = {"fp32": "mlstm_chunk_mma_kernel<float",
                      "mixed": "mlstm_chunk_mma_kernel<__nv_bfloat16"}


def _xlstm_train_run(corpus, check_bodies=True, policy_name="fp32"):
    """Full-width xlstm-125m (all 12 layers) on packed batches of TRAIN_B
    x TRAIN_S, XLSTM_TRAIN_STEPS steps under ``policy_name`` (``fp32``,
    the trainer's default, or ``mixed``), lr 1e-3: the loss must fall by
    TRAIN_LOSS_DROP, its six mLSTM layers through the mLSTM forward kernel
    (twice a layer and step: remat) and the backward kernel (once),
    nothing else of the port's; with ``check_bodies`` the profiled step's
    mLSTM forward kernels must be the tensor-core body's instance at the
    policy's compute dtype (XLSTM_TRAIN_BODIES).  Returns (label, launch
    counts, failures)."""
    import torch
    from repro_torch.configs.base import MLSTM, layer_specs
    from repro_torch.configs.registry import get_config
    from repro_torch.core.precision import get_policy
    from repro_torch.core.tokenizer import FastTokenizer
    from repro_torch.data.pipeline import packed_batches
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as OPT
    cfg = get_config("xlstm-125m")
    n_mlstm = sum(s.mixer == MLSTM for s in layer_specs(cfg))
    tok = FastTokenizer.train(corpus, min(cfg.vocab_size, 4000))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    policy = get_policy(policy_name)
    params = T.init_params(gen, cfg, policy)
    batches = packed_batches(tok, corpus, batch_size=TRAIN_B,
                             seq_len=TRAIN_S)
    label = f"xlstm-125m {policy_name}"
    out, seen = _train_run(
        cfg, params, batches, label=label, policy=policy,
        policy_name=policy_name, steps=XLSTM_TRAIN_STEPS,
        opt_cfg=OPT.AdamWConfig(lr=1e-3, warmup_steps=5,
                                total_steps=XLSTM_TRAIN_STEPS))
    drop = out["losses"][0] - out["losses"][-1]
    n = n_mlstm * XLSTM_TRAIN_STEPS
    body = XLSTM_TRAIN_BODIES[policy_name]
    fwd = out["profile"]["mlstm_fwd_kernels"]
    failed = []
    if not (drop >= TRAIN_LOSS_DROP
            and seen["mlstm_chunked_bwd"] == n
            and seen["mlstm_chunked"] == 2 * n
            and sum(seen.values()) == 3 * n
            and (not check_bodies
                 or fwd and all(body in k for k in fwd))):
        failed.append((label, drop, seen, fwd))
    del params
    torch.cuda.empty_cache()
    return label, seen, failed


def _qwen3_train_model():
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.precision import MIXED
    from repro_torch.models import transformer as T
    cfg = get_config("qwen3-4b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if QWEN3_TRAIN_LAYERS != cfg.num_layers:
        cfg = _cut(cfg, {"layers": []}, QWEN3_TRAIN_LAYERS)[0]
    return cfg, T.init_params(gen, cfg, MIXED)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


# the mesh phase: the dry run's production combos on the fake 16 x 16
# mesh, then full-width qwen3-4b through make_target on the card's real
# (1, 1) mesh against the same steps unmeshed, at shapes cut to one card
MESH_DRYRUNS = (("qwen3-4b", "train_4k"), ("qwen3-4b", "decode_32k"),
                ("deepseek-v3-671b", "decode_32k"))
MESH_SHAPES = {"train": {"kind": "train", "seq": 1024, "batch": 2},
               "prefill": {"kind": "prefill", "seq": 2048, "batch": 8},
               "decode": {"kind": "decode", "seq": 2048, "batch": 8}}
# the dry run's predicted peak over the card's max_memory_allocated
MESH_PEAK_BAND = (0.75, 1.25)
# updated leaves compared after the train step
MESH_SAMPLE = ("embed/tokens", "layers/0/attn/wq", "layers/17/ffn/wo",
               "layers/35/attn/k_norm/w", "layers/35/norm2/w",
               "final_norm/w")


def _mesh_train_target(cfg, mesh):
    """The card's train target: mixed precision, factored, remat (the
    switches make_target reserves for archs above LOW_MEM_OPT_THRESHOLD,
    set here for qwen3-4b)."""
    import torch
    from repro_torch.core.precision import MIXED
    from repro_torch.launch import specs as SPC
    return SPC.train_target(cfg, mesh, MESH_SHAPES["train"], policy=MIXED,
                            factored=True, grad_accum=1,
                            moment_dtype=torch.float32, fsdp=False,
                            meta={"arch": cfg.name, "kind": "train"})


def _rule_param_bytes(params, cfg, fsdp, mesh):
    """Per-device parameter bytes from the rules alone: every leaf's
    sanitized local shard, from the (DTensor) parameters' global
    shapes."""
    import math
    from repro_torch.sharding import partition as SH
    from repro_torch.training import optimizer as OPT
    flat = SH.flat_specs(SH.param_pspecs(params, cfg, fsdp=fsdp, mesh=mesh))
    return sum(math.prod(SH.local_shape(t.shape, flat[p], mesh))
               * t.element_size() for p, t in OPT.flatten(params).items())


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _mesh_dryrun(arch, shape):
    """One production combo on the fake 16 x 16 mesh (this host's CPU,
    nothing allocated): (its record, the rules' parameter bytes, its
    seconds)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import specs as SPC
    from repro_torch.sharding import partition as SH
    t0 = time.perf_counter()
    target = []

    def make(cfg, mesh):
        target.append(SPC.make_target(cfg, shape, mesh))
        return target[0]
    rec = DR.run_one(arch, shape, make=make)
    want = _rule_param_bytes(target[0].args[0], get_config(arch),
                             rec["fsdp"], SH.current_mesh())
    return rec, want, time.perf_counter() - t0


def _emit_dryrun(arch, shape, rec, want, seconds):
    """The ``dryrun`` line of a combo, and its gates."""
    train = rec["kind"] == "train"
    mem, coll, hlo = rec["memory"], rec["collectives"], rec["hlo"]
    emit("dryrun", arch=arch, shape=shape, mesh=rec["mesh"],
         fsdp=rec["fsdp"], param_bytes=mem["parameter_bytes"],
         rule_param_bytes=want, optimizer_bytes=mem["optimizer_bytes"],
         cache_bytes=mem["cache_bytes"],
         argument_bytes=mem["argument_size_in_bytes"],
         peak_bytes=mem["peak_memory_in_bytes"], flops=hlo["flops"],
         bytes=hlo["bytes"], n_dots=hlo["n_dots"],
         bytes_by_op=hlo["bytes_by_op"], collectives=coll["counts"],
         collective_bytes=coll["per_op_bytes"],
         collective_total_bytes=coll["total_bytes"],
         model_flops=rec["model_flops"]["flops"], build_s=rec["build_s"],
         trace_s=rec["trace_s"], seconds=seconds)
    if not (hlo["flops"] > 0 and hlo["bytes"] > 0):
        raise SystemExit(f"dryrun {arch} {shape}: no flops or bytes")
    if train and not coll["total_bytes"] > 0:
        raise SystemExit(f"dryrun {arch} {shape}: a sharded train step "
                         f"without collectives")
    if mem["parameter_bytes"] != want:
        raise SystemExit(f"dryrun {arch} {shape}: parameter bytes "
                         f"{mem['parameter_bytes']} != the rules' {want}")


def _mesh_predictions():
    """The dry run's predicted per-device memory of each card target
    (full-width qwen3-4b), on a fake (1, 1) mesh."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun as DR
    DR.init_fake_group(1)
    mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))
    cfg, pred = get_config("qwen3-4b"), {}
    for kind, info in MESH_SHAPES.items():
        make = _mesh_train_target if kind == "train" else None
        pred[kind] = DR.run_one("qwen3-4b", kind, cfg=cfg, mesh=mesh,
                                info=info, make=make)["memory"]
    return pred


_SRC = [None]      # the src/ directory main() runs (children import it)


def _in_child(src, name, args, conn):
    sys.path.insert(0, src)
    try:
        conn.send(("ok", globals()[name](*args)))
    except BaseException as e:                      # reported by _finish
        import traceback
        conn.send(("error", f"{type(e).__name__}: {e}\n"
                            f"{traceback.format_exc()[-3000:]}"))
    conn.close()


def _start(name, *args):
    """``name(*args)`` of this module in a child process (spawned: its
    own torch, its own process group)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    p = ctx.Process(target=_in_child, args=(_SRC[0], name, args, send),
                    daemon=True)
    p.start()
    send.close()
    return p, recv, name


def _finish(job):
    p, recv, name = job
    status, value = recv.recv()
    p.join()
    if status != "ok":
        raise SystemExit(f"mesh phase: {name} failed in its child: {value}")
    return value


def phase_mesh():
    """The production dry runs (``_mesh_dryrun``) and the predictions
    (``_mesh_predictions``), each in a child process on this host's CPU,
    beside full-width qwen3-4b on the card's
    real (1, 1) mesh (``make_host_mesh``: nccl, one rank) through
    ``make_target`` against the same steps unmeshed on the same
    parameters: a factored mixed train step (2 x 1024), a prefill (8 x
    2048) and one decode step.  Every shard is whole, so loss, the
    sampled updated leaves and the logits must be bit-identical and the
    kernel launches equal; the dry run's predicted peak (a fake (1, 1)
    mesh) over ``max_memory_allocated`` must lie in MESH_PEAK_BAND."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.core.precision import BF16, MIXED
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs as SPC
    from repro_torch.models import transformer as T
    from repro_torch.sharding import partition as SH
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train_loop import make_train_step

    # the CPU-only parts (fake tensors) run in child processes beside the
    # card's part: the three production dry runs and the predictions
    jobs = [_start("_mesh_dryrun", arch, shape)
            for arch, shape in MESH_DRYRUNS]
    t0 = time.perf_counter()
    pred_job = _start("_mesh_predictions")
    cfg = get_config("qwen3-4b")
    mesh = M.make_host_mesh()
    SH.set_current_mesh(mesh)
    results = {}

    start = {}

    def measured(kind, fn):
        """(fn's result, the card's peak bytes, the launches) of a
        meshed step, the peak counted from the step's arguments up (what
        was allocated when it started: ``start``)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start[kind] = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated(), ops.launch_counts()

    def unmeshed(fn):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, ops.launch_counts()

    pred = {}

    def record(kind, diff, peak, l_mesh, l_plain, **kw):
        if not pred:
            pred.update(_finish(pred_job))
            emit("mesh_predictions", arch=cfg.name,
                 peak_bytes={k: v["peak_memory_in_bytes"]
                             for k, v in pred.items()},
                 argument_bytes={k: v["argument_size_in_bytes"]
                                 for k, v in pred.items()},
                 seconds=time.perf_counter() - t0)
        p = pred[kind]["peak_memory_in_bytes"]
        ratio = p / peak
        results[kind] = dict(
            max_abs_diff=diff, launches=l_mesh,
            launches_equal=l_mesh == l_plain, predicted_peak_bytes=p,
            card_peak_bytes=peak, peak_ratio=ratio,
            predicted_argument_bytes=pred[kind]["argument_size_in_bytes"],
            card_start_bytes=start[kind], **kw)
        emit("mesh_truth", target=kind, **results[kind])
        if diff != 0:
            raise SystemExit(f"mesh {kind}: the (1, 1) mesh differs from "
                             f"the unmeshed step by {diff}")
        if l_mesh != l_plain:
            raise SystemExit(f"mesh {kind}: launches {l_mesh} != unmeshed "
                             f"{l_plain}")
        if not MESH_PEAK_BAND[0] <= ratio <= MESH_PEAK_BAND[1]:
            raise SystemExit(f"mesh {kind}: predicted peak {p} / card peak "
                             f"{peak} = {ratio:.3f} outside "
                             f"{MESH_PEAK_BAND}")

    # -- train --------------------------------------------------------------
    t = _mesh_train_target(cfg, mesh)
    params, _, batch = t.args
    flat = OPT.flatten(params)
    host = {p: _local(x).to("cpu", copy=True) for p, x in flat.items()}
    skeleton = SH.map_tree(lambda n, x: None, params)
    hbatch = {k: _local(v).clone() for k, v in batch.items()}
    (_, _, m), peak, l_mesh = measured("train", lambda: t.fn(*t.args))
    loss_mesh = _local(m["loss"]).detach().item()
    sample = {p: _local(flat[p]).to("cpu", copy=True) for p in MESH_SAMPLE}
    del t, params, batch, flat, m
    gc.collect()
    torch.cuda.empty_cache()
    params_u = OPT.unflatten_like(skeleton, {p: x.to(mesh.device_type)
                                             for p, x in host.items()})
    del host
    state_u = OPT.init_state(params_u, factored=True, model_cfg=cfg)
    step = make_train_step(cfg, OPT.AdamWConfig(factored=True),
                           policy=MIXED, remat=True)
    (_, _, m_u), l_plain = unmeshed(lambda: step(params_u, state_u, hbatch))
    flat_u = OPT.flatten(params_u)
    diff = max([abs(loss_mesh - float(m_u["loss"]))]
               + [float((sample[p] - flat_u[p].detach().cpu()).abs().max())
                  for p in MESH_SAMPLE])
    record("train", diff, peak, l_mesh, l_plain, loss=loss_mesh)
    del params_u, state_u, m_u, flat_u, hbatch
    gc.collect()
    torch.cuda.empty_cache()

    # -- prefill, then one decode step --------------------------------------
    before = torch.cuda.memory_allocated()     # left from the train part
    tp = SPC.make_target(cfg, "prefill", mesh, info=MESH_SHAPES["prefill"])
    params = tp.args[0]
    (lp, cache), peak_p, lm_p = measured("prefill", lambda: tp.fn(*tp.args))
    td = SPC.make_target(cfg, "decode", mesh, info=MESH_SHAPES["decode"],
                         params=params, cache=cache)
    (ld, _), peak_d, lm_d = measured("decode", lambda: td.fn(*td.args))
    lp, ld = _local(lp).float().cpu(), _local(ld).float().cpu()
    plocal = SH.map_tree(lambda n, x: _local(x), params)
    ins_p = [_local(x) for x in tp.args[1:3]]
    ins_d = (_local(td.args[1]), _local(td.args[3]))
    del tp, td, cache
    gc.collect()
    torch.cuda.empty_cache()
    S, B = MESH_SHAPES["prefill"]["seq"], MESH_SHAPES["prefill"]["batch"]
    cache_u = T.init_cache(cfg, B, S, torch.bfloat16,
                           device=mesh.device_type)
    (lpu, cache_u), lu_p = unmeshed(lambda: T.forward_prefill(
        plocal, cfg, ins_p[0], ins_p[1], cache_u, policy=BF16, max_len=S,
        last_only=True))
    (ldu, _), lu_d = unmeshed(lambda: T.forward_decode(
        plocal, cfg, ins_d[0], cache_u, ins_d[1], policy=BF16, max_len=S))
    record("prefill", float((lp - lpu.float().cpu()).abs().max()), peak_p,
           lm_p, lu_p, card_before_target_bytes=before)
    record("decode", float((ld - ldu.float().cpu()).abs().max()), peak_d,
           lm_d, lu_d)
    del params, plocal, cache_u
    SH.set_current_mesh(None)
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    for (arch, shape), job in zip(MESH_DRYRUNS, jobs):
        _emit_dryrun(arch, shape, *_finish(job))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src/ directory whose repro_torch is run "
                         "(default: this checkout's)")
    ap.add_argument("--only", action="append",
                    choices=("flash", "train", "ragged", "mlstm", "attn",
                             "mesh"),
                    help="run only these phases, for an A/B: the flash "
                         "forward and backward cases at the train shapes "
                         "(flash), the full-width unimo-text fp32 train "
                         "run (train), the grouped product's kernel cases "
                         "at bf16, fp16 and fp32 (ragged), the mLSTM "
                         "forward's kernel cases at bf16, fp32 and fp16 "
                         "and the full-width xlstm-125m train runs, fp32 "
                         "and mixed (mlstm), the timed bf16 cases of the "
                         "flash forward and the paged decode, packed and "
                         "mixed kernels (attn), the sharding and dry-run "
                         "phase (mesh); "
                         "no kernels summary line")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = args.src.resolve()
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    _SRC[0] = str(src)
    from repro_torch.kernels import build

    smi = nvidia_smi()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    info = build.build()
    build.load()
    emit("build", seconds=time.perf_counter() - t0, built=info["built"],
         library=Path(info["path"]).name,
         source_seconds=info.get("source_seconds"),
         ptxas=[ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "Compiling entry" in ln
                or "spill" in ln])

    emit("bwd_kernels", kernels=bwd_kernel_attrs(build.load()))
    # the grouped product's kernels as ptxas reported them (when built here)
    emit("ragged_kernels", kernels=ptxas_report(info["log"],
                                                "ragged_mm_|ragged_dw_"))
    check_bodies = src == (ROOT / "src").resolve()
    if args.only:
        if "flash" in args.only:
            cases = flash_train_cases(torch.Generator(device="cuda")
                                      .manual_seed(0))
            for c in cases:
                emit("kernels", **c)
            bad = [c["case"] for c in cases if not c["ok"]]
            if bad:
                raise SystemExit(f"flash disagrees with its plain version: "
                                 f"{bad}")
        if "train" in args.only:
            phase_train(unimo_fp32_only=True)
        for part, fn in (("ragged", ragged_kernel_cases),
                         ("mlstm", mlstm_kernel_cases),
                         ("attn", attention_kernel_cases)):
            if part not in args.only:
                continue
            cases = fn(torch.Generator(device="cuda").manual_seed(0))
            for c in cases:
                emit("kernels", **c)
            bad = [c["case"] for c in cases if not c["ok"]]
            if bad:
                raise SystemExit(f"{part}: kernel disagrees with its plain "
                                 f"version: {bad}")
            if check_bodies:
                _check_bodies(cases)
        if "mlstm" in args.only:
            torch.backends.cuda.matmul.allow_tf32 = False
            from repro_torch.data.pipeline import synthetic_corpus
            bad = []
            for name in ("fp32", "mixed"):
                bad += _xlstm_train_run(synthetic_corpus(2000),
                                        check_bodies, name)[2]
            if bad:
                raise SystemExit(f"training on the card failed: {bad}")
        if "mesh" in args.only:
            phase_mesh()
        print(smi, flush=True)
        print(json.dumps({"ok": True, "only": args.only, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    timed = phase_kernels(check_bodies=check_bodies)
    phase_parity("unimo-text")
    phase_parity("qwen3-4b")
    phase_parity("qwen3-4b", kv_dtype="int8", weights_dtype="int8")
    phase_parity_dense("unimo-text")
    phase_parity_dense("qwen3-4b")
    phase_parity_xlstm()
    phase_parity_overload()
    phase_parity_families()
    phase_parity_moe_mm()
    phase_parity_hybrid_mla()
    phase_train_parity()
    ragged = phase_parity_ragged()
    launches = phase_serves()
    xl = phase_serve_xlstm()
    launches.update({k: xl[k] for k in ("mlstm_chunked", "fused_rmsnorm")})
    family = phase_serves_families()
    family.update(phase_serves_moe_mm())
    family.update(phase_serves_hybrid_mla())
    train_launches, xlstm_train, train_runs = phase_train(
        check_bodies=check_bodies)
    phase_mesh()
    launches["flash_attention_bwd"] = train_launches["flash_attention_bwd"]
    launches["mlstm_chunked_bwd"] = xlstm_train["mlstm_chunked_bwd"]
    launches["ragged_matmul"] = family[
        "qwen3-moe bucketed moe_ragged"]["ragged_matmul"]
    launches["ragged_matmul_bwd"] = ragged["train"]["ragged_matmul_bwd"]
    family["train_parity_ragged"] = ragged["train"]
    family.update(train_runs)

    kernels = []
    for name in REPLACES:
        c = timed[name]
        row = {
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": c["max_abs_err"], "ms": c["kernel_ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "device_ms": c["device_ms"],
            "library_device_ms": c["library_device_ms"],
            "device_kernels": c["device_kernels"],
            "profile_attempts": c["profile_attempts"]}
        if name in NOTES:
            row["note"] = NOTES[name]
        # this slice's serves: the kernel's launches in each
        row["family_launches"] = {k: v[name] for k, v in family.items()}
        if "regimes" in c:          # each timed shape of the kernel
            row["regimes"] = [
                {k: r[k] for k in ("case", "M", "K", "N", "B", "S", "H",
                                   "dh", "T", "Sk", "rows", "D", "Dv",
                                   "Hq", "Hkv", "seconds", "rel_errs",
                                   "max_abs_err", "errs", "gate_frac",
                                   "kernel_ms", "plain_ms", "library_ms", "device_ms",
                                   "device_kernels", "library_device_ms",
                                   "profile_attempts", "bound_ms",
                                   "bound_by", "split_floor_ms", "dtype",
                                   "body", "fp64", "drows", "dw") if k in r}
                for r in c["regimes"]]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
