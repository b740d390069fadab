#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero before the last line:

  1. device   the card's name, power limit, torch / CUDA versions
  2. build    compile the CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
              sm_90a) and report the build seconds and ptxas resource use
  3. kernels  each kernel against its plain PyTorch version on the card at
              the main path's shapes (unimo-text: Hq = Hkv = 16, D = 64,
              16-token bf16 pages, 8 slots, a 256-lane packed stream), plus a
              GQA case (Hq 32, Hkv 8, D 128), a window + softcap case and fp32
              pools; times the kernel, the plain version and
              ``scaled_dot_product_attention`` over densely gathered K/V (a
              yardstick the port never calls) with CUDA events
  4. parity   reduced unimo-text in fp32: packed and decode forwards on the
              card against the same forwards through the plain versions on
              the CPU, and a short greedy serve on both, whose token
              streams must be identical
  5. serve    full-width unimo-text (24 layers, random weights from a seeded
              torch.Generator, bf16) through ``serve_continuous``; the kernel
              launch counts of this run must equal 24 x the packed
              iterations and 24 x the decode steps.  The same serve then
              runs once more under ``torch.profiler`` (``profile`` line):
              device time by kernel and the device's idle share

It then prints the kernels' JSON summary, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  It needs one
CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float16": 2e-2, "float32": 1e-4}
REPLACES = {
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:165",
    "paged_packed_attention": "src/repro/kernels/decode_attention.py:639",
}
SOURCE = "src/repro_torch/csrc/paged_attention.cu"


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def time_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of ``fn`` over ``reps`` calls."""
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


# ---------------------------------------------------------------------------
# Kernel cases
# ---------------------------------------------------------------------------


def paged_case(rng, *, slots, ctx_lens, Hq, Hkv, D, page, npages, dtype,
               device):
    """Pools holding ``ctx_lens`` tokens per slot on pages scattered over
    the pool (plus the dump page), and a block table per slot."""
    import torch
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
    return (k.to(dtype), v.to(dtype), torch.from_numpy(ppos).to(device),
            torch.from_numpy(bt).to(device), ppos, bt)


def visible(kp, qp, window):
    m = (kp >= 0) & (kp <= qp)
    if window is not None:
        m &= kp > qp - window
    return m


def bound(*, ppos, bt, lane_slots, lane_pos, Hq, Hkv, D, elt, window,
          extra_bytes, dtype):
    """Least time the card needs for this call: the K/V entries some query
    can see (each read once per kv head), the positions of the pages the
    block tables reference, and q/out/tables once; the flops those visible
    keys need, at the peak rate of the inputs' type."""
    needed, flops = set(), 0
    for s, qp in zip(lane_slots, lane_pos):
        if s < 0 or qp < 0:
            continue
        for pg in bt[s][bt[s] >= 0]:
            vis = np.nonzero(visible(ppos[pg], qp, window))[0]
            needed.update((int(pg), int(o)) for o in vis)
            flops += 2 * (2 * D) * Hq * len(vis)
    pages = {int(p) for row in bt for p in row if p >= 0}
    nbytes = (len(needed) * Hkv * 2 * D * elt + len(pages) * ppos.shape[1] * 4
              + extra_bytes)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_decode_case(rng, name, *, Hq, Hkv, D, dtype, window=None,
                    softcap=None, timed=False):
    import torch
    import torch.nn.functional as F
    from repro_torch.core.kv_cache import paged_gather
    from repro_torch.kernels import decode_attention as DA
    dev = torch.device("cuda")
    slots, page, npages = 8, 16, 16
    ctx = [int(x) for x in torch.randint(1, npages * page + 1, (slots,),
                                         generator=rng, device=dev)]
    k, v, ppos, bt, ppos_np, bt_np = paged_case(
        rng, slots=slots, ctx_lens=ctx, Hq=Hq, Hkv=Hkv, D=D, page=page,
        npages=npages, dtype=dtype, device=dev)
    q = torch.randn(slots, 1, Hq, D, generator=rng, device=dev).to(dtype)
    q_pos = torch.tensor([[n - 1] for n in ctx], dtype=torch.int32,
                         device=dev)
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    out = DA.paged_decode_attention(q, k, v, ppos, bt, q_pos, **kw)
    ref = DA.paged_decode_attention_ref(q, k, v, ppos, bt, q_pos, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[str(dtype).removeprefix("torch.")]
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
    res = {"case": name, "kernel": "paged_decode_attention",
           "max_abs_err": err, "tol": tol, "ok": bool(ok)}
    if timed:
        kk, vv, kp = paged_gather({"pk": k, "pv": v, "ppos": ppos}, bt)
        mask = visible(kp[:, None, None, :], q_pos[:, :, None, None], window)
        qs, ks, vs = (q.transpose(1, 2), kk.transpose(1, 2),
                      vv.transpose(1, 2))
        elt = q.element_size()
        res.update(
            kernel_ms=time_ms(lambda: DA.paged_decode_attention(
                q, k, v, ppos, bt, q_pos, **kw)),
            plain_ms=time_ms(lambda: DA.paged_decode_attention_ref(
                q, k, v, ppos, bt, q_pos, **kw)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, scale=D ** -0.5)))
        res["bound_ms"], res["bound_by"] = bound(
            ppos=ppos_np, bt=bt_np, lane_slots=range(slots),
            lane_pos=[n - 1 for n in ctx], Hq=Hq, Hkv=Hkv, D=D, elt=elt,
            window=window, dtype=str(dtype).removeprefix("torch."),
            extra_bytes=2 * q.numel() * elt + bt_np.nbytes + 4 * slots)
    return res


def run_packed_case(rng, name, *, Hq, Hkv, D, dtype, window=None,
                    softcap=None, timed=False):
    """A full 256-lane stream: decode lanes for four slots and prefill
    chunks for the other four (one continuing, three fresh), as a
    256-token budget iteration with 8 slots schedules them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.engine import packed_width_buckets
    from repro_torch.core.kv_cache import paged_gather
    from repro_torch.kernels import decode_attention as DA
    dev = torch.device("cuda")
    slots, page, npages = 8, 16, 16
    T = packed_width_buckets(256)[-1]
    before = [100, 37, 201, 9, 60, 0, 0, 0]          # context in the pool
    seg = [1, 1, 1, 1, 90, 70, 50, 30]               # decode x4, chunks x4
    k, v, ppos, bt, ppos_np, bt_np = paged_case(
        rng, slots=slots, ctx_lens=[b + s for b, s in zip(before, seg)],
        Hq=Hq, Hkv=Hkv, D=D, page=page, npages=npages, dtype=dtype,
        device=dev)
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
    kw = dict(window=window, scale=D ** -0.5, attn_softcap=softcap)
    out = DA.paged_packed_attention(q, k, v, ppos, bt, q_pos, meta_t, **kw)
    ref = DA.paged_packed_attention_ref(q, k, v, ppos, bt, q_pos, sid, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[str(dtype).removeprefix("torch.")]
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol) \
        and not out[0, t:].any().item()
    res = {"case": name, "kernel": "paged_packed_attention",
           "max_abs_err": err, "tol": tol, "ok": bool(ok), "T": T}
    if timed:
        kk, vv, kp = paged_gather({"pk": k, "pv": v, "ppos": ppos}, bt)
        safe = sid.long().clamp(0, slots - 1)
        ks, vs = kk[safe].transpose(1, 2), vv[safe].transpose(1, 2)
        kpt = torch.where((sid >= 0)[:, None], kp[safe], -1)
        mask = visible(kpt[:, None, None, :], q_pos[0][:, None, None, None],
                       window)
        qs = q[0][:, None].transpose(1, 2)           # (T, Hq, 1, D)
        elt = q.element_size()
        res.update(
            kernel_ms=time_ms(lambda: DA.paged_packed_attention(
                q, k, v, ppos, bt, q_pos, meta_t, **kw)),
            plain_ms=time_ms(lambda: DA.paged_packed_attention_ref(
                q, k, v, ppos, bt, q_pos, sid, **kw)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, scale=D ** -0.5)))
        res["bound_ms"], res["bound_by"] = bound(
            ppos=ppos_np, bt=bt_np, lane_slots=slot_ids, lane_pos=pos,
            Hq=Hq, Hkv=Hkv, D=D, elt=elt, window=window,
            dtype=str(dtype).removeprefix("torch."),
            extra_bytes=(2 * q.numel() * elt + bt_np.nbytes + 4 * T
                         + meta.nbytes))
    return res


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_kernels():
    import torch
    rng = torch.Generator(device="cuda")
    rng.manual_seed(1234)
    bf16, fp32 = torch.bfloat16, torch.float32
    unimo = dict(Hq=16, Hkv=16, D=64)
    gqa = dict(Hq=32, Hkv=8, D=128)
    cases = []
    for run in (run_decode_case, run_packed_case):
        cases.append(run(rng, "unimo-text bf16", dtype=bf16, timed=True,
                         **unimo))
        cases.append(run(rng, "gqa bf16", dtype=bf16, **gqa))
        cases.append(run(rng, "window 64 + softcap 30 bf16", dtype=bf16,
                         window=64, softcap=30.0, **unimo))
        cases.append(run(rng, "unimo-text fp32", dtype=fp32, **unimo))
        cases.append(run(rng, "gqa window 64 + softcap 30 fp32", dtype=fp32,
                         window=64, softcap=30.0, **gqa))
    for c in cases:
        emit("kernels", **c)
    bad = [c["case"] + " / " + c["kernel"] for c in cases if not c["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    return {c["kernel"]: c for c in cases if "kernel_ms" in c}


def phase_parity():
    """Reduced unimo-text, fp32: a packed and a decode forward on the card
    against the same forwards through the plain versions on the CPU, from
    the same pools; then a short greedy serve on both devices, whose token
    streams must be identical."""
    import torch
    from repro_torch.configs.registry import get_reduced
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.precision import FP32
    from repro_torch.core.scheduler import Request
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_reduced("unimo-text")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    rng = np.random.default_rng(3)
    slots, page, npages = 4, 8, 8
    P = slots * npages + 1
    ctx = [20, 9, 0, 33]
    pk, pv = (rng.normal(size=(P, page, cfg.num_kv_heads,
                               cfg.resolved_head_dim)).astype(np.float32)
              for _ in range(2))
    ppos = np.full((P, page), -1, np.int32)
    bt = np.full((slots, npages), -1, np.int32)
    for s, n in enumerate(ctx):
        used = -(-(n + 8) // page)
        bt[s, :used] = s * npages + np.arange(used)
        for t in range(n):
            ppos[bt[s, t // page], t % page] = t
    # packed: decode lanes for slots 0 and 3, a 6-token chunk continuing
    # slot 1 and a 5-token chunk starting slot 2, 5 padding lanes
    segs = [(0, 20, 1), (3, 33, 1), (1, 9, 6), (2, 0, 5)]
    W = 16
    toks = np.zeros(W, np.int32)
    sid = np.full(W, -1, np.int32)
    pos = np.full(W, -1, np.int32)
    starts, last, t = [], [], 0
    for s, p0, ln in segs:
        starts.append(t)
        toks[t:t + ln] = rng.integers(4, 400, size=ln)
        sid[t:t + ln], pos[t:t + ln] = s, p0 + np.arange(ln)
        t += ln
        last.append(t - 1)
    meta = DA.packed_meta_table(starts, [g[2] for g in segs],
                                [g[0] for g in segs], W,
                                W // DA.PACKED_BLOCK_Q + slots)
    dec_tok = rng.integers(4, 400, size=(slots, 1)).astype(np.int32)
    dec_len = np.asarray([21, 15, 5, 34], np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        def put(a):                    # a copy: every layer owns its pool
            return torch.tensor(a, device=dev)
        p = {"layers": [{"pk": put(pk), "pv": put(pv), "ppos": put(ppos)}
                        for _ in range(cfg.num_layers)]}
        prm = {"embed": {k: v.to(dev) for k, v in params["embed"].items()},
               "final_norm": {k: v.to(dev)
                              for k, v in params["final_norm"].items()},
               "layers": [{b: {k: v.to(dev) for k, v in d.items()}
                           for b, d in layer.items()}
                          for layer in params["layers"]]}
        with torch.no_grad():
            lp, _ = T.forward_packed(
                prm, cfg, put(toks[None]), p, put(sid), put(pos),
                put(np.asarray(last, np.int32)), policy=FP32, max_len=64,
                paged={"block_tables": put(bt), "packed_meta": put(meta)})
            ld, _ = T.forward_decode(
                prm, cfg, put(dec_tok), p, put(dec_len), policy=FP32,
                max_len=64, paged={"block_tables": put(bt),
                                   "active": put(np.ones(slots, bool))})
        out[dev] = (lp.cpu(), ld.cpu())
    errs = [(a - b).abs().max().item() for a, b in zip(out["cuda"],
                                                       out["cpu"])]
    prompts = [[2] + [int(t) for t in rng.integers(4, 400, size=n)]
               for n in (19, 30, 11, 23, 7, 15)]
    prompts += [prompts[0][:12] + [5, 6, 7, 8], prompts[1][:17] + [9, 10]]
    streams = {}
    for dev in ("cuda", "cpu"):
        eng = InferenceEngine(cfg, params, policy=FP32, max_len=64,
                              max_batch=4, device=dev)
        reqs = [Request(uid=i, tokens=p, max_new_tokens=12)
                for i, p in enumerate(prompts)]
        done, m = eng.serve_continuous(reqs, page_size=8,
                                       max_batched_tokens=32)
        streams[dev] = [r.result for r in done]
    toks_all = sum(len(s) for s in streams["cpu"])
    same = sum(a == b for x, y in zip(streams["cuda"], streams["cpu"])
               for a, b in zip(x, y))
    emit("parity", packed_logits_max_abs_err=errs[0],
         decode_logits_max_abs_err=errs[1], logits_tol=1e-3,
         greedy_token_match=same / max(toks_all, 1), tokens=toks_all,
         streams_identical=streams["cuda"] == streams["cpu"])
    if not all(np.isfinite(e) and e <= 1e-3 for e in errs):
        raise SystemExit(f"card forwards differ from the plain path: {errs}")
    if streams["cuda"] != streams["cpu"]:
        raise SystemExit("greedy streams on the card differ from the CPU's")


def phase_serve():
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.precision import BF16
    from repro_torch.core.scheduler import Request
    from repro_torch.core.tokenizer import FastTokenizer
    from repro_torch.data.pipeline import synthetic_corpus
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.models import transformer as T
    cfg = get_config("unimo-text")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(gen, cfg, BF16)
    tok = FastTokenizer.train(synthetic_corpus(600), 4000)
    texts = synthetic_corpus(16, seed=7, min_len=4, max_len=40)

    def requests(n, max_new):
        return [Request(uid=i, tokens=tok.encode(t), max_new_tokens=max_new)
                for i, t in enumerate(texts[:n])]

    kw = dict(max_batch=8, max_len=256, device="cuda")
    # warm-up on its own engine (cuBLAS handles, allocator pools)
    InferenceEngine(cfg, params, policy=BF16, **kw).serve_continuous(
        requests(4, 4))
    eng = InferenceEngine(cfg, params, policy=BF16, **kw)
    reqs = requests(16, 32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    DA.reset_launch_counts()
    t0 = time.perf_counter()
    done, m = eng.serve_continuous(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = DA.launch_counts()
    n_layers = cfg.num_layers
    decode_steps = m.steps - m.mixed_dispatches
    out_ok = all(r.outcome is not None and r.outcome.status == "completed"
                 and all(0 <= t < cfg.vocab_size for t in r.result)
                 for r in done)
    emit("serve", arch=cfg.name, layers=n_layers, policy="bf16",
         requests=len(done), generated_tokens=m.generated_tokens,
         wall_s=wall, tokens_per_s=m.generated_tokens / wall,
         ttft_p50_s=m.ttft_p50, ttft_p99_s=m.ttft_p99, itl_p50_s=m.itl_p50,
         itl_p99_s=m.itl_p99, host_frac=m.host_frac, host_s=m.host_s,
         device_s=m.device_s, mixed_iters=m.mixed_iters,
         mixed_dispatches=m.mixed_dispatches, decode_steps=decode_steps,
         dispatches_per_iter=m.dispatches_per_iter,
         padded_token_frac=m.padded_token_frac,
         prefix_hits=m.prefix_hits, cow_copies=m.cow_copies,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         launches=launches, outcomes=m.outcome_counts)
    checks = {
        "all requests completed with in-vocab tokens": out_ok,
        "one dispatch per mixed iteration": m.dispatches_per_iter == 1.0,
        "packed kernel ran 24 x mixed dispatches": (
            launches["paged_packed_attention"]
            == n_layers * m.mixed_dispatches > 0),
        "decode kernel ran 24 x decode steps": (
            launches["paged_decode_attention"]
            == n_layers * decode_steps > 0),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"serve phase failed: {failed}")

    # the same serve once more, under torch.profiler, on a fresh engine:
    # device time by kernel, and the device's busy share of the measured
    # (unprofiled) wall time above
    from torch.profiler import ProfilerActivity, profile
    eng = InferenceEngine(cfg, params, policy=BF16, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.serve_continuous(requests(16, 32))
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_s = sum(us for us, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    ours = {name: {"ms": us / 1e3, "count": n}
            for name in ("paged_decode_kernel", "paged_packed_kernel")
            for k, (us, n) in by_name.items() if name in k}
    emit("profile", device_busy_s=busy_s, measured_wall_s=wall,
         device_idle_frac=max(0.0, 1.0 - busy_s / wall),
         kernels_launched=sum(n for _, n in by_name.values()),
         port_kernels=ours,
         top=[{"kernel": k[:90], "ms": us / 1e3, "count": n}
              for k, (us, n) in top])
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
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
         ptxas=[ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "Compiling entry" in ln])

    timed = phase_kernels()
    phase_parity()
    launches = phase_serve()

    kernels = []
    for name in ("paged_decode_attention", "paged_packed_attention"):
        c = timed[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": c["max_abs_err"], "ms": c["kernel_ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
