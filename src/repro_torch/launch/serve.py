"""Serving launcher for the port.

Without ``--continuous`` it serves the paper's own stack: length-bucketed
batches over a dense KV cache, through the staged pipeline (tokenize ||
infer || detokenize) or, with ``--no-pipeline``, sequentially;
``--no-kv-cache`` re-runs the full forward for every token (the paper's
Table-1 baseline).  ``python -m repro_torch.launch.serve --arch qwen3-4b
--full`` prints one JSON line of requests/s, decode tokens/s and prefill
seconds.

With ``--continuous`` it serves through continuous batching over the paged
KV cache: ``--kv-dtype int8 --weights-dtype int8``, ``--spec ngram|draft
--spec-k 4`` for speculative decoding, ``--packed off`` for the per-chunk
mixed path, ``--chunked-prefill off`` for bucketed whole-prompt admission
(families that cannot share pages, such as ``--arch xlstm-125m``,
``hymba-1.5b`` or ``deepseek-v3-671b``, are always admitted that way).  ``--preemption
lru|priority --host-kv-bytes N`` survives pool pressure by preempting
slots into a host KV tier, ``--trace-out PATH`` writes the serve loop's
event trace, ``--metrics-json PATH`` every metric and the active
``REPRO_PERF_OPTS`` flags (``perf_flags``, read by the model code: e.g.
``moe_ragged`` for the MoE archs); it prints one JSON line
of throughput, latency and scheduler metrics.  ``--prune-coverage`` /
``--prune-vocab`` serve a pruned vocabulary (the paper's embedding-layer
pruning) on either path.

Everything runs on the card (``--device cuda``, the default); ``--device
cpu`` runs the kernels' plain versions.  Weights are random, drawn from a
seeded ``torch.Generator``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch import perf_flags
from repro_torch.configs.registry import get_config, get_reduced, list_archs
from repro_torch.core import pruning as PR
from repro_torch.core import trace as TR
from repro_torch.core.engine import InferenceEngine, resolve_device
from repro_torch.core.pipeline import run_pipelined, run_sequential
from repro_torch.core.precision import (KV_DTYPES, WEIGHTS_DTYPES,
                                        get_policy)
from repro_torch.core.sampling import SamplingParams
from repro_torch.core.scheduler import Request
from repro_torch.core.speculative import SpecConfig
from repro_torch.core.tokenizer import FastTokenizer
from repro_torch.data.pipeline import synthetic_corpus
from repro_torch.models import transformer as T


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="unimo-text", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--no-kv-cache", action="store_true",
                    help="the paper's baseline: every token re-runs the "
                         "full forward (without --continuous)")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="sequential stages instead of the pipelined "
                         "tokenize || infer || detokenize (without "
                         "--continuous)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over a paged KV cache "
                         "instead of bucket batches")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--policy", default="bf16",
                    choices=["fp32", "bf16", "fp16"])
    ap.add_argument("--kv-dtype", default="auto", choices=list(KV_DTYPES),
                    help="paged KV pool storage: auto = compute dtype; int8 "
                         "stores codes + per-entry fp32 scales")
    ap.add_argument("--weights-dtype", default="auto",
                    choices=list(WEIGHTS_DTYPES),
                    help="serve-path matmul weight storage: auto = policy "
                         "param dtype; int8 = per-output-channel quantized "
                         "codes through the quant_matmul kernel")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--steps-per-sync", type=int, default=4)
    ap.add_argument("--max-batched-tokens", type=int, default=None,
                    help="per-iteration token budget of the unified "
                         "scheduler (default: engine default, 256)")
    ap.add_argument("--chunked-prefill", default="auto",
                    choices=["auto", "on", "off"],
                    help="unified token-budget iterations with chunked "
                         "prefill (auto = on for families that support "
                         "it; off = bucketed whole-prompt admission)")
    ap.add_argument("--prefix-cache", default="auto",
                    choices=["auto", "on", "off"],
                    help="radix prefix cache: share identical prompt-prefix "
                         "KV pages across requests (auto = on)")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="prepend one shared N-token system prompt to "
                         "every request")
    ap.add_argument("--spec", default="off",
                    choices=["off", "ngram", "draft"],
                    help="speculative decoding: ngram = prompt-lookup "
                         "drafter (no weights), draft = draft-model "
                         "drafter (self-drafting with the served model); "
                         "greedy streams equal --spec off")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafted tokens per slot per verify step")
    ap.add_argument("--packed", default="auto",
                    choices=["auto", "on", "off"],
                    help="token-packed execution of iterations with "
                         "prefill chunks (auto = on); off = one decode "
                         "step plus one mixed forward per chunk (the A/B "
                         "baseline)")
    ap.add_argument("--preemption", default="off",
                    choices=["off", "lru", "priority"],
                    help="when admission fails for pages while a slot is "
                         "free, evict a decoding victim (lru = most "
                         "recently admitted, priority = lowest "
                         "Request.priority) into the host KV tier and "
                         "re-queue it; greedy streams are unchanged")
    ap.add_argument("--host-kv-bytes", type=int, default=None,
                    help="host-memory KV tier capacity in bytes: preempted "
                         "slots' page snapshots and spilled prefix-cache "
                         "pages (default: none; preemption then resumes "
                         "by prefilling the context again)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline in seconds on the serve "
                         "clock: requests still queued past it are "
                         "cancelled (timed_out)")
    ap.add_argument("--debug-audit", action="store_true",
                    help="audit allocator refcounts and host-tier bytes "
                         "on every serve iteration")
    ap.add_argument("--prune-coverage", type=float, default=None,
                    help="prune the vocabulary to this corpus coverage "
                         "(e.g. 0.999), the paper's embedding pruning")
    ap.add_argument("--prune-vocab", type=int, default=None, metavar="N",
                    help="prune the vocabulary to the N most frequent "
                         "corpus tokens (exclusive with --prune-coverage); "
                         "prompts and results stay in the original ids")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the serve loop's structured event trace "
                         "(iterations, request lifecycles, scheduler "
                         "decisions, device spans)")
    ap.add_argument("--trace-format", default="jsonl",
                    choices=["jsonl", "perfetto", "both"],
                    help="jsonl = one schema-versioned event per line; "
                         "perfetto = Chrome trace-event JSON; both = "
                         "<PATH>.jsonl and <PATH>.perfetto.json")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write every ServeMetrics counter and derived "
                         "property as one JSON object")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-len", type=int, default=256)
    args = ap.parse_args(argv)
    if args.prune_coverage and args.prune_vocab:
        raise SystemExit("--prune-coverage and --prune-vocab are mutually "
                         "exclusive")
    if (args.trace_out or args.metrics_json) and not args.continuous:
        raise SystemExit("--trace-out/--metrics-json require --continuous")

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.num_codebooks or cfg.num_prefix_embeds:
        raise SystemExit("serve.py drives text archs; audio/VLM backbones "
                         "are exercised via dryrun + smoke tests")
    policy = dataclasses.replace(get_policy(args.policy),
                                 kv_dtype=args.kv_dtype,
                                 weights_dtype=args.weights_dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = T.init_params(gen, cfg, policy)

    corpus = synthetic_corpus(600)
    tok = FastTokenizer.train(corpus, min(cfg.vocab_size, 4000))
    texts = synthetic_corpus(args.requests, seed=7, min_len=4, max_len=40)
    maps = None
    if args.prune_coverage or args.prune_vocab:
        freqs = tok.count_frequencies(corpus)
        params, cfg, maps = PR.prune_model(
            params, cfg, dict(freqs), coverage=args.prune_coverage,
            max_vocab=args.prune_vocab)
        print(f"pruned vocab -> {cfg.vocab_size}")
    engine = InferenceEngine(cfg, params, policy=policy,
                             max_batch=args.max_batch, max_len=args.max_len,
                             use_kv_cache=not args.no_kv_cache,
                             device=device, prune_maps=maps)
    sp = SamplingParams(temperature=args.temperature,
                        top_k=40 if args.temperature > 0 else 0)
    dev_name = (torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu")
    if not args.continuous:
        runner = run_sequential if args.no_pipeline else run_pipelined
        t0 = time.time()
        results = runner(texts, tok, engine,
                         max_new_tokens=args.max_new_tokens, sp=sp,
                         max_batch=args.max_batch)
        dt = time.time() - t0
        for r in results[:3]:
            print(f"[{r.uid}] {r.text[:70]!r}")
        st = engine.stats
        print(json.dumps({
            "requests": len(results), "wall_s": round(dt, 3),
            "device": dev_name,
            "requests_per_s": round(len(results) / dt, 3),
            "generated_tokens": st.generated_tokens,
            "decode_tok_per_s": round(st.generated_tokens / st.decode_s, 1)
            if st.decode_s else None,
            "prefill_s": round(st.prefill_s, 3),
            "mode": "baseline-nocache" if args.no_kv_cache else "kv-cache",
            "pipelined": not args.no_pipeline}))
        return
    shared = tok.encode(" ".join(synthetic_corpus(
        3, seed=11)))[:args.shared_prefix] if args.shared_prefix else []
    reqs = [Request(uid=i, tokens=shared + tok.encode(t),
                    max_new_tokens=args.max_new_tokens,
                    deadline=args.deadline)
            for i, t in enumerate(texts)]
    onoff = {"auto": None, "on": True, "off": False}
    spec = None
    if args.spec != "off":
        spec = SpecConfig(k=args.spec_k, drafter=(
            "ngram" if args.spec == "ngram" else "draft_model"))
    tracer = TR.ServeTracer() if args.trace_out else None
    t0 = time.time()
    done, metrics = engine.serve_continuous(
        reqs, sp, page_size=args.page_size,
        steps_per_sync=args.steps_per_sync,
        prefix_cache=onoff[args.prefix_cache],
        max_batched_tokens=args.max_batched_tokens, spec=spec,
        chunked_prefill=onoff[args.chunked_prefill],
        packed=onoff[args.packed], preemption=args.preemption,
        host_kv_bytes=args.host_kv_bytes, debug_audit=args.debug_audit,
        trace=tracer)
    dt = time.time() - t0
    for r in done[:3]:
        print(f"[{r.uid}] {tok.decode(r.result or [])[:70]!r}")
    if tracer is not None:
        for p in TR.export(tracer, args.trace_out, args.trace_format):
            print(f"trace: {p} ({len(tracer.events)} events, "
                  f"{tracer.dropped} dropped)")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump({"requests": len(done), "wall_s": dt,
                       "tokens_per_s": metrics.generated_tokens / dt,
                       "mode": "continuous-paged",
                       "perf_opts": perf_flags.active(), **metrics.to_dict()},
                      f, indent=1)
        print(f"metrics: {args.metrics_json}")
    print(json.dumps({
        "requests": len(done), "wall_s": round(dt, 3),
        "device": dev_name,
        "generated_tokens": metrics.generated_tokens,
        "tokens_per_s": round(metrics.generated_tokens / dt, 1),
        "p50_latency_s": round(metrics.percentile_latency(50), 3),
        "p99_latency_s": round(metrics.percentile_latency(99), 3),
        "ttft_p50_s": round(metrics.ttft_p50, 4),
        "ttft_p99_s": round(metrics.ttft_p99, 4),
        "itl_p50_s": round(metrics.itl_p50, 4),
        "itl_p99_s": round(metrics.itl_p99, 4),
        "scheduler": metrics.scheduler,
        "max_batched_tokens": metrics.max_batched_tokens,
        "prefill_chunks": metrics.prefill_chunks,
        "spec_mode": metrics.spec_mode,
        "spec_k": metrics.spec_k,
        "acceptance_rate": round(metrics.acceptance_rate, 3),
        "tokens_per_forward": round(metrics.tokens_per_forward, 3),
        "decode_idle_frac": round(metrics.decode_idle_frac, 3),
        "dispatches_per_iter": round(metrics.dispatches_per_iter, 3),
        "padded_token_frac": round(metrics.padded_token_frac, 3),
        "host_frac": round(metrics.host_frac, 3),
        "host_s": round(metrics.host_s, 3),
        "device_s": round(metrics.device_s, 3),
        "prefix_hit_rate": round(metrics.prefix_hit_rate, 3),
        "prefix_matched_tokens": metrics.prefix_matched_tokens,
        "pages_shared": metrics.pages_shared,
        "cow_copies": metrics.cow_copies,
        "kv_dtype": metrics.kv_dtype,
        "kv_pool_bytes": metrics.kv_pool_bytes,
        "kv_bytes_per_token": round(metrics.kv_bytes_per_token, 1),
        "weight_dtype": metrics.weight_dtype,
        "weight_bytes": metrics.weight_bytes,
        "host_syncs": metrics.host_syncs,
        "peak_pages_in_use": metrics.peak_pages_in_use,
        "admission_stalls": metrics.admission_stalls,
        "preemptions": metrics.preemptions,
        "resumed": metrics.resumed,
        "offloaded_pages": metrics.offloaded_pages,
        "restored_pages": metrics.restored_pages,
        "host_bytes_peak": metrics.host_bytes_peak,
        "timed_out": metrics.timed_out,
        "deadline_misses": metrics.deadline_misses,
        "outcomes": dict(sorted(metrics.outcome_counts.items())),
        "mode": "continuous-paged"}))


if __name__ == "__main__":
    main()
