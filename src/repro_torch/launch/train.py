"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

The port's counterpart of ``repro.launch.train``, with its ten flags and
``--device`` (``cuda`` by default, which raises without a card; ``cpu``
runs the kernels' plain versions).  On the card every attention layer's
forward and backward run through the hand-written flash kernels.  It
trains the full config, or the reduced one with ``--reduced``, on the
Zipf corpus packed into batches (random tokens with
``--synthetic-tokens``, and always for audio and vision configs, whose
prefix embeddings come from a seeded ``torch.Generator``), and prints one
JSON line per logged step with the reference's keys.

    PYTHONPATH=src python -m repro_torch.launch.train --arch unimo-text \\
        --reduced --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.registry import get_config, get_reduced, list_archs
from repro_torch.core.engine import resolve_device
from repro_torch.core.precision import get_policy
from repro_torch.core.tokenizer import FastTokenizer
from repro_torch.data.pipeline import packed_batches, random_batches, \
    synthetic_corpus
from repro_torch.models import transformer as T
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import optimizer as OPT
from repro_torch.training.train_loop import make_train_step, to_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced variant (CPU-sized)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--policy", default="fp32",
                    choices=["fp32", "bf16", "fp16", "mixed"])
    ap.add_argument("--synthetic-tokens", action="store_true",
                    help="random tokens instead of the Zipf corpus")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    policy = get_policy(args.policy)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = T.init_params(gen, cfg, policy)
    n_params = sum(t.numel() for t in OPT.flatten(params).values())
    print(f"arch={cfg.name} layers={cfg.num_layers} params={n_params:,}")

    if args.synthetic_tokens or cfg.num_codebooks or cfg.num_prefix_embeds:
        batches = random_batches(cfg.vocab_size, batch_size=args.batch_size,
                                 seq_len=args.seq_len,
                                 num_codebooks=cfg.num_codebooks)
    else:
        corpus = synthetic_corpus(2000)
        tok = FastTokenizer.train(corpus, min(cfg.vocab_size, 4000))
        batches = packed_batches(tok, corpus, batch_size=args.batch_size,
                                 seq_len=args.seq_len)

    opt_cfg = OPT.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                              total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, policy=policy)
    opt_state = OPT.init_state(params)

    t0 = time.time()
    toks_seen = 0
    for i in range(args.steps):
        batch = to_device(next(batches), device)
        if cfg.num_prefix_embeds:
            batch["prefix_embeds"] = 0.02 * torch.randn(
                args.batch_size, cfg.num_prefix_embeds, cfg.d_model,
                generator=gen, device=device)
        params, opt_state, m = step_fn(params, opt_state, batch)
        toks_seen += args.batch_size * args.seq_len
        if i % args.log_every == 0 or i == args.steps - 1:
            loss, gnorm = float(m["loss"]), float(m["gnorm"])
            dt = time.time() - t0
            print(json.dumps({"step": i, "loss": round(loss, 4),
                              "lr": float(m["lr"]),
                              "gnorm": round(gnorm, 3),
                              "tok_per_s": int(toks_seen / max(dt, 1e-9))}),
                  flush=True)
    if args.checkpoint:
        CKPT.save(args.checkpoint, params, opt_state,
                  meta={"arch": cfg.name, "steps": args.steps})
        print(f"checkpoint -> {args.checkpoint}")


if __name__ == "__main__":
    main()
