"""Inference engine (the port's counterpart of ``repro.core.engine``),
where the paper's pillars compose.

* ``generate_batch`` / ``serve``: the paper's own serving path.  Length-
  bucketed batches (``DynamicBatcher``) run a prefill over a dense per-slot
  KV cache, then one decode step per token (P1); with
  ``use_kv_cache=False`` every token re-runs the full forward (the paper's
  Table-1 baseline).  ``core.pipeline`` overlaps tokenization and
  detokenization with it (P4).
* ``serve_continuous``: continuous batching over a paged KV pool.
  Attention models run the unified token-budget scheduler with radix
  prefix sharing and fused multi-step decode; an iteration that carries
  prefill chunks runs token-packed (one (1, T) dispatch, the default) or,
  with ``packed=False``, as the reference's A/B baseline (a one-step decode
  plus one (1, W-bucket) mixed forward per chunk).  With
  ``chunked_prefill=False``, and always for layer families that cannot
  share pages (recurrent xLSTM, windowed rings, hybrid SSM state, MLA
  latents, capacity-routed MoE), admissions are bucketed instead: each
  group of equal-bucket prompts prefills whole in one dispatch, after any
  shared prefix pinned by ``set_prefix`` or cached in the trie.  With a
  ``SpecConfig``, decode-only iterations run draft-verify steps.  Under
  pool pressure a decoding slot can be preempted into a host KV tier and
  resumed; a :class:`~repro_torch.core.trace.ServeTracer` records the
  loop's event timeline.

An engine built on a pruned vocabulary (``prune_maps``) remaps prompts
and unmaps results on every path.  The engine runs on the card by default
(``device="cuda"``) and raises when no CUDA device is present; pass
``device="cpu"`` to run the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import (ATTN, HYBRID, MOE_FFN, ModelConfig,
                                      layer_specs)
from repro_torch.core import kv_cache as KV
from repro_torch.core import prefix_cache as PC
from repro_torch.core import pruning as PR
from repro_torch.core.continuous import (ContinuousScheduler, FaultConfig,
                                         HostKVStore, PageAllocator,
                                         ServeMetrics)
from repro_torch.core.precision import (BF16, Policy, compress_weights,
                                        map_params)
from repro_torch.core.sampling import (SamplingParams, sample,
                                      speculative_verify)
from repro_torch.core.scheduler import (DEFAULT_BUCKETS, DynamicBatcher,
                                        Request, pad_batch, pick_bucket,
                                        truncate_prompt)
from repro_torch.core.speculative import SpecConfig, get_drafter
from repro_torch.core.tokenizer import EOS
from repro_torch.kernels import decode_attention as DA
from repro_torch.models import transformer as T

# Default per-iteration token budget of the unified scheduler.
DEFAULT_MAX_BATCHED_TOKENS = 256


def mixed_width_buckets(budget: int) -> tuple:
    """Padded widths of the ``packed=False`` path's chunk rows: powers of
    two from 8 below the budget, then the budget itself."""
    return tuple(w for w in (8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                             4096) if w < budget) + (budget,)


def packed_width_buckets(budget: int) -> tuple:
    """Stream widths a packed (1, T) iteration pads to: multiples of the
    packed kernel's 8-lane query window on a <=32-step ladder whose step
    scales with the budget."""
    cap = -(-budget // 8) * 8                # budget, 8-lane aligned
    step = max(8, -(-(cap // 32) // 8) * 8)  # ~cap/32, 8-lane aligned
    return tuple(sorted({min(i * step, cap)
                         for i in range(1, -(-cap // step) + 1)}))


@dataclass
class EngineStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    nocache_s: float = 0.0
    prompt_tokens: int = 0
    generated_tokens: int = 0
    batches: int = 0

    def merge(self, other: "EngineStats"):
        for f in self.__dataclass_fields__:
            setattr(self, f, getattr(self, f) + getattr(other, f))


def resolve_device(device) -> torch.device:
    """The device an entry point runs on (a bare "cuda" is the current
    card); a CUDA request without a CUDA device raises instead of
    carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the port runs on "
                           "the card by default (pass device='cpu' to run "
                           "the kernels' plain PyTorch versions)")
    if dev.type == "cuda" and dev.index is None:
        # pinned to the current card, so another thread can select it
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class InferenceEngine:
    """Single-host serving engine for one model on one device.

    ``prune_maps`` (from :func:`~repro_torch.core.pruning.prune_model`)
    marks ``cfg``/``params`` as a pruned-vocabulary model: requests come
    and go in the original ids, remapped at submission and unmapped on
    the way out.  ``use_kv_cache=False`` makes ``generate_batch`` the
    no-cache baseline."""

    def __init__(self, cfg: ModelConfig, params, *, policy: Policy = BF16,
                 max_batch: int = 8, max_len: int = 512,
                 use_kv_cache: bool = True, seed: int = 0, device="cuda",
                 prune_maps: Optional[PR.PruneMaps] = None):
        self.device = resolve_device(device)
        T.check_supported(cfg)
        if cfg.num_codebooks:
            # the reference's engine has no multi-codebook decoding either
            # (its (B, S, C) tokens fail there with a shape error)
            raise NotImplementedError(
                f"{cfg.name}: num_codebooks={cfg.num_codebooks} — the "
                f"engine serves single-stream token ids; drive a "
                f"multi-codebook model through the forwards of "
                f"repro_torch.models.transformer")
        self.cfg = cfg
        self.policy = policy
        self.prune_maps = prune_maps
        self.params = policy.cast_params(
            map_params(lambda p: p.to(self.device), params))
        t_q = time.perf_counter()
        self.params, self.weight_stats = compress_weights(self.params,
                                                          policy)
        self._sync()
        self.weight_quant_s = time.perf_counter() - t_q
        self.max_batch = max_batch
        self.max_len = max_len
        self.use_kv_cache = use_kv_cache
        self.stats = EngineStats()
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self._paged_ctx = None         # persistent paged pool + radix trie
        self.spec = None               # SpecConfig of the last spec serve
        self.drafter = None            # ... and its drafter (kept)

    def prompt_buckets(self):
        """Prompt length buckets bounded by the engine context."""
        return tuple(b for b in DEFAULT_BUCKETS if b < self.max_len) \
            + (self.max_len,)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- the paper's serving path: bucketed batches over a dense cache ------
    @torch.no_grad()
    def generate_batch(self, tokens: np.ndarray, lengths: np.ndarray,
                       max_new_tokens: int,
                       sp: SamplingParams = SamplingParams(),
                       stop_at_eos: bool = True) -> np.ndarray:
        """tokens: (B, L) right-padded int32, lengths: (B,).  Returns
        (B, max_new_tokens) ids, -1 after EOS (EOS itself is not
        emitted)."""
        if self.prune_maps is not None:
            tokens = PR.remap_tokens(tokens, self.prune_maps)
        gen = self._generate_kv if self.use_kv_cache \
            else self._generate_nocache
        out = gen(tokens, lengths, max_new_tokens, sp, stop_at_eos)
        if self.prune_maps is not None:
            out = np.where(out >= 0, PR.unmap_tokens(
                np.maximum(out, 0), self.prune_maps), out)
        return out

    def _generate_kv(self, tokens, lengths, max_new, sp, stop_at_eos):
        """Prefill the bucket into a fresh dense cache, then decode.  The
        greedy path runs its ``max_new - 1`` decode steps back to back on
        the device with the reference's EOS rule (a finished row feeds
        token 0 and emits -1) and copies the ids to the host once; the
        sampled path reads each step's token."""
        B = tokens.shape[0]
        cache = T.init_cache(self.cfg, B, self.max_len,
                             self.policy.kv_cache_dtype(dense=True),
                             device=self.device)
        t0 = time.perf_counter()
        lens = self._put(np.asarray(lengths, np.int32))
        logits, _ = T.forward_prefill(
            self.params, self.cfg, self._put(np.asarray(tokens, np.int32)),
            lens, cache, policy=self.policy, max_len=self.max_len)
        self._sync()
        t1 = time.perf_counter()
        out = np.full((B, max_new), -1, np.int64)
        rows = torch.arange(B, device=self.device)
        first = sample(logits[rows, lens.long() - 1], self.gen, sp)

        def step(tok, pos):
            logits1, _ = T.forward_decode(
                self.params, self.cfg, tok[:, None], cache, pos,
                policy=self.policy, max_len=self.max_len)
            return logits1[:, 0]

        if sp.temperature <= 0.0 and max_new > 1 and stop_at_eos:
            first = first.to(torch.int32)
            done = first == EOS
            emits = [torch.where(done, -1, first)]
            tok = torch.where(done, 0, first)
            for i in range(max_new - 1):
                nxt = torch.argmax(step(tok, lens + i), -1).to(torch.int32)
                nxt = torch.where(done, 0, nxt)
                done = done | (nxt == EOS)
                emits.append(torch.where(done, -1, nxt))
                tok = nxt
            out[:] = torch.stack(emits, 1).cpu().numpy()
        else:
            done = np.zeros((B,), bool)
            nxt = first
            for i in range(max_new):
                nxt_np = nxt.cpu().numpy()
                if stop_at_eos:
                    done |= nxt_np == EOS
                out[~done, i] = nxt_np[~done]
                if done.all() or i == max_new - 1:
                    break
                nxt = sample(step(nxt, lens + i), self.gen, sp)
        self._sync()
        t2 = time.perf_counter()
        self.stats.merge(EngineStats(
            prefill_s=t1 - t0, decode_s=t2 - t1,
            prompt_tokens=int(np.sum(lengths)),
            generated_tokens=int((out >= 0).sum()), batches=1))
        return out

    def _generate_nocache(self, tokens, lengths, max_new, sp, stop_at_eos):
        """The paper's Table-1 baseline: every token re-runs the full
        forward over the (B, L + max_new) buffer, each row's new token
        written after its last one."""
        B, L = tokens.shape
        buf = np.zeros((B, L + max_new), np.int32)
        buf[:, :L] = tokens
        lens = np.asarray(lengths).copy()
        out = np.full((B, max_new), -1, np.int64)
        done = np.zeros((B,), bool)
        rows = torch.arange(B, device=self.device)
        t0 = time.perf_counter()
        for i in range(max_new):
            logits = T.forward_train(self.params, self.cfg, self._put(buf),
                                     policy=self.policy, remat=False)[0]
            last = logits[rows, self._put(lens - 1).long()]
            nxt = sample(last, self.gen, sp).cpu().numpy()
            if stop_at_eos:
                done |= nxt == EOS
            out[~done, i] = nxt[~done]
            buf[np.arange(B), lens] = np.where(done, 0, nxt)
            lens = lens + (~done).astype(lens.dtype)
            if done.all():
                break
        t1 = time.perf_counter()
        self.stats.merge(EngineStats(
            nocache_s=t1 - t0, prompt_tokens=int(np.sum(lengths)),
            generated_tokens=int((out >= 0).sum()), batches=1))
        return out

    def serve(self, requests: List[Request],
              sp: SamplingParams = SamplingParams()) -> List[Request]:
        """The request-level API of the bucketed path: sort by length,
        batch by bucket (``DynamicBatcher``), ``generate_batch`` each
        batch; fills ``r.result``."""
        batcher = DynamicBatcher(max_batch=self.max_batch,
                                 buckets=self.prompt_buckets())
        for r in requests:
            batcher.add(r)
        while True:
            batch = batcher.next_batch()
            if batch is None:
                break
            toks, lens = pad_batch(batch)
            max_new = max(r.max_new_tokens for r in batch.requests)
            gen = self.generate_batch(toks, lens, max_new, sp)
            for i, r in enumerate(batch.requests):
                row = gen[i]
                r.result = [int(t) for t in row[row >= 0]][:r.max_new_tokens]
        return requests

    # -- prefix caching: a shared prompt prefilled once and pinned --------
    @torch.no_grad()
    def set_prefix(self, prefix_tokens, *, page_size: int = 16,
                   num_pages: Optional[int] = None,
                   slots: Optional[int] = None) -> None:
        """Prefill a shared prompt prefix into the paged pool once and pin
        it in the radix prefix cache: every later request of
        :meth:`serve_continuous` that starts with these tokens maps its
        pages and prefills only its own suffix.  Families that cannot
        share pages (``prefix_cache.shareable``) warn and do nothing.  The
        geometry must match the later serves' (they share the pool)."""
        toks = [int(t) for t in prefix_tokens]
        reason = PC.shareable(self.cfg, self.max_len)
        if reason is not None:
            warnings.warn(f"set_prefix: prefix sharing disabled — {reason}")
            return
        if len(toks) > self.max_len - 1:
            raise ValueError(f"prefix of {len(toks)} tokens leaves no room "
                             f"to generate within max_len={self.max_len}")
        ctx = self._paged_context(page_size, num_pages, slots)
        n = -(-len(toks) // page_size)
        pages = ctx["alloc"].alloc(n)
        if pages is None:
            ctx["trie"].evict(n - ctx["alloc"].free_count)
            pages = ctx["alloc"].alloc(n)
        if pages is None:
            raise ValueError(f"prefix needs {n} pages; pool has only "
                             f"{ctx['alloc'].free_count} free")
        row = np.full((1, ctx["pages_per_slot"]), -1, np.int32)
        row[0, :n] = pages
        reset = np.where(row >= 0, row, ctx["dump"]).astype(np.int32)
        self._admit_step(ctx["cache"], np.asarray([toks], np.int32),
                         np.asarray([len(toks)], np.int32),
                         np.zeros((1,), np.int32), row, reset,
                         SamplingParams())
        self._sync()
        # the trie takes its own reference on the pages; ours drops
        ctx["trie"].insert(toks, pages, len(toks), pin=True)
        for p in pages:
            ctx["alloc"].decref(p)

    def clear_prefix(self) -> None:
        """Unpin every seeded prefix: its pages stay cached as ordinary
        LRU-evictable entries."""
        if self._paged_ctx is not None:
            self._paged_ctx["trie"].unpin_all()

    def reset_prefix_cache(self) -> None:
        """Drop the persistent paged pool and radix trie (a cold cache)."""
        self._paged_ctx = None

    # -- continuous batching (paged KV, in-flight admission) --------------
    def _paged_context(self, page_size: int, num_pages: Optional[int],
                       slots: Optional[int]) -> dict:
        """The persistent paged serving context: pool tensors, refcounted
        allocator and radix prefix trie.  It survives across
        ``serve_continuous`` calls; a geometry change rebuilds it."""
        slots = slots or self.max_batch
        pages_per_slot = -(-self.max_len // page_size)
        if num_pages is None:
            num_pages = slots * pages_per_slot
        key = (page_size, num_pages, slots)
        if self._paged_ctx is not None and self._paged_ctx["key"] == key:
            return self._paged_ctx
        if self._paged_ctx is not None:
            warnings.warn(
                f"paged pool geometry changed {self._paged_ctx['key']} -> "
                f"{key}; rebuilding (cached prefixes are dropped)")
        if self.policy.kv_dtype == "int8" and not any(
                spec.mixer == ATTN for spec in layer_specs(self.cfg)):
            warnings.warn("kv_dtype=int8 requested but no attention layer "
                          "has a paged pool to quantize; state stays at "
                          "full precision")
        alloc = PageAllocator(num_pages)
        cache = T.init_paged_cache(
            self.cfg, num_pages=num_pages, page_size=page_size,
            dtype=self.policy.compute_dtype, kv_dtype=self.policy.kv_dtype,
            max_slots=slots, max_len=self.max_len, device=self.device)
        pool_bytes = KV.paged_pool_bytes(cache)
        self._paged_ctx = {
            "key": key, "page_size": page_size, "num_pages": num_pages,
            "slots": slots, "pages_per_slot": pages_per_slot,
            "dump": num_pages, "alloc": alloc,
            "kv_dtype": self.policy.kv_dtype, "kv_pool_bytes": pool_bytes,
            "kv_bytes_per_token": pool_bytes / ((num_pages + 1) * page_size),
            "trie": PC.RadixPrefixCache(alloc, page_size),
            "cache": cache,
        }
        return self._paged_ctx

    def _init_pages(self, cache, reset_rows, cow_src, cow_dst, cow_keep):
        """Reset admitting slots' fresh pages, then copy their partial COW
        tail pages (dump-page rows are no-ops)."""
        KV.reset_pages_all(cache, self._put(reset_rows))
        KV.copy_pages_all(cache, self._put(cow_src), self._put(cow_dst),
                          self._put(cow_keep))

    def _admit_step(self, cache, toks, plens, slots, block_rows,
                    reset_rows, sp, start=None, cow=None):
        """One bucketed admission dispatch: the reference's ``admit_fn``,
        or with per-row ``start`` offsets its ``admit_prefix_fn``.  Reset
        the group's fresh pages, copy each row's partial COW tail page
        (``cow``: source, target and kept length per row), prefill the
        prompts (or their suffixes after a shared prefix, which they
        attend through the gathered block table) on a fresh slot view,
        scatter the view's state into the group's slots and sample each
        row's first token."""
        if cow is None:
            KV.reset_pages_all(cache, self._put(reset_rows))
        else:
            self._init_pages(cache, reset_rows, *cow)
        view = KV.slot_view(cache, toks.shape[0])
        logits, view = T.forward_prefill(
            self.params, self.cfg, self._put(toks), self._put(plens), view,
            policy=self.policy, max_len=self.max_len, last_only=True,
            start=0 if start is None else self._put(start),
            paged={"block_tables": self._put(block_rows)})
        KV.slot_merge(cache, view, self._put(slots))
        return sample(logits[:, 0], self.gen, sp)

    def _packed_step(self, cache, pb, meta, block_tables, init, sp):
        """One token-packed iteration on the device: page init, the packed
        forward (K/V scattered into each lane's own slot pages), and a
        sample of every segment's last token.  Host arrays are copied to
        the device once here, not once per layer."""
        self._init_pages(cache, *init)
        logits, _ = T.forward_packed(
            self.params, self.cfg, self._put(pb.tokens[None, :]), cache,
            self._put(pb.slot_ids), self._put(pb.positions),
            self._put(pb.last_idx), policy=self.policy,
            max_len=self.max_len,
            paged={"block_tables": self._put(block_tables),
                   "packed_meta": self._put(meta)})
        return sample(logits[0], self.gen, sp)             # (S,)

    def _mixed_step(self, cache, toks, start, length, bt_row, init, sp):
        """One prefill chunk of the ``packed=False`` path: page init (on the
        slot's first chunk), a (1, W) mixed forward that writes the chunk's
        K/V and attends the slot's pages, and a sample of its last token
        (a device tensor, read only for a prompt's final chunk)."""
        self._init_pages(cache, *init)
        logits, _ = T.forward_mixed(
            self.params, self.cfg, self._put(toks), cache,
            self._put(np.asarray([start], np.int32)),
            self._put(np.asarray([length], np.int32)), policy=self.policy,
            max_len=self.max_len,
            paged={"block_tables": self._put(bt_row)})
        return sample(logits[:, 0], self.gen, sp)

    def _verify_step(self, cache, tok, lens, rem, act, drafts, block_tables,
                     sp):
        """One draft-verify decode step on the device (the reference's
        ``_spec_fns``): score the pending token plus the k drafts of every
        slot in one forward, keep the longest accepted prefix, clamp the
        emit stream to each slot's budget and to its first EOS, and rewind
        the rejected entries' positions before anything can read them.
        Returns the new (tok, lens, rem, act), the emits (slots, k+1; -1
        = none) and each slot's count of emitted drafts."""
        tok, lens, rem, act = (self._put(tok), self._put(lens),
                               self._put(rem), self._put(act))
        drafts, bt = self._put(drafts), self._put(block_tables)
        K = drafts.shape[1]
        logits, _ = T.forward_verify(
            self.params, self.cfg, torch.cat([tok[:, None], drafts], 1),
            cache, lens, policy=self.policy, max_len=self.max_len,
            paged={"block_tables": bt, "active": act})
        accept_len, nxt = speculative_verify(logits, drafts, self.gen, sp)
        accept_len, nxt = accept_len.to(torch.int32), nxt.to(torch.int32)
        # the nominal emit stream: accepted drafts, then the corrective or
        # bonus token at index accept_len
        idx1 = torch.arange(K + 1, dtype=torch.int32,
                            device=self.device)[None, :]
        stream = torch.where(idx1 == accept_len[:, None], nxt[:, None],
                             torch.cat([drafts, torch.zeros_like(
                                 nxt[:, None])], 1))
        # the budget keeps a prefix of the stream; EOS inside the emittable
        # prefix ends the request there (EOS itself is not emitted)
        limit = torch.minimum(accept_len + 1, rem.clamp_min(0))
        eos_hit = (stream == EOS) & (idx1 < limit[:, None])
        eos_pos = torch.where(eos_hit, idx1, K + 1).amin(dim=1)
        n_emit = torch.where(act, torch.minimum(limit, eos_pos), 0)
        emits = torch.where(idx1 < n_emit[:, None], stream, -1)
        # written accepted context: the pending token plus the emitted
        # drafts (an emitted trailing nxt is the next pending token)
        d_count = torch.where(act, torch.minimum(accept_len, n_emit), 0)
        lens = lens + torch.where(act, d_count + 1, 0).to(lens.dtype)
        rem = rem - n_emit.to(rem.dtype)
        still = act & ~(eos_pos < limit) & (rem > 0)
        tok = torch.where(still, nxt, tok)
        # after this, every stored position < lens is accepted context and
        # nothing at or beyond it is visible
        KV.paged_truncate_all(cache, bt, lens)
        return tok, lens, rem, still, emits, d_count

    def _decode_steps(self, cache, tok, lens, rem, act, block_tables,
                      steps: int, sp):
        """``steps`` fused iterations of [decode every slot -> sample ->
        scatter K/V into pages], with the slot state kept on the device
        between steps (the reference's ``lax.scan``).  Returns the final
        (tok, lens, rem, act) and the per-step emits / activity,
        (slots, steps) each."""
        tok, lens, rem, act = (self._put(tok), self._put(lens),
                               self._put(rem), self._put(act))
        bt = self._put(block_tables)
        emits, acts = [], []
        for _ in range(steps):
            logits, _ = T.forward_decode(
                self.params, self.cfg, tok[:, None], cache, lens,
                policy=self.policy, max_len=self.max_len,
                paged={"block_tables": bt, "active": act})
            nxt = sample(logits[:, 0], self.gen, sp).to(torch.int32)
            is_eos = nxt == EOS                      # EOS is not emitted
            emits.append(torch.where(act & ~is_eos, nxt, -1))
            acts.append(act)
            still = act & ~is_eos & (rem > 1)
            lens = lens + act.to(lens.dtype)
            rem = rem - act.to(rem.dtype)
            tok = torch.where(still, nxt, tok)
            act = still
        return (tok, lens, rem, act, torch.stack(emits, 1),
                torch.stack(acts, 1))

    @torch.no_grad()
    def serve_continuous(self, requests: List[Request],
                         sp: SamplingParams = SamplingParams(), *,
                         page_size: int = 16,
                         num_pages: Optional[int] = None,
                         slots: Optional[int] = None,
                         steps_per_sync: int = 4,
                         arrivals: Optional[List[float]] = None,
                         prefix_cache: Optional[bool] = None,
                         max_batched_tokens: Optional[int] = None,
                         chunked_prefill: Optional[bool] = None,
                         packed: Optional[bool] = None,
                         spec: Optional[SpecConfig] = None,
                         preemption: str = "off",
                         max_preemptions: int = 2,
                         host_kv_bytes: Optional[int] = None,
                         faults: Optional[FaultConfig] = None,
                         debug_audit: bool = False,
                         trace=None):
        """Serve requests with continuous batching over a paged KV cache.

        Attention models run the unified scheduler: each iteration packs
        one decode token per live slot plus up to
        the remaining ``max_batched_tokens`` (default 256) in
        prefill-chunk tokens from admitting slots (FCFS).  An iteration
        that carries chunks runs as ONE token-packed (1, T) dispatch, or
        with ``packed=False`` as the reference's A/B baseline: a one-step
        decode of the live slots plus one (1, W-bucket) mixed forward per
        chunk, with one synchronize for the iteration.  Decode-only
        iterations fuse ``steps_per_sync`` decode steps into one
        dispatch, or with ``spec`` (a :class:`SpecConfig`) run one
        draft-verify step: the drafter proposes ``spec.k`` tokens per
        slot, one forward verifies them, the longest accepted prefix is
        kept (greedy streams are unchanged) and the rest rewound; the
        budget is then raised to at least ``slots * (k + 1)``.
        ``prefix_cache`` (default on) shares identical prompt-prefix
        pages across requests through a radix trie with copy-on-write.
        ``arrivals`` gives optional per-request arrival offsets in
        seconds.

        ``preemption`` "lru" (victim: the most recently admitted) or
        "priority" (victim: the lowest ``Request.priority``, strictly
        below the blocked head's): an admission that fails for pages
        while a slot is free evicts a decoding victim between dispatches.
        Its pages are snapshotted into a host tier of ``host_kv_bytes``
        (when set) and freed, and the request re-queues at the back with
        its generated tokens.  On re-admission the snapshot is restored
        and decoding continues where it stopped; if the host tier had no
        room, prompt and generated tokens are prefilled again.  The
        prefix trie spills evicted full-page leaves into the same tier
        and promotes them back on a match.  ``max_preemptions`` bounds
        the evictions of one request.  ``Request.deadline`` (seconds on
        the serve clock) and ``Request.max_queue_wait`` cancel queued
        work (``timed_out``; running slots are never cancelled).
        ``faults`` (a :class:`FaultConfig`) injects faults, and
        ``debug_audit`` checks the allocator and host-tier accounting on
        every iteration.

        ``trace``: a :class:`~repro_torch.core.trace.ServeTracer`.  The
        loop then emits per-iteration records, request lifecycle events
        and scheduler decisions, device dispatches as ``span`` events on
        the device track (each ends with the device's completion), and
        takes every wall-clock reading from the tracer's clock, so a
        deterministic fake clock gives byte-identical traces.  ``None``
        costs nothing: every emit site is guarded.

        ``chunked_prefill=False`` (and, always, a model whose layers
        cannot share pages) takes the bucketed path instead: FCFS
        admissions whose unmatched prompt suffixes share a length bucket
        (``prompt_buckets``; the exact length for recurrent, hybrid and
        MoE models, whose state or routing padding would change) are
        grouped into power-of-two
        batches, each prefilled whole in one dispatch, then every slot
        decodes in fused steps, or in verify steps under ``spec``.  With
        sharing on, a suffix resumes after its matched prefix pages (a
        partial tail page copied on write) and attends them through the
        gathered block table; an int8 pool attends its written pages even
        with no match, so bucketed int8 equals chunked int8.  There
        ``packed`` and ``preemption`` warn and are turned off, as the
        reference does; for the families that cannot share pages
        (``prefix_cache.shareable`` gives the reason) ``prefix_cache``,
        ``spec`` and ``chunked_prefill`` too.

        Returns (requests, ServeMetrics); ``r.result`` holds each
        request's generated tokens.
        """
        if preemption not in ("off", "lru", "priority"):
            raise ValueError(f"unknown preemption policy {preemption!r}")
        reason = PC.shareable(self.cfg, self.max_len)
        if arrivals is not None and len(arrivals) != len(requests):
            raise ValueError("arrivals must match requests 1:1")
        # the reference's family gate: a model whose layers cannot share
        # pages serves without the prefix cache, speculation, chunks,
        # preemption and packing, with a warning for each one asked for;
        # chunked_prefill=False turns chunks, preemption and packing off
        # for any model (bucketed admission)
        share = reason is None if prefix_cache is None else bool(prefix_cache)
        if share and reason is not None:
            warnings.warn(f"prefix_cache requested but disabled — {reason}")
            share = False
        if spec is not None and reason is not None:
            warnings.warn(f"speculative decoding requested but disabled — "
                          f"{reason}")
            spec = None
        chunked = reason is None if chunked_prefill is None \
            else bool(chunked_prefill)
        if chunked and reason is not None:
            warnings.warn(f"chunked prefill requested but disabled — "
                          f"{reason}")
            chunked = False
        if preemption != "off" and not chunked:
            warnings.warn("preemption requested but disabled — it needs "
                          "the unified chunked scheduler (resume "
                          "re-prefill rides the chunk machinery)")
            preemption = "off"
        packed_on = chunked if packed is None else bool(packed)
        if packed_on and not chunked:
            warnings.warn("packed execution requested but disabled — it "
                          "rides the unified chunked scheduler"
                          + (f" ({reason})" if reason is not None else ""))
            packed_on = False
        drafter = None
        if spec is not None:
            # kept across serve calls with the same SpecConfig object
            if spec is not self.spec:
                self.spec, self.drafter = spec, get_drafter(
                    spec, self.cfg, self.params, policy=self.policy)
            drafter = self.drafter
        ctx = self._paged_context(page_size, num_pages, slots)
        slots, num_pages = ctx["slots"], ctx["num_pages"]
        pages_per_slot, dump = ctx["pages_per_slot"], ctx["dump"]
        trie = ctx["trie"]
        budget = max_batched_tokens or DEFAULT_MAX_BATCHED_TOKENS
        floor = slots * (drafter.k + 1 if drafter else 1)
        if chunked and budget < floor:
            warnings.warn(
                f"max_batched_tokens={budget} cannot cover one "
                f"{'verify window' if drafter else 'decode token'} per "
                f"slot; raising to {floor}")
            budget = floor
        packed_buckets = packed_width_buckets(budget)
        width_buckets = mixed_width_buckets(budget)
        buckets = self.prompt_buckets()
        # padding would fold into recurrent or SSM state (and compete for
        # capacity-routed experts): such families admit at exact prompt
        # lengths instead of buckets
        pad_sensitive = any(spec.mixer in T.RECURRENT + (HYBRID,)
                            or spec.ffn == MOE_FFN
                            for spec in layer_specs(self.cfg))
        # the host KV tier persists with the pool; a new budget replaces
        # it (spilled prefixes of the old one are dropped with it)
        host = None
        if host_kv_bytes is not None or (faults is not None
                                         and faults.host_full):
            hb = 0 if (faults is not None and faults.host_full) \
                else host_kv_bytes
            host = ctx.get("host")
            if host is None or host.max_bytes != hb:
                host = HostKVStore(hb)
                ctx["host"] = host

        cache = ctx["cache"]
        sched = ContinuousScheduler(slots, ctx["alloc"], page_size,
                                    max_pages_per_slot=pages_per_slot,
                                    prefix_cache=trie, match_prefix=share,
                                    preemption=preemption,
                                    max_preemptions=max_preemptions,
                                    trace=trace)

        # device closures of the host-side scheduler and trie (the pool
        # is updated in place, so they always see its latest contents)
        def offload_fn(pages):
            return KV.offload_pages(cache, pages)

        def restore_fn(blob, pages):
            KV.restore_pages(cache, blob, pages)

        sched.host_store = host
        sched.offload_fn = offload_fn
        sched.restore_fn = restore_fn
        trie.host_store = host
        trie.offload_fn = offload_fn if host is not None else None
        # the tracer, like offload_fn, must not outlive this call on the
        # persistent trie and host tier (detached at the end)
        trie.trace = trace
        if host is not None:
            host.trace = trace
        spill_base = trie.spilled_pages
        promote_base = sched.promoted_pages
        ws = self.weight_stats
        metrics = ServeMetrics(kv_dtype=ctx["kv_dtype"],
                               kv_pool_bytes=ctx["kv_pool_bytes"],
                               kv_bytes_per_token=ctx["kv_bytes_per_token"],
                               weight_dtype=ws["weights_dtype"],
                               weight_bytes=int(ws["weight_bytes"]),
                               weight_bytes_saved=int(
                                   ws["weight_bytes_saved"]),
                               spec_mode=drafter.name if drafter else "off",
                               spec_k=drafter.k if drafter else 0,
                               scheduler="unified" if chunked
                               else "bucketed",
                               max_batched_tokens=budget if chunked else 0)
        stats = EngineStats(batches=1)
        trie_base = trie.evicted_pages

        block_tables = np.full((slots, pages_per_slot), -1, np.int32)
        tok = np.zeros((slots,), np.int32)
        lens = np.zeros((slots,), np.int32)
        rem = np.zeros((slots,), np.int32)
        act = np.zeros((slots,), bool)

        if faults is not None and faults.collapse_arrivals:
            arrivals = None            # a burst: everything at t=0
        order = sorted(range(len(requests)),
                       key=lambda i: arrivals[i]) if arrivals else \
            list(range(len(requests)))
        incoming = [(arrivals[i] if arrivals else 0.0, requests[i])
                    for i in order]
        fault_hold: List[int] = []     # pool pages a fault squats on
        # with a tracer attached, every wall reading of this loop comes
        # from its clock: a deterministic fake clock then reproduces the
        # event stream, timestamps included
        tr = trace
        clk = tr.clock if tr is not None else time.perf_counter
        t0 = clk()
        if tr is not None:
            tr.set_origin(t0)
            # weight-compression gauge, and the load-time quantization
            # span only where weights were compressed (its wall duration
            # would break a fake clock's byte-identical trace otherwise)
            tr.emit("weights", 0.0, dtype=ws["weights_dtype"],
                    weight_bytes=int(ws["weight_bytes"]),
                    weight_bytes_dense=int(ws["weight_bytes_dense"]),
                    quantized_tensors=int(ws["n_quantized"]))
            if ws["n_quantized"]:
                tr.emit("span", 0.0, name="quantize_weights",
                        dur=float(self.weight_quant_s), track="load")

        def now():
            return clk() - t0

        # per-iteration accounting of the trace timeline: device time
        # accumulates over the iteration's spans, then one iteration
        # record carries the host/device split and the pool gauges
        it_acc = {"t0": 0.0, "iter": 0, "device_s": 0.0}

        @contextmanager
        def dev_span(name):
            """Time one device dispatch up to its completion (the span
            ends with a device synchronize on the card) into
            ``metrics.device_s`` and, when tracing, a device-track span
            named ``name``."""
            ts = clk()
            try:
                yield
            finally:
                self._sync()
                dt = clk() - ts
                metrics.device_s += dt
                if name == "admit_prefill":
                    stats.prefill_s += dt
                else:
                    stats.decode_s += dt
                it_acc["device_s"] += dt
                if tr is not None:
                    tr.emit("span", t=ts - t0, name=name, dur=dt,
                            track="device")

        def emit_iteration(**kw):
            dev = it_acc["device_s"]
            it_acc["device_s"] = 0.0
            it_acc["iter"] += 1
            if tr is None:
                return
            t_it = it_acc["t0"]
            dur = max(0.0, now() - t_it)
            tr.emit("iteration", t=t_it, iter=it_acc["iter"] - 1, dur=dur,
                    host_s=max(0.0, dur - dev), device_s=dev,
                    budget=budget if chunked else 0,
                    pages_in_use=int(sched.allocator.allocated_count),
                    host_bytes=int(host.used_bytes) if host is not None
                    else 0,
                    trie_nodes=int(trie.num_nodes), **kw)

        def count_outcome(req):
            oc = req.outcome
            metrics.outcome_counts[oc.status] = \
                metrics.outcome_counts.get(oc.status, 0) + 1
            if oc.deadline_missed:
                metrics.deadline_misses += 1
            if oc.status == "timed_out":
                metrics.timed_out += 1
            elif oc.status == "rejected":
                metrics.rejected += 1

        def retire(slot):
            st = sched.retire(slot, now())
            block_tables[slot, :] = -1
            act[slot] = False
            metrics.retired += 1
            metrics.generated_tokens += len(st.request.result)
            count_outcome(st.request)
            metrics.latency_s.append(st.finished_at - st.submitted_at)
            if tr is not None:
                oc = st.request.outcome
                tr.emit("retire", t=st.finished_at, uid=st.request.uid,
                        slot=int(slot), status=oc.status,
                        preemptions=int(oc.preemptions),
                        deadline_missed=bool(oc.deadline_missed),
                        latency_s=st.finished_at - st.submitted_at,
                        generated=len(st.request.result))

        def record_emit(st, n, t):
            """TTFT / ITL bookkeeping: ``n`` tokens appended at wall time
            ``t``; a multi-token sync spreads its time evenly."""
            if n <= 0:
                return
            if st.last_token_at is None:
                metrics.ttft_s.append(t - st.submitted_at)
                if tr is not None:
                    tr.emit("first_token", t=t, uid=st.request.uid,
                            ttft_s=t - st.submitted_at)
            else:
                metrics.itl_s.extend([(t - st.last_token_at) / n] * n)
            st.last_token_at = t

        def start_decoding(slot, st, first):
            """A context's final chunk is written: a recompute-resume
            continues from its kept pending token (the final chunk's
            sample ``first`` is not used); otherwise ``first`` is emitted
            and the slot either retires or goes on to decode."""
            plen = st.ctx_len
            if st.is_resume:
                tok[slot] = st.resume_pending
                lens[slot] = plen
                rem[slot] = st.resume_rem
                act[slot] = True
                st.last_token_at = now()
                return
            req = st.request
            gen_budget = min(req.max_new_tokens, self.max_len - plen)
            if first != EOS and gen_budget > 0:
                st.emitted.append(first)
                record_emit(st, 1, now())
            if first == EOS or gen_budget <= 1:
                retire(slot)
            else:
                tok[slot] = first
                lens[slot] = plen
                rem[slot] = gen_budget - 1
                act[slot] = True

        def page_init_rows(n):
            """``n`` rows of page init (reset rows, COW source, target and
            kept length), all dump-page no-ops."""
            return (np.full((n, pages_per_slot), dump, np.int32),
                    np.full((n,), dump, np.int32),
                    np.full((n,), dump, np.int32), np.zeros((n,), np.int32))

        def book_page_init(st, init, i):
            """Row ``i`` of ``init`` resets an admitting slot's fresh pages
            and copies its partial COW tail page into the first of them."""
            reset_rows, cow_src, cow_dst, cow_keep = init
            reset_rows[i, :len(st.fresh_pages)] = st.fresh_pages
            if st.cow_src >= 0:
                # COW invariant: the destination must be private
                if sched.allocator.refcount(st.fresh_pages[0]) != 1:
                    raise AssertionError("COW write target is a shared page")
                cow_src[i] = st.cow_src
                cow_dst[i] = st.fresh_pages[0]
                cow_keep[i] = st.matched_len
                metrics.cow_copies += 1

        def finish_chunk(c, st):
            """Bookkeeping of a prefill chunk once it is written; True if
            it was the context's final chunk (its page-aligned KV then
            joins the trie; the partial tail joins at retire)."""
            if st.needs_init:
                st.needs_init = False
                sched.release_cow_source(st)
            st.prefill_pos = c.start + c.length
            if not st.prefill_done:
                return False
            sched.insert_prefix(st, (st.ctx_len // page_size) * page_size)
            return True

        def run_packed(plan):
            """One token-packed iteration: the whole plan — every
            decoding slot's token plus every scheduled prefill chunk —
            as ONE (1, T) dispatch, then the reference's bookkeeping."""
            W = pick_bucket(plan.total_tokens, packed_buckets)
            pb = sched.pack_batch(plan, tok, lens, W)
            init = page_init_rows(slots)
            for c in plan.chunks:
                if sched.slots[c.slot].needs_init:
                    book_page_init(sched.slots[c.slot], init, c.slot)
            # every segment adds at most one partial query window
            n_work = W // DA.PACKED_BLOCK_Q + slots
            meta = DA.packed_meta_table(pb.seg_start[:pb.n_segments],
                                        pb.seg_len[:pb.n_segments],
                                        pb.seg_slots[:pb.n_segments],
                                        W, n_work)
            with dev_span("packed"):
                nxt = self._packed_step(cache, pb, meta, block_tables,
                                        init, sp).cpu().numpy()
            metrics.host_syncs += 1
            metrics.steps += 1
            metrics.slot_steps_total += slots
            metrics.slot_steps_active += len(plan.decode_slots)
            metrics.mixed_iters += 1
            metrics.mixed_dispatches += 1
            metrics.packed_tokens_real += pb.n_tokens
            metrics.packed_tokens_padded += W
            real = sum(c.length for c in plan.chunks)
            metrics.prefill_chunks += len(plan.chunks)
            metrics.prefill_tokens += real
            metrics.prefill_padded += real
            t_emit = now()
            for i in range(pb.n_decode):
                s = int(pb.seg_slots[i])
                st = sched.slots[s]
                v = int(nxt[i])
                lens[s] += 1
                rem[s] -= 1
                if v != EOS:
                    st.emitted.append(v)
                    record_emit(st, 1, t_emit)
                    metrics.decode_tokens += 1
                if v == EOS or rem[s] <= 0:
                    retire(s)
                else:
                    tok[s] = v
            for i in range(pb.n_decode, pb.n_segments):
                c = plan.chunks[i - pb.n_decode]
                st = sched.slots[c.slot]
                if tr is not None:
                    tr.emit("prefill_chunk", t=t_emit, uid=st.request.uid,
                            slot=int(c.slot), start=int(c.start),
                            len=int(c.length))
                if finish_chunk(c, st):
                    start_decoding(c.slot, st, int(nxt[i]))
            emit_iteration(budget_used=int(pb.n_tokens),
                           decode_lanes=len(plan.decode_slots),
                           chunk_segments=len(plan.chunks),
                           chunk_tokens=int(real), width_bucket=int(W),
                           padded_lanes=int(W - pb.n_tokens), idle=False)

        def apply_decode_results(tok_d, lens_d, rem_d, act_d, emits):
            """Fold a decode or verify dispatch's results into the host
            slot arrays: append emits, record TTFT/ITL, retire finished
            slots (admitting slots rode along inactive)."""
            nonlocal tok, lens, rem, act
            tok, lens, rem = (tok_d.cpu().numpy(), lens_d.cpu().numpy(),
                              rem_d.cpu().numpy())
            act_new = act_d.cpu().numpy()
            metrics.decode_tokens += int((emits >= 0).sum())
            t_now = now()
            for slot in list(sched.slots):
                st = sched.slots[slot]
                if not st.prefill_done:
                    continue
                n_emit = 0
                for t in emits[slot]:
                    if t >= 0:
                        st.emitted.append(int(t))
                        n_emit += 1
                record_emit(st, n_emit, t_now)
                if not act_new[slot]:
                    retire(slot)
            act = act_new

        def run_decode():
            n_lanes = int(act.sum())
            with dev_span("decode"):
                tok_d, lens_d, rem_d, act_d, emits_d, acts_d = \
                    self._decode_steps(cache, tok, lens, rem, act,
                                       block_tables, steps_per_sync, sp)
                emits = emits_d.cpu().numpy()
            metrics.host_syncs += 1
            metrics.steps += steps_per_sync
            metrics.slot_steps_total += slots * steps_per_sync
            metrics.slot_steps_active += int(acts_d.sum())
            apply_decode_results(tok_d, lens_d, rem_d, act_d, emits)
            emit_iteration(budget_used=n_lanes * steps_per_sync,
                           decode_lanes=n_lanes, chunk_segments=0,
                           chunk_tokens=0, width_bucket=0, padded_lanes=0,
                           idle=False)

        def run_verify():
            """One draft-verify step (decode-only iterations under spec):
            draft on the host, one verify forward, one synchronize."""
            n_lanes = int(act.sum())
            contexts = [None] * slots
            for slot, st in sched.slots.items():
                if act[slot]:
                    contexts[slot] = st.request.tokens + st.emitted
            with dev_span("verify"):
                drafts = drafter.propose_slots(contexts)
                tok_d, lens_d, rem_d, act_d, emits_d, acc_d = \
                    self._verify_step(cache, tok, lens, rem, act, drafts,
                                      block_tables, sp)
                emits = emits_d.cpu().numpy()
            metrics.host_syncs += 1
            metrics.steps += 1
            metrics.slot_steps_total += slots
            metrics.slot_steps_active += n_lanes
            metrics.drafted_tokens += drafter.k * n_lanes
            metrics.accepted_tokens += int(acc_d.sum())
            apply_decode_results(tok_d, lens_d, rem_d, act_d, emits)
            emit_iteration(budget_used=n_lanes * (drafter.k + 1),
                           decode_lanes=n_lanes, chunk_segments=0,
                           chunk_tokens=0, width_bucket=0, padded_lanes=0,
                           idle=False)

        def run_mixed(plan):
            """One mixed iteration of the ``packed=False`` path: a one-step
            decode of the live slots, then one (1, W-bucket) mixed forward
            per prefill chunk (page init fused into a slot's first chunk),
            all dispatched before the iteration's one synchronize; then
            the reference's bookkeeping, decode results first."""
            padded = 0
            with dev_span("mixed"):
                dec = self._decode_steps(cache, tok, lens, rem, act,
                                         block_tables, 1, sp) \
                    if plan.decode_slots else None
                finals = {}       # chunk index -> final chunk's sample
                inited = set()    # slots whose page init this plan ran
                for ci, c in enumerate(plan.chunks):
                    st = sched.slots[c.slot]
                    W = pick_bucket(c.length, width_buckets)
                    toks = np.zeros((1, W), np.int32)
                    toks[0, :c.length] = st.ctx[c.start:c.start + c.length]
                    init = page_init_rows(1)
                    if st.needs_init and c.slot not in inited:
                        inited.add(c.slot)
                        book_page_init(st, init, 0)
                    nxt = self._mixed_step(
                        cache, toks, c.start, c.length,
                        block_tables[c.slot:c.slot + 1], init, sp)
                    padded += W - c.length
                    metrics.prefill_chunks += 1
                    metrics.prefill_tokens += c.length
                    metrics.prefill_padded += W
                    # a recompute-resume's final chunk samples nothing
                    # that is used
                    if c.start + c.length >= st.ctx_len \
                            and not st.is_resume:
                        finals[ci] = nxt
                # the iteration's one device-to-host copy: decode emits,
                # then the final chunks' samples
                parts = ([dec[4].reshape(-1).long()] if dec else []) + \
                    [t.reshape(-1).long() for t in finals.values()]
                host_out = torch.cat(parts).cpu().numpy() if parts \
                    else None
            n_dec = slots if dec else 0
            emits = host_out[:n_dec].reshape(slots, 1) if dec else None
            finals = dict(zip(finals, host_out[n_dec:])) if finals else {}
            metrics.host_syncs += 1
            metrics.mixed_iters += 1
            metrics.mixed_dispatches += len(plan.chunks) + (dec is not None)
            if tr is not None:
                for c in plan.chunks:
                    tr.emit_now("prefill_chunk",
                                uid=sched.slots[c.slot].request.uid,
                                slot=int(c.slot), start=int(c.start),
                                len=int(c.length))
            if dec:
                metrics.steps += 1
                metrics.slot_steps_total += slots
                metrics.slot_steps_active += int(dec[5].sum())
                apply_decode_results(*dec[:4], emits)
            for ci, c in enumerate(plan.chunks):
                st = sched.slots[c.slot]
                if finish_chunk(c, st):
                    start_decoding(c.slot, st, None if st.is_resume
                                   else int(finals[ci]))
            emit_iteration(budget_used=int(plan.total_tokens),
                           decode_lanes=len(plan.decode_slots),
                           chunk_segments=len(plan.chunks),
                           chunk_tokens=int(sum(c.length
                                                for c in plan.chunks)),
                           width_bucket=0, padded_lanes=int(padded),
                           idle=False)

        def flush_admissions(pending):
            """Run the pending equal-bucket admissions in power-of-two
            groups (a group size that followed scheduling timing would
            make the set of prefill shapes unbounded), one dispatch
            each."""
            while pending:
                n = 1 << (len(pending).bit_length() - 1)
                group, pending[:] = pending[:n], pending[n:]
                admit_group(group)

        def admit_group(group):
            """One bucketed admission dispatch (the reference's
            ``_flush_chunk``): every row's unmatched suffix, right-padded
            to the group's bucket, prefilled from its matched prefix
            length (``admit_prefix_fn`` when sharing is on, ``admit_fn``
            otherwise), first tokens sampled; then the bookkeeping."""
            n, bucket = len(group), group[0][2]
            toks = np.zeros((n, bucket), np.int32)
            plens = np.zeros((n,), np.int32)        # suffix lengths
            starts = np.zeros((n,), np.int32)       # matched prefix lengths
            slots_arr = np.zeros((n,), np.int32)
            rows = np.zeros((n, pages_per_slot), np.int32)
            init = page_init_rows(n)
            for i, (slot, st, _) in enumerate(group):
                req, m = st.request, st.matched_len
                plens[i], starts[i] = req.prompt_len - m, m
                toks[i, :req.prompt_len - m] = req.tokens[m:]
                slots_arr[i] = slot
                block_tables[slot, :] = -1
                block_tables[slot, :len(st.pages)] = st.pages
                rows[i] = block_tables[slot]
                # only the request's own pages are reset: shared prefix
                # pages stay live for other readers and the trie
                book_page_init(st, init, i)
            with dev_span("admit_prefill"):
                first = self._admit_step(
                    cache, toks, plens, slots_arr, rows, init[0], sp,
                    start=starts if share else None,
                    cow=init[1:] if share else None).cpu().numpy()
            metrics.host_syncs += 1
            t_adm = now()
            for i, (slot, st, _) in enumerate(group):
                req, plen = st.request, st.request.prompt_len
                sched.release_cow_source(st)
                st.needs_init = False
                st.prefill_pos = plen             # whole prompt in one go
                metrics.admitted += 1
                metrics.prefill_tokens += plen - st.matched_len
                metrics.prefill_padded += bucket
                metrics.prefix_hits += st.matched_len > 0
                metrics.prefix_matched_tokens += st.matched_len
                metrics.pages_shared += st.shared_count
                stats.prompt_tokens += plen
                if tr is not None:
                    tr.emit("prefill_chunk", t=t_adm, uid=req.uid,
                            slot=int(slot), start=int(st.matched_len),
                            len=int(plen - st.matched_len))
                    if st.matched_len > 0:
                        tr.emit("prefix_hit", t=t_adm, uid=req.uid,
                                matched_tokens=int(st.matched_len),
                                pages_shared=int(st.shared_count))
                # the page-aligned prompt KV joins the trie now (the
                # partial tail joins at retire)
                sched.insert_prefix(st, (plen // page_size) * page_size)
                gen_budget = min(req.max_new_tokens, self.max_len - plen)
                v = int(first[i])
                if v != EOS and gen_budget > 0:
                    st.emitted.append(v)
                    record_emit(st, 1, t_adm)
                if v == EOS or gen_budget <= 1:
                    retire(slot)
                else:
                    tok[slot] = v
                    lens[slot] = plen
                    rem[slot] = gen_budget - 1
                    act[slot] = True

        def admit_bucketed():
            """Admit FCFS while slots and pages allow, grouping consecutive
            admissions whose unmatched suffixes share a bucket (an exact
            length for padding-sensitive families); a flush may retire
            slots (EOS or budget at admission), so retry until no
            progress."""
            while True:
                pending, progress = [], False
                while True:
                    adm = sched.try_admit(now())
                    if adm is None:
                        break
                    progress = True
                    slot, st = adm
                    suffix = st.request.prompt_len - st.matched_len
                    bucket = suffix if pad_sensitive \
                        else pick_bucket(suffix, buckets)
                    if pending and pending[0][2] != bucket:
                        flush_admissions(pending)
                    pending.append((slot, st, bucket))
                flush_admissions(pending)
                metrics.peak_pages_in_use = max(
                    metrics.peak_pages_in_use,
                    sched.allocator.allocated_count)
                if not progress or not sched.waiting:
                    return

        def admit_chunked():
            """Unified scheduler: admission only claims a slot and its
            pages (the prompt is prefilled in budgeted chunks by the
            iterations) or resumes a preempted request; when the head is
            blocked on pages with a slot free, preempt decoding victims
            for it, between dispatches."""
            while True:
                adm = sched.try_admit(now())
                if adm is not None:
                    slot, st = adm
                    block_tables[slot, :] = -1
                    block_tables[slot, :len(st.pages)] = st.pages
                    if st.restore_blob is not None:
                        # host-tier resume: the snapshot goes back and the
                        # slot rejoins decode exactly where it stopped
                        KV.restore_pages(cache, st.restore_blob, st.pages)
                        st.restore_blob = None
                        metrics.restored_pages += len(st.pages)
                        metrics.resumed += 1
                        tok[slot] = st.resume_pending
                        lens[slot] = st.ctx_len
                        rem[slot] = st.resume_rem
                        act[slot] = True
                        st.last_token_at = now()
                        if tr is not None:
                            tr.emit_now("restore", uid=st.request.uid,
                                        slot=int(slot), mode="hostkv",
                                        n_pages=len(st.pages))
                    elif st.is_resume:
                        # the host tier had no room: prefill the context
                        # again as ordinary chunks (recompute-resume)
                        metrics.resumed += 1
                        if tr is not None:
                            tr.emit_now("restore", uid=st.request.uid,
                                        slot=int(slot), mode="recompute",
                                        n_pages=len(st.pages))
                    else:
                        stats.prompt_tokens += st.request.prompt_len
                        metrics.admitted += 1
                        metrics.prefix_hits += st.matched_len > 0
                        metrics.prefix_matched_tokens += st.matched_len
                        metrics.pages_shared += st.shared_count
                        if tr is not None and st.matched_len > 0:
                            tr.emit_now("prefix_hit", uid=st.request.uid,
                                        matched_tokens=int(st.matched_len),
                                        pages_shared=int(st.shared_count))
                    continue
                # the head is blocked: preempt only when a slot is free
                # (pure pool pressure) and evicting every eligible victim
                # could fit it (else preemption is churn)
                if preemption == "off" or not sched.waiting \
                        or not sched.free_slots():
                    return
                head = sched.waiting[0]
                if sched.queued_pages_needed(head) \
                        > sched.preemptible_headroom(head):
                    return
                victim = sched.pick_victim(head)
                if victim is None:
                    return
                n_pages = len(sched.slots[victim].pages)
                vic_uid = sched.slots[victim].request.uid
                _, offloaded = sched.preempt(
                    victim, pending=int(tok[victim]),
                    ctx_len=int(lens[victim]),
                    rem_tokens=int(rem[victim]))
                act[victim] = False
                block_tables[victim, :] = -1
                metrics.preemptions += 1
                if offloaded:
                    metrics.offloaded_pages += n_pages
                if tr is not None:
                    tr.emit_now("preempt", uid=int(vic_uid),
                                slot=int(victim), policy=preemption,
                                n_pages=int(n_pages),
                                offloaded=bool(offloaded))
                    if offloaded:
                        tr.emit_now("offload", uid=int(vic_uid),
                                    slot=int(victim), n_pages=int(n_pages))

        while incoming or sched.has_work():
            if tr is not None:
                it_acc["t0"] = now()
            # -- release arrived requests into the FCFS queue -------------
            while incoming and incoming[0][0] <= now():
                _, req = incoming.pop(0)
                if self.prune_maps is not None:
                    req.tokens = [int(t) for t in PR.remap_tokens(
                        req.tokens, self.prune_maps)]
                if faults is not None and req.uid in faults.oversize_uids:
                    # inflate past the whole pool: truncation or
                    # rejection below must absorb it, never raise
                    target = max(self.max_len,
                                 num_pages * page_size) + page_size
                    req.tokens = (req.tokens
                                  * (target // max(len(req.tokens), 1)
                                     + 1))[:target]
                if req.prompt_len > self.max_len:
                    # leave the truncated prompt room to generate
                    limit = max(self.max_len - req.max_new_tokens,
                                self.max_len // 2)
                    req.tokens = truncate_prompt(req.tokens, limit,
                                                 uid=req.uid)
                    req.truncated = True
                sched.submit(req, now())

            for req in sched.cancel_expired(now()):
                count_outcome(req)

            # -- fault injection: a squatter on free pool pages -----------
            if faults is not None and faults.hold_pages and not fault_hold \
                    and metrics.admitted >= faults.hold_after_admits:
                fault_hold = sched.allocator.alloc(
                    min(faults.hold_pages,
                        sched.allocator.free_count)) or []

            if chunked:
                admit_chunked()
            else:
                admit_bucketed()
            metrics.peak_pages_in_use = max(metrics.peak_pages_in_use,
                                            sched.allocator.allocated_count)
            if sched.waiting and sched.free_slots() and sched.slots:
                metrics.admission_stalls += 1
            if debug_audit:
                # refcount and host-tier accounting hold on every
                # iteration, not only at the end of the run
                sched.allocator.check()
                if host is not None:
                    host.check()

            if not sched.slots:
                if sched.waiting:
                    # the head can never fit: fail it rather than spin
                    head = sched.waiting[0]
                    detail = (f"needs {sched.queued_pages_needed(head)} "
                              f"pages but the pool holds "
                              f"{sched.allocator.num_pages} "
                              f"({sched.allocator.free_count} free after "
                              f"eviction)")
                    warnings.warn(f"request {head.uid}: {detail}; rejecting")
                    count_outcome(sched.fail_head(detail))
                elif incoming:        # idle until the next arrival
                    time.sleep(max(0.0, min(incoming[0][0] - now(), 0.01)))
                emit_iteration(budget_used=0, decode_lanes=0,
                               chunk_segments=0, chunk_tokens=0,
                               width_bucket=0, padded_lanes=0, idle=True)
                continue

            plan = sched.next_batch(budget) if chunked else None
            if plan is not None and plan.chunks:
                (run_packed if packed_on else run_mixed)(plan)
            elif drafter is not None:
                run_verify()
            else:
                run_decode()

        metrics.host_s = max(0.0, now() - metrics.device_s)
        if fault_hold:                 # release the injected squatter
            sched.allocator.free(fault_hold)
        metrics.prefix_evicted_pages = trie.evicted_pages - trie_base
        # trie spills count as offloads, promotions as restores; the trie
        # outlives this call but its device closure and tracer must not
        metrics.offloaded_pages += trie.spilled_pages - spill_base
        metrics.restored_pages += sched.promoted_pages - promote_base
        trie.offload_fn = None
        trie.trace = None
        if host is not None:
            host.trace = None
            host.check()
            metrics.host_bytes_used = host.used_bytes
            metrics.host_bytes_peak = host.peak_bytes
        if self.prune_maps is not None:
            for r in requests:
                if r.result:
                    r.result = [int(t) for t in PR.unmap_tokens(
                        r.result, self.prune_maps)]
        stats.generated_tokens = metrics.generated_tokens
        self.stats.merge(stats)
        # pool accounting must balance: every page is free or cached
        sched.allocator.check()
        resident = trie.resident_pages
        if sorted(set(resident)) != sorted(
                p for p in range(num_pages)
                if sched.allocator.refcount(p) > 0) \
                or any(sched.allocator.refcount(p) != 1 for p in resident):
            raise AssertionError("page leak: allocated pages != pages "
                                 "resident in the prefix cache")
        return requests, metrics
