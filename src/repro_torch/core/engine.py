"""Continuous-batching inference engine (the port's counterpart of
``repro.core.engine``), reduced to the reference's main serving path:
``serve_continuous`` with the unified token-budget scheduler, token-packed
execution of every iteration that carries prefill chunks, fused multi-step
decode otherwise, and radix prefix sharing over the paged KV pool.

The engine runs on the card by default (``device="cuda"``) and raises when
no CUDA device is present; pass ``device="cpu"`` to run the kernels'
plain PyTorch versions.  Options of the reference that the port does not
serve yet (speculative decoding, preemption and the host KV tier, fault
injection, tracing, the non-packed and bucketed paths, vocabulary
pruning) raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
import warnings
from contextlib import contextmanager
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kv_cache as KV
from repro_torch.core import prefix_cache as PC
from repro_torch.core.continuous import (ContinuousScheduler, PageAllocator,
                                         ServeMetrics)
from repro_torch.core.precision import (BF16, Policy, compress_weights,
                                        map_params)
from repro_torch.core.sampling import SamplingParams, sample
from repro_torch.core.scheduler import (DEFAULT_BUCKETS, Request,
                                        pick_bucket, truncate_prompt)
from repro_torch.core.tokenizer import EOS
from repro_torch.kernels import decode_attention as DA
from repro_torch.models import transformer as T

# Default per-iteration token budget of the unified scheduler.
DEFAULT_MAX_BATCHED_TOKENS = 256


def packed_width_buckets(budget: int) -> tuple:
    """Stream widths a packed (1, T) iteration pads to: multiples of the
    packed kernel's 8-lane query window on a <=32-step ladder whose step
    scales with the budget."""
    cap = -(-budget // 8) * 8                # budget, 8-lane aligned
    step = max(8, -(-(cap // 32) // 8) * 8)  # ~cap/32, 8-lane aligned
    return tuple(sorted({min(i * step, cap)
                         for i in range(1, -(-cap // step) + 1)}))


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA request without a CUDA
    device raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the port runs on "
                           "the card by default (pass device='cpu' to run "
                           "the kernels' plain PyTorch versions)")
    return dev


class InferenceEngine:
    """Single-host serving engine for one model on one device."""

    def __init__(self, cfg: ModelConfig, params, *, policy: Policy = BF16,
                 max_batch: int = 8, max_len: int = 512, seed: int = 0,
                 device="cuda", prune_maps=None):
        self.device = resolve_device(device)
        if prune_maps is not None:
            raise NotImplementedError("vocabulary pruning is not ported")
        T.check_supported(cfg)
        self.cfg = cfg
        self.policy = policy
        self.params = policy.cast_params(
            map_params(lambda p: p.to(self.device), params))
        self.params, self.weight_stats = compress_weights(self.params,
                                                          policy)
        self.max_batch = max_batch
        self.max_len = max_len
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self._paged_ctx = None         # persistent paged pool + radix trie

    def prompt_buckets(self):
        """Prompt length buckets bounded by the engine context."""
        return tuple(b for b in DEFAULT_BUCKETS if b < self.max_len) \
            + (self.max_len,)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

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
        alloc = PageAllocator(num_pages)
        cache = T.init_paged_cache(
            self.cfg, num_pages=num_pages, page_size=page_size,
            dtype=self.policy.compute_dtype, kv_dtype=self.policy.kv_dtype,
            device=self.device)
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

    def _packed_step(self, cache, pb, meta, block_tables, reset_rows,
                     cow_src, cow_dst, cow_keep, sp):
        """One token-packed iteration on the device: reset the admitting
        slots' fresh pages, copy their partial COW tail pages, run the
        packed forward (K/V scattered into each lane's own slot pages),
        and sample every segment's last token.  Host arrays are copied to
        the device once here, not once per layer."""
        KV.reset_pages_all(cache, self._put(reset_rows))
        KV.copy_pages_all(cache, self._put(cow_src), self._put(cow_dst),
                          self._put(cow_keep))
        logits, _ = T.forward_packed(
            self.params, self.cfg, self._put(pb.tokens[None, :]), cache,
            self._put(pb.slot_ids), self._put(pb.positions),
            self._put(pb.last_idx), policy=self.policy,
            max_len=self.max_len,
            paged={"block_tables": self._put(block_tables),
                   "packed_meta": self._put(meta)})
        return sample(logits[0], self.gen, sp)             # (S,)

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
                         spec=None, preemption: str = "off",
                         host_kv_bytes: Optional[int] = None,
                         faults=None, trace=None):
        """Serve requests with continuous batching over a paged KV cache.

        Each iteration packs one decode token per live slot plus up to
        the remaining ``max_batched_tokens`` (default 256) in
        prefill-chunk tokens from admitting slots (FCFS).  An iteration
        that carries chunks runs as ONE token-packed (1, T) dispatch;
        decode-only iterations fuse ``steps_per_sync`` decode steps into
        one dispatch.  ``prefix_cache`` (default on) shares identical
        prompt-prefix pages across requests through a radix trie with
        copy-on-write.  ``arrivals`` gives optional per-request arrival
        offsets in seconds.

        Returns (requests, ServeMetrics); ``r.result`` holds each
        request's generated tokens.
        """
        unported = {"spec": spec is not None,
                    "preemption": preemption != "off",
                    "host_kv_bytes": host_kv_bytes is not None,
                    "faults": faults is not None,
                    "trace": trace is not None,
                    "chunked_prefill=False": chunked_prefill is False,
                    "packed=False": packed is False}
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"serve_continuous options not ported: {', '.join(bad)} "
                f"(the port serves the unified packed path only)")
        reason = PC.shareable(self.cfg, self.max_len)
        if reason is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: the port serves only the unified packed "
                f"path, which needs paged pure attention ({reason})")
        if arrivals is not None and len(arrivals) != len(requests):
            raise ValueError("arrivals must match requests 1:1")
        share = True if prefix_cache is None else bool(prefix_cache)
        ctx = self._paged_context(page_size, num_pages, slots)
        slots, num_pages = ctx["slots"], ctx["num_pages"]
        pages_per_slot, dump = ctx["pages_per_slot"], ctx["dump"]
        trie = ctx["trie"]
        budget = max_batched_tokens or DEFAULT_MAX_BATCHED_TOKENS
        if budget < slots:
            warnings.warn(f"max_batched_tokens={budget} cannot cover one "
                          f"decode token per slot; raising to {slots}")
            budget = slots
        packed_buckets = packed_width_buckets(budget)

        cache = ctx["cache"]
        sched = ContinuousScheduler(slots, ctx["alloc"], page_size,
                                    max_pages_per_slot=pages_per_slot,
                                    prefix_cache=trie, match_prefix=share)
        ws = self.weight_stats
        metrics = ServeMetrics(kv_dtype=ctx["kv_dtype"],
                               kv_pool_bytes=ctx["kv_pool_bytes"],
                               kv_bytes_per_token=ctx["kv_bytes_per_token"],
                               weight_dtype=ws["weights_dtype"],
                               weight_bytes=int(ws["weight_bytes"]),
                               weight_bytes_saved=int(
                                   ws["weight_bytes_saved"]),
                               max_batched_tokens=budget)
        trie_base = trie.evicted_pages

        block_tables = np.full((slots, pages_per_slot), -1, np.int32)
        tok = np.zeros((slots,), np.int32)
        lens = np.zeros((slots,), np.int32)
        rem = np.zeros((slots,), np.int32)
        act = np.zeros((slots,), bool)

        order = sorted(range(len(requests)),
                       key=lambda i: arrivals[i]) if arrivals else \
            list(range(len(requests)))
        incoming = [(arrivals[i] if arrivals else 0.0, requests[i])
                    for i in order]
        t0 = time.perf_counter()

        def now():
            return time.perf_counter() - t0

        @contextmanager
        def dev_span():
            """Time one device dispatch up to its completion (the span
            ends with a device synchronize on the card)."""
            ts = time.perf_counter()
            try:
                yield
            finally:
                self._sync()
                metrics.device_s += time.perf_counter() - ts

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

        def record_emit(st, n, t):
            """TTFT / ITL bookkeeping: ``n`` tokens appended at wall time
            ``t``; a multi-token sync spreads its time evenly."""
            if n <= 0:
                return
            if st.last_token_at is None:
                metrics.ttft_s.append(t - st.submitted_at)
            else:
                metrics.itl_s.extend([(t - st.last_token_at) / n] * n)
            st.last_token_at = t

        def start_decoding(slot, st, first):
            """A prompt's final chunk sampled ``first``: emit it and
            either retire the slot or hand it to decode."""
            req = st.request
            plen = st.ctx_len
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

        def run_packed(plan):
            """One token-packed iteration: the whole plan — every
            decoding slot's token plus every scheduled prefill chunk —
            as ONE (1, T) dispatch, then the reference's bookkeeping."""
            W = pick_bucket(plan.total_tokens, packed_buckets)
            pb = sched.pack_batch(plan, tok, lens, W)
            reset_rows = np.full((slots, pages_per_slot), dump, np.int32)
            cow_src = np.full((slots,), dump, np.int32)
            cow_dst = np.full((slots,), dump, np.int32)
            cow_keep = np.zeros((slots,), np.int32)
            for c in plan.chunks:
                st = sched.slots[c.slot]
                if not st.needs_init:
                    continue
                reset_rows[c.slot, :len(st.fresh_pages)] = st.fresh_pages
                if st.cow_src >= 0:
                    # COW invariant: the destination must be private
                    if sched.allocator.refcount(st.fresh_pages[0]) != 1:
                        raise AssertionError(
                            "COW write target is a shared page")
                    cow_src[c.slot] = st.cow_src
                    cow_dst[c.slot] = st.fresh_pages[0]
                    cow_keep[c.slot] = st.matched_len
                    metrics.cow_copies += 1
            # every segment adds at most one partial query window
            n_work = W // DA.PACKED_BLOCK_Q + slots
            meta = DA.packed_meta_table(pb.seg_start[:pb.n_segments],
                                        pb.seg_len[:pb.n_segments],
                                        pb.seg_slots[:pb.n_segments],
                                        W, n_work)
            with dev_span():
                nxt = self._packed_step(cache, pb, meta, block_tables,
                                        reset_rows, cow_src, cow_dst,
                                        cow_keep, sp).cpu().numpy()
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
                if st.needs_init:
                    st.needs_init = False
                    sched.release_cow_source(st)
                st.prefill_pos = c.start + c.length
                if not st.prefill_done:
                    continue
                # final chunk: page-aligned prompt KV joins the trie now
                # (the partial tail joins at retire)
                sched.insert_prefix(
                    st, (st.ctx_len // page_size) * page_size)
                start_decoding(c.slot, st, int(nxt[i]))

        def run_decode():
            nonlocal tok, lens, rem, act
            with dev_span():
                tok_d, lens_d, rem_d, act_d, emits_d, acts_d = \
                    self._decode_steps(cache, tok, lens, rem, act,
                                       block_tables, steps_per_sync, sp)
                emits = emits_d.cpu().numpy()
            metrics.host_syncs += 1
            metrics.steps += steps_per_sync
            metrics.slot_steps_total += slots * steps_per_sync
            metrics.slot_steps_active += int(acts_d.sum())
            tok, lens, rem = (tok_d.cpu().numpy(), lens_d.cpu().numpy(),
                              rem_d.cpu().numpy())
            act_new = act_d.cpu().numpy()
            metrics.decode_tokens += int((emits >= 0).sum())
            t_now = now()
            for slot in list(sched.slots):
                st = sched.slots[slot]
                n_emit = 0
                for t in emits[slot]:
                    if t >= 0:
                        st.emitted.append(int(t))
                        n_emit += 1
                record_emit(st, n_emit, t_now)
                if not act_new[slot]:
                    retire(slot)
            act = act_new

        while incoming or sched.has_work():
            # -- release arrived requests into the FCFS queue -------------
            while incoming and incoming[0][0] <= now():
                _, req = incoming.pop(0)
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

            # -- admission only claims a slot and its pages; the prompt is
            # prefilled in budgeted chunks by the packed iterations --------
            while True:
                adm = sched.try_admit(now())
                if adm is None:
                    break
                slot, st = adm
                block_tables[slot, :] = -1
                block_tables[slot, :len(st.pages)] = st.pages
                metrics.admitted += 1
                metrics.prefix_hits += st.matched_len > 0
                metrics.prefix_matched_tokens += st.matched_len
                metrics.pages_shared += st.shared_count
            metrics.peak_pages_in_use = max(metrics.peak_pages_in_use,
                                            sched.allocator.allocated_count)
            if sched.waiting and sched.free_slots() and sched.slots:
                metrics.admission_stalls += 1

            if not sched.slots:
                if sched.waiting:
                    # the head can never fit: fail it rather than spin
                    head = sched.waiting[0]
                    detail = (f"needs {sched.pages_needed(head)} pages but "
                              f"the pool holds {sched.allocator.num_pages} "
                              f"({sched.allocator.free_count} free after "
                              f"eviction)")
                    warnings.warn(f"request {head.uid}: {detail}; rejecting")
                    count_outcome(sched.fail_head(detail))
                elif incoming:        # idle until the next arrival
                    time.sleep(max(0.0, min(incoming[0][0] - now(), 0.01)))
                continue

            plan = sched.next_batch(budget)
            if plan.chunks:
                run_packed(plan)
            else:
                run_decode()

        metrics.host_s = max(0.0, now() - metrics.device_s)
        metrics.prefix_evicted_pages = trie.evicted_pages - trie_base
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
