"""Continuous (in-flight) batching bookkeeping (the port's copy of
``repro.core.continuous``).

A fixed set of decode *slots* runs forever; requests are admitted into
free slots mid-flight and retired at EOS.  KV memory is a shared pool of
fixed-size, refcounted pages, shared across requests with a common prompt
prefix through :class:`~repro_torch.core.prefix_cache.RadixPrefixCache`.
Each iteration is a unified token budget: one decode token per live slot
plus prefill-chunk tokens from admitting slots (FCFS), flattened into one
token-packed stream (:meth:`ContinuousScheduler.pack_batch`).

Under pool pressure a decoding slot can be preempted: its pages are
snapshotted into the byte-budgeted host tier (:class:`HostKVStore`), freed,
and the request re-queues with its generated tokens; on re-admission the
snapshot is restored, or, when the host tier had no room, the context is
prefilled again.  :class:`FaultConfig` injects the faults the overload
tests drive.

This module is host-side bookkeeping only; the device side lives in
``engine.serve_continuous`` and ``kernels/decode_attention``.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.scheduler import Request, RequestOutcome


class PageAllocator:
    """Refcounted free-list allocator over ``num_pages`` physical pages.

    Page ids are 0..num_pages-1; the engine reserves one extra pool page
    (id num_pages) as the dump page, which is never handed out.
    """

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref: Dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated_count(self) -> int:
        return len(self._ref)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages at refcount 1, or None (and no change) if the pool
        can't cover it."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, page: int) -> None:
        if page not in self._ref:
            raise ValueError(f"incref of unallocated page {page}")
        self._ref[page] += 1

    def decref(self, page: int) -> None:
        if not (0 <= page < self.num_pages):
            raise ValueError(f"bad page id {page}")
        c = self._ref.get(page, 0)
        if c <= 0:
            raise ValueError(f"refcount of page {page} would go negative")
        if c == 1:
            del self._ref[page]
            self._free.append(page)
        else:
            self._ref[page] = c - 1

    def free(self, pages: List[int]) -> None:
        """Release one reference on each page.  Atomic: the whole batch
        is validated (ids in range, enough references to cover duplicate
        entries) before any page is released."""
        for p in pages:
            if not (0 <= p < self.num_pages):
                raise ValueError(f"bad page id {p}")
            if pages.count(p) > self._ref.get(p, 0):
                raise ValueError(f"over-free of page {p}")
        for p in pages:
            self.decref(p)

    def check(self) -> None:
        """Pool accounting invariant: every page is either free or has a
        positive refcount, exactly once."""
        if len(set(self._free)) != len(self._free):
            raise AssertionError("duplicate pages in the free list")
        if set(self._free) & set(self._ref):
            raise AssertionError("page both free and allocated")
        if len(self._free) + len(self._ref) != self.num_pages:
            raise AssertionError(
                f"leak: {len(self._free)} free + {len(self._ref)} resident "
                f"!= {self.num_pages} pool pages")
        if any(c <= 0 for c in self._ref.values()):
            raise AssertionError("non-positive refcount")


class HostKVStore:
    """Byte-budgeted host-memory KV tier, the level below the device page
    pool.

    Entries are opaque blobs (:func:`~repro_torch.core.kv_cache.
    offload_pages` snapshots) under caller-chosen keys.  Two kinds share
    the budget: *evictable* entries (prefix-cache spills) are dropped LRU
    to make room, *non-evictable* entries (preemption snapshots) stay
    until popped.  A ``put`` that cannot fit even after evicting every
    evictable entry is refused, never raises: callers degrade (recompute
    the KV, drop the prefix) instead of failing the request.

    ``max_bytes=None`` is unbounded; ``0`` refuses everything (the
    host-tier-full fault).
    """

    def __init__(self, max_bytes: Optional[int] = None):
        self.max_bytes = max_bytes
        # key -> (blob, nbytes, evictable); OrderedDict order = LRU
        self._entries: "OrderedDict[object, tuple]" = OrderedDict()
        self.used_bytes = 0
        self.peak_bytes = 0
        self.spill_evictions = 0       # evictable entries dropped for room
        self.refused_puts = 0          # blobs that could not fit at all
        self.trace = None              # optional ServeTracer (set per serve)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def peek(self, key):
        """The blob under ``key`` (refreshing its LRU position), or None."""
        e = self._entries.get(key)
        if e is None:
            return None
        self._entries.move_to_end(key)
        return e[0]

    def pop(self, key):
        """Remove and return the blob under ``key`` (None if absent)."""
        e = self._entries.pop(key, None)
        if e is None:
            return None
        self.used_bytes -= e[1]
        return e[0]

    def _refuse(self, nbytes: int) -> bool:
        self.refused_puts += 1
        if self.trace is not None:
            self.trace.emit_now("host_refused", bytes=int(nbytes))
        return False

    def put(self, key, blob, *, evictable: bool = True) -> bool:
        """Store ``blob`` under ``key`` (replacing any previous entry),
        evicting LRU evictable entries if the budget requires.  Returns
        False, and stores nothing, when it cannot fit."""
        from repro_torch.core.kv_cache import blob_bytes
        nbytes = blob_bytes(blob)
        old = self._entries.pop(key, None)
        if old is not None:
            self.used_bytes -= old[1]
        if self.max_bytes is not None:
            if nbytes > self.max_bytes:
                return self._refuse(nbytes)
            while self.used_bytes + nbytes > self.max_bytes:
                victim = next((k for k, e in self._entries.items()
                               if e[2]), None)
                if victim is None:
                    return self._refuse(nbytes)
                _, vb, _ = self._entries.pop(victim)
                self.used_bytes -= vb
                self.spill_evictions += 1
                if self.trace is not None:
                    self.trace.emit_now("host_evict", bytes=int(vb))
        self._entries[key] = (blob, nbytes, evictable)
        self.used_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.used_bytes)
        return True

    def check(self) -> None:
        """Accounting invariant: used_bytes matches the resident blobs
        and never exceeds the budget."""
        total = sum(e[1] for e in self._entries.values())
        if total != self.used_bytes:
            raise AssertionError(
                f"host tier leak: {self.used_bytes} booked != "
                f"{total} resident bytes")
        if self.max_bytes is not None and self.used_bytes > self.max_bytes:
            raise AssertionError("host tier over budget")


@dataclass
class FaultConfig:
    """Deterministic fault injection for ``serve_continuous`` (the
    overload test harness).  Every fault must degrade gracefully: each
    submitted request still ends with a terminal
    :class:`~repro_torch.core.scheduler.RequestOutcome`, the allocator
    audit stays clean, and the serve loop terminates.

      hold_pages        steal this many free pool pages (pool exhaustion)
                        once ``hold_after_admits`` admissions have
                        happened; released before the end-of-run audit
      hold_after_admits admissions to wait before stealing
      host_full         the host tier refuses every offload (preemption
                        degrades to recompute-resume, trie spills to
                        plain eviction)
      oversize_uids     inflate these requests' prompts past the whole
                        pool before admission (truncate-or-reject path)
      collapse_arrivals ignore arrival offsets: every request lands at
                        t=0 (a burst)
    """
    hold_pages: int = 0
    hold_after_admits: int = 0
    host_full: bool = False
    oversize_uids: Tuple[int, ...] = ()
    collapse_arrivals: bool = False


@dataclass
class PreemptedState:
    """Resume ticket of a preempted request, keyed by uid while it waits
    in the queue again.

    ``blob`` is the host KV snapshot (None when the host tier was full:
    resume then prefills prompt + generated tokens again).  ``pending`` is
    the sampled-but-unwritten last token (= emitted[-1]); ``ctx_len`` the
    written context length; ``rem`` the remaining token budget.
    """
    blob: Optional[list]
    emitted: List[int]
    n_pages: int
    ctx_len: int
    pending: int
    rem: int


@dataclass
class SlotState:
    request: Request
    pages: List[int]                   # block-table order (shared + fresh)
    fresh_pages: List[int] = field(default_factory=list)  # refcount-1, ours
    matched_len: int = 0               # tokens served from the prefix cache
    shared_count: int = 0              # leading fully-shared pages
    cow_src: int = -1                  # partial tail page to copy, or -1
    emitted: List[int] = field(default_factory=list)
    submitted_at: float = 0.0          # queued (arrival) time
    admitted_at: float = 0.0
    finished_at: Optional[float] = None
    prefill_pos: int = 0               # prompt tokens written so far (abs)
    admit_seq: int = 0                 # FCFS tiebreak for prefill chunks
    needs_init: bool = True            # fresh pages not yet reset / COW'd
    last_token_at: Optional[float] = None   # wall time of last emit (ITL)
    # -- preemption resume --------------------------------------------------
    restore_blob: Optional[list] = None  # host KV snapshot to scatter back
    resume_ctx: Optional[List[int]] = None  # recompute-resume: prompt plus
    #                                    pre-preemption output to prefill
    resume_pending: int = -1           # pre-preemption sampled token; decode
    #                                    continues from it (no new sample)
    resume_rem: int = -1               # token budget left at preemption

    @property
    def is_resume(self) -> bool:
        return self.resume_pending >= 0

    @property
    def ctx(self) -> List[int]:
        """Tokens the slot must have written before it can decode: the
        prompt, or on a recompute-resume the prompt plus every token
        generated before the preemption (minus the pending one)."""
        return self.resume_ctx if self.resume_ctx is not None \
            else self.request.tokens

    @property
    def ctx_len(self) -> int:
        return len(self.ctx)

    @property
    def prefill_done(self) -> bool:
        return self.prefill_pos >= self.ctx_len


@dataclass
class ChunkPlan:
    """One prefill chunk scheduled into a mixed iteration: ``length``
    prompt tokens of ``slot``'s request starting at absolute prompt
    position ``start``."""
    slot: int
    start: int
    length: int


@dataclass
class MixedPlan:
    """One token-budget iteration: every decoding slot contributes
    ``decode_cost`` tokens, admitting slots share the remainder as
    prefill chunks (FCFS)."""
    decode_slots: List[int]
    chunks: List[ChunkPlan]
    decode_cost: int = 1

    @property
    def total_tokens(self) -> int:
        return (self.decode_cost * len(self.decode_slots)
                + sum(c.length for c in self.chunks))


@dataclass
class PackedBatch:
    """One mixed iteration flattened into a single token-packed stream
    (decode tokens first, then prefill-chunk tokens, FCFS).  Stream arrays
    are ``width`` long (lanes past ``n_tokens`` are padding: slot_ids /
    positions -1, tokens 0); segment arrays are ``max_slots`` long."""
    tokens: np.ndarray       # (T,) int32, 0-padded
    slot_ids: np.ndarray     # (T,) int32, -1-padded
    positions: np.ndarray    # (T,) int32 absolute, -1-padded
    seg_slots: np.ndarray    # (S,) int32 owning slot, -1-padded
    seg_start: np.ndarray    # (S,) int32 stream offset of the segment
    seg_len: np.ndarray      # (S,) int32 real tokens in the segment
    last_idx: np.ndarray     # (S,) int32 stream index of the last token
    n_decode: int            # leading decode segments
    n_segments: int          # live segments (decode + chunks)
    n_tokens: int            # real lanes (== plan.total_tokens)


@dataclass
class ServeMetrics:
    """Per-run counters for the continuous path."""
    steps: int = 0                   # decode steps + packed iterations
    slot_steps_active: int = 0       # slot-steps that carried a live request
    slot_steps_total: int = 0
    prefill_tokens: int = 0          # prompt tokens actually computed
    prefill_padded: int = 0          # padded prompt tokens
    generated_tokens: int = 0
    admitted: int = 0
    retired: int = 0
    rejected: int = 0                # could never fit the page pool
    latency_s: List[float] = field(default_factory=list)
    # -- prefix cache -------------------------------------------------------
    prefix_hits: int = 0             # admissions with a non-empty match
    prefix_matched_tokens: int = 0   # prefill tokens saved by sharing
    pages_shared: int = 0            # zero-copy page mappings
    cow_copies: int = 0              # partial tail pages copied on write
    prefix_evicted_pages: int = 0    # trie pages reclaimed under pressure
    # -- storage ------------------------------------------------------------
    kv_dtype: str = "auto"
    kv_pool_bytes: int = 0
    kv_bytes_per_token: float = 0.0
    weight_dtype: str = "auto"
    weight_bytes: int = 0
    weight_bytes_saved: int = 0
    peak_pages_in_use: int = 0
    admission_stalls: int = 0        # iterations a free slot waited on pages
    decode_tokens: int = 0           # tokens emitted by decode/verify steps
    # -- speculative decoding ----------------------------------------------
    spec_mode: str = "off"           # drafter this run used (off|ngram|...)
    spec_k: int = 0                  # drafted tokens per slot per step
    drafted_tokens: int = 0          # drafts offered to the verifier
    accepted_tokens: int = 0         # drafts kept by the rejection sampler
    # -- unified token-budget scheduler -------------------------------------
    scheduler: str = "unified"
    max_batched_tokens: int = 0
    prefill_chunks: int = 0
    ttft_s: List[float] = field(default_factory=list)   # submit->first tok
    itl_s: List[float] = field(default_factory=list)    # inter-token gaps
    # -- packed execution ---------------------------------------------------
    host_s: float = 0.0              # serve-loop wall time minus device time
    device_s: float = 0.0            # time inside synchronized device spans
    host_syncs: int = 0
    mixed_iters: int = 0             # iterations that carried prefill chunks
    mixed_dispatches: int = 0        # device dispatches those iterations made
    packed_tokens_real: int = 0
    packed_tokens_padded: int = 0
    # -- overload survival (preemption + host KV tier) ---------------------
    preemptions: int = 0             # slots evicted under pool pressure
    resumed: int = 0                 # preempted requests re-admitted
    offloaded_pages: int = 0         # pages snapshotted to the host tier
    restored_pages: int = 0          # pages brought back from the host tier
    host_bytes_used: int = 0         # host tier bytes at end of run
    host_bytes_peak: int = 0         # host tier high-water mark
    timed_out: int = 0               # queued requests cancelled at deadline
    deadline_misses: int = 0         # requests that died or finished late
    outcome_counts: Dict[str, int] = field(default_factory=dict)

    @property
    def decode_idle_frac(self) -> float:
        if not self.slot_steps_total:
            return 0.0
        return 1.0 - self.slot_steps_active / self.slot_steps_total

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the verifier accepted (0 when the run
        drafted nothing)."""
        if not self.drafted_tokens:
            return 0.0
        return self.accepted_tokens / self.drafted_tokens

    @property
    def tokens_per_forward(self) -> float:
        if not self.slot_steps_active:
            return 0.0
        return self.decode_tokens / self.slot_steps_active

    @property
    def prefill_pad_frac(self) -> float:
        if not self.prefill_padded:
            return 0.0
        return 1.0 - self.prefill_tokens / self.prefill_padded

    @property
    def prefix_hit_rate(self) -> float:
        total = self.prefix_matched_tokens + self.prefill_tokens
        return self.prefix_matched_tokens / total if total else 0.0

    @property
    def host_frac(self) -> float:
        total = self.host_s + self.device_s
        return self.host_s / total if total else 0.0

    @property
    def dispatches_per_iter(self) -> float:
        if not self.mixed_iters:
            return 0.0
        return self.mixed_dispatches / self.mixed_iters

    @property
    def padded_token_frac(self) -> float:
        if not self.packed_tokens_padded:
            return 0.0
        return 1.0 - self.packed_tokens_real / self.packed_tokens_padded

    @staticmethod
    def percentile(values, q: float) -> float:
        if len(values) == 0:
            return 0.0
        return float(np.percentile(np.asarray(values, dtype=np.float64), q))

    def percentile_latency(self, q: float) -> float:
        return self.percentile(self.latency_s, q)

    @property
    def ttft_p50(self) -> float:
        return self.percentile(self.ttft_s, 50)

    @property
    def ttft_p99(self) -> float:
        return self.percentile(self.ttft_s, 99)

    @property
    def itl_p50(self) -> float:
        return self.percentile(self.itl_s, 50)

    @property
    def itl_p99(self) -> float:
        return self.percentile(self.itl_s, 99)

    def to_dict(self, include_raw: bool = False) -> Dict[str, object]:
        """Every counter field plus every derived property, as
        ``--metrics-json`` writes them.  The per-request sample lists are
        summarized as percentiles unless ``include_raw`` is set."""
        raw_lists = ("latency_s", "ttft_s", "itl_s")
        d: Dict[str, object] = {}
        for name in self.__dataclass_fields__:
            if name in raw_lists and not include_raw:
                continue
            v = getattr(self, name)
            d[name] = dict(v) if isinstance(v, dict) else v
        d.update(
            latency_p50=self.percentile_latency(50),
            latency_p99=self.percentile_latency(99),
            ttft_p50=self.ttft_p50,
            ttft_p99=self.ttft_p99,
            itl_p50=self.itl_p50,
            itl_p99=self.itl_p99,
            decode_idle_frac=self.decode_idle_frac,
            acceptance_rate=self.acceptance_rate,
            tokens_per_forward=self.tokens_per_forward,
            prefill_pad_frac=self.prefill_pad_frac,
            prefix_hit_rate=self.prefix_hit_rate,
            host_frac=self.host_frac,
            dispatches_per_iter=self.dispatches_per_iter,
            padded_token_frac=self.padded_token_frac,
        )
        return d


class ContinuousScheduler:
    """FCFS admission control over decode slots + the refcounted page pool.

    ``waiting`` holds not-yet-admitted requests; ``try_admit`` claims a
    slot + pages, ``retire`` releases them.  With a ``prefix_cache``,
    admission first matches the request's longest cached prefix:
    fully-covered pages are mapped shared, a partially-covered tail page
    is flagged for copy-on-write, and only the fresh remainder is
    allocated — evicting LRU unreferenced trie leaves if the pool runs dry.
    With ``preemption`` "lru" or "priority" the engine may evict a
    decoding slot for a blocked head (:meth:`preempt`); the victim
    re-queues at the back and resumes from its host snapshot or by
    prefilling its context again.
    """

    def __init__(self, max_slots: int, allocator: PageAllocator,
                 page_size: int, max_pages_per_slot: Optional[int] = None,
                 prefix_cache=None, match_prefix: bool = True,
                 preemption: str = "off", max_preemptions: int = 2,
                 trace=None):
        self.max_slots = max_slots
        self.trace = trace             # optional ServeTracer (decision events)
        self.allocator = allocator
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        self.prefix_cache = prefix_cache
        self.match_prefix = match_prefix and prefix_cache is not None
        self.waiting: List[Request] = []
        self.slots: Dict[int, SlotState] = {}      # slot idx -> state
        self._submit_t: Dict[int, float] = {}      # uid -> queued time
        self._admit_seq = 0                        # FCFS chunk ordering
        # -- overload survival ---------------------------------------------
        if preemption not in ("off", "lru", "priority"):
            raise ValueError(f"unknown preemption policy {preemption!r}")
        self.preemption = preemption
        # a request preempted this many times is no longer a victim (with
        # back-of-queue re-entry this bounds preempt/resume churn)
        self.max_preemptions = max_preemptions
        self.host_store: Optional[HostKVStore] = None
        # engine-injected device closures (the scheduler stays host-side):
        # offload_fn(pages) -> blob, restore_fn(blob, pages)
        self.offload_fn: Optional[Callable] = None
        self.restore_fn: Optional[Callable] = None
        self._resume: Dict[int, PreemptedState] = {}   # uid -> ticket
        self.promoted_pages = 0        # host -> device trie re-promotions

    # -- queue --------------------------------------------------------------
    def submit(self, req: Request, now: float = 0.0) -> None:
        self.waiting.append(req)
        self._submit_t[req.uid] = now
        if self.trace is not None:
            self.trace.emit("enqueue", t=now, uid=req.uid,
                            prompt_len=req.prompt_len,
                            max_new=req.max_new_tokens,
                            deadline=req.deadline)

    def has_work(self) -> bool:
        return bool(self.waiting or self.slots)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.max_slots) if s not in self.slots]

    def pages_needed(self, req: Request) -> int:
        n = -(-(req.prompt_len + req.max_new_tokens) // self.page_size)
        if self.max_pages_per_slot is not None:
            # generation is clamped to the slot's max context at admission
            n = min(n, self.max_pages_per_slot)
        return n

    def _alloc_with_eviction(self, n: int) -> Optional[List[int]]:
        pages = self.allocator.alloc(n)
        if pages is None and self.prefix_cache is not None:
            self.prefix_cache.evict(n - self.allocator.free_count)
            pages = self.allocator.alloc(n)
        return pages

    # -- deadlines / backpressure -------------------------------------------
    def queued_pages_needed(self, req: Request) -> int:
        """Worst-case pages the queued ``req`` will claim: a preempted
        request resumes into exactly the page count it held."""
        pr = self._resume.get(req.uid)
        return pr.n_pages if pr is not None else self.pages_needed(req)

    def _finalize(self, req: Request, status: str, detail: str = "",
                  deadline_missed: bool = False) -> None:
        """Terminal bookkeeping for a request that will never (re)run:
        drop any resume ticket (its pre-preemption output becomes the
        partial result) and attach the outcome."""
        pr = self._resume.pop(req.uid, None)
        if pr is not None and pr.blob is not None \
                and self.host_store is not None:
            self.host_store.pop(("preempt", req.uid))
        req.result = pr.emitted[:req.max_new_tokens] if pr is not None \
            else []
        req.outcome = RequestOutcome(status=status,
                                     preemptions=req.preemptions,
                                     deadline_missed=deadline_missed,
                                     detail=detail)

    def cancel_expired(self, now: float = 0.0) -> List[Request]:
        """Cancel queued requests whose deadline or ``max_queue_wait`` has
        passed (``timed_out``) and requests that can never fit the pool
        (``rejected``).  Running slots are never cancelled.  Returns the
        cancelled requests with their outcomes attached."""
        kept, cancelled = [], []
        for req in self.waiting:
            status = detail = None
            missed = False
            waited = now - self._submit_t.get(req.uid, 0.0)
            if req.deadline is not None and now > req.deadline:
                status, missed = "timed_out", True
                detail = f"deadline {req.deadline:.3f}s passed in queue"
            elif req.max_queue_wait is not None \
                    and waited > req.max_queue_wait:
                status, missed = "timed_out", True
                detail = (f"queued {waited:.3f}s > max_queue_wait "
                          f"{req.max_queue_wait:.3f}s")
            elif self.queued_pages_needed(req) > self.allocator.num_pages:
                status = "rejected"
                detail = (f"needs {self.queued_pages_needed(req)} pages, "
                          f"pool holds {self.allocator.num_pages}")
            if status is None:
                kept.append(req)
                continue
            self._finalize(req, status, detail, deadline_missed=missed)
            cancelled.append(req)
            if self.trace is not None:
                self.trace.emit("cancel", t=now, uid=req.uid,
                                status=status, detail=detail)
        self.waiting = kept
        return cancelled

    def fail_head(self, detail: str = "") -> Optional[Request]:
        """Reject the head-of-line request (nothing is running, eviction
        already ran, and the head still cannot fit)."""
        if not self.waiting:
            return None
        req = self.waiting.pop(0)
        self._finalize(req, "rejected", detail)
        if self.trace is not None:
            self.trace.emit_now("cancel", uid=req.uid, status="rejected",
                                detail=detail)
        return req

    # -- preemption ---------------------------------------------------------
    def preempt_candidates(self, beneficiary: Request) -> List[int]:
        """Slots that may be preempted for ``beneficiary``: decoding slots
        only (a mid-prefill victim would waste its prefill), whose request
        has not used up ``max_preemptions``, and under "priority" whose
        priority is strictly below the beneficiary's."""
        if self.preemption == "off":
            return []
        out = []
        for s, st in self.slots.items():
            r = st.request
            if not st.prefill_done or not st.emitted:
                continue
            if r.preemptions >= self.max_preemptions:
                continue
            if self.preemption == "priority" \
                    and r.priority >= beneficiary.priority:
                continue
            out.append(s)
        return out

    def pick_victim(self, beneficiary: Request) -> Optional[int]:
        """The slot to evict for ``beneficiary``: lowest priority first,
        most recently admitted as the tiebreak (under "lru" only the
        latter counts): the oldest work in flight is closest to done."""
        cands = self.preempt_candidates(beneficiary)
        if not cands:
            return None
        return max(cands, key=lambda s: (-self.slots[s].request.priority,
                                         self.slots[s].admit_seq))

    def preemptible_headroom(self, beneficiary: Request) -> int:
        """Upper bound on the pages an admission could obtain from the
        free list, trie eviction and preempting every eligible victim.  A
        head needing more can never be helped by preemption."""
        evictable = self.prefix_cache.evictable_count() \
            if self.prefix_cache is not None else 0
        return (self.allocator.free_count + evictable
                + sum(len(self.slots[s].pages)
                      for s in self.preempt_candidates(beneficiary)))

    def preempt(self, slot: int, *, pending: int, ctx_len: int,
                rem_tokens: int) -> Tuple[SlotState, bool]:
        """Evict a decoding slot under pool pressure: snapshot its pages
        into the host tier (when one is attached and has room), free
        them, and re-queue the request at the BACK of the queue with its
        generated tokens (back-of-queue re-entry lets the beneficiary
        take the freed pages first, which breaks preempt/resume livelock).
        Returns (victim state, offloaded?).

        ``pending``/``ctx_len``/``rem_tokens`` come from the engine's
        slot arrays: the sampled-but-unwritten token, the written context
        length and the remaining budget.
        """
        st = self.slots.pop(slot)
        req = st.request
        if not (st.prefill_done and st.emitted):
            raise AssertionError("only decoding slots are preemptible")
        req.preemptions += 1
        blob = None
        if self.host_store is not None and self.offload_fn is not None:
            blob = self.offload_fn(st.pages)
            if not self.host_store.put(("preempt", req.uid), blob,
                                       evictable=False):
                blob = None            # host tier full: recompute-resume
        self.release_cow_source(st)
        for p in st.pages:
            self.allocator.decref(p)
        self._resume[req.uid] = PreemptedState(
            blob=blob, emitted=list(st.emitted), n_pages=len(st.pages),
            ctx_len=ctx_len, pending=pending, rem=rem_tokens)
        self.waiting.append(req)
        return st, blob is not None

    def _try_resume(self, req: Request, pr: PreemptedState, slot: int,
                    now: float) -> Optional[tuple]:
        """Re-admit a preempted request into the page count it held, then
        either mark the slot for a host-tier restore (the engine scatters
        the blob back) or set up a recompute-resume (prefill prompt +
        generated tokens as ordinary chunks, then continue from the kept
        pending token)."""
        pages = self._alloc_with_eviction(pr.n_pages)
        if pages is None:
            return None
        self.waiting.pop(0)
        self._resume.pop(req.uid)
        st = SlotState(request=req, pages=pages, fresh_pages=pages,
                       admitted_at=now,
                       submitted_at=self._submit_t.get(req.uid, 0.0),
                       admit_seq=self._admit_seq)
        self._admit_seq += 1
        st.emitted = list(pr.emitted)
        st.resume_ctx = list(req.tokens) + pr.emitted[:-1]
        if len(st.resume_ctx) != pr.ctx_len:
            raise AssertionError(
                "resume context desynchronized from written KV length")
        st.resume_pending = pr.pending
        st.resume_rem = pr.rem
        if pr.blob is not None:
            if self.host_store is not None:
                self.host_store.pop(("preempt", req.uid))
            st.restore_blob = pr.blob
            st.prefill_pos = pr.ctx_len    # KV comes back verbatim
            st.needs_init = False
        self.slots[slot] = st
        if self.trace is not None:
            self.trace.emit(
                "admit", t=now, uid=req.uid, slot=slot, matched_tokens=0,
                pages=len(pages),
                resume="hostkv" if pr.blob is not None else "recompute")
        return slot, st

    def _promote(self, tokens: List[int], matched: int,
                 mpages: List[int]) -> Tuple[int, List[int]]:
        """Extend a trie match from the host spill tier: while the next
        full page span of ``tokens`` is spilled, allocate a device page,
        restore the span into it and insert it into the trie again.  Each
        promoted page holds both the trie's reference and the caller's
        mapping reference.  Returns the extended (matched, pages)."""
        ps = self.page_size
        while matched % ps == 0 and matched + ps <= len(tokens):
            key = ("trie", tuple(tokens[:matched + ps]))
            blob = self.host_store.peek(key)
            if blob is None:
                break
            pg = self._alloc_with_eviction(1)
            if pg is None:
                break
            self.restore_fn(blob, pg)
            self.host_store.pop(key)
            # alloc's reference becomes the request mapping; the trie
            # takes its own through insert's incref
            self.prefix_cache.insert(tokens[:matched + ps],
                                     mpages + pg, matched + ps)
            mpages = mpages + pg
            matched += ps
            self.promoted_pages += 1
        return matched, mpages

    # -- admit / retire -----------------------------------------------------
    def try_admit(self, now: float = 0.0) -> Optional[tuple]:
        """Pop the head-of-line request into a free slot if the pool can
        hold it (a preempted head resumes).  Returns (slot_idx, SlotState)
        or None."""
        if not self.waiting:
            return None
        free = self.free_slots()
        if not free:
            if self.trace is not None:
                self.trace.emit("admission_denied", t=now,
                                uid=self.waiting[0].uid,
                                reason="no_free_slot")
            return None
        req = self.waiting[0]
        pr = self._resume.get(req.uid)
        if pr is not None:
            res = self._try_resume(req, pr, free[0], now)
            if res is None and self.trace is not None:
                self.trace.emit("admission_denied", t=now, uid=req.uid,
                                reason="pool_exhausted_resume",
                                pages_needed=pr.n_pages)
            return res
        total = self.pages_needed(req)
        matched, mpages = (0, [])
        if self.match_prefix and req.prompt_len > 1:
            # always leave >= 1 suffix token: its logits seed sampling
            matched, mpages = self.prefix_cache.match(
                req.tokens[:req.prompt_len - 1])
        shared = matched // self.page_size           # fully-covered pages
        cow_src = mpages[shared] if matched % self.page_size else -1
        # take references on every matched page BEFORE allocating: the
        # allocation may evict LRU trie leaves
        for p in mpages[:shared]:
            self.allocator.incref(p)                 # zero-copy mapping
        if cow_src >= 0:
            self.allocator.incref(cow_src)           # pin the COW source
        if cow_src < 0 and self.match_prefix and self.host_store is not None \
                and self.restore_fn is not None and req.prompt_len > 1:
            # page-aligned match end: the continuation may be spilled
            matched, mpages = self._promote(
                list(req.tokens[:req.prompt_len - 1]), matched, mpages)
            shared = matched // self.page_size
        fresh = self._alloc_with_eviction(total - shared)
        if fresh is None:
            for p in mpages[:shared]:
                self.allocator.decref(p)
            if cow_src >= 0:
                self.allocator.decref(cow_src)
            if self.trace is not None:
                self.trace.emit("admission_denied", t=now, uid=req.uid,
                                reason="pool_exhausted",
                                pages_needed=total - shared)
            return None
        self.waiting.pop(0)
        slot = free[0]
        st = SlotState(request=req, pages=mpages[:shared] + fresh,
                       fresh_pages=fresh, matched_len=matched,
                       shared_count=shared, cow_src=cow_src,
                       admitted_at=now,
                       submitted_at=self._submit_t.get(req.uid, 0.0),
                       prefill_pos=matched, admit_seq=self._admit_seq)
        self._admit_seq += 1
        req.prefix_tokens_matched = matched
        self.slots[slot] = st
        if self.trace is not None:
            self.trace.emit("admit", t=now, uid=req.uid, slot=slot,
                            matched_tokens=matched, pages=len(st.pages),
                            resume="no")
        return slot, st

    # -- unified token-budget iteration planning ----------------------------
    def next_batch(self, budget: int, decode_cost: int = 1) -> MixedPlan:
        """Plan one mixed iteration under ``budget`` total tokens: every
        decoding slot first, then FCFS prefill chunks of
        ``min(remaining prompt, remaining budget)`` tokens."""
        decode = [s for s in sorted(self.slots)
                  if self.slots[s].prefill_done]
        admitting = sorted((s for s in self.slots
                            if not self.slots[s].prefill_done),
                           key=lambda s: self.slots[s].admit_seq)
        rem = budget - decode_cost * len(decode)
        chunks: List[ChunkPlan] = []
        for s in admitting:
            if rem <= 0:
                break
            st = self.slots[s]
            c = min(st.ctx_len - st.prefill_pos, rem)
            chunks.append(ChunkPlan(slot=s, start=st.prefill_pos, length=c))
            rem -= c
        return MixedPlan(decode_slots=decode, chunks=chunks,
                         decode_cost=decode_cost)

    def pack_batch(self, plan: MixedPlan, pending_tok, lengths,
                   width: int) -> PackedBatch:
        """Flatten a :meth:`next_batch` plan into one token-packed ragged
        stream: decode segments first — slot s contributes its pending
        token ``pending_tok[s]`` at position ``lengths[s]`` — then each
        prefill chunk's prompt tokens, in plan (FCFS) order."""
        if plan.decode_cost != 1:
            raise ValueError("packed execution streams exactly one decode "
                             "token per slot")
        if plan.total_tokens > width:
            raise ValueError(f"plan of {plan.total_tokens} tokens exceeds "
                             f"bucket {width}")
        S = self.max_slots
        tokens = np.zeros(width, np.int32)
        slot_ids = np.full(width, -1, np.int32)
        positions = np.full(width, -1, np.int32)
        seg_slots = np.full(S, -1, np.int32)
        seg_start = np.zeros(S, np.int32)
        seg_len = np.zeros(S, np.int32)
        last_idx = np.zeros(S, np.int32)
        t = i = 0
        for s in plan.decode_slots:
            tokens[t] = pending_tok[s]
            slot_ids[t] = s
            positions[t] = lengths[s]
            seg_slots[i], seg_start[i], seg_len[i], last_idx[i] = s, t, 1, t
            t += 1
            i += 1
        for c in plan.chunks:
            ctx = self.slots[c.slot].ctx
            tokens[t:t + c.length] = ctx[c.start:c.start + c.length]
            slot_ids[t:t + c.length] = c.slot
            positions[t:t + c.length] = np.arange(c.start,
                                                  c.start + c.length)
            seg_slots[i], seg_start[i] = c.slot, t
            seg_len[i], last_idx[i] = c.length, t + c.length - 1
            t += c.length
            i += 1
        return PackedBatch(tokens=tokens, slot_ids=slot_ids,
                           positions=positions, seg_slots=seg_slots,
                           seg_start=seg_start, seg_len=seg_len,
                           last_idx=last_idx,
                           n_decode=len(plan.decode_slots),
                           n_segments=i, n_tokens=t)

    def release_cow_source(self, st: SlotState) -> None:
        """Drop the pin on the COW source page once the engine has copied
        it into the request's own tail page."""
        if st.cow_src >= 0:
            self.allocator.decref(st.cow_src)
            st.cow_src = -1

    def insert_prefix(self, st: SlotState, valid_len: int) -> int:
        """Index ``valid_len`` tokens of the slot's context (prompt, plus
        generated tokens at retire) into the prefix cache."""
        if self.prefix_cache is None or not self.match_prefix \
                or valid_len <= 0:
            return 0
        toks = list(st.request.tokens) + st.emitted
        return self.prefix_cache.insert(toks[:valid_len], st.pages,
                                        valid_len)

    def retire(self, slot: int, now: float = 0.0) -> SlotState:
        st = self.slots.pop(slot)
        st.finished_at = now
        req = st.request
        req.result = st.emitted[:req.max_new_tokens]
        req.outcome = RequestOutcome(
            status="truncated" if req.truncated else "completed",
            preemptions=req.preemptions,
            deadline_missed=(req.deadline is not None
                             and st.finished_at > req.deadline))
        self.release_cow_source(st)
        # finalized context -> cache it for future requests; the last
        # emitted token's KV may never have been written, so it is excluded
        cached_gen = max(len(st.emitted) - 1, 0)
        self.insert_prefix(st, req.prompt_len + cached_gen)
        for p in st.pages:
            self.allocator.decref(p)
        return st
