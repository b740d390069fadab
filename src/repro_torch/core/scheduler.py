"""Request records, length buckets and dynamic batching (the port's copy
of ``repro.core.scheduler``, the paper's §2.3 "dynamic batch size").

Requests are sorted by prompt length and grouped into batches whose padded
shapes come from a small set of length buckets, so padding waste stays
small and the set of prefill shapes stays bounded.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)


class PromptOverflowError(ValueError):
    """Prompt longer than the largest bucket with overflow='reject'."""


def truncate_prompt(tokens: List[int], limit: int, *,
                    uid: Optional[int] = None) -> List[int]:
    """Left-truncate an over-long prompt to its last ``limit`` tokens,
    warning loudly — the *recent* context is what conditions generation."""
    if len(tokens) <= limit:
        return tokens
    who = f"request {uid}" if uid is not None else "request"
    warnings.warn(
        f"{who}: prompt of {len(tokens)} tokens exceeds the maximum "
        f"length {limit}; keeping the last {limit} tokens",
        stacklevel=2)
    return tokens[-limit:]


TERMINAL_STATUSES = ("completed", "truncated", "timed_out", "rejected")


@dataclass
class RequestOutcome:
    """Terminal disposition of a request on the continuous path: every
    submitted request ends in exactly one of ``TERMINAL_STATUSES`` —
    overload degrades outcomes, it never loses requests.

      completed  served to EOS / its token budget
      truncated  served, but the prompt was cut to fit the context
      timed_out  cancelled in the queue (deadline / max_queue_wait);
                 tokens generated before a preemption are preserved
      rejected   could never fit (pool smaller than the request)
    """
    status: str
    preemptions: int = 0               # times the request lost its slot
    deadline_missed: bool = False      # finished (or died) past deadline
    detail: str = ""


@dataclass
class Request:
    uid: int
    tokens: List[int]                  # prompt token ids
    max_new_tokens: int = 32
    result: Optional[List[int]] = None # filled by the engine
    # prompt tokens served zero-copy from the radix prefix cache
    prefix_tokens_matched: int = 0
    priority: int = 0                  # higher preempts lower under the
    #                                    "priority" preemption policy
    deadline: Optional[float] = None   # absolute serve-clock seconds
    max_queue_wait: Optional[float] = None  # seconds from submission
    truncated: bool = False            # prompt was cut to fit the context
    preemptions: int = 0               # slot evictions suffered so far
    outcome: Optional[RequestOutcome] = None  # set once, at a terminal point

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


@dataclass
class Batch:
    requests: List[Request]
    padded_len: int

    @property
    def size(self) -> int:
        return len(self.requests)


@dataclass
class DynamicBatcher:
    max_batch: int = 8
    buckets: Sequence[int] = DEFAULT_BUCKETS
    sort_by_length: bool = True        # the paper's inference-order trick
    overflow: str = "truncate"         # over-long prompts: truncate | reject
    _queue: List[Request] = field(default_factory=list)

    def add(self, req: Request) -> None:
        limit = self.buckets[-1]
        if req.prompt_len > limit:
            if self.overflow == "reject":
                raise PromptOverflowError(
                    f"request {req.uid}: prompt of {req.prompt_len} tokens "
                    f"exceeds the largest bucket ({limit})")
            req.tokens = truncate_prompt(req.tokens, limit, uid=req.uid)
        self._queue.append(req)

    def pending(self) -> int:
        return len(self._queue)

    def next_batch(self) -> Optional[Batch]:
        """Greedy: take up to max_batch requests sharing a length bucket."""
        if not self._queue:
            return None
        if self.sort_by_length:
            self._queue.sort(key=lambda r: r.prompt_len)
        head_bucket = pick_bucket(self._queue[0].prompt_len, self.buckets)
        take: List[Request] = []
        rest: List[Request] = []
        for r in self._queue:
            if (len(take) < self.max_batch
                    and pick_bucket(r.prompt_len, self.buckets)
                    == head_bucket):
                take.append(r)
            else:
                rest.append(r)
        self._queue = rest
        return Batch(requests=take, padded_len=head_bucket)


def pad_batch(batch: Batch, pad_id: int = 0):
    """-> (tokens (B, L) int32, lengths (B,) int32)."""
    B, L = batch.size, batch.padded_len
    toks = np.full((B, L), pad_id, np.int32)
    lens = np.zeros((B,), np.int32)
    for i, r in enumerate(batch.requests):
        if len(r.tokens) > L:
            # DynamicBatcher.add truncates on entry: a longer prompt here
            # is a hand-built Batch, refused rather than clipped
            raise PromptOverflowError(
                f"request {r.uid}: {len(r.tokens)} tokens > padded_len {L}")
        toks[i, :len(r.tokens)] = r.tokens
        lens[i] = len(r.tokens)
    return toks, lens
