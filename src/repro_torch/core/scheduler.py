"""Request records and length buckets (the port's copy of the parts of
``repro.core.scheduler`` the continuous path uses)."""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import List, Optional, Sequence

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)


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
