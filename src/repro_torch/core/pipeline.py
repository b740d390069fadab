"""Multi-stage parallel processing — the paper's pillar P4 (Figure 4), the
port's copy of ``repro.core.pipeline``.

Serving is split into stages connected by bounded queues: preprocessing
(tokenize, dynamic batching), inference (``generate_batch``) and
postprocessing (strip padding, detokenize).  While the card runs batch N,
the tokenizer prepares batch N+1 and the detokenizer drains batch N-1.
The stages are threads: PyTorch releases the GIL around its kernels and
device waits.  ``run_pipelined`` and ``run_sequential`` process the same
work (the Table-1 benchmark takes their ratio).

Unlike the reference's threads, a stage that raises stops the others
(every queue wait polls an abort flag) and the caller gets the exception:
a hang would outlast any time limit, and a swallowed failure would hide a
kernel's.  The inference stage makes the engine's CUDA device current in
its own thread; it launches on that device's current stream, the default
one, as the caller's thread does, so the split kernels' scratch and
counters (kept per device and stream) are the caller's too.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import List, Sequence

import torch

from repro_torch.core.sampling import SamplingParams
from repro_torch.core.scheduler import DynamicBatcher, Request, pad_batch

_STOP = object()
_POLL_S = 0.05


@dataclass
class PipelineResult:
    uid: int
    text: str
    token_ids: List[int]


class _Stages:
    """The queues and abort flag of one pipelined run."""

    def __init__(self, depth: int):
        self.q_pre = queue.Queue(maxsize=depth)
        self.q_post = queue.Queue(maxsize=depth)
        self.abort = threading.Event()
        self.errors: List[BaseException] = []

    def put(self, q, item) -> bool:
        """Put unless the run was aborted; False if it was."""
        while not self.abort.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def get(self, q):
        """The next item, or _STOP once the run was aborted."""
        while not self.abort.is_set():
            try:
                return q.get(timeout=_POLL_S)
            except queue.Empty:
                continue
        return _STOP

    def run(self, fn, *args):
        """A stage's thread body: an exception aborts the run."""
        try:
            fn(self, *args)
        except BaseException as e:             # re-raised by the caller
            self.errors.append(e)
            self.abort.set()


def _results(batch, gen, tokenizer) -> List[PipelineResult]:
    out = []
    for i, r in enumerate(batch.requests):
        row = gen[i]
        ids = [int(t) for t in row[row >= 0]]
        out.append(PipelineResult(
            uid=r.uid, token_ids=ids,
            text=tokenizer.decode(ids) if tokenizer else ""))
    return out


def _preprocess(st: _Stages, texts, tokenizer, batcher, max_new_tokens):
    """Stage 1: tokenize and batch by length bucket."""
    for uid, text in enumerate(texts):
        batcher.add(Request(uid=uid, tokens=tokenizer.encode(text),
                            max_new_tokens=max_new_tokens))
    while True:
        batch = batcher.next_batch()
        if batch is None:
            break
        toks, lens = pad_batch(batch)
        if not st.put(st.q_pre, (batch, toks, lens)):
            return
    st.put(st.q_pre, _STOP)


def _infer(st: _Stages, engine, sp):
    """Stage 2: prefill and decode on the engine's device."""
    if engine.device.type == "cuda":
        torch.cuda.set_device(engine.device)
    while True:
        item = st.get(st.q_pre)
        if item is _STOP:
            st.put(st.q_post, _STOP)
            return
        batch, toks, lens = item
        max_new = max(r.max_new_tokens for r in batch.requests)
        gen = engine.generate_batch(toks, lens, max_new, sp)
        if not st.put(st.q_post, (batch, gen)):
            return


def _postprocess(st: _Stages, tokenizer, results):
    """Stage 3: strip padding and detokenize."""
    while True:
        item = st.get(st.q_post)
        if item is _STOP:
            return
        results.extend(_results(*item, tokenizer))


def run_pipelined(texts: Sequence[str], tokenizer, engine, *,
                  max_new_tokens: int = 16,
                  sp: SamplingParams = SamplingParams(), max_batch: int = 8,
                  queue_depth: int = 4) -> List[PipelineResult]:
    """The paper's Figure-4 topology: pre || infer || post as concurrent
    stages.  Results come back sorted by request order; an exception in
    any stage is raised here once every stage has stopped."""
    batcher = DynamicBatcher(max_batch=max_batch,
                             buckets=engine.prompt_buckets())
    st = _Stages(queue_depth)
    results: List[PipelineResult] = []
    threads = [
        threading.Thread(target=st.run, args=(
            _preprocess, texts, tokenizer, batcher, max_new_tokens)),
        threading.Thread(target=st.run, args=(_infer, engine, sp)),
        threading.Thread(target=st.run, args=(
            _postprocess, tokenizer, results)),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if st.errors:
        raise st.errors[0]
    results.sort(key=lambda r: r.uid)
    return results


def run_sequential(texts: Sequence[str], tokenizer, engine, *,
                   max_new_tokens: int = 16,
                   sp: SamplingParams = SamplingParams(),
                   max_batch: int = 8) -> List[PipelineResult]:
    """The paper's flow before the optimisation: strictly sequential
    stages."""
    batcher = DynamicBatcher(max_batch=max_batch,
                             buckets=engine.prompt_buckets())
    for uid, text in enumerate(texts):
        batcher.add(Request(uid=uid, tokens=tokenizer.encode(text),
                            max_new_tokens=max_new_tokens))
    results: List[PipelineResult] = []
    while True:
        batch = batcher.next_batch()
        if batch is None:
            break
        toks, lens = pad_batch(batch)
        gen = engine.generate_batch(toks, lens, max_new_tokens, sp)
        results.extend(_results(batch, gen, tokenizer))
    results.sort(key=lambda r: r.uid)
    return results
