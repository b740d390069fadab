"""What the split launches share: the card's SM count, which their split
plans aim to fill, and their scratch memory, kept per (device, stream).

A launch that splits its reduction over several blocks (the tensor-core
paged attention bodies, the bf16/fp16 ``quant_matmul`` bodies) writes each
split's partial result to an fp32 scratch buffer, and the last block of a
group to arrive, found with an int32 arrival counter, merges them and
resets the counter.  The flash backward's split dK/dV blocks write their
partials to the same buffer and a second launch adds them, in order.
Both buffers are allocated once per (device, stream) and grown as
needed, so a launch allocates nothing.  Launches on one stream
run in order, so they may share the buffers; two streams never do, since
two launches in flight at once would count their arrivals in the same
counters.  A buffer that is grown is replaced by a larger one made on the
same stream, so the caching allocator hands the old memory out again only
after the stream's earlier work.
"""
from __future__ import annotations

import functools

import torch

_COUNTERS = {}
_SCRATCH = {}


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_counters(device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros for the launches on ``stream`` (its
    ``cuda_stream`` handle) of ``device``; the kernels leave them zero."""
    key = (device, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = c
    return c


def split_scratch(device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` fp32 scratch values for the launches on ``stream`` of
    ``device`` (contents undefined)."""
    key = (device, stream)
    s = _SCRATCH.get(key)
    if s is None or s.numel() < n:
        s = torch.empty(max(n, 1 << 20), dtype=torch.float32, device=device)
        _SCRATCH[key] = s
    return s
