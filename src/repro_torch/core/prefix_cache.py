"""Radix prefix cache — cross-request KV reuse over the paged pool (the
port's copy of ``repro.core.prefix_cache``).

  * a radix trie keyed on token ids, one node per KV *page span*
    (``page_size`` tokens; tail nodes may be partial),
  * page refcounts via :class:`~repro_torch.core.continuous.PageAllocator`
    (the trie holds one reference per cached node; every request mapping
    a page holds another),
  * copy-on-write discipline: a page referenced by anyone else is never
    written — a request whose match ends inside a page gets a fresh copy
    of that partial tail page (``kv_cache.copy_pages``),
  * LRU eviction of unreferenced leaves when the pool runs dry; with a
    host tier attached, an evicted full-page leaf is spilled into it and
    promoted back into the pool when a later admission matches it.

:func:`shareable` is the per-layer opt-out gate: sharing is only sound
for position-stable K/V written once at prefill.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ATTN, MOE_FFN, ModelConfig


def shareable(cfg: ModelConfig, max_len: int) -> Optional[str]:
    """None if every layer family supports paged prefix sharing, else a
    human-readable reason naming the first opted-out layer family."""
    from repro_torch.core import kv_cache as KV
    for stack in cfg.stacks:
        for spec in stack.pattern:
            if spec.mixer != ATTN:
                return (f"layer family '{spec.mixer}' keeps dense/ring "
                        f"state that cannot be shared across requests")
            if KV.effective_window(cfg, spec, max_len) is not None:
                return ("sliding-window attention cyclically overwrites "
                        "its pages (ring), so they cannot be shared")
            if spec.ffn == MOE_FFN:
                return ("capacity-routed MoE drops tokens as a function "
                        "of batch composition; suffix-only prefill would "
                        "change results")
    return None


@dataclass
class _Node:
    """One cached page span: ``tokens`` (<= page_size ids) backed by
    physical ``page``.  Partial nodes are always leaves."""
    tokens: Tuple[int, ...]
    page: int
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = field(default_factory=dict)
    tick: int = 0
    pinned: bool = False               # seeded by set_prefix: never evicted


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class RadixPrefixCache:
    """Trie over token-id page spans -> physical pages of the paged pool.

    The cache owns one allocator reference per resident node; ``match``
    does NOT take references (the scheduler increfs the pages it maps
    into a request).  Eviction only considers unpinned leaves whose page
    has no reference beyond the trie's own.
    """

    def __init__(self, allocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        self.root = _Node(tokens=(), page=-1, parent=None)
        self._tick = 0
        self.evicted_pages = 0         # cumulative, survives serve runs
        # host spill tier (set per serve call by the engine): evicted
        # full-page leaves demote into ``host_store`` through
        # ``offload_fn`` instead of dropping, and the scheduler promotes
        # them back on a match
        self.host_store = None         # HostKVStore or None
        self.offload_fn = None         # pages -> blob (device closure)
        self.spilled_pages = 0         # cumulative leaves demoted to host
        self.trace = None              # optional ServeTracer (set per serve)

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            nd = stack.pop()
            yield nd
            stack.extend(nd.children.values())

    @property
    def num_nodes(self) -> int:
        return sum(1 for _ in self._iter_nodes())

    @property
    def resident_pages(self) -> List[int]:
        return [nd.page for nd in self._iter_nodes()]

    def evictable_count(self) -> int:
        """Pages :meth:`evict` could free right now: unpinned leaves no
        live request maps (the scheduler's preemption-headroom bound)."""
        return sum(1 for nd in self._iter_nodes()
                   if not nd.children and not nd.pinned
                   and self.allocator.refcount(nd.page) == 1)

    def _span_key(self, node: _Node) -> tuple:
        """Host-tier key of a node: its full token path from the root
        (what a later admission looks up)."""
        parts = []
        cur = node
        while cur is not None and cur.parent is not None:
            parts.append(cur.tokens)
            cur = cur.parent
        return ("trie", tuple(t for chunk in reversed(parts)
                              for t in chunk))

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.tick = self._tick

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens``: (matched_len, pages), the
        pages covering spans [0, ps), [ps, 2 ps), ... of the match; the
        last page is partial when the match ends inside it."""
        node, m, pages = self.root, 0, []
        ps = self.page_size
        while m < len(tokens):
            chunk = tokens[m:m + ps]
            best, best_l = None, 0
            for child in node.children.values():
                l = _common_prefix(child.tokens, chunk)
                if l > best_l:
                    best, best_l = child, l
            if best is None:
                break
            self._touch(best)
            pages.append(best.page)
            m += best_l
            if best_l < ps:
                break                       # partial use / tail node: stop
            node = best
        return m, pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               valid_len: int, pin: bool = False) -> int:
        """Index ``tokens[:valid_len]`` whose KV lives in ``pages``
        (block-table order).  Only spans the trie doesn't already cover
        take a new reference; a partial tail node that our tokens extend
        is swapped to our page.  ``pin`` marks every node of the path
        unevictable (``set_prefix``).  Returns the number of pages newly
        retained by the trie."""
        node, i, pi, kept = self.root, 0, 0, 0
        ps = self.page_size
        while i < valid_len:
            chunk = tuple(tokens[i:min(i + ps, valid_len)])
            exact = node.children.get(chunk)
            if exact is not None:
                self._touch(exact)
                if pin:
                    exact.pinned = True
                if len(chunk) < ps:
                    break
                node, i, pi = exact, i + ps, pi + 1
                continue
            ext = cover = None
            for child in node.children.values():
                l = _common_prefix(child.tokens, chunk)
                if l == len(child.tokens) and l < len(chunk):
                    ext = child                 # child is a prefix of ours
                elif l == len(chunk) and l < len(child.tokens):
                    cover = child               # ours is a prefix of child
            if cover is not None:
                self._touch(cover)
                if pin:
                    cover.pinned = True
                break
            if ext is not None:
                # extend the partial node in place: swap to our page
                self.allocator.incref(pages[pi])
                self.allocator.decref(ext.page)
                del node.children[ext.tokens]
                ext.tokens = chunk
                ext.page = pages[pi]
                node.children[chunk] = ext
                child_node = ext
            else:
                self.allocator.incref(pages[pi])
                child_node = _Node(tokens=chunk, page=pages[pi], parent=node)
                node.children[chunk] = child_node
            kept += 1
            self._touch(child_node)
            if pin:
                child_node.pinned = True
            if len(chunk) < ps:
                break
            node, i, pi = child_node, i + ps, pi + 1
        return kept

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pool pages by dropping unpinned LRU
        leaves whose page has no reference besides the trie's own
        (spilling full-page leaves into the host tier when one is
        attached).  Returns the number actually freed."""
        heap = [(nd.tick, id(nd), nd) for nd in self._iter_nodes()
                if not nd.children and not nd.pinned]
        heapq.heapify(heap)
        freed = 0
        spilled0 = self.spilled_pages
        while heap and freed < n_pages:
            _, _, nd = heapq.heappop(heap)
            if nd.children or nd.pinned or nd.parent is None:
                continue                        # stale heap entry
            if self.allocator.refcount(nd.page) > 1:
                continue                        # a live request maps it
            if (self.host_store is not None and self.offload_fn is not None
                    and len(nd.tokens) == self.page_size):
                # demote to host instead of dropping (full-page leaves
                # only: a partial span is not addressable by the
                # page-aligned promote lookup); a refused put (host full)
                # degrades to the plain drop below
                if self.host_store.put(self._span_key(nd),
                                       self.offload_fn([nd.page])):
                    self.spilled_pages += 1
            self.allocator.decref(nd.page)
            freed += 1
            self.evicted_pages += 1
            parent = nd.parent
            del parent.children[nd.tokens]
            nd.parent = None
            if (parent is not self.root and not parent.children
                    and not parent.pinned):
                heapq.heappush(heap, (parent.tick, id(parent), parent))
        if self.trace is not None and n_pages > 0:
            self.trace.emit_now("prefix_evict", requested=int(n_pages),
                                freed=int(freed),
                                spilled=int(self.spilled_pages - spilled0))
        return freed

    def unpin_all(self) -> None:
        """Unpin every node: seeded prefixes become ordinary LRU-evictable
        entries."""
        for nd in self._iter_nodes():
            nd.pinned = False
