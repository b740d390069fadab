"""The port's host-side serving bookkeeping against the reference, in
lockstep: the same random request traces drive the reference's
``ContinuousScheduler`` / ``RadixPrefixCache`` / ``PageAllocator`` and
the port's copies, through admission (prefix matches, COW tails, trie
eviction under a tight pool), iteration planning, packing and
retirement.  Every decision and the allocator state must be identical."""
import numpy as np
import pytest

from repro.core import continuous as JC
from repro.core import prefix_cache as JPC
from repro.core.scheduler import Request as JRequest
from repro_torch.core import continuous as C
from repro_torch.core import prefix_cache as PC
from repro_torch.core.scheduler import Request

PAGE, SLOTS, PPS = 4, 3, 8           # contexts stay within PPS * PAGE


def _make(mod_c, mod_pc, num_pages):
    alloc = mod_c.PageAllocator(num_pages)
    trie = mod_pc.RadixPrefixCache(alloc, PAGE)
    return mod_c.ContinuousScheduler(SLOTS, alloc, PAGE,
                                     max_pages_per_slot=PPS,
                                     prefix_cache=trie)


def _state(sched):
    a = sched.allocator
    return (sorted(a._free), sorted(a._ref.items()),
            sorted(sched.prefix_cache.resident_pages),
            sched.prefix_cache.evicted_pages)


def _slot_view(st):
    return (st.pages, st.fresh_pages, st.matched_len, st.shared_count,
            st.cow_src, st.prefill_pos)


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_lockstep_with_reference(seed):
    rng = np.random.default_rng(seed)
    prefixes = [list(map(int, rng.integers(4, 50, size=n)))
                for n in (5, 9, 14)]
    num_pages = int(rng.integers(12, 22))       # tight: forces eviction
    ref, ours = _make(JC, JPC, num_pages), _make(C, PC, num_pages)
    tok = np.zeros(SLOTS, np.int32)
    lens = np.zeros(SLOTS, np.int32)
    uid = cows = 0
    for step in range(60):
        if uid < 24 and rng.random() < 0.5:
            body = list(map(int, rng.integers(4, 50,
                                              size=int(rng.integers(1, 9)))))
            pre = prefixes[int(rng.integers(0, 3))] if rng.random() < 0.7 \
                else []
            new = int(rng.integers(1, 6))
            ref.submit(JRequest(uid=uid, tokens=[2] + pre + body,
                                max_new_tokens=new))
            ours.submit(Request(uid=uid, tokens=[2] + pre + body,
                                max_new_tokens=new))
            uid += 1
        while True:
            a, b = ref.try_admit(), ours.try_admit()
            assert (a is None) == (b is None)
            if a is None:
                break
            assert a[0] == b[0] and _slot_view(a[1]) == _slot_view(b[1])
            cows += a[1].cow_src >= 0
        assert _state(ref) == _state(ours)
        if not ref.slots:
            continue
        budget = int(rng.integers(SLOTS, 12))
        pa, pb = ref.next_batch(budget), ours.next_batch(budget)
        assert pa.decode_slots == pb.decode_slots
        assert [(c.slot, c.start, c.length) for c in pa.chunks] == \
            [(c.slot, c.start, c.length) for c in pb.chunks]
        width = -(-pa.total_tokens // 8) * 8
        ka = ref.pack_batch(pa, tok, lens, width)
        kb = ours.pack_batch(pb, tok, lens, width)
        for f in ("tokens", "slot_ids", "positions", "seg_slots",
                  "seg_start", "seg_len", "last_idx"):
            np.testing.assert_array_equal(getattr(ka, f), getattr(kb, f))
        # advance both the same way: chunks prefill, decode slots emit
        emits = {s: int(rng.integers(4, 50)) for s in pa.decode_slots}
        for sched, plan in ((ref, pa), (ours, pb)):
            for c in plan.chunks:
                st = sched.slots[c.slot]
                if st.needs_init:
                    st.needs_init = False
                    sched.release_cow_source(st)
                st.prefill_pos = c.start + c.length
                if st.prefill_done:
                    sched.insert_prefix(st, (st.ctx_len // PAGE) * PAGE)
                    st.emitted.append(7)
            for s in plan.decode_slots:
                sched.slots[s].emitted.append(emits[s])
        for s in sorted(ref.slots):
            st = ref.slots[s]
            if st.prefill_done and len(st.emitted) >= \
                    st.request.max_new_tokens:
                ra, rb = ref.retire(s), ours.retire(s)
                assert ra.request.result == rb.request.result
        assert _state(ref) == _state(ours)
        ours.allocator.check()
    # the traces reach the interesting cases: shared-prefix COW tails and
    # trie eviction under the tight pool
    assert cows > 0 and ours.prefix_cache.evicted_pages > 0
