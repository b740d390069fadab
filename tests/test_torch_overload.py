"""Overload survival in the port against the reference, on the CPU:
preemption with a host KV tier, recompute-resume, deadlines, fault
injection and the trie's host spill tier, on reduced qwen3-4b at fp32
(2 layers; the reference's parameters converted by ``bridge``).

* ``offload_pages`` / ``restore_pages`` round-trip every paged leaf
  bit-identically into other pages (fp32 and int8 pools: codes, scale
  pools, positions), and ``blob_bytes`` equals the reference's for the
  same pool geometry.
* The same requests, pool, policy and options go into both packages'
  ``serve_continuous``: greedy streams, every request's outcome status
  and ``deadline_missed``, and the overload counters must be equal
  (exactly: they are counts, and the streams are held token for token).
  The cases: ``lru`` and ``priority`` preemption on a pool of about a
  third of the demand (fp32 and int8 pools, and the n-gram drafter),
  recompute-resume without a host tier and under
  ``FaultConfig(host_full=True)``, every ``FaultConfig`` field, a
  deadline, ``max_queue_wait`` and ``max_preemptions``.  The serve
  clock is wall time, so nothing here may depend on how fast a serve
  runs: arrival offsets are left out (except where ``collapse_arrivals``
  ignores them), the deadline has passed before the serve starts, the
  ``max_queue_wait`` of 0 expires at once, and the fault cases'
  ``max_queue_wait`` (set, as in the reference's fault tests) lies far
  beyond any serve.
* Inside the port, preempting serves (``debug_audit=True``, which checks
  the allocator and host accounting on every iteration) give the streams
  of the uncontended serve.
* Scheduler-level invariants of the reference (seeded preempt/resume
  traces, sharing safety, deadline misses) hold on the port's scheduler.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.core import kv_cache as JKV
from repro.core.continuous import FaultConfig as JFaultConfig
from repro.core.engine import InferenceEngine as JEngine
from repro.core.precision import FP32 as J_FP32
from repro.core.scheduler import Request as JRequest
from repro.core.speculative import SpecConfig as JSpecConfig
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs.registry import get_reduced
from repro_torch.core import kv_cache as KV
from repro_torch.core.continuous import (ContinuousScheduler, FaultConfig,
                                         HostKVStore, PageAllocator,
                                         ServeMetrics)
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.precision import FP32
from repro_torch.core.prefix_cache import RadixPrefixCache
from repro_torch.core.scheduler import TERMINAL_STATUSES, Request
from repro_torch.core.speculative import SpecConfig
from repro_torch.models import transformer as T

ARCH = "qwen3-4b"
# demand: 6 requests x 5 pages = 30 pages; pool: 11 pages (~1/3)
SHAPES = [(30, 8), (28, 8), (26, 8), (24, 8), (22, 8), (20, 8)]
POOL = 11
HOST = 1 << 30


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These serves are many small ops: one intra-op thread keeps them
    fast when several test workers share the cores (with a thread per
    core in every worker they ran up to 100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
CONTENDED = dict(num_pages=POOL, preemption="lru", host_kv_bytes=HOST,
                 debug_audit=True)
COUNTERS = ("preemptions", "resumed", "offloaded_pages", "restored_pages",
            "host_bytes_peak", "host_bytes_used", "timed_out",
            "deadline_misses", "rejected", "admission_stalls", "admitted",
            "retired", "generated_tokens", "prefix_evicted_pages")


@pytest.fixture(scope="module")
def model():
    jparams = JT.init_params(jax.random.PRNGKey(0), j_get_reduced(ARCH),
                             J_FP32)
    return jparams, bridge.params_from_jax(jax.tree.map(np.asarray, jparams))


def _prompts(seed, shapes, prefix=()):
    rng = np.random.default_rng(seed)
    return [([2] + list(prefix) + [int(t) for t in rng.integers(
        4, 400, size=ln)], mn) for ln, mn in shapes]


# case -> (prompt seed, shapes, engine max_batch, serve options, request
# fields by index, options given to the port only / the reference only)
def _cases():
    wait = {i: {"max_queue_wait": 600.0} for i in range(3, 6)}
    arr = [0.0, 0.0, 0.05, 0.05, 0.1, 0.1]
    return {
        "lru": (1, SHAPES, 3, CONTENDED, {}),
        "lru_int8": (2, SHAPES, 3, CONTENDED, {}),
        "lru_spec": (3, SHAPES, 3, CONTENDED, {}),
        "priority": (4, SHAPES[:4], 3,
                     {**CONTENDED, "preemption": "priority"},
                     {2: {"priority": 5}}),
        "priority_equal": (5, SHAPES[:4], 3,
                           {**CONTENDED, "preemption": "priority"}, {}),
        "no_host": (6, SHAPES, 3,
                    dict(num_pages=POOL, preemption="lru",
                         debug_audit=True), {}),
        "host_full": (7, SHAPES, 3,
                      {**CONTENDED, "faults": "host_full"}, {}),
        "max_preemptions": (8, SHAPES, 3,
                            {**CONTENDED, "max_preemptions": 1}, {}),
        "hold_pages": (9, SHAPES, 3, {**CONTENDED, "faults": "hold"}, wait),
        "oversize": (10, SHAPES, 3, {**CONTENDED, "faults": "oversize"},
                     wait),
        "collapse_arrivals": (11, SHAPES, 3,
                              {**CONTENDED, "faults": "collapse",
                               "arrivals": arr}, wait),
        "all_faults": (12, SHAPES, 3,
                       {**CONTENDED, "faults": "all", "arrivals": arr},
                       wait),
        "deadline": (13, [(20, 6), (18, 6), (16, 6)], 2, {},
                     {2: {"deadline": -1.0}}),
        "max_queue_wait": (14, [(30, 8), (28, 8), (26, 8), (24, 8)], 2,
                           {"num_pages": POOL},
                           {2: {"max_queue_wait": 0.0},
                            3: {"max_queue_wait": 0.0}}),
    }


FAULTS = {"host_full": dict(host_full=True),
          "hold": dict(hold_pages=6, hold_after_admits=2),
          "oversize": dict(oversize_uids=(1, 3)),
          "collapse": dict(collapse_arrivals=True),
          "all": dict(hold_pages=8, host_full=True, oversize_uids=(0,),
                      collapse_arrivals=True)}


def _serve(pkg, params, name, contended=True):
    """One case through one package (``contended=False``: the same
    requests on the default pool, without preemption)."""
    seed, shapes, max_batch, opts, fields = _cases()[name]
    opts = dict(opts)
    fault = opts.pop("faults", None)
    if not contended:
        opts = {}
    jax_side = pkg == "jax"
    int8 = name.endswith("int8")
    if jax_side:
        policy = dataclasses.replace(J_FP32, kv_dtype="int8") if int8 \
            else J_FP32
        eng = JEngine(j_get_reduced(ARCH), params, policy=policy,
                      max_len=64, max_batch=max_batch)
        Req, Fault, Spec = JRequest, JFaultConfig, JSpecConfig
        opts["chunked_prefill"] = True
    else:
        policy = dataclasses.replace(FP32, kv_dtype="int8") if int8 \
            else FP32
        eng = InferenceEngine(get_reduced(ARCH), params, policy=policy,
                              max_len=64, max_batch=max_batch, device="cpu")
        Req, Fault, Spec = Request, FaultConfig, SpecConfig
    if fault is not None and contended:
        opts["faults"] = Fault(**FAULTS[fault])
    if name.endswith("spec"):
        opts["spec"] = Spec(k=3, drafter="ngram")
    reqs = [Req(uid=i, tokens=list(p), max_new_tokens=mn,
                **fields.get(i, {}))
            for i, (p, mn) in enumerate(_prompts(seed, shapes))]
    done, m = eng.serve_continuous(reqs, page_size=8, max_batched_tokens=16,
                                   **opts)
    return done, m


@pytest.fixture(scope="module")
def reference(model):
    """The reference's serve of each case, run once per module."""
    jparams, _ = model
    runs = {}

    def get(name):
        if name not in runs:
            runs[name] = _serve("jax", jparams, name)
        return runs[name]
    return get


# ---------------------------------------------------------------------------
# HostKVStore accounting
# ---------------------------------------------------------------------------


def _blob(nbytes):
    """A stand-in offload blob of ``nbytes`` host bytes (one paged layer)."""
    return [{"pk": torch.zeros(nbytes, dtype=torch.int8)}]


def test_host_store_budget_and_lru():
    hs = HostKVStore(max_bytes=100)
    assert hs.put("a", _blob(40)) and hs.put("b", _blob(40))
    assert hs.used_bytes == 80
    hs.peek("a")                           # refresh a: b becomes LRU
    assert hs.put("c", _blob(40))          # evicts b
    assert "b" not in hs and "a" in hs and "c" in hs
    assert hs.spill_evictions == 1 and hs.used_bytes == 80
    hs.check()


def test_host_store_nonevictable_protected():
    hs = HostKVStore(max_bytes=100)
    assert hs.put("pinned", _blob(80), evictable=False)
    assert not hs.put("big", _blob(50))    # cannot evict the pinned entry
    assert hs.refused_puts == 1 and "pinned" in hs
    assert hs.pop("pinned") is not None
    assert hs.used_bytes == 0
    hs.check()


def test_host_store_overwrite_zero_budget_and_unbounded():
    hs = HostKVStore(max_bytes=100)
    hs.put("k", _blob(60))
    assert hs.put("k", _blob(30))          # replace: bytes re-accounted
    assert hs.used_bytes == 30 and len(hs) == 1
    full = HostKVStore(max_bytes=0)        # the host-tier-full fault
    assert not full.put("x", _blob(1))
    assert full.used_bytes == 0 and full.refused_puts == 1
    unb = HostKVStore(max_bytes=None)
    for i in range(5):
        assert unb.put(i, _blob(1000))
    assert unb.used_bytes == unb.peak_bytes == 5000
    for store in (hs, full, unb):
        store.check()


# ---------------------------------------------------------------------------
# offload_pages / restore_pages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_offload_restore_bit_identical(kv_dtype):
    cfg = get_reduced(ARCH)
    cache = T.init_paged_cache(cfg, num_pages=8, page_size=8,
                               dtype=torch.float32, kv_dtype=kv_dtype)
    gen = torch.Generator().manual_seed(0)
    for c in cache["layers"]:
        for k in KV.PAGED_KEYS:
            if k not in c:
                continue
            if c[k].dtype == torch.int32:
                c[k].copy_(torch.randint(-1, 50, c[k].shape, generator=gen))
            elif c[k].dtype == torch.int8:
                c[k].copy_(torch.randint(-127, 128, c[k].shape,
                                         generator=gen))
            else:
                c[k].copy_(torch.randn(c[k].shape, generator=gen) * 3)
    src, dst = [1, 3, 6], [0, 2, 5]
    before = [{k: v.clone() for k, v in c.items()} for c in cache["layers"]]
    blob = KV.offload_pages(cache, src)
    leaf = blob[0]
    assert set(leaf) == ({"pk", "pv", "ppos", "pk_scale", "pv_scale"}
                         if kv_dtype == "int8" else {"pk", "pv", "ppos"})
    # the reference's blob of the same pool geometry has as many bytes
    jcache = JT.init_paged_cache(j_get_reduced(ARCH), num_pages=8,
                                 page_size=8, max_slots=2, max_len=64,
                                 dtype=np.float32, kv_dtype=kv_dtype)
    assert KV.blob_bytes(blob) == JKV.blob_bytes(
        JKV.offload_pages(jcache, src)) > 0
    KV.reset_pages_all(cache, torch.tensor(src))      # clobber the source
    KV.restore_pages(cache, blob, dst)                # land elsewhere
    for c, b in zip(cache["layers"], before):
        for k in b:
            assert torch.equal(c[k][dst], b[k][src]), k
            keep = [p for p in range(9) if p not in src + dst]
            assert torch.equal(c[k][keep], b[k][keep]), k


# ---------------------------------------------------------------------------
# serve_continuous: the port against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(_cases()))
def test_overload_serve_matches_reference(model, reference, name):
    _, tparams = model
    jdone, jm = reference(name)
    done, m = _serve("torch", tparams, name)
    assert [r.result for r in done] == [r.result for r in jdone]
    for r, jr in zip(done, jdone):
        assert r.outcome is not None and r.outcome.status in \
            TERMINAL_STATUSES
        assert (r.outcome.status, r.outcome.deadline_missed,
                r.outcome.preemptions, r.preemptions) == (
            jr.outcome.status, jr.outcome.deadline_missed,
            jr.outcome.preemptions, jr.preemptions), r.uid
    for k in COUNTERS:
        assert getattr(m, k) == getattr(jm, k), k
    assert m.outcome_counts == jm.outcome_counts
    assert sum(m.outcome_counts.values()) == len(done)
    # what each case is there to exercise
    if name in ("lru", "lru_int8", "lru_spec", "priority"):
        assert m.preemptions >= 1 and m.resumed == m.preemptions
        assert m.offloaded_pages > 0 and m.restored_pages > 0
        assert m.host_bytes_peak > 0
    if name in ("no_host", "host_full"):
        assert m.preemptions >= 1 and m.offloaded_pages == 0
    if name == "priority":
        assert done[2].preemptions == 0    # the priority-5 request
    if name == "priority_equal":
        assert m.preemptions == 0          # strictly-lower rule
    if name == "max_preemptions":
        assert all(r.preemptions <= 1 for r in done)
    if name == "oversize":
        assert done[1].outcome.status == "truncated"
    if name == "deadline":
        assert done[2].outcome.status == "timed_out" and done[2].result == []
        assert m.timed_out == 1
    if name == "max_queue_wait":
        assert [r.outcome.status for r in done][2:] == ["timed_out"] * 2


@pytest.mark.parametrize("name", ["lru", "lru_int8", "lru_spec", "priority",
                                  "no_host", "host_full",
                                  "max_preemptions"])
def test_preempted_streams_equal_uncontended(model, name):
    """Inside the port, preempt/resume (host restore or recompute) leaves
    every greedy stream as the uncontended serve's, with the per-iteration
    audit clean (it raises otherwise)."""
    _, tparams = model
    base, mb = _serve("torch", tparams, name, contended=False)
    done, m = _serve("torch", tparams, name)
    assert mb.preemptions == 0 and m.preemptions >= 1
    assert [r.result for r in done] == [r.result for r in base]
    assert all(r.outcome.status == "completed" for r in done)


def test_trie_spill_and_promote_matches_reference(model):
    """Evicted prefix pages demote to the host tier; a later admission
    that matches the spilled span restores it into a fresh pool page
    instead of prefilling it: the same streams and counters as the
    reference's."""
    jparams, tparams = model
    prefix = [int(t) for t in np.random.default_rng(15).integers(
        4, 400, size=23)]
    first = _prompts(16, [(8, 6)], prefix)[0][0]
    second = first[:24] + [7, 8, 9]
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            eng = JEngine(j_get_reduced(ARCH), jparams, policy=J_FP32,
                          max_len=64, max_batch=2)
            Req, kv, kw = JRequest, JKV, {"chunked_prefill": True}
        else:
            eng = InferenceEngine(get_reduced(ARCH), tparams, policy=FP32,
                                  max_len=64, max_batch=2, device="cpu")
            Req, kv, kw = Request, KV, {}
        serve = dict(page_size=8, max_batched_tokens=16, host_kv_bytes=HOST,
                     **kw)
        d1, m1 = eng.serve_continuous([Req(uid=0, tokens=list(first),
                                           max_new_tokens=6)], **serve)
        ctx = eng._paged_ctx
        trie, host = ctx["trie"], ctx["host"]
        spilled = trie.spilled_pages
        # evict everything the trie holds, as pool pressure would
        trie.offload_fn = lambda pages: kv.offload_pages(ctx["cache"], pages)
        trie.evict(64)
        trie.offload_fn = None
        assert trie.spilled_pages > spilled and len(host) > 0
        d2, m2 = eng.serve_continuous([Req(uid=9, tokens=list(second),
                                           max_new_tokens=6)], **serve)
        out[pkg] = (d1[0].result, d2[0].result, trie.spilled_pages,
                    m2.restored_pages, m2.prefix_matched_tokens,
                    m2.host_bytes_peak, m1.offloaded_pages)
    assert out["torch"] == out["jax"]
    assert out["torch"][3] > 0 and out["torch"][4] > 0


# ---------------------------------------------------------------------------
# Scheduler-level invariants
# ---------------------------------------------------------------------------


def test_completed_past_deadline_counts_miss():
    alloc = PageAllocator(8)
    sched = ContinuousScheduler(1, alloc, page_size=4)
    req = Request(uid=0, tokens=[1, 2, 3], max_new_tokens=2, deadline=0.5)
    sched.submit(req, 0.0)
    slot, st = sched.try_admit(0.1)
    st.prefill_pos = st.ctx_len
    st.emitted.extend([5, 6])
    sched.retire(slot, now=1.0)            # finishes past the deadline
    assert req.outcome.status == "completed"
    assert req.outcome.deadline_missed
    assert req.result == [5, 6]
    alloc.check()


def _stub_sched(num_pages, slots, preemption, host):
    alloc = PageAllocator(num_pages)
    trie = RadixPrefixCache(alloc, page_size=8)
    sched = ContinuousScheduler(slots, alloc, page_size=8,
                                max_pages_per_slot=8, prefix_cache=trie,
                                match_prefix=True, preemption=preemption)
    sched.host_store = host
    # device-free stand-ins: a blob is one int8 row per page
    sched.offload_fn = lambda pages: [{"pk": torch.zeros(
        (len(pages), 8), dtype=torch.int8)}]
    sched.restore_fn = lambda blob, pages: None
    return sched, alloc


def _preempt_resume_trace(seed: int):
    """Random admit / decode / preempt / cancel / retire sequences (the
    reference's): the allocator and host tier audit clean after every
    operation, and every request ends terminal."""
    rng = np.random.default_rng(seed)
    host = HostKVStore(max_bytes=int(rng.integers(0, 4000))) \
        if rng.random() < 0.7 else None
    sched, alloc = _stub_sched(
        num_pages=int(rng.integers(12, 40)), slots=int(rng.integers(2, 5)),
        preemption=["lru", "priority"][int(rng.integers(0, 2))], host=host)
    n = int(rng.integers(4, 12))
    reqs = [Request(uid=u,
                    tokens=[1] + [int(t) for t in rng.integers(2, 9, size=int(
                        rng.integers(4, 40)))],
                    max_new_tokens=int(rng.integers(2, 8)),
                    priority=int(rng.integers(0, 3)))
            for u in range(n)]
    for r in reqs:
        sched.submit(r, 0.0)
    steps = 0
    while sched.has_work():
        steps += 1
        assert steps < 4000, "scheduler live/deadlocked"
        op = rng.random()
        sched.cancel_expired(float(steps))
        alloc.check()
        if op < 0.5:
            adm = sched.try_admit(float(steps))
            if adm is None and sched.waiting and sched.free_slots():
                head = sched.waiting[0]
                if sched.queued_pages_needed(head) \
                        <= sched.preemptible_headroom(head):
                    v = sched.pick_victim(head)
                    if v is not None:
                        st = sched.slots[v]
                        sched.preempt(
                            v, pending=st.emitted[-1],
                            ctx_len=(len(st.request.tokens)
                                     + len(st.emitted) - 1),
                            rem_tokens=2)
            elif adm is not None:
                _, st = adm
                st.prefill_pos = st.ctx_len          # instant prefill
                if not st.emitted:
                    st.emitted.append(7)
        elif op < 0.8 and sched.slots:
            s = int(rng.choice(list(sched.slots)))
            st = sched.slots[s]
            if st.prefill_done:
                st.emitted.append(7)
                if len(st.emitted) >= st.request.max_new_tokens:
                    sched.retire(s, float(steps))
        elif sched.waiting and rng.random() < 0.2:
            sched.waiting[0].max_queue_wait = -1.0   # doom the head
        alloc.check()
        if host is not None:
            host.check()
    for r in reqs:
        assert r.outcome is not None and r.outcome.status in \
            TERMINAL_STATUSES
    alloc.check()


def test_preempt_resume_invariants_seeded():
    for seed in range(40):
        _preempt_resume_trace(seed)


def test_preempt_never_disturbs_other_readers():
    """Preempting one sharer leaves the refcounts and mappings of the
    pages another slot still reads as they were, less its own."""
    alloc = PageAllocator(16)
    trie = RadixPrefixCache(alloc, page_size=4)
    sched = ContinuousScheduler(2, alloc, page_size=4,
                                max_pages_per_slot=8, prefix_cache=trie,
                                preemption="lru")
    sched.host_store = HostKVStore()
    offloaded = []
    sched.offload_fn = lambda pages: (offloaded.append(list(pages)), [{
        "pk": torch.zeros(2, dtype=torch.int8)}])[1]
    sched.restore_fn = lambda blob, pages: None
    shared_toks = [1, 2, 3, 4, 5, 6, 7, 8]
    ra = Request(uid=0, tokens=shared_toks + [9], max_new_tokens=4)
    rb = Request(uid=1, tokens=shared_toks + [11], max_new_tokens=4)
    sched.submit(ra)
    sched.submit(rb)
    sa, sta = sched.try_admit()
    sta.prefill_pos = sta.ctx_len
    sta.emitted.append(7)
    sched.insert_prefix(sta, 8)            # both full pages join the trie
    sb, stb = sched.try_admit()
    stb.prefill_pos = stb.ctx_len
    stb.emitted.append(7)
    assert stb.shared_count == 2           # B maps A's two prefix pages
    shared_pages = stb.pages[:2]
    before = [alloc.refcount(p) for p in shared_pages]
    assert all(c >= 3 for c in before)     # trie + A + B
    sched.preempt(sa, pending=7, ctx_len=9, rem_tokens=3)
    assert offloaded and set(shared_pages) <= set(offloaded[0])
    assert [alloc.refcount(p) for p in shared_pages] == \
        [c - 1 for c in before]
    alloc.check()
    sched.retire(sb)
    alloc.check()


def test_overload_metrics_zero_guards():
    m = ServeMetrics()
    assert m.preemptions == m.resumed == 0
    assert m.offloaded_pages == m.restored_pages == 0
    assert m.host_bytes_used == m.host_bytes_peak == 0
    assert m.timed_out == m.deadline_misses == 0
    assert m.outcome_counts == {}
    assert m.decode_idle_frac == 0.0 and m.acceptance_rate == 0.0
    assert m.prefix_hit_rate == 0.0 and m.itl_p99 == 0.0
