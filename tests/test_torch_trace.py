"""Serve-loop tracing in the port, against the reference's, on the CPU
(reduced qwen3-4b at fp32, 2 layers; the reference's parameters converted
by ``bridge``).

* Under a fake clock (a fixed step per read) two traced serves write
  byte-identical JSONL, and every event validates against the schema.
* The port's event sequence equals the reference's on the same serve in
  kind, uid, slot (and span name), timestamps and durations left out:
  a plain serve and a preempting one.  Fed the same events, the port's
  Perfetto converter gives the reference's document, and on their own
  serves the two documents have the same (phase, track, name) sequence.
* Tracing is observation only: traced greedy streams equal untraced ones
  on the packed, shared-prefix, int8, speculative, preempting,
  ``packed=False`` and bucketed (xlstm) serves.
* Device spans sum to ``metrics.device_s`` (the same clock reads feed
  both; held to 1e-9 relative, the rounding of two fp64 sums of the same
  terms), iteration host time stays within ``metrics.host_s``, and the
  lifecycle closes for every request.
* The validator rejects malformed events, the ring buffer drops and
  counts, and ``ServeMetrics.to_dict`` carries every derived key.
"""
import copy
import dataclasses
import io
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.core import trace as JTR
from repro.core.engine import InferenceEngine as JEngine
from repro.core.precision import FP32 as J_FP32
from repro.core.scheduler import Request as JRequest
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs.registry import get_reduced
from repro_torch.core import trace as TR
from repro_torch.core.continuous import ServeMetrics
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.precision import FP32
from repro_torch.core.scheduler import Request
from repro_torch.core.speculative import SpecConfig
from repro_torch.core.trace import (EVENT_SCHEMAS, ServeTracer,
                                    to_perfetto_dict, validate_event,
                                    validate_events)
from repro_torch.models import transformer as T

ARCH = "qwen3-4b"
PREEMPT = dict(num_pages=11, preemption="lru", host_kv_bytes=1 << 30,
               debug_audit=True)
SHAPES = {"plain": [(14, 4), (22, 4), (9, 3)],
          "preempt": [(30, 6), (28, 6), (26, 5), (22, 6), (9, 5)]}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These serves are many small ops: one intra-op thread keeps them
    fast when several test workers share the cores (with a thread per
    core in every worker they ran up to 100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    """Deterministic monotonic clock: advances a fixed step per read."""

    def __init__(self, step=0.001):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


@pytest.fixture(scope="module")
def model():
    jparams = JT.init_params(jax.random.PRNGKey(0), j_get_reduced(ARCH),
                             J_FP32)
    return jparams, bridge.params_from_jax(jax.tree.map(np.asarray, jparams))


def _prompts(shapes, seed=0, prefix=()):
    rng = np.random.default_rng(seed)
    return [([2] + list(prefix) + [int(t) for t in rng.integers(
        4, 400, size=ln)], mn) for ln, mn in shapes]


def _serve(params, prompts, *, policy=FP32, trace=None, **kw):
    eng = InferenceEngine(get_reduced(ARCH), params, policy=policy,
                          max_len=64, max_batch=3, device="cpu")
    done, m = eng.serve_continuous(
        [Request(uid=i, tokens=list(p), max_new_tokens=mn)
         for i, (p, mn) in enumerate(prompts)],
        page_size=8, max_batched_tokens=16, trace=trace, **kw)
    return [r.result for r in done], m


def _jax_serve(params, prompts, trace, **kw):
    eng = JEngine(j_get_reduced(ARCH), params, policy=J_FP32, max_len=64,
                  max_batch=3)
    eng.serve_continuous(
        [JRequest(uid=i, tokens=list(p), max_new_tokens=mn)
         for i, (p, mn) in enumerate(prompts)],
        page_size=8, max_batched_tokens=16, chunked_prefill=True,
        trace=trace, **kw)


def _sequence(events):
    return [(e["kind"], e.get("uid"), e.get("slot"), e.get("name"))
            for e in events]


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "preempt"])
def test_event_sequence_matches_reference(model, case):
    jparams, tparams = model
    prompts = _prompts(SHAPES[case], seed=1)
    kw = PREEMPT if case == "preempt" else {}
    jtr = JTR.ServeTracer(clock=FakeClock())
    _jax_serve(jparams, prompts, jtr, **kw)
    tr = ServeTracer(clock=FakeClock())
    _, m = _serve(tparams, prompts, trace=tr, **kw)
    assert _sequence(tr.events) == _sequence(jtr.events)
    assert validate_events(tr.events) == []
    kinds = {e["kind"] for e in tr.events}
    assert kinds <= set(EVENT_SCHEMAS)
    if case == "preempt":
        assert m.preemptions >= 1
        assert {"preempt", "offload", "restore",
                "admission_denied"} <= kinds
    # Perfetto: the port's converter is the reference's, and the two
    # serves give documents of the same structure
    evs = list(tr.events)
    assert to_perfetto_dict(evs, dropped=3) == JTR.to_perfetto_dict(
        copy.deepcopy(evs), dropped=3)

    def shape(doc):
        return [(e["ph"], e.get("tid"), e.get("name"))
                for e in doc["traceEvents"]]
    assert shape(to_perfetto_dict(evs)) == shape(
        JTR.to_perfetto_dict(list(jtr.events)))


def test_schema_matches_reference():
    assert EVENT_SCHEMAS == JTR.EVENT_SCHEMAS
    assert TR.TRACE_SCHEMA_VERSION == JTR.TRACE_SCHEMA_VERSION


# ---------------------------------------------------------------------------
# Determinism and schema
# ---------------------------------------------------------------------------


def test_fake_clock_jsonl_byte_identical(model):
    _, tparams = model
    prompts = _prompts(SHAPES["plain"])
    bufs = []
    for _ in range(2):
        tr = ServeTracer(clock=FakeClock())
        _serve(tparams, prompts, trace=tr)
        buf = io.StringIO()
        tr.to_jsonl(buf)
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1]
    lines = bufs[0].splitlines()
    assert json.loads(lines[0])["kind"] == "trace_header"
    kinds = {json.loads(line)["kind"] for line in lines[1:]}
    assert {"enqueue", "admit", "prefill_chunk", "first_token", "span",
            "iteration", "retire"} <= kinds
    assert validate_events(json.loads(line) for line in lines[1:]) == []
    # serve-relative timestamps; iteration indices count from 0
    tr = ServeTracer(clock=FakeClock())
    _serve(tparams, prompts[:1], trace=tr)
    assert min(e["t"] for e in tr.events) >= 0.0
    its = [e["iter"] for e in tr.iter_events("iteration")]
    assert its == list(range(len(its)))


def test_validate_event_rejects_bad_events():
    ok = {"kind": "first_token", "t": 0.5, "uid": 1, "ttft_s": 0.5}
    assert validate_event(ok) == []
    assert validate_event({"kind": "nope", "t": 0.0})      # unknown kind
    assert validate_event({"kind": "first_token", "t": 0.5, "uid": 1})
    assert validate_event({**ok, "ttft_s": "fast"})         # wrong type
    assert validate_event({**ok, "bogus": 1})               # extra field
    assert validate_event({**ok, "t": "now"})               # bad timestamp
    assert validate_event({"kind": "trace_header", "v": 999})
    assert validate_event({"kind": "host_evict", "t": 0.0, "bytes": True})
    base = {"kind": "admission_denied", "t": 0.0, "uid": 3,
            "reason": "no_free_slot"}
    assert validate_event(base) == []
    assert validate_event({**base, "pages_needed": None}) == []
    assert validate_event({**base, "pages_needed": 7}) == []


def test_validate_jsonl_and_cli(tmp_path, capsys):
    tr = ServeTracer(clock=FakeClock())
    tr.emit("enqueue", 0.0, uid=0, prompt_len=5, max_new=4)
    tr.emit("host_evict", 0.1, bytes=4096)
    p = str(tmp_path / "t.jsonl")
    tr.to_jsonl(p)
    assert TR.validate_jsonl(p) == (2, [])
    assert TR._main(["validate", p]) == 0
    assert "OK" in capsys.readouterr().out
    with open(p, "a") as f:
        f.write(json.dumps({"kind": "nope", "t": 0.0}) + "\n")
    assert TR._main(["validate", p]) == 1
    paths = TR.export(tr, str(tmp_path / "both.jsonl"), "both")
    assert [p.rsplit("/", 1)[1] for p in paths] == ["both.jsonl",
                                                    "both.perfetto.json"]
    assert json.load(open(paths[1]))["otherData"]["dropped_events"] == 0


# ---------------------------------------------------------------------------
# Zero perturbation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["plain", "prefix", "int8", "spec",
                                  "preempt", "packed_off"])
def test_traced_outputs_bit_identical(model, mode):
    _, tparams = model
    prefix = [int(t) for t in np.random.default_rng(9).integers(
        4, 400, size=16)] if mode == "prefix" else ()
    shapes = [(14, 5), (25, 5), (9, 4)] if prefix \
        else SHAPES["preempt"] if mode == "preempt" \
        else [(30, 5), (26, 5), (9, 4), (22, 5)]
    prompts = _prompts(shapes, seed=2, prefix=prefix)
    policy = dataclasses.replace(FP32, kv_dtype="int8") \
        if mode == "int8" else FP32
    kw = {"spec": {"spec": SpecConfig(k=3, drafter="ngram")},
          "preempt": PREEMPT,
          "packed_off": {"packed": False}}.get(mode, {})
    base, _ = _serve(tparams, prompts, policy=policy, **kw)
    tr = ServeTracer()
    traced, m = _serve(tparams, prompts, policy=policy, trace=tr, **kw)
    assert traced == base, f"tracing perturbed outputs ({mode})"
    assert validate_events(tr.events) == []
    if mode == "preempt":
        assert m.preemptions >= 1


def test_traced_bucketed_xlstm_serve():
    """The recurrent model's bucketed admission path is traced too: its
    admission dispatches and decode steps as device spans, one
    prefill_chunk per admitted prompt."""
    cfg = get_reduced("xlstm-125m")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, FP32)
    prompts = _prompts([(12, 4), (12, 4), (7, 3)], seed=3)

    def serve(trace):
        eng = InferenceEngine(cfg, params, policy=FP32, max_len=64,
                              max_batch=2, device="cpu")
        done, m = eng.serve_continuous(
            [Request(uid=i, tokens=list(p), max_new_tokens=mn)
             for i, (p, mn) in enumerate(prompts)], page_size=8,
            trace=trace)
        return [r.result for r in done], m
    base, _ = serve(None)
    tr = ServeTracer()
    out, m = serve(tr)
    assert out == base and validate_events(tr.events) == []
    names = {e["name"] for e in tr.iter_events("span")}
    assert names == {"admit_prefill", "decode"}
    assert len(list(tr.iter_events("prefill_chunk"))) == len(prompts)
    assert sum(e["dur"] for e in tr.iter_events("span")) == pytest.approx(
        m.device_s, rel=1e-9, abs=1e-12)


# ---------------------------------------------------------------------------
# Reconciliation with ServeMetrics
# ---------------------------------------------------------------------------


def test_trace_reconciles_with_metrics(model):
    _, tparams = model
    prompts = _prompts([(18, 5), (24, 5), (11, 4)], seed=4)
    tr = ServeTracer()
    _, m = _serve(tparams, prompts, trace=tr)
    span_dev = sum(e["dur"] for e in tr.iter_events("span")
                   if e["track"] == "device")
    it_dev = sum(e["device_s"] for e in tr.iter_events("iteration"))
    it_host = sum(e["host_s"] for e in tr.iter_events("iteration"))
    assert span_dev == pytest.approx(m.device_s, rel=1e-9, abs=1e-12)
    assert it_dev == pytest.approx(m.device_s, rel=1e-9, abs=1e-12)
    assert 0.0 <= it_host <= m.host_s + 1e-6
    for kind in ("enqueue", "admit", "retire"):
        assert {e["uid"] for e in tr.iter_events(kind)} == {0, 1, 2}
    for e in tr.iter_events("iteration"):
        assert e["budget"] == 16 and 0 <= e["budget_used"] <= 16
    ttfts = sorted(e["ttft_s"] for e in tr.iter_events("first_token"))
    np.testing.assert_allclose(ttfts, sorted(m.ttft_s), rtol=1e-9)


def test_perfetto_structure_and_dangling_slices(model):
    _, tparams = model
    tr = ServeTracer(clock=FakeClock())
    _serve(tparams, _prompts([(14, 4), (22, 4)], seed=5), trace=tr)
    doc = to_perfetto_dict(list(tr.events), dropped=tr.dropped)
    te = doc["traceEvents"]
    assert doc["otherData"]["schema_version"] == TR.TRACE_SCHEMA_VERSION
    names = {e.get("args", {}).get("name") for e in te if e["ph"] == "M"}
    assert {"repro-serve", "scheduler", "device"} <= names
    depth = {}
    for e in te:
        if e["ph"] in "BE":
            depth[e["tid"]] = depth.get(e["tid"], 0) + (
                1 if e["ph"] == "B" else -1)
            assert depth[e["tid"]] >= 0
    assert all(v == 0 for v in depth.values())
    counters = {e["name"] for e in te if e["ph"] == "C"}
    assert {"pages_in_use", "host_bytes", "trie_nodes"} <= counters
    # an admit with no matching end is closed at trace end
    evs = [{"kind": "admit", "t": 0.1, "uid": 7, "slot": 0,
            "matched_tokens": 0, "pages": 2, "resume": "no"}]
    phases = [e["ph"] for e in to_perfetto_dict(evs)["traceEvents"]]
    assert phases.count("B") == phases.count("E") == 1


def test_ring_buffer_drops_and_counts():
    tr = ServeTracer(clock=FakeClock(), ring_size=5)
    for i in range(8):
        tr.emit("host_evict", float(i), bytes=i)
    assert len(tr.events) == 5
    assert tr.dropped == 3
    assert [e["t"] for e in tr.events] == [3.0, 4.0, 5.0, 6.0, 7.0]
    assert tr.header()["dropped"] == 3


def test_metrics_to_dict_derived_keys():
    m = ServeMetrics(host_s=1.0, device_s=3.0, mixed_iters=4,
                     mixed_dispatches=4, packed_tokens_real=90,
                     packed_tokens_padded=100, latency_s=[1.0, 2.0],
                     ttft_s=[0.1, 0.2], itl_s=[0.01, 0.02])
    d = m.to_dict()
    for k in ("latency_p50", "latency_p99", "ttft_p50", "ttft_p99",
              "itl_p50", "itl_p99", "host_frac", "dispatches_per_iter",
              "padded_token_frac", "decode_idle_frac", "acceptance_rate",
              "tokens_per_forward", "prefix_hit_rate", "preemptions",
              "host_bytes_peak"):
        assert k in d, k
    assert d["host_frac"] == pytest.approx(0.25)
    assert "latency_s" not in d
    assert "latency_s" in m.to_dict(include_raw=True)
    json.dumps(d)
