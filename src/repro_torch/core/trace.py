"""Structured serve-loop tracing: event timeline, lifecycle spans, exporters
(the port's copy of ``repro.core.trace``; the event schema, the JSONL
layout and the Perfetto layout are the reference's, so traces of both
packages read alike).

``ServeTracer`` is a low-overhead, ring-buffered event recorder threaded through
``serve_continuous`` / ``ContinuousScheduler`` / ``RadixPrefixCache`` /
``HostKVStore`` behind a ``trace=None`` argument.  Every emit site is guarded
(``if trace is not None``) so the untraced path costs nothing; the traced path
appends one plain dict per event to a bounded deque.

Three record families share one flat schema (see ``EVENT_SCHEMAS``):

* **iteration** — one record per serve-loop iteration: token budget used vs.
  ``max_batched_tokens``, decode lanes vs. chunk segments, the chosen packed
  width bucket and padded lanes, the host/device wall split for the iteration,
  and gauges (pages in use, host-tier bytes, radix-trie nodes) sampled each step.
* **request lifecycle** — ``enqueue → admit → prefill_chunk* → first_token →
  (preempt/offload/restore)* → retire``, the retire stamped with the request's
  structured ``RequestOutcome``.
* **scheduler decisions** — ``admission_denied`` (with reason), ``preempt``
  (victim choice), ``prefix_hit`` / ``prefix_evict`` (incl. host spills),
  ``host_evict`` / ``host_refused`` (host-tier pressure), ``cancel`` (deadline
  or queue-wait rejection).

Time: all ``t`` values are seconds relative to the tracer origin (set by the
engine at serve start).  The clock is injectable (``clock=`` callable) so tests
can drive a fake monotonic clock and obtain byte-identical JSONL across runs.

Exporters:

* ``to_jsonl`` — one event per line; the first line is a ``trace_header``
  carrying the schema version and drop counter.
* ``to_perfetto`` — Chrome trace-event JSON (``{"traceEvents": [...]}``),
  loadable at https://ui.perfetto.dev: one track for the scheduler (iteration
  slices + decision instants), one for device dispatches (named spans), one for
  the host KV tier, and one per slot (request-occupancy slices admit→retire).

Validation: ``validate_event`` / ``validate_events`` / ``validate_jsonl`` check
every event against ``EVENT_SCHEMAS``; ``python -m repro_torch.core.trace
validate PATH`` runs the same check from the command line.
"""

from __future__ import annotations

import json
import time
from collections import deque

TRACE_SCHEMA_VERSION = 1

# Sentinel for schema fields that may be absent (or null) on an event.
_OPTIONAL = True
_REQUIRED = False

_NUM = ("num",)      # int or float, bools rejected
_INT = ("int",)      # int only, bools rejected
_STR = ("str",)
_BOOL = ("bool",)

# kind -> field -> (type tag, optional?).  Common fields "kind" and "t" are
# checked for every event; "t" is seconds since trace origin.
EVENT_SCHEMAS = {
    # --- iteration records -------------------------------------------------
    "iteration": {
        "iter": (_INT, _REQUIRED),          # serve-loop iteration index
        "dur": (_NUM, _REQUIRED),           # iteration wall seconds
        "host_s": (_NUM, _REQUIRED),        # dur minus device dispatch time
        "device_s": (_NUM, _REQUIRED),      # sum of device spans this iteration
        "budget": (_INT, _REQUIRED),        # max_batched_tokens (0 = unbudgeted)
        "budget_used": (_INT, _REQUIRED),   # tokens dispatched this iteration
        "decode_lanes": (_INT, _REQUIRED),
        "chunk_segments": (_INT, _REQUIRED),
        "chunk_tokens": (_INT, _REQUIRED),  # real (unpadded) prefill tokens
        "width_bucket": (_INT, _REQUIRED),  # chosen packed/chunk width (0 = n/a)
        "padded_lanes": (_INT, _REQUIRED),  # padding tokens inside the bucket
        "idle": (_BOOL, _REQUIRED),         # no work dispatched this iteration
        "pages_in_use": (_INT, _REQUIRED),  # KV page-pool gauge
        "host_bytes": (_INT, _REQUIRED),    # host KV tier gauge
        "trie_nodes": (_INT, _REQUIRED),    # radix prefix-trie gauge
    },
    "span": {
        "name": (_STR, _REQUIRED),          # e.g. decode, packed, chunk, verify
        "dur": (_NUM, _REQUIRED),
        "track": (_STR, _REQUIRED),         # "device"
    },
    # --- request lifecycle -------------------------------------------------
    "enqueue": {
        "uid": (_INT, _REQUIRED),
        "prompt_len": (_INT, _REQUIRED),
        "max_new": (_INT, _REQUIRED),
        "deadline": (_NUM, _OPTIONAL),      # absolute serve-relative seconds
    },
    "admit": {
        "uid": (_INT, _REQUIRED),
        "slot": (_INT, _REQUIRED),
        "matched_tokens": (_INT, _REQUIRED),  # prefix-cache reuse at admit
        "pages": (_INT, _REQUIRED),
        "resume": (_STR, _REQUIRED),        # "no" | "hostkv" | "recompute"
    },
    "prefill_chunk": {
        "uid": (_INT, _REQUIRED),
        "slot": (_INT, _REQUIRED),
        "start": (_INT, _REQUIRED),         # chunk start position in the prompt
        "len": (_INT, _REQUIRED),
    },
    "first_token": {
        "uid": (_INT, _REQUIRED),
        "ttft_s": (_NUM, _REQUIRED),
    },
    "retire": {
        "uid": (_INT, _REQUIRED),
        "slot": (_INT, _REQUIRED),
        "status": (_STR, _REQUIRED),        # RequestOutcome.status
        "preemptions": (_INT, _REQUIRED),
        "deadline_missed": (_BOOL, _REQUIRED),
        "latency_s": (_NUM, _REQUIRED),
        "generated": (_INT, _REQUIRED),
    },
    "preempt": {
        "uid": (_INT, _REQUIRED),
        "slot": (_INT, _REQUIRED),
        "policy": (_STR, _REQUIRED),        # victim-choice policy (lru, ...)
        "n_pages": (_INT, _REQUIRED),
        "offloaded": (_BOOL, _REQUIRED),    # pages went to the host tier
    },
    "offload": {
        "uid": (_INT, _REQUIRED),
        "slot": (_INT, _REQUIRED),
        "n_pages": (_INT, _REQUIRED),
    },
    "restore": {
        "uid": (_INT, _REQUIRED),
        "slot": (_INT, _REQUIRED),
        "mode": (_STR, _REQUIRED),          # "hostkv" | "recompute"
        "n_pages": (_INT, _REQUIRED),
    },
    # --- scheduler decisions ----------------------------------------------
    "admission_denied": {
        "uid": (_INT, _REQUIRED),
        "reason": (_STR, _REQUIRED),        # no_free_slot | pool_exhausted | ...
        "pages_needed": (_INT, _OPTIONAL),
    },
    "cancel": {
        "uid": (_INT, _REQUIRED),
        "status": (_STR, _REQUIRED),        # timed_out | rejected
        "detail": (_STR, _REQUIRED),
    },
    "prefix_hit": {
        "uid": (_INT, _REQUIRED),
        "matched_tokens": (_INT, _REQUIRED),
        "pages_shared": (_INT, _REQUIRED),
    },
    "prefix_evict": {
        "requested": (_INT, _REQUIRED),     # pages the allocator asked for
        "freed": (_INT, _REQUIRED),
        "spilled": (_INT, _REQUIRED),       # pages copied to the host tier
    },
    "host_evict": {
        "bytes": (_INT, _REQUIRED),         # victim blob size
    },
    "host_refused": {
        "bytes": (_INT, _REQUIRED),         # rejected put size
    },
    # --- weight compression (emitted once, at serve start) -----------------
    "weights": {
        "dtype": (_STR, _REQUIRED),         # policy weights_dtype
        "weight_bytes": (_INT, _REQUIRED),  # serve-path matmul weight bytes
        "weight_bytes_dense": (_INT, _REQUIRED),   # same set, uncompressed
        "quantized_tensors": (_INT, _REQUIRED),
    },
}


def _type_ok(tag, v):
    if tag == "num":
        return isinstance(v, (int, float)) and not isinstance(v, bool)
    if tag == "int":
        return isinstance(v, int) and not isinstance(v, bool)
    if tag == "str":
        return isinstance(v, str)
    if tag == "bool":
        return isinstance(v, bool)
    raise ValueError(f"unknown type tag {tag!r}")


def validate_event(ev):
    """Return a list of error strings for one event dict (empty = valid)."""
    errs = []
    if not isinstance(ev, dict):
        return [f"event is not a dict: {type(ev).__name__}"]
    kind = ev.get("kind")
    if kind == "trace_header":
        if ev.get("v") != TRACE_SCHEMA_VERSION:
            errs.append(f"trace_header: bad schema version {ev.get('v')!r}")
        return errs
    schema = EVENT_SCHEMAS.get(kind)
    if schema is None:
        return [f"unknown event kind {kind!r}"]
    t = ev.get("t")
    if not (isinstance(t, (int, float)) and not isinstance(t, bool)):
        errs.append(f"{kind}: field 't' must be numeric, got {t!r}")
    for field, (tag, optional) in schema.items():
        if field not in ev or ev[field] is None:
            if not optional:
                errs.append(f"{kind}: missing required field {field!r}")
            continue
        if not _type_ok(tag[0], ev[field]):
            errs.append(
                f"{kind}: field {field!r} expected {tag[0]}, "
                f"got {ev[field]!r}"
            )
    extra = set(ev) - set(schema) - {"kind", "t"}
    if extra:
        errs.append(f"{kind}: unknown fields {sorted(extra)}")
    return errs


def validate_events(events):
    """Validate an iterable of event dicts; return all error strings."""
    errs = []
    for i, ev in enumerate(events):
        for e in validate_event(ev):
            errs.append(f"event {i}: {e}")
    return errs


def validate_jsonl(path):
    """Validate a JSONL trace file. Returns (num_events, errors)."""
    errs = []
    n = 0
    with open(path) as f:
        first = f.readline()
        if not first:
            return 0, ["empty trace file"]
        try:
            header = json.loads(first)
        except json.JSONDecodeError as e:
            return 0, [f"line 1: invalid JSON: {e}"]
        if header.get("kind") != "trace_header":
            errs.append("line 1: first line must be a trace_header")
        else:
            errs.extend(validate_event(header))
        for lineno, line in enumerate(f, start=2):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                errs.append(f"line {lineno}: invalid JSON: {e}")
                continue
            n += 1
            for e in validate_event(ev):
                errs.append(f"line {lineno}: {e}")
    return n, errs


def _json_default(o):
    # numpy scalars sneak into emit sites despite int()/float() discipline;
    # coerce them so exports never crash on a forgotten cast.
    try:
        import numpy as np

        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.bool_):
            return bool(o)
    except ImportError:
        pass
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


class ServeTracer:
    """Ring-buffered structured event recorder for the serve loop.

    Parameters
    ----------
    clock:
        Monotonic ``() -> float`` used for every timestamp the engine takes
        while this tracer is attached.  Defaults to ``time.perf_counter``.
        Injecting a deterministic fake makes traces byte-reproducible.
    ring_size:
        Maximum buffered events; older events are dropped (and counted in
        ``dropped``) once the ring is full.
    """

    def __init__(self, clock=None, ring_size=1_000_000):
        self.clock = clock if clock is not None else time.perf_counter
        self.ring_size = int(ring_size)
        self.events = deque(maxlen=self.ring_size)
        self.dropped = 0
        self._origin = 0.0

    def set_origin(self, t):
        """Anchor t=0 at absolute clock value ``t`` (serve start)."""
        self._origin = float(t)

    def now(self):
        """Seconds since the trace origin, from the injected clock."""
        return self.clock() - self._origin

    def emit(self, kind, t, **fields):
        """Record one event at serve-relative time ``t``."""
        if len(self.events) == self.ring_size:
            self.dropped += 1
        ev = {"kind": kind, "t": float(t)}
        ev.update(fields)
        self.events.append(ev)

    def emit_now(self, kind, **fields):
        self.emit(kind, self.now(), **fields)

    def iter_events(self, kind=None):
        if kind is None:
            return iter(self.events)
        return (e for e in self.events if e["kind"] == kind)

    def reset(self):
        self.events.clear()
        self.dropped = 0
        self._origin = 0.0

    # --- exporters ---------------------------------------------------------

    def header(self):
        return {
            "kind": "trace_header",
            "v": TRACE_SCHEMA_VERSION,
            "events": len(self.events),
            "dropped": self.dropped,
        }

    def to_jsonl(self, out):
        """Write the trace as JSONL to a path or file-like object.

        The first line is a ``trace_header``; every following line is one
        event.  Keys are sorted and separators fixed so that identical event
        streams produce byte-identical files.
        """
        close = False
        if isinstance(out, str):
            f = open(out, "w")
            close = True
        else:
            f = out
        try:
            dump = lambda o: json.dumps(
                o, sort_keys=True, separators=(",", ":"), default=_json_default
            )
            f.write(dump(self.header()) + "\n")
            for ev in self.events:
                f.write(dump(ev) + "\n")
        finally:
            if close:
                f.close()

    def to_perfetto(self, out):
        """Write a Chrome trace-event JSON file loadable in Perfetto."""
        doc = to_perfetto_dict(list(self.events), dropped=self.dropped)
        close = False
        if isinstance(out, str):
            f = open(out, "w")
            close = True
        else:
            f = out
        try:
            json.dump(doc, f, default=_json_default)
        finally:
            if close:
                f.close()


# Perfetto track layout (all under one pid).
_PID = 1
_TID_SCHED = 1
_TID_DEVICE = 2
_TID_HOST = 3
_TID_SLOT0 = 10  # slot s renders on tid 10 + s


def _us(t):
    return round(float(t) * 1e6, 3)


def to_perfetto_dict(events, dropped=0):
    """Convert a list of event dicts into Chrome trace-event JSON.

    Tracks: scheduler (iteration slices + decision instants), device (named
    dispatch spans), host KV tier, and one per slot holding a ``req <uid>``
    slice from admit to retire (or preempt).  Gauges become counter tracks.
    """
    te = []

    def meta(tid, name):
        te.append(
            {
                "ph": "M",
                "pid": _PID,
                "tid": tid,
                "name": "thread_name",
                "args": {"name": name},
            }
        )

    te.append(
        {
            "ph": "M",
            "pid": _PID,
            "name": "process_name",
            "args": {"name": "repro-serve"},
        }
    )
    meta(_TID_SCHED, "scheduler")
    meta(_TID_DEVICE, "device")
    meta(_TID_HOST, "host-kv")

    def slice_(tid, name, t, dur, args=None):
        ev = {
            "ph": "X",
            "pid": _PID,
            "tid": tid,
            "name": name,
            "ts": _us(t),
            "dur": max(_us(dur), 0.001),
            "cat": "serve",
        }
        if args:
            ev["args"] = args
        te.append(ev)

    def instant(tid, name, t, args=None):
        ev = {
            "ph": "i",
            "s": "t",
            "pid": _PID,
            "tid": tid,
            "name": name,
            "ts": _us(t),
            "cat": "serve",
        }
        if args:
            ev["args"] = args
        te.append(ev)

    def counter(name, t, value):
        te.append(
            {
                "ph": "C",
                "pid": _PID,
                "name": name,
                "ts": _us(t),
                "args": {"value": value},
            }
        )

    seen_slots = set()
    open_slot = {}  # slot -> (uid, since there is at most one open req/slot)
    t_end = 0.0

    for ev in events:
        k = ev["kind"]
        t = ev["t"]
        t_end = max(t_end, t + float(ev.get("dur", 0.0)))
        if k == "iteration":
            args = {
                f: ev[f]
                for f in (
                    "iter",
                    "budget",
                    "budget_used",
                    "decode_lanes",
                    "chunk_segments",
                    "chunk_tokens",
                    "width_bucket",
                    "padded_lanes",
                    "idle",
                    "host_s",
                    "device_s",
                )
                if f in ev
            }
            name = "idle" if ev.get("idle") else "iteration"
            slice_(_TID_SCHED, name, t, ev["dur"], args)
            counter("pages_in_use", t, ev.get("pages_in_use", 0))
            counter("host_bytes", t, ev.get("host_bytes", 0))
            counter("trie_nodes", t, ev.get("trie_nodes", 0))
        elif k == "span":
            slice_(_TID_DEVICE, ev["name"], t, ev["dur"])
        elif k == "admit":
            slot = ev["slot"]
            tid = _TID_SLOT0 + slot
            if slot not in seen_slots:
                seen_slots.add(slot)
                meta(tid, f"slot {slot}")
            # A lost retire/preempt would leave the previous slice open and
            # corrupt nesting; close it defensively at this admit.
            if slot in open_slot:
                te.append({"ph": "E", "pid": _PID, "tid": tid, "ts": _us(t)})
            te.append(
                {
                    "ph": "B",
                    "pid": _PID,
                    "tid": tid,
                    "name": f"req {ev['uid']}",
                    "ts": _us(t),
                    "cat": "serve",
                    "args": {
                        "uid": ev["uid"],
                        "matched_tokens": ev.get("matched_tokens", 0),
                        "resume": ev.get("resume", "no"),
                    },
                }
            )
            open_slot[slot] = ev["uid"]
        elif k in ("retire", "preempt"):
            slot = ev["slot"]
            tid = _TID_SLOT0 + slot
            if slot in open_slot:
                args = {f: ev[f] for f in ev if f not in ("kind", "t")}
                te.append(
                    {
                        "ph": "E",
                        "pid": _PID,
                        "tid": tid,
                        "ts": _us(t),
                        "args": args,
                    }
                )
                del open_slot[slot]
            if k == "preempt":
                instant(
                    _TID_SCHED,
                    f"preempt uid={ev['uid']}",
                    t,
                    {f: ev[f] for f in ("policy", "n_pages", "offloaded")},
                )
        elif k in ("prefill_chunk", "first_token"):
            slot = ev.get("slot")
            tid = _TID_SLOT0 + slot if slot is not None else _TID_SCHED
            if slot is not None and slot not in seen_slots:
                seen_slots.add(slot)
                meta(tid, f"slot {slot}")
            args = {f: ev[f] for f in ev if f not in ("kind", "t")}
            instant(tid, k, t, args)
        elif k == "weights":
            counter("weight_bytes", t, ev.get("weight_bytes", 0))
            args = {f: ev[f] for f in ev if f not in ("kind", "t")}
            instant(_TID_SCHED, k, t, args)
        elif k in ("offload", "restore", "host_evict", "host_refused"):
            args = {f: ev[f] for f in ev if f not in ("kind", "t")}
            instant(_TID_HOST, k, t, args)
        else:  # enqueue / admission_denied / cancel / prefix_* / unknown
            args = {f: ev[f] for f in ev if f not in ("kind", "t")}
            instant(_TID_SCHED, k, t, args)

    # Close any request slices still open at trace end (e.g. in-flight at stop).
    for slot in sorted(open_slot):
        te.append(
            {
                "ph": "E",
                "pid": _PID,
                "tid": _TID_SLOT0 + slot,
                "ts": _us(t_end),
            }
        )

    return {
        "traceEvents": te,
        "displayTimeUnit": "ms",
        "otherData": {
            "schema_version": TRACE_SCHEMA_VERSION,
            "dropped_events": dropped,
        },
    }


def export(tracer, out_path, fmt="jsonl"):
    """Export ``tracer`` to ``out_path`` in ``fmt`` (jsonl|perfetto|both).

    For ``both``, ``out_path`` names the JSONL file and the Perfetto file is
    written next to it with a ``.perfetto.json`` suffix.  Returns the list of
    written paths.
    """
    if fmt == "jsonl":
        tracer.to_jsonl(out_path)
        return [out_path]
    if fmt == "perfetto":
        tracer.to_perfetto(out_path)
        return [out_path]
    if fmt == "both":
        base = out_path[: -len(".jsonl")] if out_path.endswith(".jsonl") else out_path
        jp, pp = base + ".jsonl", base + ".perfetto.json"
        tracer.to_jsonl(jp)
        tracer.to_perfetto(pp)
        return [jp, pp]
    raise ValueError(f"unknown trace format {fmt!r}")


def _main(argv=None):
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.trace",
        description="Validate or summarize a serve-loop JSONL trace.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("validate", help="schema-validate a JSONL trace")
    v.add_argument("path")
    v.add_argument("--max-errors", type=int, default=20)
    s = sub.add_parser("summary", help="per-kind event counts and span totals")
    s.add_argument("path")
    args = ap.parse_args(argv)

    if args.cmd == "validate":
        n, errs = validate_jsonl(args.path)
        for e in errs[: args.max_errors]:
            print(f"ERROR: {e}", file=sys.stderr)
        if errs:
            print(f"INVALID: {args.path}: {n} events, {len(errs)} errors")
            return 1
        print(f"OK: {args.path}: {n} events, schema v{TRACE_SCHEMA_VERSION}")
        return 0

    counts = {}
    span_s = {}
    host_s = device_s = 0.0
    with open(args.path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            k = ev.get("kind")
            counts[k] = counts.get(k, 0) + 1
            if k == "span":
                span_s[ev["name"]] = span_s.get(ev["name"], 0.0) + ev["dur"]
            elif k == "iteration":
                host_s += ev["host_s"]
                device_s += ev["device_s"]
    for k in sorted(counts):
        print(f"{k:18s} {counts[k]}")
    for name in sorted(span_s):
        print(f"span[{name}] total {span_s[name]:.4f}s")
    print(f"iteration host_s={host_s:.4f}s device_s={device_s:.4f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
