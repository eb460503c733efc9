"""Port parity: `obs/trace.py` vs the JAX reference's, on the CPU.

A seeded program of tracer operations (traces of every kind with nested
spans, attributes, errors and discards; traces begun on one thread and
resumed and committed on another; links to committed traces, floods of
links past `MAX_LINKS`; event registrations past the event map's
capacity) runs on a fresh `Tracer` of each package, with each module's
clock replaced by the same fake one. What `snapshot` (every kind, each
kind, slowest first), `related`, `trace_id_for_event` and
`traces_response` (`kind`, `n`, `sort=slowest`, `trace_id`, `event_ids`)
return must be equal, exactly, once trace ids are named by the order the
program made them and span ids, pids, times and durations are taken out.
With the real clocks, every duration is non-negative and nested inside
its parent's. Header adoption (`ingress_trace_kwargs`,
`inbound_trace_id`) agrees on valid, malformed and absent ids, and
`trace_context_headers` on the same active context.
"""

import threading

import numpy as np
import pytest

from predictionio_tpu.obs import trace as JT
from predictionio_tpu_torch.obs import trace as TT
from tests.torch_obs_parity import FakeTime, canon, check_durations

KINDS = ("query", "batch_predict", "fold_tick", "event_ingest")
SPANS = ("supplement", "predict", "readback", "post_process",
         "tail_read", "fold_solve", "storage_write")


def tree(rng, depth=0):
    """A random span tree: [(name, attrs, children)]."""
    n = int(rng.integers(0, 4 if depth == 0 else 2))
    return [(str(rng.choice(SPANS)),
             {"k": int(rng.integers(0, 9))} if rng.random() < 0.5 else {},
             tree(rng, depth + 1) if depth < 2 else [])
            for _ in range(n)]


def program(seed: int):
    rng = np.random.default_rng(seed)
    prog = []
    for _ in range(90):
        r = rng.random()
        if r < 0.55:
            prog.append(("trace", str(rng.choice(KINDS)), tree(rng),
                         {"batch": int(rng.integers(1, 33))}
                         if rng.random() < 0.3 else {},
                         bool(rng.random() < 0.1),       # raise
                         bool(rng.random() < 0.1),       # discard
                         bool(rng.random() < 0.2)))      # annotate
        elif r < 0.65:
            prog.append(("begin", int(rng.integers(1, 17))))
        elif r < 0.8:
            prog.append(("link", int(rng.integers(0, 1 << 30)),
                         int(rng.integers(0, 1 << 30))))
        elif r < 0.95:
            prog.append(("register", f"e{int(rng.integers(0, 40))}",
                         int(rng.integers(0, 1 << 30))))
        else:
            prog.append(("flood", int(rng.integers(60, 80))))
    return prog


def spans(tracer, nodes):
    for name, attrs, kids in nodes:
        with tracer.span(name, **attrs):
            spans(tracer, kids)


def run(mod, prog):
    """The program on a fresh tracer; returns (tracer, ids) where ids
    names each trace id by the order the program made it."""
    tracer = mod.Tracer(per_kind_capacity=8, event_map_capacity=16)
    made = []
    for step in prog:
        op = step[0]
        if op == "trace":
            _, kind, nodes, attrs, boom, discard, note = step
            try:
                with tracer.trace(kind, **attrs) as t:
                    made.append(t)
                    spans(tracer, nodes)
                    if note:
                        tracer.annotate(noted=True)
                    t.discard = discard
                    if boom:
                        with tracer.span("predict"):
                            raise ValueError("boom")
            except ValueError:
                pass
        elif op == "begin":
            t = tracer.begin_trace("batch_predict", batch=step[1],
                                   pipelined=True)
            made.append(t)
            with tracer.resume(t):
                with tracer.span("predict", batch=step[1]):
                    pass

            def complete():
                with tracer.resume(t, commit=True):
                    with tracer.span("readback"):
                        pass
            th = threading.Thread(target=complete)
            th.start()
            th.join()
        elif op == "link" and made:
            a = made[step[1] % len(made)]
            b = made[step[2] % len(made)]
            tracer.link_completed(a.trace_id, b.trace_id)
        elif op == "register" and made:
            tracer.register_event(step[1],
                                  made[step[2] % len(made)].trace_id)
        elif op == "flood":
            with tracer.trace("fold_tick") as t:
                made.append(t)
                for k in range(step[1]):
                    t.link(f"{k:016x}")
    ids = {t.trace_id: f"T{i}" for i, t in enumerate(made)}
    ids.update({f"{k:016x}": f"L{k}" for k in range(80)})
    return tracer, ids


def views(mod, tracer, ids):
    out = {"all": tracer.snapshot(limit=500),
           "slowest": tracer.snapshot(limit=500, slowest=True),
           "limit3": tracer.snapshot(limit=3)}
    for kind in KINDS:
        out[kind] = tracer.snapshot(limit=500, kind=kind)
    names = sorted(ids, key=lambda k: ids[k])
    for tid in names[:: max(1, len(names) // 12)]:
        out["related " + ids[tid]] = tracer.related(tid)
    out["events"] = {f"e{k}": tracer.trace_id_for_event(f"e{k}")
                     for k in range(40)}
    orig = mod.TRACER
    mod.TRACER = tracer
    try:
        out["resp kind"] = mod.traces_response({"kind": "query", "n": "4"})
        out["resp slowest"] = mod.traces_response({"sort": "slowest",
                                                    "limit": "5"})
        out["resp trace_id"] = mod.traces_response(
            {"trace_id": names[0]}) if names else None
        out["resp event_ids"] = mod.traces_response(
            {"event_ids": ",".join(f"e{k}" for k in range(40))})
    finally:
        mod.TRACER = orig
    durations = [t["durationMs"] for t in out["slowest"]]
    return canon(out, ids), durations


@pytest.mark.parametrize("seed", range(6))
def test_the_same_program_gives_the_same_views(seed, monkeypatch):
    got = {}
    for name, mod in (("jax", JT), ("port", TT)):
        monkeypatch.setattr(mod, "time", FakeTime())
        tracer, ids = run(mod, program(seed))
        got[name] = views(mod, tracer, ids)
    assert got["port"][0] == got["jax"][0]
    # the fake clocks ticked alike, so the durations agree too
    assert got["port"][1] == got["jax"][1]


@pytest.mark.parametrize("seed", range(2))
def test_durations_are_nested_on_the_real_clock(seed):
    tracer, _ = run(TT, program(seed))
    traces = tracer.snapshot(limit=500)
    assert traces
    for t in traces:
        check_durations(t["root"])


def test_max_links_and_the_ring_bound_match():
    assert TT.Trace.MAX_LINKS == JT.Trace.MAX_LINKS == 64
    assert TT.Tracer().per_kind_capacity == JT.Tracer().per_kind_capacity
    for mod in (JT, TT):
        tr = mod.Tracer(per_kind_capacity=8)
        for _ in range(20):
            with tr.trace("query"):
                pass
        with tr.trace("fold_tick") as t:
            for k in range(70):
                t.link(f"{k:016x}")
        snap = tr.snapshot(limit=100)
        assert len([s for s in snap if s["kind"] == "query"]) == 8
        tick = [s for s in snap if s["kind"] == "fold_tick"][0]
        assert len(tick["links"]) == 64 and tick["linksDropped"] == 6


HEADERS = [
    {},
    {"X-PIO-Trace-Id": "0123456789abcdef"},
    {"X-PIO-Trace-Id": "0123456789ABCDEF0123456789abcdef",
     "X-PIO-Parent-Span": "4242:17"},
    {"X-PIO-Trace-Id": "not-a-trace-id"},
    {"X-PIO-Trace-Id": "abc"},
    {"X-PIO-Trace-Id": "0" * 65},
    {"X-PIO-Trace-Id": " 89abcdef0123 ", "X-PIO-Parent-Span": "bad span!"},
    {"X-PIO-Trace-Id": "", "X-PIO-Parent-Span": "1:2"},
]


@pytest.mark.parametrize("headers", HEADERS)
def test_header_adoption_agrees(headers):
    assert TT.inbound_trace_id(headers) == JT.inbound_trace_id(headers)
    assert TT.ingress_trace_kwargs(headers) == \
        JT.ingress_trace_kwargs(headers)
    kw = TT.ingress_trace_kwargs(headers)
    with TT.TRACER.trace("query", **kw) as t:
        if "trace_id" in kw:
            assert t.trace_id == kw["trace_id"]
        else:
            assert t.trace_id != headers.get("X-PIO-Trace-Id")
            assert len(t.trace_id) == 16


def test_context_headers_agree():
    assert TT.trace_context_headers() == JT.trace_context_headers() == {}
    got = {}
    for name, mod in (("jax", JT), ("port", TT)):
        tracer = mod.TRACER
        with tracer.trace("query", trace_id="00000000000000aa"):
            with tracer.span("predict"):
                h = mod.trace_context_headers()
        got[name] = (h["X-PIO-Trace-Id"],
                     h["X-PIO-Parent-Span"].split(":")[0])
    assert got["port"] == got["jax"]


def test_a_span_outside_a_trace_is_a_no_op():
    with TT.TRACER.span("orphan") as s:
        assert s is None
    TT.TRACER.annotate(x=1)
    assert TT.TRACER.current_span() is None
