"""Request and fold trace spans with context propagation.

The port's copy of `predictionio_tpu/obs/trace.py` (`Span`, `Trace`,
`Tracer`, `TRACER`, `inbound_trace_id`, `ingress_trace_kwargs`,
`trace_context_headers`, `traces_response`).

A `trace_id` is minted at ingress (an event server POST, an engine
server query, a scheduler fold tick, a training run) and carried
through nested `span()` scopes by a contextvar, so the storage write,
the tail read, the fold's solves, the registry publish, the hot swap and
the batched predict all land in one span tree with per-stage walls.

Cross-trace causality uses links: one fold tick absorbs many ingested
events, so the tick's trace links the events' ingest traces (and each
of them links back) instead of posing as their parent. The event server
registers `event_id -> trace_id` at write time; the scheduler's tail
read resolves the fresh events it consumed back to their ingest traces.

Completed traces live in per-kind rings (query traces at serving rates
must not evict the day's fold ticks) served at `GET /traces.json` on
both HTTP servers: the last N, filtered by kind, sorted by slowest, or
one trace id with its linked neighbourhood.

Propagation across processes: an ingress that finds `X-PIO-Trace-Id`
adopts that id (validated; a malformed one mints a fresh id), and the
port's own client hops (the engine server's feedback POST, the
scheduler's `/reload`) send the active context.

A span's wall is host time. Around asynchronous CUDA work it times what
the host waited for: the fold's `fold_solve` span ends after the fold
copies its tables back to the host (a copy that waits for the fold's
stream), a serve window's `predict` span times the dispatch (a graph
replay's launch) and its `readback` span the wait on the packed copy.

`span()` outside any trace is a no-op context manager.
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import os
import re
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

_span_seq = itertools.count(1)

# -- propagation across processes ----------------------------------------
# An ingress that finds X-PIO-Trace-Id adopts that id instead of minting
# a fresh one, and the port's client hops (the scheduler's reload POST,
# the engine server's feedback loop) send the active trace context, so
# one trace id survives event POST -> fold tick -> hot swap -> served
# query across processes.
TRACE_HEADER = "X-PIO-Trace-Id"
PARENT_SPAN_HEADER = "X-PIO-Parent-Span"

#: inbound ids are VALIDATED, not trusted: a trace id is hex (ours are
#: 16 hex chars; foreign tracers up to 128-bit/32 chars ride too), and
#: a garbage header must mint a fresh id rather than poison the rings
_TID_RE = re.compile(r"^[0-9a-fA-F]{8,64}$")
_PARENT_RE = re.compile(r"^[0-9A-Za-z_.:-]{1,128}$")


def inbound_trace_id(headers) -> Optional[str]:
    """The validated inbound trace id, or None (absent/garbage)."""
    try:
        raw = headers.get(TRACE_HEADER)
    except Exception:
        return None
    if not raw:
        return None
    raw = str(raw).strip()
    return raw if _TID_RE.match(raw) else None


def ingress_trace_kwargs(headers) -> dict:
    """Kwargs for a server-side ``TRACER.trace(kind, **kw)``: adopts
    the caller's trace id when the propagation headers are present and
    valid, recording the remote parent span (``<pid>:<span_id>``) as a
    root attr so a stitched waterfall can anchor this process's tree
    under the hop that caused it. Empty dict = mint as before."""
    tid = inbound_trace_id(headers)
    if not tid:
        return {}
    kw: dict = {"trace_id": tid}
    try:
        parent = headers.get(PARENT_SPAN_HEADER)
    except Exception:
        parent = None
    if parent:
        parent = str(parent).strip()
        if _PARENT_RE.match(parent):
            kw["remoteParent"] = parent
    return kw


def trace_context_headers() -> Dict[str, str]:
    """The outbound propagation headers for the ACTIVE trace context
    ({} when none): the trace id plus this process's current span as
    ``<pid>:<span_id>`` — the value a downstream ingress records as
    its remote parent. One contextvar read on the no-trace path."""
    ctx = TRACER._ctx.get()
    if ctx is None:
        return {}
    trace, span = ctx
    return {TRACE_HEADER: trace.trace_id,
            PARENT_SPAN_HEADER: f"{os.getpid()}:{span.span_id}"}


class Span:
    __slots__ = ("name", "span_id", "parent_id", "t_wall", "_t0",
                 "duration_s", "attrs", "error")

    def __init__(self, name: str, parent_id: Optional[int]):
        self.name = name
        self.span_id = next(_span_seq)
        self.parent_id = parent_id
        self.t_wall = time.time()
        self._t0 = time.perf_counter()
        self.duration_s: Optional[float] = None
        self.attrs: Dict[str, object] = {}
        self.error: Optional[str] = None

    def end(self):
        if self.duration_s is None:
            self.duration_s = time.perf_counter() - self._t0

    def to_dict(self) -> dict:
        d = {"name": self.name, "spanId": self.span_id,
             "start": self.t_wall,
             "durationMs": (round(self.duration_s * 1000.0, 3)
                            if self.duration_s is not None else None)}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.error:
            d["error"] = self.error
        return d


_tid_pool = threading.local()


def _stamp_tenant(root: "Span"):
    """Tenant attribution: a trace minted inside an active
    tenant scope carries the tenant id as a root attr — the key that
    lets waterfalls, incident slices and the dashboard tell one
    tenant's requests from another's. An explicit ``tenant=`` attr
    passed by the caller wins; one contextvar read otherwise."""
    if "tenant" in root.attrs:
        return
    from predictionio_tpu_torch.obs.tenantctx import current_tenant
    t = current_tenant()
    if t is not None:
        root.attrs["tenant"] = t


def _new_trace_id() -> str:
    """16-hex trace id, entropy drawn 128 ids at a time into a
    thread-local pool — one request-path os.urandom syscall (with its
    GIL release/reacquire round trip) per 128 traces instead of per
    trace, mirroring event.new_event_id."""
    off = getattr(_tid_pool, "off", None)
    if not off:   # None or exhausted (0)
        _tid_pool.hexes = os.urandom(8 * 128).hex()
        off = 128
    _tid_pool.off = off - 1
    i = (off - 1) << 4
    return _tid_pool.hexes[i:i + 16]


class Trace:
    """One span tree. The root span shares the trace's kind as its
    name; ``links`` are trace_ids of causally-related traces (event
    ingest <-> fold tick), capped so a fold absorbing thousands of
    events can't bloat its /traces.json entry (``linksDropped``
    records the overflow)."""

    MAX_LINKS = 64

    def __init__(self, kind: str, trace_id: Optional[str] = None):
        self.trace_id = trace_id or _new_trace_id()
        self.kind = kind
        self.root = Span(kind, None)
        self.spans: List[Span] = [self.root]
        self.links: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        self.links_dropped = 0
        self.discard = False   # set True to skip the ring (empty ticks)

    @property
    def duration_s(self) -> Optional[float]:
        return self.root.duration_s

    def link(self, other_trace_id: str):
        if not other_trace_id or other_trace_id == self.trace_id:
            return
        if other_trace_id in self.links:
            return
        if len(self.links) >= self.MAX_LINKS:
            self.links_dropped += 1
            return
        self.links[other_trace_id] = None

    def to_dict(self) -> dict:
        by_parent: Dict[Optional[int], List[Span]] = {}
        for s in self.spans:
            by_parent.setdefault(s.parent_id, []).append(s)

        def build(span: Span) -> dict:
            d = span.to_dict()
            kids = by_parent.get(span.span_id)
            if kids:
                d["children"] = [build(k) for k in kids]
            return d

        d = {"traceId": self.trace_id, "kind": self.kind,
             # the owning process
             "pid": os.getpid(),
             "start": self.root.t_wall,
             "durationMs": (round(self.root.duration_s * 1000.0, 3)
                            if self.root.duration_s is not None
                            else None),
             "links": list(self.links),
             "root": build(self.root)}
        if self.links_dropped:
            d["linksDropped"] = self.links_dropped
        return d


class Tracer:
    """Process-wide trace collector + context propagation."""

    def __init__(self, per_kind_capacity: int = 128,
                 event_map_capacity: int = 8192):
        self.per_kind_capacity = per_kind_capacity
        self._lock = threading.Lock()
        self._done: Dict[str, collections.deque] = {}
        # trace_id -> committed Trace, kept in lockstep with the rings
        # so link_completed is O(1) instead of a ring scan (a fold can
        # absorb thousands of events per tick)
        self._by_id: Dict[str, Trace] = {}
        self._ctx: contextvars.ContextVar = contextvars.ContextVar(
            "pio_trace_ctx", default=None)
        # event_id -> trace_id, bounded FIFO: lets the scheduler's tail
        # read resolve fresh events back to their ingest traces
        self._event_traces: "collections.OrderedDict[str, str]" = \
            collections.OrderedDict()
        self._event_map_capacity = event_map_capacity

    # -- context -------------------------------------------------------
    def current_trace(self) -> Optional[Trace]:
        ctx = self._ctx.get()
        return ctx[0] if ctx else None

    def current_trace_id(self) -> Optional[str]:
        t = self.current_trace()
        return t.trace_id if t else None

    def current_span(self) -> Optional[Span]:
        """The innermost open span of the active trace, or None; a
        sampled device-time reading annotates it once the sample is
        read (`obs/costmon.device_timed`)."""
        ctx = self._ctx.get()
        return ctx[1] if ctx else None

    @contextmanager
    def trace(self, kind: str, trace_id: Optional[str] = None, **attrs):
        """Mint a trace and make it current for the calling thread's
        scope. Exceptions mark the root span and re-raise. Set
        ``trace.discard = True`` inside to skip recording (e.g. an
        empty scheduler tick)."""
        t = Trace(kind, trace_id=trace_id)
        if attrs:
            t.root.attrs.update(attrs)
        _stamp_tenant(t.root)
        token = self._ctx.set((t, t.root))
        try:
            yield t
        except BaseException as e:
            t.root.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            self._ctx.reset(token)
            t.root.end()
            if not t.discard:
                self._commit(t)

    def begin_trace(self, kind: str, **attrs) -> Trace:
        """Mint a trace WITHOUT making it current or committing it —
        the cross-thread half of :meth:`trace` for the pipelined
        serving executor: the formation thread begins the
        ``batch_predict`` trace, each stage re-enters it via
        :meth:`resume`, and the completion stage's ``resume(...,
        commit=True)`` ends + commits it."""
        t = Trace(kind)
        if attrs:
            t.root.attrs.update(attrs)
        _stamp_tenant(t.root)
        return t

    @contextmanager
    def resume(self, t: Trace, commit: bool = False):
        """Make an EXISTING (uncommitted) trace current for this
        thread's scope — spans recorded inside land on it. With
        ``commit`` the trace's root is ended and the trace committed
        on exit: the resuming stage is its final owner. Exceptions
        mark the root span and re-raise (matching :meth:`trace`)."""
        token = self._ctx.set((t, t.root))
        try:
            yield t
        except BaseException as e:
            t.root.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            self._ctx.reset(token)
            if commit:
                t.root.end()
                if not t.discard:
                    self._commit(t)

    @contextmanager
    def span(self, name: str, **attrs):
        """A child span of the current trace; a cheap no-op when no
        trace is active (so instrumented code needs no caller checks)."""
        ctx = self._ctx.get()
        if ctx is None:
            yield None
            return
        trace, parent = ctx
        s = Span(name, parent.span_id)
        if attrs:
            s.attrs.update(attrs)
        trace.spans.append(s)
        token = self._ctx.set((trace, s))
        try:
            yield s
        except BaseException as e:
            s.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            self._ctx.reset(token)
            s.end()

    def annotate(self, **attrs):
        """Attach attributes to the current span, if any."""
        ctx = self._ctx.get()
        if ctx is not None:
            ctx[1].attrs.update(attrs)

    # -- commit / ring -------------------------------------------------
    def _commit(self, t: Trace):
        with self._lock:
            ring = self._done.get(t.kind)
            if ring is None:
                ring = collections.deque(maxlen=self.per_kind_capacity)
                self._done[t.kind] = ring
            if len(ring) == ring.maxlen:   # evicting: drop its index
                # ... only if the index still points at the evicted
                # object: an adopted inbound id can put two traces
                # under one id in this process (a co-located hop), and
                # the older ring entry must not unhook the newer trace
                # from ?trace_id= lookup
                old = ring[0]
                if self._by_id.get(old.trace_id) is old:
                    self._by_id.pop(old.trace_id, None)
            ring.append(t)
            self._by_id[t.trace_id] = t

    # -- cross-trace causality ------------------------------------------
    def register_event(self, event_id: Optional[str],
                       trace_id: Optional[str]):
        if not event_id or not trace_id:
            return
        with self._lock:
            self._event_traces[str(event_id)] = trace_id
            while len(self._event_traces) > self._event_map_capacity:
                self._event_traces.popitem(last=False)

    def trace_id_for_event(self, event_id) -> Optional[str]:
        with self._lock:
            return self._event_traces.get(str(event_id))

    def get(self, trace_id: str) -> Optional[Trace]:
        """The committed Trace for ``trace_id``, or None once it has
        rotated out of its ring (O(1); slow-query waterfalls read the
        batch trace that answered a request this way)."""
        with self._lock:
            return self._by_id.get(trace_id)

    def link_completed(self, trace_id: str, other_trace_id: str):
        """Add a link onto an already-committed trace (the back-link
        from an event's ingest trace to the fold tick that absorbed
        it). O(1); no-op when the trace already left the ring."""
        with self._lock:
            t = self._by_id.get(trace_id)
            if t is not None:
                t.link(other_trace_id)

    # -- the /traces.json view -----------------------------------------
    def snapshot(self, limit: int = 50, kind: Optional[str] = None,
                 slowest: bool = False) -> List[dict]:
        with self._lock:
            if kind is not None:
                traces = list(self._done.get(kind, ()))
            else:
                traces = [t for ring in self._done.values()
                          for t in ring]
        if slowest:
            traces.sort(key=lambda t: t.duration_s or 0.0, reverse=True)
        else:
            traces.sort(key=lambda t: t.root.t_wall, reverse=True)
        return [t.to_dict() for t in traces[:max(0, int(limit))]]

    def related(self, trace_id: str, limit: int = 50) -> List[dict]:
        """The trace plus its causal neighborhood, for incident
        correlation: the trace itself, every
        committed trace it links, and every committed trace linking
        it — so one ``?trace_id=`` query walks an ingest event to the
        fold tick that absorbed it (or back) without client-side grep
        over whole rings. Every committed trace CARRYING the id is
        returned, not just the newest (an adopted inbound id can put
        a query trace and a feedback-ingest trace under one id in one
        process, and the waterfall needs both legs)."""
        with self._lock:
            target = self._by_id.get(trace_id)
            linked = set(target.links) if target is not None else set()
            out = [] if target is None else [target]
            for ring in self._done.values():
                for t in ring:
                    if t is target:
                        continue
                    if (t.trace_id == trace_id
                            or t.trace_id in linked
                            or trace_id in t.links):
                        out.append(t)
        out.sort(key=lambda t: t.root.t_wall, reverse=True)
        return [t.to_dict() for t in out[:max(0, int(limit))]]

    def clear(self):
        with self._lock:
            self._done.clear()
            self._by_id.clear()
            self._event_traces.clear()


# The process-wide tracer.
TRACER = Tracer()


def traces_response(params: dict):
    """Shared ``GET /traces.json`` handler body for every HTTP server:
    ``?n=``/``?limit=`` (default 50), ``?kind=`` filter,
    ``?sort=slowest``, and ``?trace_id=`` — which returns the named
    trace plus its linked neighborhood. ``?event_ids=a,b,c`` instead
    answers the event-id -> ingest-trace-id map from this process's
    bounded event registry."""
    event_ids = params.get("event_ids") or params.get("eventIds")
    if event_ids:
        out = {}
        for eid in str(event_ids).split(",")[:1024]:
            eid = eid.strip()
            if not eid:
                continue
            tid = TRACER.trace_id_for_event(eid)
            if tid:
                out[eid] = tid
        return {"eventTraces": out}
    limit = int(params.get("n", params.get("limit", 50)))
    trace_id = params.get("trace_id") or params.get("traceId")
    if trace_id:
        return {"traces": TRACER.related(trace_id, limit=limit)}
    return {"traces": TRACER.snapshot(
        limit=limit, kind=params.get("kind"),
        slowest=params.get("sort") == "slowest")}
