"""COST* rules: per-request overhead on the ingest-ack and query paths.

The port's copy of `predictionio_tpu/analysis/rules_cost.py`: the rules
are framework-free, and the port's modules keep the reference's
basenames, so the same handler roots apply.

Roots are the HTTP-facing functions of the event server (single, batch
and columnar create routes + the admission batcher) and the engine
server (query handlers + micro-batcher); reachability runs over the
tier A+B call graph with a depth cap, so helpers the handlers call are
in scope but the whole repo is not.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from predictionio_tpu_torch.analysis.core import (Finding, RepoModel,
                                            register_rule)

COST001 = register_rule(
    "COST001", "fsync on hot path",
    "os.fsync reachable from an ingest-ack or query handler. One fsync "
    "is ~ms on a loaded disk — it serializes the ack behind physical "
    "IO. Durability belongs on the group-commit cadence (PR 7) or the "
    "spill WAL's outage path, not per request.")

COST002 = register_rule(
    "COST002", "eager log-string formatting on hot path",
    "logging call whose message is built eagerly (f-string, %-format, "
    ".format(), concatenation) on a request path — the string is "
    "rendered even when the level is disabled. Use lazy %-style args: "
    "logger.debug(\"x=%s\", x).")

COST003 = register_rule(
    "COST003", "metric registration on hot path",
    "registry.counter()/gauge()/histogram()/lock_probe() reachable "
    "from a request handler. Registration takes the registry lock and "
    "allocates; resolve instruments once at init and call .inc()/"
    ".observe() on the hot path (the PR 2 obs contract).")

#: (module basename, function name) handler roots. Name-based so the
#: fixture suite can exercise the rules with small files of the same
#: shape.
HOT_PATH_ROOTS: Tuple[Tuple[str, str], ...] = (
    # event server: ingest-ack
    ("event_server.py", "_create_event"),
    ("event_server.py", "_create_event_inner"),
    ("event_server.py", "_batch_create"),
    ("event_server.py", "_columnar_post"),
    ("event_server.py", "_columnar_create"),
    ("event_server.py", "_insert_traced"),
    ("event_server.py", "_resilient_insert"),
    ("event_server.py", "_resilient_insert_batch"),
    ("event_server.py", "_resilient_insert_columnar"),
    ("event_server.py", "submit"),
    ("event_server.py", "_dispatch"),
    # engine server: query
    ("server.py", "handle_query"),
    ("server.py", "handle_query_batch"),
    ("batcher.py", "submit"),
    ("batcher.py", "_dispatch"),
    ("batcher.py", "_loop"),
    # bulk data plane (ISSUE 16): the per-chunk steady loop — an fsync,
    # eager log render, or metric registration here repeats per chunk
    # for the whole backfill
    ("reader.py", "_run"),
    ("upload.py", "stage"),
    ("pipeline.py", "run"),
)

_LOG_METHODS = {"debug", "info", "warning", "error", "exception",
                "critical", "log"}
_REGISTRATION_ATTRS = {"counter", "gauge", "histogram", "gauge_func",
                       "counter_func", "summary_func"}
_REGISTRY_RECEIVERS = {"registry", "reg", "_registry", "get_registry",
                       "metrics"}


def hot_path_functions(repo: RepoModel) -> Set[str]:
    """Reachable set from the handler roots; memoized on the repo —
    the three COST rules share it."""
    cached = getattr(repo, "_hot_path_fns", None)
    if cached is not None:
        return cached
    roots = []
    for key, fn in repo.functions.items():
        if (fn.module.basename, fn.name) in HOT_PATH_ROOTS:
            roots.append(key)
    edges = repo.call_edges(tier_b=True)
    out = repo.reachable(roots, edges, max_depth=8)
    repo._hot_path_fns = out
    return out


def check_cost001(repo: RepoModel) -> List[Finding]:
    findings: List[Finding] = []
    for key in sorted(hot_path_functions(repo)):
        fn = repo.functions[key]
        for ev in fn.events:
            if ev.kind == "call" and ev.chain == ("os", "fsync"):
                findings.append(Finding(
                    COST001.id, fn.module.relpath, ev.line, fn.qualname,
                    "os.fsync",
                    "os.fsync on a request path — the ack waits on "
                    "physical IO"))
    return findings


def _eager_format_kind(call: ast.Call) -> str:
    """'' when the first logging arg is lazy (constant + args)."""
    if not call.args:
        return ""
    msg = call.args[0]
    if isinstance(msg, ast.JoinedStr):
        return "f-string"
    if isinstance(msg, ast.BinOp) and isinstance(msg.op, ast.Mod):
        return "%-format"
    if isinstance(msg, ast.BinOp) and isinstance(msg.op, ast.Add):
        return "concat"
    if isinstance(msg, ast.Call):
        inner = msg.func
        if isinstance(inner, ast.Attribute) and inner.attr == "format":
            return ".format()"
    return ""


def check_cost002(repo: RepoModel) -> List[Finding]:
    findings: List[Finding] = []
    for key in sorted(hot_path_functions(repo)):
        fn = repo.functions[key]
        for ev in fn.events:
            if ev.kind != "call" or len(ev.chain) < 2:
                continue
            if ev.chain[-1] not in _LOG_METHODS:
                continue
            root = ev.chain[0]
            if not (root in ("logger", "logging", "log", "_logger")
                    or root.endswith("logger")):
                continue
            kind = _eager_format_kind(ev.node) \
                if isinstance(ev.node, ast.Call) else ""
            if kind:
                findings.append(Finding(
                    COST002.id, fn.module.relpath, ev.line, fn.qualname,
                    f"{ev.chain[-1]}:{kind}",
                    f"logger.{ev.chain[-1]} message built eagerly "
                    f"({kind}) on a request path — use lazy %-style "
                    f"args"))
    return findings


def check_cost003(repo: RepoModel) -> List[Finding]:
    findings: List[Finding] = []
    for key in sorted(hot_path_functions(repo)):
        fn = repo.functions[key]
        if fn.name in ("__init__", "_register_metrics"):
            continue   # init-time by definition, not per-request
        for ev in fn.events:
            if ev.kind != "call":
                continue
            chain = ev.chain
            if chain[-1] == "lock_probe" and len(chain) == 1:
                findings.append(Finding(
                    COST003.id, fn.module.relpath, ev.line, fn.qualname,
                    "lock_probe",
                    "lock_probe() resolves the probe under a lock — "
                    "resolve once at init, observe on the hot path"))
                continue
            if chain[-1] in _REGISTRATION_ATTRS and len(chain) >= 2 \
                    and (chain[-2] in _REGISTRY_RECEIVERS
                         or chain[-2].endswith("registry")):
                findings.append(Finding(
                    COST003.id, fn.module.relpath, ev.line, fn.qualname,
                    f"register:{chain[-1]}",
                    f"{'.'.join(chain)}() registers a metric family "
                    f"per request — register at init, increment on "
                    f"the path"))
    return findings
