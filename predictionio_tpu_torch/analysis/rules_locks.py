"""LOCK* rules: lock-order cycles, locks held across blocking calls,
and unguarded mutation from background threads.

The port's copy of `predictionio_tpu/analysis/rules_locks.py`. The
rules are framework-free; the one JAX label of the reference's blocking
set (``jit-dispatch``) becomes its counterpart here: a lock held across
a host sync with the card (``host-sync:...``, see
``core.host_sync_label``).

The lock graph is class-attribute granular (``SpillWAL._lock`` is one
node regardless of instance) — the right granularity for order cycles,
and the documented source of instance-aliasing false positives the
baseline absorbs.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from predictionio_tpu_torch.analysis.core import (Event, Finding,
                                                  FunctionInfo, RepoModel,
                                                  host_sync_label,
                                                  register_rule)

LOCK001 = register_rule(
    "LOCK001", "lock-order cycle",
    "Two or more locks are acquired in inconsistent orders somewhere "
    "in the repo (directly or through resolvable calls made while "
    "holding a lock). Two threads taking the cycle's edges "
    "concurrently deadlock. Self-cycles on a non-reentrant "
    "threading.Lock are reported too (re-acquiring wedges the thread).")

LOCK002 = register_rule(
    "LOCK002", "lock held across blocking call",
    "A blocking operation (FFI el_*, os.fsync/open, HTTP, queue/event "
    "waits, thread joins, time.sleep, a host sync with the card) runs "
    "while a lock "
    "is held — every other thread needing the lock convoys behind the "
    "slow operation (the PR 7 nativelog fsync convoy class).")

LOCK003 = register_rule(
    "LOCK003", "unguarded shared mutation from background thread",
    "An instance attribute is mutated from a background-thread entry "
    "point (Thread(target=...) roster) without holding any lock, while "
    "other methods of the class also touch it. Torn reads/lost updates "
    "unless the attribute is documented single-writer or benign.")

#: call-chain tails treated as blocking while a lock is held. Curated,
#: not exhaustive: high-signal operations only (plain file .write/.flush
#: under a lock is the WAL's whole design, so it is NOT in this set).
_BLOCKING_DOTTED: Dict[Tuple[str, ...], str] = {
    ("os", "fsync"): "os.fsync",
    ("time", "sleep"): "time.sleep",
    ("os", "replace"): "os.replace",
}
_BLOCKING_NAMES = {"fetch_json": "http:fetch_json", "urlopen":
                   "http:urlopen", "open": "open"}
_BLOCKING_ATTRS = {"fsync": "os.fsync", "urlopen": "http:urlopen",
                   "getresponse": "http:getresponse",
                   "wait": "wait", "result": "future.result"}


def _blocking_label(fn: FunctionInfo, ev: Event,
                    repo: RepoModel) -> Optional[str]:
    chain = ev.chain
    name = chain[-1]
    if chain in _BLOCKING_DOTTED:
        return _BLOCKING_DOTTED[chain]
    if len(chain) == 1 and name in _BLOCKING_NAMES:
        return _BLOCKING_NAMES[name]
    if name.startswith("el_"):
        return f"ffi:{name}"
    if len(chain) >= 2:
        if name in _BLOCKING_ATTRS:
            # Condition.wait on the HELD lock releases it while waiting
            # — that is the condition idiom, not a convoy
            if name == "wait" and chain[-2] in ev.held_src:
                return None
            # stop-event waits with timeout are the scheduler/pacer
            # idiom; .wait on anything else under a lock is a finding
            return _BLOCKING_ATTRS[name]
        if name == "get" and any("queue" in part.lower() or
                                 part.rstrip("_").endswith("q")
                                 for part in chain[:-1]):
            return "queue.get"
        if name == "join" and any("thread" in part.lower()
                                  for part in chain[:-1]):
            return "thread.join"
    # a host sync with the card: .synchronize(), the port's
    # device.synchronize, or a host pull of a device local
    return host_sync_label(fn, ev)


def check_lock002(repo: RepoModel) -> List[Finding]:
    findings: List[Finding] = []
    edges = repo.call_edges(tier_b=False)
    # may-block closure: which functions (transitively) hit a blocking
    # op — used for calls made while a lock is held here
    seed: Dict[str, Set[str]] = {}
    for key, fn in repo.functions.items():
        ops = set()
        for ev in fn.events:
            if ev.kind != "call":
                continue
            label = _blocking_label(fn, ev, repo)
            if label is not None:
                ops.add(label)
        seed[key] = ops
    may_block = repo.closure(seed, edges)

    for key, fn in repo.functions.items():
        for ev in fn.events:
            if ev.kind != "call" or not ev.held:
                continue
            label = _blocking_label(fn, ev, repo)
            if label is not None:
                findings.append(Finding(
                    LOCK002.id, fn.module.relpath, ev.line, fn.qualname,
                    label,
                    f"{label} while holding {', '.join(ev.held)}"))
                continue
            # interprocedural: a resolvable callee that may block
            for callee in repo.resolve_call(fn, ev.chain):
                ops = may_block.get(callee, ())
                if ops:
                    cal = repo.functions[callee].qualname
                    findings.append(Finding(
                        LOCK002.id, fn.module.relpath, ev.line,
                        fn.qualname, f"call:{cal}",
                        f"call to {cal} (which may {sorted(ops)[0]}) "
                        f"while holding {', '.join(ev.held)}"))
                    break
    return findings


def check_lock001(repo: RepoModel) -> List[Finding]:
    edges = repo.call_edges(tier_b=False)
    # may-acquire closure over NAMED locks (local: anonymous locks only
    # order intra-function where the held stack already sees them)
    seed: Dict[str, Set[str]] = {}
    for key, fn in repo.functions.items():
        seed[key] = {ev.chain[0] for ev in fn.events
                     if ev.kind == "acquire"
                     and not ev.chain[0].startswith("local:")}
    may_acquire = repo.closure(seed, edges)

    #: lock kind lookup (for RLock self-cycle exemption)
    kinds: Dict[str, str] = {}
    graph: Dict[str, Set[str]] = {}
    sites: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

    def edge(a: str, b: str, fn: FunctionInfo, line: int):
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
        sites.setdefault((a, b), (fn.module.relpath, line, fn.qualname))

    for key, fn in repo.functions.items():
        for ev in fn.events:
            if ev.kind == "acquire":
                kinds.setdefault(ev.chain[0], ev.chain[1])
                for held in ev.held:
                    edge(held, ev.chain[0], fn, ev.line)
            elif ev.kind == "call" and ev.held:
                for callee in repo.resolve_call(fn, ev.chain):
                    for lock in may_acquire.get(callee, ()):
                        for held in ev.held:
                            edge(held, lock, fn, ev.line)

    findings: List[Finding] = []
    # self-cycles on non-reentrant locks
    for lock, outs in sorted(graph.items()):
        if lock in outs and kinds.get(lock) == "lock" \
                and not lock.startswith("local:"):
            path, line, symbol = sites[(lock, lock)]
            findings.append(Finding(
                LOCK001.id, path, line, symbol, f"self:{lock}",
                f"non-reentrant {lock} re-acquired while already held "
                f"(threading.Lock deadlocks on re-entry)"))
    # multi-lock cycles via Tarjan SCC
    for scc in _sccs(graph):
        if len(scc) < 2:
            continue
        cyc = sorted(scc)
        # anchor the finding to a REAL edge inside the cycle (the
        # first in sorted pair order) — an arbitrary repo-wide edge
        # would make the fingerprint's path/symbol churn with scan
        # order
        site = next((sites[(a, b)] for a in cyc for b in cyc
                     if (a, b) in sites), None)
        assert site is not None, f"SCC {cyc} has no recorded edge"
        path, line, symbol = site
        findings.append(Finding(
            LOCK001.id, path, line, symbol,
            "cycle:" + ">".join(cyc),
            f"lock-order cycle between {', '.join(cyc)} — two threads "
            f"taking these edges concurrently deadlock"))
    return findings


def _sccs(graph: Dict[str, Set[str]]) -> List[Set[str]]:
    """Iterative Tarjan strongly-connected components."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    out: List[Set[str]] = []
    counter = [0]

    for root in sorted(graph):
        if root in index:
            continue
        work = [(root, iter(sorted(graph.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on.add(nxt)
                    work.append((nxt, iter(sorted(graph.get(nxt, ())))))
                    advanced = True
                    break
                elif nxt in on:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = set()
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.add(w)
                    if w == node:
                        break
                out.append(comp)
    return out


#: attribute types that are themselves synchronization/thread-safe and
#: need no external lock
_SAFE_CTOR_TAILS = {"Lock", "RLock", "Condition", "Event", "Queue",
                    "SimpleQueue", "deque", "Semaphore",
                    "BoundedSemaphore", "Barrier", "local", "Thread"}


def check_lock003(repo: RepoModel) -> List[Finding]:
    findings: List[Finding] = []
    edges = repo.call_edges(tier_b=False)
    for classes in repo.classes.values():
        for cls in classes:
            entry_keys = [cls.methods[m] for m in sorted(cls.thread_targets)
                          if m in cls.methods]
            # nested-def thread targets (loop() defined in start())
            for mkey in cls.methods.values():
                fn = repo.functions.get(mkey)
                if fn is None:
                    continue
                entry_keys.extend(k for k in fn.nested
                                  if k in repo.thread_entries)
            if not entry_keys:
                continue
            thread_keys = repo.reachable(entry_keys, edges, max_depth=3)
            # keep only this class's own methods/closures
            thread_keys = {k for k in thread_keys
                           if repo.functions[k].class_name == cls.name}
            method_keys = set(cls.methods.values())
            safe_attrs = _attr_classes(repo, cls)
            reported: Set[str] = set()
            for key in sorted(thread_keys):
                fn = repo.functions[key]
                for ev in fn.events:
                    if ev.kind != "selfstore" or ev.held:
                        continue
                    attr = ev.name
                    if attr in reported or attr in safe_attrs:
                        continue
                    # shared = some NON-thread method touches it too
                    if not _touched_outside(repo, method_keys
                                            - thread_keys, attr):
                        continue
                    reported.add(attr)
                    findings.append(Finding(
                        LOCK003.id, fn.module.relpath, ev.line,
                        fn.qualname, attr,
                        f"{cls.name}.{attr} mutated from background "
                        f"thread without a lock (also accessed from "
                        f"foreground methods)"))
    return findings


def _attr_classes(repo: RepoModel, cls) -> Set[str]:
    """Attrs holding sync primitives / thread handles (need no external
    lock — they ARE the synchronization)."""
    safe: Set[str] = set(cls.lock_attrs)
    for mkey in cls.methods.values():
        fn = repo.functions.get(mkey)
        if fn is None:
            continue
        for ev in fn.events:
            if ev.kind == "selfstore" and ev.chain \
                    and ev.chain[-1] in _SAFE_CTOR_TAILS:
                safe.add(ev.name)
    return safe


def _touched_outside(repo: RepoModel, other_keys: Set[str],
                     attr: str) -> bool:
    """Does any non-thread method of the class read or write
    ``self.<attr>``? (Event streams don't record attribute loads, so
    reads come from a direct AST scan.)"""
    for key in sorted(other_keys):
        fn = repo.functions.get(key)
        if fn is None or fn.name == "__init__":
            continue
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Attribute) and node.attr == attr \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self":
                return True
    return False
