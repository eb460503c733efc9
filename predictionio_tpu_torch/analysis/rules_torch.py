"""TORCH* rules: hot-path hygiene for the port's serving and fold code.

The port's counterpart of `predictionio_tpu/analysis/rules_jax.py`: one
rule per JAX rule, in its order, each over the reference's zone for it.

- "Hot zone" (TORCH001) = modules whose path has a ``serving``/``ops``/
  ``guard`` segment or is ``fold_in.py``: the code that runs per query
  or per fold tick, where one stray ``.item()`` stalls the stream.
- "Serve zone" (TORCH005, and TORCH006's device-wide synchronize) =
  serving/, guard/, tenancy/, dataplane/, ``fold_in.py`` and the serve
  kernels ``ops/{als,similarity,topk}.py``.
- "Pipelined zone" (TORCH006) = serving/, tenancy/, dataplane/: the
  executor's own modules, where no host sync may appear. The sanctioned
  sync sites stay outside it by construction: ``ops/readback.py`` (the
  serve readback), ``ops/staging.py`` (the bulk upload's waits),
  ``obs/costmon.py`` (sampled device time) and ``compile/aot.py``
  (captures).

Device-value taint is per-function and syntactic (``core.device_tainted``):
a local assigned from a ``torch.*`` call or a program function (what a
module hands to the executable registry) is device-resident; host pulls
of tainted names are findings. Where the reference's rules key on
``jax.jit``, these key on CUDA-graph captures: a graph bakes in the
addresses of what it read, so a graph captured per call is the port's
recompile, and a captured graph's static outputs are overwritten by its
next replay, the port's donated buffer.
"""

from __future__ import annotations

import ast
import builtins
from typing import Dict, Iterable, List, Optional, Set, Tuple

from predictionio_tpu_torch.analysis.core import (GRAPH_CAPTURE_CALLS,
                                                  GRAPH_CTORS, HOST_CASTS,
                                                  HOST_PULLS, Finding,
                                                  FunctionInfo, RepoModel,
                                                  _walk_skipping_callables,
                                                  attr_chain,
                                                  device_tainted,
                                                  host_sync_label,
                                                  is_capture_call,
                                                  is_graph_with,
                                                  register_rule)

TORCH001 = register_rule(
    "TORCH001", "implicit host sync on hot path",
    ".item(), .cpu(), .numpy(), .tolist(), or float()/int()/bool() "
    "applied to a device value inside serving/fold code: each one waits "
    "for the stream and copies a device value to the host per call. "
    "Batch the readback (ops/readback.py) or keep the value on device.")

TORCH002 = register_rule(
    "TORCH002", "graph capture of closure (recapture hazard)",
    "A CUDA graph captured around a locally defined function that "
    "captures enclosing variables, with no visible cache for the graph. "
    "Every call of the enclosing function builds a NEW closure over new "
    "tensors and captures a new graph (a graph bakes in the addresses it "
    "read), unless the enclosing scope holds the graph. Hold it (the "
    "executable registry, a module dict, the owning object) keyed by "
    "what the closure captured.")

TORCH003 = register_rule(
    "TORCH003", "CUDA graph captured per call (uncached)",
    "torch.cuda.CUDAGraph() built, or a capture made, inside a function "
    "body outside compile/ with no visible cache (no lru_cache, the "
    "graph not stored in a cache container, on the owning object or in "
    "the executable registry). On a per-request or per-tick path this "
    "re-captures, warm-up runs included, every invocation.")

TORCH004 = register_rule(
    "TORCH004", "static graph output read after its next replay",
    "A captured graph's static output is aliased (not cloned) after a "
    "replay and read again after the graph's next replay, which has "
    "overwritten it in place: the reader sees the later replay's "
    "values. Clone the output before the next replay (compile/aot's "
    "GraphExecutable returns clones).")

TORCH005 = register_rule(
    "TORCH005", "serve-zone program call bypasses compile plane",
    "A program function (one this module hands to the executable "
    "registry) is called directly from serve-zone code (serving/guard/"
    "tenancy/dataplane modules, fold_in.py, the serve kernels ops/{als,"
    "similarity,topk}.py) by a function that never touches the compile "
    "plane (predictionio_tpu_torch/compile: get_aot, .dispatch, .ensure, "
    "warm_models). The direct call runs eagerly on every window, where "
    "plane dispatch replays the bucket's deploy-captured CUDA graph.")

TORCH006 = register_rule(
    "TORCH006", "host sync in the pipelined serve zone",
    "A host-synchronizing call (a stream/event/device .synchronize(), "
    ".item(), or .cpu()/.numpy()/.tolist()/np.asarray() of a device "
    "value) inside the pipelined serving executor's modules (serving/, "
    "tenancy/, dataplane/), or a device-wide torch.cuda.synchronize() "
    "anywhere in the serve zone. The serve path keeps window formation, "
    "dispatch and serialization overlapped with device work by deferring "
    "every readback to the ops layer's finish() closures "
    "(ops/readback.py) and every upload wait to ops/staging.py; one sync "
    "in these modules re-serializes the pipeline. A device-wide "
    "synchronize also invalidates a CUDA-graph capture that another "
    "thread has in flight (compile/aot.capture); the port synchronizes "
    "streams (device.synchronize), never the device.")

_HOT_SEGMENTS = {"serving", "ops", "guard"}


def in_hot_zone(relpath: str) -> bool:
    parts = relpath.split("/")
    return bool(_HOT_SEGMENTS.intersection(parts[:-1])) \
        or parts[-1] == "fold_in.py"


#: the serve zone: code dispatching device programs per query or per
#: fold tick, where the compile plane's buckets and deploy-time captures
#: are the contract; the train-only kernels (markov, forest, ...) stay
#: out, as in the reference
_SERVE_KERNELS = {"als.py", "similarity.py", "topk.py"}


def in_serve_zone(relpath: str) -> bool:
    parts = relpath.split("/")
    if {"serving", "guard", "tenancy", "dataplane"}.intersection(
            parts[:-1]):
        return True
    if parts[-1] == "fold_in.py":
        return True
    return "ops" in parts[:-1] and parts[-1] in _SERVE_KERNELS


def in_pipelined_zone(relpath: str) -> bool:
    """The pipelined serve zone: serving/, tenancy/ (which routes into
    the pipelined executor) and dataplane/ (whose read/decode overlaps
    the async upload). Narrower than the hot zone on purpose: the ops
    kernels read back inside their finish() callables, and
    ops/staging.py holds the bulk loader's waits."""
    parts = relpath.split("/")
    return bool({"serving", "tenancy", "dataplane"}.intersection(
        parts[:-1]))


_NP_CONVERTERS = {("np", "asarray"), ("np", "array"),
                  ("numpy", "asarray"), ("numpy", "array")}


def _first_arg_name(node: Optional[ast.AST]) -> Optional[str]:
    if not isinstance(node, ast.Call) or not node.args:
        return None
    a = node.args[0]
    return a.id if isinstance(a, ast.Name) else None


def check_torch001(repo: RepoModel) -> List[Finding]:
    findings: List[Finding] = []
    for key, fn in repo.functions.items():
        if not in_hot_zone(fn.module.relpath):
            continue
        tainted = device_tainted(fn)
        if not tainted:
            continue
        for ev in fn.events:
            if ev.kind != "call":
                continue
            chain = ev.chain
            if chain[-1] in HOST_PULLS and len(chain) == 2 \
                    and chain[0] in tainted:
                findings.append(Finding(
                    TORCH001.id, fn.module.relpath, ev.line, fn.qualname,
                    f"{chain[-1]}:{chain[0]}",
                    f"{'.'.join(chain)}() waits for the stream and copies "
                    f"a device value to the host per call"))
                continue
            arg0 = _first_arg_name(ev.node)
            if arg0 is None or arg0 not in tainted:
                continue
            if len(chain) == 1 and chain[0] in HOST_CASTS:
                findings.append(Finding(
                    TORCH001.id, fn.module.relpath, ev.line, fn.qualname,
                    f"{chain[0]}:{arg0}",
                    f"{chain[0]}({arg0}) converts a device value on the "
                    f"host (implicit copy + sync)"))
            elif tuple(chain[-2:]) in _NP_CONVERTERS:
                findings.append(Finding(
                    TORCH001.id, fn.module.relpath, ev.line, fn.qualname,
                    f"asarray:{arg0}",
                    f"{'.'.join(chain)}({arg0}) pulls a device value to "
                    f"host memory (implicit copy + sync)"))
    return findings


def _free_vars(fn_node: ast.AST, params: Set[str]) -> Set[str]:
    """Names loaded but never bound in the function: closure captures
    (module globals are filtered by the caller)."""
    bound = set(params)
    loaded: Set[str] = set()
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Store):
                bound.add(node.id)
            elif isinstance(node.ctx, ast.Load):
                loaded.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node is not fn_node:
                bound.add(node.name)
    return {n for n in loaded - bound if not hasattr(builtins, n)}


def _module_globals(fn: FunctionInfo) -> Set[str]:
    out: Set[str] = set()
    for node in fn.module.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            out.add(node.name)
    return out


def _store_targets(node: ast.AST) -> List[str]:
    """Name targets of an assignment, tuple targets included."""
    if not isinstance(node, (ast.Assign, ast.AnnAssign)):
        return []
    targets = (node.targets if isinstance(node, ast.Assign)
               else [node.target])
    out: List[str] = []
    for t in targets:
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            out.extend(e.id for e in t.elts if isinstance(e, ast.Name))
    return out


def _is_self_attr(expr: Optional[ast.AST]) -> bool:
    chain = attr_chain(expr) if expr is not None else None
    return bool(chain) and len(chain) >= 2 and chain[0] == "self"


#: calls that hand a graph (or what holds it) to a container or to the
#: executable registry, which then own its lifetime
_HOLD_TAILS = {"append", "add", "setdefault", "adopt", "shared_jit"}


def _graph_cached(fn: FunctionInfo, held: Set[str],
                  graph_expr: Optional[ast.AST] = None) -> bool:
    """The enclosing function visibly holds the graph: lru_cache-
    decorated, the graph kept on the owning object (``self.graph``),
    stored into a subscript or onto ``self``, or handed to a container
    or the registry (``self.graphs.append(g)``, ``AOT.adopt(key, g)``)."""
    for dec in getattr(fn.node, "decorator_list", []):
        chain = attr_chain(dec if not isinstance(dec, ast.Call)
                           else dec.func)
        if chain and chain[-1] in ("lru_cache", "cache"):
            return True
    if _is_self_attr(graph_expr):
        return True
    if not held:
        return False
    for node in _walk_skipping_callables(fn.node):
        if isinstance(node, ast.Assign):
            v = node.value
            elts = (v.elts if isinstance(v, (ast.Tuple, ast.List))
                    else [v])
            if not any(isinstance(e, ast.Name) and e.id in held
                       for e in elts):
                continue
            for t in node.targets:
                if isinstance(t, ast.Subscript) or _is_self_attr(t):
                    return True
        elif isinstance(node, ast.Call):
            tail = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else node.func.id if isinstance(node.func, ast.Name)
                    else None)
            if tail in _HOLD_TAILS and any(
                    isinstance(a, ast.Name) and a.id in held
                    for a in node.args):
                return True
    return False


class _CaptureSite:
    """One graph construction or capture in a function: its line, the
    callable captured (when the site names one), the graph's expression
    and the names that hold the graph or its executable."""

    __slots__ = ("line", "callable", "graph", "held", "key")

    def __init__(self, line: int, callable_: Optional[ast.AST],
                 graph: Optional[ast.AST], held: Set[str]):
        self.line = line
        self.callable = callable_
        self.graph = graph
        self.held = held
        gname = graph.id if isinstance(graph, ast.Name) else None
        self.key = gname or (sorted(held)[0] if held else "inline")


_GRAPH_TAILS = set(GRAPH_CTORS) | set(GRAPH_CAPTURE_CALLS) | {"graph"}


def _touches_graphs(fn: FunctionInfo) -> bool:
    """Cheap pre-filter: does the function call anything that builds or
    captures a graph (a ``with torch.cuda.graph(g)`` emits its call)?"""
    return any(ev.kind == "call" and ev.chain[-1] in _GRAPH_TAILS
               for ev in fn.events)


def _capture_sites(fn: FunctionInfo) -> List[_CaptureSite]:
    sites: List[_CaptureSite] = []
    if not _touches_graphs(fn):
        return sites
    stored: Dict[int, List[str]] = {}
    for node in _walk_skipping_callables(fn.node):
        if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                and isinstance(node.value, ast.Call):
            stored[id(node.value)] = _store_targets(node)
    for node in _walk_skipping_callables(fn.node):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            tail = chain[-1] if chain else None
            if tail in GRAPH_CTORS:
                held = set(stored.get(id(node), ()))
                sites.append(_CaptureSite(node.lineno, None, None, held))
            elif tail in GRAPH_CAPTURE_CALLS and is_capture_call(chain):
                pos = GRAPH_CAPTURE_CALLS[tail]
                if len(node.args) <= pos:
                    continue
                held = set(stored.get(id(node), ()))
                graph = None
                if tail == "capture" and node.args:
                    graph = node.args[0]
                    if isinstance(graph, ast.Name):
                        held.add(graph.id)
                sites.append(_CaptureSite(node.lineno, node.args[pos],
                                          graph, held))
        elif isinstance(node, ast.With):
            for item in node.items:
                if not is_graph_with(item.context_expr):
                    continue
                args = item.context_expr.args
                graph = args[0] if args else None
                held = {graph.id} if isinstance(graph, ast.Name) else set()
                called = None
                for sub in node.body:
                    for n in _walk_skipping_callables(sub):
                        if isinstance(n, ast.Call) \
                                and isinstance(n.func, ast.Name):
                            called = n.func
                            break
                    if called is not None:
                        break
                sites.append(_CaptureSite(node.lineno, called, graph, held))
    return sites


def check_torch002(repo: RepoModel) -> List[Finding]:
    findings: List[Finding] = []
    for key, fn in repo.functions.items():
        if not fn.nested:
            continue
        nested_by_name = {repo.functions[k].name: repo.functions[k]
                          for k in fn.nested}
        module_globals = _module_globals(fn)
        seen: Set[int] = set()
        for site in _capture_sites(fn):
            if site.line in seen or not isinstance(site.callable,
                                                   ast.Name):
                continue
            target = nested_by_name.get(site.callable.id)
            if target is None:
                continue
            seen.add(site.line)
            free = _free_vars(target.node, target.params)
            free -= module_globals
            free -= fn.module.imports.keys()
            if not free or _graph_cached(fn, site.held, site.graph):
                continue
            findings.append(Finding(
                TORCH002.id, fn.module.relpath, site.line, fn.qualname,
                f"closure:{target.name}",
                f"a CUDA graph captured around {target.name}, which "
                f"captures {sorted(free)} from the enclosing scope: a "
                f"fresh closure per call captures a fresh graph unless "
                f"the graph is held"))
    return findings


def check_torch003(repo: RepoModel) -> List[Finding]:
    findings: List[Finding] = []
    for key, fn in repo.functions.items():
        if "compile" in fn.module.relpath.split("/")[:-1]:
            continue
        reported: Set[str] = set()
        sites = _capture_sites(fn)
        for site in sites:
            if site.key in reported:
                continue
            # a graph built on one line and captured on another is one
            # graph: every name any of its sites binds holds it
            held = set(site.held)
            for other in sites:
                if other.key == site.key:
                    held |= other.held
            if _graph_cached(fn, held, site.graph):
                continue
            reported.add(site.key)
            findings.append(Finding(
                TORCH003.id, fn.module.relpath, site.line, fn.qualname,
                f"graph:{site.key}",
                f"a CUDA graph built or captured inside {fn.qualname} "
                f"with no visible cache: it is captured again on every "
                f"invocation"))
    return findings


def _static_outputs(fn: FunctionInfo) -> Set[str]:
    """Names bound to a captured graph's static outputs: assigned inside
    a ``with torch.cuda.graph(...)`` block, from a ``capture(...)`` call,
    or from an executable's ``.static_out``."""
    out: Set[str] = set()
    for node in _walk_skipping_callables(fn.node):
        if isinstance(node, ast.With) and any(
                is_graph_with(i.context_expr) for i in node.items):
            for sub in node.body:
                for n in _walk_skipping_callables(sub):
                    out.update(_store_targets(n))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)) \
                and node.value is not None:
            v = node.value
            if isinstance(v, ast.Call) and \
                    is_capture_call(attr_chain(v.func) or ()) and \
                    (attr_chain(v.func) or ())[-1:] == ("capture",):
                out.update(_store_targets(node))
            elif isinstance(v, ast.Attribute) and v.attr == "static_out":
                out.update(_store_targets(node))
    return out


def _aliases_of(value: ast.AST, static: Set[str]) -> bool:
    """Does ``value`` alias a static output without copying it (the name
    itself, an element of it, or a tuple of such)?"""
    if isinstance(value, ast.Name):
        return value.id in static
    if isinstance(value, ast.Subscript):
        return _aliases_of(value.value, static)
    if isinstance(value, (ast.Tuple, ast.List)):
        return any(_aliases_of(e, static) for e in value.elts)
    return False


def check_torch004(repo: RepoModel) -> List[Finding]:
    findings: List[Finding] = []
    for key, fn in repo.functions.items():
        replays = sorted(ev.line for ev in fn.events
                         if ev.kind == "call" and len(ev.chain) >= 2
                         and ev.chain[-1] == "replay")
        if len(replays) < 2:
            continue
        static = _static_outputs(fn)
        if not static:
            continue
        stores: Dict[str, List[int]] = {}
        aliases: List[Tuple[str, int]] = []
        for node in _walk_skipping_callables(fn.node):
            for name in _store_targets(node):
                stores.setdefault(name, []).append(node.lineno)
            if isinstance(node, ast.Assign) \
                    and _aliases_of(node.value, static):
                aliases.extend((n, node.lineno)
                               for n in _store_targets(node)
                               if n not in static)
        for name, line in sorted(aliases, key=lambda a: a[1]):
            nxt = next((r for r in replays if r > line), None)
            if nxt is None:
                continue
            restore = min((s for s in stores.get(name, ()) if s > line),
                          default=None)
            for ev in fn.events:
                if ev.kind != "load" or ev.name != name \
                        or ev.line <= nxt:
                    continue
                if restore is not None and ev.line >= restore:
                    continue
                findings.append(Finding(
                    TORCH004.id, fn.module.relpath, ev.line, fn.qualname,
                    f"replayed:{name}",
                    f"{name} aliases a graph's static output at line "
                    f"{line} and is read after the replay at line {nxt} "
                    f"overwrote it"))
                break
    return findings


#: the compile plane's entry points: a function that calls one resolves
#: its program through the registry (buckets, deploy-time capture)
_PLANE_NAMES = {"get_aot", "shared_jit", "warm_models"}
_PLANE_METHODS = {"dispatch", "ensure"}


def _references_plane(fn: FunctionInfo) -> bool:
    """Does this function resolve anything through the compile plane?
    By name (get_aot / shared_jit / warm_models, however imported), a
    registry method (``.dispatch``, ``.ensure``), or any alias the
    module imports from predictionio_tpu_torch.compile.*."""
    imports = fn.module.imports
    for ev in fn.events:
        if not ev.chain:
            continue
        root = ev.chain[0]
        if root in _PLANE_NAMES or "get_aot" in ev.chain \
                or "shared_jit" in ev.chain:
            return True
        if ev.kind == "call" and len(ev.chain) >= 2 \
                and ev.chain[-1] in _PLANE_METHODS:
            return True
        if imports.get(root, "").startswith(
                "predictionio_tpu_torch.compile"):
            return True
    return False


def check_torch005(repo: RepoModel) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[str, str]] = set()
    for key, fn in repo.functions.items():
        if not in_serve_zone(fn.module.relpath):
            continue
        roster = fn.module.programs
        if not roster or _references_plane(fn):
            continue
        for ev in fn.events:
            if ev.kind != "call" or len(ev.chain) != 1 \
                    or ev.chain[0] not in roster:
                continue
            if (fn.key, ev.chain[0]) in seen:
                continue
            seen.add((fn.key, ev.chain[0]))
            findings.append(Finding(
                TORCH005.id, fn.module.relpath, ev.line, fn.qualname,
                f"program_call:{ev.chain[0]}",
                f"{fn.qualname} calls program {ev.chain[0]} directly on "
                f"a serve-zone path: no compile-plane dispatch (bucketed, "
                f"deploy-captured graphs) covers it"))
    return findings


def _sync_findings(fn: FunctionInfo) -> Iterable[Tuple[int, str, str]]:
    """(line, evidence, message) of each host sync in ``fn``."""
    # call-rooted synchronizes (``torch.cuda.current_stream(d)
    # .synchronize()``) name no stable chain, so emit no call event
    for node in _walk_skipping_callables(fn.node):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "synchronize" \
                and isinstance(node.func.value, ast.Call):
            inner = attr_chain(node.func.value.func) or ("<call>",)
            yield (node.lineno, f"synchronize:{'.'.join(inner)}()",
                   f"{'.'.join(inner)}(...).synchronize() waits for the "
                   f"card inside the pipelined serve zone")
    tainted = device_tainted(fn)
    for ev in fn.events:
        if ev.kind != "call" or not ev.chain:
            continue
        chain = ev.chain
        if chain[-1] == "item" and len(chain) >= 2:
            yield (ev.line, f"item:{chain[-2]}",
                   f"{'.'.join(chain)}() forces a device sync in the "
                   f"pipelined serve zone")
            continue
        label = host_sync_label(fn, ev)
        if label is not None:
            yield (ev.line, label[len("host-sync:"):],
                   f"{'.'.join(chain)}() waits for the card inside the "
                   f"pipelined serve zone: the overlap is re-serialized "
                   f"here")
            continue
        arg0 = _first_arg_name(ev.node)
        if arg0 is not None and arg0 in tainted \
                and tuple(chain[-2:]) in _NP_CONVERTERS:
            yield (ev.line, f"asarray:{arg0}",
                   f"{'.'.join(chain)}({arg0}) reads a device value back "
                   f"in the pipelined serve zone; defer it to the "
                   f"completion stage's finish()")


def check_torch006(repo: RepoModel) -> List[Finding]:
    findings: List[Finding] = []
    for key, fn in repo.functions.items():
        rel = fn.module.relpath
        if in_pipelined_zone(rel):
            for line, evidence, message in _sync_findings(fn):
                findings.append(Finding(TORCH006.id, rel, line,
                                        fn.qualname, evidence, message))
            continue
        if not in_serve_zone(rel):
            continue
        for ev in fn.events:
            if ev.kind == "call" and tuple(ev.chain[-2:]) == (
                    "cuda", "synchronize"):
                findings.append(Finding(
                    TORCH006.id, rel, ev.line, fn.qualname,
                    "device_synchronize",
                    f"{'.'.join(ev.chain)}() waits for the whole device "
                    f"on a serve path: it invalidates a CUDA-graph "
                    f"capture in flight on another thread; synchronize "
                    f"the stream (device.synchronize)"))
    return findings
