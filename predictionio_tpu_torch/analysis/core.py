"""Analyzer core: AST facts extraction shared by every rule family.

The port's copy of `predictionio_tpu/analysis/core.py`. Pure ``ast``:
the analyzer never imports the code under analysis (it must be able to
lint a module whose import would start threads, touch storage or build
a kernel). One parse + one recursive walk per function produces an
ordered **event stream** (calls, lock acquisitions, attribute stores,
name loads) where every event carries the locks held at that point;
rules are then linear passes over the streams plus two small fixpoints
(may-acquire and may-block closures over the resolvable call graph).

Resolution is deliberately name-based and two-tier:

- tier A (high confidence): ``self.method`` within the defining class
  (single-inheritance chain included when the base is in-repo), plain
  names within the same module, ``mod.func`` through the import map,
  and nested ``def``s (conservatively assumed to run in their parent —
  the ``attempt()``-closure idiom the resilience layer uses).
- tier B (distinctive names, used only for hot-path reachability): a
  method name defined by at most ``TIER_B_MAX_IMPLS`` in-repo classes
  and absent from ``COMMON_METHOD_NAMES`` resolves to all of them.

Where the reference recognises ``jax.jit`` (its module "jitted" roster),
this core recognises the port's device programs: the module-level
functions a module hands to the executable registry (``dispatch``'s
fallback, or what a builder given to ``register`` returns), the compile
plane's entry points, and CUDA-graph captures.

Findings carry a line number for humans and a line-independent
``fingerprint`` (rule:path:symbol:evidence[#n]) for the baseline, so
accepted findings survive unrelated edits to the same file.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# -- rule registry ------------------------------------------------------

#: rule ids are API: the baseline and the docs key on them, and the
#: tests lint the ids themselves (family prefix + 3 digits, unique,
#: titled) so they stay stable.
RULE_ID_PATTERN = r"^(LOCK|TORCH|COST)[0-9]{3}$"


@dataclass(frozen=True)
class Rule:
    id: str
    title: str
    description: str


RULES: Dict[str, Rule] = {}


def register_rule(id: str, title: str, description: str) -> Rule:
    rule = Rule(id, title, description)
    if id in RULES:
        raise ValueError(f"duplicate rule id {id}")
    RULES[id] = rule
    return rule


@dataclass
class Finding:
    rule_id: str
    path: str            # repo-relative, forward slashes
    line: int
    symbol: str          # enclosing function qualname ("" = module)
    evidence: str        # the stable what ("os.fsync", attr name, ...)
    message: str
    occurrence: int = 0  # disambiguates same-evidence repeats

    @property
    def fingerprint(self) -> str:
        base = f"{self.rule_id}:{self.path}:{self.symbol}:{self.evidence}"
        return base if self.occurrence == 0 else f"{base}#{self.occurrence}"

    def to_dict(self) -> dict:
        return {"rule": self.rule_id, "path": self.path, "line": self.line,
                "symbol": self.symbol, "evidence": self.evidence,
                "message": self.message, "fingerprint": self.fingerprint}


def number_occurrences(findings: List[Finding]) -> List[Finding]:
    """Assign ``occurrence`` so identical (rule, path, symbol, evidence)
    repeats — two fsyncs in one function — fingerprint distinctly, in
    source order (stable as long as their relative order is)."""
    seen: Dict[str, int] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line)):
        key = f"{f.rule_id}:{f.path}:{f.symbol}:{f.evidence}"
        f.occurrence = seen.get(key, 0)
        seen[key] = f.occurrence + 1
    return findings


# -- call-chain + event model ------------------------------------------

def attr_chain(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """``self.wal.append`` -> ("self", "wal", "append"); None when any
    link is a call/subscript (those don't name a stable symbol)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


@dataclass
class Event:
    kind: str                 # call | acquire | selfstore | store | load
    line: int
    held: Tuple[str, ...]     # lock ids held at this point
    chain: Tuple[str, ...] = ()   # call: callee chain; store: value root
    node: Optional[ast.AST] = None
    name: str = ""            # selfstore/store/load: the target name
    held_src: Tuple[str, ...] = ()  # source names of held locks


@dataclass
class FunctionInfo:
    qualname: str             # "Class.method", "func" or "outer.<inner>"
    name: str
    module: "ModuleInfo"
    node: ast.AST
    class_name: Optional[str]
    parent: Optional[str]     # enclosing function qualname
    events: List[Event] = field(default_factory=list)
    params: Set[str] = field(default_factory=set)
    local_names: Set[str] = field(default_factory=set)
    nested: List[str] = field(default_factory=list)

    @property
    def key(self) -> str:
        return f"{self.module.relpath}::{self.qualname}"


@dataclass
class ClassInfo:
    name: str
    module: "ModuleInfo"
    bases: Tuple[str, ...]
    methods: Dict[str, str] = field(default_factory=dict)  # name -> key
    lock_attrs: Dict[str, str] = field(default_factory=dict)  # attr->kind
    thread_targets: Set[str] = field(default_factory=set)  # method names


@dataclass
class ModuleInfo:
    relpath: str
    tree: ast.Module
    imports: Dict[str, str] = field(default_factory=dict)  # alias->module
    module_locks: Dict[str, str] = field(default_factory=dict)  # name->kind
    #: module-level functions handed to the executable registry
    programs: Set[str] = field(default_factory=set)
    functions: List[str] = field(default_factory=list)     # top-level fns

    @property
    def basename(self) -> str:
        return os.path.basename(self.relpath)


_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}


def _lock_ctor_kind(value: ast.AST) -> Optional[str]:
    """``threading.Lock()`` / ``Lock()`` / ``threading.Condition(lk)``."""
    if not isinstance(value, ast.Call):
        return None
    chain = attr_chain(value.func)
    if not chain:
        return None
    if chain[-1] in _LOCK_CTORS and (
            len(chain) == 1 or chain[0] in ("threading", "_threading")):
        return _LOCK_CTORS[chain[-1]]
    return None


#: call tails that hand a program to the executable registry
#: (``AOTRegistry.dispatch(label, dims, fallback, *args)``) or register
#: a builder of one (``register(label, builder)``)
_DISPATCH_TAILS = {"dispatch"}
_REGISTER_TAILS = {"register"}

#: calls that capture a CUDA graph around a callable, with the position
#: of that callable (``compile/aot.capture(graph, fn, device)``,
#: ``GraphExecutable(fn, example_args)``, torch's own)
GRAPH_CAPTURE_CALLS = {"capture": 1, "GraphExecutable": 0,
                       "_make_executable": 0,
                       "make_graphed_callables": 0}
#: constructors and context managers of a CUDA graph
GRAPH_CTORS = {"CUDAGraph"}


def _tail(node: ast.AST) -> Optional[str]:
    """The terminal name of a call's callee, even through a call-rooted
    chain such as ``get_aot().dispatch``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _partial_target(node: ast.AST) -> Optional[str]:
    """``f`` for a Name ``f`` or a ``functools.partial(f, ...)``."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Call) and _tail(node.func) == "partial" \
            and node.args and isinstance(node.args[0], ast.Name):
        return node.args[0].id
    return None


def is_capture_call(chain: Tuple[str, ...]) -> bool:
    """A graph capture call: one of ``GRAPH_CAPTURE_CALLS``, with the
    compile plane's generic ``capture`` only as a bare name or through
    ``aot`` (``INCIDENTS.capture`` captures an incident, not a graph)."""
    if not chain or chain[-1] not in GRAPH_CAPTURE_CALLS:
        return False
    return chain[-1] != "capture" or len(chain) == 1 or chain[-2] == "aot"


def is_graph_with(expr: ast.AST) -> bool:
    """``torch.cuda.graph(g)`` as a ``with`` context: a capture."""
    return isinstance(expr, ast.Call) and \
        (attr_chain(expr.func) or ())[-2:] == ("cuda", "graph")


def program_roster(tree: ast.Module) -> Set[str]:
    """The module-level functions a module hands to the executable
    registry: the fallback program of a ``dispatch`` call (directly or
    through ``functools.partial``), and what a builder given to
    ``register`` wraps or returns. These are the port's counterparts of
    the reference's module-level jitted callables."""
    defs = {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    found: Set[str] = set()
    builders: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        tail = _tail(node.func)
        if tail in _DISPATCH_TAILS and len(node.args) >= 3:
            name = _partial_target(node.args[2])
            if name:
                found.add(name)
        elif tail in _REGISTER_TAILS and len(node.args) >= 2 \
                and isinstance(node.args[1], ast.Name):
            builders.add(node.args[1].id)
    for b in builders:
        node = defs.get(b)
        if node is None:
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and _tail(sub.func) == "partial":
                name = _partial_target(sub)
                if name:
                    found.add(name)
            elif isinstance(sub, ast.Return) \
                    and isinstance(sub.value, ast.Tuple) \
                    and sub.value.elts \
                    and isinstance(sub.value.elts[0], ast.Name):
                found.add(sub.value.elts[0].id)
    return {n for n in found if n in defs}


# -- device values and host syncs --------------------------------------

#: tensor methods that copy a device value to the host and wait for it
HOST_PULLS = ("item", "cpu", "numpy", "tolist")
HOST_CASTS = ("float", "int", "bool")
#: ``torch`` namespaces whose calls return host objects, not tensors
_HOST_NAMESPACES = {"cuda", "backends", "device", "dtype", "profiler",
                    "utils", "distributed", "Generator", "Size"}


def _root_and_tail(node: ast.AST
                   ) -> Tuple[Optional[str], Tuple[str, ...], Optional[str]]:
    """(root name, root-side attribute chain, outermost call tail) of an
    expression, followed through calls, attributes and subscripts:
    ``torch.from_numpy(a).to(dev)`` -> ("torch", ("torch", "from_numpy"),
    "to"). An outermost call that makes a host tensor reads as a host
    pull ("cpu")."""
    outer = _tail(node.func) if isinstance(node, ast.Call) else None
    chain: List[str] = []
    if isinstance(node, ast.Call) and _makes_host_tensor(node):
        outer = "cpu"
    while True:
        if isinstance(node, ast.Call):
            node = node.func
            chain = []
        elif isinstance(node, ast.Attribute):
            chain.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
            chain = []
        else:
            break
    if not isinstance(node, ast.Name):
        return None, (), outer
    return node.id, (node.id,) + tuple(reversed(chain)), outer


def _makes_host_tensor(call: ast.Call) -> bool:
    """A torch call whose result is a host tensor: a pinned buffer, one
    made on ``device="cpu"``, or ``torch.from_numpy`` not moved on."""
    for kw in call.keywords:
        if kw.arg == "pin_memory":
            return True
        if kw.arg == "device" and isinstance(kw.value, ast.Constant) \
                and kw.value.value == "cpu":
            return True
    return (attr_chain(call.func) or ())[-1:] == ("from_numpy",)


def _device_roots(mod: "ModuleInfo") -> Set[str]:
    roots = {"torch"}
    for alias, target in mod.imports.items():
        if target == "torch" or target.startswith("torch."):
            roots.add(alias)
    return roots


def device_tainted(fn: "FunctionInfo") -> Set[str]:
    """Locals holding a device value: assigned (tuple targets included)
    from a ``torch.*`` call or a program function, or derived from such
    a local by a call, attribute or subscript that is not itself a host
    pull. Flow-insensitive, memoized on the function."""
    cached = getattr(fn, "_tainted", None)
    if cached is not None:
        return cached
    roots = _device_roots(fn.module)
    programs = fn.module.programs
    stores: List[Tuple[List[str], str, Tuple[str, ...], Optional[str],
                       bool]] = []
    for node in _walk_skipping_callables(fn.node):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)) \
                or node.value is None:
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        names: List[str] = []
        for t in targets:
            if isinstance(t, ast.Name):
                names.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                names.extend(e.id for e in t.elts
                             if isinstance(e, ast.Name))
        root, chain, outer = _root_and_tail(node.value)
        if names and root is not None:
            stores.append((names, root, chain, outer,
                           isinstance(node.value, ast.Call)))
    out: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for names, root, chain, outer, is_call in stores:
            if outer in HOST_PULLS:
                continue
            if root in roots:
                if not is_call or (len(chain) > 1
                                   and chain[1] in _HOST_NAMESPACES) \
                        or (outer or "").startswith(("is_", "get_")):
                    continue
            elif root in programs:
                if not is_call:
                    continue
            elif root not in out:
                continue
            for n in names:
                if n not in out:
                    out.add(n)
                    changed = True
    fn._tainted = out
    return out


def host_sync_label(fn: "FunctionInfo", ev: "Event") -> Optional[str]:
    """``host-sync:...`` when a call event waits for the card: a
    ``.synchronize()`` (``torch.cuda``, an Event, a Stream), the port's
    ``device.synchronize``, a host pull (``.item()``, ``.cpu()``,
    ``.numpy()``, ``.tolist()``) of a device local, or a ``float()``/
    ``int()``/``bool()`` of one."""
    chain = ev.chain
    if not chain:
        return None
    name = chain[-1]
    if name == "synchronize":
        if len(chain) >= 2:
            return "host-sync:" + ".".join(chain)
        target = fn.module.imports.get(name, "")
        if target.endswith("device.synchronize"):
            return "host-sync:device.synchronize"
        return None
    if name in HOST_PULLS and len(chain) == 2 \
            and chain[0] in device_tainted(fn):
        return "host-sync:" + ".".join(chain)
    if len(chain) == 1 and name in HOST_CASTS \
            and isinstance(ev.node, ast.Call) and ev.node.args \
            and isinstance(ev.node.args[0], ast.Name) \
            and ev.node.args[0].id in device_tainted(fn):
        return f"host-sync:{name}:{ev.node.args[0].id}"
    return None


# -- per-function walk --------------------------------------------------

class _FunctionWalker:
    """Recursive statement walk producing the ordered event stream.

    Tracks the held-lock stack through ``with`` statements; nested
    ``def``/``lambda`` bodies are NOT walked here (each gets its own
    FunctionInfo) but are recorded so the call graph can add the
    conservative parent->nested edge.
    """

    def __init__(self, fn: FunctionInfo, scanner: "_ModuleScanner"):
        self.fn = fn
        self.scanner = scanner
        self.held: List[Tuple[str, str, str]] = []  # (id, kind, srcname)

    # lock id resolution for a with-context expression ------------------
    def _lock_of(self, expr: ast.AST) -> Optional[Tuple[str, str, str]]:
        """(lock_id, kind, source_name) when ``expr`` names a lock, or
        is ``timed_acquire(lock, probe)`` wrapping one."""
        if isinstance(expr, ast.Call):
            chain = attr_chain(expr.func)
            if chain and chain[-1] == "timed_acquire" and expr.args:
                inner = self._lock_of(expr.args[0])
                if inner is not None:
                    return inner
                src = self._src_name(expr.args[0])
                return (f"local:{src}", "lock", src) if src else None
            return None
        chain = attr_chain(expr)
        if chain is None:
            return None
        cls = self.scanner.current_class
        if len(chain) == 2 and chain[0] == "self" and cls is not None:
            kind = cls.lock_attrs.get(chain[1])
            if kind is not None:
                return (f"{cls.name}.{chain[1]}", kind, chain[1])
            return None
        if len(chain) == 1:
            kind = self.fn.module.module_locks.get(chain[0])
            if kind is not None:
                mod = os.path.splitext(self.fn.module.basename)[0]
                return (f"{mod}:{chain[0]}", kind, chain[0])
            if chain[0] in self.scanner.local_lock_names.get(
                    self.fn.key, set()):
                return (f"local:{chain[0]}", "lock", chain[0])
        return None

    @staticmethod
    def _src_name(expr: ast.AST) -> str:
        chain = attr_chain(expr)
        return chain[-1] if chain else ""

    # event emission ----------------------------------------------------
    def _emit(self, kind: str, line: int, **kw):
        self.fn.events.append(Event(
            kind=kind, line=line,
            held=tuple(h[0] for h in self.held),
            held_src=tuple(h[2] for h in self.held), **kw))

    # walk --------------------------------------------------------------
    def walk(self, body: Sequence[ast.stmt]):
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return                      # nested defs walked separately
        if isinstance(stmt, ast.ClassDef):
            return                      # function-local classes too
        if isinstance(stmt, ast.With):
            self._with(stmt)
            return
        self._expr_events(stmt)
        # recurse into compound statements' bodies with held preserved
        for attr in ("body", "orelse", "finalbody"):
            for child in getattr(stmt, attr, []) or []:
                if isinstance(child, ast.stmt):
                    self._stmt(child)
        for handler in getattr(stmt, "handlers", []) or []:
            for child in handler.body:
                self._stmt(child)

    def _expr_events(self, stmt: ast.stmt):
        """Emit call/store/load events for the statement's own
        expressions (compound bodies recurse via ``_stmt``)."""
        skip_bodies = ("body", "orelse", "finalbody", "handlers")
        if isinstance(stmt, (ast.If, ast.While)):
            roots: List[ast.AST] = [stmt.test]
        elif isinstance(stmt, ast.For):
            roots = [stmt.target, stmt.iter]
        elif isinstance(stmt, ast.Try):
            roots = []
        elif any(getattr(stmt, a, None) for a in skip_bodies):
            roots = [v for a, v in ast.iter_fields(stmt)
                     if a not in skip_bodies and isinstance(v, ast.AST)]
        else:
            roots = [stmt]
        for root in roots:
            for node in _walk_skipping_callables(root):
                self._node_event(node)

    def _node_event(self, node: ast.AST):
        line = getattr(node, "lineno", 0)
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain:
                self._emit("call", line, chain=chain, node=node)
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            value = node.value
            vchain = (attr_chain(value.func)
                      if isinstance(value, ast.Call) else None) or ()
            for t in targets:
                tc = attr_chain(t)
                if tc and len(tc) == 2 and tc[0] == "self":
                    self._emit("selfstore", line, name=tc[1],
                               chain=vchain, node=node)
                elif isinstance(t, ast.Name):
                    self.fn.local_names.add(t.id)
                    self._emit("store", line, name=t.id, chain=vchain,
                               node=node)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            self._emit("load", line, name=node.id)

    def _with(self, stmt: ast.With):
        acquired = []
        for item in stmt.items:
            lk = self._lock_of(item.context_expr)
            if lk is not None:
                self._emit("acquire", stmt.lineno, name=lk[2],
                           chain=(lk[0], lk[1]))
                self.held.append(lk)
                acquired.append(lk)
            else:
                # a non-lock context manager: still scan its expression
                for node in _walk_skipping_callables(item.context_expr):
                    self._node_event(node)
        for child in stmt.body:
            self._stmt(child)
        for _ in acquired:
            self.held.pop()


def _walk_skipping_callables(root: ast.AST):
    """``ast.walk`` minus nested ``def``/``lambda``/``class`` subtrees
    — their bodies belong to their own FunctionInfo's event stream, not
    the enclosing function's (marking the shared tree would blank the
    nested function's OWN walk). The root itself is always yielded."""
    yield root
    stack = [root]
    while stack:
        node = stack.pop()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            yield child
            stack.append(child)


def _immediate_nested_defs(fn_node: ast.AST) -> List[ast.AST]:
    """The ``def``s directly nested in ``fn_node``'s body (not the ones
    inside those, which recurse through their own FunctionInfo)."""
    found: List[ast.AST] = []

    def visit(n: ast.AST):
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                found.append(child)
            elif not isinstance(child, (ast.Lambda, ast.ClassDef)):
                visit(child)

    visit(fn_node)
    return found


def _immediate_nested_classes(fn_node: ast.AST) -> List[ast.ClassDef]:
    """Function-local ``class`` definitions (the HttpServer
    ``_make_handler`` -> ``_Handler`` idiom): analyzed as ordinary
    classes so their methods — e.g. the per-request ``_handle`` — are
    visible to every rule."""
    found: List[ast.ClassDef] = []

    def visit(n: ast.AST):
        for child in ast.iter_child_nodes(n):
            if isinstance(child, ast.ClassDef):
                found.append(child)
            elif not isinstance(child, (ast.Lambda, ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                visit(child)

    visit(fn_node)
    return found


# -- per-module scan ----------------------------------------------------

class _ModuleScanner:
    def __init__(self, mod: ModuleInfo, repo: "RepoModel"):
        self.mod = mod
        self.repo = repo
        self.current_class: Optional[ClassInfo] = None
        #: fn key -> local names assigned from a lock ctor (the
        #: ``lk = self._locks[k]`` nativelog idiom resolves via this
        #: only when the value is literally a Lock() call; dict-fetched
        #: locks resolve through timed_acquire or stay anonymous)
        self.local_lock_names: Dict[str, Set[str]] = {}

    def scan(self):
        self._module_level()
        for node in self.mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._function(node, qual=node.name, cls=None, parent=None)
            elif isinstance(node, ast.ClassDef):
                self._class(node)

    def _module_level(self):
        for node in self.mod.tree.body:
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.mod.imports[a.asname or a.name.split(".")[0]] = \
                        a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.mod.imports[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
            elif isinstance(node, ast.Assign):
                kind = _lock_ctor_kind(node.value)
                for t in node.targets:
                    if not isinstance(t, ast.Name):
                        continue
                    if kind is not None:
                        self.mod.module_locks[t.id] = kind
        self.mod.programs = program_roster(self.mod.tree)

    def _class(self, node: ast.ClassDef):
        bases = tuple(chain[-1] for chain in
                      (attr_chain(b) for b in node.bases) if chain)
        cls = ClassInfo(node.name, self.mod, bases)
        self.repo.classes.setdefault(node.name, []).append(cls)
        # first pass: lock attrs + methods (so with-resolution inside
        # any method sees attrs assigned in __init__ or elsewhere)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign):
                kind = _lock_ctor_kind(sub.value)
                if kind is None:
                    continue
                for t in sub.targets:
                    c = attr_chain(t)
                    if c and len(c) == 2 and c[0] == "self":
                        cls.lock_attrs[c[1]] = kind
        prev, self.current_class = self.current_class, cls
        for sub in node.body:
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{node.name}.{sub.name}"
                cls.methods[sub.name] = f"{self.mod.relpath}::{qual}"
                self._function(sub, qual=qual, cls=cls, parent=None)
        self.current_class = prev

    def _function(self, node, qual: str, cls: Optional[ClassInfo],
                  parent: Optional[str]):
        fn = FunctionInfo(qualname=qual, name=node.name, module=self.mod,
                          node=node,
                          class_name=cls.name if cls else None,
                          parent=parent)
        self.repo.functions[fn.key] = fn
        if parent is None and cls is None:
            self.mod.functions.append(fn.key)
        for a in (node.args.posonlyargs + node.args.args
                  + node.args.kwonlyargs):
            fn.params.add(a.arg)
        if node.args.vararg:
            fn.params.add(node.args.vararg.arg)
        if node.args.kwarg:
            fn.params.add(node.args.kwarg.arg)
        # pre-scan: local lock names
        locks = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and _lock_ctor_kind(sub.value):
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        locks.add(t.id)
        self.local_lock_names[fn.key] = locks
        saved_cls, self.current_class = self.current_class, cls
        walker = _FunctionWalker(fn, self)
        walker.walk(node.body)
        self.current_class = saved_cls
        for sub in _immediate_nested_defs(node):
            qual = f"{fn.qualname}.<{sub.name}>"
            fn.nested.append(f"{fn.module.relpath}::{qual}")
            self._function(sub, qual=qual, cls=cls, parent=fn.qualname)
        for cls_node in _immediate_nested_classes(node):
            self._class(cls_node)


# -- repo model ---------------------------------------------------------

#: method names too generic for tier-B name-based resolution — the
#: containers-and-protocols vocabulary that would wire the call graph
#: to everything
COMMON_METHOD_NAMES = frozenset({
    "append", "add", "get", "put", "pop", "insert", "update", "remove",
    "delete", "clear", "close", "open", "read", "write", "flush",
    "items", "keys", "values", "copy", "start", "stop", "join", "run",
    "send", "recv", "render", "wait", "set", "acquire", "release",
    "format", "split", "strip", "encode", "decode", "sort", "index",
    "count", "extend", "next", "result", "done", "cancel", "name",
    "with_", "to_dict", "from_dict", "stats", "collect", "match",
    "search", "sub", "group", "inc", "dec", "observe", "labels",
})

TIER_B_MAX_IMPLS = 3


class RepoModel:
    """Parsed repo + derived facts. ``root`` is the directory whose
    ``*.py`` files (recursively) are analyzed; paths in findings are
    relative to ``base`` (default: ``root``'s parent, so the real run
    reports ``predictionio_tpu_torch/...`` paths)."""

    def __init__(self, root: str, base: Optional[str] = None):
        self.root = os.path.abspath(root)
        self.base = os.path.abspath(base) if base else \
            os.path.dirname(self.root)
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, List[ClassInfo]] = {}
        self.parse_errors: List[Tuple[str, str]] = []
        #: call_edges memo, keyed by tier_b — several rules need the
        #: same graph, and tier-B resolution is the dominant
        #: post-parse cost
        self._edges: Dict[bool, Dict[str, Set[str]]] = {}
        self._scan()

    # -- parsing --------------------------------------------------------
    def _scan(self):
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__",))
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, self.base).replace(os.sep, "/")
                try:
                    with open(path, "r", encoding="utf-8") as f:
                        tree = ast.parse(f.read(), filename=rel)
                except (SyntaxError, UnicodeDecodeError) as e:
                    self.parse_errors.append((rel, str(e)))
                    continue
                mod = ModuleInfo(relpath=rel, tree=tree)
                self.modules[rel] = mod
        for mod in self.modules.values():
            _ModuleScanner(mod, self).scan()
        self._roster_threads()

    # -- thread roster --------------------------------------------------
    def _roster_threads(self):
        """``Thread(target=X)`` sites: mark X (a self-method or a
        nested def) as a background-thread entry point on its class."""
        self.thread_entries: Set[str] = set()   # function keys
        for fn in self.functions.values():
            for ev in fn.events:
                if ev.kind != "call" or ev.chain[-1] != "Thread":
                    continue
                call = ev.node
                target = None
                for kw in getattr(call, "keywords", []):
                    if kw.arg == "target":
                        target = kw.value
                if target is None:
                    continue
                tc = attr_chain(target)
                if not tc:
                    continue
                if len(tc) == 2 and tc[0] == "self" and fn.class_name:
                    for cls in self.classes.get(fn.class_name, []):
                        key = cls.methods.get(tc[1])
                        if key:
                            self.thread_entries.add(key)
                            cls.thread_targets.add(tc[1])
                elif len(tc) == 1:
                    # local nested def in this function
                    for nk in fn.nested:
                        if self.functions[nk].name == tc[0]:
                            self.thread_entries.add(nk)
                    # or a module-level function
                    mk = f"{fn.module.relpath}::{tc[0]}"
                    if mk in self.functions:
                        self.thread_entries.add(mk)

    # -- call graph -----------------------------------------------------
    def resolve_call(self, fn: FunctionInfo, chain: Tuple[str, ...],
                     tier_b: bool = False) -> List[str]:
        """Resolve a call chain to function keys (possibly empty)."""
        out: List[str] = []
        name = chain[-1]
        if len(chain) >= 2 and chain[0] == "self" and fn.class_name:
            if len(chain) == 2:
                for cls in self._mro(fn.class_name):
                    key = cls.methods.get(name)
                    if key:
                        return [key]
                return []
            # self.obj.method(...): falls through to tier B
        elif len(chain) == 1:
            # local nested def first, then module function, then import
            for nk in fn.nested:
                if self.functions[nk].name == name:
                    return [nk]
            mk = f"{fn.module.relpath}::{name}"
            if mk in self.functions:
                return [mk]
            target = fn.module.imports.get(name)
            if target:
                return self._import_target(target)
            return []
        elif len(chain) == 2 and chain[0] in fn.module.imports:
            return self._import_target(
                f"{fn.module.imports[chain[0]]}.{name}")
        elif len(chain) == 2 and chain[0] in self.classes:
            for cls in self._mro(chain[0]):
                key = cls.methods.get(name)
                if key:
                    return [key]
            return []
        if tier_b and name not in COMMON_METHOD_NAMES \
                and not name.startswith("__"):
            impls = [cls.methods[name]
                     for classes in self.classes.values()
                     for cls in classes if name in cls.methods]
            if 0 < len(impls) <= TIER_B_MAX_IMPLS:
                out.extend(impls)
        return out

    def _mro(self, class_name: str) -> Iterable[ClassInfo]:
        seen: Set[str] = set()
        stack = [class_name]
        while stack:
            cn = stack.pop(0)
            if cn in seen:
                continue
            seen.add(cn)
            for cls in self.classes.get(cn, []):
                yield cls
                stack.extend(b for b in cls.bases if b in self.classes)

    def _import_target(self, dotted: str) -> List[str]:
        """``predictionio_tpu_torch.obs.slo.timed_acquire`` -> its key, via
        the module path mapped onto analyzed relpaths."""
        parts = dotted.split(".")
        for split in range(len(parts) - 1, 0, -1):
            rel = "/".join(parts[:split]) + ".py"
            mod = self.modules.get(rel)
            if mod is None:
                continue
            name = parts[split]
            key = f"{rel}::{name}"
            if key in self.functions:
                return [key]
        return []

    def call_edges(self, tier_b: bool = False) -> Dict[str, Set[str]]:
        """fn key -> resolvable callee keys (+ conservative edges to
        nested defs, which run when the parent passes them somewhere).
        Memoized per tier."""
        cached = self._edges.get(tier_b)
        if cached is not None:
            return cached
        edges: Dict[str, Set[str]] = {}
        for key, fn in self.functions.items():
            out: Set[str] = set(fn.nested)
            for ev in fn.events:
                if ev.kind != "call":
                    continue
                out.update(self.resolve_call(fn, ev.chain, tier_b=tier_b))
            out.discard(key)
            edges[key] = out
        self._edges[tier_b] = edges
        return edges

    def closure(self, seed: Dict[str, Set[str]],
                edges: Dict[str, Set[str]]) -> Dict[str, Set[str]]:
        """Fixpoint: propagate ``seed`` sets backwards over call edges
        (caller inherits callees' sets). Used for may-acquire and
        may-block."""
        out = {k: set(v) for k, v in seed.items()}
        changed = True
        while changed:
            changed = False
            for caller, callees in edges.items():
                acc = out.setdefault(caller, set())
                before = len(acc)
                for c in callees:
                    acc.update(out.get(c, ()))
                if len(acc) != before:
                    changed = True
        return out

    def reachable(self, roots: Iterable[str],
                  edges: Dict[str, Set[str]],
                  max_depth: int = 8) -> Set[str]:
        seen: Set[str] = set()
        frontier = [(r, 0) for r in roots if r in self.functions]
        while frontier:
            key, d = frontier.pop()
            if key in seen or d > max_depth:
                continue
            seen.add(key)
            for c in edges.get(key, ()):
                frontier.append((c, d + 1))
        return seen
