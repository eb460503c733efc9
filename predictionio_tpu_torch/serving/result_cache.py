"""The serving result cache: a query's serialized response, invalidated by
the rows a fold touched.

The port's counterpart of `predictionio_tpu/serving/result_cache.py`
(`cache_enabled`, `strict_items`, `query_key`, `query_entities`,
`entity_tags`, `NS_SEP`, `ResultCache`), with the same keys, eviction
order and strict mode. Serving traffic repeats itself: a hot user asks for
the same ranking again and again, and between two model changes the
answer is a function of the query and the deployed models only. The cache
keeps the final response bytes of each canonical query, so a hit skips
the queue, the window, the device and the serialization, and the HTTP
layer writes the stored bytes as they are.

Invalidation: a fold's publish knows which user and item rows it
re-solved, so its hot swap drops only the entries registered under a
touched entity, and an untouched user's entry survives the swap byte for
byte. A model change whose touched set is unknown (`/reload`, a canary
promote, a swap without lineage) clears the whole cache. A fold leaves
untouched users' rows bit-equal, so a surviving entry is its own row's
answer; moved item rows can change an untouched user's ranking by at most
the touched rows' score changes. That is the documented staleness trade,
on by default and bounded by the fold cadence. `PIO_SERVE_CACHE=off` (or
`ServerConfig.result_cache=False`) disables the cache;
`PIO_SERVE_CACHE_STRICT=1` also drops every entry whose cached result
ranks a touched item.

Budget: entry and byte caps, LRU eviction, O(1) a lookup. `stats()`
carries the counters, and with a `metrics` registry (the engine
server's) they are also the reference's `pio_serve_cache_*` families.
The tenant-namespaced view (`TenantResultCache`) rides with the tenancy
plane.
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Dict, Iterable, List, Optional, Tuple

#: query fields that name cacheable entities, and the tag prefix their
#: values register under (the invalidation's join key)
_ENTITY_FIELDS = (("user", "user"), ("item", "item"), ("items", "item"))

#: namespace separator of tenant-prefixed keys and tags: a control
#: character no canonical query key or entity tag contains
NS_SEP = "\x1f"


def cache_enabled() -> bool:
    return os.environ.get("PIO_SERVE_CACHE", "").lower() not in (
        "off", "0", "false", "no")


def strict_items() -> bool:
    """Strict mode: entries whose cached result ranks a touched item are
    dropped too (exact freshness, broader invalidation)."""
    return os.environ.get("PIO_SERVE_CACHE_STRICT", "").lower() in (
        "1", "on", "true", "yes")


def query_key(query_dict: dict) -> Optional[str]:
    """The canonical cache key of one query body; None = uncacheable."""
    try:
        return json.dumps(query_dict, sort_keys=True,
                          separators=(",", ":"))
    except (TypeError, ValueError):
        return None


def query_entities(query_dict: dict) -> Tuple[str, ...]:
    """The entity tags a query's cached result registers under: the ids a
    fold names when it touches the entity."""
    tags: List[str] = []
    for field, prefix in _ENTITY_FIELDS:
        v = query_dict.get(field)
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            tags.extend(f"{prefix}:{x}" for x in v)
        else:
            tags.append(f"{prefix}:{v}")
    return tuple(tags)


def entity_tags(touched: Dict[str, Iterable]) -> List[str]:
    """{"user": ids, "item": ids} -> a flat tag list."""
    out: List[str] = []
    for kind, ids in (touched or {}).items():
        out.extend(f"{kind}:{i}" for i in ids)
    return out


class _Entry:
    __slots__ = ("body", "entities", "result_items", "nbytes", "raw")

    def __init__(self, body: bytes, entities: Tuple[str, ...],
                 result_items: Tuple[str, ...],
                 raw: Optional[bytes] = None):
        self.body = body
        self.entities = entities
        self.result_items = result_items
        self.nbytes = len(body)
        # the exact request bytes that stored this entry: a repeating
        # client sends the same bytes, so a lookup can skip the JSON parse
        self.raw = raw


class ResultCache:
    """A thread-safe LRU of serialized responses, indexed by entity tag
    so a fold's swap drops its touched entries in O(touched)."""

    def __init__(self, max_entries: int = 8192, max_bytes: int = 64 << 20,
                 metrics=None):
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, _Entry]" = \
            collections.OrderedDict()
        # exact request bytes -> canonical key, one alias an entry
        self._raw_alias: Dict[bytes, str] = {}
        # entity tag -> the keys whose entry registered it
        self._by_entity: Dict[str, set] = {}
        self._bytes = 0
        #: bumped by every invalidation: a caller reads it before it
        #: computes and passes it to put(), which refuses the store when
        #: an invalidation landed meanwhile (the result may be pre-swap)
        self.generation = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # dropped entries by reason (fold_swap, swap, reload, ...)
        self.invalidations: Dict[str, int] = {}
        if metrics is not None:
            self._register_metrics(metrics)

    def _register_metrics(self, metrics) -> None:
        """The reference's `pio_serve_cache_*` families, read from these
        counters at scrape time."""
        metrics.counter_func(
            "pio_serve_cache_hits_total",
            "Queries answered from the serving result cache (skipping "
            "batch formation, dispatch and serialization)",
            lambda: self.hits)
        metrics.counter_func(
            "pio_serve_cache_misses_total",
            "Cacheable queries that missed the result cache",
            lambda: self.misses)
        metrics.counter_func(
            "pio_serve_cache_invalidations_total",
            "Cache entries dropped by invalidation, by reason (fold_swap = "
            "touched-entity drop, others = whole-cache clears)",
            lambda: [({"reason": r}, n) for r, n in
                     sorted(self.invalidations.items())] or [(None, 0)])
        metrics.counter_func(
            "pio_serve_cache_evictions_total",
            "Entries evicted by the entry/byte budget (LRU)",
            lambda: self.evictions)
        metrics.gauge_func(
            "pio_serve_cache_entries",
            "Entries resident in the serving result cache",
            lambda: len(self._entries))
        metrics.gauge_func(
            "pio_serve_cache_bytes",
            "Serialized bytes resident in the serving result cache",
            lambda: self._bytes)

    # -- lookup and store --------------------------------------------------
    def get(self, key: Optional[str]) -> Optional[bytes]:
        if key is None:
            return None
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return e.body

    def get_raw(self, raw: bytes) -> Optional[bytes]:
        """The lookup by exact request bytes: two dict probes, no JSON
        parse. None on a miss, which is not counted (the caller falls
        back to the canonical key and counts the miss there)."""
        with self._lock:
            key = self._raw_alias.get(raw)
            if key is None:
                return None
            e = self._entries.get(key)
            if e is None:
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return e.body

    def put(self, key: Optional[str], body: bytes,
            entities: Tuple[str, ...],
            result_items: Tuple[str, ...] = (),
            generation: Optional[int] = None,
            raw: Optional[bytes] = None) -> bool:
        """Store one serialized response under its entity tags.
        `result_items`: the item ids it ranks (read in strict mode only).
        `generation`: the caller's reading of `generation` before it
        computed; a mismatch refuses the store. `raw`: the request bytes,
        the alias `get_raw` looks up. A body over a quarter of the byte
        budget is refused (one response must not evict the hot set)."""
        if key is None or len(body) > self.max_bytes // 4:
            return False
        with self._lock:
            if generation is not None and generation != self.generation:
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._unindex(key, old)
                self._bytes -= old.nbytes
            e = _Entry(bytes(body), entities, tuple(result_items),
                       raw=bytes(raw) if raw is not None else None)
            self._entries[key] = e
            self._bytes += e.nbytes
            if e.raw is not None:
                self._raw_alias[e.raw] = key
            for tag in entities:
                self._by_entity.setdefault(tag, set()).add(key)
            while (len(self._entries) > self.max_entries
                   or self._bytes > self.max_bytes):
                k, victim = self._entries.popitem(last=False)
                self._unindex(k, victim)
                self._bytes -= victim.nbytes
                self.evictions += 1
        return True

    def _unindex(self, key: str, e: _Entry) -> None:
        if e.raw is not None and self._raw_alias.get(e.raw) == key:
            self._raw_alias.pop(e.raw, None)
        for tag in e.entities:
            keys = self._by_entity.get(tag)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    self._by_entity.pop(tag, None)

    # -- invalidation ------------------------------------------------------
    def invalidate_entities(self, tags: Iterable[str],
                            reason: str = "fold_swap") -> int:
        """Drop the entries registered under any touched tag and, in
        strict mode, the entries whose result ranks a touched item (in
        the tag's namespace). Untouched entries are not visited outside
        strict mode. Returns the entries dropped."""
        tags = list(tags)
        strict = strict_items()
        # touched item ids by namespace ("" = keys without one)
        touched_by_ns: Dict[str, set] = {}
        if strict:
            for t in tags:
                ns, sep, rest = t.rpartition(NS_SEP)
                if rest.startswith("item:"):
                    touched_by_ns.setdefault(
                        ns + sep, set()).add(rest.split(":", 1)[1])
        with self._lock:
            self.generation += 1
            doomed = set()
            for tag in tags:
                doomed |= self._by_entity.get(tag, set())
            if touched_by_ns:
                for k, e in self._entries.items():
                    for nsp, items in touched_by_ns.items():
                        if nsp:
                            if not k.startswith(nsp):
                                continue
                        elif NS_SEP in k:
                            continue
                        if items.intersection(e.result_items):
                            doomed.add(k)
                            break
            for k in doomed:
                e = self._entries.pop(k, None)
                if e is None:
                    continue
                self._unindex(k, e)
                self._bytes -= e.nbytes
            if doomed:
                self.invalidations[reason] = \
                    self.invalidations.get(reason, 0) + len(doomed)
            return len(doomed)

    def invalidate_prefix(self, prefix: str, reason: str = "full") -> int:
        """Drop every entry whose key starts with `prefix` (one
        namespace's clear on a shared cache)."""
        with self._lock:
            self.generation += 1
            doomed = [k for k in self._entries if k.startswith(prefix)]
            for k in doomed:
                e = self._entries.pop(k, None)
                if e is None:
                    continue
                self._unindex(k, e)
                self._bytes -= e.nbytes
            if doomed:
                self.invalidations[reason] = \
                    self.invalidations.get(reason, 0) + len(doomed)
            return len(doomed)

    def invalidate_all(self, reason: str = "full") -> int:
        with self._lock:
            self.generation += 1
            n = len(self._entries)
            self._entries.clear()
            self._raw_alias.clear()
            self._by_entity.clear()
            self._bytes = 0
            if n:
                self.invalidations[reason] = \
                    self.invalidations.get(reason, 0) + n
            return n

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "maxEntries": self.max_entries,
                "maxBytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "hitRate": (self.hits / total if total else None),
                "evictions": self.evictions,
                "invalidations": dict(self.invalidations),
            }
