"""Helpers of the diagnostics-plane parity tests (`test_torch_obs_*.py`):
what is left of a trace, record or bundle once the ids, times and pids
that each process mints are taken out, and the duration checks."""

import itertools

#: keys whose values each run mints: times, span ids, pids
MINTED = frozenset({"start", "durationMs", "t", "ts", "pid", "spanId",
                    "capturedAt", "seq", "wallS", "spentS", "overheadPct",
                    "totalMs", "ms", "id", "incidentsDir", "dir",
                    "traceFile"})
#: keys that hold trace ids
TRACE_ID_KEYS = frozenset({"traceId", "batchTraceId", "trace_id"})


class FakeTime:
    """A module stand-in for `time` whose clocks advance one millisecond a
    read, so both packages see the same sequence of readings."""

    def __init__(self):
        self._n = itertools.count(1)

    def _tick(self):
        return next(self._n) * 1e-3

    def time(self):
        return 1.7e9 + self._tick()

    def perf_counter(self):
        return self._tick()

    def monotonic(self):
        return self._tick()

    def sleep(self, s):
        pass


def canon(obj, ids: dict):
    """`obj` with each trace id replaced by its name in `ids` (an id not
    in it by "T?") and the minted keys taken out."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in MINTED:
                continue
            if k in TRACE_ID_KEYS:
                out[k] = ids.get(v, "T?")
            elif k == "links":
                out[k] = [ids.get(x, "T?") for x in v]
            elif k in ("eventTraces", "traceIds"):
                out[k] = canon_ids(v, ids)
            else:
                out[k] = canon(v, ids)
        return out
    if isinstance(obj, (list, tuple)):
        return [canon(x, ids) for x in obj]
    if isinstance(obj, str) and obj in ids:
        return ids[obj]
    return obj


def canon_ids(v, ids):
    if isinstance(v, dict):
        return {k: ids.get(x, "T?") for k, x in v.items()}
    return [ids.get(x, "T?") for x in v]


def check_durations(node: dict, parent: dict = None, slack_ms=1.0):
    """Every span's duration is non-negative and lies inside its
    parent's (start and end, within `slack_ms` of clock skew)."""
    d = node.get("durationMs")
    assert d is not None and d >= 0, node
    if parent is not None:
        s0, d0 = parent["start"] * 1e3, parent["durationMs"]
        s1 = node["start"] * 1e3
        assert s1 >= s0 - slack_ms, (node, parent)
        assert s1 + d <= s0 + d0 + slack_ms, (node, parent)
    for child in node.get("children", ()):
        check_durations(child, node, slack_ms)
