"""Fleet observability: the member registry, federation and trace
stitching across processes.

The port's copy of `predictionio_tpu/obs/fleet.py`. The event server,
the engine server and the fold scheduler run as separate OS processes;
this module lets the diagnostics plane see them as one system:

- **Member registry.** Each server or scheduler writes a JSON record
  under `base_dir()/fleet/` (role, pid, host, port, node, start time),
  refreshed by a heartbeat thread (`PIO_FLEET_HEARTBEAT_S`, 2 s by
  default). A member is live while its heartbeat is fresher than the
  liveness window (`PIO_FLEET_LIVENESS_S`, three beats) and, on the
  same node, its pid exists, so a SIGKILL shows before the window ends.
  A crash leaves its record: a dead member is reported dead, not
  forgotten. The records have the reference's layout, so members of
  either package read each other's.
- **Federation.** `federate_metrics()` scrapes every live member's
  `/metrics` and merges the expositions with `{role,pid}` as the first
  labels of every sample; `fleet_health()` rolls `/health.json` up
  worst-of per SLO; `fleet_traces(trace_id)` asks every member's
  `/traces.json?trace_id=` and stitches the span trees into one
  waterfall.
- **Event -> trace resolution.** `resolve_event_traces()` answers
  event id -> ingest trace id from peers' `/traces.json?event_ids=`, so
  a fold tick in its own process links the ingest traces the event
  server minted.

Surfaces: `GET /fleet/{status.json,metrics,traces.json,health.json}`
on both servers, and the CLI's `fleet {status,metrics,traces}`.
`PIO_FLEET=off` turns registration off. Everything here is fail-soft:
an unreachable member is a row in the report, never an exception on a
serving path.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

#: role names are path components of the record filename
_ROLE_RE = re.compile(r"^[a-zA-Z0-9_.-]{1,64}$")


def _off() -> bool:
    return os.environ.get("PIO_FLEET", "").strip().lower() in (
        "off", "0", "false")


def heartbeat_s() -> float:
    try:
        return max(0.2, float(os.environ.get("PIO_FLEET_HEARTBEAT_S",
                                             "2.0")))
    except (TypeError, ValueError):
        return 2.0


def liveness_window_s() -> float:
    """How stale a heartbeat may be before the member counts as dead.
    Default 3 heartbeats: one missed beat is scheduler jitter, three is
    a corpse (or a wedged process, which for GC/federation purposes is
    the same thing)."""
    try:
        return float(os.environ.get("PIO_FLEET_LIVENESS_S",
                                    str(3.0 * heartbeat_s())))
    except (TypeError, ValueError):
        return 3.0 * heartbeat_s()


def _node_name() -> str:
    try:
        return os.uname().nodename
    except (AttributeError, OSError):
        return "unknown"


def _pid_probe(pid) -> Optional[bool]:
    """Same-host pid existence; None when unknowable."""
    if not pid:
        return None
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True       # EPERM: exists, someone else's
    except (TypeError, ValueError):
        return None
    return True


class FleetRegistry:
    """Reader/writer over the ``base_dir()/fleet/`` member records.

    One instance per process is plenty (module singleton below); a
    process may register several members (an event server and an
    engine server sharing a test process register one record each,
    keyed ``<role>-<pid>``)."""

    def __init__(self, fleet_dir: Optional[str] = None):
        self._dir_override = fleet_dir
        self._lock = threading.Lock()
        # member_id -> (record, stop event, heartbeat thread) for the
        # members THIS process registered
        self._own: Dict[str, tuple] = {}

    def fleet_dir(self) -> str:
        if self._dir_override:
            return self._dir_override
        env = os.environ.get("PIO_FLEET_DIR")
        if env:
            return env
        from predictionio_tpu_torch.data.storage.registry import base_dir
        return os.path.join(base_dir(), "fleet")

    # -- registration ---------------------------------------------------
    def _path(self, member_id: str) -> str:
        return os.path.join(self.fleet_dir(), member_id + ".json")

    def _write_record(self, rec: dict):
        """Crash-atomic (temp + replace): a reader never sees a torn
        record, and a crash between beats leaves the previous one."""
        path = self._path(rec["memberId"])
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(rec, f, separators=(",", ":"))
        os.replace(tmp, path)

    def register(self, role: str, port: Optional[int] = None,
                 host: Optional[str] = None,
                 stats: Optional[bool] = None,
                 extra: Optional[dict] = None) -> Optional[str]:
        """Write this process's member record and start its heartbeat.
        Returns the member id, or None when fleet registration is off
        or the record cannot be written (fail-soft: a server must
        start even on a read-only base_dir)."""
        if _off():
            return None
        if not _ROLE_RE.match(role or ""):
            logger.warning("fleet: bad role %r; not registering", role)
            return None
        member_id = f"{role}-{os.getpid()}"
        rec = {
            "memberId": member_id, "role": role, "pid": os.getpid(),
            "host": (host if host and host != "0.0.0.0" else None)
            or "127.0.0.1",
            "port": int(port) if port else None,
            # the writer's node identity: the pid probe in _is_alive
            # only runs when the READER is on the same node — a pid
            # from a sibling container / NFS peer lives in another pid
            # namespace and probing it there would falsely kill a
            # member with a perfectly fresh heartbeat
            "node": _node_name(),
            "startedAt": time.time(), "heartbeatAt": time.time(),
        }
        if rec["port"]:
            # the advertised URL, recorded once at bind time, so
            # routing and federation read the address off the record
            rec["url"] = f"http://{rec['host']}:{rec['port']}"
        if stats is not None:
            rec["stats"] = bool(stats)
        if extra:
            rec.update(extra)
        try:
            os.makedirs(self.fleet_dir(), exist_ok=True)
            self._write_record(rec)
        except OSError:
            logger.warning("fleet: cannot write member record under %s",
                           self.fleet_dir(), exc_info=True)
            return None
        stop = threading.Event()
        # the beat thread shares THIS rec dict (not a copy): roster
        # updates via update_member land in the next heartbeat too
        t = threading.Thread(target=self._beat_loop,
                             args=(rec, stop), daemon=True,
                             name=f"pio-fleet-beat-{role}")
        with self._lock:
            # re-registering a role (server restart inside one process)
            # retires the previous beat thread first
            old = self._own.pop(member_id, None)
            self._own[member_id] = (rec, stop, t)
        if old is not None:
            old[1].set()
            old[2].join(timeout=2.0)   # its last write must not
            #                            clobber the fresh record
        t.start()
        self._prune_stale()
        return member_id

    def _beat_loop(self, rec: dict, stop: threading.Event):
        while not stop.wait(heartbeat_s()):
            # snapshot under the registry lock: update_member mutates
            # the shared rec concurrently, and json.dump over a dict
            # changing size would tear the write
            with self._lock:
                rec["heartbeatAt"] = time.time()
                snap = dict(rec)
            try:
                self._write_record(snap)
            except OSError:
                # a full/readonly disk must not kill the member; the
                # stale heartbeat honestly reports it as unhealthy
                logger.debug("fleet heartbeat write failed",
                             exc_info=True)

    def update_member(self, member_id: Optional[str],
                      extra: dict) -> bool:
        """Merge ``extra`` into an own member record and re-publish it
        immediately (the next heartbeat carries it too, since the beat
        thread shares the dict). The serving host updates its tenant
        roster here on every admit/remove/pin: the roster must be
        readable off the record of a member that later dies without
        warning — a corpse record is the failover controller's ONLY
        source for which tenants the dead host was carrying."""
        if not member_id or not extra:
            return False
        with self._lock:
            own = self._own.get(member_id)
            if own is None:
                return False
            rec = own[0]
            rec.update(extra)
            rec["heartbeatAt"] = time.time()
            snap = dict(rec)
        try:
            self._write_record(snap)
        except OSError:
            logger.debug("fleet member update write failed",
                         exc_info=True)
        return True

    def deregister(self, member_id: Optional[str]):
        """Stop the heartbeat and remove the record (clean shutdown —
        a crash leaves the record, which is the point). The beat
        thread is JOINED before the remove: a beat mid-_write_record
        would otherwise os.replace the file back into existence after
        the remove, and a cleanly-stopped member would read UP then
        DEAD for the whole liveness window."""
        if not member_id:
            return
        with self._lock:
            own = self._own.pop(member_id, None)
        if own is not None:
            own[1].set()
            own[2].join(timeout=2.0)
        try:
            os.remove(self._path(member_id))
        except OSError:
            pass

    def _prune_stale(self, max_dead_s: float = 3600.0):
        """Opportunistically drop records dead for over an hour (run at
        register time): yesterday's crashes should not clutter today's
        ``pio fleet status`` forever, but a fresh corpse stays visible
        for the whole forensic window."""
        now = time.time()
        for m in self._read_records():
            if now - float(m.get("heartbeatAt") or 0) > max_dead_s:
                try:
                    os.remove(self._path(m["memberId"]))
                except OSError:
                    pass

    # -- reads ----------------------------------------------------------
    def _read_records(self) -> List[dict]:
        d = self.fleet_dir()
        out = []
        try:
            names = sorted(os.listdir(d))
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, name), encoding="utf-8") as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            if isinstance(rec, dict) and rec.get("memberId"):
                out.append(rec)
        return out

    @staticmethod
    def _is_alive(rec: dict, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        beat = float(rec.get("heartbeatAt") or 0.0)
        if now - beat > liveness_window_s():
            return False
        # heartbeat fresh — but a SIGKILL leaves a fresh-looking beat
        # for up to the window; the SAME-NODE pid probe closes that
        # gap. Scoped by the writer's node identity, never the host
        # field: a sibling container or NFS peer sharing base_dir
        # lives in another pid namespace, and probing its pid here
        # would falsely kill a member whose heartbeat is the truth.
        # Records without a node (foreign writers) get heartbeat-only.
        if rec.get("node") == _node_name():
            probe = _pid_probe(rec.get("pid"))
            if probe is False:
                return False
        return True

    def members(self, include_dead: bool = True) -> List[dict]:
        """Every member record, annotated with ``alive`` and ``ageS``
        (seconds since the last heartbeat)."""
        now = time.time()
        out = []
        for rec in self._read_records():
            m = dict(rec)
            m["alive"] = self._is_alive(rec, now)
            m["ageS"] = round(now - float(rec.get("heartbeatAt") or 0.0),
                              3)
            if m["alive"] or include_dead:
                out.append(m)
        return out

    def live_members(self) -> List[dict]:
        return self.members(include_dead=False)

    def pid_status(self, pid) -> str:
        """``live`` / ``dead`` / ``unknown`` per the registry — the
        real liveness the flight GC and incident capture use instead
        of mtime/os.kill guessing. A pid with a member record is
        definitively live or dead (pid REUSE by an unrelated process
        cannot resurrect a dead member); a pid the registry never saw
        is unknown and callers fall back to their old probe."""
        if pid is None:
            return "unknown"
        try:
            pid = int(pid)
        except (TypeError, ValueError):
            return "unknown"
        status = "unknown"
        now = time.time()
        for rec in self._read_records():
            if rec.get("pid") == pid:
                if self._is_alive(rec, now):
                    return "live"
                status = "dead"
        return status


# The process-wide registry handle.
FLEET = FleetRegistry()


def get_fleet() -> FleetRegistry:
    return FLEET


def register_member(role: str, port: Optional[int] = None,
                    host: Optional[str] = None,
                    stats: Optional[bool] = None,
                    extra: Optional[dict] = None) -> Optional[str]:
    return FLEET.register(role, port=port, host=host, stats=stats,
                          extra=extra)


def deregister_member(member_id: Optional[str]):
    FLEET.deregister(member_id)


def update_member(member_id: Optional[str], extra: dict) -> bool:
    return FLEET.update_member(member_id, extra)


def member_url(m: dict) -> Optional[str]:
    # prefer the URL the member advertised at bind time; derive it
    # for records written without one
    url = m.get("url")
    if url:
        return str(url).rstrip("/")
    if not m.get("port"):
        return None
    return f"http://{m.get('host') or '127.0.0.1'}:{m['port']}"


def _scrapeable(members: List[dict]) -> List[dict]:
    return [m for m in members if m.get("port")]


def _fetch_all(members: List[dict], fn) -> List[tuple]:
    """Run ``fn(member)`` for every member CONCURRENTLY, preserving
    order: one wedged member costs max(timeout), not sum — a
    Prometheus scrape of /fleet/metrics must not serialize 3s
    timeouts across a fleet with a dead switch port in it."""
    if not members:
        return []
    if len(members) == 1:
        return [(members[0], fn(members[0]))]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(min(8, len(members))) as ex:
        return list(zip(members, ex.map(fn, members)))


# -- metrics federation -------------------------------------------------

def _find_close_brace(s: str, start: int) -> int:
    """Index of the label-section closing brace, quote- and
    escape-aware (a label VALUE may legally contain ``}``)."""
    in_q = False
    esc = False
    for i in range(start, len(s)):
        c = s[i]
        if esc:
            esc = False
            continue
        if c == "\\":
            esc = True
            continue
        if c == '"':
            in_q = not in_q
            continue
        if c == "}" and not in_q:
            return i
    return -1


def _esc_label(v: str) -> str:
    # the ONE label-value escaper (utils/prometheus): federated
    # relabeled samples must escape exactly like locally-rendered ones
    from predictionio_tpu_torch.utils.prometheus import _escape
    return _escape(v)


def _inject_labels(line: str, extra: Dict[str, str]) -> Optional[str]:
    """Rewrite one sample line with ``extra`` as its FIRST labels.
    None when the line does not parse as a sample."""
    pairs = ",".join(f'{k}="{_esc_label(v)}"' for k, v in extra.items())
    brace = line.find("{")
    space = line.find(" ")
    if brace != -1 and (space == -1 or brace < space):
        close = _find_close_brace(line, brace + 1)
        if close == -1:
            return None
        inner = line[brace + 1:close]
        merged = pairs + ("," + inner if inner else "")
        return line[:brace] + "{" + merged + "}" + line[close + 1:]
    if space == -1:
        return None
    return line[:space] + "{" + pairs + "}" + line[space:]


_SAMPLE_NAME_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)")
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _parse_scrape(text: str):
    """Parse one classic-format exposition into ordered families:
    ``[(name, type, help, [sample lines])]``. Tolerant of families
    without HELP; sample lines that belong to no declared family (a
    bare gauge from a foreign exporter) become an implicit untyped
    family of their own."""
    families: Dict[str, dict] = {}
    order: List[str] = []

    def fam(name: str) -> dict:
        f = families.get(name)
        if f is None:
            f = families[name] = {"type": "untyped", "help": name,
                                  "lines": []}
            order.append(name)
        return f

    current: Optional[str] = None
    for line in text.splitlines():
        line = line.rstrip()
        if not line:
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_ = rest.partition(" ")
            fam(name)["help"] = help_ or name
            current = name
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE "):]
            name, _, mtype = rest.partition(" ")
            fam(name)["type"] = (mtype or "untyped").strip()
            current = name
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_NAME_RE.match(line)
        if m is None:
            continue
        sample = m.group(1)
        owner = None
        if current is not None and (
                sample == current
                or (sample.startswith(current)
                    and sample[len(current):] in _HIST_SUFFIXES)):
            owner = current
        else:
            owner = sample
            current = sample
        fam(owner)["lines"].append(line)
    return [(n, families[n]["type"], families[n]["help"],
             families[n]["lines"]) for n in order]


def federate_metrics(members: Optional[List[dict]] = None,
                     timeout_s: float = 3.0) -> str:
    """One merged classic-format exposition over every live member's
    ``/metrics``: each sample re-labeled with ``{role,pid}`` first, so
    co-located and remote processes' same-named families become
    distinct, lint-clean series; HELP/TYPE emitted once per family. A
    family a later member declares with a CLASHING type is dropped for
    that member (and noted in a comment) rather than poisoning the
    scrape. A synthesized ``pio_fleet_member_up`` gauge reports which
    members answered; the exposition degrades to that alone when no
    member is scrapeable."""
    from predictionio_tpu_torch.utils.http import fetch_text
    if members is None:
        members = get_fleet().live_members()
    families: Dict[str, dict] = {}
    order: List[str] = []
    notes: List[str] = []
    up: List[str] = []
    scrapes = _fetch_all(
        _scrapeable(members),
        lambda m: fetch_text(member_url(m) + "/metrics",
                             timeout=timeout_s))
    for m, text in scrapes:
        extra = {"role": str(m.get("role")), "pid": str(m.get("pid"))}
        pairs = ",".join(f'{k}="{_esc_label(v)}"'
                         for k, v in extra.items())
        up.append(f"pio_fleet_member_up{{{pairs}}} "
                  f"{1 if text is not None else 0}")
        if text is None:
            notes.append(f"# fleet: {m.get('memberId')} unreachable or "
                         "gated (launch the event server with --stats "
                         "to federate it)")
            continue
        for name, mtype, help_, lines in _parse_scrape(text):
            f = families.get(name)
            if f is None:
                f = families[name] = {"type": mtype, "help": help_,
                                      "lines": []}
                order.append(name)
            elif f["type"] != mtype:
                notes.append(
                    f"# fleet: dropped {name} from "
                    f"{m.get('memberId')} ({mtype} clashes with "
                    f"{f['type']})")
                continue
            for line in lines:
                out = _inject_labels(line, extra)
                if out is not None:
                    f["lines"].append(out)
    chunks = [
        "# HELP pio_fleet_member_up 1 when the member answered the "
        "federated scrape, 0 when live-but-unreachable",
        "# TYPE pio_fleet_member_up gauge",
    ] + up
    for name in order:
        f = families[name]
        chunks.append(f"# HELP {name} {f['help']}")
        chunks.append(f"# TYPE {name} {f['type']}")
        chunks.extend(f["lines"])
    chunks.extend(notes)
    return "\n".join(chunks) + "\n"


def merge_scrapes(parts: List[tuple]) -> str:
    """Merge locally-rendered expositions into one classic-format
    scrape: ``parts`` is ``[(text, extra_labels_dict), ...]``; each
    part's samples get its extras injected as FIRST labels (an empty
    dict injects nothing), HELP/TYPE emitted once per family, clashing
    types dropped with a comment — the same discipline as
    ``federate_metrics`` but without HTTP (a multi-tenant host publishes
    each slot's registry under a ``tenant`` label this way)."""
    families: Dict[str, dict] = {}
    order: List[str] = []
    notes: List[str] = []
    for text, extra in parts:
        if not text:
            continue
        for name, mtype, help_, lines in _parse_scrape(text):
            f = families.get(name)
            if f is None:
                f = families[name] = {"type": mtype, "help": help_,
                                      "lines": []}
                order.append(name)
            elif f["type"] != mtype:
                notes.append(f"# merge: dropped {name} "
                             f"({mtype} clashes with {f['type']})")
                continue
            if not extra:
                f["lines"].extend(lines)
                continue
            for line in lines:
                out = _inject_labels(line, extra)
                if out is not None:
                    f["lines"].append(out)
    chunks = []
    for name in order:
        f = families[name]
        chunks.append(f"# HELP {name} {f['help']}")
        chunks.append(f"# TYPE {name} {f['type']}")
        chunks.extend(f["lines"])
    chunks.extend(notes)
    return "\n".join(chunks) + "\n"


# -- status / health / trace federation ---------------------------------

def fleet_status(members: Optional[List[dict]] = None,
                 registry: Optional[FleetRegistry] = None) -> dict:
    """The ``pio fleet status`` / ``GET /fleet/status.json`` body.
    ``registry`` names the registry the members came from, so a
    ``--dir`` override reports ITS path, not the default's."""
    if registry is None:
        registry = get_fleet()
    if members is None:
        members = registry.members()
    return {
        "fleetDir": registry.fleet_dir(),
        "heartbeatS": heartbeat_s(),
        "livenessWindowS": liveness_window_s(),
        "alive": sum(1 for m in members if m.get("alive")),
        "dead": sum(1 for m in members if not m.get("alive")),
        "members": members,
    }


_SEVERITY = {"breached": 4, "burning": 3, "unreachable": 2,
             "no_data": 1, "ok": 0}


def _worse(a: Optional[str], b: Optional[str]) -> str:
    a = a or "no_data"
    b = b or "no_data"
    return a if _SEVERITY.get(a, 0) >= _SEVERITY.get(b, 0) else b


def fleet_health(members: Optional[List[dict]] = None,
                 timeout_s: float = 3.0) -> dict:
    """Worst-of SLO rollup across every live member's ``/health.json``:
    one breached serve-p99 anywhere breaches the fleet. Per-SLO rows
    carry the per-member verdicts so the operator sees WHICH process
    is burning; unreachable members degrade the overall status to
    ``unreachable`` (never silently drop)."""
    from predictionio_tpu_torch.utils.http import fetch_json
    if members is None:
        members = get_fleet().live_members()
    overall = "ok"
    slos: Dict[str, dict] = {}
    rows = []
    fetched = _fetch_all(
        _scrapeable(members),
        lambda m: fetch_json(member_url(m) + "/health.json",
                             timeout=timeout_s))
    for m, body in fetched:
        mid = m.get("memberId")
        if not isinstance(body, dict) or "error" in body:
            rows.append({"memberId": mid, "status": "unreachable",
                         "error": (body or {}).get("error")})
            overall = _worse(overall, "unreachable")
            continue
        status = body.get("status") or "no_data"
        rows.append({"memberId": mid, "status": status})
        overall = _worse(overall, status)
        for s in body.get("slo") or ():
            name = s.get("name")
            if not name:
                continue
            agg = slos.get(name)
            if agg is None:
                agg = slos[name] = {"name": name, "kind": s.get("kind"),
                                    "status": s.get("status"),
                                    "members": {}}
            agg["status"] = _worse(agg["status"], s.get("status"))
            agg["members"][mid] = {
                k: s.get(k) for k in ("status", "burnFast", "burnSlow",
                                      "rateFast", "value", "eventsFast")
                if s.get(k) is not None}
    return {"status": overall, "members": rows,
            "slo": sorted(slos.values(), key=lambda s: s["name"])}


def fleet_traces(trace_id: str,
                 members: Optional[List[dict]] = None,
                 limit: int = 50, timeout_s: float = 3.0) -> dict:
    """Resolve ``trace_id`` fleet-wide: query every live member's
    ``/traces.json?trace_id=`` (the trace + its linked neighborhood,
    per process) and stitch the results into one waterfall — traces
    de-duplicated by (pid, traceId) so two co-located servers sharing
    one process tracer contribute one copy, each stamped with the
    member that served it, ordered by start time. ``pids`` names the
    distinct OS processes in the stitched story — the assertion the
    two-process acceptance test makes."""
    from predictionio_tpu_torch.utils.http import fetch_json
    if members is None:
        members = get_fleet().live_members()
    out: List[dict] = []
    seen = set()
    queried = []
    fetched = _fetch_all(
        _scrapeable(members),
        lambda m: fetch_json(
            f"{member_url(m)}/traces.json?trace_id={trace_id}"
            f"&n={int(limit)}", timeout=timeout_s))
    for m, body in fetched:
        ok = isinstance(body, dict) and "traces" in body
        queried.append({"memberId": m.get("memberId"), "ok": ok,
                        **({} if ok else
                           {"error": (body or {}).get("error")
                            or (body or {}).get("message")})})
        if not ok:
            continue
        for t in body["traces"]:
            key = (t.get("pid"), t.get("traceId"), t.get("kind"))
            if key in seen:
                continue
            seen.add(key)
            out.append(dict(t, member={
                "memberId": m.get("memberId"),
                "role": m.get("role"), "pid": m.get("pid")}))
    out.sort(key=lambda t: t.get("start") or 0.0)
    return {"traceId": trace_id,
            "pids": sorted({t.get("pid") for t in out
                            if t.get("pid") is not None}),
            "members": queried, "traces": out}


def resolve_event_traces(event_ids, members: Optional[List[dict]] = None,
                         timeout_s: float = 2.0) -> Dict[str, str]:
    """event_id -> ingest trace id, resolved locally first, then via
    peers' ``/traces.json?event_ids=`` (the fold tick's cross-process
    link source). Only members in OTHER processes are
    queried — co-located servers share this process's tracer, so a
    local miss cannot resolve over a loopback hop."""
    from predictionio_tpu_torch.obs.trace import TRACER
    from predictionio_tpu_torch.utils.http import fetch_json
    out: Dict[str, str] = {}
    missing = []
    for eid in event_ids:
        tid = TRACER.trace_id_for_event(eid)
        if tid:
            out[str(eid)] = tid
        else:
            missing.append(str(eid))
    if not missing or _off():
        return out
    if members is None:
        members = get_fleet().live_members()
    peers = [m for m in _scrapeable(members)
             if m.get("pid") != os.getpid()]
    for m in peers:
        if not missing:
            break
        qs = ",".join(missing[:1024])
        body = fetch_json(
            f"{member_url(m)}/traces.json?event_ids={qs}",
            timeout=timeout_s)
        got = (body or {}).get("eventTraces") \
            if isinstance(body, dict) else None
        if not got:
            continue
        out.update(got)
        missing = [e for e in missing if e not in got]
    return out


# -- HTTP handler bodies (shared by both servers) ------------------------

def fleet_status_response(params: dict) -> dict:
    return fleet_status()


def fleet_metrics_response(params: dict) -> str:
    return federate_metrics()


def fleet_health_response(params: dict) -> dict:
    return fleet_health()


def fleet_traces_response(params: dict) -> dict:
    trace_id = params.get("trace_id") or params.get("traceId")
    if not trace_id:
        raise ValueError("trace_id is required (the fleet view stitches "
                         "ONE trace; per-process rings stay at "
                         "/traces.json)")
    limit = int(params.get("n", params.get("limit", 50)))
    return fleet_traces(trace_id, limit=limit)
