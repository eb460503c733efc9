"""Placement planning: pure decisions over a fleet's tenants.

The port's copy of `predictionio_tpu/tenancy/placement.py`, with the same
decisions: the planner half of the fleet's control plane, free of clocks,
HTTP and storage, so every decision is a function of its inputs. Given
hosts with HBM budgets and tenants with footprints (the budget's padded
estimate), priorities and traffic (the signals' EWMA), where does each
tenant go? In order:

1. Feasibility: a tenant lands only where its footprint fits the host's
   free budget (a host without a budget always fits).
2. Priority before heat: pending tenants are placed highest priority
   first, then largest first.
3. Spread: among the hosts it fits, the one with the most free bytes
   (then fewest tenants, then least traffic, then member id).
4. Pre-emption last: when nothing fits, lower-priority unpinned tenants
   of one host, coldest first, may be displaced (they are queued again,
   once), on the host where the fewest must go.
5. An honest refusal: a tenant that fits nowhere gets a `refuse`
   decision with its reason.

Every decision is a `Decision` the controller records as it is.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class TenantView:
    """One tenant as the planner sees it: identity + engine coords
    (enough to re-admit from registry lineage) + placement signals."""
    key: str
    hbm_bytes: int = 0
    priority: int = 0
    pinned: bool = False
    traffic_ewma: float = 0.0
    burn_fast: float = 0.0
    slo_status: str = "no_data"
    engine_id: str = ""
    engine_version: str = "0"
    engine_variant: str = "engine.json"
    engine_instance_id: str = ""
    generation: int = 0
    scheduler: Optional[dict] = None


@dataclass
class HostView:
    """One serving host: budget + current residents. ``budget_bytes``
    None means unbounded (a dev host without PIO_HBM_BUDGET)."""
    member_id: str
    url: str = ""
    budget_bytes: Optional[int] = None
    alive: bool = True
    tenants: Dict[str, TenantView] = field(default_factory=dict)

    def used_bytes(self) -> int:
        return sum(t.hbm_bytes for t in self.tenants.values())

    def free_bytes(self) -> Optional[int]:
        if self.budget_bytes is None:
            return None
        return self.budget_bytes - self.used_bytes()

    def fits(self, t: TenantView) -> bool:
        free = self.free_bytes()
        return free is None or t.hbm_bytes <= free


@dataclass(frozen=True)
class Decision:
    """One planned action. ``action`` is one of:

    - ``admit``   — place ``tenant`` on ``host``
    - ``migrate`` — move ``tenant`` from ``from_host`` to ``host``
    - ``preempt`` — evict ``tenant`` from ``from_host`` to make room
                    (paired with a later admit/refuse for the evictee)
    - ``refuse``  — no feasible host; ``reason`` says why
    """
    action: str
    tenant: str
    host: Optional[str] = None
    from_host: Optional[str] = None
    reason: str = ""

    def as_dict(self) -> dict:
        d = {"action": self.action, "tenant": self.tenant}
        if self.host:
            d["host"] = self.host
        if self.from_host:
            d["fromHost"] = self.from_host
        if self.reason:
            d["reason"] = self.reason
        return d


@dataclass
class PlacementPlan:
    decisions: List[Decision] = field(default_factory=list)

    @property
    def admits(self) -> List[Decision]:
        return [d for d in self.decisions if d.action == "admit"]

    @property
    def refusals(self) -> List[Decision]:
        return [d for d in self.decisions if d.action == "refuse"]

    def as_dict(self) -> dict:
        return {"decisions": [d.as_dict() for d in self.decisions]}


def _pick_host(hosts: Sequence[HostView], t: TenantView,
               exclude: Tuple[str, ...] = ()) -> Optional[HostView]:
    """Most-free feasible live host (spread-first). Unbounded hosts
    sort as infinitely free; ties break to fewest tenants, then least
    traffic, then member id for determinism."""
    best = None
    best_key = None
    for h in hosts:
        if not h.alive or h.member_id in exclude or not h.fits(t):
            continue
        free = h.free_bytes()
        key = (-(float("inf") if free is None else free),
               len(h.tenants),
               sum(x.traffic_ewma for x in h.tenants.values()),
               h.member_id)
        if best is None or key < best_key:
            best, best_key = h, key
    return best


def _preemption_victims(h: HostView, t: TenantView) -> List[TenantView]:
    """The cheapest set of lower-priority unpinned residents whose
    eviction makes ``t`` fit on ``h`` — coldest (lowest traffic EWMA)
    first, so pre-emption displaces the tenants least likely to
    notice. Empty list when no such set exists."""
    free = h.free_bytes()
    if free is None or t.hbm_bytes <= free:
        return []
    candidates = sorted(
        (x for x in h.tenants.values()
         if not x.pinned and x.priority < t.priority),
        key=lambda x: (x.traffic_ewma, -x.hbm_bytes, x.key))
    victims: List[TenantView] = []
    for v in candidates:
        victims.append(v)
        free += v.hbm_bytes
        if t.hbm_bytes <= free:
            return victims
    return []


def plan_placement(hosts: Sequence[HostView],
                   pending: Sequence[TenantView],
                   allow_preemption: bool = True) -> PlacementPlan:
    """Place every pending tenant onto the live hosts. Mutates NOTHING
    the caller passed in: hosts are shallow-copied with copied tenant
    maps so the simulation of successive placements stays internal."""
    sim = [replace_host(h) for h in hosts]
    plan = PlacementPlan()
    queue = sorted(pending,
                   key=lambda t: (-t.priority, -t.hbm_bytes, t.key))
    # displaced tenants re-enter the queue at most once: a pre-empted
    # tenant that cannot land anywhere becomes a refusal, it must not
    # pre-empt someone else and cascade forever
    displaced_once = set()
    i = 0
    while i < len(queue):
        t = queue[i]
        i += 1
        h = _pick_host(sim, t)
        if h is not None:
            h.tenants[t.key] = t
            plan.decisions.append(Decision(
                "admit", t.key, host=h.member_id,
                reason="fits free budget"))
            continue
        if allow_preemption and t.key not in displaced_once:
            # find the live host where evicting the cheapest set of
            # colder, lower-priority tenants frees enough room
            choice = None
            for cand in sorted(sim, key=lambda x: x.member_id):
                if not cand.alive:
                    continue
                victims = _preemption_victims(cand, t)
                if victims and (choice is None
                                or len(victims) < len(choice[1])):
                    choice = (cand, victims)
            if choice is not None:
                cand, victims = choice
                for v in victims:
                    del cand.tenants[v.key]
                    plan.decisions.append(Decision(
                        "preempt", v.key, from_host=cand.member_id,
                        reason=f"displaced by higher-priority "
                               f"{t.key}"))
                    displaced_once.add(v.key)
                    queue.append(v)
                cand.tenants[t.key] = t
                plan.decisions.append(Decision(
                    "admit", t.key, host=cand.member_id,
                    reason="fits after preemption"))
                continue
        plan.decisions.append(Decision(
            "refuse", t.key,
            reason="no feasible host: footprint %d bytes exceeds every "
                   "live host's free budget" % t.hbm_bytes))
    return plan


def replace_host(h: HostView) -> HostView:
    return HostView(member_id=h.member_id, url=h.url,
                    budget_bytes=h.budget_bytes, alive=h.alive,
                    tenants=dict(h.tenants))


def plan_failover(hosts: Sequence[HostView],
                  dead: HostView) -> PlacementPlan:
    """Re-place every tenant of ``dead`` onto the survivors. The dead
    host's roster comes from its corpse member record (the fleet
    registry keeps records of the dead on purpose)."""
    survivors = [h for h in hosts
                 if h.alive and h.member_id != dead.member_id]
    return plan_placement(survivors, list(dead.tenants.values()))


def plan_rebalance(hosts: Sequence[HostView],
                   pressure_ratio: float = 0.9) -> PlacementPlan:
    """Evict-cold/admit-hot ACROSS hosts: on every live host whose
    budget is under pressure (used/budget above ``pressure_ratio``),
    propose migrating its coldest unpinned tenant to the most-free
    peer that fits it. One migration per pressured host per planning
    round — the controller re-observes between rounds, so rebalancing
    converges on real signals instead of a stale simulation."""
    plan = PlacementPlan()
    sim = [replace_host(h) for h in hosts]
    for h in sorted(sim, key=lambda x: x.member_id):
        if not h.alive or h.budget_bytes is None or not h.tenants:
            continue
        if h.used_bytes() < pressure_ratio * h.budget_bytes:
            continue
        movable = sorted(
            (t for t in h.tenants.values() if not t.pinned),
            key=lambda t: (t.traffic_ewma, -t.hbm_bytes, t.key))
        for t in movable:
            dest = _pick_host(sim, t, exclude=(h.member_id,))
            if dest is None:
                continue
            del h.tenants[t.key]
            dest.tenants[t.key] = t
            plan.decisions.append(Decision(
                "migrate", t.key, host=dest.member_id,
                from_host=h.member_id,
                reason="evict-cold under budget pressure "
                       f"({h.used_bytes() + t.hbm_bytes}/"
                       f"{h.budget_bytes} bytes)"))
            break
    return plan
