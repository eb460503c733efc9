#!/usr/bin/env python3
"""The e-commerce template under 32 clients, two checkouts of the port in
turns, on one card: do its live seen-items reads miss their deadline, and
does an answer then hold an item its user has seen?

    python3 scripts/ecom_plane_ab.py --base DIR [--order BAAB] [--bursts 3]

Set-up, once, with this checkout's `chip_smoke.py`: the smoke's SQLite
store (`populate_store`: 4,026,744 events of synthetic_ml20m, seed 0),
its e-commerce traffic (`ecom_populate`: views, buys, new users, two
`unavailableItems` lists) and `pio train` of the e-commerce template at
rank 200. Then, for each letter of `--order`, that checkout (`--base
DIR`, e.g. the parent commit unpacked with `git archive` into the
git-ignored `scratch_archive/`, as "B"; this checkout as "A") deploys the
instance as a `deploy` subprocess at its defaults, and this process sends
`--bursts` bursts of `chip_smoke.py` `ecom_plane`'s shape (32 closed-loop
clients x 20 queries: known users, half with categories, new users,
unknown users; burst k draws with seed 23 + k, so burst 0 is the
smoke's). Every answer is held as the smoke holds it (`EcomTruth.hold`),
counting the failures instead of stopping. Prints one JSON line a run:
each burst's qps, p50 / p99 ms, the deploy's point-read timeouts
(`pio_event_point_read_timeout_total`), the held answers that failed and
the first of them, the rule-read errors in the deploy's log by message,
the incidents it captured by kind and, where it has a fleet registry, its
live members; and, before the last, the card's name and power limit as
nvidia-smi prints them. Needs a CUDA card.
"""

from __future__ import annotations

import collections
import json
import os
import re
import sys
import tempfile

import numpy as np

from ab_turns import HERE, ab_args, card_line, trees

sys.path.insert(0, HERE)
import chip_smoke as S  # noqa: E402  (the smoke's set-up and holds)

SEEN_INCIDENTS: set = set()
READ_ERROR = re.compile(r"Error when reading (\w+(?: \w+)?): (.*)")


def setup(workdir: str) -> tuple:
    """The store, the e-commerce events and the trained instance.
    Returns (engine.json path, truth, the known-user pool)."""
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.storage.registry import Storage
    S.use_store(workdir)
    app_id = Storage.get_meta_data_apps().insert(App(0, S.STORE_APP))
    S.populate_store(app_id)
    seeds = S.ecom_populate(app_id)
    path = os.path.join(workdir, "ecommerce.json")
    S.ecom_variant(path)
    _, trained, _ = S.workflow_train(path, "ecom_train")
    truth = S.EcomTruth(trained.models[0], seeds,
                        S.item_meta(S.appended_events(app_id)))
    buyers = np.unique(np.concatenate([seeds["view"][0],
                                       seeds["buy"][0]]))
    rng = np.random.default_rng(25)   # the smoke's pool
    pool = np.concatenate([
        buyers[rng.choice(len(buyers), min(S.ECOM_POOL, len(buyers)),
                          replace=False)],
        [f"u{x}" for x in rng.choice(S.STORE_DATA[0], S.ECOM_POOL,
                                     replace=False)]])
    return path, truth, pool


def queries(pool, seed: int) -> list:
    """`phase_ecom_plane`'s per-client queries, drawn with `seed`."""
    rng = np.random.default_rng(seed)
    cats = sorted({c for cs in S.store_items()[0] for c in cs})
    known, new, unknown = S.ECOM_PLANE_MIX
    per_client = []
    for c in range(S.SERVE_CLIENTS):
        qs = []
        for n in range(known):
            q = {"user": str(pool[rng.integers(len(pool))]),
                 "num": S.SERVE_NUM}
            if n % 2:
                q["categories"] = [str(x) for x in rng.choice(
                    cats, 1 + n % 4 // 2, replace=False)]
            qs.append(q)
        qs += [{"user": f"eu{rng.integers(S.ECOM_NEW_USERS)}",
                "num": S.SERVE_NUM} for _ in range(new)]
        qs += [{"user": f"nouser{c}-{n}", "num": S.SERVE_NUM}
               for n in range(unknown)]
        rng.shuffle(qs)
        per_client.append(qs)
    return per_client


def burst(url: str, truth, pool, seed: int) -> dict:
    before = S.get_json(url + "/stats.json")
    results, wall = S.closed_loop(url, queries(pool, seed))
    after = S.get_json(url + "/stats.json")
    failed = []
    for q, code, body, _ in results:
        try:
            S.check(code == 200, f"{q} answered {code}")
            truth.hold(body, q, str(q))
        except S.SmokeFailure as e:
            failed.append(str(e))
    ms = np.array([r[3] for r in results])
    d = S.stats_delta(before, after)
    return {"seed": seed, "queries": len(results), "qps": len(ms) / wall,
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "point_read_timeouts":
                after["pio_event_point_read_timeout_total"]
                - before["pio_event_point_read_timeout_total"],
            "hold_failures": len(failed), "first_failure":
                failed[0] if failed else None,
            "dispatch_ms_per_window": d["stage_ms_per_window"]["dispatch"],
            "avg_batch": d["avg_batch"]}


def run(name: str, tree: str, path: str, truth, pool, bursts: int,
        workdir: str) -> dict:
    S.HERE = tree                  # the checkout whose `deploy` runs
    deps = {}
    first = {"user": str(pool[0]), "num": S.SERVE_NUM}
    try:
        S.phase_cli_deploy({"ecommercerecommendation": path}, workdir,
                           deps, first_queries={
                               "ecommercerecommendation": first},
                           warmed=False)
        dep = deps["ecommercerecommendation"]
        rows = [burst(dep["url"], truth, pool, 23 + k)
                for k in range(bursts)]
        # the bundle directory is the store's, shared by the runs
        new = [i for i in S.get_json(dep["url"] + "/incidents.json?n=1000"
                                     )["incidents"]
               if i["id"] not in SEEN_INCIDENTS]
        SEEN_INCIDENTS.update(i["id"] for i in new)
        kinds = collections.Counter(i.get("kind") for i in new)
        # the other members each bundle froze (the fleet capture)
        peers = [len(S.get_json(f"{dep['url']}/incidents/{i['id']}.json"
                                ).get("fleet") or []) for i in new]
        try:
            status = S.get_json(dep["url"] + "/fleet/status.json")
            fleet_live = sum(m["alive"] for m in status["members"])
        except OSError:            # a checkout without the fleet: 404
            fleet_live = None
        try:
            S.phase_undeploy(deps)
            undeploy = "exit 0"
        except S.SmokeFailure as e:
            undeploy = str(e)[-2000:]
    finally:
        S.stop_all(deps)
    errors = collections.Counter()
    with open(dep["log"], errors="replace") as f:
        for line in f:
            m = READ_ERROR.search(line)
            if m:
                errors[f"{m.group(1)}: {m.group(2)[:80]}"] += 1
    return {"run": name, "tree": tree, "bursts": rows,
            "point_read_timeouts": sum(r["point_read_timeouts"]
                                       for r in rows),
            "hold_failures": sum(r["hold_failures"] for r in rows),
            "read_errors": dict(errors), "incidents": dict(kinds),
            "incident_fleet_members": peers, "fleet_live": fleet_live,
            "undeploy": undeploy}


def main() -> int:
    import torch
    p = ab_args(__doc__)
    p.add_argument("--bursts", type=int, default=3)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("ecom_plane_ab: needs a CUDA card", file=sys.stderr)
        return 2
    checkouts = trees(args.base)
    with tempfile.TemporaryDirectory(prefix="pio_ecom_ab_") as workdir:
        path, truth, pool = setup(workdir)
        for name in args.order:
            print(json.dumps(run(name, checkouts[name], path, truth, pool,
                                 args.bursts, workdir)), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
