#!/usr/bin/env python3
"""The serve plane at 32 clients, two checkouts of the port in turns, on
one card.

    python3 scripts/serve_plane_ab.py --base DIR [--order BAAB] [--bursts 3]
        [--variant NAME:ENV=VALUE,...]

Each run starts a server process from one checkout (`--base DIR`, e.g.
the parent commit unpacked with `git archive` into the git-ignored
`scratch_archive/`, as "B"; this checkout as "A"; a `--variant` as this
checkout under extra environment variables): the recommendation
template's in-process `EngineServer` on random rank-200 tables at the
ML-20M widths (138,493 users x 26,744 items, each item 1-3 of 20
categories and a creationYear; seed 0), its serve executables captured
by a `swap_models` before traffic, at its defaults (micro-batched, two
windows in flight, the result cache on). This process then sends an
untimed warm burst and `--bursts` timed bursts of `chip_smoke.py`
`serve_plane`'s shape: 32 closed-loop client threads x 20 queries
(base, categories, creationYear and both in turn, the last query an
unknown user), fresh users each burst, and stops the server. Prints one
JSON line a run (qps, p50 / p99 / max ms of each burst, the server's
realized batch and dispatch ms a window) and, before the last, the
card's name and power limit as nvidia-smi prints them. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
USERS, ITEMS, RANK = 138_493, 26_744, 200
CLIENTS, PER_CLIENT, NUM = 32, 20, 10
N_CATEGORIES, YEARS = 20, (1950, 2020)


def serve(tree: str) -> None:
    """The server process: the model on the card, warmed, then serve
    until `/stop`."""
    sys.path.insert(0, tree)
    import torch
    from predictionio_tpu_torch.core import TrainResult
    from predictionio_tpu_torch.models import recommendation as TR
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    from predictionio_tpu_torch.weights import from_jax_model
    assert torch.cuda.is_available(), "needs a CUDA card"
    rng = np.random.default_rng(0)
    U = rng.standard_normal((USERS, RANK), dtype=np.float32)
    V = rng.standard_normal((ITEMS, RANK), dtype=np.float32)
    props = [{"categories": [f"c{int(c)}" for c in rng.choice(
        N_CATEGORIES, int(rng.integers(1, 4)), replace=False)],
        "creationYear": int(rng.integers(*YEARS))} for _ in range(ITEMS)]
    model = from_jax_model(U, V, [f"u{k}" for k in range(USERS)],
                           [f"i{k}" for k in range(ITEMS)], RANK,
                           item_properties=props)
    srv = EngineServer(
        ServerConfig(ip="127.0.0.1", port=0),
        TR.RecommendationEngineFactory.apply(),
        TR.RecommendationEngineFactory.engine_params(
            TR.RatingsData([], [], [])),
        TrainResult(models=[model], algorithms=[TR.ALSAlgorithm(
            TR.ALSAlgorithmParams(rank=RANK))]))
    srv.swap_models(srv.models, version="ab")   # captures the ladder
    srv.start()
    print(f"PORT {srv.config.port}", flush=True)
    while srv._httpd is not None:
        time.sleep(0.2)


def queries(rng) -> list:
    out = []
    for c in range(CLIENTS):
        qs = []
        for n in range(PER_CLIENT - 1):
            q = {"user": f"u{int(rng.integers(USERS))}", "num": NUM}
            if (c + n) % 4 in (1, 3):
                q["categories"] = [f"c{int(x)}" for x in rng.choice(
                    N_CATEGORIES, 1 + n % 2, replace=False)]
            if (c + n) % 4 in (2, 3):
                q["creationYear"] = int(rng.integers(*YEARS))
            qs.append(q)
        qs.append({"user": f"no-such-user-{c}", "num": NUM})
        out.append(qs)
    return out


def post(url: str, body: dict) -> int:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        r.read()
        return r.status


def burst(url: str, per_client: list) -> dict:
    lat = [[] for _ in per_client]
    start = threading.Barrier(len(per_client) + 1)

    def client(c):
        start.wait()
        for q in per_client[c]:
            t0 = time.perf_counter()
            assert post(url + "/queries.json", q) == 200
            lat[c].append((time.perf_counter() - t0) * 1e3)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(per_client))]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    ms = np.concatenate([np.asarray(x) for x in lat])
    return {"qps": len(ms) / wall, "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "max_ms": float(ms.max())}


def run(name: str, tree: str, env: dict, bursts: int, seed: int) -> dict:
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "serve", "--tree",
         tree], cwd=tree, env=dict(os.environ, **env),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        port = None
        for line in proc.stdout:
            m = re.match(r"PORT (\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port is not None, f"{name}: the server did not start"
        url = f"http://127.0.0.1:{port}"
        rng = np.random.default_rng(seed)
        burst(url, queries(rng)[:CLIENTS][:8])        # warm, untimed
        with urllib.request.urlopen(url + "/stats.json", timeout=60) as r:
            s0 = json.loads(r.read())
        rows = [burst(url, queries(rng)) for _ in range(bursts)]
        with urllib.request.urlopen(url + "/stats.json", timeout=60) as r:
            s1 = json.loads(r.read())
        nb = s1["batches"] - s0["batches"]
        nq = s1["batchedQueries"] - s0["batchedQueries"]
        disp = (s1["stageSeconds"]["dispatch"]
                - s0["stageSeconds"]["dispatch"])
        out = {"run": name, "tree": tree, "env": env, "bursts": rows,
               "qps_median": float(np.median([r["qps"] for r in rows])),
               "p50_ms_median": float(np.median([r["p50_ms"]
                                                 for r in rows])),
               "avg_batch": nq / nb if nb else None,
               "dispatch_ms_per_window": disp * 1e3 / nb if nb else None}
        try:
            post(url + "/stop", {})
        except OSError:
            pass
        proc.wait(timeout=60)
        return out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def main() -> int:
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd")
    sv = sub.add_parser("serve")
    sv.add_argument("--tree", required=True)
    p.add_argument("--base", help="the other checkout (B)")
    p.add_argument("--order", default="BAAB")
    p.add_argument("--bursts", type=int, default=3)
    p.add_argument("--variant", action="append", default=[],
                   help="NAME:ENV=VALUE,... : this checkout under extra "
                        "environment variables, run after the others")
    args = p.parse_args()
    if args.cmd == "serve":
        serve(args.tree)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("serve_plane_ab: needs a CUDA card", file=sys.stderr)
        return 2
    trees = {"A": HERE, "B": os.path.abspath(args.base or HERE)}
    plan = [(k, trees[k], {}) for k in args.order]
    for v in args.variant:
        name, _, kv = v.partition(":")
        plan.append((name, HERE, dict(x.split("=", 1)
                                      for x in kv.split(",") if x)))
    for k, (name, tree, env) in enumerate(plan):
        print(json.dumps(run(name, tree, env, args.bursts, seed=k)),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
