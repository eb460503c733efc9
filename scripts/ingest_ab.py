#!/usr/bin/env python3
"""Event ingest through the port's event server, two checkouts in turns,
on the card's host.

    python3 scripts/ingest_ab.py --base DIR [--order BAAB]

Each run starts `python -m predictionio_tpu_torch eventserver --stats`
from one checkout (`--base DIR`, e.g. the parent commit unpacked with
`git archive` into the git-ignored `scratch_archive/`, as "B"; this
checkout as "A") over a fresh SQLite store of its own, makes an app with
that checkout's `app new`, then posts `chip_smoke.py` `eventserver`'s
routes: 16 closed-loop clients x 250 single `POST /events.json`, 8 x 25
`POST /batch/events.json` of 50 events, and one `POST
/events/columnar.json` of 100,000 rows, each event acknowledged 201, and
stops the server. Prints one JSON line a run (events/s, p50 / p99 ms a
request and the server process's CPU µs an event, from
`/proc/<pid>/stat`, by route) and, before the last, the card's name and
power limit as nvidia-smi prints them. Ingest is host work; the run fails without a
CUDA card so that its numbers are the card's host's.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

from ab_turns import ab_args, card_line, closed_loop, cpu_s, post_json, trees

SINGLE = (16, 250)          # clients x single posts
BATCH = (8, 25, 50)         # clients x batches x events a batch
COLUMNAR = 100_000          # rows of the one columnar post


def cli(tree: str, env: dict, *args) -> str:
    out = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch",
                          *args], cwd=tree, env=env, capture_output=True,
                         text=True, check=True)
    return out.stdout


def event(k: int) -> dict:
    return {"event": "rate", "entityType": "user", "entityId": f"u{k % 5003}",
            "targetEntityType": "item", "targetEntityId": f"i{k % 977}",
            "properties": {"rating": float(1 + k % 5)}}


def row(n_events: int, wall: float, ms: list, cpu: float) -> dict:
    return {"events": n_events, "events_per_s": n_events / wall,
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "server_cpu_us_per_event": cpu / n_events * 1e6}


def run(tree: str) -> dict:
    store = tempfile.mkdtemp(prefix="pio_ingest_ab_")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env["PIO_FS_BASEDIR"] = os.path.join(store, "pio")
    key = re.search(r"Access Key: (\S+) \|",
                    cli(tree, env, "app", "new", "abapp")).group(1)
    log = os.path.join(store, "eventserver.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch", "eventserver",
             "--ip", "127.0.0.1", "--port", "0", "--stats"], cwd=tree,
            env=env, stdout=f, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 120
        while True:
            with open(log) as f:
                m = re.search(r"listening on http://127\.0\.0\.1:(\d+)",
                              f.read())
            if m:
                break
            assert proc.poll() is None and time.time() < deadline, \
                open(log).read()
            time.sleep(0.1)
        base = f"http://127.0.0.1:{m.group(1)}"
        while True:
            try:
                urllib.request.urlopen(base + "/", timeout=5).read()
                break
            except OSError:
                time.sleep(0.1)
        out = {"tree": tree}
        n_c, n_e = SINGLE
        c0 = cpu_s(proc.pid)
        res, wall = closed_loop(f"{base}/events.json?accessKey={key}", [
            [event(c * n_e + j) for j in range(n_e)] for c in range(n_c)])
        assert {s for s, _, _ in res} == {201}
        out["single"] = row(len(res), wall, [ms for _, _, ms in res],
                            cpu_s(proc.pid) - c0)
        n_c, n_b, size = BATCH
        c0 = cpu_s(proc.pid)
        k0 = SINGLE[0] * SINGLE[1]
        res, wall = closed_loop(f"{base}/batch/events.json?accessKey={key}", [
            [[event(k0 + (c * n_b + b) * size + j) for j in range(size)]
             for b in range(n_b)] for c in range(n_c)])
        assert all(s == 200 and {g["status"] for g in got} == {201}
                   for s, got, _ in res)
        out["batch"] = row(n_c * n_b * size, wall, [ms for _, _, ms in res],
                           cpu_s(proc.pid) - c0)
        k0 += n_c * n_b * size
        c0 = cpu_s(proc.pid)
        status, got, ms = post_json(f"{base}/events/columnar.json?accessKey={key}",
                               {"event": "rate", "entityType": "user",
                                "entityId": [f"u{k % 5003}" for k in
                                             range(k0, k0 + COLUMNAR)],
                                "targetEntityType": "item",
                                "targetEntityId": [f"i{k % 977}" for k in
                                                   range(k0, k0 + COLUMNAR)]})
        assert status == 201 and got["eventsCreated"] == COLUMNAR, got
        out["columnar"] = row(COLUMNAR, ms / 1e3, [ms],
                              cpu_s(proc.pid) - c0)
        return out
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        shutil.rmtree(store, ignore_errors=True)


def main() -> int:
    args = ab_args(__doc__).parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ingest_ab: no CUDA card; its host's numbers only",
              file=sys.stderr)
        return 2
    checkouts = trees(args.base)
    for side in args.order:
        print(json.dumps({"side": side, **run(checkouts[side])}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "order": args.order}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
