"""What the A/B scripts of `scripts/` share: two checkouts of the port run
in turns on one card's host (`--base DIR` is "B", this checkout "A";
`--order` spells the turns, e.g. BAAB), closed-loop JSON POSTs and the
card's name and power limit.

    from ab_turns import ab_args, card_line, closed_loop, cpu_s, trees
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ab_args(doc: str, base_required: bool = True) -> argparse.ArgumentParser:
    """A parser with `--base` (the other checkout, run as B) and
    `--order`; the script adds its own options."""
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("--base", required=base_required,
                   help="the other checkout, run as B")
    p.add_argument("--order", default="BAAB")
    return p


def trees(base) -> dict:
    """{"A": this checkout, "B": `base`, or this checkout without one}."""
    return {"A": HERE, "B": os.path.abspath(base or HERE)}


def post_json(url: str, body, timeout: float = 120.0) -> tuple:
    """POST `body` as JSON: (status, the parsed answer, ms)."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        got = json.loads(r.read())
        return r.status, got, (time.perf_counter() - t0) * 1e3


def closed_loop(url: str, per_client: list) -> tuple:
    """One thread a client, all released together, each POSTing its
    bodies to `url` in turn: ([(status, answer, ms)] in client order,
    wall seconds from the release to the last answer)."""
    out = [[] for _ in per_client]
    start = threading.Barrier(len(per_client) + 1)

    def client(c):
        start.wait()
        for body in per_client[c]:
            out[c].append(post_json(url, body))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(per_client))]
    for th in threads:
        th.start()
    start.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join()
    return [r for rows in out for r in rows], time.perf_counter() - t0


def cpu_s(pid: int) -> float:
    """A process's user + system CPU seconds so far."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
