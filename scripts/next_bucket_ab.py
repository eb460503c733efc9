"""What the serve path's next-bucket capture costs on the card: two
checkouts of the port in turns, each serving one model of the smoke
store's shape through `ops/als.users_topk_serve`.

    python3 scripts/next_bucket_ab.py --base scratch_archive/parent

Each turn is a process of its own (cwd and `PYTHONPATH` its checkout): a
seeded model of 138,493 users x 26,744 items at rank 200 (the items fill
0.82 of their 32,768-row bucket, past the reference's 3/4 promotion
mark) on the card, a first window of 16 users (a miss: it runs eagerly
and captures its bucket in the background; a checkout that promotes
also captures the next item bucket), the background captures joined,
then `--windows` more windows (replays). It prints one JSON line: the
executables held, the capture count and seconds, the first window's and
the replays' ms, and `torch.cuda.memory_allocated()` before the first
window and after the captures (the stream synchronized). The last line
is the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ab_turns import ab_args, card_line, trees  # noqa: E402

PROBE = r"""
import json, sys, time
import numpy as np
import torch
from predictionio_tpu_torch.compile.aot import get_aot
from predictionio_tpu_torch.ops import als

windows = int(sys.argv[1])
rng = np.random.default_rng(0)
model = als.ALSModel(
    rng.standard_normal((138_493, 200), dtype=np.float32),
    rng.standard_normal((26_744, 200), dtype=np.float32), 200,
    torch.device("cuda"))
model.tables()
torch.cuda.current_stream().synchronize()
before = torch.cuda.memory_allocated()
users = rng.integers(0, model.n_users, (windows + 1, 16))
t0 = time.perf_counter()
als.users_topk_serve(model, users[0], 10)
first_ms = (time.perf_counter() - t0) * 1e3
aot = get_aot()
for t in list(aot._threads):
    t.join(600)
torch.cuda.current_stream().synchronize()
after = torch.cuda.memory_allocated()
t0 = time.perf_counter()
for w in range(1, windows + 1):
    als.users_topk_serve(model, users[w], 10)
replay_ms = (time.perf_counter() - t0) * 1e3 / windows
snap = aot.snapshot()
print(json.dumps({
    "executables": snap["executablesResident"],
    "buckets": snap["bucketsCompiled"],
    "captures": snap["compileCount"],
    "capture_s": snap["compileSeconds"],
    "first_window_ms": first_ms, "replay_window_ms": replay_ms,
    "hits": snap["dispatchHits"], "misses": snap["dispatchMisses"],
    "allocated_before": before, "allocated_after": after,
    "allocated_by_serving": after - before}))
"""


def main() -> int:
    p = ab_args(__doc__)
    p.add_argument("--windows", type=int, default=50)
    args = p.parse_args()
    dirs = trees(args.base)
    for turn in args.order:
        env = dict(os.environ, PYTHONPATH=dirs[turn])
        out = subprocess.run(
            [sys.executable, "-c", PROBE, str(args.windows)], cwd=dirs[turn],
            env=env, capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": turn, "tree": dirs[turn], **row}),
              flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
