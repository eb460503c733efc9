"""What a deploy's AOT warm leaves allocated on the card, and on how many
streams it captured: two checkouts of the port in turns, each warming
one recommendation model of the smoke store's shape.

    python3 scripts/capture_streams_ab.py --base scratch_archive/parent

Each turn is a process of its own (cwd and `PYTHONPATH` its checkout): a
seeded model of 138,493 users x 26,744 items at rank 200 placed on the
card by the template's `place_model` (what a deploy's `load()` does),
then `compile.aot.warm_models` over the micro-batcher's ladder up to 16
(the deploy's warm: the plain and the masked top-k at every batch
bucket). `torch.cuda.CUDAGraph.capture_begin` is wrapped to note the
stream each capture records on. It prints one JSON line: the graphs
captured, the distinct capture streams, and
`torch.cuda.memory_allocated()` before and after the warm (the current
stream synchronized); cuBLAS keeps a 32 MiB workspace for each stream it
has run on, which the difference between the checkouts shows. The last
line is the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ab_turns import ab_args, card_line, trees  # noqa: E402

PROBE = r"""
import json, os
import numpy as np
import torch
os.environ["PIO_AOT_WARM"] = "on"
from predictionio_tpu_torch.compile.aot import warm_models
from predictionio_tpu_torch.data.bimap import EntityIdIxMap
from predictionio_tpu_torch.models import recommendation as R
from predictionio_tpu_torch.ops.als import ALSModel

streams = []
begin = torch.cuda.CUDAGraph.capture_begin

def noted(self, *args, **kwargs):
    streams.append(torch.cuda.current_stream().cuda_stream)
    return begin(self, *args, **kwargs)

torch.cuda.CUDAGraph.capture_begin = noted
rng = np.random.default_rng(0)
n_users, n_items, rank = 138_493, 26_744, 200
als = ALSModel(rng.standard_normal((n_users, rank), dtype=np.float32),
               rng.standard_normal((n_items, rank), dtype=np.float32),
               rank, None)
model = R.RecommendationModel(
    als, EntityIdIxMap.from_ids([f"u{k}" for k in range(n_users)]),
    EntityIdIxMap.from_ids([f"i{k}" for k in range(n_items)]))
algo = R.ALSAlgorithm(R.ALSAlgorithmParams(rank=rank))
algo.place_model(model)
torch.cuda.current_stream().synchronize()
before = torch.cuda.memory_allocated()
summary = warm_models([algo], [model], batch_hint=16)
torch.cuda.current_stream().synchronize()
after = torch.cuda.memory_allocated()
print(json.dumps({
    "captured": summary["compiled"], "capture_calls": len(streams),
    "capture_streams": len(set(streams)), "allocated_before": before,
    "allocated_after": after, "allocated_by_warm": after - before}))
"""


def main() -> int:
    args = ab_args(__doc__).parse_args()
    dirs = trees(args.base)
    for turn in args.order:
        env = dict(os.environ, PYTHONPATH=dirs[turn])
        out = subprocess.run([sys.executable, "-c", PROBE], cwd=dirs[turn],
                             env=env, capture_output=True, text=True,
                             timeout=900)
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
