"""Power-of-two shape buckets for the serve path.

The port's own copy of the batch half of
`predictionio_tpu/compile/buckets.py` (`_next_pow2`, `BATCH_FLOOR`,
`K_FLOOR`, `bucket_batch`). A serve window pads its batch of queries to
`bucket_batch(n)` and its top-k to `bucket_batch(k, floor=K_FLOOR)`, so
the shapes cuBLAS and `torch.topk` see on the card come from a short
ladder that the deploy-time warm-up covers, and the micro-batcher's
adaptive target snaps to the same ladder. The tables stay exact-size:
the reference's vocabulary-row buckets have nothing to do here.
"""

from __future__ import annotations

#: smallest batch bucket (a single query is its own class)
BATCH_FLOOR = 1
#: smallest top-k bucket: a client-chosen num in 1..16 shares one shape
K_FLOOR = 16


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def bucket_batch(n: int, floor: int = BATCH_FLOOR) -> int:
    """Query-batch bucket covering `n`."""
    return max(int(floor), _next_pow2(max(int(n), 1)))


def batch_ladder(max_batch: int) -> list:
    """Every batch bucket a window of at most `max_batch` queries pads
    to: 1, 2, 4, ... up to `bucket_batch(max_batch)`."""
    top = bucket_batch(max(int(max_batch), 1))
    return [1 << e for e in range(top.bit_length())]
