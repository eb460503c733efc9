"""Power-of-two shape buckets for the serve path.

The port's own copy of `predictionio_tpu/compile/buckets.py`'s ladder
(`_next_pow2`, `ROWS_FLOOR`, `BATCH_FLOOR`, `K_FLOOR`, `bucket_rows`,
`bucket_batch`). A serve window pads its batch of queries to
`bucket_batch(n)` and its top-k to `bucket_batch(k, floor=K_FLOOR)`, so
the shapes cuBLAS and `torch.topk` see on the card come from a short
ladder that the deploy-time warm-up covers, and the micro-batcher's
adaptive target snaps to the same ladder. The served tables stay
exact-size; the fold-in (`online/fold_in.py`) keeps its device tables at
`bucket_rows` heights and pads its touched rows and solve batches on the
same ladder, as the reference does, so the kernel sees the reference's
batch and K shapes.
"""

from __future__ import annotations

#: smallest vocabulary-row bucket
ROWS_FLOOR = 64
#: smallest batch bucket (a single query is its own class)
BATCH_FLOOR = 1
#: smallest top-k bucket: a client-chosen num in 1..16 shares one shape
K_FLOOR = 16


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def bucket_rows(n: int, floor: int = ROWS_FLOOR) -> int:
    """Row-count bucket covering `n` (vocabulary rows, touched rows)."""
    return max(int(floor), _next_pow2(max(int(n), 1)))


def bucket_batch(n: int, floor: int = BATCH_FLOOR) -> int:
    """Query-batch bucket covering `n`."""
    return max(int(floor), _next_pow2(max(int(n), 1)))


def batch_ladder(max_batch: int) -> list:
    """Every batch bucket a window of at most `max_batch` queries pads
    to: 1, 2, 4, ... up to `bucket_batch(max_batch)`."""
    top = bucket_batch(max(int(max_batch), 1))
    return [1 << e for e in range(top.bit_length())]
