"""Shape-bucket ladder: the sizes the compile plane captures for.

The port's copy of `predictionio_tpu/compile/buckets.py`. The dims that
move in production (vocabulary rows, touched-row counts, query batch
sizes, top-k) are quantized to next-power-of-two buckets with a floor:

- growth inside a bucket changes no shape the card sees, so a serve
  window replays a graph captured for its bucket (`compile/aot.py`);
- a promotion (bucket -> 2x) is one predictable capture, which can run
  in the background before the shape is needed (`occupancy` past
  `PROMOTE_AT` is the trigger);
- the executables a label holds are bounded by log2 of the largest size.

The serve path pads its tables to `bucket_rows` (`utils/device_cache.
cached_put_rows`), its batch to `bucket_batch` and its top-k to
`bucket_batch(k, floor=K_FLOOR)`; the fold keeps its device tables at
`bucket_rows` heights and pads its touched rows and solve batches on the
same ladder; the micro-batcher's adaptive target snaps to it. Pure host
math.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

#: smallest vocabulary-row bucket: tiny models all share one shape
ROWS_FLOOR = 64
#: smallest batch bucket (a single query is its own class)
BATCH_FLOOR = 1
#: smallest top-k bucket: a client-chosen num in 1..16 shares one shape
K_FLOOR = 16
#: fraction of a bucket in use at which the next bucket's executables
#: are captured in the background (before growth forces it)
PROMOTE_AT = 0.75


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def bucket_rows(n: int, floor: int = ROWS_FLOOR) -> int:
    """Row-count bucket covering `n` (vocabulary rows, touched rows)."""
    return max(int(floor), _next_pow2(max(int(n), 1)))


def bucket_batch(n: int, floor: int = BATCH_FLOOR) -> int:
    """Query-batch bucket covering `n`."""
    return max(int(floor), _next_pow2(max(int(n), 1)))


def bucket_rows_sharded(n: int, shards: int,
                        floor: int = ROWS_FLOOR) -> int:
    """Row bucket for a table split by rows over `shards` devices: the
    pow2 bucket rounded up to a multiple of the shard count, so every
    shard gets an equal contiguous slice."""
    b = bucket_rows(n, floor=floor)
    s = max(int(shards), 1)
    return ((b + s - 1) // s) * s


def occupancy(n: int, bucket: int) -> float:
    """How full `bucket` is at current size `n` (0..1]."""
    return float(n) / float(bucket) if bucket else 1.0


def should_promote(n: int, bucket: int,
                   threshold: float = PROMOTE_AT) -> bool:
    """True when `n` is close enough to `bucket` that the next bucket's
    executables should be captured now, in the background."""
    return occupancy(n, bucket) >= threshold


def next_bucket(bucket: int) -> int:
    return int(bucket) * 2


def bucket_key(dims: Dict[str, int]) -> Tuple[Tuple[str, int], ...]:
    """Canonical hashable key for a bucket-dim dict (sorted items). Flag
    dims ride the same key: `fp` (the positive-score filter) and `p`
    (the readback pack mode), so each flag value owns its executables."""
    return tuple(sorted((str(k), int(v)) for k, v in dims.items()))


def bucket_label(dims: Dict[str, int]) -> str:
    """Compact metric-label rendering: `"b16-i2048-u1024"`."""
    return "-".join(f"{k}{v}" for k, v in bucket_key(dims))


def batch_ladder(max_batch: int) -> List[int]:
    """Every batch bucket a window of at most `max_batch` queries pads
    to: 1, 2, 4, ... up to `bucket_batch(max_batch)` (the ladder the
    templates' `aot_warm_specs` cover)."""
    top = bucket_batch(max(int(max_batch), 1))
    return [1 << e for e in range(top.bit_length())]
