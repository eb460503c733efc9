"""The compile plane: the salted build directory, the shape-bucket
ladder and the executable registry.

The port's counterpart of `predictionio_tpu/compile/`:

- `compile.cache`: the salted `nvcc` build directory of the kernels (the
  counterpart of the persistent XLA cache) and `cache {status,clear}`.
- `compile.buckets`: the pow2 ladder of vocabulary rows, touched rows,
  batch sizes and top-k.
- `compile.aot`: the executable registry, whose executables are CUDA
  graphs captured at deploy and swap time and replayed by the serve
  path.

`PIO_AOT=off` turns dispatch into eager calls; `PIO_AOT_WARM=off` stops
deploy-time capture.
"""

from predictionio_tpu_torch.compile.buckets import (PROMOTE_AT, bucket_batch,
                                                    bucket_key, bucket_rows,
                                                    occupancy)
from predictionio_tpu_torch.compile.cache import cache_status, clear_cache
from predictionio_tpu_torch.compile.aot import (AOTRegistry, aot_enabled,
                                                get_aot, shared_jit,
                                                warm_models)

__all__ = [
    "AOTRegistry", "aot_enabled", "bucket_batch", "bucket_key",
    "bucket_rows", "cache_status", "clear_cache", "get_aot", "occupancy",
    "PROMOTE_AT", "shared_jit", "warm_models",
]
