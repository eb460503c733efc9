"""The distributed substrate: the mesh, row-sharded tables, host ingest.

The port's counterpart of `predictionio_tpu/parallel/`: a
`torch.distributed` process group with a grid of logical devices
(`mesh.py`), the row-sharded factor table (`sharded_table.py`), the
per-process ingest edge (`dataset.py`) and the collective counters
(`collective_stats.py`).
"""

from predictionio_tpu_torch.parallel.mesh import (MeshContext, current_mesh,
                                                  make_mesh, use_mesh)

__all__ = ["MeshContext", "make_mesh", "current_mesh", "use_mesh"]
