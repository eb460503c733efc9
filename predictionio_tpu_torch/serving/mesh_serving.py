"""Query coordination across the processes of a sharded deploy.

The port's counterpart of `predictionio_tpu/serving/mesh_serving.py`
(`MeshServingUnavailable`, `MeshQueryCoordinator`). A model whose tables
are split over P processes answers a query only if every process runs
the same ranking, with its collectives in the same order. So the HTTP
front end (process 0) broadcasts each query's payload (one query's JSON
body, or a micro-batched window's list of them) to every process before
any device work, and the other processes sit in `worker_loop`, running
the same predict on their shards for each payload they receive.

Transport: `parallel/mesh.broadcast` of a fixed-size uint8 buffer (a
4-byte length, then the JSON), a `torch.distributed` broadcast over the
gloo group, counted in `parallel/collective_stats`. The broadcast orders
the processes; a lock on the primary keeps two request threads from
interleaving their queries' collectives.

A broadcast that fails or outlasts `broadcast_timeout_s` (a worker died
or hangs) poisons the coordinator: it never catches the failure and
carries on. Every query after it answers 503 (`MeshServingUnavailable`)
at once, until the mesh is deployed again; `health()` carries the state
to `/stats.json` and `/metrics`.

The contract for engines served so: `Serving.supplement` is a function
of the query (every process supplements its own copy), and feedback and
output plugins run on the primary only.
"""

from __future__ import annotations

import json
import logging
import threading
from contextlib import contextmanager
from typing import Callable, Optional

import numpy as np

logger = logging.getLogger(__name__)

_SHUTDOWN = 0xFFFFFFFF


class MeshServingUnavailable(RuntimeError):
    """The coordinator cannot serve: a broadcast failed or timed out (a
    worker process is dead or stuck) and the coordinator is poisoned.
    Answered 503; the operator deploys the mesh again."""

    http_status = 503


class MeshQueryCoordinator:
    """Serializes and broadcasts query payloads so every process runs the
    same predict in the same order. The primary wraps each query's
    device work in `serialized(payload)`; workers run
    `worker_loop(handler)`."""

    def __init__(self, max_bytes: int = 1 << 16,
                 broadcast_timeout_s: float = 30.0):
        from predictionio_tpu_torch.parallel.mesh import (process_index,
                                                          world_size)
        self.max_bytes = max_bytes
        self.broadcast_timeout_s = broadcast_timeout_s
        self.n_processes = world_size()
        self.is_primary = process_index() == 0
        self._lock = threading.Lock()
        self._down = False
        self._poisoned = False

    @property
    def multi_process(self) -> bool:
        return self.n_processes > 1

    def health(self) -> dict:
        """The coordinator's state for `/stats.json` and `/metrics`:
        `poisoned` once a broadcast failed (every query answers 503
        until the mesh is deployed again)."""
        return {"processes": self.n_processes,
                "poisoned": self._poisoned,
                "shutdown": self._down}

    @classmethod
    def create_if_distributed(cls, max_bytes: int = 1 << 16,
                              broadcast_timeout_s: float = 30.0
                              ) -> Optional["MeshQueryCoordinator"]:
        """A coordinator when the process group has more than one
        process, else None (one process needs no broadcast)."""
        from predictionio_tpu_torch.parallel.mesh import world_size
        if world_size() > 1:
            return cls(max_bytes=max_bytes,
                       broadcast_timeout_s=broadcast_timeout_s)
        return None

    # -- the wire format ----------------------------------------------------
    def _encode(self, obj) -> np.ndarray:
        data = json.dumps(obj).encode("utf-8")
        if len(data) > self.max_bytes - 4:
            raise ValueError(
                f"query payload {len(data)}B exceeds the mesh broadcast "
                f"buffer ({self.max_bytes - 4}B); raise max_bytes")
        buf = np.zeros(self.max_bytes, np.uint8)
        buf[:4] = np.frombuffer(np.uint32(len(data)).tobytes(), np.uint8)
        buf[4:4 + len(data)] = np.frombuffer(data, np.uint8)
        return buf

    @staticmethod
    def _decode(buf: np.ndarray):
        n = int(np.frombuffer(buf[:4].tobytes(), np.uint32)[0])
        if n == _SHUTDOWN:
            return None
        return json.loads(buf[4:4 + n].tobytes().decode("utf-8"))

    def _bcast(self, buf: np.ndarray) -> np.ndarray:
        import torch
        from predictionio_tpu_torch.parallel.mesh import broadcast
        out = broadcast(torch.from_numpy(np.array(buf, dtype=np.uint8)),
                        src=0).numpy()
        # `_decode` slices bytes: a backend that widened the buffer (as
        # the reference's CPU gloo returns int32) would hand the worker
        # interleaved text, so the wire dtype is restored
        if out.dtype != np.uint8:
            out = out.astype(np.uint8)
        return out

    def _bcast_watched(self, buf: np.ndarray) -> np.ndarray:
        """The primary's broadcast under a watchdog: it runs in a daemon
        thread with a deadline. On a timeout or a failure the coordinator
        is poisoned (the stuck thread is left; no further broadcast is
        tried) and this raises `MeshServingUnavailable`."""
        done = threading.Event()
        result: list = []

        def run():
            try:
                result.append(self._bcast(buf))
            except BaseException as e:
                result.append(e)
            finally:
                done.set()

        threading.Thread(target=run, daemon=True,
                         name="mesh-bcast-watchdog").start()
        if not done.wait(self.broadcast_timeout_s):
            self._poisoned = True
            logger.critical(
                "mesh broadcast did not complete within %.1fs — a worker "
                "process is dead or stuck; coordinator poisoned, every "
                "mesh query answers 503 until the mesh is redeployed",
                self.broadcast_timeout_s)
            raise MeshServingUnavailable(
                f"mesh broadcast timed out after "
                f"{self.broadcast_timeout_s:.1f}s (worker dead?); "
                f"redeploy the mesh")
        out = result[0]
        if isinstance(out, BaseException):
            self._poisoned = True
            logger.critical("mesh broadcast failed (%s: %s) — coordinator "
                            "poisoned", type(out).__name__, out)
            raise MeshServingUnavailable(
                f"mesh broadcast failed: {out}; redeploy the mesh") from out
        return out

    # -- the primary --------------------------------------------------------
    @contextmanager
    def serialized(self, payload):
        """Primary: broadcast `payload`, then hold the slot while the
        caller runs the device work (the collectives' order across the
        processes is the broadcasts' order). A worker, or a single
        process: a pass-through."""
        if not self.multi_process or not self.is_primary:
            yield
            return
        if self._poisoned:
            raise MeshServingUnavailable(
                "mesh coordinator is poisoned (an earlier broadcast never "
                "completed); redeploy the mesh")
        with self._lock:
            if self._down:
                raise RuntimeError("mesh coordinator is shut down")
            if self._poisoned:      # poisoned while this one waited
                raise MeshServingUnavailable(
                    "mesh coordinator is poisoned (an earlier broadcast "
                    "never completed); redeploy the mesh")
            self._bcast_watched(self._encode(payload))
            yield

    def shutdown(self):
        """Primary: release every worker loop (once; skipped when
        poisoned, since that broadcast would hang too)."""
        if not (self.multi_process and self.is_primary) or self._down:
            self._down = True
            return
        with self._lock:
            if self._down:
                return
            self._down = True
            if self._poisoned:
                logger.warning("mesh coordinator poisoned: skipping the "
                               "worker-release broadcast")
                return
            buf = np.zeros(self.max_bytes, np.uint8)
            buf[:4] = np.frombuffer(np.uint32(_SHUTDOWN).tobytes(),
                                    np.uint8)
            try:
                self._bcast_watched(buf)
            except Exception as e:   # the peers are gone already
                logger.warning("mesh coordinator shutdown broadcast: %s", e)

    # -- a worker -----------------------------------------------------------
    def worker_loop(self, handler: Callable[[object], object]):
        """A non-primary process: wait for the next broadcast, run the
        same pipeline (`handler` gets the decoded payload: a dict is one
        query, a list one micro-batched window), repeat until the primary
        shuts down. A handler error of the query's own (a bad field, an
        unknown id) is the one the primary met at the same point, so the
        loop goes on; a device or collective error may have left this
        process out of step, so it raises and the process ends."""
        if self.is_primary:
            raise RuntimeError("worker_loop is for process ranks above 0")
        zeros = np.zeros(self.max_bytes, np.uint8)
        while True:
            obj = self._decode(self._bcast(zeros))
            if obj is None:
                logger.info("mesh worker: shutdown")
                return
            try:
                handler(obj)
            except Exception as e:
                mod = type(e).__module__ or ""
                text = str(e)
                if (mod.startswith("torch")
                        or any(w in text for w in ("CUDA", "NCCL", "Gloo",
                                                   "gloo"))):
                    logger.critical(
                        "mesh worker: device or collective failure (%s: "
                        "%s), possibly out of step; exiting",
                        type(e).__name__, e)
                    raise
                logger.error(
                    "mesh worker: the query raised %s: %s (continuing; "
                    "the primary answers the same query with an error)",
                    type(e).__name__, e)
