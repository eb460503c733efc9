"""URI-addressed model blob store (the HDFS-role backend).

The port's copy of `predictionio_tpu/data/storage/remotefs.py`: the
reference's HDFS model store (hdfs/{StorageClient,HDFSModels}.scala:60,
model blobs at a filesystem URI addressed by engine-instance id) over a
registry of URI schemes:

  - `file://` works as shipped (local or mounted paths);
  - another scheme (`hdfs://`, `gs://`, `s3://`) plugs in an adapter with
    `register_scheme`: an object with read/write/delete/exists.

Config: `PIO_STORAGE_SOURCES_<S>_TYPE=remotefs` (alias `hdfs`) and
`PIO_STORAGE_SOURCES_<S>_URL=file:///shared/models` (or `PATH=...`).
`adapter_for` also serves the template gallery (`tools/templates.py`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional
from urllib.parse import urlparse

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import Model
from predictionio_tpu_torch.data.storage.registry import (StorageError,
                                                          base_dir)


class SchemeAdapter:
    """Filesystem adapter interface for one URI scheme."""

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def write(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def delete(self, path: str) -> bool:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError


class LocalFileAdapter(SchemeAdapter):
    """file:// — local or mounted (NFS/FUSE) paths."""

    def read(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)        # atomic publish

    def delete(self, path: str) -> bool:
        try:
            os.remove(path)
            return True
        except FileNotFoundError:
            return False

    def exists(self, path: str) -> bool:
        return os.path.exists(path)


_SCHEMES: Dict[str, SchemeAdapter] = {"file": LocalFileAdapter(),
                                      "": LocalFileAdapter()}


def register_scheme(scheme: str, adapter: SchemeAdapter) -> None:
    """Plug in a remote filesystem (hdfs/gs/s3/...) client."""
    _SCHEMES[scheme] = adapter


def adapter_for(url: str) -> "tuple[SchemeAdapter, str]":
    u = urlparse(url)
    if u.scheme not in _SCHEMES:
        raise StorageError(
            f"no adapter registered for scheme {u.scheme!r} "
            f"(register one with remotefs.register_scheme); "
            f"known: {sorted(s for s in _SCHEMES if s)}")
    root = (u.netloc + u.path) if u.scheme not in ("file", "") else u.path
    return _SCHEMES[u.scheme], root


class StorageClient:
    def __init__(self, config):
        self.config = config
        url = config.get("URL") or config.get("PATH") or os.path.join(
            base_dir(), "remote_models")
        self.adapter, self.root = adapter_for(url)
        self._objects = {}

    def get_data_object(self, kind: str, namespace: str):
        if kind != "models":
            raise StorageError(
                f"remotefs backend stores models only, not {kind!r} "
                "(the reference HDFS backend likewise)")
        key = f"{namespace}/{kind}"
        if key not in self._objects:
            self._objects[key] = RemoteFSModels(self.adapter, self.root,
                                                namespace)
        return self._objects[key]

    def close(self):
        self._objects.clear()


class RemoteFSModels(base.Models):
    """Blob-per-model at <root>/<namespace>/<id> (HDFSModels.scala:40-76)."""

    def __init__(self, adapter: SchemeAdapter, root: str, ns: str):
        self.adapter = adapter
        self.root = root
        self.ns = ns

    def _path(self, model_id: str) -> str:
        safe = model_id.replace("/", "_")
        return os.path.join(self.root, self.ns, safe)

    def insert(self, model: Model) -> None:
        self.adapter.write(self._path(model.id), model.models)

    def get(self, model_id: str) -> Optional[Model]:
        p = self._path(model_id)
        if not self.adapter.exists(p):
            return None
        return Model(model_id, self.adapter.read(p))

    def delete(self, model_id: str) -> bool:
        return self.adapter.delete(self._path(model_id))
