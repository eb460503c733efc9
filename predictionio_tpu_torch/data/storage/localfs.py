"""Local-filesystem model store.

The port's copy of `predictionio_tpu/data/storage/localfs.py` (the
reference's LocalFSModels, LocalFSModels.scala:59): one blob file per
model id under a configured directory, the default MODELDATA backend.
"""

from __future__ import annotations

import os
from typing import Optional

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import Model


class StorageClient:
    def __init__(self, config):
        self.config = config
        self.path = (config.get("PATH") or config.get("HOSTS")
                     or os.path.join(os.path.expanduser("~/.pio_store"),
                                     "models"))
        os.makedirs(self.path, exist_ok=True)
        self._objects = {}

    def get_data_object(self, kind: str, namespace: str):
        if kind != "models":
            raise ValueError(f"localfs backend only stores models, not {kind}")
        if namespace not in self._objects:
            self._objects[namespace] = LocalFSModels(self.path, namespace)
        return self._objects[namespace]

    def close(self):
        self._objects.clear()


class LocalFSModels(base.Models):
    def __init__(self, root: str, namespace: str):
        self.dir = os.path.join(root, namespace)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, model_id: str) -> str:
        safe = model_id.replace(os.sep, "_")
        return os.path.join(self.dir, safe + ".bin")

    def insert(self, model: Model) -> None:
        tmp = self._path(model.id) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(model.models)
        os.replace(tmp, self._path(model.id))

    def get(self, model_id: str) -> Optional[Model]:
        p = self._path(model_id)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return Model(model_id, f.read())

    def delete(self, model_id: str) -> bool:
        p = self._path(model_id)
        if os.path.exists(p):
            os.remove(p)
            return True
        return False
