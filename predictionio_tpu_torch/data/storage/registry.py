"""Env-var-driven storage backend registry.

The port's copy of `predictionio_tpu/data/storage/registry.py` (the
reference's `Storage` object, Storage.scala:112-393): the repositories
METADATA / EVENTDATA / MODELDATA are bound to named sources through
`PIO_STORAGE_REPOSITORIES_<R>_{NAME,SOURCE}`; each source is configured
through `PIO_STORAGE_SOURCES_<S>_{TYPE,URL,HOSTS,PATH,...}`. With the
environment unset, SQLite holds metadata and events and localfs holds
models, under `PIO_FS_BASEDIR` (default `~/.pio_store`): the same
variables and defaults as the JAX package, so both read one store.

The registered types are those of the JAX registry: `sqlite`, `localfs`,
`memory`, `remotefs` (alias `hdfs`: model blobs at a URI), `nativelog`
(the C++ append log, events only), `eventserver` (the events DAO over a
remote event server's REST API), `docindex` (the embedded document-index
metadata store, the Elasticsearch role), and `pgsql` and `mysql` (the
server-backed SQL stores over the pure-stdlib wire clients `pgwire` and
`mywire`); any other type raises `StorageError`. `clear_cache` closes every client, which stops
nativelog's group committers and fsync loop and closes its handles.
When `PIO_FAULTS` names a storage target, every events DAO is handed
out wrapped in `resilience.faults.FaultyEvents`.
Every DAO access crosses the module lock, whose waits go into
`pio_lock_wait_seconds{lock="registry_publish"}`.
"""

from __future__ import annotations

import importlib
import os
import threading
from typing import Any, Dict, Optional

from predictionio_tpu_torch.obs.slo import lock_probe, timed_acquire

REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")

#: source TYPE -> backend module
BACKENDS = {
    "sqlite": "predictionio_tpu_torch.data.storage.sqlite",
    "localfs": "predictionio_tpu_torch.data.storage.localfs",
    "memory": "predictionio_tpu_torch.data.storage.memory",
    "remotefs": "predictionio_tpu_torch.data.storage.remotefs",
    "hdfs": "predictionio_tpu_torch.data.storage.remotefs",
    "nativelog": "predictionio_tpu_torch.data.storage.nativelog",
    "eventserver": "predictionio_tpu_torch.data.storage.eventserver_client",
    "docindex": "predictionio_tpu_torch.data.storage.docindex",
    "pgsql": "predictionio_tpu_torch.data.storage.pgsql",
    "mysql": "predictionio_tpu_torch.data.storage.mysql",
}

_lock = threading.RLock()
_clients: Dict[str, Any] = {}       # source name -> backend client
_dataobjects: Dict[str, Any] = {}   # "repo/kind" -> DAO
#: the lock-wait probe (each fold publish resolves its DAOs here)
_dao_lock_wait = lock_probe("registry_publish")


class StorageError(Exception):
    pass


class StorageClientConfig:
    """Parsed PIO_STORAGE_SOURCES_<S>_* config (Storage.scala:73)."""

    def __init__(self, name: str, type_: str, properties: Dict[str, str]):
        self.name = name
        self.type = type_
        self.properties = properties

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self.properties.get(key.upper(), default)

    def __repr__(self):
        return (f"StorageClientConfig({self.name}, {self.type}, "
                f"{self.properties})")


def base_dir() -> str:
    return os.environ.get("PIO_FS_BASEDIR",
                          os.path.expanduser("~/.pio_store"))


def _default_source_for(repo: str) -> StorageClientConfig:
    if repo == "MODELDATA":
        return StorageClientConfig(
            "LOCALFS", "localfs",
            {"HOSTS": os.path.join(base_dir(), "models")})
    return StorageClientConfig(
        "SQLITE", "sqlite", {"URL": os.path.join(base_dir(), "pio.db")})


def source_config(source_name: str) -> Optional[StorageClientConfig]:
    prefix = f"PIO_STORAGE_SOURCES_{source_name}_"
    props = {k[len(prefix):].upper(): v for k, v in os.environ.items()
             if k.startswith(prefix)}
    type_ = props.pop("TYPE", None)
    if type_ is None:
        return None
    return StorageClientConfig(source_name, type_.lower(), props)


def repository_config(repo: str) -> StorageClientConfig:
    source_name = os.environ.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE")
    if source_name:
        cfg = source_config(source_name)
        if cfg is None:
            raise StorageError(
                f"Repository {repo} references source {source_name} but "
                f"PIO_STORAGE_SOURCES_{source_name}_TYPE is not set.")
        return cfg
    return _default_source_for(repo)


def repository_namespace(repo: str) -> str:
    defaults = {"METADATA": "pio_meta", "EVENTDATA": "pio_event",
                "MODELDATA": "pio_model"}
    return os.environ.get(f"PIO_STORAGE_REPOSITORIES_{repo}_NAME",
                          defaults[repo])


def _backend_module(type_: str):
    if type_ not in BACKENDS:
        raise StorageError(f"Unknown storage source type: {type_}. "
                           f"Known types: {sorted(BACKENDS)}")
    return importlib.import_module(BACKENDS[type_])


def _client_for(cfg: StorageClientConfig):
    with _lock:
        if cfg.name not in _clients:
            _clients[cfg.name] = _backend_module(cfg.type).StorageClient(cfg)
        return _clients[cfg.name]


def get_data_object(repo: str, kind: str):
    """kind in {apps, access_keys, channels, engine_instances,
    engine_manifests, evaluation_instances, models, events}."""
    key = f"{repo}/{kind}"
    with timed_acquire(_lock, _dao_lock_wait):
        if key not in _dataobjects:
            client = _client_for(repository_config(repo))
            obj = client.get_data_object(kind, repository_namespace(repo))
            if kind == "events":
                # the chaos harness: when PIO_FAULTS names a storage
                # target, every events DAO handed out is fault-wrapped
                from predictionio_tpu_torch.resilience.faults import \
                    maybe_wrap_events
                obj = maybe_wrap_events(obj)
            _dataobjects[key] = obj
        return _dataobjects[key]


def clear_cache() -> None:
    """Close and drop the cached clients and DAOs (tests switch the
    environment between cases), and forget the cached `PIO_FAULTS`
    injector: a DAO is fault-wrapped when it is created, so a new
    `PIO_FAULTS` takes effect through this reset."""
    from predictionio_tpu_torch.resilience.faults import reset_env_injector
    reset_env_injector()
    with _lock:
        for c in _clients.values():
            c.close()
        _clients.clear()
        _dataobjects.clear()


class Storage:
    """Facade matching the reference Storage object's accessors."""

    @staticmethod
    def get_meta_data_apps():
        return get_data_object("METADATA", "apps")

    @staticmethod
    def get_meta_data_access_keys():
        return get_data_object("METADATA", "access_keys")

    @staticmethod
    def get_meta_data_channels():
        return get_data_object("METADATA", "channels")

    @staticmethod
    def get_meta_data_engine_instances():
        return get_data_object("METADATA", "engine_instances")

    @staticmethod
    def get_meta_data_engine_manifests():
        return get_data_object("METADATA", "engine_manifests")

    @staticmethod
    def get_meta_data_evaluation_instances():
        return get_data_object("METADATA", "evaluation_instances")

    @staticmethod
    def get_model_data_models():
        return get_data_object("MODELDATA", "models")

    @staticmethod
    def get_events():
        """The LEvents/PEvents analog."""
        return get_data_object("EVENTDATA", "events")

    @staticmethod
    def verify_all_data_objects() -> Dict[str, bool]:
        """Health check of `status` (Storage.scala:325-348)."""
        out = {}
        for repo, kind in (("METADATA", "apps"), ("EVENTDATA", "events"),
                           ("MODELDATA", "models")):
            try:
                get_data_object(repo, kind)
                out[repo] = True
            except Exception:
                out[repo] = False
        return out

    @staticmethod
    def config_summary() -> Dict[str, str]:
        return {repo: repository_config(repo).type for repo in REPOSITORIES}
