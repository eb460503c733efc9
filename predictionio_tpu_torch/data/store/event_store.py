"""App-name-keyed event access for engine components.

The port's copy of the bulk-read half of
`predictionio_tpu/data/store/event_store.py` (the reference's
`PEventStore`, PEventStore.scala:30-116, and Common.scala appNameToId):
engines name apps (and channels) by name; the store resolves the ids
through the metadata DAOs and forwards to the configured Events backend.
`find` is what the fold-in scheduler tails, `find_columnar_by_entities`
what its entity-filtered read goes through, `find_columnar_chunked` the
bulk data plane's cursor. `LEventStore` is another
name for the same store, as in the reference, and `find_by_entity` is its
deadline-guarded point read (LEventStore.findByEntity), which the
e-commerce template's live business rules call at serve time. The
reference counts timed-out reads in its metrics registry, which is not
ported: `point_read_stats()` carries the count under the reference's
name, and the server's `/stats.json` shows it.
"""

from __future__ import annotations

import datetime as _dt
import threading
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.registry import Storage


class EventStore:
    def __init__(self, apps=None, channels=None, events=None):
        self._apps = apps
        self._channels = channels
        self._events = events

    @property
    def apps(self):
        return self._apps or Storage.get_meta_data_apps()

    @property
    def channels(self):
        return self._channels or Storage.get_meta_data_channels()

    @property
    def events(self):
        return self._events or Storage.get_events()

    def resolve(self, app_name: str,
                channel_name: Optional[str] = None) -> tuple:
        """app/channel name -> ids (store/Common.scala appNameToId)."""
        app = self.apps.get_by_name(app_name)
        if app is None:
            raise ValueError(
                f"Invalid app name {app_name!r}: app does not exist.")
        channel_id = None
        if channel_name is not None:
            match = [c for c in self.channels.get_by_app_id(app.id)
                     if c.name == channel_name]
            if not match:
                raise ValueError(
                    f"Invalid channel name {channel_name!r} for app "
                    f"{app_name!r}.")
            channel_id = match[0].id
        return app.id, channel_id

    def find(self, app_name: str, channel_name: Optional[str] = None,
             start_time: Optional[_dt.datetime] = None,
             until_time: Optional[_dt.datetime] = None,
             entity_type: Optional[str] = None,
             entity_id: Optional[str] = None,
             event_names: Optional[Sequence[str]] = None,
             target_entity_type=None, target_entity_id=None,
             limit: Optional[int] = None,
             reversed_order: bool = False) -> Iterator[Event]:
        """Events of an app by name (PEventStore.find, :54)."""
        app_id, channel_id = self.resolve(app_name, channel_name)
        return self.events.find(
            app_id=app_id, channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            entity_id=entity_id, event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id, limit=limit,
            reversed_order=reversed_order)

    def find_columnar(self, app_name: str,
                      channel_name: Optional[str] = None,
                      property_field: Optional[str] = None,
                      **filters) -> Dict[str, np.ndarray]:
        """Columnar bulk read (see `Events.find_columnar`): flat numpy
        arrays for training, without per-event Python objects."""
        app_id, channel_id = self.resolve(app_name, channel_name)
        return self.events.find_columnar(
            app_id=app_id, channel_id=channel_id,
            property_field=property_field, **filters)

    def find_columnar_chunked(self, app_name: str,
                              channel_name: Optional[str] = None,
                              property_field: Optional[str] = None,
                              chunk_rows: Optional[int] = None,
                              **filters) -> Iterator[Dict[str, np.ndarray]]:
        """Streaming columnar read (see `Events.find_columnar_chunked`):
        chunk column dicts that concatenate to exactly `find_columnar`."""
        app_id, channel_id = self.resolve(app_name, channel_name)
        return self.events.find_columnar_chunked(
            app_id=app_id, channel_id=channel_id,
            property_field=property_field, chunk_rows=chunk_rows,
            **filters)

    def find_columnar_by_entities(self, app_name: str,
                                  channel_name: Optional[str] = None,
                                  entity_ids=None, target_entity_ids=None,
                                  property_field: Optional[str] = None,
                                  **filters) -> Dict[str, np.ndarray]:
        """Entity-filtered columnar read (see
        `Events.find_columnar_by_entities`)."""
        app_id, channel_id = self.resolve(app_name, channel_name)
        return self.events.find_columnar_by_entities(
            app_id=app_id, channel_id=channel_id, entity_ids=entity_ids,
            target_entity_ids=target_entity_ids,
            property_field=property_field, **filters)

    def aggregate_properties(self, app_name: str, entity_type: str,
                             channel_name: Optional[str] = None,
                             start_time: Optional[_dt.datetime] = None,
                             until_time: Optional[_dt.datetime] = None,
                             required: Optional[Sequence[str]] = None
                             ) -> Dict[str, PropertyMap]:
        """PEventStore.aggregateProperties."""
        app_id, channel_id = self.resolve(app_name, channel_name)
        return self.events.aggregate_properties(
            app_id=app_id, channel_id=channel_id, entity_type=entity_type,
            start_time=start_time, until_time=until_time, required=required)


    # -- serve-time point reads (LEventStore.findByEntity) -----------------

    #: cap on concurrently outstanding deadline-guarded point reads. A
    #: timed-out read's worker thread keeps running against the slow
    #: backend (a Python thread cannot be killed); the permit it holds is
    #: released only when the backend answers, so at most this many
    #: wedged readers pile up, and past that new deadline reads fail at
    #: their own deadline instead of minting another stuck thread each.
    POINT_READ_MAX_INFLIGHT = 8

    _point_read_sem = threading.BoundedSemaphore(POINT_READ_MAX_INFLIGHT)
    _timeouts_lock = threading.Lock()
    _timeouts = 0

    @staticmethod
    def _count_timeout() -> None:
        with EventStore._timeouts_lock:
            EventStore._timeouts += 1

    @staticmethod
    def point_read_stats() -> dict:
        """The timed-out point reads of this process, under the
        reference's metric name."""
        with EventStore._timeouts_lock:
            return {"pio_event_point_read_timeout_total":
                    EventStore._timeouts}

    def find_by_entity(self, app_name: str, entity_type: str,
                       entity_id: str, channel_name: Optional[str] = None,
                       event_names: Optional[Sequence[str]] = None,
                       target_entity_type=None, target_entity_id=None,
                       start_time=None, until_time=None,
                       limit: Optional[int] = None, latest: bool = True,
                       timeout_ms: Optional[int] = None) -> list:
        """An entity's events, latest first unless `latest` is False, with
        an optional deadline (LEventStore.scala:30; the e-commerce
        template passes 200 ms). With a timeout the read runs on a worker
        thread under one of POINT_READ_MAX_INFLIGHT permits, and the wait
        for a permit shares the deadline; a read that misses it raises
        TimeoutError and is counted (`point_read_stats`)."""
        def _query():
            return list(self.find(
                app_name=app_name, channel_name=channel_name,
                entity_type=entity_type, entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id, start_time=start_time,
                until_time=until_time, limit=limit, reversed_order=latest))

        if timeout_ms is None:
            return _query()
        # a healthy burst past the permit count queues briefly and still
        # answers in time; permits stranded by a wedged backend make new
        # reads fail at their own deadline
        t_start = time.monotonic()
        # the worker returns the permit to the semaphore it came from,
        # even if the class's has been replaced meanwhile
        sem = EventStore._point_read_sem
        if not sem.acquire(timeout=timeout_ms / 1000.0):
            self._count_timeout()
            raise TimeoutError(
                f"event lookup exceeded {timeout_ms} ms deadline: all "
                f"{self.POINT_READ_MAX_INFLIGHT} deadline-read workers "
                "are busy (backend wedged?)")
        done = threading.Event()
        result: list = []
        error: list = []

        def _run():
            try:
                result.append(_query())
            except Exception as e:  # raised below if still awaited
                error.append(e)
            finally:
                sem.release()
                done.set()

        threading.Thread(target=_run, daemon=True,
                         name="pio-point-read").start()
        remaining = timeout_ms / 1000.0 - (time.monotonic() - t_start)
        if not done.wait(max(0.0, remaining)):
            # the worker keeps its permit until the backend answers; its
            # late result is dropped
            self._count_timeout()
            raise TimeoutError(
                f"event lookup exceeded {timeout_ms} ms deadline")
        if error:
            raise error[0]
        return result[0]


# Module-level default instance, as the reference's singleton.
PEventStore = EventStore()
LEventStore = PEventStore
