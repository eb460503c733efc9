"""App-name-keyed event access for engine components.

The port's copy of the bulk-read half of
`predictionio_tpu/data/store/event_store.py` (the reference's
`PEventStore`, PEventStore.scala:30-116, and Common.scala appNameToId):
engines name apps (and channels) by name; the store resolves the ids
through the metadata DAOs and forwards to the configured Events backend.
`find` is what the fold-in scheduler tails, `find_columnar_by_entities`
what its entity-filtered read goes through. `LEventStore` is another
name for the same store, as in the reference; its deadline-guarded point
reads are a later slice.
"""

from __future__ import annotations

import datetime as _dt
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


# Module-level default instance, as the reference's singleton.
PEventStore = EventStore()
LEventStore = PEventStore
