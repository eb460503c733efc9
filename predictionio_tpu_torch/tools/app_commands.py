"""App / access-key / channel management commands.

The port's copy of `predictionio_tpu/tools/app_commands.py`, the
reference's console App commands
(reference: tools/src/main/scala/io/prediction/tools/console/App.scala —
create: insert App -> LEvents.init(appId) -> create AccessKey; list/show/
delete/data-delete; channel-new/channel-delete).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional

from predictionio_tpu_torch.data.storage.base import (AccessKey, App,
                                                      Channel)
from predictionio_tpu_torch.data.storage.registry import Storage

logger = logging.getLogger(__name__)


class AppCommandError(Exception):
    pass


@dataclass
class AppDescription:
    app: App
    access_keys: List[AccessKey]
    channels: List[Channel]


def app_new(name: str, app_id: int = 0, description: Optional[str] = None,
            access_key: str = "") -> AppDescription:
    apps = Storage.get_meta_data_apps()
    if apps.get_by_name(name) is not None:
        raise AppCommandError(f"App {name} already exists. Aborting.")
    if app_id != 0 and apps.get(app_id) is not None:
        raise AppCommandError(f"App ID {app_id} already exists. Aborting.")
    new_id = apps.insert(App(app_id, name, description))
    if new_id is None:
        raise AppCommandError("Unable to create new app.")
    Storage.get_events().init(new_id)
    key = Storage.get_meta_data_access_keys().insert(
        AccessKey(access_key, new_id, []))
    if key is None:
        raise AppCommandError("Unable to create new access key.")
    app = apps.get(new_id)
    logger.info("Created app %s (id %d) with access key %s",
                name, new_id, key)
    return AppDescription(app=app,
                          access_keys=[AccessKey(key, new_id, [])],
                          channels=[])


def app_list() -> List[AppDescription]:
    apps = Storage.get_meta_data_apps().get_all()
    keys = Storage.get_meta_data_access_keys()
    channels = Storage.get_meta_data_channels()
    return [AppDescription(app=a, access_keys=keys.get_by_app_id(a.id),
                           channels=channels.get_by_app_id(a.id))
            for a in apps]


def app_show(name: str) -> AppDescription:
    app = Storage.get_meta_data_apps().get_by_name(name)
    if app is None:
        raise AppCommandError(f"App {name} does not exist. Aborting.")
    return AppDescription(
        app=app,
        access_keys=Storage.get_meta_data_access_keys().get_by_app_id(app.id),
        channels=Storage.get_meta_data_channels().get_by_app_id(app.id))


def app_delete(name: str) -> None:
    desc = app_show(name)
    events = Storage.get_events()
    for channel in desc.channels:
        events.remove(desc.app.id, channel.id)
        Storage.get_meta_data_channels().delete(channel.id)
    events.remove(desc.app.id)
    for k in desc.access_keys:
        Storage.get_meta_data_access_keys().delete(k.key)
    if not Storage.get_meta_data_apps().delete(desc.app.id):
        raise AppCommandError(f"Unable to delete app {name}.")
    logger.info("Deleted app %s.", name)


def app_data_delete(name: str, channel: Optional[str] = None,
                    delete_all: bool = False) -> None:
    desc = app_show(name)
    events = Storage.get_events()
    if delete_all:
        events.remove(desc.app.id)
        events.init(desc.app.id)
        for ch in desc.channels:
            events.remove(desc.app.id, ch.id)
            events.init(desc.app.id, ch.id)
        return
    if channel is not None:
        match = [c for c in desc.channels if c.name == channel]
        if not match:
            raise AppCommandError(
                f"Unable to delete data for channel. Channel {channel} "
                "doesn't exist.")
        events.remove(desc.app.id, match[0].id)
        events.init(desc.app.id, match[0].id)
    else:
        events.remove(desc.app.id)
        events.init(desc.app.id)


def channel_new(app_name: str, channel_name: str) -> Channel:
    desc = app_show(app_name)
    if any(c.name == channel_name for c in desc.channels):
        raise AppCommandError(
            f"Unable to create new channel. Channel {channel_name} already "
            "exists.")
    if not Channel.is_valid_name(channel_name):
        raise AppCommandError(
            f"Unable to create new channel. The channel name "
            f"{channel_name} is invalid. {Channel.NAME_CONSTRAINT}")
    cid = Storage.get_meta_data_channels().insert(
        Channel(0, channel_name, desc.app.id))
    if cid is None:
        raise AppCommandError("Unable to create new channel.")
    Storage.get_events().init(desc.app.id, cid)
    return Channel(cid, channel_name, desc.app.id)


def channel_delete(app_name: str, channel_name: str) -> None:
    desc = app_show(app_name)
    match = [c for c in desc.channels if c.name == channel_name]
    if not match:
        raise AppCommandError(
            f"Unable to delete channel. Channel {channel_name} doesn't "
            "exist.")
    Storage.get_events().remove(desc.app.id, match[0].id)
    if not Storage.get_meta_data_channels().delete(match[0].id):
        raise AppCommandError("Unable to delete channel.")


def accesskey_new(app_name: str, key: str = "",
                  events: Optional[List[str]] = None) -> AccessKey:
    desc = app_show(app_name)
    created = Storage.get_meta_data_access_keys().insert(
        AccessKey(key, desc.app.id, tuple(events or ())))
    if created is None:
        raise AppCommandError("Unable to create new access key.")
    return AccessKey(created, desc.app.id, tuple(events or ()))


def accesskey_list(app_name: Optional[str] = None) -> List[AccessKey]:
    dao = Storage.get_meta_data_access_keys()
    if app_name is None:
        return dao.get_all()
    return dao.get_by_app_id(app_show(app_name).app.id)


def accesskey_delete(key: str) -> None:
    if not Storage.get_meta_data_access_keys().delete(key):
        raise AppCommandError(f"Unable to delete access key {key}.")
