"""Event-server plugin interface.

The port's copy of `predictionio_tpu/data/api/plugins.py`, the
reference's ``EventServerPlugin``
(reference: data/src/main/scala/io/prediction/data/api/EventServerPlugin.scala:18-32
and api/PluginsActor.scala): inputblocker plugins validate/veto incoming
events, inputsniffer plugins observe them; both are discovered from
PIO_EVENT_SERVER_PLUGINS (dotted class names) or registered explicitly.
"""

from __future__ import annotations

import abc
import importlib
import logging
import os
from typing import Dict, List

logger = logging.getLogger(__name__)

INPUT_BLOCKER = "inputblocker"
INPUT_SNIFFER = "inputsniffer"


class EventServerPlugin(abc.ABC):
    plugin_name: str = "plugin"
    plugin_description: str = ""
    input_type: str = INPUT_SNIFFER

    def start(self, context: "EventServerPluginContext") -> None:
        pass

    @abc.abstractmethod
    def process(self, event_info: dict,
                context: "EventServerPluginContext") -> None:
        """inputblocker: raise ValueError to reject the event;
        inputsniffer: observe only."""

    def handle_rest(self, app_id: int, channel_id, arguments: List[str]):
        return {"message": "The plugin does not support REST."}


class EventServerPluginContext:
    def __init__(self):
        self.plugins: Dict[str, Dict[str, EventServerPlugin]] = {
            INPUT_BLOCKER: {}, INPUT_SNIFFER: {}}

    def register(self, plugin: EventServerPlugin):
        self.plugins[plugin.input_type][plugin.plugin_name] = plugin

    @staticmethod
    def load_from_env() -> "EventServerPluginContext":
        ctx = EventServerPluginContext()
        spec = os.environ.get("PIO_EVENT_SERVER_PLUGINS", "")
        for dotted in filter(None, (s.strip() for s in spec.split(","))):
            try:
                module_name, _, attr = dotted.rpartition(".")
                cls = getattr(importlib.import_module(module_name), attr)
                ctx.register(cls())
            except Exception as e:
                logger.error("Cannot load plugin %s: %s", dotted, e)
        return ctx

    def check_input(self, event_info: dict) -> None:
        """Run inputblockers (may raise) then inputsniffers."""
        for plugin in self.plugins[INPUT_BLOCKER].values():
            plugin.process(event_info, self)
        for plugin in self.plugins[INPUT_SNIFFER].values():
            try:
                plugin.process(event_info, self)
            except Exception as e:
                logger.error("inputsniffer %s failed: %s",
                             plugin.plugin_name, e)

    def to_dict(self) -> dict:
        return {
            "plugins": {
                kind: {name: {"name": p.plugin_name,
                              "description": p.plugin_description,
                              "class": type(p).__name__}
                       for name, p in plugins.items()}
                for kind, plugins in self.plugins.items()}}
