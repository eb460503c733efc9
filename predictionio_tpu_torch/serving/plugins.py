"""Engine-server plugin interface.

The port's copy of `predictionio_tpu/serving/plugins.py`, the
reference's ``EngineServerPlugin``
(reference: core/src/main/scala/io/prediction/workflow/EngineServerPlugin.scala:21-40
and EngineServerPluginContext ServiceLoader discovery): plugins either
transform outgoing prediction JSON (outputblocker) or observe it
(outputsniffer). Discovery is by explicit registration or entry-point-style
dotted names in PIO_ENGINE_SERVER_PLUGINS."""

from __future__ import annotations

import abc
import importlib
import logging
import os
from typing import Dict, List

logger = logging.getLogger(__name__)

OUTPUT_BLOCKER = "outputblocker"
OUTPUT_SNIFFER = "outputsniffer"


class EngineServerPlugin(abc.ABC):
    plugin_name: str = "plugin"
    plugin_description: str = ""
    output_type: str = OUTPUT_SNIFFER

    def start(self, context: "EngineServerPluginContext") -> None:
        pass

    @abc.abstractmethod
    def process(self, engine_instance, query: dict, prediction: dict,
                context: "EngineServerPluginContext") -> dict:
        """outputblocker: return (possibly modified) prediction JSON;
        outputsniffer: return value ignored."""

    def handle_rest(self, arguments: List[str]) -> dict:
        return {"message": "The plugin does not support REST."}


class EngineServerPluginContext:
    def __init__(self):
        self.plugins: Dict[str, Dict[str, EngineServerPlugin]] = {
            OUTPUT_BLOCKER: {}, OUTPUT_SNIFFER: {}}

    def register(self, plugin: EngineServerPlugin):
        self.plugins[plugin.output_type][plugin.plugin_name] = plugin

    @staticmethod
    def load_from_env() -> "EngineServerPluginContext":
        """PIO_ENGINE_SERVER_PLUGINS=pkg.mod.Class,pkg2.mod.Other"""
        ctx = EngineServerPluginContext()
        spec = os.environ.get("PIO_ENGINE_SERVER_PLUGINS", "")
        for dotted in filter(None, (s.strip() for s in spec.split(","))):
            try:
                module_name, _, attr = dotted.rpartition(".")
                cls = getattr(importlib.import_module(module_name), attr)
                ctx.register(cls())
            except Exception as e:
                logger.error("Cannot load plugin %s: %s", dotted, e)
        return ctx

    def apply_output(self, engine_instance, query: dict,
                     prediction: dict) -> dict:
        for plugin in self.plugins[OUTPUT_SNIFFER].values():
            try:
                plugin.process(engine_instance, query, prediction, self)
            except Exception as e:
                logger.error("outputsniffer %s failed: %s",
                             plugin.plugin_name, e)
        out = prediction
        for plugin in self.plugins[OUTPUT_BLOCKER].values():
            out = plugin.process(engine_instance, query, out, self)
        return out

    def to_dict(self) -> dict:
        return {
            "plugins": {
                kind: {name: {"name": p.plugin_name,
                              "description": p.plugin_description,
                              "class": type(p).__name__}
                       for name, p in plugins.items()}
                for kind, plugins in self.plugins.items()}}
