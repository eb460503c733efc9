"""Connector interfaces: the port's copy of
`predictionio_tpu/data/webhooks/base.py` (reference: data/webhooks/{JsonConnector,
FormConnector}.scala, ConnectorUtil.scala toEvent)."""

from __future__ import annotations

import abc
from typing import Dict, Optional

from predictionio_tpu_torch.data.event import Event


class ConnectorException(ValueError):
    pass


class JsonConnector(abc.ABC):
    @abc.abstractmethod
    def to_event_dict(self, data: dict) -> dict:
        """Third-party JSON -> event JSON dict."""

    def to_event(self, data: dict) -> Event:
        return Event.from_dict(self.to_event_dict(data))


class FormConnector(abc.ABC):
    @abc.abstractmethod
    def to_event_dict(self, form: Dict[str, str]) -> dict:
        """Form fields -> event JSON dict."""

    def to_event(self, form: Dict[str, str]) -> Event:
        return Event.from_dict(self.to_event_dict(form))


class ConnectorRegistry:
    def __init__(self):
        self._json: Dict[str, JsonConnector] = {}
        self._form: Dict[str, FormConnector] = {}

    def register_json(self, name: str, connector: JsonConnector):
        self._json[name] = connector

    def register_form(self, name: str, connector: FormConnector):
        self._form[name] = connector

    def get_json(self, name: str) -> Optional[JsonConnector]:
        return self._json.get(name)

    def get_form(self, name: str) -> Optional[FormConnector]:
        return self._form.get(name)
