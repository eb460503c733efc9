"""segment.io JSON webhook connector.

The port's copy of `predictionio_tpu/data/webhooks/segmentio.py`, the
reference connector (reference:
data/src/main/scala/io/prediction/data/webhooks/segmentio/
SegmentIOConnector.scala): maps identify/track/alias/page/screen/group
payloads to events keyed by userId (falling back to anonymousId), carrying
type-specific properties plus optional `context`.
"""

from __future__ import annotations

from predictionio_tpu_torch.data.webhooks.base import (ConnectorException,
                                                       JsonConnector)


class SegmentIOConnector(JsonConnector):
    SUPPORTED = ("identify", "track", "alias", "page", "screen", "group")

    def to_event_dict(self, data: dict) -> dict:
        typ = data.get("type")
        if typ is None:
            raise ConnectorException(
                f"Cannot extract Common field from {data}.")
        if typ not in self.SUPPORTED:
            raise ConnectorException(
                f"Cannot convert unknown type {typ} to event JSON.")
        user_id = data.get("userId") or data.get("anonymousId")
        if not user_id:
            raise ConnectorException(
                "there was no `userId` or `anonymousId` in the common "
                "fields.")
        props = self._event_properties(typ, data)
        if "context" in data and data["context"] is not None:
            props = {"context": data["context"], **props}
        out = {
            "event": typ,
            "entityType": "user",
            "entityId": user_id,
            "properties": props,
        }
        if data.get("timestamp"):
            out["eventTime"] = data["timestamp"]
        return out

    @staticmethod
    def _event_properties(typ: str, data: dict) -> dict:
        def req(key):
            if key not in data:
                raise ConnectorException(
                    f"Cannot convert {data} to event JSON. missing {key}")
            return data[key]

        if typ == "identify":
            req("userId")
            return {"traits": data.get("traits")}
        if typ == "track":
            return {"properties": data.get("properties"),
                    "event": req("event")}
        if typ == "alias":
            return {"previousId": req("previousId")}
        if typ == "page":
            return {"name": req("name"),
                    "properties": data.get("properties")}
        if typ == "screen":
            return {"name": req("name"),
                    "properties": data.get("properties")}
        if typ == "group":
            return {"groupId": req("groupId"),
                    "traits": data.get("traits")}
        raise ConnectorException(f"unhandled type {typ}")
