"""Webhook connectors: third-party payloads -> events.

The port's copy of `predictionio_tpu/data/webhooks`, the reference's
webhook framework (reference:
data/src/main/scala/io/prediction/data/webhooks/{JsonConnector,FormConnector,
ConnectorUtil}.scala and the registry api/WebhooksConnectors.scala:34 —
segment.io as the JSON connector, MailChimp as the form connector).
"""

from predictionio_tpu_torch.data.webhooks.base import (
    ConnectorException, ConnectorRegistry, FormConnector, JsonConnector)


def default_connectors() -> ConnectorRegistry:
    from predictionio_tpu_torch.data.webhooks.mailchimp import \
        MailChimpConnector
    from predictionio_tpu_torch.data.webhooks.segmentio import \
        SegmentIOConnector
    reg = ConnectorRegistry()
    reg.register_json("segmentio", SegmentIOConnector())
    reg.register_form("mailchimp", MailChimpConnector())
    return reg


__all__ = ["ConnectorException", "ConnectorRegistry", "FormConnector",
           "JsonConnector", "default_connectors"]
