"""MailChimp form webhook connector.

The port's copy of `predictionio_tpu/data/webhooks/mailchimp.py`, the
reference connector (reference:
data/src/main/scala/io/prediction/data/webhooks/mailchimp/
MailChimpConnector.scala): subscribe/unsubscribe/profile/upemail/cleaned/
campaign form payloads -> events. MailChimp timestamps are
"yyyy-MM-dd HH:mm:ss" in UTC.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict

from predictionio_tpu_torch.data.event import UTC, format_event_time
from predictionio_tpu_torch.data.webhooks.base import (ConnectorException,
                                                       FormConnector)


def _parse_time(s: str) -> str:
    t = _dt.datetime.strptime(s, "%Y-%m-%d %H:%M:%S").replace(tzinfo=UTC)
    return format_event_time(t)


class MailChimpConnector(FormConnector):
    def to_event_dict(self, form: Dict[str, str]) -> dict:
        typ = form.get("type")
        if typ is None:
            raise ConnectorException(
                "The field 'type' is required for MailChimp data.")
        handlers = {
            "subscribe": self._subscribe,
            "unsubscribe": self._unsubscribe,
            "profile": self._profile,
            "upemail": self._upemail,
            "cleaned": self._cleaned,
            "campaign": self._campaign,
        }
        if typ not in handlers:
            raise ConnectorException(
                f"Cannot convert unknown MailChimp data type {typ} to "
                "event JSON")
        return handlers[typ](form)

    @staticmethod
    def _req(form, key):
        if key not in form:
            raise ConnectorException(f"missing field {key}")
        return form[key]

    @classmethod
    def _merges(cls, form) -> dict:
        merges = {
            "EMAIL": cls._req(form, "data[merges][EMAIL]"),
            "FNAME": cls._req(form, "data[merges][FNAME]"),
            "LNAME": cls._req(form, "data[merges][LNAME]"),
        }
        if "data[merges][INTERESTS]" in form:
            merges["INTERESTS"] = form["data[merges][INTERESTS]"]
        return merges

    def _subscribe(self, form):
        return {
            "event": "subscribe", "entityType": "user",
            "entityId": self._req(form, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": self._req(form, "data[list_id]"),
            "eventTime": _parse_time(self._req(form, "fired_at")),
            "properties": {
                "email": self._req(form, "data[email]"),
                "email_type": self._req(form, "data[email_type]"),
                "merges": self._merges(form),
                "ip_opt": self._req(form, "data[ip_opt]"),
                "ip_signup": self._req(form, "data[ip_signup]"),
            }}

    def _unsubscribe(self, form):
        return {
            "event": "unsubscribe", "entityType": "user",
            "entityId": self._req(form, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": self._req(form, "data[list_id]"),
            "eventTime": _parse_time(self._req(form, "fired_at")),
            "properties": {
                "action": self._req(form, "data[action]"),
                "reason": self._req(form, "data[reason]"),
                "email": self._req(form, "data[email]"),
                "email_type": self._req(form, "data[email_type]"),
                "merges": self._merges(form),
                "ip_opt": self._req(form, "data[ip_opt]"),
                "campaign_id": self._req(form, "data[campaign_id]"),
            }}

    def _profile(self, form):
        return {
            "event": "profile", "entityType": "user",
            "entityId": self._req(form, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": self._req(form, "data[list_id]"),
            "eventTime": _parse_time(self._req(form, "fired_at")),
            "properties": {
                "email": self._req(form, "data[email]"),
                "email_type": self._req(form, "data[email_type]"),
                "merges": self._merges(form),
                "ip_opt": self._req(form, "data[ip_opt]"),
            }}

    def _upemail(self, form):
        return {
            "event": "upemail", "entityType": "user",
            "entityId": self._req(form, "data[new_id]"),
            "targetEntityType": "list",
            "targetEntityId": self._req(form, "data[list_id]"),
            "eventTime": _parse_time(self._req(form, "fired_at")),
            "properties": {
                "new_email": self._req(form, "data[new_email]"),
                "old_email": self._req(form, "data[old_email]"),
            }}

    def _cleaned(self, form):
        return {
            "event": "cleaned", "entityType": "list",
            "entityId": self._req(form, "data[list_id]"),
            "eventTime": _parse_time(self._req(form, "fired_at")),
            "properties": {
                "campaignId": self._req(form, "data[campaign_id]"),
                "reason": self._req(form, "data[reason]"),
                "email": self._req(form, "data[email]"),
            }}

    def _campaign(self, form):
        return {
            "event": "campaign", "entityType": "campaign",
            "entityId": self._req(form, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": self._req(form, "data[list_id]"),
            "eventTime": _parse_time(self._req(form, "fired_at")),
            "properties": {
                "subject": self._req(form, "data[subject]"),
                "status": self._req(form, "data[status]"),
                "reason": self._req(form, "data[reason]"),
            }}
