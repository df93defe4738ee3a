"""Webhooks: third-party payloads → event JSON.

Counterpart of ``predictionio_tpu/serving/webhooks.py``: the
``JsonConnector`` / ``FormConnector`` interfaces, a name → connector
registry for each, and the two built-in connectors, segment.io (JSON)
and MailChimp (form). A connector emits the Event API's JSON shape; the
event server validates and stores it like any other event.
"""

from __future__ import annotations

import abc
import datetime as _dt
from typing import Any, Mapping


class ConnectorError(ValueError):
    pass


class JsonConnector(abc.ABC):
    """JSON webhook → event JSON dict (reference JsonConnector.scala:21-27)."""

    @abc.abstractmethod
    def to_event_json(self, data: Mapping[str, Any]) -> dict[str, Any]: ...


class FormConnector(abc.ABC):
    """Form-encoded webhook → event JSON dict (FormConnector.scala)."""

    @abc.abstractmethod
    def to_event_json(self, data: Mapping[str, str]) -> dict[str, Any]: ...


class SegmentIOConnector(JsonConnector):
    """segment.io v2 messages (identify/track/page/screen/alias/group).

    Mapping (matches reference SegmentIOConnector.scala:43-180):
    event = message type; entity = user (userId, falling back to
    anonymousId); type-specific payload fields land in properties,
    with the optional ``context`` object merged in.
    """

    SUPPORTED = ("identify", "track", "page", "screen", "alias", "group")

    def to_event_json(self, data: Mapping[str, Any]) -> dict[str, Any]:
        msg_type = data.get("type")
        if msg_type not in self.SUPPORTED:
            raise ConnectorError(
                f"Cannot convert unknown type {msg_type!r} to event JSON."
            )
        user_id = data.get("userId") or data.get("user_id") or data.get(
            "anonymousId"
        ) or data.get("anonymous_id")
        if not user_id:
            raise ConnectorError(
                "there was no `userId` or `anonymousId` in the common fields."
            )
        props: dict[str, Any] = {}
        if msg_type == "identify":
            props["traits"] = data.get("traits") or {}
        elif msg_type == "track":
            props["event"] = data.get("event")
            props["properties"] = data.get("properties") or {}
        elif msg_type in ("page", "screen"):
            props["name"] = data.get("name")
            props["properties"] = data.get("properties") or {}
        elif msg_type == "alias":
            props["previous_id"] = data.get("previousId") or data.get(
                "previous_id"
            )
        elif msg_type == "group":
            props["group_id"] = data.get("groupId") or data.get("group_id")
            props["traits"] = data.get("traits") or {}
        if data.get("context"):
            props["context"] = data["context"]
        out: dict[str, Any] = {
            "event": msg_type,
            "entityType": "user",
            "entityId": str(user_id),
            "properties": props,
        }
        timestamp = data.get("timestamp") or data.get("sentAt")
        if timestamp:
            out["eventTime"] = timestamp
        return out


class MailChimpConnector(FormConnector):
    """MailChimp list-webhook form posts (subscribe / unsubscribe /
    profile / upemail / cleaned / campaign), matching the reference's
    field mapping (MailChimpConnector.scala:32-300)."""

    def _time(self, data: Mapping[str, str]) -> str | None:
        raw = data.get("fired_at")
        if not raw:
            return None  # omit → event defaults to now()
        try:
            t = _dt.datetime.strptime(raw, "%Y-%m-%d %H:%M:%S").replace(
                tzinfo=_dt.timezone.utc
            )
        except ValueError as e:
            raise ConnectorError(f"bad fired_at {raw!r}: {e}") from e
        return t.isoformat()

    def _merges(self, data: Mapping[str, str]) -> dict[str, Any]:
        prefix = "data[merges]["
        return {
            k[len(prefix):-1]: v
            for k, v in data.items()
            if k.startswith(prefix) and k.endswith("]")
        }

    def to_event_json(self, data: Mapping[str, str]) -> dict[str, Any]:
        msg_type = data.get("type")
        if msg_type is None:
            raise ConnectorError(
                "The field 'type' is required for MailChimp data."
            )
        handlers = {
            "subscribe": self._list_membership,
            "unsubscribe": self._list_membership,
            "profile": self._list_membership,
            "upemail": self._upemail,
            "cleaned": self._cleaned,
            "campaign": self._campaign,
        }
        handler = handlers.get(msg_type)
        if handler is None:
            raise ConnectorError(
                f"Cannot convert unknown MailChimp data type {msg_type} "
                "to event JSON"
            )
        return handler(msg_type, data)

    def _require(self, data: Mapping[str, str], key: str) -> str:
        try:
            return data[key]
        except KeyError:
            raise ConnectorError(
                f"The field '{key}' is required for MailChimp data."
            ) from None

    def _list_membership(
        self, msg_type: str, data: Mapping[str, str]
    ) -> dict[str, Any]:
        props: dict[str, Any] = {
            "email": self._require(data, "data[email]"),
            "email_type": data.get("data[email_type]", ""),
            "merges": self._merges(data),
        }
        for extra in ("data[ip_opt]", "data[ip_signup]", "data[action]",
                      "data[reason]"):
            if extra in data:
                props[extra.split("[")[1][:-1]] = data[extra]
        return {
            "event": msg_type,
            "entityType": "user",
            "entityId": self._require(data, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": self._require(data, "data[list_id]"),
            "eventTime": self._time(data),
            "properties": props,
        }

    def _upemail(self, msg_type, data) -> dict[str, Any]:
        return {
            "event": msg_type,
            "entityType": "list",
            "entityId": self._require(data, "data[list_id]"),
            "eventTime": self._time(data),
            "properties": {
                "new_id": data.get("data[new_id]", ""),
                "new_email": data.get("data[new_email]", ""),
                "old_email": data.get("data[old_email]", ""),
            },
        }

    def _cleaned(self, msg_type, data) -> dict[str, Any]:
        return {
            "event": msg_type,
            "entityType": "list",
            "entityId": self._require(data, "data[list_id]"),
            "eventTime": self._time(data),
            "properties": {
                "campaign_id": data.get("data[campaign_id]", ""),
                "reason": data.get("data[reason]", ""),
                "email": data.get("data[email]", ""),
            },
        }

    def _campaign(self, msg_type, data) -> dict[str, Any]:
        return {
            "event": msg_type,
            "entityType": "campaign",
            "entityId": self._require(data, "data[id]"),
            "eventTime": self._time(data),
            "properties": {
                "subject": data.get("data[subject]", ""),
                "status": data.get("data[status]", ""),
                "reason": data.get("data[reason]", ""),
                "list_id": data.get("data[list_id]", ""),
            },
        }


#: name → connector registry (reference WebhooksConnectors.scala)
JSON_CONNECTORS: dict[str, JsonConnector] = {
    "segmentio": SegmentIOConnector(),
}
FORM_CONNECTORS: dict[str, FormConnector] = {
    "mailchimp": MailChimpConnector(),
}
