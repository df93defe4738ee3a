"""Columnar event interchange files.

Counterpart of ``predictionio_tpu/data/eventfile.py``, writing the same
on-disk layout, so an export of either package imports into the other.

The reference's ``pio export`` writes either JSON lines or **parquet**
(``tools/.../export/EventsToFile.scala:40-104``, format flag at
``Console.scala:604-618``) and ``pio import`` reads them back
(``imprt/FileToEvents.scala:41-103``). The columnar
interchange format is a compressed ``.npz`` of per-field numpy columns
— the same container :mod:`predictionio_tpu_torch.data.view` uses for cached
views, but with **full event fidelity** (tags, prId, event ids,
creation times — everything the DB serializer round-trips), so
``export → import`` reproduces the event log exactly.

Hot string fields are real columns (scan a column without touching the
rest — the property parquet buys the reference); variable-shape fields
(properties, tags) travel as JSON-encoded string columns. Times are
ISO-8601 strings to preserve timezones bit-for-bit with the JSON-lines
format. ``allow_pickle`` stays False on read: untrusted export files
must not execute code.
"""

from __future__ import annotations

import datetime as _dt
import json
from typing import Iterable, Iterator

import numpy as np

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event

#: bumped on layout changes; readers reject files they don't understand
FORMAT_VERSION = 1


def write_events_npz(events: Iterable[Event], path: str) -> int:
    """Write events as a columnar npz; returns the row count.

    Atomic: lands under a temp name first, like the view cache.
    """
    ev, ety, eid, tty, tid = [], [], [], [], []
    t_event, t_creation, props, tags, pr, ids = [], [], [], [], [], []
    for e in events:
        ev.append(e.event)
        ety.append(e.entity_type)
        eid.append(e.entity_id)
        tty.append(e.target_entity_type or "")
        tid.append(e.target_entity_id or "")
        t_event.append(e.event_time.isoformat())
        t_creation.append(e.creation_time.isoformat())
        props.append(json.dumps(e.properties.to_dict()))
        tags.append(json.dumps(list(e.tags)))
        pr.append(e.pr_id or "")
        ids.append(e.event_id or "")
    from predictionio_tpu_torch.utils.npzio import atomic_savez

    atomic_savez(
        path,
        format_version=np.asarray([FORMAT_VERSION], dtype=np.int64),
        event=np.asarray(ev, dtype=np.str_),
        entity_type=np.asarray(ety, dtype=np.str_),
        entity_id=np.asarray(eid, dtype=np.str_),
        target_entity_type=np.asarray(tty, dtype=np.str_),
        target_entity_id=np.asarray(tid, dtype=np.str_),
        event_time=np.asarray(t_event, dtype=np.str_),
        creation_time=np.asarray(t_creation, dtype=np.str_),
        properties=np.asarray(props, dtype=np.str_),
        tags=np.asarray(tags, dtype=np.str_),
        pr_id=np.asarray(pr, dtype=np.str_),
        event_id=np.asarray(ids, dtype=np.str_),
    )
    return len(ev)


def read_events_npz(path: str) -> Iterator[Event]:
    """Yield events from a columnar npz written by
    :func:`write_events_npz`."""
    with np.load(path, allow_pickle=False) as z:
        names = set(z.files)
        if "format_version" not in names:
            raise ValueError(
                f"{path} is not an event export (no format_version)"
            )
        version = int(z["format_version"][0])
        if version != FORMAT_VERSION:
            raise ValueError(
                f"{path}: unsupported event-file version {version} "
                f"(this build reads {FORMAT_VERSION})"
            )
        cols = {
            name: z[name]
            for name in (
                "event",
                "entity_type",
                "entity_id",
                "target_entity_type",
                "target_entity_id",
                "event_time",
                "creation_time",
                "properties",
                "tags",
                "pr_id",
                "event_id",
            )
        }
    for i in range(len(cols["event"])):
        yield Event(
            event=str(cols["event"][i]),
            entity_type=str(cols["entity_type"][i]),
            entity_id=str(cols["entity_id"][i]),
            target_entity_type=str(cols["target_entity_type"][i]) or None,
            target_entity_id=str(cols["target_entity_id"][i]) or None,
            properties=DataMap(json.loads(str(cols["properties"][i]))),
            event_time=_dt.datetime.fromisoformat(
                str(cols["event_time"][i])
            ),
            creation_time=_dt.datetime.fromisoformat(
                str(cols["creation_time"][i])
            ),
            tags=tuple(json.loads(str(cols["tags"][i]))),
            pr_id=str(cols["pr_id"][i]) or None,
            event_id=str(cols["event_id"][i]) or None,
        )
