"""The native event log: an events backend over ``native/eventlog.cc``.

Counterpart of ``predictionio_tpu/data/storage/eventlog.py``, through
``ctypes``: an append-only binary log per (app, channel) with a
persistent string interner, and *columnar* scans.
:meth:`EventLogEvents.interactions` turns a scan straight into dense-id
COO arrays (no per-event Python objects, no host-side re-interning):
the training read at scale.

The library is the same C++ source as the JAX package's, built by the
port's own loader (:mod:`predictionio_tpu_torch.ops._build`) into
``build/native/``. The on-disk format is the library's, so a log written
by either package is read by the other.
"""

from __future__ import annotations

import contextlib
import ctypes
import datetime as _dt
import fcntl
import json
import logging
import os
import shutil
import struct
import sys
import threading
from typing import Iterator, Sequence

import numpy as np

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.eventframe import Interactions
from predictionio_tpu_torch.data.storage.base import (
    EventsBackend,
    PartialBatchError,
)
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.utils.bimap import BiMap

logger = logging.getLogger(__name__)

_NAN = float("nan")


def _fsync_enabled() -> bool:
    """``PIO_EVENTLOG_FSYNC=1`` turns appends into batch-commit fsyncs:
    one durability barrier per write-lock section (a whole
    ``insert_batch`` pays it once), making the durable prefix survive
    power loss, not just process death. Default off — appends already
    fflush, so kill -9 loses nothing; fsync is the disk-latency tax
    for the continuous-training ingest path (ROADMAP) where replayed
    events feed training and must not silently vanish."""
    return os.environ.get("PIO_EVENTLOG_FSYNC", "").strip().lower() in (
        "1", "true", "yes", "on",
    )


class _Log:
    """One (app, channel) log directory.

    Cross-process write discipline: every intern+append pair runs under
    an exclusive ``flock`` on ``write.lock`` with the dictionary
    reloaded first, so concurrent writer processes (event server +
    import job) agree on interner ids. Readers reload the dictionary
    before decoding a scan.
    """

    def __init__(self, path: str):
        self.lib = _build.library("eventlog")  # builds into build/native/
        os.makedirs(path, exist_ok=True)
        self.handle = self.lib.pio_log_open(path.encode())
        if not self.handle:
            raise RuntimeError(f"cannot open event log at {path}")
        # read once at open: flipping the env mid-process is not a
        # supported way to change durability of an open log
        self.fsync_on_commit = _fsync_enabled()
        self.lock = threading.Lock()
        self._flock_file = open(  # noqa: SIM115 - held for log lifetime
            os.path.join(path, "write.lock"), "a"
        )
        # mirror of the persistent dictionary for decode / lookup
        self.strings: list[str] = []
        self.ids: dict[str, int] = {}
        self._refresh_dict()

    @contextlib.contextmanager
    def write_lock(self):
        """Thread lock + cross-process flock, dict resynced inside.
        With ``PIO_EVENTLOG_FSYNC`` on, the commit point — one fsync
        for everything appended in the section — happens before the
        lock releases, so an insert/insert_batch that returned has its
        events on stable storage."""
        with self.lock:
            fcntl.flock(self._flock_file, fcntl.LOCK_EX)
            try:
                self.reload_dict()
                yield
            finally:
                try:
                    # sync even when the section raised mid-batch: a
                    # PartialBatchError's acked prefix must be durable
                    # too — clients retry only the remainder
                    if (
                        self.fsync_on_commit
                        and self.lib.pio_log_sync(self.handle) != 0
                    ):
                        # acking a write that is not durable is worse
                        # than an error; but never mask an exception
                        # already propagating out of the section
                        if sys.exc_info()[0] is None:
                            raise OSError(
                                "event log fsync failed; the last "
                                "append may not be durable"
                            )
                        logger.error(
                            "event log fsync failed during an already-"
                            "failing write section"
                        )
                finally:
                    fcntl.flock(self._flock_file, fcntl.LOCK_UN)

    def reload_dict(self) -> None:
        """Pick up dictionary entries appended by other processes."""
        self.lib.pio_dict_reload(self.handle)
        self._refresh_dict()

    def _refresh_dict(self) -> None:
        size = self.lib.pio_dict_size(self.handle)
        while len(self.strings) < size:
            i = len(self.strings)
            n = self.lib.pio_dict_get(self.handle, i, None, 0)
            buf = ctypes.create_string_buffer(n)
            self.lib.pio_dict_get(self.handle, i, buf, n)
            s = buf.raw[:n].decode()
            self.ids[s] = i
            self.strings.append(s)

    def intern(self, s: str) -> int:
        cached = self.ids.get(s)
        if cached is not None:
            return cached
        raw = s.encode()
        i = self.lib.pio_intern(self.handle, raw, len(raw))
        if i == len(self.strings):
            self.strings.append(s)
            self.ids[s] = i
        else:
            self._refresh_dict()
        return i

    def lookup(self, s: str) -> int | None:
        return self.ids.get(s)

    def close(self) -> None:
        if self.handle:
            self.lib.pio_log_close(self.handle)
            self.handle = None
        self._flock_file.close()


class _Scan:
    """Columnar scan result as numpy views (copied before free)."""

    def __init__(self, lib, ptr):
        n = lib.pio_result_n(ptr)
        self.n = n

        def arr(fn, dtype):
            p = fn(ptr)
            if n == 0 or not p:
                return np.zeros(0, dtype)
            return np.ctypeslib.as_array(p, shape=(n,)).astype(dtype, copy=True)

        self.event_time = arr(lib.pio_result_event_time, np.float64)
        self.creation_time = arr(lib.pio_result_creation_time, np.float64)
        self.event = arr(lib.pio_result_event, np.uint32)
        self.entity_type = arr(lib.pio_result_entity_type, np.uint32)
        self.entity_id = arr(lib.pio_result_entity_id, np.uint32)
        self.target_entity_type = arr(
            lib.pio_result_target_entity_type, np.int32
        )
        self.target_entity_id = arr(
            lib.pio_result_target_entity_id, np.int32
        )
        vlen = lib.pio_result_varlen_len(ptr)
        if vlen:
            vp = lib.pio_result_varlen(ptr)
            self.varlen = bytes(
                np.ctypeslib.as_array(vp, shape=(vlen,))
            )
        else:
            self.varlen = b""
        lib.pio_result_free(ptr)

        self._offsets: list[tuple[int, int, int, int]] | None = None

    def _index_varlen(self) -> list[tuple[int, int, int, int]]:
        """Byte offsets per record (no JSON parsing): (id_off, id_len,
        blob_off, blob_len)."""
        if self._offsets is None:
            buf, off, out = self.varlen, 0, []
            for _ in range(self.n):
                (id_len,) = struct.unpack_from("<I", buf, off)
                off += 4
                id_off = off
                off += id_len
                (blob_len,) = struct.unpack_from("<I", buf, off)
                off += 4
                out.append((id_off, id_len, off, blob_len))
                off += blob_len
            self._offsets = out
        return self._offsets

    def varlen_at(self, i: int) -> tuple[str, dict]:
        """Decode one record's (event_id, blob) on demand — JSON is
        parsed only for records actually yielded (limit-friendly)."""
        id_off, id_len, blob_off, blob_len = self._index_varlen()[i]
        event_id = self.varlen[id_off:id_off + id_len].decode()
        blob = (
            json.loads(self.varlen[blob_off:blob_off + blob_len])
            if blob_len
            else {}
        )
        return event_id, blob

    def iter_varlen(self):
        """Yield (event_id, blob_dict) per record."""
        for i in range(self.n):
            yield self.varlen_at(i)


def _decode(scan: _Scan, strings: list[str], i: int) -> Event:
    """Record ``i`` of a scan as an Event; its JSON blob is parsed here,
    only for records actually returned."""
    event_id, blob = scan.varlen_at(i)
    tty = int(scan.target_entity_type[i])
    tid = int(scan.target_entity_id[i])
    return Event(
        event=strings[int(scan.event[i])],
        entity_type=strings[int(scan.entity_type[i])],
        entity_id=strings[int(scan.entity_id[i])],
        target_entity_type=strings[tty] if tty >= 0 else None,
        target_entity_id=strings[tid] if tid >= 0 else None,
        properties=DataMap(blob.get("properties") or {}),
        event_time=_dt.datetime.fromtimestamp(
            float(scan.event_time[i]), _dt.timezone.utc
        ),
        tags=tuple(blob.get("tags") or ()),
        pr_id=blob.get("prId"),
        event_id=event_id,
        creation_time=_dt.datetime.fromtimestamp(
            float(scan.creation_time[i]), _dt.timezone.utc
        ),
    )


class EventLogEvents(EventsBackend):
    """EventsBackend over per-(app, channel) native logs."""

    def __init__(self, config: dict | None = None):
        config = config or {}
        self._base = config.get("PATH") or os.path.join(
            os.environ.get(
                "PIO_FS_BASEDIR",
                os.path.join(os.path.expanduser("~"), ".piotpu"),
            ),
            "eventlog",
        )
        self._logs: dict[tuple[int, int | None], _Log] = {}
        self._lock = threading.Lock()

    def _dir(self, app_id: int, channel_id: int | None) -> str:
        name = f"app_{app_id}" + (
            f"_ch{channel_id}" if channel_id is not None else ""
        )
        return os.path.join(self._base, name)

    def _log(self, app_id: int, channel_id: int | None) -> _Log:
        key = (app_id, channel_id)
        with self._lock:
            if key not in self._logs:
                self._logs[key] = _Log(self._dir(app_id, channel_id))
            return self._logs[key]

    # -- lifecycle --------------------------------------------------------
    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        self._log(app_id, channel_id)
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        key = (app_id, channel_id)
        with self._lock:
            log = self._logs.pop(key, None)
        if log is not None:
            log.close()
        path = self._dir(app_id, channel_id)
        if os.path.isdir(path):
            shutil.rmtree(path)
            return True
        return False

    def close(self) -> None:
        with self._lock:
            for log in self._logs.values():
                log.close()
            self._logs.clear()

    # -- writes -----------------------------------------------------------
    @staticmethod
    def _make_blob(stamped: Event) -> bytes:
        """Serialize the varlen payload OUTSIDE the write lock — JSON
        encoding of large property maps must not extend the critical
        section shared by all writer threads/processes."""
        return json.dumps(
            {
                "properties": stamped.properties.to_dict(),
                "tags": list(stamped.tags),
                "prId": stamped.pr_id,
            }
        ).encode()

    @staticmethod
    def _append_one(log, stamped: Event, blob: bytes) -> int:
        """Intern + append one event; caller holds ``log.write_lock``."""
        ev = log.intern(stamped.event)
        ety = log.intern(stamped.entity_type)
        eid = log.intern(stamped.entity_id)
        tty = (
            log.intern(stamped.target_entity_type)
            if stamped.target_entity_type is not None
            else -1
        )
        tid = (
            log.intern(stamped.target_entity_id)
            if stamped.target_entity_id is not None
            else -1
        )
        rid = stamped.event_id.encode()
        return log.lib.pio_append(
            log.handle, 1,
            stamped.event_time.timestamp(),
            stamped.creation_time.timestamp(),
            ev, ety, eid, tty, tid, rid, len(rid), blob, len(blob),
        )

    def insert(
        self, event: Event, app_id: int, channel_id: int | None = None
    ) -> str:
        log = self._log(app_id, channel_id)
        stamped = event.with_id(event.event_id)
        blob = self._make_blob(stamped)
        with log.write_lock():
            rc = self._append_one(log, stamped, blob)
        if rc != 0:
            raise OSError("event log append failed")
        return stamped.event_id

    def insert_batch(
        self,
        events: Sequence[Event],
        app_id: int,
        channel_id: int | None = None,
    ) -> list[str]:
        """One write_lock (thread lock + flock + dict resync) for the
        whole batch — the per-event locking of the default implementation
        dominated batch-ingest throughput."""
        if not events:
            return []
        log = self._log(app_id, channel_id)
        stamped = [e.with_id(e.event_id) for e in events]
        blobs = [self._make_blob(e) for e in stamped]
        done: list[str] = []
        with log.write_lock():
            for ev_obj, blob in zip(stamped, blobs):
                if self._append_one(log, ev_obj, blob) != 0:
                    # append-only log: the prefix is durable — report
                    # exactly what landed so clients retry only the rest
                    raise PartialBatchError(
                        "event log append failed mid-batch", done
                    )
                done.append(ev_obj.event_id)
        return done

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        if self.get(event_id, app_id, channel_id) is None:
            return False
        log = self._log(app_id, channel_id)
        rid = event_id.encode()
        with log.write_lock():
            log.lib.pio_append(
                log.handle, 2, 0.0, 0.0, 0, 0, 0, -1, -1,
                rid, len(rid), b"", 0,
            )
        return True

    # -- reads ------------------------------------------------------------
    def _scan(
        self,
        app_id: int,
        channel_id: int | None,
        start_time=None,
        until_time=None,
        entity_type=None,
        entity_id=None,
        event_names=None,
        target_entity_type=...,
        target_entity_id=...,
        include_varlen: bool = True,
        id_filter: str | None = None,
    ) -> _Scan | None:
        log = self._log(app_id, channel_id)
        # pick up strings interned by other processes before filter
        # lookups and result decoding
        log.reload_dict()

        def t(x):
            return x.timestamp() if x is not None else _NAN

        def opt(s):
            if s is None:
                return -1  # "any" for ety/eid
            i = log.lookup(s)
            return i if i is not None else None

        ety = opt(entity_type)
        eid = opt(entity_id)
        if ety is None or eid is None:
            return None  # filter string never seen → no matches
        if event_names is not None:
            ev_ids = [log.lookup(n) for n in event_names]
            ev_ids = [i for i in ev_ids if i is not None]
            if not ev_ids:
                return None
            ev_arr = (ctypes.c_uint32 * len(ev_ids))(*ev_ids)
            n_ev = len(ev_ids)
        else:
            ev_arr = None
            n_ev = 0

        def tri(v):
            if v is ...:
                return -2
            if v is None:
                return -1
            i = log.lookup(v)
            return i if i is not None else None

        tty = tri(target_entity_type)
        tid = tri(target_entity_id)
        if tty is None or tid is None:
            return None
        rid = id_filter.encode() if id_filter is not None else b""
        ptr = log.lib.pio_scan(
            log.handle, t(start_time), t(until_time), ev_arr, n_ev,
            ety, eid, tty, tid, 1 if include_varlen else 0,
            rid, len(rid),
        )
        return _Scan(log.lib, ptr)

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type=...,
        target_entity_id=...,
        limit: int | None = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        if start_time is not None and start_time.tzinfo is None:
            start_time = start_time.replace(tzinfo=_dt.timezone.utc)
        if until_time is not None and until_time.tzinfo is None:
            until_time = until_time.replace(tzinfo=_dt.timezone.utc)
        scan = self._scan(
            app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id,
        )
        if scan is None or scan.n == 0:
            return
        if limit is not None and limit == 0:
            return
        log = self._log(app_id, channel_id)
        order = np.argsort(scan.event_time, kind="stable")
        if reversed:
            order = order[::-1]
        n_out = 0
        for i in order:
            yield _decode(scan, log.strings, int(i))
            n_out += 1
            if limit is not None and 0 < limit <= n_out:
                return

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        # id-filtered scan: matching happens in C++, O(1) decode here
        scan = self._scan(app_id, channel_id, id_filter=event_id)
        if scan is None or scan.n == 0:
            return None
        return _decode(scan, self._log(app_id, channel_id).strings, 0)

    # -- native columnar fast path ----------------------------------------
    def interactions(
        self,
        app_id: int,
        channel_id: int | None = None,
        event_names: Sequence[str] | None = None,
        value_key: str | None = None,
        default_value: float = 1.0,
    ) -> Interactions:
        """Dense COO interactions straight from the C++ scan.

        Entity/target codes come from the log's interner (compacted to a
        dense vocabulary); property blobs are only parsed when a
        ``value_key`` is requested.
        """
        need_values = value_key is not None
        scan = self._scan(
            app_id, channel_id, event_names=event_names,
            target_entity_id=...,  # any
            include_varlen=need_values,
        )
        log = self._log(app_id, channel_id)
        if scan is None or scan.n == 0:
            empty = BiMap(np.asarray([], dtype=np.str_))
            z = np.zeros(0, np.int32)
            return Interactions(
                entity_map=empty, target_map=empty, rows=z, cols=z,
                values=np.zeros(0, np.float32),
                times=np.zeros(0, np.float64),
            )
        mask = scan.target_entity_id >= 0
        eid = scan.entity_id[mask]
        tid = scan.target_entity_id[mask].astype(np.uint32)
        times = scan.event_time[mask]
        # compact interner ids → dense [0, n) vocabularies
        uniq_e, rows = np.unique(eid, return_inverse=True)
        uniq_t, cols = np.unique(tid, return_inverse=True)
        decode = np.asarray(log.strings, dtype=np.str_)
        entity_map = BiMap(decode[uniq_e])
        target_map = BiMap(decode[uniq_t])
        if need_values:
            vals = np.fromiter(
                (
                    float((blob.get("properties") or {}).get(
                        value_key, default_value
                    ))
                    for (_id, blob), keep in zip(
                        scan.iter_varlen(), mask
                    )
                    if keep
                ),
                dtype=np.float32,
                count=int(mask.sum()),
            )
        else:
            vals = np.full(int(mask.sum()), default_value, np.float32)
        return Interactions(
            entity_map=entity_map,
            target_map=target_map,
            rows=rows.astype(np.int32),
            cols=cols.astype(np.int32),
            values=vals,
            times=times,
        )
