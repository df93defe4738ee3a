"""SQLite storage: the durable zero-dependency default.

Counterpart of ``predictionio_tpu/data/storage/sqlite.py``, on the
standard library's ``sqlite3``. The DAOs are :mod:`.sql_common`'s; this
module supplies the sqlite dialect and the connections: one per thread
(``threading.local``: a sqlite connection is not shared across threads),
WAL so the event server's reader and writer threads do not serialize on
the file, ``synchronous=NORMAL`` and a 30 s busy timeout.
"""

from __future__ import annotations

import os
import sqlite3
from typing import Any, Sequence

from predictionio_tpu_torch.data.storage.sql_common import (
    SQLAccessKeys,
    SQLApps,
    SQLChannels,
    SQLClient,
    SQLDialect,
    SQLEngineInstances,
    SQLEngineManifests,
    SQLEvaluationInstances,
    SQLEvents,
    SQLModels,
)


class SQLiteDialect(SQLDialect):
    placeholder = "?"
    autoinc_pk = "INTEGER PRIMARY KEY AUTOINCREMENT"
    blob_type = "BLOB"
    integrity_errors = (sqlite3.IntegrityError,)
    operational_errors = (sqlite3.OperationalError,)

    def upsert(self, table: str, cols: Sequence[str],
               pk: Sequence[str]) -> str:
        return (
            f"INSERT OR REPLACE INTO {table} ({','.join(cols)}) "
            f"VALUES ({','.join('?' * len(cols))})"
        )

    def insert_autoinc(self, cur, table: str, cols: Sequence[str],
                       values: Sequence[Any]) -> int:
        cur.execute(
            f"INSERT INTO {table} ({','.join(cols)}) "
            f"VALUES ({','.join('?' * len(cols))})",
            tuple(values),
        )
        return cur.lastrowid


class SQLiteClient(SQLClient):
    """Shared connection manager for all DAOs of one storage source."""

    def __init__(self, config: dict | None = None):
        super().__init__()
        self.dialect = SQLiteDialect()
        config = config or {}
        path = config.get("PATH") or config.get(
            "URL", os.path.join(os.getcwd(), "pio.sqlite")
        )
        if path != ":memory:":
            os.makedirs(
                os.path.dirname(os.path.abspath(path)), exist_ok=True
            )
        self.path = path
        self.ensure_metadata_schema()

    def _connect(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self.path, timeout=30.0)
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        return conn


# DAO names kept for the registry and external callers; the bodies are
# the shared SQL implementations.
SQLiteApps = SQLApps
SQLiteAccessKeys = SQLAccessKeys
SQLiteChannels = SQLChannels
SQLiteEngineInstances = SQLEngineInstances
SQLiteEngineManifests = SQLEngineManifests
SQLiteEvaluationInstances = SQLEvaluationInstances
SQLiteModels = SQLModels
SQLiteEvents = SQLEvents
