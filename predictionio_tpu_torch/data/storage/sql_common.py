"""The dialect-neutral SQL layer: one DAO set over a small dialect seam.

Counterpart of ``predictionio_tpu/data/storage/sql_common.py``. Every
DAO is written against :class:`SQLDialect` (placeholder style, upsert
syntax, autoincrement column, blob type, driver error classes) and
:class:`SQLClient` (one connection per thread, ``tx``, the schema and
the ``access_keys`` column migration). The port ships the sqlite
dialect (:mod:`.sqlite`); the networked dialects come later (ROADMAP,
queue 1, item 3b).

The schema is the JAX package's, byte for byte: one event table per
(app, channel) named ``events_<appId>[_<channelId>]``, timestamps as UTC
ISO-8601 text (lexicographic order is chronological order), seven
metadata tables and the model blob table, so one sqlite file is read and
written by both packages.
"""

from __future__ import annotations

import abc
import datetime as _dt
import json
import threading
import uuid
from contextlib import contextmanager
from typing import Any, Iterator, Sequence

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    AccessKeysBackend,
    App,
    AppsBackend,
    Channel,
    ChannelsBackend,
    EngineInstance,
    EngineInstancesBackend,
    EngineManifest,
    EngineManifestsBackend,
    EvaluationInstance,
    EvaluationInstancesBackend,
    EventsBackend,
    Model,
    ModelsBackend,
)


def iso(t: _dt.datetime) -> str:
    # Naive datetimes are UTC by convention (same rule as Event.__post_init__)
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return t.astimezone(_dt.timezone.utc).isoformat()


def from_iso(s: str) -> _dt.datetime:
    return _dt.datetime.fromisoformat(s)


class SQLDialect(abc.ABC):
    """Database-specific syntax and driver error classes."""

    #: "?" (sqlite/qmark) or "%s" (postgres/mysql/format)
    placeholder: str = "?"
    #: column definition for an autoincrementing integer primary key
    autoinc_pk: str = "INTEGER PRIMARY KEY AUTOINCREMENT"
    #: binary blob column type
    blob_type: str = "BLOB"
    #: column type for primary-key / unique / indexed text columns —
    #: MySQL cannot index a bare TEXT column (needs a sized VARCHAR);
    #: sqlite/postgres keep TEXT
    key_text: str = "TEXT"
    #: driver exception types for unique/PK violations
    integrity_errors: tuple = ()
    #: driver exception types for missing tables etc.
    operational_errors: tuple = ()

    def sql(self, text: str) -> str:
        """Convert canonical '?'-placeholder SQL to this dialect."""
        if self.placeholder == "?":
            return text
        return text.replace("?", self.placeholder)

    def upsert(self, table: str, cols: Sequence[str],
               pk: Sequence[str]) -> str:
        """INSERT-or-replace statement with '?' placeholders."""
        raise NotImplementedError

    def insert_autoinc(self, cur, table: str, cols: Sequence[str],
                       values: Sequence[Any]) -> int:
        """Insert a row whose integer PK is database-assigned; return it."""
        raise NotImplementedError

    def create_index(self, name: str, table: str, cols: str) -> str:
        """Idempotent index creation."""
        return f"CREATE INDEX IF NOT EXISTS {name} ON {table} ({cols})"


class SQLClient(abc.ABC):
    """Thread-local connection manager + statement helpers."""

    dialect: SQLDialect

    def __init__(self):
        self._local = threading.local()
        self._init_lock = threading.Lock()

    @abc.abstractmethod
    def _connect(self):
        """Open a new DB-API connection."""

    @property
    def conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._connect()
            self._local.conn = conn
        return conn

    @contextmanager
    def tx(self):
        """Cursor scope; commits on success, rolls back on error."""
        conn = self.conn
        cur = conn.cursor()
        try:
            yield cur
            conn.commit()
        except BaseException:
            conn.rollback()
            raise
        finally:
            cur.close()

    def execute(self, text: str, params: Sequence[Any] = ()) -> int:
        """Run one statement; returns affected-row count."""
        with self.tx() as cur:
            cur.execute(self.dialect.sql(text), tuple(params))
            return cur.rowcount

    def executemany(self, text: str, rows: Sequence[Sequence[Any]]) -> None:
        with self.tx() as cur:
            cur.executemany(
                self.dialect.sql(text), [tuple(r) for r in rows]
            )

    def query(self, text: str, params: Sequence[Any] = ()) -> list:
        with self.tx() as cur:
            cur.execute(self.dialect.sql(text), tuple(params))
            return cur.fetchall()

    def query_one(self, text: str, params: Sequence[Any] = ()):
        rows = self.query(text, params)
        return rows[0] if rows else None

    def upsert(self, table: str, cols: Sequence[str], pk: Sequence[str],
               values: Sequence[Any]) -> None:
        self.execute(self.dialect.upsert(table, cols, pk), values)

    def upsert_many(self, table: str, cols: Sequence[str],
                    pk: Sequence[str], rows: Sequence[Sequence[Any]]) -> None:
        self.executemany(self.dialect.upsert(table, cols, pk), rows)

    def insert_autoinc(self, table: str, cols: Sequence[str],
                       values: Sequence[Any]) -> int:
        with self.tx() as cur:
            return self.dialect.insert_autoinc(cur, table, cols, values)

    # -- schema -----------------------------------------------------------
    def metadata_schema_statements(self) -> list[str]:
        d = self.dialect
        kt = d.key_text
        return [
            f"""CREATE TABLE IF NOT EXISTS apps (
                  id {d.autoinc_pk},
                  name {kt} UNIQUE NOT NULL,
                  description TEXT)""",
            f"""CREATE TABLE IF NOT EXISTS access_keys (
                  access_key {kt} PRIMARY KEY,
                  appid INTEGER NOT NULL,
                  events TEXT NOT NULL)""",
            f"""CREATE TABLE IF NOT EXISTS channels (
                  id {d.autoinc_pk},
                  name {kt} NOT NULL,
                  appid INTEGER NOT NULL,
                  UNIQUE(name, appid))""",
            f"""CREATE TABLE IF NOT EXISTS engine_instances (
                  id {kt} PRIMARY KEY,
                  status TEXT, start_time TEXT, end_time TEXT,
                  engine_id TEXT, engine_version TEXT, engine_variant TEXT,
                  engine_factory TEXT, batch TEXT, env TEXT, mesh_conf TEXT,
                  data_source_params TEXT, preparator_params TEXT,
                  algorithms_params TEXT, serving_params TEXT)""",
            f"""CREATE TABLE IF NOT EXISTS evaluation_instances (
                  id {kt} PRIMARY KEY,
                  status TEXT, start_time TEXT, end_time TEXT,
                  evaluation_class TEXT, engine_params_generator_class TEXT,
                  batch TEXT, env TEXT, evaluator_results TEXT,
                  evaluator_results_html TEXT, evaluator_results_json TEXT)""",
            f"""CREATE TABLE IF NOT EXISTS engine_manifests (
                  id {kt} NOT NULL,
                  version {kt} NOT NULL,
                  name TEXT NOT NULL,
                  description TEXT,
                  files TEXT NOT NULL,
                  engine_factory TEXT NOT NULL,
                  PRIMARY KEY (id, version))""",
            f"""CREATE TABLE IF NOT EXISTS models (
                  id {kt} PRIMARY KEY,
                  models {d.blob_type} NOT NULL)""",
        ]

    def ensure_metadata_schema(self) -> None:
        with self._init_lock:
            for stmt in self.metadata_schema_statements():
                self.execute(stmt)
            self._migrate_access_key_column()

    def _migrate_access_key_column(self) -> None:
        """Databases created before the MySQL dialect landed have
        ``access_keys.key`` (a MySQL reserved word); rename in place so
        existing sqlite/postgres stores keep working."""
        try:
            self.query("SELECT access_key FROM access_keys LIMIT 1")
            return  # current schema
        except Exception:  # noqa: BLE001 - probe only
            pass
        try:
            self.execute(
                "ALTER TABLE access_keys RENAME COLUMN key TO access_key"
            )
        except Exception as exc:  # noqa: BLE001
            raise RuntimeError(
                "access_keys table has a legacy 'key' column and "
                "automatic rename failed; run: ALTER TABLE access_keys "
                "RENAME COLUMN key TO access_key"
            ) from exc

    def event_table(self, app_id: int, channel_id: int | None) -> str:
        # Reference JDBC table naming: <namespace>_<appId>[_<channelId>]
        return f"events_{int(app_id)}" + (
            f"_{int(channel_id)}" if channel_id is not None else ""
        )

    def event_schema_statements(self, table: str) -> list[str]:
        kt = self.dialect.key_text
        return [
            f"""CREATE TABLE IF NOT EXISTS {table} (
                  id {kt} PRIMARY KEY,
                  event TEXT NOT NULL,
                  entity_type {kt} NOT NULL,
                  entity_id {kt} NOT NULL,
                  target_entity_type TEXT,
                  target_entity_id TEXT,
                  properties TEXT NOT NULL,
                  event_time {kt} NOT NULL,
                  tags TEXT NOT NULL,
                  pr_id TEXT,
                  creation_time TEXT NOT NULL)""",
            self.dialect.create_index(
                f"{table}_time", table, "event_time"
            ),
            self.dialect.create_index(
                f"{table}_entity", table, "entity_type, entity_id"
            ),
        ]


# --------------------------------------------------------------------------
# Generic DAOs
# --------------------------------------------------------------------------


class SQLApps(AppsBackend):
    def __init__(self, client: SQLClient):
        self._c = client

    def insert(self, app: App) -> int | None:
        try:
            if app.id > 0:
                self._c.execute(
                    "INSERT INTO apps (id, name, description) "
                    "VALUES (?,?,?)",
                    (app.id, app.name, app.description),
                )
                return app.id
            return self._c.insert_autoinc(
                "apps", ("name", "description"), (app.name, app.description)
            )
        except self._c.dialect.integrity_errors:
            return None

    def _row(self, r) -> App:
        return App(id=r[0], name=r[1], description=r[2])

    def get(self, app_id: int) -> App | None:
        r = self._c.query_one(
            "SELECT id, name, description FROM apps WHERE id=?", (app_id,)
        )
        return self._row(r) if r else None

    def get_by_name(self, name: str) -> App | None:
        r = self._c.query_one(
            "SELECT id, name, description FROM apps WHERE name=?", (name,)
        )
        return self._row(r) if r else None

    def get_all(self) -> list[App]:
        return [
            self._row(r)
            for r in self._c.query(
                "SELECT id, name, description FROM apps ORDER BY id"
            )
        ]

    def update(self, app: App) -> bool:
        return self._c.execute(
            "UPDATE apps SET name=?, description=? WHERE id=?",
            (app.name, app.description, app.id),
        ) > 0

    def delete(self, app_id: int) -> bool:
        return self._c.execute(
            "DELETE FROM apps WHERE id=?", (app_id,)
        ) > 0


class SQLAccessKeys(AccessKeysBackend):
    def __init__(self, client: SQLClient):
        self._c = client

    def insert(self, access_key: AccessKey) -> str | None:
        key = access_key.key or self.generate_key()
        try:
            self._c.execute(
                "INSERT INTO access_keys (access_key, appid, events) "
                "VALUES (?,?,?)",
                (key, access_key.appid,
                 json.dumps(list(access_key.events))),
            )
            return key
        except self._c.dialect.integrity_errors:
            return None

    def _row(self, r) -> AccessKey:
        return AccessKey(
            key=r[0], appid=r[1], events=tuple(json.loads(r[2]))
        )

    def get(self, key: str) -> AccessKey | None:
        r = self._c.query_one(
            "SELECT access_key, appid, events FROM access_keys "
            "WHERE access_key=?",
            (key,),
        )
        return self._row(r) if r else None

    def get_all(self) -> list[AccessKey]:
        return [
            self._row(r)
            for r in self._c.query(
                "SELECT access_key, appid, events FROM access_keys"
            )
        ]

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return [
            self._row(r)
            for r in self._c.query(
                "SELECT access_key, appid, events FROM access_keys WHERE appid=?",
                (app_id,),
            )
        ]

    def update(self, access_key: AccessKey) -> bool:
        return self._c.execute(
            "UPDATE access_keys SET appid=?, events=? WHERE access_key=?",
            (
                access_key.appid,
                json.dumps(list(access_key.events)),
                access_key.key,
            ),
        ) > 0

    def delete(self, key: str) -> bool:
        return self._c.execute(
            "DELETE FROM access_keys WHERE access_key=?", (key,)
        ) > 0


class SQLChannels(ChannelsBackend):
    def __init__(self, client: SQLClient):
        self._c = client

    def insert(self, channel: Channel) -> int | None:
        if not Channel.is_valid_name(channel.name):
            return None
        try:
            if channel.id > 0:
                self._c.execute(
                    "INSERT INTO channels (id, name, appid) VALUES (?,?,?)",
                    (channel.id, channel.name, channel.appid),
                )
                return channel.id
            return self._c.insert_autoinc(
                "channels", ("name", "appid"), (channel.name, channel.appid)
            )
        except self._c.dialect.integrity_errors:
            return None

    def get(self, channel_id: int) -> Channel | None:
        r = self._c.query_one(
            "SELECT id, name, appid FROM channels WHERE id=?",
            (channel_id,),
        )
        return Channel(id=r[0], name=r[1], appid=r[2]) if r else None

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return [
            Channel(id=r[0], name=r[1], appid=r[2])
            for r in self._c.query(
                "SELECT id, name, appid FROM channels WHERE appid=?",
                (app_id,),
            )
        ]

    def delete(self, channel_id: int) -> bool:
        return self._c.execute(
            "DELETE FROM channels WHERE id=?", (channel_id,)
        ) > 0


EI_COLS = (
    "id status start_time end_time engine_id engine_version engine_variant "
    "engine_factory batch env mesh_conf data_source_params preparator_params "
    "algorithms_params serving_params"
).split()


class SQLEngineInstances(EngineInstancesBackend):
    def __init__(self, client: SQLClient):
        self._c = client

    def _to_row(self, i: EngineInstance):
        return (
            i.id, i.status, iso(i.start_time), iso(i.end_time),
            i.engine_id, i.engine_version, i.engine_variant,
            i.engine_factory, i.batch, json.dumps(i.env),
            json.dumps(i.mesh_conf), i.data_source_params,
            i.preparator_params, i.algorithms_params, i.serving_params,
        )

    def _from_row(self, r) -> EngineInstance:
        return EngineInstance(
            id=r[0], status=r[1],
            start_time=from_iso(r[2]), end_time=from_iso(r[3]),
            engine_id=r[4], engine_version=r[5], engine_variant=r[6],
            engine_factory=r[7], batch=r[8], env=json.loads(r[9]),
            mesh_conf=json.loads(r[10]), data_source_params=r[11],
            preparator_params=r[12], algorithms_params=r[13],
            serving_params=r[14],
        )

    def insert(self, instance: EngineInstance) -> str:
        iid = instance.id or uuid.uuid4().hex
        row = (iid,) + self._to_row(instance)[1:]
        self._c.upsert("engine_instances", EI_COLS, ("id",), row)
        return iid

    def get(self, instance_id: str) -> EngineInstance | None:
        r = self._c.query_one(
            f"SELECT {','.join(EI_COLS)} FROM engine_instances WHERE id=?",
            (instance_id,),
        )
        return self._from_row(r) if r else None

    def get_all(self) -> list[EngineInstance]:
        return [
            self._from_row(r)
            for r in self._c.query(
                f"SELECT {','.join(EI_COLS)} FROM engine_instances"
            )
        ]

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        rows = self._c.query(
            f"SELECT {','.join(EI_COLS)} FROM engine_instances "
            "WHERE status='COMPLETED' AND engine_id=? AND engine_version=? "
            "AND engine_variant=? ORDER BY start_time DESC",
            (engine_id, engine_version, engine_variant),
        )
        return [self._from_row(r) for r in rows]

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None:
        completed = self.get_completed(
            engine_id, engine_version, engine_variant
        )
        return completed[0] if completed else None

    def update(self, instance: EngineInstance) -> bool:
        sets = ",".join(f"{c}=?" for c in EI_COLS[1:])
        return self._c.execute(
            f"UPDATE engine_instances SET {sets} WHERE id=?",
            self._to_row(instance)[1:] + (instance.id,),
        ) > 0

    def delete(self, instance_id: str) -> bool:
        return self._c.execute(
            "DELETE FROM engine_instances WHERE id=?", (instance_id,)
        ) > 0


EM_COLS = "id version name description files engine_factory".split()


class SQLEngineManifests(EngineManifestsBackend):
    def __init__(self, client: SQLClient):
        self._c = client

    def _from_row(self, r) -> EngineManifest:
        return EngineManifest(
            id=r[0], version=r[1], name=r[2], description=r[3],
            files=tuple(json.loads(r[4])), engine_factory=r[5],
        )

    def insert(self, manifest: EngineManifest) -> None:
        self._c.upsert(
            "engine_manifests", EM_COLS, ("id", "version"),
            (
                manifest.id, manifest.version, manifest.name,
                manifest.description, json.dumps(list(manifest.files)),
                manifest.engine_factory,
            ),
        )

    def get(self, manifest_id: str, version: str) -> EngineManifest | None:
        row = self._c.query_one(
            f"SELECT {','.join(EM_COLS)} FROM engine_manifests "
            "WHERE id=? AND version=?",
            (manifest_id, version),
        )
        return self._from_row(row) if row else None

    def get_all(self) -> list[EngineManifest]:
        return [
            self._from_row(r)
            for r in self._c.query(
                f"SELECT {','.join(EM_COLS)} FROM engine_manifests"
            )
        ]

    def update(self, manifest: EngineManifest, upsert: bool = False) -> None:
        if not upsert and self.get(manifest.id, manifest.version) is None:
            raise KeyError(
                f"engine manifest ({manifest.id}, {manifest.version}) "
                "not found"
            )
        self.insert(manifest)

    def delete(self, manifest_id: str, version: str) -> bool:
        return self._c.execute(
            "DELETE FROM engine_manifests WHERE id=? AND version=?",
            (manifest_id, version),
        ) > 0


EVI_COLS = (
    "id status start_time end_time evaluation_class "
    "engine_params_generator_class batch env evaluator_results "
    "evaluator_results_html evaluator_results_json"
).split()


class SQLEvaluationInstances(EvaluationInstancesBackend):
    def __init__(self, client: SQLClient):
        self._c = client

    def _to_row(self, i: EvaluationInstance):
        return (
            i.id, i.status, iso(i.start_time), iso(i.end_time),
            i.evaluation_class, i.engine_params_generator_class, i.batch,
            json.dumps(i.env), i.evaluator_results,
            i.evaluator_results_html, i.evaluator_results_json,
        )

    def _from_row(self, r) -> EvaluationInstance:
        return EvaluationInstance(
            id=r[0], status=r[1],
            start_time=from_iso(r[2]), end_time=from_iso(r[3]),
            evaluation_class=r[4], engine_params_generator_class=r[5],
            batch=r[6], env=json.loads(r[7]), evaluator_results=r[8],
            evaluator_results_html=r[9], evaluator_results_json=r[10],
        )

    def insert(self, instance: EvaluationInstance) -> str:
        iid = instance.id or uuid.uuid4().hex
        row = (iid,) + self._to_row(instance)[1:]
        self._c.upsert("evaluation_instances", EVI_COLS, ("id",), row)
        return iid

    def get(self, instance_id: str) -> EvaluationInstance | None:
        r = self._c.query_one(
            f"SELECT {','.join(EVI_COLS)} FROM evaluation_instances "
            "WHERE id=?",
            (instance_id,),
        )
        return self._from_row(r) if r else None

    def get_all(self) -> list[EvaluationInstance]:
        return [
            self._from_row(r)
            for r in self._c.query(
                f"SELECT {','.join(EVI_COLS)} FROM evaluation_instances"
            )
        ]

    def get_completed(self) -> list[EvaluationInstance]:
        rows = self._c.query(
            f"SELECT {','.join(EVI_COLS)} FROM evaluation_instances "
            "WHERE status='EVALCOMPLETED' ORDER BY start_time DESC"
        )
        return [self._from_row(r) for r in rows]

    def update(self, instance: EvaluationInstance) -> bool:
        sets = ",".join(f"{c}=?" for c in EVI_COLS[1:])
        return self._c.execute(
            f"UPDATE evaluation_instances SET {sets} WHERE id=?",
            self._to_row(instance)[1:] + (instance.id,),
        ) > 0

    def delete(self, instance_id: str) -> bool:
        return self._c.execute(
            "DELETE FROM evaluation_instances WHERE id=?", (instance_id,)
        ) > 0


class SQLModels(ModelsBackend):
    def __init__(self, client: SQLClient):
        self._c = client

    def insert(self, model: Model) -> None:
        self._c.upsert(
            "models", ("id", "models"), ("id",), (model.id, model.models)
        )

    def get(self, model_id: str) -> Model | None:
        r = self._c.query_one(
            "SELECT id, models FROM models WHERE id=?", (model_id,)
        )
        return Model(id=r[0], models=bytes(r[1])) if r else None

    def delete(self, model_id: str) -> bool:
        return self._c.execute(
            "DELETE FROM models WHERE id=?", (model_id,)
        ) > 0


EVENT_COLS = (
    "id event entity_type entity_id target_entity_type target_entity_id "
    "properties event_time tags pr_id creation_time"
).split()


class SQLEvents(EventsBackend):
    """Event DAO over per-(app, channel) tables indexed by event time
    (reference JDBCLEvents.scala init/insert/find)."""

    def __init__(self, client: SQLClient):
        self._c = client

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        t = self._c.event_table(app_id, channel_id)
        for stmt in self._c.event_schema_statements(t):
            self._c.execute(stmt)
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        t = self._c.event_table(app_id, channel_id)
        self._c.execute(f"DROP TABLE IF EXISTS {t}")
        return True

    def close(self) -> None:
        pass

    def _to_row(self, e: Event):
        return (
            e.event_id, e.event, e.entity_type, e.entity_id,
            e.target_entity_type, e.target_entity_id,
            json.dumps(e.properties.to_dict()), iso(e.event_time),
            json.dumps(list(e.tags)), e.pr_id, iso(e.creation_time),
        )

    def _from_row(self, r) -> Event:
        return Event(
            event_id=r[0], event=r[1], entity_type=r[2], entity_id=r[3],
            target_entity_type=r[4], target_entity_id=r[5],
            properties=DataMap(json.loads(r[6])),
            event_time=from_iso(r[7]), tags=tuple(json.loads(r[8])),
            pr_id=r[9], creation_time=from_iso(r[10]),
        )

    def insert(
        self, event: Event, app_id: int, channel_id: int | None = None
    ) -> str:
        stamped = event.with_id(event.event_id)
        t = self._c.event_table(app_id, channel_id)
        try:
            self._c.upsert(t, EVENT_COLS, ("id",), self._to_row(stamped))
        except self._c.dialect.operational_errors:
            # table not yet init()-ed — auto-create, matching MemoryEvents
            self.init(app_id, channel_id)
            self._c.upsert(t, EVENT_COLS, ("id",), self._to_row(stamped))
        return stamped.event_id

    def insert_batch(
        self,
        events: Sequence[Event],
        app_id: int,
        channel_id: int | None = None,
    ) -> list[str]:
        stamped = [e.with_id(e.event_id) for e in events]
        t = self._c.event_table(app_id, channel_id)
        rows = [self._to_row(e) for e in stamped]
        try:
            self._c.upsert_many(t, EVENT_COLS, ("id",), rows)
        except self._c.dialect.operational_errors:
            self.init(app_id, channel_id)
            self._c.upsert_many(t, EVENT_COLS, ("id",), rows)
        return [e.event_id for e in stamped]

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        t = self._c.event_table(app_id, channel_id)
        try:
            r = self._c.query_one(
                f"SELECT {','.join(EVENT_COLS)} FROM {t} WHERE id=?",
                (event_id,),
            )
        except self._c.dialect.operational_errors:
            return None
        return self._from_row(r) if r else None

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        t = self._c.event_table(app_id, channel_id)
        try:
            return self._c.execute(
                f"DELETE FROM {t} WHERE id=?", (event_id,)
            ) > 0
        except self._c.dialect.operational_errors:
            return False

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
        t = self._c.event_table(app_id, channel_id)
        where, params = [], []
        if start_time is not None:
            where.append("event_time >= ?")
            params.append(iso(start_time))
        if until_time is not None:
            where.append("event_time < ?")
            params.append(iso(until_time))
        if entity_type is not None:
            where.append("entity_type = ?")
            params.append(entity_type)
        if entity_id is not None:
            where.append("entity_id = ?")
            params.append(entity_id)
        if event_names is not None:
            where.append(
                f"event IN ({','.join('?' * len(event_names))})"
            )
            params.extend(event_names)
        if target_entity_type is not ...:
            if target_entity_type is None:
                where.append("target_entity_type IS NULL")
            else:
                where.append("target_entity_type = ?")
                params.append(target_entity_type)
        if target_entity_id is not ...:
            if target_entity_id is None:
                where.append("target_entity_id IS NULL")
            else:
                where.append("target_entity_id = ?")
                params.append(target_entity_id)
        sql = f"SELECT {','.join(EVENT_COLS)} FROM {t}"
        if where:
            sql += " WHERE " + " AND ".join(where)
        sql += f" ORDER BY event_time {'DESC' if reversed else 'ASC'}"
        if limit is not None and limit > 0:
            sql += f" LIMIT {int(limit)}"
        elif limit == 0:
            return
        try:
            rows = self._c.query(sql, params)
        except self._c.dialect.operational_errors:
            return  # table not initialized → no events
        for r in rows:
            yield self._from_row(r)
