"""Replicated store tier — quorum writes, failover reads, anti-entropy.

Counterpart of ``predictionio_tpu/data/storage/replicated.py``, with the
same hint files, status payloads, timeline events and ``pio_store_*``
metrics. A *client-side* replication layer over N ordinary store
servers (Dynamo-style: peers never talk to each other on the write
path, so a peer is the unmodified store server of
:mod:`predictionio_tpu_torch.serving.store_server`, with its
``PIO_EVENTLOG_FSYNC`` commit path):

* **Quorum writes** — every write fans out to all N peers and acks to
  the caller only after W report durable. Event inserts carry an
  ``X-PIO-Store-Seq`` token (``<writer>:<seq>``) so a replay after a
  torn send is idempotent even on the append-only eventlog backend.
* **Failover reads with read-repair** — reads serve from any live peer
  (sticky preference, advancing on failure); model blob reads verify
  against the generation's SHA-256 manifest and backfill stale or
  corrupt peers from a healthy one.
* **Hinted handoff** — writes a down peer missed are queued on disk
  (bounded, ``atomic_write_bytes``) and drained by a background thread
  when the peer answers again.
* **Anti-entropy** (:class:`AntiEntropyLoop`, runs inside each store
  server given ``--peer`` URLs) — periodically compares per-app event
  watermarks, model-id sets, and metadata between peers and pulls the
  delta, so a restarted node converges without operator action.

Config (``PIO_STORAGE_SOURCES_<NAME>_*`` with ``TYPE=replicated``):

* ``URLS`` — comma-separated peer base URLs (required, ≥ 1)
* ``W`` — write quorum (default: majority, ``N // 2 + 1``)
* ``KEY`` / ``TIMEOUT`` / ``CACERT`` / ``VERIFY`` — per-peer client
  settings, same meaning as the httpstore source
* ``HINT_DIR`` — hint-queue directory (default
  ``$PIO_FS_BASEDIR/replication_hints``)
* ``HINT_LIMIT`` — max queued hints per peer (default 512, drop-oldest)

Env: ``PIO_STORE_HINT_INTERVAL`` (hint-drain poll seconds, default 2),
``PIO_STORE_SYNC_INTERVAL`` (anti-entropy cadence seconds, default 5).
"""

from __future__ import annotations

import base64
import concurrent.futures
import dataclasses
import hashlib
import json
import logging
import os
import threading
import time
import uuid
from typing import Any, Callable, Iterable

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
    PartialBatchError,
    StorageError,
)
from predictionio_tpu_torch.data.storage.httpstore import (
    HTTPAccessKeys,
    HTTPApps,
    HTTPChannels,
    HTTPEngineInstances,
    HTTPEngineManifests,
    HTTPEvaluationInstances,
    HTTPEvents,
    HTTPModels,
    HTTPStoreClient,
    access_key_from_json,
    access_key_to_json,
    app_from_json,
    app_to_json,
    channel_from_json,
    channel_to_json,
    engine_instance_from_json,
    engine_instance_to_json,
    evaluation_instance_from_json,
    evaluation_instance_to_json,
    manifest_from_json,
    manifest_to_json,
)
from predictionio_tpu_torch.data.storage.localfs import atomic_write_bytes
from predictionio_tpu_torch.obs import timeline as timeline_mod
from predictionio_tpu_torch.obs.registry import get_registry

logger = logging.getLogger(__name__)

#: generation manifests live beside their blob under this suffix
#: (core/persistence.manifest_id) — replication orders blob-before-
#: manifest on repair so the manifest stays the commit point
_MANIFEST_SUFFIX = ".manifest"

_DEFAULT_HINT_LIMIT = 512


def _env_interval(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        return default
    return value if value > 0 else default


def hint_interval() -> float:
    """``PIO_STORE_HINT_INTERVAL`` — seconds between hint-drain polls."""
    return _env_interval("PIO_STORE_HINT_INTERVAL", 2.0)


def sync_interval() -> float:
    """``PIO_STORE_SYNC_INTERVAL`` — anti-entropy cadence in seconds."""
    return _env_interval("PIO_STORE_SYNC_INTERVAL", 5.0)


def _register_metrics(registry):
    """The replication telemetry trio (idempotent re-registration)."""
    lag = registry.gauge(
        "pio_store_replica_lag_seconds",
        "seconds the peer's newest event trails the local newest event",
        ("peer",),
    )
    hints = registry.gauge(
        "pio_store_hints_pending",
        "hinted-handoff writes queued on disk for a down peer",
        ("peer",),
    )
    repairs = registry.counter(
        "pio_store_repair_total",
        "replication repair actions by outcome "
        "(events/models/metadata pulls, read_repair backfills, errors)",
        ("outcome",),
    )
    return lag, hints, repairs


def _record(kind: str, message: str, **kw) -> None:
    """Timeline emission through the process-global ring — the store
    server installs its own ring, so failover/repair transitions land
    beside its other lifecycle events."""
    try:
        timeline_mod.get_timeline().record(kind, message, **kw)
    except Exception:  # noqa: BLE001 - telemetry must not fail the op
        logger.exception("timeline record failed")


class ReplicationError(StorageError):
    """A write could not reach its W-of-N quorum."""


# --------------------------------------------------------------------------
# peers
# --------------------------------------------------------------------------


_PEER_CONF_KEYS = ("KEY", "TIMEOUT", "CACERT", "VERIFY")


class Peer:
    """One store-server endpoint: the httpstore client plus its DAOs.

    The underlying :class:`HTTPStoreClient` already carries the
    resilience machinery — per-target circuit breaker, deadline-budget
    propagation, jittered retries on idempotent methods — so this layer
    adds nothing on the single-peer path.
    """

    def __init__(self, url: str, conf: dict | None = None):
        conf = conf or {}
        cfg = {"URL": url}
        for key in _PEER_CONF_KEYS:
            if conf.get(key) not in (None, ""):
                cfg[key] = conf[key]
        self.url = url.rstrip("/")
        self.client = HTTPStoreClient(cfg)
        #: host:port — breaker identity and metric label
        self.name = self.client._target
        self.apps = HTTPApps(self.client)
        self.access_keys = HTTPAccessKeys(self.client)
        self.channels = HTTPChannels(self.client)
        self.engine_instances = HTTPEngineInstances(self.client)
        self.engine_manifests = HTTPEngineManifests(self.client)
        self.evaluation_instances = HTTPEvaluationInstances(self.client)
        self.models = HTTPModels(self.client)
        self.events = HTTPEvents(self.client)

    def healthy(self) -> bool:
        """One cheap liveness probe (GET /) — used before draining
        hints; the breaker already gates the request itself."""
        try:
            out = self.client.json("GET", "/")
            return bool(out)
        except StorageError:
            return False

    def breaker_state(self) -> str:
        return self.client._breaker.state

    def close(self) -> None:
        self.client.close()


# --------------------------------------------------------------------------
# hinted handoff
# --------------------------------------------------------------------------


class HintQueue:
    """Bounded on-disk FIFO of writes one peer missed.

    One JSON file per hint, written with ``atomic_write_bytes`` so a
    crash mid-enqueue never leaves a torn hint; ordered by a
    zero-padded sequence number recovered from the directory on
    restart. At ``limit`` the OLDEST hint is dropped (the peer has been
    down long enough that anti-entropy will do the heavy lifting
    anyway — the queue only needs to cover short outages cheaply).
    """

    def __init__(self, base_dir: str, peer_name: str, limit: int):
        safe = peer_name.replace(":", "_").replace("/", "_")
        self.dir = os.path.join(base_dir, safe)
        os.makedirs(self.dir, exist_ok=True)
        self.limit = max(1, int(limit))
        self.dropped = 0
        self._lock = threading.Lock()
        self._next = 1 + max(
            (
                int(name[:-5])
                for name in os.listdir(self.dir)
                if name.endswith(".json") and name[:-5].isdigit()
            ),
            default=0,
        )

    def _files(self) -> list[str]:
        return sorted(
            name
            for name in os.listdir(self.dir)
            if name.endswith(".json") and name[:-5].isdigit()
        )

    def pending(self) -> int:
        with self._lock:
            return len(self._files())

    def append(self, payload: dict) -> None:
        with self._lock:
            files = self._files()
            while len(files) >= self.limit:
                oldest = files.pop(0)
                try:
                    os.remove(os.path.join(self.dir, oldest))
                except FileNotFoundError:
                    pass
                self.dropped += 1
            path = os.path.join(self.dir, f"{self._next:020d}.json")
            self._next += 1
            atomic_write_bytes(
                path, json.dumps(payload, sort_keys=True).encode("utf-8")
            )

    def drain(self, apply: Callable[[dict], None]) -> int:
        """Replay hints in order; a :class:`StorageError` from ``apply``
        (transport — the peer went away again) stops the drain and
        KEEPS the hint; any other exception marks the hint poison
        (malformed payload, unknown op — replaying it can never
        succeed) and drops it so one bad hint cannot wedge the queue
        or kill the drainer thread. Returns replayed count."""
        replayed = 0
        while True:
            with self._lock:
                files = self._files()
            if not files:
                return replayed
            path = os.path.join(self.dir, files[0])
            try:
                with open(path, "rb") as f:
                    payload = json.loads(f.read().decode("utf-8"))
            except (OSError, ValueError):
                # torn/garbage hint: drop it rather than wedge the queue
                self._drop(path)
                continue
            try:
                apply(payload)
            except StorageError:
                raise  # peer unreachable -> stop, keep the hint
            except Exception:  # noqa: BLE001 - poison hint
                logger.exception("dropping undeliverable hint %s", path)
                self._drop(path)
                continue
            with self._lock:
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass
            replayed += 1

    def _drop(self, path: str) -> None:
        with self._lock:
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
            self.dropped += 1


# --------------------------------------------------------------------------
# the replicated client
# --------------------------------------------------------------------------


#: metadata kinds the hint/anti-entropy machinery understands:
#: kind -> (peer DAO attr, to_json, from_json)
_META_KINDS = {
    "apps": ("apps", app_to_json, app_from_json),
    "access_keys": ("access_keys", access_key_to_json, access_key_from_json),
    "channels": ("channels", channel_to_json, channel_from_json),
    "engine_instances": (
        "engine_instances",
        engine_instance_to_json,
        engine_instance_from_json,
    ),
    "engine_manifests": (
        "engine_manifests",
        manifest_to_json,
        manifest_from_json,
    ),
    "evaluation_instances": (
        "evaluation_instances",
        evaluation_instance_to_json,
        evaluation_instance_from_json,
    ),
}


class ReplicatedStoreClient:
    """Fan-out client over N store-server peers (see module docstring).

    DAO accessors hand out replicated wrappers; ``Storage`` binds them
    through the ``replicated`` backend spec exactly like any other
    source type, so the event server, trainer, and engine servers adopt
    replication by configuration alone.
    """

    def __init__(self, config: dict):
        urls = [
            u.strip()
            for u in str(config.get("URLS", "")).split(",")
            if u.strip()
        ]
        if not urls:
            raise StorageError(
                "replicated source needs PIO_STORAGE_SOURCES_<NAME>_URLS "
                "(comma-separated store-server base URLs)"
            )
        self.peers = [Peer(u, config) for u in urls]
        n = len(self.peers)
        default_w = n // 2 + 1
        try:
            self.w = int(config.get("W", default_w))
        except ValueError as e:
            raise StorageError(
                f"replicated W not an int: {config.get('W')!r}"
            ) from e
        if not 1 <= self.w <= n:
            raise StorageError(
                f"replicated W={self.w} out of range for {n} peer(s)"
            )
        base = config.get("HINT_DIR") or os.path.join(
            os.environ.get(
                "PIO_FS_BASEDIR",
                os.path.join(os.path.expanduser("~"), ".piotpu"),
            ),
            "replication_hints",
        )
        try:
            limit = int(config.get("HINT_LIMIT", _DEFAULT_HINT_LIMIT))
        except ValueError as e:
            raise StorageError(
                f"replicated HINT_LIMIT not an int: "
                f"{config.get('HINT_LIMIT')!r}"
            ) from e
        self.hints = {p.name: HintQueue(base, p.name, limit) for p in self.peers}
        #: write sequencing: one writer identity per client process,
        #: one monotonic counter per peer
        self.writer_id = uuid.uuid4().hex[:12]
        self._seq: dict[str, int] = {p.name: 0 for p in self.peers}
        self._seq_lock = threading.Lock()
        self._preferred = 0  # sticky failover-read index
        self._pref_lock = threading.Lock()
        registry = get_registry()
        self._lag_gauge, self._hints_gauge, self._repairs = (
            _register_metrics(registry)
        )
        for p in self.peers:
            self._hints_gauge.labels(p.name).set(
                self.hints[p.name].pending()
            )
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=n, thread_name_prefix="pio-repl"
        )
        self._stop = threading.Event()
        self._drainer = threading.Thread(
            target=self._hint_loop, daemon=True, name="pio-hint-drain"
        )
        self._drainer.start()
        self._dao_cache: dict[str, object] = {}
        logger.info(
            "replicated store: %d peer(s) %s, W=%d, hints under %s",
            n, [p.name for p in self.peers], self.w, base,
        )

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        self._stop.set()
        self._drainer.join(timeout=2)
        self._pool.shutdown(wait=False)
        for p in self.peers:
            p.close()

    def dao(self, name: str):
        if name not in self._dao_cache:
            factory = {
                "apps": ReplicatedApps,
                "access_keys": ReplicatedAccessKeys,
                "channels": ReplicatedChannels,
                "engine_instances": ReplicatedEngineInstances,
                "engine_manifests": ReplicatedEngineManifests,
                "evaluation_instances": ReplicatedEvaluationInstances,
                "models": ReplicatedModels,
                "events": ReplicatedEvents,
            }[name]
            self._dao_cache[name] = factory(self)
        return self._dao_cache[name]

    def next_seq(self, peer: Peer) -> str:
        with self._seq_lock:
            self._seq[peer.name] += 1
            return f"{self.writer_id}:{self._seq[peer.name]}"

    def status(self) -> dict:
        """The client-side replication view (``replication_status``
        feeds it into a non-store server's /healthz)."""
        return {
            "role": "client",
            "n": len(self.peers),
            "w": self.w,
            "peers": [
                {
                    "url": p.url,
                    "breaker": p.breaker_state(),
                    "hintsPending": self.hints[p.name].pending(),
                    "hintsDropped": self.hints[p.name].dropped,
                }
                for p in self.peers
            ],
        }

    # -- quorum writes ----------------------------------------------------

    def quorum_write(
        self,
        op: str,
        fn: Callable[[Peer], Any],
        hint_payload: dict | Callable[[Peer], dict] | None = None,
    ) -> list[Any]:
        """Apply ``fn`` to every peer concurrently; require W acks.

        Returns per-peer results (None for a failed peer). With the
        quorum met, each failed peer gets a hint so the write reaches
        it on recovery; below quorum the write FAILS to the caller
        (whatever landed converges later via anti-entropy, but was
        never acked)."""
        futures = [
            (peer, self._pool.submit(fn, peer)) for peer in self.peers
        ]
        results: list[Any] = []
        failed: list[tuple[Peer, Exception]] = []
        for peer, fut in futures:
            try:
                results.append(fut.result())
            except StorageError as e:
                results.append(None)
                failed.append((peer, e))
        acks = len(self.peers) - len(failed)
        if acks < self.w:
            raise ReplicationError(
                f"{op}: only {acks}/{len(self.peers)} peers acked "
                f"(need W={self.w}); first error: {failed[0][1]}"
            )
        if failed and hint_payload is not None:
            for peer, err in failed:
                payload = (
                    hint_payload(peer)
                    if callable(hint_payload)
                    else hint_payload
                )
                self.add_hint(peer, payload)
                logger.warning(
                    "%s: peer %s missed the write (%s); hinted",
                    op, peer.name, err,
                )
        return results

    def add_hint(self, peer: Peer, payload: dict) -> None:
        queue = self.hints[peer.name]
        queue.append(payload)
        self._hints_gauge.labels(peer.name).set(queue.pending())
        _record(
            "store_hint_enqueued",
            f"hinted {payload.get('op', '?')} for down peer {peer.name}",
            severity=timeline_mod.WARN,
            peer=peer.name,
            pending=queue.pending(),
        )

    # -- failover reads ---------------------------------------------------

    def read_order(self) -> list[Peer]:
        with self._pref_lock:
            start = self._preferred
        n = len(self.peers)
        return [self.peers[(start + i) % n] for i in range(n)]

    def failover_read(
        self, op: str, fn: Callable[[Peer], Any], retry_none: bool = False
    ) -> Any:
        """Serve from the preferred peer, advancing (stickily) past
        dead ones. Raises the last error when every peer failed.

        ``retry_none`` (point-reads): a live peer answering None may
        simply have missed a quorum-acked write (hint still pending,
        anti-entropy not yet run) — e.g. an access key created a
        moment ago on W of N siblings. Only conclude not-found once
        every live peer agrees; sticky preference moves only past
        DEAD peers, so one stale replica cannot flap it."""
        last: Exception | None = None
        saw_none = False
        for i, peer in enumerate(self.read_order()):
            try:
                result = fn(peer)
            except StorageError as e:
                last = e
                continue
            if result is None and retry_none:
                saw_none = True
                continue
            if i and last is not None:
                with self._pref_lock:
                    self._preferred = self.peers.index(peer)
                _record(
                    "store_failover",
                    f"{op}: failed over to peer {peer.name} ({last})",
                    severity=timeline_mod.WARN,
                    peer=peer.name,
                )
            return result
        if saw_none:
            return None
        raise last if last is not None else StorageError(
            f"{op}: no peers configured"
        )

    # -- hinted-handoff drain ---------------------------------------------

    def _hint_loop(self) -> None:
        while not self._stop.wait(hint_interval()):
            for peer in self.peers:
                queue = self.hints[peer.name]
                if queue.pending() == 0:
                    continue
                if not peer.healthy():
                    continue
                try:
                    replayed = queue.drain(
                        lambda payload, p=peer: self._apply_hint(p, payload)
                    )
                except StorageError as e:
                    logger.info(
                        "hint drain to %s stopped: %s", peer.name, e
                    )
                    replayed = 0
                except Exception:  # noqa: BLE001 - the daemon drainer
                    # must outlive anything a single drain throws, or
                    # hinted handoff silently dies for the process
                    # lifetime while hints keep queueing
                    logger.exception("hint drain to %s failed", peer.name)
                    replayed = 0
                self._hints_gauge.labels(peer.name).set(queue.pending())
                if replayed:
                    self._repairs.labels("hinted_handoff").inc(replayed)
                    _record(
                        "store_hint_drained",
                        f"replayed {replayed} hinted write(s) to "
                        f"recovered peer {peer.name}",
                        peer=peer.name,
                        replayed=replayed,
                    )

    def _apply_hint(self, peer: Peer, payload: dict) -> None:
        op = payload.get("op")
        app_id = payload.get("appId")
        channel_id = payload.get("channelId")
        if op == "event":
            peer.events.insert(
                Event.from_json_dict(payload["event"]),
                app_id,
                channel_id,
                store_seq=payload.get("seq"),
                replay=True,
            )
        elif op == "event_batch":
            peer.events.insert_batch(
                [Event.from_json_dict(d) for d in payload["events"]],
                app_id,
                channel_id,
                store_seq=payload.get("seq"),
                replay=True,
            )
        elif op == "event_init":
            peer.events.init(app_id, channel_id)
        elif op == "event_remove":
            peer.events.remove(app_id, channel_id)
        elif op == "event_delete":
            peer.events.delete(payload["eventId"], app_id, channel_id)
        elif op == "model":
            peer.models.insert(
                Model(
                    id=payload["id"],
                    models=base64.b64decode(payload["b64"]),
                )
            )
        elif op == "model_delete":
            peer.models.delete(payload["id"])
        elif op == "meta":
            kind = payload["kind"]
            attr, _to_json, from_json = _META_KINDS[kind]
            dao = getattr(peer, attr)
            action = payload.get("action", "insert")
            if action == "delete":
                key = payload["key"]
                dao.delete(*key) if isinstance(key, list) else dao.delete(key)
            else:
                record = from_json(payload["record"])
                if kind == "engine_manifests":
                    dao.update(record, upsert=True)
                elif action == "update":
                    dao.update(record)
                else:
                    dao.insert(record)
        else:
            logger.warning("unknown hint op %r dropped", op)


def replication_status(storage) -> dict | None:
    """The replication view of a :class:`Storage` env, if any source is
    ``TYPE=replicated`` — what a non-store server (event server) merges
    into its ``/healthz``."""
    for name, (_spec, conf) in storage._specs.items():
        if conf.get("TYPE") == "replicated":
            return storage._client(name).status()
    return None


# --------------------------------------------------------------------------
# replicated DAOs
# --------------------------------------------------------------------------


class _ReplicatedBase:
    def __init__(self, rc: ReplicatedStoreClient):
        self._rc = rc


def _meta_hint(kind: str, action: str, record=None, key=None, to_json=None):
    payload: dict[str, Any] = {"op": "meta", "kind": kind, "action": action}
    if record is not None:
        payload["record"] = to_json(record)
    if key is not None:
        payload["key"] = key
    return payload


class ReplicatedApps(_ReplicatedBase, AppsBackend):
    def insert(self, app: App) -> int | None:
        # primary-first: one live peer assigns the id (or reports the
        # name conflict), then the CONCRETE record fans out — peers must
        # agree on ids, so auto-assignment can only happen once
        assigned = self._rc.failover_read(
            "apps.insert", lambda p: p.apps.insert(app)
        )
        if assigned is None:
            return None
        stamped = dataclasses.replace(app, id=assigned)

        def fan(peer: Peer):
            # a conflict on replay (record already there) is an ack
            peer.apps.insert(stamped)
            return True

        self._rc.quorum_write(
            "apps.insert",
            fan,
            _meta_hint("apps", "insert", stamped, to_json=app_to_json),
        )
        return assigned

    def get(self, app_id: int) -> App | None:
        return self._rc.failover_read(
            "apps.get", lambda p: p.apps.get(app_id), retry_none=True
        )

    def get_by_name(self, name: str) -> App | None:
        return self._rc.failover_read(
            "apps.get_by_name",
            lambda p: p.apps.get_by_name(name),
            retry_none=True,
        )

    def get_all(self) -> list[App]:
        return self._rc.failover_read(
            "apps.get_all", lambda p: p.apps.get_all()
        )

    def update(self, app: App) -> bool:
        out = self._rc.quorum_write(
            "apps.update",
            lambda p: p.apps.update(app),
            _meta_hint("apps", "update", app, to_json=app_to_json),
        )
        return any(bool(r) for r in out)

    def delete(self, app_id: int) -> bool:
        out = self._rc.quorum_write(
            "apps.delete",
            lambda p: p.apps.delete(app_id),
            _meta_hint("apps", "delete", key=app_id),
        )
        return any(bool(r) for r in out)


class ReplicatedAccessKeys(_ReplicatedBase, AccessKeysBackend):
    def insert(self, access_key: AccessKey) -> str | None:
        key = access_key.key or self.generate_key()
        stamped = dataclasses.replace(access_key, key=key)
        self._rc.quorum_write(
            "access_keys.insert",
            lambda p: p.access_keys.insert(stamped),
            _meta_hint(
                "access_keys", "insert", stamped, to_json=access_key_to_json
            ),
        )
        return key

    def get(self, key: str) -> AccessKey | None:
        return self._rc.failover_read(
            "access_keys.get",
            lambda p: p.access_keys.get(key),
            retry_none=True,
        )

    def get_all(self) -> list[AccessKey]:
        return self._rc.failover_read(
            "access_keys.get_all", lambda p: p.access_keys.get_all()
        )

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return self._rc.failover_read(
            "access_keys.get_by_app_id",
            lambda p: p.access_keys.get_by_app_id(app_id),
        )

    def update(self, access_key: AccessKey) -> bool:
        out = self._rc.quorum_write(
            "access_keys.update",
            lambda p: p.access_keys.update(access_key),
            _meta_hint(
                "access_keys", "update", access_key,
                to_json=access_key_to_json,
            ),
        )
        return any(bool(r) for r in out)

    def delete(self, key: str) -> bool:
        out = self._rc.quorum_write(
            "access_keys.delete",
            lambda p: p.access_keys.delete(key),
            _meta_hint("access_keys", "delete", key=key),
        )
        return any(bool(r) for r in out)


class ReplicatedChannels(_ReplicatedBase, ChannelsBackend):
    def insert(self, channel: Channel) -> int | None:
        assigned = self._rc.failover_read(
            "channels.insert", lambda p: p.channels.insert(channel)
        )
        if assigned is None:
            return None
        stamped = dataclasses.replace(channel, id=assigned)
        self._rc.quorum_write(
            "channels.insert",
            lambda p: p.channels.insert(stamped),
            _meta_hint(
                "channels", "insert", stamped, to_json=channel_to_json
            ),
        )
        return assigned

    def get(self, channel_id: int) -> Channel | None:
        return self._rc.failover_read(
            "channels.get",
            lambda p: p.channels.get(channel_id),
            retry_none=True,
        )

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return self._rc.failover_read(
            "channels.get_by_app_id",
            lambda p: p.channels.get_by_app_id(app_id),
        )

    def delete(self, channel_id: int) -> bool:
        out = self._rc.quorum_write(
            "channels.delete",
            lambda p: p.channels.delete(channel_id),
            _meta_hint("channels", "delete", key=channel_id),
        )
        return any(bool(r) for r in out)


class ReplicatedEngineManifests(_ReplicatedBase, EngineManifestsBackend):
    def insert(self, manifest: EngineManifest) -> None:
        self._rc.quorum_write(
            "engine_manifests.insert",
            lambda p: p.engine_manifests.insert(manifest),
            _meta_hint(
                "engine_manifests", "insert", manifest,
                to_json=manifest_to_json,
            ),
        )

    def get(self, manifest_id: str, version: str) -> EngineManifest | None:
        return self._rc.failover_read(
            "engine_manifests.get",
            lambda p: p.engine_manifests.get(manifest_id, version),
            retry_none=True,
        )

    def get_all(self) -> list[EngineManifest]:
        return self._rc.failover_read(
            "engine_manifests.get_all",
            lambda p: p.engine_manifests.get_all(),
        )

    def update(self, manifest: EngineManifest, upsert: bool = False) -> None:
        self._rc.quorum_write(
            "engine_manifests.update",
            lambda p: p.engine_manifests.update(manifest, upsert=upsert),
            _meta_hint(
                "engine_manifests", "update", manifest,
                to_json=manifest_to_json,
            ),
        )

    def delete(self, manifest_id: str, version: str) -> bool:
        out = self._rc.quorum_write(
            "engine_manifests.delete",
            lambda p: p.engine_manifests.delete(manifest_id, version),
            _meta_hint(
                "engine_manifests", "delete", key=[manifest_id, version]
            ),
        )
        return any(bool(r) for r in out)


class ReplicatedEngineInstances(_ReplicatedBase, EngineInstancesBackend):
    def insert(self, instance: EngineInstance) -> str:
        iid = instance.id or uuid.uuid4().hex
        stamped = dataclasses.replace(instance, id=iid)
        self._rc.quorum_write(
            "engine_instances.insert",
            lambda p: p.engine_instances.insert(stamped),
            _meta_hint(
                "engine_instances", "insert", stamped,
                to_json=engine_instance_to_json,
            ),
        )
        return iid

    def get(self, instance_id: str) -> EngineInstance | None:
        return self._rc.failover_read(
            "engine_instances.get",
            lambda p: p.engine_instances.get(instance_id),
            retry_none=True,
        )

    def get_all(self) -> list[EngineInstance]:
        return self._rc.failover_read(
            "engine_instances.get_all",
            lambda p: p.engine_instances.get_all(),
        )

    def _merged_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        """Union across ALL live peers, newest first — the engine
        server's reload path must find a generation published during a
        peer outage no matter which peer it asks first."""
        by_id: dict[str, EngineInstance] = {}
        live = 0
        for peer in self._rc.read_order():
            try:
                rows = peer.engine_instances.get_completed(
                    engine_id, engine_version, engine_variant
                )
            except StorageError:
                continue
            live += 1
            for row in rows:
                by_id.setdefault(row.id, row)
        if live == 0:
            raise StorageError(
                "engine_instances.get_completed: no live peers"
            )
        return sorted(
            by_id.values(), key=lambda i: i.start_time, reverse=True
        )

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        return self._merged_completed(
            engine_id, engine_version, engine_variant
        )

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None:
        merged = self._merged_completed(
            engine_id, engine_version, engine_variant
        )
        return merged[0] if merged else None

    def update(self, instance: EngineInstance) -> bool:
        out = self._rc.quorum_write(
            "engine_instances.update",
            lambda p: p.engine_instances.update(instance),
            _meta_hint(
                "engine_instances", "update", instance,
                to_json=engine_instance_to_json,
            ),
        )
        return any(bool(r) for r in out)

    def delete(self, instance_id: str) -> bool:
        out = self._rc.quorum_write(
            "engine_instances.delete",
            lambda p: p.engine_instances.delete(instance_id),
            _meta_hint("engine_instances", "delete", key=instance_id),
        )
        return any(bool(r) for r in out)


class ReplicatedEvaluationInstances(
    _ReplicatedBase, EvaluationInstancesBackend
):
    def insert(self, instance: EvaluationInstance) -> str:
        iid = instance.id or uuid.uuid4().hex
        stamped = dataclasses.replace(instance, id=iid)
        self._rc.quorum_write(
            "evaluation_instances.insert",
            lambda p: p.evaluation_instances.insert(stamped),
            _meta_hint(
                "evaluation_instances", "insert", stamped,
                to_json=evaluation_instance_to_json,
            ),
        )
        return iid

    def get(self, instance_id: str) -> EvaluationInstance | None:
        return self._rc.failover_read(
            "evaluation_instances.get",
            lambda p: p.evaluation_instances.get(instance_id),
            retry_none=True,
        )

    def get_all(self) -> list[EvaluationInstance]:
        return self._rc.failover_read(
            "evaluation_instances.get_all",
            lambda p: p.evaluation_instances.get_all(),
        )

    def get_completed(self) -> list[EvaluationInstance]:
        return self._rc.failover_read(
            "evaluation_instances.get_completed",
            lambda p: p.evaluation_instances.get_completed(),
        )

    def update(self, instance: EvaluationInstance) -> bool:
        out = self._rc.quorum_write(
            "evaluation_instances.update",
            lambda p: p.evaluation_instances.update(instance),
            _meta_hint(
                "evaluation_instances", "update", instance,
                to_json=evaluation_instance_to_json,
            ),
        )
        return any(bool(r) for r in out)

    def delete(self, instance_id: str) -> bool:
        out = self._rc.quorum_write(
            "evaluation_instances.delete",
            lambda p: p.evaluation_instances.delete(instance_id),
            _meta_hint("evaluation_instances", "delete", key=instance_id),
        )
        return any(bool(r) for r in out)


class ReplicatedModels(_ReplicatedBase, ModelsBackend):
    """Quorum blob writes + manifest-verified failover reads.

    The trainer's generation publish
    (``core/persistence.publish_generation``) writes the blob, then the
    manifest. Both inserts go through :meth:`insert`, which raises
    below quorum — so the manifest COMMIT only happens once the blob is
    quorum-durable, and a generation can never become loadable on peers
    that would then fail to serve its artifact.
    """

    def insert(self, model: Model) -> None:
        self._rc.quorum_write(
            "models.insert",
            lambda p: p.models.insert(model),
            lambda peer: {
                "op": "model",
                "id": model.id,
                "b64": base64.b64encode(model.models).decode("ascii"),
            },
        )

    def _manifest_spec(self, peer: Peer, model_id: str) -> dict | None:
        """The manifest's artifact entry for ``model_id`` on ``peer``,
        or None when the blob is legacy/unmanifested."""
        if model_id.endswith(_MANIFEST_SUFFIX):
            return None
        try:
            record = peer.models.get(model_id + _MANIFEST_SUFFIX)
        except StorageError:
            return None
        if record is None:
            return None
        try:
            manifest = json.loads(record.models.decode("utf-8"))
            for art in manifest.get("artifacts", ()):
                if art.get("id") == model_id:
                    return art
        except (ValueError, UnicodeDecodeError):
            return None
        return None

    @staticmethod
    def _verify(blob: bytes, spec: dict | None) -> bool:
        if spec is None:
            return True
        if len(blob) != spec.get("bytes"):
            return False
        return hashlib.sha256(blob).hexdigest() == spec.get("sha256")

    def get(self, model_id: str) -> Model | None:
        """Failover read with read-repair: serve the first peer whose
        blob verifies against its generation manifest; peers found
        stale (missing) or corrupt (checksum mismatch) are backfilled
        from the verified copy."""
        stale: list[Peer] = []
        found: Model | None = None
        errors: Exception | None = None
        source: Peer | None = None
        for peer in self._rc.read_order():
            try:
                record = peer.models.get(model_id)
            except StorageError as e:
                errors = e
                continue
            if record is None:
                stale.append(peer)
                continue
            spec = self._manifest_spec(peer, model_id)
            if not self._verify(record.models, spec):
                self._rc._repairs.labels("corrupt_detected").inc()
                _record(
                    "store_read_corrupt",
                    f"model {model_id} on {peer.name} fails its "
                    "manifest checksum; trying next peer",
                    severity=timeline_mod.WARN,
                    peer=peer.name,
                )
                stale.append(peer)
                continue
            found = record
            source = peer
            break
        if found is None:
            if errors is not None and not stale:
                raise errors
            return None
        for peer in stale:
            try:
                peer.models.insert(found)
            except StorageError:
                continue
            self._rc._repairs.labels("read_repair").inc()
            _record(
                "store_read_repair",
                f"backfilled model {model_id} to stale peer "
                f"{peer.name} from {source.name}",
                peer=peer.name,
            )
        return found

    def delete(self, model_id: str) -> bool:
        out = self._rc.quorum_write(
            "models.delete",
            lambda p: p.models.delete(model_id),
            {"op": "model_delete", "id": model_id},
        )
        return any(bool(r) for r in out)

    def list_ids(self) -> list[str] | None:
        return self._rc.failover_read(
            "models.list_ids", lambda p: p.models.list_ids()
        )


class ReplicatedEvents(_ReplicatedBase, EventsBackend):
    """Quorum event ingest (the ``zero ack'd-write loss`` contract).

    Events are id-stamped BEFORE the fan-out so every peer stores the
    same identity; a peer-level send failure retries once with the same
    ``X-PIO-Store-Seq`` token (the server dedupes the replay), then
    falls to hinted handoff if the quorum still holds without it.
    """

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        out = self._rc.quorum_write(
            "events.init",
            lambda p: p.events.init(app_id, channel_id),
            {"op": "event_init", "appId": app_id, "channelId": channel_id},
        )
        return any(bool(r) for r in out)

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        out = self._rc.quorum_write(
            "events.remove",
            lambda p: p.events.remove(app_id, channel_id),
            {"op": "event_remove", "appId": app_id, "channelId": channel_id},
        )
        return any(bool(r) for r in out)

    def close(self) -> None:
        pass  # peers are owned by the client; Storage closes it

    def _insert_one_on(
        self, peer: Peer, stamped: Event, app_id, channel_id
    ) -> str:
        seq = self._rc.next_seq(peer)
        try:
            return peer.events.insert(
                stamped, app_id, channel_id, store_seq=seq
            )
        except StorageError:
            # one replay with the SAME token: if the first send
            # committed before the connection died, the server answers
            # from its dedupe cache (or skips the duplicate id)
            return peer.events.insert(
                stamped, app_id, channel_id, store_seq=seq
            )

    def insert(
        self, event: Event, app_id: int, channel_id: int | None = None
    ) -> str:
        stamped = event.with_id(event.event_id)
        self._rc.quorum_write(
            "events.insert",
            lambda p: self._insert_one_on(p, stamped, app_id, channel_id),
            lambda peer: {
                "op": "event",
                "appId": app_id,
                "channelId": channel_id,
                "event": stamped.to_json_dict(),
                "seq": self._rc.next_seq(peer),
            },
        )
        return stamped.event_id

    def insert_batch(
        self,
        events,
        app_id: int,
        channel_id: int | None = None,
    ) -> list[str]:
        if not events:
            return []
        stamped = [e.with_id(e.event_id) for e in events]
        ids = [e.event_id for e in stamped]
        rc = self._rc

        def attempt(peer: Peer):
            seq = rc.next_seq(peer)
            try:
                acked = peer.events.insert_batch(
                    stamped, app_id, channel_id, store_seq=seq
                )
                return set(acked), None, seq
            except PartialBatchError as e:
                # the peer ANSWERED: its durable prefix is exact
                return set(e.inserted_ids), "partial", seq
            except StorageError:
                try:
                    acked = peer.events.insert_batch(
                        stamped, app_id, channel_id, store_seq=seq
                    )
                    return set(acked), None, seq
                except PartialBatchError as e:
                    return set(e.inserted_ids), "partial", seq
                except StorageError:
                    return set(), "fail", seq

        futures = [
            (peer, rc._pool.submit(attempt, peer)) for peer in rc.peers
        ]
        per_peer: list[tuple[Peer, set, str | None, str]] = []
        for peer, fut in futures:
            acked, state, seq = fut.result()
            per_peer.append((peer, acked, state, seq))

        # durable prefix: an event is ack'd iff >= W peers hold it, and
        # the batch contract only acks an unbroken prefix
        durable: list[str] = []
        for event_id in ids:
            votes = sum(
                1 for _p, acked, _s, _q in per_peer if event_id in acked
            )
            if votes >= rc.w:
                durable.append(event_id)
            else:
                break

        # hints carry only the DURABLE prefix: an event that never
        # reached quorum was never acked to the caller
        # (PartialBatchError below), so replaying it later would
        # resurrect a write the caller believes failed — and a caller
        # retry of the suffix (fresh UUIDs) would then logically
        # duplicate it. The un-acked suffix converges via anti-entropy
        # only, exactly the below-quorum contract of quorum_write. A
        # fully-failed peer keeps its original seq token (an ambiguous
        # torn-but-committed send dedupes server-side).
        durable_set = set(durable)
        durable_events = [e for e in stamped if e.event_id in durable_set]
        for peer, acked, state, seq in per_peer:
            missing = [
                e for e in durable_events if e.event_id not in acked
            ]
            if not missing:
                continue
            payload = {
                "op": "event_batch",
                "appId": app_id,
                "channelId": channel_id,
                "events": [e.to_json_dict() for e in missing],
            }
            if state == "fail":
                payload["seq"] = seq
            rc.add_hint(peer, payload)

        if len(durable) < len(ids):
            raise PartialBatchError(
                f"only {len(durable)}/{len(ids)} events reached the "
                f"W={rc.w} quorum",
                durable,
            )
        return ids

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        return self._rc.failover_read(
            "events.get",
            lambda p: p.events.get(event_id, app_id, channel_id),
            retry_none=True,
        )

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        out = self._rc.quorum_write(
            "events.delete",
            lambda p: p.events.delete(event_id, app_id, channel_id),
            {
                "op": "event_delete",
                "appId": app_id,
                "channelId": channel_id,
                "eventId": event_id,
            },
        )
        return any(bool(r) for r in out)

    def find(self, app_id: int, channel_id: int | None = None, **kw):
        rows = self._rc.failover_read(
            "events.find",
            lambda p: list(p.events.find(app_id, channel_id, **kw)),
        )
        yield from rows


# --------------------------------------------------------------------------
# anti-entropy (runs inside each store server)
# --------------------------------------------------------------------------


class AntiEntropyLoop:
    """Pull-based convergence: each store server, given its replica-set
    siblings (``--peer``), periodically asks every peer what it has and
    pulls anything missing locally — metadata by id, events by
    watermark comparison, model blobs by id-set diff (blobs before
    manifests, so a pulled generation commits atomically here too).
    A node restarted empty (or SIGKILLed mid-batch) converges without
    operator action; the repair is visible in the timeline and the
    ``pio_store_repair_total`` counter.
    """

    def __init__(
        self,
        storage,
        peers: Iterable[str],
        role: str = "replica",
        registry=None,
        timeline=None,
        key: str | None = None,
        interval: float | None = None,
        insert_lock: threading.Lock | None = None,
        watermarks=None,
    ):
        self._storage = storage
        conf = {"KEY": key} if key else {}
        self.peers = [Peer(u, conf) for u in peers]
        self.role = role
        self.interval = interval or sync_interval()
        registry = registry or get_registry()
        self._lag_gauge, self._hints_gauge, self._repairs = (
            _register_metrics(registry)
        )
        self._timeline = timeline
        #: shared with the store server's event-insert routes: the pull
        #: below and the routes are both check-then-insert against an
        #: append-only log, and an unserialized interleaving (e.g. a
        #: hinted-handoff replay racing the pull after a restart) lands
        #: duplicate records no later repair can remove
        self.insert_lock = insert_lock or threading.Lock()
        #: the store server's incremental EventWatermarkCache (when
        #: this loop runs inside one) — keeps the local side of every
        #: watermark comparison O(1) instead of a full log scan per
        #: round, and folds pulled events in so it stays exact. A
        #: standalone loop (tests, tooling) leaves it None and scans.
        self._watermarks = watermarks
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._status_lock = threading.Lock()
        self._peer_status: dict[str, dict] = {
            p.name: {"url": p.url, "lagSeconds": None, "lastSync": None,
                     "error": None}
            for p in self.peers
        }
        self._last_sync: float | None = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="pio-anti-entropy"
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        for p in self.peers:
            p.close()

    def status(self) -> dict:
        """The ``/healthz`` replication payload for this node."""
        with self._status_lock:
            peers = [dict(v) for v in self._peer_status.values()]
            last = self._last_sync
        return {
            "role": self.role,
            "peers": peers,
            "lastSync": last,
            "syncInterval": self.interval,
        }

    # -- sync -------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sync_once()
            except Exception:  # noqa: BLE001 - loop must survive anything
                logger.exception("anti-entropy round failed")

    def sync_once(self, horizon: float | None = None) -> dict:
        """One full round against every peer; returns pull counts.

        ``horizon`` (seconds; default ``max(1, interval)``) excludes
        events created within the last that-many seconds from the pull:
        a write currently fanning out to this node would otherwise race
        the pull of its own copy from a faster sibling and land twice.
        Anything the horizon defers is picked up one round later. Pass
        ``0`` to pull everything (deterministic tests on quiesced
        stores)."""
        if horizon is None:
            horizon = max(1.0, self.interval)
        totals = {"metadata": 0, "events": 0, "models": 0}
        for peer in self.peers:
            if self._stop.is_set():
                break
            try:
                pulled = self._sync_peer(peer, horizon)
            except StorageError as e:
                self._repairs.labels("error").inc()
                with self._status_lock:
                    self._peer_status[peer.name]["error"] = str(e)
                continue
            for k in totals:
                totals[k] += pulled[k]
            with self._status_lock:
                self._peer_status[peer.name].update(
                    lastSync=time.time(), error=None
                )
        with self._status_lock:
            self._last_sync = time.time()
        total = sum(totals.values())
        if total and self._timeline is not None:
            self._timeline.record(
                "store_antientropy",
                f"anti-entropy pulled {totals['events']} event(s), "
                f"{totals['models']} model blob(s), "
                f"{totals['metadata']} metadata record(s) from peers",
                **totals,
            )
        return totals

    def _sync_peer(self, peer: Peer, horizon: float = 0.0) -> dict:
        pulled = {"metadata": 0, "events": 0, "models": 0}
        pulled["metadata"] += self._sync_metadata(peer)
        pulled["events"] += self._sync_events(peer, horizon)
        pulled["models"] += self._sync_models(peer)
        if pulled["metadata"]:
            self._repairs.labels("metadata").inc(pulled["metadata"])
        if pulled["events"]:
            self._repairs.labels("events").inc(pulled["events"])
        if pulled["models"]:
            self._repairs.labels("models").inc(pulled["models"])
        return pulled

    # metadata: pull records the peer has that we don't, keyed per kind
    def _sync_metadata(self, peer: Peer) -> int:
        s = self._storage
        pulled = 0
        pulled += self._pull_missing(
            peer.apps.get_all(),
            s.get_meta_data_apps(),
            key=lambda a: a.id,
        )
        pulled += self._pull_missing(
            peer.access_keys.get_all(),
            s.get_meta_data_access_keys(),
            key=lambda k: k.key,
        )
        local_channels = s.get_meta_data_channels()
        their_channels = []
        for app in s.get_meta_data_apps().get_all():
            their_channels.extend(peer.channels.get_by_app_id(app.id))
        mine = {
            c.id
            for app in s.get_meta_data_apps().get_all()
            for c in local_channels.get_by_app_id(app.id)
        }
        for chan in their_channels:
            if chan.id not in mine:
                local_channels.insert(chan)
                pulled += 1
        pulled += self._pull_missing(
            peer.engine_instances.get_all(),
            s.get_meta_data_engine_instances(),
            key=lambda i: i.id,
        )
        pulled += self._pull_missing(
            peer.evaluation_instances.get_all(),
            s.get_meta_data_evaluation_instances(),
            key=lambda i: i.id,
        )
        local_manifests = s.get_meta_data_engine_manifests()
        mine_m = {(m.id, m.version) for m in local_manifests.get_all()}
        for m in peer.engine_manifests.get_all():
            if (m.id, m.version) not in mine_m:
                local_manifests.insert(m)
                pulled += 1
        return pulled

    @staticmethod
    def _pull_missing(theirs, local_dao, key) -> int:
        mine = {key(r) for r in local_dao.get_all()}
        pulled = 0
        for record in theirs:
            if key(record) not in mine:
                local_dao.insert(record)
                pulled += 1
        return pulled

    # events: watermark comparison per (app, channel), full pull only
    # on divergence; inserts are id-checked so replays can't duplicate
    def _event_coords(self) -> list[tuple[int, int | None]]:
        s = self._storage
        coords: list[tuple[int, int | None]] = []
        channels = s.get_meta_data_channels()
        for app in s.get_meta_data_apps().get_all():
            coords.append((app.id, None))
            for chan in channels.get_by_app_id(app.id):
                coords.append((app.id, chan.id))
        return coords

    def _local_watermark(
        self, app_id: int, channel_id: int | None
    ) -> tuple[str, Any]:
        dao = self._storage.get_events()
        if self._watermarks is not None:
            summary = self._watermarks.summary(app_id, channel_id, dao)
            return summary["checksum"], summary["latest"]

        from predictionio_tpu_torch.serving.store_server import event_set_checksum

        latest = None

        def _ids():
            nonlocal latest
            for e in dao.find(app_id, channel_id):
                if latest is None or e.creation_time > latest:
                    latest = e.creation_time
                yield e.event_id

        checksum = event_set_checksum(_ids())
        return checksum, latest

    def _sync_events(self, peer: Peer, horizon: float = 0.0) -> int:
        import datetime as _dt

        dao = self._storage.get_events()
        cutoff = (
            _dt.datetime.now(_dt.timezone.utc)
            - _dt.timedelta(seconds=horizon)
        )
        pulled = 0
        worst_lag = 0.0
        for app_id, channel_id in self._event_coords():
            try:
                theirs = peer.events.watermark(app_id, channel_id)
            except StorageError:
                continue  # peer may not have this app's log yet
            mine_checksum, mine_latest = self._local_watermark(
                app_id, channel_id
            )
            their_latest = theirs.get("latest")
            if their_latest and mine_latest is not None:
                try:
                    their_dt = _dt.datetime.fromisoformat(their_latest)
                    worst_lag = max(
                        worst_lag,
                        (mine_latest - their_dt).total_seconds(),
                    )
                except ValueError:
                    pass
            if theirs.get("checksum") == mine_checksum:
                continue
            wm = self._watermarks

            def local_ids():
                # the store server's watermark cache, or one scan of the
                # local log; the caller holds the lock
                if wm is not None:
                    return wm.ids_locked(app_id, channel_id, dao)
                return {e.event_id for e in dao.find(app_id, channel_id)}

            # the peer's ids first (a port store server lists them), and
            # only the events this node lacks; a peer without the route
            # (a JAX store server) sends its whole log, as JAX pulls.
            # Too fresh: an event's own fan-out write may still be in
            # flight toward us — defer it to the next round rather than
            # race it into a duplicate append
            listed = peer.events.ids(app_id, channel_id)
            if listed is None:
                fresh = [
                    event
                    for event in peer.events.find(app_id, channel_id)
                    if not (horizon and event.creation_time > cutoff)
                ]
            else:
                stamp = cutoff.timestamp()
                with self.insert_lock:
                    have = local_ids()
                    wanted = [
                        i for i, t in listed
                        if i not in have
                        and not (horizon and t is not None and t > stamp)
                    ]
                fresh = (
                    peer.events.pull(wanted, app_id, channel_id)
                    if wanted else []
                )
            if not fresh:
                continue
            # the local ids under the lock, then one batch append of
            # what it lacks: the JAX loop makes a point read per peer
            # event, and on the event log each of those is a scan of
            # the whole log (ROADMAP.md §3)
            with self.insert_lock:
                have = local_ids()
                missing, seen = [], set()
                for event in fresh:
                    if event.event_id not in have and (
                        event.event_id not in seen
                    ):
                        seen.add(event.event_id)
                        missing.append(event)
                if missing:
                    try:
                        dao.insert_batch(missing, app_id, channel_id)
                    except Exception:
                        # an unknown prefix landed: rescan next time
                        if wm is not None:
                            wm.invalidate_locked(app_id, channel_id)
                        raise
                    if wm is not None:
                        for event in missing:
                            wm.record_insert_locked(
                                app_id, channel_id, event
                            )
                    pulled += len(missing)
        # lag: how far the PEER trails us (what /healthz reports as
        # this node's view of its replica set)
        self._lag_gauge.labels(peer.name).set(max(0.0, worst_lag))
        with self._status_lock:
            self._peer_status[peer.name]["lagSeconds"] = max(0.0, worst_lag)
        return pulled

    # models: id-set diff, blobs before manifests so the manifest stays
    # the commit point; pulled blobs verify against the manifest they
    # arrive with before anything becomes loadable
    def _sync_models(self, peer: Peer) -> int:
        local = self._storage.get_model_data_models()
        mine = local.list_ids()
        if mine is None:
            return 0
        try:
            theirs = peer.models.list_ids()
        except StorageError:
            return 0
        if theirs is None:
            return 0
        missing = [i for i in theirs if i not in set(mine)]
        if not missing:
            return 0
        blobs = [i for i in missing if not i.endswith(_MANIFEST_SUFFIX)]
        manifests = [i for i in missing if i.endswith(_MANIFEST_SUFFIX)]
        pulled = 0
        for model_id in blobs:
            record = peer.models.get(model_id)
            if record is not None:
                local.insert(record)
                pulled += 1
        for manifest_blob_id in manifests:
            record = peer.models.get(manifest_blob_id)
            if record is None:
                continue
            if not self._manifest_artifacts_ok(local, record):
                # commit point discipline: never land a manifest whose
                # artifacts aren't verified-present locally
                self._repairs.labels("manifest_deferred").inc()
                continue
            local.insert(record)
            pulled += 1
        return pulled

    @staticmethod
    def _manifest_artifacts_ok(local, manifest_record: Model) -> bool:
        try:
            manifest = json.loads(manifest_record.models.decode("utf-8"))
            artifacts = manifest.get("artifacts", ())
        except (ValueError, UnicodeDecodeError):
            return False
        for art in artifacts:
            blob = local.get(art.get("id", ""))
            if blob is None:
                return False
            if len(blob.models) != art.get("bytes"):
                return False
            if hashlib.sha256(blob.models).hexdigest() != art.get("sha256"):
                return False
        return True
