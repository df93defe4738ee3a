"""Crash-safe continuous trainer.

Counterpart of ``predictionio_tpu/training/trainer.py``, with the same
state file, triggers, outcomes and metrics; a retrain runs the port's
ALS on the card, a fold-in the port's host-numpy ``fold_in_users``.
The ``pio-tpu trainer`` CLI verb is the CLI's work (ROADMAP.md, queue
1, item 4); its respawn loop and the router it promotes through are the
fleet's (item 5b). The promotion client is here.

The Podracer shape (PAPERS.md): the learner is a *supervised,
restartable service beside the serving path*, not a job inside it. The
``ContinuousTrainer`` watches event-store watermarks (event count +
latest event time per app), triggers

* **incremental fold-in** — new users/items get factors from one
  ``k×k`` normal-equation solve against the frozen opposite factor
  matrix (:func:`predictionio_tpu_torch.ops.als.fold_in_users`), published as
  a child generation of the current one in seconds, and
* **periodic full retrains** — ``run_train`` with the checkpoint flags
  threaded down to :func:`~predictionio_tpu_torch.ops.als.train_als`, so a
  trainer killed -9 (or preempted) mid-epoch resumes from its latest
  restore point instead of restarting from scratch.

Both publish transactional generations (checksum manifest, watermark,
parent pointer — :mod:`predictionio_tpu_torch.core.persistence`), so a
crashed publish can never become the serving model.

Crash-safety state machine: the trainer's own progress lives in an
atomically-written JSON state file next to the checkpoints. On restart
(the ``pio-tpu trainer`` verb supervises the training child with the
same backoff loop that keeps SO_REUSEPORT workers alive —
``serving/workers.supervise_children``) the trainer re-reads the state
file and the ALS checkpoint and continues where the dead process
stopped.

With a ``router_url`` the trainer also closes the loop fleet-wide
("Fleet promotion" in the JAX package's docs): after publishing a generation
it drives the router's ``POST /admin/swap`` directly, so
publish → canary → fleet promotion is ONE pipeline behind ONE
fleet-level shadow gate. The swap token is the generation's instance
id and the "promoting" phase commits to the state file before the
request leaves, so a trainer killed -9 mid-promotion re-drives the
same token on respawn and the gate still fires exactly once.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
import os
import threading
import time
from typing import Any

import numpy as np
import torch

from predictionio_tpu_torch.core.engine import (
    Engine,
    EngineParams,
    WorkflowParams,
)
from predictionio_tpu_torch.core.persistence import (
    deserialize_models,
    load_generation,
    publish_generation,
    serialize_models,
)
from predictionio_tpu_torch.data.storage import (
    EngineInstance,
    Storage,
    get_storage,
)
from predictionio_tpu_torch.data.storage.localfs import atomic_write_bytes
from predictionio_tpu_torch.obs import MetricRegistry, get_registry
from predictionio_tpu_torch.obs.device import DeviceSampler
from predictionio_tpu_torch.ops import als as als_ops
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.utils.bimap import BiMap

logger = logging.getLogger(__name__)


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def _host(factors) -> np.ndarray:
    """float32 numpy of a factor table: a generation staged or trained
    on the card holds CUDA tensors, which are copied to the host first."""
    if isinstance(factors, torch.Tensor):
        factors = factors.detach().cpu().numpy()
    return np.asarray(factors, np.float32)


# --------------------------------------------------------------------------
# Watermarks
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Watermark:
    """Event-store progress marker: how much data existed when a
    generation was trained. Count drives the triggers; the latest event
    time is the freshness provenance recorded in the manifest."""

    count: int = 0
    latest_time: str = ""  # ISO-8601, "" = empty store

    def to_json(self) -> dict:
        return {"count": self.count, "latestTime": self.latest_time}

    @staticmethod
    def from_json(d: dict | None) -> "Watermark":
        d = d or {}
        return Watermark(
            count=int(d.get("count", 0)),
            latest_time=str(d.get("latestTime", "")),
        )


def read_watermark(
    events_backend, app_id: int, channel_id: int | None = None
) -> Watermark:
    """Current watermark of one (app, channel) via the existing store
    APIs. Backends exposing a native ``count_events`` fast path are
    used (no port store has one, nor has any JAX store); otherwise the
    count is one filtered scan (the trainer polls on a human-scale
    interval, not per request)."""
    if hasattr(events_backend, "count_events"):
        count = int(events_backend.count_events(app_id, channel_id))
    else:
        count = sum(1 for _ in events_backend.find(app_id, channel_id))
    latest = ""
    for ev in events_backend.find(
        app_id, channel_id, limit=1, reversed=True
    ):
        latest = ev.event_time.isoformat()
    return Watermark(count=count, latest_time=latest)


# --------------------------------------------------------------------------
# Trainer
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Trigger/checkpoint policy for one supervised trainer."""

    app_name: str
    channel_name: str | None = None
    poll_interval_s: float = 10.0
    #: fold-in as soon as this many events arrived since the last
    #: published generation (0 disables incremental fold-in)
    min_new_events: int = 1
    #: full retrain once this many events accumulated since the last
    #: FULL train (0 = never by count)
    full_every_events: int = 0
    #: full retrain at least this often in seconds (0 = never by time)
    full_every_s: float = 0.0
    checkpoint_dir: str = ""
    checkpoint_every: int = 2
    #: where the trainer's own progress lives; default
    #: ``<checkpoint_dir>/trainer_state.json``
    state_path: str = ""
    #: fleet promotion: after publishing a generation, drive the
    #: router's ``POST /admin/swap`` directly (token = the generation's
    #: instance id, so a respawned trainer re-driving the same
    #: promotion is idempotent — the fleet gate fires exactly once).
    #: Empty = publish only; each replica gates its own /reload.
    router_url: str = ""
    router_key: str = ""
    #: how long one promotion may take end to end (warm + shadow gate
    #: + roll + regression watch) before the trainer stops polling
    promote_timeout_s: float = 600.0

    def resolved_state_path(self) -> str:
        if self.state_path:
            return self.state_path
        if not self.checkpoint_dir:
            raise ValueError(
                "TrainerConfig needs checkpoint_dir or state_path"
            )
        return os.path.join(self.checkpoint_dir, "trainer_state.json")


class ContinuousTrainer:
    """Watermark-triggered trainer publishing transactional generations.

    Single-threaded by design: one training run at a time, state
    committed atomically after every transition. Everything the next
    incarnation needs to continue after ``kill -9`` is on disk — the
    state file, the ALS checkpoint, and the generation chain in the
    model store.

    ``ctx=None`` takes the current CUDA device and raises without one:
    the trainer never trains on the CPU unasked (pass
    ``ComputeContext.create(device="cpu")`` for that).
    """

    def __init__(
        self,
        engine: Engine,
        params: EngineParams,
        engine_id: str,
        config: TrainerConfig,
        engine_version: str = "1",
        engine_variant: str = "default",
        storage: Storage | None = None,
        ctx=None,
        registry: MetricRegistry | None = None,
    ):
        self._engine = engine
        self._params = params
        self._engine_id = engine_id
        self._engine_version = engine_version
        self._engine_variant = engine_variant
        self._storage = storage or get_storage()
        self._ctx = ctx or ComputeContext.create(batch="continuous-trainer")
        self._config = config
        self._registry = registry if registry is not None else get_registry()
        self._runs = self._registry.counter(
            "pio_trainer_runs_total",
            "Training runs triggered by the continuous trainer",
            ("kind", "outcome"),
        )
        self._watermark_gauge = self._registry.gauge(
            "pio_trainer_watermark_events",
            "Event count at the last trainer poll",
        )
        self._backlog_gauge = self._registry.gauge(
            "pio_trainer_backlog_events",
            "Events ingested since the last published generation",
        )
        self._last_train_gauge = self._registry.gauge(
            "pio_train_last_timestamp_seconds",
            "Unix time of the last successfully published generation "
            "(display epoch; freshness = now - this)",
        )
        self._promotions = self._registry.counter(
            "pio_trainer_promotions_total",
            "Trainer-driven fleet promotions, by terminal outcome "
            "(done | failed | rolled_back | timeout | unreachable)",
            ("outcome",),
        )
        self._state = self._load_state()
        self._recover_interrupted_publish()
        app = self._storage.get_meta_data_apps().get_by_name(
            config.app_name
        )
        if app is None:
            raise ValueError(
                f"trainer app {config.app_name!r} does not exist"
            )
        self._app_id = app.id
        self._channel_id = None
        if config.channel_name:
            for ch in self._storage.get_meta_data_channels().get_by_app_id(
                app.id
            ):
                if ch.name == config.channel_name:
                    self._channel_id = ch.id
                    break
            else:
                raise ValueError(
                    f"channel {config.channel_name!r} not found for app "
                    f"{config.app_name!r}"
                )

    # -- durable state ----------------------------------------------------
    def _load_state(self) -> dict:
        try:
            with open(self._config.resolved_state_path()) as f:
                state = json.load(f)
            if not isinstance(state, dict):
                raise ValueError("state is not an object")
            return state
        except FileNotFoundError:
            return {}
        except (OSError, ValueError) as e:
            # a torn state file (should be impossible — atomic writes —
            # but disks lie) degrades to a conservative cold state: the
            # next poll re-trains rather than serving stale silently
            logger.warning("trainer state unreadable (%s); starting cold", e)
            return {}

    def _save_state(self) -> None:
        atomic_write_bytes(
            self._config.resolved_state_path(),
            json.dumps(self._state, sort_keys=True, indent=1).encode(),
        )

    def _recover_interrupted_publish(self) -> None:
        """Close the crash window between run_train COMPLETING (the
        generation is published and deployable) and the trainer
        finalizing its own state: on restart in phase "publishing" the
        run already succeeded, so finalize it — in particular DELETE
        the now-stale checkpoint, which must never seed the next
        train's resume with factors from an already-published run."""
        if self._state.get("phase") != "publishing":
            return
        if self._config.checkpoint_dir:
            try:
                os.remove(
                    als_ops.checkpoint_path(self._config.checkpoint_dir)
                )
            except FileNotFoundError:
                pass
        wm = self._state.get("pendingWatermark")
        now_iso = _now().isoformat()
        # a publish that completed right before the crash still owes
        # the fleet its promotion: mark it pending so the first poll
        # re-drives it (idempotent — the router keys the swap on the
        # generation id)
        next_phase = (
            "promoting"
            if self._config.router_url
            and self._state.get("lastInstanceId")
            else "idle"
        )
        self._state.update(
            phase=next_phase,
            lastFullTrainAt=now_iso,
            lastTrainAt=now_iso,
            fullTrains=int(self._state.get("fullTrains", 0)) + 1,
        )
        if next_phase == "promoting":
            self._state["promoteToken"] = self._state["lastInstanceId"]
        if wm is not None:
            self._state["trainedWatermark"] = wm
            self._state["fullTrainedCount"] = int(wm.get("count", 0))
            self._state.pop("pendingWatermark", None)
        self._save_state()
        logger.info(
            "recovered an interrupted publish: generation %s was "
            "COMPLETED; finalized trainer state and cleared the stale "
            "checkpoint",
            self._state.get("lastInstanceId", "?"),
        )

    @property
    def state(self) -> dict:
        return dict(self._state)

    # -- triggers ---------------------------------------------------------
    def _trained_watermark(self) -> Watermark:
        return Watermark.from_json(self._state.get("trainedWatermark"))

    def decide(self, wm: Watermark) -> str:
        """Trigger policy → "full" | "fold_in" | "idle"."""
        cfg = self._config
        last_full = self._state.get("lastFullTrainAt", "")
        if not last_full:
            return "full"  # never trained: everything is new
        trained = self._trained_watermark()
        new_events = wm.count - trained.count
        if cfg.full_every_s > 0:
            try:
                age = (
                    _now() - _dt.datetime.fromisoformat(last_full)
                ).total_seconds()
            except ValueError:
                age = float("inf")
            if age >= cfg.full_every_s and new_events > 0:
                return "full"
        full_count = int(self._state.get("fullTrainedCount", 0))
        if (
            cfg.full_every_events > 0
            and wm.count - full_count >= cfg.full_every_events
        ):
            return "full"
        if cfg.min_new_events > 0 and new_events >= cfg.min_new_events:
            return "fold_in"
        return "idle"

    def poll_once(self) -> str:
        """One supervision tick: resume an interrupted promotion, read
        the watermark, maybe train, drive the fleet promotion of what
        was published. Returns the action taken ("idle" | "full" |
        "fold_in" — "fold_in" may escalate to "full" when the model
        shape does not support incremental updates)."""
        self._resume_promotion()
        events = self._storage.get_events()
        wm = read_watermark(events, self._app_id, self._channel_id)
        self._watermark_gauge.set(wm.count)
        self._backlog_gauge.set(
            max(0, wm.count - self._trained_watermark().count)
        )
        action = self.decide(wm)
        if action == "idle":
            return action
        if action == "fold_in":
            instance_id = self.fold_in(wm)
            if instance_id:
                self.promote(instance_id)
                return "fold_in"
            action = "full"  # not fold-innable: escalate
        instance_id = self.full_train(wm)
        self.promote(instance_id)
        return action

    # -- fleet promotion --------------------------------------------------
    def _resume_promotion(self) -> None:
        """A trainer respawned mid-promotion re-drives the SAME token:
        the router's idempotent swap returns the in-flight (or already
        terminal) record instead of opening a second gate."""
        if self._state.get("phase") != "promoting":
            return
        token = str(
            self._state.get("promoteToken")
            or self._state.get("lastInstanceId")
            or ""
        )
        if token and self._config.router_url:
            logger.info(
                "resuming interrupted fleet promotion of %s", token
            )
            self.promote(token)
        else:
            self._state["phase"] = "idle"
            self._state.pop("promoteToken", None)
            self._save_state()

    def _post_train_phase(self, instance_id: str) -> str:
        """Phase a just-completed train finalizes into. With a router
        configured the generation OWES a fleet promotion, and that debt
        must be durable in the same state save that records completion:
        phase="promoting" + the token, so a kill -9 in the gap before
        promote() is re-driven by _resume_promotion on respawn."""
        if not self._config.router_url:
            return "idle"
        self._state["promoteToken"] = instance_id
        return "promoting"

    def promote(self, instance_id: str) -> str | None:
        """Drive publish → canary → fleet promotion as ONE pipeline:
        ask the router to stage ``instance_id`` fleet-wide behind its
        shadow gate and poll the swap to a terminal phase. The
        "promoting" phase + token are committed to the state file
        BEFORE the request, so a kill -9 anywhere in here resumes by
        re-driving the same token. Returns the terminal outcome, or
        None when no router is configured."""
        if not self._config.router_url:
            return None
        self._state["phase"] = "promoting"
        self._state["promoteToken"] = instance_id
        self._save_state()
        outcome, swap = self._drive_promotion(instance_id)
        self._state.update(
            phase="idle",
            lastPromotion={
                "generation": instance_id,
                "outcome": outcome,
                "swap": swap,
            },
        )
        self._state.pop("promoteToken", None)
        self._save_state()
        self._promotions.labels(outcome).inc()
        level = (
            logging.INFO if outcome == "done" else logging.WARNING
        )
        logger.log(
            level, "fleet promotion of %s: %s", instance_id, outcome
        )
        return outcome

    def _router_request(self, path: str, body: dict | None = None):
        import urllib.request

        req = urllib.request.Request(
            self._config.router_url.rstrip("/") + path,
            data=json.dumps(body).encode() if body is not None else None,
            method="POST" if body is not None else "GET",
        )
        req.add_header("Content-Type", "application/json")
        if self._config.router_key:
            req.add_header("X-PIO-Server-Key", self._config.router_key)
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read() or b"null")

    def _drive_promotion(self, token: str) -> tuple[str, str | None]:
        """(terminal outcome, swap id). ``unreachable`` / ``timeout`` /
        ``refused`` are trainer-side outcomes — the router may still
        converge on its own; the next generation's promotion (or a
        respawn's resume) re-synchronizes."""
        import urllib.error

        deadline = time.monotonic() + self._config.promote_timeout_s
        record = None
        while record is None:
            try:
                record = self._router_request(
                    "/admin/swap",
                    {"token": token, "generation": token},
                )
            except urllib.error.HTTPError as e:
                # HTTPError IS an OSError — split it out: the router
                # ANSWERED. 409 = "retry shortly" by design (this
                # token's swap record is mid-open, or another gated
                # swap holds the fleet gate); anything else (401 bad
                # key, 400 bad body) is a misconfiguration that a
                # retry or an "unreachable" diagnosis would only hide.
                detail = e.read().decode("utf-8", "replace")[:200]
                if e.code == 409 and time.monotonic() < deadline:
                    logger.info(
                        "router busy for promotion of %s (409 %s); "
                        "retrying", token, detail,
                    )
                    time.sleep(min(1.0, self._config.poll_interval_s))
                    continue
                logger.error(
                    "router refused promotion of %s: HTTP %s %s",
                    token, e.code, detail,
                )
                return "refused", None
            except OSError as e:
                logger.warning(
                    "router unreachable for promotion of %s: %s",
                    token, e,
                )
                return "unreachable", None
        if not isinstance(record, dict) or not record.get("id"):
            logger.warning(
                "router answered a non-swap record for %s: %r",
                token, record,
            )
            return "unreachable", None
        swap_id = record["id"]
        terminal = ("done", "failed", "rolled_back")
        phase = record.get("phase")
        while phase not in terminal and time.monotonic() < deadline:
            time.sleep(
                min(1.0, max(0.1, self._config.poll_interval_s / 10.0))
            )
            try:
                record = self._router_request(f"/admin/swap/{swap_id}")
                phase = (record or {}).get("phase")
            except urllib.error.HTTPError as e:
                # HTTPError IS an OSError — split it out here too: a
                # 4xx is the router DEFINITIVELY not knowing this swap
                # (restarted without/with a stale state file), and
                # spinning on it until promote_timeout would block
                # training ticks for minutes to mislabel it "timeout"
                if e.code >= 500:
                    continue  # router hiccup: poll again in budget
                logger.warning(
                    "router lost swap %s for %s (HTTP %s); its state "
                    "file was discarded or absent",
                    swap_id, token, e.code,
                )
                return "lost", swap_id
            except OSError:
                continue  # router mid-restart: it resumes from ITS state
        if phase not in terminal:
            return "timeout", swap_id
        return str(phase), swap_id

    # -- full retrain ------------------------------------------------------
    def full_train(self, wm: Watermark) -> str:
        """One checkpointed full retrain; returns the instance id.

        ``resume=True`` is unconditional: if the previous incarnation
        died mid-train, the checkpoint it left is the restore point;
        after a COMPLETED train the checkpoint is deleted, so resume on
        fresh runs is a no-op. The resume provenance
        (``resumedFromIteration``) lands in the state file — the
        trainer smoke asserts a killed trainer continued, not
        restarted."""
        from predictionio_tpu_torch.core.workflow import run_train

        cfg = self._config
        resumed_from = als_ops.peek_checkpoint_iteration(
            cfg.checkpoint_dir or None
        )
        self._state["phase"] = "training"
        self._state["resumedFromIteration"] = resumed_from
        self._state["pendingWatermark"] = wm.to_json()
        self._save_state()
        try:
            instance_id = run_train(
                self._engine,
                self._params,
                engine_id=self._engine_id,
                engine_version=self._engine_version,
                engine_variant=self._engine_variant,
                workflow=WorkflowParams(batch="continuous-trainer"),
                ctx=self._ctx,
                storage=self._storage,
                checkpoint_dir=cfg.checkpoint_dir or None,
                checkpoint_every=cfg.checkpoint_every,
                resume=True,
                watermark=wm.to_json(),
            )
        except Exception:
            self._runs.labels("full", "failed").inc()
            self._state["phase"] = "failed"
            self._save_state()
            raise
        # the generation is published and COMPLETED; commit that fact
        # BEFORE clearing the checkpoint so a crash in between is
        # finalized by _recover_interrupted_publish instead of letting
        # the stale checkpoint seed the next train's resume
        self._state["phase"] = "publishing"
        self._state["lastInstanceId"] = instance_id
        self._save_state()
        # a COMPLETED train's checkpoint must not leak into the NEXT
        # run's resume (different data → bogus warm start)
        if cfg.checkpoint_dir:
            try:
                os.remove(als_ops.checkpoint_path(cfg.checkpoint_dir))
            except FileNotFoundError:
                pass
        now_iso = _now().isoformat()
        self._state.update(
            # with a router configured, the promotion debt is committed
            # in the SAME save that records completion — a kill -9
            # between this save and promote() resumes via
            # _resume_promotion instead of silently orphaning the
            # generation behind phase="idle"
            phase=self._post_train_phase(instance_id),
            lastFullTrainAt=now_iso,
            lastTrainAt=now_iso,
            lastInstanceId=instance_id,
            trainedWatermark=wm.to_json(),
            fullTrainedCount=wm.count,
            fullTrains=int(self._state.get("fullTrains", 0)) + 1,
        )
        self._state.pop("pendingWatermark", None)
        self._save_state()
        self._runs.labels("full", "completed").inc()
        self._last_train_gauge.set(_now().timestamp())
        logger.info(
            "full retrain published generation %s (watermark %d events%s)",
            instance_id, wm.count,
            f", resumed from iteration {resumed_from}" if resumed_from
            else "",
        )
        return instance_id

    # -- incremental fold-in ----------------------------------------------
    @staticmethod
    def _als_shaped(payload: Any) -> bool:
        return all(
            hasattr(payload, f)
            for f in (
                "user_factors", "item_factors", "user_map", "item_map",
            )
        )

    def fold_in(self, wm: Watermark) -> str | None:
        """Publish a child generation with folded-in factors for users/
        items unseen by the current generation. Returns the new
        instance id, or None when fold-in does not apply (no current
        generation, non-ALS-shaped model, nothing new) — the caller
        escalates to a full retrain on None only when the trigger
        demanded fresh data."""
        from predictionio_tpu_torch.data.store import EventStore

        instances = self._storage.get_meta_data_engine_instances()
        current = instances.get_latest_completed(
            self._engine_id, self._engine_version, self._engine_variant
        )
        if current is None:
            return None
        models_backend = self._storage.get_model_data_models()
        try:
            entries = deserialize_models(
                load_generation(models_backend, current.id)
            )
        except Exception as e:  # noqa: BLE001 - corrupt -> full retrain
            logger.warning(
                "fold-in cannot load generation %s (%s); escalating",
                current.id, e,
            )
            return None
        als_slots = [
            i for i, (tag, payload) in enumerate(entries)
            if tag == "auto" and self._als_shaped(payload)
        ]
        if not als_slots:
            return None
        # read the SAME event slice the full train reads: the data
        # source's event-name filter and rating key, not the raw stream
        # (a fold-in under a different data view would solve factors
        # against different observations than the parent generation's)
        ds_params = self._params.data_source[1]
        event_names = list(getattr(ds_params, "event_names", ()) or ())
        inter = EventStore(self._storage).interactions(
            self._config.app_name,
            channel_name=self._config.channel_name,
            event_names=event_names or None,
            value_key=getattr(ds_params, "rating_key", None),
        )
        new_models = [payload for _tag, payload in entries]
        total_new_users = total_new_items = 0
        algo_params = [p for _name, p in self._params.algorithms]
        for slot in als_slots:
            # fold in under the SAME objective the parent generation
            # was trained with (reg/alpha/implicit from the algorithm's
            # own params — defaults only if the params lack the fields)
            p = algo_params[slot] if slot < len(algo_params) else None
            model, n_u, n_i = self._fold_in_model(
                entries[slot][1],
                inter,
                reg=float(getattr(p, "lambda_", 0.01)),
                alpha=float(getattr(p, "alpha", 1.0)),
                implicit=bool(getattr(p, "implicit", True)),
            )
            new_models[slot] = model
            total_new_users += n_u
            total_new_items += n_i
        if total_new_users == 0 and total_new_items == 0:
            # watermark moved but nothing fold-innable changed (events
            # for known pairs): record progress so the trigger resets
            self._state["trainedWatermark"] = wm.to_json()
            self._save_state()
            return None
        instance = EngineInstance(
            id="",
            status="INIT",
            start_time=_now(),
            end_time=_now(),
            engine_id=self._engine_id,
            engine_version=self._engine_version,
            engine_variant=self._engine_variant,
            engine_factory=current.engine_factory,
            batch="fold-in",
            env={
                "foldIn": f"users={total_new_users} "
                          f"items={total_new_items}",
                "parent": current.id,
            },
        )
        instance_id = instances.insert(instance)
        instance = instances.get(instance_id)
        try:
            algorithms = self._engine.make_algorithms(self._params)
            blob = serialize_models(instance_id, algorithms, new_models)
            publish_generation(
                models_backend,
                instance_id,
                blob,
                watermark=wm.to_json(),
                parent=current.id,
            )
            instances.update(
                dataclasses.replace(
                    instance, status="COMPLETED", end_time=_now()
                )
            )
        except Exception:
            self._runs.labels("fold_in", "failed").inc()
            instances.update(
                dataclasses.replace(
                    instance, status="FAILED", end_time=_now()
                )
            )
            raise
        self._state.update(
            phase=self._post_train_phase(instance_id),
            lastTrainAt=_now().isoformat(),
            lastInstanceId=instance_id,
            trainedWatermark=wm.to_json(),
            foldIns=int(self._state.get("foldIns", 0)) + 1,
        )
        self._save_state()
        self._runs.labels("fold_in", "completed").inc()
        self._last_train_gauge.set(_now().timestamp())
        logger.info(
            "fold-in published generation %s (parent %s, +%d users, "
            "+%d items)",
            instance_id, current.id, total_new_users, total_new_items,
        )
        return instance_id

    @staticmethod
    def _fold_in_model(
        model: Any,
        inter,
        reg: float = 0.01,
        alpha: float = 1.0,
        implicit: bool = True,
    ) -> tuple[Any, int, int]:
        """Fold new users/items from ``inter`` (the app's interaction
        set under the data source's event filter) into one ALS-shaped
        model, solving under the parent generation's own
        ``reg``/``alpha``/``implicit``. Returns (new model,
        n_new_users, n_new_items). Duplicate (user, item) pairs
        accumulate into one normal-equation contribution — the
        sum-dedupe convention of the implicit preparator. Factors held
        as CUDA tensors are copied to the host first."""
        user_keys = inter.entity_map.keys()
        item_keys = inter.target_map.keys()
        new_user_keys = np.asarray(
            [k for k in user_keys if model.user_map.get(str(k)) is None]
        )
        new_item_keys = np.asarray(
            [k for k in item_keys if model.item_map.get(str(k)) is None]
        )
        user_factors = _host(model.user_factors)
        item_factors = _host(model.item_factors)
        if isinstance(model.user_factors, torch.Tensor) or isinstance(
            model.item_factors, torch.Tensor
        ):
            # the child generation is published with host factors
            model = dataclasses.replace(
                model, user_factors=user_factors, item_factors=item_factors
            )
        # event-store row/col codes → this model's factor indices
        row_keys = inter.entity_map.decode(inter.rows)
        col_keys = inter.target_map.decode(inter.cols)
        model_rows = model.user_map.encode(row_keys)
        model_cols = model.item_map.encode(col_keys)
        n_new_users = n_new_items = 0
        if len(new_user_keys):
            local = BiMap(new_user_keys)
            new_rows = local.encode(row_keys)
            folded = als_ops.fold_in_users(
                item_factors,
                new_rows,
                model_cols,
                inter.values,
                len(new_user_keys),
                reg=reg,
                alpha=alpha,
                implicit=implicit,
            )
            user_factors = np.concatenate([user_factors, folded])
            model = dataclasses.replace(
                model,
                user_factors=user_factors,
                user_map=BiMap(
                    np.concatenate([model.user_map.keys(), new_user_keys])
                ),
            )
            n_new_users = len(new_user_keys)
        if len(new_item_keys):
            local = BiMap(new_item_keys)
            new_cols = local.encode(col_keys)
            # re-encode rows against the (possibly just extended) user
            # map so a brand-new item observed only by brand-new users
            # still gets factors from their folded-in rows
            model_rows = model.user_map.encode(row_keys)
            folded = als_ops.fold_in_users(
                _host(model.user_factors),
                new_cols,
                model_rows,
                inter.values,
                len(new_item_keys),
                reg=reg,
                alpha=alpha,
                implicit=implicit,
            )
            model = dataclasses.replace(
                model,
                item_factors=np.concatenate([item_factors, folded]),
                item_map=BiMap(
                    np.concatenate([model.item_map.keys(), new_item_keys])
                ),
            )
            n_new_items = len(new_item_keys)
        return model, n_new_users, n_new_items

    # -- daemon loop -------------------------------------------------------
    def run_forever(self, stopping: threading.Event) -> None:
        """Poll → maybe train → sleep, until ``stopping`` is set. One
        failure does not kill the loop (the supervisor handles process
        death; an application error is logged and retried next tick)."""
        # device telemetry rides the daemon loop's lifetime: training
        # is where device memory actually moves (factor matrices, batch
        # staging), so the trainer publishes the pio_device_hbm_* gauges
        # (nothing without CUDA)
        sampler = DeviceSampler(self._registry).start()
        try:
            while not stopping.is_set():
                try:
                    action = self.poll_once()
                    if action != "idle":
                        logger.info("trainer tick: %s", action)
                except Exception:
                    logger.exception(
                        "trainer tick failed; retrying next poll"
                    )
                stopping.wait(self._config.poll_interval_s)
        finally:
            sampler.stop()
