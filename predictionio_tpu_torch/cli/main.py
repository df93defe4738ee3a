"""``pio``-style console of the port (reference tools/.../console/
Console.scala:186-677).

Counterpart of ``predictionio_tpu/cli/main.py``: the same verbs, with
the same arguments, defaults, exit codes and stdout lines, over the
port's storage, engines, servers and kernel. Run it as
``python -m predictionio_tpu_torch.cli.main <verb>`` or as the
``pio-tpu-torch`` console script.

Verbs: version, help, status, trace, timeline, profile, app
(new/list/show/delete/data-delete/channel-new/channel-delete), accesskey
(new/list/delete), build, unregister, upgrade, shell, train, eval,
deploy, undeploy, trainer, eventserver, dashboard, adminserver, export,
import, template (list/get), run, start-all, stop-all, daemons, daemon,
storeserver, minipg.

Every verb that builds a ``ComputeContext`` (status, shell, run, train,
eval, deploy, trainer) takes ``--device {cuda,cpu}``, default ``cuda``;
without a card it exits 1 with the context's "no CUDA device" error and
never drops to the CPU unasked. ``trace``, ``timeline``, ``profile`` and
``status --metrics-url`` are pure HTTP and never import torch.

``router`` (the serving fleet's front tier, with ``--spawn-replica``
its autoscaler) and ``status --router-url`` are pure HTTP too: they
import no torch, and the replicas own the card. ``deploy --workers N``
and ``eventserver --workers N`` serve N processes on one port through
``SO_REUSEPORT``.

``minipg`` (the postgres-wire dev store over sqlite) and ``storeserver``
(metadata, model blobs and events over HTTP, for the ``httpstore``
storage type) serve the networked stores; ``start-all --with-minipg``
and ``--with-storeserver`` run them as daemons.

``--store-url`` (repeated) on ``train``, ``deploy``, ``trainer`` and
``eventserver`` points every repository at a replicated set of store
servers (quorum writes, failover reads, hinted handoff); ``storeserver
--peer URL --role primary|replica`` runs a node of such a set with its
anti-entropy loop, and ``status --store-url`` prints one health line per
node.

A verb or option that needs a part of the system not ported yet exits 1
naming its ROADMAP.md item before doing anything: more than one card
(9).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

from predictionio_tpu_torch.obs.context import redact_keys
from predictionio_tpu_torch.version import __version__

_ITEM = {
    "9": "ROADMAP.md, queue 1, item 9",
}


def _refuse(what: str, item: str) -> int:
    """Print why ``what`` cannot run in the port and return exit code 1."""
    print(f"error: {what} is not ported yet ({_ITEM[item]})",
          file=sys.stderr)
    return 1


def _load_variant(path: str | None) -> dict:
    if not path:
        return {}
    with open(path) as f:
        return json.load(f)


def _resolve(args) -> tuple:
    """(engine, engine_params, engine_id, variant_name, variant_dict)
    from CLI args."""
    from predictionio_tpu_torch.core.registry import resolve_engine_factory

    variant = _load_variant(getattr(args, "variant", None))
    factory_name = args.engine or variant.get("engineFactory")
    if not factory_name:
        raise SystemExit(
            "error: --engine (or an engine.json with engineFactory) "
            "is required"
        )
    engine = resolve_engine_factory(factory_name)()
    params = engine.params_from_variant(variant)
    engine_id = getattr(args, "engine_id", None) or variant.get(
        "id", factory_name
    )
    return engine, params, engine_id, variant.get("variant", "default"), variant


def _apply_store_urls(urls: list[str], access_key: str = "") -> None:
    """Point every repository at a replicated store-server set
    (repeated ``--store-url``): quorum writes, failover reads, hinted
    handoff. One URL is the degenerate W=1 case and behaves like a plain
    httpstore source."""
    from predictionio_tpu_torch.data.storage import Storage, set_storage

    env = dict(os.environ)
    env.update(
        {
            "PIO_STORAGE_SOURCES_REPLSET_TYPE": "replicated",
            "PIO_STORAGE_SOURCES_REPLSET_URLS": ",".join(urls),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "REPLSET",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "REPLSET",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "REPLSET",
        }
    )
    if access_key:
        env["PIO_STORAGE_SOURCES_REPLSET_KEY"] = access_key
    set_storage(Storage(env))


def _store_urls_from_args(args) -> None:
    urls = getattr(args, "store_urls", None)
    if urls:
        _apply_store_urls(urls, getattr(args, "store_access_key", ""))


def _batched_insert(events_iter, backend, app_id, channel_id) -> int:
    """Insert an event stream in 500-event batches; returns the count."""
    batch, n = [], 0
    for event in events_iter:
        batch.append(event)
        if len(batch) >= 500:
            backend.insert_batch(batch, app_id, channel_id)
            n += len(batch)
            batch = []
    if batch:
        backend.insert_batch(batch, app_id, channel_id)
        n += len(batch)
    return n


def _variant_batch(args, variant: dict | None) -> str:
    """Run batch label: the --batch flag wins, else the variant's
    ``meshConf.batch``."""
    return (
        getattr(args, "batch", "")
        or ((variant or {}).get("meshConf") or {}).get("batch", "")
        or ""
    )


def _mesh_ctx(args, variant: dict | None = None):
    """Compute context from CLI flags, falling back to the variant's
    embedded ``meshConf`` (``{"meshConf": {"shape": "4,2" | [4, 2],
    "batch": "nightly"}}``), as the JAX console reads it. The port runs
    on one card: a shape spanning more than one device refuses, naming
    item 9. ``--device`` picks the card (default) or the CPU."""
    from predictionio_tpu_torch.cli.commands import CommandError
    from predictionio_tpu_torch.parallel.mesh import ComputeContext

    mesh_conf = (variant or {}).get("meshConf") or {}
    raw_shape = getattr(args, "mesh_shape", None) or mesh_conf.get("shape")
    if raw_shape:
        try:
            if isinstance(raw_shape, str):
                mesh_shape = tuple(int(x) for x in raw_shape.split(","))
            else:
                mesh_shape = tuple(int(x) for x in raw_shape)
        except (TypeError, ValueError):
            raise SystemExit(
                f"error: mesh shape {raw_shape!r} (--mesh-shape / "
                "meshConf.shape) must be device counts like \"4,2\""
            ) from None
        if math.prod(mesh_shape) != 1:
            raise CommandError(
                f"mesh shape {raw_shape!r} (--mesh-shape / meshConf.shape) "
                f"spans {math.prod(mesh_shape)} devices; more than one "
                f"card is not ported yet ({_ITEM['9']})"
            )
    return ComputeContext.create(
        batch=_variant_batch(args, variant), device=args.device
    )


# -- command implementations ----------------------------------------------


def _serve_foreground(http) -> int:
    """Block on a bound HTTPServer with the graceful-drain contract of
    the JAX console: SIGTERM flips ``/healthz`` to draining, refuses new
    work with 503 + ``Retry-After``, lets in-flight requests (and the
    batch on the card) finish within ``PIO_DRAIN_GRACE_S``, then shuts
    the listener down, so ``serve_forever`` returns and the process
    exits 0. ``POST /stop`` (engine servers) and Ctrl-C stop at once;
    the shutdown hooks (an engine server's: close the batchers) run
    either way."""
    from predictionio_tpu_torch.serving import resilience

    restore = resilience.install_signal_drain(http)
    try:
        http.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        restore()
        # waits for a drain that is still running its hooks
        http.shutdown()
    return 0


def cmd_version(args) -> int:
    print(__version__)
    return 0


def _fetch_json(target: str, access_key: str = ""):
    """GET + parse one telemetry endpoint; on any transport/parse
    failure prints a clean ``[ERROR]`` (key redacted) and returns None.
    ``access_key`` travels as ``X-PIO-Server-Key``. ValueError covers
    JSONDecodeError: a proxy error page or a non-pio service answering
    200 must not traceback."""
    import urllib.request

    req = urllib.request.Request(target)
    if access_key:
        req.add_header("X-PIO-Server-Key", access_key)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.load(resp)
    except (OSError, ValueError) as e:
        print(
            f"[ERROR] cannot fetch {redact_keys(target)}: {e}",
            file=sys.stderr,
        )
        return None


_CANARY_STATE_NAMES = {
    0: "idle", 1: "shadowing", 2: "watching", 3: "stable",
    4: "rejected", 5: "rolled_back",
}


def _labeled_sum(data: dict, name: str) -> float:
    family = data.get(name)
    if not isinstance(family, dict):
        return 0.0
    return sum(
        s.get("value", s.get("count", 0)) or 0
        for s in family.get("samples") or []
    )


def _first_value(data: dict, name: str):
    family = data.get(name)
    if not isinstance(family, dict):
        return None
    samples = family.get("samples") or []
    if not samples or "value" not in samples[0]:
        return None
    return samples[0]["value"]


def _model_summary_line(data: dict) -> str | None:
    """One-line model-lifecycle summary from the generation/age/
    last-train gauges, shown ahead of the raw metric dump when the
    scraped server exposes them (engine servers and trainers)."""
    generation = _first_value(data, "pio_model_generation")
    if generation is None:
        return None
    parts = [f"model: generation={int(generation)}"]
    age = _first_value(data, "pio_model_age_seconds")
    if age is not None:
        parts.append(f"age={age:.0f}s")
    last_train = _first_value(data, "pio_train_last_timestamp_seconds")
    if last_train:
        import datetime as _dt

        parts.append(
            "lastTrain="
            + _dt.datetime.fromtimestamp(
                last_train, _dt.timezone.utc
            ).isoformat(timespec="seconds")
        )
    canary = _first_value(data, "pio_canary_state")
    if canary is not None:
        parts.append(
            f"canary={_CANARY_STATE_NAMES.get(int(canary), canary)}"
        )
    quarantined = _first_value(data, "pio_model_quarantined_total")
    if quarantined:
        parts.append(f"quarantined={int(quarantined)}")
    return " ".join(parts)


def _pool_summary_line(data: dict) -> str | None:
    """One-line model-pool summary (multi-tenant serving), rendered only
    when the scraped server runs a pool (pio_pool_* series present)."""
    budget = _first_value(data, "pio_pool_budget_bytes")
    if budget is None:
        return None
    resident = _first_value(data, "pio_pool_tenants_resident") or 0
    hits = _labeled_sum(data, "pio_pool_hits_total")
    misses = _labeled_sum(data, "pio_pool_misses_total")
    parts = [
        f"pool: tenantsResident={int(resident)}",
        f"bytes={int(_labeled_sum(data, 'pio_pool_resident_bytes'))}/"
        f"{int(budget)}",
    ]
    lookups = hits + misses
    if lookups:
        parts.append(f"hitRate={hits / lookups:.2f}")
    parts.append(
        f"evictions={int(_labeled_sum(data, 'pio_pool_evictions_total'))}"
    )
    return " ".join(parts)


def _cache_summary_line(data: dict) -> str | None:
    """One-line serving-cache summary, rendered only when the scraped
    server runs the query cache (``pio_cache_*`` series present)."""
    budget = data.get("pio_cache_budget_bytes")
    if not isinstance(budget, dict) or not budget.get("samples"):
        return None
    hits = _labeled_sum(data, "pio_cache_hits_total")
    misses = _labeled_sum(data, "pio_cache_misses_total")
    parts = [
        "cache: bytes="
        f"{int(_labeled_sum(data, 'pio_cache_resident_bytes'))}/"
        f"{int(_labeled_sum(data, 'pio_cache_budget_bytes'))}"
    ]
    lookups = hits + misses
    if lookups:
        parts.append(f"hitRate={hits / lookups:.2f}")
    parts.append(
        f"coalesced={int(_labeled_sum(data, 'pio_cache_coalesced_total'))}"
    )
    inflight = _labeled_sum(data, "pio_cache_inflight")
    if inflight:
        parts.append(f"inflight={int(inflight)}")
    parts.append(
        f"evictions={int(_labeled_sum(data, 'pio_cache_evictions_total'))}"
    )
    return " ".join(parts)


def _fleet_summary_line(status: dict) -> str:
    """One-line fleet summary from a router's ``GET /`` status payload:
    replica count and health bands, serving generation, in-flight swap
    phase, and the autoscaler's target against the healthy count."""
    replicas = status.get("replicas") or []
    bands: dict[str, int] = {}
    for r in replicas:
        state = str(r.get("state", "?"))
        bands[state] = bands.get(state, 0) + 1
    band_str = " ".join(f"{k}={v}" for k, v in sorted(bands.items()))
    parts = [
        f"fleet: replicas={len(replicas)}"
        + (f" ({band_str})" if band_str else "")
    ]
    generation = status.get("servingGeneration")
    if generation:
        parts.append(f"generation={generation}")
    swaps = status.get("swaps") or {}
    active = swaps.get("active") or []
    if active:
        parts.append(
            "swap="
            + ",".join(
                f"{s.get('generation') or s.get('id')}:{s.get('phase')}"
                for s in active
            )
        )
    else:
        parts.append("swap=none")
    if isinstance(swaps.get("completedTotal"), int):
        parts.append(f"swapsCompleted={swaps['completedTotal']}")
    autoscaler = status.get("autoscaler")
    if isinstance(autoscaler, dict):
        healthy = bands.get("healthy", 0)
        parts.append(
            f"autoscaler={healthy}/{autoscaler.get('target')}"
            f" [{autoscaler.get('min')}..{autoscaler.get('max')}]"
        )
    if status.get("stateFile"):
        parts.append(f"stateFile=({status['stateFile']})")
    return " ".join(parts)


def _fmt_bytes(n: float) -> str:
    for unit, div in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if n >= div:
            return f"{n / div:.2f}{unit}"
    return f"{n:.0f}B"


def _fleet_health_line(health) -> str | None:
    """One-line fleet-health summary from the router's ``fleetHealth``
    status block: goodput, worst-class SLO burn, and each replica's
    device-memory headroom (or RSS where it exports no device gauges)."""
    if not isinstance(health, dict):
        return None
    parts = [
        f"health: goodput={health.get('goodputQps', 0.0)}qps",
        f"burn={health.get('burnRate', 0.0)}",
    ]
    for rid, entry in sorted((health.get("replicas") or {}).items()):
        if not isinstance(entry, dict):
            continue
        bits = []
        if "hbmHeadroomBytes" in entry:
            bits.append(
                f"hbmFree={_fmt_bytes(entry['hbmHeadroomBytes'])}"
            )
        elif "residentBytes" in entry:
            bits.append(f"rss={_fmt_bytes(entry['residentBytes'])}")
        if entry.get("stale"):
            bits.append("stale")
        if bits:
            parts.append(f"{rid}[{' '.join(bits)}]")
    return " ".join(parts)


def _print_router_status(url: str, access_key: str = "") -> int:
    """``status --router-url``: the fleet summary and fleet-health lines
    from the router's own status route, then its federated metrics
    scrape."""
    status = _fetch_json(url.rstrip("/") + "/", access_key=access_key)
    if status is None:
        return 1
    if not isinstance(status, dict) or status.get("service") != "router":
        print(
            f"[ERROR] {redact_keys(url)} is not a pio router "
            "(GET / did not answer a router status payload)",
            file=sys.stderr,
        )
        return 1
    print(_fleet_summary_line(status))
    health = _fleet_health_line(status.get("fleetHealth"))
    if health:
        print(health)
    return _print_metrics(url, access_key=access_key)


def _tenant_cost_line(data: dict, top_n: int = 3) -> str | None:
    """One-line per-tenant cost rollup: the top-N tenants by attributed
    device-seconds, rendered only when ``pio_tenant_*`` series exist."""

    def by_tenant(name):
        family = data.get(name)
        out: dict[str, float] = {}
        if not isinstance(family, dict):
            return out
        for s in family.get("samples") or []:
            tenant = (s.get("labels") or {}).get("tenant")
            if tenant is None:
                continue
            try:
                out[tenant] = out.get(tenant, 0.0) + float(
                    s.get("value", 0) or 0
                )
            except (TypeError, ValueError):
                continue
        return out

    device = by_tenant("pio_tenant_device_seconds_total")
    if not device:
        return None
    total = sum(device.values())
    resident = by_tenant("pio_tenant_resident_byte_seconds_total")
    noisy = by_tenant("pio_tenant_noisy")
    parts = [f"tenants: deviceSeconds={total:.3f}"]
    ranked = sorted(device.items(), key=lambda kv: -kv[1])[:top_n]
    for tenant, dev_s in ranked:
        share = dev_s / total if total > 0 else 0.0
        bits = [f"dev={dev_s:.3f}s({share:.0%})"]
        if resident.get(tenant):
            bits.append(f"res={_fmt_bytes(resident[tenant])}·s")
        if noisy.get(tenant):
            bits.append("noisy")
        parts.append(f"{tenant or '(none)'}[{' '.join(bits)}]")
    if len(device) > top_n:
        parts.append(f"(+{len(device) - top_n} more)")
    return " ".join(parts)


def _print_families(data: dict) -> None:
    for name in sorted(data):
        family = data[name]
        for sample in family["samples"]:
            label = ",".join(
                f"{k}={v}" for k, v in sample["labels"].items()
            )
            label = f"{{{label}}}" if label else ""
            if family["type"] == "histogram":
                print(
                    f"{name}{label} count={sample['count']} "
                    f"p50={sample['p50']} p95={sample['p95']} "
                    f"p99={sample['p99']}"
                )
            else:
                print(f"{name}{label} {sample['value']}")


def _print_metrics(url: str, access_key: str = "") -> int:
    """Scrape a live server's ``/metrics.json`` and print a per-metric
    one-liner (histograms with derived p50/p95/p99), led by the model,
    pool, cache and tenant summaries where the server exposes those
    series. A router's federated shape is printed with its federation
    header line, as the JAX console prints it."""
    target = url.rstrip("/") + "/metrics.json"
    data = _fetch_json(target, access_key=access_key)
    if data is None:
        return 1
    try:
        if (
            isinstance(data, dict)
            and isinstance(data.get("federation"), dict)
            and "fleet" in data
        ):
            fed = data["federation"]
            replicas = ",".join(fed.get("replicas") or []) or "none"
            line = f"federation: replicas={replicas}"
            stale = fed.get("stale") or []
            if stale:
                line += " stale=" + ",".join(stale)
            print(line)
            for summary in (_cache_summary_line, _tenant_cost_line):
                text = summary(data.get("fleet") or {})
                if text:
                    print(text)
            _print_families(data.get("fleet") or {})
            _print_families(data.get("local") or {})
            return 0
        for summary in (_model_summary_line, _pool_summary_line,
                        _cache_summary_line, _tenant_cost_line):
            text = summary(data)
            if text:
                print(text)
        _print_families(data)
    except (AttributeError, KeyError, TypeError) as e:
        print(
            f"[ERROR] {redact_keys(target)} is not a pio metrics.json "
            f"payload: {e!r}",
            file=sys.stderr,
        )
        return 1
    return 0


def _print_store_status(urls: list[str], access_key: str = "") -> int:
    """``status --store-url`` (repeatable): one health line per store
    node from its /healthz — role, peer count, replication lag, hint
    queue depth, last anti-entropy sync. Pure HTTP, never imports torch
    (as ``status --metrics-url``)."""
    import time as _time

    failed = 0
    for url in urls:
        base = url.rstrip("/")
        payload = _fetch_json(f"{base}/healthz", access_key=access_key)
        if payload is None:
            failed += 1
            continue
        state = payload.get("status", "?")
        repl = payload.get("replication")
        if not isinstance(repl, dict):
            print(f"Store {base}: {state}, standalone (no replication)")
            continue
        peers = repl.get("peers") or []
        parts = [
            f"Store {base}: {state}",
            f"role={repl.get('role', '?')}",
            f"peers={len(peers)}",
        ]
        lags = [
            p.get("lagSeconds")
            for p in peers
            if p.get("lagSeconds") is not None
        ]
        if lags:
            parts.append(f"lag={max(lags):.1f}s")
        hints = [p.get("hintsPending") for p in peers
                 if p.get("hintsPending") is not None]
        if hints:
            parts.append(f"hints-pending={sum(hints)}")
        last = repl.get("lastSync")
        if last:
            parts.append(f"last-sync={max(0.0, _time.time() - last):.1f}s ago")
        down = [
            p.get("url", "?") for p in peers
            if p.get("error") or p.get("breaker") == "open"
        ]
        if down:
            parts.append(f"unreachable={','.join(down)}")
        print(" ".join(parts))
        if state != "ok":
            failed += 1
    return 1 if failed else 0


def cmd_status(args) -> int:
    """Reference Console.status:1035-1107: verify storage + compute.
    With ``--metrics-url`` it instead scrapes a running server's
    telemetry registry (pure HTTP: it returns before torch is
    imported)."""
    if getattr(args, "store_urls", None):
        # replicated-store health; pure HTTP like --metrics-url
        return _print_store_status(
            args.store_urls, getattr(args, "access_key", "")
        )
    if getattr(args, "router_url", ""):
        # fleet summary + metrics; pure HTTP like --metrics-url
        return _print_router_status(
            args.router_url, getattr(args, "access_key", "")
        )
    if getattr(args, "metrics_url", ""):
        return _print_metrics(
            args.metrics_url, getattr(args, "access_key", "")
        )

    from predictionio_tpu_torch.data.storage import get_storage
    from predictionio_tpu_torch.parallel.mesh import (
        ComputeContext,
        NoDeviceError,
    )

    print(f"PredictionIO-TPU {__version__}")
    try:
        ctx = ComputeContext.create(device=args.device)
    except NoDeviceError as e:
        print(f"[ERROR] Compute: {e}")
        print("Compute status: FAILED")
        return 1
    if ctx.device.type == "cuda":
        import torch

        names = [
            torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count())
        ]
    else:
        names = [str(ctx.device)]
    print(
        f"Compute: {len(names)} {ctx.device.type} device(s): {names[:8]}"
    )
    problems = get_storage().verify_all_data_objects()
    if problems:
        for p in problems:
            print(f"[ERROR] {p}")
        print("Storage status: FAILED")
        return 1
    print("Storage status: OK")
    print("Your system is all ready to go.")
    return 0


def cmd_trace(args) -> int:
    """Pull the tracing flight recorder from any live server and write
    a Perfetto-loadable trace file. Pure HTTP."""
    target = args.url.rstrip("/") + (
        "/debug/traces.json" if args.raw else "/debug/traces"
    )
    data = _fetch_json(target, access_key=args.access_key)
    if data is None:
        return 1
    if not isinstance(data, dict):
        # a non-pio service answering 200 with a JSON array/scalar must
        # not traceback
        data = {}
    if args.raw:
        if not isinstance(data.get("traces"), list):
            print(
                f"[ERROR] {redact_keys(target)} is not a pio "
                "raw-trace payload",
                file=sys.stderr,
            )
            return 1
        summary = f"{len(data['traces'])} trace(s)"
    else:
        events = data.get("traceEvents")
        if not isinstance(events, list):
            print(
                f"[ERROR] {redact_keys(target)} is not a Chrome "
                "trace-event payload",
                file=sys.stderr,
            )
            return 1
        summary = f"{len(events)} trace event(s)"
    try:
        with open(args.out, "w") as f:
            json.dump(data, f)
    except OSError as e:
        print(f"[ERROR] cannot write {args.out}: {e}", file=sys.stderr)
        return 1
    print(f"Wrote {summary} to {args.out}")
    if not args.raw:
        print("Open it at https://ui.perfetto.dev (or chrome://tracing).")
    return 0


#: event keys rendered in dedicated columns; everything else in an
#: event dict is an emitter-specific field, appended as key=value
_TIMELINE_CORE_KEYS = frozenset(
    ("kind", "message", "severity", "mono", "wall", "seq", "replica")
)


def _render_timeline_event(event: dict) -> str:
    import datetime as _dt

    wall = float(event.get("wall", 0.0) or 0.0)
    stamp = _dt.datetime.fromtimestamp(
        wall, _dt.timezone.utc
    ).isoformat(timespec="milliseconds")
    severity = str(event.get("severity", "info")).upper()
    parts = [stamp, f"{severity:<5}"]
    replica = event.get("replica")
    if replica:
        parts.append(f"[{replica}]")
    parts.append(
        f"{event.get('kind', '?')}: {event.get('message', '')}"
    )
    extras = [
        f"{k}={event[k]}"
        for k in sorted(event)
        if k not in _TIMELINE_CORE_KEYS and event[k] not in ("", None)
    ]
    if extras:
        parts.append("(" + " ".join(extras) + ")")
    return " ".join(parts)


def cmd_timeline(args) -> int:
    """Pull the incident timeline from a live server and render one line
    per lifecycle event, oldest first. Pure HTTP."""
    target = args.url.rstrip("/") + "/debug/timeline.json"
    data = _fetch_json(target, access_key=args.access_key)
    if data is None:
        return 1
    if not isinstance(data, dict) or not isinstance(
        data.get("events"), list
    ):
        print(
            f"[ERROR] {redact_keys(target)} is not a pio timeline "
            "payload",
            file=sys.stderr,
        )
        return 1
    events = [e for e in data["events"] if isinstance(e, dict)]
    if args.tenant:
        events = [e for e in events if e.get("tenant") == args.tenant]
    if args.since and events:
        # the cutoff is relative to the newest event's own wall stamp,
        # not this machine's clock
        newest = max(float(e.get("wall", 0.0) or 0.0) for e in events)
        cutoff = newest - args.since
        events = [
            e for e in events if float(e.get("wall", 0.0) or 0.0) >= cutoff
        ]
    header = [f"timeline: events={len(events)}"]
    replicas = data.get("replicas")
    if isinstance(replicas, list) and replicas:
        header.append("replicas=" + ",".join(str(r) for r in replicas))
    stale = data.get("stale")
    if isinstance(stale, list) and stale:
        header.append("stale=" + ",".join(str(r) for r in stale))
    dropped = data.get("dropped")
    if dropped:
        header.append(f"dropped={dropped}")
    if args.tenant:
        header.append(f"tenant={args.tenant}")
    if args.since:
        header.append(f"since={args.since:g}s")
    print(" ".join(header))
    for event in events:
        print(_render_timeline_event(event))
    return 0


def _safe_extract(tar, dest: str) -> None:
    """Extract refusing path-traversing members (absolute paths,
    ``..``) — the server is trusted, the archive format is not."""
    try:
        tar.extractall(dest, filter="data")
        return
    except TypeError:
        pass  # Python without the tarfile filter API
    base = os.path.realpath(dest)
    for member in tar.getmembers():
        target = os.path.realpath(os.path.join(dest, member.name))
        if target != base and not target.startswith(base + os.sep):
            raise ValueError(f"unsafe tar member: {member.name}")
    tar.extractall(dest)


def cmd_profile(args) -> int:
    """Trigger an on-demand profile capture on a live engine server
    (``POST /debug/profile``) and extract the returned tar.gz bundle
    under ``--out``. Pure HTTP."""
    import base64
    import io
    import tarfile
    import urllib.request

    target = args.url.rstrip("/") + "/debug/profile"
    req = urllib.request.Request(
        target,
        data=json.dumps({"durationMs": args.duration_ms}).encode(),
        method="POST",
        headers={"Content-Type": "application/json"},
    )
    if args.access_key:
        req.add_header("X-PIO-Server-Key", args.access_key)
    try:
        timeout = max(30.0, args.duration_ms / 1000.0 + 30.0)
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            data = json.load(resp)
    except (OSError, ValueError) as e:
        print(
            f"[ERROR] cannot fetch {redact_keys(target)}: {e}",
            file=sys.stderr,
        )
        return 1
    if (
        not isinstance(data, dict)
        or not data.get("bundle")
        or not isinstance(data.get("profile"), dict)
    ):
        print(
            f"[ERROR] {redact_keys(target)} did not answer a profile "
            "bundle",
            file=sys.stderr,
        )
        return 1
    try:
        raw = base64.b64decode(data["bundle"])
    except (TypeError, ValueError):
        print(
            "[ERROR] profile bundle is not valid base64",
            file=sys.stderr,
        )
        return 1
    try:
        os.makedirs(args.out, exist_ok=True)
        with tarfile.open(fileobj=io.BytesIO(raw), mode="r:gz") as tar:
            _safe_extract(tar, args.out)
    except (OSError, ValueError, tarfile.TarError) as e:
        print(
            f"[ERROR] cannot extract profile bundle: {e}",
            file=sys.stderr,
        )
        return 1
    manifest = data["profile"]
    dest = os.path.join(args.out, f"profile-{manifest.get('id')}")
    print(
        f"Wrote profile artifact {manifest.get('id')} "
        f"({manifest.get('durationS')}s window) to {dest}"
    )
    print(
        "spans.json opens at https://ui.perfetto.dev; "
        "jax_trace/ loads in TensorBoard."
    )
    return 0


def cmd_lint(args) -> int:
    print(
        "error: not ported: the source linter is JAX developer tooling "
        "(ROADMAP.md, not queued)",
        file=sys.stderr,
    )
    return 1


def cmd_app(args) -> int:
    from predictionio_tpu_torch.cli import commands
    from predictionio_tpu_torch.data.storage import get_storage

    storage = get_storage()
    if args.app_command == "new":
        info = commands.create_app(
            args.name,
            description=args.description,
            access_key=args.access_key or "",
            storage=storage,
        )
        print(f"Created a new app: {args.name} (id {info['app_id']})")
        print(f"Access Key: {info['access_key']}")
    elif args.app_command == "list":
        for app in storage.get_meta_data_apps().get_all():
            print(f"{app.id}\t{app.name}\t{app.description or ''}")
    elif args.app_command == "show":
        print(json.dumps(commands.show_app(args.name, storage), indent=2))
    elif args.app_command == "delete":
        commands.delete_app(args.name, storage)
        print(f"Deleted app {args.name}.")
    elif args.app_command == "data-delete":
        commands.delete_app_data(args.name, args.channel, storage)
        print(f"Deleted data of app {args.name}.")
    elif args.app_command == "channel-new":
        cid = commands.create_channel(args.name, args.channel, storage)
        print(f"Created channel {args.channel} (id {cid}).")
    elif args.app_command == "channel-delete":
        commands.delete_channel(args.name, args.channel, storage)
        print(f"Deleted channel {args.channel}.")
    return 0


def cmd_accesskey(args) -> int:
    from predictionio_tpu_torch.cli import commands
    from predictionio_tpu_torch.data.storage import get_storage

    storage = get_storage()
    if args.ak_command == "new":
        events = tuple(args.events.split(",")) if args.events else ()
        key = commands.new_access_key(args.app_name, events, storage)
        print(f"Access Key: {key}")
    elif args.ak_command == "list":
        keys = storage.get_meta_data_access_keys()
        apps = storage.get_meta_data_apps()
        if args.app_name:
            app = apps.get_by_name(args.app_name)
            rows = keys.get_by_app_id(app.id) if app else []
        else:
            rows = keys.get_all()
        for k in rows:
            print(f"{k.key}\t{k.appid}\t{','.join(k.events)}")
    elif args.ak_command == "delete":
        ok = storage.get_meta_data_access_keys().delete(args.key)
        print("Deleted." if ok else "Key not found.")
        return 0 if ok else 1
    return 0


def cmd_build(args) -> int:
    """Python needs no compile; validate the engine + variant, then
    register an EngineManifest (reference Console.build:812-833 →
    RegisterEngine.scala:33-58)."""
    from predictionio_tpu_torch.data.storage import (
        EngineManifest,
        get_storage,
    )

    engine, params, engine_id, _, variant = _resolve(args)
    print(
        f"Engine {engine_id} OK: "
        f"{len(engine.algorithm_classes)} algorithm class(es), "
        f"{len(params.algorithms)} configured"
    )
    manifest = EngineManifest(
        id=engine_id,
        version=variant.get("engineVersion", __version__),
        name=engine_id,
        description=variant.get("description"),
        files=(os.path.abspath(args.variant),) if args.variant else (),
        engine_factory=args.engine or variant.get("engineFactory", ""),
    )
    get_storage().get_meta_data_engine_manifests().update(
        manifest, upsert=True
    )
    print(f"Registered engine {manifest.id} {manifest.version}.")
    return 0


def cmd_unregister(args) -> int:
    """Delete a registered EngineManifest (reference Console.unregister →
    RegisterEngine.unregisterEngine, RegisterEngine.scala:60-84)."""
    from predictionio_tpu_torch.data.storage import get_storage

    manifests = get_storage().get_meta_data_engine_manifests()
    version = args.engine_version or __version__
    if manifests.delete(args.engine_id, version):
        print(f"Unregistered engine {args.engine_id} {version}.")
        return 0
    print(
        f"Engine {args.engine_id} {version} is not registered.",
        file=sys.stderr,
    )
    return 1


def cmd_upgrade(args) -> int:
    """Migrate an app's events between two declared storage sources
    (the analogue of the reference's 0.8.x→0.9 HBase migration)."""
    import pickle
    import tempfile

    from predictionio_tpu_torch.data.storage import get_storage

    if args.from_source == args.to_source:
        print(
            "error: --from and --to must be different storage sources",
            file=sys.stderr,
        )
        return 1
    storage = get_storage()
    src = storage.backend_for_source(args.from_source)
    dst = storage.backend_for_source(args.to_source)
    app = storage.get_meta_data_apps().get_by_name(args.app_name)
    if app is None:
        print(f"error: app {args.app_name!r} not found", file=sys.stderr)
        return 1
    channel_ids = [None] + [
        c.id
        for c in storage.get_meta_data_channels().get_by_app_id(app.id)
    ]
    total = 0
    for cid in channel_ids:
        dst.init(app.id, cid)
        # snapshot the source scan before inserting: both sources may
        # share an underlying store, and inserting mid-scan over a live
        # cursor can revisit rows. Spool to disk, not RAM.
        with tempfile.TemporaryFile() as spool:
            n = 0
            for ev in src.find(app.id, cid):
                pickle.dump(ev, spool, protocol=pickle.HIGHEST_PROTOCOL)
                n += 1
            spool.seek(0)

            def _replay(f=spool, count=n):
                for _ in range(count):
                    yield pickle.load(f)

            total += _batched_insert(_replay(), dst, app.id, cid)
    print(
        f"Migrated {total} events of app {args.app_name} from "
        f"{args.from_source} to {args.to_source}."
    )
    return 0


def cmd_shell(args) -> int:
    """Interactive REPL with the environment preloaded — the
    ``bin/pio-shell`` analogue: storage wired, ComputeContext built,
    stores importable."""
    import code

    from predictionio_tpu_torch.data.storage import get_storage
    from predictionio_tpu_torch.data.store import EventStore

    ctx = _mesh_ctx(args)
    ns = {
        "storage": get_storage(),
        "ctx": ctx,
        "event_store": EventStore(),
    }
    banner = (
        f"PredictionIO-TPU {__version__} shell\n"
        f"preloaded: storage, ctx (device {ctx.device}), "
        "event_store (find / find_by_entity / aggregate_properties)"
    )
    code.interact(banner=banner, local=ns)
    return 0


def cmd_train(args) -> int:
    from predictionio_tpu_torch.core.engine import WorkflowParams
    from predictionio_tpu_torch.core.workflow import run_train

    _store_urls_from_args(args)
    engine, params, engine_id, variant, variant_dict = _resolve(args)
    workflow = WorkflowParams(
        batch=_variant_batch(args, variant_dict),
        save_model=not args.no_save_model,
        skip_sanity_check=args.skip_sanity_check,
        stop_after_read=args.stop_after_read,
        stop_after_prepare=args.stop_after_prepare,
    )
    instance_id = run_train(
        engine,
        params,
        engine_id=engine_id,
        engine_variant=variant,
        engine_factory=args.engine or "",
        workflow=workflow,
        ctx=_mesh_ctx(args, variant_dict),
        checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
    )
    print(f"Training completed. Engine instance: {instance_id}")
    return 0


def cmd_eval(args) -> int:
    from predictionio_tpu_torch.core.registry import resolve_engine_factory
    from predictionio_tpu_torch.core.workflow import run_evaluation

    factory = resolve_engine_factory(args.evaluation)
    evaluation = factory() if callable(factory) else factory
    instance_id, result = run_evaluation(
        evaluation, batch=args.batch or "", ctx=_mesh_ctx(args)
    )
    print(result.to_one_liner())
    print(f"Evaluation instance: {instance_id}")
    return 0


def _reuseport_unsupported() -> str | None:
    """A clean console error when ``--workers N`` cannot work here,
    instead of a traceback (or, on the deploy path, three pointless bind
    retries)."""
    import socket

    if not hasattr(socket, "SO_REUSEPORT"):
        return (
            "error: --workers needs SO_REUSEPORT, which this platform "
            "does not support; run with --workers 1"
        )
    return None


def cmd_deploy(args) -> int:
    from predictionio_tpu_torch.serving.engine_server import EngineServer

    _store_urls_from_args(args)
    if args.max_batch < 1:
        # 0 would also zero the derived queue bound
        print(
            f"error: --max-batch must be >= 1, got {args.max_batch}",
            file=sys.stderr,
        )
        return 1
    if args.max_wait_ms < 0:
        # negative puts every deadline in the past: 1-query batches
        print(
            f"error: --max-wait-ms must be >= 0, got {args.max_wait_ms}",
            file=sys.stderr,
        )
        return 1
    if args.pipeline_depth < 0:
        print(
            f"error: --pipeline-depth must be >= 0, "
            f"got {args.pipeline_depth}",
            file=sys.stderr,
        )
        return 1

    tenants = None
    if args.tenant:
        tenants = {}
        for spec in args.tenant:
            name, sep, tenant_variant = spec.partition("=")
            if not (sep and name and tenant_variant):
                print(
                    f"error: --tenant expects NAME=VARIANT, got {spec!r}",
                    file=sys.stderr,
                )
                return 1
            tenants[name] = tenant_variant
        if args.canary:
            print(
                "error: --canary and --tenant are mutually exclusive "
                "(per-tenant /reload replaces the canary gate)",
                file=sys.stderr,
            )
            return 1
        if args.pool_budget_bytes:
            # the environment rather than a ModelPool of our own, so the
            # server owns (and closes) the pool it builds
            os.environ["PIO_POOL_BUDGET_BYTES"] = str(
                args.pool_budget_bytes
            )

    engine, params, engine_id, variant, variant_dict = _resolve(args)
    feedback_app_id = None
    if args.feedback:
        from predictionio_tpu_torch.data.storage import get_storage

        app = get_storage().get_meta_data_apps().get_by_name(
            args.event_server_app or ""
        )
        if app is None:
            raise SystemExit(
                "error: --feedback requires --event-server-app <existing app>"
            )
        feedback_app_id = app.id
    server = EngineServer(
        engine,
        params,
        engine_id=engine_id,
        engine_variant=variant,
        ctx=_mesh_ctx(args, variant_dict),
        feedback=args.feedback,
        feedback_app_id=feedback_app_id,
        log_url=args.log_url or None,
        log_prefix=args.log_prefix,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        pipeline_depth=args.pipeline_depth,
        adaptive_wait=not args.no_adaptive_wait,
        admission=not args.no_admission,
        canary=args.canary,
        tenants=tenants,
        quantize=args.quantize,
    )
    multi = args.workers > 1
    if multi and (err := _reuseport_unsupported()):
        print(err, file=sys.stderr)
        return 1
    http = server.serve(
        host=args.ip, port=args.port,
        reuse_port=multi or args.reuse_port,
        # a re-exec'd worker must not "undeploy" its own parent
        undeploy_first=not args.reuse_port,
    )
    print(f"Engine server is listening on {args.ip}:{http.port}",
          flush=True)
    if multi:
        from predictionio_tpu_torch.serving import workers as _workers

        print(
            "note: every worker stages its own copy of the model on the "
            "same card (one CUDA context and one copy of the tables per "
            "worker); storage must be a shared backend",
            file=sys.stderr,
        )
        return _workers.serve_with_workers(
            http, args.workers,
            _workers.rebuild_argv(args.raw_argv, http.port),
        )
    return _serve_foreground(http)


def cmd_trainer(args) -> int:
    """Supervised continuous trainer: watches event watermarks, folds in
    new users/items, runs checkpointed full retrains, publishes
    transactional model generations. The default mode supervises the
    training child (``python -m predictionio_tpu_torch.cli.main trainer
    ... --no-supervise``, ``--device`` passed through with the rest of
    the argv) with the backoff respawn loop — kill -9 mid-epoch respawns
    the child, which resumes from the latest checkpoint."""
    import signal as _signal
    import threading

    _store_urls_from_args(args)
    base_dir = args.checkpoint_dir or os.path.join(
        os.environ.get(
            "PIO_FS_BASEDIR",
            os.path.join(os.path.expanduser("~"), ".piotpu"),
        ),
        "trainer",
        args.engine_id or args.engine or "default",
    )
    if not args.no_supervise and not args.once:
        from predictionio_tpu_torch.serving import workers as _workers

        child_argv = list(args.raw_argv) + [
            "--no-supervise", "--checkpoint-dir", base_dir,
        ]

        def spawn():
            return subprocess.Popen(
                [sys.executable, "-m", "predictionio_tpu_torch.cli.main"]
                + child_argv
            )

        stopping = threading.Event()
        slots = [_workers.WorkerSlot(spawn)]

        def _stop(signum, frame):
            stopping.set()

        _signal.signal(_signal.SIGTERM, _stop)
        _signal.signal(_signal.SIGINT, _stop)
        print(f"trainer supervisor: training child pid {slots[0].pid}")
        try:
            _workers.supervise_children(slots, stopping)
        finally:
            # the child finishes its current run on SIGTERM; escalate
            # only after a generous drain
            _workers.terminate_children(slots, 30.0)
        return 0

    # ---- training child ----
    from predictionio_tpu_torch.training import (
        ContinuousTrainer,
        TrainerConfig,
    )

    engine, params, engine_id, variant, variant_dict = _resolve(args)
    config = TrainerConfig(
        app_name=args.app_name,
        channel_name=args.channel or None,
        poll_interval_s=args.poll_interval,
        min_new_events=args.min_new_events,
        full_every_events=args.full_every_events,
        full_every_s=args.full_every_s,
        checkpoint_dir=base_dir,
        checkpoint_every=args.checkpoint_every,
        router_url=args.router_url,
        router_key=args.router_key,
        promote_timeout_s=args.promote_timeout,
    )
    os.makedirs(base_dir, exist_ok=True)
    # pid marker: what a chaos driver (or operator) kills; the
    # supervising parent respawns and training resumes
    with open(os.path.join(base_dir, "trainer.pid"), "w") as f:
        f.write(str(os.getpid()))
    trainer = ContinuousTrainer(
        engine,
        params,
        engine_id=engine_id,
        engine_version="1",
        engine_variant=variant,
        config=config,
        ctx=_mesh_ctx(args, variant_dict),
    )
    http = None
    if args.metrics_port:
        from predictionio_tpu_torch.obs import get_registry, tracing
        from predictionio_tpu_torch.serving.config import ServerConfig
        from predictionio_tpu_torch.serving.http import (
            HTTPServer,
            Router,
            install_metrics_routes,
        )

        router = Router()
        install_metrics_routes(
            router, get_registry(), tracing.get_tracer(),
            server_config=ServerConfig.from_env(),
        )
        http = HTTPServer(
            router,
            host="127.0.0.1",
            port=args.metrics_port,
            service="trainer",
        )
        http.start()
        print(f"trainer metrics on 127.0.0.1:{http.port}/metrics.json")
    stopping = threading.Event()
    if threading.current_thread() is threading.main_thread():
        _signal.signal(_signal.SIGTERM, lambda s, f: stopping.set())
    try:
        if args.once:
            print(f"trainer action: {trainer.poll_once()}")
        else:
            trainer.run_forever(stopping)
    except KeyboardInterrupt:
        pass
    finally:
        if http is not None:
            http.shutdown()
    return 0


def cmd_undeploy(args) -> int:
    from predictionio_tpu_torch.serving.config import ServerConfig
    from predictionio_tpu_torch.serving.engine_server import (
        undeploy_existing,
    )

    if undeploy_existing(args.ip, args.port, ServerConfig.from_env()):
        print(f"Undeployed engine server at {args.ip}:{args.port}")
        return 0
    print(
        f"Undeploy failed: no engine server stopped at "
        f"{args.ip}:{args.port}",
        file=sys.stderr,
    )
    return 1


def cmd_eventserver(args) -> int:
    from predictionio_tpu_torch.serving.event_server import (
        create_event_server,
    )

    _store_urls_from_args(args)
    multi = args.workers > 1
    if multi and (err := _reuseport_unsupported()):
        print(err, file=sys.stderr)
        return 1
    http = create_event_server(host=args.ip, port=args.port,
                               stats=args.stats,
                               reuse_port=multi or args.reuse_port,
                               admission=not args.no_admission)
    print(f"Event server is listening on {args.ip}:{http.port}",
          flush=True)
    if multi:
        from predictionio_tpu_torch.serving import workers as _workers

        print(
            "note: each worker opens storage independently — use a "
            "shared backend (sqlite/eventlog/...), not memory",
            file=sys.stderr,
        )
        return _workers.serve_with_workers(
            http, args.workers,
            _workers.rebuild_argv(args.raw_argv, http.port),
        )
    return _serve_foreground(http)


def cmd_router(args) -> int:
    """Scale-out front tier: least-inflight + consistent-hash dispatch
    across N engine replicas, health-probed through their ``/healthz``
    and warmup gauges, with breaker-guarded single-retry failover and
    rolling generation swaps. With ``--state-file`` the replica set and
    in-flight swaps survive a router crash; with ``--fleet-gate`` swaps
    shadow-score live traffic before promoting; with
    ``--spawn-replica`` an autoscaler grows and shrinks the pool from
    overload signals. Pure HTTP: it never imports torch, and the
    replicas own the card."""
    import dataclasses

    from predictionio_tpu_torch.serving import canary as canary_mod
    from predictionio_tpu_torch.serving.config import ServerConfig
    from predictionio_tpu_torch.serving.router import create_router

    config = ServerConfig.from_env()
    if args.admin_key:
        config = dataclasses.replace(
            config, key_auth_enforced=True, access_key=args.admin_key
        )
    if not config.key_auth_enforced:
        print(
            "WARNING: /admin/* routes are OPEN — anyone who can reach "
            "the router can register or retire replicas. Pass "
            "--admin-key (or set PIO_SERVER_ACCESS_KEY with "
            "PIO_SERVER_KEY_AUTH_ENFORCED=true).",
            file=sys.stderr,
        )
    _router, http = create_router(
        args.replica or [],
        host=args.ip,
        port=args.port,
        probe_interval_s=args.probe_interval,
        failover_retries=args.failover_retries,
        proxy_timeout_s=args.proxy_timeout,
        server_config=config,
        state_path=args.state_file,
        state_max_age_s=args.state_max_age,
        gate_config=(
            canary_mod.CanaryConfig.from_env()
            if args.fleet_gate
            else None
        ),
    )
    autoscaler = None
    if args.spawn_replica:
        import shlex

        from predictionio_tpu_torch.serving.autoscaler import (
            AutoscalerConfig,
            ReplicaAutoscaler,
            ReplicaSpawner,
        )

        scale_cfg = AutoscalerConfig.from_env()
        if args.min_replicas:
            scale_cfg = dataclasses.replace(
                scale_cfg, min_replicas=args.min_replicas
            )
        if args.max_replicas:
            scale_cfg = dataclasses.replace(
                scale_cfg, max_replicas=args.max_replicas
            )
        if scale_cfg.max_replicas < scale_cfg.min_replicas:
            # a floor above the ceiling would pin the pool below it
            scale_cfg = dataclasses.replace(
                scale_cfg, max_replicas=scale_cfg.min_replicas
            )
        autoscaler = ReplicaAutoscaler(
            _router,
            ReplicaSpawner(shlex.split(args.spawn_replica)),
            config=scale_cfg,
        ).start()
        print(
            f"Autoscaler reconciling {scale_cfg.min_replicas}.."
            f"{scale_cfg.max_replicas} replicas via: "
            f"{args.spawn_replica}",
            flush=True,
        )
    print(f"Router is listening on {args.ip}:{http.port}", flush=True)
    if args.replica:
        print(f"Routing across {len(args.replica)} replica(s)")
    if args.state_file:
        print(f"Fleet state persisted to {args.state_file}")
    sys.stdout.flush()
    try:
        return _serve_foreground(http)
    finally:
        if autoscaler is not None:
            autoscaler.close()


def cmd_dashboard(args) -> int:
    from predictionio_tpu_torch.serving.dashboard import create_dashboard

    http = create_dashboard(host=args.ip, port=args.port)
    print(f"Dashboard is listening on {args.ip}:{http.port}", flush=True)
    return _serve_foreground(http)


def cmd_adminserver(args) -> int:
    from predictionio_tpu_torch.serving.admin import create_admin_server

    http = create_admin_server(host=args.ip, port=args.port)
    print(f"Admin server is listening on {args.ip}:{http.port}",
          flush=True)
    return _serve_foreground(http)


def _file_format(explicit: str, path: str) -> str:
    """Export/import format: the flag wins, else the file extension
    (reference Console.scala:604-618 takes --format json|parquet)."""
    if explicit:
        return explicit
    return "npz" if path.endswith(".npz") else "json"


def cmd_export(args) -> int:
    """Events → JSON lines or columnar npz (reference
    export/EventsToFile.scala:40-104, formats json|parquet)."""
    from predictionio_tpu_torch.data.store import EventStore

    store = EventStore()
    found = store.find(args.app_name, channel_name=args.channel)
    if _file_format(args.format, args.output) == "npz":
        from predictionio_tpu_torch.data.eventfile import write_events_npz

        n = write_events_npz(found, args.output)
    else:
        n = 0
        with open(args.output, "w") as f:
            for event in found:
                f.write(json.dumps(event.to_json_dict()) + "\n")
                n += 1
    print(f"Exported {n} events to {args.output}.")
    return 0


def cmd_import(args) -> int:
    """JSON lines or columnar npz → events (reference
    imprt/FileToEvents.scala:41-103)."""
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import get_storage
    from predictionio_tpu_torch.data.store import EventStore

    store = EventStore()
    app_id, channel_id = store._resolve(args.app_name, args.channel)
    events_backend = get_storage().get_events()
    events_backend.init(app_id, channel_id)

    if _file_format(args.format, args.input) == "npz":
        from predictionio_tpu_torch.data.eventfile import read_events_npz

        n = _batched_insert(
            read_events_npz(args.input), events_backend, app_id, channel_id
        )
    else:
        def parse(f):
            for line in f:
                line = line.strip()
                if line:
                    yield Event.from_json_dict(json.loads(line))

        with open(args.input) as f:
            n = _batched_insert(
                parse(f), events_backend, app_id, channel_id
            )
    print(f"Imported {n} events.")
    return 0


def _is_git_source(src: str) -> bool:
    """A template source that names a git repository rather than a
    bundled template or local directory."""
    return (
        "://" in src  # https://, git://, file://, ssh://
        or src.startswith("git@")
        or src.endswith(".git")
    )


def _templates_dir() -> str:
    """Bundled template gallery: the repository's ``examples/``, the
    same one the JAX console lists (``PIO_TEMPLATES_DIR`` overrides)."""
    env = os.environ.get("PIO_TEMPLATES_DIR")
    if env:
        return env
    import predictionio_tpu_torch

    return os.path.join(
        os.path.dirname(os.path.dirname(predictionio_tpu_torch.__file__)),
        "examples",
    )


def _fetch_template(args) -> tuple[str | None, object]:
    """(source directory, clone to clean up) for ``template get``; the
    directory is None after an error has been printed."""
    import tempfile

    if not _is_git_source(args.template):
        if args.ref or args.subdir:
            print(
                "error: --ref/--subdir apply only to git sources "
                f"({args.template!r} is a bundled name or local "
                "directory)",
                file=sys.stderr,
            )
            return None, None
        src = args.template
        if not os.path.isdir(src):
            src = os.path.join(_templates_dir(), args.template)
        if not os.path.isdir(src):
            print(
                f"error: template {args.template!r} not found "
                f"(looked in {_templates_dir()}); `pio-tpu-torch template "
                f"list` shows bundled engines, and a git URL / "
                f"file:// repo fetches remotely",
                file=sys.stderr,
            )
            return None, None
        return src, None
    # a remote gallery: shallow git clone (also covers file:// repos)
    clone_tmp = tempfile.TemporaryDirectory(prefix="pio-tpl-")
    src = os.path.join(clone_tmp.name, "repo")
    cmd = ["git", "clone", "--depth", "1"]
    if args.ref:
        cmd += ["--branch", args.ref]
    cmd += [args.template, src]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError:
        print(
            "error: cannot fetch template: git is not installed "
            "(template get from a URL shells out to git clone)",
            file=sys.stderr,
        )
        clone_tmp.cleanup()
        return None, None
    if proc.returncode != 0:
        print(
            f"error: cannot fetch template from "
            f"{args.template!r}: {proc.stderr.strip()}",
            file=sys.stderr,
        )
        clone_tmp.cleanup()
        return None, None
    if args.subdir:
        root = os.path.realpath(src)
        src = os.path.realpath(os.path.join(src, args.subdir))
        # confine --subdir to the clone: an absolute path or ../
        # traversal must not scaffold from the host tree
        if not src.startswith(root + os.sep) or not os.path.isdir(src):
            print(
                f"error: --subdir {args.subdir!r} does not "
                "name a directory inside the fetched repository",
                file=sys.stderr,
            )
            clone_tmp.cleanup()
            return None, None
    return src, clone_tmp


def cmd_template(args) -> int:
    import predictionio_tpu_torch.models  # noqa: F401  (registers built-ins)
    from predictionio_tpu_torch.core.registry import engine_registry

    if args.template_command == "get":
        import shutil

        dst = args.directory
        if os.path.exists(dst) and (
            not os.path.isdir(dst) or os.listdir(dst)
        ):
            print(
                f"error: destination {dst!r} exists and is not an "
                f"empty directory",
                file=sys.stderr,
            )
            return 1
        src, clone_tmp = _fetch_template(args)
        if src is None:
            return 1
        try:
            # symlinks=True: preserve links as links — dereferencing
            # would let a hostile template repo copy arbitrary host
            # files into the scaffold
            shutil.copytree(
                src, dst, dirs_exist_ok=True, symlinks=True,
                ignore=shutil.ignore_patterns("__pycache__", ".git"),
            )
        finally:
            if clone_tmp is not None:
                clone_tmp.cleanup()
        # personalize engine.json (the reference's scaffolding prompts,
        # Template.scala:226-369, taken from flags instead)
        variant_path = os.path.join(dst, "engine.json")
        if args.engine_id and os.path.lexists(variant_path):
            if os.path.islink(variant_path):
                # writing through a fetched symlink would overwrite the
                # host file it names
                print(
                    "error: fetched engine.json is a symlink — refusing "
                    "to personalize it; inspect the template",
                    file=sys.stderr,
                )
                return 1
            try:
                with open(variant_path) as f:
                    variant = json.load(f)
                if not isinstance(variant, dict):
                    raise ValueError(
                        f"expected a JSON object, got {type(variant).__name__}"
                    )
            except (OSError, ValueError) as exc:
                print(
                    f"error: cannot personalize engine.json: {exc}",
                    file=sys.stderr,
                )
                return 1
            variant["id"] = args.engine_id
            with open(variant_path, "w") as f:
                json.dump(variant, f, indent=2)
                f.write("\n")
        print(f"created engine project at {dst}")
        return 0

    # template list: bundled gallery + registered engine factories
    names = set(engine_registry())
    gallery = _templates_dir()
    if os.path.isdir(gallery):
        names.update(
            name
            for name in os.listdir(gallery)
            if os.path.isdir(os.path.join(gallery, name))
        )
    for name in sorted(names):
        print(name)
    return 0


def cmd_run(args) -> int:
    """Run an arbitrary ``module:fn`` under the environment — storage
    configured, ComputeContext built (the FakeWorkflow/FakeRun analogue,
    workflow/FakeWorkflow.scala:29-106). The callable receives the
    ComputeContext."""
    import importlib

    module_name, _, attr = args.target.partition(":")
    if not attr:
        print(
            "error: run target must look like 'module:function'",
            file=sys.stderr,
        )
        return 1
    sys.path.insert(0, os.getcwd())
    try:
        fn = getattr(importlib.import_module(module_name), attr)
    except (ImportError, AttributeError) as e:
        print(f"error: cannot load {args.target!r}: {e}", file=sys.stderr)
        return 1
    ctx = _mesh_ctx(args)
    result = fn(ctx)
    if result is not None:
        print(json.dumps(result, default=str))
    return 0


def cmd_storeserver(args) -> int:
    """Networked metadata, model and event store service; clients point
    repositories at it with ``PIO_STORAGE_SOURCES_<NAME>_TYPE=httpstore``
    + ``_URL``."""
    import dataclasses

    from predictionio_tpu_torch.serving.config import ServerConfig
    from predictionio_tpu_torch.serving.store_server import (
        create_store_server,
    )

    config = ServerConfig.from_env()
    if args.access_key:
        config = dataclasses.replace(
            config, key_auth_enforced=True, access_key=args.access_key
        )
    if not config.key_auth_enforced and args.ip not in (
        "127.0.0.1", "localhost", "::1"
    ):
        print(
            "WARNING: store server is starting WITHOUT an access key on "
            f"non-loopback bind {args.ip} — it serves all event-server "
            "credentials and model blobs. Pass --access-key, or set "
            "PIO_SERVER_ACCESS_KEY together with "
            "PIO_SERVER_KEY_AUTH_ENFORCED=true.",
            file=sys.stderr,
        )
    http = create_store_server(
        host=args.ip, port=args.port, server_config=config,
        peers=getattr(args, "peers", None) or None,
        role=getattr(args, "role", "replica"),
    )
    print(f"Store server is listening on {args.ip}:{http.port}", flush=True)
    if getattr(args, "peers", None):
        print(
            f"Replication: role={args.role}, anti-entropy against "
            f"{len(args.peers)} peer(s)", flush=True
        )
    return _serve_foreground(http)


def cmd_minipg(args) -> int:
    """Foreground minipg server (the postgres-wire dev store); usually
    run daemonized via ``start-all --with-minipg``."""
    import signal as _signal

    from predictionio_tpu_torch.cli import daemon
    from predictionio_tpu_torch.data.storage.minipg import MiniPGServer

    path = args.path or os.path.join(daemon.base_dir(), "minipg.db")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    server = MiniPGServer(
        path=path,
        host=args.ip,
        port=args.port,
        password=args.password,
    )
    port = server.start()
    print(f"minipg is listening on {args.ip}:{port}", flush=True)
    try:
        _signal.pause()
    except (KeyboardInterrupt, AttributeError):
        pass
    server.stop()
    return 0


def cmd_start_all(args) -> int:
    """Reference bin/pio-start-all: bring up the serving daemons."""
    from predictionio_tpu_torch.cli import daemon

    ports = {}
    if args.eventserver_port:
        ports["eventserver"] = args.eventserver_port
    if args.dashboard_port:
        ports["dashboard"] = args.dashboard_port
    if args.adminserver_port:
        ports["adminserver"] = args.adminserver_port
    if args.minipg_port:
        ports["minipg"] = args.minipg_port
    if args.storeserver_port:
        ports["storeserver"] = args.storeserver_port
    return daemon.start_all(
        ip=args.ip,
        ports=ports,
        # an explicit port is an explicit ask for the optional service
        with_minipg=args.with_minipg or bool(args.minipg_port),
        with_storeserver=(
            args.with_storeserver
            or bool(args.storeserver_port)
            or bool(args.storeserver_access_key)
        ),
        storeserver_access_key=args.storeserver_access_key,
    )


def cmd_stop_all(args) -> int:
    """Reference bin/pio-stop-all."""
    from predictionio_tpu_torch.cli import daemon

    return daemon.stop_all()


def cmd_daemons(args) -> int:
    """Daemon liveness report (exit 0 iff all running)."""
    from predictionio_tpu_torch.cli import daemon

    return daemon.status_all()


def cmd_daemon(args) -> int:
    """Run ANY console verb as a managed background daemon
    (reference bin/pio-daemon: nohup + pidfile)."""
    from predictionio_tpu_torch.cli import daemon

    argv = list(args.cmd)
    if argv and argv[0] == "--":
        argv = argv[1:]
    if not argv:
        print("error: daemon needs a verb to run", file=sys.stderr)
        return 1
    name = args.name or f"daemon-{argv[0]}"
    state, pid = daemon.service_status(name)
    if state == "running":
        print(f"{name}: already running (pid {pid})", file=sys.stderr)
        return 1
    pid = daemon.spawn_daemon(name, argv)
    print(f"{name}: started (pid {pid}, log {daemon.logfile(name)})")
    return 0


# -- parser ----------------------------------------------------------------

#: verbs of the JAX console that need an unported item: verb → (what, item)
_REFUSED_VERBS = {
    "launch": ("launch (the multi-process launcher)", "9"),
}


def _store_url_args(p) -> None:
    p.add_argument(
        "--store-url", dest="store_urls", action="append", default=None,
        help="replicated store-server base URL (repeat once per peer): "
             "writes need a W-of-N quorum, reads fail over between "
             "peers",
    )
    p.add_argument(
        "--store-access-key", dest="store_access_key", default="",
        help="access key the store-server peers require",
    )


def _device_arg(p) -> None:
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="run on the CUDA card (default) or on the host's CPU",
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pio-tpu-torch",
        description="PredictionIO-class ML server console (PyTorch/CUDA)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("version").set_defaults(func=cmd_version)
    # reference Console has an explicit `help` verb besides -h
    sub.add_parser("help").set_defaults(
        func=lambda _args: (parser.print_help(), 0)[1]
    )
    p = sub.add_parser("status")
    p.add_argument(
        "--metrics-url", dest="metrics_url", default="",
        help="scrape a running server's /metrics.json instead of "
             "checking local storage/compute",
    )
    p.add_argument(
        "--router-url", dest="router_url", default="",
        help="summarize a running router's fleet (replica health "
             "bands, serving generation, in-flight swap phase, "
             "autoscaler target vs actual) and scrape its metrics",
    )
    p.add_argument(
        "--access-key", dest="access_key", default="",
        help="server access key for key-authed scrape targets "
             "(sent as the X-PIO-Server-Key header)",
    )
    p.add_argument(
        "--store-url", dest="store_urls", action="append", default=None,
        help="print one store-health line per URL (role, peer count, "
             "replication lag, hint-queue depth, last anti-entropy "
             "sync) instead of checking local storage/compute",
    )
    _device_arg(p)
    p.set_defaults(func=cmd_status)

    p = sub.add_parser("trace")
    p.add_argument(
        "--url", required=True,
        help="base URL of a live server (engine/event/dashboard)",
    )
    p.add_argument(
        "--out", default="trace.json",
        help="output file (default: trace.json)",
    )
    p.add_argument(
        "--raw", action="store_true",
        help="fetch raw span trees (/debug/traces.json) instead of "
             "Perfetto-loadable Chrome trace-event JSON",
    )
    p.add_argument(
        "--access-key", dest="access_key", default="",
        help="server access key (servers that key-auth every route)",
    )
    p.set_defaults(func=cmd_trace)

    p = sub.add_parser("timeline")
    p.add_argument("--url", required=True,
                   help="base URL of a live server")
    p.add_argument(
        "--since", type=float, default=0.0,
        help="only events within the last S seconds, measured back "
             "from the newest event (default: all)",
    )
    p.add_argument(
        "--tenant", default="",
        help="only events correlated with this tenant",
    )
    p.add_argument(
        "--access-key", dest="access_key", default="",
        help="server access key",
    )
    p.set_defaults(func=cmd_timeline)

    p = sub.add_parser("profile")
    p.add_argument("--url", required=True,
                   help="base URL of a live engine server")
    p.add_argument(
        "--out", default="profile",
        help="directory the profile artifact extracts into "
             "(default: ./profile)",
    )
    p.add_argument(
        "--duration-ms", dest="duration_ms", type=float, default=1000.0,
        help="capture window in milliseconds (server-clamped; "
             "default: 1000)",
    )
    p.add_argument(
        "--access-key", dest="access_key", default="",
        help="server access key",
    )
    p.set_defaults(func=cmd_profile)

    sub.add_parser("lint").set_defaults(func=cmd_lint, any_args=True)

    p = sub.add_parser("app")
    ap = p.add_subparsers(dest="app_command", required=True)
    new = ap.add_parser("new")
    new.add_argument("name")
    new.add_argument("--description")
    new.add_argument("--access-key", dest="access_key")
    ap.add_parser("list")
    for verb in ("show", "delete"):
        x = ap.add_parser(verb)
        x.add_argument("name")
    dd = ap.add_parser("data-delete")
    dd.add_argument("name")
    dd.add_argument("--channel")
    for verb in ("channel-new", "channel-delete"):
        x = ap.add_parser(verb)
        x.add_argument("name")
        x.add_argument("channel")
    p.set_defaults(func=cmd_app)

    p = sub.add_parser("accesskey")
    akp = p.add_subparsers(dest="ak_command", required=True)
    aknew = akp.add_parser("new")
    aknew.add_argument("app_name")
    aknew.add_argument("--events", default="")
    aklist = akp.add_parser("list")
    aklist.add_argument("app_name", nargs="?")
    akdel = akp.add_parser("delete")
    akdel.add_argument("key")
    p.set_defaults(func=cmd_accesskey)

    def _engine_args(p, mesh=True):
        p.add_argument("--engine", help="registered name or module:factory")
        p.add_argument("--variant", help="path to engine.json")
        p.add_argument("--engine-id", dest="engine_id")
        p.add_argument("--batch", default="")
        if mesh:
            p.add_argument(
                "--mesh-shape",
                dest="mesh_shape",
                help="data,model mesh shape; one device only (more is "
                     "ROADMAP.md, queue 1, item 9)",
            )
            _device_arg(p)

    def _checkpoint_args(p):
        p.add_argument(
            "--checkpoint-dir", dest="checkpoint_dir", default="",
            help="write mid-training factor checkpoints here "
                 "(atomic npz; enables crash/preemption resume)",
        )
        p.add_argument(
            "--checkpoint-every", dest="checkpoint_every", type=int,
            default=5,
            help="iterations between checkpoints (with --checkpoint-dir;"
                 " default 5)",
        )
        p.add_argument(
            "--resume", action="store_true",
            help="resume from the latest checkpoint in --checkpoint-dir "
                 "instead of restarting from scratch",
        )

    p = sub.add_parser("unregister")
    p.add_argument("--engine-id", required=True)
    p.add_argument("--engine-version", default=None)
    p.set_defaults(func=cmd_unregister)

    p = sub.add_parser("upgrade")
    p.add_argument("--from", dest="from_source", required=True)
    p.add_argument("--to", dest="to_source", required=True)
    p.add_argument("--app", dest="app_name", required=True)
    p.set_defaults(func=cmd_upgrade)

    p = sub.add_parser("shell")
    p.add_argument("--mesh-shape", default=None)
    p.add_argument("--batch", default="shell")
    _device_arg(p)
    p.set_defaults(func=cmd_shell)

    p = sub.add_parser("build")
    _engine_args(p, mesh=False)
    p.set_defaults(func=cmd_build)

    p = sub.add_parser("train")
    _engine_args(p)
    p.add_argument("--skip-sanity-check", action="store_true")
    p.add_argument("--stop-after-read", action="store_true")
    p.add_argument("--stop-after-prepare", action="store_true")
    p.add_argument("--no-save-model", action="store_true")
    _checkpoint_args(p)
    _store_url_args(p)
    p.set_defaults(func=cmd_train)

    p = sub.add_parser("eval")
    p.add_argument(
        "evaluation", help="module:attr producing an Evaluation"
    )
    p.add_argument("--batch", default="")
    p.add_argument("--mesh-shape", dest="mesh_shape")
    _device_arg(p)
    p.set_defaults(func=cmd_eval)

    p = sub.add_parser("deploy")
    _engine_args(p)
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument(
        "--max-batch", dest="max_batch", type=int, default=64,
        help="micro-batcher bucket ceiling (queries per device dispatch)",
    )
    p.add_argument(
        "--max-wait-ms", dest="max_wait_ms", type=float, default=2.0,
        help="micro-batcher fill window in milliseconds",
    )
    p.add_argument(
        "--pipeline-depth", dest="pipeline_depth", type=int, default=2,
        help="batches in flight between device enqueue and collected "
             "results (2 = double buffering; 0 = serial dispatch)",
    )
    p.add_argument(
        "--quantize", choices=("int8", "bf16"), default=None,
        help="serve int8 or bf16 factor tables through the fused kernel",
    )
    p.add_argument(
        "--no-adaptive-wait", dest="no_adaptive_wait",
        action="store_true",
        help="disable the self-tuning fill window (full batches shrink "
             "the next wait toward 0; idle traffic restores it)",
    )
    p.add_argument(
        "--no-admission", dest="no_admission", action="store_true",
        help="disable the adaptive overload controller (criticality-"
             "aware admission + computed Retry-After) — equivalent to "
             "PIO_ADMISSION=0",
    )
    p.add_argument(
        "--canary", action="store_true",
        help="guard /reload with shadow-scored canary promotion + "
             "automatic rollback (PIO_CANARY_* env tunes the gate)",
    )
    p.add_argument(
        "--feedback", action="store_true",
        help="store a predict event (entity pio_pr) for every answer "
             "and return its prId (needs --event-server-app)",
    )
    p.add_argument("--event-server-app", dest="event_server_app")
    p.add_argument(
        "--log-url", dest="log_url", default="",
        help="POST serving errors to this collector URL",
    )
    p.add_argument(
        "--log-prefix", dest="log_prefix", default="",
        help="prefix for remote error-log messages",
    )
    p.add_argument(
        "--tenant", action="append", default=[], metavar="NAME=VARIANT",
        help="serve engine variant VARIANT as tenant NAME through the "
             "model pool on the card (repeatable). Mutually exclusive "
             "with --canary",
    )
    p.add_argument(
        "--pool-budget-bytes", dest="pool_budget_bytes", type=int,
        default=0,
        help="model-pool byte budget for --tenant mode (0 = "
             "PIO_POOL_BUDGET_BYTES env, else PIO_POOL_HBM_FRACTION of "
             "the card's memory)",
    )
    p.add_argument(
        "--workers", type=int, default=1,
        help="SO_REUSEPORT worker processes sharing the port, each with "
             "its own copy of the model on the card (1 = single process)",
    )
    p.add_argument("--reuse-port", action="store_true",
                   help=argparse.SUPPRESS)
    _store_url_args(p)
    p.set_defaults(func=cmd_deploy)

    p = sub.add_parser("undeploy")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.set_defaults(func=cmd_undeploy)

    p = sub.add_parser("trainer")
    _engine_args(p)
    p.add_argument(
        "--app", dest="app_name", required=True,
        help="app whose event watermark drives the training triggers",
    )
    p.add_argument("--channel", default="")
    p.add_argument(
        "--poll-interval", dest="poll_interval", type=float, default=10.0,
        help="seconds between watermark polls",
    )
    p.add_argument(
        "--min-new-events", dest="min_new_events", type=int, default=1,
        help="fold-in new users/items once this many events arrived "
             "since the last published generation (0 = disable fold-in)",
    )
    p.add_argument(
        "--full-every-events", dest="full_every_events", type=int,
        default=0,
        help="full retrain once this many events accumulated since the "
             "last full train (0 = never by count)",
    )
    p.add_argument(
        "--full-every-s", dest="full_every_s", type=float, default=0.0,
        help="full retrain at least this often in seconds "
             "(0 = never by time)",
    )
    _checkpoint_args(p)
    p.add_argument(
        "--router-url", dest="router_url", default="",
        help="drive this router's POST /admin/swap after every "
             "published generation",
    )
    p.add_argument(
        "--router-key", dest="router_key", default="",
        help="X-PIO-Server-Key for the router's /admin/* routes",
    )
    p.add_argument(
        "--promote-timeout", dest="promote_timeout", type=float,
        default=600.0,
        help="seconds to wait for one fleet promotion before giving up "
             "polling",
    )
    p.add_argument(
        "--metrics-port", dest="metrics_port", type=int, default=0,
        help="serve /metrics + /metrics.json + /healthz on this port "
             "(0 = no metrics server)",
    )
    p.add_argument(
        "--once", action="store_true",
        help="run one watermark poll (train if triggered) and exit",
    )
    p.add_argument(
        "--no-supervise", dest="no_supervise", action="store_true",
        help="run the training loop directly instead of supervising a "
             "respawned child (the child mode of the supervisor)",
    )
    _store_url_args(p)
    p.set_defaults(func=cmd_trainer)

    p = sub.add_parser("eventserver")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7070)
    p.add_argument("--stats", action="store_true")
    p.add_argument(
        "--no-admission", dest="no_admission", action="store_true",
        help="disable the adaptive overload controller — equivalent to "
             "PIO_ADMISSION=0",
    )
    p.add_argument(
        "--workers", type=int, default=1,
        help="SO_REUSEPORT worker processes sharing the port",
    )
    p.add_argument("--reuse-port", action="store_true",
                   help=argparse.SUPPRESS)
    _store_url_args(p)
    p.set_defaults(func=cmd_eventserver)

    p = sub.add_parser("router")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8100)
    p.add_argument(
        "--replica", action="append", default=[],
        help="replica base URL, optionally 'url#generation'; repeat "
             "per replica (more can be registered live via "
             "POST /admin/replicas)",
    )
    p.add_argument(
        "--probe-interval", dest="probe_interval", type=float,
        default=0.5, help="seconds between replica health probes",
    )
    p.add_argument(
        "--failover-retries", dest="failover_retries", type=int,
        default=1,
        help="retries against a DIFFERENT replica after a transport "
             "error or 5xx (inside the request's deadline budget)",
    )
    p.add_argument(
        "--proxy-timeout", dest="proxy_timeout", type=float,
        default=30.0, help="per-attempt upstream timeout in seconds",
    )
    p.add_argument(
        "--admin-key", dest="admin_key", default="",
        help="require this key on /admin/* (register/retire/swap)",
    )
    p.add_argument(
        "--state-file", dest="state_file", default="",
        help="persist the replica set + in-flight swap state here "
             "(atomic write + checksum); re-adopted on restart so a "
             "router killed mid-swap resumes or safely aborts",
    )
    p.add_argument(
        "--state-max-age", dest="state_max_age", type=float,
        default=300.0,
        help="discard (loudly) a state file older than this many "
             "seconds instead of trusting a stale fleet picture",
    )
    p.add_argument(
        "--fleet-gate", dest="fleet_gate", action="store_true",
        help="gate every swap behind fleet-level shadow scoring: "
             "mirror sampled live traffic to the staged replica, "
             "promote only on a clean divergence/NaN gate, watch for "
             "post-promotion regressions and roll the fleet back "
             "(PIO_CANARY_* tunes the gate)",
    )
    p.add_argument(
        "--spawn-replica", dest="spawn_replica", default="",
        help="replica launch command template with {port} and "
             "{generation} placeholders; enables the autoscaler and "
             "lets trainer-driven swaps stage candidates without a "
             "url (e.g. 'pio-tpu-torch deploy --variant e.json --port "
             "{port}')",
    )
    p.add_argument(
        "--min-replicas", dest="min_replicas", type=int, default=0,
        help="autoscaler floor (default PIO_AUTOSCALE_MIN or 1)",
    )
    p.add_argument(
        "--max-replicas", dest="max_replicas", type=int, default=0,
        help="autoscaler ceiling (default PIO_AUTOSCALE_MAX or 4)",
    )
    p.set_defaults(func=cmd_router)

    p = sub.add_parser("dashboard")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9000)
    p.set_defaults(func=cmd_dashboard)

    p = sub.add_parser("adminserver")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7071)
    p.set_defaults(func=cmd_adminserver)

    p = sub.add_parser("export")
    p.add_argument("--appname", dest="app_name", required=True)
    p.add_argument("--channel")
    p.add_argument("--output", required=True)
    p.add_argument(
        "--format", choices=["json", "npz"], default="",
        help="default: by extension (.npz = columnar, else JSON lines)",
    )
    p.set_defaults(func=cmd_export)

    p = sub.add_parser("import")
    p.add_argument("--appname", dest="app_name", required=True)
    p.add_argument("--channel")
    p.add_argument("--input", required=True)
    p.add_argument(
        "--format", choices=["json", "npz"], default="",
        help="default: by extension (.npz = columnar, else JSON lines)",
    )
    p.set_defaults(func=cmd_import)

    p = sub.add_parser("template")
    tp = p.add_subparsers(dest="template_command", required=True)
    tp.add_parser("list")
    tg = tp.add_parser("get")
    tg.add_argument(
        "template",
        help="bundled template name, local path, or git URL "
             "(https://…, git@…, file://…, anything ending .git)",
    )
    tg.add_argument("directory", help="destination project directory")
    tg.add_argument("--engine-id", dest="engine_id")
    tg.add_argument(
        "--ref", default="",
        help="branch or tag to fetch (git sources only)",
    )
    tg.add_argument(
        "--subdir", default="",
        help="template subdirectory inside the fetched repository",
    )
    p.set_defaults(func=cmd_template)

    p = sub.add_parser("run")
    p.add_argument("target", help="module:function receiving a ComputeContext")
    p.add_argument("--batch", default="run")
    p.add_argument("--mesh-shape", dest="mesh_shape")
    _device_arg(p)
    p.set_defaults(func=cmd_run)

    p = sub.add_parser("minipg")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=5432)
    p.add_argument("--path", default="")
    p.add_argument("--password", default=None)
    p.set_defaults(func=cmd_minipg)

    p = sub.add_parser("storeserver")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7072)
    p.add_argument(
        "--access-key", dest="access_key", default="",
        help="require this key on every request (Bearer/accessKey)",
    )
    p.add_argument(
        "--peer", dest="peers", action="append", default=None,
        help="replica-set sibling base URL (repeat once per peer): "
             "turns on the background anti-entropy loop that pulls "
             "missed events/models/metadata from the named peers",
    )
    p.add_argument(
        "--role", default="replica", choices=("primary", "replica"),
        help="reported in /healthz and `status --store-url` "
             "(informational; every node accepts writes)",
    )
    p.set_defaults(func=cmd_storeserver)

    p = sub.add_parser("start-all")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--eventserver-port", type=int, default=0)
    p.add_argument("--dashboard-port", type=int, default=0)
    p.add_argument("--adminserver-port", type=int, default=0)
    p.add_argument("--with-minipg", action="store_true")
    p.add_argument("--minipg-port", type=int, default=0)
    p.add_argument("--with-storeserver", action="store_true")
    p.add_argument("--storeserver-port", type=int, default=0)
    p.add_argument(
        "--storeserver-access-key", dest="storeserver_access_key",
        default="",
        help="require this key on every store-server request",
    )
    p.set_defaults(func=cmd_start_all)

    sub.add_parser("stop-all").set_defaults(func=cmd_stop_all)
    sub.add_parser("daemons").set_defaults(func=cmd_daemons)

    p = sub.add_parser("daemon")
    p.add_argument("--name", default="")
    p.add_argument(
        "cmd", nargs=argparse.REMAINDER,
        help="console verb + args to daemonize (after --)",
    )
    p.set_defaults(func=cmd_daemon)

    for verb, (what, item) in _REFUSED_VERBS.items():
        sub.add_parser(verb, help=f"not ported ({_ITEM[item]})").set_defaults(
            func=lambda _args, what=what, item=item: _refuse(what, item),
            any_args=True,
        )

    return parser


def main(argv: list[str] | None = None) -> int:
    import logging

    from predictionio_tpu_torch.cli.commands import CommandError

    level = os.environ.get("PIO_LOG_LEVEL", "INFO").upper()
    if not isinstance(logging.getLevelName(level), int):
        level = "INFO"
    logging.basicConfig(
        level=level,
        format="[%(levelname)s] [%(name)s] %(message)s",
    )
    parser = build_parser()
    # a refused verb takes whatever its JAX counterpart takes
    args, extra = parser.parse_known_args(argv)
    if extra and not getattr(args, "any_args", False):
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    # the argv actually parsed — NOT sys.argv, which belongs to the host
    # process when main() is called programmatically; the trainer's
    # child command line is rebuilt from this
    args.raw_argv = list(argv) if argv is not None else sys.argv[1:]
    try:
        return args.func(args)
    except CommandError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except Exception as e:
        # the device module (and torch) is imported only once an error
        # needs classifying, so pure-HTTP verbs never load torch
        from predictionio_tpu_torch.parallel.mesh import NoDeviceError

        if isinstance(e, NoDeviceError):
            print(f"error: {e}", file=sys.stderr)
            return 1
        raise


if __name__ == "__main__":
    sys.exit(main())
