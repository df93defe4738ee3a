"""Fleet metrics federation: merge per-replica ``/metrics.json``
payloads into one scrape surface.

Counterpart of ``predictionio_tpu/obs/federation.py``, copied: the same
merges and renderings, so one fleet scrape reads alike from either
package's router (``tests/test_torch_federation.py``).

The serving router scrapes every replica's ``/metrics.json`` and
re-exposes the whole fleet from its own ``/metrics`` — one scrape sees
every replica (each series labeled ``replica=<id>``) plus an exactly
merged fleet view:

* **counters** merge by sum — cumulative totals add across processes;
* **histograms** merge by bucket-wise sum over the raw per-bucket
  counts the registry snapshot carries (including the explicit
  ``+Inf`` overflow bucket), so fleet percentiles are re-derived from
  the merged distribution, never averaged from per-replica
  percentiles (averaging percentiles is the classic federation bug
  this module exists to avoid);
* **gauges** are NOT merged — a sum of ``pio_model_generation`` means
  nothing. They stay visible per replica (``replica`` label) and the
  router exports its own fleet-level gauges (``pio_fleet_*``,
  ``pio_slo_*``) beside them.

Stdlib-only, like the rest of ``obs/`` — the router imports this, not
the other way around.
"""

from __future__ import annotations

import math

from predictionio_tpu_torch.obs.registry import _fmt, _nan_none, _quantile

#: label the router injects into every federated replica series
REPLICA_LABEL = "replica"


def _finite_bounds(samples: list[dict]) -> tuple[float, ...]:
    bounds: set[float] = set()
    for sample in samples:
        for key in (sample.get("buckets") or {}):
            if key != "+Inf":
                try:
                    bounds.add(float(key))
                except ValueError:
                    continue
    return tuple(sorted(bounds))


def merge_histogram_samples(samples: list[dict]) -> dict:
    """Bucket-wise sum of registry histogram snapshots (same labels,
    different replicas); percentiles re-derived from the merged
    buckets. Pre-``+Inf`` snapshots degrade gracefully: the overflow
    count is reconstructed as ``count - sum(finite buckets)``."""
    bounds = _finite_bounds(samples)
    counts = [0] * (len(bounds) + 1)
    total = 0
    total_sum = 0.0
    for sample in samples:
        buckets = sample.get("buckets") or {}
        finite = 0
        for i, bound in enumerate(bounds):
            c = int(buckets.get(_fmt(bound), 0) or 0)
            counts[i] += c
            finite += c
        count = int(sample.get("count", 0) or 0)
        overflow = buckets.get("+Inf")
        if overflow is None:
            overflow = max(0, count - finite)
        counts[-1] += int(overflow)
        total += count
        total_sum += float(sample.get("sum", 0.0) or 0.0)
    merged = {_fmt(b): c for b, c in zip(bounds, counts)}
    merged["+Inf"] = counts[-1]
    return {
        "count": total,
        "sum": round(total_sum, 6),
        "buckets": merged,
        "p50": _nan_none(_quantile(bounds, counts, total, 0.50)),
        "p95": _nan_none(_quantile(bounds, counts, total, 0.95)),
        "p99": _nan_none(_quantile(bounds, counts, total, 0.99)),
    }


def _label_key(sample: dict) -> tuple:
    return tuple(sorted((sample.get("labels") or {}).items()))


def merge_payloads(payloads: dict[str, dict]) -> dict:
    """Merge per-replica ``/metrics.json`` payloads into one fleet
    view: counters summed and histograms bucket-wise summed per
    label set; gauges (and unknown kinds) dropped — see module doc."""
    families: dict[str, dict] = {}
    for rid in sorted(payloads):
        payload = payloads[rid]
        if not isinstance(payload, dict):
            continue
        for name, family in payload.items():
            if not isinstance(family, dict):
                continue
            kind = family.get("type")
            if kind not in ("counter", "histogram"):
                continue
            fam = families.setdefault(
                name,
                {
                    "type": kind,
                    "help": family.get("help", ""),
                    "groups": {},
                },
            )
            if fam["type"] != kind:
                continue  # conflicting registrations: first one wins
            for sample in family.get("samples", ()):
                if not isinstance(sample, dict):
                    continue
                fam["groups"].setdefault(_label_key(sample), []).append(
                    sample
                )
    out: dict[str, dict] = {}
    for name in sorted(families):
        fam = families[name]
        samples = []
        for key in sorted(fam["groups"]):
            group = fam["groups"][key]
            labels = dict(key)
            if fam["type"] == "histogram":
                samples.append(
                    {"labels": labels, **merge_histogram_samples(group)}
                )
            else:
                samples.append(
                    {
                        "labels": labels,
                        "value": sum(
                            float(s.get("value") or 0.0) for s in group
                        ),
                    }
                )
        out[name] = {
            "type": fam["type"],
            "help": fam["help"],
            "samples": samples,
        }
    return out


def combine_families(
    local: dict, payloads: dict[str, dict]
) -> dict:
    """Family-union of the router's own registry dict and every
    replica payload, each replica sample gaining a ``replica`` label —
    the per-series federated view (no merging, no double counting)."""
    combined: dict[str, dict] = {}
    for name, family in local.items():
        combined[name] = {
            "type": family.get("type"),
            "help": family.get("help", ""),
            "samples": list(family.get("samples", ())),
        }
    for rid in sorted(payloads):
        payload = payloads[rid]
        if not isinstance(payload, dict):
            continue
        for name, family in payload.items():
            if not isinstance(family, dict):
                continue
            fam = combined.setdefault(
                name,
                {
                    "type": family.get("type"),
                    "help": family.get("help", ""),
                    "samples": [],
                },
            )
            for sample in family.get("samples", ()):
                if not isinstance(sample, dict):
                    continue
                fam["samples"].append(
                    {
                        **sample,
                        "labels": {
                            **(sample.get("labels") or {}),
                            REPLICA_LABEL: rid,
                        },
                    }
                )
    return combined


def _render_labels(labels: dict) -> str:
    if not labels:
        return ""
    pairs = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + pairs + "}"


def _escape(value: str) -> str:
    return (
        value.replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _render_value(value) -> str:
    if value is None:
        return "NaN"
    v = float(value)
    if math.isnan(v):
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v.is_integer():
        return str(int(v))
    return repr(v)


def render_prometheus_families(families: dict) -> str:
    """Prometheus text exposition 0.0.4 over the JSON family shape —
    the federated equivalent of ``MetricRegistry.render_prometheus``
    (one HELP/TYPE per family even when samples come from many
    replicas, cumulative ``_bucket`` series rebuilt from raw bucket
    counts)."""
    lines: list[str] = []
    for name in sorted(families):
        family = families[name]
        kind = family.get("type") or "untyped"
        lines.append(f"# HELP {name} {family.get('help', '')}")
        lines.append(f"# TYPE {name} {kind}")
        for sample in family.get("samples", ()):
            labels = dict(sample.get("labels") or {})
            if kind == "histogram":
                buckets = sample.get("buckets") or {}
                bounds = _finite_bounds([sample])
                cumulative = 0
                for bound in bounds:
                    cumulative += int(buckets.get(_fmt(bound), 0) or 0)
                    le = _render_labels({**labels, "le": _fmt(bound)})
                    lines.append(f"{name}_bucket{le} {cumulative}")
                count = int(sample.get("count", 0) or 0)
                le = _render_labels({**labels, "le": "+Inf"})
                lines.append(f"{name}_bucket{le} {count}")
                label_str = _render_labels(labels)
                lines.append(
                    f"{name}_sum{label_str} "
                    f"{_render_value(sample.get('sum', 0.0))}"
                )
                lines.append(f"{name}_count{label_str} {count}")
            else:
                label_str = _render_labels(labels)
                lines.append(
                    f"{name}{label_str} "
                    f"{_render_value(sample.get('value'))}"
                )
    return "\n".join(lines) + "\n"


def counter_total(families: dict, name: str, **labels) -> float:
    """Sum a counter family's samples across every label set matching
    ``labels`` — the federation consumer's rollup read (fleet goodput,
    fleet SLO ingestion)."""
    total = 0.0
    family = families.get(name)
    if not isinstance(family, dict):
        return total
    for sample in family.get("samples", ()):
        sample_labels = sample.get("labels") or {}
        if all(sample_labels.get(k) == v for k, v in labels.items()):
            try:
                total += float(sample.get("value") or 0.0)
            except (TypeError, ValueError):
                continue
    return total
