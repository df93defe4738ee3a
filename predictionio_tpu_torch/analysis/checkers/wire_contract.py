"""Wire-contract checker: the distributed stack's implicit protocols
— ``X-PIO-*`` headers, route strings, cross-process metric scrapes,
``PIO_*`` env knobs — verified producer-against-consumer project-wide
(docs/static_analysis.md "Wire-contract rules").

Cross-file by construction (a header set in ``client.py`` is consumed
in ``serving/http.py``; a metric registered in ``batching.py`` is
scraped by ``serving/router.py`` and the smoke scripts), so this
checker never participates in the per-file findings cache.

Four sub-contracts, one rule id each:

* ``wire-header`` — every contract header must have at least one
  producer and one consumer somewhere in the linted tree, and every
  site must agree on one spelling (case/dash/underscore near-misses
  are exactly how the PR 3 "header read that no hop ever sent" class
  of bug is born);
* ``wire-route`` — every client/smoke-script request path must match
  a registered route pattern (``<seg>`` and dynamic f-string chunks
  match any one segment);
* ``wire-metric`` — every metric name scraped *by name* (router
  admission gating on a replica's ``pio_warmup_complete``, smoke
  scripts asserting counters) must be registered somewhere;
* ``wire-env`` — every ``PIO_*`` env var read by the framework or its
  scripts must appear in a docs env table (``docs/*.md``). Modules
  under ``tests/`` are exempt: test-only knobs are not operator
  surface.
"""

from __future__ import annotations

from collections import Counter

from predictionio_tpu_torch.analysis import wire
from predictionio_tpu_torch.analysis.model import Finding
from predictionio_tpu_torch.analysis.source import SourceModule


def _finding(rule: str, site: wire.Site, message: str,
             mod_by_path: dict[str, SourceModule]) -> Finding:
    mod = mod_by_path.get(site.path)
    return Finding(
        rule=rule,
        path=site.path,
        line=site.line,
        col=site.col,
        message=message,
        context=site.context,
        source=mod.source_line(site.line) if mod is not None else "",
    )


def _fmt_sites(sites: list[wire.Site], limit: int = 3) -> str:
    shown = ", ".join(
        f"{s.path}:{s.line}" for s in sites[:limit]
    )
    extra = len(sites) - limit
    return shown + (f" (+{extra} more)" if extra > 0 else "")


def check(modules: list[SourceModule]) -> list[Finding]:
    reg = wire.build_registry(modules)
    mod_by_path = {m.rel_path: m for m in modules}
    findings: list[Finding] = []

    # -- headers -----------------------------------------------------------
    for canon, sides in sorted(reg.header_canonical().items()):
        produced, consumed = sides["produced"], sides["consumed"]
        spellings = Counter(
            s.spelling for s in produced + consumed
        )
        if len(spellings) > 1:
            # near-miss: the majority spelling wins; every deviating
            # site is flagged (ties break toward the alphabetically
            # first so the report is deterministic — uppercase sorts
            # first, so a tie prefers the canonical X-PIO-* casing)
            majority, _n = min(
                spellings.items(), key=lambda kv: (-kv[1], kv[0])
            )
            for site in produced + consumed:
                if site.spelling != majority:
                    findings.append(_finding(
                        "wire-header", site,
                        f"header {site.spelling!r} is a near-miss of "
                        f"{majority!r} (the majority spelling) — one "
                        "side of the wire will never see the other's "
                        "value",
                        mod_by_path,
                    ))
            continue  # pairing against a misspelled side is noise
        if canon in wire.OPTIONAL_HEADERS:
            continue
        if consumed and not produced:
            site = consumed[0]
            findings.append(_finding(
                "wire-header", site,
                f"header {site.spelling!r} is read "
                f"(at {_fmt_sites(consumed)}) but no site in the "
                "linted tree ever sets it — the read can only ever "
                "see the default",
                mod_by_path,
            ))
        elif produced and not consumed:
            site = produced[0]
            findings.append(_finding(
                "wire-header", site,
                f"header {site.spelling!r} is set "
                f"(at {_fmt_sites(produced)}) but no site in the "
                "linted tree ever reads it — dead wire weight, or "
                "the reader spells it differently",
                mod_by_path,
            ))

    # -- routes ------------------------------------------------------------
    route_patterns = list(reg.routes)
    for path, sites in sorted(reg.request_paths.items()):
        if any(wire.route_matches(path, r) for r in route_patterns):
            continue
        display = path.replace(wire.WILDCARD, "{…}")
        findings.append(_finding(
            "wire-route", sites[0],
            f"request path {display!r} (requested at "
            f"{_fmt_sites(sites)}) matches no registered route — "
            "every request to it will 404",
            mod_by_path,
        ))

    # -- metrics -----------------------------------------------------------
    for name, sites in sorted(reg.metrics_scraped.items()):
        base = wire.strip_metric_suffix(name)
        if name in reg.metrics_registered or (
            base in reg.metrics_registered
        ):
            continue
        findings.append(_finding(
            "wire-metric", sites[0],
            f"metric {name!r} is scraped by name (at "
            f"{_fmt_sites(sites)}) but never registered — the scrape "
            "can only ever read absent",
            mod_by_path,
        ))

    # -- env ---------------------------------------------------------------
    for name, sites in sorted(reg.env_reads.items()):
        if name.endswith("_"):
            continue  # prefix family, composed dynamically
        operator_sites = [
            s for s in sites if not s.path.startswith("tests/")
        ]
        if not operator_sites:
            continue
        if wire.env_is_documented(name, reg.env_documented):
            continue
        findings.append(_finding(
            "wire-env", operator_sites[0],
            f"env var {name!r} is read (at "
            f"{_fmt_sites(operator_sites)}) but appears in no docs "
            "env table — operators cannot discover it",
            mod_by_path,
        ))

    return findings
