"""Telemetry hygiene: spans closed on all paths, metric names
registered with one consistent (kind, label-set) project-wide.

``span-leak``: a span context manager (``tracer.trace(...)``,
``tracer.child(...)``, ``tracing.span(...)``) or raw ``tracing.Span``
construction must reach a ``with`` statement — directly, via a variable
later used as a ``with`` context expression in the same function (the
``span_cm = ... ; with span_cm:`` pattern), or by being returned to the
caller. Anything else can leak an open span on an exception path, which
pins the trace in the recorder's open table until eviction.

``metric-labels``: ``registry.counter/gauge/histogram(name, ...)``
sites are collected project-wide; a metric name registered with two
different label tuples (or two different kinds) would raise at runtime
*only if* both sites ever run in one process — the lint catches the
conflict statically.
"""

from __future__ import annotations

import ast
from collections import defaultdict

from predictionio_tpu_torch.analysis import astutil
from predictionio_tpu_torch.analysis.model import Finding
from predictionio_tpu_torch.analysis.source import SourceModule

_METRIC_KINDS = {"counter", "gauge", "histogram"}


# -- span-leak -------------------------------------------------------------

def _span_call_desc(call: ast.Call) -> str | None:
    func = call.func
    dotted = astutil.dotted_name(func)
    if dotted == "tracing.span":
        return "tracing.span(...)"
    if dotted == "tracing.Span":
        return "tracing.Span(...)"
    if isinstance(func, ast.Attribute):
        recv = astutil.dotted_name(func.value) or ""
        if func.attr in ("trace", "child") and "tracer" in recv.lower():
            return f"{recv}.{func.attr}(...)"
    return None


def _reaches_with(call: ast.Call, fn: ast.AST | None) -> bool:
    """The call result is used as a context manager or returned."""
    node: ast.AST = call
    parent = astutil.parent_of(node)
    while parent is not None:
        if isinstance(parent, ast.withitem):
            return _contains(parent.context_expr, call)
        if isinstance(parent, (ast.With, ast.AsyncWith)):
            for item in parent.items:
                if _contains(item.context_expr, call):
                    return True
            return False  # inside a with *body* doesn't count
        if isinstance(parent, ast.Return):
            return True  # factory pattern: caller owns the lifecycle
        if isinstance(parent, ast.Assign):
            names = [
                t.id for t in parent.targets if isinstance(t, ast.Name)
            ]
            return any(
                _name_used_in_with(fn, name) for name in names
            )
        if isinstance(parent, (ast.IfExp, ast.BoolOp)):
            node, parent = parent, astutil.parent_of(parent)
            continue
        return False
    return False


def _contains(root: ast.AST, needle: ast.AST) -> bool:
    return any(n is needle for n in ast.walk(root))


def _name_used_in_with(fn: ast.AST | None, name: str) -> bool:
    if fn is None:
        return False
    for node in ast.walk(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                for sub in ast.walk(item.context_expr):
                    if isinstance(sub, ast.Name) and sub.id == name:
                        return True
    return False


# -- metric labels ---------------------------------------------------------

def _metric_site(call: ast.Call):
    """(kind, name, labels-or-None) for registry.counter/gauge/histogram
    calls with a literal metric name; labels None when dynamic."""
    func = call.func
    if not (
        isinstance(func, ast.Attribute) and func.attr in _METRIC_KINDS
    ):
        return None
    recv = (astutil.dotted_name(func.value) or "").lower()
    if "registry" not in recv and "metrics" not in recv:
        return None
    if not call.args or not (
        isinstance(call.args[0], ast.Constant)
        and isinstance(call.args[0].value, str)
    ):
        return None
    name = call.args[0].value
    labels_node = None
    if len(call.args) >= 3:
        labels_node = call.args[2]
    for kw in call.keywords:
        if kw.arg == "label_names":
            labels_node = kw.value
    if labels_node is None:
        labels: tuple | None = ()
    elif isinstance(labels_node, (ast.Tuple, ast.List)) and all(
        isinstance(e, ast.Constant) for e in labels_node.elts
    ):
        labels = tuple(e.value for e in labels_node.elts)
    else:
        labels = None  # dynamic — can't check
    return func.attr, name, labels


def check(modules: list[SourceModule]) -> list[Finding]:
    findings: list[Finding] = []
    #: metric name -> list of (kind, labels, mod, line, ctx)
    metric_sites: dict[str, list] = defaultdict(list)

    for mod in modules:
        if mod.rel_path.startswith("predictionio_tpu/obs/"):
            in_obs = True  # the tracing/registry layer itself is exempt
        else:
            in_obs = False
        index = mod.index()
        for node in mod.nodes():
            if not isinstance(node, ast.Call):
                continue
            site = _metric_site(node)
            if site is not None:
                kind, name, labels = site
                metric_sites[name].append(
                    (kind, labels, mod, node.lineno,
                     index.context_of(node))
                )
            if in_obs:
                continue
            desc = _span_call_desc(node)
            if desc is None:
                continue
            ctx = index.context_of(node)
            fn = index.funcs.get(ctx)
            if _reaches_with(node, fn):
                continue
            findings.append(
                Finding(
                    rule="span-leak",
                    path=mod.rel_path,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        f"{desc} is not used as a context manager — "
                        "the span may never close"
                    ),
                    context=ctx,
                    source=mod.source_line(node.lineno),
                )
            )

    for name, sites in metric_sites.items():
        kinds = {kind for kind, _l, _m, _n, _c in sites}
        label_sets = {
            labels for _k, labels, _m, _n, _c in sites
            if labels is not None
        }
        if len(kinds) <= 1 and len(label_sets) <= 1:
            continue
        detail = "; ".join(
            f"{m.rel_path}:{line} {kind}{list(labels) if labels is not None else '<dynamic>'}"
            for kind, labels, m, line, _c in sites
        )
        for kind, labels, mod, line, ctx in sites:
            findings.append(
                Finding(
                    rule="metric-labels",
                    path=mod.rel_path,
                    line=line,
                    col=0,
                    message=(
                        f"metric {name!r} registered inconsistently "
                        f"({detail})"
                    ),
                    context=ctx,
                    source=mod.source_line(line),
                )
            )
    return findings
