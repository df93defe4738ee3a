"""Monotonic-clock discipline: ``time.time()`` is banned in
deadline/retry/backoff/uptime/elapsed code paths.

Wall clock is fine for *display* timestamps (log lines, Prometheus
``process_start_time_seconds``), but any value that feeds duration
arithmetic must come from ``time.monotonic()`` (or a
``serving.resilience.Deadline``): ``time.time()`` jumps backwards and
forwards under NTP steps, which has corrupted backoff and uptime logic
in this codebase before (see docs/static_analysis.md).

A ``time.time()`` call is flagged when any of:

* it participates in arithmetic (``+``/``-``) or a comparison — the
  canonical elapsed/deadline pattern;
* it is assigned to a name that smells like a duration anchor
  (``*start_time*``, ``*deadline*``, ``*_t0*``, ``*uptime*``, ...);
* the enclosing function's name names one of those code paths.

Display-only uses (e.g. a log-record ``ts`` field) don't match and are
not flagged; deliberate exemptions carry a suppression comment with the
reason (``# pio-lint: disable=wall-clock -- <why>``).
"""

from __future__ import annotations

import ast
import re

from predictionio_tpu_torch.analysis import astutil
from predictionio_tpu_torch.analysis.model import Finding
from predictionio_tpu_torch.analysis.source import SourceModule

_ANCHOR_NAME = re.compile(
    r"(start_?time|deadline|uptime|elapsed|backoff|retry|expir|"
    r"timeout|(^|_)t0$)",
    re.IGNORECASE,
)
_PATH_FUNC = re.compile(
    r"(deadline|retry|backoff|uptime|elapsed|expir)", re.IGNORECASE
)


def _is_time_time(call: ast.Call) -> bool:
    return astutil.dotted_name(call.func) in ("time.time",)

#: each module's findings depend only on that module's text --
#: cacheable per file (see analysis/cache.py)
PER_FILE = True


def check(modules: list[SourceModule]) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        index = mod.index()
        for node in mod.nodes():
            if not (isinstance(node, ast.Call) and _is_time_time(node)):
                continue
            reason = _why_flagged(node, index)
            if reason is None:
                continue
            ctx = index.context_of(node)
            findings.append(
                Finding(
                    rule="wall-clock",
                    path=mod.rel_path,
                    line=node.lineno,
                    col=node.col_offset,
                    message=f"time.time() {reason}",
                    context=ctx,
                    source=mod.source_line(node.lineno),
                )
            )
    return findings


def _why_flagged(
    call: ast.Call, index: astutil.FunctionIndex
) -> str | None:
    # 1) arithmetic / comparison participation
    node: ast.AST = call
    parent = astutil.parent_of(node)
    while parent is not None and isinstance(
        parent, (ast.BinOp, ast.Compare, ast.UnaryOp)
    ):
        if isinstance(parent, ast.Compare):
            return "used in a comparison (deadline check)"
        if isinstance(parent, ast.BinOp) and isinstance(
            parent.op, (ast.Add, ast.Sub)
        ):
            return "used in duration arithmetic"
        node, parent = parent, astutil.parent_of(parent)

    # 2) assignment to a duration-anchor name
    target_name = _assign_target_name(call)
    if target_name and _ANCHOR_NAME.search(target_name):
        return (
            f"assigned to duration anchor {target_name!r}"
        )

    # 3) enclosing function names a deadline/retry/backoff/uptime path
    ctx = index.context_of(call)
    func_name = ctx.rsplit(".", 1)[-1] if ctx else ""
    if func_name and _PATH_FUNC.search(func_name):
        return f"inside {func_name}(), a monotonic-clock code path"
    return None


def _assign_target_name(call: ast.Call) -> str | None:
    node: ast.AST = call
    parent = astutil.parent_of(node)
    # walk through trivial wrappers: round(time.time()), t = x or ...
    while parent is not None and isinstance(
        parent, (ast.Call, ast.BoolOp, ast.IfExp)
    ):
        node, parent = parent, astutil.parent_of(parent)
    if isinstance(parent, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        targets = (
            parent.targets
            if isinstance(parent, ast.Assign)
            else [parent.target]
        )
        for t in targets:
            if isinstance(t, ast.Name):
                return t.id
            if isinstance(t, ast.Attribute):
                return t.attr
    return None
