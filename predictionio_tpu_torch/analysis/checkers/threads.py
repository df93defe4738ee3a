"""Thread-lifecycle discipline: every ``threading.Thread`` must either
be daemonized (``daemon=True`` at construction — with the shutdown
contract documented at the site) or joined somewhere reachable from
``close()``/``stop()``-style teardown.

A non-daemon thread that is never joined keeps the process alive after
``close()`` and leaks across server generations; PR 3/PR 4 reviews
caught this class by hand in the batcher and router teardown paths.

Heuristic: a thread constructed and bound to ``self._x`` is satisfied
by any ``self._x.join(...)`` in the same class; a local ``t = Thread``
by a ``t.join(...)`` in the same function. An unbound
``threading.Thread(...).start()`` without ``daemon=True`` is always
flagged.

Repaired against the JAX package's checker: a bound thread whose
``daemon`` attribute is set to ``True`` after construction (``t =
threading.Timer(s, fn); t.daemon = True`` — the only way to daemonize a
``Timer``, whose constructor takes no ``daemon``) counts as daemonized,
on the same scoping as a join. The reference flags that form.
"""

from __future__ import annotations

import ast

from predictionio_tpu_torch.analysis import astutil
from predictionio_tpu_torch.analysis.model import Finding
from predictionio_tpu_torch.analysis.source import SourceModule

_THREAD_CTORS = {"threading.Thread", "Thread", "threading.Timer", "Timer"}


def _daemon_kwarg(call: ast.Call) -> bool | None:
    """True/False for an explicit constant daemon=..., None if absent
    or dynamic."""
    for kw in call.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return None


def _receiver(expr: ast.expr) -> tuple[str, str] | None:
    if isinstance(expr, ast.Attribute) and isinstance(
        expr.value, ast.Name
    ) and expr.value.id in ("self", "cls"):
        return ("self", expr.attr)
    if isinstance(expr, ast.Name):
        return ("", expr.id)
    return None


def _join_targets(nodes) -> set[tuple[str, str]]:
    """('self', '_x') / ('', 'name') receivers of ``.join(...)`` calls
    and of ``.daemon = True`` stores among ``nodes``."""
    out: set[tuple[str, str]] = set()
    for node in nodes:
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "join"
        ):
            recvs = [node.func.value]
        elif (
            isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Constant)
            and node.value.value is True
        ):
            recvs = [
                t.value for t in node.targets
                if isinstance(t, ast.Attribute) and t.attr == "daemon"
            ]
        else:
            continue
        for recv in recvs:
            target = _receiver(recv)
            if target is not None:
                out.add(target)
    return out

#: each module's findings depend only on that module's text --
#: cacheable per file (see analysis/cache.py)
PER_FILE = True


def check(modules: list[SourceModule]) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        index = mod.index()
        #: class qualname -> join receivers anywhere in the class
        class_joins: dict[str, set[tuple[str, str]]] = {}
        for node in mod.nodes():
            if isinstance(node, ast.ClassDef):
                qual = _class_qual(node, index)
                class_joins[qual] = _join_targets(ast.walk(node))
        module_joins = _join_targets(mod.nodes())

        for node in mod.nodes():
            if not (
                isinstance(node, ast.Call)
                and astutil.dotted_name(node.func) in _THREAD_CTORS
            ):
                continue
            daemon = _daemon_kwarg(node)
            if daemon is True:
                continue
            ctx = index.context_of(node)
            target = _bound_target(node)
            joined = False
            if target is not None:
                kind, name = target
                if kind == "self":
                    owner = index.owner_class.get(ctx, "")
                    joined = ("self", name) in class_joins.get(
                        owner, set()
                    )
                else:
                    fn = index.funcs.get(ctx)
                    scope_joins = (
                        _join_targets(ast.walk(fn)) if fn is not None
                        else module_joins
                    )
                    joined = ("", name) in scope_joins
            if joined:
                continue
            what = (
                "thread is neither daemon=True nor joined"
                if target is not None
                else "unbound thread can never be joined and is not "
                     "daemon=True"
            )
            findings.append(
                Finding(
                    rule="thread-lifecycle",
                    path=mod.rel_path,
                    line=node.lineno,
                    col=node.col_offset,
                    message=what,
                    context=ctx,
                    source=mod.source_line(node.lineno),
                )
            )
    return findings


def _class_qual(node: ast.ClassDef, index: astutil.FunctionIndex) -> str:
    # class qualnames in FunctionIndex.class_methods are dotted; for
    # top-level classes (the norm here) the bare name matches
    for qual in index.class_methods:
        if qual == node.name or qual.endswith("." + node.name):
            return qual
    return node.name


def _bound_target(call: ast.Call) -> tuple[str, str] | None:
    """('self', '_x') / ('', 't') when the Thread(...) result is bound,
    walking through trivial wrapping expressions."""
    node: ast.AST = call
    parent = astutil.parent_of(node)
    while parent is not None and isinstance(
        parent, (ast.IfExp, ast.BoolOp)
    ):
        node, parent = parent, astutil.parent_of(parent)
    if isinstance(parent, ast.Assign):
        for t in parent.targets:
            if isinstance(t, ast.Attribute) and isinstance(
                t.value, ast.Name
            ) and t.value.id in ("self", "cls"):
                return ("self", t.attr)
            if isinstance(t, ast.Name):
                return ("", t.id)
    if isinstance(parent, ast.AnnAssign):
        t = parent.target
        if isinstance(t, ast.Attribute) and isinstance(
            t.value, ast.Name
        ) and t.value.id in ("self", "cls"):
            return ("self", t.attr)
        if isinstance(t, ast.Name):
            return ("", t.id)
    return None
