"""Resource-lifecycle checker: paired acquire/release discipline and
OS-resource cleanup on *all* paths, including exception paths
(docs/static_analysis.md "Resource-lifecycle rules").

Two rules:

``acquire-release`` — the serving stack's paired protocols must be
exception-safe:

* ``X.try_acquire(...)`` (the admission controller's slot protocol)
  must reach an ``X.release(...)`` in the same function or through a
  same-module callee, and at least one reachable release must sit in a
  ``finally`` block — an exception between admit and release otherwise
  leaks the slot forever (the limiter counts it in-flight until
  process death, exactly the PR 8 review class of bug);
* paired brackets that appear together in one function —
  ``X.begin()``/``X.end()``, ``X.begin_request()``/``X.end_request()``,
  and ``self._*inflight* += 1`` / ``-= 1`` — must put the closing half
  in a ``finally``. When only one half appears the pair is a
  cross-thread handoff (the pipeline semaphore acquired by the
  collector and released by the completer) and is NOT flagged: that
  discipline belongs to the race rules.

``resource-leak`` — ``open()``/``socket.socket()``/
``subprocess.Popen()``/``tempfile.TemporaryDirectory()`` (and friends)
must reach their cleanup (``close``/``terminate``/``cleanup``/...) on
every path: a ``with`` statement, a cleanup in a ``finally``, or
ownership escaping to the caller (returned, stored on ``self``/into a
container, passed to another component — whoever holds the object owns
the close). A cleanup that only sits on the fall-through path, with
calls in between that can raise, is flagged: that is the classic
``f = open(...); f.write(...); f.close()`` leak. Thread ``start()``
lifecycles are the existing ``thread-lifecycle`` rule's job and are
not re-checked here.
"""

from __future__ import annotations

import ast
import dataclasses

from predictionio_tpu_torch.analysis import astutil
from predictionio_tpu_torch.analysis.model import Finding
from predictionio_tpu_torch.analysis.source import SourceModule

#: each module's findings depend only on that module's text —
#: cacheable per file (see analysis/cache.py)
PER_FILE = True

#: creator call -> (human kind, cleanup method names)
_CREATORS: dict[str, tuple[str, frozenset[str]]] = {
    "open": ("file", frozenset({"close"})),
    "io.open": ("file", frozenset({"close"})),
    "os.fdopen": ("file", frozenset({"close"})),
    "gzip.open": ("file", frozenset({"close"})),
    "bz2.open": ("file", frozenset({"close"})),
    "lzma.open": ("file", frozenset({"close"})),
    "tarfile.open": ("archive", frozenset({"close"})),
    "zipfile.ZipFile": ("archive", frozenset({"close"})),
    "socket.socket": (
        "socket", frozenset({"close", "shutdown", "detach"})
    ),
    "socket.create_connection": (
        "socket", frozenset({"close", "shutdown", "detach"})
    ),
    "subprocess.Popen": (
        "process",
        frozenset({"terminate", "kill", "wait", "communicate"}),
    ),
    "tempfile.TemporaryDirectory": (
        "temporary directory", frozenset({"cleanup"})
    ),
    "tempfile.NamedTemporaryFile": ("file", frozenset({"close"})),
}

#: acquire leaf -> matching release leaf, for brackets that must pair
#: exception-safely when both halves appear in one function
_PAIRS = {
    "try_acquire": "release",
    "begin": "end",
    "begin_request": "end_request",
}

_TRY_TYPES = tuple(
    t for t in (ast.Try, getattr(ast, "TryStar", None)) if t is not None
)

_DEF_TYPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


@dataclasses.dataclass
class _CallSite:
    recv: str  # dotted receiver ("self._adm", "admission_ref")
    leaf: str  # method name
    node: ast.Call
    in_finally: bool


@dataclasses.dataclass
class _AugSite:
    target: str  # dotted target ("self._inflight")
    sign: str  # "+" or "-"
    node: ast.AugAssign
    in_finally: bool


@dataclasses.dataclass
class _CreateSite:
    node: ast.Call
    ctor: str
    kind: str
    cleanups: frozenset[str]


@dataclasses.dataclass
class _Scan:
    calls: list[_CallSite] = dataclasses.field(default_factory=list)
    augs: list[_AugSite] = dataclasses.field(default_factory=list)
    creators: list[_CreateSite] = dataclasses.field(default_factory=list)


def _scan_scope(body: list[ast.stmt]) -> _Scan:
    """Collect calls / augmented assigns / creator sites in one scope
    (a function body or the module body), tagging each with whether it
    executes inside a ``finally`` block, and never descending into
    nested function/class definitions (their own scopes)."""
    scan = _Scan()
    _scan_body(body, False, scan)
    return scan


def _scan_body(body: list, in_finally: bool, scan: _Scan) -> None:
    for stmt in body:
        if isinstance(stmt, _DEF_TYPES):
            continue
        if isinstance(stmt, _TRY_TYPES):
            _scan_body(stmt.body, in_finally, scan)
            for handler in stmt.handlers:
                _scan_body(handler.body, in_finally, scan)
            _scan_body(stmt.orelse, in_finally, scan)
            _scan_body(stmt.finalbody, True, scan)
            continue
        nested: list[ast.stmt] = []
        for field in ("body", "orelse"):
            nested.extend(getattr(stmt, field, ()) or ())
        for case in getattr(stmt, "cases", ()):  # ast.Match
            nested.extend(case.body)
        skip = set(map(id, nested))
        # seed with the statement node itself — it may BE the record
        # (AugAssign is the statement, not a child of one); the loop
        # expands children with the nested-body skip applied
        todo: list[ast.AST] = [stmt]
        while todo:
            cur = todo.pop()
            if isinstance(cur, _DEF_TYPES):
                continue
            _record(cur, in_finally, scan)
            todo.extend(
                c for c in ast.iter_child_nodes(cur) if id(c) not in skip
            )
        for sub in nested:
            _scan_body([sub], in_finally, scan)


def _record(node: ast.AST, in_finally: bool, scan: _Scan) -> None:
    if isinstance(node, ast.Call):
        dotted = astutil.dotted_name(node.func)
        if dotted in _CREATORS:
            kind, cleanups = _CREATORS[dotted]
            scan.creators.append(
                _CreateSite(
                    node=node, ctor=dotted, kind=kind, cleanups=cleanups
                )
            )
        if isinstance(node.func, ast.Attribute):
            recv = astutil.dotted_name(node.func.value)
            if recv:
                scan.calls.append(
                    _CallSite(
                        recv=recv,
                        leaf=node.func.attr,
                        node=node,
                        in_finally=in_finally,
                    )
                )
    elif isinstance(node, ast.AugAssign):
        target = astutil.dotted_name(node.target)
        if target and isinstance(node.op, (ast.Add, ast.Sub)):
            scan.augs.append(
                _AugSite(
                    target=target,
                    sign="+" if isinstance(node.op, ast.Add) else "-",
                    node=node,
                    in_finally=in_finally,
                )
            )


def _recv_leaf(recv: str) -> str:
    return recv.rsplit(".", 1)[-1]


# --------------------------------------------------------------------------
# acquire/release
# --------------------------------------------------------------------------


def _resolve_callee(call: ast.Call, ctx: str, index) -> str | None:
    func = call.func
    if isinstance(func, ast.Attribute) and isinstance(
        func.value, ast.Name
    ) and func.value.id in ("self", "cls"):
        owner = index.owner_class.get(ctx, "")
        if not owner:
            parts = ctx.split(".")
            for i in range(len(parts) - 1, 0, -1):
                owner = index.owner_class.get(".".join(parts[:i]), "")
                if owner:
                    break
        qual = f"{owner}.{func.attr}" if owner else func.attr
        return qual if qual in index.funcs else None
    if isinstance(func, ast.Name):
        for candidate in (f"{ctx}.{func.id}", func.id):
            if candidate in index.funcs:
                return candidate
    return None


def _release_summaries(
    scans: dict[str, _Scan], index
) -> dict[str, set[str]]:
    """{function qualname: receiver leafs it (transitively) releases}
    — a same-module fixpoint so ``finally: self._cleanup()`` counts
    when ``_cleanup`` does the actual ``release``."""
    releases: dict[str, set[str]] = {}
    callees: dict[str, set[str]] = {}
    for qual, scan in scans.items():
        releases[qual] = {
            _recv_leaf(c.recv)
            for c in scan.calls
            if c.leaf == "release"
        }
        callees[qual] = set()
        for c in scan.calls:
            resolved = _resolve_callee(c.node, qual, index)
            if resolved:
                callees[qual].add(resolved)
    changed = True
    while changed:
        changed = False
        for qual, outs in callees.items():
            for callee in outs:
                extra = releases.get(callee, set()) - releases[qual]
                if extra:
                    releases[qual] |= extra
                    changed = True
    return releases


def _check_acquire_release(
    mod: SourceModule,
    scans: dict[str, _Scan],
    index,
    findings: list[Finding],
) -> None:
    release_of = _release_summaries(scans, index)
    for qual, scan in scans.items():
        fn_leaf = qual.rsplit(".", 1)[-1] if qual else ""
        for site in scan.calls:
            if site.leaf != "try_acquire":
                continue
            if "acquire" in fn_leaf:
                # a delegating wrapper (def try_acquire: return
                # inner.try_acquire(...)) hands the obligation to ITS
                # caller
                continue
            leaf = _recv_leaf(site.recv)
            if any(
                leaf in release_of.get(nested, set())
                for nested in scans
                if nested.startswith(f"{qual}.")
            ):
                # the release lives in a nested function defined here
                # (a future done-callback, a closure handed to the
                # batcher): the obligation escapes into the callback —
                # its exception-safety is the callback runner's
                # contract, not this function's
                continue
            direct = [
                c for c in scan.calls
                if c.leaf == "release" and c.recv == site.recv
            ]
            via_callee = [
                c for c in scan.calls
                if leaf in release_of.get(
                    _resolve_callee(c.node, qual, index) or "", set()
                )
            ]
            if not direct and not via_callee:
                findings.append(_mk(
                    mod, "acquire-release", site.node, qual,
                    f"{site.recv}.try_acquire(...) is never paired "
                    "with a release on any path in this function or "
                    "its same-module callees — the slot leaks",
                ))
                continue
            if not any(c.in_finally for c in direct + via_callee):
                findings.append(_mk(
                    mod, "acquire-release", site.node, qual,
                    f"no {site.recv}.release(...) reachable from this "
                    "try_acquire sits in a finally block — an "
                    "exception between admit and release leaks the "
                    "slot",
                ))
        # paired brackets: both halves in one function
        for a_leaf, r_leaf in _PAIRS.items():
            if a_leaf == "try_acquire":
                continue  # handled above with callee propagation
            for site in scan.calls:
                if site.leaf != a_leaf:
                    continue
                closers = [
                    c for c in scan.calls
                    if c.leaf == r_leaf and c.recv == site.recv
                ]
                if closers and not any(c.in_finally for c in closers):
                    findings.append(_mk(
                        mod, "acquire-release", site.node, qual,
                        f"{site.recv}.{a_leaf}() is closed by "
                        f".{r_leaf}() on the fall-through path only — "
                        "put the closing call in a finally",
                    ))
        # inflight counters: += / -= on the same *inflight* field
        for aug in scan.augs:
            if aug.sign != "+" or "inflight" not in aug.target.lower():
                continue
            decs = [
                a for a in scan.augs
                if a.sign == "-" and a.target == aug.target
            ]
            if decs and not any(a.in_finally for a in decs):
                findings.append(_mk(
                    mod, "acquire-release", aug.node, qual,
                    f"{aug.target} += 1 is decremented on the "
                    "fall-through path only — an exception leaves the "
                    "gauge permanently high; decrement in a finally",
                ))


# --------------------------------------------------------------------------
# resource-leak
# --------------------------------------------------------------------------


def _in_with_or_return(node: ast.AST) -> bool:
    cur: ast.AST | None = node
    while cur is not None:
        parent = astutil.parent_of(cur)
        if isinstance(parent, ast.withitem):
            return True
        if isinstance(parent, (ast.Return, ast.Yield, ast.YieldFrom)):
            return True
        if isinstance(parent, ast.stmt):
            return False
        cur = parent
    return False


def _binding_of(call: ast.Call) -> tuple[str, ast.AST | None]:
    """How the creator's result is bound: ("name", Name) for a plain
    local, ("attr", Attribute) for ``self.x = ...``, ("transfer", None)
    when it is immediately handed to another expression (call argument,
    container element, subscript store — ownership moves), or
    ("discard", None) for a bare expression statement."""
    cur: ast.AST = call
    parent = astutil.parent_of(cur)
    while isinstance(parent, (ast.Await, ast.IfExp, ast.BoolOp)):
        cur, parent = parent, astutil.parent_of(parent)
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
        target = parent.targets[0]
        if isinstance(target, ast.Name):
            return "name", target
        if isinstance(target, ast.Attribute) and isinstance(
            target.value, ast.Name
        ) and target.value.id in ("self", "cls"):
            return "attr", target
        return "transfer", None  # subscript / tuple target: container
    if isinstance(parent, (ast.AnnAssign, ast.NamedExpr)):
        target = parent.target
        if isinstance(target, ast.Name):
            return "name", target
        return "transfer", None
    if isinstance(parent, ast.Expr):
        return "discard", None
    # call argument, dict/list element, comparison operand, ...:
    # the resource flows into another owner
    return "transfer", None


def _function_node_of(mod: SourceModule, qual: str):
    if not qual:
        return mod.tree
    return mod.index().funcs.get(qual, mod.tree)


def _name_escapes(scope: ast.AST, name: str, after_line: int) -> bool:
    """Does local ``name`` escape the scope after its binding —
    returned, yielded, stored into an attribute/subscript/container,
    passed as a call argument, or captured by a nested function?"""
    for node in ast.walk(scope):
        if node is scope:
            continue  # the scope's own def is not a capture of itself
        if getattr(node, "lineno", 0) < after_line and not isinstance(
            node, _DEF_TYPES
        ):
            continue
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            # only the object ITSELF escaping counts (`return f`, or a
            # tuple containing it, handled by the container branch):
            # `return td.name` returns a derived value and drops the
            # resource on the floor
            value = getattr(node, "value", None)
            if value is not None and _mentions_bare(value, name):
                return True
        elif isinstance(node, ast.Assign):
            if any(
                not isinstance(t, ast.Name) for t in node.targets
            ) and _mentions(node.value, name):
                return True
        elif isinstance(node, ast.Call):
            for arg in list(node.args) + [
                kw.value for kw in node.keywords
            ]:
                if _mentions_bare(arg, name):
                    return True
        elif isinstance(node, _DEF_TYPES[:2]):
            if any(
                isinstance(sub, ast.Name) and sub.id == name
                for sub in ast.walk(node)
            ):
                return True
        elif isinstance(node, ast.Lambda):
            if any(
                isinstance(sub, ast.Name) and sub.id == name
                for sub in ast.walk(node)
            ):
                return True
        elif isinstance(node, (ast.List, ast.Tuple, ast.Set, ast.Dict)):
            if isinstance(
                astutil.parent_of(node), (ast.Assign, ast.Return)
            ) and _mentions_bare_elts(node, name):
                return True
    return False


def _mentions(expr: ast.AST, name: str) -> bool:
    return any(
        isinstance(sub, ast.Name) and sub.id == name
        for sub in ast.walk(expr)
    )


def _mentions_bare(expr: ast.AST, name: str) -> bool:
    """``name`` used AS the argument (not just somewhere inside an
    expression computing something else — ``n.fileno()`` is a use,
    not a transfer)."""
    if isinstance(expr, ast.Name):
        return expr.id == name
    if isinstance(expr, ast.Starred):
        return _mentions_bare(expr.value, name)
    return False


def _mentions_bare_elts(node: ast.AST, name: str) -> bool:
    elts = list(getattr(node, "elts", ()) or ())
    elts.extend(getattr(node, "values", ()) or ())
    return any(_mentions_bare(e, name) for e in elts)


def _check_resources(
    mod: SourceModule,
    scans: dict[str, _Scan],
    findings: list[Finding],
) -> None:
    # (owner class, attr) -> cleaned anywhere in the module?
    attr_cleaned: set[tuple[str, str]] = set()
    index = mod.index()
    for qual, scan in scans.items():
        owner = index.owner_class.get(qual, "")
        for c in scan.calls:
            if c.recv.startswith(("self.", "cls.")):
                attr_cleaned.add((owner, _recv_leaf(c.recv), c.leaf))

    for qual, scan in scans.items():
        scope = _function_node_of(mod, qual)
        for site in scan.creators:
            if _in_with_or_return(site.node):
                continue
            binding, target = _binding_of(site.node)
            if binding == "transfer":
                continue
            if binding == "discard":
                findings.append(_mk(
                    mod, "resource-leak", site.node, qual,
                    f"{site.ctor}(...) result is discarded — the "
                    f"{site.kind} can never be closed",
                ))
                continue
            if binding == "attr":
                owner = index.owner_class.get(qual, "")
                attr = target.attr
                if not any(
                    (owner, attr, leaf) in attr_cleaned
                    for leaf in site.cleanups
                ):
                    findings.append(_mk(
                        mod, "resource-leak", site.node, qual,
                        f"{site.ctor}(...) stored on self.{attr} but "
                        f"no method of {owner or 'this class'} ever "
                        f"calls {'/'.join(sorted(site.cleanups))} on "
                        "it",
                    ))
                continue
            # plain local name
            name = target.id
            if _name_escapes(scope, name, site.node.lineno):
                continue
            cleanups = [
                c for c in scan.calls
                if c.recv == name and c.leaf in site.cleanups
                and c.node.lineno >= site.node.lineno
            ]
            if not cleanups:
                findings.append(_mk(
                    mod, "resource-leak", site.node, qual,
                    f"{site.ctor}(...) bound to {name!r} but "
                    f"{'/'.join(sorted(site.cleanups))} is never "
                    "called and the value never escapes — use a "
                    "with statement",
                ))
                continue
            if any(c.in_finally for c in cleanups):
                continue
            first_cleanup = min(c.node.lineno for c in cleanups)
            risky = any(
                site.node.lineno < c.node.lineno < first_cleanup
                for c in scan.calls
            )
            if risky:
                findings.append(_mk(
                    mod, "resource-leak", site.node, qual,
                    f"{name!r} ({site.kind}) is only closed on the "
                    "fall-through path — an exception in between "
                    "leaks it; use with, or close in a finally",
                ))


def _mk(
    mod: SourceModule, rule: str, node: ast.AST, qual: str, message: str
) -> Finding:
    return Finding(
        rule=rule,
        path=mod.rel_path,
        line=node.lineno,
        col=node.col_offset,
        message=message,
        context=qual,
        source=mod.source_line(node.lineno),
    )


def check(modules: list[SourceModule]) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        index = mod.index()
        scans: dict[str, _Scan] = {
            "": _scan_scope(mod.tree.body)
        }
        for qual, fn in index.funcs.items():
            scans[qual] = _scan_scope(fn.body)
        _check_acquire_release(mod, scans, index, findings)
        _check_resources(mod, scans, findings)
    return findings
