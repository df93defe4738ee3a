"""Thread-root discovery + per-root lockset model for the shared-state
race checkers (docs/static_analysis.md "Concurrency rules").

A **thread root** is an entry point whose body runs on its own thread:

* ``threading.Thread(target=...)`` / ``threading.Timer(..., fn)`` —
  including lambda, bound-method (``self._loop``), nested-closure and
  ``functools.partial`` target forms;
* ``WorkerSlot(respawn)`` respawn callables (they run on the
  ``supervise_children`` supervisor thread);
* HTTP handlers registered via ``router.route(method, path, handler)``
  and gauge scrape callbacks via ``.set_function(fn)`` — every request
  is its own thread, so these roots are **multi-instance** (they race
  with themselves);
* drain/teardown hooks: ``add_drain_hook(fn)``, ``atexit.register``,
  ``signal.signal`` targets, plus any bound method / local function
  escaping as a callback argument into another component;
* the implicit **external** root: public functions/methods of a module
  that starts threads are callable from arbitrary caller threads, so
  any of them not already reachable from a discovered root belongs to
  a multi-instance "external caller" root.

For each root the reachable same-module call graph is computed to a
fixpoint (like the lock checker), carrying the **entry lockset**: the
intersection over all call paths of the locks provably held when a
function is entered. Every ``self._x`` access is recorded with its
lockset — the lexical ``with <lock>:`` stack (each ``with`` keeps its
node identity, so two separate blocks on the same lock do NOT count as
one continuous critical section) plus the inherited entry locks.

The model is deliberately *self-attribute only*: fields reached through
parameters or locals (``slot.retired``) belong to the defining class's
own analysis. Modules that never start a thread get no roots and no
race analysis — single-threaded code must never pay this rule's rent.
"""

from __future__ import annotations

import ast
import dataclasses

from predictionio_tpu_torch.analysis import astutil
from predictionio_tpu_torch.analysis.source import SourceModule

#: constructors whose instances ARE the synchronization — fields of
#: these types mediate cross-thread handoff by design and are exempt
#: from the race rules
SYNC_CTORS = {
    "threading.Lock", "Lock",
    "threading.RLock", "RLock",
    "threading.Condition", "Condition",
    "threading.Event", "Event",
    "threading.Semaphore", "Semaphore",
    "threading.BoundedSemaphore", "BoundedSemaphore",
    "threading.Barrier", "Barrier",
    "threading.local",
    "queue.Queue", "queue.LifoQueue", "queue.PriorityQueue",
    "queue.SimpleQueue", "Queue", "LifoQueue", "PriorityQueue",
    "SimpleQueue",
    "contextvars.ContextVar", "ContextVar",
    "threading.Thread", "Thread", "threading.Timer", "Timer",
}

#: lock constructors (subset of SYNC_CTORS) usable in ``with``/acquire
LOCK_CTORS = {
    "threading.Lock", "Lock",
    "threading.RLock", "RLock",
    "threading.Condition", "Condition",
}

#: method names that mutate their receiver container in place
MUTATOR_METHODS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "add", "discard", "setdefault", "appendleft", "popleft",
    "sort", "reverse",
}

#: calls that materialize/iterate their argument — reading a shared
#: container through these races with a concurrent mutator (dict/set
#: iteration raises RuntimeError mid-mutation; list gives torn views)
ITERATING_CALLS = {
    "list", "tuple", "set", "frozenset", "dict", "sorted", "sum",
    "min", "max", "any", "all",
}  # len() deliberately absent: it is GIL-atomic, never a torn read

#: calls taking function arguments in a pure, same-thread way — a
#: lambda handed to these is NOT a thread root
_FUNCTIONAL_CALLS = {
    "sorted", "min", "max", "map", "filter", "sort", "reduce", "sum",
    "any", "all", "partial", "functools.partial",
}

#: kwarg names whose callables run inline on the calling thread
_FUNCTIONAL_KWARGS = {"key", "default"}

#: teardown method names treated as externally-driven roots on classes
#: that own threads (called from a control/drain thread)
TEARDOWN_NAMES = {"close", "stop", "shutdown", "drain", "__exit__"}


def owner_of(index, qual: str) -> str:
    """Owning class of ``qual``: its own ``owner_class`` entry, else the
    nearest enclosing scope's — a closure or nested helper defined in a
    method keeps that method's class (its ``self``)."""
    owner = index.owner_class.get(qual, "")
    if not owner:
        parts = qual.split(".")
        for i in range(len(parts) - 1, 0, -1):
            owner = index.owner_class.get(".".join(parts[:i]), "")
            if owner:
                break
    return owner


# --------------------------------------------------------------------------
# Model dataclasses
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Access:
    """One ``self._x`` touch: where, what kind, under which locks.

    ``kind``: ``read`` (single load — GIL-atomic), ``iter`` (iteration /
    materialization of a container), ``write`` (plain store of a fresh
    value), ``rmw`` (read-modify-write: augmented assignment, or a store
    whose value loads the same field), ``mutate`` (in-place container
    mutation: mutator method, subscript store, ``del``).

    ``held`` is a frozenset of lock *tokens* — ``lock_id@@nodeN`` for a
    lexical ``with`` block (node identity distinguishes two separate
    blocks on the same lock) or ``lock_id@@entry`` for locks inherited
    from every caller.
    """

    owner: str
    field: str
    kind: str
    qual: str
    line: int
    col: int
    held: frozenset


@dataclasses.dataclass(frozen=True)
class Root:
    """One discovered thread root."""

    kind: str  # thread | timer | handler | hook | callback | external
    display: str
    entry: str | None  # in-module entry qualname (None = external body)
    line: int
    #: True when many instances of this root run concurrently (HTTP
    #: handlers, scrape callbacks, per-call spawned threads) — the root
    #: races with itself
    multi: bool


def token_lock(token: str) -> str:
    return token.split("@@", 1)[0]


def tokens_to_locks(tokens: frozenset) -> frozenset:
    return frozenset(token_lock(t) for t in tokens)


@dataclasses.dataclass
class _FuncInfo:
    accesses: list = dataclasses.field(default_factory=list)
    #: (callee qualname, held tokens at the call, line)
    calls: list = dataclasses.field(default_factory=list)
    #: fields this function (directly) writes: (owner, field, kind)
    writes: set = dataclasses.field(default_factory=set)


class ThreadModel:
    """Per-module concurrency model: roots, reachability with entry
    locksets, and every self-attribute access with its lockset."""

    def __init__(self, mod: SourceModule):
        self.mod = mod
        self.index = mod.index()
        #: lock id ("C._lock" / "<module>.X") -> reentrant? (unused
        #: here but kept for parity with the lock checker's decl scan)
        self.locks: dict[str, str] = {}
        #: (owner, field) declared with a synchronization constructor
        self.sync_fields: set[tuple[str, str]] = set()
        #: (owner, field) assigned a builtin-container literal/ctor
        #: somewhere — only these treat ``.append()``/``.update()``/...
        #: as in-place mutation (the same names on a custom object are
        #: that object's own thread-safety story)
        self.container_fields: set[tuple[str, str]] = set()
        self.funcs: dict[str, _FuncInfo] = {}
        self._collect_decls()
        for qual, fn in self.index.funcs.items():
            self.funcs[qual] = self._scan_function(qual, fn)
        self.roots: list[Root] = []
        self._discover_roots()
        #: funcs reachable only from __init__/module level — pre-start
        #: initialization, exempt from the race rules
        self.init_only: set[str] = set()
        #: root index -> {qualname -> frozenset(entry lock ids)}
        self.reach: list[dict[str, frozenset]] = []
        self._compute_reachability()

    # -- declarations ------------------------------------------------------
    def _collect_decls(self) -> None:
        for node in self.mod.nodes():
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            value = node.value
            if value is None:
                continue
            targets = (
                node.targets
                if isinstance(node, ast.Assign)
                else [node.target]
            )
            container = _is_container_value(value)
            ctor = (
                astutil.dotted_name(value.func)
                if isinstance(value, ast.Call)
                else None
            )
            for target in targets:
                owner, name = self._owner_and_name(node, target)
                if name is None:
                    continue
                if container:
                    self.container_fields.add((owner, name))
                if ctor is None:
                    continue
                if ctor in LOCK_CTORS:
                    self.locks[f"{owner or '<module>'}.{name}"] = ctor
                if ctor in SYNC_CTORS:
                    self.sync_fields.add((owner, name))

    def _owner_and_name(
        self, node: ast.AST, target: ast.expr
    ) -> tuple[str, str | None]:
        if isinstance(target, ast.Attribute) and isinstance(
            target.value, ast.Name
        ) and target.value.id in ("self", "cls"):
            ctx = self.index.context_of(node)
            return self.index.owner_class.get(ctx, ""), target.attr
        if isinstance(target, ast.Name):
            return self.index.context_of(node), target.id
        return "", None

    # -- lock resolution ---------------------------------------------------
    def _resolve_lock(self, expr: ast.expr, ctx: str) -> str | None:
        if isinstance(expr, ast.Attribute) and isinstance(
            expr.value, ast.Name
        ) and expr.value.id in ("self", "cls"):
            owner = self.index.owner_class.get(ctx, "")
            lid = f"{owner or '<module>'}.{expr.attr}"
            return lid if lid in self.locks else None
        if isinstance(expr, ast.Name):
            for scope in (ctx, "<module>"):
                lid = f"{scope}.{expr.id}"
                if lid in self.locks:
                    return lid
        return None

    def _with_token(self, lock_id: str, node: ast.AST) -> str:
        # position-keyed, NOT id(node)-keyed: the check-then-act
        # checker re-walks the function bodies in a SEPARATE pass
        # (_statement_locksets) and must mint the exact tokens stored
        # in this pass's Access records — node identities differ
        # between walks only if the tree were re-parsed, but position
        # keys make the contract independent of object identity
        return f"{lock_id}@@L{node.lineno}c{node.col_offset}"

    # -- per-function scan -------------------------------------------------
    def _scan_function(self, qual: str, fn: ast.AST) -> _FuncInfo:
        info = _FuncInfo()
        self._scan_body(qual, fn.body, frozenset(), info)
        return info

    def _scan_body(
        self, qual: str, body: list, held: frozenset, info: _FuncInfo
    ) -> None:
        for stmt in body:
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            inner_held = held
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    lid = self._resolve_lock(item.context_expr, qual)
                    if lid:
                        inner_held = inner_held | {
                            self._with_token(lid, stmt)
                        }
            # header expressions of this statement (not nested stmts)
            self._scan_exprs(qual, stmt, held, info)
            for field in ("body", "orelse", "finalbody"):
                nested = getattr(stmt, field, None)
                if nested:
                    self._scan_body(qual, nested, inner_held, info)
            for handler in getattr(stmt, "handlers", ()):
                self._scan_body(qual, handler.body, inner_held, info)
            for case in getattr(stmt, "cases", ()):  # ast.Match
                self._scan_body(qual, case.body, inner_held, info)

    def _scan_exprs(
        self, qual: str, stmt: ast.stmt, held: frozenset, info: _FuncInfo
    ) -> None:
        """Accesses + same-module calls in one statement's own
        expressions (nested statement bodies are walked separately,
        with their updated lock stacks)."""
        nested: list[ast.AST] = []
        for field in ("body", "orelse", "finalbody"):
            nested.extend(getattr(stmt, field, ()) or ())
        for handler in getattr(stmt, "handlers", ()):
            nested.append(handler)
        for case in getattr(stmt, "cases", ()):  # ast.Match: guards
            nested.extend(case.body)  # are header exprs, bodies nest
        skip = set(map(id, nested))
        todo = [c for c in ast.iter_child_nodes(stmt) if id(c) not in skip]
        while todo:
            cur = todo.pop()
            if isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if self._is_self_attr(cur):
                self._record_access(qual, cur, held, info)
            if isinstance(cur, ast.Call):
                callee = self._resolve_callee(cur, qual)
                if callee:
                    info.calls.append((callee, held, cur.lineno))
            todo.extend(
                c for c in ast.iter_child_nodes(cur) if id(c) not in skip
            )

    @staticmethod
    def _is_self_attr(node: ast.AST) -> bool:
        return (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in ("self", "cls")
        )

    def _record_access(
        self, qual: str, node: ast.Attribute, held: frozenset,
        info: _FuncInfo,
    ) -> None:
        owner = owner_of(self.index, qual)
        field = node.attr
        kind = self._classify(node)
        if kind is None:
            return
        if kind == "mutate-method":
            kind = (
                "mutate"
                if (owner, field) in self.container_fields
                else "read"
            )
        info.accesses.append(
            Access(
                owner=owner,
                field=field,
                kind=kind,
                qual=qual,
                line=node.lineno,
                col=node.col_offset,
                held=held,
            )
        )
        if kind in ("write", "rmw", "mutate"):
            info.writes.add((owner, field, kind))

    def _classify(self, node: ast.Attribute) -> str | None:
        parent = astutil.parent_of(node)
        # store target of a plain/annotated assignment
        if isinstance(node.ctx, ast.Store):
            if isinstance(parent, ast.Assign):
                return (
                    "rmw"
                    if _loads_field(parent.value, node.attr)
                    else "write"
                )
            if isinstance(parent, ast.AnnAssign):
                return "write"
            if isinstance(parent, ast.AugAssign):
                return "rmw"
            if isinstance(parent, (ast.For, ast.withitem, ast.NamedExpr)):
                return "write"
            return "write"
        if isinstance(node.ctx, ast.Del):
            return "mutate"
        if isinstance(parent, ast.AugAssign) and parent.target is node:
            return "rmw"
        # self._x.method(...)
        if (
            isinstance(parent, ast.Attribute)
            and parent.value is node
            and isinstance(astutil.parent_of(parent), ast.Call)
            and astutil.parent_of(parent).func is parent
        ):
            if parent.attr in MUTATOR_METHODS:
                return "mutate-method"  # downgraded unless a container
            return "read"
        # self._x[k] = v / del self._x[k] / self._x[k] load
        if isinstance(parent, ast.Subscript) and parent.value is node:
            if isinstance(parent.ctx, (ast.Store, ast.Del)):
                return "mutate"
            return "read"
        # iteration / materialization
        gp = parent
        if isinstance(parent, ast.Attribute) and parent.value is node:
            # .items()/.values()/.keys() views — classify by how the
            # VIEW is consumed (walk to the call around the view)
            call = astutil.parent_of(parent)
            if (
                isinstance(call, ast.Call)
                and call.func is parent
                and parent.attr in ("items", "values", "keys", "copy")
            ):
                gp = call
        if self._is_iterated(gp if gp is not parent else node):
            return "iter"
        return "read"

    @staticmethod
    def _is_iterated(node: ast.AST) -> bool:
        parent = astutil.parent_of(node)
        if isinstance(parent, ast.For) and parent.iter is node:
            return True
        if isinstance(parent, ast.comprehension) and parent.iter is node:
            return True
        if isinstance(parent, ast.Call) and node in parent.args:
            name = astutil.dotted_name(parent.func)
            if name in ITERATING_CALLS:
                return True
        if isinstance(parent, ast.Starred):
            return True
        return False

    def _resolve_callee(self, call: ast.Call, ctx: str) -> str | None:
        func = call.func
        if isinstance(func, ast.Attribute) and isinstance(
            func.value, ast.Name
        ) and func.value.id in ("self", "cls"):
            owner = owner_of(self.index, ctx)
            qual = f"{owner}.{func.attr}" if owner else func.attr
            return qual if qual in self.index.funcs else None
        if isinstance(func, ast.Name):
            # nested function in the current scope first, then module
            for candidate in (f"{ctx}.{func.id}", func.id):
                if candidate in self.index.funcs:
                    return candidate
        return None

    # -- root discovery ----------------------------------------------------
    def _discover_roots(self) -> None:
        for node in self.mod.nodes():
            if not isinstance(node, ast.Call):
                continue
            ctx = self.index.context_of(node)
            name = astutil.dotted_name(node.func)
            if name in ("threading.Thread", "Thread"):
                target = _kwarg(node, "target")
                self._add_entry_root(
                    "thread", target, node, ctx, multi=self._multi_site(ctx)
                )
                continue
            if name in ("threading.Timer", "Timer"):
                fn_arg = (
                    node.args[1] if len(node.args) > 1
                    else _kwarg(node, "function")
                )
                self._add_entry_root(
                    "timer", fn_arg, node, ctx, multi=self._multi_site(ctx)
                )
                continue
            if name == "WorkerSlot" or (
                name and name.endswith(".WorkerSlot")
            ):
                arg = node.args[0] if node.args else _kwarg(node, "spawn")
                self._add_entry_root(
                    "callback", arg, node, ctx, multi=True
                )
                continue
            if name in ("atexit.register", "signal.signal"):
                for arg in node.args:
                    self._add_entry_root("hook", arg, node, ctx, multi=False)
                continue
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr == "route" and len(node.args) >= 3:
                    self._add_entry_root(
                        "handler", node.args[2], node, ctx, multi=True
                    )
                    continue
                if attr == "set_function" and node.args:
                    self._add_entry_root(
                        "handler", node.args[0], node, ctx, multi=True
                    )
                    continue
                if attr in ("add_drain_hook", "register_hook") and node.args:
                    self._add_entry_root(
                        "hook", node.args[0], node, ctx, multi=False
                    )
                    continue
            # generic escape: a bound method / local function / lambda
            # handed as an argument into another component may be
            # called from any of ITS threads
            if name not in _FUNCTIONAL_CALLS and not (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _FUNCTIONAL_CALLS
            ):
                for arg in node.args:
                    self._maybe_escape_root(arg, node, ctx)
                for kw in node.keywords:
                    if kw.arg not in _FUNCTIONAL_KWARGS:
                        self._maybe_escape_root(kw.value, node, ctx)

    def _multi_site(self, ctx: str) -> bool:
        """A thread constructed outside __init__/start/serve/module
        level can be spawned once per call — treat it as
        multi-instance."""
        leaf = ctx.rsplit(".", 1)[-1] if ctx else ""
        return leaf not in (
            "", "__init__", "start", "serve", "open", "main",
        )

    def _maybe_escape_root(
        self, arg: ast.expr, call: ast.Call, ctx: str
    ) -> None:
        """Escaped-callback roots — only for forms that resolve to an
        in-module body (a bound method, a nested function, a lambda)."""
        entry = self._entry_of(arg, ctx)
        if entry is None:
            return
        callee = astutil.dotted_name(call.func) or "<call>"
        self.roots.append(
            Root(
                kind="callback",
                display=f"callback:{entry}→{callee}",
                entry=entry,
                line=call.lineno,
                multi=True,
            )
        )

    def _add_entry_root(
        self, kind: str, target: ast.expr | None, call: ast.Call,
        ctx: str, multi: bool,
    ) -> None:
        entry = self._entry_of(target, ctx) if target is not None else None
        display = f"{kind}:{entry or '<external>'}"
        self.roots.append(
            Root(
                kind=kind, display=display, entry=entry,
                line=call.lineno, multi=multi,
            )
        )

    def _entry_of(self, expr: ast.expr | None, ctx: str) -> str | None:
        """In-module entry qualname for a callable expression."""
        if expr is None:
            return None
        if isinstance(expr, ast.Lambda):
            # synthesize: the lambda body's same-module calls ARE the
            # entries; register a pseudo-function for the lambda itself
            return self._lambda_entry(expr, ctx)
        if isinstance(expr, ast.Call):
            name = astutil.dotted_name(expr.func)
            if name in ("functools.partial", "partial") and expr.args:
                return self._entry_of(expr.args[0], ctx)
            return None
        if self._is_self_attr(expr):
            owner = owner_of(self.index, ctx)
            qual = f"{owner}.{expr.attr}" if owner else expr.attr
            return qual if qual in self.index.funcs else None
        if isinstance(expr, ast.Name):
            for candidate in (f"{ctx}.{expr.id}", expr.id):
                if candidate in self.index.funcs:
                    return candidate
        return None

    def _lambda_entry(self, lam: ast.Lambda, ctx: str) -> str:
        """Register the lambda as a pseudo-function so its body's
        accesses and calls get a root of their own."""
        qual = f"{ctx}.<lambda@{lam.lineno}>" if ctx else (
            f"<lambda@{lam.lineno}>"
        )
        if qual in self.funcs:
            return qual
        info = _FuncInfo()
        # lambda body is one expression: scan it like a statement header
        expr_stmt = ast.Expr(value=lam.body)
        ast.copy_location(expr_stmt, lam)
        # parents are already attached on the real body nodes
        todo: list[ast.AST] = [lam.body]
        while todo:
            cur = todo.pop()
            if isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if self._is_self_attr(cur):
                owner = owner_of(self.index, ctx)
                kind = self._classify(cur)
                if kind == "mutate-method":
                    kind = (
                        "mutate"
                        if (owner, cur.attr) in self.container_fields
                        else "read"
                    )
                if kind is not None:
                    info.accesses.append(
                        Access(
                            owner=owner, field=cur.attr, kind=kind,
                            qual=qual, line=cur.lineno,
                            col=cur.col_offset, held=frozenset(),
                        )
                    )
            if isinstance(cur, ast.Call):
                callee = self._resolve_callee(cur, ctx)
                if callee:
                    info.calls.append((callee, frozenset(), cur.lineno))
            todo.extend(ast.iter_child_nodes(cur))
        self.funcs[qual] = info
        return qual

    # -- reachability + entry locksets -------------------------------------
    def _compute_reachability(self) -> None:
        covered: set[str] = set()
        for root in self.roots:
            reach = self._propagate(root.entry)
            self.reach.append(reach)
            covered |= set(reach)

        # pre-start initialization: reachable from __init__ and from no
        # root. Computed BEFORE the external fallback so an init-only
        # helper can never be misread as externally driven.
        init_reach: set[str] = set()
        for qual in self.index.funcs:
            if qual.rsplit(".", 1)[-1] in ("__init__", "__post_init__"):
                init_reach.add(qual)
                init_reach |= set(self._propagate(qual))

        if self.roots:
            # implicit external root: public entry points not already
            # reachable from a discovered root — arbitrary caller
            # threads may run them concurrently
            external_entries = []
            for qual in self.index.funcs:
                leaf = qual.rsplit(".", 1)[-1]
                if qual in covered:
                    continue
                if leaf.startswith("_") and not (
                    leaf == "__call__" or leaf in TEARDOWN_NAMES
                ):
                    continue
                if leaf in ("__init__", "__post_init__"):
                    continue
                external_entries.append(qual)
            if external_entries:
                merged: dict[str, frozenset] = {}
                for entry in sorted(external_entries):
                    for qual, locks in self._propagate(entry).items():
                        if qual in merged:
                            merged[qual] = merged[qual] & locks
                        else:
                            merged[qual] = locks
                self.roots.append(
                    Root(
                        kind="external",
                        display="external:public-API",
                        entry=None,
                        line=0,
                        multi=True,
                    )
                )
                self.reach.append(merged)
                covered |= set(merged)

            # private helpers reached by nothing in-module AND not by
            # __init__: they are driven from another module through an
            # escaped reference; fold them into the external root too
            # (safety net)
            stragglers = [
                q for q in self.index.funcs
                if q not in covered
                and q not in init_reach
                and self.funcs[q].accesses
            ]
            if stragglers:
                if self.roots[-1].kind != "external":
                    self.roots.append(
                        Root(
                            kind="external",
                            display="external:public-API",
                            entry=None,
                            line=0,
                            multi=True,
                        )
                    )
                    self.reach.append({})
                merged = self.reach[-1]
                for entry in stragglers:
                    for qual, locks in self._propagate(entry).items():
                        if qual in merged:
                            merged[qual] = merged[qual] & locks
                        else:
                            merged[qual] = locks

        self.init_only = init_reach - covered

    def _propagate(self, entry: str | None) -> dict[str, frozenset]:
        """{reachable qualname: entry lock ids} from ``entry``,
        intersecting over call paths (a single lockless path means the
        lock is NOT guaranteed at entry)."""
        if entry is None or entry not in self.funcs:
            return {}
        result: dict[str, frozenset] = {entry: frozenset()}
        work = [entry]
        while work:
            qual = work.pop()
            inherited = result[qual]
            for callee, held_tokens, _line in self.funcs[qual].calls:
                if callee not in self.funcs:
                    continue
                locks = inherited | tokens_to_locks(held_tokens)
                prev = result.get(callee)
                merged = locks if prev is None else (prev & locks)
                if prev is None or merged != prev:
                    result[callee] = merged
                    work.append(callee)
        return result

    # -- queries used by the checkers --------------------------------------
    def field_accesses(self) -> dict[tuple[str, str], list[Access]]:
        out: dict[tuple[str, str], list[Access]] = {}
        for info in self.funcs.values():
            for acc in info.accesses:
                out.setdefault((acc.owner, acc.field), []).append(acc)
        return out

    def roots_of(self, qual: str) -> list[int]:
        return [
            i for i, reach in enumerate(self.reach) if qual in reach
        ]

    def entry_locks(self, root_idx: int, qual: str) -> frozenset:
        return self.reach[root_idx].get(qual, frozenset())


_CONTAINER_CTORS = {
    "list", "dict", "set", "collections.Counter", "Counter",
    "collections.defaultdict", "defaultdict", "collections.deque",
    "deque", "collections.OrderedDict", "OrderedDict",
}


def _is_container_value(value: ast.expr) -> bool:
    if isinstance(
        value,
        (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
         ast.SetComp),
    ):
        return True
    if isinstance(value, ast.Call):
        return astutil.dotted_name(value.func) in _CONTAINER_CTORS
    return False


def _loads_field(expr: ast.AST, field: str) -> bool:
    """Does ``expr`` read ``self.<field>``? (RMW detection)."""
    for node in ast.walk(expr):
        if (
            isinstance(node, ast.Attribute)
            and node.attr == field
            and isinstance(node.value, ast.Name)
            and node.value.id in ("self", "cls")
            and isinstance(node.ctx, ast.Load)
        ):
            return True
    return False


def _kwarg(call: ast.Call, name: str) -> ast.expr | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def get_model(mod: SourceModule) -> ThreadModel:
    """Memoized per-module model (three checkers share it)."""
    model = getattr(mod, "_pio_thread_model", None)
    if model is None:
        model = ThreadModel(mod)
        mod._pio_thread_model = model  # type: ignore[attr-defined]
    return model
