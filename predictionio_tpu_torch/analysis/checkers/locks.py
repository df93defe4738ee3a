"""Lock-order and blocking-under-lock checkers.

Builds a per-module (interprocedural within the module) model of lock
acquisition:

* lock *identities* come from assignments: ``self._x = threading.Lock()``
  inside class ``C`` is lock ``path::C._x``; a module-level
  ``X = threading.RLock()`` is ``path::X``. RLock/Condition are
  reentrant (self-edges allowed); plain Lock is not.
* ``with <lock>:`` (and bare ``<lock>.acquire()``) push the lock onto
  the held stack for the enclosed statements.
* calls to same-module functions/methods propagate: a function's
  summary says which locks it may acquire and whether it may block,
  computed to a fixpoint over the module call graph.

Findings:

* ``lock-order`` — a cycle in the global lock-acquisition graph
  (A held while acquiring B somewhere, B held while acquiring A
  elsewhere ⇒ two threads can deadlock), including length-1 cycles on
  non-reentrant locks.
* ``lock-blocking`` — a known-blocking call (device barrier, sleep,
  socket/HTTP, ``future.result``, thread join, queue get/put, ...)
  issued while a lock is held, directly or via a same-module callee.

The rules are the JAX package's, unchanged; the blocking table adds
torch's explicit device barriers (``torch.cuda.synchronize()`` and
``.synchronize()`` on a CUDA ``Event`` or ``Stream``). Implicit syncs
(``.item()``, ``.cpu()``) stay with ``device-sync-hot``: a scalar read
under a lock is the usual way to snapshot state.
"""

from __future__ import annotations

import ast
import dataclasses

from predictionio_tpu_torch.analysis import astutil
from predictionio_tpu_torch.analysis.model import Finding
from predictionio_tpu_torch.analysis.source import SourceModule

#: dotted call targets that always block
BLOCKING_DOTTED = {
    "time.sleep",
    "urllib.request.urlopen",
    "socket.create_connection",
    "socket.getaddrinfo",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "select.select",
    "jax.device_get",
    "signal.pause",
    "torch.cuda.synchronize",  # torch device barrier
    "cuda.synchronize",
}

#: attribute basenames that block regardless of receiver
BLOCKING_ATTRS = {
    "result",  # concurrent.futures.Future.result
    "block_until_ready",  # jax device barrier
    "device_get",
    "serve_forever",
    "communicate",  # Popen
    "accept",
    "recv",
    "sendall",
    "urlopen",
    "wait",  # Event/Condition/Popen — all blocking
}

#: attribute basenames that block only on receivers we can type as
#: thread/queue-like (``", ".join`` and ``dict.get`` must not trip).
#: ``put`` blocks only on a *bounded* queue; an unbounded ``Queue()``
#: put is lock-free-ish and safe under a lock.
BLOCKING_TYPED_ATTRS = {
    "join": {"thread"},
    "get": {"queue", "bounded-queue"},
    "put": {"bounded-queue"},
    "synchronize": {"cuda-sync"},
}

#: constructor dotted-name -> tracked receiver type
_TYPE_CTORS = {
    "threading.Thread": "thread",
    "Thread": "thread",
    "queue.Queue": "queue",
    "queue.LifoQueue": "queue",
    "queue.PriorityQueue": "queue",
    "queue.SimpleQueue": "queue",
    "Queue": "queue",
}

#: torch constructors whose ``.synchronize()`` waits for the card
_CUDA_SYNC_CTORS = {
    "torch.cuda.Event", "cuda.Event",
    "torch.cuda.Stream", "cuda.Stream",
    "torch.cuda.current_stream", "cuda.current_stream",
    "torch.cuda.default_stream", "cuda.default_stream",
}

_QUEUE_CTORS = {
    "queue.Queue", "queue.LifoQueue", "queue.PriorityQueue", "Queue",
}


def _queue_type(call: ast.Call) -> str:
    """'bounded-queue' when constructed with a nonzero maxsize."""
    size = call.args[0] if call.args else None
    for kw in call.keywords:
        if kw.arg == "maxsize":
            size = kw.value
    if size is None or (
        isinstance(size, ast.Constant) and not size.value
    ):
        return "queue"
    return "bounded-queue"

_LOCK_CTORS = {
    "threading.Lock": False,  # reentrant?
    "Lock": False,
    "threading.RLock": True,
    "RLock": True,
    "threading.Condition": True,
    "Condition": True,
}

#: receiver-name fragments that mark a thread even without seeing the
#: constructor (e.g. a Thread handed in from outside the module)
_THREADISH = ("thread", "prober", "watchdog", "worker")


@dataclasses.dataclass
class _FuncSummary:
    acquires: set[str] = dataclasses.field(default_factory=set)
    #: (description, line) of direct blocking calls
    blocking: list[tuple[str, int]] = dataclasses.field(
        default_factory=list
    )
    calls: set[str] = dataclasses.field(default_factory=set)
    may_block_via: str | None = None  # callee qualname, for messages


class _ModuleModel:
    def __init__(self, mod: SourceModule):
        self.mod = mod
        self.index = mod.index()
        #: lock id -> reentrant?
        self.locks: dict[str, bool] = {}
        #: (owner-class qualname, attr/name) -> tracked type
        self.var_types: dict[tuple[str, str], str] = {}
        self.summaries: dict[str, _FuncSummary] = {}
        self._collect_decls()
        for qual, fn in self.index.funcs.items():
            self.summaries[qual] = self._summarize(qual, fn)
        self._fixpoint()

    # -- declarations ------------------------------------------------------
    def _collect_decls(self) -> None:
        for node in self.mod.nodes():
            if not isinstance(
                node, (ast.Assign, ast.AnnAssign)
            ) or not isinstance(node.value, ast.Call):
                continue
            ctor = astutil.dotted_name(node.value.func)
            if ctor is None:
                continue
            targets = (
                node.targets
                if isinstance(node, ast.Assign)
                else [node.target]
            )
            for target in targets:
                owner, name = self._owner_and_name(node, target)
                if name is None:
                    continue
                if ctor in _LOCK_CTORS:
                    self.locks[self._lock_id(owner, name)] = _LOCK_CTORS[
                        ctor
                    ]
                elif ctor in _QUEUE_CTORS:
                    self.var_types[(owner, name)] = _queue_type(
                        node.value
                    )
                elif ctor in _TYPE_CTORS:
                    self.var_types[(owner, name)] = _TYPE_CTORS[ctor]
                elif ctor in _CUDA_SYNC_CTORS:
                    self.var_types[(owner, name)] = "cuda-sync"

    def _owner_and_name(
        self, node: ast.AST, target: ast.expr
    ) -> tuple[str, str | None]:
        """('C', '_x') for ``self._x = ...`` in class C, ('', 'X') for
        a module-level name, (qualname, 'x') for a function local."""
        if isinstance(target, ast.Attribute) and isinstance(
            target.value, ast.Name
        ) and target.value.id in ("self", "cls"):
            ctx = self.index.context_of(node)
            owner = self.index.owner_class.get(ctx, "")
            return owner, target.attr
        if isinstance(target, ast.Name):
            return self.index.context_of(node), target.id
        return "", None

    def _lock_id(self, owner: str, name: str) -> str:
        scope = owner or "<module>"
        return f"{self.mod.rel_path}::{scope}.{name}"

    # -- expression resolution ---------------------------------------------
    def _resolve_lock(self, expr: ast.expr, ctx: str) -> str | None:
        """Lock id for ``self._x`` / local ``x`` / module-level ``X``
        if declared as a Lock/RLock/Condition somewhere."""
        if isinstance(expr, ast.Attribute) and isinstance(
            expr.value, ast.Name
        ) and expr.value.id in ("self", "cls"):
            owner = self.index.owner_class.get(ctx, "")
            lid = self._lock_id(owner, expr.attr)
            return lid if lid in self.locks else None
        if isinstance(expr, ast.Name):
            for scope in (ctx, ""):
                lid = self._lock_id(scope, expr.id)
                if lid in self.locks:
                    return lid
        return None

    def _receiver_type(self, recv: ast.expr, ctx: str) -> str | None:
        if isinstance(recv, ast.Call) and (
            astutil.dotted_name(recv.func) in _CUDA_SYNC_CTORS
        ):
            return "cuda-sync"  # torch.cuda.current_stream().synchronize()
        if isinstance(recv, ast.Attribute) and isinstance(
            recv.value, ast.Name
        ) and recv.value.id in ("self", "cls"):
            owner = self.index.owner_class.get(ctx, "")
            t = self.var_types.get((owner, recv.attr))
            if t:
                return t
            name = recv.attr
        elif isinstance(recv, ast.Name):
            t = self.var_types.get((ctx, recv.id)) or self.var_types.get(
                ("", recv.id)
            )
            if t:
                return t
            name = recv.id
        else:
            return None
        low = name.lower()
        if any(frag in low for frag in _THREADISH):
            return "thread"
        if "queue" in low or low.endswith("_q"):
            return "queue"
        return None

    def _resolve_callee(self, call: ast.Call, ctx: str) -> str | None:
        """Same-module callee qualname for ``self.m()`` / ``f()``."""
        func = call.func
        if isinstance(func, ast.Attribute) and isinstance(
            func.value, ast.Name
        ) and func.value.id in ("self", "cls"):
            owner = self.index.owner_class.get(ctx, "")
            qual = f"{owner}.{func.attr}" if owner else func.attr
            return qual if qual in self.index.funcs else None
        if isinstance(func, ast.Name) and func.id in self.index.funcs:
            return func.id
        return None

    def _blocking_desc(self, call: ast.Call, ctx: str) -> str | None:
        dotted = astutil.dotted_name(call.func)
        if dotted in BLOCKING_DOTTED:
            return f"{dotted}()"
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            if attr in BLOCKING_ATTRS:
                recv = astutil.dotted_name(call.func.value) or "<expr>"
                return f"{recv}.{attr}()"
            if attr in BLOCKING_TYPED_ATTRS:
                rtype = self._receiver_type(call.func.value, ctx)
                if rtype in BLOCKING_TYPED_ATTRS[attr]:
                    recv = astutil.dotted_name(call.func.value) or "<expr>"
                    return f"{recv}.{attr}()"
        return None

    # -- per-function summaries --------------------------------------------
    def _summarize(self, qual: str, fn: ast.AST) -> _FuncSummary:
        s = _FuncSummary()
        for stmt in astutil.walk_statements(fn.body):
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    lid = self._resolve_lock(item.context_expr, qual)
                    if lid:
                        s.acquires.add(lid)
            for call in _stmt_calls(stmt):
                if isinstance(call.func, ast.Attribute) and (
                    call.func.attr == "acquire"
                ):
                    lid = self._resolve_lock(call.func.value, qual)
                    if lid:
                        s.acquires.add(lid)
                desc = self._blocking_desc(call, qual)
                if desc:
                    s.blocking.append((desc, call.lineno))
                callee = self._resolve_callee(call, qual)
                if callee:
                    s.calls.add(callee)
        return s

    def _fixpoint(self) -> None:
        changed = True
        while changed:
            changed = False
            for qual, s in self.summaries.items():
                for callee in s.calls:
                    cs = self.summaries.get(callee)
                    if cs is None:
                        continue
                    if not cs.acquires <= s.acquires:
                        s.acquires |= cs.acquires
                        changed = True
                    if (cs.blocking or cs.may_block_via) and not (
                        s.blocking or s.may_block_via
                    ):
                        s.may_block_via = callee
                        changed = True


def _stmt_calls(stmt: ast.stmt):
    """Calls in this one statement (header expressions included), not
    in statements nested under it — those are walked separately."""
    nested: list[ast.AST] = []
    for field in ("body", "orelse", "finalbody"):
        nested.extend(getattr(stmt, field, ()) or ())
    for handler in getattr(stmt, "handlers", ()):
        nested.extend(handler.body)
    skip = set(map(id, nested))
    todo = [
        c for c in ast.iter_child_nodes(stmt) if id(c) not in skip
    ]
    while todo:
        cur = todo.pop()
        if isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            continue
        if isinstance(cur, ast.Call):
            yield cur
        # the skip set must hold at EVERY depth: an ExceptHandler node
        # is not itself in `nested`, but its body statements are —
        # without the filter they'd be yielded here AND by the caller's
        # recursion into handler.body (duplicate findings)
        todo.extend(
            c for c in ast.iter_child_nodes(cur) if id(c) not in skip
        )


def check(modules: list[SourceModule]) -> list[Finding]:
    findings: list[Finding] = []
    #: (held_lock, acquired_lock) -> (module, line, context)
    edges: dict[tuple[str, str], tuple[SourceModule, int, str]] = {}
    reentrant: dict[str, bool] = {}

    for mod in modules:
        model = _ModuleModel(mod)
        reentrant.update(model.locks)
        for qual, fn in model.index.funcs.items():
            _walk_held(
                model, qual, fn.body, held=[], findings=findings,
                edges=edges,
            )

    findings.extend(_cycle_findings(edges, reentrant))
    return findings


def _walk_held(
    model: _ModuleModel,
    qual: str,
    body: list[ast.stmt],
    held: list[str],
    findings: list[Finding],
    edges: dict,
) -> None:
    mod = model.mod
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        acquired_here: list[str] = []
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            # `with a, b:` acquires b while already holding a
            for item in stmt.items:
                lid = model._resolve_lock(item.context_expr, qual)
                if lid:
                    _note_acquire(
                        model, qual, lid, held + acquired_here,
                        stmt.lineno, edges,
                    )
                    acquired_here.append(lid)
        for call in _stmt_calls(stmt):
            if isinstance(call.func, ast.Attribute) and (
                call.func.attr == "acquire"
            ):
                lid = model._resolve_lock(call.func.value, qual)
                if lid:
                    _note_acquire(
                        model, qual, lid, held, call.lineno, edges
                    )
                    # approximation: held until end of this block
                    held = held + [lid]
            if not held:
                continue
            if (
                isinstance(call.func, ast.Attribute)
                and call.func.attr in ("wait", "wait_for")
                and model._resolve_lock(call.func.value, qual) in held
            ):
                # Condition.wait releases the condition's own lock
                # while sleeping — not a blocking-under-lock bug
                continue
            desc = model._blocking_desc(call, qual)
            if desc:
                findings.append(
                    Finding(
                        rule="lock-blocking",
                        path=mod.rel_path,
                        line=call.lineno,
                        col=call.col_offset,
                        message=(
                            f"blocking call {desc} while holding "
                            f"{_short(held[-1])}"
                        ),
                        context=qual,
                        source=mod.source_line(call.lineno),
                    )
                )
                continue
            callee = model._resolve_callee(call, qual)
            if callee:
                cs = model.summaries.get(callee)
                if cs and (cs.blocking or cs.may_block_via):
                    via = (
                        cs.blocking[0][0]
                        if cs.blocking
                        else f"{cs.may_block_via}()"
                    )
                    findings.append(
                        Finding(
                            rule="lock-blocking",
                            path=mod.rel_path,
                            line=call.lineno,
                            col=call.col_offset,
                            message=(
                                f"call to {callee}() blocks ({via}) "
                                f"while holding {_short(held[-1])}"
                            ),
                            context=qual,
                            source=mod.source_line(call.lineno),
                        )
                    )
                if cs:
                    for lid in cs.acquires:
                        for h in held:
                            edges.setdefault(
                                (h, lid),
                                (model.mod, call.lineno, qual),
                            )
        # recurse with updated held stack
        inner_held = held + acquired_here
        for field in ("body", "orelse", "finalbody"):
            inner = getattr(stmt, field, None)
            if inner:
                _walk_held(
                    model, qual, inner, inner_held, findings, edges
                )
        for handler in getattr(stmt, "handlers", ()):
            _walk_held(
                model, qual, handler.body, inner_held, findings, edges
            )


def _note_acquire(
    model: _ModuleModel,
    qual: str,
    lid: str,
    held: list[str],
    line: int,
    edges: dict,
) -> None:
    for h in held:
        edges.setdefault((h, lid), (model.mod, line, qual))


def _short(lock_id: str) -> str:
    return lock_id.split("::", 1)[-1]


def _cycle_findings(
    edges: dict[tuple[str, str], tuple[SourceModule, int, str]],
    reentrant: dict[str, bool],
) -> list[Finding]:
    graph: dict[str, set[str]] = {}
    for (a, b), _site in edges.items():
        if a == b and reentrant.get(a, False):
            continue  # re-acquiring an RLock/Condition is fine
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())

    findings = []
    for cycle in _find_cycles(graph):
        # report at the first edge of the cycle, naming the full loop
        a, b = cycle[0], cycle[1 % len(cycle)]
        mod, line, ctx = edges.get((a, b)) or next(
            iter(edges.values())
        )
        loop = " -> ".join(_short(x) for x in [*cycle, cycle[0]])
        sites = "; ".join(
            f"{edges[(x, y)][0].rel_path}:{edges[(x, y)][1]}"
            for x, y in zip(cycle, [*cycle[1:], cycle[0]])
            if (x, y) in edges
        )
        findings.append(
            Finding(
                rule="lock-order",
                path=mod.rel_path,
                line=line,
                col=0,
                message=(
                    f"lock-acquisition cycle {loop} "
                    f"(edges at {sites})"
                ),
                context=ctx,
                source=mod.source_line(line),
            )
        )
    return findings


def _find_cycles(graph: dict[str, set[str]]) -> list[list[str]]:
    """Elementary cycles, canonicalized and deduped — Tarjan SCCs, then
    one representative cycle per SCC (plus self-loops)."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    counter = [0]
    sccs: list[list[str]] = []

    def strongconnect(v: str) -> None:
        todo = [(v, iter(sorted(graph.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while todo:
            node, it = todo[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    todo.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            todo.pop()
            if todo:
                parent = todo[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)

    cycles: list[list[str]] = []
    for comp in sccs:
        if len(comp) > 1:
            comp_set = set(comp)
            # walk one representative loop inside the SCC
            start = min(comp)
            path = [start]
            seen = {start}
            cur = start
            while True:
                nxt = min(
                    (w for w in graph.get(cur, ()) if w in comp_set),
                    default=None,
                )
                if nxt is None or nxt == start:
                    break
                if nxt in seen:
                    path = path[path.index(nxt):]
                    break
                path.append(nxt)
                seen.add(nxt)
                cur = nxt
            cycles.append(path)
        elif comp[0] in graph.get(comp[0], ()):
            cycles.append([comp[0]])
    return cycles
