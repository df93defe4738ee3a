"""Wire-contract registry for the port's ``lint``
(docs/static_analysis.md "Wire-contract rules").

The distributed stack coordinates through *implicit* protocols that no
compiler sees: custom ``X-PIO-*`` headers, route strings registered on
one process and requested from another, metric names registered in a
replica and scraped by name from the router or a smoke script, and
``PIO_*`` environment knobs. This module builds one project-wide
registry of every such wire artifact — producer sites and consumer
sites separately — so the ``wire-contract`` checker (and the docs
meta-test that keeps the ``docs/scale_out.md`` contract table honest)
can diff the two sides.

Header names are resolved through module-level string constants
(``DEADLINE_HEADER = "X-PIO-Deadline"`` referenced as
``resilience.DEADLINE_HEADER`` elsewhere): the constant table is built
first over the whole module set, then each site resolves its key
expression against its own module and falls back to a project-global
name lookup when the name is unambiguous (one value project-wide).
Unresolvable (dynamic) keys are skipped, never guessed — a wire rule
that guessed would cry wolf.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

from predictionio_tpu_torch.analysis import astutil
from predictionio_tpu_torch.analysis.source import SourceModule

#: header names participating in the checked contract (the framework's
#: own protocol headers; standard HTTP headers like Content-Type are
#: out of scope — every library under the sun produces and consumes
#: those)
_WIRE_HEADER = re.compile(r"^x[-_]pio[-_]", re.IGNORECASE)

#: request-ID / span headers are part of the wire too, but they are
#: deliberately optional on both sides (a request without them mints
#: fresh IDs); they appear in the registry for the docs table yet are
#: exempt from produced/consumed pairing
OPTIONAL_HEADERS = frozenset({"x-request-id", "x-parent-span"})

_METRIC_NAME = re.compile(r"^pio_[a-z0-9_]+$")
#: per-sample suffixes the text/JSON exposition derives from one
#: histogram registration
_METRIC_SUFFIXES = ("_bucket", "_count", "_sum")

_ENV_NAME = re.compile(r"^PIO_[A-Z0-9_]+$")
_DOC_ENV_TOKEN = re.compile(r"PIO_[A-Z0-9_]*")

#: callee leaf names whose first string argument is an env var name
_ENV_HELPER = re.compile(r"(^|_)env(_|$)|^getenv$", re.IGNORECASE)

#: callee leaf names whose string argument names a metric being READ
#: from a scrape payload (``_metric_sample``, ``metric_value``,
#: ``sample``, the cli's local ``gauge(name)`` helper)
_SCRAPE_CALL = re.compile(r"(metric|sample|scrape)", re.IGNORECASE)

#: names that smell like a URL/base being concatenated with a path
_URLISH = re.compile(r"(url|base|addr|host|endpoint|target)", re.IGNORECASE)

#: callee leaf names that take a request path as their first string
#: argument (the smoke scripts' ``call(path, body)`` helpers and the
#: trainer's ``_router_request``)
_PATH_CALL = re.compile(r"(^call$|_call$|_request$|^http_json$)")

#: placeholder for a dynamic (formatted) chunk of a client path
WILDCARD = "\x00"


@dataclasses.dataclass(frozen=True)
class Site:
    """One producer/consumer occurrence of a wire artifact."""

    path: str  # repo-relative, forward slashes
    line: int
    col: int
    context: str  # enclosing qualname
    spelling: str  # the name exactly as written at this site


@dataclasses.dataclass
class WireRegistry:
    """Project-wide wire-contract registry (see module docstring)."""

    #: raw header spelling -> sites that SET it on a request/response
    headers_produced: dict[str, list[Site]]
    #: raw header spelling -> sites that READ it
    headers_consumed: dict[str, list[Site]]
    #: registered route pattern ("/events/<event_id>.json") -> sites
    routes: dict[str, list[Site]]
    #: client-side request path pattern (dynamic chunks as WILDCARD)
    request_paths: dict[str, list[Site]]
    #: metric name -> registration sites (counter/gauge/histogram)
    metrics_registered: dict[str, list[Site]]
    #: metric name -> scrape-by-name sites
    metrics_scraped: dict[str, list[Site]]
    #: env var name -> read sites (names ending "_" are prefix families
    #: and are recorded but exempt from the documentation rule)
    env_reads: dict[str, list[Site]]
    #: PIO_* tokens found in the docs tree (full names and prefixes)
    env_documented: set[str]

    def header_canonical(self) -> dict[str, dict[str, list[Site]]]:
        """{canonical name: {"produced": sites, "consumed": sites}}
        over every contract header, canonical = lowercase with ``_``
        folded to ``-`` (the near-miss equivalence class)."""
        out: dict[str, dict[str, list[Site]]] = {}
        for table, key in (
            (self.headers_produced, "produced"),
            (self.headers_consumed, "consumed"),
        ):
            for spelling, sites in table.items():
                canon = canonical_header(spelling)
                slot = out.setdefault(
                    canon, {"produced": [], "consumed": []}
                )
                slot[key].extend(sites)
        return out


def canonical_header(name: str) -> str:
    return name.lower().replace("_", "-")


def strip_metric_suffix(name: str) -> str:
    for suffix in _METRIC_SUFFIXES:
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def docs_env_tokens(root: str) -> set[str]:
    """Every ``PIO_*`` token mentioned anywhere under ``<root>/docs``
    or in ``<root>/README.md`` (whose port section documents the knobs
    only the port reads) — the documentation side of the env contract.
    Tokens ending in ``_`` double as documented prefixes
    (``PIO_STORAGE_SOURCES_...``)."""
    docs = os.path.join(root, "docs")
    try:
        names = sorted(os.listdir(docs))
    except OSError:
        names = []
    paths = [
        os.path.join(docs, name) for name in names if name.endswith(".md")
    ] + [os.path.join(root, "README.md")]
    tokens: set[str] = set()
    for path in paths:
        try:
            with open(path, encoding="utf-8") as f:
                tokens.update(_DOC_ENV_TOKEN.findall(f.read()))
        except OSError:
            continue
    return tokens


def env_is_documented(name: str, documented: set[str]) -> bool:
    if name in documented:
        return True
    # a documented prefix family covers its members
    # (PIO_STORAGE_SOURCES_ covers PIO_STORAGE_SOURCES_STORE_KEY)
    return any(
        tok.endswith("_") and len(tok) > 4 and name.startswith(tok)
        for tok in documented
    )


def route_matches(client_path: str, route_pattern: str) -> bool:
    """Does a client path pattern (WILDCARD = dynamic chunk) match a
    registered route pattern (``<name>`` captures, possibly embedded —
    ``/events/<event_id>.json``)? Compared segment-by-segment; a
    dynamic chunk on either side matches anything within its
    segment."""
    c_segs = client_path.strip("/").split("/")
    r_segs = route_pattern.strip("/").split("/")
    if len(c_segs) != len(r_segs):
        return False
    for c, r in zip(c_segs, r_segs):
        if WILDCARD in c:
            continue  # dynamic client chunk: matches any segment
        if "<" in r:
            # route captures may be embedded in a segment
            # (`<id>.json`): each capture matches any non-empty chunk
            literals = re.split(r"<[^>]*>", r)
            pattern = "[^/]+".join(re.escape(part) for part in literals)
            if re.fullmatch(pattern, c) is None:
                return False
            continue
        if c != r:
            return False
    return True


# --------------------------------------------------------------------------
# registry construction
# --------------------------------------------------------------------------


def _module_constants(mod: SourceModule) -> dict[str, str]:
    """Module-level ``NAME = "literal"`` string constants."""
    out: dict[str, str] = {}
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and isinstance(
            node.value, ast.Constant
        ) and isinstance(node.value.value, str):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    out[target.id] = node.value.value
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.value, ast.Constant
        ) and isinstance(node.value.value, str) and isinstance(
            node.target, ast.Name
        ):
            out[node.target.id] = node.value.value
    return out


class _Builder:
    def __init__(self, modules: list[SourceModule]):
        self.modules = modules
        self.reg = WireRegistry(
            headers_produced={},
            headers_consumed={},
            routes={},
            request_paths={},
            metrics_registered={},
            metrics_scraped={},
            env_reads={},
            env_documented=set(),
        )
        self.mod_consts = {
            m.rel_path: _module_constants(m) for m in modules
        }
        #: constant leaf name -> set of values project-wide (used when
        #: a name reference crosses modules: resilience.DEADLINE_HEADER
        #: resolves by its unambiguous leaf)
        self.global_consts: dict[str, set[str]] = {}
        for consts in self.mod_consts.values():
            for name, value in consts.items():
                self.global_consts.setdefault(name, set()).add(value)
        root = ""
        if modules:
            m = modules[0]
            if m.path.replace(os.sep, "/").endswith(m.rel_path):
                root = m.path[: -len(m.rel_path)]
        self.reg.env_documented = docs_env_tokens(root or os.getcwd())

    # -- shared helpers ----------------------------------------------------
    def _resolve_str(
        self, expr: ast.expr, mod: SourceModule
    ) -> str | None:
        if isinstance(expr, ast.Constant) and isinstance(
            expr.value, str
        ):
            return expr.value
        name = astutil.dotted_name(expr)
        if not name:
            return None
        leaf = name.rsplit(".", 1)[-1]
        own = self.mod_consts.get(mod.rel_path, {})
        if leaf in own:
            return own[leaf]
        values = self.global_consts.get(leaf)
        if values is not None and len(values) == 1:
            return next(iter(values))
        return None

    def _site(
        self, mod: SourceModule, node: ast.AST, spelling: str
    ) -> Site:
        return Site(
            path=mod.rel_path,
            line=node.lineno,
            col=node.col_offset,
            context=mod.index().context_of(node),
            spelling=spelling,
        )

    @staticmethod
    def _add(table: dict[str, list[Site]], key: str, site: Site) -> None:
        table.setdefault(key, []).append(site)

    # -- per-module walk ---------------------------------------------------
    def build(self) -> WireRegistry:
        for mod in self.modules:
            mod.index()  # parents attached for context_of
            for node in mod.nodes():
                if isinstance(node, ast.Call):
                    self._scan_call(mod, node)
                elif isinstance(node, ast.Assign):
                    self._scan_assign(mod, node)
                elif isinstance(node, ast.Subscript):
                    self._scan_subscript_load(mod, node)
                elif isinstance(node, ast.Compare):
                    self._scan_compare(mod, node)
                elif isinstance(node, ast.BinOp):
                    self._scan_binop(mod, node)
                elif isinstance(node, ast.JoinedStr):
                    self._scan_fstring(mod, node)
                elif isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    self._scan_defaults(mod, node)
        for table in (
            self.reg.headers_produced,
            self.reg.headers_consumed,
            self.reg.routes,
            self.reg.request_paths,
            self.reg.metrics_registered,
            self.reg.metrics_scraped,
            self.reg.env_reads,
        ):
            for sites in table.values():
                sites.sort(key=lambda s: (s.path, s.line, s.col))
        return self.reg

    # -- headers -----------------------------------------------------------
    def _maybe_header(
        self, mod: SourceModule, key_expr: ast.expr, node: ast.AST,
        produced: bool,
    ) -> None:
        value = self._resolve_str(key_expr, mod)
        if value is None:
            return
        canon = canonical_header(value)
        if not (
            _WIRE_HEADER.match(value) or canon in OPTIONAL_HEADERS
        ):
            return
        table = (
            self.reg.headers_produced
            if produced
            else self.reg.headers_consumed
        )
        self._add(table, value, self._site(mod, node, value))

    @staticmethod
    def _headers_recv(expr: ast.expr) -> bool:
        """Does ``expr`` denote a header mapping? (``x.headers``, a
        name containing "header")."""
        if isinstance(expr, ast.Attribute):
            return "header" in expr.attr.lower()
        if isinstance(expr, ast.Name):
            return "header" in expr.id.lower()
        return False

    # -- calls -------------------------------------------------------------
    def _scan_call(self, mod: SourceModule, call: ast.Call) -> None:
        func = call.func
        leaf = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else ""
        )

        # header producers: req.add_header(K, V) and friends
        if leaf in ("add_header", "putheader", "send_header"):
            if call.args:
                self._maybe_header(mod, call.args[0], call, produced=True)
            return

        # header consumers: <headers>.get(K[, default])
        if (
            leaf == "get"
            and isinstance(func, ast.Attribute)
            and self._headers_recv(func.value)
            and call.args
        ):
            self._maybe_header(mod, call.args[0], call, produced=False)
            # fall through: a .get() on a scrape payload is handled
            # under metrics below only for Name receivers, never for
            # header mappings
            return

        # headers={...} / extra_headers={...} kwargs anywhere
        # (Response(...), http_json(...), httpstore's request helper)
        for kw in call.keywords:
            if (
                kw.arg
                and "header" in kw.arg.lower()
                and isinstance(kw.value, ast.Dict)
            ):
                for key in kw.value.keys:
                    if key is not None:
                        self._maybe_header(mod, key, call, produced=True)

        # routes: <router>.route("GET", "/path", handler), also under
        # `for method, pattern, handler in ((...), ...)` over literals
        if leaf == "route" and isinstance(func, ast.Attribute) and len(
            call.args
        ) >= 2:
            pattern = self._resolve_str(call.args[1], mod)
            patterns = (
                [pattern] if pattern is not None
                else self._loop_values(call.args[1], call, mod)
            )
            for pattern in patterns:
                if pattern.startswith("/"):
                    self._add(
                        self.reg.routes, pattern,
                        self._site(mod, call, pattern),
                    )
            return

        # metric registrations: registry.counter/gauge/histogram(name)
        # — including through a factory call (get_registry().counter)
        if (
            leaf in ("counter", "gauge", "histogram")
            and isinstance(func, ast.Attribute)
            and call.args
        ):
            recv_expr = func.value
            if isinstance(recv_expr, ast.Call):
                recv_expr = recv_expr.func
            recv = (astutil.dotted_name(recv_expr) or "").lower()
            if "registry" in recv or "metrics" in recv:
                name = self._resolve_str(call.args[0], mod)
                if name is not None and _METRIC_NAME.match(name):
                    self._add(
                        self.reg.metrics_registered, name,
                        self._site(mod, call, name),
                    )
                return

        # metric scrapes: metric_value(base, "pio_x"), sample("pio_x"),
        # the cli's local gauge("pio_x") helper, data.get("pio_x")
        if _SCRAPE_CALL.search(leaf) or (
            leaf == "gauge" and isinstance(func, ast.Name)
        ):
            for arg in call.args:
                if isinstance(arg, ast.Constant) and isinstance(
                    arg.value, str
                ) and _METRIC_NAME.match(arg.value):
                    self._add(
                        self.reg.metrics_scraped, arg.value,
                        self._site(mod, call, arg.value),
                    )
        if leaf == "get" and isinstance(func, ast.Attribute) and call.args:
            arg = call.args[0]
            if isinstance(arg, ast.Constant) and isinstance(
                arg.value, str
            ):
                if _METRIC_NAME.match(arg.value):
                    self._add(
                        self.reg.metrics_scraped, arg.value,
                        self._site(mod, call, arg.value),
                    )
                self._maybe_env_read(mod, func.value, arg.value, call)

        # env reads: os.getenv / os.environ.get handled above; helper
        # readers (_env_float("PIO_X"), env_flag("PIO_X")) here
        if _ENV_HELPER.search(leaf) and call.args:
            arg = call.args[0]
            if isinstance(arg, ast.Constant) and isinstance(
                arg.value, str
            ) and _ENV_NAME.match(arg.value):
                self._add(
                    self.reg.env_reads, arg.value,
                    self._site(mod, call, arg.value),
                )

        # request paths: call("/admin/swap", ...) style helpers
        if _PATH_CALL.search(leaf) and call.args:
            arg = call.args[0]
            if isinstance(arg, ast.Constant) and isinstance(
                arg.value, str
            ) and arg.value.startswith("/"):
                self._record_request_path(mod, arg.value, call)

    def _loop_values(
        self, expr: ast.expr, node: ast.AST, mod: SourceModule
    ) -> list[str]:
        """The strings a loop variable takes when ``node`` sits in a
        ``for a, b, c in ((...), ...)`` over a literal table and ``expr``
        names one of the targets. Repaired against the JAX package's
        registry, which leaves such routes unregistered (the store
        server's ``/meta/<kind>`` table) and so reports every client
        request to them as a 404."""
        if not isinstance(expr, ast.Name):
            return []
        cur = astutil.parent_of(node)
        while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            if isinstance(cur, ast.For) and isinstance(
                cur.iter, (ast.Tuple, ast.List)
            ):
                values = _loop_column(cur.target, cur.iter, expr.id)
                if values is not None:
                    out = [self._resolve_str(v, mod) for v in values]
                    return [v for v in out if v is not None]
            cur = astutil.parent_of(cur)
        return []

    def _maybe_env_read(
        self, mod: SourceModule, recv: ast.expr, key: str, node: ast.AST
    ) -> None:
        recv_name = astutil.dotted_name(recv) or ""
        if recv_name.endswith("environ") and _ENV_NAME.match(key):
            self._add(
                self.reg.env_reads, key, self._site(mod, node, key)
            )

    # -- assignments (header subscript stores, env subscripts) -------------
    def _scan_assign(self, mod: SourceModule, node: ast.Assign) -> None:
        for target in node.targets:
            if isinstance(target, ast.Subscript) and self._headers_recv(
                target.value
            ):
                self._maybe_header(
                    mod, target.slice, target, produced=True
                )

    def _scan_subscript_load(
        self, mod: SourceModule, node: ast.Subscript
    ) -> None:
        if not isinstance(node.ctx, ast.Load):
            return
        if self._headers_recv(node.value):
            self._maybe_header(mod, node.slice, node, produced=False)
            return
        if isinstance(node.slice, ast.Constant) and isinstance(
            node.slice.value, str
        ):
            self._maybe_env_read(
                mod, node.value, node.slice.value, node
            )

    def _scan_compare(self, mod: SourceModule, node: ast.Compare) -> None:
        if len(node.ops) != 1:
            return
        left, right = node.left, node.comparators[0]
        # path == "/healthz": a server handling a path by direct
        # comparison (ahead of routing — the drain-exempt telemetry
        # surface) still SERVES that path; record it as a route
        if isinstance(node.ops[0], ast.Eq):
            for name_side, lit_side in ((left, right), (right, left)):
                if (
                    isinstance(lit_side, ast.Constant)
                    and isinstance(lit_side.value, str)
                    and lit_side.value.startswith("/")
                ):
                    dotted = astutil.dotted_name(name_side) or ""
                    if dotted.rsplit(".", 1)[-1] == "path":
                        self._add(
                            self.reg.routes, lit_side.value,
                            self._site(mod, node, lit_side.value),
                        )
            return
        # "PIO_X" in os.environ  /  "pio_metric" in data
        if not isinstance(node.ops[0], (ast.In, ast.NotIn)):
            return
        if not (
            isinstance(left, ast.Constant) and isinstance(left.value, str)
        ):
            return
        recv_name = astutil.dotted_name(right) or ""
        if recv_name.endswith("environ") and _ENV_NAME.match(left.value):
            self._add(
                self.reg.env_reads, left.value,
                self._site(mod, node, left.value),
            )
        elif _METRIC_NAME.match(left.value):
            self._add(
                self.reg.metrics_scraped, left.value,
                self._site(mod, node, left.value),
            )

    def _scan_defaults(self, mod: SourceModule, node) -> None:
        # a metric name as a parameter default (StepTimer.publish's
        # ``name="pio_train_step_seconds"``) is a registration intent:
        # the body registers through the parameter
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None
        ]
        for default in defaults:
            if isinstance(default, ast.Constant) and isinstance(
                default.value, str
            ) and _METRIC_NAME.match(default.value):
                self._add(
                    self.reg.metrics_registered, default.value,
                    self._site(mod, default, default.value),
                )

    # -- request-path extraction -------------------------------------------
    def _record_request_path(
        self, mod: SourceModule, raw: str, node: ast.AST
    ) -> None:
        path = raw.split("?", 1)[0]
        if not path.startswith("/") or path == "/":
            return
        self._add(
            self.reg.request_paths, path, self._site(mod, node, path)
        )

    def _scan_binop(self, mod: SourceModule, node: ast.BinOp) -> None:
        # url + "/path": the left subtree must mention a URL-ish name
        if not isinstance(node.op, ast.Add):
            return
        right = node.right
        if not (
            isinstance(right, ast.Constant)
            and isinstance(right.value, str)
            and right.value.startswith("/")
        ):
            return
        if self._mentions_urlish(node.left):
            self._record_request_path(mod, right.value, node)

    def _scan_fstring(self, mod: SourceModule, node: ast.JoinedStr) -> None:
        # f"{base}/queries.json" and f"{base}/events/{eid}.json?{qs}":
        # everything after the first URL-ish formatted value is the
        # path, with later dynamic chunks as WILDCARD
        parts = node.values
        for i, part in enumerate(parts):
            if not (
                isinstance(part, ast.FormattedValue)
                and self._mentions_urlish(part.value)
            ):
                continue
            chunks: list[str] = []
            for rest in parts[i + 1:]:
                if isinstance(rest, ast.Constant) and isinstance(
                    rest.value, str
                ):
                    chunks.append(rest.value)
                elif isinstance(rest, ast.FormattedValue):
                    chunks.append(WILDCARD)
            path = "".join(chunks)
            if path.startswith("/"):
                # a trailing "?{qs}" wildcard must not swallow the
                # whole query string into the last segment
                self._record_request_path(
                    mod, path.split("?", 1)[0], node
                )
            break

    @staticmethod
    def _mentions_urlish(expr: ast.expr) -> bool:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Name) and _URLISH.search(sub.id):
                return True
            if isinstance(sub, ast.Attribute) and _URLISH.search(sub.attr):
                return True
        return False


def _loop_column(
    target: ast.expr, table: ast.Tuple | ast.List, name: str
) -> list[ast.expr] | None:
    """The elements ``name`` binds to over a literal loop table: the
    rows themselves for ``for name in (...)``, column k of each row for
    a tuple target with ``name`` at position k. None when ``name`` is
    not a target or a row is not a literal of the target's width."""
    if isinstance(target, ast.Name):
        return list(table.elts) if target.id == name else None
    if not isinstance(target, (ast.Tuple, ast.List)):
        return None
    names = [t.id if isinstance(t, ast.Name) else None for t in target.elts]
    if name not in names:
        return None
    k = names.index(name)
    column = []
    for row in table.elts:
        if not (
            isinstance(row, (ast.Tuple, ast.List))
            and len(row.elts) == len(names)
        ):
            return None
        column.append(row.elts[k])
    return column


def build_registry(modules: list[SourceModule]) -> WireRegistry:
    """Build the project-wide wire registry over ``modules``."""
    return _Builder(modules).build()
