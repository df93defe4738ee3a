"""The port's source linter (``predictionio_tpu_torch/analysis``) against
the JAX package's (``predictionio_tpu/analysis``), on the CPU.

* every fixture source that ``tests/test_lint.py`` hands to its
  ``lint_source(...)`` — read out of that file with ``ast``, with its
  ``path=`` and ``extra=`` modules — goes through both packages'
  ``analyze_modules``: the findings of the 15 rules the port carries
  unchanged are equal as ``(rule, path, line, col, message)``, one case
  per fixture;
* the additions and repairs: torch's device barriers under a lock are
  lock-blocking; a route registered in a loop over a literal table and a
  ``Timer`` daemonized after construction are seen, where the JAX
  checker reports a 404 and an unjoined thread;
* the two rules recast for torch: ``device-sync-hot`` (host syncs of
  tensors in a launch; host preparation of the queries stays clean) and
  ``sharding-spec`` (``P(...)`` axes against the port's meshes), on
  fixtures and on the port's own launches and rule tables;
* the reference's suppression, baseline, console, ``--changed`` (renames
  and merge-base included), cache, salt and SARIF classes, read out of
  ``tests/test_lint.py`` and run against the port's package;
* both consoles' ``lint`` on one fixture directory;
* the port uses no form the three rules it does not carry would check
  (``torch.compile``, ``torch.jit``, CUDA graphs, donation).

The tree-wide cases (the port's surface lints clean, under 30 s, with
torch blocked) are ``tests/test_torch_lint_tree.py``.
"""

from __future__ import annotations

import ast
import pathlib
import re
import sys
import textwrap
import types

import pytest

from predictionio_tpu.analysis import analyze_modules as jax_analyze
from predictionio_tpu.analysis.source import SourceModule as JaxSourceModule
from predictionio_tpu_torch.analysis import RULES, analyze_modules
from predictionio_tpu_torch.analysis.astutil import dotted_name
from predictionio_tpu_torch.analysis.source import SourceModule

ROOT = pathlib.Path(__file__).resolve().parent.parent
REFERENCE_TESTS = ROOT / "tests" / "test_lint.py"

#: the JAX rules the port carries unchanged
CARRIED = frozenset({
    "lock-order", "lock-blocking", "wall-clock", "shared-state-race",
    "lock-consistency", "check-then-act", "wire-header", "wire-route",
    "wire-metric", "wire-env", "acquire-release", "resource-leak",
    "thread-lifecycle", "span-leak", "metric-labels",
})
RECAST = frozenset({"device-sync-hot", "sharding-spec"})
NOT_CARRIED = frozenset({"device-sync-jit", "jit-retrace", "donation"})


def test_rule_table_is_the_reference_minus_three():
    from predictionio_tpu.analysis import RULES as JAX_RULES

    assert set(RULES) == CARRIED | RECAST
    assert set(JAX_RULES) == CARRIED | RECAST | NOT_CARRIED
    for rule in CARRIED:
        mine, ref = RULES[rule], JAX_RULES[rule]
        assert (mine.id, mine.summary, mine.hint) == (
            ref.id, ref.summary, ref.hint)


# -- (a) the reference's fixtures through both analyzers -------------------


class _Unresolved(Exception):
    pass


class _FixtureReader:
    """Evaluates the literal arguments of ``lint_source(...)`` calls in
    ``tests/test_lint.py``: string literals, names bound once to one in
    the same function (else at module level), class attributes read as
    ``self.X``, ``+`` of strings, ``"...".format(k=literal)`` and dicts
    of those."""

    def __init__(self, path: pathlib.Path):
        self.tree = ast.parse(path.read_text())
        self.parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.module_binds = self._binds(self.tree.body)

    @staticmethod
    def _binds(body) -> dict[str, list[ast.expr]]:
        out: dict[str, list[ast.expr]] = {}
        for stmt in body:
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        out.setdefault(t.id, []).append(stmt.value)
        return out

    def _enclosing(self, node, kind):
        while node in self.parents:
            node = self.parents[node]
            if isinstance(node, kind):
                return node
        return None

    def value(self, expr, fn, cls):
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value
        if isinstance(expr, ast.Name):
            binds = []
            if fn is not None:
                binds = [
                    n.value for n in ast.walk(fn)
                    if isinstance(n, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == expr.id
                        for t in n.targets)
                ]
            if not binds:
                binds = self.module_binds.get(expr.id, [])
            if len(binds) != 1:
                raise _Unresolved(expr.id)
            return self.value(binds[0], fn, cls)
        if isinstance(expr, ast.Attribute) and isinstance(
            expr.value, ast.Name
        ) and expr.value.id in ("self", "cls") and cls is not None:
            binds = self._binds(cls.body).get(expr.attr, [])
            if len(binds) != 1:
                raise _Unresolved(expr.attr)
            return self.value(binds[0], fn, cls)
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
            return self.value(expr.left, fn, cls) + self.value(
                expr.right, fn, cls)
        if isinstance(expr, ast.Call) and isinstance(
            expr.func, ast.Attribute
        ) and expr.func.attr == "format" and not expr.args:
            return self.value(expr.func.value, fn, cls).format(**{
                kw.arg: self.value(kw.value, fn, cls)
                for kw in expr.keywords})
        if isinstance(expr, ast.Dict):
            return {
                self.value(k, fn, cls): self.value(v, fn, cls)
                for k, v in zip(expr.keys, expr.values)
            }
        raise _Unresolved(ast.dump(expr)[:80])

    def fixtures(self):
        """[(id, {path: text})] for every lint_source(...) call."""
        out, unresolved = [], []
        for node in ast.walk(self.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "lint_source"
            ):
                continue
            fn = self._enclosing(node, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
            cls = self._enclosing(node, ast.ClassDef)
            try:
                src = self.value(node.args[0], fn, cls)
                path = "mod.py"
                extra = {}
                for kw in node.keywords:
                    if kw.arg == "path":
                        path = self.value(kw.value, fn, cls)
                    elif kw.arg == "extra":
                        extra = self.value(kw.value, fn, cls)
                    else:
                        raise _Unresolved(kw.arg)
            except _Unresolved as e:
                unresolved.append((node.lineno, str(e)))
                continue
            where = f"{cls.name + '.' if cls else ''}{fn.name}:{node.lineno}"
            out.append((where, {path: src, **extra}))
        return sorted(out, key=lambda f: int(f[0].rsplit(":", 1)[1])), \
            unresolved


FIXTURES, UNRESOLVED = _FixtureReader(REFERENCE_TESTS).fixtures()


def _findings(analyze, module_cls, sources: dict[str, str]):
    modules = [
        module_cls(f"/fixture/{p}", p, textwrap.dedent(text))
        for p, text in sources.items()
    ]
    return analyze(modules)


def _key(findings, rules):
    return sorted(
        (f.rule, f.path, f.line, f.col, f.message)
        for f in findings if f.rule in rules
    )


def test_every_reference_fixture_is_read():
    """Each ``lint_source(...)`` call of the reference's tests resolves
    to its sources."""
    calls = sum(
        1 for n in ast.walk(ast.parse(REFERENCE_TESTS.read_text()))
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
        and n.func.id == "lint_source"
    )
    assert UNRESOLVED == []
    assert len(FIXTURES) == calls >= 150


@pytest.mark.parametrize("sources", [s for _, s in FIXTURES],
                         ids=[w for w, _ in FIXTURES])
def test_carried_rules_match_the_reference(sources):
    want = _key(_findings(jax_analyze, JaxSourceModule, sources), CARRIED)
    got = _key(_findings(analyze_modules, SourceModule, sources), CARRIED)
    assert got == want


def _both(src: str, path: str = "mod.py", extra: dict | None = None):
    sources = {path: src, **(extra or {})}
    return (_findings(jax_analyze, JaxSourceModule, sources),
            _findings(analyze_modules, SourceModule, sources))


def _rules(findings):
    return [f.rule for f in findings]


# -- the addition to lock-blocking: torch's device barriers ------------------

_BARRIER = """
import threading
import torch

class Stager:
    def __init__(self):
        self._lock = threading.Lock()
        self._done = torch.cuda.Event()
        self._stream = torch.cuda.Stream()

    def one(self):
        with self._lock:
            {call}
"""


@pytest.mark.parametrize("call", [
    "torch.cuda.synchronize()",
    "self._done.synchronize()",
    "self._stream.synchronize()",
    "torch.cuda.current_stream().synchronize()",
])
def test_torch_barrier_under_a_lock_is_lock_blocking(call):
    jax, port = _both(_BARRIER.format(call=call))
    assert "lock-blocking" not in _rules(jax)  # the reference's table
    hits = [f for f in port if f.rule == "lock-blocking"]
    assert len(hits) == 1 and hits[0].line == 13, port


@pytest.mark.parametrize("call", [
    "self.total = float(torch.ones(1).sum().item())",
    "self.rows = torch.ones(2).cpu()",
    "self._lock.locked()",
    "self._other.synchronize()",  # an object of unknown type
])
def test_implicit_syncs_under_a_lock_stay_clean(call):
    _jax, port = _both(_BARRIER.format(call=call))
    assert "lock-blocking" not in _rules(port), port


# -- repairs of the reference -------------------------------------------------

_LOOP_ROUTES = {
    "server.py": """
    from http_router import Router

    class StoreServer:
        def __init__(self):
            r = Router()
            for method, pattern, handler in (
                ("POST", "/meta/<kind>", self._insert),
                ("GET", "/meta/<kind>/<id>", self._get),
            ):
                r.route(method, pattern, handler)

        def _insert(self, req):
            return req

        def _get(self, req):
            return req
    """,
}
_CLIENT = """
import urllib.request

def probe(base_url):
    return urllib.request.urlopen(base_url + "{path}")
"""


def test_routes_registered_in_a_loop_are_seen():
    """The reference misses ``r.route(method, pattern, handler)`` over a
    literal table and reports every request to those routes as a 404
    (the store server's ``/meta/<kind>``, requested by
    ``chip_smoke.py``)."""
    jax, port = _both(_CLIENT.format(path="/meta/apps"), path="client.py",
                      extra=_LOOP_ROUTES)
    assert _rules(jax) == ["wire-route"]
    assert port == []
    jax, port = _both(_CLIENT.format(path="/meta/apps/7"),
                      path="client.py", extra=_LOOP_ROUTES)
    assert _rules(jax) == ["wire-route"] and port == []


def test_a_request_outside_the_loop_table_is_still_a_404():
    _jax, port = _both(_CLIENT.format(path="/models/list"),
                       path="client.py", extra=_LOOP_ROUTES)
    assert _rules(port) == ["wire-route"]
    assert "/models/list" in port[0].message


_TIMER = """
import threading

def watch(limit_s, expired):
    watchdog = threading.Timer(limit_s, expired)
    {daemon}
    watchdog.start()
"""


def test_a_timer_daemonized_after_construction_is_seen():
    """``Timer`` takes no ``daemon=``; setting the attribute before
    ``start`` is how it is daemonized. The reference flags it."""
    jax, port = _both(_TIMER.format(daemon="watchdog.daemon = True"))
    assert _rules(jax) == ["thread-lifecycle"]
    assert port == []


@pytest.mark.parametrize("daemon", ["pass", "watchdog.daemon = False",
                                    "other.daemon = True"])
def test_a_timer_neither_daemonized_nor_joined_is_still_flagged(daemon):
    jax, port = _both(_TIMER.format(daemon=daemon))
    assert _rules(jax) == _rules(port) == ["thread-lifecycle"]


def test_self_bound_thread_daemonized_in_another_method_is_seen():
    src = """
    import threading

    class Loader:
        def __init__(self):
            self._worker = threading.Thread(target=self._run)
            self._worker.daemon = True

        def _run(self):
            return 1
    """
    jax, port = _both(src)
    assert _rules(jax) == ["thread-lifecycle"]
    assert port == []


# -- thread roots of the port's own threaded modules ------------------------


@pytest.mark.parametrize("rel, threads", [
    ("serving/modelpool.py", ["thread:ModelPool._run"]),
    ("serving/workers.py", ["thread:supervise_children"]),
    ("serving/batching.py", ["thread:MicroBatcher._loop",
                             "thread:MicroBatcher._complete_loop"]),
    ("serving/http.py", ["thread:<external>"]),
    # these start processes, not threads
    ("utils/child_start.py", []),
    ("parallel/distributed.py", []),
])
def test_thread_roots_of_the_ports_modules(rel, threads):
    """Both analyzers find the same roots in the port's threaded modules
    — the model pool's loader thread, the workers' supervisor, the
    batcher's two threads, the HTTP server's metrics handlers."""
    from predictionio_tpu.analysis.threads import ThreadModel as JaxModel
    from predictionio_tpu_torch.analysis.threads import ThreadModel

    path = ROOT / "predictionio_tpu_torch" / rel
    text = path.read_text()
    mine = ThreadModel(SourceModule(str(path), rel, text)).roots
    ref = JaxModel(JaxSourceModule(str(path), rel, text)).roots
    assert [(r.kind, r.display, r.entry, r.line, r.multi) for r in mine] == [
        (r.kind, r.display, r.entry, r.line, r.multi) for r in ref]
    assert [r.display for r in mine if r.kind in ("thread", "timer")] == (
        threads)
    if rel == "serving/http.py":
        assert "handler:install_metrics_routes._metrics" in {
            r.display for r in mine}


# -- (b) device-sync-hot, recast for torch -----------------------------------

_LAUNCH = """
import numpy as np
import torch

class Algo:
    def batch_predict_launch(self, model, queries):
        num = max(int(q.get("num", 10)) for q in queries)
        user_idx = np.asarray([model.users.get(q["user"], -1)
                               for q in queries], np.int32)
        idx = np.clip(np.asarray(user_idx), 0, None)
        rows = torch.as_tensor(idx).to(model.device)
        scores = model.table[rows] @ model.items.T
        {line}
        return scores, user_idx, num
"""


@pytest.mark.parametrize("line, desc", [
    ("best = scores.argmax().item()", "<expr>.item()"),
    ("host = scores.cpu()", "scores.cpu()"),
    ("host = scores.numpy()", "scores.numpy()"),
    ("host = scores.to('cpu')", 'scores.to("cpu")'),
    ("host = scores.to(device='cpu')", 'scores.to("cpu")'),
    ("host = scores.tolist()", "scores.tolist()"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("model.done.synchronize()", "model.done.synchronize()"),
    ("top = float(rows[0])", "float() on a tensor"),
    ("n = int(torch.count_nonzero(rows))", "int() on a tensor"),
    ("ok = bool(scores.max() > 0)", "bool() on a tensor"),
    ("host = np.asarray(scores)", "np.asarray() on a tensor"),
])
def test_host_sync_in_a_launch_is_flagged(line, desc):
    _jax, port = _both(_LAUNCH.format(line=line))
    hits = [f for f in port if f.rule == "device-sync-hot"]
    assert len(hits) == 1, port
    assert hits[0].line == 13
    assert hits[0].message == (
        f"implicit host sync {desc} inside enqueue-only dispatch path "
        "Algo.batch_predict_launch()")


@pytest.mark.parametrize("line", [
    "pass",
    "n_rows = int(rows.shape[0])",
    "n_rows = int(len(rows))",
    "width = int(model.width)",
    "bucket = 1 << max(0, (len(idx) - 1)).bit_length()",
    "host_ids = np.asarray(user_idx)",
    "on_card = rows.to(model.device)",
])
def test_host_preparation_in_a_launch_is_clean(line):
    _jax, port = _both(_LAUNCH.format(line=line))
    assert "device-sync-hot" not in _rules(port), port


def test_collect_pays_the_barrier():
    """The same syncs in ``batch_predict_collect``, or in a ``dispatch``
    whose class has no ``collect``, are not the hot path."""
    src = """
    class Algo:
        def batch_predict_collect(self, model, handle, queries):
            return handle.cpu().numpy().tolist()

    class OnePhase:
        def dispatch(self, handle):
            return handle.item()

    class TwoPhase:
        def dispatch(self, handle):
            return handle.item()

        def collect(self, handle):
            return handle.cpu()
    """
    _jax, port = _both(src)
    assert [(f.rule, f.context) for f in port] == [
        ("device-sync-hot", "TwoPhase.dispatch")]


def _port_module(rel: str, text: str | None = None) -> SourceModule:
    path = ROOT / rel
    return SourceModule(str(path), rel, text or path.read_text())


_LAUNCHES = [
    "predictionio_tpu_torch/models/recommendation.py",
    "predictionio_tpu_torch/models/classification.py",
    "predictionio_tpu_torch/models/textclassification.py",
]


@pytest.mark.parametrize("rel", _LAUNCHES)
def test_the_ports_launches_are_enqueue_only(rel):
    """The real launches are clean, and the checker reads them: a
    ``.item()`` planted on the launch's last line is flagged there."""
    from predictionio_tpu_torch.analysis.checkers import device_sync

    assert device_sync.check([_port_module(rel)]) == []
    text = (ROOT / rel).read_text()
    tree = ast.parse(text)
    launch = next(
        n for n in ast.walk(tree)
        if isinstance(n, ast.FunctionDef)
        and n.name == "batch_predict_launch")
    ret = launch.body[-1]
    assert isinstance(ret, ast.Return)
    lines = text.splitlines()
    indent = lines[ret.lineno - 1][: ret.col_offset]
    lines.insert(ret.lineno - 1, f"{indent}_probe = queries.item()")
    hits = device_sync.check([_port_module(rel, "\n".join(lines))])
    assert [(f.line, f.context) for f in hits] == [
        (ret.lineno, f"{launch_owner(tree, launch)}.batch_predict_launch")]


def launch_owner(tree, fn) -> str:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and fn in node.body:
            return node.name
    raise AssertionError("launch outside a class")


# -- (b) sharding-spec on the port's mesh ------------------------------------

_MESH = """
import numpy as np

DATA_AXIS = "data"
MODEL_AXIS = "model"


class PartitionSpec(tuple):
    pass


P = PartitionSpec


class Mesh:
    def __init__(self, devices, axis_names, local):
        self.axis_names = axis_names


def create(grid, axis_names=(DATA_AXIS, MODEL_AXIS)):
    return Mesh(grid, tuple(axis_names), (0,))
"""


@pytest.mark.parametrize("spec, flagged", [
    ("P(DATA_AXIS, None)", None),
    ("P((DATA_AXIS, MODEL_AXIS), None)", None),
    ("P()", None),
    ("PartitionSpec(MODEL_AXIS)", None),
    ('P("model", None)', None),
    ('P("modle", None)', "modle"),
    ("P(None, (DATA_AXIS, 'replica'))", "replica"),
    ("PartitionSpec('batch')", "batch"),
])
def test_partition_spec_axes_against_the_mesh(spec, flagged):
    user = f"""
    from pkg.parallel.mesh import DATA_AXIS, MODEL_AXIS, P, PartitionSpec

    RULES = [(r".*", {spec})]
    """
    _jax, port = _both(user, path="pkg/rules.py",
                       extra={"pkg/parallel/mesh.py": _MESH})
    hits = [f for f in port if f.rule == "sharding-spec"]
    if flagged is None:
        assert hits == [], hits
    else:
        assert len(hits) == 1 and hits[0].path == "pkg/rules.py"
        assert hits[0].message == (
            f"PartitionSpec names axis {flagged!r} which no mesh defines "
            "(known axes: data, model)")


def test_axes_come_from_the_mesh_construction_too():
    """An axis no ``*_AXIS`` constant names is known once a ``Mesh(...)``
    is built with it, through a parameter default tuple."""
    mesh = _MESH + (
        "\n\ndef ring(grid, axis_names=('data', 'ring')):\n"
        "    return Mesh(grid, axis_names, (0,))\n")
    user = "from pkg.mesh import P\n\nSPEC = P('ring')\nBAD = P('rung')\n"
    _jax, port = _both(user, path="pkg/rules.py",
                       extra={"pkg/mesh.py": mesh})
    assert [(f.rule, f.line) for f in port] == [("sharding-spec", 4)]


def test_the_ports_rule_tables_name_mesh_axes():
    """``parallel/mesh.py`` and ``parallel/partition.py`` are clean, the
    registry holds exactly the port's two axes, and an axis misspelt in
    one of partition.py's rule tables is flagged at its line."""
    from predictionio_tpu_torch.analysis.checkers import sharding_spec

    mesh = _port_module("predictionio_tpu_torch/parallel/mesh.py")
    rel = "predictionio_tpu_torch/parallel/partition.py"
    partition = _port_module(rel)
    assert sharding_spec.check([mesh, partition]) == []
    assert sharding_spec._Registry([mesh, partition]).axes == {
        "data", "model"}
    text = (ROOT / rel).read_text()
    site = '(r"(^|/)inv_perm$", P(MODEL_AXIS)),'
    assert text.count(site) == 1
    line = text[: text.index(site)].count("\n") + 1
    planted = text.replace(site, site.replace("MODEL_AXIS", '"modle"'))
    hits = sharding_spec.check(
        [_port_module("predictionio_tpu_torch/parallel/mesh.py"),
         _port_module(rel, planted)])
    assert [(f.path, f.line) for f in hits] == [(rel, line)]


# -- (c) the reference's classes against the port's package ------------------

#: text substitutions that point the reference's tests at the port
_TO_PORT = (
    ("predictionio_tpu.analysis", "predictionio_tpu_torch.analysis"),
    ("predictionio_tpu.cli.main", "predictionio_tpu_torch.cli.main"),
    ('driver["name"] == "pio-tpu-lint"',
     'driver["name"] == "pio-tpu-torch-lint"'),
    ('"predictionio_tpu/client.py"', '"predictionio_tpu_torch/client.py"'),
)


def reference_cases() -> types.ModuleType:
    """``tests/test_lint.py`` compiled with its imports of the JAX
    analyzer and console pointed at the port's."""
    text = REFERENCE_TESTS.read_text()
    for old, new in _TO_PORT:
        assert old in text, old
        text = text.replace(old, new)
    assert not re.search(r"predictionio_tpu\.(analysis|cli)", text)
    module = types.ModuleType("_reference_lint_cases_on_the_port")
    module.__file__ = str(REFERENCE_TESTS)
    exec(compile(text, str(REFERENCE_TESTS), "exec"), module.__dict__)
    return module


_REF = reference_cases()

TestRefSuppressions = _REF.TestSuppressions
TestRefBaseline = _REF.TestBaseline
TestRefChangedScope = _REF.TestChangedScope
TestRefChangedScopeRenames = _REF.TestChangedScopeRenames
TestRefChangedMergeBase = _REF.TestChangedMergeBase
TestRefLintCache = _REF.TestLintCache
TestRefCacheSalt = _REF.TestCacheSalt
TestRefSarifFormat = _REF.TestSarifFormat
TestRefSarifFingerprintStability = _REF.TestSarifFingerprintStability
TestRefSarifContextFingerprintCollision = (
    _REF.TestSarifContextFingerprintCollision)


class TestRefRunLintAndCli(_REF.TestRunLintAndCli):
    def test_json_reports_per_checker_timings(self, tmp_path, capsys,
                                              monkeypatch):
        """The reference's case over the port's checker modules (it
        names jit_retrace and donation, which the port does not carry)."""
        import json as _json

        from predictionio_tpu_torch.cli.main import main

        (tmp_path / "ok.py").write_text("x = 1\n")
        monkeypatch.chdir(tmp_path)
        assert main(["lint", "ok.py", "--no-baseline", "--json"]) == 0
        payload = _json.loads(capsys.readouterr().out)
        assert payload["ok"] is True
        assert payload["totalMs"] >= 0
        assert set(payload["timingsMs"]) == {
            "locks", "clock", "device_sync", "sharding_spec", "threads",
            "races", "telemetry", "lifecycle", "wire_contract"}


def test_cache_defaults_to_the_ports_own_directory(monkeypatch, tmp_path):
    from predictionio_tpu.analysis import cache as jax_cache
    from predictionio_tpu_torch.analysis import cache

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert cache.default_cache_dir() == str(tmp_path / "pio-tpu-torch-lint")
    assert cache.default_cache_dir() != jax_cache.default_cache_dir()
    assert cache.analyzer_salt() != jax_cache.analyzer_salt()


# -- (e) both consoles on one fixture directory ------------------------------

_FIXTURE_DIR = {
    "clock.py": "import time\n\n\ndef f(t0):\n    return time.time() - t0\n",
    "locks.py": textwrap.dedent("""
        import threading
        import time

        class W:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def one(self):
                with self._a:
                    with self._b:
                        time.sleep(1)

            def two(self):
                with self._b:
                    with self._a:
                        return 2
        """),
    "threads.py": textwrap.dedent("""
        import threading

        def spawn(fn):
            threading.Thread(target=fn).start()
        """),
    "spans.py": textwrap.dedent("""
        def f(tracer):
            span = tracer.trace("x")
            return span
        """),
    "files.py": textwrap.dedent("""
        def read(path):
            f = open(path)
            return f.read()
        """),
    "env.py": 'import os\n\nKNOB = os.environ.get("PIO_FIXTURE_KNOB")\n',
    "suppressed.py": (
        "import time\n\nT = time.time() + 5  "
        "# pio-lint: disable=wall-clock -- fixture\n"),
}
_FINDING_LINE = re.compile(r"^(\S+\.py):(\d+): ([a-z-]+)\b")


@pytest.mark.parametrize("argv", [[], ["--format", "github"]],
                         ids=["text", "github"])
def test_both_consoles_lint_a_fixture_directory_alike(tmp_path, capsys,
                                                      monkeypatch, argv):
    from predictionio_tpu.cli.main import main as jax_main
    from predictionio_tpu_torch.cli.main import main

    for name, text in _FIXTURE_DIR.items():
        (tmp_path / name).write_text(text)
    monkeypatch.chdir(tmp_path)
    runs = {}
    for pkg, console in (("jax", jax_main), ("port", main)):
        rc = console(["lint", ".", "--no-baseline", "--no-cache", *argv])
        out = capsys.readouterr().out
        if argv:
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("::error")]
        else:
            lines = [ln for ln in out.splitlines()
                     if _FINDING_LINE.match(ln)
                     and _FINDING_LINE.match(ln).group(3) in CARRIED]
        runs[pkg] = (rc, lines)
    assert runs["port"] == runs["jax"]
    rc, lines = runs["port"]
    assert rc == 1
    found = {
        rule for rule in CARRIED
        if any(f" {rule}" in ln or f"pio-lint {rule}::" in ln
               for ln in lines)}
    assert found >= {"wall-clock", "lock-order", "lock-blocking",
                     "thread-lifecycle", "span-leak", "resource-leak",
                     "wire-env"}, lines


# -- (g) the ground of the three rules not carried ---------------------------

#: torch forms the JAX package's device-sync-jit / jit-retrace /
#: donation rules would have to be recast for
_COMPILED = re.compile(
    r"^torch\.(compile|jit|_dynamo|export|fx|cuda\.graph|cuda\.graphs"
    r"|cuda\.CUDAGraph|cuda\.make_graphed_callables)\b")
_COMPILED_NAMES = {"compile", "jit", "_dynamo", "export", "CUDAGraph",
                   "make_graphed_callables", "graph", "graphs"}


def _port_sources():
    pkg = ROOT / "predictionio_tpu_torch"
    return sorted(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "tests").glob("torch_*_child.py"))


def test_the_port_compiles_nothing_and_donates_nothing():
    """The day a port source uses ``torch.compile``, ``torch.jit``, CUDA
    graphs or buffer donation, the three rules not carried have ground
    again and this fails."""
    offenders = []
    for path in _port_sources():
        tree = ast.parse(path.read_text())
        rel = path.relative_to(ROOT)
        for node in ast.walk(tree):
            name = None
            if isinstance(node, (ast.Attribute, ast.Name)):
                name = dotted_name(node)
                if name and not _COMPILED.match(name):
                    name = None
            elif isinstance(node, ast.ImportFrom) and (
                node.module or ""
            ).startswith("torch"):
                mod = node.module
                if _COMPILED.match(mod) or (mod in ("torch", "torch.cuda") and any(
                        a.name in _COMPILED_NAMES for a in node.names)):
                    name = mod
            elif isinstance(node, ast.Import):
                name = next((a.name for a in node.names
                             if _COMPILED.match(a.name)), None)
            elif isinstance(node, ast.keyword) and node.arg and (
                node.arg.startswith("donate")
            ):
                name = node.arg
            if name:
                offenders.append(f"{rel}:{getattr(node, 'lineno', 0)}: "
                                 f"{name}")
    assert offenders == []


@pytest.mark.parametrize("line", [
    "step = torch.compile(step)",
    "import torch._dynamo",
    "from torch import jit",
    "g = torch.cuda.CUDAGraph()",
    "out = fn(x, donate_argnums=(0,))",
])
def test_the_guard_sees_each_form(tmp_path, monkeypatch, line):
    probe = tmp_path / "chip_smoke.py"
    probe.write_text(f"import torch\n\n{line}\n")
    monkeypatch.setattr(sys.modules[__name__], "_port_sources",
                        lambda: [probe])
    monkeypatch.setattr(sys.modules[__name__], "ROOT", tmp_path)
    with pytest.raises(AssertionError):
        test_the_port_compiles_nothing_and_donates_nothing()


def test_the_analyzer_is_stdlib_only():
    """Nothing under the port's analyzer imports torch, numpy or jax."""
    pkg = ROOT / "predictionio_tpu_torch" / "analysis"
    for path in pkg.rglob("*.py"):
        assert not re.search(r"^\s*(import|from)\s+(torch|numpy|jax)\b",
                             path.read_text(), re.M), path
