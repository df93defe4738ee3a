"""The port's console against the JAX package's, verb by verb, on the CPU.

The same argv goes through ``predictionio_tpu.cli.main.main`` (JAX on
its CPU backend) and ``predictionio_tpu_torch.cli.main.main`` (with
``--device cpu`` on the verbs that build a compute context), each
against its own package's memory storage. Exit codes and stdout must be
equal once ids, keys and times are masked; so must the stored state
(apps, access keys, channels, manifests, events, instances). Covered:

* the app / accesskey / channel lifecycle, with the duplicate-app error;
* ``build`` accepting and rejecting variants, ``unregister``,
  ``upgrade`` between two declared sources, ``template list/get``,
  ``run``, ``help``, ``version``, ``status``;
* ``train`` of ``examples/recommendation/engine.json`` in both packages
  from one shared iteration-0 checkpoint, then both packages' ``deploy``
  (each in a thread) answering every user's ``/queries.json`` alike,
  stopped by each package's ``undeploy``; and both packages' ``deploy
  --tenant a=default --tenant b=default --pool-budget-bytes`` with
  ``--feedback``, ``--event-server-app``, ``--log-url`` and
  ``--log-prefix``, answering each tenant's queries alike, with the same
  ``status --metrics-url`` pool line;
* ``eval`` of the recommendation example's grid in both packages from
  one iteration-0 checkpoint per rank: metric values within 1e-6 and the
  same best candidate;
* every refused verb and option exits 1 naming its ROADMAP.md item;
* the replicated store tier's verbs run alike over each package's two
  store servers: ``train``, ``deploy`` (answers held as below),
  ``trainer --once`` and ``eventserver`` (a process) with ``--store-url``
  twice, ``status --store-url``, and ``storeserver --peer --role``
  (a process);
* the fleet verbs run: both consoles' ``router`` processes (with and
  without ``--admin-key``) print the same lines, serve the router's
  status and exit 0 on SIGTERM; ``status --router-url`` prints the same
  fleet summary, fleet-health and federation lines against a live
  router and fails alike on a server that is not one (``deploy`` and
  ``eventserver`` with ``--workers`` and ``--reuse-port``:
  ``tests/test_torch_workers.py``);
* without CUDA and without ``--device cpu`` every device verb exits 1
  with the no-device error and writes nothing.

How the served answers are held: each score is within 2e-5 of the JAX
package's in its slot (absolute; the scores are of order 1), and the
items are the same in the same order, except that two items may trade
places where the JAX model scores them within 1e-4 + 1e-5·|s| of each
other. The two packages' ALS sums run in different orders, so after the
example's ten iterations at rank 32 the factors differ by a few 1e-6
relative (``tests/test_torch_als.py`` states why): on this data the
largest score difference is 1.34e-5, and one pair of neighbours closer
than that trades places (``tests/test_torch_train.py`` allows the same).
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.cli.main import build_parser as jax_build_parser
from predictionio_tpu.cli.main import main as jax_main
from predictionio_tpu.core.persistence import (
    deserialize_models as jax_deserialize,
    load_generation as jax_load_generation,
)
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import (
    Storage as JaxStorage,
    set_storage as jax_set_storage,
)
from predictionio_tpu_torch.cli.main import build_parser, main
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Storage, set_storage
from predictionio_tpu_torch.ops.als import _write_checkpoint, checkpoint_path

ROOT = pathlib.Path(__file__).resolve().parent.parent
REC_VARIANT = ROOT / "examples" / "recommendation" / "engine.json"
MEMORY = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}
_LOG_LINE = re.compile(r"^\[[A-Z]+\] \[[\w.]+\] ")
_MASKS = (
    (re.compile(r"[A-Za-z0-9_-]{64}"), "<key>"),
    (re.compile(r"\b[0-9a-f]{32}\b"), "<id>"),
    (re.compile(r"\d{4}-\d\d-\d\dT[\d:.+]+"), "<time>"),
    # each package names its own devices
    (re.compile(r"^Compute: .*$", re.M), "Compute: <devices>"),
)


def _mask(text: str) -> str:
    for pattern, repl in _MASKS:
        text = pattern.sub(repl, text)
    return text


def _errors(err: str) -> list[str]:
    """stderr without the logging lines, masked."""
    return [_mask(line) for line in err.splitlines()
            if not _LOG_LINE.match(line)]


class _Both:
    """Runs one argv through both consoles, each on its own storage."""

    def __init__(self, capsys, jax_storage, port_storage):
        self.capsys = capsys
        self.jax = jax_storage
        self.port = port_storage

    def jax_run(self, argv):
        jax_set_storage(self.jax)
        try:
            code = jax_main(list(argv))
        finally:
            jax_set_storage(None)
        out = self.capsys.readouterr()
        return code, out.out, out.err

    def port_run(self, argv, device=False):
        set_storage(self.port)
        try:
            code = main(list(argv) + (["--device", "cpu"] if device else []))
        finally:
            set_storage(None)
        out = self.capsys.readouterr()
        return code, out.out, out.err

    def __call__(self, *argv, device=False, compare_err=False):
        want = self.jax_run(argv)
        got = self.port_run(argv, device=device)
        assert got[0] == want[0], (argv, got, want)
        assert _mask(got[1]) == _mask(want[1]), (argv, got[1], want[1])
        if compare_err:
            assert _errors(got[2]) == _errors(want[2]), (argv, got, want)
        return got, want


@pytest.fixture()
def both(capsys):
    return _Both(capsys, JaxStorage(MEMORY), Storage(MEMORY))


def _meta_state(storage):
    """Everything the metadata repository holds, ids kept, keys masked."""
    apps = [(a.id, a.name, a.description)
            for a in storage.get_meta_data_apps().get_all()]
    keys = sorted((k.appid, tuple(k.events))
                  for k in storage.get_meta_data_access_keys().get_all())
    channels = sorted(
        (c.id, c.name, c.appid)
        for a in storage.get_meta_data_apps().get_all()
        for c in storage.get_meta_data_channels().get_by_app_id(a.id))
    manifests = sorted(
        (m.id, m.version, m.name, m.description, tuple(m.files),
         m.engine_factory)
        for m in storage.get_meta_data_engine_manifests().get_all())
    return apps, keys, channels, manifests


def _events_state(storage, app_name):
    app = storage.get_meta_data_apps().get_by_name(app_name)
    return sorted(
        (e.event, e.entity_type, e.entity_id, e.target_entity_type,
         e.target_entity_id, json.dumps(e.properties.to_dict(),
                                        sort_keys=True))
        for e in storage.get_events().find(app.id))


# -- app, accesskey, channel ----------------------------------------------


def test_app_accesskey_channel_lifecycle(both):
    steps = [
        ("app", "new", "myapp", "--description", "d"),
        ("app", "new", "other"),
        ("app", "new", "myapp"),  # duplicate: error, exit 1
        ("app", "list"),
        ("app", "show", "myapp"),
        ("app", "channel-new", "myapp", "ch1"),
        ("app", "channel-new", "myapp", "bad name!"),
        ("app", "show", "myapp"),
        ("accesskey", "new", "myapp", "--events", "view,buy"),
        ("accesskey", "list", "myapp"),
        ("accesskey", "list"),
        ("accesskey", "list", "nosuchapp"),
        ("accesskey", "delete", "nosuchkey"),
        ("app", "data-delete", "myapp"),
        ("app", "data-delete", "myapp", "--channel", "ch1"),
        ("app", "data-delete", "myapp", "--channel", "nope"),
        ("app", "channel-delete", "myapp", "ch1"),
        ("app", "channel-delete", "myapp", "ch1"),
        ("app", "show", "nope"),
    ]
    for argv in steps:
        got, want = both(*argv, compare_err=True)
        if argv == ("app", "new", "myapp"):
            assert got[0] == 1 and "already exists" in got[2]
        assert _meta_state(both.port) == _meta_state(both.jax), argv
    # each package deletes its own key through its console
    for run, storage in ((both.jax_run, both.jax),
                         (both.port_run, both.port)):
        app = storage.get_meta_data_apps().get_by_name("myapp")
        key = storage.get_meta_data_access_keys().get_by_app_id(app.id)[-1]
        assert run(("accesskey", "delete", key.key)) == (0, "Deleted.\n", "")
    assert _meta_state(both.port) == _meta_state(both.jax)
    both("app", "delete", "myapp")
    both("app", "list")
    assert _meta_state(both.port) == _meta_state(both.jax)
    assert [a.name for a in both.port.get_meta_data_apps().get_all()] == [
        "other"]


def test_app_new_with_a_given_key(both):
    key = "k" * 64
    both("app", "new", "keyed", "--access-key", key)
    for storage in (both.jax, both.port):
        assert storage.get_meta_data_access_keys().get(key).appid == 1


# -- build, unregister, upgrade -------------------------------------------


def _variant(tmp_path, name, body) -> str:
    path = tmp_path / name
    path.write_text(json.dumps(body))
    return str(path)


def test_build_registers_and_unregister(both, tmp_path):
    good = _variant(tmp_path, "engine.json", {
        "id": "clf-test", "engineFactory": "classification",
        "description": "a classifier",
        "algorithms": [{"name": "naive", "params": {"lambda_": 0.5}}],
    })
    versioned = _variant(tmp_path, "v.json", {
        "id": "rec", "engineFactory": "recommendation",
        "engineVersion": "7",
    })
    both("build", "--variant", good)
    both("build", "--variant", str(REC_VARIANT))
    both("build", "--variant", versioned)
    both("build", "--engine", "helloworld", "--engine-id", "hw")
    assert _meta_state(both.port) == _meta_state(both.jax)
    assert len(_meta_state(both.port)[3]) == 4
    both("unregister", "--engine-id", "clf-test", compare_err=True)
    both("unregister", "--engine-id", "clf-test", compare_err=True)
    both("unregister", "--engine-id", "rec", "--engine-version", "7",
         compare_err=True)
    assert _meta_state(both.port) == _meta_state(both.jax)
    assert len(_meta_state(both.port)[3]) == 2


@pytest.mark.parametrize("body, error", [
    ({"engineFactory": "classification",
      "algorithms": [{"name": "naive", "params": {"lambdaaa": 0.5}}]},
     "unknown params"),
    ({"engineFactory": "no-such-engine"}, "not registered"),
])
def test_build_rejects_bad_variants(both, tmp_path, body, error):
    path = _variant(tmp_path, "bad.json", body)
    for run in (both.jax_run, both.port_run):
        with pytest.raises(Exception, match=error):
            run(("build", "--variant", path))
    assert _meta_state(both.port) == _meta_state(both.jax)


def test_build_without_an_engine_exits(both, tmp_path):
    path = _variant(tmp_path, "empty.json", {"id": "x"})
    for run in (both.jax_run, both.port_run):
        with pytest.raises(SystemExit, match="--engine"):
            run(("build", "--variant", path))


def test_upgrade_between_two_declared_sources(capsys, tmp_path):
    def env(name):
        return {
            "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
            "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_SQL_PATH": str(tmp_path / f"{name}.sqlite"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
        }

    run = _Both(capsys, JaxStorage(env("jax")), Storage(env("port")))
    run("app", "new", "migapp")
    run("app", "channel-new", "migapp", "side")
    for storage, event_cls in ((run.jax, JaxEvent), (run.port, Event)):
        app = storage.get_meta_data_apps().get_by_name("migapp")
        cid = storage.get_meta_data_channels().get_by_app_id(app.id)[0].id
        events = storage.get_events()
        for i in range(7):
            events.insert(event_cls(
                event="view", entity_type="user", entity_id=f"u{i}",
                target_entity_type="item", target_entity_id=f"i{i % 3}"),
                app.id, cid if i % 2 else None)
    got, _ = run("upgrade", "--from", "MEM", "--to", "SQL",
                 "--app", "migapp")
    assert got[1] == "Migrated 7 events of app migapp from MEM to SQL.\n"
    run("upgrade", "--from", "MEM", "--to", "MEM", "--app", "migapp",
        compare_err=True)
    run("upgrade", "--from", "MEM", "--to", "SQL", "--app", "nope",
        compare_err=True)
    for storage in (run.jax, run.port):
        app = storage.get_meta_data_apps().get_by_name("migapp")
        cid = storage.get_meta_data_channels().get_by_app_id(app.id)[0].id
        sql = storage.backend_for_source("SQL")
        assert len(list(sql.find(app.id))) == 4
        assert len(list(sql.find(app.id, cid))) == 3


# -- template, run, help, version, status ---------------------------------


def test_version_and_help(both):
    both("version")
    jax_verbs = set(jax_build_parser()._subparsers._group_actions[0].choices)
    port_verbs = set(build_parser()._subparsers._group_actions[0].choices)
    assert port_verbs == jax_verbs
    for run in (both.jax_run, both.port_run):
        code, out, _ = run(("help",))
        assert code == 0
        for verb in ("train", "deploy", "eventserver", "template"):
            assert verb in out


def test_status_checks_storage_and_compute(both):
    got, _ = both("status", device=True)
    assert got[0] == 0
    assert "Compute: 1 cpu device(s): ['cpu']" in got[1]


@pytest.mark.parametrize("argv", [
    ("template", "list"),
    ("template", "get", "classification", "{tmp}/x", "--engine-id", "mine"),
    ("template", "get", "no-such-template", "{tmp}/x"),
    ("template", "get", "classification", "{tmp}/x", "--subdir", "sub"),
    ("template", "get", "classification", "{tmp}/occupied"),
    ("template", "get", "file://{tmp}/missing.git", "{tmp}/x"),
])
def test_template(both, tmp_path, argv):
    results = []
    for run in (both.jax_run, both.port_run):
        base = tmp_path / str(len(results))
        base.mkdir()
        (base / "occupied").mkdir()
        (base / "occupied" / "f").write_text("x")
        code, out, err = run(tuple(a.replace("{tmp}", str(base))
                                   for a in argv))
        made = sorted(p.relative_to(base).as_posix()
                      for p in base.rglob("*") if p.is_file())
        engine = base / "x" / "engine.json"
        results.append((code, out.replace(str(base), "<tmp>"), made,
                        engine.read_text() if engine.exists() else None,
                        len(_errors(err))))
    assert results[1] == results[0]


def test_template_get_from_a_git_repository(both, tmp_path):
    import subprocess

    repo = tmp_path / "gallery"
    (repo / "engines" / "myrec").mkdir(parents=True)
    (repo / "engines" / "myrec" / "engine.json").write_text(
        json.dumps({"id": "default", "engineFactory": "x:y"}))
    git_env = {"GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
               "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t",
               "PATH": "/usr/bin:/bin"}
    for cmd in (["init", "-q"], ["add", "-A"], ["commit", "-qm", "g"]):
        subprocess.run(["git", "-C", str(repo), *cmd], check=True,
                       capture_output=True, env=git_env)
    for i, run in enumerate((both.jax_run, both.port_run)):
        dst = tmp_path / f"fetched{i}"
        code, out, _ = run(("template", "get", f"file://{repo}", str(dst),
                            "--subdir", "engines/myrec",
                            "--engine-id", "mine"))
        assert (code, out) == (0, f"created engine project at {dst}\n")
        assert json.loads((dst / "engine.json").read_text())["id"] == "mine"
        assert not (dst / ".git").exists()


def test_run(both, tmp_path, monkeypatch):
    (tmp_path / "fakejob.py").write_text(
        "def job(ctx):\n"
        "    return {'batch': ctx.batch, 'ok': [1, 2]}\n"
    )
    monkeypatch.chdir(tmp_path)
    monkeypatch.syspath_prepend(str(tmp_path))
    got, _ = both("run", "fakejob:job", device=True)
    assert json.loads(got[1]) == {"batch": "run", "ok": [1, 2]}
    both("run", "fakejob:job", "--batch", "nightly", device=True)
    both("run", "nocolon", device=True, compare_err=True)
    got, want = both("run", "nomodule:job", device=True)
    assert got[0] == 1


# -- import and export through both consoles -------------------------------


def test_import_export(both, tmp_path):
    rng = np.random.default_rng(5)
    lines = [json.dumps({
        "event": "rate", "entityType": "user", "entityId": f"u{u}",
        "targetEntityType": "item", "targetEntityId": f"i{i}",
        "properties": {"rating": int(r)},
        "eventTime": "2026-01-02T03:04:05+00:00",
    }) for u, i, r in zip(rng.integers(0, 9, 25), rng.integers(0, 5, 25),
                          rng.integers(1, 6, 25))]
    src = tmp_path / "in.jsonl"
    src.write_text("\n".join(lines) + "\n\n")
    both("app", "new", "imp")
    both("app", "channel-new", "imp", "side")
    both("import", "--appname", "imp", "--input", str(src))
    both("import", "--appname", "imp", "--channel", "side",
         "--input", str(src))
    assert _events_state(both.port, "imp") == _events_state(both.jax, "imp")
    for fmt in ("json", "npz"):
        for i, run in enumerate((both.jax_run, both.port_run)):
            out = tmp_path / f"out{i}.{fmt}"
            assert run(("export", "--appname", "imp", "--output", str(out),
                        "--channel", "side"))[:2] == (
                0, f"Exported 25 events to {out}.\n")
        both("app", "new", f"back{fmt}")
        for i, run in enumerate((both.jax_run, both.port_run)):
            # each package imports the OTHER package's export
            other = tmp_path / f"out{1 - i}.{fmt}"
            assert run(("import", "--appname", f"back{fmt}",
                        "--input", str(other)))[:2] == (
                0, "Imported 25 events.\n")
        assert _events_state(both.port, f"back{fmt}") == _events_state(
            both.jax, f"back{fmt}") == _events_state(both.jax, "imp")


# -- train → deploy --------------------------------------------------------

N_USERS, N_ITEMS, N_EVENTS = 60, 40, 900


def _rate_events(event_cls):
    rng = np.random.default_rng(11)
    return [
        event_cls(event="rate", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item", target_entity_id=f"i{i}",
                  properties={"rating": int(r)})
        for u, i, r in zip(rng.integers(0, N_USERS, N_EVENTS),
                           rng.zipf(1.3, N_EVENTS) % N_ITEMS,
                           rng.integers(1, 6, N_EVENTS))
    ]


def _seeded(both):
    """``MyRecApp`` (the example's app) with the same events in both."""
    both("app", "new", "MyRecApp")
    for storage, event_cls in ((both.jax, JaxEvent), (both.port, Event)):
        app = storage.get_meta_data_apps().get_by_name("MyRecApp")
        storage.get_events().insert_batch(_rate_events(event_cls), app.id)
    events = _rate_events(Event)
    return (len({e.entity_id for e in events}),
            len({e.target_entity_id for e in events}))


def _start_checkpoint(ckpt_dir, n_users, n_items, rank, seed):
    rng = np.random.default_rng(seed)
    _write_checkpoint(
        checkpoint_path(str(ckpt_dir)), iteration=0,
        item_factors=(rng.standard_normal((n_items, rank)) / 3).astype(
            np.float32),
        user_factors=np.zeros((n_users, rank), np.float32),
    )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _query(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _serving(port: int, thread: threading.Thread) -> bool:
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and thread.is_alive():
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return True
        except OSError:
            time.sleep(0.05)
    return False


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train --variant examples/recommendation/engine.json`` in both
    consoles from one iteration-0 checkpoint (a copy each: the read must
    not see the other run's writes)."""
    base = tmp_path_factory.mktemp("cli-train")
    both = _Both(_NoCapture(), JaxStorage(MEMORY), Storage(MEMORY))
    n_users, n_items = _seeded(both)
    _start_checkpoint(base / "start", n_users, n_items, 32, 12)
    outs = []
    for name, run, kw in (("jax", both.jax_run, {}),
                          ("port", both.port_run, {"device": True})):
        shutil.copytree(base / "start", base / name)
        outs.append(run(("train", "--variant", str(REC_VARIANT),
                         "--checkpoint-dir", str(base / name),
                         "--checkpoint-every", "0", "--resume"), **kw))
    return both, outs


class _NoCapture:
    """capsys stand-in for a module-scoped fixture: output is left to
    pytest's own capture."""

    @staticmethod
    def readouterr():
        class _Out:
            out = err = ""
        return _Out()


def test_train_records_alike(trained):
    both, (jax_out, port_out) = trained
    assert port_out[0] == jax_out[0] == 0
    (jax_inst,) = both.jax.get_meta_data_engine_instances().get_all()
    (port_inst,) = both.port.get_meta_data_engine_instances().get_all()
    for field in ("status", "engine_id", "engine_version", "engine_variant",
                  "engine_factory", "batch", "data_source_params",
                  "preparator_params", "algorithms_params",
                  "serving_params"):
        assert getattr(port_inst, field) == getattr(jax_inst, field), field
    assert port_inst.status == "COMPLETED"
    assert port_inst.engine_id == "recommendation-quickstart"


def test_deploy_answers_alike(trained, capsys):
    both, _ = trained
    jax_port, port_port = _free_port(), _free_port()
    threads = {}
    results = {}

    def deploy(name, run, port, **kw):
        results[name] = run(("deploy", "--variant", str(REC_VARIANT),
                             "--ip", "127.0.0.1", "--port", str(port),
                             "--max-batch", "8"), **kw)

    for name, run, port, kw in (
            ("jax", both.jax_run, jax_port, {}),
            ("port", both.port_run, port_port, {"device": True})):
        threads[name] = threading.Thread(target=deploy,
                                         args=(name, run, port), kwargs=kw)
        threads[name].start()
        assert _serving(port, threads[name]), results
    try:
        users = sorted({e.entity_id for e in _rate_events(Event)})
        queries = [{"user": u, "num": n}
                   for u, n in zip(users, [1, 3, 5, 10, 40] * 20)]
        queries.append({"user": "nobody", "num": 4})
        want = [_query(jax_port, q) for q in queries]
        got = [_query(port_port, q) for q in queries]
    finally:
        set_storage(both.port)
        try:
            assert main(["undeploy", "--port", str(port_port)]) == 0
        finally:
            set_storage(None)
        assert jax_main(["undeploy", "--port", str(jax_port)]) == 0
        for t in threads.values():
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads.values())
    assert results["jax"][0] == results["port"][0] == 0
    assert got[-1] == want[-1] == {"itemScores": []}
    (jax_inst,) = both.jax.get_meta_data_engine_instances().get_all()
    (jax_model,) = [m for _t, m in jax_deserialize(jax_load_generation(
        both.jax.get_model_data_models(), jax_inst.id))]
    plain = np.asarray(jax_model.user_factors, np.float64) @ np.asarray(
        jax_model.item_factors, np.float64).T
    # the bound rests on a reading: the packages sum the ALS Gramians in
    # different orders, so one half-step agrees to rtol 1e-4 / atol 1e-5
    # (test_torch_als.py::test_half_step_matches_make_solve_side), and
    # the ten rank-32 iterations here gave 1.34e-5 per slot and one swap
    swaps, worst = 0, 0.0
    for q, g, w in zip(queries[:-1], got, want):
        g_items = [e["item"] for e in g["itemScores"]]
        w_items = [e["item"] for e in w["itemScores"]]
        assert len(g_items) == len(w_items) == min(q["num"], N_ITEMS)
        diff = np.abs(np.subtract([e["score"] for e in g["itemScores"]],
                                  [e["score"] for e in w["itemScores"]]))
        worst = max(worst, float(diff.max(initial=0.0)))
        row = plain[jax_model.user_map(q["user"])]
        for gi, wi in zip(g_items, w_items):
            if gi != wi:
                swaps += 1
                a, b = row[jax_model.item_map(gi)], row[jax_model.item_map(wi)]
                assert abs(a - b) <= 1e-4 + 1e-5 * abs(b), (q, gi, wi)
    summary = f"largest per-slot score difference {worst:.3g}, {swaps} swaps"
    assert worst <= 2e-5, summary
    assert swaps <= 4, summary


def test_deploy_tenants_and_serving_options_alike(trained, capsys,
                                                  monkeypatch):
    """``deploy --tenant a=default --tenant b=default`` under a pool
    budget that holds one tenant, with feedback and a remote error log,
    in one console and then the other: the same exit codes and stdout
    (the deploy's line, the ``status --metrics-url`` lines that do not
    carry timings, the undeploy's line), each tenant's answers alike
    (routed by ``accessKey`` and by ``X-PIO-Tenant``), every answer with
    a ``prId``.

    A fault of the reference shows here: after ``/stop`` the JAX
    console's ``deploy`` returns without closing the server, so its
    pool's loader thread, which is not a daemon, outlives ``main`` and
    would hold the process open, and so does its remote error log's
    sender; the port's ``/stop`` closes both (ROADMAP.md §3). The test
    closes the JAX server itself."""
    both, _ = trained
    # the consoles write the budget into the environment; restored after
    monkeypatch.setenv("PIO_POOL_BUDGET_BYTES", "")
    users = sorted({e.entity_id for e in _rate_events(Event)})[:12]
    runs = {}

    def leftovers():
        return {t for t in threading.enumerate()
                if t.name in ("pio-pool-loader", "remote-error-log")}

    for name in ("jax", "port"):
        before = leftovers()
        port = _free_port()
        result = {}
        argv = ["deploy", "--variant", str(REC_VARIANT), "--ip", "127.0.0.1",
                "--port", str(port), "--max-batch", "8", "--tenant",
                "a=default", "--tenant", "b=default", "--pool-budget-bytes",
                "20000", "--feedback", "--event-server-app", "MyRecApp",
                "--log-url", "http://127.0.0.1:9/collect", "--log-prefix",
                "cli-"]
        if name == "port":
            storage, set_, run = both.port, set_storage, main
            argv_run = argv + ["--device", "cpu"]
        else:
            storage, set_, run = both.jax, jax_set_storage, jax_main
            argv_run = argv
        set_(storage)
        try:
            thread = threading.Thread(
                target=lambda: result.update(code=run(argv_run)))
            thread.start()
            try:
                assert _serving(port, thread), result
                answers = []
                for i, user in enumerate(users):
                    tenant = "ab"[i % 2]
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{port}/queries.json"
                        + (f"?accessKey={tenant}" if i % 4 < 2 else ""),
                        data=json.dumps({"user": user, "num": 5}).encode(),
                        method="POST",
                        headers={"Content-Type": "application/json",
                                 "X-PIO-Tenant": tenant})
                    with urllib.request.urlopen(req, timeout=30) as resp:
                        answers.append(json.loads(resp.read()))
                status = run(["status", "--metrics-url",
                              f"http://127.0.0.1:{port}"])
            finally:
                stopped = run(["undeploy", "--port", str(port)])
                thread.join(timeout=60)
        finally:
            set_(None)
        assert not thread.is_alive()
        leaked = leftovers() - before
        if name == "jax":
            assert sorted(t.name for t in leaked) == [
                "pio-pool-loader", "remote-error-log"]
            (sender,) = [t for t in leaked if t.name == "remote-error-log"]
            sender._target.__self__.close()  # the JAX EngineServer
            for t in leaked:
                t.join(timeout=30)
                assert not t.is_alive()
        else:
            for t in leaked:  # the sender ends on close's sentinel
                t.join(timeout=30)
            assert not any(t.is_alive() for t in leaked)
        out = re.sub(r"age=\d+s", "age=<s>",
                     capsys.readouterr().out.replace(str(port), "<port>"))
        runs[name] = (result["code"], status, stopped, answers, [
            line for line in out.splitlines()
            if line.startswith(("Engine server", "pool:", "model:",
                                "Undeployed"))])
    got, want = runs["port"], runs["jax"]
    assert got[:3] == want[:3] == (0, 0, 0)
    assert got[4] == want[4]
    assert want[4][1].startswith("model: generation=")
    assert want[4][2].startswith("pool: tenantsResident=1 bytes=12800/20000")
    for g, w in zip(got[3], want[3]):
        assert re.fullmatch(r"[0-9a-f]{32}", g["prId"])
        assert [e["item"] for e in g["itemScores"]] == [
            e["item"] for e in w["itemScores"]]
        np.testing.assert_allclose([e["score"] for e in g["itemScores"]],
                                   [e["score"] for e in w["itemScores"]],
                                   rtol=0, atol=2e-5)


# -- eval ------------------------------------------------------------------

_EVAL_MODULE = '''
import os

CKPT = os.environ["PIO_TEST_EVAL_CKPT"]


def _precision(base):
    class PrecisionAtK(base):
        def __init__(self, k=10):
            self.k = k

        def calculate_point(self, eval_info, query, prediction, actual):
            top = [s["item"] for s in prediction.get("itemScores", [])[:self.k]]
            if not top:
                return 0.0
            return len(set(top) & set(actual)) / float(self.k)
    return PrecisionAtK


def _evaluation(engine_mod, evaluation_mod, rec):
    grid = [
        engine_mod.EngineParams(
            data_source=("", rec.RecDataSourceParams(app_name="MyRecApp",
                                                     eval_k=3)),
            preparator=("", rec.RecPreparatorParams()),
            algorithms=[("als", rec.ALSParams(
                rank=rank, num_iterations=5,
                checkpoint_dir=os.path.join(CKPT, f"rank{rank}"),
                resume=True))],
        )
        for rank in (8, 16, 32)
    ]
    return evaluation_mod.Evaluation(
        engine=rec.recommendation_engine(),
        metric=_precision(evaluation_mod.AverageMetric)(k=10),
        engine_params_list=grid)


def jax_grid():
    from predictionio_tpu.core import engine, evaluation
    from predictionio_tpu.models import recommendation
    return _evaluation(engine, evaluation, recommendation)


def port_grid():
    from predictionio_tpu_torch.core import engine, evaluation
    from predictionio_tpu_torch.models import recommendation
    return _evaluation(engine, evaluation, recommendation)
'''


def test_eval_matches_the_jax_grid(both, tmp_path, monkeypatch):
    """The recommendation example's grid (eval_k 3, ranks 8/16/32,
    5 iterations, precision@10) through both ``eval`` verbs, each rank
    from one shared iteration-0 checkpoint (only read)."""
    n_users, n_items = _seeded(both)
    for rank in (8, 16, 32):
        _start_checkpoint(tmp_path / "ckpt" / f"rank{rank}", n_users,
                          n_items, rank, 100 + rank)
    (tmp_path / "cli_eval_grid.py").write_text(_EVAL_MODULE)
    monkeypatch.setenv("PIO_TEST_EVAL_CKPT", str(tmp_path / "ckpt"))
    monkeypatch.syspath_prepend(str(tmp_path))
    want = both.jax_run(("eval", "cli_eval_grid:jax_grid"))
    got = both.port_run(("eval", "cli_eval_grid:port_grid"), device=True)
    assert got[0] == want[0] == 0
    line = re.compile(
        r"^\[PrecisionAtK\] best: ([\d.e-]+) \(candidate (\d)/3\)$")
    g_lines, w_lines = got[1].splitlines(), want[1].splitlines()
    g, w = line.match(g_lines[0]), line.match(w_lines[0])
    assert g and w, (g_lines, w_lines)
    assert g.group(2) == w.group(2)
    assert abs(float(g.group(1)) - float(w.group(1))) <= 1e-6
    assert _mask(g_lines[1]) == _mask(w_lines[1]) == (
        "Evaluation instance: <id>")
    (jax_inst,) = both.jax.get_meta_data_evaluation_instances().get_all()
    (port_inst,) = both.port.get_meta_data_evaluation_instances().get_all()
    assert port_inst.status == jax_inst.status == "EVALCOMPLETED"
    jr, pr = (json.loads(i.evaluator_results_json)
              for i in (jax_inst, port_inst))
    assert pr["bestIdx"] == jr["bestIdx"]
    np.testing.assert_allclose(pr["scores"], jr["scores"], rtol=0,
                               atol=1e-6)
    assert max(pr["scores"]) > 0
    for rank in (8, 16, 32):
        with np.load(checkpoint_path(str(tmp_path / "ckpt" /
                                         f"rank{rank}"))) as z:
            assert int(z["iteration"]) == 0


# -- refusals --------------------------------------------------------------

_REFUSALS = [
    (["launch", "-n", "2", "--", "python", "x.py"], "9"),
    (["train", "--variant", str(REC_VARIANT), "--mesh-shape", "4,2"], "9"),
    (["shell", "--mesh-shape", "2"], "9"),
    (["lint", "predictionio_tpu"], None),
]


@pytest.mark.parametrize("verb", ["storeserver", "minipg"])
def test_store_verbs_serve(tmp_path, verb):
    """``storeserver`` and ``minipg`` of each console as a process: the
    same stdout line, the store answering (the store server its status
    and a key-gated route, minipg a query over the postgres wire from
    the other package's driver), and the same exit after SIGINT."""
    import os
    import signal
    import subprocess

    from predictionio_tpu.data.storage import pgwire as jax_pgwire
    from predictionio_tpu_torch.data.storage import pgwire

    results = {}
    for pkg, module in _CONSOLE_MODULES.items():
        port = _free_port()
        argv = [sys.executable, "-m", module, verb, "--ip", "127.0.0.1",
                "--port", str(port)]
        argv += (["--access-key", "k"] if verb == "storeserver" else
                 ["--path", str(tmp_path / f"{pkg}.db"), "--password", "pw"])
        env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1",
                   PIO_FS_BASEDIR=str(tmp_path / pkg))
        out_path, err_path = tmp_path / f"{pkg}.out", tmp_path / f"{pkg}.err"
        with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
            proc = subprocess.Popen(argv, env=env, stdout=out_f,
                                    stderr=err_f, text=True)
        try:
            deadline = time.monotonic() + 60
            while "listening on" not in out_path.read_text():
                assert proc.poll() is None, err_path.read_text()
                assert time.monotonic() < deadline
                time.sleep(0.05)
            if verb == "storeserver":
                base = f"http://127.0.0.1:{port}"
                try:
                    urllib.request.urlopen(base + "/meta/apps", timeout=10)
                    answered = 200
                except urllib.error.HTTPError as e:
                    answered = e.code
                req = urllib.request.Request(
                    base + "/", headers={"Authorization": "Bearer k"})
                with urllib.request.urlopen(req, timeout=10) as resp:
                    answered = (answered, json.loads(resp.read()))
            else:
                driver = pgwire if pkg == "jax" else jax_pgwire
                conn = driver.connect(host="127.0.0.1", port=port,
                                      user="pio", database="pio",
                                      password="pw")
                cur = conn.cursor()
                cur.execute("SELECT 1")
                answered = cur.fetchall()
                conn.close()
            proc.send_signal(signal.SIGINT)
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        results[pkg] = (proc.returncode, answered, [
            ln.replace(str(port), "<port>")
            for ln in out_path.read_text().splitlines()])
    assert results["port"] == results["jax"], results
    assert results["port"][0] == 0
    assert results["port"][2] == [
        {"storeserver": "Store server", "minipg": "minipg"}[verb]
        + " is listening on 127.0.0.1:<port>"]


@pytest.mark.parametrize("argv, item", _REFUSALS,
                         ids=[" ".join(a[:2]) for a, _ in _REFUSALS])
def test_refusals_name_their_item(capsys, argv, item):
    set_storage(Storage(MEMORY))
    try:
        assert main(argv + (["--device", "cpu"] if argv[0] in (
            "train", "shell") else [])) == 1
    finally:
        set_storage(None)
    err = capsys.readouterr().err
    if item is None:
        assert "error: not ported: the source linter is JAX developer " \
               "tooling (ROADMAP.md, not queued)" in err
    else:
        assert f"(ROADMAP.md, queue 1, item {item})" in err, err


# -- the replicated store tier's verbs ----------------------------------------

_STORE_MODULES = {
    "jax": ("predictionio_tpu.serving.store_server",
            "predictionio_tpu.data.storage"),
    "port": ("predictionio_tpu_torch.serving.store_server",
             "predictionio_tpu_torch.data.storage"),
}


class _ReplSet:
    """Two in-process store servers of one package (memory storage), the
    example's app, its access key and ``_rate_events`` on both, and
    every replicated storage the console makes recorded so it can be
    closed."""

    def __init__(self, pkg, monkeypatch, tmp_path, peers=False):
        import importlib

        server_mod, storage_mod = (importlib.import_module(m)
                                   for m in _STORE_MODULES[pkg])
        self.pkg, self.storage_mod = pkg, storage_mod
        self.servers = []
        for i in range(2):
            peer = ([f"http://127.0.0.1:{self.servers[0].port}"]
                    if peers and i else None)
            http = server_mod.create_store_server(
                host="127.0.0.1", port=0,
                storage=storage_mod.Storage(MEMORY), peers=peer,
                role="primary" if i == 0 else "replica")
            http.start()
            self.servers.append(http)
        self.urls = [f"http://127.0.0.1:{s.port}" for s in self.servers]
        self.made = []
        real = storage_mod.set_storage

        def recording(storage):
            if storage is not None and "REPLSET" in storage._specs:
                self.made.append(storage)
            return real(storage)

        monkeypatch.setattr(storage_mod, "set_storage", recording)
        event_cls = JaxEvent if pkg == "jax" else Event
        for http in self.servers:
            local = http.store_app._storage
            app_id = local.get_meta_data_apps().insert(
                storage_mod.App(0, "MyRecApp"))
            local.get_meta_data_access_keys().insert(
                storage_mod.AccessKey(key="repl-key", appid=app_id))
            local.get_events().init(app_id)
            local.get_events().insert_batch(_rate_events(event_cls), app_id)

    def args(self) -> list:
        return [a for u in self.urls for a in ("--store-url", u)]

    def close(self):
        for storage in self.made:
            storage._client("REPLSET").close()
        for http in self.servers:
            if http.store_app.replication is not None:
                http.store_app.replication.close()
            http.shutdown()


def _in_process(pkg, argv):
    if pkg == "jax":
        return jax_main(list(argv))
    return main(list(argv) + (["--device", "cpu"] if argv[0] in (
        "train", "deploy", "trainer") else []))


def _train_through(sets, tmp_path, capsys):
    """``train --store-url ×2`` of each console over its own set, from
    one iteration-0 checkpoint (a copy each); (rc, stdout) by package."""
    events = _rate_events(Event)
    _start_checkpoint(tmp_path / "start",
                      len({e.entity_id for e in events}),
                      len({e.target_entity_id for e in events}), 32, 12)
    out = {}
    for pkg, repl in sets.items():
        shutil.copytree(tmp_path / "start", tmp_path / f"ckpt-{pkg}")
        capsys.readouterr()
        rc = _in_process(pkg, [
            "train", "--variant", str(REC_VARIANT), *repl.args(),
            "--checkpoint-dir", str(tmp_path / f"ckpt-{pkg}"),
            "--checkpoint-every", "0", "--resume"])
        out[pkg] = (rc, _mask(capsys.readouterr().out))
    return out


def _completed_on_every_node(repl) -> list:
    return [[i.status for i in
             http.store_app._storage.get_meta_data_engine_instances()
             .get_all()] for http in repl.servers]


def _store_url_train(sets, tmp_path, capsys):
    out = _train_through(sets, tmp_path, capsys)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 0
    for repl in sets.values():
        assert _completed_on_every_node(repl) == [["COMPLETED"]] * 2


def _store_url_deploy(sets, tmp_path, capsys):
    assert _train_through(sets, tmp_path, capsys)["port"][0] == 0
    ports = {pkg: _free_port() for pkg in sets}
    results, threads = {}, {}
    for pkg, repl in sets.items():
        argv = ["deploy", "--variant", str(REC_VARIANT), "--ip", "127.0.0.1",
                "--port", str(ports[pkg]), "--max-batch", "8", *repl.args()]
        threads[pkg] = threading.Thread(
            target=lambda p=pkg, a=argv: results.__setitem__(
                p, _in_process(p, a)))
        threads[pkg].start()
        assert _serving(ports[pkg], threads[pkg]), results
    try:
        users = sorted({e.entity_id for e in _rate_events(Event)})[:20]
        answers = {pkg: [_query(port, {"user": u, "num": 5})
                         for u in users] for pkg, port in ports.items()}
    finally:
        assert main(["undeploy", "--port", str(ports["port"])]) == 0
        assert jax_main(["undeploy", "--port", str(ports["jax"])]) == 0
        for t in threads.values():
            t.join(timeout=60)
    assert results == {"jax": 0, "port": 0}
    # the bound of test_deploy_answers_alike, which states why: each
    # slot's score within 2e-5, and two items may trade places only where
    # the JAX package scores them within 1e-4 + 1e-5·|s|
    for got, want in zip(answers["port"], answers["jax"]):
        jax_score = {e["item"]: e["score"] for e in want["itemScores"]}
        assert len(got["itemScores"]) == len(want["itemScores"]) == 5
        for g, w in zip(got["itemScores"], want["itemScores"]):
            assert abs(g["score"] - w["score"]) <= 2e-5, (g, w)
            if g["item"] != w["item"]:
                assert abs(jax_score[g["item"]] - w["score"]) <= (
                    1e-4 + 1e-5 * abs(w["score"])), (g, w)


def _store_url_trainer(sets, tmp_path, capsys):
    out = {}
    for pkg, repl in sets.items():
        capsys.readouterr()
        rc = _in_process(pkg, [
            "trainer", "--app", "MyRecApp", "--variant", str(REC_VARIANT),
            "--once", "--checkpoint-dir", str(tmp_path / f"t-{pkg}"),
            *repl.args()])
        out[pkg] = (rc, _mask(capsys.readouterr().out))
    assert out["port"] == out["jax"]
    assert out["port"][0] == 0
    for repl in sets.values():
        assert _completed_on_every_node(repl) == [["COMPLETED"]] * 2


def _store_url_eventserver(sets, tmp_path, capsys):
    import os
    import signal
    import subprocess

    got = {}
    for pkg, repl in sets.items():
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1",
                   PIO_FS_BASEDIR=str(tmp_path / f"es-{pkg}"))
        out_path = tmp_path / f"es-{pkg}.out"
        with open(out_path, "w") as out_f:
            proc = subprocess.Popen(
                [sys.executable, "-m", _CONSOLE_MODULES[pkg], "eventserver",
                 "--ip", "127.0.0.1", "--port", str(port), *repl.args()],
                env=env, stdout=out_f, stderr=subprocess.DEVNULL)
        try:
            deadline = time.monotonic() + 60
            while not _listening_on(port):
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.05)
            base = f"http://127.0.0.1:{port}"
            body = [{"event": "rate", "entityType": "user",
                     "entityId": f"new{i}", "targetEntityType": "item",
                     "targetEntityId": "i1", "properties": {"rating": 3},
                     "eventId": f"{i:032x}"} for i in range(3)]
            req = urllib.request.Request(
                base + "/batch/events.json?accessKey=repl-key",
                data=json.dumps(body).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                statuses = [r["status"] for r in json.loads(resp.read())]
            with urllib.request.urlopen(base + "/healthz",
                                        timeout=10) as resp:
                health = json.loads(resp.read())
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        held = [sorted(e.entity_id for e in
                       http.store_app._storage.get_events().find(
                           1, entity_type="user")
                       if e.entity_id.startswith("new"))
                for http in repl.servers]
        repl_view = health["replication"]
        for i, peer in enumerate(repl_view["peers"]):
            assert peer.pop("url") == repl.urls[i]
        got[pkg] = (proc.returncode, statuses, held, repl_view,
                    out_path.read_text().replace(str(port), "<port>"))
    assert got["port"] == got["jax"]
    rc, statuses, held, view, _out = got["port"]
    assert rc == 0 and statuses == [201] * 3
    assert held == [["new0", "new1", "new2"]] * 2
    assert (view["role"], view["n"], view["w"]) == ("client", 2, 2)


def _listening_on(port: int) -> bool:
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=1):
            return True
    except OSError:
        return False


def _store_url_status(sets, tmp_path, capsys):
    got = {}
    for pkg, repl in sets.items():
        repl.servers[1].store_app.replication.sync_once()
        capsys.readouterr()
        rc = _in_process(pkg, ["status", *repl.args()])
        text = capsys.readouterr().out
        for i, url in enumerate(repl.urls):
            text = text.replace(url, f"<node{i}>")
        got[pkg] = (rc, re.sub(r"(lag|last-sync)=[\d.]+s", r"\1=<t>s", text))
    assert got["port"] == got["jax"]
    assert got["port"] == (0, "Store <node0>: ok, standalone (no "
                              "replication)\nStore <node1>: ok role=replica "
                              "peers=1 lag=<t>s last-sync=<t>s ago\n")


def _store_url_storeserver(sets, tmp_path, capsys):
    import os
    import signal
    import subprocess

    got = {}
    for pkg, repl in sets.items():
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1",
                   PIO_FS_BASEDIR=str(tmp_path / f"ss-{pkg}"))
        out_path = tmp_path / f"ss-{pkg}.out"
        with open(out_path, "w") as out_f:
            proc = subprocess.Popen(
                [sys.executable, "-m", _CONSOLE_MODULES[pkg], "storeserver",
                 "--ip", "127.0.0.1", "--port", str(port), "--peer",
                 repl.urls[0], "--role", "primary"],
                env=env, stdout=out_f, stderr=subprocess.DEVNULL)
        try:
            deadline = time.monotonic() + 60
            while "Replication:" not in out_path.read_text():
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.05)
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                        timeout=10) as resp:
                repl_view = json.loads(resp.read())["replication"]
            proc.send_signal(signal.SIGINT)
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        got[pkg] = (proc.returncode, repl_view["role"],
                    [p["url"] == repl.urls[0] for p in repl_view["peers"]],
                    out_path.read_text().replace(str(port), "<port>"))
    assert got["port"] == got["jax"]
    assert got["port"] == (0, "primary", [True], (
        "Store server is listening on 127.0.0.1:<port>\n"
        "Replication: role=primary, anti-entropy against 1 peer(s)\n"))


_STORE_URL_VERBS = {
    "train --store-url": _store_url_train,
    "deploy --store-url": _store_url_deploy,
    "trainer --app": _store_url_trainer,
    "eventserver --store-url": _store_url_eventserver,
    "status --store-url": _store_url_status,
    "storeserver --peer": _store_url_storeserver,
}


@pytest.mark.parametrize("verb", list(_STORE_URL_VERBS))
def test_store_url_verbs_work_alike(tmp_path, capsys, monkeypatch, verb):
    """What the refusals of the replicated store tier became: each verb
    of both consoles against its own package's two store servers
    (``--store-url`` twice, ``storeserver --peer``), with the same exit
    code, the same masked stdout, and the same effect on every node."""
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    sets = {}
    try:
        for pkg in ("jax", "port"):
            sets[pkg] = _ReplSet(pkg, monkeypatch, tmp_path,
                                 peers=verb == "status --store-url")
        _STORE_URL_VERBS[verb](sets, tmp_path, capsys)
    finally:
        for repl in sets.values():
            repl.close()



# -- the fleet verbs -----------------------------------------------------------

_CONSOLE_MODULES = {"jax": "predictionio_tpu.cli.main",
                    "port": "predictionio_tpu_torch.cli.main"}


@pytest.mark.parametrize("admin_key", ["", "k3y"])
def test_router_runs_alike(tmp_path, admin_key):
    """``router --replica URL#g1 [--admin-key K] --state-file F`` of each
    console as a process: the same stdout and stderr lines, a router
    status naming the replica, ``/admin/replicas`` key-gated alike, exit
    0 after SIGTERM."""
    import os
    import signal
    import subprocess

    results = {}
    for pkg, module in _CONSOLE_MODULES.items():
        port = _free_port()
        argv = [sys.executable, "-m", module, "router", "--ip", "127.0.0.1",
                "--port", str(port), "--replica", "http://127.0.0.1:1#g1",
                "--state-file", str(tmp_path / pkg / "state.json"),
                "--probe-interval", "0.2"]
        if admin_key:
            argv += ["--admin-key", admin_key]
        env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1")
        (tmp_path / pkg).mkdir()
        out_path, err_path = tmp_path / f"{pkg}.out", tmp_path / f"{pkg}.err"
        with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
            proc = subprocess.Popen(argv, env=env, stdout=out_f,
                                    stderr=err_f, text=True)
        try:
            deadline = time.monotonic() + 60
            while "listening on" not in out_path.read_text():
                assert proc.poll() is None, err_path.read_text()
                assert time.monotonic() < deadline
                time.sleep(0.05)
            base = f"http://127.0.0.1:{port}"
            with urllib.request.urlopen(base + "/", timeout=10) as resp:
                status = json.loads(resp.read())
            try:
                urllib.request.urlopen(base + "/admin/replicas", timeout=10)
                gate = 200
            except urllib.error.HTTPError as e:
                gate = e.code
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        out, err = out_path.read_text(), err_path.read_text()
        results[pkg] = (
            proc.returncode,
            [re.sub(r"\d{3,}", "<n>", ln)
             for ln in out.replace(str(tmp_path / pkg), "<dir>")
             .splitlines()],
            [ln for ln in err.splitlines() if not _LOG_LINE.match(ln)],
            (status["service"], [(r["id"], r["generation"])
                                 for r in status["replicas"]],
             status["stateFile"] if "stateFile" in status else None),
            gate,
        )
    assert results["port"] == results["jax"]
    rc, lines, err, status, gate = results["port"]
    assert rc == 0 and lines[:2] == [
        "Router is listening on <n>.0.0.1:<n>",
        "Routing across 1 replica(s)"]
    assert lines[2] == "Fleet state persisted to <dir>/state.json"
    assert status[0] == "router" and status[1] == [("r0", "g1")]
    assert gate == (401 if admin_key else 200)
    assert bool(err) == (not admin_key)  # the open-admin warning


class _Replica:
    """A warm replica-shaped server of the port's HTTP layer."""

    def __init__(self):
        from predictionio_tpu_torch.obs import MetricRegistry
        from predictionio_tpu_torch.serving import http

        self.registry = MetricRegistry()
        self.registry.gauge("pio_warmup_complete", "h").set(1.0)
        self.registry.counter("pio_batches_total", "h").inc(3)
        r = http.Router()
        r.route("GET", "/metrics.json",
                lambda req: http.Response(200, self.registry.to_dict()))
        self.server = http.HTTPServer(r, host="127.0.0.1", port=0)
        self.server.start()
        self.url = f"http://127.0.0.1:{self.server.port}"


def _fresh_router(replica):
    from predictionio_tpu_torch.obs import MetricRegistry
    from predictionio_tpu_torch.serving.router import ServingRouter

    router = ServingRouter(probe_interval_s=0.05, registry=MetricRegistry())
    router.add_replica(replica.url, replica_id="r0", generation="g7")
    server = router.serve(host="127.0.0.1", port=0)
    server.start()
    deadline = time.monotonic() + 30
    while router.replica_states() != {"r0": "healthy"}:
        assert time.monotonic() < deadline
        time.sleep(0.02)
    return router, server


@pytest.mark.parametrize("target", ["router", "not_a_router", "unreachable"])
def test_status_router_url_alike(both, target):
    """``status --router-url``: the fleet summary, fleet-health and
    federation lines (numbers masked) from a fresh router each console
    scrapes alike; a server that is not a router and a closed port fail
    alike with exit 1."""
    replica = _Replica()
    outs = {}
    try:
        for name, run in (("jax", both.jax_run), ("port", both.port_run)):
            router = server = None
            if target == "router":
                router, server = _fresh_router(replica)
                url = f"http://127.0.0.1:{server.port}"
            elif target == "not_a_router":
                url = replica.url
            else:
                url = f"http://127.0.0.1:{_free_port()}"
            try:
                code, out, err = run(("status", "--router-url", url))
            finally:
                if router is not None:
                    router.close()
                    server.shutdown()
            outs[name] = (code, [re.sub(r"[\d.]+", "<n>", ln)
                                 for ln in out.splitlines()],
                          [re.sub(r"\d+", "<n>", ln)
                           for ln in _errors(err)])
    finally:
        replica.server.shutdown()
    assert outs["port"] == outs["jax"]
    code, lines, err = outs["port"]
    if target == "router":
        assert code == 0
        assert lines[0] == ("fleet: replicas=<n> (healthy=<n>) "
                            "generation=g<n> swap=none swapsCompleted=<n>")
        assert lines[1].startswith("health: goodput=")
        assert lines[2] == "federation: replicas=r<n>"
        assert "pio_batches_total <n>" in lines
    else:
        assert code == 1 and err

def test_mesh_conf_of_the_variant_is_held_to_one_card(both, tmp_path):
    wide = _variant(tmp_path, "wide.json", {
        "id": "w", "engineFactory": "helloworld",
        "meshConf": {"shape": [2, 2], "batch": "b"}})
    code, _, err = both.port_run(("train", "--variant", wide), device=True)
    assert code == 1 and "item 9" in err
    bad = _variant(tmp_path, "bad.json", {
        "id": "w", "engineFactory": "helloworld",
        "meshConf": {"shape": "data,model"}})
    for run, kw in ((both.jax_run, {}), (both.port_run, {"device": True})):
        with pytest.raises(SystemExit, match="mesh shape"):
            run(("train", "--variant", bad), **kw)
    one = _variant(tmp_path, "one.json", {
        "id": "w", "engineFactory": "helloworld",
        "datasource": {"params": {"app_name": "hw"}},
        "meshConf": {"shape": "1,1", "batch": "from-variant"}})
    both.port_run(("app", "new", "hw"))
    app = both.port.get_meta_data_apps().get_by_name("hw")
    both.port.get_events().insert_batch([
        Event(event="report", entity_type="day", entity_id=day,
              properties={"temperature": t})
        for day, t in (("Mon", 20.0), ("Tue", 22.5), ("Mon", 21.0))
    ], app.id)
    code, out, err = both.port_run(("train", "--variant", one), device=True)
    assert code == 0, err
    (inst,) = both.port.get_meta_data_engine_instances().get_all()
    assert inst.batch == "from-variant"


@pytest.mark.parametrize("argv", [
    ["deploy", "--variant", "nope.json", "--max-batch", "0"],
    ["deploy", "--variant", "nope.json", "--max-wait-ms", "-5"],
    ["deploy", "--variant", "nope.json", "--pipeline-depth", "-1"],
    ["deploy", "--variant", "nope.json", "--tenant", "a"],
    ["deploy", "--variant", "nope.json", "--tenant", "=v"],
    ["deploy", "--variant", "nope.json", "--tenant", "a=v", "--canary"],
])
def test_deploy_flag_checks_alike(both, argv):
    both(*argv, compare_err=True)


def test_deploy_feedback_needs_an_existing_app(both):
    for run, kw in ((both.jax_run, {}), (both.port_run, {"device": True})):
        for extra in ([], ["--event-server-app", "nope"]):
            with pytest.raises(SystemExit, match="--event-server-app"):
                run(("deploy", "--variant", str(REC_VARIANT), "--feedback",
                     *extra), **kw)


# -- no card, no --device cpu ----------------------------------------------


@pytest.mark.parametrize("argv", [
    ["train", "--variant", str(REC_VARIANT)],
    ["deploy", "--variant", str(REC_VARIANT)],
    ["eval", "cli_eval_grid:port_grid"],
    ["trainer", "--app", "MyRecApp", "--variant", str(REC_VARIANT),
     "--once"],
    ["run", "fakejob:job"],
    ["shell"],
])
def test_no_cuda_and_no_device_flag_exits(monkeypatch, capsys, tmp_path,
                                          argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("PIO_TEST_EVAL_CKPT", str(tmp_path))
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    (tmp_path / "cli_eval_grid.py").write_text(_EVAL_MODULE)
    (tmp_path / "fakejob.py").write_text("def job(ctx):\n    return 1\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    storage = Storage(MEMORY)
    storage.get_meta_data_apps().insert(App(0, "MyRecApp"))
    set_storage(storage)
    try:
        assert main(argv) == 1
    finally:
        set_storage(None)
    out = capsys.readouterr()
    assert "error: ComputeContext.create: no CUDA device is available" in (
        out.err), out
    assert storage.get_meta_data_engine_instances().get_all() == []
    assert storage.get_meta_data_evaluation_instances().get_all() == []


def test_status_without_a_card_fails_compute(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    set_storage(Storage(MEMORY))
    try:
        assert main(["status"]) == 1
    finally:
        set_storage(None)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "PredictionIO-TPU 0.1.0"
    assert out[1].startswith("[ERROR] Compute: ComputeContext.create: no "
                             "CUDA device")
    assert out[2:] == ["Compute status: FAILED"]


def test_pure_http_verbs_never_import_torch(tmp_path):
    """``trace``, ``timeline``, ``profile`` and ``status --metrics-url``
    answer without loading torch (nothing listens: each exits 1)."""
    import subprocess

    port = _free_port()
    script = (
        "import sys\n"
        "from predictionio_tpu_torch.cli.main import main\n"
        f"url = 'http://127.0.0.1:{port}'\n"
        "codes = [main(['trace', '--url', url, '--out', 'x.json']),\n"
        "         main(['timeline', '--url', url]),\n"
        "         main(['profile', '--url', url, '--out', 'p']),\n"
        "         main(['status', '--metrics-url', url])]\n"
        "print(codes, 'torch' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin"})
    assert out.stdout.strip() == "[1, 1, 1, 1] False", out.stderr[-2000:]
    assert out.stderr.count("[ERROR] cannot fetch") == 4


def test_first_cuda_linalg_call_is_made_once(monkeypatch):
    """``eval`` trains its candidates in threads; the first CUDA linalg
    call of a process (torch's lazy, thread-unsafe load of its linalg
    library) is made once, under a lock, however many threads ask."""
    from predictionio_tpu_torch.parallel import mesh

    calls = []

    def first_call(a):
        calls.append(a)
        time.sleep(0.05)  # wide enough for every thread to arrive
        return a, a

    monkeypatch.setattr(mesh, "_linalg_loaded", False)
    monkeypatch.setattr(torch.linalg, "cholesky_ex", first_call)
    monkeypatch.setattr(torch, "ones", lambda *shape, device: shape)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=mesh.load_cuda_linalg,
                                    args=(torch.device("cuda", 0),))
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert calls == [(1, 1)]
    mesh.load_cuda_linalg(torch.device("cpu"))  # nothing on the CPU
    assert len(calls) == 1
