"""The networked stores of both packages on the same operations.

* The storage contract cases (every metadata DAO over one script, events
  under every find filter, models) on ``postgres`` (minipg), ``mysql``
  (minimysql) and ``httpstore`` (a store server over sqlite, the event
  log and localfs): the port's storage over the port's server gives what
  the JAX package's storage gives over the JAX package's server.
* A minipg sqlite file written through one package's server is read
  through the other's, both ways.
* ``list_ids`` gives the same ids on every models backend of both
  packages (memory, sqlite, localfs, postgres, mysql, httpstore); a
  backend that cannot list answers None.
* Events → ``run_train(device="cpu")`` → served answers: each package
  trains from one shared iteration-0 checkpoint with its events and
  generations on minipg, and on a store server, and both engine servers'
  ``/queries.json`` answers name the same items in the same order.
"""

from __future__ import annotations

import contextlib

import pytest

from predictionio_tpu.data.storage import Model as JaxModel
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage import set_storage as jax_set_storage
from predictionio_tpu.data.storage.minimysql import (
    MiniMySQLServer as JaxMiniMySQL,
)
from predictionio_tpu.data.storage.minipg import MiniPGServer as JaxMiniPG
from predictionio_tpu.models.recommendation import (
    recommendation_engine as jax_engine,
)
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.serving.store_server import (
    create_store_server as jax_create_store_server,
)
from predictionio_tpu_torch.data.storage import Model, Storage, set_storage
from predictionio_tpu_torch.data.storage.base import ModelsBackend
from predictionio_tpu_torch.data.storage.minimysql import MiniMySQLServer
from predictionio_tpu_torch.data.storage.minipg import MiniPGServer
from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.models.recommendation import recommendation_engine
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.serving.store_server import create_store_server
from test_torch_storage import (
    FILTERS,
    JAX,
    PORT,
    _assert_same_events,
    _event_rows,
    _metadata_dump,
    _metadata_ops,
)
from test_torch_train import (
    N_EVENTS,
    VARIANT,
    _assert_served_alike,
    _events,
    _start_checkpoint,
)

KINDS = ("postgres", "mysql", "httpstore")
_DEV = {
    "jax": {"postgres": JaxMiniPG, "mysql": JaxMiniMySQL,
            "httpstore": (jax_create_store_server, JaxStorage)},
    "port": {"postgres": MiniPGServer, "mysql": MiniMySQLServer,
             "httpstore": (create_store_server, Storage)},
}


def _own_env(base) -> dict:
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(base / "pio.sqlite"),
        "PIO_STORAGE_SOURCES_LOG_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_LOG_PATH": str(base / "eventlog"),
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(base / "models"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    }


@contextlib.contextmanager
def _dev_store(pkg: str, kind: str, base):
    """One package's dev server for ``kind``, running; yields the
    ``PIO_STORAGE_*`` env that names it for every repository."""
    base.mkdir(parents=True, exist_ok=True)
    dev = _DEV[pkg][kind]
    env = {"PIO_STORAGE_SOURCES_NET_TYPE": kind}
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "NET"
    if kind == "httpstore":
        create, storage_cls = dev
        server = create(host="127.0.0.1", port=0,
                        storage=storage_cls(env=_own_env(base)))
        server.start()
        env["PIO_STORAGE_SOURCES_NET_URL"] = f"http://127.0.0.1:{server.port}"
        try:
            yield env
        finally:
            server.shutdown()
        return
    scheme = "postgresql" if kind == "postgres" else "mysql"
    with dev(path=str(base / "dev.db"), password="pio") as server:
        env["PIO_STORAGE_SOURCES_NET_URL"] = (
            f"{scheme}://pio:pio@127.0.0.1:{server.port}/pio")
        yield env


def _fill(pkg, env):
    storage = pkg["Storage"](env=env)
    app_id = storage.get_meta_data_apps().insert(pkg["App"](0, "shop"))
    events = storage.get_events()
    events.init(app_id)
    made = [pkg["Event"](**r) for r in _event_rows(60, seed=9)]
    events.insert_batch(made[:30], app_id)
    for e in made[30:]:
        events.insert(e, app_id)
    return storage, app_id


@pytest.mark.parametrize("kind", KINDS)
def test_the_storage_contract_matches_jax(tmp_path, kind):
    with _dev_store("jax", kind, tmp_path / "jax") as jenv, \
            _dev_store("port", kind, tmp_path / "port") as penv:
        jax, port = JaxStorage(env=jenv), Storage(env=penv)
        assert _metadata_ops(PORT, port) == _metadata_ops(JAX, jax)
        assert _metadata_dump(port) == _metadata_dump(jax)
        (jax, japp), (port, papp) = _fill(JAX, jenv), _fill(PORT, penv)
        for case, kw in FILTERS.items():
            _assert_same_events(list(port.get_events().find(papp, **kw)),
                                list(jax.get_events().find(japp, **kw)))
        for eid in ("ev0003", "ev0040", "nope"):
            assert port.get_events().delete(eid, papp) == (
                jax.get_events().delete(eid, japp))
        _assert_same_events(list(port.get_events().find(papp)),
                            list(jax.get_events().find(japp)))
        for storage, model in ((jax, JaxModel), (port, Model)):
            models = storage.get_model_data_models()
            models.insert(model("g/1", bytes(range(256))))
            models.insert(model("g2", b""))
        pm, jm = (s.get_model_data_models() for s in (port, jax))
        assert [pm.get(i).models for i in ("g/1", "g2")] == [
            jm.get(i).models for i in ("g/1", "g2")]
        assert pm.get("absent") is jm.get("absent") is None
        assert pm.delete("g2") == jm.delete("g2") is True


@pytest.mark.parametrize("writer, reader", [("port", "jax"),
                                            ("jax", "port")])
def test_a_minipg_file_reads_through_the_other_package(tmp_path, writer,
                                                       reader):
    """Metadata, events and a model written through one package's
    minipg into its sqlite file read back through the other package's
    minipg on the same file."""
    pkgs = {"jax": JAX, "port": PORT}
    with _dev_store(writer, "postgres", tmp_path) as env:
        want_meta = _metadata_ops(pkgs[writer],
                                  pkgs[writer]["Storage"](env=env))
        written, app_id = _fill(pkgs[writer], env)
        want = list(written.get_events().find(app_id))
        written.get_model_data_models().insert(
            (JaxModel if writer == "jax" else Model)("g", b"\x00\xffmodel"))
    with _dev_store(reader, "postgres", tmp_path) as env:
        read = pkgs[reader]["Storage"](env=env)
        _assert_same_events(list(read.get_events().find(app_id)), want)
        assert read.get_model_data_models().get("g").models == (
            b"\x00\xffmodel")
        assert read.get_meta_data_apps().get_by_name("shop").id == app_id
        assert len(want_meta) > 50
        assert _metadata_dump(read) == _metadata_dump(
            pkgs[writer]["Storage"](env=env))


@pytest.mark.parametrize("kind", ["memory", "sqlite", "localfs", *KINDS])
def test_list_ids_is_the_same_on_every_backend(tmp_path, kind):
    ids = ["gen1", "gen1.manifest", "a-b_c", "0"]
    got = {}
    for pkg, storage_cls, model in (("jax", JaxStorage, JaxModel),
                                    ("port", Storage, Model)):
        base = tmp_path / pkg
        if kind in KINDS:
            cm = _dev_store(pkg, kind, base)
        else:
            base.mkdir()
            cm = contextlib.nullcontext({
                "PIO_STORAGE_SOURCES_M_TYPE": kind,
                "PIO_STORAGE_SOURCES_M_PATH": str(
                    base / ("pio.sqlite" if kind == "sqlite" else "models")),
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
            })
        with cm as env:
            models = storage_cls(env=env).get_model_data_models()
            assert models.list_ids() == []
            for i in ids:
                models.insert(model(i, i.encode()))
            models.delete("0")
            got[pkg] = models.list_ids()
    assert got["port"] == got["jax"] == sorted(ids[:3])


def test_a_backend_that_cannot_list_answers_none():
    class Plain(ModelsBackend):
        def insert(self, model):
            pass

        def get(self, model_id):
            return None

        def delete(self, model_id):
            return False

    assert Plain().list_ids() is None


# -- events → trained → served, over the networked stores ---------------------


def _trained_on(pkg: str, kind: str, base, ckpt) -> tuple:
    """One package's run_train on the shared events, with its events and
    generation on its own ``kind`` dev store; returns (storage, id)."""
    stack = contextlib.ExitStack()
    env = stack.enter_context(_dev_store(pkg, kind, base))
    kw = dict(checkpoint_dir=str(ckpt), resume=True)
    if pkg == "jax":
        storage = JaxStorage(env=env)
        app_id = storage.get_meta_data_apps().insert(JAX["App"](0, "shop"))
        storage.get_events().init(app_id)
        storage.get_events().insert_batch(_events(JAX["Event"]), app_id)
        engine = jax_engine()
        jax_set_storage(storage)
        try:
            iid = jax_run_train(engine, engine.params_from_variant(VARIANT),
                                "rec", storage=storage, **kw)
        finally:
            jax_set_storage(None)
    else:
        storage = Storage(env=env)
        app_id = storage.get_meta_data_apps().insert(PORT["App"](0, "shop"))
        storage.get_events().init(app_id)
        storage.get_events().insert_batch(_events(PORT["Event"]), app_id)
        engine = recommendation_engine()
        set_storage(storage)
        try:
            iid = run_train(engine, engine.params_from_variant(VARIANT),
                            "rec", ctx=ComputeContext.create(device="cpu"),
                            storage=storage, watermark={"events": N_EVENTS},
                            **kw)
        finally:
            set_storage(None)
    return stack, storage, iid


@pytest.mark.parametrize("kind", ["postgres", "httpstore"])
def test_events_trained_and_served_alike_over_the_store(tmp_path, kind):
    events = _events(PORT["Event"])
    ckpt = tmp_path / "ckpt"
    _start_checkpoint(ckpt, len({e.entity_id for e in events}),
                      len({e.target_entity_id for e in events}))
    jax_stack, jax_storage, jax_id = _trained_on("jax", kind,
                                                 tmp_path / "jax", ckpt)
    port_stack, storage, port_id = _trained_on("port", kind,
                                               tmp_path / "port", ckpt)
    with jax_stack, port_stack:
        assert storage.get_meta_data_engine_instances().get(
            port_id).status == "COMPLETED"
        _assert_served_alike(jax_storage, jax_id, storage, port_id,
                             sorted({e.entity_id for e in events}),
                             ComputeContext.create(device="cpu"))
