"""Event interchange files across the two packages.

The same events (ids, times with their offsets, tags, prId, properties,
made from a seed with numpy) go into each package's memory store; each
package's ``export`` writes them, and

* the JSON-lines files are byte-equal;
* an npz written by either package reads back in the other with every
  field equal (the on-disk layout is one format);
* ``export`` → ``import`` through the port's console reproduces every
  field but the backend-assigned id;
* a foreign npz and an npz of another format version are refused, as
  ``tests/test_cli.py::TestBuildTrainExportImport::
  test_eventfile_rejects_foreign_npz`` holds for the JAX package.
"""

import datetime as dt

import numpy as np
import pytest

from predictionio_tpu.cli.main import main as jax_main
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.eventfile import (
    read_events_npz as jax_read,
    write_events_npz as jax_write,
)
from predictionio_tpu.data.storage import (
    App as JaxApp,
    Storage as JaxStorage,
    set_storage as jax_set_storage,
)
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.eventfile import (
    FORMAT_VERSION,
    read_events_npz,
    write_events_npz,
)
from predictionio_tpu_torch.data.storage import App, Storage, set_storage
from predictionio_tpu_torch.utils.npzio import atomic_savez

MEMORY = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}
FIELDS = ("event", "entity_type", "entity_id", "target_entity_type",
          "target_entity_id", "event_time", "creation_time", "tags",
          "pr_id", "event_id")


def _events(event_cls, n=40):
    rng = np.random.default_rng(7)
    base = dt.datetime(2026, 3, 1, 12, tzinfo=dt.timezone.utc)
    out = []
    for i in range(n):
        tz = dt.timezone(dt.timedelta(hours=int(rng.integers(-5, 6))))
        kind = i % 3
        out.append(event_cls(
            event=("rate", "$set", "view")[kind],
            entity_type="user",
            entity_id=f"u{int(rng.integers(0, 9))}",
            target_entity_type=None if kind == 1 else "item",
            target_entity_id=None if kind == 1 else f"i{int(rng.integers(0, 5))}",
            properties=(
                {"rating": int(rng.integers(1, 6))} if kind == 0
                else {"plan": ["a", "b"][i % 2], "w": float(rng.random())}
                if kind == 1 else {}
            ),
            event_time=(base + dt.timedelta(
                seconds=int(rng.integers(0, 10**6)))).astimezone(tz),
            creation_time=base + dt.timedelta(seconds=i),
            tags=("t1", "t2")[: i % 3],
            pr_id=f"pr{i}" if i % 4 == 0 else None,
            event_id=f"{i:032x}",
        ))
    return out


def _fields(e):
    return tuple(getattr(e, f) for f in FIELDS) + (e.properties.to_dict(),)


def _exported(run, set_default, storage, app_cls, events, out_path):
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "files"))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch(events, app_id)
    set_default(storage)
    try:
        assert run(["export", "--appname", "files",
                    "--output", str(out_path)]) == 0
    finally:
        set_default(None)


def test_json_lines_exports_are_byte_equal(tmp_path, capsys):
    _exported(jax_main, jax_set_storage, JaxStorage(MEMORY), JaxApp,
              _events(JaxEvent), tmp_path / "jax.jsonl")
    _exported(main, set_storage, Storage(MEMORY), App, _events(Event),
              tmp_path / "port.jsonl")
    out = capsys.readouterr().out.splitlines()
    assert out == [f"Exported 40 events to {tmp_path / 'jax.jsonl'}.",
                   f"Exported 40 events to {tmp_path / 'port.jsonl'}."]
    jax_bytes = (tmp_path / "jax.jsonl").read_bytes()
    assert jax_bytes and jax_bytes == (tmp_path / "port.jsonl").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_reads_across_packages(tmp_path, writer):
    path = str(tmp_path / "events.npz")
    if writer == "jax":
        assert jax_write(_events(JaxEvent), path) == 40
        got = list(read_events_npz(path))
    else:
        assert write_events_npz(_events(Event), path) == 40
        got = list(jax_read(path))
    want = _events(Event)
    assert [_fields(e) for e in got] == [_fields(e) for e in want]
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            ("format_version", "properties") + FIELDS)


def test_console_npz_round_trip(tmp_path, capsys):
    storage = Storage(MEMORY)
    _exported(main, set_storage, storage, App, _events(Event),
              tmp_path / "events.npz")
    set_storage(storage)
    try:
        assert main(["app", "new", "copy"]) == 0
        assert main(["import", "--appname", "copy",
                     "--input", str(tmp_path / "events.npz")]) == 0
    finally:
        set_storage(None)
    assert capsys.readouterr().out.splitlines()[-1] == "Imported 40 events."
    copy_id = storage.get_meta_data_apps().get_by_name("copy").id
    copied = list(storage.get_events().find(copy_id))
    strip = lambda e: _fields(e)[:-2] + (_fields(e)[-1],)  # noqa: E731
    assert sorted(map(strip, copied), key=repr) == sorted(
        map(strip, _events(Event)), key=repr)


def test_rejects_foreign_npz(tmp_path):
    bad = tmp_path / "other.npz"
    np.savez(bad, x=np.arange(3))
    with pytest.raises(ValueError, match="not an event export"):
        list(read_events_npz(str(bad)))
    newer = str(tmp_path / "newer.npz")
    atomic_savez(newer, format_version=np.asarray([FORMAT_VERSION + 1]))
    for read in (read_events_npz, jax_read):
        with pytest.raises(ValueError, match="unsupported event-file"):
            list(read(newer))
