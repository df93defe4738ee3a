"""The event read path: the port's data layer against the JAX package's.

The same events (made from a seed with numpy: users, items, ratings,
event times with repeats of one (user, item) pair) are inserted into
both packages' memory event stores; ``EventStore.interactions`` and the
two dedupes must give equal id maps and identical rows, columns, values
and times. Event validation, the store's filtered scans and the
unknown-app error agree too. No tolerance: all of it is exact.
"""

import datetime as dt

import numpy as np
import pytest

from predictionio_tpu.data.event import (
    Event as JaxEvent,
    EventValidationError as JaxValidationError,
)
from predictionio_tpu.data.storage import App as JaxApp, Storage as JaxStorage
from predictionio_tpu.data.store import (
    EventStore as JaxEventStore,
    EventStoreError as JaxEventStoreError,
)
from predictionio_tpu_torch.data import DataMap, PropertyMap
from predictionio_tpu_torch.data.event import Event, EventValidationError
from predictionio_tpu_torch.data.storage import App, Channel, Storage
from predictionio_tpu_torch.data.store import EventStore, EventStoreError

MEMORY = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}
T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)


def _event_rows(n=400, seed=0):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, 30, n)
    items = rng.integers(0, 25, n)
    ratings = rng.integers(1, 6, n)
    secs = rng.permutation(n) * 7  # distinct times, shuffled
    names = np.where(rng.random(n) < 0.8, "rate", "view")
    return list(zip(users, items, ratings, secs, names))


def _fill(storage, app_cls, event_cls, rows, channel=None):
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "shop"))
    events = storage.get_events()
    events.init(app_id)
    batch = [
        event_cls(
            event=str(name), entity_type="user", entity_id=f"u{u}",
            target_entity_type="item", target_entity_id=f"i{i}",
            properties={"rating": int(r)},
            event_time=T0 + dt.timedelta(seconds=int(s)),
        )
        for u, i, r, s, name in rows
    ]
    # a property event without a target: the interactions drop it
    batch.append(event_cls(event="$set", entity_type="user",
                           entity_id="u1", properties={"a": 1},
                           event_time=T0))
    events.insert_batch(batch, app_id)
    return app_id


@pytest.fixture(scope="module")
def stores():
    rows = _event_rows()
    jax_storage = JaxStorage(env=MEMORY)
    port_storage = Storage(env=MEMORY)
    _fill(jax_storage, JaxApp, JaxEvent, rows)
    _fill(port_storage, App, Event, rows)
    return JaxEventStore(jax_storage), EventStore(port_storage)


def _assert_same(got, want):
    assert list(got.entity_map.keys()) == list(want.entity_map.keys())
    assert list(got.target_map.keys()) == list(want.target_map.keys())
    for field in ("rows", "cols", "values", "times"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("dedupe", ["none", "sum", "latest"])
@pytest.mark.parametrize("value_key", ["rating", None])
def test_interactions_and_dedupe_match(stores, dedupe, value_key):
    jstore, store = stores
    kw = dict(event_names=["rate"], value_key=value_key)
    want = jstore.interactions("shop", **kw)
    got = store.interactions("shop", **kw)
    if dedupe == "sum":
        want, got = want.dedupe_sum(), got.dedupe_sum()
    elif dedupe == "latest":
        want, got = want.dedupe_latest(), got.dedupe_latest()
    assert got.nnz > 0 and got.n_rows == want.n_rows
    _assert_same(got, want)


def test_dedupe_really_merges_repeats(stores):
    _, store = stores
    inter = store.interactions("shop", event_names=["rate"],
                               value_key="rating")
    summed = inter.dedupe_sum()
    latest = inter.dedupe_latest()
    assert summed.nnz == latest.nnz < inter.nnz
    assert np.isclose(summed.values.sum(), inter.values.sum())
    pairs = set(zip(inter.rows.tolist(), inter.cols.tolist()))
    assert len(pairs) == summed.nnz


@pytest.mark.parametrize("query", [
    dict(entity_id="u3"),
    dict(event_names=["view"], limit=5),
    dict(start_time=T0 + dt.timedelta(seconds=700),
         until_time=T0 + dt.timedelta(seconds=1400)),
    dict(target_entity_type=None),
    dict(entity_id=f"u{_event_rows()[0][0]}",
         target_entity_id=f"i{_event_rows()[0][1]}", latest=False),
])
def test_find_by_entity_matches(stores, query):
    jstore, store = stores
    query = dict(query)
    entity_id = query.pop("entity_id", "u1")
    want = jstore.find_by_entity("shop", "user", entity_id, **query)
    got = store.find_by_entity("shop", "user", entity_id, **query)
    assert got and [_public(e) for e in got] == [_public(e) for e in want]


def _public(event):
    """The event's JSON without the two fields each store stamps itself
    (a random id and the insertion time)."""
    d = event.to_json_dict()
    d.pop("eventId"), d.pop("creationTime")
    return d


def test_frame_and_find_match(stores):
    jstore, store = stores
    want = jstore.frame("shop", event_names=["view", "$set"])
    got = store.frame("shop", event_names=["view", "$set"])
    for field in ("event", "entity_id", "target_entity_id", "event_time"):
        assert np.array_equal(getattr(got, field), getattr(want, field))
    assert got.properties == want.properties
    assert len(list(store.find("shop"))) == len(list(jstore.find("shop")))


def test_unknown_app_and_channel_errors(stores):
    jstore, store = stores
    with pytest.raises(JaxEventStoreError, match="app does not exist"):
        jstore.interactions("nope")
    with pytest.raises(EventStoreError, match="app does not exist"):
        store.interactions("nope")
    with pytest.raises(EventStoreError, match="Invalid channel name"):
        store.frame("shop", channel_name="missing")


def test_channels_keep_events_apart():
    storage = Storage(env=MEMORY)
    app_id = _fill(storage, App, Event, _event_rows(50, seed=1))
    channels = storage.get_meta_data_channels()
    cid = channels.insert(Channel(0, "side", app_id))
    assert channels.insert(Channel(0, "bad name!", app_id)) is None
    assert channels.insert(Channel(0, "side", app_id)) is None
    eid = storage.get_events().insert(
        Event(event="rate", entity_type="user", entity_id="x",
              target_entity_type="item", target_entity_id="y"),
        app_id, cid,
    )
    store = EventStore(storage)
    side = list(store.find("shop", channel_name="side"))
    assert [e.event_id for e in side] == [eid]
    assert storage.get_events().get(eid, app_id, cid).entity_id == "x"
    assert storage.get_events().delete(eid, app_id, cid)
    assert list(store.find("shop", channel_name="side")) == []
    assert storage.get_meta_data_apps().insert(App(0, "shop")) is None


@pytest.mark.parametrize("bad", [
    dict(event="$other"),
    dict(event="pio_x"),
    dict(entity_type="pio_user"),
    dict(entity_id=""),
    dict(target_entity_type="item"),  # without an id
    dict(event="$unset"),  # with no properties
    dict(event="$set", target_entity_type="item", target_entity_id="i"),
    dict(properties={"pio_key": 1}),
])
def test_validation_matches(bad):
    fields = dict(event="rate", entity_type="user", entity_id="u")
    fields.update(bad)
    with pytest.raises(JaxValidationError) as jerr:
        JaxEvent(**fields)
    with pytest.raises(EventValidationError) as err:
        Event(**fields)
    assert str(err.value) == str(jerr.value)


def test_event_json_round_trip_matches():
    d = {"event": "rate", "entityType": "user", "entityId": "u1",
         "targetEntityType": "item", "targetEntityId": "i2",
         "properties": {"rating": 4}, "eventTime": "2024-01-02T03:04:05Z",
         "tags": ["a"], "prId": "p"}
    got = Event.from_json_dict(d).to_json_dict()
    want = JaxEvent.from_json_dict(d).to_json_dict()
    got.pop("creationTime"), want.pop("creationTime")
    assert got == want


def test_datamap_and_property_map():
    m = DataMap({"a": 1, "b": [1, 2], "n": None})
    assert m.get_int("a") == 1 and m.get_float_list("b") == [1.0, 2.0]
    assert m.merged_with({"a": 2})["a"] == 2 and "b" not in m.without(["b"])
    with pytest.raises(KeyError):
        m.get_required("n")
    pm = PropertyMap({"x": 1}, T0, T0)
    assert pm == {"x": 1} and pm.first_updated == T0


def test_default_wiring_binds_eventdata(tmp_path):
    storage = Storage(env={"PIO_FS_BASEDIR": str(tmp_path)})
    app_id = storage.get_meta_data_apps().insert(App(0, "a"))
    storage.get_events().init(app_id)
    assert storage.get_events() is storage.get_events()
