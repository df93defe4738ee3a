"""App / access-key command logic shared by the console and the admin
server.

Counterpart of ``predictionio_tpu/cli/commands.py`` over the port's
``Storage``, with the same errors and the same rollback of a half-made
app (reference console/App.scala:32-538 + admin/CommandClient.scala:
64-174).
"""

from __future__ import annotations

from predictionio_tpu_torch.data.storage import (
    AccessKey,
    App,
    Channel,
    Storage,
    get_storage,
)


class CommandError(RuntimeError):
    pass


def create_app(
    name: str,
    description: str | None = None,
    access_key: str = "",
    storage: Storage | None = None,
) -> dict:
    """Insert app → init event store → create access key, rolling the app
    back if event-store init fails (reference App.scala:32-93)."""
    storage = storage or get_storage()
    apps = storage.get_meta_data_apps()
    if apps.get_by_name(name) is not None:
        raise CommandError(f"App {name!r} already exists.")
    app_id = apps.insert(App(id=0, name=name, description=description))
    if app_id is None:
        raise CommandError(f"Unable to create app {name!r}.")
    try:
        if not storage.get_events().init(app_id):
            raise CommandError("Unable to initialize the event store.")
        key = storage.get_meta_data_access_keys().insert(
            AccessKey(key=access_key, appid=app_id)
        )
        if key is None:
            raise CommandError("Unable to create an access key.")
    except Exception:
        apps.delete(app_id)  # rollback (reference App.scala:73-86)
        raise
    return {"app_id": app_id, "access_key": key}


def _app(name: str, storage: Storage) -> App:
    app = storage.get_meta_data_apps().get_by_name(name)
    if app is None:
        raise CommandError(f"App {name!r} does not exist.")
    return app


def show_app(name: str, storage: Storage | None = None) -> dict:
    storage = storage or get_storage()
    app = _app(name, storage)
    keys = storage.get_meta_data_access_keys().get_by_app_id(app.id)
    channels = storage.get_meta_data_channels().get_by_app_id(app.id)
    return {
        "name": app.name,
        "id": app.id,
        "description": app.description,
        "accessKeys": [
            {"key": k.key, "events": list(k.events)} for k in keys
        ],
        "channels": [{"id": c.id, "name": c.name} for c in channels],
    }


def delete_app(name: str, storage: Storage | None = None) -> None:
    """Remove events (all channels), access keys, channels, app record."""
    storage = storage or get_storage()
    app = _app(name, storage)
    events = storage.get_events()
    channels = storage.get_meta_data_channels()
    for ch in channels.get_by_app_id(app.id):
        events.remove(app.id, ch.id)
        channels.delete(ch.id)
    events.remove(app.id)
    keys = storage.get_meta_data_access_keys()
    for k in keys.get_by_app_id(app.id):
        keys.delete(k.key)
    storage.get_meta_data_apps().delete(app.id)


def delete_app_data(
    name: str, channel: str | None = None, storage: Storage | None = None
) -> None:
    """Drop + re-init the event store (reference ``pio app data-delete``)."""
    storage = storage or get_storage()
    app = _app(name, storage)
    events = storage.get_events()
    channel_id = None
    if channel is not None:
        channel_id = _channel_id(app, channel, storage)
    events.remove(app.id, channel_id)
    events.init(app.id, channel_id)


def _channel_id(app: App, channel: str, storage: Storage) -> int:
    for ch in storage.get_meta_data_channels().get_by_app_id(app.id):
        if ch.name == channel:
            return ch.id
    raise CommandError(
        f"Channel {channel!r} does not exist in app {app.name!r}."
    )


def create_channel(
    app_name: str, channel: str, storage: Storage | None = None
) -> int:
    storage = storage or get_storage()
    app = _app(app_name, storage)
    if not Channel.is_valid_name(channel):
        raise CommandError(
            f"{channel!r} is not a valid channel name "
            "(1-16 alphanumeric/-/_ characters)."
        )
    cid = storage.get_meta_data_channels().insert(
        Channel(id=0, name=channel, appid=app.id)
    )
    if cid is None:
        raise CommandError(f"Unable to create channel {channel!r}.")
    if not storage.get_events().init(app.id, cid):
        storage.get_meta_data_channels().delete(cid)
        raise CommandError("Unable to initialize the channel event store.")
    return cid


def delete_channel(
    app_name: str, channel: str, storage: Storage | None = None
) -> None:
    storage = storage or get_storage()
    app = _app(app_name, storage)
    cid = _channel_id(app, channel, storage)
    storage.get_events().remove(app.id, cid)
    storage.get_meta_data_channels().delete(cid)


def new_access_key(
    app_name: str,
    events: tuple[str, ...] = (),
    storage: Storage | None = None,
) -> str:
    storage = storage or get_storage()
    app = _app(app_name, storage)
    key = storage.get_meta_data_access_keys().insert(
        AccessKey(key="", appid=app.id, events=events)
    )
    if key is None:
        raise CommandError("Unable to create access key.")
    return key
