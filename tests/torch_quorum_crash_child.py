"""Kill-9 crash-test writer for the port's replicated (quorum) event path.

Connects the port's ``ReplicatedStoreClient`` to the store-server peer
URLs in argv with W equal to N and inserts events one at a time,
printing ``ACK <i> <event_id>`` — flushed — only after the W-of-N quorum
write returned. ``tests/test_torch_replicated.py`` SIGKILLs this process
mid-stream and checks that every acked event is durable on every peer.

Usage: python tests/torch_quorum_crash_child.py <hint-dir> <url> [<url> ...]
"""

from __future__ import annotations

import datetime as dt
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.storage.replicated import (  # noqa: E402
    ReplicatedStoreClient,
)

APP_ID = 1


def main() -> int:
    hint_dir, urls = sys.argv[1], sys.argv[2:]
    client = ReplicatedStoreClient({
        "URLS": ",".join(urls),
        "W": str(len(urls)),  # every ack means durable everywhere
        "HINT_DIR": hint_dir,
    })
    events = client.dao("events")
    events.init(APP_ID)
    t0 = dt.datetime(2020, 1, 1, tzinfo=dt.timezone.utc)
    i = 0
    while True:
        event_id = events.insert(Event(
            event="rate", entity_type="user", entity_id=f"u{i}",
            properties={"n": i}, event_time=t0 + dt.timedelta(seconds=i)),
            APP_ID)
        print(f"ACK {i} {event_id}", flush=True)
        i += 1


if __name__ == "__main__":
    sys.exit(main())
