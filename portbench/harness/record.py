"""What one run leaves for the metric readers."""

from __future__ import annotations

import dataclasses

from portbench.harness.trace import Trace


@dataclasses.dataclass
class Run:
    """A driver's account of one run.

    ``steps`` and ``window_s`` are the measured window's (untraced, host
    clock, from the first enqueue to the closing synchronize); ``work``
    holds one step's useful ``flops``, ``bytes`` and the units the rate
    counts, from the configuration's shapes; ``spans`` are host-clock
    seconds of set-up stages and of the judge; ``trace`` is the traced window's summary
    (``--trace 1`` only); ``checks`` map each compared number's name to
    ``[value, limit]``."""

    config: dict
    device_kind: str
    setup_s: float
    spans: dict
    steps: int
    window_s: float
    work: dict
    peaks: dict | None
    trace: Trace | None
    memory_peak_bytes: int
    checks: dict
    attempted: int
    failed: int
