"""Checker registry for the port's ``lint``.

Each checker is ``check(modules: list[SourceModule]) -> list[Finding]``
over the whole file set at once, so project-wide rules (lock-order
cycles, metric-label consistency) see everything.

A checker whose module sets ``PER_FILE = True`` promises that each
module's findings are a pure function of that module's text alone —
the findings cache (``analysis/cache.py``) replays those from disk for
unchanged files and only re-runs them on misses. Cross-file checkers
(lock graphs, the mesh-axis and metric-name registries) must NOT set
it.

The JAX package's ``jit_retrace`` and ``donation`` checkers are not
carried: the port has no ``torch.compile``, ``torch.jit``, CUDA graphs
or buffer donation, so they would have nothing to check.
"""

from __future__ import annotations

from predictionio_tpu_torch.analysis.checkers import (
    clock,
    device_sync,
    lifecycle,
    locks,
    races,
    sharding_spec,
    telemetry,
    threads,
    wire_contract,
)

_CHECKER_MODULES = (
    locks,
    clock,
    device_sync,
    sharding_spec,
    threads,
    races,
    telemetry,
    lifecycle,
    wire_contract,
)

ALL_CHECKERS = tuple(mod.check for mod in _CHECKER_MODULES)

#: module names whose findings are cacheable per file (see docstring);
#: derived from each checker's own PER_FILE attribute so there is one
#: source of truth — a new per-file checker only sets the flag
PER_FILE_CHECKERS = frozenset(
    mod.__name__.rsplit(".", 1)[-1]
    for mod in _CHECKER_MODULES
    if getattr(mod, "PER_FILE", False)
)
