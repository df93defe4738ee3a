"""Finding a cell's files by the names in ``BENCHMARK.json``.

Nothing here knows a cell, a configuration or a metric by name. A cell
(an entry of ``workloads``) names its configuration, whose ``file`` is
read as it stands, and its traffic mix, read from
``portbench/traffic/<traffic>.json``; the traffic names the window
driver, ``portbench/drivers/<driver>.py``; each metric is read by
``portbench/metrics/<name>.py``; the limits that decide ``correct`` are
``portbench/limits/<workload>.json``. A metric applies to the cells its
``workloads`` names; without that key an end-to-end metric applies to
every cell, and a per-layer one to every cell that reports the
end-to-end metric it ``moves``. A later cell, configuration, driver or
metric is therefore new files and new entries, never an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from types import ModuleType

#: the checkout's root, where ``BENCHMARK.json`` and ``portbench/`` lie
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
BETTER = ("lower", "higher")


class SpecError(ValueError):
    """``BENCHMARK.json`` or a file it names breaks the contract."""


def check_name(value, what: str) -> str:
    if not isinstance(value, str) or not NAME.fullmatch(value):
        raise SpecError(f"{what} {value!r}: a name is 1-64 of A-Z a-z 0-9 "
                        "_ . - and starts with a letter, digit or _")
    return value


def check_unit(value, what: str) -> str:
    if not isinstance(value, str) or not UNIT.fullmatch(value):
        raise SpecError(f"{what}: unit {value!r} is not 1-16 of "
                        "A-Z a-z 0-9 _ / % . -")
    return value


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    workloads: tuple[str, ...] | None  # None: every cell of its kind


@dataclasses.dataclass
class Cell:
    """One workload with everything it names, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[Metric]
    per_layer: list[Metric]
    limits: dict


def _metric(entry: dict, kind: str) -> Metric:
    name = check_name(entry.get("name"), f"{kind} metric")
    if entry.get("better") not in BETTER:
        raise SpecError(f"{name}: better must be lower or higher")
    workloads = entry.get("workloads")
    if workloads is not None:
        workloads = tuple(check_name(w, f"{name} workload")
                          for w in workloads)
    return Metric(name, check_unit(entry.get("unit"), name), workloads)


def read_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_cell(workload: str, root: str | None = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` (the checkout
    this file lies in by default), with its configuration, traffic,
    metrics and limits read from the files their names give."""
    root = root or ROOT
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    check_name(workload, "workload")
    cells = [w for w in bench["workloads"] if w.get("name") == workload]
    if len(cells) != 1:
        raise SpecError(f"workload {workload!r}: {len(cells)} entries")
    (w,) = cells
    configs = [c for c in bench["configs"]
               if c.get("name") == check_name(w["config"], "config")]
    if len(configs) != 1:
        raise SpecError(f"config {w['config']!r}: {len(configs)} entries")
    traffic = check_name(w["traffic"], "traffic")
    config = read_json(os.path.join(root, configs[0]["file"]))
    here = os.path.join(root, "portbench")
    e2e = [_metric(m, "end_to_end") for m in bench["end_to_end"]]
    layer = [_metric(m, "per_layer") for m in bench["per_layer"]]
    e2e = [m for m in e2e if m.workloads is None or workload in m.workloads]
    reported = {m.name for m in e2e}
    moves = {m["name"]: m.get("moves") for m in bench["per_layer"]}
    layer = [m for m in layer
             if (workload in m.workloads if m.workloads is not None
                 else moves[m.name] in reported)]
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=config,
        traffic=read_json(os.path.join(here, "traffic", f"{traffic}.json")),
        end_to_end=e2e,
        per_layer=layer,
        limits=read_json(os.path.join(here, "limits", f"{workload}.json")),
    )


def load_module(kind: str, name: str, root: str | None = None) -> ModuleType:
    """``portbench/<kind>/<name>.py`` as a module of its own (a metric's
    name may hold dots, so it is loaded by path, not imported)."""
    check_name(name, kind)
    path = os.path.join(root or ROOT, "portbench", kind, f"{name}.py")
    if not os.path.isfile(path):
        raise SpecError(f"no {kind} file for {name!r}: {path}")
    key = f"portbench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
