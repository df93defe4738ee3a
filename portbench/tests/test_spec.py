"""``BENCHMARK.json`` keeps to the contract's shape, and the loader finds
a new cell, configuration, traffic, driver or metric by its name alone:
new files and entries, no edit."""

import json
import os
import re
import shutil

import pytest

from portbench.harness import spec

ROOT = spec.ROOT
BENCH = spec.read_json(os.path.join(ROOT, "BENCHMARK.json"))
LINE = re.compile(r"[^\t\n]{1,200}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.fullmatch(p) and ".." not in p for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert all(LINE.fullmatch(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.add(spec.check_name(c["name"], "config"))
        assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert spec.read_json(os.path.join(ROOT, c["file"]))["name"] \
            == c["name"]
        assert len(c["reduced"]) <= 16
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        spec.check_name(w["name"], "workload")
        assert w["config"] in names and w["chips"] in (1, 4)
        assert LINE.fullmatch(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and LINE.fullmatch(m["layer"])
    every = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    assert len({m["name"] for m in every}) == len(every)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    cell = spec.load_cell(workload)
    spec.load_module("drivers", cell.traffic["driver"])
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.load_module("metrics", m.name).read)
    assert {m.name for m in cell.end_to_end} >= {"setup_s"}
    assert cell.per_layer
    assert set(cell.limits) == {"res_users", "res_items"}


def _tree(tmp_path):
    """A copy of the benchmark's files in a fresh checkout."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    return tmp_path


def test_new_files_are_found_without_an_edit(tmp_path):
    root = _tree(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    old = json.dumps({k: bench[k] for k in ("end_to_end", "per_layer")})
    cfg = spec.read_json(os.path.join(ROOT, bench["configs"][0]["file"]))
    (root / "portbench/configs/extra-cfg.json").write_text(
        json.dumps(dict(cfg, name="extra-cfg", rank=64)))
    (root / "portbench/traffic/extra-mix.json").write_text(json.dumps(
        {"driver": "extra_driver", "value_max": 9}))
    (root / "portbench/drivers/extra_driver.py").write_text(
        "def run(*a, **k):\n    return 'ran'\n")
    (root / "portbench/metrics/extra.metric_ms.py").write_text(
        "def read(run):\n    return 1.5\n")
    for cell in ("extra-cell", "extra-als"):
        (root / f"portbench/limits/{cell}.json").write_text(
            json.dumps({"res_users": 1.0}))
    bench["configs"].append({"name": "extra-cfg", "source": "x",
                             "file": "portbench/configs/extra-cfg.json",
                             "reduced": [], "why": "x"})
    # a cell of the ALS driver on the new configuration, and a cell of a
    # new driver with a per-layer metric of its own
    bench["workloads"] += [
        {"name": "extra-als", "config": "extra-cfg",
         "traffic": BENCH["workloads"][0]["traffic"], "chips": 1,
         "why": "x"},
        {"name": "extra-cell", "config": "extra-cfg", "traffic": "extra-mix",
         "chips": 1, "why": "x"}]
    bench["per_layer"].append({"name": "extra.metric_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "x", "moves": "train_ratings_per_s",
                               "workloads": ["extra-cell"]})
    # no entry that was there changed: only entries were added
    assert json.dumps({k: bench[k][:len(BENCH[k])] for k in
                       ("end_to_end", "per_layer")}) == old
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    als = spec.load_cell("extra-als", root=str(root))
    first = spec.load_cell(BENCH["workloads"][0]["name"], root=str(root))
    assert als.config["rank"] == 64
    assert [m.name for m in als.end_to_end] \
        == [m.name for m in first.end_to_end]
    assert [m.name for m in als.per_layer] \
        == [m["name"] for m in BENCH["per_layer"]]
    cell = spec.load_cell("extra-cell", root=str(root))
    assert cell.traffic["value_max"] == 9
    assert spec.load_module("drivers", "extra_driver", str(root)).run() \
        == "ran"
    assert [m.name for m in cell.per_layer][-1] == "extra.metric_ms"
    assert spec.load_module("metrics", "extra.metric_ms",
                            str(root)).read(None) == 1.5
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p


@pytest.mark.parametrize("name", ["", "a b", "x/y", "-lead", "a,b",
                                  "µs", "é", "n" * 65])
def test_bad_names_are_refused(name):
    with pytest.raises(spec.SpecError):
        spec.check_name(name, "name")


@pytest.mark.parametrize("unit", ["", "tokens per second", "µs",
                                  "u" * 17, "a\tb"])
def test_bad_units_are_refused(unit):
    with pytest.raises(spec.SpecError):
        spec.check_unit(unit, "metric")


def test_loader_refuses_a_bad_metric_entry(tmp_path):
    root = _tree(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"][0]["unit"] = "per second"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(spec.SpecError):
        spec.load_cell(BENCH["workloads"][0]["name"], root=str(root))
    with pytest.raises(spec.SpecError):
        spec.load_module("metrics", "../run", str(root))
