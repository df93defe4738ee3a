"""The port's own surface under its linter, on the CPU.

``python -m predictionio_tpu_torch.cli.main lint`` from the repository
root — over ``predictionio_tpu_torch/``, ``chip_smoke.py`` and
``tests/torch_*_child.py``, with the shipped baseline — runs once, in a
process where ``torch``, ``jax`` and ``predictionio_tpu`` cannot be
imported, with no cache. Its JSON report must show 0 findings, 0
baselined, no unanalyzable file, every file of the surface, and a total
under the 30 s lint budget. Besides: the shipped baseline is empty, every
``# pio-lint:`` comment of the surface carries a ``-- reason``, the
reference's reasoned exemptions are carried to the port's copies of
their files, and the reference's explicit-path scope class runs against
the port's tree.
"""

from __future__ import annotations

import io
import json
import os
import pathlib
import re
import subprocess
import sys
import tokenize

import pytest

from predictionio_tpu_torch.analysis import load_baseline
from predictionio_tpu_torch.analysis.source import iter_python_files
from test_torch_imports import _NO_TORCH
from test_torch_lint import reference_cases

ROOT = pathlib.Path(__file__).resolve().parent.parent
BASELINE = ROOT / "predictionio_tpu_torch" / "analysis" / "lint_baseline.txt"
#: the JAX package's lint budget (its check.sh), for the whole surface
BUDGET_MS = 30_000.0


def surface() -> list[str]:
    return [str(ROOT / "predictionio_tpu_torch"), str(ROOT / "chip_smoke.py"),
            *sorted(str(p) for p in (ROOT / "tests").glob("torch_*_child.py"))]


_LINT = r"""
import runpy
sys.argv = ["pio-tpu-torch", "lint", "--no-cache", "--json"]
try:
    runpy.run_module("predictionio_tpu_torch.cli.main", run_name="__main__")
except SystemExit as e:
    code = e.code
blocked = sorted({m.split(".")[0] for m in sys.modules} & {
    "torch", "jax", "jaxlib", "predictionio_tpu"})
print(json.dumps({"exit": code, "imported": blocked}), file=sys.stderr)
"""


@pytest.fixture(scope="module")
def lint_run():
    """The console's ``lint`` from the repository root, torch, jax and
    the reference blocked: (exit code, JSON report, imported tops)."""
    assert '"torch")' in _NO_TORCH
    prelude = _NO_TORCH.split("import importlib\nfor mod")[0]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    got = subprocess.run(
        [sys.executable, "-c", prelude + "import json\n" + _LINT],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    tail = json.loads(got.stderr.strip().splitlines()[-1])
    return tail["exit"], json.loads(got.stdout), tail["imported"]


def test_the_ports_surface_lints_clean(lint_run):
    code, report, _imported = lint_run
    assert report["new"] == [], "\n".join(
        f"{f['path']}:{f['line']}: {f['rule']}: {f['message']}"
        for f in report["new"])
    assert report["baselined"] == []
    assert report["staleBaseline"] == []
    assert report["errors"] == []
    assert report["ok"] is True and code == 0
    assert report["filesChecked"] == len(iter_python_files(surface()))


def test_lint_runs_with_torch_jax_and_the_reference_blocked(lint_run):
    code, report, imported = lint_run
    assert code == 0 and report["ok"] is True
    assert imported == []


def test_whole_surface_lint_is_within_budget(lint_run):
    _code, report, _imported = lint_run
    assert report["totalMs"] < BUDGET_MS, report["timingsMs"]


def test_shipped_baseline_is_empty():
    """Every finding is fixed or suppressed with a reason at its site;
    the baseline never absorbs debt."""
    assert BASELINE.read_text().startswith("# pio-tpu lint baseline")
    assert load_baseline(str(BASELINE)) == []


_MARKER = re.compile(r"#\s*pio-lint:\s*disable")
_REASONED = re.compile(
    r"#\s*pio-lint:\s*disable(?:-next|-file)?\s*=\s*"
    r"[\w\-*,\s]+?\s+--\s+\S")


def _comments(path: str):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    for tok in tokenize.generate_tokens(io.StringIO(text).readline):
        if tok.type == tokenize.COMMENT:
            yield tok.start[0], tok.string.strip()


def test_every_inline_suppression_carries_a_reason():
    offenders, seen = [], 0
    for path in iter_python_files(surface()):
        for line, comment in _comments(path):
            if _MARKER.search(comment):
                seen += 1
                if not _REASONED.search(comment):
                    rel = os.path.relpath(path, ROOT)
                    offenders.append(f"{rel}:{line}: {comment}")
    assert offenders == []
    assert seen >= 7


def test_the_references_exemptions_are_carried():
    """Each ``# pio-lint:`` comment of a JAX module stands, word for
    word, in the port's copy of that module."""
    carried = 0
    for path in iter_python_files([str(ROOT / "predictionio_tpu")]):
        rel = os.path.relpath(path, ROOT)
        if rel.startswith(os.path.join("predictionio_tpu", "analysis")):
            continue
        port = ROOT / rel.replace("predictionio_tpu", "predictionio_tpu_torch",
                                  1)
        for _line, comment in _comments(path):
            if not _MARKER.search(comment):
                continue
            assert port.exists(), rel
            assert comment[comment.index("#"):] in port.read_text(), (
                rel, comment)
            carried += 1
    assert carried == 7


TestRefExplicitPathScope = reference_cases().TestExplicitPathScope
