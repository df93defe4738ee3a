"""Nothing the harness loads is JAX or the JAX package, and the reference
loads nothing of the program. Checked in fresh processes by the top-level
name of every module loaded, compared whole (the port's name begins with
the JAX package's)."""

import json
import os
import subprocess
import sys

from portbench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "predictionio_tpu"}


def loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=spec.ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=spec.ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    code = "\n".join([
        "from portbench import run, readings",
        "from portbench.harness import spec",
        "bench = spec.read_json(spec.ROOT + '/BENCHMARK.json')",
        "for w in [w['name'] for w in bench['workloads']]:",
        "    cell = spec.load_cell(w)",
        "    spec.load_module('drivers', cell.traffic['driver'])",
        "    for m in cell.end_to_end + cell.per_layer:",
        "        spec.load_module('metrics', m.name)",
        "import predictionio_tpu_torch.ops.als",
        "import predictionio_tpu_torch.parallel.mesh",
    ])
    tops = loaded(code)
    assert "predictionio_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    tops = loaded("import portbench.reference.als_ref")
    assert not tops & (FORBIDDEN | {"predictionio_tpu_torch"})


def test_the_run_refuses_a_forbidden_module():
    from portbench import run

    sys.modules["jaxlib_probe_only"] = sys  # a name that merely begins so
    try:
        assert run.forbidden_modules() == []
        sys.modules["jax.numpy"] = sys
        assert run.forbidden_modules() == ["jax"]
    finally:
        sys.modules.pop("jax.numpy", None)
        sys.modules.pop("jaxlib_probe_only", None)
