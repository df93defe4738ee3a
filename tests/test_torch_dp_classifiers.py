"""Data-parallel classifiers (ROADMAP item 9a): the classification,
textclassification and leadscoring templates with their rows placed over
the mesh's ``data`` axis, the port against the JAX package.

The JAX preparators call ``ctx.shard_rows`` and GSPMD reduces the fits;
the port's preparators call it too, and each fit sums its per-block
partials on the home device in block order (``sum_over_data``). Inputs
are made from numpy seeds and handed to both packages' preparators.

* Meshes: the JAX package on its default (8, 1) mesh of the 8 virtual
  CPU devices and on (4, 2); the port on CPU meshes (8, 1), (4, 2) and
  (1, 1), each held against both JAX runs.
* Row counts: 37 (not a multiple of 8) and 5 (fewer rows than devices,
  so most blocks are padding).
* Tolerances: naive Bayes ``pi``/``theta``, the lead weights and bias
  within 1e-5 relative + 1e-6 absolute; the class counts exactly equal;
  the answers (labels, the lead's ``converted``) equal.
* ``pio_mesh_pad_rows_total`` grows by what the JAX package's grows.
* Across processes: 2 ``gloo`` ranks (``DP_CHILD`` below, a process a
  rank, the pattern of ``tests/distributed_child.py``) train
  classification and leadscoring on a (2, 1) and a (4, 1) mesh; rank 0's
  tables equal the one-process run on the same mesh within the same
  tolerance.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.models import classification as jclf
from predictionio_tpu.models import leadscoring as jlead
from predictionio_tpu.models import textclassification as jtext
from predictionio_tpu.obs import get_registry as jax_registry
from predictionio_tpu.parallel.mesh import ComputeContext as JaxContext
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu_torch.models import classification as clf
from predictionio_tpu_torch.models import leadscoring as lead
from predictionio_tpu_torch.models import textclassification as text
from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.ops import naive_bayes as nb
from predictionio_tpu_torch.parallel.distributed import launch_processes
from predictionio_tpu_torch.parallel.mesh import ComputeContext, ShardedTensor
from predictionio_tpu_torch.utils.bimap import BiMap

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TOL = dict(rtol=1e-5, atol=1e-6)
PAD_HELP = ("Phantom rows added when padding arrays to a mesh-axis "
            "multiple (shard_rows / sharded factor staging)")
PORT_MESHES = [(8, 1), (4, 2), (1, 1)]
JAX_MESHES = [(8, 1), (4, 2)]
ROWS = [37, 5]
LEAD_STEPS = 200
WORDS = ("win free prize money claim offer meeting agenda review report "
         "match goal score team recipe bake flour oven").split()


def _clf_data(n, seed=1):
    rng = np.random.default_rng(seed)
    y = np.arange(n) % 3
    rng.shuffle(y)
    x = (rng.random((n, 4)) * 3 + np.eye(3, 4)[y] * 5).astype(np.float32)
    return x, y.astype(np.int32), [f"c{c}" for c in range(3)]


def _text_data(n, seed=2):
    rng = np.random.default_rng(seed)
    labels = [f"t{i % 3}" for i in range(n)]
    texts = [" ".join(WORDS[int(j)] for j in rng.integers(
        6 * (i % 3), 6 * (i % 3) + 6, int(rng.integers(3, 9))))
        for i in range(n)]
    return texts, labels


def _lead_data(n, seed=3):
    rng = np.random.default_rng(seed)
    y = (np.arange(n) % 2).astype(np.float32)
    x = (rng.normal(0, 2, (n, 3)) + y[:, None] * 4).astype(np.float32)
    return x, y


def _train(pkg, name, ctx, n):
    """Prepare and train ``name`` on ``n`` seeded rows in package
    ``pkg``: ``(prepared, model)``."""
    if name == "classification":
        mod = jclf if pkg == "jax" else clf
        bimap = JaxBiMap if pkg == "jax" else BiMap
        x, y, keys = _clf_data(n)
        td = mod.ClassificationTrainingData(
            x=x, y=y, label_map=bimap.string_int(keys))
        prep = mod.ClassificationPreparator().prepare(ctx, td)
        return prep, mod.NaiveBayesAlgorithm().train(ctx, prep)
    if name == "textclassification":
        mod = jtext if pkg == "jax" else text
        texts, labels = _text_data(n)
        td = mod.TextTrainingData(texts=texts, labels=labels)
        prep = mod.TextPreparator(mod.TextPreparatorParams(
            n_features=64)).prepare(ctx, td)
        return prep, mod.TextNBAlgorithm().train(ctx, prep)
    mod = jlead if pkg == "jax" else lead
    x, y = _lead_data(n)
    td = mod.LeadTrainingData(x=x, y=y)
    prep = mod.LeadPreparator().prepare(ctx, td)
    return prep, mod.LeadScoringAlgorithm(mod.LeadScoringParams(
        steps=LEAD_STEPS)).train(ctx, prep)


def _jax_class_counts(prep, n_classes):
    onehot = jax.nn.one_hot(prep.y, n_classes) * prep.mask[:, None]
    return np.asarray(onehot.sum(axis=0))


def _queries(name, n):
    if name == "classification":
        return [{"features": row.tolist()} for row in _clf_data(n, 9)[0]]
    if name == "textclassification":
        return [{"text": t} for t in _text_data(n, 9)[0]]
    return [{"features": row.tolist()} for row in _lead_data(n, 9)[0]]


def _held_alike(name, prep, model, jprep, jmodel):
    """The port's tables, counts and answers against one JAX run."""
    if name == "leadscoring":
        np.testing.assert_allclose(model.w, np.asarray(jmodel.w), **TOL)
        np.testing.assert_allclose(model.b, jmodel.b, **TOL)
        got = lead.LeadScoringAlgorithm().batch_predict(model, _queries(
            name, 16))
        want = jlead.LeadScoringAlgorithm().batch_predict(jmodel, _queries(
            name, 16))
        assert [g["converted"] for g in got] == [w["converted"] for w in want]
        return
    if name == "classification":
        tables, jtables = model.nb, jmodel.nb
        algo, jalgo = clf.NaiveBayesAlgorithm(), jclf.NaiveBayesAlgorithm()
        n_classes = prep.n_classes
    else:
        tables, jtables = model.nb_model, jmodel.nb_model
        algo, jalgo = text.TextNBAlgorithm(), jtext.TextNBAlgorithm()
        n_classes = len(prep.label_map)
    np.testing.assert_allclose(tables.pi.numpy(), np.asarray(jtables.pi),
                               **TOL)
    np.testing.assert_allclose(tables.theta.numpy(),
                               np.asarray(jtables.theta), **TOL)
    counts, _sums = nb.class_sums(prep.x, prep.y, n_classes, prep.mask)
    np.testing.assert_array_equal(counts.numpy(),
                                  _jax_class_counts(jprep, n_classes))
    queries = _queries(name, 16)
    got = [algo.predict(model, q)["label"] for q in queries]
    assert got == [jalgo.predict(jmodel, q)["label"] for q in queries]
    batch = algo.batch_predict(model, queries)
    assert [b["label"] for b in batch] == got


@pytest.fixture(scope="module")
def jax_runs():
    """Each template's JAX run per mesh and row count, with the growth
    of its ``pio_mesh_pad_rows_total``."""
    counter = jax_registry().counter("pio_mesh_pad_rows_total", PAD_HELP)
    out = {}
    for name in ("classification", "textclassification", "leadscoring"):
        for n in ROWS:
            for shape in JAX_MESHES:
                before = counter.value
                jprep, jmodel = _train("jax", name, JaxContext.create(
                    mesh_shape=shape), n)
                out[name, n, shape] = (jprep, jmodel,
                                       counter.value - before)
    return out


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("mesh", PORT_MESHES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("name", ["classification", "textclassification",
                                  "leadscoring"])
def test_port_mesh_matches_jax(jax_runs, name, mesh, n):
    counter = get_registry().counter("pio_mesh_pad_rows_total", PAD_HELP)
    before = counter.value
    ctx = ComputeContext.create(device="cpu", mesh_shape=mesh)
    prep, model = _train("torch", name, ctx, n)
    assert isinstance(prep.x, ShardedTensor)
    blocks = prep.x.row_shards()
    assert len(blocks) == mesh[0]
    pad = (-n) % mesh[0]
    assert prep.x.shape[0] == n + pad
    # three placements (x, y, mask), each padded to the data multiple
    assert counter.value - before == 3 * pad
    for shape in JAX_MESHES:
        jprep, jmodel, jpad = jax_runs[name, n, shape]
        if shape[0] == mesh[0]:
            assert counter.value - before == jpad
        _held_alike(name, prep, model, jprep, jmodel)


def test_sum_over_data_adds_blocks_in_order():
    """Each row block once (the lowest position holding it computes it),
    added in block order: the same floats as a loop over the blocks."""
    ctx = ComputeContext.create(device="cpu", mesh_shape=(4, 2))
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((12, 3)) * 1e4).astype(np.float32)
    placed = ctx.shard_rows(x)
    from predictionio_tpu_torch.parallel.mesh import sum_over_data

    calls = []

    def block(xb):
        calls.append(xb.data_ptr())
        return xb.sum(dim=0), xb.shape[0] * torch.ones(())

    total, rows = sum_over_data(block, placed)
    assert len(calls) == 4 and rows.item() == 12
    want = torch.from_numpy(x[0:3]).sum(dim=0)
    for i in range(1, 4):
        want = want + torch.from_numpy(x[3 * i:3 * i + 3]).sum(dim=0)
    assert torch.equal(total, want)
    # a plain tensor is one block
    assert torch.equal(sum_over_data(lambda t: t.sum(dim=0),
                                     torch.from_numpy(x)),
                       torch.from_numpy(x).sum(dim=0))
    with pytest.raises(ValueError, match="split alike"):
        sum_over_data(lambda a, b: a, placed, ctx.shard_rows(x[:8]))


#: each rank of the data-parallel job: the mesh is ``PIO_TEST_MESH``
#: over 2 processes; classification and leadscoring are prepared and
#: trained on the seeded rows, and rank 0 writes the tables to
#: ``PIO_TEST_OUT``
DP_CHILD = r"""
import os
import sys

import numpy as np

from predictionio_tpu_torch.models import classification as clf
from predictionio_tpu_torch.models import leadscoring as lead
from predictionio_tpu_torch.parallel import distributed
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.utils.bimap import BiMap


def data(n):
    rng = np.random.default_rng(1)
    y = np.arange(n) % 3
    rng.shuffle(y)
    x = (rng.random((n, 4)) * 3 + np.eye(3, 4)[y] * 5).astype(np.float32)
    rng = np.random.default_rng(3)
    ly = (np.arange(n) % 2).astype(np.float32)
    lx = (rng.normal(0, 2, (n, 3)) + ly[:, None] * 4).astype(np.float32)
    return x, y.astype(np.int32), lx, ly


def train(ctx, n, steps):
    x, y, lx, ly = data(n)
    prep = clf.ClassificationPreparator().prepare(
        ctx, clf.ClassificationTrainingData(
            x=x, y=y, label_map=BiMap.string_int(["c0", "c1", "c2"])))
    model = clf.NaiveBayesAlgorithm().train(ctx, prep)
    lprep = lead.LeadPreparator().prepare(ctx, lead.LeadTrainingData(
        x=lx, y=ly))
    lmodel = lead.LeadScoringAlgorithm(lead.LeadScoringParams(
        steps=steps)).train(ctx, lprep)
    return {"pi": model.nb.pi.cpu().numpy(),
            "theta": model.nb.theta.cpu().numpy(),
            "w": lmodel.w, "b": np.float32(lmodel.b)}


def main() -> int:
    mesh = tuple(int(x) for x in os.environ["PIO_TEST_MESH"].split("x"))
    distributed.initialize(device="cpu")
    assert distributed.backend() == "gloo"
    rank = distributed.process_index()
    ctx = ComputeContext.create(batch="dp", device="cpu", mesh_shape=mesh)
    assert len(ctx.mesh.local) == ctx.n_devices // 2
    got = train(ctx, int(os.environ["PIO_TEST_ROWS"]),
                int(os.environ["PIO_TEST_STEPS"]))
    if rank == 0:
        np.savez(os.environ["PIO_TEST_OUT"], **got)
    sys.stdout.write(f"data-parallel ok rank={rank}\n")
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.mark.parametrize("mesh", ["2x1", "4x1"])
def test_two_gloo_ranks_equal_one_process(tmp_path, mesh):
    out = tmp_path / "tables.npz"
    n = ROWS[0]
    rc = launch_processes(
        [sys.executable, "-c", DP_CHILD], 2, timeout=120,
        env=_env(PIO_TEST_MESH=mesh, PIO_TEST_OUT=str(out),
                 PIO_TEST_ROWS=str(n), PIO_TEST_STEPS=str(LEAD_STEPS),
                 OMP_NUM_THREADS="1"))
    assert rc == 0
    got = np.load(out)
    namespace: dict = {"__name__": "dp_child"}
    exec(DP_CHILD, namespace)
    shape = tuple(int(x) for x in mesh.split("x"))
    want = namespace["train"](ComputeContext.create(
        device="cpu", mesh_shape=shape), n, LEAD_STEPS)
    for key in ("pi", "theta", "w", "b"):
        np.testing.assert_allclose(got[key], want[key], **TOL)


def test_launch_trains_classification_over_two_ranks(tmp_path):
    """The console's ``launch -n 2 -- train`` on the classification
    example: both ranks join, and each publishes a COMPLETED instance
    whose tables equal a one-process train on the same mesh."""
    base = tmp_path / "base"
    base.mkdir()
    env = _env(PIO_FS_BASEDIR=str(base), OMP_NUM_THREADS="1")
    seed = subprocess.run(
        [sys.executable, "-c", SEED_EVENTS], env=env, capture_output=True,
        text=True, timeout=120)
    assert seed.returncode == 0, seed.stderr
    variant = os.path.join(REPO, "examples", "classification", "engine.json")
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "launch",
         "-n", "2", "--timeout", "120", "--", sys.executable, "-m",
         "predictionio_tpu_torch.cli.main", "train", "--variant", variant,
         "--mesh-shape", "2,1", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=180, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stderr.count("torch.distributed initialized (gloo)") == 2
    one = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "train",
         "--variant", variant, "--mesh-shape", "2,1", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert one.returncode == 0, one.stderr[-3000:]
    check = subprocess.run(
        [sys.executable, "-c", READ_TABLES], env=env, capture_output=True,
        text=True, timeout=120)
    assert check.returncode == 0, check.stderr
    assert check.stdout.strip() == "3 instances alike"


#: the classification example's app with 37 users' ``$set`` events in
#: the default storage under ``PIO_FS_BASEDIR``
SEED_EVENTS = r"""
import json
import os

import numpy as np

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Storage

variant = json.load(open(os.path.join(
    os.environ["PYTHONPATH"].split(os.pathsep)[0], "examples",
    "classification", "engine.json")))
app = variant["datasource"]["params"]["app_name"]
storage = Storage()
app_id = storage.get_meta_data_apps().insert(App(0, app))
storage.get_events().init(app_id)
rng = np.random.default_rng(1)
events = []
for i in range(37):
    label = i % 3
    feats = rng.random(3) * 3 + np.eye(3)[label] * 5
    events.append(Event(event="$set", entity_type="user", entity_id=f"u{i}",
                        properties={"attr0": float(feats[0]),
                                    "attr1": float(feats[1]),
                                    "attr2": float(feats[2]),
                                    "plan": f"p{label}"}))
storage.get_events().insert_batch(events, app_id)
"""

#: every published classification generation's tables, held to the last
READ_TABLES = r"""
import numpy as np

from predictionio_tpu_torch.core.persistence import (
    deserialize_models,
    load_generation,
)
from predictionio_tpu_torch.data.storage import Storage

storage = Storage()
insts = sorted(storage.get_meta_data_engine_instances().get_all(),
               key=lambda i: i.start_time)
assert all(i.status == "COMPLETED" for i in insts), insts
tables = []
for inst in insts:
    (model,) = [m for _t, m in deserialize_models(load_generation(
        storage.get_model_data_models(), inst.id))]
    tables.append((np.asarray(model.nb.pi), np.asarray(model.nb.theta)))
for pi, theta in tables[:-1]:
    np.testing.assert_allclose(pi, tables[-1][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(theta, tables[-1][1], rtol=1e-5, atol=1e-6)
print(f"{len(tables)} instances alike")
"""
