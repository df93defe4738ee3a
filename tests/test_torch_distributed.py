"""The process boundary: the port's ``parallel/distributed.py`` over
``gloo`` (JAX ``tests/test_distributed.py``).

* the env contract (``PIO_COORDINATOR_ADDRESS``, ``PIO_NUM_PROCESSES``,
  ``PIO_PROCESS_ID``), the first failing rank's exit code, the timeout's
  124, and no process left behind: a rank that fails ends the job while
  the others still run;
* the console's ``launch`` verb: a rank line from each of two processes;
* model-sharded ALS in 2 processes × 2 logical devices (mesh 2x2) and in
  4 × 1 (mesh 1x4) from one shared iteration-0 checkpoint
  (``ALS_CHILD`` below, a process a rank), held against the port in
  one process and the JAX package's sharded run on 4 of its devices,
  within rtol 1e-4 / atol 1e-5 (the JAX package's own tolerance between
  meshes; the packages sum the Gramians in different orders);
* ``initialize`` refusing a CUDA job with more ranks on this host than
  cards, naming both counts, and a CUDA job without a card.

Every child run has a timeout of its own (at most 120 s).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

from predictionio_tpu.ops import als as jals
from predictionio_tpu.parallel.mesh import ComputeContext as JaxContext
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.parallel import distributed
from predictionio_tpu_torch.parallel.distributed import launch_processes
from predictionio_tpu_torch.parallel.mesh import ComputeContext, NoDeviceError

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def test_env_contract():
    probe = ("import os,sys;"
             "assert os.environ['PIO_NUM_PROCESSES']=='2';"
             "assert os.environ['PIO_COORDINATOR_ADDRESS'];"
             "sys.exit(int(os.environ['PIO_PROCESS_ID']))")
    # ranks 0 and 1 exit with their rank: the first nonzero is 1
    assert launch_processes([sys.executable, "-c", probe], 2,
                            timeout=60) == 1


def test_failure_propagates_and_terminates():
    assert launch_processes([sys.executable, "-c", "import sys; sys.exit(3)"],
                            2, timeout=60) == 3
    # rank 1 fails at once while rank 0 would sleep a minute: the job
    # ends with rank 1's code and rank 0 is terminated, not waited for
    probe = ("import os,sys,time;"
             "rank=int(os.environ['PIO_PROCESS_ID']);"
             "time.sleep(60) if rank == 0 else sys.exit(5)")
    t0 = time.monotonic()
    assert launch_processes([sys.executable, "-c", probe], 2,
                            timeout=90) == 5
    assert time.monotonic() - t0 < 30


def test_timeout_is_124():
    t0 = time.monotonic()
    assert launch_processes([sys.executable, "-c",
                             "import time; time.sleep(60)"], 2,
                            timeout=1.0) == 124
    assert time.monotonic() - t0 < 30


def test_cli_launch_verb():
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "launch",
         "-n", "2", "--", sys.executable, "-c",
         # one write: two children share the pipe
         "import os,sys;"
         "sys.stdout.write('rank %s\\n' % os.environ['PIO_PROCESS_ID'])"],
        env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    ranks = sorted(ln for ln in out.stdout.splitlines() if "rank" in ln)
    assert ranks == ["rank 0", "rank 1"]


#: each rank of the sharded-ALS job: the mesh is processes × logical CPU
#: devices (``PIO_TEST_MESH``); every rank trains from the shared
#: iteration-0 checkpoint in ``PIO_TEST_START``, checks its own shards
#: are split over the model axis, that checkpoint writes are the
#: coordinator's alone (host-local directories, one per rank) and that a
#: resume from them keeps every rank on one schedule; rank 0 writes the
#: factors to ``PIO_TEST_OUT``
ALS_CHILD = r"""
import os
import shutil
import sys

import numpy as np

from predictionio_tpu_torch.ops.als import check_factor_sharding, train_als
from predictionio_tpu_torch.parallel import distributed
from predictionio_tpu_torch.parallel.mesh import ComputeContext

def problem():
    rng = np.random.default_rng(11)
    n_users, n_items, nnz, rank = 48, 32, 400, 8
    rows = rng.integers(0, n_users, nnz).astype(np.int32)
    cols = rng.integers(0, n_items, nnz).astype(np.int32)
    vals = rng.integers(1, 5, nnz).astype(np.float32)
    return rows, cols, vals, n_users, n_items, rank


def main() -> int:
    mesh = tuple(int(x) for x in os.environ["PIO_TEST_MESH"].split("x"))
    distributed.initialize(device="cpu")
    assert distributed.backend() == "gloo"
    rank = distributed.process_index()
    ctx = ComputeContext.create(batch="dist-als", device="cpu",
                                mesh_shape=mesh)
    assert ctx.n_devices == mesh[0] * mesh[1]
    assert len(ctx.mesh.local) == ctx.n_devices // distributed.process_count()
    rows, cols, vals, n_users, n_items, k = problem()
    kw = dict(n_users=n_users, n_items=n_items, rank=k, iterations=2,
              reg=0.1, block_len=8, factor_sharding="sharded")
    got = train_als(ctx, rows, cols, vals, resume=True,
                    checkpoint_dir=os.environ["PIO_TEST_START"], **kw)
    assert np.isfinite(got.user_factors).all()
    if ctx.model_parallelism > 1:
        check_factor_sharding(ctx, rows, cols, vals, n_users, n_items,
                              rank=k, block_len=8)
    # host-local checkpoint dirs: only the coordinator's gets the file,
    # and the resume broadcast keeps the others on its schedule
    mine = os.path.join(os.environ["PIO_TEST_OUT"] + ".ckpt", f"rank{rank}")
    os.makedirs(mine, exist_ok=True)
    shutil.copy(os.path.join(os.environ["PIO_TEST_START"],
                             "als_checkpoint.npz"),
                os.path.join(mine, "als_checkpoint.npz"))
    if rank:
        os.remove(os.path.join(mine, "als_checkpoint.npz"))
    resumed = train_als(ctx, rows, cols, vals, resume=True,
                        checkpoint_dir=mine, checkpoint_every=1, **kw)
    step = np.load(os.path.join(mine, "als_checkpoint.npz")) if not rank \
        else None
    assert (step is not None) == (rank == 0)
    if step is not None:
        assert int(step["iteration"]) == 1
    np.testing.assert_allclose(resumed.user_factors, got.user_factors,
                               rtol=1e-5, atol=1e-6)
    if rank == 0:
        np.savez(os.environ["PIO_TEST_OUT"], user=got.user_factors,
                 item=got.item_factors)
    sys.stdout.write(f"distributed ALS ok rank={rank}\n")
    distributed.shutdown()
    return 0


sys.exit(main())
"""


def _child_problem():
    namespace: dict = {}
    exec(ALS_CHILD.split("def main()")[0], namespace)
    return namespace["problem"]()


@pytest.mark.parametrize("nprocs, mesh", [(2, "2x2"), (4, "1x4")])
def test_sharded_als_across_processes(tmp_path, nprocs, mesh):
    rows, cols, vals, n_users, n_items, k = _child_problem()
    start = tmp_path / "start"
    rng = np.random.default_rng(4)
    als._write_checkpoint(
        als.checkpoint_path(str(start)), iteration=0,
        item_factors=(rng.standard_normal((n_items, k)) / 3).astype(
            np.float32),
        user_factors=np.zeros((n_users, k), np.float32))
    out = tmp_path / "factors.npz"
    rc = launch_processes(
        [sys.executable, "-c", ALS_CHILD],
        nprocs, timeout=120,
        env=_env(PIO_TEST_MESH=mesh, PIO_TEST_START=str(start),
                 PIO_TEST_OUT=str(out), OMP_NUM_THREADS="1"),
    )
    assert rc == 0
    got = np.load(out)
    kw = dict(n_users=n_users, n_items=n_items, rank=k, iterations=2,
              reg=0.1, block_len=8, checkpoint_dir=str(start), resume=True)
    one = als.train_als(ComputeContext.create(device="cpu"), rows, cols,
                        vals, **kw)
    shape = tuple(int(x) for x in mesh.split("x"))
    jctx = JaxContext.create(mesh_shape=shape, devices=jax.devices()[:4])
    want = jals.train_als(jctx, rows, cols, vals, factor_sharding="sharded",
                          **kw)
    for ref in (one, want):
        np.testing.assert_allclose(got["user"], ref.user_factors,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["item"], ref.item_factors,
                                   rtol=1e-4, atol=1e-5)


def test_cuda_job_is_refused_without_enough_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError, match="no CUDA device"):
        distributed.initialize("127.0.0.1:1", 2, 0, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="4 ranks on this host but 1 CUDA"):
        distributed.initialize("127.0.0.1:1", 4, 0, device="cuda")
    assert not distributed.is_initialized()
    # single-process: nothing to join
    monkeypatch.delenv("PIO_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("PIO_NUM_PROCESSES", raising=False)
    distributed.initialize(device="cpu")
    assert not distributed.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.is_coordinator()
