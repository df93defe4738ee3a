"""Multi-process initialization over ``torch.distributed``.

Counterpart of ``predictionio_tpu/parallel/distributed.py``: one process
per card, all calling :func:`initialize` so collectives span them; the
console calls it before building a
:class:`~predictionio_tpu_torch.parallel.mesh.ComputeContext`, whose mesh
is then processes × local devices.

Env contract (the JAX package's):

* ``PIO_COORDINATOR_ADDRESS`` — host:port of process 0 (the TCP store)
* ``PIO_NUM_PROCESSES`` / ``PIO_PROCESS_ID`` — world size / rank

A CUDA run takes ``nccl``, one card per rank (``cuda:{rank %
device_count}``); a CPU run takes ``gloo``. A CUDA run that asks for more
ranks on this host than it has cards raises: NCCL cannot put two ranks
on one card, and nothing drops to ``gloo`` or the CPU instead. Every
collective is bounded by COLLECTIVE_TIMEOUT.
"""

from __future__ import annotations

import datetime
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)

_state: dict = {}

#: a rank blocked this long in a collective raises (its peer died)
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | None = None,
) -> None:
    """Join the multi-process job. No-op when single-process (no
    coordinator and no world size given or in the environment), and on
    a second call. ``device`` is ``"cuda"`` (default) or ``"cpu"``."""
    if _state:
        return
    coordinator_address = coordinator_address or os.environ.get(
        "PIO_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "PIO_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PIO_NUM_PROCESSES"])
    if process_id is None and "PIO_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PIO_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None:
        raise ValueError(
            "a multi-process job needs both PIO_COORDINATOR_ADDRESS and "
            "PIO_NUM_PROCESSES"
        )
    rank = int(process_id or 0)
    world = int(num_processes)
    import torch
    import torch.distributed as dist

    from predictionio_tpu_torch.parallel.mesh import NoDeviceError

    kind = torch.device(device or "cuda").type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise NoDeviceError(
                "distributed.initialize: no CUDA device is available; "
                "pass device='cpu' (--device cpu) for a gloo job"
            )
        cards = torch.cuda.device_count()
        if _is_loopback(coordinator_address) and world > cards:
            raise RuntimeError(
                f"{world} ranks on this host but {cards} CUDA card(s): "
                "NCCL needs a card per rank"
            )
        local = torch.device("cuda", rank % cards)
        torch.cuda.set_device(local)
        backend = "nccl"
    elif kind == "cpu":
        local = torch.device("cpu")
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device!r}")
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank, timeout=COLLECTIVE_TIMEOUT,
    )
    _state.update(rank=rank, world=world, device=local, backend=backend)
    logger.info("torch.distributed initialized (%s): process %d/%d on %s",
                backend, rank, world, local)


def _is_loopback(coordinator_address: str) -> bool:
    """A loopback coordinator (what :func:`launch_processes` starts) puts
    every rank on this host; elsewhere NCCL refuses a shared card itself."""
    host = coordinator_address.rsplit(":", 1)[0]
    return host in ("127.0.0.1", "localhost", "::1", "[::1]")


def is_initialized() -> bool:
    return bool(_state)


def process_index() -> int:
    return _state.get("rank", 0)


def process_count() -> int:
    return _state.get("world", 1)


def is_coordinator() -> bool:
    return process_index() == 0


def backend() -> str | None:
    return _state.get("backend")


def local_device():
    """The device this rank's collectives run on."""
    return _state["device"]


def shutdown() -> None:
    """Leave the process group (the next :func:`initialize` joins anew)."""
    if not _state:
        return
    import torch.distributed as dist

    dist.destroy_process_group()
    _state.clear()


def all_gather_cat(t):
    """Every process's ``t`` (equal shapes), concatenated along dim 0 in
    rank order, on ``t``'s device: ``all_gather_into_tensor`` on nccl,
    ``all_gather`` on gloo. ``t`` itself when single-process."""
    if not _state:
        return t
    import torch
    import torch.distributed as dist

    dev = t.device
    src = t.contiguous().to(_state["device"])
    world = _state["world"]
    if _state["backend"] == "nccl":
        out = torch.empty((world * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src)
    else:
        parts = [torch.empty_like(src) for _ in range(world)]
        dist.all_gather(parts, src)
        out = torch.cat(parts, dim=0)
    return out.to(dev)


def broadcast_array(arr: np.ndarray) -> np.ndarray:
    """The coordinator's ``arr`` (same shape and dtype everywhere) on
    every process."""
    if not _state:
        return arr
    import torch
    import torch.distributed as dist

    t = torch.as_tensor(np.ascontiguousarray(arr)).to(_state["device"])
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


def _free_port() -> int:
    """A free TCP port below the kernel's ephemeral range, so that no
    outgoing connection's source port takes it between this probe and
    the coordinator's bind."""
    import random
    import socket

    lo = 20000
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        pass
    rng = random.Random()
    for _ in range(200):
        port = rng.randrange(10000, max(10001, lo))
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_processes(
    argv: list[str],
    num_processes: int,
    coordinator_address: str | None = None,
    env: dict | None = None,
    timeout: float | None = None,
) -> int:
    """Spawn ``num_processes`` copies of ``argv`` with the env contract
    set on top of the parent env (so ``PIO_STORAGE_*`` flows through).
    Returns the first nonzero child exit code in rank order, 124 on
    timeout, else 0; on failure or timeout the remaining children are
    terminated, so a rank that raised never leaves the others blocked
    in a collective."""
    import subprocess
    import time as _time

    if num_processes < 1:
        raise ValueError("num_processes must be ≥ 1")
    coordinator_address = (
        coordinator_address or f"127.0.0.1:{_free_port()}"
    )
    base_env = dict(os.environ if env is None else env)
    base_env["PIO_COORDINATOR_ADDRESS"] = coordinator_address
    base_env["PIO_NUM_PROCESSES"] = str(num_processes)
    procs = []
    for rank in range(num_processes):
        child_env = dict(base_env)
        child_env["PIO_PROCESS_ID"] = str(rank)
        procs.append(subprocess.Popen(argv, env=child_env))
    logger.info(
        "launched %d process(es) for %r (coordinator %s)",
        num_processes, argv, coordinator_address,
    )
    deadline = _time.monotonic() + timeout if timeout else None
    rc = 0
    try:
        # poll every child: the first to fail ends the job, whatever
        # its rank, rather than waiting on a lower rank blocked in a
        # collective with it
        pending = list(procs)
        while pending and not rc:
            for p in list(pending):
                code = p.poll()
                if code is None:
                    continue
                pending.remove(p)
                if code:
                    rc = next(q.returncode for q in procs
                              if q.returncode)
                    break
            if pending and not rc:
                if deadline is not None and _time.monotonic() > deadline:
                    rc = 124
                    break
                _time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
    return rc
