"""ComputeContext — the device mesh every controller receives.

Counterpart of ``predictionio_tpu/parallel/mesh.py`` (``ComputeContext``,
``pad_to_multiple``, ``record_padded_rows``, ``assert_phantom_rows_zero``).
The JAX context wraps a ``jax.sharding.Mesh``; here a :class:`Mesh` is an
ndarray of ``torch.device`` shaped ``(data, model)``, and an array placed
over it is a :class:`ShardedTensor`: one tensor per mesh position, the
block that position holds under a :class:`PartitionSpec`.

Mesh convention (the JAX package's):

* axis ``"data"`` — batch / example / entity-row parallelism;
* axis ``"model"`` — factor / catalog row sharding.

A mesh may repeat a device. ``devices=[cuda:0] * 4`` (or ``device="cpu"``
with any ``mesh_shape``) gives four *logical* devices on one card: the
whole sharded program runs, each position's work in turn, which is how
the tests and ``chip_smoke.py`` exercise a (4, 2) mesh without eight
cards. Positions that share a device share one tensor for a block they
both hold, so a replicated block costs no copy there.

Across processes (``parallel.distributed.initialize``) the global mesh is
processes × local devices, in rank order; each process holds the blocks
of its own positions, and :meth:`ShardedTensor.gather` all-gathers over
``torch.distributed``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"


def pad_to_multiple(
    arr: np.ndarray, multiple: int, axis: int = 0, fill: Any = 0
) -> np.ndarray:
    """Pad ``axis`` up to the next multiple of ``multiple``."""
    size = arr.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - size)
    return np.pad(arr, widths, constant_values=fill)


def record_padded_rows(added: int, n_rows: int, parallelism: int) -> None:
    """Telemetry for mesh-padding sites (``shard_rows``, factor staging):
    counts phantom rows in ``pio_mesh_pad_rows_total`` and warns when
    the padding exceeds the real data."""
    from predictionio_tpu_torch.obs import get_registry

    get_registry().counter(
        "pio_mesh_pad_rows_total",
        "Phantom rows added when padding arrays to a mesh-axis "
        "multiple (shard_rows / sharded factor staging)",
    ).inc(added)
    if n_rows < parallelism:
        logger.warning(
            "padding %d-row array to %d rows to shard over %d "
            "devices — padding exceeds the real data",
            n_rows, n_rows + added, parallelism,
        )


def assert_phantom_rows_zero(
    arr, n_real: int, what: str = "factors"
) -> None:
    """Rows past ``n_real`` exist only for padding and must be exact
    zeros; anything else would score into serving as a ghost entity."""
    if isinstance(arr, ShardedTensor):
        arr = arr.gather()
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    tail = np.asarray(arr)[n_real:]
    if tail.size and np.any(tail != 0):
        bad = int(np.count_nonzero(np.any(tail != 0, axis=-1)))
        raise AssertionError(
            f"phantom-row invariant violated: {bad} padded row(s) of "
            f"{what} past row {n_real} are nonzero"
        )


_linalg_lock = threading.Lock()
#: the devices whose linalg library is loaded (False before the first)
_linalg_loaded: "set | bool" = False


def load_cuda_linalg(device: torch.device) -> None:
    """Make the first CUDA linear-algebra call on ``device``, once per
    device, under a lock. torch loads its CUDA linalg library (and the
    device's cuSOLVER handle) at that first call, and the load is not
    thread-safe: two threads making it together (the candidates of an
    evaluation, each training ALS) fail with "lazy wrapper should be
    called at most once". Callers of ``torch.linalg`` on the card call
    this for every device of their mesh; on the CPU it does nothing."""
    global _linalg_loaded
    if device.type != "cuda" or (_linalg_loaded and device in _linalg_loaded):
        return
    with _linalg_lock:
        if not (_linalg_loaded and device in _linalg_loaded):
            torch.linalg.cholesky_ex(torch.ones(1, 1, device=device))
            _linalg_loaded = (_linalg_loaded or set()) | {device}


class NoDeviceError(RuntimeError):
    """CUDA was asked for (or defaulted to) and there is no card. The
    console prints it as ``error: ...`` and exits 1, as the JAX console
    does its ``DeviceInitTimeout``."""


# --------------------------------------------------------------------------
# Mesh, specs and placements
# --------------------------------------------------------------------------


class PartitionSpec(tuple):
    """Per-dimension placement: ``None`` (whole), an axis name, or a
    tuple of axis names (split over their product, the first major) —
    the port's counterpart of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object ndarray of ``torch.device`` shaped by the
    axes; ``local``: the flat (row-major) positions this process holds
    — all of them in one process."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    local: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, pos: int) -> dict[str, int]:
        """Axis name → index of flat position ``pos``."""
        idx = np.unravel_index(pos, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def device(self, pos: int) -> torch.device:
        return self.devices.flat[pos]

    @property
    def home(self) -> torch.device:
        """This process's first device: where replicated results live."""
        return self.device(self.local[0])


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """A placement: ``spec`` over ``mesh`` (``NamedSharding``)."""

    mesh: Mesh
    spec: PartitionSpec

    def __eq__(self, other) -> bool:
        return (isinstance(other, Sharding) and other.mesh is self.mesh
                and tuple(other.spec) == tuple(self.spec))

    def __hash__(self) -> int:
        return hash((id(self.mesh), tuple(self.spec)))

    def axes(self, dim: int) -> tuple[str, ...]:
        """The mesh axes dimension ``dim`` is split over, major first."""
        entry = self.spec[dim] if dim < len(self.spec) else None
        if entry is None:
            return ()
        return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)

    def parts(self, dim: int) -> int:
        """How many blocks dimension ``dim`` is cut into."""
        sizes = self.mesh.shape
        return math.prod(sizes[a] for a in self.axes(dim))

    def block(self, pos: int, shape: Sequence[int]) -> tuple[slice, ...]:
        """The slices of a global ``shape`` that position ``pos`` holds."""
        coords = self.mesh.coords(pos)
        sizes = self.mesh.shape
        out = []
        for dim, n in enumerate(shape):
            part, parts = 0, 1
            for axis in self.axes(dim):
                part = part * sizes[axis] + coords[axis]
                parts *= sizes[axis]
            if n % parts:
                raise ValueError(
                    f"dimension {dim} of size {n} does not split evenly "
                    f"over {parts} devices ({self.spec!r})"
                )
            step = n // parts
            out.append(slice(part * step, (part + 1) * step))
        return tuple(out)

    def place(self, value) -> "ShardedTensor":
        """Commit a global host or device array: each local position
        gets its block, one copy per distinct (block, device)."""
        if isinstance(value, ShardedTensor):
            value = value.gather()
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        for dim, entry in enumerate(self.spec):
            if entry is not None and dim >= value.dim():
                raise ValueError(
                    f"spec {self.spec!r} splits dimension {dim} of a "
                    f"{value.dim()}-d array"
                )
        shards: list = [None] * self.mesh.size
        made: dict = {}
        for pos in self.mesh.local:
            sl = self.block(pos, value.shape)
            dev = self.mesh.device(pos)
            key = (tuple((s.start, s.stop) for s in sl), dev)
            if key not in made:
                made[key] = value[sl].to(dev).contiguous()
            shards[pos] = made[key]
        return ShardedTensor(self, tuple(value.shape), shards)


class ShardedTensor:
    """A global array placed over a mesh: ``shards[pos]`` is the block
    position ``pos`` holds (``None`` for another process's positions)."""

    def __init__(self, sharding: Sharding, shape: tuple, shards: list):
        self.sharding = sharding
        self.shape = tuple(int(n) for n in shape)
        self.shards = shards

    # -- array facts --------------------------------------------------------
    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.local_shards()[0].dtype

    @property
    def device(self) -> torch.device:
        """The home device (this process's first position)."""
        return self.mesh.home

    def local_shards(self) -> list[torch.Tensor]:
        return [self.shards[pos] for pos in self.mesh.local]

    @property
    def addressable_shards(self) -> list[torch.Tensor]:
        return self.local_shards()

    def unique_shards(self) -> list[torch.Tensor]:
        """Each distinct local block tensor once."""
        seen, out = set(), []
        for t in self.local_shards():
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    @property
    def nbytes(self) -> int:
        """Device bytes this process holds (a block that positions on one
        device share counts once)."""
        return sum(t.numel() * t.element_size() for t in self.unique_shards())

    def is_floating_point(self) -> bool:
        return self.dtype.is_floating_point

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.sharding.spec!r}, mesh={self.mesh.shape})")

    # -- transforms -----------------------------------------------------------
    def map(self, fn: Callable) -> "ShardedTensor":
        """Apply a row-local ``fn`` to every distinct block (dimension 0
        split only; trailing dimensions may change)."""
        if any(self.sharding.parts(d) > 1 for d in range(1, self.ndim)):
            raise ValueError("map needs an array split on dimension 0 only")
        results = {id(t): fn(t) for t in self.unique_shards()}
        first = next(iter(results.values()))
        spec = PartitionSpec(*tuple(self.sharding.spec)[:first.dim()])
        return ShardedTensor(
            Sharding(self.mesh, spec),
            (self.shape[0],) + tuple(first.shape[1:]),
            [None if t is None else results[id(t)] for t in self.shards],
        )

    def row_shards(self) -> list[tuple[int, torch.Tensor, int]]:
        """``(row offset, block, position)`` per row block of a
        dimension-0 split, in row order, from this process's positions
        (the lowest position holding each block)."""
        out: dict = {}
        for pos in self.mesh.local:
            start = self.sharding.block(pos, self.shape)[0].start
            out.setdefault(start, (start, self.shards[pos], pos))
        return [out[k] for k in sorted(out)]

    def take_rows(self, idx) -> torch.Tensor:
        """Rows ``idx`` of the global array, on the home device, with no
        wait for the card: each row block gathers with its local index
        clamped, and the rows that fall in it are kept."""
        home = self.device
        idx = torch.as_tensor(np.asarray(idx, np.int64)).to(home)
        blocks = self.row_shards()
        rows = self.shape[0] // max(1, len(blocks))
        if len(blocks) * rows != self.shape[0]:
            raise ValueError("take_rows needs every row block in this "
                             "process")
        out = None
        for start, block, _ in blocks:
            local = (idx - start).clamp(0, rows - 1)
            got = block.index_select(0, local.to(block.device)).to(home)
            inside = ((idx >= start) & (idx < start + rows)).view(
                (-1,) + (1,) * (got.dim() - 1))
            out = got if out is None else torch.where(inside, got, out)
        return out

    def gather(self) -> torch.Tensor:
        """The whole global array on the home device. A collective when
        the process group is up: every process must call it."""
        from predictionio_tpu_torch.parallel import distributed

        home = self.device
        mesh = self.mesh
        if distributed.is_initialized():
            local = torch.stack([t.to(home) for t in self.local_shards()])
            every = distributed.all_gather_cat(local)
            blocks = list(every.unbind(0))
        elif len(mesh.local) == mesh.size:
            blocks = [t.to(home) for t in self.shards]
        else:
            raise RuntimeError("a mesh over several processes gathers "
                               "through torch.distributed")
        out = torch.empty(self.shape, dtype=blocks[0].dtype, device=home)
        done = set()
        for pos, block in enumerate(blocks):
            sl = self.sharding.block(pos, self.shape)
            key = tuple((s.start, s.stop) for s in sl)
            if key not in done:
                out[sl] = block
                done.add(key)
        return out


def default_devices(device=None) -> list[torch.device]:
    """This process's devices: every visible card (a rank of a CUDA
    process group owns one, ``cuda:{rank % device_count}``), or the CPU.
    Without CUDA, asking for it (or the default) raises
    :class:`NoDeviceError`: nothing drops quietly to the CPU."""
    from predictionio_tpu_torch.parallel import distributed

    base = torch.device("cuda" if device is None else device)
    if base.type == "cpu":
        return [base]
    if base.type != "cuda":
        raise ValueError(f"unsupported device {base}")
    if not torch.cuda.is_available():
        raise NoDeviceError(
            "ComputeContext.create: no CUDA device is available; "
            "pass device='cpu' (--device cpu) to run on the host"
        )
    if base.index is not None:
        return [base]
    if distributed.is_initialized():
        return [distributed.local_device()]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass
class ComputeContext:
    """Mesh + placement helpers threaded through DASE controllers."""

    mesh: Mesh
    batch: str = ""  # run label

    # -- construction -------------------------------------------------------
    @staticmethod
    def create(
        batch: str = "",
        mesh_shape: Sequence[int] | None = None,
        devices: Sequence | None = None,
        device: str | torch.device | None = None,
        axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
    ) -> "ComputeContext":
        """A context over this process's devices (every process's, once
        ``parallel.distributed.initialize`` has run).

        ``devices`` lists them explicitly, repeats allowed (logical
        devices); otherwise :func:`default_devices` of ``device``, where
        ``device="cpu"`` gives as many logical CPU devices as
        ``mesh_shape`` needs. The default shape puts every device on
        ``data``; a shape that does not cover the devices raises, as in
        the JAX package."""
        from predictionio_tpu_torch.parallel import distributed

        n_proc = distributed.process_count()
        rank = distributed.process_index()
        if devices is not None:
            local = [torch.device(d) for d in devices]
            if not local:
                raise ValueError("ComputeContext.create: no devices")
            if any(d.type == "cuda" for d in local) and (
                not torch.cuda.is_available()
            ):
                raise NoDeviceError(
                    "ComputeContext.create: no CUDA device is available; "
                    "pass device='cpu' (--device cpu) to run on the host"
                )
        else:
            local = default_devices(device)
            if local[0].type == "cpu" and mesh_shape is not None:
                total = math.prod(mesh_shape)
                local = local * max(1, total // n_proc)
        if mesh_shape is None:
            mesh_shape = (len(local) * n_proc,) + (1,) * (len(axis_names) - 1)
        mesh_shape = tuple(int(n) for n in mesh_shape)
        if math.prod(mesh_shape) != len(local) * n_proc:
            raise ValueError(
                f"mesh_shape {mesh_shape} does not cover "
                f"{len(local) * n_proc} devices"
            )
        everyone = []
        for p in range(n_proc):
            if p == rank:
                everyone += local
            else:  # another process's devices, named as it names them
                everyone += [
                    torch.device("cuda", p % torch.cuda.device_count())
                    if d.type == "cuda" and devices is None else d
                    for d in local
                ]
        grid = np.empty(len(everyone), dtype=object)
        grid[:] = everyone
        n = len(local)
        mesh = Mesh(grid.reshape(mesh_shape), tuple(axis_names),
                    tuple(range(rank * n, (rank + 1) * n)))
        logger.info(
            "ComputeContext %r: mesh %s over %d %s device(s)",
            batch, mesh.shape, mesh.size, local[0].type,
        )
        return ComputeContext(mesh=mesh, batch=batch)

    # -- mesh facts -------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        """The mesh's first local device: home of replicated results."""
        return self.mesh.home

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def data_parallelism(self) -> int:
        return self.mesh.shape.get(DATA_AXIS, 1)

    @property
    def model_parallelism(self) -> int:
        return self.mesh.shape.get(MODEL_AXIS, 1)

    @property
    def local_devices(self) -> list[torch.device]:
        """This process's distinct devices, in mesh order."""
        out: list = []
        for pos in self.mesh.local:
            d = self.mesh.device(pos)
            if d not in out:
                out.append(d)
        return out

    # -- placement helpers ------------------------------------------------------
    def sharding(self, *spec: Any) -> Sharding:
        return Sharding(self.mesh, PartitionSpec(*spec))

    @property
    def replicated(self) -> Sharding:
        return Sharding(self.mesh, PartitionSpec())

    @property
    def data_sharded(self) -> Sharding:
        """Rows split over the data axis."""
        return Sharding(self.mesh, PartitionSpec(DATA_AXIS))

    @property
    def model_sharded(self) -> Sharding:
        return Sharding(self.mesh, PartitionSpec(MODEL_AXIS))

    def _padded(self, arr, fill) -> np.ndarray:
        multiple = max(self.data_parallelism, 1)
        arr = np.asarray(arr)
        padded = pad_to_multiple(arr, multiple, axis=0, fill=fill)
        if padded.shape[0] != arr.shape[0]:
            record_padded_rows(
                padded.shape[0] - arr.shape[0], arr.shape[0], multiple
            )
        return padded

    def shard_rows(self, arr, fill: Any = 0) -> ShardedTensor:
        """Pad rows to the data-axis multiple and split them over
        ``data``: one block per data index (an array smaller than the
        axis pads up to one row per device, counted in
        ``pio_mesh_pad_rows_total``)."""
        return self.data_sharded.place(self._padded(arr, fill))

    def pad_rows(self, arr, fill: Any = 0) -> torch.Tensor:
        """The rows of :meth:`shard_rows` as one tensor on the home
        device, for code that computes there."""
        return torch.as_tensor(self._padded(arr, fill)).to(self.device)

    def replicate(self, arr) -> torch.Tensor:
        """``arr`` on the home device (positions sharing a device read
        the same tensor; others copy it from there)."""
        if isinstance(arr, ShardedTensor):
            return arr.gather()
        if isinstance(arr, torch.Tensor):
            return arr.to(self.device)
        return torch.as_tensor(np.asarray(arr)).to(self.device)

    def on_each(self, value: torch.Tensor) -> dict:
        """Device → ``value`` there, for every distinct local device."""
        return {d: value.to(d) for d in self.local_devices}
