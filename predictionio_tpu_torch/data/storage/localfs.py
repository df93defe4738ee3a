"""Local-filesystem model blob store.

Counterpart of ``predictionio_tpu/data/storage/localfs.py``, with the
same file names (``pio_model_<id>.bin``), so either package reads the
other's store. Every insert is write-to-unique-tmp → fsync → rename in
the same directory: a reader never sees a torn blob.
"""

from __future__ import annotations

import os
import secrets

from predictionio_tpu_torch.data.storage.base import Model, ModelsBackend


def _fsync_dir(path: str) -> None:
    """Persist a rename; best-effort where directories cannot be opened."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Atomic, durable byte write: unique same-directory tmp + fsync +
    rename + directory fsync."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{secrets.token_hex(4)}"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(directory)


class LocalFSModels(ModelsBackend):
    def __init__(self, config: dict | None = None):
        config = config or {}
        base = config.get("PATH") or os.path.join(
            os.environ.get(
                "PIO_FS_BASEDIR",
                os.path.join(os.path.expanduser("~"), ".piotpu"),
            ),
            "models",
        )
        os.makedirs(base, exist_ok=True)
        self._base = base

    def _path(self, model_id: str) -> str:
        safe = model_id.replace("/", "_")
        return os.path.join(self._base, f"pio_model_{safe}.bin")

    def insert(self, model: Model) -> None:
        atomic_write_bytes(self._path(model.id), model.models)

    def get(self, model_id: str) -> Model | None:
        try:
            with open(self._path(model_id), "rb") as f:
                return Model(id=model_id, models=f.read())
        except FileNotFoundError:
            return None

    def delete(self, model_id: str) -> bool:
        try:
            os.remove(self._path(model_id))
            return True
        except FileNotFoundError:
            return False

    def quarantine(self, model_id: str) -> bool:
        """Atomic move-aside of a corrupt blob; the bytes survive under
        ``.quarantined.<token>``."""
        src = self._path(model_id)
        dst = f"{src}.quarantined.{secrets.token_hex(4)}"
        try:
            os.replace(src, dst)
        except FileNotFoundError:
            return False
        _fsync_dir(os.path.dirname(src))
        return True
