"""Micro-batching queue for serving.

Counterpart of ``TwoPhaseBatchFn``, ``BatcherOverloaded`` and
``MicroBatcher`` in ``predictionio_tpu/serving/batching.py``: concurrent
requests coalesce into one batch for one kernel launch. The batcher is a
two-stage pipeline: a **collector** thread assembles batches
(``max_batch`` / ``max_wait_ms``) and launches them, and a **completer**
thread waits for each batch's results and settles its futures.
``pipeline_depth`` bounds batches launched but not yet collected
(2 = double buffering; 0 = both stages inline on one thread).

``batch_fn`` is either a plain callable ``(items) -> results``, run once
per batch in the completer, or a two-phase object with
``dispatch(items) -> handle`` (launch, return at once) and
``collect(handle) -> results`` (wait + decode).

Criticality shedding, deadlines and the metric registry come with later
slices; overload is the ``max_queue`` bound alone.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, NamedTuple, Sequence

logger = logging.getLogger(__name__)


class BatcherOverloaded(Exception):
    """Queue depth bound hit — shed the request instead of queuing it.
    Not a RuntimeError: callers tell overload (back off) apart from a
    closed batcher mid-reload (retry)."""


class TwoPhaseBatchFn:
    """The pipelined ``batch_fn`` protocol: launch now, collect later."""

    __slots__ = ("dispatch", "collect")

    def __init__(
        self,
        dispatch: Callable[[Sequence[Any]], Any],
        collect: Callable[[Any], Sequence[Any]],
    ):
        self.dispatch = dispatch
        self.collect = collect


class _Inflight(NamedTuple):
    """One launched batch riding the collector→completer handoff."""

    futures: list
    handle: Any


class MicroBatcher:
    """Coalesce ``submit()``-ed items into batches for ``batch_fn``.

    A batch goes out when ``max_batch`` items wait or ``max_wait_ms``
    passed since the first of them. ``max_queue`` (default
    ``8 * max_batch``) bounds waiting items: beyond it ``submit`` raises
    :class:`BatcherOverloaded`. A returned future may be cancelled until
    its batch is launched; a cancelled item is dropped from the batch."""

    def __init__(
        self,
        batch_fn: Callable[[Sequence[Any]], Sequence[Any]] | TwoPhaseBatchFn,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        max_queue: int | None = None,
        name: str = "default",
        close_join_timeout_s: float = 30.0,
        pipeline_depth: int = 2,
    ):
        if hasattr(batch_fn, "dispatch") and hasattr(batch_fn, "collect"):
            self._dispatch_fn = batch_fn.dispatch
            self._collect_fn = batch_fn.collect
        else:
            # single-phase: the whole batch_fn runs as the collect stage
            self._dispatch_fn = None
            self._collect_fn = batch_fn
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1000.0
        self._max_queue = (
            max_queue if max_queue is not None else 8 * max_batch
        )
        self._close_join_timeout_s = close_join_timeout_s
        self.name = name
        #: submit appends and notifies; the collector takes batches under
        #: the same lock, never held across a launch or a collect
        self._cv = threading.Condition()
        self._buf: list[tuple[Any, Future]] = []
        self._closed = False
        self._pipeline_depth = max(0, pipeline_depth)
        self._completer: threading.Thread | None = None
        if self._pipeline_depth > 0:
            self._pending: queue.Queue = queue.Queue()
            self._inflight = threading.Semaphore(self._pipeline_depth)
            self._completer = threading.Thread(
                target=self._complete_loop, name=f"{name}-completer",
                daemon=True,
            )
            self._completer.start()
        self._thread = threading.Thread(
            target=self._loop, name=f"{name}-collector", daemon=True
        )
        self._thread.start()

    def submit(self, item: Any) -> Future:
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._max_queue > 0 and len(self._buf) >= self._max_queue:
                raise BatcherOverloaded(
                    f"batch queue at capacity ({self._max_queue})"
                )
            future: Future = Future()
            self._buf.append((item, future))
            self._cv.notify()
        return future

    def close(self) -> None:
        """Graceful: queued items still go through, in-flight batches
        complete and their futures resolve, then both threads exit."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        deadline = time.monotonic() + self._close_join_timeout_s
        self._thread.join(timeout=self._close_join_timeout_s)
        if self._completer is not None:
            self._completer.join(
                timeout=max(0.1, deadline - time.monotonic())
            )
        if self._thread.is_alive() or (
            self._completer is not None and self._completer.is_alive()
        ):
            logger.warning(
                "batcher %s: a worker thread did not stop within %.0f s",
                self.name, self._close_join_timeout_s,
            )

    # -- collector stage ---------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._buf and not self._closed:
                    self._cv.wait()
                if not self._buf:
                    break  # closed and fully drained
                if not self._closed:
                    # coalesce: wait out the window from the first queued
                    # item unless the batch fills or close lands
                    window_end = time.monotonic() + self._max_wait
                    while len(self._buf) < self._max_batch and not self._closed:
                        remaining = window_end - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                batch = self._buf[: self._max_batch]
                self._buf = self._buf[self._max_batch:]
            self._dispatch_batch(batch)
        if self._completer is not None:
            self._pending.put(None)  # completer drains in order, then exits

    def _dispatch_batch(self, batch) -> None:
        if self._completer is not None:
            # backpressure first, so items can still be cancelled while
            # the collector waits for a pipeline slot
            self._inflight.acquire()
        live = [
            (item, fut) for item, fut in batch
            if fut.set_running_or_notify_cancel()
        ]
        if not live:
            if self._completer is not None:
                self._inflight.release()
            return
        items = [item for item, _ in live]
        futures = [fut for _, fut in live]
        try:
            handle = (
                items if self._dispatch_fn is None
                else self._dispatch_fn(items)
            )
            if self._completer is None:
                self._settle(futures, self._collect_fn(handle))
                return
        except Exception as e:  # noqa: BLE001 - propagate to every waiter
            if self._completer is not None:
                self._inflight.release()
            self._fail(futures, e)
            return
        self._pending.put(_Inflight(futures, handle))

    # -- completer stage ---------------------------------------------------
    def _complete_loop(self) -> None:
        while True:
            rec = self._pending.get()
            if rec is None:
                return
            try:
                self._settle(rec.futures, self._collect_fn(rec.handle))
            except Exception as e:  # noqa: BLE001 - to every waiter
                self._fail(rec.futures, e)
            finally:
                self._inflight.release()

    def _settle(self, futures, results) -> None:
        if len(results) != len(futures):
            raise RuntimeError(
                f"batch_fn returned {len(results)} results for "
                f"{len(futures)} items"
            )
        for fut, result in zip(futures, results):
            fut.set_result(result)

    def _fail(self, futures, exc: Exception) -> None:
        logger.warning(
            "batcher %s: batch of %d failed: %s: %s",
            self.name, len(futures), type(exc).__name__, exc,
        )
        for fut in futures:
            if not fut.done():
                fut.set_exception(exc)
