"""Asynchronous checkpoint worker (counterpart of
``confignet_tpu/core/async_checkpoint.py``).

The reference runs its checkpoint block (metric renders, image panels,
matplotlib, the weight files) inline on the training thread every
``*_checkpoint_period`` steps (confignet_first_stage.py:616-626).  Here the
trainer snapshots what the checkpoint needs (clones of the parameter tensors
on the device, list copies of the loss history) and hands the job to this
single worker thread, so the loop keeps launching steps while the host work
of the checkpoint runs beside it.

One worker, first in first out: jobs append to ``metrics`` and write
checkpoints in order.  The first error is kept and re-raised on the next
``submit``, ``drain`` or ``close``, so a failing checkpoint is never lost.
"""
from __future__ import annotations

import queue
import threading
import traceback
from typing import Callable, Optional


class CheckpointWorker:
    """One background thread running checkpoint jobs in order.

    The queue is bounded (2 pending jobs by default): each queued job holds
    a snapshot of the parameters on the device, so when checkpoints take
    longer than their period, ``submit`` blocks the trainer until a slot
    frees instead of piling up model copies."""

    def __init__(self, name: str = "checkpoint-worker", max_pending: int = 2):
        self._queue: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue(maxsize=max_pending)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._queue.get()
            try:
                if job is None:
                    return
                job()
            except BaseException as exc:  # noqa: BLE001 -- re-raised on the next submit/drain/close
                traceback.print_exc()
                if self._error is None:
                    # keep the first failure: later jobs usually fail of the
                    # same cause (a full disk, a lost device) and would mask it
                    self._error = exc
            finally:
                self._queue.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint job failed") from err

    def submit(self, job: Callable[[], None]) -> None:
        self._raise_pending()
        self._queue.put(job)

    def drain(self) -> None:
        """Block until every queued job has finished; re-raise a failure."""
        self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        """Run the pending jobs, stop the thread, re-raise a failure."""
        self._queue.put(None)
        self._thread.join()
        self._raise_pending()
