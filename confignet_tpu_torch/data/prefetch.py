"""Host-to-device batch prefetching on a background thread (counterpart of
``confignet_tpu/data/prefetch.py``).

The reference samples its numpy batches inside the training loop
(confignet_first_stage.py:597-626), so host indexing, the copy to the device
and the step follow one another.  Here a worker thread runs the sampler and
stages each batch on the device while the current step runs.

On a CUDA device each array is copied into pinned host memory and sent with
``non_blocking=True`` on a side stream, then an event is recorded there.
:meth:`BatchPrefetcher.next` makes the caller's current stream wait on that
event and ``record_stream``-s every tensor onto it, so the caching allocator
does not reuse a batch's memory for later copies while the caller's kernels
may still read it.  The pinned buffers are held until their copy's event has
completed, so no copy reads a buffer that was freed or reused.  On the CPU
the arrays become tensors without a copy.

Depth 2 (one batch in flight, one ready) reaches steady state.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from confignet_tpu_torch.core.device import resolve_device


def _map_leaves(batch: Any, fn: Callable[[Any], torch.Tensor]) -> Any:
    """``fn`` of every array in a dict / list / tuple tree; tuples and lists
    become lists (as the train step's ``_batch_to_device`` returns them)."""
    if isinstance(batch, dict):
        return {key: _map_leaves(value, fn) for key, value in batch.items()}
    if isinstance(batch, (tuple, list)):
        return [_map_leaves(value, fn) for value in batch]
    return fn(batch)


def _leaves(batch: Any) -> List[torch.Tensor]:
    if isinstance(batch, dict):
        return [leaf for value in batch.values() for leaf in _leaves(value)]
    if isinstance(batch, (tuple, list)):
        return [leaf for value in batch for leaf in _leaves(value)]
    return [batch]


def _host_tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


class BatchPrefetcher:
    """Runs ``sample_fn`` on a background thread and stages its batches on
    ``device`` (the GPU unless given).

    ``sample_fn`` returns a dict / list / tuple tree of numpy arrays (or
    tensors).  :meth:`next` returns the batches in order; :meth:`close` (or
    the context manager) stops the worker.  With ``device_put=False`` the
    batches pass through untouched."""

    _SENTINEL = object()

    def __init__(self, sample_fn: Callable[[], Any], depth: int = 2, device_put: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        self._sample_fn = sample_fn
        self._device_put = device_put
        self._device = resolve_device(device) if device_put else None
        self._cuda = self._device is not None and self._device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self._device) if self._cuda else None
        # (copy event, pinned buffers) of copies that may still be running
        self._in_flight: List[Tuple[torch.cuda.Event, List[torch.Tensor]]] = []
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, name="batch-prefetcher", daemon=True)
        self._thread.start()

    def _stage(self, batch: Any):
        """(the batch on the device, its copy's event or None)."""
        if not self._device_put:
            return batch, None
        if not self._cuda:
            return _map_leaves(batch, lambda v: _host_tensor(v).to(self._device)), None
        self._in_flight = [(event, bufs) for event, bufs in self._in_flight if not event.query()]
        pinned: List[torch.Tensor] = []

        def copy(value):
            host = _host_tensor(value)
            if host.device.type == "cpu":
                host = host.pin_memory()
                pinned.append(host)
            return host.to(self._device, non_blocking=True)

        with torch.cuda.stream(self._copy_stream):
            staged = _map_leaves(batch, copy)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        self._in_flight.append((event, pinned))
        return staged, event

    def _worker(self) -> None:
        try:
            while not self._stop.is_set():
                item = self._stage(self._sample_fn())
                # a bounded put that polls, so close() cannot deadlock the worker
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:  # surfaced to the consumer in next()
            self._error = exc
            self._stop.set()  # no producer remains; next() must not block
            self._queue.put(self._SENTINEL)

    def next(self) -> Any:
        if self._error is not None:
            # raised on every call after the worker died: a second next()
            # would otherwise wait forever on an empty queue
            raise self._error
        if self._stop.is_set():
            raise RuntimeError("BatchPrefetcher is closed")
        item = self._queue.get()
        if item is self._SENTINEL:
            assert self._error is not None
            raise self._error
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for tensor in _leaves(batch):
                tensor.record_stream(stream)
        return batch

    def close(self) -> None:
        self._stop.set()
        # unblock a worker waiting on a full queue
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "BatchPrefetcher":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
