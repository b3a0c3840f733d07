"""One runner for every chunked call: the server's pipelines
(``serving.py``), the model's renders, encodes and fused FID features
(``training/first_stage.py``, ``training/second_stage.py``).

Host arrays come in and are cut along their leading axis into chunks of a
fixed size, the last one padded by repeating its last row, so every chunk is
one call shape and one graph (``core/graphs.py``).  Fresh host arrays of
exactly the rows asked for come out, floats as float32; padded rows never
reach them, and no result shares memory with a buffer a later call reuses.

On the card the chunks are pipelined on one stream.  A chunk's rows are
copied on the host into a pinned staging buffer of the graph cache; the
copy into the graph's inputs, the replay and the copy of the valid rows of
its outputs into a pinned buffer are queued, and an event recorded behind
them.  Only then does the host wait for the chunk before, and copy its rows
into the result, so the card renders one chunk while the host stages the
next and copies out the last.  Stream order keeps every replay behind the
copy-out of the replay before (both write and read the graph's one set of
buffers), and each chunk's input copy behind the replay before it.  The two
staging slots take turns; a slot is filled again only after the event of
its last chunk.  On the CPU, on the card inside ``graphs.eager()``, and over
a data-parallel mesh (whose gather of each chunk's rows is a collective
outside the graph), each chunk runs and comes back to the host before the
next.

Host steps are spans of ``core/tracing.py``: a chunk's staging
``confignet.io.inputs``, the copies into the graph's inputs
``confignet.io.h2d`` (in ``GraphCache.replay``), the queued copy-out, the wait
on a chunk and its copy into the result ``confignet.io.d2h``.
"""
from __future__ import annotations

from typing import Callable, Hashable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from confignet_tpu_torch.core.graphs import GraphCache, host_dtype
from confignet_tpu_torch.core.tracing import count, span
from confignet_tpu_torch.parallel.mesh import all_gather_rows, shard_batch


class _Chunk(NamedTuple):
    start: int
    valid: int  # rows that are not padding
    host: Tuple[np.ndarray, ...]  # the chunk's outputs on the host (at least ``valid`` rows)
    done: Optional["torch.cuda.Event"]  # recorded behind the copy into ``host``
    device: tuple = ()  # the outputs on the card, kept until ``done``


@torch.inference_mode()
def run_chunked(graphs: GraphCache, name: Hashable, fn: Callable, arrays: Sequence[np.ndarray],
                extra: Sequence[torch.Tensor] = (), modules: Sequence[torch.nn.Module] = (),
                chunk: int = 32, mesh=None):
    """``fn`` over the rows of ``arrays`` (host arrays of one leading length),
    ``chunk`` rows at a time, each chunk through ``graphs.run(name, fn,
    ...)`` over ``modules``; ``extra`` tensors pass whole to every chunk.
    Returns a fresh host array for each output of ``fn`` (the array itself
    for a single output).  Over ``mesh`` each chunk is this rank's rows, and its
    outputs are gathered from every rank."""
    n = arrays[0].shape[0]
    if n == 0:
        raise ValueError("no rows to run")
    count("rows.requested", n)
    count("rows.run", -(-n // chunk) * chunk)
    pipelined = graphs.active and mesh is None
    results = pending = None
    for index, start in enumerate(range(0, n, chunk)):
        valid = min(chunk, n - start)
        if pipelined:
            queued = _enqueue(graphs, name, fn, arrays, extra, modules, chunk, start, valid,
                              slot=index % 2)
            if pending is not None:
                results = _copy_out(pending, results, n)
            pending = queued
        else:
            results = _copy_out(_run_now(graphs, name, fn, arrays, extra, modules, chunk, start,
                                         valid, mesh), results, n)
    if pending is not None:
        results = _copy_out(pending, results, n)
    return results if len(results) > 1 else results[0]


def _fill(staged: np.ndarray, array: np.ndarray, start: int, valid: int) -> np.ndarray:
    """A chunk's rows of ``array`` in ``staged``, the rest repeating its last row."""
    staged[:valid] = array[start:start + valid]
    staged[valid:] = array[start + valid - 1]
    return staged


def _enqueue(graphs: GraphCache, name, fn, arrays, extra, modules, rows: int, start: int,
             valid: int, slot: int) -> _Chunk:
    """Stage a chunk in ``slot``'s pinned buffers and queue its input copy,
    its replay and the copy of its valid output rows to the host."""
    done = graphs.slot_event(slot)
    with span("confignet.io.inputs"):
        done.synchronize()  # the slot's last chunk has left its buffers
        staged = [graphs.pinned((slot, "input", i), (rows,) + array.shape[1:],
                                torch.from_numpy(np.empty(0, array.dtype)).dtype)
                  for i, array in enumerate(arrays)]
        for buffer, array in zip(staged, arrays):
            _fill(buffer.numpy(), array, start, valid)
    out = graphs.run(name, fn, staged + list(extra), modules, non_blocking=True)
    out = out if isinstance(out, tuple) else (out,)
    with span("confignet.io.d2h"):
        host = []
        for i, tensor in enumerate(out):
            buffer = graphs.pinned((slot, "output", i), tuple(tensor.shape), host_dtype(tensor))
            buffer[:valid].copy_(tensor[:valid].to(buffer.dtype), non_blocking=True)
            host.append(buffer.numpy())
        done.record()  # on the current stream, the replay's
    return _Chunk(start, valid, tuple(host), done, out)


def _run_now(graphs: GraphCache, name, fn, arrays, extra, modules, rows: int, start: int,
             valid: int, mesh) -> _Chunk:
    """Run a chunk and bring its outputs to the host before returning."""
    with span("confignet.io.inputs"):
        pieces = []
        for array in arrays:
            piece = _fill(np.empty((rows,) + array.shape[1:], array.dtype), array, start, valid)
            pieces.append(torch.from_numpy(piece) if mesh is None else shard_batch(mesh, piece))
    out = graphs.run(name, fn, pieces + list(extra), modules)
    with span("confignet.io.d2h"):
        host = tuple(_host(all_gather_rows(mesh, tensor))
                     for tensor in (out if isinstance(out, tuple) else (out,)))
    return _Chunk(start, valid, host, None)


def _host(tensor: torch.Tensor) -> np.ndarray:
    """A chunk's output on the host, floats as float32."""
    return tensor.to(host_dtype(tensor)).cpu().numpy()


def _copy_out(chunk: _Chunk, results, n: int) -> Tuple[np.ndarray, ...]:
    """Wait for ``chunk`` and copy its valid rows into ``results`` (made at
    the first chunk, ``n`` rows each)."""
    with span("confignet.io.d2h"):
        if chunk.done is not None:
            chunk.done.synchronize()
        if results is None:
            results = tuple(np.empty((n,) + host.shape[1:], host.dtype) for host in chunk.host)
        for result, host in zip(results, chunk.host):
            result[chunk.start:chunk.start + chunk.valid] = host[:chunk.valid]
    return results
