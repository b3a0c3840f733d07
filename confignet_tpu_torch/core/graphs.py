"""Captured CUDA graphs, one per function and call shape: the port's
counterpart of ``jax.jit``'s cache.

The JAX package runs each path a user waits for (serving's chunks, the
trainer's renders and fused FID features, the encoder's chunks, each
fine-tune iteration, each train step of both stages and of the LatentGAN,
the LatentGAN's sampler) as one compiled program per call shape.  The port's
counterpart is a CUDA graph: :class:`GraphCache` captures a function at the
first call of a key and replays the graph at later calls, so a chunk costs
one graph launch and the copies of its inputs instead of hundreds of kernel
launches paced by the host.

The key is what jit's cache is keyed by: the caller's name for the function,
with every Python value the function closes over (a splice's
``param_name``); every input's shape and dtype; and the identity and
``data_ptr()`` of every parameter and buffer of the modules the function
reads; the addresses of the state it updates beside them (a train step's
optimizer moments and step counts); and the global settings that choose
kernels at capture (deterministic algorithms, cuDNN's flags, TF32).  A
module swapped for another, or a parameter rebound, so captures anew
instead of replaying
stale addresses; a graph of the same name and modules at old addresses is
dropped then, and a module's graphs are dropped when the module is.
Weights loaded in place (``load_state_dict``, the EMA update) keep their
addresses, and the graphs read the new values.

At the first call of a key the inputs are copied into buffers the cache
owns; the function runs once eagerly on the cache's side stream (lazy kernel
builds, cuDNN plans and constants come into being there, and its outputs are
the call's); then it is captured into the cache's memory pool with
``capture_error_mode="thread_local"``, so the data prefetch thread and the
checkpoint worker cannot break a capture.  Later calls copy their inputs into
those buffers (queued, where they come from pinned memory the caller keeps)
and replay.  A stateful step (:meth:`GraphCache.run_step`, a
train step) is captured one call later: its first call of a key runs
eagerly and may build state on the way (Adam's moments at a player's first
update), so the key is taken again after it, and the second call captures
and replays.  A function that draws random numbers names its
``torch.Generator`` objects; each is registered with the graph before
capture, so every replay draws the numbers the eager call would have drawn
next, and advances the generator as far.  A replay's outputs stay in the
graph's buffers until the next replay of any graph of the cache, so callers
copy them out at once (:func:`copy_out`), or queue their copy before the next
replay on the same stream (``core/chunks.py``, whose pinned staging buffers
and their events the cache keeps: :meth:`GraphCache.pinned`).  The kernel
wrappers' launch counters (``ops/launches.py``) count each replay as the
launches made into the capture.

CUDA refuses to destroy a graph while a stream captures, and a capture runs
Python that may collect garbage: a dead owner's cache, or a dead module's
graphs.  So graphs dropped while a capture is open wait in a list until it
ends, and are destroyed then.

A capture or a replay that fails raises; nothing falls back to eager on the
card.  On the CPU, and on the card inside :func:`eager`, every function runs
directly.

While a profiler records, a call on the card records the spans of
``core/tracing.py``: its key, the copies into the graph's inputs, the
replay, and a key's first calls (whose host seconds the
``graph.first_call_s`` counter sums, profiled or not).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, Hashable, Iterable, List, Sequence, Tuple

import torch

from confignet_tpu_torch.core.tracing import count, span
from confignet_tpu_torch.ops import cuda_build
from confignet_tpu_torch.ops.launches import add_launches, recorded_launches

# CUDA captures one graph at a time in a process; the checkpoint worker and
# the training thread may both reach a capture
_capture_lock = threading.Lock()
_eager_depth = 0


@contextlib.contextmanager
def eager():
    """While open, every cache runs its functions directly, op by op: the
    same paths uncaptured, for holding a captured path against its eager
    run."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


# graphs dropped while a capture was open, destroyed when it has ended
_buried: list = []


def _bury(entries) -> None:
    """Let dropped graphs go: at once, or after the open capture ends.  No
    lock is taken here: a collection may call this on a thread that holds
    any of them."""
    if _capture_lock.locked():
        _buried.append(entries)


def _release_buried() -> None:
    """Destroy the graphs dropped during a capture, once none is open."""
    while _buried and not _capture_lock.locked():
        _buried.pop()


@contextlib.contextmanager
def _first_call():
    """A key's first calls: a ``confignet.graph.first_call`` span, its host
    seconds added to the ``graph.first_call_s`` counter."""
    start = time.perf_counter()
    with span("confignet.graph.first_call"):
        yield
    count("graph.first_call_s", time.perf_counter() - start)


def module_key(modules: Iterable[torch.nn.Module]) -> tuple:
    """Each module's identity and the addresses of its parameters and
    buffers."""
    return tuple((id(m), tuple(t.data_ptr() for t in itertools.chain(m.parameters(), m.buffers())))
                 for m in modules)


def input_key(tensors: Sequence[torch.Tensor]) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def flatten(tree: Dict[str, Any]) -> Tuple[List[torch.Tensor], tuple]:
    """A dict of tensors and lists of tensors (a train step's batch) as its
    leaves, in key order, and its structure: each key with its list's
    length, or None for a tensor."""
    leaves: List[torch.Tensor] = []
    structure = []
    for name in sorted(tree):
        value = tree[name]
        if isinstance(value, (list, tuple)):
            leaves.extend(value)
            structure.append((name, len(value)))
        else:
            leaves.append(value)
            structure.append((name, None))
    return leaves, tuple(structure)


def unflatten(structure: tuple, leaves: Sequence[torch.Tensor]) -> Dict[str, Any]:
    """The dict that :func:`flatten` took apart."""
    out, at = {}, 0
    for name, n in structure:
        if n is None:
            out[name], at = leaves[at], at + 1
        else:
            out[name], at = list(leaves[at:at + n]), at + n
    return out


def copy_out(tree):
    """A nested dict of tensors with every tensor copied on its device: a
    replay's outputs, taken before the next replay overwrites them."""
    if isinstance(tree, dict):
        return {k: copy_out(v) for k, v in tree.items()}
    return tree.clone()


def host_dtype(tensor: torch.Tensor) -> torch.dtype:
    """The dtype of a tensor's copy on the host: floats as float32."""
    return torch.float32 if tensor.is_floating_point() else tensor.dtype


def _tensors(tree) -> Iterable[torch.Tensor]:
    """The tensors of a graph's inputs or outputs (a tensor, or tuples,
    lists and dicts of them)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list, dict)):
        for value in (tree.values() if isinstance(tree, dict) else tree):
            yield from _tensors(value)


def settings_key() -> tuple:
    """The global settings a capture bakes in: which convolution and
    reduction kernels run, and whether float32 products use TF32."""
    return (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@dataclass
class _Entry:
    graph: Any  # torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]
    outputs: Any
    launches: Tuple[int, ...]  # the kernels' launches of one replay, in LAUNCH_NAMES order


def _module_ids(key: tuple) -> tuple:
    return tuple(module_id for module_id, _ in key[1])


def _addresses(key: tuple) -> tuple:
    """The module and state addresses of a key."""
    return key[1], key[4]


def _forget_module(cache_ref, module_id: int) -> None:
    cache = cache_ref()
    if cache is not None:
        cache._watched.discard(module_id)
        cache._drop(lambda key: module_id in _module_ids(key))


class GraphCache:
    """The captured graphs of one owner (a server, a model, a checkpoint
    snapshot), sharing one memory pool and one capture stream."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._entries: Dict[tuple, _Entry] = {}
        self._warm = set()  # run_step's keys that have run once eagerly
        self._lock = threading.RLock()
        self._watched = set()
        self._pool = None
        self._stream = None
        # the chunk runner's pinned host buffers, by (place, shape, dtype),
        # and each slot's event, recorded behind the last chunk staged in it
        self._pinned: Dict[tuple, torch.Tensor] = {}
        self._slot_events: List["torch.cuda.Event"] = []
        self.captures = 0  # graphs captured over the cache's life
        self.capture_seconds = 0.0  # host time spent capturing them
        # a cache that dies mid-capture (a collection of its owner) keeps
        # its graphs until the capture ends
        weakref.finalize(self, _bury, self._entries)

    def __deepcopy__(self, memo) -> "GraphCache":
        """An empty cache: a copy of the owner reads other addresses, so
        its graphs are captured anew."""
        return GraphCache(self.device)

    @property
    def active(self) -> bool:
        """Whether calls capture and replay: on the card, outside
        :func:`eager`."""
        return self.device.type == "cuda" and _eager_depth == 0

    def __len__(self) -> int:
        return len(self._entries)

    def key(self, name: Hashable, modules: Sequence[torch.nn.Module] = (),
            tensors: Sequence[torch.Tensor] = (), state: Sequence[torch.Tensor] = ()) -> tuple:
        return (name, module_key(modules), input_key(tensors), settings_key(),
                tuple(t.data_ptr() for t in state))

    def captured(self, key: tuple) -> bool:
        return key in self._entries

    def discard(self, name: Hashable) -> None:
        """Drop the graphs of ``name``."""
        self._drop(lambda key: key[0] == name)

    def clear(self) -> None:
        """Drop every graph (and, with the last, the pool's memory)."""
        self._drop(lambda key: True)

    def run(self, name: Hashable, fn: Callable, tensors: Sequence[torch.Tensor],
            modules: Sequence[torch.nn.Module] = (), non_blocking: bool = False):
        """``fn(*tensors)`` on the cache's device, through the graph of
        (``name``, the modules' parameters, the tensors' shapes and dtypes).
        ``tensors`` may lie on the host; ``modules`` are every module ``fn``
        reads.  A replay returns the graph's own output buffers.
        ``non_blocking``: a replay's input copies are queued on the stream,
        not waited for (``tensors`` in pinned memory, left unchanged until
        the stream has passed them)."""
        if not self.active:
            return fn(*(t.to(self.device) for t in tensors))
        with span("confignet.graph.key"):
            key = self.key(name, modules, tensors)
        if key in self._entries:
            return self.replay(key, tensors, non_blocking)
        with _first_call():
            inputs = tuple(t.to(self.device, copy=True) for t in tensors)
            outputs = self.run_on_capture_stream(fn, *inputs)
            self.capture(key, fn, inputs, modules)
        return outputs

    def run_step(self, name: Hashable, fn: Callable, tensors: Sequence[torch.Tensor],
                 modules: Sequence[torch.nn.Module] = (),
                 state: Callable[[], Sequence[torch.Tensor]] = tuple,
                 generators: Sequence[torch.Generator] = ()):
        """``fn(*tensors)`` for a stateful step (a train step): as :meth:`run`,
        but the first call of a key runs ``fn`` eagerly, on the capture
        stream, and the key is taken again after it (``state()``: the
        tensors besides the modules' that ``fn`` updates in place, which the
        first call may create); the next call of that key captures and
        replays, later calls replay.  ``generators``: every
        ``torch.Generator`` ``fn`` draws from.  Returns the eager call's
        outputs or the graph's own buffers."""
        if not self.active:
            return fn(*(t.to(self.device) for t in tensors))
        with span("confignet.graph.key"):
            key = self.key(name, modules, tensors, state())
        if key in self._entries:
            return self.replay(key, tensors)
        with _first_call():
            if key not in self._warm:
                outputs = self.run_on_capture_stream(fn, *(t.to(self.device) for t in tensors))
                with self._lock:
                    self._warm.add(self.key(name, modules, tensors, state()))
                return outputs
            inputs = tuple(t.to(self.device, copy=True) for t in tensors)
            self.capture(key, fn, inputs, modules, generators)
        return self.replay(key)

    def run_on_capture_stream(self, fn: Callable, *args):
        """``fn(*args)`` run directly, on the card on the capture stream (a
        warm-up, or a step whose state the graph will then hold)."""
        if not self.active:
            return fn(*args)
        stream = self._capture_stream()
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = fn(*args)
        current.wait_stream(stream)
        return out

    def capture(self, key: tuple, fn: Callable, inputs: Sequence[torch.Tensor] = (),
                modules: Sequence[torch.nn.Module] = (),
                generators: Sequence[torch.Generator] = ()) -> None:
        """Capture ``fn(*inputs)`` as the graph of ``key``, with each of
        ``generators`` registered, so a replay draws afresh from it.  Capture
        runs nothing: the launches made into it are counted at each
        replay."""
        stream = self._capture_stream()
        graph = torch.cuda.CUDAGraph()
        for generator in generators:
            graph.register_generator_state(generator)
        start = time.perf_counter()
        try:
            with _capture_lock, torch.cuda.device(self.device):
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                stream.wait_stream(torch.cuda.current_stream(self.device))
                with cuda_build.recording_launches(stream.cuda_stream) as counts:
                    with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                          capture_error_mode="thread_local"):
                        outputs = fn(*inputs)
        finally:
            _release_buried()
        ids = _module_ids(key)
        with self._lock:
            # the same function over the same modules at old addresses
            self._drop(lambda k: k[0] == key[0] and _module_ids(k) == ids
                       and _addresses(k) != _addresses(key))
            self._entries[key] = _Entry(graph, tuple(inputs), outputs, recorded_launches(counts))
            self.captures += 1
            self.capture_seconds += time.perf_counter() - start
            for module in modules:
                if id(module) not in self._watched:
                    self._watched.add(id(module))
                    weakref.finalize(module, _forget_module, weakref.ref(self), id(module))

    def replay(self, key: tuple, tensors: Sequence[torch.Tensor] = (),
               non_blocking: bool = False):
        """Copy ``tensors`` into the graph's inputs, replay it on the current
        stream and return its outputs."""
        entry = self._entries[key]
        with span("confignet.io.h2d"):
            for static, tensor in zip(entry.inputs, tensors):
                static.copy_(tensor, non_blocking=non_blocking)
        with span("confignet.graph.launch"):
            entry.graph.replay()
            add_launches(entry.launches)
        return entry.outputs

    def launches(self, key: tuple) -> Tuple[int, ...]:
        """The kernels' launches of one replay of ``key``'s graph."""
        return self._entries[key].launches

    def launches_by_name(self) -> Dict[Hashable, Tuple[int, ...]]:
        """Each captured function's launches a replay, by its name."""
        return {key[0]: entry.launches for key, entry in list(self._entries.items())}

    def pinned(self, place: Hashable, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        """The pinned host buffer of ``shape`` and ``dtype`` at ``place`` (a
        staging slot and an input's or output's position): made at its first
        use, shared by every graph whose tensor at that place has that shape,
        and dropped with the last graph whose inputs or outputs (floats as
        float32) have it."""
        buffer = self._pinned.get((place, shape, dtype))
        if buffer is None:
            # a plain tensor, written in place by calls in and out of
            # inference mode
            with torch.inference_mode(False):
                buffer = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[(place, shape, dtype)] = buffer
        return buffer

    def slot_event(self, slot: int) -> "torch.cuda.Event":
        """The event behind the last chunk staged in ``slot`` (made unrecorded)."""
        while len(self._slot_events) <= slot:
            self._slot_events.append(torch.cuda.Event())
        return self._slot_events[slot]

    def _drop(self, which: Callable[[tuple], bool]) -> None:
        with self._lock:
            self._warm = {k for k in self._warm if not which(k)}
            _bury([self._entries.pop(key) for key in [k for k in self._entries if which(k)]])
            # a dropped buffer still in a queued copy is kept by the host
            # allocator until the copy is done
            used = {(tuple(t.shape), t.dtype) for entry in self._entries.values()
                    for t in _tensors(entry.inputs)}
            used |= {(tuple(t.shape), host_dtype(t)) for entry in self._entries.values()
                     for t in _tensors(entry.outputs)}
            self._pinned = {k: v for k, v in self._pinned.items() if k[1:] in used}

    def _capture_stream(self) -> "torch.cuda.Stream":
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream
