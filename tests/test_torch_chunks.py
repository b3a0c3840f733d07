"""The chunk runner (confignet_tpu_torch/core/chunks.py) that the server's
pipelines, ``generate_images``, ``encode_images`` and the fused FID features
share, held to a plain per-chunk loop: pad the last chunk by repeating its
last row, run each chunk, bring it to the host, concatenate, strip the
padding.

On the CPU the runner takes its synchronous path through a real
``GraphCache``, and its pipelined path through a cache that stands in for
the card's (plain buffers for the pinned ones, events that record nothing):
the same order of staging, replay and copy-out, with the two staging slots
taking turns.  The test marked ``gpu`` holds the pipelined runner on the
card against the plain loop over the same graphs, bit for bit, and checks
the pinned staging's life; it imports no JAX, so on a machine without it:
python -m pytest --noconftest -m gpu tests/test_torch_chunks.py
"""
import numpy as np
import pytest
import torch

from helpers import TINY_FIRST_STAGE_CONFIG
from confignet_tpu_torch.core import tracing
from confignet_tpu_torch.core.chunks import run_chunked
from confignet_tpu_torch.core.graphs import GraphCache
from confignet_tpu_torch.serving import ConfigNetServer
from confignet_tpu_torch.training.second_stage import ConfigNet

torch.set_num_threads(1)

CHUNK = 4


class _Event:
    def __init__(self):
        self.records = 0

    def record(self):
        self.records += 1

    def synchronize(self):
        pass


class _PipelinedCache(GraphCache):
    """A CPU cache that takes the runner's pipelined path: each call runs
    directly, its staging buffers are plain tensors kept as the card's
    pinned ones are."""

    def __init__(self):
        super().__init__("cpu")
        self.made = 0

    @property
    def active(self):
        return True

    def run(self, name, fn, tensors, modules=(), non_blocking=False):
        return fn(*tensors)

    def pinned(self, place, shape, dtype):
        if (place, shape, dtype) not in self._pinned:
            self._pinned[(place, shape, dtype)] = torch.empty(shape, dtype=dtype)
            self.made += 1
        return self._pinned[(place, shape, dtype)]

    def slot_event(self, slot):
        while len(self._slot_events) <= slot:
            self._slot_events.append(_Event())
        return self._slot_events[slot]


def _inputs(n, seed):
    """Two inputs of one shape and dtype (as a value row and a pose can be),
    and a uint8 one."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, 5)).astype(np.float32), rng.normal(size=(n, 5)).astype(np.float32),
            rng.integers(0, 200, (n, 2, 3), dtype=np.uint8)]


EXTRA = (torch.linspace(-1.0, 1.0, 5)[None],)

OUTPUTS = {
    "uint8": lambda x, z, y, e: (y.int() + (x.sum(1) > z.sum(1)).int()[:, None, None]).to(torch.uint8),
    "float32": lambda x, z, y, e: x * 2 + e - z,
    # float64 comes back as float32, beside a float32 output of its shape
    "tuple": lambda x, z, y, e: (x.double() * 2 + e, y.flip(1), z * 3),
}


def _plain_loop(fn, arrays, extra, chunk):
    """The per-chunk loop the runner replaced."""
    n = arrays[0].shape[0]
    outs = []
    for start in range(0, n, chunk):
        pieces = []
        for arr in arrays:
            piece = arr[start:start + chunk]
            pad = chunk - piece.shape[0]
            if pad:
                piece = np.concatenate([piece, np.repeat(piece[-1:], pad, axis=0)])
            pieces.append(torch.from_numpy(np.ascontiguousarray(piece)))
        out = fn(*pieces, *extra)
        outs.append(tuple((o.float() if o.is_floating_point() else o).numpy()
                          for o in (out if isinstance(out, tuple) else (out,))))
    result = tuple(np.concatenate([o[i] for o in outs])[:n] for i in range(len(outs[0])))
    return result if len(result) > 1 else result[0]


def _cache(kind):
    return GraphCache("cpu") if kind == "synchronous" else _PipelinedCache()


def _equal(a, b):
    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return len(a) == len(b) and all(x.dtype == y.dtype and np.array_equal(x, y)
                                    for x, y in zip(a, b))


@pytest.mark.parametrize("n", [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 5 * CHUNK + 3])
@pytest.mark.parametrize("outputs", list(OUTPUTS))
@pytest.mark.parametrize("path", ["synchronous", "pipelined"])
def test_runner_equals_the_plain_loop(n, outputs, path):
    fn = OUTPUTS[outputs]
    seen = []

    def recording(x, z, y, e):
        seen.append((x.clone(), z.clone(), y.clone()))
        return fn(x, z, y, e)

    arrays = _inputs(n, seed=n)
    cache = _cache(path)
    if n == 0:
        with pytest.raises(ValueError, match="no rows"):
            run_chunked(cache, "f", recording, arrays, EXTRA, chunk=CHUNK)
        return
    got = run_chunked(cache, "f", recording, arrays, EXTRA, chunk=CHUNK)
    assert _equal(got, _plain_loop(fn, arrays, EXTRA, CHUNK))
    # every chunk is full, its padding the last row repeated
    assert len(seen) == -(-n // CHUNK)
    for x, z, y in seen:
        assert x.shape[0] == z.shape[0] == y.shape[0] == CHUNK
    valid = n - (len(seen) - 1) * CHUNK
    for t in seen[-1]:
        assert all(torch.equal(row, t[valid - 1]) for row in t[valid:])
    if path == "pipelined":
        # two slots take turns; each chunk's event recorded once
        assert [e.records for e in cache._slot_events] == [-(-len(seen) // 2), len(seen) // 2][
            :min(len(seen), 2)]


@pytest.mark.parametrize("path", ["synchronous", "pipelined"])
def test_a_later_call_leaves_an_earlier_result_alone(path):
    cache = _cache(path)
    fn = OUTPUTS["tuple"]
    first_in, second_in = _inputs(2 * CHUNK + 1, 1), _inputs(2 * CHUNK + 1, 2)
    first = run_chunked(cache, "f", fn, first_in, EXTRA, chunk=CHUNK)
    kept = tuple(a.copy() for a in first)
    if path == "pipelined":
        made = cache.made
    second = run_chunked(cache, "f", fn, second_in, EXTRA, chunk=CHUNK)
    assert _equal(first, kept) and _equal(second, _plain_loop(fn, second_in, EXTRA, CHUNK))
    assert not any(np.shares_memory(a, b) for a in first for b in second)
    if path == "pipelined":
        # the staging is made at the first call and reused
        assert cache.made == made == 2 * (3 + 3)


@pytest.mark.parametrize("n, run", [(1, 4), (CHUNK, CHUNK), (5 * CHUNK + 3, 6 * CHUNK)])
def test_rows_are_counted_as_asked_and_as_run(n, run):
    before = dict(tracing.totals)
    run_chunked(GraphCache("cpu"), "f", OUTPUTS["uint8"], _inputs(n, 3), EXTRA, chunk=4)
    counted = tuple(tracing.totals.get(k, 0) - before.get(k, 0)
                    for k in ("rows.requested", "rows.run"))
    assert counted == (n, run)


def test_generate_images_of_no_latents_is_an_empty_uint8_array():
    model = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG), device="cpu")
    out = model.generate_images(np.zeros((0, model.config["latent_dim"]), np.float32),
                                np.zeros((0, 3), np.float32))
    assert out.dtype == np.uint8 and out.shape == (0,)


# -- on the card ---------------------------------------------------------------------------


def _photos(n, seed, size=128):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.mark.gpu
def test_card_pipelined_runner_equals_the_synchronous_loop():
    """At a served shape (the tiny model's 128px, chunks of 4, 11 rows: three
    chunks and a padded tail): the server's pipelined encode and generate
    against the plain loop replaying the same graphs, bit for bit; two calls
    back to back share no memory; a key's pinned staging is made once, kept
    over later calls, and dropped with the graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG, seed=3))
    rng = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for head in (model.real_encoder.feature_to_latent, model.real_encoder.rotation_regressor):
            head.weight.copy_(torch.randn(head.weight.shape, generator=rng) * 1e-6)
    server = ConfigNetServer(model, chunk=CHUNK)
    graphs = server._graphs
    n = 3 * CHUNK - 1
    photos = [_photos(n, 1), _photos(n, 2)]
    rotations = np.zeros((n, 3), np.float32)

    def plain(name, fn, modules, arrays):
        @torch.inference_mode()
        def run(*pieces):
            out = graphs.run(name, fn, pieces, modules)
            return tuple((o.float() if o.is_floating_point() else o).cpu()
                         for o in (out if isinstance(out, tuple) else (out,)))
        return _plain_loop(lambda *pieces: run(*pieces), arrays, (), CHUNK)

    encoded = server.encode(photos[0])  # captures
    staging = dict(graphs._pinned)
    assert staging and all(t.is_pinned() for t in staging.values())
    assert _equal(server.encode(photos[0]), encoded)
    assert _equal(encoded, plain("encode", server._encode, (server._encoder,), [photos[0]]))

    lat = [encoded[0], server.encode(photos[1])[0]]
    first = server.generate(lat[0], rotations)
    kept = first.copy()
    second = server.generate(lat[1], rotations)
    np.testing.assert_array_equal(first, kept)
    assert not np.shares_memory(first, second)
    for latents, got in zip(lat, (first, second)):
        want = plain("generate", server._generate, (server._generator,), [latents, rotations])
        assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)
    assert not np.array_equal(first, second)

    # the encoder's staging is kept, beside the generator's, and reused
    assert all(graphs._pinned[k] is t for k, t in staging.items())
    before = {k: t.data_ptr() for k, t in graphs._pinned.items()}
    server.generate(lat[0], rotations)
    server.encode(photos[1])
    assert {k: t.data_ptr() for k, t in graphs._pinned.items()} == before
    graphs.clear()
    assert graphs._pinned == {} and len(graphs) == 0
