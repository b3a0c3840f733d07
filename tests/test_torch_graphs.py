"""The port's graph cache (confignet_tpu_torch/core/graphs.py), the
counterpart of jax.jit's per-shape cache, and the paths that go through it.

On the CPU every path runs eagerly: these tests hold the cache's keys and
its launch accounting, the server's per-``param_name`` pipelines against the
JAX server, and the fine-tune's buffers, which are kept per image count and
reset in place at every call.  The tests marked ``gpu`` hold each captured
path against the same call run eagerly (``graphs.eager()``) on the card,
bit for bit, with the kernels' launches counted through the replays (a
stage-1 and a LatentGAN train step among them, over 3 steps whose draws
differ); they skip without a CUDA device.  Only the JAX comparison imports JAX (inside
the test), so on a machine without it:
python -m pytest --noconftest -m gpu tests/test_torch_graphs.py
"""
import contextlib
import copy
import gc
import types
import weakref

import numpy as np
import pytest
import torch

from helpers import FakeDataset, TINY_FIRST_STAGE_CONFIG
from confignet_tpu_torch.core import graphs
from confignet_tpu_torch.core.graphs import GraphCache
from confignet_tpu_torch.ops import cuda_build, launches
from confignet_tpu_torch.serving import ConfigNetServer
from confignet_tpu_torch.training.second_stage import ConfigNet
from confignet_tpu_torch.training.state import ema_update

torch.set_num_threads(1)


def _photos(n, seed, size=128):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


# -- the cache's keys and launch accounting (CPU) ---------------------------------------


def test_key_separates_names_shapes_dtypes_and_modules():
    model = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG), device="cpu")
    cache = GraphCache("cpu")
    gen = model.generator_smoothed
    lat, rot = torch.zeros((4, 10)), torch.zeros((4, 3))
    base = cache.key(("render_with_attribute", "blendshape_values"), (gen,), (lat, rot))
    assert base == cache.key(("render_with_attribute", "blendshape_values"), (gen,), (lat, rot))
    assert base != cache.key(("render_with_attribute", "head_hair_color"), (gen,), (lat, rot))
    assert base != cache.key(("render_with_attribute", "blendshape_values"), (gen,),
                             (torch.zeros((8, 10)), rot))
    assert base != cache.key(("render_with_attribute", "blendshape_values"), (gen,),
                             (lat.double(), rot))
    # a module swapped for an equal copy captures anew
    assert base != cache.key(("render_with_attribute", "blendshape_values"), (copy.deepcopy(gen),),
                             (lat, rot))
    # a parameter rebound to new storage too; weights loaded in place do not
    param = next(gen.parameters())
    with torch.no_grad():
        gen.load_state_dict({k: v + 1 for k, v in gen.state_dict().items()})
    assert base == cache.key(("render_with_attribute", "blendshape_values"), (gen,), (lat, rot))
    param.data = param.data.clone()
    assert base != cache.key(("render_with_attribute", "blendshape_values"), (gen,), (lat, rot))


def test_ema_update_keeps_the_ema_generators_graph_key():
    """The EMA update is in place, so the graphs keyed by the EMA generator
    stay valid across train steps and read the new weights."""
    model = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG), device="cpu")
    before = graphs.module_key([model.generator_smoothed])
    values = {k: v.clone() for k, v in model.generator_smoothed.state_dict().items()}
    with torch.no_grad():
        for p in model.generator.parameters():
            p.add_(0.25)
    ema_update(model.generator_smoothed, model.generator)
    assert graphs.module_key([model.generator_smoothed]) == before
    assert any(not torch.equal(v, values[k])
               for k, v in model.generator_smoothed.state_dict().items())


def test_cpu_cache_runs_directly_and_captures_nothing():
    cache = GraphCache("cpu")
    assert not cache.active
    calls = []

    def fn(a, b):
        calls.append(1)
        return a + b

    out = cache.run("add", fn, (torch.ones(2), torch.ones(2)))
    assert torch.equal(out, torch.full((2,), 2.0)) and calls == [1] and len(cache) == 0
    assert cache.captures == 0


def test_a_copied_model_starts_with_empty_caches():
    """A deep copy of a model reads other addresses: it keeps no graph of
    the original's."""
    model = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG), device="cpu")
    clone = copy.deepcopy(model)
    assert isinstance(clone._graphs, GraphCache) and clone._graphs is not model._graphs
    assert len(clone._graphs) == 0 and clone._graphs.device == model._graphs.device


class _FakeGraph:
    """Stands in for a torch.cuda.CUDAGraph: the tests watch when it dies."""


def _cache_with_a_fake_graph(module=None):
    cache = GraphCache("cpu")
    graph = _FakeGraph()
    key = cache.key("f", (module,) if module is not None else ())
    cache._entries[key] = graphs._Entry(graph, (), None, (0, 0, 0, 0))
    return cache, weakref.ref(graph)


def test_graphs_dropped_during_a_capture_live_until_it_ends():
    """CUDA refuses to destroy a graph while a stream captures: graphs
    dropped while a capture is open (a cache cleared, a watched module's
    finalizer, a dead owner collected) wait until it ends."""
    module = torch.nn.Linear(2, 2)
    cleared, cleared_graph = _cache_with_a_fake_graph()
    watched, watched_graph = _cache_with_a_fake_graph(module)
    owner = types.SimpleNamespace()
    owner.graphs, dead_graph = _cache_with_a_fake_graph()
    owner.itself = owner  # a cycle: only a collection frees it
    dead_cache = weakref.ref(owner.graphs)
    del owner
    with graphs._capture_lock:  # a capture is open
        cleared.clear()
        graphs._forget_module(weakref.ref(watched), id(module))
        gc.collect()
        assert dead_cache() is None and len(cleared) == 0 and len(watched) == 0
        assert cleared_graph() is not None and watched_graph() is not None
        assert dead_graph() is not None
        graphs._release_buried()  # still open: nothing goes
        assert cleared_graph() is not None and dead_graph() is not None
    graphs._release_buried()
    assert cleared_graph() is None and watched_graph() is None and dead_graph() is None
    assert graphs._buried == []


def test_graphs_dropped_outside_a_capture_go_at_once():
    cache, graph = _cache_with_a_fake_graph()
    cache.discard("f")
    assert graph() is None and graphs._buried == []
    cache, graph = _cache_with_a_fake_graph()
    del cache
    assert graph() is None and graphs._buried == []


def test_replay_accounting_adds_a_recorded_tuple():
    launches.zero_launch_counts()
    try:
        launches.add_launches((1, 0, 6, 0))
        launches.add_launches((1, 0, 6, 0))
        assert launches.launch_counts() == (2, 0, 12, 0)
        recorded = {w: n for w, n in zip(launches.KERNEL_WRAPPERS, (0, 0, 7, 7))}
        assert launches.recorded_launches(recorded) == (0, 0, 7, 7)
        assert launches.recorded_launches({}) == (0, 0, 0, 0)
        launches.add_launches(launches.recorded_launches(recorded))
        assert launches.launch_counts() == (2, 0, 19, 7)
    finally:
        launches.zero_launch_counts()


def test_recording_launches_is_one_at_a_time():
    with cuda_build.recording_launches(1234) as counts:
        assert counts == {}
        with pytest.raises(RuntimeError, match="already recording"):
            with cuda_build.recording_launches(5678):
                pass
    with cuda_build.recording_launches(1234):  # closed, so open again
        pass


# -- the server: one pipeline per param_name, against the JAX server (CPU) ---------------


def test_render_with_attribute_two_param_names_match_jax():
    """Two spliced attributes through one server: each param_name is its
    own pipeline (a closed-over value, part of the key), and each matches
    the JAX server at tests/test_torch_serving.py's bound."""
    from flax import traverse_util

    from confignet_tpu.serving import ConfigNetServer as JaxServer
    from confignet_tpu.training.second_stage import ConfigNet as JaxConfigNet

    def flat(tree):
        return {"/".join(path): np.array(leaf)
                for path, leaf in traverse_util.flatten_dict(tree).items()}

    jmodel = JaxConfigNet(dict(TINY_FIRST_STAGE_CONFIG))
    weights = jmodel.get_weights()
    enc = flat(weights["real_encoder"])
    rng = np.random.default_rng(0)
    for head, std in (("feature_to_latent", 1e-6), ("rotation_regressor", 3e-7)):
        enc[f"{head}/kernel"] = (rng.normal(size=enc[f"{head}/kernel"].shape) * std).astype(np.float32)
    weights["real_encoder"] = traverse_util.unflatten_dict({tuple(k.split("/")): v
                                                            for k, v in enc.items()})
    jmodel.set_weights(weights)
    jsrv = JaxServer(jmodel, chunk=4)
    model = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG), device="cpu")
    model.set_weights({**{name: flat(tree) for name, tree in weights.items()},
                       "generator": flat(jsrv._gen_params),
                       "generator_smoothed": flat(jsrv._gen_params),
                       "synthetic_encoder": flat(jsrv._synth_params),
                       "real_encoder": flat(jsrv._enc_params)})
    srv = ConfigNetServer(model, chunk=4, device="cpu")

    imgs = _photos(5, 7)
    values = {name: np.random.default_rng(8).uniform(0, 1, size=(1, dims[0])).astype(np.float32)
              for name, dims in model.config["facemodel_inputs"].items()}
    renders = {}
    for name, value in values.items():
        renders[name] = srv.render_with_attribute(imgs, name, value)
        want = jsrv.render_with_attribute(imgs, name, value)
        assert renders[name].shape == want.shape and renders[name].dtype == np.uint8
        assert np.mean(np.abs(renders[name].astype(int) - want.astype(int))) < 1.0, name
    assert not np.array_equal(*renders.values())


# -- the fine-tune's buffers, reset in place (CPU) --------------------------------------


def _fine_tune_result(model, img, n_iters):
    embeddings, rotations = model.fine_tune_on_img(img, n_iters=n_iters)
    tuned = {k: v.clone() for k, v in model._fine_tuned_generator_params.items()}
    return embeddings, rotations, [float(x) for x in model.fine_tune_losses], tuned


def _assert_same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]
    assert a[3].keys() == b[3].keys()
    for k in a[3]:
        assert torch.equal(a[3][k], b[3][k]), k


def test_fine_tune_twice_on_one_model_equals_two_fresh_models():
    """The second fine_tune_on_img call on a model reuses the first's
    variables, Adam and loss buffer, reset in place: it gives what a fresh
    model gives, so no state is left behind."""
    config = dict(TINY_FIRST_STAGE_CONFIG)
    first, second = _photos(1, 11)[0], _photos(1, 12)[0]
    reused = ConfigNet(config, device="cpu")
    a = _fine_tune_result(reused, first, 2)
    state = reused._fine_tune_states[(False, 1)]
    b = _fine_tune_result(reused, second, 3)
    assert reused._fine_tune_states[(False, 1)] is state  # the same buffers
    assert len(b[2]) == 3 and all(np.isfinite(b[2]))
    _assert_same(a, _fine_tune_result(ConfigNet(config, device="cpu"), first, 2))
    _assert_same(b, _fine_tune_result(ConfigNet(config, device="cpu"), second, 3))


# -- on the card: each captured path against its eager run ------------------------------


@pytest.fixture(scope="module")
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG, seed=3))
    # the zero-initialised encoder heads given seeded weights, so latents
    # and poses vary from photo to photo
    rng = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for head in (model.real_encoder.feature_to_latent, model.real_encoder.rotation_regressor):
            head.weight.copy_(torch.randn(head.weight.shape, generator=rng) * 1e-6)
    return model


def _eager_and_replayed(call):
    """(the call run eagerly, its first call through the cache, its second
    call's launches, its second call)."""
    with graphs.eager():
        eager = call()
    first = call()
    launches.zero_launch_counts()
    replayed = call()
    return eager, first, launches.launch_counts(), replayed


def _equal(a, b):
    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_card_server_replays_equal_eager(card_model):
    server = ConfigNetServer(card_model, chunk=4)
    imgs = _photos(6, 1)
    lat = np.random.default_rng(2).normal(size=(6, 10)).astype(np.float32)
    rot = np.zeros((6, 3), np.float32)
    blend = np.full((1, 8), 0.5, np.float32)
    forward = launches.unit_launches("forward", 128)
    for name, call, chunks in (
            ("encode", lambda: server.encode(imgs), 0),
            ("generate", lambda: server.generate(lat, rot), 2),
            ("render_with_attribute", lambda: server.render_with_attribute(
                imgs, "blendshape_values", blend), 2)):
        eager, first, counts, replayed = _eager_and_replayed(call)
        assert _equal(replayed, eager) and _equal(first, eager), name
        assert counts == launches.scaled(chunks, forward), name
    assert len(server._graphs) == 3
    # refresh() drops the graphs; the next render reflects the new weights
    before = server.generate(lat, rot)
    tuned = {k: v.clone() for k, v in card_model.generator_smoothed.state_dict().items()}
    tuned["learned_input"] += 0.5
    card_model._fine_tuned_generator_params = tuned
    try:
        server.refresh()
        assert len(server._graphs) == 0
        server.generate(lat, rot)
        after = server.generate(lat, rot)
        assert not np.array_equal(after, before)
        np.testing.assert_array_equal(after, card_model.generate_images(lat, rot, batch_chunk=4))
    finally:
        card_model._fine_tuned_generator_params = None


@pytest.mark.gpu
def test_card_model_paths_replay_equal_eager(card_model):
    from confignet_tpu_torch.metrics.inception import InceptionFeatureExtractor

    model = card_model
    imgs = _photos(5, 3)
    lat = np.random.default_rng(4).normal(size=(5, 10)).astype(np.float32)
    rot = np.zeros((5, 3), np.float32)
    model._inception_metric_object = types.SimpleNamespace(
        inception_feature_extractor=InceptionFeatureExtractor((128, 128, 3), dtype=torch.float32))
    forward = launches.unit_launches("forward", 128)
    for name, call, chunks in (
            ("generate_images", lambda: model.generate_images(lat, rot, batch_chunk=4), 2),
            ("metric_features", lambda: model._metric_features_for_latents(lat, rot, batch_chunk=4),
             2),
            ("encode_images", lambda: model.encode_images(imgs, batch_chunk=4), 0)):
        eager, first, counts, replayed = _eager_and_replayed(call)
        assert _equal(replayed, eager) and _equal(first, eager), name
        assert counts == launches.scaled(chunks, forward), name
    # the EMA generator's graph stays valid over an in-place EMA update and
    # renders the new weights
    key_graphs = len(model._graphs)
    with torch.no_grad():
        for p in model.generator.parameters():
            p.add_(0.01)
    ema_update(model.generator_smoothed, model.generator, alpha=0.5)
    with graphs.eager():
        eager = model.generate_images(lat, rot, batch_chunk=4)
    np.testing.assert_array_equal(model.generate_images(lat, rot, batch_chunk=4), eager)
    assert len(model._graphs) == key_graphs


@pytest.mark.gpu
def test_card_fine_tune_replays_equal_eager(card_model):
    """Each iteration's loss and the final variables: the captured
    iterations against eager ones, under deterministic algorithms (two
    eager runs agree bit for bit first)."""
    photo = _photos(1, 9)[0]
    n_iters = 4
    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = []
        for mode in ("eager", "eager", "graph"):
            launches.zero_launch_counts()
            with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                runs.append(_fine_tune_result(card_model, photo, n_iters))
            assert launches.launch_counts() == launches.scaled(
                n_iters, launches.unit_launches("fine_tune_iteration", 128)), mode
        _assert_same(runs[0], runs[1])
        _assert_same(runs[2], runs[0])
        key = card_model._fine_tune_graph_key(False, 1)
        assert card_model._graphs.captured(key)
        assert card_model._graphs.launches(key) == launches.unit_launches("fine_tune_iteration", 128)
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1])
        card_model._fine_tuned_generator_params = None




@pytest.mark.gpu
def test_card_capture_survives_a_dead_owners_collection():
    """A collection during a capture frees a dead owner's cache (a cycle);
    its graphs are destroyed after the capture ends, which then replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda")
    layer = torch.nn.Linear(8, 8).to(device)
    x = torch.randn(4, 8, device=device)
    live = GraphCache(device)

    def collecting(x):
        gc.collect()
        return layer(x) * 2

    enabled = gc.isenabled()
    gc.disable()  # only the capture's own collection may free the owner
    try:
        with torch.no_grad():
            static = x.clone()
            live.run_on_capture_stream(collecting, static)
            owner = types.SimpleNamespace(graphs=GraphCache(device))
            owner.itself = owner
            owner.graphs.run("f", layer, (x,), (layer,))
            owner.graphs.run("f", layer, (x,), (layer,))
            assert len(owner.graphs) == 1
            dead = weakref.ref(owner.graphs)
            del owner
            key = live.key("g", (layer,), (static,))
            live.capture(key, collecting, (static,), (layer,))
            assert dead() is None and graphs._buried == []
            out = live.replay(key, (x + 1,))
            torch.testing.assert_close(out, layer(x + 1) * 2, rtol=0, atol=0)
    finally:
        if enabled:
            gc.enable()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _captured_steps(model, step, inputs, label):
    """bench_train.captured_against_eager: the steps on ``inputs[1:]``
    through the graph equal to the eager steps bit for bit; returns the
    check's record."""
    from confignet_tpu_torch.apps import bench_train

    return bench_train.captured_against_eager(model, step, inputs, label)


@pytest.mark.gpu
def test_card_stage1_step_replays_equal_eager():
    """A stage-1 train step: 3 steps through its graph (the first captures)
    against 3 eager steps from the same state and draws, under
    deterministic algorithms: every parameter, Adam moment and count, the
    EMA generator, every loss and the draw generator after each step equal,
    the draws moving at every step, with a train step's launches a replay."""
    from confignet_tpu_torch.training.first_stage import ConfigNetFirstStage

    _need_card()
    model = ConfigNetFirstStage(dict(TINY_FIRST_STAGE_CONFIG, seed=4))
    dataset = FakeDataset(n_images=8, img_size=128)
    step = model._build_train_step()
    batches = [model._sample_host_batch(dataset, dataset) for _ in range(4)]
    check = _captured_steps(model, step, batches, "stage-1 step")
    assert check["launches"] == launches.scaled(3, launches.unit_launches("train_step", 128))
    assert len(step.graphs) == 1
    losses = [step(b)["d"]["loss_sum"].item() for b in batches[:2]]
    assert losses[0] != losses[1]


@pytest.mark.gpu
def test_card_latent_gan_step_replays_equal_eager():
    """The LatentGAN step, as the stage-1 step above, on one batch of
    embeddings at every step: only the draws differ between its steps, and
    so do their losses."""
    from confignet_tpu_torch.training.latent_gan import LatentGAN

    _need_card()
    gan = LatentGAN({"latent_dim": 12, "batch_size": 8})
    real = torch.from_numpy(np.random.default_rng(5).normal(size=(8, 12)).astype(np.float32))
    step = gan._build_train_step()
    check = _captured_steps(gan, step, [real.cuda() for _ in range(4)], "latent GAN step")
    assert check["steps"] == 3 and check["launches"] == (0, 0, 0, 0)
    replayed = [step(real.cuda())["g"]["loss_sum"].item() for _ in range(2)]
    assert replayed[0] != replayed[1]
