"""The port's data parallelism (``confignet_tpu_torch/parallel``) over a
2-process gloo group on the CPU, against the JAX package.

Each test writes its inputs, starts two ranks of
``tests/torch_parallel_child.py`` (a script, run with ``sys.executable``,
that imports the port only) and compares what they write back:

1. ``process_slice``, ``shard_batch`` (both ``local_rows`` modes, batch axes
   0 and 1), ``replicate``, ``all_reduce_mean``, ``all_gather_rows`` and the
   differentiable ``all_reduce_sum``, each held to its JAX counterpart on the
   8-device CPU mesh of ``tests/conftest.py``: rank r of 2 holds what devices
   4r..4r+3 hold.  Also the size-1 mesh (no process group): the identity,
   with no collective launched.
2. A size-1 mesh trains bit-equal to ``mesh=None`` (one stage-1 step, in
   this process).
3. A 2-rank stage-1 step and a 2-rank stage-2 step, at global batch 4 (2
   rows a rank), against the JAX single-device step at batch 4 from the
   same weights, host batch (``_batch_rng = RandomState(0)``) and global
   draws, with the tolerances of ``tests/test_torch_train.py`` and
   ``tests/test_torch_second_stage.py``: losses (the mean of the ranks')
   rtol 1e-4; gradients read as Adam first moments (beta_1 = 0), per player
   a relative L2 distance below 1e-3 and per leaf rtol 1e-3 with atol 1e-4
   of the leaf's largest value, ResNet50 trunk leaves each within 1e-3
   relative L2; the EMA atol 1e-6.  The two ranks end bit-equal, and each
   rank's host batch is byte-equal to its rows of the global one.
4. A 2-rank ``fine_tune_on_img`` on 2 images (one a rank) against the JAX
   single-device fine-tune on them, with the tolerances of
   ``tests/test_torch_fine_tune.py``, and JAX's ValueError for 3 images.
5. A 2-rank ``ConfigNetServer(chunk=4)`` against the JAX server over a
   4-device mesh, with the tolerances of ``tests/test_torch_serving.py``,
   and JAX's ValueError for a chunk of 3.
6. A 2-rank ``train()`` of 3 steps, checkpoints every 2: both ranks run
   the checkpoint block and score alike, rank 0 writes the files, rank 1
   writes nothing, and the logged losses are the means of the ranks' own.
   Also: the children initialise their group as the training CLI does with
   ``--device cpu``, and the backend follows the device with a card
   visible.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from flax import traverse_util

import confignet_tpu.training.first_stage as jax_first_stage
import confignet_tpu.training.second_stage as jax_second_stage
from confignet_tpu.parallel import (
    batch_sharding, create_mesh as jax_create_mesh, replicate as jax_replicate,
    shard_batch as jax_shard_batch)
from confignet_tpu.serving import ConfigNetServer as JaxServer
from helpers import FakeDataset, TINY_FIRST_STAGE_CONFIG
from confignet_tpu_torch.core.model_io import export_jax_params
from confignet_tpu_torch.parallel import (
    Mesh, all_gather_rows, all_reduce_mean, all_reduce_sum, create_mesh,
    maybe_initialize_distributed, process_slice, replicate)
from confignet_tpu_torch.training.first_stage import PLAYER_TREES, ConfigNetFirstStage
from confignet_tpu_torch.training.second_stage import ConfigNet

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CHILD = REPO / "tests" / "torch_parallel_child.py"
WORLD = 2
BATCH = TINY_FIRST_STAGE_CONFIG["batch_size"]  # 4: 4 % (2 * WORLD) == 0
STAGE2_CONFIG = dict(TINY_FIRST_STAGE_CONFIG, pixel_loss_weight=2.0, encoder_inversion_weight=3.0)
# stage 2's flips: D reals, synth-D reals, latent-D reals (BATCH each), G reals (BATCH // 2)
STAGE2_FLIPS = [np.array([True, False, True, False]), np.array([False, True, True, False]),
                np.array([True, True, False, False]), np.array([False, True])]
LR = 1e-4  # the fine-tune's Adam


def _flat(tree):
    return {"/".join(path): np.array(leaf) for path, leaf in traverse_util.flatten_dict(tree).items()}


def _unflat(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def _pack(out, prefix, trees):
    for tree, leaves in trees.items():
        for path, value in leaves.items():
            out[f"{prefix}|{tree}|{path}"] = np.asarray(value)


def _unpack(arrays, prefix):
    trees = {}
    for key, value in arrays.items():
        if key.startswith(prefix + "|"):
            _, tree, path = key.split("|", 2)
            trees.setdefault(tree, {})[path] = value
    return trees


def _dataset_arrays(dataset):
    out = {"data/imgs": dataset.imgs, "data/eye_masks": dataset.eye_masks}
    out.update({f"data/meta/{k}": v for k, v in dataset.metadata_inputs.items()})
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(mode, workdir, inputs, config):
    """Start the two ranks of ``mode`` with torchrun's environment (they run
    while the caller computes the JAX reference); :func:`_collect` waits
    for them."""
    np.savez(workdir / "inputs.npz", **inputs)
    (workdir / "config.json").write_text(json.dumps(config))
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    return [subprocess.Popen([sys.executable, str(CHILD), mode, str(workdir)], cwd=REPO,
                             env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(WORLD)]


def _collect(procs, workdir, timeout=300):
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
            proc.communicate(timeout=30)
        pytest.fail("the ranks timed out:\n" + "\n".join(outputs))
    for rank, (proc, out) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0 and f"CHILD_OK {rank}" in out, out[-4000:]
    results = []
    for rank in range(WORLD):
        with np.load(workdir / f"result_{rank}.npz") as npz:
            results.append(dict(npz))
    return results


def _rows(garr, rank, axis=0):
    """Rank ``rank``'s share of a JAX array sharded over the 8-device mesh:
    what devices 4 * rank .. 4 * rank + 3 hold, in order."""
    shards = sorted(garr.addressable_shards, key=lambda s: s.index[axis].start)
    per = len(shards) // WORLD
    return np.concatenate([np.asarray(s.data) for s in shards[rank * per:(rank + 1) * per]],
                          axis=axis)


# ---------------------------------------------------------------------------
# 1. the primitives
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def primitives(tmp_path_factory):
    rng = np.random.default_rng(0)
    inputs = {"x": rng.normal(size=(8, 3, 5)).astype(np.float32),
              "x1": rng.normal(size=(2, 8, 4)).astype(np.float32)}
    for rank in range(WORLD):
        inputs[f"rank{rank}"] = rng.normal(size=(3, 5)).astype(np.float32)
        inputs[f"c{rank}"] = rng.normal(size=(3, 5)).astype(np.float32)
    workdir = tmp_path_factory.mktemp("primitives")
    return inputs, _collect(_launch("primitives", workdir, inputs, {}), workdir)


def test_process_slice_matches_the_jax_sharding(primitives):
    inputs, results = primitives
    devices = batch_sharding(jax_create_mesh()).devices_indices_map((8,))
    ordered = [devices[d][0] for d in jax.devices()]
    for rank, result in enumerate(results):
        mine = ordered[4 * rank:4 * rank + 4]
        np.testing.assert_array_equal(result["slice"], [mine[0].start, mine[-1].stop])
        assert str(result["slice_error"]) == \
            "global batch rows (3) must divide evenly over 2 processes"
    with pytest.raises(ValueError):  # JAX cannot shard 3 rows over its mesh either
        jax_shard_batch(jax_create_mesh(), np.zeros((3, 2), np.float32))


def test_shard_batch_matches_jax(primitives):
    inputs, results = primitives
    jmesh = jax_create_mesh()
    x, x1 = inputs["x"], inputs["x1"]
    jtree = jax_shard_batch(jmesh, {"a": x, "t": (x, x1[0])})
    j_axis1 = jax_shard_batch(jmesh, x1, batch_axis=1)
    for rank, result in enumerate(results):
        want = _rows(jtree["a"], rank)
        np.testing.assert_array_equal(result["shard/a"], want)
        np.testing.assert_array_equal(result["shard/t0"], _rows(jtree["t"][0], rank))
        np.testing.assert_array_equal(result["shard/t1"], _rows(jtree["t"][1], rank))
        np.testing.assert_array_equal(result["shard_local"], want)
        np.testing.assert_array_equal(result["shard_axis1"], _rows(j_axis1, rank, axis=1))
        np.testing.assert_array_equal(result["shard_local_axis1"], _rows(j_axis1, rank, axis=1))


def test_replicate_matches_jax(primitives):
    inputs, results = primitives
    jw = jax_replicate(jax_create_mesh(), inputs["rank0"])
    torch.manual_seed(0)
    linear = torch.nn.Linear(3, 2)
    want_module = np.concatenate([p.detach().numpy().ravel() for p in linear.parameters()])
    for result in results:
        for shard in jw.addressable_shards:
            np.testing.assert_array_equal(result["replicate/w"], np.asarray(shard.data))
        np.testing.assert_array_equal(result["replicate/u"], inputs["rank0"].astype(np.float64) * 2)
        assert result["replicate/u"].dtype == np.float64
        np.testing.assert_array_equal(result["replicate/module"], want_module)


def test_reductions_match_jax(primitives):
    inputs, results = primitives
    stacked = np.stack([inputs["rank0"], inputs["rank1"]])
    jmean = jax.jit(lambda a: a.mean(axis=0))(
        jax_shard_batch(jax_create_mesh(jax.devices()[:2]), stacked))
    jgathered = np.asarray(jax_shard_batch(jax_create_mesh(), inputs["x"]))
    for result in results:
        np.testing.assert_allclose(result["mean/f32"], np.asarray(jmean), rtol=1e-7)
        np.testing.assert_allclose(result["mean/f64"], 3 * stacked.astype(np.float64).mean(0),
                                   rtol=1e-15)
        np.testing.assert_array_equal(result["gather"], jgathered)
        np.testing.assert_allclose(result["sum/value"], stacked.sum(0), rtol=1e-7)
        np.testing.assert_allclose(result["sum/grad"], inputs["c0"] + inputs["c1"], rtol=1e-7)
        # sorted names: all_gather_rows, all_reduce_mean, all_reduce_sum, broadcast;
        # one collective a dtype, the sum's forward and backward
        np.testing.assert_array_equal(result["launches"], [1, 2, 2, 3])


def test_cpu_ranks_initialise_gloo_beside_a_card(primitives, monkeypatch):
    # the children initialise as the training CLI does with --device cpu
    _, results = primitives
    assert [str(result["backend"]) for result in results] == ["gloo"] * WORLD
    # with a card visible the backend still follows the device: gloo for the
    # CPU, NCCL on cuda:LOCAL_RANK for the card
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda index: calls.append(("device", index)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda backend: calls.append(("init", backend)))
    for name, value in (("WORLD_SIZE", "2"), ("RANK", "1"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(name, value)
    maybe_initialize_distributed("cpu")
    assert calls == [("init", "gloo")]
    calls.clear()
    maybe_initialize_distributed()
    assert calls == [("device", 1), ("init", "nccl")]
    calls.clear()
    monkeypatch.delenv("WORLD_SIZE")  # not under torchrun: nothing
    maybe_initialize_distributed("cpu")
    assert calls == []


def test_size_one_mesh_is_the_identity():
    mesh = create_mesh(device="cpu")
    assert (mesh.group, mesh.size, mesh.rank, mesh.device) == (None, 1, 0, torch.device("cpu"))
    assert process_slice(3, mesh) == slice(None) == process_slice(3, None)
    a, b = torch.randn(3, 2), torch.randn(4, dtype=torch.float64)
    before = a.clone(), b.clone()
    got = all_reduce_mean(mesh, [a, b])
    assert got[0] is a and got[1] is b and torch.equal(a, before[0]) and torch.equal(b, before[1])
    assert all_gather_rows(mesh, a) is a and all_reduce_sum(mesh, a) is a
    linear = torch.nn.Linear(2, 2)
    assert replicate(mesh, linear) is linear
    assert mesh.launches == {"all_reduce_mean": 0, "all_reduce_sum": 0, "all_gather_rows": 0,
                             "broadcast": 0}


# ---------------------------------------------------------------------------
# 2.-3. training steps
# ---------------------------------------------------------------------------

def _stage1_draws(latent_dim):
    """The stage-1 step's global draws in call order (tests/test_torch_train.py)."""
    rng = np.random.default_rng(0)
    n_real = BATCH - BATCH // 2
    latents = [rng.normal(size=(n, latent_dim)).astype(np.float32) for n in (BATCH, BATCH, n_real)]
    scale = np.array([np.pi / 6, np.pi / 18, 0.0], np.float32)
    rotations = [(rng.uniform(-1, 1, size=(n, 3)) * scale).astype(np.float32)
                 for n in (BATCH, n_real)]
    flips = [np.array([True, False, True, False]), np.array([False, True, True, False])]
    return latents, rotations, flips


def _feeder(arrays, convert):
    queue = list(arrays)

    def draw(*args):
        n = args[-1]
        value = queue.pop(0)
        assert value.shape[0] == n, (value.shape, n)
        return convert(value)

    draw.remaining = queue
    return draw


def test_size_one_mesh_step_is_bit_equal_to_no_mesh():
    dataset = FakeDataset(n_images=8, img_size=128)
    latents, rotations, flips = _stage1_draws(10)
    results = []
    for mesh in (None, create_mesh(device="cpu")):
        model = ConfigNetFirstStage(dict(TINY_FIRST_STAGE_CONFIG), device="cpu")
        model._use_mesh(mesh)
        model._batch_rng = np.random.RandomState(0)
        model._sample_latent = _feeder(latents, torch.from_numpy)
        model._sample_rotations = _feeder(rotations, torch.from_numpy)
        model._flip_mask = _feeder(flips, torch.from_numpy)
        losses = model._build_train_step()(model._sample_host_batch(dataset, dataset))
        results.append((losses, model.first_moments(), model.get_weights()))
    (losses_a, moments_a, weights_a), (losses_b, moments_b, weights_b) = results
    for group, values in losses_a.items():
        for key, value in values.items():
            assert torch.equal(value, losses_b[group][key]), (group, key)
    for a, b in ((moments_a, moments_b), (weights_a, weights_b)):
        flat_a, flat_b = _flat(a), _flat(b)
        assert set(flat_a) == set(flat_b)
        for key, value in flat_a.items():
            np.testing.assert_array_equal(flat_b[key], value, err_msg=key)


def _jax_moments(state, player_trees):
    moments = {}
    for player, trees in player_trees.items():
        mu = getattr(state, player).opt_state[0].mu  # optax adam: (ScaleByAdamState, ...)
        moments[player] = ({tree: _flat(mu[tree]) for tree in trees}
                           if player == "generator" else {player: _flat(mu)})
    return moments


def _losses(groups):
    return {g: {k: float(v) for k, v in d.items()} for g, d in groups.items()}


def _stage1(workdir):
    dataset = FakeDataset(n_images=8, img_size=128)
    jmodel = jax_first_stage.ConfigNetFirstStage(dict(TINY_FIRST_STAGE_CONFIG))
    latents, rotations, flips = _stage1_draws(jmodel.config["latent_dim"])
    weights = {name: _flat(tree) for name, tree in jmodel.get_weights().items()}
    vgg_params = jmodel.perceptual_loss.variables["params"]
    jmodel._batch_rng = np.random.RandomState(0)
    batch = jmodel._sample_host_batch(dataset, dataset)

    inputs = _dataset_arrays(dataset)
    _pack(inputs, "weights", weights)
    _pack(inputs, "vgg", {"vgg": _flat(vgg_params)})
    for name, arrays in (("latents", latents), ("rotations", rotations), ("flips", flips)):
        inputs.update({f"{name}/{i}": a for i, a in enumerate(arrays)})
    config = dict(TINY_FIRST_STAGE_CONFIG, rotation_resample_train="kernel_train",
                  adain_impl="kernel")
    procs = _launch("stage1", workdir, inputs, config)

    j_latent, j_rot = _feeder(latents, jnp.asarray), _feeder(rotations, jnp.asarray)
    jmodel._sample_latent_on_device = j_latent
    jmodel._sample_rotations_on_device = j_rot
    flip_queue = list(flips)
    hflip = jax_first_stage.batched_hflip
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_first_stage, "batched_hflip",
                      lambda images, mask: hflip(images, jnp.asarray(flip_queue.pop(0))))
        state, jlosses = jmodel._build_train_step()(jmodel.state, jmodel.keychain.next(), batch,
                                                    vgg_params)
    assert not (j_latent.remaining or j_rot.remaining or flip_queue)
    jax_result = dict(losses=_losses(jlosses), moments=_jax_moments(state, PLAYER_TREES),
                      ema=_flat(state.generator_smoothed), batch=batch)
    return jax_result, _collect(procs, workdir)


def _stage2(workdir):
    dataset = FakeDataset(n_images=8, img_size=128)
    jmodel = jax_second_stage.ConfigNet(dict(STAGE2_CONFIG))
    weights = jmodel.get_weights()
    enc = _flat(weights["real_encoder"])
    rng = np.random.default_rng(0)  # seeded heads, as tests/test_torch_second_stage.py gives them
    for head, std in (("feature_to_latent", 1e-6), ("rotation_regressor", 3e-7)):
        enc[f"{head}/kernel"] = (rng.normal(size=enc[f"{head}/kernel"].shape) * std).astype(np.float32)
    jmodel.set_weights({**weights, "real_encoder": _unflat(enc)})
    weights = {name: _flat(tree) for name, tree in jmodel.get_weights().items()}
    vgg = jmodel.perceptual_loss.variables["params"]
    vggface = jmodel.perceptual_loss_face_reco.variables["params"]
    jmodel._batch_rng = np.random.RandomState(0)
    batch = jmodel._sample_host_batch(dataset, dataset)

    inputs = _dataset_arrays(dataset)
    _pack(inputs, "weights", weights)
    _pack(inputs, "vgg", {"vgg": _flat(vgg)})
    _pack(inputs, "vggface", {"vggface": _flat(vggface)})
    inputs.update({f"flips/{i}": a for i, a in enumerate(STAGE2_FLIPS)})
    procs = _launch("stage2", workdir, inputs, dict(STAGE2_CONFIG, rotation_resample_train="gather"))

    flip_queue = list(STAGE2_FLIPS)
    hflip = jax_second_stage.batched_hflip
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_second_stage, "batched_hflip",
                      lambda images, mask: hflip(images, jnp.asarray(flip_queue.pop(0))))
        state, jlosses = jmodel._build_train_step()(jmodel.state, jmodel.keychain.next(), batch,
                                                    vgg, vggface)
    assert not flip_queue
    jax_result = dict(losses=_losses(jlosses), moments=_jax_moments(state, ConfigNet.PLAYER_TREES),
                      ema=_flat(state.generator_smoothed), batch=batch)
    return jax_result, _collect(procs, workdir)


@pytest.fixture(scope="module", params=["stage1", "stage2"])
def stepped(request, tmp_path_factory):
    run = _stage1 if request.param == "stage1" else _stage2
    return request.param, run(tmp_path_factory.mktemp(request.param))


def test_step_losses_are_jax_global_losses(stepped):
    _, (jax_result, results) = stepped
    for group, want in jax_result["losses"].items():
        for key, value in want.items():
            got = np.mean([float(r[f"loss/{group}/{key}"]) for r in results])
            np.testing.assert_allclose(got, value, rtol=1e-4, err_msg=f"{group}/{key}")


def test_step_gradients_are_jax_global_gradients(stepped):
    stage, (jax_result, results) = stepped
    player_trees = PLAYER_TREES if stage == "stage1" else ConfigNet.PLAYER_TREES
    for player in player_trees:
        want_trees = jax_result["moments"][player]
        got_trees = _unpack(results[0], f"moments:{player}")
        assert set(got_trees) == set(want_trees)
        keys = []
        for tree, want in want_trees.items():
            got = got_trees[tree]
            assert set(got) == set(want), tree
            for key, value in want.items():
                if tree == "real_encoder" and key.startswith("resnet/"):
                    # the trunk: relative L2 (tests/test_torch_second_stage.py)
                    assert np.linalg.norm(got[key] - value) < 1e-3 * np.linalg.norm(value), key
                    continue
                keys.append((tree, key))
                assert np.abs(value).max() > 0, f"{tree}/{key} has no gradient"
                np.testing.assert_allclose(got[key], value, rtol=1e-3,
                                           atol=1e-4 * np.abs(value).max(),
                                           err_msg=f"{player}: {tree}/{key}")
        want_all = np.concatenate([want_trees[t][k].ravel() for t, k in keys])
        got_all = np.concatenate([got_trees[t][k].ravel() for t, k in keys])
        assert np.linalg.norm(got_all - want_all) < 1e-3 * np.linalg.norm(want_all), player


def test_step_ema_matches_jax_and_ranks_stay_equal(stepped):
    _, (jax_result, results) = stepped
    ema = _unpack(results[0], "weights")["generator_smoothed"]
    assert set(ema) == set(jax_result["ema"])
    for key, value in jax_result["ema"].items():
        np.testing.assert_allclose(ema[key], value, atol=1e-6, err_msg=key)
    rank0, rank1 = results
    state_keys = [k for k in rank0 if k.startswith(("weights|", "moments:"))]
    assert len(state_keys) > 100 and set(state_keys) <= set(rank1)
    for key in state_keys:
        np.testing.assert_array_equal(rank1[key], rank0[key], err_msg=key)


def test_step_host_batches_are_the_ranks_rows(stepped):
    _, (jax_result, results) = stepped
    batch = jax_result["batch"]
    for rank, result in enumerate(results):
        for key, value in batch.items():
            leaves = value if isinstance(value, tuple) else (value,)
            for i, leaf in enumerate(leaves):
                leaf = np.asarray(leaf)
                # a mesh object standing for this rank (no process group)
                rows = process_slice(leaf.shape[0], Mesh(None, WORLD, rank, "cpu"))
                got = result[f"batch/{key}/{i}"]
                assert got.dtype == leaf.dtype and got.shape[0] == leaf.shape[0] // WORLD, key
                np.testing.assert_array_equal(got, leaf[rows], err_msg=key)


# ---------------------------------------------------------------------------
# 4. the fine-tune
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fine_tuned(tmp_path_factory):
    jmodel = jax_second_stage.ConfigNet(dict(TINY_FIRST_STAGE_CONFIG))
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (WORLD, 128, 128, 3), dtype=np.uint8)
    # Both packages start from the same pinned encodings (as the one-iteration
    # test of tests/test_torch_fine_tune.py does): the zero-initialised
    # encoder heads would give every photo the same latent and a zero pose,
    # where the trilinear resample's gradient is one-sided.
    embeddings = rng.normal(size=(WORLD, jmodel.config["latent_dim"])).astype(np.float32)
    rotations = (rng.uniform(-1, 1, (WORLD, 3)) * [np.pi / 6, np.pi / 18, 0]).astype(np.float32)
    jmodel.encode_images = lambda *args, **kwargs: (embeddings.copy(), rotations.copy())
    inputs = {"images": images, "encodings/embeddings": embeddings,
              "encodings/rotations": rotations}
    _pack(inputs, "weights", {name: _flat(tree) for name, tree in jmodel.get_weights().items()})
    _pack(inputs, "vgg", {"vgg": _flat(jmodel.perceptual_loss.variables["params"])})
    _pack(inputs, "vggface", {"vggface": _flat(jmodel.perceptual_loss_face_reco.variables["params"])})
    workdir = tmp_path_factory.mktemp("fine_tune")
    procs = _launch("fine_tune", workdir, inputs, dict(TINY_FIRST_STAGE_CONFIG))

    # one iteration, as JAX's fine_tune_on_img builds it (second_stage.py:685-752)
    floats = (images / 127.5 - 1.0).astype(np.float32)
    idxs = jmodel.get_facemodel_param_idxs_in_latent("blendshape_values")
    mean = np.mean(embeddings, axis=0, keepdims=True)
    opt_vars = {"generator": jax.device_get(jmodel.state.generator_smoothed),
                "pre_expr": mean[:, :idxs.start], "expr": embeddings[:, idxs.start:idxs.stop],
                "post_expr": mean[:, idxs.stop:], "rotations": rotations}
    opt_vars = jax.tree_util.tree_map(jnp.asarray, opt_vars)
    tx = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-7)
    state = jmodel.state
    _, opt_state, jloss, jout = jmodel._get_fine_tune_step(False, WORLD, tx)(
        opt_vars, tx.init(opt_vars), jnp.asarray(floats), state.discriminator.params,
        state.latent_discriminator.params, state.generator.params["latent_regressor"],
        jmodel.perceptual_loss.variables["params"],
        jmodel.perceptual_loss_face_reco.variables["params"])
    mu = opt_state[0].mu
    moments = {f"generator/{k}": v for k, v in _flat(mu["generator"]).items()}
    moments.update({k: np.asarray(mu[k]) for k in ("pre_expr", "expr", "post_expr", "rotations")})

    jembeddings, jrotations = jmodel.fine_tune_on_img(images, n_iters=2)
    jtuned = _flat(jax.device_get(jmodel._fine_tuned_generator_params))
    jax_result = dict(loss=float(jloss), render=np.asarray(jout), moments=moments,
                      embeddings=jembeddings, rotations=jrotations, tuned=jtuned)
    return jax_result, _collect(procs, workdir)


def test_fine_tune_iteration_matches_jax(fine_tuned):
    jax_result, results = fine_tuned
    got_loss = np.mean([float(r["loss_sum"]) for r in results])
    np.testing.assert_allclose(got_loss, jax_result["loss"], rtol=1e-4)
    want = jax_result["moments"]
    for result in results:
        np.testing.assert_allclose(result["render"], jax_result["render"], atol=1e-4)
        got = {k[len("moment/"):]: v for k, v in result.items() if k.startswith("moment/")}
        assert set(got) == set(want)
        keys = []
        for key, value in want.items():
            assert got[key].shape == value.shape, key
            if value.size == 0:  # pre_expr: the expression slice opens the tiny config's latent
                continue
            keys.append(key)
            assert np.abs(value).max() > 0, f"{key} has no gradient"
            np.testing.assert_allclose(got[key], value, rtol=1e-3, atol=1e-4 * np.abs(value).max(),
                                       err_msg=key)
        want_all = np.concatenate([want[k].ravel() for k in keys])
        got_all = np.concatenate([got[k].ravel() for k in keys])
        assert np.linalg.norm(got_all - want_all) < 1e-3 * np.linalg.norm(want_all)


def test_fine_tune_on_img_matches_jax(fine_tuned):
    jax_result, results = fine_tuned
    bound = 2 * 2 * LR  # 2 iterations, each moving a value by about lr
    for result in results:
        assert result["embeddings"].shape == (WORLD, 10) and result["rotations"].shape == (WORLD, 3)
        assert np.abs(result["embeddings"] - jax_result["embeddings"]).max() <= bound
        assert np.abs(result["rotations"] - jax_result["rotations"]).max() <= bound
        tuned = {k[len("tuned/"):]: v for k, v in result.items() if k.startswith("tuned/")}
        assert set(tuned) == set(jax_result["tuned"])
        for key, value in jax_result["tuned"].items():
            np.testing.assert_allclose(tuned[key], value, atol=bound, err_msg=key)
        assert str(result["error"]) == "fine-tune batch 3 must divide over 2 devices"
    for key in results[0]:
        if key.startswith(("tuned/", "embeddings", "rotations")):
            np.testing.assert_array_equal(results[1][key], results[0][key], err_msg=key)


# ---------------------------------------------------------------------------
# 5. the server
# ---------------------------------------------------------------------------

def test_server_matches_the_jax_mesh_server(tmp_path):
    jmodel = jax_second_stage.ConfigNet(dict(TINY_FIRST_STAGE_CONFIG))
    weights = jmodel.get_weights()
    enc = _flat(weights["real_encoder"])
    rng = np.random.default_rng(0)  # heads as tests/test_torch_serving.py gives them
    for head, std in (("feature_to_latent", 1e-6), ("rotation_regressor", 3e-7)):
        enc[f"{head}/kernel"] = (rng.normal(size=enc[f"{head}/kernel"].shape) * std).astype(np.float32)
    weights["real_encoder"] = _unflat(enc)
    jmodel.set_weights(weights)
    jsrv = JaxServer(jmodel, chunk=4, mesh=jax_create_mesh(jax.devices()[:4]))
    photos = np.random.default_rng(1).integers(0, 256, (5, 128, 128, 3), dtype=np.uint8)
    jlat, jrot = (np.asarray(a, np.float32) for a in jsrv.encode(photos))

    inputs = {"photos": photos, "jax_latents": jlat, "jax_rotations": jrot}
    _pack(inputs, "weights", {**{name: _flat(tree) for name, tree in weights.items()},
                              "generator": _flat(jsrv._gen_params),
                              "generator_smoothed": _flat(jsrv._gen_params),
                              "synthetic_encoder": _flat(jsrv._synth_params),
                              "real_encoder": _flat(jsrv._enc_params)})
    procs = _launch("serve", tmp_path, inputs, dict(TINY_FIRST_STAGE_CONFIG))
    jout = np.asarray(jsrv.generate(jlat, jrot))
    results = _collect(procs, tmp_path)
    for result in results:
        lat, rot, out = result["latents"], result["rotations"], result["renders"]
        assert lat.shape == (5, 10) and np.std(lat[:, 0]) > 0
        np.testing.assert_allclose(lat, jlat, rtol=2e-2, atol=2e-2 * np.abs(jlat).max())
        np.testing.assert_allclose(rot, jrot, atol=1e-2)
        assert out.shape == jout.shape and out.dtype == np.uint8 and out.std() > 0
        assert np.mean(np.abs(out.astype(int) - jout.astype(int))) < 1.0
        assert str(result["error"]) == \
            "chunk (3) must be divisible by the mesh size (2) so batches shard evenly"
        # 2 chunks: the encoder's two outputs and the renders gathered per chunk
        # (sorted names: all_gather_rows, all_reduce_mean, all_reduce_sum, broadcast)
        np.testing.assert_array_equal(result["launches"], [6, 0, 0, 3])
    for key in ("latents", "rotations", "renders"):
        np.testing.assert_array_equal(results[1][key], results[0][key])


# ---------------------------------------------------------------------------
# 6. the training loop
# ---------------------------------------------------------------------------

def _files(directory):
    return sorted(os.path.relpath(os.path.join(root, name), directory)
                  for root, _, names in os.walk(directory) for name in names)


def test_loop_writes_on_rank_zero_the_global_losses(tmp_path):
    config = dict(TINY_FIRST_STAGE_CONFIG, image_checkpoint_period=2, metrics_checkpoint_period=2,
                  loss_print_period=2, async_checkpointing=True)
    model = ConfigNetFirstStage(dict(config), device="cpu")
    dataset = FakeDataset(n_images=8, img_size=128)
    inputs = _dataset_arrays(dataset)
    # ground-truth Inception features of the extractor's width: no extraction
    inputs["data/inception_features"] = \
        np.random.default_rng(2).normal(size=(8, 2048)).astype(np.float32)
    _pack(inputs, "weights", model.get_weights())
    _pack(inputs, "vgg", {"vgg": export_jax_params(model.perceptual_loss.vgg)})
    results = _collect(_launch("loop", tmp_path, inputs, config), tmp_path)

    assert not (tmp_path / "out_1").exists() and not (tmp_path / "logs_1").exists()
    files = _files(tmp_path / "out_0")
    assert {"checkpoints/000000.npz", "checkpoints/000002.npz", "generator_losses.txt",
            "discriminator_losses.txt", "inception_metrics.txt",
            "output_imgs/000002.png"} <= set(files), files
    assert _files(tmp_path / "logs_0")  # the TensorBoard writer's
    # both ranks run both checkpoints inline and score alike; only rank 0
    # writes and feeds the sink
    assert [int(r["events"]) for r in results] == [2, 2]
    assert [bool(r["async"]) for r in results] == [False, False]
    for key in ("kid", "fid"):
        assert results[0][f"metrics/{key}"].shape == (2,)
        np.testing.assert_array_equal(results[1][f"metrics/{key}"], results[0][f"metrics/{key}"])
    assert int(results[0]["sink_calls"]) > 0 == int(results[1]["sink_calls"])
    table = np.atleast_2d(np.loadtxt(tmp_path / "out_0" / "generator_losses.txt"))
    with open(tmp_path / "out_0" / "generator_losses.txt") as fp:
        header = fp.readline().lstrip("# ").split()
    assert table.shape == (3, len(header))
    assert not np.allclose(results[0]["local/g/loss_sum"], results[1]["local/g/loss_sum"])
    for column, key in enumerate(header):
        want = np.mean([r[f"local/g/{key}"] for r in results], axis=0)
        np.testing.assert_allclose(table[:, column], want, rtol=1e-6, err_msg=key)
        for result in results:  # every rank logs the global means
            np.testing.assert_allclose(result[f"logged/g/{key}"], want, rtol=1e-6, err_msg=key)
