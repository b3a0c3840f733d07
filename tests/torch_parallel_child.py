"""One rank of a gloo group on the CPU, for tests/test_torch_parallel.py and
tests/test_torch_parallel_card.py.

    torchrun --nproc_per_node=2 tests/torch_parallel_child.py MODE WORKDIR

or the same with torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) set by the caller.  The
group is initialised as the training CLI initialises it with ``--device
cpu`` (``maybe_initialize_distributed``).  Reads ``WORKDIR/inputs.npz`` and
``WORKDIR/config.json`` (written by the test), runs one mode of the port
over a mesh of every rank and writes ``WORKDIR/result_<RANK>.npz``.  It imports the port only, never JAX or the
JAX package, and checks that at the end.
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from confignet_tpu_torch.core.model_io import export_jax_params, export_jax_tensors, load_jax_params
from confignet_tpu_torch.parallel import (
    all_gather_rows, all_reduce_mean, all_reduce_sum, create_mesh, maybe_initialize_distributed,
    process_slice, replicate, shard_batch)
from confignet_tpu_torch.serving import ConfigNetServer
from confignet_tpu_torch.training.first_stage import ConfigNetFirstStage
from confignet_tpu_torch.training.second_stage import ConfigNet


class Dataset:
    """The trainer's view of a dataset, from the test's arrays."""

    def __init__(self, arrays):
        self.imgs = arrays["data/imgs"]
        self.eye_masks = arrays["data/eye_masks"]
        self.metadata_inputs = {k[len("data/meta/"):]: v for k, v in arrays.items()
                                if k.startswith("data/meta/")}
        self.metadata_input_distributions = None
        if "data/inception_features" in arrays:
            self.inception_features = arrays["data/inception_features"]


def unpack(arrays, prefix):
    """{tree: {path: array}} from keys ``prefix|tree|path``."""
    trees = {}
    for key, value in arrays.items():
        if key.startswith(prefix + "|"):
            _, tree, path = key.split("|", 2)
            trees.setdefault(tree, {})[path] = value
    return trees


def pack(out, prefix, trees):
    for tree, leaves in trees.items():
        for path, value in leaves.items():
            out[f"{prefix}|{tree}|{path}"] = np.asarray(value)


def feeder(arrays, name):
    """A draw method returning the pinned global arrays in order."""
    queue = [arrays[k] for k in sorted((k for k in arrays if k.startswith(name + "/")),
                                       key=lambda k: int(k.split("/")[1]))]

    def draw(n):
        value = queue.pop(0)
        assert value.shape[0] == n, (name, value.shape, n)
        return torch.from_numpy(value)

    draw.remaining = queue
    return draw


def trained_model(cls, config, arrays, mesh):
    model = cls(config, device="cpu", initialize=False)
    model.set_weights(unpack(arrays, "weights"))
    load_jax_params(model.perceptual_loss.vgg, unpack(arrays, "vgg")["vgg"])
    if hasattr(model, "perceptual_loss_face_reco"):
        load_jax_params(model.perceptual_loss_face_reco.vgg, unpack(arrays, "vggface")["vggface"])
    model._use_mesh(mesh)
    return model


def primitives(mesh, arrays, config, out):
    x, x1 = arrays["x"], arrays["x1"]
    rows = process_slice(8, mesh)
    out["slice"] = np.array([rows.start, rows.stop])
    try:
        process_slice(3, mesh)
    except ValueError as exc:
        out["slice_error"] = np.array(str(exc))
    global_tree = shard_batch(mesh, {"a": x, "t": (x, x1[0])})
    out["shard/a"] = global_tree["a"].numpy()
    out["shard/t0"] = global_tree["t"][0].numpy()
    out["shard/t1"] = global_tree["t"][1].numpy()
    out["shard_axis1"] = shard_batch(mesh, x1, batch_axis=1).numpy()
    out["shard_local"] = shard_batch(mesh, x[rows], local_rows=True).numpy()
    out["shard_local_axis1"] = shard_batch(mesh, x1[:, rows], batch_axis=1, local_rows=True).numpy()

    # each rank starts from its own values; every rank ends with rank 0's
    mine = arrays[f"rank{mesh.rank}"]
    tree = replicate(mesh, {"w": mine, "u": [mine.astype(np.float64) * 2]})
    out["replicate/w"], out["replicate/u"] = tree["w"].numpy(), tree["u"][0].numpy()
    torch.manual_seed(mesh.rank)
    module = replicate(mesh, torch.nn.Linear(3, 2))
    out["replicate/module"] = np.concatenate([p.detach().numpy().ravel() for p in module.parameters()])

    mean_f32, mean_f64 = all_reduce_mean(mesh, [torch.from_numpy(mine.copy()),
                                                torch.from_numpy(mine.astype(np.float64) * 3)])
    out["mean/f32"], out["mean/f64"] = mean_f32.numpy(), mean_f64.numpy()
    out["gather"] = all_gather_rows(mesh, torch.from_numpy(x[rows])).numpy()

    # a differentiable sum: rank r's loss is sum(c_r * y), y the sum of every
    # rank's x_r, so each rank's input gradient is the sum of the c's
    x_r = torch.from_numpy(mine.copy()).requires_grad_(True)
    y = all_reduce_sum(mesh, x_r)
    (grad,) = torch.autograd.grad((torch.from_numpy(arrays[f"c{mesh.rank}"]) * y).sum(), x_r)
    out["sum/value"], out["sum/grad"] = y.detach().numpy(), grad.numpy()
    out["launches"] = np.array([mesh.launches[k] for k in sorted(mesh.launches)])


def train_step(cls, mesh, arrays, config, out):
    model = trained_model(cls, config, arrays, mesh)
    dataset = Dataset(arrays)
    model._batch_rng = np.random.RandomState(0)
    batch = model._sample_host_batch(dataset, dataset)
    for key, value in batch.items():
        for i, leaf in enumerate(value if isinstance(value, tuple) else (value,)):
            out[f"batch/{key}/{i}"] = leaf
    model._sample_latent = feeder(arrays, "latents")
    model._sample_rotations = feeder(arrays, "rotations")
    model._flip_mask = feeder(arrays, "flips")
    losses = model._build_train_step()(batch)
    assert not (model._sample_latent.remaining or model._sample_rotations.remaining
                or model._flip_mask.remaining)
    for group, values in losses.items():
        for key, value in values.items():
            out[f"loss/{group}/{key}"] = np.asarray(float(value))
    for player, trees in model.first_moments().items():
        pack(out, f"moments:{player}", trees)
    pack(out, "weights", model.get_weights())
    out["launches"] = np.array([mesh.launches[k] for k in sorted(mesh.launches)])


def fine_tune(mesh, arrays, config, out):
    model = trained_model(ConfigNet, config, arrays, mesh)
    images = arrays["images"]
    pinned = arrays["encodings/embeddings"], arrays["encodings/rotations"]
    model.encode_images = lambda *args, **kwargs: tuple(a.copy() for a in pinned)
    captured = []
    make_optimizer, get_step = model._fine_tune_optimizer, model._get_fine_tune_step

    def capture_optimizer(generator, variables, force_neutral):
        optimizer = make_optimizer(generator, variables, force_neutral)
        captured.append((generator, variables, optimizer))
        return optimizer

    def capture_step(*args, **kwargs):
        step = get_step(*args, **kwargs)

        def run(*step_args):
            losses, rendered = step(*step_args)
            captured.append((losses, rendered))
            return losses, rendered
        return run

    model._fine_tune_optimizer = capture_optimizer
    model._get_fine_tune_step = capture_step
    model.fine_tune_on_img(images, n_iters=1, mesh=mesh)
    (generator, variables, optimizer), (losses, rendered) = captured
    moments = {p: optimizer.state[p]["exp_avg"] for group in optimizer.param_groups
               for p in group["params"]}
    for key, value in export_jax_tensors((name, moments[p])
                                         for name, p in generator.named_parameters()).items():
        out[f"moment/generator/{key}"] = value
    for key, value in variables.items():  # the per-image ones hold this rank's rows
        gathered = all_gather_rows(mesh, moments[value]) if key in ("expr", "rotations") else \
            moments[value]
        out[f"moment/{key}"] = gathered.numpy()
    out["loss_sum"] = np.asarray(float(losses["loss_sum"]))
    out["render"] = all_gather_rows(mesh, rendered).numpy()
    model._fine_tuned_generator_params = None

    model._fine_tune_optimizer, model._get_fine_tune_step = make_optimizer, get_step
    embeddings, rotations = model.fine_tune_on_img(images, n_iters=2, mesh=mesh)
    out["embeddings"], out["rotations"] = embeddings, rotations
    tuned = model._generator("gather")
    tuned.load_state_dict(model._fine_tuned_generator_params)
    for key, value in export_jax_params(tuned).items():
        out[f"tuned/{key}"] = value
    try:
        model.fine_tune_on_img(np.concatenate([images, images[:1]]), n_iters=1, mesh=mesh)
    except ValueError as exc:
        out["error"] = np.array(str(exc))


def serve(mesh, arrays, config, out):
    model = ConfigNet(config, device="cpu", initialize=False)
    model.set_weights(unpack(arrays, "weights"))
    server = ConfigNetServer(model, chunk=4, mesh=mesh)
    out["latents"], out["rotations"] = server.encode(arrays["photos"])
    out["renders"] = server.generate(arrays["jax_latents"], arrays["jax_rotations"])
    try:
        ConfigNetServer(model, chunk=3, mesh=mesh)
    except ValueError as exc:
        out["error"] = np.array(str(exc))
    out["launches"] = np.array([mesh.launches[k] for k in sorted(mesh.launches)])


class Recorder:
    """An ``aml_run`` stand-in (no loss plots)."""

    def __init__(self):
        self.calls = []

    def log(self, name, value):
        self.calls.append(name)


def loop(mesh, arrays, config, out, workdir):
    model = ConfigNetFirstStage(config, device="cpu", initialize=False)
    model.set_weights(unpack(arrays, "weights"))
    load_jax_params(model.perceptual_loss.vgg, unpack(arrays, "vgg")["vgg"])
    dataset = Dataset(arrays)
    model._batch_rng = np.random.RandomState(0)
    step = model._build_train_step()
    local = []

    def recording_step(batch):
        losses = step(batch)
        local.append({f"{g}/{k}": float(v) for g, d in losses.items() for k, v in d.items()})
        return losses

    model._train_step_fn = recording_step
    recorder = Recorder()
    np.random.seed(5)
    model.train(dataset, dataset, os.path.join(workdir, f"out_{mesh.rank}"),
                os.path.join(workdir, f"logs_{mesh.rank}"), n_steps=3, n_samples_for_metrics=2,
                aml_run=recorder, mesh=mesh)
    for key in local[0]:
        out[f"local/{key}"] = np.array([step_losses[key] for step_losses in local])
    out["events"] = np.asarray(model.checkpoint_events_run)
    out["sink_calls"] = np.asarray(len(recorder.calls))
    out["async"] = np.asarray(model._checkpoint_worker is not None)
    for key in ("kid", "fid"):
        out[f"metrics/{key}"] = np.asarray(model.metrics[key])
    for key, history in model.g_losses.items():
        out[f"logged/g/{key}"] = np.asarray(history)


def main():
    # TensorBoard imports TensorFlow where it is installed, and TensorFlow
    # imports JAX; the ranks run the port alone, so both stay out
    sys.modules["tensorflow"] = None
    mode, workdir = sys.argv[1], sys.argv[2]
    maybe_initialize_distributed("cpu")
    mesh = create_mesh(device="cpu")
    rank = mesh.rank
    assert (rank, mesh.size) == (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]))
    with np.load(os.path.join(workdir, "inputs.npz")) as npz:
        arrays = dict(npz)
    with open(os.path.join(workdir, "config.json")) as fp:
        config = json.load(fp)
    out = {"backend": np.array(dist.get_backend(mesh.group))}
    if mode == "primitives":
        primitives(mesh, arrays, config, out)
    elif mode == "stage1":
        train_step(ConfigNetFirstStage, mesh, arrays, config, out)
    elif mode == "stage2":
        train_step(ConfigNet, mesh, arrays, config, out)
    elif mode == "fine_tune":
        fine_tune(mesh, arrays, config, out)
    elif mode == "serve":
        serve(mesh, arrays, config, out)
    elif mode == "loop":
        loop(mesh, arrays, config, out, workdir)
    else:
        raise ValueError(mode)
    dist.barrier()
    dist.destroy_process_group()
    assert "jax" not in sys.modules and "confignet_tpu" not in sys.modules
    np.savez(os.path.join(workdir, f"result_{rank}.npz"), **out)
    print(f"CHILD_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
