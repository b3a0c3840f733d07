"""The port's MobileNetV2 and CelebA attribute classifier against the JAX
package's, on the CPU at 64px, with the JAX weights (``params`` and
``batch_stats``) carried across.

- ``MobileNetV2`` with frozen and with trainable batch norms, at 64px and at
  an odd size (67px, where TF "SAME" at stride 2 pads symmetrically, while
  64px pads 0 before and 1 after): train-mode outputs and running
  statistics, then eval-mode outputs, within 1e-5 relative L2 of JAX's.
- One train step with the dropout mask pinned on both sides: loss rtol
  1e-4, every parameter's gradient (the Adam first moment, 0.1 g after one
  step on both sides) within 1e-3 relative L2, ``batch_stats`` rtol 1e-5.
- ``recalibrate_batch_stats`` after the same seed, and
  ``predict_attributes`` (uint8, [-1, 1] float, and a resized input).
- ``save`` / ``load`` both ways, and ``train(n_epochs=1,
  steps_per_epoch=2)`` writes the JAX package's file set.

With trainable trunk norms (52 batch norms in train mode, over 12-3072
values a channel at 64px) JAX's own float32 result lies 1.0e-4 to 1.9e-4
relative L2 from a float64 evaluation of the same network (the port's 1.7e-5
to 2.7e-5): its statistics' reductions round more.  So in that mode the
train-mode outputs are held to 1e-3 relative L2, about 5x JAX's own
rounding error, and so are the running statistics after a train-mode pass:
each ``var`` leaf in relative L2, each ``mean`` leaf relative to the norm of
its running standard deviation (a norm fed by a linear map of normalised
values has a batch mean of zero up to rounding, so its own norm is no
scale).  The train step's gradients in that mode lie 6e-3 relative L2 from
the float64 ones on JAX's side (up to 1.4e-2 a leaf), so the reference is
JAX's own train step run in float64 on the same weights, inputs and mask
(compiled without XLA's algebraic simplifier, see below): the port's float64 step is held to it within 1e-8 relative L2 a leaf, and
the port's float32 gradients within 1e-3.  Leaves whose float64 gradient on
JAX's side is zero (a norm's bias that a later batch norm subtracts again:
norms below 1e-5 of the largest) are rounding noise in float32 and are held
only in float64, in absolute terms.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from confignet_tpu.metrics.celeba_attribute_prediction import (
    CelebaAttributeClassifier as JaxClassifier)
from confignet_tpu.models.backbones.mobilenet import MobileNetV2 as JaxMobileNetV2
from helpers import FakeDataset
from confignet_tpu_torch.core.model_io import export_jax_params, export_jax_tensors, load_jax_params
from confignet_tpu_torch.metrics.celeba_attribute_prediction import CelebaAttributeClassifier
from confignet_tpu_torch.models.backbones.mobilenet import MobileNetV2

torch.set_num_threads(1)

ATTRS = sorted(["Black_Hair", "Blond_Hair", "Smiling", "Mustache", "No_Beard"])
BN_MODES = pytest.mark.parametrize("trainable_bn", [False, True], ids=["frozen_bn", "trainable_bn"])


def _flat(tree):
    return {"/".join(path): np.array(leaf) for path, leaf in traverse_util.flatten_dict(tree).items()}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _config(trainable_bn, **extra):
    return dict({"input_shape": (64, 64, 3), "predicted_attributes": ATTRS, "batch_size": 4,
                 "trainable_bn": trainable_bn, "head_bn_momentum": 0.9}, **extra)


def _dataset(n=12, seed=0):
    ds = FakeDataset(n_images=n, img_size=64, seed=seed)
    rng = np.random.default_rng(seed + 1)
    ds.attributes = [{a: int(rng.random() > 0.5) for a in ATTRS} for _ in range(n)]
    return ds


def _pair(trainable_bn, **extra):
    """A JAX classifier and the port's, carrying the same weights."""
    jclf = JaxClassifier(_config(trainable_bn, **extra))
    clf = CelebaAttributeClassifier(_config(trainable_bn, **extra), device="cpu")
    clf.set_weights({tree: _flat(jclf.variables[tree]) for tree in ("params", "batch_stats")})
    return jclf, clf


# relative L2 bound of train-mode results with trainable trunk norms (see above)
TRAINABLE_BN_RTOL = 1e-3


def _close_trees(got, want, trainable_bn):
    """Batch statistics: rtol 1e-5 (with an atol of 1e-5 of the leaf's
    largest value), or TRAINABLE_BN_RTOL as the module
    docstring says after a train-mode pass through trainable trunk norms."""
    assert set(got) == set(want)
    for key, value in want.items():
        if not trainable_bn:
            np.testing.assert_allclose(got[key], value, rtol=1e-5,
                                       atol=1e-5 * np.abs(value).max(), err_msg=key)
        elif key.endswith("/var"):
            assert _rel_l2(got[key], value) < TRAINABLE_BN_RTOL, key
        else:
            std = np.sqrt(want[key[:-len("mean")] + "var"])
            assert np.linalg.norm(got[key] - value) < TRAINABLE_BN_RTOL * np.linalg.norm(std), key


@BN_MODES
@pytest.mark.parametrize("size", [64, 67])
def test_mobilenet_matches_jax(trainable_bn, size):
    x = np.random.default_rng(0).uniform(-1, 1, (3, size, size, 3)).astype(np.float32)
    jnet = JaxMobileNetV2(trainable_bn=trainable_bn)
    variables = jax.jit(lambda k, x: jnet.init(k, x, train=False))(jax.random.PRNGKey(0),
                                                                    jnp.asarray(x))
    net = MobileNetV2(trainable_bn=trainable_bn)
    load_jax_params(net, _flat(variables["params"]))
    if trainable_bn:
        load_jax_params(net, _flat(variables["batch_stats"]), "batch_stats")
        want, mutated = jax.jit(lambda v, x: jnet.apply(v, x, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
        variables = {**variables, **mutated}
        with torch.no_grad():
            got = net(torch.from_numpy(x), train=True).numpy()
        assert _rel_l2(got, want) < TRAINABLE_BN_RTOL
        _close_trees(export_jax_params(net, "batch_stats"), _flat(variables["batch_stats"]), True)
        load_jax_params(net, _flat(variables["batch_stats"]), "batch_stats")  # eval on JAX's
    want = np.asarray(jax.jit(lambda v, x: jnet.apply(v, x, train=False))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, -(-size // 32), -(-size // 32), 1280)
    assert got.std() > 0 and _rel_l2(got, want) < 1e-5


@BN_MODES
def test_train_step_matches_jax(trainable_bn, monkeypatch):
    jclf, clf = _pair(trainable_bn)
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    labels = (rng.random((4, len(ATTRS))) > 0.5).astype(np.float32)
    mask = rng.random((4, 1280)) < 0.5
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(mask))
    clf._dropout_mask = lambda n: torch.from_numpy(mask)

    copy = lambda tree: jax.tree_util.tree_map(jnp.array, tree)  # noqa: E731  (the step donates)
    _, new_stats, opt_state, jloss, jacc = jclf._build_train_step()(
        copy(jclf.variables["params"]), copy(jclf.variables["batch_stats"]), copy(jclf.opt_state),
        jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(labels))
    loss, acc = clf._build_train_step()(torch.from_numpy(imgs), torch.from_numpy(labels))

    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert float(acc) == float(jacc)
    _close_trees(clf.get_weights()["batch_stats"], _flat(new_stats), trainable_bn)
    got = export_jax_tensors((name, clf.optimizer.state[p]["exp_avg"])
                             for name, p in clf.module.named_parameters())
    want = _flat(opt_state[0].mu)
    assert set(got) == set(want)
    if not trainable_bn:
        errors = {key: _rel_l2(got[key], value) for key, value in want.items()
                  if np.linalg.norm(value) > 0}
        assert len(errors) > 0.9 * len(want)
        worst = max(errors, key=errors.get)
        assert errors[worst] < 1e-3, (worst, errors[worst])
        return
    exact = _jax_float64_first_moments(jclf, imgs, labels, mask)
    port64 = _float64_first_moments(jclf, imgs, labels, mask)
    assert set(port64) == set(exact)
    largest = max(np.linalg.norm(v) for v in exact.values())
    kept = [key for key, value in exact.items() if np.linalg.norm(value) > 1e-5 * largest]
    assert len(kept) > 0.85 * len(exact)
    for key, value in exact.items():
        if key in kept:
            assert _rel_l2(port64[key], value) < 1e-8, key
            assert _rel_l2(got[key], value) < 1e-3, key
        else:
            assert np.linalg.norm(port64[key] - value) < 1e-8 * largest, key


def _jax_float64_first_moments(jclf, imgs, labels, mask):
    """The Adam first moment (0.1 x the gradient) of the JAX classifier's
    own train step, run in float64 from its weights, in its layout.

    XLA's algebraic simplifier is off for this compile: it turns the float32
    ``/ 127.5`` of the input scaling into a product with the reciprocal, which
    moves 205 of the 256 pixel values by an ulp, and that alone moves these
    float64 gradients by 2e-5 relative L2 at random weights."""
    with jax.enable_x64(True):
        to64 = lambda tree: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), tree)
        params = to64(jclf.variables["params"])
        args = (params, to64(jclf.variables["batch_stats"]), jclf.tx.init(params),
                jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(labels, jnp.float64))
        step = jclf._build_train_step().lower(*args).compile({"xla_disable_hlo_passes": "algsimp"})
        _, _, opt_state, _, _ = step(*args)
        moments = _flat(opt_state[0].mu)
    assert all(v.dtype == np.float64 for v in moments.values())
    return moments


def _float64_first_moments(jclf, imgs, labels, mask):
    """0.1 x the gradient of one train-mode step of the port in float64, from
    the JAX classifier's weights, in the JAX layout."""
    from confignet_tpu_torch.metrics.celeba_attribute_prediction import _bce

    clf = CelebaAttributeClassifier(dict(jclf.config), device="cpu")
    clf.set_weights({tree: _flat(jclf.variables[tree]) for tree in ("params", "batch_stats")})
    clf.module.double()
    outputs = clf.module(torch.from_numpy(imgs).double(), train=True,
                         dropout_mask=torch.from_numpy(mask))
    _bce(outputs, torch.from_numpy(labels).double()).backward()
    return export_jax_tensors(((name, 0.1 * p.grad) for name, p in clf.module.named_parameters()),
                              torch.float64)


def test_recalibration_and_predictions_match_jax():
    jclf, clf = _pair(True)
    ds = _dataset()
    np.random.seed(3)
    jclf.recalibrate_batch_stats(ds, 3)
    np.random.seed(3)
    clf.recalibrate_batch_stats(ds, 3)
    _close_trees(clf.get_weights()["batch_stats"], _flat(jclf.variables["batch_stats"]), True)

    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (5, 64, 64, 3), dtype=np.uint8)
    floats = imgs.astype(np.float32) / 127.5 - 1.0
    bigger = rng.integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    for inputs in (imgs, floats, bigger):
        got = clf.predict_attributes(inputs, batch_chunk=2)
        assert got.shape == (len(inputs), len(ATTRS)) and got.dtype == np.float32
        np.testing.assert_allclose(got, jclf.predict_attributes(inputs, batch_chunk=2), atol=1e-5)


def test_save_load_across_packages(tmp_path):
    jclf, _ = _pair(True)
    ds = _dataset()
    np.random.seed(5)
    jclf.recalibrate_batch_stats(ds, 2)  # running statistics away from their init
    jclf.logs = {"loss": [0.5], "val_binary_accuracy": [0.75]}
    imgs = np.random.default_rng(6).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)

    jclf.save(str(tmp_path / "jax"), "judge")
    clf = CelebaAttributeClassifier.load(str(tmp_path / "jax" / "judge.json"), device="cpu")
    assert clf.logs == jclf.logs and clf.config["trainable_bn"] is True
    np.testing.assert_allclose(clf.predict_attributes(imgs), jclf.predict_attributes(imgs),
                               atol=1e-5)

    clf.save(str(tmp_path / "port"), "judge")
    with np.load(tmp_path / "jax" / "judge.npz") as a, np.load(tmp_path / "port" / "judge.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    back = JaxClassifier.load(str(tmp_path / "port" / "judge.json"))
    np.testing.assert_allclose(back.predict_attributes(imgs), clf.predict_attributes(imgs),
                               atol=1e-5)
    # a backbones_dir without mobilenet_v2_notop.h5 is skipped, as in JAX
    skipped = CelebaAttributeClassifier(_config(False, backbones_dir=str(tmp_path)), device="cpu")
    seeded = CelebaAttributeClassifier(_config(False), device="cpu").get_weights()
    for tree, leaves in skipped.get_weights().items():
        for key, value in leaves.items():
            np.testing.assert_array_equal(value, seeded[tree][key])


def test_train_writes_the_jax_file_set(tmp_path):
    jclf, clf = _pair(True)
    ds = _dataset()
    np.random.seed(7)
    jclf.train(ds, ds, str(tmp_path / "jax"), n_epochs=1, steps_per_epoch=2)
    np.random.seed(7)
    clf.train(ds, ds, str(tmp_path / "port"), n_epochs=1, steps_per_epoch=2)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, names in os.walk(root) for f in names)

    assert files(tmp_path / "port") == files(tmp_path / "jax")
    assert "best_model/0000.npz" in files(tmp_path / "port")
    assert set(clf.logs) == set(jclf.logs) == {"loss", "binary_accuracy", "val_loss",
                                               "val_binary_accuracy"}
    assert all(np.isfinite(v).all() for v in clf.logs.values())
    header = (tmp_path / "port" / "logs.txt").read_text().splitlines()[0]
    assert header == (tmp_path / "jax" / "logs.txt").read_text().splitlines()[0]
