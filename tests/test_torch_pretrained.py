"""The port's Keras ``.h5`` backbone import and ``backbones_dir`` against the
JAX package's, on the CPU.  Each ``.h5`` is written here in Keras's weight
layout (``layer_names`` / ``weight_names`` attributes, ``<layer>/<leaf>:0``
datasets) from seeded arrays shaped like the model's parameters.

- By layer name: VGG19 and VGGFace VGG16 files holding more layers than the
  perceptual losses build load to JAX's arrays bit for bit; a file with no
  matching name raises on both sides.
- By creation order: an InceptionV3 file with Keras counter names in a
  scrambled file order and gamma-less norms (through ``InceptionMetrics``)
  and a MobileNetV2 file with semantic names (through the judge's
  ``backbones_dir``) load to JAX's arrays bit for bit; a file mixing the two
  namings raises on both sides; the judge's ``trainable_bn`` raises.
- By name map: ResNet50 files in the current and the legacy Keras naming
  load into the stage-2 encoder's trunk, with VGG19 and VGGFace beside
  them, equal to JAX's bit for bit.
- An empty ``backbones_dir`` builds and trains like none (JAX's semantics:
  a missing file is skipped); ``encoder_norm`` "group" with a ResNet50 file
  raises ValueError on both sides.
"""

import h5py
import numpy as np
import pytest
import torch
from flax import traverse_util

from confignet_tpu.losses.perceptual import PerceptualLoss as JaxPerceptualLoss
from confignet_tpu.metrics import inception as jax_inception
from confignet_tpu.metrics.celeba_attribute_prediction import (
    CelebaAttributeClassifier as JaxClassifier)
from confignet_tpu.models.backbones import loader as jax_loader
from confignet_tpu.training.first_stage import ConfigNetFirstStage as JaxFirstStage
from confignet_tpu.training.second_stage import ConfigNet as JaxConfigNet
from helpers import FakeDataset, TINY_FIRST_STAGE_CONFIG
from confignet_tpu_torch.core.model_io import export_jax_params
from confignet_tpu_torch.core.pretrained import BACKBONE_FILES
from confignet_tpu_torch.losses.perceptual import PerceptualLoss
from confignet_tpu_torch.metrics import inception
from confignet_tpu_torch.metrics.celeba_attribute_prediction import CelebaAttributeClassifier
from confignet_tpu_torch.models.backbones import loader
from confignet_tpu_torch.models.backbones.inception import inception_conv_bn_order
from confignet_tpu_torch.models.backbones.mobilenet import mobilenet_conv_bn_order
from confignet_tpu_torch.models.backbones.resnet import resnet50_keras_name_map
from confignet_tpu_torch.models.backbones.vgg import keras_layer_names
from confignet_tpu_torch.training.first_stage import ConfigNetFirstStage
from confignet_tpu_torch.training.second_stage import ConfigNet

torch.set_num_threads(1)

ATTRS = ["Smiling", "Mustache", "Black_Hair"]


def write_keras_h5(path, layers, model_weights=False):
    """``layers``: (layer name, {leaf: array}) in file order; a layer with no
    arrays is a weightless one (an input, a pool)."""
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights") if model_weights else f
        root.attrs["layer_names"] = np.array([name.encode() for name, _ in layers])
        for name, arrays in layers:
            group = root.create_group(name)
            weight_names = [f"{name}/{leaf}:0" for leaf in arrays]
            group.attrs["weight_names"] = np.array([n.encode() for n in weight_names], dtype="S")
            for weight_name, array in zip(weight_names, arrays.values()):
                group.create_dataset(weight_name, data=array)


def _seeded(shape, rng, positive=False):
    value = rng.normal(size=shape).astype(np.float32)
    return np.abs(value) + 0.5 if positive else value


def _conv_arrays(flat, path, rng, depthwise=False):
    arrays = {}
    kernel = flat[f"{path}/kernel"].shape
    if depthwise:  # flax (h, w, 1, C) -> Keras (h, w, C, 1)
        arrays["depthwise_kernel"] = _seeded(kernel[:2] + (kernel[3], 1), rng)
    else:
        arrays["kernel"] = _seeded(kernel, rng)
    if f"{path}/bias" in flat:
        arrays["bias"] = _seeded(flat[f"{path}/bias"].shape, rng)
    return arrays


def _bn_arrays(flat, path, rng, with_gamma=True):
    shape = flat[f"{path}/beta"].shape
    arrays = {"gamma": _seeded(shape, rng)} if with_gamma else {}
    arrays.update(beta=_seeded(shape, rng), moving_mean=_seeded(shape, rng),
                  moving_variance=_seeded(shape, rng, positive=True))
    return arrays


def _flat(tree):
    return {"/".join(p): np.asarray(v) for p, v in traverse_util.flatten_dict(dict(tree)).items()}


def _assert_equal_flat(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def _vgg_file(path, arch, blocks, seed, model_weights=False):
    """Every conv of the first ``blocks`` VGG blocks, with the pools between."""
    rng = np.random.default_rng(seed)
    layers, cin = [("input_1", {})], 3
    channels = (64, 128, 256, 512, 512)
    for name in keras_layer_names(arch)[1:]:
        block = int(name[5])
        if block > blocks:
            break
        if name.endswith("_pool"):
            layers.append((name, {}))
            continue
        cout = channels[block - 1]
        layers.append((name, {"kernel": _seeded((3, 3, cin, cout), rng),
                              "bias": _seeded((cout,), rng)}))
        cin = cout
    write_keras_h5(path, layers, model_weights)


def _resnet_file(path, flat, legacy, seed):
    rng = np.random.default_rng(seed)
    layers = [("input_1", {})]
    for name, (module, kind) in resnet50_keras_name_map(legacy).items():
        arrays = _conv_arrays(flat, module, rng) if kind == "conv" else _bn_arrays(flat, module, rng)
        layers.append((name, arrays))
    write_keras_h5(path, layers)


@pytest.mark.parametrize("mode,taps,model_weights", [("imagenet", (1, 2), True),
                                                     ("VGGFace", (1, 2, 8), False)])
def test_vgg_by_layer_name_matches_jax(mode, taps, model_weights, tmp_path):
    path = str(tmp_path / "vgg.h5")
    _vgg_file(path, "vgg19" if mode == "imagenet" else "vgg16", 3, seed=1, model_weights=model_weights)
    port = PerceptualLoss(mode, taps=taps)
    seeded = export_jax_params(port.vgg)
    port.load_keras_weights(path)
    jax_loss = JaxPerceptualLoss((64, 64, 3), model_type=mode, taps=taps)
    jax_loss.load_keras_weights(path)
    got = export_jax_params(port.vgg)
    _assert_equal_flat(got, _flat(jax_loss.variables["params"]))
    assert all(not np.array_equal(got[k], seeded[k]) for k in got)

    other = str(tmp_path / "other.h5")
    write_keras_h5(other, [("dense_9", {"kernel": np.zeros((2, 2), np.float32)})])
    with pytest.raises(ValueError, match="no layer names"):
        port.load_keras_weights(other)
    with pytest.raises(ValueError, match="no layer names"):
        jax_loss.load_keras_weights(other)


def test_inception_by_creation_order_matches_jax(tmp_path):
    """Counter names, scrambled file order, norms without gamma."""
    backbones = tmp_path / "backbones"
    backbones.mkdir()
    config = {"output_shape": (128, 128, 3)}
    flat = export_jax_params(inception.InceptionFeatureExtractor((128, 128, 3), device="cpu").module)
    rng = np.random.default_rng(2)
    layers = []
    for i, name in enumerate(inception_conv_bn_order()):
        suffix = f"_{i}" if i else ""
        layers.append((f"conv2d{suffix}", _conv_arrays(flat, f"{name}/conv", rng)))
        layers.append((f"batch_normalization{suffix}",
                       _bn_arrays(flat, f"{name}/bn", rng, with_gamma=False)))
    order = np.random.default_rng(3).permutation(len(layers))
    write_keras_h5(str(backbones / BACKBONE_FILES["inception_v3"]),
                   [("input_1", {}), ("mixed0", {})] + [layers[i] for i in order])

    dataset = FakeDataset(n_images=4, img_size=128)
    dataset.inception_features = np.zeros((4, 2048), np.float32)
    config["backbones_dir"] = str(backbones)
    got = inception.InceptionMetrics(config, dataset, n_samples_for_metrics=2, device="cpu")
    want = jax_inception.InceptionMetrics(config, dataset, n_samples_for_metrics=2)
    got_flat = export_jax_params(got.inception_feature_extractor.module)
    _assert_equal_flat(got_flat, _flat(want.inception_feature_extractor.variables["params"]))
    assert all((got_flat[f"{n}/bn/gamma"] == 1).all() for n in inception_conv_bn_order())


def _mobilenet_layers(flat, seed):
    rng = np.random.default_rng(seed)
    conv_paths, bn_paths = mobilenet_conv_bn_order()
    layers = []
    for i, (conv, bn) in enumerate(zip(conv_paths, bn_paths)):
        if i == 0:
            names = ("Conv1", "bn_Conv1")
        elif i == len(conv_paths) - 1:
            names = ("Conv_1", "Conv_1_bn")
        else:
            block, part = conv.split("/")
            names = (f"{block}_{part}", f"{block}_{part}_BN")
        layers.append((names[0], _conv_arrays(flat, conv, rng, depthwise=conv.endswith("depthwise"))))
        layers.append((names[1], _bn_arrays(flat, bn, rng)))
    return layers


def _judge_config(**extra):
    return dict({"input_shape": (64, 64, 3), "predicted_attributes": ATTRS, "batch_size": 4,
                 "trainable_bn": False}, **extra)


def test_mobilenet_by_file_order_matches_jax(tmp_path):
    backbones = tmp_path / "backbones"
    backbones.mkdir()
    seeded = CelebaAttributeClassifier(_judge_config(), device="cpu")
    flat = export_jax_params(seeded.module.mobilenet)
    write_keras_h5(str(backbones / BACKBONE_FILES["mobilenet_v2"]),
                   [("input_1", {})] + _mobilenet_layers(flat, seed=4))

    got = CelebaAttributeClassifier(_judge_config(backbones_dir=str(backbones)), device="cpu")
    want = JaxClassifier(_judge_config(backbones_dir=str(backbones)))
    got_params = got.get_weights()["params"]
    # the trunk; each package seeds its head its own way
    _assert_equal_flat({k: v for k, v in got_params.items() if k.startswith("mobilenet/")},
                       _flat({"mobilenet": want.variables["params"]["mobilenet"]}))
    assert not np.array_equal(got_params["mobilenet/stem/kernel"],
                              seeded.get_weights()["params"]["mobilenet/stem/kernel"])
    # the head keeps the port's seeded weights
    np.testing.assert_array_equal(got_params["head/head/kernel"],
                                  seeded.get_weights()["params"]["head/head/kernel"])

    live = _judge_config(backbones_dir=str(backbones), trainable_bn=True)
    with pytest.raises(ValueError, match="trainable_bn"):
        CelebaAttributeClassifier(live, device="cpu")
    with pytest.raises(ValueError, match="trainable_bn"):
        JaxClassifier(live)


def test_mixed_naming_is_refused(tmp_path):
    path = str(tmp_path / "mixed.h5")
    kernel = {"kernel": np.ones((1, 1, 2, 2), np.float32)}
    write_keras_h5(path, [("conv2d_1", kernel), ("block_1_expand", kernel)])
    flat = {"a/kernel": np.zeros((1, 1, 2, 2), np.float32), "b/kernel": np.zeros((1, 1, 2, 2), np.float32)}
    with pytest.raises(ValueError, match="mixes"):
        loader.load_keras_h5_ordered(flat, path, ["a", "b"], [])
    with pytest.raises(ValueError, match="mixes"):
        jax_loader.load_keras_h5_ordered({"a": {"kernel": flat["a/kernel"]}, "b": {"kernel": flat["b/kernel"]}},
                                         path, ["a", "b"], [])


@pytest.mark.parametrize("legacy", [False, True], ids=["current", "legacy"])
def test_stage2_backbones_match_jax(legacy, tmp_path):
    """ResNet50 by name map (the current naming, or the legacy one through
    the fallback), VGG19 and VGGFace by layer name, all from one
    backbones_dir."""
    backbones = tmp_path / "backbones"
    backbones.mkdir()
    seeded = ConfigNet(dict(TINY_FIRST_STAGE_CONFIG), device="cpu")
    _resnet_file(str(backbones / BACKBONE_FILES["resnet50"]),
                 export_jax_params(seeded.real_encoder.resnet), legacy, seed=5)
    _vgg_file(str(backbones / BACKBONE_FILES["vgg19"]), "vgg19", 2, seed=6)
    _vgg_file(str(backbones / BACKBONE_FILES["vggface"]), "vgg16", 2, seed=7)

    config = dict(TINY_FIRST_STAGE_CONFIG, backbones_dir=str(backbones))
    got = ConfigNet(dict(config), device="cpu")
    want = JaxConfigNet(dict(config))
    got_encoder = got.get_weights()["real_encoder"]
    _assert_equal_flat(got_encoder, _flat(want.get_weights()["real_encoder"]))
    before = seeded.get_weights()["real_encoder"]
    assert not np.array_equal(got_encoder["resnet/stem_conv/kernel"], before["resnet/stem_conv/kernel"])
    np.testing.assert_array_equal(got_encoder["feature_to_latent/kernel"],
                                  before["feature_to_latent/kernel"])
    _assert_equal_flat(export_jax_params(got.perceptual_loss.vgg),
                       _flat(want.perceptual_loss.variables["params"]))
    _assert_equal_flat(export_jax_params(got.perceptual_loss_face_reco.vgg),
                       _flat(want.perceptual_loss_face_reco.variables["params"]))


def test_empty_backbones_dir_trains_like_none(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    models = [ConfigNetFirstStage(dict(TINY_FIRST_STAGE_CONFIG, backbones_dir=backbones_dir),
                                  device="cpu") for backbones_dir in (str(empty), None)]
    JaxFirstStage(dict(TINY_FIRST_STAGE_CONFIG, backbones_dir=str(empty)))  # builds, as JAX's does
    weights = [m.get_weights() for m in models]
    for tree, leaves in weights[1].items():
        _assert_equal_flat(weights[0][tree], leaves)
    _assert_equal_flat(export_jax_params(models[0].perceptual_loss.vgg),
                       export_jax_params(models[1].perceptual_loss.vgg))
    dataset = FakeDataset(n_images=8, img_size=128,
                          facemodel_dims={"blendshape_values": 8, "head_hair_color": 3})
    losses = []
    for model in models:
        np.random.seed(0)
        model._batch_rng = np.random.RandomState(0)
        batch = model._sample_host_batch(dataset, dataset)
        step = model._build_train_step()
        losses.append({group: {k: float(v) for k, v in values.items()}
                       for group, values in step(batch).items()})
    assert losses[0] == losses[1]


def test_encoder_norm_must_be_frozen_with_a_resnet_file(tmp_path):
    (tmp_path / BACKBONE_FILES["resnet50"]).write_bytes(b"")
    config = dict(TINY_FIRST_STAGE_CONFIG, backbones_dir=str(tmp_path), encoder_norm="group")
    with pytest.raises(ValueError, match="encoder_norm"):
        ConfigNet(dict(config), device="cpu")
    with pytest.raises(ValueError, match="encoder_norm"):
        JaxConfigNet(dict(config))
