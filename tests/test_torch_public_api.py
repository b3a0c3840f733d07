"""The port's package-level public API: the JAX package's lazy re-exports
(tests/test_public_api.py) and the method-level names of its public
classes, resolved from the port's own modules."""
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from confignet_tpu.core.reference_import import load_reference_pickle as jax_load_reference_pickle
from confignet_tpu.training.first_stage import ConfigNetFirstStage as JaxConfigNetFirstStage
from helpers import TINY_FIRST_STAGE_CONFIG

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_lazy_exports():
    import confignet_tpu_torch

    assert confignet_tpu_torch.__version__ == "0.1.0"
    assert confignet_tpu_torch.ConfigNetFirstStage.MODEL_TYPE == "ConfigNetFirstStage"
    assert confignet_tpu_torch.ConfigNet.MODEL_TYPE == "ConfigNet"
    assert confignet_tpu_torch.LatentGAN.MODEL_TYPE == "LatentGAN"
    assert confignet_tpu_torch.CelebaAttributeClassifier.MODEL_TYPE == "CelebaAttributeClassifier"
    assert hasattr(confignet_tpu_torch.NeuralRendererDataset, "generate_face_dataset")
    assert hasattr(confignet_tpu_torch.FaceImageNormalizer, "normalize_individual_image")
    assert hasattr(confignet_tpu_torch.ControllabilityMetrics, "get_metrics")
    assert hasattr(confignet_tpu_torch.InceptionMetrics, "get_metrics")
    assert len(confignet_tpu_torch.ControllabilityMetricConfigs.all_configs()) == 8
    assert callable(confignet_tpu_torch.load_confignet)
    assert confignet_tpu_torch.ConfigNetServer.__module__ == "confignet_tpu_torch.serving"


def test_exports_mirror_the_jax_package():
    import confignet_tpu
    import confignet_tpu_torch

    assert set(confignet_tpu_torch._LAZY_EXPORTS) == set(confignet_tpu._LAZY_EXPORTS)
    for name, module in confignet_tpu._LAZY_EXPORTS.items():
        assert confignet_tpu_torch._LAZY_EXPORTS[name] == module.replace(
            "confignet_tpu.", "confignet_tpu_torch.", 1), name
        assert getattr(confignet_tpu_torch, name).__name__ == name


def test_dir_lists_exports():
    import confignet_tpu_torch

    names = dir(confignet_tpu_torch)
    for expected in ("ConfigNet", "LatentGAN", "NeuralRendererDataset", "ConfigNetServer"):
        assert expected in names


def test_unknown_name_raises():
    import confignet_tpu_torch

    try:
        confignet_tpu_torch.NoSuchName
    except AttributeError as err:
        assert "NoSuchName" in str(err)
    else:
        raise AssertionError("an unknown name resolved")


def test_root_export_loads_no_jax():
    """In a fresh interpreter, a root export resolves from the port's module
    without JAX or the JAX package entering sys.modules."""
    code = ("import sys, confignet_tpu_torch; m = confignet_tpu_torch.ConfigNet; "
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'confignet_tpu')]; print(m.__module__, bad); "
            "sys.exit(0 if m.__module__ == 'confignet_tpu_torch.training.second_stage' and not bad "
            "else 1)")
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                            text=True, timeout=300)
    assert result.returncode == 0, result.stdout + result.stderr


def test_facemodel_input_dim_matches_jax():
    from confignet_tpu_torch import ConfigNet, ConfigNetFirstStage

    config = dict(TINY_FIRST_STAGE_CONFIG)
    want = JaxConfigNetFirstStage(dict(config), initialize=False).facemodel_input_dim
    assert want == 8 + 3
    for cls in (ConfigNetFirstStage, ConfigNet):
        assert cls(dict(config), device="cpu", initialize=False).facemodel_input_dim == want


def test_latent_gan_initialize_network_reseeds():
    """initialize_network builds the two MLPs from the config's seed, the
    EMA copy and fresh optimizers; __init__ calls it."""
    from confignet_tpu_torch import LatentGAN

    gan = LatentGAN({"latent_dim": 6, "seed": 3}, device="cpu")
    first = gan.get_weights()
    gan._build_train_step()(torch.randn(gan.config["batch_size"], 6))
    assert any(gan.optimizers[p].state for p in gan.optimizers)
    assert not all(np.array_equal(v, first["generator"][k])
                   for k, v in gan.get_weights()["generator"].items())
    gan.initialize_network()
    again = gan.get_weights()
    for tree, leaves in first.items():
        for key, value in leaves.items():
            np.testing.assert_array_equal(again[tree][key], value, err_msg=f"{tree}/{key}")
    assert not any(gan.optimizers[p].state for p in gan.optimizers)


def test_perceptual_loss_method_is_loss_fn():
    from confignet_tpu_torch.losses.perceptual import PerceptualLoss

    loss = PerceptualLoss("imagenet", taps=(1, 2))
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        assert torch.equal(loss.loss(a, b), loss.loss_fn(a, b))
        assert loss.loss(a, a).item() == 0.0 and loss.loss(a, b).item() > 0.0


def test_load_reference_pickle_reads_reference_and_jax_names(tmp_path):
    """A pickle naming the reference's distribution class and one naming the
    JAX package's load as the port's class, with the JAX reader agreeing on
    the payload; a plain object round-trips."""
    from confignet_tpu_torch.core import pickles
    from confignet_tpu_torch.core.reference_import import load_reference_pickle
    from confignet_tpu_torch.data.distributions import ExemplarDistribution

    exemplars = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    distribution = ExemplarDistribution()
    distribution.fit(exemplars)
    for module in ("confignet.neural_renderer_dataset", "confignet_tpu.data.distributions"):

        class Writer(pickles._Pickler):
            write_modules = {"confignet_tpu_torch.data.distributions": module}

        path = tmp_path / f"{module}.pck"
        with open(path, "wb") as fp:
            Writer(fp, protocol=4).dump({"x": distribution})
        assert module.encode() in path.read_bytes()
        got = load_reference_pickle(str(path))["x"]
        assert type(got) is ExemplarDistribution
        np.testing.assert_array_equal(got.exemplars, exemplars)
        np.testing.assert_array_equal(jax_load_reference_pickle(str(path))["x"].exemplars, exemplars)
    path = tmp_path / "plain.pck"
    path.write_bytes(pickle.dumps([1, 2.5, "three"]))
    assert load_reference_pickle(str(path)) == [1, 2.5, "three"]
