"""The port's LatentGAN against the JAX package's on the CPU.

- Two train steps from the JAX weights with the noise pinned on both sides
  (the JAX step's ``_sample_noise_on_device`` monkeypatched before each
  ``_build_train_step``, so each traced step bakes in its own draws; the
  port's ``_sample_noise`` overridden): every loss within rtol 1e-4 and every
  parameter leaf, the EMA generator's included, within atol 1e-5 of the
  leaf's largest value.  The EMA starts at zeros, so that bound holds its
  decay.
- ``generate_latents`` at truncation 0.7 and 1.0 within atol 1e-5 of JAX's
  after the same ``np.random.seed``; checkpoints move both ways;
  ``extract_embeddings`` chunks as JAX's does; a reference-release npz with
  the wrong count of weights is refused; ``LatentGAN({})`` raises ValueError.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from confignet_tpu.training.latent_gan import LatentGAN as JaxLatentGAN
from confignet_tpu_torch.core import model_io
from confignet_tpu_torch.training.latent_gan import LatentGAN

torch.set_num_threads(1)

CONFIG = {"latent_dim": 12, "batch_size": 8}


def _flat(tree):
    return {"/".join(path): np.array(leaf) for path, leaf in traverse_util.flatten_dict(tree).items()}


def _pair(config=CONFIG):
    jgan = JaxLatentGAN(dict(config))
    gan = LatentGAN(dict(config), device="cpu")
    gan.set_weights({name: _flat(tree) for name, tree in jgan.get_weights().items()})
    return jgan, gan


def _check_weights(got, want):
    assert set(got) == set(want)
    for tree, leaves in want.items():
        assert set(got[tree]) == set(leaves), tree
        for key, value in leaves.items():
            np.testing.assert_allclose(got[tree][key], value, rtol=0,
                                       atol=1e-5 * np.abs(value).max(), err_msg=f"{tree}/{key}")


def test_weights_carry_over_exactly():
    jgan, gan = _pair()
    want = {name: _flat(tree) for name, tree in jgan.get_weights().items()}
    got = gan.get_weights()
    assert set(got) == {"generator", "generator_smoothed", "discriminator"}
    for tree, leaves in want.items():
        assert set(got[tree]) == set(leaves) == {f"dense_{i}/{p}" for i in range(3)
                                                 for p in ("kernel", "bias")}
        for key, value in leaves.items():
            np.testing.assert_array_equal(got[tree][key], value)
    assert got["generator"]["dense_0/kernel"].shape == (12, 18)  # hidden int(1.5 * 12)
    assert got["discriminator"]["dense_2/kernel"].shape == (18, 1)


def test_two_train_steps_match_jax(monkeypatch):
    jgan, gan = _pair()
    # the EMA starts at zeros on both sides, so after two steps it holds about
    # 2 (1 - decay) of the generator and the leaf-relative bound below tests
    # the decay (from the generator's own start it would move ~1e-7)
    weights = jgan.get_weights()
    weights["generator_smoothed"] = jax.tree_util.tree_map(np.zeros_like,
                                                           weights["generator_smoothed"])
    jgan.set_weights(weights)
    gan.set_weights({name: _flat(tree) for name, tree in weights.items()})
    rng = np.random.default_rng(0)
    # per step: the real batch, the D step's noise, the G step's noise
    steps = [[rng.normal(size=(8, 12)).astype(np.float32) for _ in range(3)] for _ in range(2)]
    before = gan.get_weights()

    port_noise = []
    gan._sample_noise = lambda n: torch.from_numpy(port_noise.pop(0))
    port_step = gan._build_train_step()
    for real, noise_d, noise_g in steps:
        jax_noise = [noise_d, noise_g]
        monkeypatch.setattr(jgan, "_sample_noise_on_device",
                            lambda key, n: jnp.asarray(jax_noise.pop(0)), raising=False)
        jgan.state, jlosses = jgan._build_train_step()(jgan.state, jgan.keychain.next(),
                                                         jnp.asarray(real))
        assert not jax_noise  # traced: both draws baked into this step
        port_noise[:] = [noise_d, noise_g]
        losses = port_step(torch.from_numpy(real))
        assert not port_noise

        jlosses = jax.device_get(jlosses)
        assert set(losses["d"]) == {"GAN_loss_real", "GAN_loss_fake", "gp_loss", "loss_sum"}
        assert set(losses["g"]) == set(jlosses["g"]) == {"gan_loss", "loss_sum"}
        for group in ("d", "g"):
            for key, value in jlosses[group].items():
                np.testing.assert_allclose(float(losses[group][key]), float(value), rtol=1e-4,
                                           err_msg=f"{group}/{key}")

    want = {name: _flat(tree) for name, tree in jgan.get_weights().items()}
    got = gan.get_weights()
    _check_weights(got, want)
    for tree in got:
        assert any(not np.array_equal(got[tree][k], before[tree][k]) for k in got[tree]), tree


def test_default_noise_drives_a_step():
    gan = LatentGAN(dict(CONFIG, latent_distribution_type="uniform"), device="cpu")
    noise = gan._sample_noise(5)
    assert noise.shape == (5, 12) and noise.min() >= -1 and noise.max() <= 1
    losses = gan._build_train_step()(torch.zeros((8, 12)))
    assert all(torch.isfinite(v) for group in losses.values() for v in group.values())


@pytest.mark.parametrize("truncation", [0.7, 1.0])
def test_generate_latents_matches_jax(truncation):
    jgan, gan = _pair()
    np.random.seed(4)
    want = jgan.generate_latents(6, truncation=truncation)
    np.random.seed(4)
    got = gan.generate_latents(6, truncation=truncation)
    assert got.shape == (6, 12) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.random.seed(4)
    noise = gan.sample_input_latent_vector(6)
    np.random.seed(4)
    assert noise.tobytes() == jgan.sample_input_latent_vector(6).tobytes()


def test_checkpoints_move_both_ways(tmp_path):
    jgan, gan = _pair()
    noise = np.random.default_rng(1).normal(size=(3, 12)).astype(np.float32)
    gan.generator_smoothed.dense_0.bias.data += 0.25  # port weights that JAX does not have
    gan.save(str(tmp_path), "port")
    assert sorted(os.listdir(tmp_path)) == ["port.json", "port.npz"]
    loaded_by_jax = JaxLatentGAN.load(str(tmp_path / "port.json"))
    np.testing.assert_allclose(loaded_by_jax.generate_latents_smoothed(noise),
                               gan.generate_latents_smoothed(noise), atol=1e-5)
    again = model_io.load_confignet(str(tmp_path / "port.json"), device="cpu")
    assert type(again) is LatentGAN and again.config == gan.config
    np.testing.assert_array_equal(again.generate_latents_smoothed(noise),
                                  gan.generate_latents_smoothed(noise))

    jgan.save(str(tmp_path), "jax")
    loaded = LatentGAN.load(str(tmp_path / "jax.json"), device="cpu")
    want = {name: _flat(tree) for name, tree in jgan.get_weights().items()}
    for tree, leaves in loaded.get_weights().items():
        for key, value in leaves.items():
            np.testing.assert_array_equal(value, want[tree][key])
    np.testing.assert_allclose(loaded.generate_latents_smoothed(noise),
                               jgan.generate_latents_smoothed(noise), atol=1e-5)


def test_reference_format_is_refused(tmp_path):
    weights = np.empty(2, dtype=object)
    weights[:] = [np.zeros((12, 18), np.float32), np.zeros(18, np.float32)]
    np.savez(tmp_path / "ref.npz", generator_weights=weights, discriminator_weights=weights)
    with open(tmp_path / "ref.json", "w") as fp:
        json.dump({"model_type": "LatentGAN", "latent_dim": 12}, fp)
    # sniffed as a reference release, whose MLPs have 3 layers of 2 weights
    with pytest.raises(ValueError, match="expected 6 weights, got 2"):
        LatentGAN.load(str(tmp_path / "ref.json"), device="cpu")


def test_extract_embeddings_matches_jax():
    class Encoder:
        """Stands in for a ConfigNet: one latent row per image."""

        def encode_images(self, imgs):
            flat = np.asarray(imgs, np.float32).reshape(len(imgs), -1)[:, :12] / 255.0
            return flat, np.zeros((len(imgs), 3), np.float32)

    class Photos:
        imgs = np.random.default_rng(2).integers(0, 256, (7, 4, 4, 3), dtype=np.uint8)

    jgan, gan = _pair()
    got = gan.extract_embeddings(Encoder(), Photos(), max_chunk_size=3)
    assert got.shape == (7, 12) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jgan.extract_embeddings(Encoder(), Photos(), max_chunk_size=3))
    np.testing.assert_array_equal(got, Encoder().encode_images(Photos.imgs)[0])


def test_config_and_device_rules(monkeypatch):
    with pytest.raises(ValueError, match="latent_dim"):
        LatentGAN({})
    gan = LatentGAN({"latent_dim": 4}, device="cpu")
    assert gan.config["batch_size"] == 32 and gan.config["optimizer"]["lr"] == 5e-5
    assert gan.optimizers["generator"].defaults["betas"] == (0.0, 0.9)
    assert gan.optimizers["discriminator"].defaults["eps"] == 1e-7
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LatentGAN({"latent_dim": 4})
