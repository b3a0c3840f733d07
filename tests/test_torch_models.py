"""The port's models (confignet_tpu_torch.models) against the JAX package on
the CPU at tiny widths: JAX initialises the weights, load_jax_params copies
them into the port, and the same numpy inputs go through both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from confignet_tpu.core.init_cache import cached_init
from confignet_tpu.models import blocks as jax_blocks
from confignet_tpu.models.discriminator import HologanDiscriminator as JaxDiscriminator
from confignet_tpu.models.discriminator import HologanLatentRegressor as JaxLatentRegressor
from confignet_tpu.models.generator import HologanGenerator as JaxGenerator
from confignet_tpu.models.real_encoder import RealEncoder as JaxRealEncoder
from confignet_tpu.models.synthetic_encoder import SyntheticDataEncoder as JaxSyntheticEncoder
from confignet_tpu_torch.core.model_io import (
    export_jax_params, flatten_param_trees, load_jax_params, unflatten_param_trees)
from confignet_tpu_torch.models import blocks
from confignet_tpu_torch.models.backbones.resnet import resnet50_preprocess
from confignet_tpu_torch.models.discriminator import HologanDiscriminator, HologanLatentRegressor
from confignet_tpu_torch.models.generator import HologanGenerator
from confignet_tpu_torch.models.real_encoder import RealEncoder
from confignet_tpu_torch.models.synthetic_encoder import SyntheticDataEncoder

torch.set_num_threads(1)

LATENT_DIM = 10


def flat_params(params):
    """A flax parameter tree -> {pytree path: ndarray} (one tree)."""
    return {"/".join(path): np.array(leaf)
            for path, leaf in traverse_util.flatten_dict(params).items()}


def perturbed(params, seed, scale=0.1):
    """Add seeded noise to every leaf, so zero biases and zero-init heads
    carry information through the comparison."""
    rng = np.random.default_rng(seed)
    return {k: (v + scale * rng.normal(size=v.shape) * max(float(np.std(v)), 1.0)).astype(np.float32)
            for k, v in params.items()}


def latents_and_poses(batch, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(batch, LATENT_DIM)).astype(np.float32)
    rot = (rng.uniform(-1, 1, size=(batch, 3)) * np.array([np.pi / 6, np.pi / 18, 0.0])).astype(np.float32)
    rot[0] = 0.0
    return z, rot


def test_mlp_adain_convadain_match_jax():
    rng = np.random.default_rng(1)
    z = rng.normal(size=(2, LATENT_DIM)).astype(np.float32)
    x3 = rng.normal(size=(2, 4, 4, 4, 6)).astype(np.float32)
    x2 = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    cases = [
        (jax_blocks.MLP(num_layers=3, num_hidden=7, num_out=5), (z,),
         blocks.MLP(3, LATENT_DIM, 7, 5)),
        (jax_blocks.AdaIN(num_features=6, mlp_num_units=8, mlp_num_layers=2), (x2, z),
         blocks.AdaIN(6, LATENT_DIM, 8, 2)),
        (jax_blocks.ConvAdaIN(num_feature_maps=4, kernel_size=3, rank=3, mlp_num_units=8,
                              mlp_num_layers=2, pre_upsample=True), (x3, z),
         blocks.ConvAdaIN(6, 4, 3, 3, LATENT_DIM, 8, 2, pre_upsample=True)),
        (jax_blocks.ConvAdaIN(num_feature_maps=4, kernel_size=4, rank=2, mlp_num_units=8,
                              mlp_num_layers=2, double_conv=True), (x2, z),
         blocks.ConvAdaIN(6, 4, 4, 2, LATENT_DIM, 8, 2, double_conv=True)),
    ]
    for i, (jmod, args, tmod) in enumerate(cases):
        params = jmod.init(jax.random.PRNGKey(i), *map(jnp.asarray, args))["params"]
        flat = perturbed(flat_params(params), seed=i)
        want = np.asarray(jmod.apply({"params": traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}, *map(jnp.asarray, args)))
        load_jax_params(tmod, flat)
        with torch.no_grad():
            got = tmod(*map(torch.from_numpy, args)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=type(tmod).__name__)


def _generator_pair(size, dtype=None):
    kw = dict(latent_dim=LATENT_DIM, output_shape=(size, size), n_adain_mlp_units=8,
              const_shape=(4, 4, 4, 8), n_features_first=16)
    jgen = JaxGenerator(**kw, dtype=jnp.bfloat16 if dtype == torch.bfloat16 else None)
    z, rot = latents_and_poses(1)
    params = cached_init(jgen, jax.random.PRNGKey(size), jnp.asarray(z), jnp.asarray(rot))["params"]
    flat = perturbed(flat_params(params), seed=size)
    tgen = HologanGenerator(**kw, dtype=dtype)
    load_jax_params(tgen, flat)
    jparams = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return jgen, jparams, tgen


@pytest.mark.parametrize("size", [128, 256, 512])
def test_generator_matches_jax_f32(size):
    jgen, jparams, tgen = _generator_pair(size)
    z, rot = latents_and_poses(3, seed=size)
    want = np.asarray(jgen.apply({"params": jparams}, jnp.asarray(z), jnp.asarray(rot)))
    for impl in ("gather", "kernel"):
        tgen.rotation_resample = impl
        with torch.no_grad():
            got = tgen(torch.from_numpy(z), torch.from_numpy(rot)).numpy()
        assert got.shape == (3, size, size, 3)
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_generator_five_way_latents_match_jax():
    jgen, jparams, tgen = _generator_pair(128)
    zs = [latents_and_poses(2, seed=s)[0] for s in range(5)]
    rot = latents_and_poses(2, seed=9)[1]
    want = np.asarray(jgen.apply({"params": jparams}, [jnp.asarray(z) for z in zs], jnp.asarray(rot)))
    with torch.no_grad():
        got = tgen([torch.from_numpy(z) for z in zs], torch.from_numpy(rot)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_generator_matches_jax_bf16():
    """bf16 compute: the two frameworks round at different places, so the
    bound is JAX's own bf16 rounding noise -- the port's bf16 images must be
    no farther from JAX's bf16 images (mean and max abs) than those are from
    JAX's float32 images with the same weights."""
    jgen, jparams, tgen = _generator_pair(128, torch.bfloat16)
    jgen32 = JaxGenerator(latent_dim=LATENT_DIM, output_shape=(128, 128), n_adain_mlp_units=8,
                          const_shape=(4, 4, 4, 8), n_features_first=16)
    z, rot = latents_and_poses(3, seed=11)
    want = np.asarray(jgen.apply({"params": jparams}, jnp.asarray(z), jnp.asarray(rot)), np.float32)
    want32 = np.asarray(jgen32.apply({"params": jparams}, jnp.asarray(z), jnp.asarray(rot)))
    with torch.no_grad():
        got = tgen(torch.from_numpy(z), torch.from_numpy(rot))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    noise = np.abs(want - want32)
    assert diff.mean() <= noise.mean() and diff.max() <= noise.max(), (diff.mean(), noise.mean())


def test_generator_rejects_unsupported_size():
    with pytest.raises(ValueError, match="unsupported"):
        HologanGenerator(LATENT_DIM, (192, 192))


def test_synthetic_encoder_matches_jax():
    inputs = (("blendshape_values", (8, 6)), ("bone_rotations:left_eye", (2, 2)),
              ("head_hair_color", (3, 4)))
    rng = np.random.default_rng(3)
    values = [rng.normal(size=(2, d[0])).astype(np.float32) for _, d in inputs]
    jmod = JaxSyntheticEncoder(facemodel_inputs=inputs)
    params = jmod.init(jax.random.PRNGKey(0), [jnp.asarray(v) for v in values])["params"]
    flat = flat_params(params)
    tmod = SyntheticDataEncoder(inputs)
    load_jax_params(tmod, flat)
    want = np.asarray(jmod.apply({"params": params}, [jnp.asarray(v) for v in values]))
    want_one = np.asarray(jmod.apply({"params": params}, "head_hair_color", jnp.asarray(values[2]),
                                     method=jmod.encode_single_param))
    with torch.no_grad():
        got = tmod([torch.from_numpy(v) for v in values]).numpy()
        got_stacked = tmod(torch.from_numpy(np.concatenate(values, axis=1))).numpy()
        got_one = tmod.encode_single_param("head_hair_color", torch.from_numpy(values[2])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got_stacked, want, atol=1e-5)
    np.testing.assert_allclose(got_one, want_one, atol=1e-5)


@pytest.mark.parametrize("norm", ["frozen", "group"])
def test_real_encoder_matches_jax(norm):
    """Relative tolerance 2e-2: the random-init ResNet trunk amplifies
    activations to ~1e5 (as in tests/test_serving.py)."""
    ranges = ((-30, 30), (-10, 10), (0, 0))
    imgs = np.random.default_rng(4).uniform(-1, 1, size=(2, 64, 64, 3)).astype(np.float32)
    jmod = JaxRealEncoder(latent_dim=LATENT_DIM, rotation_ranges=ranges, trunk_norm=norm)
    params = cached_init(jmod, jax.random.PRNGKey(0), jnp.asarray(imgs[:1]))["params"]
    flat = flat_params(params)
    tmod = RealEncoder(LATENT_DIM, ranges, trunk_norm=norm)
    load_jax_params(tmod, flat)
    # the heads are zero-initialised: give them weights scaled to the
    # trunk's features so that latents and poses vary
    with torch.no_grad():
        features = tmod.resnet(resnet50_preprocess(torch.from_numpy(imgs)))
    std = 1.0 / (np.sqrt(2048) * float(features.square().mean().sqrt()))
    rng = np.random.default_rng(5)
    for head in ("feature_to_latent", "rotation_regressor"):
        shape = flat[f"{head}/kernel"].shape
        flat[f"{head}/kernel"] = (rng.normal(size=shape) * std).astype(np.float32)
    load_jax_params(tmod, flat)
    jparams = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    want_lat, want_rot = (np.asarray(a) for a in jmod.apply({"params": jparams}, jnp.asarray(imgs)))

    with torch.no_grad():
        lat, rot = (a.numpy() for a in tmod(torch.from_numpy(imgs)))
    assert np.abs(want_lat).max() > 1e-3 and np.abs(want_rot).max() > 1e-3
    np.testing.assert_allclose(lat, want_lat, rtol=2e-2, atol=2e-2 * np.abs(want_lat).max())
    np.testing.assert_allclose(rot, want_rot, rtol=2e-2, atol=1e-3)


def test_weights_round_trip_port_numpy_port():
    """port -> numpy (JAX layout, npz keys) -> port is the identity, and the
    exported keys are exactly the JAX generator's pytree paths."""
    gen = HologanGenerator(LATENT_DIM, (128, 128), n_adain_mlp_units=8,
                           const_shape=(4, 4, 4, 8), n_features_first=16)
    flat = export_jax_params(gen)
    jgen, jparams, _ = _generator_pair(128)
    assert set(flat) == set(flat_params(jparams))
    for key in ("learned_input", "map_3d_0/conv_0/kernel", "map_3d_0/adain/mlp/dense_0/kernel",
                "map_3d_post_0/kernel", "projection_conv/kernel", "map_final/kernel"):
        assert key in flat

    npz = flatten_param_trees({"generator": flat})
    trees = unflatten_param_trees(npz)
    assert set(trees) == {"generator"}
    back = flatten_param_trees(trees)
    assert set(back) == set(npz)
    other = HologanGenerator(LATENT_DIM, (128, 128), n_adain_mlp_units=8,
                             const_shape=(4, 4, 4, 8), n_features_first=16)
    load_jax_params(other, {k.partition("/")[2]: v for k, v in back.items()})
    for (name, a), (_, b) in zip(gen.named_parameters(), other.named_parameters()):
        assert torch.equal(a, b), name


def _carry(jmod, tmod, args, seed):
    """Init the JAX module, perturb its weights, load them into the port's
    module; returns (flat weights, JAX output on args)."""
    params = jmod.init(jax.random.PRNGKey(seed), *map(jnp.asarray, args))["params"]
    flat = perturbed(flat_params(params), seed=seed)
    load_jax_params(tmod, flat)
    jparams = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return flat, jmod.apply({"params": jparams}, *map(jnp.asarray, args))


@pytest.mark.parametrize("size", [8, 7])
@pytest.mark.parametrize("return_styles", [True, False])
def test_discr_block_matches_jax(size, return_styles):
    """Stride-2 TF SAME conv (even and odd sizes), styles from the conv
    output before the LeakyReLU, std_instance_norm; atol 1e-4."""
    x = np.random.default_rng(12).normal(size=(2, size, size, 5)).astype(np.float32)
    tmod = blocks.DiscrBlock(5, 6, 3, return_styles=return_styles)
    _, want = _carry(jax_blocks.DiscrBlock(num_feature_maps=6, kernel_size=3,
                                           return_styles=return_styles), tmod, (x,), seed=size)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    if return_styles:
        assert got[1].shape == (2, 12)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
        got, want = got[0], want[0]
    assert got.shape == (2, (size + 1) // 2, (size + 1) // 2, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


DISCR_KW = dict(num_resample=3, disc_expansion_factor=4, disc_max_feature_maps=16)


def test_discriminator_matches_jax_in_head_order():
    """The three-layer tiny widths of TINY_FIRST_STAGE_CONFIG (4, 8, 16) at
    32px; heads discr_style_0..2 then discr_final; atol 1e-4.  The final
    Dense sees the trunk flattened channels-last, as in JAX."""
    imgs = np.random.default_rng(13).uniform(-1, 1, size=(3, 32, 32, 3)).astype(np.float32)
    tmod = HologanDiscriminator((32, 32), **DISCR_KW)
    flat, want = _carry(JaxDiscriminator(img_shape=(32, 32), **DISCR_KW), tmod, (imgs,), seed=3)
    assert flat["disc_map/kernel"].shape == (4 * 4 * 16, 1)
    with torch.no_grad():
        got = tmod(torch.from_numpy(imgs))
    assert list(got) == ["discr_style_0", "discr_style_1", "discr_style_2", "discr_final"]
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value), atol=1e-4, err_msg=key)


def test_latent_regressor_matches_jax():
    imgs = np.random.default_rng(14).uniform(-1, 1, size=(3, 32, 32, 3)).astype(np.float32)
    tmod = HologanLatentRegressor(LATENT_DIM, (32, 32), **DISCR_KW)
    _, want = _carry(JaxLatentRegressor(latent_dim=LATENT_DIM, img_shape=(32, 32), **DISCR_KW),
                     tmod, (imgs,), seed=4)
    with torch.no_grad():
        got = tmod(torch.from_numpy(imgs)).numpy()
    assert got.shape == (3, LATENT_DIM + 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_training_trees_round_trip_with_jax_keys():
    """get_weights/set_weights carry all seven trees of the JAX checkpoint
    (and the npz tree flattening) both ways; the keys are JAX's."""
    from helpers import TINY_FIRST_STAGE_CONFIG
    from confignet_tpu.training.first_stage import ConfigNetFirstStage as JaxFirstStage
    from confignet_tpu_torch.training.first_stage import ConfigNetFirstStage

    jweights = {name: flat_params(tree) for name, tree in JaxFirstStage(
        dict(TINY_FIRST_STAGE_CONFIG)).get_weights().items()}
    model = ConfigNetFirstStage(dict(TINY_FIRST_STAGE_CONFIG), device="cpu")
    weights = model.get_weights()
    assert set(weights) == set(jweights) and len(weights) == 7
    for name, tree in jweights.items():
        assert set(weights[name]) == set(tree), name
        assert all(weights[name][k].shape == v.shape for k, v in tree.items()), name
    for name, key in (("discriminator", "block_0/conv/kernel"), ("discriminator", "block_2/in_gamma"),
                      ("synth_discriminator", "style_classifier_1/kernel"),
                      ("discriminator", "disc_map/kernel"), ("latent_regressor", "from_rgb/kernel"),
                      ("latent_regressor", "latent_predictor/bias"),
                      ("latent_discriminator", "dense_1/kernel")):
        assert key in weights[name], (name, key)
    vgg = export_jax_params(model.perceptual_loss.vgg)
    assert set(vgg) == {"block1_conv1/kernel", "block1_conv1/bias", "block1_conv2/kernel",
                        "block1_conv2/bias"}

    model.set_weights(unflatten_and_flatten(jweights))
    back = model.get_weights()
    for name, tree in jweights.items():
        for key, value in tree.items():
            np.testing.assert_array_equal(back[name][key], value, err_msg=f"{name}/{key}")
    with pytest.raises(KeyError, match="latent_discriminator"):
        model.set_weights({k: v for k, v in jweights.items() if k != "latent_discriminator"})


def unflatten_and_flatten(weights):
    """Through the npz layout: {tree/path: array} and back."""
    trees = unflatten_param_trees(flatten_param_trees(weights))
    return {name: flatten_param_trees({"": tree}) for name, tree in trees.items()}


def test_load_jax_params_rejects_mismatch():
    mod = blocks.MLP(2, 4, 3, 2)
    flat = export_jax_params(mod)
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(mod, {k: v for k, v in flat.items() if k != "dense_0/bias"})
    with pytest.raises(KeyError, match="unused"):
        load_jax_params(mod, dict(flat, extra=np.zeros(1)))
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(mod, dict(flat, **{"dense_0/kernel": np.zeros((3, 4), np.float32)}))
