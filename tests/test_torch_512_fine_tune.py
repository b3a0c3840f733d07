"""One iteration of the port's one-shot fine-tune at 512px against the JAX
package's, on TINY_FIRST_STAGE_CONFIG's widths with ``output_shape``
(512, 512, 3), the same weights on both sides (the seven trees, VGG19 and
VGGFace): the generator's seventh AdaIN site (``map_2d_2c``) is on the
differentiated path, and VGG19 and VGGFace see 512x512 renders.

- In float32, the bounds of tests/test_torch_fine_tune.py for the loss
  (rtol 1e-4), the renders (atol 1e-4) and the Adam first moments of all
  optimised tensors together (0.1 times the gradient; a relative L2
  distance below 1e-3).  Each leaf is held to a relative L2 distance below
  1e-3, the bound tests/test_torch_second_stage.py puts on the ResNet50
  trunk's leaves, for the same reason: at 512x512 a few of VGG19's 16.7M
  ``block1_conv1`` pre-activations of this input lie within float32
  rounding of zero (3 here; none at 128px), the ReLU's gradient is
  discontinuous there, and the port's float32 gradient sits up to 7e-4 of
  a leaf's largest value from its own float64 gradient, which equals
  JAX's float64 gradient to 3e-6 relative L2.
- In float64 (both packages: JAX under ``jax.enable_x64``, the port's
  modules in double), where no tie flips, every leaf within rtol 1e-3 and
  atol 1e-4 of its largest value, and all together within 1e-3 relative
  L2: the per-leaf bound of tests/test_torch_fine_tune.py.
- ``fine_tune_on_img`` on one 512px photo runs end to end, within
  2 * n_iters * lr of JAX's embeddings and rotations.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from confignet_tpu.training.second_stage import ConfigNet as JaxConfigNet
from test_torch_512 import CONFIG_512, SIZE, flat
from test_torch_fine_tune import LR, _check_leaves
from confignet_tpu_torch.core.model_io import export_jax_tensors, load_jax_params
from confignet_tpu_torch.training.second_stage import ConfigNet

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxConfigNet(dict(CONFIG_512))
    model = ConfigNet(dict(CONFIG_512), device="cpu")
    model.set_weights({name: flat(tree) for name, tree in jmodel.get_weights().items()})
    load_jax_params(model.perceptual_loss.vgg, flat(jmodel.perceptual_loss.variables["params"]))
    load_jax_params(model.perceptual_loss_face_reco.vgg,
                    flat(jmodel.perceptual_loss_face_reco.variables["params"]))
    return jmodel, model


def one_iteration(models, dtype):
    """(JAX's, the port's) (loss, render, {leaf: Adam first moment}) of one
    fine-tune iteration in ``dtype`` from the same weights, photo, embedding
    split and rotations."""
    jmodel, model = models
    rng = np.random.default_rng(512)
    images = rng.uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    embeddings = rng.normal(size=(1, model.config["latent_dim"])).astype(np.float32)
    rotations = (rng.uniform(-1, 1, (1, 3)) * [np.pi / 6, np.pi / 18, 0]).astype(np.float32)
    variables = model._fine_tune_variables(embeddings, rotations, force_neutral_expression=False)

    with jax.enable_x64(dtype == torch.float64):
        jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
        cast = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdtype), tree)  # noqa: E731
        opt_vars = cast({"generator": jax.device_get(jmodel.state.generator_smoothed),
                         **{k: v.detach().numpy() for k, v in variables.items()}})
        tx = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-7)
        state = jmodel.state
        _, opt_state, jloss, jout = jmodel._get_fine_tune_step(False, 1, tx)(
            opt_vars, tx.init(opt_vars), cast(images), cast(state.discriminator.params),
            cast(state.latent_discriminator.params), cast(state.generator.params["latent_regressor"]),
            cast(jmodel.perceptual_loss.variables["params"]),
            cast(jmodel.perceptual_loss_face_reco.variables["params"]))
        mu = opt_state[0].mu
        want = {f"generator/{k}": v for k, v in flat(mu["generator"]).items()}
        want.update({k: np.asarray(mu[k]) for k in variables})
        jax_result = float(jloss), np.asarray(jout), want

    if dtype == torch.float64:
        model = copy.deepcopy(model)
        for module in (model.generator_smoothed, model.discriminator, model.latent_discriminator,
                       model.latent_regressor, model.perceptual_loss, model.perceptual_loss_face_reco):
            module.double()
    variables = {k: v.detach().to(dtype).requires_grad_(True) for k, v in variables.items()}
    generator = model._fine_tune_generator().to(dtype)
    optimizer = model._fine_tune_optimizer(generator, variables, force_neutral_expression=False)
    losses, out = model._get_fine_tune_step(False, 1)(generator, variables, optimizer,
                                                     torch.from_numpy(images).to(dtype))
    moments = {p: optimizer.state[p]["exp_avg"] for group in optimizer.param_groups
               for p in group["params"]}
    got = {f"generator/{k}": v for k, v in export_jax_tensors(
        ((name, moments[p]) for name, p in generator.named_parameters()), dtype).items()}
    got.update({k: moments[v].numpy() for k, v in variables.items()})
    return jax_result, (float(losses["loss_sum"]), out.numpy(), got)


def check_leaves_relative(got, want):
    """Each leaf, and all together, within 1e-3 relative L2 (the trunk rule)."""
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        if value.size:
            assert np.abs(value).max() > 0, f"{key} has no gradient"
            assert np.linalg.norm(got[key] - value) < 1e-3 * np.linalg.norm(value), key
    keys = sorted(want)
    want_all = np.concatenate([want[k].ravel() for k in keys])
    got_all = np.concatenate([got[k].ravel() for k in keys])
    assert np.linalg.norm(got_all - want_all) < 1e-3 * np.linalg.norm(want_all)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_iteration_matches_jax(models, dtype):
    (jloss, jout, want), (loss, out, got) = one_iteration(models, dtype)
    assert any(k.startswith("generator/map_2d_2c/") for k in want)
    assert out.shape == (1, SIZE, SIZE, 3) and out.dtype == want["expr"].dtype
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    np.testing.assert_allclose(out, jout, atol=1e-4)
    if dtype == torch.float64:
        _check_leaves(got, want)
    else:
        check_leaves_relative(got, want)


def test_fine_tune_on_img_matches_jax(models):
    """One 512px photo through fine_tune_on_img in both packages (the encoder
    heads keep their zero initialisation, so both start from the same
    encoding): embeddings and rotations within 2 * n_iters * lr of JAX's,
    and the fine-tuned generator renders at 512px."""
    jmodel, model = models
    img = np.random.default_rng(7).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    try:
        embeddings, rotations = model.fine_tune_on_img(img, n_iters=1)
        jembeddings, jrotations = jmodel.fine_tune_on_img(img, n_iters=1)
        assert embeddings.shape == (1, model.config["latent_dim"]) and rotations.shape == (1, 3)
        assert len(model.fine_tune_losses) == 1 and np.isfinite(float(model.fine_tune_losses[0]))
        bound = 2 * 1 * LR
        assert np.abs(embeddings - jembeddings).max() <= bound
        assert np.abs(rotations - jrotations).max() <= bound
        tuned = model._fine_tuned_generator_params
        ema = model.generator_smoothed.state_dict()
        assert any(not torch.equal(tuned[k], ema[k]) for k in tuned)
        rendered = model.generate_images(embeddings, rotations)
        assert rendered.shape == (1, SIZE, SIZE, 3) and rendered.std() > 0
    finally:
        model._fine_tuned_generator_params = None
