"""The port's losses (confignet_tpu_torch.losses) against the JAX package on
the CPU: the same numpy inputs, discriminator and VGG weights carried across
with load_jax_params.  Values rtol 1e-5 (PARITY.md's bound for the losses);
the discriminator loss's parameter gradients, which go through the R1
penalty's double backward, rtol 1e-3 with atol 1e-4 of each leaf's largest
value (the float32 noise measured in tests/test_torch_train.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from confignet_tpu.losses import gan as jax_gan
from confignet_tpu.losses.perceptual import PerceptualLoss as JaxPerceptualLoss
from confignet_tpu.models.blocks import MLP as JaxMLP
from confignet_tpu.models.discriminator import HologanDiscriminator as JaxDiscriminator
from confignet_tpu_torch.core.model_io import export_jax_tensors, load_jax_params
from confignet_tpu_torch.losses import gan
from confignet_tpu_torch.losses.perceptual import PerceptualLoss
from confignet_tpu_torch.models.blocks import MLP
from confignet_tpu_torch.models.discriminator import HologanDiscriminator

torch.set_num_threads(1)


def _flat(tree):
    return {"/".join(path): np.array(leaf) for path, leaf in traverse_util.flatten_dict(tree).items()}


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=rtol)


def test_elementwise_losses_match_jax():
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(6, 1)).astype(np.float32) * 3
    gt, gen = (rng.uniform(-1, 1, size=(3, 16, 16, 3)).astype(np.float32) for _ in range(2))
    masks = (rng.random((3, 16, 16)) > 0.8).astype(np.uint8)
    grads = rng.normal(size=(3, 16, 16, 3)).astype(np.float32)
    pred, labels = (rng.normal(size=(8, 13)).astype(np.float32) for _ in range(2))
    t, j = torch.from_numpy, jnp.asarray
    _close(gan.gan_g_loss(t(scores)), jax_gan.gan_g_loss(j(scores)))
    for label in (0.0, 1.0):
        _close(gan.gan_d_loss(label, t(scores)), jax_gan.gan_d_loss(label, j(scores)))
    _close(gan.eye_loss(t(gt), t(gen), t(masks)), jax_gan.eye_loss(j(gt), j(gen), j(masks)))
    _close(gan.r1_penalty(t(grads)), jax_gan.r1_penalty(j(grads)))
    _close(gan.latent_regression_loss(t(pred), t(labels)), jax_gan.latent_regression_loss(j(pred), j(labels)))
    _close(gan.normalized_latent_regression_loss(t(pred), t(labels), 10.0),
           jax_gan.normalized_latent_regression_loss(j(pred), j(labels), 10.0))


DISCR_KW = dict(num_resample=3, disc_expansion_factor=4, disc_max_feature_maps=16)


@pytest.fixture(scope="module")
def discriminators():
    imgs = np.random.default_rng(1).uniform(-1, 1, size=(2, 4, 32, 32, 3)).astype(np.float32)
    jmod = JaxDiscriminator(img_shape=(32, 32), **DISCR_KW)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(imgs[0]))["params"]
    tmod = HologanDiscriminator((32, 32), **DISCR_KW)
    load_jax_params(tmod, _flat(params))
    return jmod, params, tmod, imgs


@pytest.mark.parametrize("r1_heads", ["all", "final"])
def test_discriminator_loss_matches_jax(discriminators, r1_heads):
    """Every per-head loss under the JAX names (head i in the direct call's
    insertion order, PARITY.md:30-35), the R1 heads of each mode, loss_sum,
    and the gradient of loss_sum with respect to the parameters."""
    jmod, params, tmod, (real, fake) = discriminators

    def jax_loss(p):
        losses = jax_gan.compute_discriminator_loss(
            lambda x: jmod.apply({"params": p}, x), jnp.asarray(real), jnp.asarray(fake),
            r1_heads=r1_heads)
        return losses["loss_sum"], losses

    (_, want), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    got = gan.compute_discriminator_loss(tmod, torch.from_numpy(real), torch.from_numpy(fake),
                                         r1_heads=r1_heads)
    n_gp = 4 if r1_heads == "all" else 1
    assert list(got) == ([f"GAN_loss_real_{i}" for i in range(4)] + [f"GAN_loss_fake_{i}" for i in range(4)]
                         + [f"gp_loss_{i}" for i in range(4 - n_gp, 4)] + ["loss_sum"])
    assert set(got) == set(want)
    for key, value in want.items():
        _close(got[key], value)

    tmod.zero_grad()
    got["loss_sum"].backward()
    got_grads = export_jax_tensors((n, p.grad) for n, p in tmod.named_parameters())
    for key, value in _flat(jgrads).items():
        np.testing.assert_allclose(got_grads[key], value, rtol=1e-3, atol=1e-4 * np.abs(value).max(),
                                   err_msg=key)


def test_latent_discriminator_loss_matches_jax():
    rng = np.random.default_rng(2)
    real, fake = (rng.normal(size=(6, 10)).astype(np.float32) for _ in range(2))
    jmod = JaxMLP(num_layers=2, num_hidden=10, num_out=1)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(real))["params"]
    tmod = MLP(2, 10, 10, 1)
    load_jax_params(tmod, _flat(params))
    want = jax_gan.compute_latent_discriminator_loss(
        lambda z: jmod.apply({"params": params}, z), jnp.asarray(real), jnp.asarray(fake))
    got = gan.compute_latent_discriminator_loss(tmod, torch.from_numpy(real), torch.from_numpy(fake))
    assert list(got) == ["GAN_loss_real", "GAN_loss_fake", "gp_loss", "loss_sum"]
    for key, value in want.items():
        _close(got[key], value)


def test_perceptual_loss_matches_jax():
    """VGG19 taps [1, 2] on 32px images, the JAX VGG weights carried across;
    the loss is symmetric but is called in the train step's argument order."""
    rng = np.random.default_rng(3)
    a, b = (rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    jloss = JaxPerceptualLoss((32, 32, 3), taps=(1, 2))
    loss = PerceptualLoss(taps=(1, 2))
    load_jax_params(loss.vgg, _flat(jloss.variables["params"]))
    assert not any(p.requires_grad for p in loss.parameters())
    _close(loss.loss_fn(torch.from_numpy(a), torch.from_numpy(b)), jloss.loss(jnp.asarray(a), jnp.asarray(b)))
    # a bf16 image is promoted to float32 by the VGG (flax promote_dtype)
    got16 = loss.loss_fn(torch.from_numpy(a), torch.from_numpy(b).bfloat16())
    want16 = jloss.loss(jnp.asarray(a), jnp.asarray(b, jnp.bfloat16))
    assert got16.dtype == torch.float32
    _close(got16, want16, rtol=1e-3)


def test_lead_autograd_sequence_puts_the_calling_thread_ahead_once():
    """The lead advances the calling thread's autograd sequence count by at
    least ``_SEQUENCE_LEAD`` nodes, once per process; a CUDA train step
    calls it when built (losses/gan.py)."""
    def next_sequence_nr():
        return (torch.zeros((), requires_grad=True) * 1.0).grad_fn._sequence_nr()

    led = gan._sequence_led
    before = next_sequence_nr()
    gan.lead_autograd_sequence()
    after = next_sequence_nr()
    assert after - before >= (1 if led else gan._SEQUENCE_LEAD)
    assert gan._sequence_led
    gan.lead_autograd_sequence()
    assert next_sequence_nr() - after == 1
