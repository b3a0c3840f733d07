"""The 512px path of the port against the JAX package's, on the CPU at
TINY_FIRST_STAGE_CONFIG's widths with ``output_shape`` (512, 512, 3): the
generator adds its ``map_2d_2c`` block, the seventh AdaIN site, of
(65536 positions, 16 channels) at full width.

- ``ConfigNetServer`` over a ConfigNet holding the JAX model's weights (its
  encoder heads given seeded weights): ``encode``, ``generate``,
  ``render_with_attribute`` and ``sample`` through a LatentGAN, with the
  bounds of tests/test_torch_serving.py (latents rtol 2e-2, rotations atol
  1e-2, images a mean abs uint8 difference below 1.0).
- A 512px reference release (tests/helpers.write_reference_checkpoint, every
  weight shifted by 0.5) loads through both packages' ``load_confignet`` to
  the same weights bit for bit, and both render it alike.
- The AdaIN launch plan at the 512 site: one pass over co-resident blocks,
  forward and backward, at every batch of the 512 path, in float32 and
  bfloat16, on an H100's limits, its blocks covering every (sample, group)
  and every row once; and the plain forward and its autograd backward at
  that site against the JAX Pallas kernel (interpret mode) and its custom
  VJP.

The fine-tune and the stage-2 step at 512px are in
tests/test_torch_512_fine_tune.py and tests/test_torch_512_second_stage.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from confignet_tpu.core import model_io as jax_model_io
from confignet_tpu.ops.adain_pallas import fused_adain as jax_fused_adain
from confignet_tpu.serving import ConfigNetServer as JaxServer
from confignet_tpu.training.latent_gan import LatentGAN as JaxLatentGAN
from confignet_tpu.training.second_stage import ConfigNet as JaxConfigNet
from helpers import TINY_FIRST_STAGE_CONFIG, write_reference_checkpoint
from test_torch_second_stage import give_heads_weights
from confignet_tpu_torch.core import model_io
from confignet_tpu_torch.ops.adain_cuda import (
    adain_resident_plan, adain_route, fused_adain)
from confignet_tpu_torch.serving import ConfigNetServer
from confignet_tpu_torch.training.latent_gan import LatentGAN
from confignet_tpu_torch.training.second_stage import ConfigNet

torch.set_num_threads(1)

SIZE = 512
CONFIG_512 = dict(TINY_FIRST_STAGE_CONFIG, output_shape=(SIZE, SIZE, 3))
CHUNK = 2
# the 512 site at full width: map_2d_2c's (256 * 256 positions, 256 // 16 channels)
SITE_512 = (65536, 16)
H100_LIMITS = (232448, 132)  # opt-in shared memory per block, SMs


def flat(tree):
    return {"/".join(path): np.array(leaf) for path, leaf in traverse_util.flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def servers():
    jmodel = JaxConfigNet(dict(CONFIG_512))
    jmodel.set_weights(give_heads_weights(jmodel.get_weights()))
    jsrv = JaxServer(jmodel, chunk=CHUNK)
    model = ConfigNet(dict(CONFIG_512), device="cpu")
    model.set_weights({**{name: flat(tree) for name, tree in jmodel.get_weights().items()},
                       "generator": flat(jsrv._gen_params),
                       "generator_smoothed": flat(jsrv._gen_params),
                       "synthetic_encoder": flat(jsrv._synth_params),
                       "real_encoder": flat(jsrv._enc_params)})
    return jmodel, jsrv, ConfigNetServer(model, chunk=CHUNK, device="cpu"), model


def photos(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)


def close_images(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert a.shape[1:] == (SIZE, SIZE, 3)
    assert np.mean(np.abs(a.astype(int) - b.astype(int))) < 1.0


def test_generator_has_the_512_block(servers):
    *_, model = servers
    assert model.generator_smoothed.extra_blocks == ["map_2d_2b", "map_2d_2c"]


def test_encode_and_generate_match_jax(servers):
    _, jsrv, srv, model = servers
    imgs = photos(3, 0)  # 3 photos pad to two chunks of 2
    lat, rot = srv.encode(imgs)
    jlat, jrot = jsrv.encode(imgs)
    assert lat.shape == (3, model.config["latent_dim"]) and rot.shape == (3, 3)
    assert np.std(lat[:, 0]) > 0 and np.std(rot[:, 0]) > 0
    np.testing.assert_allclose(lat, np.asarray(jlat, np.float32), rtol=2e-2,
                               atol=2e-2 * np.abs(jlat).max())
    np.testing.assert_allclose(rot, np.asarray(jrot, np.float32), atol=1e-2)

    out = srv.generate(jlat, jrot)
    close_images(out, np.asarray(jsrv.generate(jlat, jrot)))
    assert out.std() > 0


def test_render_with_attribute_matches_jax(servers):
    _, jsrv, srv, model = servers
    imgs = photos(2, 1)
    n_blend = model.config["facemodel_inputs"]["blendshape_values"][0]
    value = np.random.default_rng(2).normal(size=(1, n_blend)).astype(np.float32)
    out = srv.render_with_attribute(imgs, "blendshape_values", value)
    close_images(out, np.asarray(jsrv.render_with_attribute(imgs, "blendshape_values", value)))


def test_sample_matches_jax(servers):
    """Photo-free sampling through each package's LatentGAN over the 512
    model's latent, with equal weights, after the same np.random.seed."""
    jmodel, _, _, model = servers
    latent_dim = model.config["latent_dim"]
    jgan = JaxLatentGAN({"latent_dim": latent_dim})
    gan = LatentGAN({"latent_dim": latent_dim}, device="cpu")
    gan.set_weights({name: flat(tree) for name, tree in jgan.get_weights().items()})
    jsampler = JaxServer(jmodel, latent_gan=jgan, chunk=CHUNK)
    sampler = ConfigNetServer(model, latent_gan=gan, chunk=CHUNK, device="cpu")
    rotations = (np.random.default_rng(5).uniform(-1, 1, (3, 3))
                 * [np.pi / 6, np.pi / 18, 0]).astype(np.float32)
    np.random.seed(6)
    out = sampler.sample(3, rotations=rotations, truncation=0.7)
    np.random.seed(6)
    close_images(out, np.asarray(jsampler.sample(3, rotations=rotations, truncation=0.7)))
    assert out.std() > 0


def test_release_loads_like_jax(servers, tmp_path):
    """A 512px reference release of a ConfigNet loads through both packages
    to the same weights bit for bit, the generator's 2c block included."""
    jmodel, *_ = servers
    path = write_reference_checkpoint(jmodel, str(tmp_path / "release"), shift=0.5)
    jloaded = jax_model_io.load_confignet(path)
    loaded = model_io.load_confignet(path, device="cpu")
    assert type(loaded) is ConfigNet and type(jloaded) is JaxConfigNet
    want = {name: flat(tree) for name, tree in jloaded.get_weights().items()}
    got = loaded.get_weights()
    assert set(got) == set(want)
    for tree, leaves in want.items():
        assert set(got[tree]) == set(leaves), tree
        for key, value in leaves.items():
            np.testing.assert_array_equal(got[tree][key], value, err_msg=f"{tree}/{key}")
    assert any(key.startswith("map_2d_2c/") for key in got["generator"])
    before = flat(jmodel.get_weights()["generator"])["map_2d_2c/conv_0/kernel"]
    np.testing.assert_array_equal(got["generator"]["map_2d_2c/conv_0/kernel"],
                                  (before + 0.5).astype(np.float32))

    rng = np.random.default_rng(3)
    latents = rng.normal(size=(2, loaded.config["latent_dim"])).astype(np.float32)
    rotations = (rng.uniform(-1, 1, (2, 3)) * [np.pi / 6, np.pi / 18, 0]).astype(np.float32)
    rendered = loaded.generate_images(latents, rotations)
    close_images(rendered, np.asarray(jloaded.generate_images(latents, rotations)))
    assert rendered.std() > 0


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adain_route_takes_the_resident_route_at_the_512_site(dtype, backward):
    """At every batch of the 512 path (the fine-tune's 1, the G step's 12,
    the D updates' 24, a serving chunk's 32) the 512 site's slab is too
    large for a 16-block cluster, forward and backward, so the call takes
    the co-resident route (one pass)."""
    positions, channels = SITE_512
    for batch in (1, 12, 24, 32):
        plan = adain_route(batch, positions, channels, dtype, *H100_LIMITS, backward)
        assert plan == adain_resident_plan(batch, positions, channels, dtype, *H100_LIMITS,
                                           backward)
        assert plan.route == "resident" and channels % plan.group == 0, plan
        assert plan.vec == 16 // torch.empty((), dtype=dtype).element_size()


def resident_coverage(plan, batch, positions, channels):
    """How often the co-resident grid of ``plan`` takes each (sample, group)
    work item and each (item, row), following csrc/adain.cu: block ->
    (slot, part); slot s takes the items s, s + wave, ...; part k the rows
    [k * per, min(P, (k + 1) * per))."""
    groups = -(-channels // plan.group)
    per = -(-positions // plan.parts)
    items = np.zeros((batch * groups, plan.parts), np.int64)
    rows = np.zeros((batch * groups, positions), np.int64)
    for block in range(plan.wave * plan.parts):
        slot, part = divmod(block, plan.parts)
        for item in range(slot, batch * groups, plan.wave):
            items[item, part] += 1
            rows[item, part * per:min(positions, (part + 1) * per)] += 1
    return items, rows


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adain_resident_plan_covers_the_512_site(dtype, backward):
    """The co-resident plan at every batch of the 512 path: each block's
    shared memory within the opt-in limit, so that an SM holds it; wave x
    parts blocks within the card's resident blocks at one block per SM (a
    cooperative launch is refused beyond the resident blocks, and the waits
    need every block of an item running) and leaving fewer SMs idle than a
    slab's parts; every (sample, group) taken by each of its parts once and
    every row of every item by exactly one block."""
    positions, channels = SITE_512
    smem, sms = H100_LIMITS
    elem = torch.empty((), dtype=dtype).element_size()
    for batch in (1, 12, 24, 32):
        plan = adain_route(batch, positions, channels, dtype, *H100_LIMITS, backward)
        assert plan.shared_bytes <= smem, plan
        assert sms - plan.parts < plan.wave * plan.parts <= sms, plan
        assert plan.wave <= batch, plan
        per = -(-positions // plan.parts)
        assert per * plan.group * elem * (2 if backward else 1) < plan.shared_bytes, plan
        items, rows = resident_coverage(plan, batch, positions, channels)
        assert (items == 1).all() and (rows == 1).all(), plan


@pytest.mark.parametrize("batch", [1, 2])
def test_adain_at_the_512_site_matches_jax(batch):
    """The port's AdaIN (the kernel's plain version on the CPU) at the 512
    site's full-width shape, forward and through its autograd backward,
    against the Pallas kernel in interpret mode and its custom VJP (atol
    2e-5 forward, 1e-4 gradients: tests/test_torch_ops.py)."""
    rng = np.random.default_rng(batch)
    shape = (batch, 256, 256, SITE_512[1])
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    w = rng.normal(size=shape).astype(np.float32)
    scale, bias = (rng.normal(size=(batch, shape[-1])).astype(np.float32) for _ in range(2))
    jargs = tuple(map(jnp.asarray, (x, scale, bias)))
    want = np.asarray(jax_fused_adain(*jargs, 1e-3, True))
    want_grads = jax.grad(lambda *a: jnp.sum(jax_fused_adain(*a, 1e-3, True) * w),
                          argnums=(0, 1, 2))(*jargs)
    targs = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    out = fused_adain(*targs)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=2e-5)
    (out * torch.from_numpy(w)).sum().backward()
    for got, grad in zip(targs, want_grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(grad), atol=1e-4, rtol=1e-4)
