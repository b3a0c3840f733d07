"""One fused stage-2 training step of the port on its kernel path against the
JAX step with the semantics of its TPU kernel, on TINY_FIRST_STAGE_CONFIG
on the CPU.

On the card the port trains through the rotation kernels, whose transform
gradient is defined zero as the JAX package's TPU kernel's is
(``rotate_pallas.py:204``): the encoder's rotation head then learns only
through the latent-regression labels, not through the rendered image.  Here
the port runs ``rotation_resample_train="kernel_train"`` and
``adain_impl="kernel"`` (the kernels' autograd Functions with their plain
bodies), and the JAX step's rotation resample is the gather form with its
transform gradient stopped, patched into
``confignet_tpu.models.generator._resolve_rotation_impl`` for the trace.
Weights, batch, flips and tolerances are those of
``tests/test_torch_second_stage.py``.
"""
import jax
import pytest
import torch

from confignet_tpu.core.transforms import rotate_3d_grid
from confignet_tpu_torch.training.second_stage import ConfigNet
from test_torch_second_stage import check_ema, check_gradients, check_losses, stage2_step_results

torch.set_num_threads(1)


def _rotate_transform_gradient_stopped(grid, transform):
    return rotate_3d_grid(grid, jax.lax.stop_gradient(transform))


@pytest.fixture(scope="module")
def stepped():
    return stage2_step_results(dict(rotation_resample_train="kernel_train", adain_impl="kernel"),
                               jax_rotation=_rotate_transform_gradient_stopped)


def test_kernel_path_losses_match_jax(stepped):
    check_losses(*stepped)


@pytest.mark.parametrize("player", list(ConfigNet.PLAYER_TREES))
def test_kernel_path_gradients_match_jax(stepped, player):
    check_gradients(*stepped, player)


def test_kernel_path_ema_matches_jax(stepped):
    check_ema(*stepped)

