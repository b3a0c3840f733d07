"""One fused stage-2 training step of the port at 512px against the JAX
package's, on TINY_FIRST_STAGE_CONFIG's widths with ``output_shape``
(512, 512, 3): the generator's seventh AdaIN site (``map_2d_2c``), the
discriminators, the latent regressor, VGG19 and the ResNet50 trunk at
512x512, through every loss of the step.

The port runs its kernel path, as on the card (``rotation_resample_train=
"kernel_train"``, ``adain_impl="kernel"``: the kernels' autograd Functions
with their plain bodies), against the JAX step with the semantics of its
TPU kernel (the rotation's transform gradient stopped), as
tests/test_torch_second_stage_kernel_path.py does at 128px.  Weights, host
batch (``_batch_rng`` seeded 0) and flips are those of
tests/test_torch_second_stage.py; so is the EMA's bound (atol 1e-6).

The losses and gradients are held by the rule ``chip_smoke.py`` holds the
card's kernel and plain paths to (``compare_train_paths``): every loss
within 1e-3 relative error and each player's gradient within 1e-3 relative
L2, each widened to 4x the distance of a one-site rounding probe (the same
port step with only the resample computed in float64) where the step is
that sensitive.  At 512px the step is more sensitive to float32 rounding
than 128px's bounds (rtol 1e-4 on losses, 1e-4 of a leaf's scale) allow,
through the random ResNet50 trunk, whose ReLU and max-pool decisions near a
tie flip with the rounding (its encodings differ by up to 2e-2 between the
packages: tests/test_torch_serving.py), and VGG19's ReLU ties at 512x512
(tests/test_torch_512_fine_tune.py): G(E(x))'s final-head loss differs from
JAX's by 2.8e-4 relative and the generator player's gradient by 1.8e-3
relative L2, while the discriminator itself agrees with JAX's at 512px to
2.5e-6 in float32 and 6e-15 in float64.
"""
import numpy as np
import pytest
import torch

from confignet_tpu_torch.core.transforms import rotate_3d_grid
from confignet_tpu_torch.models import generator as generator_module
from test_torch_second_stage import check_ema, stage2_step_results
from test_torch_second_stage_kernel_path import _rotate_transform_gradient_stopped

torch.set_num_threads(1)

KERNEL_PATH = dict(rotation_resample_train="kernel_train", adain_impl="kernel")


def _rotate_via_float64(grid, transform):
    """The kernel path's training resample (transform gradient stopped)
    computed in float64 and rounded once: one site rounded differently."""
    return rotate_3d_grid(grid.double(), transform.detach().double()).to(grid.dtype)


def distances(result, reference):
    """The largest relative error over the losses, and each player's
    relative L2 gradient distance, of ``result`` from ``reference``."""
    out = {"losses": max(abs(result["losses"][g][k] - v) / max(abs(v), 1e-30)
                         for g, d in reference["losses"].items() for k, v in d.items())}
    for player, trees in reference["moments"].items():
        keys = [(t, k) for t in sorted(trees) for k in sorted(trees[t])]
        a = np.concatenate([result["moments"][player][t][k].ravel() for t, k in keys])
        b = np.concatenate([trees[t][k].ravel() for t, k in keys])
        out[player] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    return out


@pytest.fixture(scope="module")
def stepped():
    with pytest.MonkeyPatch.context() as patch:
        patch.setitem(generator_module._ROTATION_IMPLS, "probe_float64", _rotate_via_float64)
        return stage2_step_results(KERNEL_PATH, _rotate_transform_gradient_stopped, 512,
                                   dict(KERNEL_PATH, rotation_resample_train="probe_float64"))


def test_step_matches_jax_within_the_rounding_rule(stepped):
    jax_result, port_result, probe_result = stepped
    assert set(port_result["losses"]) == set(jax_result["losses"]) == {"g", "d", "synth_d", "latent_d"}
    for group, want in jax_result["losses"].items():
        assert set(port_result["losses"][group]) == set(want), group
    for player, trees in jax_result["moments"].items():
        for tree, leaves in trees.items():
            assert set(port_result["moments"][player][tree]) == set(leaves), tree
            assert all(np.abs(v).max() > 0 for v in leaves.values()), tree
    distance, probe = distances(port_result, jax_result), distances(probe_result, port_result)
    bounds = {k: max(1e-3, 4 * v) for k, v in probe.items()}
    failed = {k: (distance[k], bounds[k]) for k in distance if not distance[k] <= bounds[k]}
    assert not failed, (failed, distance, probe)


def test_step_ema_matches_jax(stepped):
    check_ema(*stepped[:2])
