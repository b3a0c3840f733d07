"""The benchmark's counts against hand-worked values."""
from __future__ import annotations

import pytest
import torch

from benchmark.counts import kernels
from benchmark.counts.flops import _count
from benchmark.reference.conv3d import Conv3d


def test_conv3d_operations_by_hand():
    # a 3x3x3 conv from 4 to 16 channels over an 8^3 volume, padded to keep
    # its size: 2 operations per multiply-add, 4*27 of them per output
    with torch.device("meta"):
        conv = Conv3d(4, 16, (3, 3, 3))
        x = torch.zeros((2, 8, 8, 8, 4))
        flops = _count(lambda: conv(x))
    assert flops == 2 * (2 * 8 ** 3 * 16) * (4 * 27)


def test_adain_site_bound_by_hand():
    # the 8^3 x 256 site at a chunk of 32 in float32: x read and written,
    # scale and bias read, 7 operations an element; bytes bound it
    model = {"const_input_shape": [4, 4, 4, 512], "n_generator_features": 256,
             "output_shape": [128, 128, 3]}
    elements = 32 * 512 * 256
    by_bytes = (2 * elements + 2 * 32 * 256) * 4 / 3.35e12
    by_ops = 7 * elements / 67e12
    assert by_bytes > by_ops
    site_bounds = [kernels.bound_s((2 * 32 * p * c + 2 * 32 * c) * 4, 7 * 32 * p * c)
                   for p, c in kernels.adain_sites(model)]
    assert site_bounds[0] == pytest.approx(by_bytes, rel=1e-12)
    assert kernels.launch_bound_s("adain_fwd", 32, model) == pytest.approx(sum(site_bounds))


def test_sites_follow_the_output_size():
    base = {"const_input_shape": [4, 4, 4, 512], "n_generator_features": 256}
    sites_256 = kernels.adain_sites(dict(base, output_shape=[256, 256, 3]))
    sites_512 = kernels.adain_sites(dict(base, output_shape=[512, 512, 3]))
    assert sites_256 == [(512, 256), (4096, 128), (256, 256), (1024, 64), (4096, 32), (16384, 32)]
    assert sites_512 == sites_256 + [(65536, 16)]


def test_a_stage2_step_launches_as_the_port_counts():
    # (rotation, transpose, AdaIN, AdaIN backward) of a 256px step: (4, 2, 24, 12)
    plan = kernels.stage2_step(24)
    count = {k: sum(1 for kind, _ in plan if kind == k)
             for k in ("rotate_fwd", "rotate_transpose", "adain_fwd", "adain_bwd")}
    assert (count["rotate_fwd"], count["rotate_transpose"], 6 * count["adain_fwd"],
            6 * count["adain_bwd"]) == (4, 2, 24, 12)
