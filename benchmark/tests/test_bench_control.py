"""The controls on the card at the cells' own configurations, on a few
requests: the reference in TF32 in the program's place, and for training
the reference on half of every batch, read further from the float32
reference than one of the checks' limits allows.  The controls of the
limits' readings, three seeds a cell, are ``python3 -m benchmark.control``."""
from __future__ import annotations

import pytest

from benchmark.harness import demo, serve, train
from benchmark.harness.core import load_cell

pytestmark = pytest.mark.gpu


def test_demo_control_fails_a_check(gpu):
    cell = load_cell("serve_256_interactive")
    cell.traffic = dict(cell.traffic, check_sessions=1)
    readings = demo.control_readings(cell, 2 ** 31 + 1, gpu)["tf32"]
    assert any(readings[k] > limit for k, limit in cell.traffic["checks"].items()), readings


def test_serving_control_fails_a_check(gpu):
    cell = load_cell("serve_512_bulk")
    cell.traffic = dict(cell.traffic, check_sample=2)
    readings = serve.control_readings(cell, 2 ** 31 + 1, gpu)["tf32"]
    assert any(readings[k] > limit for k, limit in cell.traffic["checks"].items()), readings


def test_training_control_fails_a_check(gpu):
    cell = load_cell("train_256_stage2")
    readings = train.control_readings(cell, 2 ** 31 + 2, gpu)
    for fault in ("tf32", "half_batch"):
        assert any(readings[fault][k] > limit
                   for k, limit in cell.traffic["checks"].items()), (fault, readings[fault])
