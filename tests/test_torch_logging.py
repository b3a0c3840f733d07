"""The port's training observability against the JAX package's, on the CPU.

- ``update_loss_dict`` and ``LossFlusher``: the history's order, the flush
  cadence, and one device-to-host copy per flush (``Tensor.cpu`` counted,
  ``Tensor.item`` forbidden).
- ``log_loss_vals``: for the same history, the same ``*_losses.txt`` bytes
  and the same file names as JAX's, with plots and with an extra sink, and
  the same sink calls.
- ``TensorBoardWriter``: the (tag, step, value) triples the port writes
  through ``log_loss_vals`` equal JAX's, read back with tensorboard's event
  reader (JAX's TensorFlow writer stores scalars as tensors, torch's as
  ``simple_value``, so values are compared, not records); creating it
  leaves the global numpy stream where it was.
- ``build_image_matrix`` equals JAX's; ``write_jpeg`` decodes with cv2 to
  within a mean absolute error of 1.0 (max 16) of a smooth source at the
  default quality 95; ``_imwrite`` writes PNG and JPEG without cv2.
"""
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from confignet_tpu.core import images as jax_images
from confignet_tpu.core import logging_utils as jax_logging
from confignet_tpu_torch.core import images, logging_utils
from confignet_tpu_torch.training.first_stage import ConfigNetFirstStage

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
HISTORY = {"loss_sum": [3.5, 2.25, 1.0625], "GAN_loss_real_0": [0.5, 0.4, 1e-7],
           "eye_loss": [1e3, 2e-3, 7.0]}


def test_update_loss_dict_keeps_order():
    hist = {}
    logging_utils.update_loss_dict(hist, {"g": 1.0, "d": torch.tensor(2.0)})
    logging_utils.update_loss_dict(hist, {"g": np.float32(3.0)})
    assert hist == {"g": [1.0, 3.0], "d": [2.0]}
    assert all(type(v) is float for values in hist.values() for v in values)


def test_loss_flusher_cadence_order_and_one_transfer(monkeypatch):
    flusher = logging_utils.LossFlusher(period=3)
    steps = [{"g": {"loss_sum": torch.tensor(float(i)), "x": torch.tensor(i / 8.0, dtype=torch.bfloat16)},
              "d": {"loss_sum": torch.tensor(10.0 + i)}} for i in range(4)]
    assert [flusher.append(s) for s in steps[:3]] == [False, False, True]

    copies = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: copies.append(self.shape) or cpu(self, *a, **k))

    def no_item(self):
        raise AssertionError("LossFlusher fetched a value with .item()")

    monkeypatch.setattr(torch.Tensor, "item", no_item)
    fetched = flusher.flush()
    assert copies == [torch.Size([9])]
    assert fetched == [{"g": {"loss_sum": float(i), "x": i / 8.0}, "d": {"loss_sum": 10.0 + i}}
                       for i in range(3)]
    assert flusher.flush() == [] and copies == [torch.Size([9])]
    flusher.append(steps[3])
    assert flusher.flush()[0]["d"]["loss_sum"] == 13.0


def _run_log(module, directory, sink=None, tb_writer=None, draw_plots=True):
    calls = []
    extra_sink = (lambda name, value: calls.append((name, value))) if sink else None
    module.log_loss_vals({k: list(v) for k, v in HISTORY.items()}, str(directory), 4, "generator_",
                         tb_writer, extra_sink, draw_plots)
    files = {name: (directory / name).read_bytes() for name in sorted(os.listdir(directory))}
    return files, calls


@pytest.mark.parametrize("sink", [False, True], ids=["plots", "extra_sink"])
def test_log_loss_vals_matches_jax(tmp_path, sink):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got, got_calls = _run_log(logging_utils, tmp_path / "port", sink)
    want, want_calls = _run_log(jax_logging, tmp_path / "jax", sink)
    assert sorted(got) == sorted(want)
    assert got["generator_losses.txt"] == want["generator_losses.txt"]
    assert got_calls == want_calls
    if sink:
        assert got_calls == [("generator_" + k, v[-1]) for k, v in HISTORY.items()]
        assert sorted(got) == ["generator_losses.txt"]
    else:
        assert {"generator_losses.png", "generator_loss_sum.png"} <= set(got)


def _scalars(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    from tensorboard.util import tensor_util

    acc = EventAccumulator(str(log_dir), size_guidance={"scalars": 0, "tensors": 0})
    acc.Reload()
    triples = set()
    for tag in acc.Tags()["scalars"]:
        triples |= {(tag, e.step, float(np.float32(e.value))) for e in acc.Scalars(tag)}
    for tag in acc.Tags()["tensors"]:
        triples |= {(tag, e.step, float(tensor_util.make_ndarray(e.tensor_proto)))
                    for e in acc.Tensors(tag)}
    return triples


def test_tensorboard_scalars_match_jax(tmp_path):
    port_writer = logging_utils.TensorBoardWriter(str(tmp_path / "port_tb"))
    jax_writer = jax_logging.TensorBoardWriter(str(tmp_path / "jax_tb"))
    assert jax_writer._writer is not None, "the JAX writer needs TensorFlow"
    for name, module, writer in (("port", logging_utils, port_writer), ("jax", jax_logging, jax_writer)):
        (tmp_path / name).mkdir()
        _run_log(module, tmp_path / name, sink=True, tb_writer=writer)
        writer.scalar("perf/checkpoint_time", 0.25, 9)
    port_writer.flush()
    jax_writer._writer.flush()
    got, want = _scalars(tmp_path / "port_tb"), _scalars(tmp_path / "jax_tb")
    assert got == want
    assert ("generator/loss_sum", 4, 1.0625) in got and len(got) == len(HISTORY) + 1


def test_tensorboard_writer_keeps_the_numpy_stream(tmp_path):
    """The first import of tensorboard draws from the global numpy RNG; the
    writer leaves the caller's stream where it was (a fresh interpreter, as
    this one has imported tensorboard already)."""
    code = ("import sys, numpy as np; np.random.seed(0); want = np.random.rand(8); np.random.seed(0); "
            "from confignet_tpu_torch.core.logging_utils import TensorBoardWriter; "
            "TensorBoardWriter(sys.argv[1]); sys.exit(0 if (np.random.rand(8) == want).all() else 1)")
    result = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stdout + result.stderr


def test_tensorboard_writer_without_tensorboard(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    writer = logging_utils.TensorBoardWriter(str(tmp_path))
    writer.scalar("a", 1.0, 0)
    writer.image("b", np.zeros((2, 2, 3), np.uint8), 0)
    assert "WARNING" in capsys.readouterr().out
    assert os.listdir(tmp_path) == []


def test_build_image_matrix_matches_jax():
    imgs = np.random.default_rng(0).integers(0, 256, (12, 5, 7, 3), dtype=np.uint8)
    got = images.build_image_matrix(imgs, 3, 4)
    np.testing.assert_array_equal(got, jax_images.build_image_matrix(imgs, 3, 4))
    np.testing.assert_array_equal(got[5:10, 14:21], imgs[6])
    np.testing.assert_array_equal(images.uint8_to_unit_range(imgs), jax_images.uint8_to_unit_range(imgs))
    a, b = imgs.copy(), imgs.copy()
    np.testing.assert_array_equal(images.flip_random_subset_of_images(a, np.random.default_rng(1)),
                                  jax_images.flip_random_subset_of_images(b, np.random.default_rng(1)))


def _smooth_image(height, width):
    y, x = np.mgrid[0:height, 0:width]
    return np.stack([(x * 2) % 256, (y * 3) % 256, (x + y) % 256], -1).astype(np.uint8)


@pytest.mark.parametrize("shape", [(64, 96), (37, 21)], ids=["blocks", "padded"])
def test_write_jpeg_decodes_close_to_source(tmp_path, shape):
    import cv2

    img = _smooth_image(*shape)
    path = str(tmp_path / "a.jpg")
    images.write_jpeg(path, img)
    decoded = cv2.imread(path)
    assert decoded.shape == img.shape
    err = np.abs(decoded.astype(int) - img.astype(int))
    assert err.mean() < 1.0 and err.max() <= 16, (err.mean(), err.max())
    # the frame header holds the size
    data = open(path, "rb").read()
    sof = data.index(b"\xff\xc0")
    assert struct.unpack(">HH", data[sof + 5:sof + 9]) == shape


def test_imwrite_without_cv2(tmp_path, monkeypatch):
    import cv2

    img = _smooth_image(40, 24)
    monkeypatch.setitem(sys.modules, "cv2", None)
    ConfigNetFirstStage._imwrite(str(tmp_path / "a.png"), img)
    ConfigNetFirstStage._imwrite(str(tmp_path / "a_synth.jpg"), img)
    monkeypatch.undo()
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")), img)
    assert np.abs(cv2.imread(str(tmp_path / "a_synth.jpg")).astype(int) - img).mean() < 1.0
    # with cv2, the JAX package's parameters and so its bytes
    ConfigNetFirstStage._imwrite(str(tmp_path / "b.png"), img)
    cv2.imwrite(str(tmp_path / "c.png"), img, [cv2.IMWRITE_PNG_COMPRESSION, 1])
    assert (tmp_path / "b.png").read_bytes() == (tmp_path / "c.png").read_bytes()
