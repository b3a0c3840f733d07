"""Training observability (counterpart of ``confignet_tpu/core/logging_utils.py``;
reference: confignet/confignet_utils.py:206-241): the loss history, the
flusher that fetches a window of steps' device losses in one transfer, the
TensorBoard writer, the matplotlib loss grids and the plaintext tables.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from confignet_tpu_torch.parallel.mesh import all_reduce_mean


def update_loss_dict(main_loss_dict: Dict[str, List[float]], new_losses: Dict[str, object]) -> None:
    """Append the scalar values of ``new_losses`` to the running history."""
    for key, val in new_losses.items():
        main_loss_dict.setdefault(key, []).append(float(val))


class LossFlusher:
    """Buffers each step's device losses and fetches them a window at a time.

    A per-step ``.item()`` would make the host wait for the device on every
    step.  The train loops append each step's nested dict of 0-d device
    tensors here and flush on a cadence: the flush stacks every pending
    value on the device and copies the stack to the host in one transfer.
    Over a data-parallel ``mesh`` (``parallel/mesh.py``) each rank's losses
    are means over its rows, and the flush replaces the stack by its mean
    over the ranks (one all-reduce), so every rank logs the global batch's.
    """

    def __init__(self, period: int = 50, mesh=None):
        self.period = max(1, int(period))
        self.mesh = mesh
        self._pending: list = []

    def append(self, losses) -> bool:
        """Queue one step's losses; True when a flush is due."""
        self._pending.append(losses)
        return len(self._pending) >= self.period

    def flush(self) -> list:
        """The pending steps' losses as nested dicts of Python floats, oldest
        first, fetched in one device-to-host copy."""
        if not self._pending:
            return []
        leaves: list = []

        def collect(tree):
            if isinstance(tree, dict):
                return {key: collect(value) for key, value in tree.items()}
            leaves.append(tree)
            return len(leaves) - 1

        layout = [collect(losses) for losses in self._pending]
        self._pending = []
        tensors = [i for i, leaf in enumerate(leaves) if isinstance(leaf, torch.Tensor)]
        if tensors:
            stacked = torch.stack([leaves[i].detach().reshape(()).float() for i in tensors])
            all_reduce_mean(self.mesh, [stacked])
            for i, value in zip(tensors, stacked.cpu().tolist()):
                leaves[i] = value

        def fill(tree):
            if isinstance(tree, dict):
                return {key: fill(value) for key, value in tree.items()}
            return float(leaves[tree])

        return [fill(losses) for losses in layout]


class TensorBoardWriter:
    """Scalars and images for TensorBoard through
    ``torch.utils.tensorboard.SummaryWriter``; does nothing, after one
    warning, where the ``tensorboard`` package cannot be imported (as the
    JAX writer does without TensorFlow)."""

    def __init__(self, log_dir: str):
        self._writer = None
        # the first import of tensorboard (and TensorFlow, where installed)
        # draws from the global numpy RNG, which the trainers' seeded draws use
        state = np.random.get_state()
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir)
        except ImportError as exc:
            print(f"WARNING: TensorBoard logging disabled ({exc})")
        finally:
            np.random.set_state(state)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is None:
            return
        self._writer.add_scalar(tag, float(value), step)

    def image(self, tag: str, image_bgr_uint8: np.ndarray, step: int) -> None:
        if self._writer is None:
            return
        self._writer.add_image(tag, np.ascontiguousarray(image_bgr_uint8[..., ::-1]), step,
                               dataformats="HWC")

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()


# Curves longer than this are strided down before plotting, so the cost of a
# checkpoint's plots does not grow with the run's length.
MAX_PLOT_POINTS = 1024


def agg_pyplot():
    """pyplot with the Agg backend pinned, imported on first use: plots are
    written from worker threads, where an interactive backend would fail,
    and a process that never plots never loads matplotlib."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    from matplotlib import pyplot as plt

    return plt


def _semilogy_downsampled(ax, y) -> None:
    """Semilog curve of at most MAX_PLOT_POINTS points (strided, always
    keeping the last value), minor log ticks off."""
    y = np.asarray(y, dtype=np.float64)
    if y.size > MAX_PLOT_POINTS:
        stride = int(np.ceil(y.size / MAX_PLOT_POINTS))
        xs = np.arange(0, y.size, stride)
        ys = y[::stride]
        if xs[-1] != y.size - 1:
            xs = np.append(xs, y.size - 1)
            ys = np.append(ys, y[-1])
        ax.semilogy(xs, ys)
    else:
        ax.semilogy(y)
    ax.minorticks_off()


def draw_loss_grid(losses: List[List[float]], loss_names: List[str], pix_per_plot: int = 300):
    """Square grid of semilog loss curves (reference: confignet_utils.py:23-37)."""
    plt = agg_pyplot()
    n_losses = len(loss_names)
    square = int(np.ceil(np.sqrt(max(n_losses, 1))))
    dpi = 100
    pix = square * pix_per_plot
    fig, axes = plt.subplots(square, square, figsize=(pix // dpi, pix // dpi), dpi=dpi)
    axes = np.atleast_1d(axes).ravel()
    for i in range(n_losses):
        _semilogy_downsampled(axes[i], losses[i])
        axes[i].set_title(loss_names[i])
    for ax in axes[n_losses:]:
        ax.set_axis_off()
    fig.subplots_adjust(hspace=0.55, wspace=0.35, left=0.06, right=0.98, top=0.94, bottom=0.05)


def log_loss_vals(
    loss_dict: Dict[str, List[float]],
    output_dir: str,
    step_number: int,
    prefix: str,
    tb_writer: Optional[TensorBoardWriter] = None,
    extra_sink: Optional[Callable[[str, float], None]] = None,
    draw_plots: bool = True,
) -> None:
    """Write the loss history: the latest values to ``extra_sink`` (else the
    PNG loss grids), TensorBoard scalars under ``prefix`` with its last
    ``_`` made a ``/``, and ``<prefix>losses.txt``, one row per step."""
    os.makedirs(output_dir, exist_ok=True)
    loss_names = list(loss_dict.keys())
    loss_vals = list(loss_dict.values())
    if not loss_names:
        return
    most_recent = [v[-1] for v in loss_vals]

    if extra_sink is not None:
        for name, value in zip(loss_names, most_recent):
            extra_sink(prefix + name, value)
    elif draw_plots:
        plt = agg_pyplot()
        draw_loss_grid(loss_vals, loss_names)
        plt.savefig(os.path.join(output_dir, prefix + "losses.png"))
        plt.close()
        if "loss_sum" in loss_dict:
            _semilogy_downsampled(plt.gca(), loss_dict["loss_sum"])
            plt.savefig(os.path.join(output_dir, prefix + "loss_sum.png"))
            plt.close()

    if tb_writer is not None:
        tb_prefix = prefix[::-1].replace("_", "/", 1)[::-1]
        for name, value in zip(loss_names, most_recent):
            tb_writer.scalar(tb_prefix + name, value, step_number)

    table = np.stack([np.asarray(v, dtype=np.float64) for v in loss_vals], axis=1)
    np.savetxt(os.path.join(output_dir, prefix + "losses.txt"), table, header="\t".join(loss_names))
