"""CelebA attribute classifier, the controllability judge (counterpart of
``confignet_tpu/metrics/celeba_attribute_prediction.py``; reference:
confignet/metrics/celeba_attribute_prediction.py).

MobileNetV2 trunk -> global average pool -> BatchNorm -> Dropout(0.5) ->
Dense -> sigmoid over the predicted attributes; binary cross-entropy
training with per-epoch checkpoints and best-model tracking on validation
binary accuracy.  As in the JAX package:

- the batch norms are flax's (``models/backbones/mobilenet.BatchNorm``):
  running statistics ``ra = m * ra + (1 - m) * batch`` with the biased
  variance, eps 1e-3; m is 0.9 in a trainable trunk and
  ``head_bn_momentum`` in the head, whose norm runs over the batch of
  pooled vectors;
- Adam is optax's ``adam(lr, eps=1e-7)`` with the default betas (0.9,
  0.999), not the GAN players' (0, 0.9);
- the loss and the eval loss clamp the sigmoid to [1e-7, 1 - 1e-7];
  accuracy thresholds the unclamped outputs and the labels at 0.5;
- host draws (batch indices, the noise of ``add_noise``) come from the
  global ``np.random`` in the same order; the dropout masks come from a
  ``torch.Generator`` on the device seeded from ``config["seed"]``, through
  :meth:`CelebaAttributeClassifier._dropout_mask`, which a caller may
  override to pin them;
- ``save`` writes the JAX files (``<name>.npz`` with the ``params`` and
  ``batch_stats`` trees under flax's paths, ``<name>.json`` with the logs
  and config), so a classifier moves between the packages both ways.

The Keras MobileNetV2 ``.h5`` import (``backbones_dir``,
``load_backbone_keras_weights``) is not ported yet and raises.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from confignet_tpu_torch.core import initializers
from confignet_tpu_torch.core.config import merge_configs
from confignet_tpu_torch.core.device import resolve_device
from confignet_tpu_torch.core.model_io import (
    export_jax_params, load_jax_params, load_model_weights, save_model_weights)
from confignet_tpu_torch.models.backbones.mobilenet import BatchNorm, MobileNetV2, mobilenet_preprocess
from confignet_tpu_torch.models.blocks import Dense

DEFAULT_CONFIG: Dict[str, Any] = {
    "model_type": "CelebaAttributeClassifier",
    "input_shape": None,
    "predicted_attributes": None,
    "optimizer": {"lr": 0.001},
    "batch_size": 32,
    # the head BN's momentum: 0.99 is Keras's, for a pretrained trunk;
    # about 0.9 suits from-scratch training
    "head_bn_momentum": 0.99,
    # a live trunk BatchNorm, for from-scratch training (no pretrained .h5)
    "trainable_bn": False,
    "seed": 0,
}

TREES = ("params", "batch_stats")
_EPS = 1e-7
DROPOUT_RATE = 0.5


class _ClassifierHead(nn.Module):
    def __init__(self, n_attributes: int, bn_momentum: float = 0.99):
        super().__init__()
        self.bn = BatchNorm(1280, momentum=bn_momentum)
        self.head = Dense(1280, n_attributes)

    def forward(self, features: torch.Tensor, train: bool = False,
                dropout_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``dropout_mask``: the kept units (bool, (B, 1280)) in train mode;
        None skips the dropout (its output is not used then)."""
        x = self.bn(features.mean(dim=(1, 2)), train)
        if train and dropout_mask is not None:
            keep = 1.0 - DROPOUT_RATE
            x = torch.where(dropout_mask, x / keep, torch.zeros_like(x))
        return torch.sigmoid(self.head(x))


class _ClassifierNet(nn.Module):
    def __init__(self, n_attributes: int, head_bn_momentum: float = 0.99,
                 trainable_bn: bool = False):
        super().__init__()
        self.mobilenet = MobileNetV2(trainable_bn=trainable_bn)
        self.head = _ClassifierHead(n_attributes, bn_momentum=head_bn_momentum)

    def forward(self, images_0_255: torch.Tensor, train: bool = False,
                dropout_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        feats = self.mobilenet(mobilenet_preprocess(images_0_255), train)
        return self.head(feats, train, dropout_mask)


def _bce(outputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    clipped = torch.clamp(outputs, _EPS, 1 - _EPS)
    return -torch.mean(labels * torch.log(clipped) + (1 - labels) * torch.log(1 - clipped))


def _accuracy(outputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return ((outputs > 0.5) == (labels > 0.5)).float().mean()


class CelebaAttributeClassifier:
    MODEL_TYPE = "CelebaAttributeClassifier"

    def __init__(self, config: Dict[str, Any], device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.config = merge_configs(DEFAULT_CONFIG, config)
        if self.config["input_shape"] is None or self.config["predicted_attributes"] is None:
            raise ValueError("config requires input_shape and predicted_attributes")
        self.logs: Dict[str, List[float]] = {}
        self._draws = torch.Generator(device=self.device).manual_seed(int(self.config.get("seed", 0)))
        self.initialize_dnn()

    def initialize_dnn(self) -> None:
        self.module = _ClassifierNet(
            n_attributes=len(self.config["predicted_attributes"]),
            head_bn_momentum=float(self.config.get("head_bn_momentum", 0.99)),
            trainable_bn=bool(self.config.get("trainable_bn", False)))
        initializers.initialize(self.module, torch.Generator().manual_seed(int(self.config.get("seed", 0))))
        self.module.to(self.device).eval()
        self._make_optimizer()
        if self.config.get("backbones_dir") is not None:
            raise NotImplementedError("loading Keras .h5 backbones (backbones_dir) is not ported "
                                      "yet")

    def _make_optimizer(self) -> None:
        self.optimizer = torch.optim.Adam(self.module.parameters(),
                                          lr=self.config["optimizer"].get("lr", 1e-3),
                                          betas=(0.9, 0.999), eps=_EPS)

    def load_backbone_keras_weights(self, h5_path: str) -> None:
        raise NotImplementedError("importing the Keras MobileNetV2 .h5 is not ported yet")

    # ------------------------------------------------------------------
    # Weights in the JAX package's layout
    # ------------------------------------------------------------------

    def get_weights(self) -> Dict[str, Dict[str, np.ndarray]]:
        """{"params": {flax path: ndarray}, "batch_stats": {...}}."""
        return {tree: export_jax_params(self.module, tree) for tree in TREES}

    def set_weights(self, weights: Dict[str, Dict[str, np.ndarray]]) -> None:
        """Load both trees; the optimizer state is reset."""
        for tree in TREES:
            load_jax_params(self.module, weights[tree], tree)
        self._make_optimizer()

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def _dropout_mask(self, batch_size: int) -> torch.Tensor:
        """The units the head's dropout keeps, (B, 1280) bool on the device."""
        return torch.rand((batch_size, 1280), generator=self._draws,
                          device=self.device) < 1.0 - DROPOUT_RATE

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(array)).to(self.device)  # a copy: memmaps are read-only

    def _build_train_step(self):
        """``step(imgs, labels) -> (loss, accuracy)``, 0-d tensors on the
        device: one Adam step on the BCE of a train-mode forward (batch
        statistics, dropout), whose running statistics it also updates."""

        def step(imgs: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
            outputs = self.module(imgs, train=True, dropout_mask=self._dropout_mask(imgs.shape[0]))
            loss = _bce(outputs, labels)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
            return loss.detach(), _accuracy(outputs.detach(), labels)

        return step

    @torch.no_grad()
    def _evaluate(self, imgs: torch.Tensor, labels: torch.Tensor) -> Tuple[float, float]:
        outputs = self.module(imgs, train=False)
        return float(_bce(outputs, labels)), float(_accuracy(outputs, labels))

    def sample_batch_from_dataset(self, dataset, batch_size: Optional[int] = None,
                                  add_noise: bool = False):
        """Images in [0, 255] (uint8, or float32 with ``add_noise``) and float32
        attribute labels of ``batch_size`` random dataset entries."""
        if batch_size is None:
            batch_size = self.config["batch_size"]
        idx = np.random.randint(0, dataset.imgs.shape[0], batch_size)
        if add_noise:
            imgs = np.copy(dataset.imgs[idx]).astype(np.float32)
            half = batch_size // 2
            imgs[:half] += np.random.normal(0, 0.05 * 127.5, imgs[:half].shape)
        else:
            imgs = np.copy(dataset.imgs[idx])
        attributes = dataset.get_attribute_values(idx, self.config["predicted_attributes"])
        return imgs, attributes.astype(np.float32)

    @torch.no_grad()
    def recalibrate_batch_stats(self, dataset, n_batches: int = 30) -> None:
        """Re-estimate the running statistics against the current parameters
        on ``n_batches`` dataset batches: train-mode forwards whose outputs
        are dropped (the dropout follows the head BN, so it is skipped)."""
        for _ in range(n_batches):
            imgs, _ = self.sample_batch_from_dataset(dataset)
            self.module(self._to_device(imgs), train=True)

    def train(self, training_set, validation_set, output_dir, n_epochs: int,
              steps_per_epoch: int) -> None:
        step = self._build_train_step()
        val_imgs, val_labels = self.sample_batch_from_dataset(validation_set, 200)
        val_imgs, val_labels = self._to_device(val_imgs), self._to_device(val_labels)

        for epoch in range(n_epochs):
            epoch_losses, epoch_accs = [], []
            for _ in range(steps_per_epoch):
                imgs, labels = self.sample_batch_from_dataset(training_set)
                loss, acc = step(self._to_device(imgs), self._to_device(labels))
                epoch_losses.append(float(loss))
                epoch_accs.append(float(acc))

            # BN re-estimation against the current parameters before eval
            self.recalibrate_batch_stats(training_set, 10)

            val_loss, val_acc = self._evaluate(val_imgs, val_labels)
            logs = {"loss": float(np.mean(epoch_losses)),
                    "binary_accuracy": float(np.mean(epoch_accs)),
                    "val_loss": val_loss, "val_binary_accuracy": val_acc}
            print(f"epoch {epoch}: {logs}")
            self._epoch_callback(epoch, logs, output_dir)

    def _epoch_callback(self, epoch: int, logs: Dict[str, float], output_dir: str) -> None:
        checkpoint_dir = os.path.join(output_dir, "checkpoints")
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.save(checkpoint_dir, str(epoch).zfill(4))

        for key, value in logs.items():
            self.logs.setdefault(key, []).append(float(value))

        val_history = self.logs["val_binary_accuracy"]
        if len(val_history) == 1 or val_history[-1] > np.max(val_history[:-1]):
            best_dir = os.path.join(output_dir, "best_model")
            os.makedirs(best_dir, exist_ok=True)
            self.save(best_dir, str(epoch).zfill(4))

        from confignet_tpu_torch.core.logging_utils import agg_pyplot

        plt = agg_pyplot()
        plt.plot(self.logs["loss"])
        plt.plot(self.logs["val_loss"])
        plt.savefig(os.path.join(output_dir, "losses.png"))
        plt.clf()
        plt.plot(self.logs["binary_accuracy"])
        plt.plot(self.logs["val_binary_accuracy"])
        plt.savefig(os.path.join(output_dir, "metrics.png"))
        plt.clf()

        table = np.stack(list(self.logs.values()), axis=1)
        np.savetxt(os.path.join(output_dir, "logs.txt"), table, header="\t".join(self.logs.keys()))

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def predict_attributes(self, input_images: np.ndarray, batch_chunk: int = 64) -> np.ndarray:
        """Images (uint8 [0, 255] or float [-1, 1]) -> float32 per-attribute
        probabilities, in chunks of ``batch_chunk`` (the tail padded by
        repeating its last image).  Images of another size than
        ``input_shape`` are resized with cv2."""
        input_images = np.asarray(input_images)
        if input_images.dtype in (np.float32, np.float64):
            input_images = ((input_images + 1.0) * 127.5).astype(np.float32)

        target_shape = tuple(self.config["input_shape"])
        if input_images.shape[1:] != target_shape:
            import cv2

            resized = np.zeros((input_images.shape[0], *target_shape), np.float32)
            size_xy = tuple(target_shape[:2][::-1])
            for i, img in enumerate(input_images):
                resized[i] = cv2.resize(img, size_xy)
            input_images = resized

        n = input_images.shape[0]
        chunk = min(batch_chunk, max(n, 1))
        outputs = []
        for start in range(0, n, chunk):
            batch = input_images[start:start + chunk]
            pad = chunk - batch.shape[0]
            if pad:
                batch = np.concatenate([batch, np.repeat(batch[-1:], pad, axis=0)])
            probs = self.module(self._to_device(batch), train=False).cpu().numpy()
            outputs.append(probs[:chunk - pad])
        return np.concatenate(outputs)

    # ------------------------------------------------------------------
    # Files
    # ------------------------------------------------------------------

    def save(self, output_dir: str, output_filename: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        save_model_weights(self.get_weights(), output_dir, output_filename)
        metadata = {"logs": self.logs, "config": self.config}
        with open(os.path.join(output_dir, output_filename + ".json"), "w") as fp:
            json.dump(metadata, fp, indent=4)

    @classmethod
    def load(cls, file_path: str,
             device: Optional[Union[str, torch.device]] = None) -> "CelebaAttributeClassifier":
        """A classifier saved by either package (its json's path), on
        ``device`` (the GPU unless given)."""
        with open(file_path, "r") as fp:
            metadata = json.load(fp)
        classifier = cls(metadata["config"], device=device)
        classifier.logs = metadata["logs"]
        classifier.set_weights(load_model_weights(os.path.splitext(file_path)[0] + ".npz"))
        return classifier
