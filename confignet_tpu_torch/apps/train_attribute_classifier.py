"""Attribute-classifier training CLI (counterpart of
``confignet_tpu/apps/train_attribute_classifier.py``; reference:
train_attribute_classifier.py), with the same flags plus ``--device``
(default ``cuda``):

    python -m confignet_tpu_torch.apps.train_attribute_classifier \
        --training_set_path train.pck --validation_set_path val.pck \
        --output_dir out [--device cuda]

``--backbones_dir`` names a directory of Keras ``.h5`` backbones; the
MobileNetV2 trunk loads ``mobilenet_v2_notop.h5`` from it where it is there
(``core/pretrained.py``; not with ``trainable_bn``).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def parse_args(args):
    from confignet_tpu_torch.core.profiling import maybe_trace

    parser = argparse.ArgumentParser()
    parser.add_argument("--training_set_path", required=True)
    parser.add_argument("--validation_set_path", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--profile_dir", default=None,
                        help="Capture a torch.profiler trace of training")
    parser.add_argument("--n_epochs", type=int, default=1000)
    parser.add_argument("--steps_per_epoch", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--backbones_dir", default=None,
                        help="Directory with mobilenet_v2_notop.h5 to start "
                             "from the ImageNet trunk (reference behavior)")
    parser.add_argument("--ignored_attributes", nargs="+",
                        default=["Wearing_Necklace", "Wearing_Necktie"])
    parser.add_argument("--device", default="cuda", help="The device the classifier trains on")
    args = parser.parse_args(args)

    from confignet_tpu_torch.data.dataset import NeuralRendererDataset
    from confignet_tpu_torch.metrics.celeba_attribute_prediction import (
        DEFAULT_CONFIG, CelebaAttributeClassifier)

    training_set = NeuralRendererDataset.load(args.training_set_path)
    validation_set = NeuralRendererDataset.load(args.validation_set_path)

    config = dict(DEFAULT_CONFIG)
    config["input_shape"] = tuple(training_set.imgs.shape[1:])
    config["batch_size"] = args.batch_size
    if args.backbones_dir is not None:
        config["backbones_dir"] = args.backbones_dir
    predicted = [a for a in training_set.attributes[0].keys() if a not in args.ignored_attributes]
    config["predicted_attributes"] = sorted(predicted)

    np.random.seed(0)
    classifier = CelebaAttributeClassifier(config, device=args.device)
    with maybe_trace(args.profile_dir):
        classifier.train(training_set, validation_set, args.output_dir,
                         n_epochs=args.n_epochs, steps_per_epoch=args.steps_per_epoch)
    return classifier


def main() -> None:
    """console_scripts entry point (setup.py)."""
    parse_args(sys.argv[1:])


if __name__ == "__main__":
    main()
