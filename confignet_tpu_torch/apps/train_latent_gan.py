"""LatentGAN training CLI (counterpart of
``confignet_tpu/apps/train_latent_gan.py``; reference: train_latent_gan.py),
with the same flags plus ``--device`` (default ``cuda``):

    python -m confignet_tpu_torch.apps.train_latent_gan \
        --confignet_path model.json --training_set_path train.pck \
        --output_dir out [--device cuda]

``--backbones_dir`` names a directory of Keras ``.h5`` backbones; the
FID/KID Inception loads ``inception_v3_notop.h5`` from it where it is there
(``core/pretrained.py``).
"""
from __future__ import annotations

import argparse
import os
import sys


def parse_args(args):
    from confignet_tpu_torch.core.profiling import maybe_trace
    from confignet_tpu_torch.core.randomness import initialize_random_seed

    parser = argparse.ArgumentParser()
    parser.add_argument("--confignet_path", required=True,
                        help="Path to a confignet model used to train the latent gan")
    parser.add_argument("--training_set_path", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--profile_dir", default=None,
                        help="Capture a torch.profiler trace of training")
    parser.add_argument("--backbones_dir", default=None,
                        help="Directory with inception_v3_notop.h5 for "
                             "ImageNet FID/KID features")
    parser.add_argument("--num_mlp_layers", type=int, default=3)
    parser.add_argument("--hidden_layer_size_multiplier", type=float, default=1.5)
    parser.add_argument("--latent_distribution_type", default="normal")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--n_training_steps", type=int, default=100000)
    parser.add_argument("--n_samples_for_metrics", type=int, default=1000)
    parser.add_argument("--data_dir", default=None)
    parser.add_argument("--log_dir", default=None)
    parser.add_argument("--device", default="cuda",
                        help="The device the ConfigNet and the LatentGAN run on")
    args = parser.parse_args(args)

    initialize_random_seed(0)
    if args.data_dir is not None:
        args.training_set_path = os.path.join(args.data_dir, args.training_set_path)
        args.confignet_path = os.path.join(args.data_dir, args.confignet_path)
    if args.log_dir is None:
        args.log_dir = args.output_dir

    from confignet_tpu_torch.core.model_io import load_confignet
    from confignet_tpu_torch.data.dataset import NeuralRendererDataset
    from confignet_tpu_torch.training.latent_gan import LatentGAN

    training_set = NeuralRendererDataset.load(args.training_set_path)
    confignet_model = load_confignet(args.confignet_path, device=args.device)
    if args.backbones_dir is not None:
        # the FID/KID Inception reads inception_v3_notop.h5 from here
        confignet_model.config["backbones_dir"] = args.backbones_dir

    config = {
        "latent_dim": confignet_model.config["latent_dim"],
        "num_mlp_layers": args.num_mlp_layers,
        "latent_distribution_type": args.latent_distribution_type,
        "hidden_layer_size_multiplier": args.hidden_layer_size_multiplier,
        "batch_size": args.batch_size,
        "n_samples_for_metrics": args.n_samples_for_metrics,
    }
    latent_gan = LatentGAN(config, device=args.device)
    with maybe_trace(args.profile_dir):
        latent_gan.train(training_set, confignet_model, args.output_dir, args.log_dir,
                         n_iters=args.n_training_steps)
    return latent_gan


def main() -> None:
    """console_scripts entry point (setup.py)."""
    parse_args(sys.argv[1:])


if __name__ == "__main__":
    main()
