"""Two-stage ConfigNet training CLI (counterpart of
``confignet_tpu/apps/train_confignet.py``; reference: train_confignet.py),
with the same flags plus ``--device`` (default ``cuda``):

    python -m confignet_tpu_torch.apps.train_confignet --output_dir out \
        --real_training_set_path real.pck --synth_training_set_path synth.pck \
        --validation_set_path val.pck --attribute_classifier_path judge.json \
        [--device cuda]

It loads the three datasets, trains stage 1 on the synthetic and real sets,
carries the weights into a stage-2 model (image-loss weight x10) and trains
stage 2, over a data-parallel mesh as the JAX CLI does (``parallel/mesh.py``).
Launched by ``torchrun`` it trains on one card a process, over NCCL, each
rank on ``cuda:LOCAL_RANK`` (or on the CPU over gloo with ``--device cpu``)::

    torchrun --nproc_per_node=N -m confignet_tpu_torch.apps.train_confignet ...

Launched plainly it trains on ``--device`` alone (a mesh of size 1, which
launches no collective).  ``--batch_size`` is the global batch; it must
divide by 2 * N.  As in the JAX CLI the stage-2 flag is honoured (the
reference passes ``stage_1_training_steps`` to its stage-2 call,
train_confignet.py:72).  ``--resume`` continues from the newest checkpoint
under ``output_dir`` (stage 2) or ``output_dir/first_stage``.  The loss
plots need matplotlib where the CLI runs (unless an AzureML run takes the
values instead), as in the JAX package.  ``--backbones_dir`` names a
directory of Keras ``.h5`` backbones: VGG19, VGGFace, the encoder's ResNet50
and the FID/KID InceptionV3 each load their file where it is there, and keep
their seeded weights where it is not (``core/pretrained.py``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(args):
    from confignet_tpu_torch.core import remote_logging
    from confignet_tpu_torch.core.profiling import maybe_trace
    from confignet_tpu_torch.core.randomness import initialize_random_seed

    parser = argparse.ArgumentParser(description="ConfigNet training")
    parser.add_argument("--output_dir", required=True,
                        help="Path to the directory where the output will be stored")
    parser.add_argument("--log_dir", default=None,
                        help="Directory where tensorboard logs will be written")
    parser.add_argument("--data_dir", default=None,
                        help="Optional path to which the dataset paths are appended")
    parser.add_argument("--real_training_set_path", required=True)
    parser.add_argument("--synth_training_set_path", required=True)
    parser.add_argument("--validation_set_path", required=True)
    parser.add_argument("--attribute_classifier_path", required=True,
                        help="Path to attribute classifier used in metrics")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--stage_1_training_steps", type=int, default=50000)
    parser.add_argument("--stage_2_training_steps", type=int, default=100000)
    parser.add_argument("--n_samples_for_metrics", type=int, default=1000)
    parser.add_argument("--compute_dtype", default=None, choices=[None, "float32", "bfloat16"],
                        help="Override compute dtype")
    parser.add_argument("--config_override", default=None,
                        help="JSON string or path to a JSON file merged over the default config")
    parser.add_argument("--profile_dir", default=None,
                        help="Capture a torch.profiler trace of training into this directory")
    parser.add_argument("--backbones_dir", default=None,
                        help="Directory of standard Keras notop .h5 backbone weights")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="Scan output_dir (and $PT_PREV_OUTPUT_DIR) for the "
                             "newest checkpoint and continue from it")
    parser.add_argument("--device", default="cuda", help="The device the models train on")
    args = parser.parse_args(args)

    aml_run = remote_logging.get_aml_run()
    remote_logging.log_job_params(aml_run, args)
    initialize_random_seed(0)

    if args.data_dir is not None:
        for attr in ("real_training_set_path", "synth_training_set_path",
                     "validation_set_path", "attribute_classifier_path"):
            setattr(args, attr, os.path.join(args.data_dir, getattr(args, attr)))
    if args.log_dir is None:
        args.log_dir = args.output_dir

    from confignet_tpu_torch.core.config import merge_configs
    from confignet_tpu_torch.core.model_io import attempt_reloading_checkpoint, load_confignet
    from confignet_tpu_torch.data.dataset import NeuralRendererDataset
    from confignet_tpu_torch.parallel import create_mesh, maybe_initialize_distributed
    from confignet_tpu_torch.training.first_stage import DEFAULT_CONFIG, ConfigNetFirstStage
    from confignet_tpu_torch.training.second_stage import ConfigNet

    maybe_initialize_distributed(args.device)

    real_training_set = NeuralRendererDataset.load(args.real_training_set_path)
    synth_training_set = NeuralRendererDataset.load(args.synth_training_set_path)
    validation_set = NeuralRendererDataset.load(args.validation_set_path)

    config = {"output_shape": tuple(real_training_set.imgs.shape[1:])}
    if args.config_override is not None:
        if os.path.exists(args.config_override):
            with open(args.config_override) as fp:
                config.update(json.load(fp))
        else:
            config.update(json.loads(args.config_override))
    if args.batch_size is not None:
        config["batch_size"] = args.batch_size
    if args.compute_dtype is not None:
        config["compute_dtype"] = args.compute_dtype
    if args.backbones_dir is not None:
        config["backbones_dir"] = args.backbones_dir
    facemodel_override = config.get("facemodel_inputs")
    config = merge_configs(DEFAULT_CONFIG, config)
    if facemodel_override is not None:
        # a facemodel_inputs override replaces the default table, so datasets
        # without all 12 default metadata keys stay usable
        config["facemodel_inputs"] = {k: tuple(v) for k, v in facemodel_override.items()}
    synth_training_set.process_metadata(config, True)

    # under torchrun each rank takes cuda:LOCAL_RANK unless --device names another
    mesh = create_mesh(device=None if args.device == "cuda" else args.device)
    device = mesh.device

    # --- preemption recovery ---
    def load(path):
        return load_confignet(path, device=device)

    resumed_stage2 = resumed_stage1 = None
    if args.resume:
        resumed = attempt_reloading_checkpoint(args.output_dir, load)
        if resumed is not None and resumed.MODEL_TYPE == "ConfigNet":
            resumed_stage2 = resumed
        else:
            resumed_stage1 = attempt_reloading_checkpoint(
                os.path.join(args.output_dir, "first_stage"), load)

    # --- stage 1 ---
    if resumed_stage2 is None:
        first_stage_model = resumed_stage1 or ConfigNetFirstStage(config, device=device)
        with maybe_trace(args.profile_dir):
            first_stage_model.train(
                real_training_set, synth_training_set,
                os.path.join(args.output_dir, "first_stage"), args.log_dir,
                n_steps=args.stage_1_training_steps,
                n_samples_for_metrics=args.n_samples_for_metrics, aml_run=aml_run, mesh=mesh)
        first_stage_weights = first_stage_model.get_weights()

    # --- stage 2 ---
    config["image_loss_weight"] *= 10
    if resumed_stage2 is not None:
        second_stage_model = resumed_stage2
    else:
        second_stage_model = ConfigNet(config, device=device)
        second_stage_model.set_weights(first_stage_weights)

    with maybe_trace(args.profile_dir):
        second_stage_model.train(
            real_training_set, synth_training_set, validation_set,
            args.attribute_classifier_path, args.output_dir, args.log_dir,
            n_steps=args.stage_2_training_steps,
            n_samples_for_metrics=args.n_samples_for_metrics, aml_run=aml_run, mesh=mesh)
    return second_stage_model


def main() -> None:
    """console_scripts entry point (setup.py)."""
    parse_args(sys.argv[1:])


if __name__ == "__main__":
    main()
