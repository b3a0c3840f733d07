"""Controllability-evaluation CLI reproducing the paper's Table-2 protocol
(counterpart of ``confignet_tpu/apps/evaluate_confignet_controllability.py``).

Reference: evaluation/evaluate_confignet_controllability.py, same flags and
the same JSON + CSV + plot outputs, plus ``--device`` (default ``cuda``):
the model and the judge run there.  The plot needs matplotlib (the JSON
and CSV are written before it) and ``--write_images`` needs cv2 where the
CLI runs.

    python -m confignet_tpu_torch.apps.evaluate_confignet_controllability \
        --model_path model.json --test_set_path test.pck \
        --attribute_classifier_path judge.json --output_dir out [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

MODEL_BASE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "models")


def parse_args(args):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path",
                        default=os.path.join(MODEL_BASE_DIR, "confignet_256", "model.json"))
    parser.add_argument("--test_set_path", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--attribute_classifier_path",
                        default=os.path.join(MODEL_BASE_DIR, "attribute_classifier", "model.json"))
    parser.add_argument("--n_fine_tuning_iters", type=int, default=0,
                        help="Per-image fine-tuning iterations")
    parser.add_argument("--n_samples", type=int, default=1000)
    parser.add_argument("--write_images", action="store_true", default=False)
    parser.add_argument("--device", default="cuda",
                        help="The device the model and the attribute classifier run on")
    args = parser.parse_args(args)

    from confignet_tpu_torch.core.model_io import load_confignet
    from confignet_tpu_torch.data.dataset import NeuralRendererDataset
    from confignet_tpu_torch.metrics.celeba_attribute_prediction import CelebaAttributeClassifier
    from confignet_tpu_torch.metrics.controllability import ControllabilityMetrics

    confignet_model = load_confignet(args.model_path, device=args.device)
    test_set = NeuralRendererDataset.load(args.test_set_path)
    test_imgs = test_set.imgs[: args.n_samples]

    metrics_extractor = ControllabilityMetrics(
        confignet_model,
        CelebaAttributeClassifier.load(args.attribute_classifier_path, device=args.device),
        per_image_tuning_iters=args.n_fine_tuning_iters,
    )

    metrics_filename = "contr_metrics_tuning_iters_%d_" % args.n_fine_tuning_iters
    metrics_filename += os.path.splitext(os.path.basename(args.model_path))[0]
    img_output_dir = (
        os.path.join(args.output_dir, metrics_filename) if args.write_images else None
    )

    os.makedirs(args.output_dir, exist_ok=True)
    metrics = metrics_extractor.get_metrics(test_imgs, img_output_dir=img_output_dir)

    tuples = [(k, v) for k, v in metrics.items() if isinstance(v, tuple)]
    set_vals = [v[0] for _, v in tuples]
    not_set_vals = [v[1] for _, v in tuples]
    other_deltas = [v[2] for _, v in tuples]
    corr_coefs = [v[3] for _, v in tuples]
    tick_labels = [k for k, _ in tuples]

    # the JSON and CSV first: the plot needs matplotlib, which a machine may lack
    with open(os.path.join(args.output_dir, metrics_filename + ".json"), "w") as fp:
        json.dump(metrics, fp, indent=4)

    csv_content = np.vstack((set_vals, not_set_vals, other_deltas, corr_coefs))
    np.savetxt(
        os.path.join(args.output_dir, metrics_filename + ".csv"),
        csv_content, delimiter=",",
    )

    from confignet_tpu_torch.core.logging_utils import agg_pyplot

    plt = agg_pyplot()

    plt.figure(figsize=(12, 9))
    plt.plot(set_vals)
    plt.plot(not_set_vals)
    plt.plot(other_deltas)
    plt.plot(corr_coefs)
    plt.legend([
        "Attribute value for I_+", "Attribute value for I_-",
        "Mean difference of other attributes", "Corr coef",
    ])
    plt.xticks(range(len(set_vals)), rotation=45)
    plt.gca().set_xticklabels(tick_labels)
    plt.ylim(0, 1)
    plt.tight_layout()
    plt.savefig(os.path.join(args.output_dir, metrics_filename + ".png"))
    plt.close()
    return metrics


def main() -> None:
    parse_args(sys.argv[1:])


if __name__ == "__main__":
    main()
