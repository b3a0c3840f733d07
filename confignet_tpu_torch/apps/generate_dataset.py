"""Dataset-generation CLI (counterpart of
``confignet_tpu/apps/generate_dataset.py``; reference: generate_dataset.py),
with the same flags plus ``--device`` (default ``cuda``), the device of the
InceptionV3 features:

    python -m confignet_tpu_torch.apps.generate_dataset --dataset_dir D \
        --dataset_name N --output_dir O [--landmark_backend fake] \
        [--skip_inception_features] [--device cuda]

It normalises the images (landmarks, alignment: host OpenCV), writes the
``<name>_res_<size>.pck`` dataset the trainers read and, unless
``--skip_inception_features``, the images' InceptionV3 features for FID/KID.
The reading and alignment need cv2 where the CLI runs.
"""
from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv):
    parser = argparse.ArgumentParser(description="Script for generating avatar datasets")
    parser.add_argument("--dataset_dir", required=True,
                        help="Path to the directory containing the dataset images")
    parser.add_argument("--dataset_name", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--img_size", type=int, default=256)
    parser.add_argument("--pre_normalize", type=int, default=1)
    parser.add_argument("--img_output_dir", default=None,
                        help="If specified the aligned face images are dumped here")
    parser.add_argument("--load_attributes", action="store_true", default=False)
    parser.add_argument("--synthetic_data", action="store_true", default=False)
    parser.add_argument("--landmark_backend", default=None, choices=[None, "openface", "fake"],
                        help="Landmark backend override (default: openface)")
    parser.add_argument("--skip_inception_features", action="store_true", default=False)
    parser.add_argument("--device", default="cuda",
                        help="The device the InceptionV3 features are computed on")
    args = parser.parse_args(argv)

    from confignet_tpu_torch.data.dataset import NeuralRendererDataset

    dataset = NeuralRendererDataset((args.img_size, args.img_size, 3), args.synthetic_data)

    dataset_name = f"{args.dataset_name}_res_{args.img_size}"
    output_path = os.path.join(args.output_dir, dataset_name + ".pck")
    os.makedirs(args.output_dir, exist_ok=True)

    attribute_file = (os.path.join(args.dataset_dir, "list_attr_celeba.txt")
                      if args.load_attributes else None)

    dataset.generate_face_dataset(
        args.dataset_dir, output_path,
        attribute_label_file_path=attribute_file,
        pre_normalize=args.pre_normalize == 1,
        landmark_backend=args.landmark_backend,
        compute_inception_features=not args.skip_inception_features,
        device=args.device,
    )
    if args.img_output_dir is not None:
        print(f"Writing aligned images to {args.img_output_dir}")
        dataset.write_images(args.img_output_dir)
        if args.load_attributes:
            dataset.write_images_by_attribute(args.img_output_dir)
    return dataset


def main() -> None:
    """console_scripts entry point (setup.py)."""
    parse_args(sys.argv[1:])


if __name__ == "__main__":
    main()
