"""HDRI encoding CLIs (counterpart of ``confignet_tpu/hdri/cli.py``), with
the same commands and flags:

    python -m confignet_tpu_torch.hdri.cli build_model --hdri_dir D --output_dir O
    python -m confignet_tpu_torch.hdri.cli generate_turntable --hdri_file_path F \
        --hdri_model_path M [--output_file_path assets/hdri_turntable_embeddings.npy]
    python -m confignet_tpu_torch.hdri.cli process_metadata --input_dir I \
        --render_asset_dir R --model_path M

- ``build_model``: fit a PCA model over a directory of .hdr images
  (reference: hdri_encoding/hdri_pca_model.py:118-155);
- ``generate_turntable``: embed N rotated copies of one HDRI, the
  turntable the demo's illumination sweep plays
  (reference: hdri_encoding/generate_hdri_turntable_inputs.py);
- ``process_metadata``: add ``hdri_embedding`` vectors to render-metadata
  JSONs (reference: hdri_encoding/process_hdri_metadata.py).

All three are host numpy and OpenCV (cv2 is imported inside the functions
that read and write images); none runs on the card.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

from confignet_tpu_torch.hdri.pca import HDRIModelPCA, load_hdris, resize_hdris

ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "assets")


def build_model(args):
    parser = argparse.ArgumentParser()
    parser.add_argument("--hdri_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--n_components", type=float, default=50,
                        help="Component count, or fraction of variance if < 1")
    parser.add_argument("--output_shape", type=int, nargs=2, default=(64, 128))
    parser.add_argument("--n_rotations_per_image", type=int, default=5)
    parser.add_argument("--write_hdris", action="store_true", default=False)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(args)

    np.random.seed(args.seed)
    hdri_images, _ = load_hdris(args.hdri_dir)
    print("HDRIs loaded")
    model = HDRIModelPCA(tuple(args.output_shape), args.n_rotations_per_image)
    model.fit(hdri_images, args.n_components)

    os.makedirs(args.output_dir, exist_ok=True)
    model.save(os.path.join(args.output_dir, "hdri_model.pck"))
    model.write_basis_images(os.path.join(args.output_dir, "pca_basis"))

    if args.write_hdris:
        import cv2

        out_dir = os.path.join(args.output_dir, "hdris")
        os.makedirs(out_dir, exist_ok=True)
        encoded = model.transform(hdri_images)
        reconstructed = model.inverse_transform(encoded)
        for i, image in enumerate(reconstructed):
            cv2.imwrite(os.path.join(out_dir, f"{i:03d}_reconstructed.hdr"), image)
        for i, image in enumerate(resize_hdris(hdri_images, tuple(args.output_shape))):
            cv2.imwrite(os.path.join(out_dir, f"{i:03d}_original.hdr"), image)
    return model


def generate_turntable(args):
    import cv2

    parser = argparse.ArgumentParser()
    parser.add_argument("--hdri_file_path", required=True)
    parser.add_argument("--output_file_path",
                        default=os.path.join(ASSET_DIR, "hdri_turntable_embeddings.npy"))
    parser.add_argument("--hdri_model_path", required=True)
    parser.add_argument("--n_hdri_rotations", type=int, default=90)
    parser.add_argument("--hdri_output_dir", default=None)
    args = parser.parse_args(args)

    hdri = cv2.imread(args.hdri_file_path, -1)
    rotations = np.linspace(-180, 180, args.n_hdri_rotations)
    stacked = np.stack([hdri] * args.n_hdri_rotations)

    model = HDRIModelPCA.load(args.hdri_model_path)
    embeddings = model.transform(stacked, rotations)
    os.makedirs(os.path.dirname(os.path.abspath(args.output_file_path)), exist_ok=True)
    np.save(args.output_file_path, embeddings)

    if args.hdri_output_dir is not None:
        os.makedirs(args.hdri_output_dir, exist_ok=True)
        for i in range(args.n_hdri_rotations):
            reconstructed = model.inverse_transform(embeddings[[i]])[0]
            reconstructed = np.clip(reconstructed[:, :, [2, 1, 0]] * 255, 0, 255)
            cv2.imwrite(
                os.path.join(args.hdri_output_dir, f"{i:04d}.jpg"),
                reconstructed.astype(np.uint8)[..., ::-1],
            )
    return embeddings


def process_metadata(args):
    parser = argparse.ArgumentParser(
        description="Add hdri_embedding vectors to render metadata .json files"
    )
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--render_asset_dir", required=True)
    parser.add_argument("--model_path", required=True)
    args = parser.parse_args(args)

    model = HDRIModelPCA.load(args.model_path)
    metadata_files = sorted(glob.glob(os.path.join(args.input_dir, "*.json")))
    metadata_dicts = []
    for path in metadata_files:
        with open(path, "r") as fp:
            metadata_dicts.append(json.load(fp))

    hdris, hdri_paths = load_hdris(os.path.join(args.render_asset_dir, "HDRI"))
    hdri_names = [os.path.basename(p) for p in hdri_paths]

    for i, meta in enumerate(metadata_dicts):
        if i % 100 == 0:
            print(i)
        hdri_name = meta["illumination"]["HDRI_filename"]
        rotation = 180 * meta["illumination"]["HDRI_rotation"][2] / np.pi
        hdri = hdris[hdri_names.index(hdri_name)]
        embedding = model.transform(hdri[np.newaxis], [rotation])[0]
        meta["hdri_embedding"] = embedding.tolist()

    for meta, path in zip(metadata_dicts, metadata_files):
        with open(path, "w") as fp:
            json.dump(meta, fp, indent=4)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("build_model", "generate_turntable", "process_metadata"):
        print("usage: python -m confignet_tpu_torch.hdri.cli "
              "{build_model|generate_turntable|process_metadata} [options]")
        sys.exit(2)
    command, rest = argv[0], argv[1:]
    if command == "build_model":
        build_model(rest)
    elif command == "generate_turntable":
        generate_turntable(rest)
    else:
        process_metadata(rest)


if __name__ == "__main__":
    main()
