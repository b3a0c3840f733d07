"""Interactive ConfigNet demo (counterpart of
``confignet_tpu/apps/confignet_demo.py``; reference:
evaluation/confignet_demo.py), with the same flags plus ``--device``
(default ``cuda``):

    python -m confignet_tpu_torch.apps.confignet_demo [--image_path P] \
        [--confignet_model_path m.json] [--latent_gan_model_path g.json] \
        [--test_mode] [--device cuda]

Three input modes:

- a single image path: encode it (enables the one-shot fine-tune, key B);
- an image directory: normalise it and sample from up to 200 images;
- no input: sample novel faces from a LatentGAN with truncation 0.7.

The models default to the released ``models/confignet_<res>/model.json``
and ``models/latentgan_<res>/model.json``; either checkpoint format loads
(``core/model_io.load_confignet`` sniffs it).  The render loop
(:func:`run_loop`): glide the latents, splice the gaze, render, show an
OpenCV grid.  Keys: space resample, X new attribute value, V reset, B
fine-tune, WSAD/IKJL pose/gaze, N HDRI sweep, Z/C attribute cycling.
``--test_mode`` renders one headless frame, fires every key once (one
fine-tune iteration in the single-image mode) and returns the frame.

cv2 is imported only where it is used: to show the grid and read keys
outside ``--test_mode``, and to read and normalise ``--image_path``; so
``--test_mode`` without ``--image_path`` runs without it.  The JAX demo
calls ``cv2.waitKey`` in ``--test_mode`` too; the port takes no key there.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List, Optional

import numpy as np

MODEL_BASE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "models")


def parse_args(args):
    confignet_model_paths = {
        256: os.path.join(MODEL_BASE_DIR, "confignet_256", "model.json"),
        512: os.path.join(MODEL_BASE_DIR, "confignet_512", "model.json"),
    }
    latentgan_model_paths = {
        256: os.path.join(MODEL_BASE_DIR, "latentgan_256", "model.json"),
        512: os.path.join(MODEL_BASE_DIR, "latentgan_512", "model.json"),
    }

    parser = argparse.ArgumentParser()
    parser.add_argument("--image_path", default=None,
                        help="Path to a directory of images or an individual image")
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--n_rows", type=int, default=2)
    parser.add_argument("--n_cols", type=int, default=3)
    parser.add_argument("--test_mode", action="store_true", default=False,
                        help="Render a single frame headless (for tests)")
    parser.add_argument("--confignet_model_path", default=None)
    parser.add_argument("--latent_gan_model_path", default=None)
    parser.add_argument("--landmark_backend", default=None)
    parser.add_argument("--device", default="cuda", help="The device the models run on")
    args = parser.parse_args(args)

    if args.confignet_model_path is None:
        args.confignet_model_path = confignet_model_paths[args.resolution]
    if args.latent_gan_model_path is None:
        args.latent_gan_model_path = latentgan_model_paths[args.resolution]
    return args


def process_images(image_path: str, resolution: int,
                   landmark_backend: Optional[str] = None) -> List[np.ndarray]:
    """Load and normalise the input image(s) (reference: confignet_demo.py:42-62)."""
    import cv2

    from confignet_tpu_torch.data.normalizer import FaceImageNormalizer

    if os.path.isfile(image_path):
        img = cv2.imread(image_path)
        img = FaceImageNormalizer.normalize_individual_image(
            img, (resolution, resolution), landmark_backend=landmark_backend)
        return [img]
    if os.path.isdir(image_path):
        FaceImageNormalizer.normalize_dataset_dir(
            image_path, pre_normalize=True, output_image_shape=(resolution, resolution),
            write_done_file=False, landmark_backend=landmark_backend)
        normalized_dir = os.path.join(image_path, "normalized")
        image_paths = glob.glob(os.path.join(normalized_dir, "*.png"))[:200]
        if not image_paths:
            raise ValueError("No images in input directory")
        return [cv2.imread(p) for p in image_paths]
    raise ValueError("Image path is neither directory nor file")


def get_new_embeddings(args, input_images, latentgan_model, confignet_model):
    """Embeddings sampled from the LatentGAN (no inputs) or encoded from
    input images (reference: confignet_demo.py:64-84)."""
    if input_images is None:
        n_samples = args.n_rows * args.n_cols
        embeddings = latentgan_model.generate_latents(n_samples, truncation=0.7)
        rotations = np.zeros((n_samples, 3), np.float32)
        orig_images = confignet_model.generate_images(embeddings, rotations)
    else:
        if len(input_images) == 1:
            args.n_rows = args.n_cols = 1
        n_samples = args.n_rows * args.n_cols
        idx = np.random.randint(0, len(input_images), n_samples)
        orig_images = np.array([input_images[i] for i in idx])
        embeddings, rotations = confignet_model.encode_images(orig_images)
    return embeddings, rotations, orig_images


def set_gaze_direction_in_embedding(latents, eye_pose, confignet_model):
    return confignet_model.set_facemodel_param_in_latents(latents, "bone_rotations:left_eye",
                                                          eye_pose)


def get_embedding_with_new_attribute_value(parameter_name, latents, confignet_model):
    new_value = confignet_model.facemodel_param_distributions[parameter_name].sample(1)[0]
    return confignet_model.set_facemodel_param_in_latents(latents, parameter_name, new_value)


def run(args) -> np.ndarray:
    """Load the inputs and models named by the flags, then :func:`run_loop`.
    Returns the last frame shown."""
    from confignet_tpu_torch.core.model_io import load_confignet
    from confignet_tpu_torch.training.latent_gan import LatentGAN

    args = parse_args(args)
    if args.image_path is not None:
        input_images = process_images(args.image_path, args.resolution, args.landmark_backend)
        latentgan_model = None
    else:
        input_images = None
        print("WARNING: no input image specified, sampling from the LatentGAN")
        latentgan_model = LatentGAN.load(args.latent_gan_model_path, device=args.device)
    confignet_model = load_confignet(args.confignet_model_path, device=args.device)
    return run_loop(args, input_images, latentgan_model, confignet_model)


def run_loop(args, input_images: Optional[List[np.ndarray]], latentgan_model,
             confignet_model) -> np.ndarray:
    """The render loop on loaded models: ``input_images`` is a list of
    normalised uint8 photos, or None to sample from ``latentgan_model``.
    Returns the last frame (the grid of input | render | white strip)."""
    from confignet_tpu_torch.apps.basic_ui import BasicUI
    from confignet_tpu_torch.core.images import build_image_matrix

    cv2 = None
    if not args.test_mode:
        import cv2

    basic_ui = BasicUI(confignet_model)
    current_embedding_unmodified, current_rotation, orig_images = get_new_embeddings(
        args, input_images, latentgan_model, confignet_model)
    basic_ui.retarget(current_embedding_unmodified)

    image_matrix = None
    while not basic_ui.exit:
        current_renderer_input = basic_ui.frame_latent()
        if "bone_rotations:left_eye" in confignet_model.config["facemodel_inputs"]:
            current_renderer_input = set_gaze_direction_in_embedding(
                current_renderer_input, basic_ui.eye_rotation_offset, confignet_model)

        generated_imgs = confignet_model.generate_images(
            current_renderer_input, current_rotation + basic_ui.rotation_offset)

        white_strip = np.full((generated_imgs.shape[0], generated_imgs.shape[1], 20, 3), 255,
                              np.uint8)
        visualization = np.dstack((orig_images, generated_imgs, white_strip))
        image_matrix = build_image_matrix(visualization, args.n_rows, args.n_cols)

        basic_ui.advance()

        key = -1
        if not args.test_mode:
            cv2.imshow("img", image_matrix)
            key = cv2.waitKey(1)
        key = basic_ui.handle_key(key, args.test_mode)

        if key == ord(" ") or args.test_mode:
            current_embedding_unmodified, current_rotation, orig_images = get_new_embeddings(
                args, input_images, latentgan_model, confignet_model)
            basic_ui.retarget(current_embedding_unmodified)
        if key == ord("v") or args.test_mode:
            basic_ui.retarget(current_embedding_unmodified)
        if key == ord("x") or args.test_mode:
            new_embeddings = get_embedding_with_new_attribute_value(
                basic_ui.current_attribute, basic_ui.frame_latent(), confignet_model)
            basic_ui.retarget(new_embeddings)
        if key == ord("b") or args.test_mode:
            if input_images is None or len(input_images) != 1:
                print("For one-shot learning pass a single input image path")
                continue
            n_iters = 1 if args.test_mode else 50
            print("Fine tuning generator on single image, this might take a minute or two")
            current_embedding_unmodified, current_rotation = confignet_model.fine_tune_on_img(
                input_images[0], n_iters)
            basic_ui.retarget(current_embedding_unmodified)
        if args.test_mode:
            break
    return image_matrix


def main() -> None:
    """console_scripts entry point (setup.py)."""
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
