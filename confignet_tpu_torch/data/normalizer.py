"""Face-image normalization: align faces to the canonical ConfigNet framing.

The port's own copy of ``confignet_tpu/data/normalizer.py``.

Reference: confignet/face_image_normalizer.py.  Two passes:

1. *Pre-normalization* (real photos only): a 2D similarity transform maps
   five reference landmark groups to canonical positions in a 1024px frame,
   centering the face so the 3D pass is well-conditioned.
2. *Head-center normalization*: the detected 3D landmarks are frontalized
   with the estimated head pose + camera intrinsics; scale comes from the
   frontal interocular and eye-to-mouth distances, rotation from the 2D eye
   line, and translation places the projected head center at (0.5, 0.42).

Directory runs are idempotent via ``normalization_done`` sentinels; single
images go through a temp dir.  Companion ``uv_*.exr`` maps are warped with
nearest-neighbor.  Landmark detection is pluggable (see data/landmarks.py).
"""
from __future__ import annotations

import glob
import os
import tempfile
from typing import Optional, Tuple

import numpy as np

from confignet_tpu_torch.data import landmarks as lm


def euler_matrix_rxyz(rx: float, ry: float, rz: float) -> np.ndarray:
    """Rotation matrix for intrinsic x-y-z Euler angles (the 'rxyz'
    convention of the classic transformations module used by OpenFace pose
    vectors): R = Rx(rx) @ Ry(ry) @ Rz(rz)."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rx @ Ry @ Rz


def get_similarity_transform(destination_landmarks: np.ndarray,
                             source_landmarks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares 2D similarity (scale+rotation A and translation t) such
    that A @ src + t ~ dst (reference: dataset_utils.py:91-107)."""
    dest_mean = destination_landmarks.mean(axis=0)
    src_mean = source_landmarks.mean(axis=0)

    src_vec = (source_landmarks - src_mean).flatten()
    dest_vec = (destination_landmarks - dest_mean).flatten()
    norm2 = np.linalg.norm(src_vec) ** 2

    a = np.dot(src_vec, dest_vec) / norm2
    b = 0.0
    for i in range(destination_landmarks.shape[0]):
        b += src_vec[2 * i] * dest_vec[2 * i + 1] - src_vec[2 * i + 1] * dest_vec[2 * i]
    b /= norm2

    A = np.array([[a, -b], [b, a]])
    t = dest_mean - A @ src_mean
    return A, t


def align_image(img: np.ndarray, landmarks: np.ndarray, output_shape,
                canonical_landmarks: np.ndarray) -> np.ndarray:
    """Warp an image so its landmarks land on the canonical positions
    (reference: dataset_utils.py:109-117)."""
    import cv2

    A, t = get_similarity_transform(landmarks, canonical_landmarks)
    M = np.hstack((A, t[:, np.newaxis]))
    M = cv2.invertAffineTransform(M)
    return cv2.warpAffine(img, M, tuple(output_shape[:2]))


class FaceImageNormalizer:
    # --- pre-normalization constants (reference: face_image_normalizer.py:28-34)
    ref_pre_norm_landmark_idxs = ((36, 39), (42, 45), (30,), (48,), (54,))
    _raw_ref_positions = np.array(
        ((0.32, 0.45), (0.68, 0.45), (0.5, 0.6), (0.34, 0.82), (0.66, 0.82))
    )
    pre_norm_face_scale = 0.5
    pre_norm_image_size = 1024
    ref_pre_norm_landmark_positions = (_raw_ref_positions - 0.5) * pre_norm_face_scale + 0.5

    # --- head-center normalization constants (:37-42)
    ref_head_center_coords = (0.5, 0.42)
    eye_corner_idxs = (36, 45)
    mouth_top_idx = 51
    head_center_idxs = (0, 16)
    interocular_fraction = 0.45
    eye_to_mouth_fraction = 0.34

    image_filename_patterns = ("*.jpg", "*.png", "*.bmp", "*.jpeg")

    @classmethod
    def normalize_dataset_dir(cls, input_dir: str, pre_normalize: bool,
                              output_image_shape, openface_path=lm.DEFAULT_OPENFACE_PATH,
                              write_done_file: bool = True,
                              landmark_backend: Optional[str] = None) -> None:
        output_dir = os.path.join(input_dir, "normalized")
        done_file = os.path.join(output_dir, "normalization_done")
        if os.path.exists(done_file):
            return

        lm.run_landmark_detection_on_dir(input_dir, openface_path, landmark_backend)
        if pre_normalize:
            size = cls.pre_norm_image_size
            pre_norm_dir = os.path.join(input_dir, "pre_normalized")
            pre_done = os.path.join(pre_norm_dir, "normalization_done")
            if not os.path.exists(pre_done):
                cls._normalize_directory(input_dir, pre_norm_dir, True, (size, size))
                lm.run_landmark_detection_on_dir(pre_norm_dir, openface_path, landmark_backend)
                if write_done_file:
                    open(pre_done, "w+").close()
            input_dir = pre_norm_dir

        cls._normalize_directory(input_dir, output_dir, False, output_image_shape)
        if write_done_file:
            open(done_file, "w+").close()

    @classmethod
    def normalize_individual_image(cls, image: np.ndarray, output_image_shape,
                                   landmark_backend: Optional[str] = None) -> Optional[np.ndarray]:
        import cv2

        with tempfile.TemporaryDirectory() as temp_dir:
            cv2.imwrite(os.path.join(temp_dir, "temp_img.png"), image)
            cls.normalize_dataset_dir(
                temp_dir, True, output_image_shape, landmark_backend=landmark_backend
            )
            normalized_path = os.path.join(temp_dir, "normalized", "temp_img.png")
            if os.path.exists(normalized_path):
                return cv2.imread(normalized_path)
        return None

    # ------------------------------------------------------------------

    @classmethod
    def _normalize_directory(cls, input_dir: str, output_dir: str, normalize_2d: bool,
                             output_image_shape) -> None:
        import cv2

        os.makedirs(output_dir, exist_ok=True)
        image_paths = []
        for pattern in cls.image_filename_patterns:
            image_paths.extend(glob.glob(os.path.join(input_dir, pattern)))

        for image_path in image_paths:
            name = os.path.splitext(os.path.basename(image_path))[0]
            csv_path = os.path.join(input_dir, "processed", name + ".csv")
            if not os.path.exists(csv_path):
                continue
            landmarks, landmarks_3d, pose = lm.read_landmarks_and_pose_from_csv(csv_path)
            if landmarks is None:
                continue
            details_path = os.path.join(input_dir, "processed", name + "_of_details.txt")
            intrinsics = lm.read_estimated_intrinsics(details_path)

            if normalize_2d:
                M = cls._get_normalizing_transform_2d(landmarks, output_image_shape)
            else:
                M = cls._get_normalizing_transform_3d(
                    landmarks, landmarks_3d, pose, intrinsics, output_image_shape
                )

            image = cv2.imread(image_path)
            image = cv2.warpAffine(image, M, tuple(output_image_shape[:2]))
            cv2.imwrite(os.path.join(output_dir, name + ".png"), image)

            # warp companion UV map if present (img_* -> uv_* naming)
            uv_name = "uv" + name[3:] + ".exr"
            uv_path = os.path.join(input_dir, uv_name)
            if os.path.exists(uv_path):
                uv_image = cv2.imread(uv_path, -1)
                uv_image = cv2.warpAffine(
                    uv_image, M, tuple(output_image_shape[:2]), flags=cv2.INTER_NEAREST
                )
                cv2.imwrite(os.path.join(output_dir, uv_name), uv_image)

    # ------------------------------------------------------------------

    @classmethod
    def _get_normalizing_transform_3d(cls, landmarks_2d, landmarks_3d, pose,
                                      intrinsics, output_image_shape) -> np.ndarray:
        ref_interocular = cls.interocular_fraction * output_image_shape[1]
        ref_eye_to_mouth = cls.eye_to_mouth_fraction * output_image_shape[0]

        t = pose[:3]
        R = euler_matrix_rxyz(pose[3], pose[4], pose[5])

        # frontalize the 3D landmarks about the head position
        canonical = (landmarks_3d - t) @ R
        frontal = canonical + t

        proj = frontal @ intrinsics.T
        proj = proj[:, :2] / proj[:, [2]]

        e0, e1 = cls.eye_corner_idxs
        frontal_interocular = np.linalg.norm(proj[e0] - proj[e1])
        eye_center = (proj[e0] + proj[e1]) / 2
        mouth_to_eye = np.linalg.norm(proj[cls.mouth_top_idx] - eye_center)
        scale = (
            ref_interocular / frontal_interocular + ref_eye_to_mouth / mouth_to_eye
        ) / 2

        eye_vector = landmarks_2d[e1] - landmarks_2d[e0]
        rotation = np.arctan2(eye_vector[1], eye_vector[0])

        head_center = landmarks_3d[list(cls.head_center_idxs), :].mean(axis=0)
        head_proj = intrinsics @ head_center
        head_proj = head_proj[:2] / head_proj[2]

        sin_r, cos_r = np.sin(rotation), np.cos(rotation)
        A = scale * np.array(((cos_r, sin_r), (-sin_r, cos_r)))
        t_out = np.asarray(cls.ref_head_center_coords) * np.asarray(
            output_image_shape[:2]
        ) - A @ head_proj
        return np.hstack((A, t_out[:, np.newaxis]))

    @classmethod
    def _get_normalizing_transform_2d(cls, landmarks, output_image_shape) -> np.ndarray:
        incoming = np.array(
            [landmarks[list(idxs), :].mean(axis=0) for idxs in cls.ref_pre_norm_landmark_idxs]
        )
        ref_positions = cls.ref_pre_norm_landmark_positions * np.asarray(output_image_shape[:2])
        A, t = get_similarity_transform(ref_positions, incoming)
        return np.hstack((A, t[:, np.newaxis]))
