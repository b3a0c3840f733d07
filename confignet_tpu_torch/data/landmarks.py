"""Facial-landmark backends.

The port's own copy of ``confignet_tpu/data/landmarks.py``.

The reference shells out to the OpenFace C++ binary and parses its CSV
output (confignet/dataset_utils.py:9-58,135-148).  Here the same file-based
contract is a pluggable backend:

- :class:`OpenFaceBackend` — identical subprocess + CSV contract, for users
  who have OpenFace installed.
- :class:`FakeLandmarkBackend` — synthesizes a plausible canonical face
  layout so the entire dataset pipeline (and CI) runs with no native binary.

Both produce ``processed/<img>.csv`` + ``processed/<img>_of_details.txt``
and a ``landmarks_detected`` sentinel, then
:func:`read_landmarks_and_pose_from_csv` parses them back.
"""
from __future__ import annotations

import os
import subprocess
from typing import Optional, Tuple

import numpy as np

REPO_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
DEFAULT_OPENFACE_PATH = os.path.join(
    REPO_ROOT, "3rd_party", "OpenFace_2.2.0_win_x64", "FaceLandmarkImg.exe"
)

N_LANDMARKS = 68
CONFIDENCE_THRESHOLD = 0.6


# ---------------------------------------------------------------------------
# CSV contract parsing (format defined by OpenFace's FaceLandmarkImg output)
# ---------------------------------------------------------------------------

def _read_headers(csv_file_path: str):
    with open(csv_file_path, "r") as fp:
        headers = fp.readline().split(",")
    return [h.strip() for h in headers]


def read_landmarks_and_pose_from_csv(
    csv_file_path: str,
    n_landmarks: int = N_LANDMARKS,
    confidence_threshold: float = CONFIDENCE_THRESHOLD,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], Optional[np.ndarray]]:
    """Parse 68 2D + 3D landmarks and the 6-dof pose; pick the
    highest-confidence face and reject below-threshold detections."""
    headers = _read_headers(csv_file_path)

    lm2d_cols = [headers.index(f"x_{i}") for i in range(n_landmarks)]
    lm2d_cols += [headers.index(f"y_{i}") for i in range(n_landmarks)]
    lm3d_cols = [headers.index(f"{a}_{i}") for a in "XYZ" for i in range(n_landmarks)]
    pose_cols = [
        headers.index(h)
        for h in ("pose_Tx", "pose_Ty", "pose_Tz", "pose_Rx", "pose_Ry", "pose_Rz")
    ]
    conf_col = headers.index("confidence")

    data = np.loadtxt(csv_file_path, skiprows=1, delimiter=",", ndmin=2)
    if data.size == 0:
        return None, None, None
    confidences = data[:, conf_col]
    best = int(np.argmax(confidences))
    if confidences[best] < confidence_threshold:
        return None, None, None

    row = data[best]
    landmarks = row[lm2d_cols].reshape(n_landmarks, 2, order="F")
    landmarks_3d = row[lm3d_cols].reshape(n_landmarks, 3, order="F")
    pose = row[pose_cols]
    return landmarks, landmarks_3d, pose


def read_estimated_intrinsics(details_file_path: str) -> np.ndarray:
    """Parse fx, fy, cx, cy from the third line of the *_of_details.txt
    (reference: dataset_utils.py:43-58)."""
    with open(details_file_path, "r") as fp:
        lines = fp.readlines()
    params = [float(x) for x in lines[2].split(":")[1].split(",")]
    K = np.eye(3)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = params[:4]
    return K


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

class OpenFaceBackend:
    """Invoke the external OpenFace landmark detector on a directory,
    exactly as the reference does (dataset_utils.py:135-148)."""

    def __init__(self, openface_path: str = DEFAULT_OPENFACE_PATH):
        self.openface_path = openface_path

    def detect_dir(self, input_dir: str) -> None:
        done_file = os.path.join(input_dir, "landmarks_detected")
        if os.path.exists(done_file):
            return
        output_dir = os.path.join(input_dir, "processed")
        os.makedirs(output_dir, exist_ok=True)
        if not os.path.exists(self.openface_path):
            raise ImportError(
                "OpenFace not found at %s; install it or use the fake backend"
                % self.openface_path
            )
        print(f"Running OpenFace on data dir {input_dir}")
        subprocess.call(
            [
                self.openface_path,
                "-fdir", input_dir,
                "-wild",
                "-out_dir", output_dir,
                "-2Dfp", "-3Dfp", "-pose",
                "-multi_view 1",
            ]
        )
        with open(done_file, "w+"):
            pass


# Canonical 68-landmark layout in a normalized [0,1]^2 face box.  Hand-laid
# approximation of the iBUG-68 scheme: jaw contour (0-16), brows (17-26),
# nose (27-35), eyes (36-47), mouth (48-67).  Only needs to be plausible
# enough for the similarity-transform math to be well-conditioned.
def _canonical_landmarks() -> np.ndarray:
    pts = np.zeros((68, 2), np.float32)
    # jaw: half-ellipse
    t = np.linspace(np.pi, 2 * np.pi, 17)
    pts[0:17, 0] = 0.5 + 0.45 * np.cos(t)
    pts[0:17, 1] = 0.55 - 0.45 * np.sin(t)
    # brows
    pts[17:22, 0] = np.linspace(0.2, 0.42, 5)
    pts[17:22, 1] = 0.35
    pts[22:27, 0] = np.linspace(0.58, 0.8, 5)
    pts[22:27, 1] = 0.35
    # nose bridge + base
    pts[27:31, 0] = 0.5
    pts[27:31, 1] = np.linspace(0.42, 0.58, 4)
    pts[31:36, 0] = np.linspace(0.42, 0.58, 5)
    pts[31:36, 1] = 0.62
    # eyes (6 points each)
    for base, cx in ((36, 0.31), (42, 0.69)):
        ang = np.linspace(0, 2 * np.pi, 6, endpoint=False)
        pts[base : base + 6, 0] = cx + 0.07 * np.cos(ang)
        pts[base : base + 6, 1] = 0.45 + 0.03 * np.sin(ang)
    # mouth: outer 12 + inner 8
    ang = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    pts[48:60, 0] = 0.5 + 0.13 * np.cos(ang)
    pts[48:60, 1] = 0.78 + 0.06 * np.sin(ang)
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    pts[60:68, 0] = 0.5 + 0.07 * np.cos(ang)
    pts[60:68, 1] = 0.78 + 0.03 * np.sin(ang)
    return pts


class FakeLandmarkBackend:
    """Writes synthetic OpenFace-format CSVs assuming one frontal centered
    face per image.  Lets the full dataset pipeline and tests run without
    the native binary."""

    def detect_dir(self, input_dir: str) -> None:
        import glob

        import cv2

        done_file = os.path.join(input_dir, "landmarks_detected")
        if os.path.exists(done_file):
            return
        output_dir = os.path.join(input_dir, "processed")
        os.makedirs(output_dir, exist_ok=True)

        image_paths = []
        for pattern in ("*.jpg", "*.png", "*.bmp", "*.jpeg"):
            image_paths.extend(glob.glob(os.path.join(input_dir, pattern)))

        canonical = _canonical_landmarks()
        for image_path in image_paths:
            img = cv2.imread(image_path)
            if img is None:
                continue
            h, w = img.shape[:2]
            name = os.path.splitext(os.path.basename(image_path))[0]

            # 2D landmarks: canonical layout over the middle 60% of the image
            lm2d = np.zeros_like(canonical)
            lm2d[:, 0] = (canonical[:, 0] - 0.5) * 0.6 * w + w / 2
            lm2d[:, 1] = (canonical[:, 1] - 0.5) * 0.6 * h + h / 2

            # 3D landmarks: planar face 500mm from the camera, metric scale
            # chosen so interocular distance ~ 65mm
            inter_px = np.linalg.norm(lm2d[45] - lm2d[36])
            mm_per_px = 65.0 / max(inter_px, 1e-6)
            lm3d = np.zeros((68, 3), np.float32)
            lm3d[:, 0] = (lm2d[:, 0] - w / 2) * mm_per_px
            lm3d[:, 1] = (lm2d[:, 1] - h / 2) * mm_per_px
            lm3d[:, 2] = 500.0

            pose = np.array([0.0, 0.0, 500.0, 0.0, 0.0, 0.0])
            self._write_csv(os.path.join(output_dir, name + ".csv"), lm2d, lm3d, pose)
            focal = 0.5 * (w + h)
            self._write_details(
                os.path.join(output_dir, name + "_of_details.txt"),
                focal, focal, w / 2, h / 2,
            )

        with open(done_file, "w+"):
            pass

    @staticmethod
    def _write_csv(path: str, lm2d: np.ndarray, lm3d: np.ndarray, pose: np.ndarray) -> None:
        headers = ["frame", "face_id", "timestamp", "confidence", "success"]
        headers += [f"x_{i}" for i in range(68)] + [f"y_{i}" for i in range(68)]
        headers += [f"{a}_{i}" for a in "XYZ" for i in range(68)]
        headers += ["pose_Tx", "pose_Ty", "pose_Tz", "pose_Rx", "pose_Ry", "pose_Rz"]
        values = [1, 0, 0.0, 0.98, 1]
        values += list(lm2d[:, 0]) + list(lm2d[:, 1])
        values += list(lm3d[:, 0]) + list(lm3d[:, 1]) + list(lm3d[:, 2])
        values += list(pose)
        with open(path, "w") as fp:
            fp.write(", ".join(headers) + "\n")
            fp.write(", ".join(str(v) for v in values) + "\n")

    @staticmethod
    def _write_details(path: str, fx, fy, cx, cy) -> None:
        with open(path, "w") as fp:
            fp.write("input: synthetic\n")
            fp.write("camera parameters given: 0\n")
            fp.write(f"camera parameters: {fx}, {fy}, {cx}, {cy}\n")


def get_backend(name: Optional[str] = None, openface_path: str = DEFAULT_OPENFACE_PATH):
    """Resolve a backend by name or the CONFIGNET_TPU_LANDMARK_BACKEND env
    var; defaults to OpenFace (matching the reference), with 'fake' for
    binary-free runs."""
    name = name or os.environ.get("CONFIGNET_TPU_LANDMARK_BACKEND", "openface")
    if name == "openface":
        return OpenFaceBackend(openface_path)
    if name == "fake":
        return FakeLandmarkBackend()
    raise ValueError(f"unknown landmark backend {name!r}")


def run_landmark_detection_on_dir(input_dir: str, openface_path: str = DEFAULT_OPENFACE_PATH,
                                  backend: Optional[str] = None) -> None:
    get_backend(backend, openface_path).detect_dir(input_dir)
