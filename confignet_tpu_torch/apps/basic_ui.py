"""Interactive-demo control state (counterpart of
``confignet_tpu/apps/basic_ui.py``): keyboard dispatch, pose and gaze
offsets, the glide between latents and the HDRI illumination turntable.

The reference demo's behaviour (evaluation/basic_ui.py): WSAD/QE drive the
head pose, IKJL/UO the gaze, Z/C cycle the controlled attribute, N toggles a
looping HDRI sweep, Esc exits, and every latent change glides in over 5
frames.  ``LatentInterpolator`` owns the glide, ``HdriTurntable`` the sweep
(the repo's ``assets/hdri_turntable_embeddings.npy``), and the keys are a
dispatch table.  All of it is host numpy; the model it is given renders and
splices.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np

ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "assets")

_POSE_STEP = 0.05  # radians per key press
_GLIDE_FRAMES = 5  # latent changes interpolate in over this many frames


class LatentInterpolator:
    """Glides from the currently displayed latent to a new target over a
    fixed number of frames, so attribute edits ease in instead of popping."""

    def __init__(self, n_frames: int = _GLIDE_FRAMES):
        self._rate = 1.0 / n_frames
        self._source: Optional[np.ndarray] = None
        self._target: Optional[np.ndarray] = None
        self._progress = 1.0

    def retarget(self, latent: np.ndarray) -> None:
        """Start gliding toward ``latent`` from whatever is shown now."""
        self._source = latent if self._target is None else self.value()
        self._target = latent
        self._progress = 0.0

    def advance(self) -> None:
        self._progress = min(self._progress + self._rate, 1.0)

    def value(self) -> np.ndarray:
        if self._progress >= 1.0:
            return self._target
        return self._source + self._progress * (self._target - self._source)


class HdriTurntable:
    """Looping illumination sweep: each frame splices the next pre-computed
    HDRI embedding into the latent (assets/hdri_turntable_embeddings.npy)."""

    def __init__(self, confignet_model, path: Optional[str] = None):
        self._model = confignet_model
        self._frames: Optional[np.ndarray] = None
        self._cursor = 0
        self.active = False

        path = path or os.path.join(ASSET_DIR, "hdri_turntable_embeddings.npy")
        hdri_spec = confignet_model.config["facemodel_inputs"].get("hdri_embedding")
        if hdri_spec is None or not os.path.exists(path):
            return
        frames = np.load(path)
        if frames.shape[1] != hdri_spec[0]:
            print(
                f"WARNING: turntable embeddings are {frames.shape[1]}-dim but the "
                f"model's hdri_embedding input is {hdri_spec[0]}-dim; "
                "illumination sweep disabled"
            )
            return
        self._frames = frames

    def toggle(self) -> None:
        self.active = not self.active
        print(f"Light source rotation changed to {self.active}")

    def apply(self, latent: np.ndarray) -> np.ndarray:
        if not (self.active and self._frames is not None):
            return latent
        latent = self._model.set_facemodel_param_in_latents(
            latent, "hdri_embedding", self._frames[self._cursor]
        )
        self._cursor = (self._cursor + 1) % len(self._frames)
        return latent


class BasicUI:
    """Keyboard-driven demo state.

    The demo loop calls :meth:`frame_latent` to render, :meth:`advance` once
    per frame, :meth:`handle_key` on input, and :meth:`retarget` whenever it
    computes a new latent (attribute edit, re-encode, reset).
    """

    def __init__(self, confignet_model, hdri_turntable_path: Optional[str] = None):
        self.confignet_model = confignet_model
        self.exit = False
        self.rotation_offset = np.zeros((1, 3))
        self.eye_rotation_offset = np.zeros((1, 3))

        self.facemodel_param_names = [
            name for name in confignet_model.config["facemodel_inputs"]
            # Eye rotation has dedicated gaze keys, not the attribute cycle.
            if name != "bone_rotations:left_eye"
        ]
        self.controlled_param_idx = 0

        self._interp = LatentInterpolator()
        self._turntable = HdriTurntable(confignet_model, hdri_turntable_path)
        self._dispatch = self._build_dispatch()

    # -- frame lifecycle ------------------------------------------------

    def retarget(self, latent: np.ndarray) -> None:
        self._interp.retarget(latent)

    def frame_latent(self) -> np.ndarray:
        """The latent to render this frame (glide + optional HDRI splice)."""
        return self._turntable.apply(self._interp.value())

    def advance(self) -> None:
        self._interp.advance()

    # -- keyboard -------------------------------------------------------

    def _nudge(self, target: str, axis: int, sign: float) -> Callable[[], None]:
        offsets = {"pose": self.rotation_offset, "gaze": self.eye_rotation_offset}

        def action() -> None:
            offsets[target][0, axis] += sign * _POSE_STEP
            print(offsets[target] * 180 / np.pi)

        return action

    def _cycle_attribute(self, direction: int) -> Callable[[], None]:
        def action() -> None:
            self.controlled_param_idx = (
                self.controlled_param_idx + direction
            ) % len(self.facemodel_param_names)
            print("Currently controlled face model parameter:",
                  self.current_attribute)

        return action

    def _build_dispatch(self) -> Dict[str, Callable[[], None]]:
        return {
            "a": self._nudge("pose", 0, -1), "d": self._nudge("pose", 0, +1),
            "w": self._nudge("pose", 1, -1), "s": self._nudge("pose", 1, +1),
            "q": self._nudge("pose", 2, -1), "e": self._nudge("pose", 2, +1),
            "i": self._nudge("gaze", 0, -1), "k": self._nudge("gaze", 0, +1),
            "u": self._nudge("gaze", 1, -1), "o": self._nudge("gaze", 1, +1),
            "j": self._nudge("gaze", 2, -1), "l": self._nudge("gaze", 2, +1),
            "z": self._cycle_attribute(-1), "c": self._cycle_attribute(+1),
            "n": self._turntable.toggle,
        }

    @property
    def current_attribute(self) -> str:
        return self.facemodel_param_names[self.controlled_param_idx]

    def handle_key(self, key: int, test_mode: bool = False) -> int:
        """Apply one key press; ``test_mode`` fires every action once (used
        by the demo's smoke-test path)."""
        if ord("A") <= key < ord("Z"):
            key += ord("a") - ord("A")
        if key == 27 or test_mode:
            self.exit = True
        for char, action in self._dispatch.items():
            if key == ord(char) or test_mode:
                action()
        return key

    @staticmethod
    def print_instructions() -> None:
        print("Esc - exits the app")
        print("W,S,A,D - control the head pose")
        print("I,K,J,L - control the gaze direction")
        print("N - toggle the pre-set illumination (HDRI) rotation sequence")
        print("Z, C - change the currently driven face model parameter (attribute)")
