"""The demo's render loop in plain form: one session of
``apps/confignet_demo.run_loop`` replayed on the reference's trees.

Per session the grid's photos are encoded once; each frame renders the
latent the glide shows (with the gaze spliced in) at the encoded poses plus
the pose offset, then the frame's key acts: an edit splices a new value of
the controlled attribute into the shown latent and glides to it over
``glide_frames`` frames; a nudge moves the pose or gaze offset by
``pose_step`` radians; a cycle changes the controlled attribute.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from benchmark.reference import model as ref

EYE = "bone_rotations:left_eye"


class Glide:
    """From the latent shown to a new target over ``n_frames`` frames."""

    def __init__(self, n_frames: int):
        self.rate = 1.0 / n_frames
        self.source: Optional[np.ndarray] = None
        self.target: Optional[np.ndarray] = None
        self.progress = 1.0

    def retarget(self, latent: np.ndarray) -> None:
        self.source = latent if self.target is None else self.value()
        self.target = latent
        self.progress = 0.0

    def advance(self) -> None:
        self.progress = min(self.progress + self.rate, 1.0)

    def value(self) -> np.ndarray:
        if self.progress >= 1.0:
            return self.target
        return self.source + self.progress * (self.target - self.source)


def demo_attributes(config: Dict[str, Any]) -> List[str]:
    """The attributes the demo cycles through, in its order (the gaze has
    keys of its own)."""
    return [name for name in config["facemodel_inputs"] if name != EYE]


@torch.no_grad()
def splice(trees, config: Dict[str, Any], latents: np.ndarray, name: str, value) -> np.ndarray:
    """``latents`` with ``name``'s encoding of the one row ``value``."""
    device = next(trees["synthetic_encoder"].parameters()).device
    value = torch.from_numpy(np.asarray(value, np.float32).reshape(1, -1)).to(device)
    encoded = trees["synthetic_encoder"].encode_single_param(name, value)
    out = np.copy(latents)
    out[:, ref.latent_slice(config, name)] = encoded.float().cpu().numpy()
    return out


@torch.no_grad()
def render_session(trees, config: Dict[str, Any], photos_u8: torch.Tensor, session,
                   glide_frames: int, pose_step: float, frames: Iterable[int]) -> Dict[int, np.ndarray]:
    """The uint8 renders of ``frames`` of ``session`` (traffic.Session)."""
    wanted = set(frames)
    latents, rotations = trees["real_encoder"](ref.unit_range(photos_u8))
    latents, rotations = latents.float().cpu().numpy(), rotations.float().cpu().numpy()
    names = demo_attributes(config)
    glide = Glide(glide_frames)
    glide.retarget(latents)
    pose, gaze, attribute = np.zeros((1, 3)), np.zeros((1, 3)), 0
    out: Dict[int, np.ndarray] = {}
    device = photos_u8.device
    for frame in range(max(wanted) + 1):
        if frame in wanted:
            shown = glide.value()
            if EYE in config["facemodel_inputs"]:
                shown = splice(trees, config, shown, EYE, gaze)
            poses = (rotations + pose).astype(np.float32)
            images = trees["generator_smoothed"](torch.from_numpy(shown.astype(np.float32)).to(device),
                                                 torch.from_numpy(poses).to(device))
            out[frame] = ref.to_uint8(images).cpu().numpy()
        glide.advance()
        kind, arg = session.events.get(frame, (None, None))
        if kind == "edit":
            glide.retarget(splice(trees, config, glide.value(), names[attribute], arg))
        elif kind in ("pose", "gaze"):
            (pose if kind == "pose" else gaze)[0, arg[0]] += arg[1] * pose_step
        elif kind == "cycle":
            attribute = (attribute + arg) % len(names)
    return out
