"""Batch serving pipeline: encode -> splice -> generate on one GPU
(counterpart of ``confignet_tpu/serving.py``).

uint8 photos in, uint8 renders out; the attribute splice happens on the
device between the encoder and the generator, and the uint8 conversion of
the renders is done on the device too, so only 1 byte per pixel crosses back
to the host.  On the card each chunk runs as one captured CUDA graph per
call shape (``core/graphs.py``), as each chunk of the JAX server runs as one
jitted program, and a call's chunks are pipelined (``core/chunks.py``).
Over a data-parallel mesh (``parallel/mesh.py``) each rank renders its rows
of every chunk through its graph and the chunk is gathered back on every
rank; the scatter and the gather stay outside the graph.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from confignet_tpu_torch.core.chunks import run_chunked
from confignet_tpu_torch.core.device import resolve_device
from confignet_tpu_torch.core.graphs import GraphCache
from confignet_tpu_torch.models.backbones.resnet import fold_frozen_norms
from confignet_tpu_torch.parallel.mesh import replicate


class ConfigNetServer:
    """Serving front-end over a ConfigNet and, optionally, a LatentGAN
    (``training/latent_gan.py``) whose EMA generator samples the latents of
    :meth:`sample`, so faces render without a photo.

    ``chunk`` is the device batch: every request is cut into chunks of this
    size, the last one padded by repeating its last row.

    **Snapshot semantics**: the weights are deep-copied at construction, so
    training or fine-tuning the wrapped model afterwards does not change
    what the server renders.  :meth:`refresh` takes a new snapshot.  A
    snapshot serves only, so each frozen batch norm of its encoder's
    ResNet50 is folded into the float32 convolution before it
    (``fold_frozen_norms``): two elementwise passes fewer a convolution;
    the wrapped model keeps its norms.

    ``mesh``: a data-parallel mesh (one process per card, each building the
    server alike and making the same calls); the snapshot takes rank 0's
    weights, each rank renders its rows of every chunk, and every rank
    returns the full result.  The server runs on the mesh's device.  On the
    card each chunk (over a mesh, each rank's rows of it) is a replayed CUDA
    graph.
    """

    def __init__(self, confignet, latent_gan=None, chunk: int = 32,
                 device: Optional[Union[str, torch.device]] = None, mesh=None):
        self.confignet = confignet
        self.latent_gan = latent_gan
        self.chunk = int(chunk)
        self.mesh = mesh
        if mesh is not None:
            if self.chunk % mesh.size != 0:
                raise ValueError(f"chunk ({self.chunk}) must be divisible by the mesh size "
                                 f"({mesh.size}) so batches shard evenly")
            if device is not None:
                raise ValueError("a server over a mesh runs on the mesh's device; pass no device")
            device = mesh.device
        self.device = resolve_device(device)
        self._graphs = GraphCache(self.device)
        self.refresh()

    def refresh(self) -> None:
        """Re-snapshot the wrapped model's current weights (e.g. after
        further training or a fine-tune); the graphs of the old snapshot go."""
        model = self.confignet
        self._graphs.clear()

        def snap(module, fold_norms=False):
            module = copy.deepcopy(module).to(self.device).eval()
            if fold_norms:
                fold_frozen_norms(module.resnet)
            return module if self.mesh is None else replicate(self.mesh, module)

        self._encoder = snap(model.real_encoder, fold_norms=True)
        self._generator = snap(model._inference_generator())
        self._synthetic_encoder = snap(model.synthetic_encoder)

    # -- building blocks (run on the device) ----------------------------

    def _encode(self, images: torch.Tensor):
        if images.dtype.is_floating_point:
            floats = images.float()
        else:
            floats = images.float() / 127.5 - 1.0
        return self._encoder(floats)

    def _splice(self, latents: torch.Tensor, param_name: str, value: torch.Tensor) -> torch.Tensor:
        encoded = self._synthetic_encoder.encode_single_param(param_name, value)
        idxs = self.confignet.get_facemodel_param_idxs_in_latent(param_name)
        latents = latents.clone()
        latents[:, idxs.start:idxs.stop] = encoded.to(latents.dtype)
        return latents

    def _generate(self, latents: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
        out = self._generator(latents, rotations)
        return ((torch.clamp(out.float(), -1, 1) + 1) * 127.5).to(torch.uint8)

    # -- public API ------------------------------------------------------

    def _chunked(self, key, fn: Callable, arrays: Sequence[np.ndarray], extra=(),
                 modules: Sequence[torch.nn.Module] = ()):
        """``fn`` over the rows of ``arrays``, ``chunk`` at a time
        (``core/chunks.py``): each chunk a replay of the graph of ``key``
        (the pipeline's name and every Python value ``fn`` closes over, as
        the JAX server's jit cache is keyed) over ``modules``, the modules
        ``fn`` reads; ``extra`` tensors pass through whole.  Over a mesh,
        ``fn`` (the graph) runs on this rank's rows of each chunk, and its
        outputs are gathered from every rank outside it."""
        return run_chunked(self._graphs, key, fn, arrays, extra, modules, self.chunk, self.mesh)

    def encode(self, images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 (or [-1, 1] float) photos -> float32 (latents, rotations)."""
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[np.newaxis]
        return self._chunked("encode", self._encode, [images], modules=(self._encoder,))

    def generate(self, latents, rotations) -> np.ndarray:
        """Latents + rotations -> uint8 images."""
        return self._chunked("generate", self._generate, [np.asarray(latents, np.float32),
                                                          np.asarray(rotations, np.float32)],
                             modules=(self._generator,))

    def render_with_attribute(self, images, param_name: str, param_value,
                              rotations: Optional[np.ndarray] = None) -> np.ndarray:
        """Encode photos, splice one face-model attribute into the latents on
        the device, re-render.  ``param_value`` is one row (broadcast) or one
        row per image; ``rotations`` overrides the encoder's predicted pose."""
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[np.newaxis]
        value = np.asarray(param_value, np.float32)
        if value.ndim == 1:
            value = value[np.newaxis]
        if value.shape[0] not in (1, images.shape[0]):
            raise ValueError(
                f"param_value batch dim {value.shape[0]} must be 1 (broadcast) "
                f"or match the image batch {images.shape[0]}")
        # A per-image value batch is chunked alongside the images; a single
        # broadcast row rides through whole.
        per_image = value.shape[0] == images.shape[0] and images.shape[0] != 1
        chunked = [value] if per_image else []
        extra = () if per_image else (torch.from_numpy(value).to(self.device),)

        # the splice's param_name is part of the graph's key, as it is a
        # static argument of the JAX server's jit
        modules = (self._encoder, self._synthetic_encoder, self._generator)
        if rotations is None:
            def pipeline(imgs, value):
                latents, rots = self._encode(imgs)
                return self._generate(self._splice(latents, param_name, value), rots)

            return self._chunked(("render_with_attribute", param_name), pipeline,
                                 [images] + chunked, extra, modules)

        def pipeline_rot(imgs, rots, value):
            latents, _ = self._encode(imgs)
            return self._generate(self._splice(latents, param_name, value), rots)

        return self._chunked(("render_with_attribute_at_rotations", param_name), pipeline_rot,
                             [images, np.asarray(rotations, np.float32)] + chunked, extra, modules)

    def sample(self, n: int, rotations: Optional[np.ndarray] = None,
               truncation: float = 1.0) -> np.ndarray:
        """Photo-free sampling: ``n`` latents from the LatentGAN (its input
        noise from the global np.random, scaled by ``truncation``), rendered
        at ``rotations`` (zero pose when None) -> uint8 images."""
        if self.latent_gan is None:
            raise ValueError("ConfigNetServer was built without a LatentGAN")
        latents = self.latent_gan.generate_latents(n, truncation=truncation)
        if rotations is None:
            rotations = np.zeros((n, 3), np.float32)
        return self.generate(latents, rotations)

