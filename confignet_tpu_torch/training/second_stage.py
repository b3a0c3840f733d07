"""ConfigNet second stage (counterpart of
``confignet_tpu/training/second_stage.py``; reference:
confignet/confignet_second_stage.py).  On top of the first stage:

- the ResNet50 ``RealEncoder`` joins the generator player (generator, latent
  regressor, synthetic encoder and encoder under one Adam);
- a VGGFace perceptual loss (``perceptual_loss_face_reco``) is built, which
  only the fine-tune uses: the train step takes none, as the JAX package's
  takes none (second_stage.py:162-244 passes its weights but never reads
  them);
- the checkpoint files (``save``, ``load``, inherited) carry the
  ``real_encoder`` tree too, and ``ConfigNet.load`` returns a ``ConfigNet``;
- the train step (:meth:`ConfigNet._build_train_step`) autoencodes real
  images: the image discriminator sees hflipped real images against
  ``G(E(real))``, the latent discriminator encoder latents against
  synthetic-encoder latents, and the generator player takes image losses on
  both domains, the domain-adversarial latent loss and the
  variance-normalised latent regression;
- the one-shot fine-tune (:meth:`ConfigNet.fine_tune_on_img`) optimises a
  copy of the EMA generator, the split embedding (pre-expression /
  expression / post-expression) and the rotations against perceptual and
  GAN losses, one Adam step an iteration;
- the training loop (:meth:`ConfigNet.train`, second_stage.py:438-636) adds
  a validation set (the autoencoding panel and the metric images, which
  FID/KID score through the encoder), the controllability metric and the
  perceptual autoencoding metric (``image_metrics.txt``).

The training generator resamples with ``rotation_resample_train``: on CUDA
the kernels, whose transform gradient is zero as the JAX package's TPU
kernel's is, so the encoder's rotation head learns only through the latent
regression labels; on the CPU the gather form, which passes the full
gradient, as JAX on the CPU does.  The fine-tune differentiates the
rotations and so renders through the gather form on every device.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from confignet_tpu_torch.core import initializers
from confignet_tpu_torch.core.chunks import run_chunked
from confignet_tpu_torch.core.images import (
    batched_hflip, build_image_matrix, uint8_to_unit_range, unit_range_to_uint8, write_png)
from confignet_tpu_torch.core.model_io import export_jax_params
from confignet_tpu_torch.core.pretrained import backbone_path, maybe_load
from confignet_tpu_torch.core.tracing import span
from confignet_tpu_torch.losses.gan import eye_loss, gan_d_loss, gan_g_loss, normalized_latent_regression_loss
from confignet_tpu_torch.losses.perceptual import PerceptualLoss
from confignet_tpu_torch.models.backbones.loader import load_into, load_keras_h5_mapped
from confignet_tpu_torch.models.backbones.resnet import resnet50_keras_name_map
from confignet_tpu_torch.models.real_encoder import RealEncoder
from confignet_tpu_torch.parallel.mesh import (
    all_gather_rows, all_reduce_mean, process_slice, replicate, shard_batch)
from confignet_tpu_torch.runtime import gather_images, gather_rows
from confignet_tpu_torch.training.first_stage import PLAYER_TREES, Batch, ConfigNetFirstStage
from confignet_tpu_torch.training.state import make_fine_tune_adam


def _per_image_variables(n_imgs: int, mesh) -> Tuple[str, ...]:
    """The fine-tune variables sharded over a mesh: the per-image ones, when
    there are several images (second_stage.py:743-744)."""
    return ("expr", "rotations") if mesh is not None and n_imgs > 1 else ()


FineTuneStep = Callable[[torch.nn.Module, Dict[str, torch.Tensor], torch.optim.Optimizer, torch.Tensor],
                        Tuple[Dict[str, torch.Tensor], torch.Tensor]]


# the fine-tune's loss buffer holds at least this many iterations, so calls
# of up to the default 50 share one captured iteration
FINE_TUNE_LOSS_SLOTS = 64


class _FineTuneState:
    """What a fine-tune on a given image count keeps from call to call: the
    optimised variables, their Adam, the images, and a loss buffer written
    on the device at a device-side index (one entry an iteration), all
    reset in place at each call."""

    def __init__(self, generator: torch.nn.Module, variables: Dict[str, torch.Tensor],
                 optimizer: torch.optim.Optimizer, images: torch.Tensor, n_iters: int):
        self.generator = generator
        self.variables = variables
        self.optimizer = optimizer
        self.images = images
        self.losses = torch.full((max(n_iters, FINE_TUNE_LOSS_SLOTS),), float("nan"),
                                 device=images.device)
        self.index = torch.zeros((1,), dtype=torch.long, device=images.device)

    @torch.no_grad()
    def load(self, variables: Dict[str, torch.Tensor], images: np.ndarray) -> None:
        """Start a call: the new values in place, the Adam moments and step
        counts zeroed (a fresh Adam's state), the loss index at 0."""
        for name, value in variables.items():
            self.variables[name].copy_(value)
        self.images.copy_(torch.from_numpy(images))
        for param_state in self.optimizer.state.values():
            for value in param_state.values():
                if torch.is_tensor(value):
                    value.zero_()
        self.losses.fill_(float("nan"))
        self.index.zero_()

    @torch.no_grad()
    def record(self, loss: torch.Tensor) -> None:
        """The iteration's loss at the device-side index, then the index on."""
        self.losses.index_copy_(0, self.index, loss.detach().float().reshape(1))
        self.index.add_(1)


class ConfigNet(ConfigNetFirstStage):
    MODEL_TYPE = "ConfigNet"
    WEIGHT_TREES = ConfigNetFirstStage.WEIGHT_TREES + ("real_encoder",)
    # the encoder is trained jointly in the G step (confignet_second_stage.py:213-214)
    PLAYER_TREES = {**PLAYER_TREES, "generator": PLAYER_TREES["generator"] + ("real_encoder",)}

    def __init__(self, config: Dict[str, Any], device: Optional[Union[str, torch.device]] = None,
                 initialize: bool = True):
        self._fine_tune_step_cache: Dict[Tuple[bool, int, Any], FineTuneStep] = {}
        self._fine_tune_states: Dict[Tuple[bool, int], _FineTuneState] = {}
        self._generator_ft: Optional[torch.nn.Module] = None
        # the loss sums of the last fine_tune_on_img call, 0-d tensors on the device
        self.fine_tune_losses = []
        # the ControllabilityMetrics that setup_training makes from a judge
        self.controllability_metrics = None
        super().__init__(config, device=device, initialize=initialize)
        self.config["model_type"] = self.MODEL_TYPE

    def _build_modules(self) -> None:
        super()._build_modules()
        cfg = self.config
        self.real_encoder = RealEncoder(
            latent_dim=cfg["latent_dim"],
            rotation_ranges=tuple(tuple(r) for r in cfg["rotation_ranges"]),
            dtype=self.compute_dtype, trunk_norm=cfg.get("encoder_norm", "frozen"))
        self.perceptual_loss_face_reco = PerceptualLoss("VGGFace", taps=cfg.get("perceptual_taps"))
        maybe_load(self.perceptual_loss_face_reco.load_keras_weights, cfg.get("backbones_dir"),
                   "vggface")

    def initialize_network(self) -> None:
        """The first stage's init, then the encoder's, its ResNet50 trunk
        from ``resnet50_notop.h5`` where ``backbones_dir`` has it (the
        reference encoder starts from the ImageNet ResNet50,
        real_encoder.py:13)."""
        super().initialize_network()
        rng = torch.Generator().manual_seed(int(self.config.get("seed", 0)) + 1)
        initializers.initialize(self.real_encoder, rng)
        resnet_h5 = backbone_path(self.config.get("backbones_dir"), "resnet50")
        if resnet_h5 is None:
            return
        if self.config.get("encoder_norm", "frozen") != "frozen":
            raise ValueError("encoder_norm != 'frozen' uses GroupNorm trees; the Keras ResNet50 "
                             "import targets FrozenBatchNorm params. Use the default encoder_norm "
                             "with pretrained backbones.")
        try:
            load_into(self.real_encoder.resnet,
                      lambda flat: load_keras_h5_mapped(flat, resnet_h5, resnet50_keras_name_map()))
        except ValueError:
            load_into(self.real_encoder.resnet, lambda flat: load_keras_h5_mapped(
                flat, resnet_h5, resnet50_keras_name_map(legacy=True)))
        print(f"Loaded pretrained resnet50 encoder trunk from {resnet_h5}")

    def _to_device(self) -> None:
        super()._to_device()
        self.perceptual_loss_face_reco.to(self.device)

    def set_weights(self, weights: Dict[str, Dict[str, np.ndarray]]) -> None:
        """Full ConfigNet weights, or stage-1 weights without a
        ``real_encoder`` tree, in which case the current encoder is kept (the
        stage-1 -> stage-2 transfer, reference train_confignet.py:69).  Every
        stage-1 tree must be present; the optimizer states are reset."""
        if "real_encoder" not in weights:
            weights = {**weights, "real_encoder": export_jax_params(self.real_encoder)}
        super().set_weights(weights)

    # ------------------------------------------------------------------
    # The stage-2 train step: the first stage's step with these parts
    # ------------------------------------------------------------------

    def _image_d_fakes(self, b: Batch, batch_size: int) -> torch.Tensor:
        """G(E(d_input_imgs)), without gradient."""
        with torch.no_grad():
            latents, rotations = self.real_encoder(self._to_unit_range(b["d_input_imgs"]))
            return self.generator(latents, rotations)

    def _latent_d_reals(self, b: Batch, batch_size: int) -> torch.Tensor:
        """Encoder latents of hflipped real images, without gradient."""
        imgs = batched_hflip(self._to_unit_range(b["latent_d_real_imgs"]),
                             self._draw(self._flip_mask, batch_size))
        with torch.no_grad():
            return self.real_encoder(imgs)[0]

    def _generator_losses(self, gb: Batch, batch_size: int) -> Dict[str, torch.Tensor]:
        """The generator player's losses (second_stage.py:162-244)."""
        cfg = self.config
        w_img = cfg["image_loss_weight"]
        w_pix = cfg.get("pixel_loss_weight", 0.0)
        w_inv = cfg.get("encoder_inversion_weight", 0.0)
        w_reg = cfg["latent_regression_weight"]
        losses: Dict[str, torch.Tensor] = {}
        synth_latents = self.synthetic_encoder(gb["g_facemodel"])
        out_synth = self.generator(synth_latents, gb["g_rotations"])

        real_imgs = batched_hflip(self._to_unit_range(gb["g_real_imgs"]),
                                  self._draw(self._flip_mask, gb["g_real_imgs"].shape[0]))
        real_latents, real_rotations = self.real_encoder(real_imgs)
        out_real = self.generator(real_latents, real_rotations)

        gt_synth = self._to_unit_range(gb["g_gt_imgs"])
        losses["image_loss_synth"] = w_img * self.perceptual_loss.loss_fn(gt_synth, out_synth)
        losses["image_loss_real"] = w_img * self.perceptual_loss.loss_fn(real_imgs, out_real)
        if w_pix > 0.0:
            # pixel L1 on the synthetic pair only (second_stage.py:186-195)
            losses["pixel_loss_synth"] = w_pix * (gt_synth - out_synth).abs().mean()
        if w_inv > 0.0:
            # the encoder alone learns to invert: the render goes through
            # the generator with its parameters detached (second_stage.py:196-208)
            frozen = {name: p.detach() for name, p in self.generator.named_parameters()}
            out_real_frozen = torch.func.functional_call(self.generator, frozen,
                                                         (real_latents, real_rotations))
            losses["encoder_inversion_loss"] = w_inv * (real_imgs - out_real_frozen).abs().mean()
        losses["eye_loss"] = cfg["eye_loss_weight"] * eye_loss(gt_synth, out_synth, gb["g_eye_masks"])

        for i, head in enumerate(self.synth_discriminator(out_synth).values()):
            losses[f"GAN_loss_synth_{i}"] = gan_g_loss(head)
        for i, head in enumerate(self.discriminator(out_real).values()):
            losses[f"GAN_loss_real_{i}"] = gan_g_loss(head)

        # domain-adversarial: labels real -> 0, synth -> 1
        # (confignet_second_stage.py:160-199)
        ld_out_real = self.latent_discriminator(real_latents)
        ld_out_synth = self.latent_discriminator(synth_latents)
        ld_out = torch.cat([ld_out_real, ld_out_synth], dim=0)
        labels = torch.cat([torch.zeros_like(ld_out_real), torch.ones_like(ld_out_synth)], dim=0)
        losses["latent_GAN_loss"] = cfg["domain_adverserial_loss_weight"] * gan_d_loss(labels, ld_out)

        if w_reg > 0.0:
            stacked_latents = torch.cat([synth_latents, real_latents], dim=0)
            stacked_outputs = torch.cat([out_synth, out_real], dim=0)
            stacked_rotations = torch.cat([gb["g_rotations"], real_rotations], dim=0)
            labels = torch.cat([stacked_latents,
                                cfg["latent_regressor_rot_weight"] * stacked_rotations], dim=-1)
            losses["latent_regression_loss"] = normalized_latent_regression_loss(
                self.latent_regressor(stacked_outputs), labels, w_reg, mesh=self.mesh)
        losses["loss_sum"] = sum(losses.values())
        return losses

    def _sample_host_batch_single(self, real_training_set, synth_training_set,
                                  d_fields: bool = True, g_fields: bool = True) -> Batch:
        """One stage-2 host batch, drawn from ``self._batch_rng`` in the JAX
        package's order (second_stage.py:376-432) and gathered by the native
        runtime, as JAX's is.  Over a mesh every rank draws the same global
        index arrays and gathers only its own rows of them."""
        rng = self._batch_rng
        batch_size = self.config["batch_size"]
        n_synth = batch_size // 2
        n_real = batch_size - n_synth
        n_real_imgs, n_synth_imgs = real_training_set.imgs.shape[0], synth_training_set.imgs.shape[0]
        real, synth = real_training_set.imgs, synth_training_set.imgs
        rotations = synth_training_set.metadata_inputs["rotations"]
        batch: Batch = {}
        if d_fields:
            rows = process_slice(batch_size, self.mesh)
            d_real_idx = rng.randint(0, n_real_imgs, batch_size)[rows]
            d_input_idx = rng.randint(0, n_real_imgs, batch_size)[rows]
            sd_idx = rng.randint(0, n_synth_imgs, batch_size)[rows]
            sd_fm_idx = rng.randint(0, n_synth_imgs, batch_size)[rows]
            ld_real_idx = rng.randint(0, n_real_imgs, batch_size)[rows]
            ld_fm_idx = rng.randint(0, n_synth_imgs, batch_size)[rows]
            batch.update({
                "d_real_imgs": gather_images(real, d_real_idx),
                "d_input_imgs": gather_images(real, d_input_idx),
                "synth_d_real_imgs": gather_images(synth, sd_idx),
                "synth_d_facemodel": self._facemodel_batch(synth_training_set, sd_fm_idx),
                "synth_d_rotations": np.ascontiguousarray(rotations[sd_fm_idx], dtype=np.float32),
                "latent_d_real_imgs": gather_images(real, ld_real_idx),
                "latent_d_facemodel": self._facemodel_batch(synth_training_set, ld_fm_idx),
            })
        if g_fields:
            g_idx = rng.randint(0, n_synth_imgs, n_synth)[process_slice(n_synth, self.mesh)]
            g_real_idx = rng.randint(0, n_real_imgs, n_real)[process_slice(n_real, self.mesh)]
            batch.update({
                "g_facemodel": self._facemodel_batch(synth_training_set, g_idx),
                "g_rotations": np.ascontiguousarray(rotations[g_idx], dtype=np.float32),
                "g_gt_imgs": gather_images(synth, g_idx),
                "g_eye_masks": gather_rows(np.asarray(synth_training_set.eye_masks), g_idx),
                "g_real_imgs": gather_images(real, g_real_idx),
            })
        return batch

    # ------------------------------------------------------------------
    # The training loop (second_stage.py:438-636): the first stage's loop
    # with a validation set, the controllability metric and the perceptual
    # autoencoding metric
    # ------------------------------------------------------------------

    def setup_training(self, log_dir, synth_training_set, n_samples_for_metrics,
                       attribute_classifier=None, real_training_set=None,
                       validation_set=None, mesh=None) -> None:
        """The first stage's setup, then (from the global ``np.random``) the
        validation images of the autoencoding panel and of the metrics, and
        a ``ControllabilityMetrics`` from ``attribute_classifier`` (a
        ``CelebaAttributeClassifier`` or the path of one's json)."""
        super().setup_training(log_dir, synth_training_set, n_samples_for_metrics,
                               real_training_set=real_training_set, mesh=mesh)
        if validation_set is not None:
            viz_idx = np.random.randint(0, validation_set.imgs.shape[0], self.n_checkpoint_samples)
            self._checkpoint_visualization_input["input_images"] = uint8_to_unit_range(
                validation_set.imgs[viz_idx])
            metric_idx = np.random.randint(0, validation_set.imgs.shape[0], n_samples_for_metrics)
            self._generator_input_for_metrics["input_images"] = uint8_to_unit_range(
                validation_set.imgs[metric_idx])
        if attribute_classifier is not None:
            from confignet_tpu_torch.metrics.controllability import ControllabilityMetrics

            self.controllability_metrics = ControllabilityMetrics(self, attribute_classifier)

    def train(self, real_training_set, synth_training_set, validation_set=None,
              attribute_classifier=None, output_dir=None, log_dir=None,
              n_steps=100000, n_samples_for_metrics=1000, aml_run=None,
              mesh=None) -> Dict[str, float]:
        """Train from :meth:`get_resume_step` to ``n_steps``; returns
        ``{"loop_seconds", "steps_run"}`` (see ``ConfigNetFirstStage.train``)."""
        self.setup_training(log_dir, synth_training_set, n_samples_for_metrics,
                            attribute_classifier=attribute_classifier,
                            real_training_set=real_training_set, validation_set=validation_set,
                            mesh=mesh)
        return self._run_training(real_training_set, synth_training_set, output_dir, n_steps,
                                  aml_run)

    def image_checkpoint(self, output_dir: Optional[str], step_number: Optional[int] = None) -> None:
        """The synthetic-data panel, then ``output_imgs/<step>.png``: the
        validation images, their autoencodings at the predicted pose, and at
        six yaws."""
        if step_number is None:
            step_number = self.get_training_step_number()
        self.synth_data_image_checkpoint(output_dir, step_number=step_number)
        viz = self._checkpoint_visualization_input
        if "input_images" not in viz:
            return
        gt_imgs = viz["input_images"]
        latent, pred_rotation = self.encode_images(gt_imgs)
        imgs_pred_rot = self.generate_images(latent, pred_rotation)
        imgs_sweep = self.generate_images(np.vstack([latent] * self.n_checkpoint_rotations),
                                          viz["rotation"])
        combined = np.vstack((unit_range_to_uint8(gt_imgs), imgs_pred_rot, imgs_sweep))
        matrix = build_image_matrix(combined, self.n_checkpoint_rotations + 2,
                                    self.n_checkpoint_samples)
        self._save_panel(output_dir, str(step_number).zfill(6) + ".png", matrix,
                         "generated_images", step_number)

    def generate_output_for_metrics(self) -> np.ndarray:
        imgs = self._generator_input_for_metrics.get("input_images")
        if imgs is None:
            return super().generate_output_for_metrics()
        return self.generate_images(*self.encode_images(imgs))

    def _metric_latents_and_rotations(self):
        """FID/KID score the autoencoded metric images in stage 2 (reference:
        confignet_second_stage.py:220-266)."""
        imgs = self._generator_input_for_metrics.get("input_images")
        if imgs is None:
            return super()._metric_latents_and_rotations()
        return self.encode_images(imgs)

    def calculate_metrics(self, output_dir: Optional[str], step_number: Optional[int] = None) -> None:
        """KID/FID, then on the validation images the controllability metric
        and the perceptual autoencoding loss (chunks of 16, their mean
        appended to ``metrics["perceptual_loss"]`` and ``image_metrics.txt``;
        confignet_second_stage.py:226-253)."""
        if step_number is None:
            step_number = self.get_training_step_number()
        super().calculate_metrics(output_dir, step_number=step_number)
        input_images = (self._generator_input_for_metrics.get("input_images")
                        if self._generator_input_for_metrics else None)
        if input_images is None:
            return
        if self.controllability_metrics is not None:
            self.controllability_metrics.update_and_log_metrics(
                input_images, self.metrics, output_dir, self.aml_sink, self.log_writer)

        generated = self.generate_images(*self.encode_images(input_images))
        generated_f = uint8_to_unit_range(generated)
        chunk = 16
        losses = []
        with torch.inference_mode():
            for start in range(0, len(input_images), chunk):
                gt = torch.from_numpy(np.ascontiguousarray(input_images[start:start + chunk]))
                gen = torch.from_numpy(generated_f[start:start + chunk])
                losses.append(self.perceptual_loss.loss_fn(gt.to(self.device), gen.to(self.device)))
            perceptual = float(np.mean(torch.stack(losses).float().cpu().tolist()))
        self.metrics.setdefault("perceptual_loss", []).append(perceptual)
        if self.log_writer is not None:
            self.log_writer.scalar("metrics/perceptual_loss", perceptual, step_number)
        if output_dir is not None:
            np.savetxt(os.path.join(output_dir, "image_metrics.txt"),
                       self.metrics["perceptual_loss"])

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------

    def _inference_real_encoder(self) -> RealEncoder:
        """The encoder of a checkpoint job's snapshot while one runs, else
        the live one."""
        if self._inference_params_override is not None:
            return self._inference_params_override["real_encoder"]
        return self.real_encoder

    def encode_images(self, input_images, batch_chunk: int = 32) -> Tuple[np.ndarray, np.ndarray]:
        """Images (uint8 or [-1, 1] float) -> float32 (latents, rotations)."""
        with span("confignet.io.inputs"):
            input_images = np.asarray(input_images)
            if input_images.dtype == np.uint8:
                input_images = input_images.astype(np.float32) / 127.5 - 1.0
            input_images = input_images.astype(np.float32)
            if input_images.ndim == 3:
                input_images = input_images[np.newaxis]

        encoder = self._inference_real_encoder()
        return run_chunked(self._inference_graphs(), "encode_images", encoder, (input_images,),
                           modules=(encoder,), chunk=min(batch_chunk, input_images.shape[0]))

    # ------------------------------------------------------------------
    # One-shot fine-tuning (reference: confignet_second_stage.py:321-403)
    # ------------------------------------------------------------------

    def fine_tune_on_img(self, input_images, n_iters: int = 50, img_output_dir: Optional[str] = None,
                         force_neutral_expression: bool = False,
                         mesh=None) -> Tuple[np.ndarray, np.ndarray]:
        """Fine-tune a copy of the EMA generator, the embedding and the
        rotations on one or more photos (uint8 or [-1, 1] float) for
        ``n_iters`` Adam steps; afterwards ``generate_images`` renders with
        the fine-tuned generator.  Returns float32 (embeddings, rotations).
        ``img_output_dir`` receives ``gt_img.png`` and one render an
        iteration.  The per-iteration loss sums stay in
        :attr:`fine_tune_losses` (0-d tensors on the device; over a mesh,
        this rank's images').

        Without a mesh the variables, the Adam state, the images and the
        losses live in buffers kept per (``force_neutral_expression``, image
        count) and reset in place at each call, and on the card every
        iteration after the first is a replay of one captured CUDA graph,
        as every iteration of the JAX fine-tune is one jitted step; the
        first runs eagerly and builds the Adam state the graph then holds.
        No iteration waits for the host unless ``img_output_dir`` is set.

        ``mesh``: a data-parallel mesh (``parallel/mesh.py``); every rank
        passes the same images and fine-tunes on its rows of them, with
        ``expr`` and ``rotations`` sharded alike when there are several
        images and the generator copy, ``pre_expr`` and ``post_expr``
        replicated (second_stage.py:731-752).  Only rank 0 writes images;
        the printed losses are the global batch's, and every rank returns
        the full result.  The mesh's gradient all-reduce cannot be captured
        over gloo, so this path runs eagerly."""
        input_images = np.asarray(input_images)
        if input_images.dtype == np.uint8:
            input_images = input_images / 127.5 - 1.0
        input_images = input_images.astype(np.float32)
        if input_images.ndim == 3:
            input_images = input_images[np.newaxis]
        n_imgs = input_images.shape[0]
        if mesh is not None:
            self._check_mesh_device(mesh)
            if n_imgs % mesh.size != 0:
                raise ValueError(f"fine-tune batch {n_imgs} must divide over {mesh.size} devices")

        embeddings, rotations = self.encode_images(input_images)
        generator = self._fine_tune_generator()
        step = self._get_fine_tune_step(force_neutral_expression, n_imgs, mesh)
        writes = mesh is None or mesh.rank == 0  # rank 0 holds the first image
        if img_output_dir is not None and writes:
            os.makedirs(img_output_dir, exist_ok=True)
            write_png(os.path.join(img_output_dir, "gt_img.png"),
                      unit_range_to_uint8(input_images)[0])

        def write(step_number: int, loss: float, out: torch.Tensor) -> None:
            print(loss)
            if writes:
                write_png(os.path.join(img_output_dir, "output_%02d.png" % step_number),
                          unit_range_to_uint8(out.float().cpu().numpy())[0])

        values = self._fine_tune_variables(embeddings, rotations, force_neutral_expression)
        per_image = _per_image_variables(n_imgs, mesh)
        if per_image:
            rows = process_slice(n_imgs, mesh)
            values = {k: v.detach()[rows].clone().requires_grad_(True) if k in per_image else v
                      for k, v in values.items()}
        if mesh is None:
            state = self._fine_tune_state(force_neutral_expression, values, input_images.shape,
                                          n_iters)
            state.load(values, input_images)
        else:  # nothing captured holds its addresses: built anew at each call
            replicate(mesh, generator)
            replicate(mesh, [v for k, v in values.items() if k not in per_image])
            optimizer = self._fine_tune_optimizer(generator, values, force_neutral_expression)
            state = _FineTuneState(generator, values, optimizer, shard_batch(mesh, input_images),
                                   n_iters)
        variables = state.variables

        def iteration() -> torch.Tensor:
            losses, out = step(generator, variables, state.optimizer, state.images)
            state.record(losses["loss_sum"])
            return out

        captured = mesh is None and self._graphs.active
        key = self._fine_tune_graph_key(force_neutral_expression, n_imgs) if captured else None
        for step_number in range(n_iters):
            if not captured:
                out = iteration()
            elif step_number == 0:
                out = self._graphs.run_on_capture_stream(iteration)
            else:
                if not self._graphs.captured(key):
                    self._graphs.capture(key, iteration, modules=self._fine_tune_modules())
                out = self._graphs.replay(key)
            if img_output_dir is not None:
                write(step_number, self._global_mean(state.losses[step_number], mesh), out)
        self.fine_tune_losses = list(state.losses[:n_iters].clone())
        if n_iters > 0:
            print("fine-tune final loss: %f" % self._global_mean(self.fine_tune_losses[-1], mesh))

        self._fine_tuned_generator_params = {k: v.detach().clone()
                                             for k, v in generator.state_dict().items()}
        with torch.no_grad():
            variables = {k: all_gather_rows(mesh, v.detach()) if k in per_image else v
                         for k, v in variables.items()}
            embeddings = self._fine_tune_embeddings(variables, n_imgs)
            rotations = variables["rotations"].detach().float().clone()  # the buffer is reused
        return embeddings.float().cpu().numpy(), rotations.cpu().numpy()

    @staticmethod
    def _global_mean(loss: torch.Tensor, mesh) -> float:
        return float(all_reduce_mean(mesh, [loss.detach().float().clone()])[0])

    def _fine_tune_graph_key(self, force_neutral: bool, n_imgs: int) -> tuple:
        """The graph cache's key of one fine-tune iteration on ``n_imgs``
        photos (no mesh)."""
        return self._graphs.key(("fine_tune", force_neutral, n_imgs), self._fine_tune_modules())

    def _fine_tune_modules(self) -> Tuple[torch.nn.Module, ...]:
        """Every module a fine-tune iteration reads."""
        return (self._generator_ft, self.perceptual_loss, self.perceptual_loss_face_reco,
                self.discriminator, self.latent_discriminator, self.latent_regressor)

    def _fine_tune_state(self, force_neutral: bool, variables: Dict[str, torch.Tensor],
                         images_shape: Tuple[int, ...], n_iters: int) -> "_FineTuneState":
        """The buffers of the fine-tune on images of ``images_shape``, built
        at the first call (around that call's ``variables``) and kept, so
        that a captured iteration's addresses stay valid.  A call of more
        iterations than the loss buffer holds, or a new fine-tune generator,
        builds them anew and drops the graph."""
        key = (force_neutral, images_shape[0])
        state = self._fine_tune_states.get(key)
        if (state is None or state.losses.shape[0] < n_iters or state.generator is not self._generator_ft
                or state.images.shape != images_shape):
            self._graphs.discard(("fine_tune",) + key)
            optimizer = self._fine_tune_optimizer(self._generator_ft, variables, force_neutral)
            state = _FineTuneState(self._generator_ft, variables, optimizer,
                                   torch.zeros(images_shape, device=self.device), n_iters)
            self._fine_tune_states[key] = state
        return state

    def _fine_tune_variables(self, embeddings: np.ndarray, rotations: np.ndarray,
                             force_neutral_expression: bool) -> Dict[str, torch.Tensor]:
        """The optimised embedding, split around the expression slice (the
        segments before and after it shared by all images, their mean), and
        the rotations, as leaf tensors on the device."""
        if force_neutral_expression:
            n_blend = self.config["facemodel_inputs"]["blendshape_values"][0]
            embeddings = self.set_facemodel_param_in_latents(
                embeddings, "blendshape_values", np.zeros((1, n_blend), np.float32))
        expr_idxs = self.get_facemodel_param_idxs_in_latent("blendshape_values")
        expr_start, expr_stop = expr_idxs[0], expr_idxs[-1] + 1
        mean_embedding = np.mean(embeddings, axis=0, keepdims=True)
        variables = {"pre_expr": mean_embedding[:, :expr_start],
                     "expr": embeddings[:, expr_start:expr_stop],
                     "post_expr": mean_embedding[:, expr_stop:],
                     "rotations": rotations}
        return {k: torch.tensor(np.asarray(v, np.float32), device=self.device).requires_grad_(True)
                for k, v in variables.items()}

    def _fine_tune_generator(self) -> torch.nn.Module:
        """The fine-tune view of the EMA generator (first_stage.py:288,
        352-355): the gather resample, differentiable in the rotations, and
        the configured AdaIN.  Built once; each call loads a copy of
        generator_smoothed's weights into it, so it never aliases the EMA."""
        if self._generator_ft is None:
            self._generator_ft = self._generator("gather").to(self.device).eval()
        self._generator_ft.load_state_dict(self.generator_smoothed.state_dict())
        return self._generator_ft

    @staticmethod
    def _fine_tune_optimizer(generator: torch.nn.Module, variables: Dict[str, torch.Tensor],
                             force_neutral_expression: bool) -> torch.optim.Optimizer:
        """A fresh Adam over the generator copy and the variables; with a
        forced neutral expression the ``expr`` segment is left out, which is
        optax's ``multi_transform`` with ``set_to_zero`` (second_stage.py:714-720).
        It keeps its step counts on the device, so an Adam step can be
        captured."""
        frozen = ("expr",) if force_neutral_expression else ()
        params = list(generator.parameters()) + [v for k, v in variables.items() if k not in frozen]
        return make_fine_tune_adam(params)

    @staticmethod
    def _fine_tune_embeddings(variables: Dict[str, torch.Tensor], n_imgs: int) -> torch.Tensor:
        return torch.cat([variables["pre_expr"].expand(n_imgs, -1), variables["expr"],
                          variables["post_expr"].expand(n_imgs, -1)], dim=1)

    def _get_fine_tune_step(self, force_neutral: bool, n_imgs: int, mesh=None) -> FineTuneStep:
        """``step(generator, variables, optimizer, images) -> (losses, out)``:
        the fine-tune loss (second_stage.py:797-852) and one Adam step on
        the gradient with respect to the optimised tensors only.  Cached per
        (force_neutral, n_imgs, mesh), as the JAX package caches its compiled
        step.

        Over a mesh, ``n_imgs`` is the global image count and the step sees
        this rank's rows.  Every loss term is a mean over equal shards of
        per-image values (the perceptual losses: of equal-size activations)
        except the latent regression, whose batch statistics are summed over
        the ranks; so the global loss is the mean of the ranks' losses.  Its
        gradient is, for a replicated tensor, the mean of the ranks'
        gradients, and for a sharded per-image tensor this rank's gradient
        over ``mesh.size``, with no reduction."""
        cache_key = (force_neutral, n_imgs, mesh)
        if cache_key in self._fine_tune_step_cache:
            return self._fine_tune_step_cache[cache_key]
        cfg = self.config
        w_img = cfg["image_loss_weight"]
        w_dom = cfg["domain_adverserial_loss_weight"]
        w_rot = cfg["latent_regressor_rot_weight"]
        w_reg = cfg["latent_regression_weight"]
        n_rows = n_imgs if mesh is None else n_imgs // mesh.size
        per_image = _per_image_variables(n_imgs, mesh)

        def step(generator, variables, optimizer, images):
            embeddings = self._fine_tune_embeddings(variables, n_rows)
            out = generator(embeddings, variables["rotations"])
            losses: Dict[str, torch.Tensor] = {}
            losses["image_loss_real"] = 0.5 * w_img * self.perceptual_loss.loss_fn(images, out)
            losses["face_reco_loss"] = 0.5 * w_img * self.perceptual_loss_face_reco.loss_fn(out, images)
            for i, head in enumerate(self.discriminator(out).values()):
                losses[f"GAN_loss_real_{i}"] = gan_g_loss(head)
            losses["latent_GAN_loss"] = w_dom * gan_d_loss(1.0, self.latent_discriminator(embeddings))
            labels = torch.cat([embeddings, w_rot * variables["rotations"]], dim=-1)
            losses["latent_regression_loss"] = normalized_latent_regression_loss(
                self.latent_regressor(out), labels, w_reg, mesh=mesh)
            losses["loss_sum"] = sum(losses.values())

            params = [p for group in optimizer.param_groups for p in group["params"]]
            grads = torch.autograd.grad(losses["loss_sum"], params, allow_unused=True,
                                        materialize_grads=True)
            if mesh is not None:
                sharded = {id(variables[k]) for k in per_image}
                all_reduce_mean(mesh, [g for p, g in zip(params, grads) if id(p) not in sharded])
                for p, g in zip(params, grads):
                    if id(p) in sharded:
                        g.div_(mesh.size)
            for p, g in zip(params, grads):
                p.grad = g
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            return {k: v.detach() for k, v in losses.items()}, out.detach()

        self._fine_tune_step_cache[cache_key] = step
        return step
