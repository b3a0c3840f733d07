"""Controllability metrics: the paper's Table-2 evaluation harness
(counterpart of ``confignet_tpu/metrics/controllability.py``).

Reference: confignet/metrics/metrics.py:15-199.  For each of the 8 attribute
configs: encode test images, splice the attribute's "set"/"other" value into
the latents through the synthetic encoder, generate both image sets, classify
them with the CelebA judge and compute

  (mean driven-attr prob when set, when unset,
   mean abs diff of the other attributes, correlation coefficient).

The aggregate is ``contr_attribute_means`` plus the scalar
``controllability = 10 * MAD + (1 - mean_set)``.

The renders go through the model's ``encode_images``, ``generate_images``
and (with ``per_image_tuning_iters``) ``fine_tune_on_img`` on its device;
the spliced latents through its synthetic encoder there.  The face-model
draws come from the global ``np.random`` in the JAX package's order.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from confignet_tpu_torch.metrics.blendshape_names import blendshape_names
from confignet_tpu_torch.metrics.celeba_attribute_prediction import CelebaAttributeClassifier
from confignet_tpu_torch.metrics.controllability_metric_configs import ControllabilityMetricConfigs

# Re-export, as the JAX module does (the reference's metrics module layout).
from confignet_tpu_torch.metrics.inception import InceptionMetrics  # noqa: F401


class ControllabilityMetrics:
    def __init__(self, confignet_model, attribute_classifier, per_image_tuning_iters: int = 0):
        self.confignet_model = confignet_model
        if isinstance(attribute_classifier, CelebaAttributeClassifier):
            self.attribute_classifier = attribute_classifier
        else:
            self.attribute_classifier = CelebaAttributeClassifier.load(
                attribute_classifier, device=getattr(confignet_model, "device", None))
        self.per_image_tuning_iters = per_image_tuning_iters
        if confignet_model is not None:
            self.facemodel_param_names = list(
                confignet_model.config["facemodel_inputs"].keys()
            )

    # ------------------------------------------------------------------

    def get_facemodel_params_for_config(self, attribute_config, other_param: bool):
        """One sampled facemodel-param set with the driven parameter forced
        to the config's set/other value (reference: metrics.py:29-50)."""
        facemodel_params = self.confignet_model.sample_facemodel_params(1)
        param_value = (
            attribute_config.facemodel_param_value_other
            if other_param
            else attribute_config.facemodel_param_value
        )
        param_idx = self.facemodel_param_names.index(attribute_config.facemodel_param_name)

        if isinstance(param_value, dict):
            if attribute_config.facemodel_param_name != "blendshape_values":
                raise NotImplementedError(
                    "dict-valued overrides only supported for blendshape_values"
                )
            facemodel_params[param_idx] = np.zeros_like(facemodel_params[param_idx])
            for key, value in param_value.items():
                facemodel_params[param_idx][:, blendshape_names.index(key)] = value
        else:
            facemodel_params[param_idx] = np.broadcast_to(
                np.asarray(param_value, np.float32), facemodel_params[param_idx].shape
            ).copy()
        return facemodel_params

    def get_images_for_controllable_attribute(
        self, attribute_config, latent_vectors, rotations, other_param: bool = False
    ) -> np.ndarray:
        """Splice the attribute's latent slice into every latent and decode
        (reference: metrics.py:52-66)."""
        model = self.confignet_model
        facemodel_params = self.get_facemodel_params_for_config(attribute_config, other_param)
        with torch.inference_mode():
            latent_with_attr = model.synthetic_encoder(
                [torch.from_numpy(np.asarray(p, np.float32)).to(model.device)
                 for p in facemodel_params]).float().cpu().numpy()

        param_idx = self.facemodel_param_names.index(attribute_config.facemodel_param_name)
        dims = list(model.config["facemodel_inputs"].values())
        start = int(sum(d[1] for d in dims[:param_idx]))
        end = start + dims[param_idx][1]

        modified = np.copy(latent_vectors)
        modified[:, start:end] = latent_with_attr[0, start:end]
        return model.generate_images(modified, rotations)

    # ------------------------------------------------------------------

    def generate_images_for_metric(self, input_images):
        model = self.confignet_model
        all_configs = ControllabilityMetricConfigs.all_configs()

        if self.per_image_tuning_iters > 0:
            raw_decoded = []
            with_attr = {name: [] for name, _ in all_configs}
            without_attr = {name: [] for name, _ in all_configs}
            for img in input_images:
                img = img[np.newaxis]
                latents, rotations = model.fine_tune_on_img(
                    img, n_iters=self.per_image_tuning_iters
                )
                raw_decoded.append(model.generate_images(latents, rotations)[0])
                for name, config in all_configs:
                    with_attr[name].append(
                        self.get_images_for_controllable_attribute(config, latents, rotations)[0]
                    )
                    without_attr[name].append(
                        self.get_images_for_controllable_attribute(
                            config, latents, rotations, other_param=True
                        )[0]
                    )
            raw_decoded = np.array(raw_decoded)
            with_attr = {k: np.array(v) for k, v in with_attr.items()}
            without_attr = {k: np.array(v) for k, v in without_attr.items()}
        else:
            latents, rotations = model.encode_images(input_images)
            raw_decoded = model.generate_images(latents, rotations)
            with_attr, without_attr = {}, {}
            for name, config in all_configs:
                with_attr[name] = self.get_images_for_controllable_attribute(
                    config, latents, rotations
                )
                without_attr[name] = self.get_images_for_controllable_attribute(
                    config, latents, rotations, other_param=True
                )
        return raw_decoded, with_attr, without_attr

    # ------------------------------------------------------------------

    def get_metrics_for_attribute_pairs(
        self, set_attributes, not_set_attributes, attribute_config
    ) -> Tuple[float, float, float, float]:
        attribute_names = self.attribute_classifier.config["predicted_attributes"]
        driven_idx = attribute_names.index(attribute_config.driven_attribute)
        changing = attribute_config.ignored_attributes + [attribute_config.driven_attribute]
        constant_idxs = [
            i for i, name in enumerate(attribute_names) if name not in changing
        ]

        mean_set = float(np.mean(set_attributes[:, driven_idx]))
        mean_other = float(np.mean(not_set_attributes[:, driven_idx]))

        n = len(set_attributes)
        labels = np.hstack((np.ones(n), np.zeros(n)))
        predictions = np.hstack(
            (set_attributes[:, driven_idx], not_set_attributes[:, driven_idx])
        )
        corr = np.corrcoef(np.vstack((labels, predictions)))[0, 1]

        mad = float(
            np.mean(
                np.mean(
                    np.abs(
                        set_attributes[:, constant_idxs]
                        - not_set_attributes[:, constant_idxs]
                    ),
                    axis=0,
                )
            )
        )
        return mean_set, mean_other, mad, float(corr)

    def get_metrics_from_attribute_images(self, with_attr, without_attr) -> Dict:
        metrics: Dict = {}
        for name, config in ControllabilityMetricConfigs.all_configs():
            set_probs = self.attribute_classifier.predict_attributes(with_attr[name])
            unset_probs = self.attribute_classifier.predict_attributes(without_attr[name])
            metrics[name] = self.get_metrics_for_attribute_pairs(set_probs, unset_probs, config)

        metrics["contr_attribute_means"] = tuple(
            np.mean([v for v in metrics.values()], axis=0)
        )
        metrics["controllability"] = float(
            10 * metrics["contr_attribute_means"][2]
            + (1 - metrics["contr_attribute_means"][0])
        )
        return metrics

    def get_metrics(self, input_images, img_output_dir=None) -> Dict:
        raw, with_attr, without_attr = self.generate_images_for_metric(input_images)
        if img_output_dir is not None:
            os.makedirs(img_output_dir, exist_ok=True)
            self._dump_images(img_output_dir, input_images, raw, with_attr, without_attr)
        return self.get_metrics_from_attribute_images(with_attr, without_attr)

    def _dump_images(self, out_dir, input_images, raw, with_attr, without_attr) -> None:
        import cv2

        for i in range(len(input_images)):
            cv2.imwrite(os.path.join(out_dir, "gt_img_%04d.png" % i), np.asarray(input_images[i]))
            cv2.imwrite(os.path.join(out_dir, "raw_img_%04d.png" % i), raw[i])
            for name, _ in ControllabilityMetricConfigs.all_configs():
                cv2.imwrite(
                    os.path.join(out_dir, "%s_img_%04d.png" % (name, i)), with_attr[name][i]
                )
                cv2.imwrite(
                    os.path.join(out_dir, "%s_img_not_set_%04d.png" % (name, i)),
                    without_attr[name][i],
                )

    def update_and_log_metrics(self, images, metrics_dict, output_dir,
                               aml_sink=None, tb_log_writer=None) -> None:
        os.makedirs(output_dir, exist_ok=True)
        new_metrics = self.get_metrics(images)

        for key, value in new_metrics.items():
            metrics_dict.setdefault(key, []).append(value)

        if aml_sink is not None:
            for key, value in new_metrics.items():
                aml_sink(key, value)
        if tb_log_writer is not None:
            step = metrics_dict.get("training_step_number", [0])[-1]
            for key, value in new_metrics.items():
                if isinstance(value, tuple):
                    prefix = (
                        "metrics/" if key == "contr_attribute_means"
                        else "contr_metrics_per_attribute/"
                    )
                    tb_log_writer.scalar(prefix + key + "_post", value[0], step)
                    tb_log_writer.scalar(prefix + key + "_pre", value[1], step)
                    tb_log_writer.scalar(prefix + key + "_other", value[2], step)
                else:
                    tb_log_writer.scalar("metrics/" + key, value, step)

        contr_only = {key: metrics_dict[key] for key in new_metrics.keys()}
        with open(os.path.join(output_dir, "controllability_metrics.json"), "w") as fp:
            json.dump(contr_only, fp, indent=4)
