"""Pipeline orchestrator: config -> feature generation (-t) -> training (-T)
-> `.nww` export -> distillation of the lite gate (-d), on one torch device.

The counterpart of `nanowakeword_tpu/trainer.py` for the stages the port
has: hardware auto-config merge, the project directory layout
(`features/`, `training_artifacts/`, `model/`), the manifest-driven
transform stage, dataset/sampler construction, training (the host loop by
default, the device-cached loop with `device_cache: {enabled: true}`), the
artifact export, distillation (after training, where `distillation.enabled`
defaults to true, or standalone from the exported `.nww`), and the training
journal. `run_pipeline` takes the config as a dict; the command line
(`train`) wraps it and is the only place that reads YAML. Clip generation
(-G), end-to-end training and ONNX export are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import os
import time
from types import SimpleNamespace
from typing import Optional

from nanowakeword_tpu_torch.config.generator import ConfigGenerator
from nanowakeword_tpu_torch.config.proxy import ConfigProxy, deep_merge
from nanowakeword_tpu_torch.data.dataset import (AdaptiveLossAwareDataset,
                                                 DynamicClassAwareSampler,
                                                 ValidationDataset)
from nanowakeword_tpu_torch.utils.logger import (print_banner, print_info,
                                                 print_step_header)

SEED = 10


def _build_training_data(config, manifest):
    dataset = AdaptiveLossAwareDataset(feature_manifests=manifest)
    if len(dataset) == 0:
        raise ValueError("CRITICAL: Dataset is empty. Check your feature "
                         "file paths in the manifest.")
    composition = config.get("batch_composition")
    if not composition:
        composition = {"targets": 30, "negatives": 230}
        print_info(f"'batch_composition' not found in config. Using a "
                   f"default balanced composition: {composition}")
    elif hasattr(composition, "to_dict"):
        composition = composition.to_dict()
    sampler = DynamicClassAwareSampler(dataset=dataset,
                                       batch_composition=composition,
                                       feature_manifests=manifest, seed=SEED)
    return dataset, sampler


def _validation_data(full_manifest):
    val_manifest = {cat.replace("_val", ""): paths
                    for cat, paths in full_manifest.items()
                    if cat.endswith("_val")}
    if not val_manifest:
        print_info("No validation keys (e.g. 'targets_val') in "
                   "feature_manifest. Skipping validation.")
        return None
    vd = ValidationDataset(feature_manifest=val_manifest)
    if len(vd) == 0:
        print_info("Validation manifest found but empty. Skipping "
                   "validation.")
        return None
    print_info(f"Validation dataset: {len(vd)} samples.")
    return vd


def _manifests(config):
    """-> (the whole feature manifest, its training part)."""
    full_manifest = config.get("feature_manifest", {})
    if hasattr(full_manifest, "to_dict"):
        full_manifest = full_manifest.to_dict()
    return full_manifest, {cat: paths for cat, paths in full_manifest.items()
                           if not cat.endswith("_val")}


def train_stage(config, model_name: str, artifacts_dir: str,
                model_save_dir: str, device, resume: Optional[str] = None,
                distill: bool = False) -> dict:
    """-T: build the data, train a Model, export the `.nww` artifact (with
    the bundled encoder), then distill and export the lite gate unless
    `distillation.enabled` is false and `distill` was not asked for.
    -> {"model", "dataset" (with the final hardness), "artifact",
    "lite_artifact" (path or None)}."""
    from nanowakeword_tpu_torch.data.features import \
        default_encoder_variables
    from nanowakeword_tpu_torch.export.artifact import (check_weights_dtype,
                                                        export_model)
    from nanowakeword_tpu_torch.models.model import Model
    from nanowakeword_tpu_torch.train.trainer import Trainer

    e2e_cfg = config.get("end_to_end", {})
    if e2e_cfg and e2e_cfg.get("enabled", False):
        raise NotImplementedError("end-to-end training is not ported to "
                                  "PyTorch yet (ROADMAP.md)")
    dist_cfg = config.get("distillation", {})
    should_distill = bool(dist_cfg.get("enabled", True)) or distill
    if should_distill:
        check_weights_dtype(dist_cfg)   # fail BEFORE any training runs
    full_manifest, manifest = _manifests(config)
    dataset, sampler = _build_training_data(config, manifest)
    val_dataset = _validation_data(full_manifest)

    input_shape = dataset[0][0].shape
    seconds_per_example = (1280 * input_shape[0]) / 16000
    print_info(f"Input Shape Detected: {input_shape} "
               f"({seconds_per_example:.2f}s context)")
    model = Model(
        n_classes=1, input_shape=input_shape, config=config,
        model_name=model_name, model_type=config.get("model_type", "dnn"),
        layer_dim=int(config["layer_size"]), n_blocks=int(config["n_blocks"]),
        dropout_prob=float(config.get("dropout_prob", 0.5)),
        seconds_per_example=seconds_per_example, device=device)
    trainer = Trainer(model=model, config=config)
    print_step_header("Training in progress")
    best = trainer.auto_train(
        X_train=(dataset, sampler), X_val=val_dataset,
        steps=int(config.get("steps", 15000)), debug_path=artifacts_dir,
        resume_from_dir=resume)
    encoder_vars = default_encoder_variables()
    out = {"model": best, "dataset": dataset, "lite_artifact": None,
           "artifact": export_model(best, input_shape, config, model_name,
                                    model_save_dir,
                                    encoder_variables=encoder_vars)}
    if should_distill:
        print_step_header("Distillation: Building Lite Model")
        from nanowakeword_tpu_torch.train.distill import distill_model
        student = distill_model(teacher=best, X_train=(dataset, sampler),
                                config=config, input_shape=input_shape)
        out["lite_artifact"] = export_model(
            student, input_shape, config, model_name + "_lite",
            model_save_dir, encoder_variables=encoder_vars,
            weights_dtype=dist_cfg.get("weights_dtype"))
        print_info(f"Lite model saved alongside main model in: "
                   f"{model_save_dir}")
    return out


def distill_stage(config, model_name: str, model_save_dir: str,
                  device) -> str:
    """-d without -T: distill the lite gate from the `.nww` that an earlier
    -T exported. -> the lite artifact's path."""
    from nanowakeword_tpu_torch.export.artifact import EXTENSION
    from nanowakeword_tpu_torch.train.distill import distill_from_artifact

    print_step_header("Standalone Distillation: Building Lite Model from "
                      "Existing Artifact")
    artifact_path = os.path.join(model_save_dir, model_name + EXTENSION)
    if not os.path.exists(artifact_path):
        raise FileNotFoundError(
            f"No trained model artifact found at '{artifact_path}'. Train "
            "the model first with -T, then run -d standalone.")
    _, manifest = _manifests(config)
    if not manifest:
        raise ValueError("No feature_manifest entries found in config. "
                         "Cannot run standalone distillation.")
    dataset, sampler = _build_training_data(config, manifest)
    return distill_from_artifact(
        artifact_path=artifact_path, X_train=(dataset, sampler),
        config=config, input_shape=dataset[0][0].shape,
        output_dir=model_save_dir, model_name=model_name, device=device)


def _write_journal(config, base_output_dir: str, model_name: str, model,
                   training_minutes: float) -> None:
    from nanowakeword_tpu_torch.utils.journal import update_training_journal
    report = model.history.get("final_report") or {}
    update_training_journal(
        base_output_dir=base_output_dir, model_name=model_name,
        metrics={
            "Stable Loss": report.get("Average Stable Loss", "N/A"),
            "Avg. Pos Conf": report.get("Avg. Positive Score (Logit)", "N/A"),
            "Avg. Neg Conf": report.get("Avg. Negative Score (Logit)", "N/A"),
            "Train Time": f"{training_minutes:.1f}"},
        current_config=config.report())


def run_pipeline(user_config: dict, *, transform_clips: bool = False,
                 train_model: bool = False, distill: bool = False,
                 overwrite: bool = False, resume: Optional[str] = None,
                 device="cuda") -> dict:
    """Run the requested stages for a config dict on `device`.
    -> {"project_dir", "feature_dir", "artifact" and "lite_artifact" (paths
    or None), and after training "model" and "dataset"}."""
    import torch

    print_banner()
    device = torch.device(device)
    user_config = dict(user_config)
    if user_config.get("generate_clips", False):
        raise NotImplementedError("clip generation (-G) is not ported to "
                                  "PyTorch yet (ROADMAP.md)")
    print_info("Determining hardware-specific configurations...")
    base_config = dict(ConfigGenerator().generate())
    base_config.update(user_config)
    config = ConfigProxy(deep_merge(base_config, user_config))

    model_name = config.get("model_name",
                            f"nww_{config.get('model_type', 'dnn')}")
    base_output_dir = os.path.abspath(
        base_config.get("output_dir", "./trained_models"))
    project_dir = os.path.join(base_output_dir, model_name)
    feature_dir = os.path.join(project_dir, "features")
    artifacts_dir = os.path.join(project_dir, "training_artifacts")
    model_save_dir = os.path.join(project_dir, "model")
    for path in (project_dir, feature_dir, artifacts_dir, model_save_dir):
        os.makedirs(path, exist_ok=True)
    print_info(f"Project assets will be saved in: {project_dir}")

    if transform_clips or config.get("transform_clips", False):
        from nanowakeword_tpu_torch.data.transform_clips import \
            transform_clips as run_transform
        run_transform(config, SimpleNamespace(transform_clips=True,
                                              overwrite=overwrite),
                      feature_dir, device=device)

    out = {"project_dir": project_dir, "feature_dir": feature_dir,
           "artifact": None, "lite_artifact": None}
    distill = distill or bool(config.get("distill", False))
    if train_model or config.get("train_model", False):
        start = time.time()
        out.update(train_stage(config, model_name, artifacts_dir,
                               model_save_dir, device, resume, distill))
        minutes = (time.time() - start) / 60
        print_info(f"Training and export took {minutes:.1f} min.")
        if config.get("enable_journaling", True):
            _write_journal(config, base_output_dir, model_name, out["model"],
                           minutes)
    elif distill:
        out["lite_artifact"] = distill_stage(config, model_name,
                                             model_save_dir, device)
    return out


def _build_parser():
    parser = argparse.ArgumentParser(
        description="nanowakeword, PyTorch port: feature generation, "
                    "training and export on one torch device.")
    parser.add_argument("-c", "--config_path", type=str, required=True,
                        metavar="PATH",
                        help="Path to the training configuration YAML file.")
    parser.add_argument("-t", "--transform_clips", action="store_true",
                        help="Augment clips and extract features (.npy).")
    parser.add_argument("-T", "--train_model", action="store_true",
                        help="Train the wake word model and export it as "
                             ".nww.")
    parser.add_argument("-d", "--distill", action="store_true",
                        help="Distill a lite gate model (with -T or "
                             "standalone from the exported .nww).")
    parser.add_argument("--overwrite", action="store_true",
                        help="Overwrite existing feature files.")
    parser.add_argument("--resume", type=str, default=None, metavar="PATH",
                        help="Project directory to resume training from.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda).")
    return parser


def train(cli_args=None) -> dict:
    args = _build_parser().parse_args(cli_args)
    import yaml
    with open(args.config_path, "r", encoding="utf-8") as f:
        user_config = yaml.safe_load(f.read())
    return run_pipeline(user_config, transform_clips=args.transform_clips,
                        train_model=args.train_model, distill=args.distill,
                        overwrite=args.overwrite, resume=args.resume,
                        device=args.device)


if __name__ == "__main__":
    train()
