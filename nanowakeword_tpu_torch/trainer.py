"""Pipeline orchestrator: config -> feature generation (-t) -> device-cached
training (-T) -> `.nww` export, on one torch device.

The counterpart of `nanowakeword_tpu/trainer.py` for the stages the port
has: hardware auto-config merge, the project directory layout
(`features/`, `training_artifacts/`, `model/`), the manifest-driven
transform stage, dataset/sampler construction, training in device-cache
mode, and the artifact export. `run_pipeline` takes the config as a dict;
the command line (`train`) wraps it and is the only place that reads YAML.
Clip generation (-G), distillation (-d), end-to-end training, ONNX export
and the training journal are not ported yet (ROADMAP.md).
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
                                                 print_step_header,
                                                 print_warning)

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


def train_stage(config, model_name: str, artifacts_dir: str,
                model_save_dir: str, device, resume: Optional[str] = None):
    """-T: build the data, train a Model in device-cache mode, export the
    `.nww` artifact (with the bundled encoder).
    -> (trained model, its dataset with the final hardness, artifact path)."""
    from nanowakeword_tpu_torch.data.features import \
        default_encoder_variables
    from nanowakeword_tpu_torch.export.artifact import export_model
    from nanowakeword_tpu_torch.models.model import Model
    from nanowakeword_tpu_torch.train.trainer import Trainer

    e2e_cfg = config.get("end_to_end", {})
    if e2e_cfg and e2e_cfg.get("enabled", False):
        raise NotImplementedError("end-to-end training is not ported to "
                                  "PyTorch yet (ROADMAP.md)")
    full_manifest = config.get("feature_manifest", {})
    if hasattr(full_manifest, "to_dict"):
        full_manifest = full_manifest.to_dict()
    manifest = {cat: paths for cat, paths in full_manifest.items()
                if not cat.endswith("_val")}
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
    path = export_model(best, input_shape, config, model_name,
                        model_save_dir,
                        encoder_variables=default_encoder_variables())
    dist_cfg = config.get("distillation", {})
    if dist_cfg and dist_cfg.get("enabled", True):
        print_warning("Distillation of a lite gate is not ported to PyTorch "
                      "yet (ROADMAP.md); skipped.")
    return best, dataset, path


def run_pipeline(user_config: dict, *, transform_clips: bool = False,
                 train_model: bool = False, overwrite: bool = False,
                 resume: Optional[str] = None, device="cuda") -> dict:
    """Run the requested stages for a config dict on `device`.
    -> {"project_dir", "feature_dir", and after training "artifact" (path),
    "model" and "dataset"}."""
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
    project_dir = os.path.join(os.path.abspath(
        base_config.get("output_dir", "./trained_models")), model_name)
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
           "artifact": None}
    if train_model or config.get("train_model", False):
        start = time.time()
        out["model"], out["dataset"], out["artifact"] = train_stage(
            config, model_name, artifacts_dir, model_save_dir, device, resume)
        print_info(f"Training and export took "
                   f"{(time.time() - start) / 60:.1f} min.")
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
                        help="Train the wake word model (device-cache mode) "
                             "and export it as .nww.")
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
                        train_model=args.train_model,
                        overwrite=args.overwrite, resume=args.resume,
                        device=args.device)


if __name__ == "__main__":
    train()
