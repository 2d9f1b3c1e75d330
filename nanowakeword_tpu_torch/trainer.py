"""Pipeline orchestrator: config -> clip generation (-G) -> feature
generation (-t) -> training (-T) -> `.nww` export -> distillation of the
lite gate (-d), on one torch device.

The counterpart of `nanowakeword_tpu/trainer.py`: the opt-in verification
and conversion of the data directories (`convert_audio`, with md5-named
receipts so an unchanged directory is skipped; `-f` forces it), the
hardware auto-config merge, clip synthesis from `data_generation_tasks`,
the project directory layout (`features/`, `training_artifacts/`, `model/`;
a versioned default name), the manifest-driven transform stage,
dataset/sampler construction, training (the host loop by default, the
device-cached loop with `device_cache: {enabled: true}`, or end-to-end from
raw audio with `end_to_end: {enabled: true}`), the exports (`.nww`, raw
parameters, the user's export hook), the training graph, distillation
(after training, where `distillation.enabled` defaults to true and a
failure is logged and skipped as the reference does, or standalone from the
exported `.nww`) and the training journal. `run_pipeline` takes the config
as a dict; the command line (`train`) wraps it and is the only place that
reads YAML. ONNX export is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time
from types import SimpleNamespace
from typing import Optional

from nanowakeword_tpu_torch.config.generator import ConfigGenerator
from nanowakeword_tpu_torch.config.proxy import ConfigProxy, deep_merge
from nanowakeword_tpu_torch.data.dataset import (AdaptiveLossAwareDataset,
                                                 DynamicClassAwareSampler,
                                                 ValidationDataset)
from nanowakeword_tpu_torch.utils.logger import (print_banner, print_error,
                                                 print_info,
                                                 print_step_header,
                                                 print_warning)

SEED = 10


def _directory_state(path: str) -> dict:
    """File count and total bytes of the audio files in `path`."""
    audio_exts = {".wav", ".mp3", ".flac", ".m4a", ".ogg"}
    count, size = 0, 0
    try:
        for entry in os.scandir(path):
            if (entry.is_file()
                    and os.path.splitext(entry.name)[1].lower() in audio_exts):
                count += 1
                size += entry.stat().st_size
    except FileNotFoundError:
        pass
    return {"file_count": count, "total_size": size}


def smart_verify(path: str, cache_dir: str, force: bool = False) -> None:
    """Verify (and convert to 16 kHz mono 16-bit WAV) one directory, unless
    its receipt in `cache_dir` (named by the md5 of the path) shows it
    unchanged since the last verification."""
    from nanowakeword_tpu_torch.utils.audio_io import \
        verify_and_process_directory
    if not path:
        return
    receipt_path = os.path.join(
        cache_dir, hashlib.md5(path.encode("utf-8")).hexdigest() + ".json")

    if not force and os.path.exists(receipt_path):
        try:
            with open(receipt_path) as f:
                saved = json.load(f)
            if saved == _directory_state(path):
                print_info(f"'{os.path.basename(path)}' already verified. "
                           "Skipping.")
                return
            print_info(f"Data in '{os.path.basename(path)}' has changed. "
                       "Re-verifying...")
        except (json.JSONDecodeError, KeyError) as e:
            print_info(f"Could not parse receipt for "
                       f"'{os.path.basename(path)}'. Re-verifying... ({e})")

    try:
        verify_and_process_directory(path)
        with open(receipt_path, "w") as f:
            json.dump(_directory_state(path), f, indent=4)
    except FileNotFoundError:
        print_warning(f"Directory not found, skipping preprocessing: {path}")
    except Exception as e:  # noqa: BLE001
        print_warning(f"Unexpected error verifying "
                      f"'{os.path.basename(path)}': {e}")


def verify_data_directories(user_config: dict, cache_dir: str,
                            force: bool) -> None:
    """`convert_audio: true`: verify the positive, negative, background and
    impulse-response directories (smart_verify)."""
    print_step_header("Verifying and Preprocessing Data Directories")
    paths = [user_config.get("positive_data_path"),
             user_config.get("negative_data_path")]
    paths.extend(user_config.get("background_paths", []) or [])
    paths.extend(user_config.get("rir_paths", []) or [])
    if force:
        print_info("User has forced re-verification of all data "
                   "directories.")
    for path in sorted(set(p for p in paths if p)):
        smart_verify(path, cache_dir, force=force)
    print_info("Data verification and preprocessing complete.\n")


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


def _export_custom(model, input_shape, config, model_name: str,
                   model_save_dir: str) -> None:
    """The user's export hook; its failure is logged, not raised."""
    from nanowakeword_tpu_torch.export.custom_export import \
        export_custom_model
    try:
        export_custom_model(model, input_shape, config, model_name,
                            model_save_dir)
    except Exception as e:  # noqa: BLE001
        print_warning(f"Custom export hook for '{model_name}' encountered an "
                      f"error: {e}")


def train_stage(config, model_name: str, artifacts_dir: str,
                model_save_dir: str, device, resume: Optional[str] = None,
                distill: bool = False, dynamic_table=None) -> dict:
    """-T: build the data, train a Model, draw its training graph, export
    the `.nww` artifact (with the bundled encoder), then distill and export
    the lite gate unless `distillation.enabled` is false and `distill` was
    not asked for (a failure there is logged and skipped), then the raw
    parameters and the user's export hook.
    -> {"model", "dataset" (with the final hardness), "artifact",
    "lite_artifact" (path or None)}."""
    from nanowakeword_tpu_torch.data.features import \
        default_encoder_variables
    from nanowakeword_tpu_torch.export.artifact import (check_weights_dtype,
                                                        export_model,
                                                        export_params_msgpack)
    from nanowakeword_tpu_torch.models.model import Model
    from nanowakeword_tpu_torch.train.trainer import Trainer

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
        steps=int(config.get("steps", 15000)), table_updater=dynamic_table,
        debug_path=artifacts_dir, resume_from_dir=resume)
    model.plot_history(artifacts_dir)
    encoder_vars = default_encoder_variables()
    out = {"model": best, "dataset": dataset, "lite_artifact": None,
           "artifact": export_model(best, input_shape, config, model_name,
                                    model_save_dir,
                                    encoder_variables=encoder_vars)}
    if should_distill:
        try:
            print_step_header("Distillation: Building Lite Model")
            from nanowakeword_tpu_torch.train.distill import distill_model
            student = distill_model(teacher=best, X_train=(dataset, sampler),
                                    config=config, input_shape=input_shape)
            out["lite_artifact"] = export_model(
                student, input_shape, config, model_name + "_lite",
                model_save_dir, encoder_variables=encoder_vars,
                weights_dtype=dist_cfg.get("weights_dtype"))
            _export_custom(student, input_shape, config, model_name + "_lite",
                           model_save_dir)
            print_info(f"Lite model saved alongside main model in: "
                       f"{model_save_dir}")
        except Exception as e:  # noqa: BLE001
            out["lite_artifact"] = None
            print_error(f"Distillation failed and was skipped. Details: {e}")
    export_params_msgpack(best, model_name, model_save_dir)
    _export_custom(best, input_shape, config, model_name, model_save_dir)
    return out


def e2e_stage(config, e2e_cfg, model_name: str, artifacts_dir: str,
              model_save_dir: str, device, resume: Optional[str] = None,
              dynamic_table=None) -> dict:
    """-T with `end_to_end: {enabled: true}`: train the encoder and the
    classifier jointly from raw audio (train/e2e.py), then export the
    classifier with the TRAINED encoder bundled in the `.nww`. Config:

        end_to_end:
          enabled: true
          audio_manifest:              # categories -> dirs (or {key: dir})
            targets: [data/positive]
            negatives: [data/negative]
          clip_samples: 32000
          context_frames: 16
          freeze_encoder: false

    -> {"model" (the E2EModel), "dataset", "artifact", "lite_artifact"
    (None: the reference distills no gate here)}."""
    from nanowakeword_tpu_torch.export.artifact import (export_model,
                                                        export_params_msgpack)
    from nanowakeword_tpu_torch.models.model import Model
    from nanowakeword_tpu_torch.train.e2e import AudioClipDataset, E2EModel
    from nanowakeword_tpu_torch.train.trainer import Trainer

    audio_manifest = e2e_cfg.get("audio_manifest")
    if hasattr(audio_manifest, "to_dict"):
        audio_manifest = audio_manifest.to_dict()
    if not audio_manifest:
        audio_manifest = {
            "targets": [config.get("positive_data_path")],
            "negatives": [config.get("negative_data_path")],
        }
    clip_samples = int(e2e_cfg.get("clip_samples",
                                   config.get("clip_length_samples", 32000)))
    context_frames = int(e2e_cfg.get("context_frames", 16))

    dataset = AudioClipDataset(audio_manifest, clip_samples=clip_samples)
    if len(dataset) == 0:
        raise ValueError("CRITICAL: end_to_end.audio_manifest matched no "
                         ".wav files.")
    composition = config.get("batch_composition")
    if hasattr(composition, "to_dict"):
        composition = composition.to_dict()
    if not composition:
        composition = {"targets": 8, "negatives": 16}
    sampler = DynamicClassAwareSampler(
        dataset=dataset, batch_composition=composition,
        feature_manifests={c: (d if isinstance(d, dict)
                               else {f"{c}_{i}": p
                                     for i, p in enumerate(d)})
                           for c, d in audio_manifest.items()},
        seed=SEED)

    print_info("Initializing end-to-end acoustic stack "
               f"(clip={clip_samples} samples, context={context_frames} "
               "frames)...")
    classifier = Model(
        n_classes=1, input_shape=(context_frames, 96), config=config,
        model_name=model_name, model_type=config.get("model_type", "dnn"),
        layer_dim=int(config["layer_size"]), n_blocks=int(config["n_blocks"]),
        dropout_prob=float(config.get("dropout_prob", 0.5)), device=device)
    e2e = E2EModel(classifier, context_frames=context_frames,
                   freeze_encoder=bool(e2e_cfg.get("freeze_encoder", False)))
    print_info(f"End-to-end parameters: {e2e.n_params():,} "
               "(encoder + classifier)")

    trainer = Trainer(model=e2e, config=config)
    print_step_header("End-to-end training in progress")
    trainer.auto_train(
        X_train=(dataset, sampler), X_val=None,
        steps=int(config.get("steps", 15000)), table_updater=dynamic_table,
        debug_path=artifacts_dir, resume_from_dir=resume)

    classifier.plot_history(artifacts_dir)
    trained, encoder_vars = e2e.export_components()
    input_shape = (context_frames, 96)
    artifact = export_model(trained, input_shape, config, model_name,
                            model_save_dir, encoder_variables=encoder_vars)
    export_params_msgpack(trained, model_name, model_save_dir)
    print_warning("Feature-frontend ONNX export skipped: ONNX export is not "
                  "ported to PyTorch yet (ROADMAP.md).")
    _export_custom(trained, input_shape, config, model_name, model_save_dir)
    print_info(f"End-to-end model (with trained encoder) exported to "
               f"{model_save_dir}")
    return {"model": e2e, "dataset": dataset, "artifact": artifact,
            "lite_artifact": None}


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


def run_pipeline(user_config: dict, *, generate_clips: bool = False,
                 transform_clips: bool = False, train_model: bool = False,
                 distill: bool = False, overwrite: bool = False,
                 resume: Optional[str] = None, force_verify: bool = False,
                 device="cuda") -> dict:
    """Run the requested stages for a config dict on `device`.
    -> {"project_dir", "feature_dir", "artifact" and "lite_artifact" (paths
    or None), and after training "model" and "dataset"}."""
    import torch

    from nanowakeword_tpu_torch.export.custom_export import auto_gen_name
    from nanowakeword_tpu_torch.utils.dynamic_table import DynamicTable

    print_banner()
    device = torch.device(device)
    user_config = dict(user_config)
    output_dir_from_config = user_config.get("output_dir", "./trained_models")
    cache_dir = os.path.join(output_dir_from_config, ".cache",
                             "verification_receipts")
    os.makedirs(cache_dir, exist_ok=True)
    if user_config.get("convert_audio", False) is True:
        verify_data_directories(
            user_config, cache_dir,
            force_verify or bool(user_config.get("force_verify", False)))

    print_info("Determining hardware-specific configurations...")
    base_config = dict(ConfigGenerator().generate())
    base_config.update(user_config)
    if generate_clips or base_config.get("generate_clips", False):
        from nanowakeword_tpu_torch.data.generator.generate_clips import \
            generate_clips as run_generation
        run_generation(base_config)
    config = ConfigProxy(deep_merge(base_config, user_config))
    dynamic_table = DynamicTable(
        config, title="Effective Training Configuration",
        enabled=bool(config.get("show_training_summary", True)))

    model_name = config.get("model_name") or auto_gen_name(
        config.get("model_type", "dnn"), base_dir=output_dir_from_config)
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
    should_train = train_model or config.get("train_model", False)
    e2e_cfg = config.get("end_to_end", {})
    if should_train and e2e_cfg and e2e_cfg.get("enabled", False):
        out.update(e2e_stage(config, e2e_cfg, model_name, artifacts_dir,
                             model_save_dir, device, resume, dynamic_table))
    elif should_train:
        start = time.time()
        out.update(train_stage(config, model_name, artifacts_dir,
                               model_save_dir, device, resume, distill,
                               dynamic_table))
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
    parser.add_argument("-G", "--generate_clips", action="store_true",
                        help="Synthesize audio clips from text "
                             "(data_generation_tasks).")
    parser.add_argument("-t", "--transform_clips", action="store_true",
                        help="Augment clips and extract features (.npy).")
    parser.add_argument("-T", "--train_model", action="store_true",
                        help="Train the wake word model and export it as "
                             ".nww.")
    parser.add_argument("-d", "--distill", action="store_true",
                        help="Distill a lite gate model (with -T or "
                             "standalone from the exported .nww).")
    parser.add_argument("-f", "--force-verify", action="store_true",
                        help="Re-verify all data directories, ignoring the "
                             "cache (with convert_audio: true).")
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
    return run_pipeline(user_config, generate_clips=args.generate_clips,
                        transform_clips=args.transform_clips,
                        train_model=args.train_model, distill=args.distill,
                        overwrite=args.overwrite, resume=args.resume,
                        force_verify=args.force_verify, device=args.device)


if __name__ == "__main__":
    train()
