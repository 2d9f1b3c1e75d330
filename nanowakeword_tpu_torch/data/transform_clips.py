"""Feature generation: audio directories -> augmented .npy feature memmaps.

The counterpart of `nanowakeword_tpu/data/transform_clips.py` (the `-t`
stage): the `feature_generation_manifest` job loop, clip-length autotune
from the positive-clip median, background duplication rates,
skip-if-exists, and the preallocated memmap + trim.

Per job: host threads decode audio, the device runs the augmentation chain
(the mix kernel on a CUDA device) and `AudioFeatures.embed_clips` (the mel
kernel), and rows stream into the memmap. The augmented batch stays on the
device between the two.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from nanowakeword_tpu_torch.data.augment_clips import (augment_clips,
                                                 raw_audio_batch_generator)
from nanowakeword_tpu_torch.data.features import AudioFeatures
from nanowakeword_tpu_torch.data.trim_mmap import trim_mmap
from nanowakeword_tpu_torch.utils.logger import (print_info, print_step_header,
                                           print_warning)


def determine_clip_length(config) -> int:
    """Fixed length > autotune-from-positive-median > fallback."""
    audio_cfg = config.get("audio_processing", {})

    fixed = audio_cfg.get("clip_length_samples",
                          config.get("clip_length_samples"))
    if fixed is not None:
        print_info(f"Using user-defined clip duration: {fixed} samples.")
        return int(fixed)

    autotune_cfg = audio_cfg.get("autotune_length", {})
    if autotune_cfg.get("enabled", True):
        print_info("Autotuning optimal clip duration...")
        num_to_inspect = int(autotune_cfg.get("num_samples_to_inspect", 50))
        buffer_ms = float(autotune_cfg.get("duration_buffer_ms", 750))
        min_length = int(autotune_cfg.get("min_allowable_length", 32000))
        snap_tol = int(autotune_cfg.get("snap_to_min_tolerance", 4000))

        pos_dir = config.get("positive_data_path")
        positive_clips = [str(p) for p in Path(pos_dir).glob("*.wav")] \
            if pos_dir else []
        if not positive_clips:
            print_warning("No .wav files found for autotuning; using minimum "
                          "allowable length.")
            return min_length

        rng = np.random.default_rng(10)
        sampled = rng.choice(positive_clips,
                             min(num_to_inspect, len(positive_clips)),
                             replace=False)
        durations = []
        for clip_path in sampled:
            try:
                import wave
                with wave.open(str(clip_path), "rb") as f:
                    n, sr = f.getnframes(), f.getframerate()
                if sr != 16000:
                    print_warning(f"Clip '{os.path.basename(str(clip_path))}' "
                                  f"has sample rate {sr}Hz, not 16kHz.")
                durations.append(n)
            except Exception as e:  # noqa: BLE001
                print_warning(f"Could not read clip "
                              f"'{os.path.basename(str(clip_path))}': {e}")

        if not durations:
            final_length = min_length
        else:
            median = float(np.median(durations))
            base = round(median / 1000) * 1000
            calculated = int(base + (buffer_ms / 1000) * 16000)
            final_length = max(min_length, calculated)
            if abs(final_length - min_length) <= snap_tol:
                final_length = min_length
        print_info(f"Optimal clip duration autotuned to: {final_length} "
                   f"samples ({final_length / 16000:.2f} s).")
        return final_length

    fallback = int(autotune_cfg.get("min_allowable_length", 32000))
    print_info(f"Autotuning disabled. Using fallback clip duration: "
               f"{fallback} samples.")
    return fallback


def _to_plain_dict(maybe_proxy):
    # `augmentation_settings: false` is the disable convention, so
    # non-mappings collapse to {}
    if maybe_proxy is None or isinstance(maybe_proxy, bool):
        return {}
    if hasattr(maybe_proxy, "to_dict"):
        return maybe_proxy.to_dict()
    return dict(maybe_proxy)


def process_generation_job(job_name: str, overwrite: bool, recipe, config,
                           feature_save_dir: str, rir_paths, background_paths,
                           total_length: int,
                           feature_extractor: AudioFeatures):
    """One manifest job."""
    print_info(f"Running Generation: {job_name}")

    output_filename = recipe.get("output_filename")
    if not output_filename:
        print_warning(f"Skipping job '{job_name}': 'output_filename' missing.")
        return
    output_filepath = os.path.join(feature_save_dir, output_filename)
    if os.path.exists(output_filepath) and not overwrite:
        print_warning(f"Feature file '{output_filename}' already exists. "
                      "Skipping generation. (Use --overwrite to force.)")
        return

    input_clips = [str(p) for d in recipe.get("input_audio_dirs", [])
                   for p in Path(d).rglob("*.wav")]
    if not input_clips:
        print_warning(f"Skipping job '{job_name}': no .wav files found.")
        return
    print_info(f"Found {len(input_clips)} source audio files.")

    global_aug = config.get("augmentation_settings", {})
    recipe_aug = recipe.get("augmentation_settings", {})
    final_settings = {**_to_plain_dict(global_aug), **_to_plain_dict(recipe_aug)}

    aug_rounds = int(recipe.get("augmentation_rounds", 1))
    clips_to_generate = input_clips * aug_rounds
    total_clips = len(clips_to_generate)
    batch_size = int(config.get("augmentation_batch_size", 128))
    print_info(f"Augmentation rounds: {aug_rounds}. Total clips: "
               f"{total_clips}")

    use_augmentation = not (global_aug is False or recipe_aug is False)
    num_workers = config.get("feature_gen_num_workers")
    if num_workers is None:
        num_workers = int(config.get("num_workers", 3))

    if use_augmentation:
        bg = background_paths if recipe.get("use_background_noise", True) \
            else []
        rirs = rir_paths if recipe.get("use_rir", False) else []
        audio_generator = augment_clips(
            clip_paths=clips_to_generate, total_length=total_length,
            batch_size=batch_size, background_clip_paths=bg, RIR_paths=rirs,
            num_workers=num_workers, augmentation_settings=final_settings,
            device=feature_extractor.device)
    else:
        print_info("Augmentation disabled for this job. Using raw audio.")
        audio_generator = raw_audio_batch_generator(
            clip_paths=clips_to_generate, total_length=total_length,
            batch_size=batch_size, num_workers=num_workers)

    emb_shape = feature_extractor.get_embedding_shape(total_length / 16000)
    fp = np.lib.format.open_memmap(output_filepath, mode="w+",
                                   dtype=np.float32,
                                   shape=(total_clips,) + tuple(emb_shape))
    row = 0
    n_batches = -(total_clips // -batch_size)
    # decode/augment batch k+1 on a background thread while the device
    # extracts features for batch k
    from nanowakeword_tpu_torch.utils.prefetch import Prefetcher
    audio_generator = Prefetcher(audio_generator, depth=2)
    for k, audio_batch in enumerate(audio_generator):
        if row >= total_clips:
            break
        if (k + 1) % 10 == 0 or k + 1 == n_batches:
            print_info(f"{job_name}: batch {k + 1}/{n_batches}")
        features = feature_extractor.embed_clips(audio_batch,
                                                 batch_size=len(audio_batch))
        end = min(row + features.shape[0], total_clips)
        fp[row:end] = features[:end - row]
        row = end
        fp.flush()
    del fp
    trim_mmap(output_filepath)
    print_info(f"Job '{job_name}' completed successfully!")


def transform_clips(config, args, feature_save_dir: str, device="cuda",
                    feature_extractor=None):
    """The manifest-driven feature-generation stage, on `device` (by default
    with the bundled encoder)."""
    args_flag = bool(getattr(args, "transform_clips", False))
    if not (args_flag or config.get("transform_clips", False)):
        print_info("Feature generation is disabled via config/flag. Skipping.")
        return

    generation_manifest = config.get("feature_generation_manifest")
    if not generation_manifest:
        print_warning("'feature_generation_manifest' not found. Skipping "
                      "feature generation.")
        return

    rir_config = config.get("rir_paths", []) or []
    if not rir_config:
        print_warning("No RIR is being used!")
    rir_paths = []
    for d in rir_config:
        if os.path.isdir(d):
            try:
                rir_paths.extend(e.path for e in os.scandir(d))
            except OSError as e:
                print_warning(f"Error reading {d}: {e}")
    if rir_config and not rir_paths:
        print_warning("RIR paths provided but no valid files found!")

    background_paths = []
    bg_paths_config = config.get("background_paths", []) or []
    bg_rates = config.get("background_paths_duplication_rate", []) or []
    if len(bg_rates) != len(bg_paths_config):
        bg_rates = [1] * len(bg_paths_config)
    for path, rate in zip(bg_paths_config, bg_rates):
        if os.path.isdir(path):
            entries = [e.path for e in os.scandir(path)]
            background_paths.extend(entries * int(rate))

    config["total_length"] = determine_clip_length(config)
    is_overwrite = bool(config.get("overwrite", False)
                        or getattr(args, "overwrite", False))

    if feature_extractor is None:
        feature_extractor = AudioFeatures(device=device)

    print_step_header("Computing Acoustic Features from Audio Sources")
    for job_name, recipe in generation_manifest.items():
        process_generation_job(
            job_name=job_name, overwrite=is_overwrite, recipe=recipe,
            config=config, feature_save_dir=feature_save_dir,
            rir_paths=rir_paths, background_paths=background_paths,
            total_length=int(config["total_length"]),
            feature_extractor=feature_extractor)
    print_info("All feature generation jobs finished.")
