"""Synthetic data generation engine: task-list driven clip synthesis.

A copy of `nanowakeword_tpu/data/generator/generate_clips.py`: it
iterates `data_generation_tasks`, resolves the four text sources
(`fixed_phrase`, `from_list`, `auto_adversarial`, `phoneme_adversarial`),
merges per-task TTS settings over globals, and calls the sample generator.
Same YAML task schema.
"""

from __future__ import annotations

import os

from nanowakeword_tpu_torch.data.generator.adversarial_texts import (
    PhonemeAdversarialGenerator, adversarial_texts, get_phonemizer_model)
from nanowakeword_tpu_torch.data.generator.g2p import \
    collapse_repeated_letters
from nanowakeword_tpu_torch.data.generator.tts import generate_samples
from nanowakeword_tpu_torch.utils.logger import (print_error, print_info,
                                                 print_step_header,
                                                 print_warning)

_ADV_KEYS = ("include_input_words", "include_partial_phrase",
             "multi_word_prob", "max_multi_word_len")


def _resolve_base_phrase(text_source: dict, global_phrase):
    return (text_source.get("base_phrase") or text_source.get("phrase")
            or global_phrase)


def generate_clips(base_config: dict):
    """Run every enabled task in `data_generation_tasks`."""
    print_step_header("Activating Synthetic Data Generation Engine")

    generation_tasks = base_config.get("data_generation_tasks")
    if not generation_tasks or not isinstance(generation_tasks, list):
        print_info("No 'data_generation_tasks' found in the configuration. "
                   "Skipping generation.")
        return

    global_tts_settings = dict(base_config.get("tts_settings", {}) or {})
    global_target_phrase = base_config.get("target_phrase")

    phonemizer = None
    if any((task.get("text_source") or {}).get("type") == "phoneme_adversarial"
           for task in generation_tasks):
        phonemizer = get_phonemizer_model(
            base_config.get("phonemizer_model_path"))
        print_info("Phonemizer ready (built-in rule G2P).")

    print_info(f"Found {len(generation_tasks)} generation tasks defined in "
               "the configuration.")

    for i, task in enumerate(generation_tasks):
        task_name = task.get("name", f"Unnamed Task {i + 1}")
        if not task.get("enabled", True):
            print_info(f"Skipping Task: '{task_name}' (disabled)")
            continue
        print_info(f"Executing Task: '{task_name}'")

        output_dir = task.get("output_dir")
        num_samples = int(task.get("num_samples", 0))
        text_source = task.get("text_source")
        if not all([output_dir, num_samples > 0, text_source]):
            print_warning(f"Task '{task_name}' is misconfigured. Skipping.")
            continue

        source_type = text_source.get("type") or "fixed_phrase"
        final_texts = []

        if source_type == "fixed_phrase":
            phrase = text_source.get("phrase", global_target_phrase)
            if not phrase:
                print_error(f"Task '{task_name}' needs a 'phrase'. Skipping.")
                continue
            final_texts = [phrase]
            print_info(f"Source: Fixed phrase -> '{phrase}'")

        elif source_type == "from_list":
            phrases = text_source.get("phrases", [])
            repeats = int(text_source.get("repeat_each", 1))
            if not phrases:
                print_warning(f"Task '{task_name}' has an empty 'phrases' "
                              "list. Skipping.")
                continue
            for p in phrases:
                final_texts.extend([p] * repeats)
            print_info(f"Source: Custom list of {len(phrases)} phrases, "
                       f"repeated {repeats} time(s) each.")

        elif source_type == "auto_adversarial":
            base_phrase = _resolve_base_phrase(text_source,
                                               global_target_phrase)
            if not base_phrase:
                print_error(f"Task '{task_name}' needs a 'base_phrase' for "
                            "adversarial generation. Skipping.")
                continue
            print_info(f"Source: Auto-generating {num_samples} word-based "
                       f"adversarial phrases from '{base_phrase}'.")
            adv_params = {k: text_source.get(k) for k in _ADV_KEYS
                          if text_source.get(k) is not None}
            final_texts = adversarial_texts(base_phrase, N=num_samples,
                                            **adv_params)

        elif source_type == "phoneme_adversarial":
            base_phrase = _resolve_base_phrase(text_source,
                                               global_target_phrase)
            if not base_phrase:
                print_error(f"Task '{task_name}' needs a 'base_phrase' for "
                            "phoneme generation. Skipping.")
                continue
            min_distance = float(text_source.get("min_distance", 0.35))
            print_info(f"Source: Generating {num_samples} phoneme-based "
                       f"adversarial texts from '{base_phrase}' "
                       f"(min_distance={min_distance}).")
            generator = PhonemeAdversarialGenerator(phonemizer,
                                                    min_distance=min_distance)
            variants = generator.generate(base_phrase, num_samples)
            final_texts = [collapse_repeated_letters(v) for v in variants]

        else:
            print_warning(f"Unknown text_source type: '{source_type}' in "
                          f"task '{task_name}'. Skipping.")
            continue

        if not final_texts:
            print_warning(f"No texts were generated for task '{task_name}'. "
                          "Skipping.")
            continue

        task_tts_settings = dict(global_tts_settings)
        task_tts_settings.update(task.get("tts_settings", {}) or {})
        print_info(f"Generating {num_samples} clips -> '{output_dir}'")
        os.makedirs(output_dir, exist_ok=True)
        generate_samples(
            text=final_texts, max_samples=num_samples,
            output_dir=output_dir,
            file_prefix=task.get("file_prefix", "sample"),
            **task_tts_settings)
