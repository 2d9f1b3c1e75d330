"""Training journal: cross-run markdown table + JSON history database.

A copy of `nanowakeword_tpu/utils/journal.py`: appends one row per training
run to `training_journal.md`, showing only the parameters that *changed*
versus the previous run (grouped by dotted prefix), plus permanent metric
columns (Name / StbLoss / APC / ANC / Time), backed by a JSON history db
under `.cache/journal_cache/`.
"""

from __future__ import annotations

import json
import os
from datetime import datetime

from nanowakeword_tpu_torch.utils.logger import print_info

PERMANENT_COLUMNS = ["Name", "StbLoss", "APC", "ANC", "Time(m)"]
METRIC_KEY_MAP = {
    "Stable Loss": "StbLoss",
    "Avg. Pos Conf": "APC",
    "Avg. Neg Conf": "ANC",
    "Train Time": "Time(m)",
}
EXCLUDED_PREFIXES = ("feature_manifest", "output_dir", "positive_data_path",
                     "negative_data_path", "background_paths", "rir_paths")


def _changed_params(current: dict, previous: dict) -> dict:
    changed = {}
    for key, value in sorted(current.items()):
        if key.startswith(EXCLUDED_PREFIXES):
            continue
        if previous.get(key) != value:
            changed[key] = value
    return changed


def update_training_journal(base_output_dir: str, model_name: str,
                            metrics: dict, current_config: dict):
    cache_dir = os.path.join(base_output_dir, ".cache", "journal_cache")
    os.makedirs(cache_dir, exist_ok=True)
    db_path = os.path.join(cache_dir, "training_history.json")
    journal_path = os.path.join(base_output_dir, "training_journal.md")

    history = []
    if os.path.exists(db_path):
        try:
            with open(db_path) as f:
                history = json.load(f)
        except (json.JSONDecodeError, OSError):
            history = []

    serializable_config = {}
    for k, v in current_config.items():
        try:
            json.dumps(v)
            serializable_config[k] = v
        except TypeError:
            serializable_config[k] = str(v)

    prev_config = history[-1]["config"] if history else {}
    changed = _changed_params(serializable_config, prev_config)

    entry = {
        "timestamp": datetime.now().isoformat(timespec="seconds"),
        "model_name": model_name,
        "metrics": metrics,
        "config": serializable_config,
        "changed": changed,
    }
    history.append(entry)
    with open(db_path, "w") as f:
        json.dump(history, f, indent=2)

    # regenerate the markdown table
    lines = ["# Training Journal", "",
             "One row per run; 'Changed parameters' lists only what differs "
             "from the previous run.", ""]
    header = "| " + " | ".join(["#", "Date"] + PERMANENT_COLUMNS
                               + ["Changed parameters"]) + " |"
    sep = "|" + "---|" * (len(PERMANENT_COLUMNS) + 3)
    lines += [header, sep]
    for i, run in enumerate(history, 1):
        m = run.get("metrics", {})
        cols = [str(i), run.get("timestamp", ""), run.get("model_name", "")]
        for pretty, short in METRIC_KEY_MAP.items():
            cols.append(str(m.get(pretty, m.get(short, "—"))))
        ch = run.get("changed", {})
        if i == 1:
            ch_str = "(baseline run)"
        elif ch:
            groups: dict = {}
            for k, v in ch.items():
                prefix = k.split(".")[0]
                groups.setdefault(prefix, []).append(f"{k}={v}")
            ch_str = "; ".join(", ".join(items) for items in groups.values())
        else:
            ch_str = "—"
        lines.append("| " + " | ".join(cols + [ch_str]) + " |")

    with open(journal_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print_info(f"Training journal updated: {journal_path}")
