"""Compare two judgements of the quality campaign.

    python -m nanowakeword_tpu_torch.tools.compare_judgements \\
        results REFERENCE.json JUDGED.json
    python -m nanowakeword_tpu_torch.tools.compare_judgements \\
        traces WORK_A WORK_B

`results` holds the numbers of a `results.json` written by the port's
`quality_campaign report` (or one of its eval JSON files) against a
reference such as the JAX tool's committed `campaign/results.json`: every
number the reference has, set by set, equal or not, beside the files the
judged run found within 1e-3 of a threshold. `traces` holds the per-chunk
traces of two campaign work folders (for example the card's and the
CPU's) against each other, file by file over the files both streamed
(rows matched by name through `<set>_files.json`, over the shorter
trace; the JAX tool writes no names, and its rows are then the set's
WAVs in name order): the largest score difference per stage and set, and
the files whose decision differs (raw max at 0.90, patience 3 at 0.90,
and the cascade's verifier at the swept operating point). Prints one JSON
object.
"""

import argparse
import json
from pathlib import Path

import numpy as np

from nanowakeword_tpu_torch.tools import quality_campaign as qc

SECTIONS = ("full_model", "lite_gate", "cascade", "operating_point_sweep")
# what the port adds to an eval JSON beside the JAX tool's numbers
PORT_KEYS = ("skipped_files", "device", "rate", "near_threshold")


def compare_results(reference: dict, judged: dict) -> dict:
    """-> {section: {"equal": bool, "differences": {...}, "near_threshold":
    {set: files}}} for every section both hold."""
    out = {}
    for section in SECTIONS:
        if section not in reference or section not in judged:
            continue
        ref, ours = reference[section], judged[section]
        differences = {}
        for key, value in ref.items():
            if isinstance(value, dict):
                mine = {k: v for k, v in ours.get(key, {}).items()
                        if k not in PORT_KEYS}
                diff = {k: [v, mine.get(k)] for k, v in value.items()
                        if mine.get(k) != v}
                if diff:
                    differences[key] = diff
            elif ours.get(key) != value:
                differences[key] = [value, ours.get(key)]
        near = {s: {k: [n["file"] for n in v] for k, v in entry.items()}
                for s, entry in ours.get("near_threshold", {}).items()}
        out[section] = {"equal": not differences,
                        "differences": differences,
                        "near_threshold": near}
    return out


def _decisions(rows: np.ndarray, op: dict, cascade: bool) -> np.ndarray:
    """[files, rules] detection decisions of each file under the rules
    the campaign reports."""
    if cascade:
        rules = [(op["threshold"], op["patience"])]
    else:
        rules = [(qc.THRESHOLD, 1), (qc.THRESHOLD, qc.PATIENCE)]
    return np.stack([qc._patience_score(rows, p) >= t for t, p in rules],
                    axis=1)


def _streamed_files(work: Path, stage: str, name: str) -> list:
    """The names of a trace file's rows: `<set>_files.json` where the port
    wrote one; else (the JAX tool's work folder) the set's WAVs in name
    order, which is what the JAX tool streamed when it skipped none, as
    its row count must then confirm."""
    listed = work / stage / f"{name}_files.json"
    if listed.exists():
        return json.loads(listed.read_text())
    files = sorted(p.name for p in (work / "eval" / name).glob("*.wav"))
    suffix = "_verifier" if stage == "traces_cascade" else ""
    rows = np.load(work / stage / f"{name}{suffix}.npy").shape[0]
    if rows != len(files):
        raise ValueError(f"{work / stage}: {rows} traces of {name} for "
                         f"{len(files)} files and no {listed.name}")
    return files


def compare_traces(work_a: Path, work_b: Path) -> dict:
    """-> {stage: {set: {"files", "chunks", "max_abs_diff",
    "decisions_differ"}}} over the files both work folders streamed."""
    sweep = work_a / "sweep.json"
    op = (json.loads(sweep.read_text())["operating_point"] if sweep.exists()
          else {"threshold": qc.THRESHOLD, "patience": qc.PATIENCE})
    out = {}
    for stage, suffixes in (("traces", [""]), ("traces_lite", [""]),
                            ("traces_cascade", ["_verifier", "_gate"])):
        if not (work_a / stage).is_dir() or not (work_b / stage).is_dir():
            continue
        out[stage] = {}
        for name in qc.EVAL_SETS:
            files_a = _streamed_files(work_a, stage, name)
            files_b = _streamed_files(work_b, stage, name)
            shared = [f for f in files_b if f in files_a]
            ia = [files_a.index(f) for f in shared]
            ib = [files_b.index(f) for f in shared]
            entry = {"files": len(shared), "chunks": 0, "max_abs_diff": 0.0,
                     "decisions_differ": []}
            for suffix in suffixes:
                a = np.load(work_a / stage / f"{name}{suffix}.npy")[ia]
                b = np.load(work_b / stage / f"{name}{suffix}.npy")[ib]
                n = min(a.shape[1], b.shape[1])
                a, b = a[:, :n], b[:, :n]
                entry["chunks"] += a.size
                if a.size:
                    entry["max_abs_diff"] = max(entry["max_abs_diff"], float(
                        np.abs(a - b).max()))
                if suffix in ("", "_verifier"):
                    cascade = suffix == "_verifier"
                    differ = (_decisions(a, op, cascade)
                              != _decisions(b, op, cascade)).any(axis=1)
                    entry["decisions_differ"] += [
                        shared[i] for i in np.nonzero(differ)[0]]
            out[stage][name] = entry
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("what", choices=["results", "traces"])
    p.add_argument("a", help="reference results JSON, or a work folder")
    p.add_argument("b", help="judged results JSON, or a work folder")
    args = p.parse_args(argv)
    if args.what == "results":
        report = compare_results(json.loads(Path(args.a).read_text()),
                                 json.loads(Path(args.b).read_text()))
    else:
        report = compare_traces(Path(args.a), Path(args.b))
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
