"""The harness on the CPU: its result line, the cells it finds as files, the
modules it loads, the metrics' arithmetic and the operation counts."""

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from port_bench import compare, flops
from port_bench import trace as tracemod
from port_bench.run import FORBIDDEN, load_json
from port_bench.tests.conftest import ROOT, measure_cpu, spec, tiny_cell

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _config(name: str) -> dict:
    return load_json(os.path.join(ROOT, "port_bench", "configs",
                                  name + ".json"))


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(trace):
    cell = tiny_cell("crnn_stream")
    _, line = measure_cpu(cell, trace=trace)
    extra = ["breakdown"] if trace else []
    assert list(line) == CONTRACT_KEYS + extra + ["checks"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in cell.metrics(trace)}
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["checks"]["score_gap"]) == {"value", "limit"}
    json.dumps(line)


def test_cells_report_their_metrics():
    s = spec()
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    for w in s["workloads"]:
        from port_bench.run import Cell
        cell = Cell(s, w["name"], ROOT)
        reported = {m["name"] for m in cell.metrics(False)}
        assert "setup_s" in reported and len(reported) >= 2
        layer = cell.metrics(True)
        assert layer
        assert {m["moves"] for m in layer} <= reported
        for m in layer + cell.metrics(False):
            assert os.path.exists(os.path.join(
                ROOT, "port_bench", "metrics", m["name"] + ".py"))


def test_main_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench", "--workload", "crnn_stream",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_cell_traffic_and_metric_added_as_files(tmp_path):
    """A later change adds a cell with its own traffic mix, limits and
    per-layer metric by new files and BENCHMARK.json entries alone."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(os.path.join(ROOT, "port_bench"), root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    s = spec()
    bench = root / "port_bench"
    traffic = json.loads((bench / "traffic" / "stream.json").read_text())
    traffic["clip_chunks"] = [16, 17]
    (bench / "traffic" / "stream_short.json").write_text(json.dumps(traffic))
    (bench / "limits" / "crnn_stream_short.json").write_text(
        (bench / "limits" / "crnn_stream.json").read_text())
    (bench / "metrics" / "stream.traced_chunks.py").write_text(
        "def read(result):\n"
        "    return None if result.trace is None else result.trace.units\n")
    s["workloads"].append({"name": "crnn_stream_short",
                           "config": "hey_nano_crnn",
                           "traffic": "stream_short", "chips": 1,
                           "why": "short clips"})
    s["per_layer"].append({"name": "stream.traced_chunks", "unit": "chunks",
                           "better": "higher", "source": "program_counter",
                           "layer": "interpreter",
                           "moves": "stream_chunks_per_s",
                           "workloads": ["crnn_stream_short"]})
    for m in s["end_to_end"]:
        if "workloads" in m and "crnn_stream" in m["workloads"]:
            m["workloads"].append("crnn_stream_short")
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    script = (
        "import json, sys\n"
        "from port_bench.tests.conftest import measure_cpu, tiny_cell\n"
        "cell = tiny_cell('crnn_stream_short', root='.')\n"
        "cell.traffic['clip_chunks'] = [16, 17]\n"
        "_, line = measure_cpu(cell, trace=True)\n"
        "import port_bench\n"
        "print(json.dumps({'line': line, 'from': port_bench.__file__}))\n")
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{ROOT}")
    proc = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["from"].startswith(str(root))
    line = out["line"]
    assert line["correct"] is True
    assert line["metrics"]["stream.traced_chunks"]["value"] == 8


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_of_the_harness_imports_jax_or_the_jax_package():
    for folder, _, files in os.walk(os.path.join(ROOT, "port_bench")):
        for name in files:
            if name.endswith(".py"):
                for module in _imports(os.path.join(folder, name)):
                    assert module.split(".")[0] not in FORBIDDEN, \
                        (name, module)


def test_the_reference_imports_nothing_of_the_program():
    for folder, _, files in os.walk(os.path.join(ROOT, "port_bench",
                                                 "reference")):
        for name in files:
            if not name.endswith(".py"):
                continue
            for module in _imports(os.path.join(folder, name)):
                top = module.split(".")[0]
                assert top in ("__future__", "port_bench", "numpy", "torch",
                               "json", "struct", "math", "functools",
                               "importlib", "dataclasses"), (name, module)
                assert not module.startswith("port_bench.") or \
                    module.startswith("port_bench.reference"), (name, module)


def test_a_run_loads_no_jax_module_by_whole_top_level_name():
    script = (
        "import sys\n"
        "from port_bench.tests.conftest import measure_cpu, tiny_cell\n"
        "measure_cpu(tiny_cell('conformer_bulk_2s'))\n"
        "from port_bench.run import forbidden_modules\n"
        "assert 'nanowakeword_tpu_torch' in sys.modules\n"
        "print(forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from port_bench import run
    monkeypatch.setitem(sys.modules, "nanowakeword_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert run.forbidden_modules() == ["flax.core"]


def test_score_gap_reads_the_logit_gap_and_ignores_two_ulps():
    p = np.array([1e-4, 0.5, 0.9])
    q = (p + 1e-3 * p * (1 - p)).astype(np.float32)
    assert np.allclose(compare.score_gaps(q, p), 1e-3, rtol=5e-3)
    one_ulp = np.float32(0.75) + np.spacing(np.float32(0.75))
    assert compare.score_gaps(np.array([one_ulp]), np.array([0.75]))[0] == 0
    assert compare.score_gaps(np.array([0.3]), np.array([0.0]))[0] > 1e4


def test_mel_counts_by_hand_at_one_shape():
    w = flops.mel_work(2, 1600)
    rows, frames = 12, 10
    assert w.matmul_flops == 2 * (2 * rows * 160 * 256 + 2 * frames * 128 * 32)
    assert w.elementwise_flops == 2 * frames * (128 * 25 + 32)
    assert w.bytes == 2 * (2 * 1600 + 4 * frames * 32)
    assert w.least_seconds() == max(w.bytes / 3.35e12,
                                    w.matmul_flops / 989e12
                                    + w.elementwise_flops / 67e12)


def test_model_counts_by_hand_at_one_shape():
    # wide128 encoder over 76 frames: 34, 14, 4, 1 output frames
    assert flops.encoder_flops(76) == 2 * (34 * 128 * 320 + 14 * 128 * 1024
                                           + 4 * 128 * 1024 + 1 * 128 * 512
                                           + 128 * 96)
    crnn, dnn = (_config("hey_nano_crnn")["models"][n]
                 for n in ("hey_nano_crnn", "hey_nano_crnn_lite"))
    conformer = _config("conformer_s144")["models"]["conformer_s144"]
    head = 2 * (96 * 48 + 48)
    convs = 16 * 96 * 16 * 9 + 8 * 48 * 32 * 16 * 9 + 4 * 24 * 32 * 32 * 9
    gru = 2 * 12 * (64 * 192 + 64 * 192) + 2 * 12 * (128 * 192 + 64 * 192)
    assert flops.classifier_flops(crnn) == 2 * (convs + gru + 128 * 96) + head
    block = (2 * 16 * 8 * 144 * 144 + 4 * 16 * 144 * 144
             + 2 * 16 * 16 * 144 + 16 * 144 * 288 + 16 * 144 * 31
             + 16 * 144 * 144)
    assert flops.classifier_flops(conformer) == \
        2 * (16 * 96 * 144 + 16 * block + 144 * 96) + head
    assert flops.classifier_flops(dnn) == \
        2 * (1536 * 8 + 64 + 64) + 2 * (8 * 4 + 4)


def test_the_seeded_layout_is_the_programs():
    """The conformer's drawn tree loads into the program's own module
    (strictly) and gives the same scores there as in the reference."""
    import torch
    from nanowakeword_tpu_torch.models.model import Model
    from port_bench import program
    from port_bench.reference import models as refmodels
    model = dict(_config("conformer_s144")["models"]["conformer_s144"],
                 n_blocks=2)
    layout = refmodels.family("conformer").layout(model)
    variables = program.seeded_variables(layout, 5, torch.device("cpu"))
    m = Model(config={k: model[k] for k in ("conformer_d_model",
                                            "conformer_n_head",
                                            "embedding_dim")},
              model_name="c", model_type="conformer", n_blocks=2,
              device="cpu")
    m.load_variables(variables)
    x = torch.randn(3, 16, 96, generator=torch.Generator().manual_seed(1))
    got = torch.sigmoid(m(x)).reshape(-1).double()
    want = refmodels.classifier(x, refmodels.to_tensors(
        variables, refmodels.REFERENCE, "cpu"), "conformer",
        refmodels.REFERENCE)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-6)


def test_trace_arithmetic():
    t = tracemod.Trace(
        device=[(10, 20, "k1"), (15, 30, "Memcpy HtoD (Pinned -> Device)"),
                (50, 60, "mel_frontend_kernel<short, float>"),
                (70, 75, "k2")],
        host=[(0, 100, "outer"), (30, 52, "aten::copy_"),
              (60, 71, "cudaGraphLaunch")],
        ranges={tracemod.WINDOW: [(0, 100)],
                "port_bench.embed_clips": [(5, 62)],
                "port_bench.run_batch": [(62, 99)]},
        units=2)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(35e-6)
    assert t.device_s(keep=tracemod.is_copy) == pytest.approx(15e-6)
    assert t.device_s(within="port_bench.embed_clips",
                      exclude="mel_frontend") == pytest.approx(10e-6)
    assert t.device_s(name="mel_frontend") == pytest.approx(10e-6)
    assert t.device_s(within="port_bench.run_batch") == pytest.approx(5e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["Memcpy HtoD (Pinned -> Device)",
                                 pytest.approx(15e-6)]
    assert b["idle_gaps"][:2] == [["outer", pytest.approx(25e-6)],
                                  ["aten::copy_", pytest.approx(20e-6)]]
