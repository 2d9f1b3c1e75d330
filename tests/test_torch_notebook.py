"""The port's quickstart notebook, run on the CPU.

notebooks/Train_Your_First_Wake_Word_Model_torch.ipynb is read as JSON
(no nbformat), its code cells are held to the no-JAX import check of
tests/test_torch_evaluators.py, and then executed in order in a temporary
working directory with `--device cpu` and the steps cut to a few dozen:
`-t -T -d` writes the model and its lite gate, and the cascade scores the
positive and the negative phrase past the model's warm-up.
"""

import importlib.util
import json
import re
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
NOTEBOOK = REPO / "notebooks" / "Train_Your_First_Wake_Word_Model_torch.ipynb"
MODEL_DIR = Path("trained_models") / "my_first_model" / "model"
# the notebook's text -> what the CPU run executes: the device, and the
# training and distillation steps cut from 2000 and 500
CPU_CUTS = (
    ('"steps": 2000, "stabilization_steps": 200',
     '"steps": 40, "stabilization_steps": 10'),
    ('"distillation": {"enabled": True, "steps": 500}',
     '"distillation": {"enabled": True, "steps": 30}'),
    ('"-t", "-T", "-d"]', '"-t", "-T", "-d", "--device", "cpu"]'),
    ("cascade=True)", 'cascade=True, device="cpu")'),
)


def _code_cells() -> list:
    cells = json.loads(NOTEBOOK.read_text())["cells"]
    return ["".join(c["source"]) for c in cells if c["cell_type"] == "code"]


def _evaluators_check():
    """tests/test_torch_evaluators.py, loaded under a private name."""
    name = "torch_evaluators_checks"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, REPO / "tests" / "test_torch_evaluators.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cells_import_nothing_of_jax(tmp_path):
    check = _evaluators_check()
    cells = _code_cells()
    assert len(cells) == 5
    for k, source in enumerate(cells):
        path = tmp_path / f"cell_{k}.py"
        path.write_text(source)
        roots = check._imported_roots(path)
        assert not roots & {"jax", "jaxlib", "flax", "optax",
                            "nanowakeword_tpu"}, (k, roots)
    assert "nanowakeword_tpu_torch" in check._imported_roots(path)


def test_cells_run_on_the_cpu(tmp_path, monkeypatch, capsys):
    source = "\n\n".join(_code_cells())
    for old, new in CPU_CUTS:
        assert source.count(old) == 1, old
        source = source.replace(old, new)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "path", list(sys.path))    # cell 1 adds to it
    exec(compile(source, str(NOTEBOOK), "exec"), {"__name__": "__main__"})
    for name in ("my_first_model.nww", "my_first_model_lite.nww"):
        assert (tmp_path / MODEL_DIR / name).is_file(), name
    out = capsys.readouterr().out
    scores = [float(v) for v in re.findall(
        r"max (?:positive|negative) score: (\S+)", out)]
    assert len(scores) == 2, out[-2000:]
    assert all(0.0 <= s <= 1.0 for s in scores), scores
    # the clips stream past the model's 16-frame warm-up, so chunks are
    # scored: a score of exactly 0.0 is the warm-up guard's
    assert any(s > 0.0 for s in scores), scores
