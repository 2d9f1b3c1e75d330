"""The port's benchmark program against the repository's `bench.py`, on the
CPU.

`bench.py` (the JAX package's benchmark) is loaded by path and run on JAX's
CPU backend, where `mel_frontend_fused` takes its XLA route. Its forward,
its streaming step and its `--all` compositions are held against
`nanowakeword_tpu_torch/bench.py`'s with the same weights (the JAX models'
variables carried into the port by `convert.py`). Then the port's program
runs whole at toy sizes, and the keys it prints are held to the ones
`bench.py` prints, read from its source.
"""

import ast
import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanowakeword_tpu.data.features import AudioFeatures as JaxAudioFeatures
from nanowakeword_tpu.data.features import \
    default_encoder_variables as jax_encoder_variables
from nanowakeword_tpu.models.embedding import build_encoder as jax_encoder
from nanowakeword_tpu.models.embedding import infer_encoder_arch
from nanowakeword_tpu.models.model import Model as JaxModel
from nanowakeword_tpu.ops import mel as jax_melops
from nanowakeword_tpu.ops.mel_pallas import \
    mel_frontend_fused as jax_mel_fused
from nanowakeword_tpu_torch import bench, cli
from nanowakeword_tpu_torch.convert import encoder_state_dict_from_flax
from nanowakeword_tpu_torch.data import features as port_features
from nanowakeword_tpu_torch.data.features import AudioFeatures, EMB_OFFSET
from nanowakeword_tpu_torch.export.frontend import seeded_audio
from nanowakeword_tpu_torch.models.embedding import encoder_from_state_dict
from nanowakeword_tpu_torch.models.model import Model
from nanowakeword_tpu_torch.ops.mel_cuda import mel_frontend_fused

REPO = Path(__file__).resolve().parent.parent
JAX_BENCH = REPO / "bench.py"
# Port vs JAX on the same weights with the bf16 encoder. Both round every
# layer to bf16, with sums in other orders, and the two log-mels round to
# bf16 from float64 and float32 sums. build_forward's bf16 scores differed
# by one bf16 step at 0.5 (2^-8 = 3.9e-3) on one of 18 tone clips and by 0
# on the rest (seeds 11, 21, 31): held to two steps. bench_all's float32
# classifiers on the bf16 encoder's features differed by at most 5.9e-4
# over two seeds of each audio family: held to 2e-3.
BF16_SCORE_TOL = 2.0 ** -7
BF16_FEATURE_TOL = 2e-3
OWN_MEL_TOL = 1e-3   # float32, each package on its own log-mel
JAX_MEL_TOL = 1e-5   # float32, the JAX log-mel fed to both
AUDIO_FAMILIES = ("cnn", "gru", "crnn", "bcresnet", "quartznet")
FEATURE_FAMILIES = ("dnn", "conformer", "transformer")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jbench():
    spec = importlib.util.spec_from_file_location("jax_bench", JAX_BENCH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _audio(kind: str, batch: int, n: int, seed: int) -> np.ndarray:
    """int16 audio: white noise, or tones (the bundled encoder's output is
    constant on white noise, so only a tone reaches its weights)."""
    if kind == "noise":
        return np.random.default_rng(seed).integers(
            -16000, 16000, (batch, n)).astype(np.int16)
    return np.round(seeded_audio(batch, n, seed=seed)).astype(np.int16)


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _port_encoder(dtype=torch.float32):
    return encoder_from_state_dict(encoder_state_dict_from_flax(
        port_features.default_encoder_variables()), "cpu").to(dtype)


def _jax_model(model_type, config):
    return JaxModel(config=dict(config), model_name=f"b_{model_type}",
                    input_shape=(16, 96), model_type=model_type, layer_dim=64,
                    n_blocks=2, dropout_prob=0.0)


def _port_model(jax_model, config):
    model = Model(config=dict(config), model_name=jax_model.model_name,
                  input_shape=(16, 96), model_type=jax_model.model_type,
                  layer_dim=64, n_blocks=2, dropout_prob=0.0, device="cpu")
    model.load_variables(_f32(jax_model.variables))
    return model


def _jax_pad(emb):
    return jnp.pad(emb, ((0, 0), (16 - emb.shape[1], 0), (0, 0)))


# -- the source of bench.py --------------------------------------------------


def _jax_function(name: str) -> ast.FunctionDef:
    tree = ast.parse(JAX_BENCH.read_text())
    return next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == name)


def _literal(node):
    """A node's constant value, tuples of them kept, anything else None."""
    if isinstance(node, ast.Tuple):
        return tuple(_literal(elt) for elt in node.elts)
    try:
        return ast.literal_eval(node)
    except ValueError:
        return None


def _emitted_keys() -> list:
    """The keys bench_all passes to `_emit`, in order: each f-string or
    loop variable expanded over the tuple its `for` loop iterates (a loop
    over anything else is visited once)."""
    keys = []

    def key(node, bound):
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            return bound[node.id]
        return "".join(str(part.value) if isinstance(part, ast.Constant)
                       else bound[part.value.id] for part in node.values)

    def visit(node, bound):
        if isinstance(node, ast.For):
            target = node.target
            names = ([target.id] if isinstance(target, ast.Name)
                     else [elt.id for elt in target.elts])
            for value in _literal(node.iter) or [None]:
                values = [value] if len(names) == 1 else value
                inner = {**bound, **dict(zip(names, values))}
                for stmt in node.body:
                    visit(stmt, inner)
            return
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "_emit"):
            keys.append(key(node.args[0], bound))
        for child in ast.iter_child_nodes(node):
            visit(child, bound)

    visit(_jax_function("bench_all"), {})
    return keys


def _headline_keys() -> list:
    """The keys of `result` in bench.py's main, in source order."""
    found = []
    for node in ast.walk(_jax_function("main")):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id == "result":
                found += [(k.lineno, k.col_offset, k.value)
                          for k in node.value.keys]
            elif (isinstance(target, ast.Subscript)
                  and isinstance(target.value, ast.Name)
                  and target.value.id == "result"):
                found.append((node.lineno, 0, target.slice.value))
    return [k for _, _, k in sorted(found)]


def _assigned_dict(function: str, name: str) -> dict:
    node = next(n for n in ast.walk(_jax_function(function))
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == name)
    return ast.literal_eval(node.value)


JAX_ALL_KEYS = [
    "dnn_features_scores_per_s", "cnn_e2e_clips_per_s", "gru_e2e_clips_per_s",
    "crnn_train_aug_clips_per_s", "crnn_train_aug_bf16_clips_per_s",
    "bcresnet_feature_clips_per_s", "quartznet_feature_clips_per_s",
    "conformer_stream_p50_ms", "transformer_stream_p50_ms"]
JAX_HEADLINE_KEYS = [
    "metric", "value", "unit", "vs_baseline", "on_chip_frame_ms",
    "mel_kernel_max_abs_diff", "p50_stream_frame_latency_ms", "note"]


def test_key_lists_read_from_bench_py():
    """The literal lists below are what bench.py prints today."""
    assert _emitted_keys() == JAX_ALL_KEYS
    assert _headline_keys() == JAX_HEADLINE_KEYS


@pytest.mark.parametrize("function,name,ours", [
    ("build_forward", "config", bench.CRNN_CONFIG),
    ("bench_stream_latency", "config", bench.CRNN_CONFIG),
    ("bench_on_chip_frame_latency", "config", bench.CRNN_CONFIG),
    ("bench_all", "base", bench.BASE),
])
def test_configurations_equal_bench_py(function, name, ours):
    assert _assigned_dict(function, name) == ours


# -- the headline forward and the streaming step ------------------------------


@pytest.fixture(scope="module")
def jax_forward(jbench):
    return jbench.build_forward()


@pytest.fixture(scope="module")
def port_forward(jax_forward):
    """The port's build_forward with the JAX bench's CRNN weights."""
    forward, model, encoder = bench.build_forward(device="cpu")
    model.load_variables(_f32(jax_forward[1]))
    return forward, model, encoder


@pytest.mark.parametrize("kind", ["noise", "tone"])
def test_build_forward_matches_jax(jax_forward, port_forward, kind):
    """int16 [3, 16000]: bf16 scores, the same carried weights."""
    x = _audio(kind, 3, 16000, seed=11)
    fwd, variables, enc_vars = jax_forward
    ref = np.asarray(fwd(variables, enc_vars, jnp.asarray(x)), np.float32)
    forward, model, encoder = port_forward
    assert all(p.dtype == torch.bfloat16 for p in model.module.parameters())
    assert all(b.dtype == torch.bfloat16 for b in model.module.buffers()
               if b.is_floating_point())
    out = forward(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16 and out.shape == (3,)
    out = out.float().numpy()
    assert np.isfinite(out).all() and ref.shape == out.shape
    assert np.abs(out - ref).max() <= BF16_SCORE_TOL


@pytest.fixture(scope="module")
def crnn_f32():
    jax_model = _jax_model("crnn", bench.CRNN_CONFIG)
    return jax_model, _port_model(jax_model, bench.CRNN_CONFIG)


@pytest.mark.parametrize("mel", ["own", "jax"])
def test_forward_float32_matches_jax(crnn_f32, mel):
    """The same composition with float32 weights and encoder: within 1e-3
    on each package's own log-mel, 1e-5 with the JAX log-mel in both."""
    jax_model, model = crnn_f32
    x = _audio("tone", 3, 16000, seed=12)
    enc_vars = jax_encoder_variables()
    jmel = jax_mel_fused(jnp.asarray(x))
    emb = jax_encoder(infer_encoder_arch(enc_vars)).apply(
        enc_vars, jmel[:, EMB_OFFSET:])
    ref = np.asarray(jax.nn.sigmoid(jax_model.module.apply(
        jax_model.variables, _jax_pad(emb), deterministic=True)))
    pmel = (mel_frontend_fused(torch.from_numpy(x)) if mel == "own"
            else torch.from_numpy(np.array(jmel)))
    with torch.no_grad():
        out = bench._classify(model.module, _port_encoder(), pmel).numpy()
    tol = OWN_MEL_TOL if mel == "own" else JAX_MEL_TOL
    assert out.shape == ref.shape == (3, 1)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)


def _jax_streaming_mel():
    """The JAX package's streaming log-mel in the place of the port's:
    [320 + 1280] samples -> the port's [10, 32] frames, of which it keeps
    the last 8."""
    step = jax.jit(lambda tail, chunk: jax_melops.mel_streaming_step(
        tail, chunk)[1])

    def mel(buf, out_dtype=torch.float32):
        assert buf.shape == (1600,)
        frames = np.asarray(step(jnp.asarray(buf[:320].numpy()),
                                 jnp.asarray(buf[320:].numpy())))
        return torch.from_numpy(np.concatenate(
            [np.zeros((2, 32), np.float32), frames])).to(out_dtype)
    return mel


@pytest.mark.parametrize("mel", ["own", "jax"])
def test_stream_step_matches_jax(crnn_f32, monkeypatch, mel):
    """20 chunks of the fused streaming step (bench.py:133-137): the
    score of every chunk, port vs JAX, on the CRNN of the streaming
    benchmarks."""
    jax_model, model = crnn_f32
    if mel == "jax":
        monkeypatch.setattr(port_features, "mel_frontend_fused",
                            _jax_streaming_mel())
    af = JaxAudioFeatures()

    def fused(variables, state, chunk):
        new_state = af._stream_step_impl(state, chunk)
        feats = new_state.feat_buf[-16:][None]
        logits = jax_model.module.apply(variables, feats, deterministic=True)
        return new_state, jax.nn.sigmoid(logits.reshape(()))

    jstep = jax.jit(fused)
    features = AudioFeatures(device="cpu")
    chunk, score, step = bench._stream_step(features, model.module)
    audio = _audio("tone", 1, 20 * 1280, seed=13)[0].astype(np.float32)
    state = af.state
    ref, out = [], []
    for c in range(20):
        piece = audio[c * 1280:(c + 1) * 1280]
        state, s = jstep(jax_model.variables, state, jnp.asarray(piece))
        ref.append(float(s))
        chunk.copy_(torch.from_numpy(piece))
        step()
        out.append(float(score))
    tol = OWN_MEL_TOL if mel == "own" else JAX_MEL_TOL
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    assert np.ptp(out) > 0      # the scores move with the audio


# -- one --all forward of each family ----------------------------------------


@pytest.fixture(scope="module")
def jax_bf16_encoder():
    enc_vars = jax_encoder_variables()
    return jax_encoder(infer_encoder_arch(enc_vars), dtype=jnp.bfloat16,
                       precision=None), enc_vars


@pytest.mark.parametrize("family", FEATURE_FAMILIES + AUDIO_FAMILIES)
def test_all_family_forward_matches_jax(jax_bf16_encoder, family):
    """At batch 2 with bench_all's widths: the classifier on float32
    features within 1e-5 (the dnn's bench composition; the model part of
    the conformer's and transformer's streaming step), and, for the
    families bench_all scores from audio, its composition (bench.py:
    279-283: the mel in bf16, the bf16 encoder, the float32 classifier)
    within BF16_FEATURE_TOL."""
    jax_model = _jax_model(family, bench.BASE)
    model = _port_model(jax_model, bench.BASE)
    feats = np.random.default_rng(14).normal(
        size=(2, 16, 96)).astype(np.float32)
    ref = np.asarray(jax.nn.sigmoid(jax_model.module.apply(
        jax_model.variables, jnp.asarray(feats), deterministic=True)))
    with torch.no_grad():
        out = torch.sigmoid(model.module(torch.from_numpy(feats))).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=JAX_MEL_TOL)
    if family not in AUDIO_FAMILIES:
        return
    encoder, enc_vars = jax_bf16_encoder
    x = _audio("tone", 2, 16000, seed=15)
    mel = jax_mel_fused(jnp.asarray(x), out_dtype=jnp.bfloat16)
    emb = encoder.apply(enc_vars, mel[:, EMB_OFFSET:])
    ref = np.asarray(jax.nn.sigmoid(jax_model.module.apply(
        jax_model.variables, _jax_pad(emb), deterministic=True)), np.float32)
    with torch.no_grad():
        out = bench._classify(model.module, _port_encoder(torch.bfloat16),
                              mel_frontend_fused(torch.from_numpy(x),
                                                 out_dtype=torch.bfloat16))
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= BF16_FEATURE_TOL


# -- the program at toy sizes -------------------------------------------------


TOY = {"bench_throughput": {"batch": 3, "iters": 2},
       "bench_stream_latency": {"n_frames": 3},
       "bench_on_chip_frame_latency": {"k_frames": 3, "reps": 1},
       "bench_all": {"batch": 4}}
TOY_DEPTHS = {"ALL_ITERS": 2, "TRAIN_STEPS": 2, "STREAM_STEPS": 3}


def _toy(monkeypatch):
    for name, sizes in TOY.items():
        monkeypatch.setattr(bench, name, functools.partial(
            getattr(bench, name), **sizes))
    for name, value in TOY_DEPTHS.items():
        monkeypatch.setattr(bench, name, value)


def test_headline_prints_bench_py_keys(monkeypatch, capsys):
    _toy(monkeypatch)
    bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    result = json.loads(lines[-1])
    expected = [k for k in _headline_keys() if k != "vs_baseline"] + ["card"]
    assert list(result) == expected
    assert result["metric"] == bench.METRIC
    assert result["unit"] == "clips/s" and result["card"] == "cpu"
    for key in ("value", "on_chip_frame_ms", "p50_stream_frame_latency_ms"):
        assert np.isfinite(result[key]) and result[key] > 0, key
    assert result["mel_kernel_max_abs_diff"] == 0.0   # plain vs plain


def test_all_prints_bench_py_keys(monkeypatch, capsys):
    """`--all` at batch 4, 2 iterations and 2 training steps: the nine
    keys, as each result comes and in the summary, in bench.py's order."""
    _toy(monkeypatch)
    bench.main(["--all", "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.strip() and ":" in ln and not ln.startswith("[")]
    keys = [ln.split(":")[0].strip() for ln in lines]
    assert keys == _emitted_keys() * 2
    values = [float(ln.split(":")[1].replace(",", "")) for ln in lines]
    assert all(np.isfinite(v) and v > 0 for v in values), lines


def test_mel_tripwire_on_the_cpu():
    """On a CPU tensor the wrapper is the plain version: the tripwire's
    comparisons run and find nothing."""
    assert bench.check_mel_kernel_exact(device="cpu") == 0.0


def test_cuda_without_a_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main([])


def test_cli_bench_runs_bench_main(monkeypatch):
    calls = []
    monkeypatch.setattr(bench, "main", calls.append)
    assert "--bench" in cli._build_parser().format_help()
    cli.main(["--bench", "--device", "cpu"])
    assert calls == [["--device", "cpu"]]


def test_bench_imports_nothing_of_jax():
    """The port's headline in a fresh process at toy sizes: one JSON line,
    and no jax, flax or nanowakeword_tpu in sys.modules."""
    code = (
        "import functools, json, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from nanowakeword_tpu_torch import bench\n"
        f"for name, sizes in {TOY!r}.items():\n"
        "    setattr(bench, name, functools.partial(getattr(bench, name),"
        " **sizes))\n"
        "bench.main(['--device', 'cpu'])\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'nanowakeword_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.strip().splitlines()
    assert out[-1] == "[]"
    assert json.loads(out[-2])["metric"] == bench.METRIC
