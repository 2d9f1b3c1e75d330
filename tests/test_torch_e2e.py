"""The port's end-to-end training (train/e2e.py) against the JAX package's,
on the CPU, and two repairs of the training stage.

Both packages warm-start the encoder from the bundled asset; the JAX
classifier's weights are carried into the port (torch cannot draw JAX's
initialisation), so forward passes and training steps start from the same
weights. The audio is a dozen formant clips of the port's synthesizer,
read back from 16-bit WAVs, so the mel is the plain version's in both
packages.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanowakeword_tpu.models.model import Model as JaxModel
from nanowakeword_tpu.train import e2e as jax_e2e
from nanowakeword_tpu.train.optim import build_optimizer
from nanowakeword_tpu.train.step import create_train_state
from nanowakeword_tpu.train.step import make_train_step as jax_train_step
from nanowakeword_tpu_torch.convert import (
    encoder_state_dict_from_flax, flax_encoder_variables_from_state_dict)
from nanowakeword_tpu_torch.data.dataset import (AdaptiveLossAwareDataset,
                                                 DynamicClassAwareSampler)
from nanowakeword_tpu_torch.data.features import pretrained_encoder_variables
from nanowakeword_tpu_torch.data.generator.tts import (formant_synthesize,
                                                      generate_samples)
from nanowakeword_tpu_torch.models.model import Model
from nanowakeword_tpu_torch.ops import mel_cuda
from nanowakeword_tpu_torch.train.cached import materialize_rows
from nanowakeword_tpu_torch.train.e2e import (AudioClipDataset, E2EModel,
                                              split_variables)
from nanowakeword_tpu_torch.train.optim import Optimizer
from nanowakeword_tpu_torch.train.step import make_train_step
from nanowakeword_tpu_torch.train.trainer import Trainer
from nanowakeword_tpu_torch.trainer import run_pipeline

CLIP = 16000
CONTEXT = 4          # 16000 samples give 3 embedding frames: padded to 4
STEP_TOL = 1e-5      # float32 forward/backward in two frameworks
SCORE_TOL = 1e-3     # the score-trace bar of tests/test_score_trace.py
# bf16 encoder, two frameworks: each conv rounds its output to bf16 once
# (torch, bias inside the sum) or twice (XLA, bias added in bf16), so an
# activation can land one bf16 ulp (2^-8 relative) apart. Measured on this
# batch on the CPU: max |logit diff| 2.1e-3 for logits in [-0.53, 0.35]
# (float32: 1.1e-6); the bar is 5x the measurement, on absolute logits
BF16_TOL = 1e-2
CFG = {"activation_function": "relu", "embedding_dim": 16,
       "optimizer_type": "adamw", "learning_rate_max": 1e-2,
       "lr_scheduler_type": "onecycle", "weight_decay": 0.01}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file: the host loop's two threads of
    tiny steps otherwise spin torch's thread pool against the other test
    workers' processes, which made a 1 s test take 45 s."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """4 positive and 8 negative formant clips (0.9-1.8 s) as 16-bit WAVs:
    the shorter ones are padded to CLIP, the longer ones cropped."""
    root = tmp_path_factory.mktemp("e2e_corpus")
    pos, neg = root / "pos", root / "neg"
    generate_samples(["hey nano"], 4, str(pos), seed=1)
    generate_samples(["ok tomato", "hey banana split", "open the window"],
                     8, str(neg), seed=2)
    return {"targets": [str(pos)], "negatives": [str(neg)]}


@pytest.fixture(scope="module")
def batch(corpus):
    dataset = AudioClipDataset(corpus, clip_samples=CLIP, seed=3)
    audio, labels, _ = dataset.gather(np.arange(len(dataset)))
    assert audio.shape == (12, CLIP) and np.array_equal(audio,
                                                        np.round(audio))
    return audio, labels


def _jax_e2e(freeze=False, dtype=jnp.float32):
    """(the JAX EndToEndModule, its variables as numpy): the encoder from
    the bundled asset, a width-16 DNN classifier from JAX's init."""
    clf = JaxModel(config=dict(CFG), model_name="e2e", n_classes=1,
                   input_shape=(CONTEXT, 96), model_type="dnn", layer_dim=16,
                   n_blocks=1, dropout_prob=0.0, seed=3)
    handle = jax_e2e.E2EModel(clf, clip_samples=CLIP, context_frames=CONTEXT)
    module = jax_e2e.EndToEndModule(
        classifier=clf.module, context_frames=CONTEXT,
        freeze_encoder=freeze, encoder_dtype=dtype,
        encoder_arch=handle.module.encoder_arch)
    return module, jax.tree_util.tree_map(np.asarray, handle.variables)


def _port_e2e(variables, freeze=False, dtype=torch.float32, dropout=0.0,
              cfg=None):
    clf = Model(config=dict(cfg or CFG), model_name="e2e",
                input_shape=(CONTEXT, 96), model_type="dnn", layer_dim=16,
                n_blocks=1, dropout_prob=dropout, device="cpu")
    e2e = E2EModel(clf, context_frames=CONTEXT, freeze_encoder=freeze,
                   encoder_dtype=dtype)
    if variables is not None:
        e2e.load_variables(variables)
    return e2e


def _close(ours, ref, atol, path=""):
    assert set(ours) == set(ref), path
    for k in ref:
        if isinstance(ref[k], dict):
            _close(ours[k], ref[k], atol, f"{path}/{k}")
        else:
            np.testing.assert_allclose(ours[k], np.asarray(ref[k]), rtol=0,
                                       atol=atol, err_msg=f"{path}/{k}")


@pytest.mark.parametrize("dtype,tol", [
    pytest.param("float32", STEP_TOL, id="float32"),
    pytest.param("bfloat16", BF16_TOL, id="bfloat16")])
def test_forward_matches_jax(batch, dtype, tol):
    """Eval-mode logits of the whole stack (mel, encoder in `dtype`,
    padded context, classifier) from the same weights and audio."""
    audio, _ = batch
    module, variables = _jax_e2e(dtype=getattr(jnp, dtype))
    ref = np.asarray(module.apply(variables, jnp.asarray(audio)))
    e2e = _port_e2e(variables, dtype=getattr(torch, dtype))
    with torch.no_grad():
        ours = e2e.module(torch.from_numpy(audio)).numpy()
    assert ours.shape == ref.shape == (12, 1)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol)


def test_training_step_matches_jax(batch):
    """One SGD step in float32 from the same weights and batch: loss, grad
    norm, logits, then every updated encoder and classifier weight."""
    audio, labels = batch
    cfg = dict(CFG, optimizer_type="sgd", lr_scheduler_type="cosine",
               learning_rate_max=0.05, learning_rate_base=1e-4)
    module, variables = _jax_e2e()
    tx = build_optimizer(cfg, total_steps=10)
    jstate = create_train_state(module, jax.tree_util.tree_map(
        jnp.asarray, variables), tx)
    jstate, jm = jax_train_step(module, tx, donate=False)(
        jstate, jnp.asarray(audio), jnp.asarray(labels))
    ref = np.asarray(jm.packed)

    e2e = _port_e2e(variables, cfg=cfg).train()
    optimizer = Optimizer(list(e2e.module.parameters()), cfg, 10)
    metrics = make_train_step(e2e.module, optimizer)(
        torch.from_numpy(audio), torch.from_numpy(labels))
    np.testing.assert_allclose(metrics.loss.item(), ref[0], rtol=STEP_TOL)
    np.testing.assert_allclose(metrics.grad_norm.item(), ref[1],
                               rtol=STEP_TOL)
    np.testing.assert_allclose(metrics.packed.numpy()[2:], ref[2:], rtol=0,
                               atol=STEP_TOL)
    moved = jax.tree_util.tree_map(np.asarray, jstate.params)
    assert np.abs(moved["encoder"]["Conv_0"]["kernel"]
                  - variables["params"]["encoder"]["Conv_0"]["kernel"]
                  ).max() > 1e-4
    _close(e2e.variables["params"], moved, STEP_TOL)


def test_frozen_encoder_decays_like_jax(batch):
    """freeze_encoder stops the gradient, not the optimizer: AdamW decays
    the frozen weights by lr * wd a step, in both packages."""
    audio, labels = batch
    module, variables = _jax_e2e(freeze=True)
    tx = build_optimizer(CFG, total_steps=20)
    jstate = create_train_state(module, jax.tree_util.tree_map(
        jnp.asarray, variables), tx)
    jstep = jax_train_step(module, tx, donate=False)
    e2e = _port_e2e(variables, freeze=True).train()
    optimizer = Optimizer(list(e2e.module.parameters()), CFG, 20)
    step = make_train_step(e2e.module, optimizer)
    for _ in range(3):
        jstate, _ = jstep(jstate, jnp.asarray(audio), jnp.asarray(labels))
        step(torch.from_numpy(audio), torch.from_numpy(labels))
    ref = jax.tree_util.tree_map(np.asarray, jstate.params["encoder"])
    start = variables["params"]["encoder"]
    ours = e2e.variables["params"]["encoder"]
    for name, leaf in ref.items():
        for k in leaf:
            decayed = np.abs(leaf[k] - start[name][k]).max()
            assert decayed > 0 or not np.abs(start[name][k]).any()
            np.testing.assert_allclose(ours[name][k], leaf[k], rtol=1e-6,
                                       atol=1e-9, err_msg=f"{name}/{k}")


def test_split_variables_and_encoder_round_trip():
    """The encoder's state_dict <-> flax variables round trip is exact,
    and split_variables gives the JAX package's halves."""
    asset = pretrained_encoder_variables()
    back = flax_encoder_variables_from_state_dict(
        encoder_state_dict_from_flax(asset))
    _close(back["params"], asset["params"], 0.0)
    _, variables = _jax_e2e()
    ours = split_variables(variables)
    ref = jax_e2e.split_variables(variables)
    for a, b in zip(ours, ref):
        _close(a, b, 0.0)
    e2e = _port_e2e(variables)
    enc, clf = split_variables(e2e.variables)
    _close(enc, ref[0], 0.0)
    _close(clf, ref[1], 0.0)


def test_resume_mid_run_is_bitwise(corpus, tmp_path):
    """A host-loop e2e run resumed from its step-10 checkpoint replays the
    straight run: the random crops' generator is checkpointed beside the
    sampler's."""
    cfg = dict(CFG, steps=20, hardness_reset_interval=8,
               early_stopping_patience=0, stabilization_steps=2,
               checkpointing={"enabled": True, "interval_steps": 10,
                              "limit": 5})
    manifests = {c: {f"{c}_0": d[0]} for c, d in corpus.items()}

    def build():
        dataset = AudioClipDataset(corpus, clip_samples=CLIP)
        sampler = DynamicClassAwareSampler(
            dataset, {"targets": 2, "negatives": 4}, manifests)
        return dataset, sampler, _port_e2e(None, dropout=0.1, cfg=cfg)

    crops = []
    fixed_length = AudioClipDataset._fixed_length

    def recording(self, data):
        crops.append(len(data) > CLIP)
        return fixed_length(self, data)

    ds_a, smp_a, e2e_a = build()
    run_a = tmp_path / "a" / "training_artifacts"
    AudioClipDataset._fixed_length = recording
    try:
        Trainer(e2e_a, cfg).train_model((ds_a, smp_a), None, 20, str(run_a))
    finally:
        AudioClipDataset._fixed_length = fixed_length
    assert sum(crops) > 10
    mid = run_a / "checkpoints" / "checkpoint_step_10.pkl"
    run_b = tmp_path / "b" / "training_artifacts"
    (run_b / "checkpoints").mkdir(parents=True)
    shutil.copy(mid, run_b / "checkpoints" / mid.name)

    ds_b, smp_b, e2e_b = build()
    t_b = Trainer(e2e_b, cfg)
    t_b.train_model((ds_b, smp_b), None, 20, str(run_b),
                    resume_from_dir=str(tmp_path / "b"))
    assert e2e_b.history["loss"] == e2e_a.history["loss"]
    for (k, a), b in zip(e2e_a.module.state_dict().items(),
                         e2e_b.module.state_dict().values()):
        assert torch.equal(a, b), k
    np.testing.assert_array_equal(ds_b.sample_hardness, ds_a.sample_hardness)


def test_e2e_stage_exports_the_trained_encoder(corpus, tmp_path):
    """`end_to_end.enabled` through run_pipeline on the CPU: the `.nww`
    bundles the trained encoder (not the asset), the raw parameters are
    written, and both packages' interpreters serve the artifact alike."""
    from nanowakeword_tpu.export.artifact import load_nww as jax_load_nww
    from nanowakeword_tpu.interpreter.nanointerpreter import \
        NanoInterpreter as JaxNanoInterpreter
    from nanowakeword_tpu_torch import NanoInterpreter

    cfg = dict(CFG, model_name="e2e", output_dir=str(tmp_path),
               model_type="dnn", layer_size=16, n_blocks=1, dropout_prob=0.0,
               steps=6, early_stopping_patience=0,
               batch_composition={"targets": 2, "negatives": 4},
               show_training_summary=False,
               end_to_end={"enabled": True, "audio_manifest": corpus,
                           "clip_samples": CLIP, "context_frames": CONTEXT})
    before = mel_cuda.launches
    out = run_pipeline(cfg, train_model=True, device="cpu")
    assert mel_cuda.launches == before       # the plain version on the CPU
    assert len(out["model"].history["loss"]) == 6
    path = out["artifact"]
    assert os.path.exists(path) and out["lite_artifact"] is None
    assert os.path.exists(os.path.join(os.path.dirname(path), "e2e.msgpack"))
    # the frontend graphs of the trained encoder beside it
    model_dir = os.path.dirname(path)
    for suffix in ("_frontend", "_mel_stream", "_embedding"):
        assert os.path.exists(os.path.join(model_dir, f"e2e{suffix}.onnx"))

    header, _, encoder_vars = jax_load_nww(path)
    assert header["has_encoder"] and header["input_shape"] == [CONTEXT, 96]
    trained = flax_encoder_variables_from_state_dict(
        out["model"].module.encoder.state_dict())
    _close(jax.tree_util.tree_map(np.asarray, encoder_vars)["params"],
           trained["params"], 0.0)
    asset = pretrained_encoder_variables()["params"]["Conv_0"]["kernel"]
    assert np.abs(trained["params"]["Conv_0"]["kernel"] - asset).max() > 0
    # the embedding graph holds the trained first convolution, in the
    # ONNX layout [out, in, kh, kw]
    from nanowakeword_tpu_torch.export import onnx_proto
    graph = onnx_proto.load_model(os.path.join(model_dir,
                                               "e2e_embedding.onnx")).graph
    np.testing.assert_array_equal(
        graph.initializers[graph.nodes[1].inputs[1]],
        trained["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))

    clip = (formant_synthesize("hey nano", seed=9) * 32767).astype(np.int16)
    ours = NanoInterpreter.load_model(path, device="cpu").predict_clip(clip)
    ref = JaxNanoInterpreter.load_model(path).predict_clip(clip)
    a = np.array([r.score for r in ours])
    b = np.array([r.score for r in ref])
    assert len(a) == len(b) > 0 and np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=SCORE_TOL)


# -- repairs of the training stage ---------------------------------------------


def test_materialize_rows_logs_padded_and_truncated_rows(tmp_path, capsys):
    """Rows of another frame count are cut or padded to the most common
    length, as the JAX package does, and the counts are logged."""
    rng = np.random.default_rng(0)
    short = rng.normal(size=(6, 16, 96)).astype(np.float32)
    long_ = rng.normal(size=(4, 41, 96)).astype(np.float32)
    np.save(tmp_path / "a.npy", short)
    np.save(tmp_path / "b.npy", long_)
    dataset = AdaptiveLossAwareDataset(
        {"targets": {"a": str(tmp_path / "a.npy")},
         "negatives": {"b": str(tmp_path / "b.npy")}})
    feats, labels = materialize_rows(dataset)
    assert feats.shape == (10, 16, 96)
    np.testing.assert_array_equal(feats[:6], short)
    np.testing.assert_array_equal(feats[6:], long_[:, :16])
    np.testing.assert_array_equal(labels, [1] * 6 + [0] * 4)
    assert ("0 of 10 feature rows were zero-padded and 4 truncated to the "
            "most common length of 16 frames") in " ".join(
                capsys.readouterr().out.split())


def test_failed_distillation_is_skipped(tmp_path, monkeypatch):
    """-T with distillation on: a failure of distillation is logged and
    skipped, as the JAX package does; the main `.nww`, the raw parameters
    and the journal are still written."""
    from nanowakeword_tpu_torch.train import distill

    def broken(**kwargs):
        raise MemoryError("no room for the feature cache")

    monkeypatch.setattr(distill, "distill_model", broken)
    rng = np.random.default_rng(1)
    np.save(tmp_path / "pos.npy",
            rng.normal(size=(8, 16, 96)).astype(np.float32) + 1)
    np.save(tmp_path / "neg.npy",
            rng.normal(size=(16, 16, 96)).astype(np.float32))
    cfg = dict(CFG, model_name="tiny", output_dir=str(tmp_path / "out"),
               model_type="dnn", layer_size=8, n_blocks=1, steps=4,
               early_stopping_patience=0, show_training_summary=False,
               batch_composition={"targets": 2, "negatives": 4},
               feature_manifest={"targets": {"t": str(tmp_path / "pos.npy")},
                                 "negatives": {"n": str(tmp_path /
                                                        "neg.npy")}})
    out = run_pipeline(cfg, train_model=True, device="cpu")
    assert out["lite_artifact"] is None
    assert os.path.exists(out["artifact"])
    model_dir = os.path.dirname(out["artifact"])
    assert os.path.exists(os.path.join(model_dir, "tiny.msgpack"))
    assert not os.path.exists(os.path.join(model_dir, "tiny_lite.nww"))
    assert os.path.exists(tmp_path / "out" / "training_journal.md")
