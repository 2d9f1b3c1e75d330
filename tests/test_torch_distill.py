"""The port's distillation of the lite gate against the JAX package, on the
CPU: the loss within 1e-6, 20 steps with dropout 0 within 1e-5, the best
state's restoration, the `_lite.nww` artifact and the `-d` stage."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nanowakeword_tpu.export.artifact import load_nww as jax_load_nww
from nanowakeword_tpu.models.model import Model as JaxModel
from nanowakeword_tpu.train import distill as JD
from nanowakeword_tpu.train import loss as JL
from nanowakeword_tpu_torch import NanoInterpreter
from nanowakeword_tpu_torch.data.dataset import (AdaptiveLossAwareDataset,
                                                 DynamicClassAwareSampler)
from nanowakeword_tpu_torch.export.artifact import load_nww, read_nww_header
from nanowakeword_tpu_torch.models.model import Model
from nanowakeword_tpu_torch.train import distill as TD
from nanowakeword_tpu_torch.train import loss as TL
from nanowakeword_tpu_torch.trainer import run_pipeline, train

T = torch.from_numpy
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(ROOT, "campaign", "hey_nano_crnn.nww")
LOSS_TOL = 1e-6     # distill_loss, two frameworks
STEPS_TOL = 1e-5    # loss trace and weights over 20 steps, dropout 0
TEACHER_CFG = {"activation_function": "relu", "embedding_dim": 16}


@pytest.fixture
def data(tmp_path):
    rng = np.random.default_rng(0)
    pos_p, neg_p = tmp_path / "pos.npy", tmp_path / "neg.npy"
    np.save(pos_p, rng.normal(size=(40, 16, 96)).astype(np.float32) + 0.5)
    np.save(neg_p, rng.normal(size=(80, 16, 96)).astype(np.float32))
    manifest = {"targets": {"t": str(pos_p)}, "negatives": {"n": str(neg_p)}}
    dataset = AdaptiveLossAwareDataset(manifest)
    sampler = DynamicClassAwareSampler(dataset, {"t": 8, "n": 16}, manifest)
    return dataset, sampler, manifest


@pytest.mark.parametrize("temperature,alpha", [(4.0, 0.7), (1.0, 0.0),
                                               (2.5, 1.0)])
def test_distill_loss_matches_jax(temperature, alpha):
    rng = np.random.default_rng(4)
    s = rng.normal(0, 4, 64).astype(np.float32)
    t = rng.normal(0, 6, 64).astype(np.float32)
    y = (rng.random(64) < 0.3).astype(np.float32)
    ref = JL.distill_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(y),
                          temperature, alpha)
    ours = TL.distill_loss(T(s), T(t), T(y), temperature, alpha)
    np.testing.assert_allclose(ours.item(), float(ref), rtol=LOSS_TOL,
                               atol=LOSS_TOL)


def test_student_is_the_reference_student():
    ref = JD.build_student("hey", (16, 96), {})
    ours = TD.build_student("hey", (16, 96), {}, device="cpu")
    assert ours.model_name == ref.model_name == "hey_lite"
    assert ours.n_params() == ref.n_params() == 12513
    wide = TD.build_student("hey", (16, 96), {
        "student_layer_size": 16, "student_n_blocks": 2,
        "student_embedding_dim": 12, "student_dropout_prob": 0.0},
        device="cpu")
    assert wide.module.backbone.linears[1].out_features == 16
    assert len(wide.module.backbone.norms) == 3
    assert wide.embedding_dim == 12


def test_distill_steps_match_jax():
    """20 steps from the same teacher, student and batches, student dropout
    0: the loss trace and the student's weights within 1e-5."""
    steps, temperature, alpha, lr = 20, 4.0, 0.7, 5e-4
    teacher_j = JaxModel(config=dict(TEACHER_CFG), model_name="t",
                         input_shape=(16, 96), model_type="dnn",
                         layer_dim=16, n_blocks=1, dropout_prob=0.3, seed=2)
    dist_cfg = {"student_dropout_prob": 0.0}
    student_j = JD.build_student("t", (16, 96), dist_cfg)
    tx = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(
            learning_rate=optax.cosine_onecycle_schedule(
                transition_steps=steps, peak_value=lr, pct_start=0.3,
                div_factor=25.0, final_div_factor=1e4),
            weight_decay=1e-3))
    step_j = JD._make_distill_step(teacher_j.module, teacher_j.variables,
                                   student_j.module, tx, temperature, alpha)

    teacher = Model(config=dict(TEACHER_CFG), model_name="t",
                    input_shape=(16, 96), model_type="dnn", layer_dim=16,
                    n_blocks=1, dropout_prob=0.3, device="cpu")
    teacher.load_variables(jax.tree_util.tree_map(np.asarray,
                                                  teacher_j.variables))
    student = TD.build_student("t", (16, 96), dist_cfg, device="cpu")
    student.load_variables(jax.tree_util.tree_map(np.asarray,
                                                  student_j.variables))
    student.train()
    optimizer = TD.distill_optimizer(student.module.parameters(), steps, lr)
    step = TD.make_distill_step(teacher.module, student.module, optimizer,
                                temperature, alpha)

    rng = np.random.default_rng(11)
    params, opt_state = student_j.params, tx.init(student_j.params)
    key = jax.random.PRNGKey(10)
    ours, ref = [], []
    for i in range(steps):
        x = rng.normal(0, 1, (12, 16, 96)).astype(np.float32)
        y = (rng.random(12) < 0.4).astype(np.float32)
        params, opt_state, loss = step_j(params, opt_state, key, i,
                                         jnp.asarray(x), jnp.asarray(y))
        ref.append(float(loss))
        ours.append(step(T(x), T(y)).item())
    np.testing.assert_allclose(ours, ref, rtol=0, atol=STEPS_TOL)
    assert not teacher.module.training          # the teacher stays frozen
    got = student.variables["params"]
    for (path, leaf) in jax.tree_util.tree_leaves_with_path(params):
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=0,
                                   atol=STEPS_TOL, err_msg=str(path))


def test_best_ema_state_is_restored(data, monkeypatch):
    """The student ends with the weights it had when the loss EMA was
    lowest (strict `<`, EMA 0.02 seeded by the first loss), not with the
    last ones: the loss is made to jump after 25 steps, so the best state
    lies in the middle of the run."""
    dataset, sampler, _ = data
    teacher = Model(config=dict(TEACHER_CFG), model_name="t",
                    input_shape=(16, 96), model_type="dnn", layer_dim=16,
                    n_blocks=1, dropout_prob=0.0, device="cpu")
    losses, snapshots, students = [], [], []
    real_loss = TD.distill_loss
    real_student = TD.build_student

    def recording_loss(s_logits, t_logits, labels, temperature, alpha):
        # the weights before this step are those after the step before
        snapshots.append([p.detach().clone()
                          for p in students[0].module.parameters()])
        loss = real_loss(s_logits, t_logits, labels, temperature, alpha)
        if len(losses) >= 25:
            loss = loss * 50.0
        losses.append(np.float32(loss.item()))
        return loss

    def recording_student(*args, **kwargs):
        students.append(real_student(*args, **kwargs))
        return students[0]

    monkeypatch.setattr(TD, "distill_loss", recording_loss)
    monkeypatch.setattr(TD, "build_student", recording_student)
    config = {"distillation": {"steps": 40, "learning_rate": 5e-3}}
    student = TD.distill_model(teacher, (dataset, sampler), config, (16, 96))
    assert student is students[0] and len(losses) == 40
    assert not student.module.training

    a, b = np.float32(TD.EMA_ALPHA), np.float32(1 - TD.EMA_ALPHA)
    ema, best, best_step = losses[0], np.float32(np.inf), None
    for i, loss in enumerate(losses):
        ema = loss if i == 0 else a * loss + b * ema
        if ema < best:
            best, best_step = ema, i
    assert 0 < best_step < 39
    np.testing.assert_allclose(student.history["distill_best_ema_loss"],
                               best, rtol=1e-6)
    assert (student.history["distill_final_ema_loss"]
            > student.history["distill_best_ema_loss"])
    for p, want in zip(student.module.parameters(),
                       snapshots[best_step + 1]):
        assert torch.equal(p, want)
    assert not all(torch.equal(p, last) for p, last in zip(
        student.module.parameters(), snapshots[-1]))


def test_feature_cache_is_checked_against_free_memory(monkeypatch):
    """The reference uploads the whole dataset with no size guard; the port
    raises with the numbers before the upload."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (4 * 2**30, 80 * 2**30))
    TD.check_cache_fits(3 * 2**30, torch.device("cuda"))
    with pytest.raises(MemoryError, match=r"3\.50 GiB.*4\.00 GiB free of "
                                          r"80\.00 GiB"):
        TD.check_cache_fits(int(3.5 * 2**30), torch.device("cuda"))
    TD.check_cache_fits(10**15, torch.device("cpu"))    # host rows: no check


def test_distill_from_artifact_writes_the_gate_of_the_cascade(data,
                                                              tmp_path):
    """The shipped CRNN as the teacher: the `_lite.nww` lands beside it
    with the teacher's encoder, the JAX package reads it, and
    `load_model(..., cascade=True)` picks it up as the gate."""
    dataset, sampler, _ = data
    teacher_path = str(tmp_path / "hey.nww")
    shutil.copy(SHIPPED, teacher_path)
    config = {"distillation": {"steps": 30, "weights_dtype": "bfloat16"}}
    lite = TD.distill_from_artifact(teacher_path, (dataset, sampler), config,
                                    (16, 96), str(tmp_path), "hey",
                                    device="cpu")
    assert lite == str(tmp_path / "hey_lite.nww")
    header = read_nww_header(lite)
    assert header["model_name"] == "hey_lite" and header["has_encoder"]
    assert header["weights_dtype"] == "bfloat16"
    assert header["n_params"] == 12513
    _, student, encoder = load_nww(lite, device="cpu")
    _, _, teacher_encoder = load_nww(teacher_path, device="cpu")
    for k, v in teacher_encoder.items():    # bf16 storage of the same encoder
        torch.testing.assert_close(encoder[k], v, rtol=2 ** -8, atol=1e-6)
    x = np.random.default_rng(5).normal(0, 1, (4, 16, 96)).astype(np.float32)
    _, student_j, _ = jax_load_nww(lite)
    np.testing.assert_allclose(student(x).numpy(), np.asarray(student_j(x)),
                               rtol=0, atol=1e-5)

    interp = NanoInterpreter.load_model(teacher_path, cascade=True,
                                        gate_threshold=0.0, device="cpu")
    assert interp.gate_name == "hey_lite"
    clip = np.clip(np.random.default_rng(3).normal(0, 3000, 16000 * 2),
                   -32768, 32767).astype(np.int16)
    results = interp.predict_clip(clip)
    gate = np.array([r.gate_score for r in results])
    assert np.isfinite(gate).all() and (gate[15:] > 0).all()


PIPELINE_CFG = {
    "model_name": "tiny", "model_type": "dnn", "layer_size": 8,
    "n_blocks": 1, "embedding_dim": 16, "dropout_prob": 0.1, "steps": 12,
    "batch_composition": {"targets": 4, "negatives": 4},
    "early_stopping_patience": 0, "stabilization_steps": 2,
    "checkpoint_pool_interval": 5,
    "distillation": {"steps": 10},
}


def test_pipeline_trains_on_the_host_loop_distills_and_journals(data,
                                                                tmp_path):
    """-T with no `device_cache` entry runs the host loop; distillation is
    on by default and writes `<name>_lite.nww` beside the model; the
    training journal gets one row per run; then -d alone distills again
    from the exported artifact, through the command line's entry point."""
    _, _, manifest = data
    out_dir = tmp_path / "out"
    cfg = dict(PIPELINE_CFG, output_dir=str(out_dir),
               feature_manifest=manifest)
    out = run_pipeline(cfg, train_model=True, device="cpu")
    assert len(out["model"].history["loss"]) == 12
    assert out["artifact"].endswith(os.path.join("tiny", "model", "tiny.nww"))
    assert out["lite_artifact"] == out["artifact"].replace(".nww",
                                                           "_lite.nww")
    assert read_nww_header(out["lite_artifact"])["model_type"] == "dnn"
    journal = (out_dir / "training_journal.md").read_text()
    assert "| tiny |" in journal and "(baseline run)" in journal
    run_pipeline(dict(cfg, distillation={"enabled": False}, steps=6),
                 train_model=True, device="cpu")
    journal = (out_dir / "training_journal.md").read_text()
    assert "distillation.enabled=False" in journal and "steps=6" in journal

    os.remove(out["lite_artifact"])
    import yaml
    config_path = tmp_path / "config.yaml"
    config_path.write_text(yaml.safe_dump(cfg))
    again = train(["-c", str(config_path), "-d", "--device", "cpu"])
    assert again["lite_artifact"] == out["lite_artifact"]
    assert os.path.exists(out["lite_artifact"])
    assert "model" not in again          # nothing was trained


def test_bad_weights_dtype_fails_before_training(data, tmp_path):
    _, _, manifest = data
    cfg = dict(PIPELINE_CFG, output_dir=str(tmp_path / "out"),
               feature_manifest=manifest,
               distillation={"weights_dtype": "int4"})
    with pytest.raises(ValueError, match="weights_dtype"):
        run_pipeline(cfg, train_model=True, device="cpu")
    assert not os.path.exists(tmp_path / "out" / "tiny" / "model"
                              / "tiny.nww")
    with pytest.raises(FileNotFoundError, match="Train the model first"):
        run_pipeline(dict(cfg, distillation={}), distill=True, device="cpu")
