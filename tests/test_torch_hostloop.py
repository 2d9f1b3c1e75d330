"""The port's host training loop against the JAX package's, on the CPU.

Both packages sample with the same numpy code, so with dropout 0 the two
host loops draw the same batch index sequence; the loss traces then agree
within 1e-4 over 20 steps. Resume is held bit for bit within the port.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

from nanowakeword_tpu.data import dataset as jax_data
from nanowakeword_tpu.models.model import Model as JaxModel
from nanowakeword_tpu.train.trainer import Trainer as JaxTrainer
from nanowakeword_tpu_torch.data.dataset import (AdaptiveLossAwareDataset,
                                                 DynamicClassAwareSampler,
                                                 ValidationDataset)
from nanowakeword_tpu_torch.models.model import Model
from nanowakeword_tpu_torch.train.trainer import Trainer
from nanowakeword_tpu_torch.utils import prefetch as prefetch_mod

LOSS_TOL = 1e-4     # loss trace of 20 steps, two frameworks, dropout 0
CFG = {
    "activation_function": "relu", "embedding_dim": 16,
    "optimizer_type": "adamw", "learning_rate_max": 2e-3,
    "lr_scheduler_type": "onecycle", "weight_decay": 0.01,
    "steps": 60, "stabilization_steps": 5,
    "checkpoint_pool_interval": 10, "checkpoint_averaging_top_k": 3,
    "early_stopping_patience": 0, "hardness_reset_interval": 25,
    "val_interval": 20, "val_stabilization_steps": 10,
    "val_early_stopping_patience": 0,
}


def _write_features(tmp_path):
    """Separable synthetic features: positives offset by +1."""
    rng = np.random.default_rng(0)
    pos_p, neg_p = tmp_path / "pos.npy", tmp_path / "neg.npy"
    np.save(pos_p, rng.normal(size=(60, 16, 96)).astype(np.float32) + 1.0)
    np.save(neg_p, rng.normal(size=(120, 16, 96)).astype(np.float32))
    return {"targets": {"t": str(pos_p)}, "negatives": {"n": str(neg_p)}}


@pytest.fixture
def data(tmp_path):
    manifest = _write_features(tmp_path)
    dataset = AdaptiveLossAwareDataset(manifest)
    sampler = DynamicClassAwareSampler(dataset, {"t": 8, "n": 16}, manifest)
    return dataset, sampler, ValidationDataset(manifest)


def _model(dropout=0.1, model_type="dnn", **cfg):
    return Model(config=dict(CFG, **cfg), model_name="tr",
                 input_shape=(16, 96), model_type=model_type, layer_dim=16,
                 n_blocks=1, dropout_prob=dropout, device="cpu")


def _record_batches(sampler):
    drawn = []
    sample = sampler.sample_batch

    def recording():
        batch = sample()
        drawn.append(np.asarray(batch, np.int64).copy())
        return batch

    sampler.sample_batch = recording
    return drawn


def test_host_loop_draws_the_jax_batches_and_matches_its_losses(tmp_path):
    """20 steps, dropout 0, the same starting weights: the same batch index
    sequence (the hardness feedback included: each step's BCE moves the
    sampling weights of the batch after next) and the loss trace within
    1e-4; the final hardness within 1e-5."""
    manifest = _write_features(tmp_path)
    j_data = jax_data.AdaptiveLossAwareDataset(manifest)
    j_sampler = jax_data.DynamicClassAwareSampler(j_data, {"t": 8, "n": 16},
                                                  manifest)
    jm = JaxModel(config=dict(CFG), model_name="tr", input_shape=(16, 96),
                  model_type="dnn", layer_dim=16, n_blocks=1,
                  dropout_prob=0.0)
    variables = jax.tree_util.tree_map(np.asarray, jm.variables)
    j_drawn = _record_batches(j_sampler)
    j_trainer = JaxTrainer(jm, dict(CFG))
    j_trainer.train_model(X=(j_data, j_sampler), X_val=None, max_steps=20,
                          log_path=str(tmp_path / "jax"))

    dataset = AdaptiveLossAwareDataset(manifest)
    sampler = DynamicClassAwareSampler(dataset, {"t": 8, "n": 16}, manifest)
    model = _model(dropout=0.0)
    model.load_variables(variables)
    drawn = _record_batches(sampler)
    trainer = Trainer(model, dict(CFG))
    assert trainer.train_model((dataset, sampler), None, 20,
                               str(tmp_path / "port")) == 20

    assert len(drawn) >= 20 and len(j_drawn) >= 20
    for step in range(20):
        np.testing.assert_array_equal(drawn[step], j_drawn[step],
                                      err_msg=f"batch of step {step}")
    np.testing.assert_allclose(trainer.history["loss"],
                               j_trainer.history["loss"], rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(dataset.sample_hardness,
                               j_data.sample_hardness, rtol=0, atol=1e-5)
    assert (trainer.history["train_recall_steps"]
            == j_trainer.history["train_recall_steps"] == [0])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_host_loop_resume_is_bitwise_continuation(data, tmp_path,
                                                  compute_dtype):
    """The host loop replays the uninterrupted run exactly after a mid-run
    resume, with dropout 0.1: the prefetcher has drawn ahead of the
    checkpoint and the hardness updates land one step late, so the
    checkpoint carries the hardness before the pending update, that update,
    and the sampler's generator as it was after the checkpointed batch. The
    step-25 hardness reset falls in the resumed half."""
    dataset, sampler, _ = data
    cfg = dict(CFG, compute_dtype=compute_dtype,
               checkpointing={"enabled": True, "interval_steps": 20,
                              "limit": 5})
    run_a = tmp_path / "a" / "training_artifacts"
    t_a = Trainer(_model(), cfg)
    t_a.train_model((dataset, sampler), None, 40, str(run_a))
    hardness_a = dataset.sample_hardness.copy()
    mid = run_a / "checkpoints" / "checkpoint_step_20.pkl"
    assert mid.exists()
    run_b = tmp_path / "b" / "training_artifacts"
    (run_b / "checkpoints").mkdir(parents=True)
    shutil.copy(mid, run_b / "checkpoints" / mid.name)

    dataset.sample_hardness[:] = 1.0   # must come from the checkpoint
    t_b = Trainer(_model(), cfg)
    steps = t_b.train_model((dataset, sampler), None, 40, str(run_b),
                            resume_from_dir=str(tmp_path / "b"))
    assert steps == 40
    assert t_b.history["loss"] == t_a.history["loss"]
    assert len(t_b.history["loss"]) == 40
    sd_b = t_b.model.module.state_dict()
    for k, v in t_a.model.module.state_dict().items():
        assert torch.equal(sd_b[k], v), k
    for name, moments in t_a.optimizer.state.items():
        for a, b in zip(moments, t_b.optimizer.state[name]):
            assert torch.equal(a, b), name
    np.testing.assert_array_equal(dataset.sample_hardness, hardness_a)


def test_exception_mid_loop_releases_prefetcher(data, tmp_path, monkeypatch):
    """A step exception propagates AND releases the pipeline: the producer
    thread exits instead of waiting on the pipeline gate forever."""
    created = []
    orig_init = prefetch_mod.Prefetcher.__init__

    def spy_init(self, *a, **k):
        orig_init(self, *a, **k)
        created.append(self)

    monkeypatch.setattr(prefetch_mod.Prefetcher, "__init__", spy_init)
    dataset, sampler, _ = data
    trainer = Trainer(_model(), dict(CFG))
    real_step = trainer._step
    calls = [0]

    def exploding_step(f, l):
        calls[0] += 1
        if calls[0] >= 4:
            raise RuntimeError("boom mid-loop")
        return real_step(f, l)

    trainer._step = exploding_step
    with pytest.raises(RuntimeError, match="boom mid-loop"):
        trainer.train_model((dataset, sampler), None, 30, str(tmp_path))
    assert created, "train_model never built a Prefetcher"
    producer = created[-1]._thread
    producer.join(timeout=10)
    assert not producer.is_alive(), (
        "producer thread still waiting after a mid-loop exception")


def test_matches_device_cached_quality(data, tmp_path):
    """Host-loop and device-cached training reach comparable loss."""
    dataset, sampler, _ = data
    t_host = Trainer(_model(), dict(CFG))
    t_host.train_model((dataset, sampler), None, 40, str(tmp_path / "h"))
    cfg = dict(CFG, device_cache={"enabled": True, "steps_per_dispatch": 20})
    dataset.sample_hardness[:] = 1.0
    t_dev = Trainer(_model(), cfg)
    t_dev.train_model((dataset, sampler), None, 40, str(tmp_path / "d"))
    host_final = np.mean(t_host.history["loss"][-10:])
    dev_final = np.mean(t_dev.history["loss"][-10:])
    assert host_final < np.mean(t_host.history["loss"][:5])
    assert dev_final < np.mean(t_dev.history["loss"][:5])
    assert abs(host_final - dev_final) < 0.5


def test_auto_train_improves_pools_and_validates(data, tmp_path):
    dataset, sampler, val = data
    trainer = Trainer(_model(), dict(CFG))
    before = dataset.sample_hardness.copy()
    model = trainer.auto_train(X_train=(dataset, sampler), X_val=val,
                               steps=60, debug_path=str(tmp_path))
    losses = trainer.history["loss"]
    assert len(losses) == 60
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert not np.allclose(before, dataset.sample_hardness)
    assert 0 < len(trainer.best_training_checkpoints) <= 3   # top_k
    assert trainer.history["val_loss_steps"] == [20, 40]
    assert "final_report" in trainer.history
    assert not model.module.training


def test_train_early_stopping_without_validation(data, tmp_path):
    dataset, sampler, _ = data
    cfg = dict(CFG, early_stopping_patience=3, min_delta=10.0,
               stabilization_steps=5)     # the EMA can never improve by 10
    trainer = Trainer(_model(), cfg)
    steps = trainer.train_model((dataset, sampler), None, 100, str(tmp_path))
    assert steps == 6      # the first step past stabilization
    assert len(trainer.history["loss"]) == 7    # the pending step was drained


def test_validation_early_stopping(data, tmp_path):
    dataset, sampler, val = data
    cfg = dict(CFG, val_interval=5, val_stabilization_steps=0,
               val_early_stopping_patience=5, stabilization_steps=1,
               val_miss_weight=0.0, val_fp_weight=0.0)   # never improves twice
    trainer = Trainer(_model(), cfg)
    steps = trainer.train_model((dataset, sampler), val, 100, str(tmp_path))
    assert steps == 10
    assert trainer.history["val_loss_steps"] == [5, 10]


def test_debug_log_and_profile_trace(data, tmp_path):
    dataset, sampler, _ = data
    cfg = dict(CFG, debug_mode=True, hardness_reset_interval=5,
               profile_trace_dir=str(tmp_path / "trace"),
               profile_start_step=2, profile_steps=2)
    trainer = Trainer(_model(), cfg)
    trainer.train_model((dataset, sampler), None, 8, str(tmp_path))
    import logging
    for handler in logging.getLogger("NanoTrainerDebug").handlers:
        handler.flush()
    text = (tmp_path / "training_debug" / "training_debug.log").read_text()
    assert "Recall:" in text and "Hardness scores partially reset" in text
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_host_loop_trains_a_batchnorm_family(data, tmp_path):
    """The CRNN through the host loop: BatchNorm statistics move and the
    loss falls."""
    dataset, sampler, _ = data
    model = _model(model_type="crnn", crnn_cnn_channels=[4, 8],
                   crnn_rnn_type="gru")
    trainer = Trainer(model, dict(CFG))
    trainer.train_model((dataset, sampler), None, 30, str(tmp_path))
    losses = trainer.history["loss"]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    norm = model.module.backbone.norms[0]
    assert int(norm.num_batches_tracked) == 30
    assert not torch.equal(norm.running_mean, torch.zeros_like(
        norm.running_mean))
