"""The port's training path (models in training mode, losses, optimizer,
training step, device-cached loop, checkpoints, `.nww` writer) against the
JAX package, on the CPU at small widths.

Weights are carried across with convert.py, inputs come from a numpy seed,
and every comparison of a training step uses dropout 0 (dropout masks
cannot match between frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from nanowakeword_tpu.export.artifact import load_nww as jax_load_nww
from nanowakeword_tpu.export.artifact import save_nww as jax_save_nww
from nanowakeword_tpu.models.model import Model as JaxModel
from nanowakeword_tpu.train import loss as JL
from nanowakeword_tpu.train.optim import build_optimizer, build_schedule
from nanowakeword_tpu.train.step import create_train_state
from nanowakeword_tpu.train.step import make_train_step as jax_train_step
from nanowakeword_tpu_torch.data.features import \
    pretrained_encoder_variables
from nanowakeword_tpu_torch.data.dataset import (AdaptiveLossAwareDataset,
                                                 DynamicClassAwareSampler)
from nanowakeword_tpu_torch.export.artifact import load_nww, save_nww
from nanowakeword_tpu_torch.models.model import Model
from nanowakeword_tpu_torch.train import loss as TL
from nanowakeword_tpu_torch.train.cached import (build_cached_data,
                                                 make_cached_train_loop,
                                                 sample_rule)
from nanowakeword_tpu_torch.train.optim import Optimizer
from nanowakeword_tpu_torch.train.optim import \
    build_schedule as torch_schedule
from nanowakeword_tpu_torch.train.step import make_train_step
from nanowakeword_tpu_torch.train.trainer import Trainer
from nanowakeword_tpu_torch.utils.flax_msgpack import msgpack_serialize

T = torch.from_numpy
STEP_TOL = 1e-5        # f32 forward/backward in two frameworks, one step
CRNN_CFG = {"embedding_dim": 16, "crnn_cnn_channels": [4, 8],
            "crnn_rnn_type": "gru"}
DNN_CFG = {"activation_function": "gelu", "embedding_dim": 16}


def _jax_model(model_type, cfg, seed=5, dropout=0.0):
    return JaxModel(config=cfg, model_name="t", input_shape=(16, 96),
                    model_type=model_type, layer_dim=8, n_blocks=2,
                    dropout_prob=dropout, seed=seed)


def _port_model(model_type, cfg, variables=None, dropout=0.0):
    m = Model(config=cfg, model_name="t", input_shape=(16, 96),
              model_type=model_type, layer_dim=8, n_blocks=2,
              dropout_prob=dropout, device="cpu")
    if variables is not None:
        m.load_variables(variables)
    return m


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_close(ours, ref, atol):
    assert set(ours) == set(ref)
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_trees_close(ours[k], ref[k], atol)
        else:
            np.testing.assert_allclose(ours[k], np.asarray(ref[k]), rtol=0,
                                       atol=atol, err_msg=k)


def _features(seed, b=6):
    return np.random.default_rng(seed).normal(0, 1, (b, 16, 96)).astype(
        np.float32)


def _labels(b=6):
    return np.array([1, 0, 0, 1, 0, 0][:b] + [0] * max(0, b - 6),
                    np.float32)


# -- the repair: BatchNorm in training mode, and the fresh model --------------


def test_crnn_training_forward_batch_stats_match_flax():
    jm = _jax_model("crnn", CRNN_CFG)
    variables = _np_tree(jm.variables)
    x = _features(1)
    logits, updates = jm.module.apply(variables, jnp.asarray(x),
                                      deterministic=False,
                                      mutable=["batch_stats"])
    model = _port_model("crnn", CRNN_CFG, variables).train()
    out = model.module(T(x))
    got = model.variables["batch_stats"]["backbone"]
    ref = updates["batch_stats"]["backbone"]
    for name in ref:
        for stat in ("mean", "var"):
            np.testing.assert_allclose(got[name][stat],
                                       np.asarray(ref[name][stat]),
                                       rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(logits),
                               atol=STEP_TOL)


@pytest.mark.parametrize("model_type,cfg", [("crnn", CRNN_CFG),
                                            ("dnn", DNN_CFG)])
def test_fresh_model_draws_flax_initializers(model_type, cfg):
    """Per-tensor std within 10% of the JAX Model's, each pooled over 8
    seeds (a wide embedding keeps the smallest head kernel at 1024 draws),
    zero biases, unit norm scales, orthogonal recurrent kernels."""
    cfg = dict(cfg, embedding_dim=256)

    def leaves(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{path}/{k}")
            else:
                yield f"{path}/{k}", np.asarray(v)

    def pooled(models):
        out = {}
        for m in models:
            for name, a in leaves(m):
                out.setdefault(name, []).append(a)
        return out

    seeds = range(8)
    ref = pooled(_np_tree(_jax_model(model_type, cfg, seed=s)
                          .variables["params"]) for s in seeds)
    ours = pooled(Model(config=cfg, model_name="t", input_shape=(16, 96),
                        model_type=model_type, layer_dim=8, n_blocks=2,
                        dropout_prob=0.0, seed=s, device="cpu")
                  .variables["params"] for s in seeds)
    assert set(ours) == set(ref)
    for name, arrays in ours.items():
        a, b = np.stack(arrays), np.stack(ref[name])
        assert a.shape == b.shape, name
        leaf = name.rsplit("/", 1)[1]
        if leaf in ("bias", "recurrent_bias"):
            assert not a.any(), name
        elif leaf == "scale":
            assert (a == 1).all(), name
        else:
            assert abs(a.std() / b.std() - 1) < 0.1, (name, a.std(),
                                                      b.std())
        if leaf == "recurrent_kernel":
            for k in a:
                np.testing.assert_allclose(k @ k.T, np.eye(k.shape[0]),
                                           atol=1e-5)
    kernel = next(n for n in ours if n.endswith("/kernel"))
    assert not np.array_equal(ours[kernel][0], ours[kernel][1])  # seeded


def test_eval_mode_unchanged_by_training_mode_switch():
    jm = _jax_model("crnn", CRNN_CFG)
    variables = _np_tree(jm.variables)
    model = _port_model("crnn", CRNN_CFG, variables)
    x = _features(2)
    before = model(x).numpy()
    model.train()
    model.eval()
    np.testing.assert_array_equal(model(x).numpy(), before)
    np.testing.assert_allclose(before, np.asarray(jm(x)), atol=1e-4)


def test_variables_round_trip():
    for model_type, cfg in (("crnn", CRNN_CFG), ("dnn", DNN_CFG)):
        jm = _jax_model(model_type, cfg)
        variables = _np_tree(jm.variables)
        model = _port_model(model_type, cfg, variables)
        _assert_trees_close(model.variables, variables, atol=0)


# -- losses, schedules, optimizer ----------------------------------------------------


@pytest.mark.parametrize("name", ["bias_weighted", "asymmetric_focal"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 4, 64).astype(np.float32)
    labels = (rng.random(64) < 0.3).astype(np.float32)
    ref_total, ref_per = JL.LOSS_FUNCTIONS[name](jnp.asarray(logits),
                                                 jnp.asarray(labels), 0.75)
    total, per = TL.LOSS_FUNCTIONS[name](T(logits), T(labels), 0.75)
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-6)
    np.testing.assert_allclose(per.numpy(), np.asarray(ref_per), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(
        TL.logit_regularisation(T(logits), T(labels), 3.0).item(),
        float(JL.logit_regularisation(jnp.asarray(logits),
                                      jnp.asarray(labels), 3.0)), rtol=1e-6)
    np.testing.assert_allclose(
        TL.raw_bce(T(logits), T(labels)).numpy(),
        np.asarray(JL.raw_bce(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cfg", [
    {"lr_scheduler_type": "onecycle", "learning_rate_max": 1.5e-3},
    {"lr_scheduler_type": "cyclic", "learning_rate_max": 1e-3,
     "learning_rate_base": 1e-4, "clr_step_size_up": 70,
     "clr_step_size_down": 130},
    {"lr_scheduler_type": "cosine", "learning_rate_max": 1e-3,
     "learning_rate_base": 1e-5},
])
def test_schedules_match_optax(cfg):
    total = 1000
    ref, ours = build_schedule(cfg, total), torch_schedule(cfg, total)
    peak = cfg["learning_rate_max"]
    for step in (0, 1, 300, 500, total - 1, 250):
        # optax evaluates in float32: 1e-6 of the peak
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-6 * peak)


@pytest.mark.parametrize("opt", ["adamw", "adam", "sgd"])
def test_optimizer_updates_match_optax(opt):
    cfg = {"optimizer_type": opt, "learning_rate_max": 1e-2,
           "lr_scheduler_type": "cosine", "learning_rate_base": 1e-4,
           "weight_decay": 0.01}
    rng = np.random.default_rng(5)
    params = {"a": rng.normal(0, 1, (4, 3)).astype(np.float32),
              "b": rng.normal(0, 1, 5).astype(np.float32)}
    tx = build_optimizer(cfg, total_steps=100)
    state = tx.init(jax.tree_util.tree_map(jnp.asarray, params))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = [T(params["a"].copy()), T(params["b"].copy())]
    ours = Optimizer(tp, cfg, total_steps=100)
    for scale in (3.0, 0.1):     # one clipped step, one not
        grads = {k: (rng.normal(0, scale, v.shape)).astype(np.float32)
                 for k, v in params.items()}
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray,
                                                          grads), state, jp)
        jp = optax.apply_updates(jp, updates)
        norm = ours.step([T(grads["a"]), T(grads["b"])])
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(
            jax.tree_util.tree_map(jnp.asarray, grads))), rtol=1e-6)
        np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp["a"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tp[1].numpy(), np.asarray(jp["b"]),
                                   rtol=0, atol=1e-6)


# -- one training step against the JAX step --------------------------------------------


def _noise_gradient(path: str) -> bool:
    """A conv bias right before a BatchNorm: its gradient is zero up to
    rounding, and Adam scales rounding noise to a full step of either
    sign."""
    return "/Conv_" in path and path.endswith("/bias")


@pytest.mark.parametrize("model_type,cfg,opt", [
    ("crnn", CRNN_CFG, "adamw"), ("crnn", CRNN_CFG, "sgd"),
    ("dnn", DNN_CFG, "adamw")])
def test_training_steps_match_jax(model_type, cfg, opt):
    """Steps from the same weights and batches, dropout 0: loss, grad norm,
    per-example BCE and logits, then the updated parameters and BatchNorm
    statistics, within 1e-5. AdamW takes one step: its second forward would
    see the conv biases that rounding noise moved (see _noise_gradient)."""
    lr = 1e-2
    train_cfg = {"optimizer_type": opt, "learning_rate_max": lr,
                 "lr_scheduler_type": "cosine", "learning_rate_base": 1e-4,
                 "weight_decay": 0.01}
    jm = _jax_model(model_type, cfg)
    variables = _np_tree(jm.variables)
    tx = build_optimizer(train_cfg, total_steps=50)
    jstate = create_train_state(jm.module, jax.tree_util.tree_map(
        jnp.asarray, variables), tx)
    jstep = jax_train_step(jm.module, tx, donate=False)

    model = _port_model(model_type, cfg, variables).train()
    optimizer = Optimizer(list(model.module.parameters()), train_cfg, 50)
    step = make_train_step(model.module, optimizer)
    seeds = (6,) if opt == "adamw" else (6, 7)
    for seed in seeds:
        x, y = _features(seed), _labels()
        jstate, jm_metrics = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        metrics = step(T(x), T(y))
        ref = np.asarray(jm_metrics.packed)
        np.testing.assert_allclose(metrics.loss.item(), ref[0],
                                   rtol=STEP_TOL)
        np.testing.assert_allclose(metrics.grad_norm.item(), ref[1],
                                   rtol=STEP_TOL)
        np.testing.assert_allclose(metrics.packed.numpy()[2:], ref[2:],
                                   rtol=0, atol=STEP_TOL)
    ours = model.variables

    def compare(o, r, path=""):
        for k in r:
            if isinstance(r[k], dict):
                compare(o[k], r[k], f"{path}/{k}")
                continue
            tol = STEP_TOL
            if opt == "adamw" and _noise_gradient(f"{path}/{k}"):
                tol = 2 * lr * len(seeds)     # a step of either sign
            np.testing.assert_allclose(o[k], np.asarray(r[k]), rtol=0,
                                       atol=tol, err_msg=f"{path}/{k}")
    compare(ours["params"], _np_tree(jstate.params))
    if model_type == "crnn":
        _assert_trees_close(ours["batch_stats"],
                            _np_tree(jstate.batch_stats), STEP_TOL)


# -- bf16 compute ---------------------------------------------------------------------------


@pytest.mark.parametrize("model_type,cfg", [("crnn", CRNN_CFG),
                                            ("dnn", DNN_CFG)])
def test_bf16_step_matches_jax_bf16_step(model_type, cfg):
    """One SGD step with compute_dtype bfloat16 in both packages: the loss
    within 2e-2 relative and the logits within 5e-2 (bf16 keeps 8 bits, and
    the two frameworks round intermediate sums at different points), and
    the dtype invariants: float32 masters, moments, BatchNorm statistics,
    loss and metrics."""
    train_cfg = {"optimizer_type": "sgd", "learning_rate_max": 1e-2,
                 "lr_scheduler_type": "cosine", "learning_rate_base": 1e-4}
    jm = _jax_model(model_type, cfg)
    variables = _np_tree(jm.variables)
    tx = build_optimizer(train_cfg, total_steps=50)
    jstate = create_train_state(jm.module, jax.tree_util.tree_map(
        jnp.asarray, variables), tx)
    jstep = jax_train_step(jm.module, tx, donate=False,
                           compute_dtype="bfloat16")
    model = _port_model(model_type, cfg, variables).train()
    optimizer = Optimizer(list(model.module.parameters()), train_cfg, 50)
    step = make_train_step(model.module, optimizer, compute_dtype="bf16")
    x, y = _features(6), _labels()
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    jstate, jm_metrics = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
    metrics = step(T(x), T(y))
    ref = np.asarray(jm_metrics.packed)
    assert metrics.packed.dtype == torch.float32
    np.testing.assert_allclose(metrics.loss.item(), ref[0], rtol=2e-2)
    np.testing.assert_allclose(metrics.logits.numpy(), ref[2 + len(y):],
                               rtol=0, atol=5e-2)
    moved = 0
    for k, v in model.module.state_dict().items():
        if torch.is_floating_point(v):
            assert v.dtype == torch.float32, k
            moved += int(not torch.equal(v, before[k]))
    assert moved > 0.8 * sum(torch.is_floating_point(v)
                             for v in before.values())
    for moments in optimizer.state.values():
        assert all(t.dtype == torch.float32 for t in moments)
    # the masters moved by float32 amounts: the update is not bf16-rounded
    w = model.module.head_out.weight
    assert not torch.equal(w, w.to(torch.bfloat16).float())
    if model_type == "crnn":
        _assert_trees_close(model.variables["batch_stats"],
                            _np_tree(jstate.batch_stats), 2e-3)


def test_cached_loop_bf16_keeps_masters_and_bn_stats_f32(separable):
    """The device-cached loop with compute_dtype bfloat16: float32 masters
    and a full-precision BatchNorm running-statistic EMA. One EMA step from
    1000.3 with O(1) batch statistics must start from the float32 value
    (0.99 * 1000.3), not from bf16(1000.3) = 1000."""
    dataset, sampler = separable
    cached = build_cached_data(dataset, sampler.batch_composition,
                               sampler.feature_manifests, "cpu")
    model = _port_model("crnn", CRNN_CFG).train()
    with torch.no_grad():
        for norm in model.module.backbone.norms:
            norm.running_mean.fill_(1000.3)
            norm.running_var.fill_(1000.3)
    opt = Optimizer(list(model.module.parameters()), CACHE_CFG, 60)
    loop = make_cached_train_loop(model.module, opt, quotas=cached.quotas,
                                  replace=cached.replace, k_steps=1,
                                  compute_dtype="bfloat16")
    m = loop(cached.hardness, torch.Generator().manual_seed(7),
             cached.features, cached.labels, cached.pools)
    assert m.dtype == torch.float32 and torch.isfinite(m).all()
    for p in model.module.parameters():
        assert p.dtype == torch.float32
    for norm in model.module.backbone.norms:
        for stat in (norm.running_mean, norm.running_var):
            assert stat.dtype == torch.float32
            assert (stat > 990.2).all() and (stat < 990.5).all(), stat


@pytest.mark.parametrize("name", ["float16", "fp16", "half", "tf32"])
def test_unknown_compute_dtype_raises(name):
    model = _port_model("dnn", DNN_CFG)
    opt = Optimizer(list(model.module.parameters()), {}, 10)
    with pytest.raises(ValueError, match="compute_dtype"):
        make_train_step(model.module, opt, compute_dtype=name)
    with pytest.raises(ValueError, match="compute_dtype"):
        Trainer(model, {"compute_dtype": name})


# -- the device-cached loop and the trainer -------------------------------------------------


@pytest.fixture
def separable(tmp_path):
    """Positives around +0.5, negatives around -0.5; 40 / 60 / 3 rows."""
    rng = np.random.default_rng(8)
    paths = {}
    for key, n, mean in (("pos", 40, 0.5), ("neg", 60, -0.5),
                         ("few", 3, -0.5)):
        path = str(tmp_path / f"{key}.npy")
        np.save(path, (rng.normal(mean, 1.0, (n, 16, 96))).astype(np.float32))
        paths[key] = path
    manifest = {"targets": {"pos": paths["pos"]},
                "negatives": {"neg": paths["neg"], "few": paths["few"]}}
    dataset = AdaptiveLossAwareDataset(manifest)
    sampler = DynamicClassAwareSampler(dataset, {"targets": 8, "neg": 8,
                                                 "few": 4}, manifest)
    return dataset, sampler


CACHE_CFG = {"optimizer_type": "adamw", "learning_rate_max": 3e-3,
             "lr_scheduler_type": "onecycle", "steps": 60,
             "early_stopping_patience": 0, "stabilization_steps": 10,
             "checkpoint_pool_interval": 20,
             "device_cache": {"enabled": True, "steps_per_dispatch": 20}}


def test_cached_loop_trains_and_moves_hardness(separable, tmp_path):
    dataset, sampler = separable
    model = _port_model("dnn", DNN_CFG)
    trainer = Trainer(model, dict(CACHE_CFG))
    before = dataset.sample_hardness.copy()
    steps = trainer.train_model((dataset, sampler), None, 60, str(tmp_path))
    assert steps == 60
    loss = np.asarray(trainer.history["loss"])
    assert loss.shape == (60,) and np.isfinite(loss).all()
    assert loss[-10:].mean() < 0.5 * loss[:10].mean()
    assert not np.array_equal(dataset.sample_hardness, before)
    assert len(trainer.best_training_checkpoints) == 3   # steps 20, 40, 60


def test_cached_sampling_replaces_when_pool_is_short(separable):
    dataset, sampler = separable
    cached = build_cached_data(dataset, sampler.batch_composition,
                               sampler.feature_manifests, "cpu")
    assert cached.replace == (False, False, True)
    g = torch.Generator().manual_seed(0)
    few = sample_rule(cached.pools[2], cached.hardness, 4, True, g)
    assert few.shape == (4,) and set(few.tolist()) <= {100, 101, 102}
    picked = sample_rule(cached.pools[1], cached.hardness, 8, False, g)
    assert len(set(picked.tolist())) == 8
    # harder rows are drawn more often
    hard = cached.hardness.clone()
    hard[40:50] = 20.0
    counts = torch.zeros(103)
    for _ in range(200):
        counts[sample_rule(cached.pools[1], hard, 8, False, g)] += 1
    assert counts[40:50].mean() > 3 * counts[50:100].mean()


def test_cached_loop_metrics_layout(separable):
    dataset, sampler = separable
    cached = build_cached_data(dataset, sampler.batch_composition,
                               sampler.feature_manifests, "cpu")
    model = _port_model("dnn", DNN_CFG).train()
    opt = Optimizer(list(model.module.parameters()), CACHE_CFG, 60)
    loop = make_cached_train_loop(model.module, opt, quotas=cached.quotas,
                                  replace=cached.replace, k_steps=3)
    m = loop(cached.hardness, torch.Generator().manual_seed(1),
             cached.features, cached.labels, cached.pools)
    assert m.shape == (3, 6)
    assert (m[:, 5] == 8).all()                      # n_pos: the quota
    assert (m[:, 2] + m[:, 3] == 8).all()            # tp + fn
    assert opt.count == 3


def test_pickle_checkpoint_round_trip(separable, tmp_path):
    dataset, sampler = separable
    cfg = dict(CACHE_CFG, checkpointing={"enabled": True,
                                         "interval_steps": 20, "limit": 2})
    trainer = Trainer(_port_model("dnn", DNN_CFG), cfg)
    trainer.train_model((dataset, sampler), None, 40, str(tmp_path))
    ckdir = tmp_path / "checkpoints"
    latest = Trainer.find_latest_checkpoint(str(ckdir))
    assert latest.endswith("checkpoint_step_40.pkl")
    assert sorted(p.name for p in ckdir.iterdir()) == [
        "checkpoint_step_20.pkl", "checkpoint_step_40.pkl"]
    other = Trainer(_port_model("dnn", DNN_CFG, dropout=0.0), cfg)
    ckpt = other.restore_checkpoint(latest, sampler)
    assert ckpt["step"] == 40 and other.optimizer.count == 40
    for k, v in trainer.model.module.state_dict().items():
        assert torch.equal(other.model.module.state_dict()[k], v), k
    np.testing.assert_array_equal(ckpt["dataset_hardness"],
                                  dataset.sample_hardness)
    assert other.history["loss"] == trainer.history["loss"]


def test_resume_device_cached_is_bitwise_continuation(separable, tmp_path):
    """40 steps straight against 20 steps, a new Trainer, --resume and 20
    more, with dropout 0.3: weights, optimizer moments, hardness and the
    loss history are equal bit for bit. Dropout's masks are a function of
    (seed, step), so the resumed run draws what the straight run drew."""
    import shutil
    dataset, sampler = separable
    cfg = dict(CACHE_CFG, steps=40,
               checkpointing={"enabled": True, "interval_steps": 20,
                              "limit": 5})

    def trainer():
        return Trainer(_port_model("dnn", DNN_CFG, dropout=0.3), cfg)

    run_a = tmp_path / "a" / "training_artifacts"
    t_a = trainer()
    t_a.train_model((dataset, sampler), None, 40, str(run_a))
    hardness_a = dataset.sample_hardness.copy()
    mid = run_a / "checkpoints" / "checkpoint_step_20.pkl"
    assert mid.exists()
    run_b = tmp_path / "b" / "training_artifacts"
    (run_b / "checkpoints").mkdir(parents=True)
    shutil.copy(mid, run_b / "checkpoints" / mid.name)

    dataset.sample_hardness[:] = 1.0    # must come from the checkpoint
    torch.manual_seed(12345)            # whatever else the process drew
    t_b = trainer()
    steps = t_b.train_model((dataset, sampler), None, 40, str(run_b),
                            resume_from_dir=str(tmp_path / "b"))
    assert steps == 40
    assert t_b.history["loss"] == t_a.history["loss"]
    assert len(t_b.history["loss"]) == 40
    sd_a, sd_b = (t.model.module.state_dict() for t in (t_a, t_b))
    for k, v in sd_a.items():
        assert torch.equal(sd_b[k], v), k
    for name, moments in t_a.optimizer.state.items():
        for a, b in zip(moments, t_b.optimizer.state[name]):
            assert torch.equal(a, b), name
    assert t_b.optimizer.count == t_a.optimizer.count == 40
    np.testing.assert_array_equal(dataset.sample_hardness, hardness_a)


def test_orbax_backend_raises(separable, tmp_path):
    """orbax is a JAX library: the port has pickle checkpoints only."""
    cfg = dict(CACHE_CFG, checkpointing={"enabled": True,
                                         "backend": "orbax"})
    trainer = Trainer(_port_model("dnn", DNN_CFG), cfg)
    with pytest.raises(NotImplementedError, match="orbax"):
        trainer.save_checkpoint(str(tmp_path), 1, separable[1])


# -- the .nww writer ------------------------------------------------------------------------


def test_msgpack_writer_matches_flax():
    tree = {"b": {"k": np.arange(12, dtype=np.float32).reshape(3, 4)},
            "a": np.array([-1, 2], np.int8), "s": np.float32(2.5),
            "ints": [0, 127, 128, 300, 70000, 2 ** 40, -3, -200, -70000],
            "x": 1.5, "t": "y" * 300, "flags": [True, False, None],
            "wide": {f"k{i}": i for i in range(20)}, "empty": {}}
    assert msgpack_serialize(tree) == serialization.msgpack_serialize(tree)


@pytest.mark.parametrize("weights_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("model_type,cfg", [("crnn", CRNN_CFG),
                                            ("dnn", DNN_CFG)])
def test_nww_written_by_port_loads_in_jax(tmp_path, model_type, cfg,
                                          weights_dtype):
    """The port's artifact decodes in the JAX package to exactly the tree
    the JAX writer stores for the same weights; f32 scores agree."""
    model = _port_model(model_type, cfg)
    with torch.no_grad():
        for norm in getattr(model.module.backbone, "norms", []):
            if isinstance(norm, torch.nn.BatchNorm2d):
                norm.running_mean.uniform_(-0.2, 0.2)
                norm.running_var.uniform_(0.5, 1.5)
    enc = pretrained_encoder_variables()
    ours = str(tmp_path / "port.nww")
    save_nww(ours, model=model, config=cfg, model_name="t",
             encoder_variables=enc, weights_dtype=weights_dtype)
    jm = _jax_model(model_type, cfg)
    jm.load_variables(jax.tree_util.tree_map(jnp.asarray, model.variables))
    theirs = str(tmp_path / "jax.nww")
    jax_save_nww(theirs, model=jm, config=cfg, model_name="t",
                 encoder_variables=enc, weights_dtype=weights_dtype)

    header, jm_ours, enc_ours = jax_load_nww(ours)
    header_ref, jm_ref, enc_ref = jax_load_nww(theirs)
    header.pop("n_params"), header_ref.pop("n_params")
    assert header == header_ref
    _assert_trees_close(_np_tree(jm_ours.variables),
                        _np_tree(jm_ref.variables), atol=0)
    _assert_trees_close(_np_tree(enc_ours), _np_tree(enc_ref), atol=0)
    x = _features(9)
    if weights_dtype == "float32":
        want = torch.sigmoid(model(x)).numpy()
        np.testing.assert_allclose(np.asarray(jax.nn.sigmoid(jm_ours(x))),
                                   want, rtol=0, atol=1e-6)
    _, back, _ = load_nww(ours, device="cpu")
    np.testing.assert_allclose(back(x).numpy(), np.asarray(jm_ours(x)),
                               atol=1e-4)
