"""Data and tensor parallelism of the port on the CPU, against the JAX
package on conftest's 8 virtual devices.

The port's meshes are `[cpu] * 8` (8 x 1) and `(4, 2)`: one process drives
eight replicas on the one CPU device, as it drives replicas on one card.
Parameters whose true gradient is zero (a conv bias right before a
BatchNorm, attention's key bias) take a step of either sign from Adam on
rounding noise (tests/test_torch_train.py::_noise_gradient): those
elements are held to 2 lr a step, every other one to the JAX package's
bounds.
"""

import asyncio
import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanowakeword_tpu.data.features import AudioFeatures as JaxAudioFeatures
from nanowakeword_tpu.models.model import Model as JaxModel
from nanowakeword_tpu.parallel import dp as jax_dp
from nanowakeword_tpu.parallel import mesh as jax_mesh
from nanowakeword_tpu.train.optim import build_optimizer
from nanowakeword_tpu.train.step import create_train_state
from nanowakeword_tpu_torch import AudioFeatures
from nanowakeword_tpu_torch.export.artifact import load_nww
from nanowakeword_tpu_torch.export.frontend import seeded_audio
from nanowakeword_tpu_torch.interpreter import remote_verifier as rv
from nanowakeword_tpu_torch.interpreter.nanointerpreter import _LocalSession
from nanowakeword_tpu_torch.models.model import Model
from nanowakeword_tpu_torch.parallel import dp
from nanowakeword_tpu_torch.parallel import mesh as M
from nanowakeword_tpu_torch.train.cached import (CachedData,
                                                 make_cached_train_loop,
                                                 put_cached_on_mesh)
from nanowakeword_tpu_torch.train.optim import Optimizer
from nanowakeword_tpu_torch.train.step import make_loss, make_train_step
from nanowakeword_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRNN = os.path.join(ROOT, "campaign", "hey_nano_crnn.nww")
CPU = torch.device("cpu")
STEP_TOL = 1e-5     # one f32 step in two frameworks (test_torch_train.py)
LOSS_RTOL = 1e-5    # DP vs one device (tests/test_train_step.py)
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
BATCH_TOL = 1e-5    # sharded vs unsharded scoring and features
LR = 3e-3
CFG = {"activation_function": "relu", "embedding_dim": 32,
       "optimizer_type": "adamw", "learning_rate_max": LR,
       "lr_scheduler_type": "onecycle", "weight_decay": 0.01}
ARCH = {"dnn": {}, "crnn": {"crnn_cnn_channels": [8, 8],
                            "crnn_rnn_type": "gru"},
        "conformer": {"conformer_d_model": 64, "conformer_n_head": 2}}


def _cpu_mesh(model_parallel=1):
    return M.make_mesh(devices=[CPU] * 8, model_parallel=model_parallel)


def _toy_batch(rng, n=64):
    labels = (rng.random(n) < 0.5).astype(np.float32)
    feats = rng.normal(size=(n, 16, 96)).astype(np.float32)
    feats += labels[:, None, None]
    return feats, labels


@functools.lru_cache(maxsize=None)
def _jax_model(model_type):
    return JaxModel(config=dict(CFG, **ARCH[model_type]), model_name="t",
                    input_shape=(16, 96), model_type=model_type,
                    layer_dim=16, n_blocks=1, dropout_prob=0.0)


def _variables(model_type):
    return jax.tree_util.tree_map(np.asarray, _jax_model(model_type).variables)


def _port_model(model_type, variables=None, dropout=0.0):
    m = Model(config=dict(CFG, **ARCH[model_type]), model_name="t",
              input_shape=(16, 96), model_type=model_type, layer_dim=16,
              n_blocks=1, dropout_prob=dropout, device="cpu")
    if variables is not None:
        m.load_variables(variables)
    return m.train()


def _noise(model_type, variables, x, y) -> dict:
    """name -> the elements whose clipped gradient is below 1e-6 in float64
    at the first step (chip_smoke.py's judge_step rule): a conv bias before
    a BatchNorm, attention's key bias. Their true gradient is zero, and
    Adam turns the float32 rounding noise into a step of either sign."""
    model = _port_model(model_type, variables)
    model.module.double()
    params = dict(model.module.named_parameters())
    out = model.module(torch.from_numpy(x).double()).reshape(-1)
    grads = torch.autograd.grad(make_loss()(out, torch.from_numpy(y).double()),
                                list(params.values()))
    norm = torch.sqrt(sum((g * g).sum() for g in grads)).item()
    clip = min(1.0, 1.0 / norm)
    return {k: (g.abs() * clip < 1e-6).float() for k, g in zip(params, grads)}


def _assert_params_close(ours: dict, ref: dict, noise: dict, steps=1):
    """Within 1e-4 relative and 1e-6, noise elements within 2 lr a step."""
    for k, v in ref.items():
        if not torch.is_floating_point(v):
            continue
        loud = 1.0 - noise.get(k, torch.zeros_like(v))
        diff = (ours[k] - v).abs()
        bound = (PARAM_ATOL + PARAM_RTOL * v.abs()) * loud \
            + 2 * LR * steps * (1.0 - loud)
        assert (diff <= bound).all(), (k, float((diff - bound).max()))


# -- the mesh ------------------------------------------------------------------------


def test_make_mesh_shapes_and_errors():
    for mp in (1, 2, 4):
        ours, ref = _cpu_mesh(mp), jax_mesh.make_mesh(8, model_parallel=mp)
        assert ours.shape == dict(ref.shape)
        assert ours.size == ref.devices.size == 8
        assert len(ours.data_devices) == 8 // mp
    with pytest.raises(ValueError, match="not divisible"):
        M.make_mesh(devices=[CPU] * 8, model_parallel=3)
    with pytest.raises(ValueError, match="not divisible"):
        jax_mesh.make_mesh(8, model_parallel=3)
    with pytest.raises(ValueError, match="visible"):
        M.make_mesh(n_devices=9, devices=[CPU] * 8)
    assert M.make_mesh(n_devices=3, devices=[CPU] * 8).shape == {
        M.DATA_AXIS: 3, M.MODEL_AXIS: 1}


def test_tensor_parallel_placement_matches_jax():
    """Conformer at model_parallel=2: the parameters split over the model
    axis are the JAX package's, by flax path, and they and their AdamW
    moments lie in column shards on the model-axis devices."""
    jm = _jax_model("conformer")
    mesh = jax_mesh.make_mesh(8, model_parallel=2)
    ref = set()
    for path, s in jax.tree_util.tree_flatten_with_path(
            jax_mesh.param_shardings(jm.variables["params"], mesh))[0]:
        if jax_mesh.MODEL_AXIS in str(s.spec):
            ref.add("/".join(p.key for p in path))
    model = _port_model("conformer")
    ours_mesh = _cpu_mesh(2)
    shardings = M.param_shardings(model.module, ours_mesh)
    ours = {p for s in shardings.values() if s.sharded for p in s.flax_paths}
    assert ref and ours == ref
    opt = dp.shard_train_state(model.module, Optimizer(
        list(model.module.parameters()), CFG, 5), ours_mesh)
    n_split = 0
    for k, (i, j) in enumerate(opt.slots):
        p = opt.full_params[i]
        if j is None:
            assert opt.params[k] is p
            continue
        n_split += 1
        for t in (opt.params[k], opt.state["mu"][k], opt.state["nu"][k]):
            assert t.numel() == p.numel() // 2
            assert t.device == ours_mesh.model_devices[j]
    assert n_split == 2 * sum(s.sharded for s in shardings.values())


def test_tensor_parallel_rule_needs_a_flax_layout():
    """A wide kernel's shards partition its elements; a module with no flax
    layout is replicated on a model axis of 1 and refused on a wider one."""
    module = _port_model("conformer").module
    for name, s in M.param_shardings(module, _cpu_mesh(2)).items():
        if s.sharded:
            both = torch.cat(s.index).sort().values
            numel = dict(module.named_parameters())[name].numel()
            assert torch.equal(both, torch.arange(numel))
    plain = torch.nn.Sequential(torch.nn.Linear(16, 512))
    assert not any(s.sharded for s in
                   M.param_shardings(plain, _cpu_mesh(1)).values())
    with pytest.raises(ValueError, match="no flax layout"):
        M.param_shardings(plain, _cpu_mesh(2))


# -- one training step --------------------------------------------------------------------


def _port_steps(model_type, variables, x, y, mesh=None, dropout=0.0,
                steps=1):
    model = _port_model(model_type, variables, dropout)
    opt = Optimizer(list(model.module.parameters()), CFG, 5)
    if mesh is None:
        step = make_train_step(model.module, opt, dropout_seed=3)
    else:
        opt = dp.shard_train_state(model.module, opt, mesh)
        step = dp.make_dp_train_step(model.module, opt, mesh, dropout_seed=3)
    metrics = [step(torch.from_numpy(x), torch.from_numpy(y)).packed
               for _ in range(steps)]
    return metrics, {k: v.clone() for k, v in
                     model.module.state_dict().items()}, opt


@pytest.mark.parametrize("model_type,dropout", [
    ("dnn", 0.0), ("dnn", 0.3), ("crnn", 0.0), ("crnn", 0.3)])
def test_dp_step_matches_one_device(rng, model_type, dropout):
    """8 replicas vs one device, two steps: the loss within 1e-5, the
    parameters and BatchNorm statistics within 1e-4 relative and 1e-6;
    with dropout too (the replicas take their rows of the global mask)."""
    variables = _variables(model_type)
    x, y = _toy_batch(rng)
    m1, p1, _ = _port_steps(model_type, variables, x, y, None, dropout, 2)
    m8, p8, opt = _port_steps(model_type, variables, x, y, _cpu_mesh(),
                              dropout, 2)
    for a, b in zip(m1, m8):
        np.testing.assert_allclose(b[0].item(), a[0].item(), rtol=LOSS_RTOL)
        np.testing.assert_allclose(b[2:].numpy(), a[2:].numpy(), rtol=0,
                                   atol=1e-4)
    _assert_params_close(p8, p1, _noise(model_type, variables, x, y), 2)
    # a checkpoint of the mesh's optimizer is the one-device layout
    sd = opt.state_dict()
    assert sd["count"] == 2 and [t.shape for t in sd["state"]["mu"]] == [
        p.shape for p in opt.full_params]


@pytest.mark.parametrize("model_type", ["dnn", "crnn"])
def test_dp_step_matches_jax_dp_step(rng, model_type):
    """The port over [cpu] * 8 vs the JAX package over 8 virtual devices,
    one step from the same weights: within STEP_TOL."""
    jm = _jax_model(model_type)
    variables = _variables(model_type)
    x, y = _toy_batch(rng)
    tx = build_optimizer(CFG, total_steps=5)
    mesh = jax_mesh.make_mesh(8)
    state = jax_dp.shard_train_state(create_train_state(
        jm.module, jax.tree_util.tree_map(jnp.asarray, variables), tx), mesh)
    step = jax_dp.make_dp_train_step(jm.module, tx, mesh)
    state, ref = step(state, *jax_dp.device_put_batch(x, y, mesh))
    ref = np.asarray(ref.packed)
    (ours,), params, _ = _port_steps(model_type, variables, x, y,
                                     _cpu_mesh())
    np.testing.assert_allclose(ours[0].item(), ref[0], rtol=STEP_TOL)
    np.testing.assert_allclose(ours[1].item(), ref[1], rtol=STEP_TOL)
    np.testing.assert_allclose(ours[2:].numpy(), ref[2:], rtol=0,
                               atol=STEP_TOL)
    model = _port_model(model_type)
    model.module.load_state_dict(params)
    flat = dict(jax.tree_util.tree_flatten_with_path(
        model.variables["params"])[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        name = "/".join(p.key for p in path)
        tol = 2 * LR if ("/Conv_" in name and name.endswith("/bias")) \
            else STEP_TOL
        np.testing.assert_allclose(flat[path], np.asarray(leaf), rtol=0,
                                   atol=tol, err_msg=name)


def test_tp_step_matches_one_device(rng):
    """A conformer over (4, 2): two steps against one device."""
    variables = _variables("conformer")
    x, y = _toy_batch(rng, 32)
    m1, p1, _ = _port_steps("conformer", variables, x, y, None, 0.0, 2)
    m2, p2, opt = _port_steps("conformer", variables, x, y, _cpu_mesh(2),
                              0.0, 2)
    assert any(j is not None for _, j in opt.slots)
    for a, b in zip(m1, m2):
        np.testing.assert_allclose(b[0].item(), a[0].item(), rtol=LOSS_RTOL)
    _assert_params_close(p2, p1, _noise("conformer", variables, x, y), 2)


def test_dp_batch_must_split_evenly():
    model = _port_model("dnn")
    mesh = _cpu_mesh()
    opt = dp.shard_train_state(model.module, Optimizer(
        list(model.module.parameters()), CFG, 5), mesh)
    step = dp.make_dp_train_step(model.module, opt, mesh)
    with pytest.raises(ValueError, match="split evenly"):
        step(torch.zeros(12, 16, 96), torch.zeros(12))
    with pytest.raises(TypeError, match="shard_train_state"):
        dp.make_dp_train_step(model.module, Optimizer(
            list(model.module.parameters()), CFG, 5), mesh)


# -- the device-cached loop ---------------------------------------------------------------


def test_cached_loop_dp_matches_one_device(rng):
    """6 steps of the cached loop: the same generator draws the same
    indices; losses, hardness and weights as tests/test_train_step.py
    holds the JAX package's; n_pos == the positive quota every step."""
    feats, labels = _toy_batch(rng, 256)
    variables = _variables("dnn")

    def run(mesh):
        model = _port_model("dnn", variables)
        opt = Optimizer(list(model.module.parameters()), CFG, 12)
        data = CachedData(
            features=torch.from_numpy(feats), labels=torch.from_numpy(labels),
            hardness=torch.full((256,), 0.05),
            pools=(torch.from_numpy(np.flatnonzero(labels == 1)),
                   torch.from_numpy(np.flatnonzero(labels == 0))),
            quotas=(16, 48), replace=(False, False))
        features = data.features
        if mesh is not None:
            opt = dp.shard_train_state(model.module, opt, mesh)
            data = put_cached_on_mesh(data, mesh)
            features = data.replicas
        loop = make_cached_train_loop(model.module, opt, quotas=data.quotas,
                                      replace=data.replace, k_steps=6,
                                      dropout_seed=1, mesh=mesh)
        gen = torch.Generator().manual_seed(7)
        metrics = loop(data.hardness, gen, features, data.labels, data.pools)
        return (metrics.numpy(), data.hardness.numpy(), gen.get_state(),
                model.module.state_dict())

    m1, h1, g1, s1 = run(None)
    m8, h8, g8, s8 = run(_cpu_mesh())
    assert torch.equal(g1, g8)           # the same draws
    np.testing.assert_allclose(m8[:, 0], m1[:, 0], rtol=1e-4)
    np.testing.assert_allclose(h8, h1, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(h8 != 0.05, h1 != 0.05)   # same indices
    for k in s1:
        np.testing.assert_allclose(s8[k], s1[k], rtol=1e-3, atol=1e-6)
    assert (m8[:, 5] == 16).all()        # n_pos == the quota: global
    assert (m8[:, 2] + m8[:, 3] == 16).all()


def test_trainer_device_cached_data_parallel(tmp_path):
    """`device_cache.data_parallel` over 8 replicas through Trainer: the
    run, and a resumed run restored onto the mesh, equal one device."""
    from nanowakeword_tpu_torch.data.dataset import (
        AdaptiveLossAwareDataset, DynamicClassAwareSampler)
    rng = np.random.default_rng(8)
    paths = {}
    for key, n, mean in (("pos", 40, 0.5), ("neg", 60, -0.5)):
        paths[key] = str(tmp_path / f"{key}.npy")
        np.save(paths[key], rng.normal(mean, 1.0, (n, 16, 96)).astype(
            np.float32))
    manifest = {"targets": {"pos": paths["pos"]},
                "negatives": {"neg": paths["neg"]}}
    variables = _variables("dnn")
    cfg = dict(CFG, steps=8, early_stopping_patience=0,
               checkpointing={"enabled": True, "interval_steps": 4},
               device_cache={"enabled": True, "steps_per_dispatch": 4,
                             "data_parallel": True})

    def train(devices, out, steps, resume=None):
        dataset = AdaptiveLossAwareDataset(manifest)
        sampler = DynamicClassAwareSampler(dataset, {"targets": 8, "neg": 8},
                                           manifest)
        trainer = Trainer(_port_model("dnn", variables), copy.deepcopy(cfg))
        trainer.mesh_devices = devices
        trainer.train_model((dataset, sampler), None, steps,
                            str(tmp_path / out / "training_artifacts"),
                            resume_from_dir=resume)
        return trainer

    one = train([CPU], "one", 8)
    mesh = train([CPU] * 8, "mesh", 8)
    assert isinstance(mesh.optimizer, dp.ShardedOptimizer)
    assert not isinstance(one.optimizer, dp.ShardedOptimizer)
    np.testing.assert_allclose(mesh.history["loss"], one.history["loss"],
                               rtol=1e-4)
    resumed = train([CPU] * 8, "mesh", 8, resume=str(tmp_path / "mesh"))
    assert resumed.history["loss"] == mesh.history["loss"]
    for (k, a), b in zip(mesh.model.module.state_dict().items(),
                         resumed.model.module.state_dict().values()):
        assert torch.equal(a, b), k


def test_host_loop_with_mesh_puts_batches_on_the_mesh(tmp_path):
    """Trainer(mesh=...) runs the host loop (also with device_cache set,
    as the JAX package's rule has it) through device_put_batch."""
    trainer = Trainer(_port_model("dnn"), dict(CFG), mesh=_cpu_mesh())
    batch, labels, event = trainer._upload(np.zeros((16, 16, 96)),
                                           np.zeros(16), None)
    assert isinstance(batch, dp.ShardedBatch) and event is None
    assert [s.shape[0] for s in batch.shards] == [2] * 8
    metrics = trainer._step(batch, labels)
    assert metrics.packed.shape == (2 + 2 * 16,)
    assert isinstance(trainer.optimizer, dp.ShardedOptimizer)


# -- features and serving -----------------------------------------------------------------


def test_sharded_embed_clips_matches_jax_and_unsharded():
    """[20, 16000] int16 tones over 8 data shards (uneven: 3 and 2 rows):
    the JAX package's sharded embed_clips within 5e-3 (its mel route,
    tests/test_torch_slice.py), the port's unsharded within 1e-5."""
    x = np.round(seeded_audio(20, 16000, seed=4)).astype(np.int16)
    port = AudioFeatures(device="cpu")
    sharded = port.embed_clips(x, batch_size=16, mesh=_cpu_mesh())
    alone = port.embed_clips(x, batch_size=16, mesh=None)
    ref = JaxAudioFeatures().embed_clips(x, batch_size=16)
    assert sharded.shape == alone.shape == ref.shape
    np.testing.assert_allclose(sharded, alone, rtol=0, atol=BATCH_TOL)
    np.testing.assert_allclose(sharded, ref, atol=5e-3)


def test_local_session_with_mesh_on_odd_batch():
    """13 rows over 8 shards: padded to 16, scored, the padding dropped."""
    header, model, _ = load_nww(CRNN, device="cpu")
    feats = np.random.default_rng(3).normal(0, 1, (13, 16, 96)).astype(
        np.float32)
    alone = _LocalSession(model, header).run_batch(feats)
    session = _LocalSession(model, header, mesh=_cpu_mesh())
    calls = []
    for replica in {id(r): r for r in session._replicas}.values():
        replica.register_forward_hook(
            lambda m, args, out: calls.append(args[0].shape[0]))
    sharded = session.run_batch(feats)
    assert calls == [2] * 8
    assert sharded.shape == (13,)
    np.testing.assert_allclose(sharded, alone, rtol=0, atol=BATCH_TOL)


def test_scoring_server_data_parallel(caplog):
    """data_parallel=-1: over 8 replicas when they are given, one device
    (with the JAX package's message) on the CPU alone; 21 concurrent
    requests score as the single-device server scores them."""
    feats = [np.random.default_rng(50 + i).normal(0, 1, (1, 16, 96)).astype(
        np.float32) for i in range(21)]

    def scores(server):
        async def run():
            server.start()
            return await asyncio.gather(*[
                server.reply(rv.encode_features(f), None) for f in feats])
        return [json.loads(r)["score"] for r in asyncio.run(run())]

    with caplog.at_level("INFO"):
        alone = rv._ScoringServer(CRNN, data_parallel=-1, device="cpu")
    assert "only one device visible" in caplog.text
    assert alone.session.mesh is None
    with caplog.at_level("INFO"):
        sharded = rv._ScoringServer(CRNN, data_parallel=-1, device="cpu",
                                    mesh_devices=[CPU] * 8)
    assert "over 8 devices" in caplog.text
    assert sharded.session.mesh.shape[M.DATA_AXIS] == 8
    np.testing.assert_allclose(scores(sharded), scores(alone), rtol=0,
                               atol=BATCH_TOL)
