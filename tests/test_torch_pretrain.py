"""The port's encoder pretraining (train/pretrain_encoder.py) against the
JAX package's, on the CPU.

The vocabulary, the synthesized corpus and the noise and impulse pools are
numpy in both packages and must be equal bit for bit. torch cannot draw
JAX's initialisation or its threefry batches, so the module and the
training step are held against JAX from carried weights on a given
augmented batch; sampling, resume and int8 storage are tested within the
port. The transfer metrics of the bundled v4 asset must equal the JAX
package's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from torch import nn

from nanowakeword_tpu.train import pretrain_encoder as J
from nanowakeword_tpu_torch.convert import (
    flax_pretrain_variables_from_state_dict, pretrain_state_dict_from_flax)
from nanowakeword_tpu_torch.data.features import (AudioFeatures,
                                                  pretrained_encoder_variables)
from nanowakeword_tpu_torch.train import pretrain_encoder as P
from nanowakeword_tpu_torch.train.optim import warmup_cosine_decay_schedule
from nanowakeword_tpu_torch.utils.flax_msgpack import read_msgpack_file

MODULE_TOL = 1e-5    # logits and pooled embedding, float32 in both packages
STEP_TOL = 1e-5      # loss, accuracy, grad norm (relative) and weights
# the port's log-mel against the JAX package's bf16 route on speech: the
# port sums in float64, JAX in float32, and a last-bit difference can flip
# the bf16 rounding of the power (measured up to 7.9e-4 on 17% of the mel
# of these clips, 1.8e-5 on the logits); the module's own tolerance holds
# on the same mel, which the tests hand to the port
WHOLE_TOL = 1e-3
SUPCON_TOL = 1e-6
# a clip length that takes the mix kernel's route (16000 % 128 == 0)
TINY = P.PretrainConfig(vocab_size=4, confusable_fraction=0.0,
                        variants_per_word=4, heldout_variants=1,
                        clip_samples=16000, noise_clips=6, rir_clips=2,
                        batch_size=8, steps=8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the step's tiny ops otherwise spin torch's
    thread pool against the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_corpus():
    return P.build_corpus(TINY, verbose=False)


# -- vocabulary and corpus --------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda m: m.sample_vocab(40, seed=3),
    lambda m: m.sample_vocab(12, seed=424242,
                             exclude=m.sample_vocab(20, seed=10)),
    lambda m: m.sample_training_vocab(30, seed=10, confusable_fraction=0.5),
    lambda m: m.sample_training_vocab(9, seed=4, confusable_fraction=0.0),
    lambda m: m.make_confusable_pairs(6, seed=515151),
    lambda m: m.make_confusable_pairs(
        5, seed=9002, exclude=m.sample_training_vocab(16, seed=10)),
], ids=["vocab", "vocab_exclude", "twins", "no_twins", "pairs",
        "pairs_exclude"])
def test_words_match_jax(call):
    assert call(P) == call(J)


@pytest.mark.parametrize("channel", ["formant", "resonator", "harmonic",
                                     "union", "union3", "formant_fx",
                                     "resonator_fx", "harmonic_fx"])
def test_synthesis_matches_jax_bitwise(channel):
    args = ("badoker", 3, 12000)
    out = P.synthesize_word_variants(*args, seed=21, channel=channel)
    ref = J.synthesize_word_variants(*args, seed=21, channel=channel)
    assert out.dtype == np.int16 and out.shape == (3, 12000)
    np.testing.assert_array_equal(out, ref)
    assert np.abs(out).max() > 1000


def test_noise_and_rir_pools_match_jax_bitwise():
    # ten clips: each of the five kinds twice, babble included
    np.testing.assert_array_equal(P.make_noise_pool(10, 8000, seed=5),
                                  J.make_noise_pool(10, 8000, seed=5))
    np.testing.assert_array_equal(P.make_rir_pool(6, seed=7),
                                  J.make_rir_pool(6, seed=7))


def test_build_corpus_matches_jax_bitwise(tiny_corpus):
    cfg = J.PretrainConfig(**TINY._asdict())
    ref = J.build_corpus(cfg, verbose=False)
    assert set(tiny_corpus) == set(ref)
    for k, v in ref.items():
        assert tiny_corpus[k].dtype == v.dtype, k
        np.testing.assert_array_equal(tiny_corpus[k], v, err_msg=k)


def test_corpus_from_worker_processes_is_the_same(tiny_corpus):
    spread = P.build_corpus(TINY, verbose=False, workers=2)
    for k, v in tiny_corpus.items():
        np.testing.assert_array_equal(spread[k], v, err_msg=k)


def test_corpus_cache_is_shared_and_never_clobbered(tmp_path):
    cache = str(tmp_path / "corpus.npz")
    small = TINY._replace(vocab_size=3, variants_per_word=2)
    J.build_corpus(J.PretrainConfig(**small._asdict()), cache_path=cache,
                   verbose=False)
    before = open(cache, "rb").read()
    again = P.build_corpus(small, cache_path=cache, verbose=False)
    assert again["clips"].shape == (6, 16000)
    with pytest.raises(ValueError, match="corpus cache"):
        P.build_corpus(small._replace(vocab_size=5), cache_path=cache,
                       verbose=False)
    assert open(cache, "rb").read() == before


# -- losses and the schedule ------------------------------------------------------------

@pytest.mark.parametrize("labels", [[0] * 4 + [1] * 4, [0, 1] * 4,
                                    list(range(8)), [0, 0, 1, 2, 2, 2, 3, 4]],
                         ids=["clustered", "alternating", "lone",
                              "mixed"])
def test_supcon_loss_value_and_gradient_match_jax(labels):
    z = np.random.default_rng(4).normal(0, 1, (8, 16)).astype(np.float32)
    y = np.asarray(labels)
    val, grad = jax.value_and_grad(J.supcon_loss)(jnp.asarray(z),
                                                  jnp.asarray(y), 0.15)
    zt = torch.from_numpy(z).requires_grad_(True)
    out = P.supcon_loss(zt, torch.from_numpy(y), 0.15)
    out.backward()
    np.testing.assert_allclose(out.item(), float(val), rtol=SUPCON_TOL,
                               atol=SUPCON_TOL)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(grad),
                               atol=SUPCON_TOL)
    if labels == list(range(8)):
        assert out.item() == 0.0 and not zt.grad.any()


@pytest.mark.parametrize("steps,warmup_frac", [(100, 0.05), (8, 0.05),
                                               (2000, 0.1)])
def test_warmup_cosine_schedule_matches_optax(steps, warmup_frac):
    cfg = TINY._replace(steps=steps, warmup_frac=warmup_frac)
    warmup = max(int(steps * warmup_frac), 1)
    ref = optax.warmup_cosine_decay_schedule(0.0, cfg.peak_lr, warmup,
                                             max(steps, warmup + 1))
    ours = warmup_cosine_decay_schedule(0.0, cfg.peak_lr, warmup,
                                        max(steps, warmup + 1))
    opt = P.make_optimizer([torch.zeros(2)], cfg)
    for count in list(range(0, steps + 20, max(steps // 50, 1))):
        assert abs(ours(count) - float(ref(count))) <= 1e-6 * cfg.peak_lr
        assert opt.lr(count) == ours(count)
    assert ours(0) == 0.0


# -- the module and the step, from carried weights --------------------------------------

def _audio(n=6, length=16000, seed=0):
    """int16-valued float32 speech of the formant and resonator voices."""
    words = P.sample_vocab(n, seed=seed + 5)
    return np.concatenate([P.synthesize_word_variants(
        w, 1, length, seed=seed + i, channel="union")
        for i, w in enumerate(words)]).astype(np.float32)


def _jax_module(vocab, arch, length, seed=0):
    module = J.EncoderPretrainModule(vocab_size=vocab, encoder_arch=arch)
    variables = module.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, length), jnp.float32))
    return module, jax.tree_util.tree_map(np.asarray, variables)


def _port_module(variables, vocab, arch):
    module = P.EncoderPretrainModule(vocab, arch)
    module.load_state_dict({k: torch.as_tensor(v) for k, v in
                            pretrain_state_dict_from_flax(variables).items()})
    return module


def jax_mel(monkeypatch):
    """Give the port's module the JAX package's log-mel (bf16 route), so
    that a comparison holds what comes after the mel."""
    def mel(audio):
        return torch.from_numpy(np.array(J.melops.mel_frontend(
            jnp.asarray(audio.numpy()), compute_dtype=jnp.bfloat16)))

    monkeypatch.setattr(P, "mel_frontend_fused", mel)


@pytest.mark.parametrize("arch", ["conv4", "wide128"])
def test_module_matches_jax(arch, monkeypatch):
    audio = _audio()
    module, variables = _jax_module(7, arch, audio.shape[1])
    ref_logits, ref_emb = module.apply(variables, jnp.asarray(audio),
                                       return_embedding=True)
    port = _port_module(variables, 7, arch)
    with torch.no_grad():
        whole = port(torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(whole, np.asarray(ref_logits),
                               atol=WHOLE_TOL)
    jax_mel(monkeypatch)
    with torch.no_grad():
        logits, emb = port(torch.from_numpy(audio), return_embedding=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=MODULE_TOL, rtol=MODULE_TOL)
    np.testing.assert_allclose(emb.numpy(), np.asarray(ref_emb),
                               atol=MODULE_TOL, rtol=MODULE_TOL)
    assert np.asarray(ref_emb).std() > 0
    # the state_dict round trip is exact, and the encoder lifts out as the
    # JAX package lifts it
    back = flax_pretrain_variables_from_state_dict(port.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)
    ours = P.extract_encoder_variables(back)
    ref = J.extract_encoder_variables(variables)
    assert jax.tree_util.tree_structure(ours) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)


def _jax_steps(module, variables, audio, y, cfg, n):
    """The JAX package's pretraining step (pretrain_encoder.py's `step`
    after the augmentation) n times on one batch -> ([loss, acc, norm] per
    step, params)."""
    warmup = max(int(cfg.steps * cfg.warmup_frac), 1)
    schedule = optax.warmup_cosine_decay_schedule(
        0.0, cfg.peak_lr, warmup, max(cfg.steps, warmup + 1))
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(schedule, weight_decay=cfg.weight_decay))
    params = variables["params"]
    opt_state = tx.init(params)

    def loss_fn(p):
        logits, z = module.apply({"params": p}, audio, return_embedding=True)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        if cfg.contrastive_weight > 0:
            loss = loss + cfg.contrastive_weight * J.supcon_loss(
                z, y, cfg.contrastive_temp)
        return loss, (logits.argmax(-1) == y).mean()

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    out = []
    for _ in range(n):
        (loss, acc), grads = grad_fn(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        out.append([float(loss), float(acc), float(optax.global_norm(grads))])
    return np.array(out), jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("supcon", [0.0, 0.5], ids=["ce", "supcon"])
def test_three_steps_match_jax(supcon, monkeypatch):
    """Three AdamW steps on one given batch and the same log-mel: the
    first has lr 0 (the warmup starts at 0), so the weights are compared
    after three."""
    jax_mel(monkeypatch)
    cfg = TINY._replace(steps=20, contrastive_weight=supcon)
    audio = _audio(8, 16000, seed=1)
    y = np.array([0, 0, 1, 1, 2, 2, 3, 4])
    module, variables = _jax_module(5, "wide128", audio.shape[1], seed=2)
    ref, ref_params = _jax_steps(module, variables, jnp.asarray(audio),
                                 jnp.asarray(y), cfg, 3)

    port = _port_module(variables, 5, "wide128").train()
    optimizer = P.make_optimizer(list(port.parameters()), cfg)
    step = P.make_pretrain_step(port, optimizer, cfg)
    got = np.array([step(torch.from_numpy(audio),
                         torch.from_numpy(y)).numpy() for _ in range(3)])
    np.testing.assert_allclose(got, ref, rtol=STEP_TOL, atol=0)

    # Adam moves an element by lr * g / (|g| + 1e-8): where the clipped
    # gradient is rounding-level, the rounding decides the step, so those
    # elements (by the float64 gradient at the start) are held to 2 lr
    # per step, the others to STEP_TOL
    ref64 = _port_module(variables, 5, "wide128").double()
    logits, z = ref64(torch.from_numpy(audio), return_embedding=True)
    yt = torch.from_numpy(y)
    loss = nn.functional.cross_entropy(logits, yt)
    if supcon:
        loss = loss + supcon * P.supcon_loss(z, yt, cfg.contrastive_temp)
    grads = torch.autograd.grad(loss, list(ref64.parameters()))
    clip = min(1.0, 1.0 / torch.sqrt(sum((g * g).sum() for g in grads))
               .item())
    loud = flax_pretrain_variables_from_state_dict(
        {k: (g.abs() * clip >= 1e-6).float()
         for (k, _), g in zip(ref64.named_parameters(), grads)})
    noise_bar = 2 * sum(optimizer.lr(c) for c in range(3))
    params = flax_pretrain_variables_from_state_dict(port.state_dict())
    n_quiet = n_all = 0
    for path, want in jax.tree_util.tree_leaves_with_path(ref_params):
        have, mask = params["params"], loud["params"]
        for k in path:
            have, mask = have[k.key], mask[k.key]
        mask = mask > 0.5
        n_quiet, n_all = n_quiet + int((~mask).sum()), n_all + mask.size
        np.testing.assert_allclose(have[mask], want[mask], atol=STEP_TOL,
                                   err_msg=jax.tree_util.keystr(path))
        assert np.abs(have - want)[~mask].max(initial=0) <= noise_bar
    assert n_quiet < n_all // 4      # most elements are held to STEP_TOL


# -- the loop -----------------------------------------------------------------------------

class _Killed(Exception):
    pass


def test_resume_is_bitwise(tiny_corpus, tmp_path, monkeypatch):
    """8 straight steps against a run killed right after its step-4
    checkpoint and resumed to 8: the same encoder, bit for bit."""
    import os
    cfg = TINY._replace(contrastive_weight=0.5)
    straight, report = P.pretrain_encoder(cfg, corpus=tiny_corpus,
                                          verbose=False, device="cpu")
    ck = str(tmp_path / "ck")
    save = P._save_ckpt

    def save_then_die(checkpoint_dir, state):
        save(checkpoint_dir, state)
        if state["step"] == 4:
            raise _Killed

    monkeypatch.setattr(P, "_save_ckpt", save_then_die)
    with pytest.raises(_Killed):
        P.pretrain_encoder(cfg, corpus=tiny_corpus, verbose=False,
                           checkpoint_dir=ck, checkpoint_every=1,
                           device="cpu")
    # the newest two are kept
    assert sorted(os.listdir(ck)) == ["pretrain_step_3.pkl",
                                      "pretrain_step_4.pkl"]
    monkeypatch.setattr(P, "_save_ckpt", save)
    resumed, report2 = P.pretrain_encoder(cfg, corpus=tiny_corpus,
                                          verbose=False, checkpoint_dir=ck,
                                          resume=True, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(straight),
                    jax.tree_util.tree_leaves(resumed)):
        np.testing.assert_array_equal(a, b)
    assert report2["final_train_loss"] == report["final_train_loss"]
    assert set(report) == {"vocab_size", "train_clips", "steps",
                           "final_train_loss", "final_train_acc",
                           "heldout_variant_acc", "wall_seconds"}


def test_supcon_batches_group_words(tiny_corpus):
    cfg = TINY._replace(contrastive_weight=0.5)
    run = P.PretrainRun(cfg, tiny_corpus, device="cpu", verbose=False)
    audio, y = run.draw_batch()
    assert audio.dtype == torch.int16 and audio.shape == (8, 16000)
    assert (y.view(2, 4) == y.view(2, 4)[:, :1]).all()


def test_int8_storage_trains_and_maps_as_jax(tiny_corpus, monkeypatch):
    monkeypatch.setattr(P, "_CLIP_INT8_BYTES", 1)
    run = P.PretrainRun(TINY, tiny_corpus, device="cpu", verbose=False)
    assert run.int8 and run.clips.dtype == torch.int8
    assert np.isfinite(run.step().numpy()).all()
    # the JAX package's map, applied inline in its pretrain_encoder
    x = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)[None]
    q = P.quantize_int8(x)
    np.testing.assert_array_equal(
        q, np.clip((x.astype(np.int32) + 128) >> 8, -128, 127)
        .astype(np.int8))
    deq = torch.from_numpy(q).to(torch.int16) * 256
    assert (deq.numpy().astype(np.int32) - x).__abs__().max() <= 255
    _, report = P.pretrain_encoder(TINY._replace(steps=2),
                                   corpus=tiny_corpus, verbose=False,
                                   device="cpu")
    assert np.isfinite(report["final_train_loss"])


def test_bad_supcon_group_raises(tiny_corpus):
    cfg = TINY._replace(batch_size=6, contrastive_weight=0.5)
    with pytest.raises(ValueError, match="contrastive_group"):
        P.pretrain_encoder(cfg, corpus=tiny_corpus, verbose=False,
                           device="cpu")


# -- transfer metrics of the bundled asset, and the asset writer -----------------------

@pytest.mark.parametrize("channel", ["formant", "resonator_fx"])
def test_transfer_metrics_of_v4_match_jax(channel):
    enc = pretrained_encoder_variables()
    words = P.sample_vocab(8, seed=424242)
    pairs = P.make_confusable_pairs(6, seed=616161)
    kw = dict(n_enroll=3, n_test=2, channel=channel)
    acc = P.centroid_word_accuracy(enc, words, seed=777, device="cpu", **kw)
    pair = P.confusable_pair_accuracy(enc, pairs, seed=808, device="cpu",
                                      **kw)
    assert acc == J.centroid_word_accuracy(enc, words, seed=777, **kw)
    assert pair == J.confusable_pair_accuracy(enc, pairs, seed=808, **kw)
    assert acc >= 0.8 and pair >= 0.6


def test_save_encoder_asset_bytes_and_readers(tmp_path):
    run_vars = P.random_encoder_variables("wide128", seed=3)
    path = str(tmp_path / "enc.msgpack")
    P.save_encoder_asset(run_vars, path, meta={"steps": 2})
    data = open(path, "rb").read()
    assert data == serialization.msgpack_serialize(run_vars)
    assert json.load(open(path + ".json")) == {"steps": 2}
    restored = serialization.msgpack_restore(data)
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(run_vars)):
        np.testing.assert_array_equal(a, b)
    from nanowakeword_tpu_torch.convert import encoder_state_dict_from_flax
    feats = AudioFeatures(encoder_state_dict=encoder_state_dict_from_flax(
        read_msgpack_file(path)), device="cpu")
    out = feats.embed_clips(_audio(2, 16000).astype(np.int16))
    assert out.shape == (2, 3, 96) and np.isfinite(out).all()


def test_main_writes_the_asset(tmp_path, monkeypatch):
    monkeypatch.setattr(P.os, "cpu_count", lambda: 1)  # one process here
    monkeypatch.setattr(P, "evaluate_transfer",
                        lambda enc, words, device, workers: {
                            "words": len(words)})
    out = str(tmp_path / "enc.msgpack")
    with pytest.raises(SystemExit):
        P.main([])                      # --out is required
    P.main(["--out", out, "--vocab", "3", "--variants", "2", "--steps", "2",
            "--batch", "4", "--device", "cpu"])
    meta = json.load(open(out + ".json"))
    assert meta["words"] == 3 and meta["steps"] == 2
    assert meta["encoder_arch"] == "conv4" and "NEVER trained" in \
        meta["recipe"]
    assert "Conv_0" in read_msgpack_file(out)["params"]
