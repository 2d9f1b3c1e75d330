"""Speech-encoder pretraining: the recipe behind the bundled encoder asset.

The counterpart of `nanowakeword_tpu/train/pretrain_encoder.py`. A
word-classification proxy task: W pseudo-words (phone sequences sampled to
cover the phone inventory, half of them minimal-pair twins of another) are
synthesized by many "speakers" with the numpy voices of
data/generator/tts.py, mixed with colored and babble noise at a random SNR,
reverberated, pitch-, gain- and EQ-perturbed on the device, and classified
from the mean+max-pooled encoder embedding, optionally with a
supervised-contrastive term on the mean-pooled embedding. Transfer is
measured on words never seen in pretraining (nearest-centroid
identification and minimal-pair discrimination).

The vocabulary, the corpus, the noise and the impulse pools are numpy and
equal the JAX package's bit for bit. The corpus is uploaded to the device
once; each step draws its clips there from an explicit `torch.Generator`,
augments them with ops/augment.py (the mix kernel where the clip length is
a multiple of 128), and runs `EncoderPretrainModule`, whose log-mel is
`ops/mel_cuda.mel_frontend_fused` outside autograd: the hand-written kernel
on a CUDA device, its plain version on the CPU. The gradient starts at the
encoder, which runs in float32. The host reads the metrics back only at log
points.

torch cannot reproduce JAX's threefry draws, so a run samples other batches
than the JAX package's; the step on a given batch is the JAX step.

Run: python -m nanowakeword_tpu_torch.train.pretrain_encoder --out <path>
     [--device cpu]
"""

from __future__ import annotations

import contextlib
import json
import multiprocessing
import os
import pickle
import random
import re
import time
from concurrent.futures import Executor, ProcessPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from nanowakeword_tpu_torch.convert import (
    encoder_state_dict_from_flax, flax_encoder_variables_from_state_dict)
from nanowakeword_tpu_torch.data.features import EMB_OFFSET
from nanowakeword_tpu_torch.data.generator import g2p, tts
from nanowakeword_tpu_torch.models.embedding import (EMBEDDING_DIM,
                                                     build_encoder,
                                                     encoder_from_state_dict,
                                                     infer_encoder_arch)
from nanowakeword_tpu_torch.models.model import flax_init_
from nanowakeword_tpu_torch.ops.augment import AugmentParams, augment_batch
from nanowakeword_tpu_torch.ops.mel_cuda import mel_frontend_fused
from nanowakeword_tpu_torch.train.optim import (Optimizer,
                                                warmup_cosine_decay_schedule)
from nanowakeword_tpu_torch.utils.flax_msgpack import msgpack_serialize
from nanowakeword_tpu_torch.utils.logger import print_info
from nanowakeword_tpu_torch.utils.precision import no_tf32_convs

SR = 16000

# Corpora whose clips take more bytes than this are stored as int8 on the
# device (x256 dequant in the step). None: derived from the device, a share
# of the card's free memory (`int8_threshold`); a test may set it.
_CLIP_INT8_BYTES: Optional[int] = None
# the share of the card's free memory the int16 clips may take: the JAX
# package's 8 GiB on a 15.75 GiB chip
INT16_CLIP_SHARE = 0.5
# host memory (a CPU run): the JAX package's constant
HOST_INT8_BYTES = 8 * 2**30

# Phone inventory for pseudo-word sampling (onsets/nuclei/codas the formant
# synthesizer renders distinctly).
_ONSETS = ["B", "D", "G", "K", "P", "T", "M", "N", "L", "R", "S", "SH",
           "F", "V", "Z", "CH", "JH", "W", "Y", "HH", "TH"]
_NUCLEI = ["AA", "AE", "AH", "AO", "EH", "ER", "EY", "IH", "IY", "OW",
           "UW", "AY", "AW", "OY", "UH"]
_CODAS = ["", "N", "M", "NG", "S", "T", "K", "L", "R", "SH", "Z", "D"]


class PretrainConfig(NamedTuple):
    vocab_size: int = 512
    confusable_fraction: float = 0.5   # fraction of vocab that is a
                                       # minimal-pair twin of another word
    variants_per_word: int = 24    # train variants (distinct "speakers")
    heldout_variants: int = 4      # extra variants held out for eval
    clip_samples: int = 24000      # 1.5 s
    noise_clips: int = 240
    rir_clips: int = 64
    batch_size: int = 256
    steps: int = 4000
    encoder_arch: str = "conv4"    # models/embedding.py ENCODER_ARCHS
    peak_lr: float = 2e-3
    weight_decay: float = 1e-4
    warmup_frac: float = 0.05
    seed: int = 10
    channels: str = "union"        # synthesis domain(s) of the corpus:
                                   # "formant" | "resonator" | "union"
                                   # (the *_fx chain stays eval-only)
    companding_prob: float = 0.0   # mu-law codec round-trip augmentation
    bandlimit_prob: float = 0.0    # random lowpass-cutoff augmentation
    contrastive_weight: float = 0.0  # supervised-contrastive auxiliary loss
                                     # on the mean-pooled embedding (0 = off)
    contrastive_temp: float = 0.15   # SupCon temperature
    contrastive_group: int = 4       # variants per word in each batch when
                                     # the contrastive loss is on


# -- vocabulary and corpus (numpy) ---------------------------------------------------

def sample_vocab(n_words: int, seed: int = 10,
                 min_syllables: int = 2, max_syllables: int = 3,
                 exclude: Sequence[str] = ()) -> List[str]:
    """Sample n phonetically-distinct pseudo-words (as spellings), deduped
    by their round-trip phone sequence (the synthesizer re-derives phones
    from the spelling, so two spellings that read back identically are the
    same acoustic class)."""
    rng = random.Random(seed)
    seen = {tuple(g2p.word_to_phones(w)) for w in exclude}
    words: List[str] = []
    attempts = 0
    while len(words) < n_words and attempts < n_words * 60:
        attempts += 1
        phones: List[str] = []
        for _ in range(rng.randint(min_syllables, max_syllables)):
            phones.append(rng.choice(_ONSETS))
            phones.append(rng.choice(_NUCLEI))
            if rng.random() < 0.35:
                coda = rng.choice(_CODAS)
                if coda:
                    phones.append(coda)
        spelling = g2p.phones_to_word(phones)
        key = tuple(g2p.word_to_phones(spelling))
        if len(key) < 3 or key in seen:
            continue
        seen.add(key)
        words.append(spelling)
    if len(words) < n_words:
        raise RuntimeError(f"could only sample {len(words)} distinct words")
    return words


def _confusable_twin(word: str, rng: random.Random, accept) -> Optional[str]:
    """A spelling one confusable phone away from `word` that `accept`
    takes, trying the confusable positions in a shuffled order."""
    phones = g2p.word_to_phones(word)
    positions = [i for i, p in enumerate(phones) if p in g2p.CONFUSABLE]
    rng.shuffle(positions)
    for pos in positions:
        alt = list(phones)
        alt[pos] = rng.choice(g2p.CONFUSABLE[phones[pos]])
        twin = g2p.phones_to_word(alt)
        if twin != word and accept(twin, phones):
            return twin
    return None


def sample_training_vocab(vocab_size: int, seed: int = 10,
                          confusable_fraction: float = 0.5) -> List[str]:
    """Training vocabulary with built-in minimal pairs: for a share of the
    base words, a second class one confusable phone away, so that the
    classifier must tell a word from its nearest phonetic neighbour."""
    n_twins = int(vocab_size * confusable_fraction / (1 + confusable_fraction)
                  ) if confusable_fraction > 0 else 0
    base = sample_vocab(vocab_size - n_twins, seed=seed)
    rng = random.Random(seed + 13)
    seen = {tuple(g2p.word_to_phones(w)) for w in base}

    def accept(twin, _phones):
        key = tuple(g2p.word_to_phones(twin))
        if key in seen or len(key) < 3:
            return False
        seen.add(key)
        return True

    twins: List[str] = []
    for word in base:
        if len(twins) >= n_twins:
            break
        twin = _confusable_twin(word, rng, accept)
        if twin is not None:
            twins.append(twin)
    return base + twins


def synthesize_word_variants(word: str, n_variants: int, clip_samples: int,
                             seed: int,
                             channel: str = "formant") -> np.ndarray:
    """[n_variants, clip_samples] int16 clips of one word, varied speakers.

    `channel`: "formant" / "resonator" / "harmonic" (three acoustically
    disjoint renderers of data/generator/tts.py), "union" (variants
    alternate formant/resonator), "union3" (all three), or "formant_fx" /
    "resonator_fx" / "harmonic_fx" (the same rendering through the
    eval-only telephone-EQ/reverb/soft-clip chain, `tts.apply_channel_fx`)."""
    rng = random.Random(seed)
    out = np.zeros((n_variants, clip_samples), np.int16)
    for v in range(n_variants):
        f0 = rng.uniform(85.0, 235.0)
        ls = rng.uniform(0.8, 1.25)
        ns = rng.uniform(0.2, 0.9)
        ch = channel
        if ch == "union":
            ch = "formant" if v % 2 == 0 else "resonator"
        elif ch == "union3":
            ch = ("formant", "resonator", "harmonic")[v % 3]
        if ch.startswith("formant"):
            audio = tts.formant_synthesize(word, length_scale=ls,
                                           noise_scale=ns, f0=f0,
                                           seed=seed * 7919 + v)
        else:
            synth = (tts.harmonic_synthesize if ch.startswith("harmonic")
                     else tts.resonator_synthesize)
            audio = synth(word, length_scale=ls, noise_scale=ns, f0=f0,
                          seed=seed * 7919 + v,
                          vtl_scale=rng.uniform(0.82, 1.18))
        if ch.endswith("_fx"):
            audio = tts.apply_channel_fx(
                audio, np.random.default_rng(seed * 6007 + v))
        audio = tts.cleanup_filter(audio)[:clip_samples]
        out[v, :len(audio)] = (audio * 32767.0).astype(np.int16)
    return out


def _synthesize_job(job) -> np.ndarray:
    return synthesize_word_variants(*job)


def _synthesize_all(jobs, pool: Optional[Executor] = None):
    """synthesize_word_variants over (word, n_variants, clip_samples, seed,
    channel) jobs, in order, yielded as they finish; in `pool` where one
    is given. Each job draws from its own seeds, so the clips do not
    depend on where it runs."""
    if pool is None:
        return (synthesize_word_variants(*job) for job in jobs)
    return pool.map(_synthesize_job, jobs)


@contextlib.contextmanager
def synthesis_pool(workers: int = 1):
    """A pool of `workers` spawned processes for the corpus synthesis
    (numpy, bound by the host's cores), or None for one worker."""
    if workers <= 1:
        yield None
        return
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        yield pool


def make_noise_pool(n_clips: int, clip_samples: int,
                    seed: int = 10) -> np.ndarray:
    """[n, clip_samples] int16 noise for SNR mixing. Five kinds cycle:
    broadband, low-pass rumble, band-passed hiss, amplitude-modulated
    bursts, and babble (overlapping speech of the formant voice)."""
    from scipy.signal import butter, lfilter

    rng = np.random.default_rng(seed)
    out = np.zeros((n_clips, clip_samples), np.int16)
    babble_words = None
    for i in range(n_clips):
        kind = i % 5
        white = rng.standard_normal(clip_samples)
        if kind == 0:                         # broadband
            noise = white
        elif kind == 1:                       # low-pass "rumble"
            b, a = butter(2, rng.uniform(300, 1500) / (SR / 2), btype="low")
            noise = lfilter(b, a, white)
        elif kind == 2:                       # band-passed hiss
            lo = rng.uniform(800, 3000)
            hi = lo + rng.uniform(1000, 4000)
            b, a = butter(2, [lo / (SR / 2), min(hi, 7800) / (SR / 2)],
                          btype="band")
            noise = lfilter(b, a, white)
        elif kind == 3:                       # amplitude-modulated bursts
            env = np.clip(np.sin(2 * np.pi * rng.uniform(0.5, 4.0)
                                 * np.arange(clip_samples) / SR)
                          + rng.uniform(-0.3, 0.7), 0, None)
            b, a = butter(2, rng.uniform(1000, 6000) / (SR / 2), btype="low")
            noise = lfilter(b, a, white) * env
        else:                                 # babble (overlapped speech)
            if babble_words is None:
                babble_words = sample_vocab(16, seed=seed + 555)
            noise = np.zeros(clip_samples)
            for j in range(rng.integers(3, 6)):
                w = babble_words[rng.integers(len(babble_words))]
                talk = tts.formant_synthesize(
                    w, length_scale=rng.uniform(0.9, 1.2),
                    noise_scale=rng.uniform(0.3, 0.7),
                    f0=rng.uniform(90.0, 220.0),
                    seed=int(seed * 31 + i * 97 + j))
                off = rng.integers(0, max(clip_samples - len(talk), 1))
                seg = talk[:clip_samples - off]
                noise[off:off + len(seg)] += seg * rng.uniform(0.4, 1.0)
        peak = np.abs(noise).max()
        if peak > 0:
            noise = noise / peak * rng.uniform(0.3, 0.9)
        out[i] = (noise * 32767.0).astype(np.int16)
    return out


def make_rir_pool(n_rirs: int, rir_len: int = 2400,
                  seed: int = 10) -> np.ndarray:
    """[n, rir_len] float32 synthetic room impulse responses: a direct
    path and an exponentially decaying noise tail, decay 40-150 ms, random
    direct-to-reverberant ratio."""
    rng = np.random.default_rng(seed)
    t = np.arange(rir_len) / SR
    out = np.zeros((n_rirs, rir_len), np.float32)
    for i in range(n_rirs):
        rt = rng.uniform(0.04, 0.15)          # tail decay constant (s)
        tail = rng.standard_normal(rir_len) * np.exp(-3.0 * t / rt)
        tail[0] = 0.0
        drr = rng.uniform(1.5, 6.0)           # direct-to-reverb amplitude
        rir = tail / max(np.abs(tail).max(), 1e-9)
        rir[0] = drr
        out[i] = (rir / np.abs(rir).max()).astype(np.float32)
    return out


def build_corpus(config: PretrainConfig,
                 cache_path: Optional[str] = None,
                 verbose: bool = True,
                 workers: int = 1) -> Dict[str, np.ndarray]:
    """Synthesize (or load the cached) pretraining corpus: clips [N, L]
    int16, labels [N] int32, heldout_clips / heldout_labels (unseen
    variants of the training words), noise [M, L] int16, rirs [R, 2400]
    float32, words (object array of spellings). A cache built for another
    vocab x variants geometry raises instead of being overwritten. The
    words are synthesized in `workers` processes; the corpus is the same
    for any number."""
    if cache_path and os.path.exists(cache_path):
        data = dict(np.load(cache_path, allow_pickle=True))
        if ("rirs" in data and int(data["clips"].shape[0])
                == config.vocab_size * config.variants_per_word):
            if verbose:
                print_info(f"Loaded pretraining corpus from {cache_path}")
            return data
        raise ValueError(
            f"corpus cache {cache_path} holds "
            f"{int(data['clips'].shape[0])} clips but the requested config "
            f"needs {config.vocab_size * config.variants_per_word} "
            f"(vocab_size={config.vocab_size} x variants_per_word="
            f"{config.variants_per_word}); pass a different --cache path "
            "or delete the file to re-synthesize")

    words = sample_training_vocab(
        config.vocab_size, seed=config.seed,
        confusable_fraction=config.confusable_fraction)
    n_total = config.variants_per_word + config.heldout_variants
    clips, labels, ho_clips, ho_labels = [], [], [], []
    t0 = time.time()
    jobs = [(word, n_total, config.clip_samples, config.seed + w * 1031,
             config.channels) for w, word in enumerate(words)]
    with synthesis_pool(workers) as pool:
        for w, var in enumerate(_synthesize_all(jobs, pool)):
            clips.append(var[:config.variants_per_word])
            labels.extend([w] * config.variants_per_word)
            ho_clips.append(var[config.variants_per_word:])
            ho_labels.extend([w] * config.heldout_variants)
            if verbose and (w + 1) % 64 == 0:
                print_info(f"  synthesized {w + 1}/{len(words)} words "
                           f"({time.time() - t0:.0f}s)")
    data = {
        "clips": np.concatenate(clips),
        "labels": np.asarray(labels, np.int32),
        "heldout_clips": np.concatenate(ho_clips),
        "heldout_labels": np.asarray(ho_labels, np.int32),
        "noise": make_noise_pool(config.noise_clips, config.clip_samples,
                                 seed=config.seed + 77),
        "rirs": make_rir_pool(config.rir_clips, seed=config.seed + 177),
        "words": np.asarray(words, object),
    }
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        np.savez_compressed(cache_path, **data)
        if verbose:
            print_info(f"Cached pretraining corpus at {cache_path}")
    return data


def quantize_int8(clips: np.ndarray) -> np.ndarray:
    """int16 clips -> int8 `clip((x + 128) >> 8, -128, 127)`; x256 gives
    them back within 255 (chunked to bound the int32 temporary)."""
    q = np.empty(clips.shape, np.int8)
    chunk = 16384
    for i in range(0, len(q), chunk):
        blk = clips[i:i + chunk].astype(np.int32)
        np.clip((blk + 128) >> 8, -128, 127, out=blk)
        q[i:i + chunk] = blk.astype(np.int8)
    return q


def int8_threshold(device: torch.device) -> int:
    """Clip bytes above which the corpus is stored as int8: `_CLIP_INT8_BYTES`
    where set; on a CUDA device INT16_CLIP_SHARE of its free memory; on the
    host the JAX package's 8 GiB."""
    if _CLIP_INT8_BYTES is not None:
        return _CLIP_INT8_BYTES
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(INT16_CLIP_SHARE * free)
    return HOST_INT8_BYTES


# -- the model ----------------------------------------------------------------------------

class EncoderPretrainModule(nn.Module):
    """audio [B, L] (int16 scale) -> word logits [B, vocab_size].

    The log-mel (no parameters, no gradient) runs outside autograd; the
    encoder (`encoder`, the deployable asset) runs in float32; the word
    head reads the mean and the max of the embedding over time. The max is
    `amax`, which splits the gradient among tied frames as JAX does
    (digital-silence tails give identical frames)."""

    def __init__(self, vocab_size: int, encoder_arch: str = "conv4"):
        super().__init__()
        self.encoder = build_encoder(encoder_arch)
        self.word_head = nn.Linear(2 * EMBEDDING_DIM, vocab_size)

    def forward(self, audio: torch.Tensor, return_embedding: bool = False):
        with torch.no_grad():
            mel = mel_frontend_fused(audio.contiguous())[:, EMB_OFFSET:]
        emb = self.encoder(mel)
        mean = emb.mean(dim=1)
        logits = self.word_head(torch.cat([mean, emb.amax(dim=1)], dim=-1))
        if return_embedding:
            # the mean-pooled embedding: the space the transfer metrics
            # (and enrolment) use
            return logits, mean
        return logits


def supcon_loss(z: torch.Tensor, labels: torch.Tensor,
                temperature: float = 0.15) -> torch.Tensor:
    """Supervised-contrastive loss (Khosla et al. 2020) over embeddings:
    pulls same-word embeddings together and pushes other words apart in
    cosine space. Anchors with no positive in the batch contribute 0."""
    z = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                        min=1e-6)
    sim = (z @ z.T) / temperature
    eye = torch.eye(z.shape[0], dtype=torch.bool, device=z.device)
    pos = (labels[:, None] == labels[None, :]) & ~eye
    sim = torch.where(eye, -1e9, sim)          # anchors never pair with self
    log_prob = sim - torch.logsumexp(sim, dim=1, keepdim=True)
    per_anchor = -(torch.where(pos, log_prob, 0.0).sum(dim=1)
                   / torch.clamp(pos.sum(dim=1), min=1))
    return per_anchor.mean()


def extract_encoder_variables(pretrain_variables) -> dict:
    """Pretrain-module variables (flax layout) -> encoder variables."""
    out = {}
    for coll, sub in pretrain_variables.items():
        if "encoder" in sub:
            out[coll] = sub["encoder"]
    return out


def _pretrain_augment_params(
        config: PretrainConfig = PretrainConfig()) -> AugmentParams:
    return AugmentParams(
        rir_prob=0.25, gain_prob=0.5, pitch_prob=0.3,
        min_pitch=-1.5, max_pitch=1.5,
        min_snr=3.0, max_snr=25.0,
        min_gain=-6.0, max_gain=6.0,
        min_volume=0.4, max_volume=1.0,
        eq_prob=0.5,
        companding_prob=config.companding_prob,
        bandlimit_prob=config.bandlimit_prob)


def make_pretrain_step(module: EncoderPretrainModule, optimizer: Optimizer,
                       config: PretrainConfig):
    """step(audio [B, L], labels [B] int64) -> [loss, accuracy, grad
    norm] as a device tensor, after one clipped AdamW update of `module`'s
    parameters; the loss is cross-entropy, plus `contrastive_weight` x
    SupCon on the mean-pooled embedding when that is on."""
    params = list(module.parameters())
    use_supcon = config.contrastive_weight > 0.0

    def step(audio: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        # the backward convolutions run without TF32 too (train/step.py)
        with no_tf32_convs():
            logits, z = module(audio, return_embedding=True)
            loss = nn.functional.cross_entropy(logits, y)
            if use_supcon:
                loss = loss + config.contrastive_weight * supcon_loss(
                    z, y, config.contrastive_temp)
            grads = torch.autograd.grad(loss, params)
        norm = optimizer.step(list(grads))
        acc = (logits.detach().argmax(-1) == y).float().mean()
        return torch.stack([loss.detach(), acc, norm])

    return step


def make_optimizer(params, config: PretrainConfig) -> Optimizer:
    """clip_by_global_norm(1.0), then AdamW on optax's warmup-cosine
    schedule from 0 to `peak_lr` and back to 0 (so the first step has
    lr 0)."""
    warmup = max(int(config.steps * config.warmup_frac), 1)
    schedule = warmup_cosine_decay_schedule(
        0.0, config.peak_lr, warmup, max(config.steps, warmup + 1))
    return Optimizer(params, {"optimizer_type": "adamw",
                              "weight_decay": config.weight_decay},
                     config.steps, grad_clip=1.0, schedule=schedule)


class PretrainRun:
    """One pretraining run on `device`: the corpus on the device (int8
    above `int8_threshold`), the module (flax's initializers from a
    generator seeded with `config.seed`), the optimizer, and two
    generators: `sample_rng` on the device draws the clips, noise and
    impulse rows, `augment_rng` on the host the augmentation's draws."""

    def __init__(self, config: PretrainConfig, corpus, device="cuda",
                 verbose: bool = True):
        device = torch.device(device)
        self.config, self.device = config, device
        clips = corpus["clips"]
        self.int8 = clips.nbytes > int8_threshold(device)
        if self.int8:
            if verbose:
                print_info(f"  corpus clips {clips.nbytes / 2**30:.1f} GiB > "
                           f"{int8_threshold(device) / 2**30:.1f} GiB: "
                           "storing int8 on the device (x256 dequant)")
            clips = quantize_int8(clips)
        self.clips = torch.from_numpy(np.ascontiguousarray(clips)).to(device)
        self.labels = torch.from_numpy(
            corpus["labels"].astype(np.int64)).to(device)
        self.noise = torch.from_numpy(corpus["noise"]).to(device)
        use_rir = "rirs" in corpus and corpus["rirs"].shape[-1] > 1
        rirs = corpus["rirs"] if use_rir else np.zeros((1, 1), np.float32)
        self.rirs = torch.from_numpy(rirs).to(device)
        self.n_clips, self.clip_len = self.clips.shape
        self.vocab = int(corpus["labels"].max()) + 1
        if config.contrastive_weight > 0.0 \
                and config.batch_size % config.contrastive_group:
            raise ValueError(
                "batch_size must be divisible by contrastive_group")

        self.module = EncoderPretrainModule(self.vocab, config.encoder_arch)
        flax_init_(self.module, torch.Generator().manual_seed(config.seed))
        self.module.to(device).train()
        self.optimizer = make_optimizer(list(self.module.parameters()),
                                        config)
        self._step = make_pretrain_step(self.module, self.optimizer, config)
        self.aug_params = _pretrain_augment_params(config)
        if not use_rir:
            self.aug_params = self.aug_params._replace(rir_prob=0.0)
        self.sample_rng = torch.Generator(device=device).manual_seed(
            config.seed + 1)
        self.augment_rng = torch.Generator().manual_seed(config.seed + 2)
        b = config.batch_size
        self._fg_lens = np.full(b, self.clip_len, np.int64)
        self._flags = torch.ones(b, dtype=torch.bool, device=device)
        self.done = 0

    def draw_batch(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (augmented int16 audio [B, L], labels [B]) on the device:
        P words x K variants when SupCon is on (every anchor has in-batch
        positives), else B clips uniformly."""
        cfg, dev, g = self.config, self.device, self.sample_rng
        b = cfg.batch_size
        if cfg.contrastive_weight > 0.0:
            n_group = cfg.contrastive_group
            w_ids = torch.randint(0, self.n_clips // cfg.variants_per_word,
                                  (b // n_group,), generator=g, device=dev)
            v_ids = torch.randint(0, cfg.variants_per_word,
                                  (b // n_group, n_group), generator=g,
                                  device=dev)
            idx = (w_ids[:, None] * cfg.variants_per_word
                   + v_ids).reshape(-1)
        else:
            idx = torch.randint(0, self.n_clips, (b,), generator=g,
                                device=dev)
        nidx = torch.randint(0, self.noise.shape[0], (b,), generator=g,
                             device=dev)
        ridx = torch.randint(0, self.rirs.shape[0], (b,), generator=g,
                             device=dev)
        fg = self.clips[idx]
        if self.int8:
            fg = fg.to(torch.int16) * 256   # exact: at most 127 * 256
        audio = augment_batch(fg, self.noise[nidx], self.rirs[ridx],
                              self._fg_lens, self._flags, self._flags,
                              self.aug_params, generator=self.augment_rng)
        return audio, self.labels[idx]

    def train_on(self, audio: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One update on a given batch -> [loss, accuracy, grad norm]."""
        return self._step(audio, y)

    def step(self) -> torch.Tensor:
        """Draw, augment and train one step -> [loss, accuracy, grad norm]
        on the device (no host sync)."""
        metrics = self.train_on(*self.draw_batch())
        self.done += 1
        return metrics

    def state(self) -> dict:
        """Everything a resumed run needs, on the host."""
        return {"step": self.done,
                "params": {k: v.detach().cpu().numpy()
                           for k, v in self.module.state_dict().items()},
                "opt_state": self.optimizer.state_dict(),
                "sample_rng": self.sample_rng.get_state().numpy(),
                "augment_rng": self.augment_rng.get_state().numpy()}

    def load_state(self, ck: dict) -> None:
        self.module.load_state_dict(
            {k: torch.from_numpy(v) for k, v in ck["params"].items()})
        self.optimizer.load_state_dict(ck["opt_state"])
        self.sample_rng.set_state(torch.from_numpy(ck["sample_rng"]))
        self.augment_rng.set_state(torch.from_numpy(ck["augment_rng"]))
        self.done = int(ck["step"])

    def encoder_variables(self) -> dict:
        """The encoder's weights in the flax layout (numpy)."""
        return flax_encoder_variables_from_state_dict(
            self.module.encoder.state_dict())

    @torch.no_grad()
    def heldout_accuracy(self, clips: np.ndarray,
                         labels: np.ndarray) -> float:
        """Held-out variants of the training words through the classifier,
        in batches of `batch_size`."""
        self.module.eval()
        correct = 0
        b = self.config.batch_size
        for i in range(0, len(clips), b):
            audio = torch.from_numpy(clips[i:i + b]).to(self.device)
            pred = self.module(audio).argmax(-1).cpu().numpy()
            correct += int((pred == labels[i:i + b]).sum())
        self.module.train()
        return correct / max(len(clips), 1)


def _find_latest_pretrain_ckpt(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    best_step, best = -1, None
    for f in os.listdir(ckpt_dir):
        m = re.match(r"pretrain_step_(\d+)\.pkl$", f)
        if m and int(m.group(1)) > best_step:
            best_step, best = int(m.group(1)), f
    return os.path.join(ckpt_dir, best) if best else None


def _save_ckpt(checkpoint_dir: str, state: dict) -> None:
    """pretrain_step_<n>.pkl; the newest two are kept."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir,
                        f"pretrain_step_{state['step']}.pkl")
    with open(path, "wb") as f:
        pickle.dump(state, f)
    keep = sorted((f for f in os.listdir(checkpoint_dir)
                   if f.startswith("pretrain_step_")),
                  key=lambda f: int(f.split("_")[-1].split(".")[0]))
    for victim in keep[:-2]:
        os.remove(os.path.join(checkpoint_dir, victim))


def pretrain_encoder(config: PretrainConfig = PretrainConfig(),
                     corpus: Optional[Dict[str, np.ndarray]] = None,
                     cache_path: Optional[str] = None,
                     log_every: int = 100,
                     verbose: bool = True,
                     checkpoint_dir: Optional[str] = None,
                     checkpoint_every: int = 1000,
                     resume: bool = False,
                     device="cuda",
                     history: Optional[list] = None) -> Tuple[dict, dict]:
    """Train the encoder on the word-classification proxy task.

    Returns (encoder_variables in the flax layout, report). With
    `checkpoint_dir`, (step, weights, Adam moments and count, both
    generators) is pickled every `checkpoint_every` steps; `resume=True`
    restores the newest and continues bit for bit. The host reads the
    metrics back (a device sync) at the first step and every `log_every`;
    `history`, a list, gets one entry there: step, loss, accuracy and host
    seconds since the start."""
    if corpus is None:
        corpus = build_corpus(config, cache_path=cache_path, verbose=verbose)
    run = PretrainRun(config, corpus, device=device, verbose=verbose)
    if checkpoint_dir and resume:
        latest = _find_latest_pretrain_ckpt(checkpoint_dir)
        if latest:
            with open(latest, "rb") as f:
                run.load_state(pickle.load(f))
            if verbose:
                print_info(f"  resuming pretraining from {latest} "
                           f"(step {run.done})")

    start = run.done
    t0 = time.time()
    metrics = None
    watch = verbose or history is not None
    for i in range(start, config.steps):
        metrics = run.step()
        if watch and (i == start or (i + 1) % log_every == 0
                      or i + 1 == config.steps):
            m = metrics.cpu().numpy()     # the only sync point
            seconds = time.time() - t0
            if history is not None:
                history.append({"step": i + 1, "loss": float(m[0]),
                                "acc": float(m[1]), "seconds": seconds})
            if verbose:
                print_info(f"  pretrain step {i + 1}/{config.steps} "
                           f"loss={m[0]:.4f} acc={m[1]:.3f} "
                           f"({(i + 1 - start) / seconds:.1f} steps/s)")
        if checkpoint_dir and (i + 1) % checkpoint_every == 0 \
                and i + 1 < config.steps:
            _save_ckpt(checkpoint_dir, run.state())
    final = (metrics.cpu().numpy() if metrics is not None
             else np.zeros(3))

    report = {
        "vocab_size": run.vocab,
        "train_clips": int(run.n_clips),
        "steps": int(config.steps),
        "final_train_loss": float(final[0]),
        "final_train_acc": float(final[1]),
        "heldout_variant_acc": run.heldout_accuracy(
            corpus["heldout_clips"], corpus["heldout_labels"]),
        "wall_seconds": round(time.time() - t0, 1),
    }
    if verbose:
        print_info(f"Pretraining done: {json.dumps(report)}")
    return run.encoder_variables(), report


# -- transfer metrics ------------------------------------------------------------------

@torch.no_grad()
def embed_pooled(encoder_variables, clips: np.ndarray,
                 device="cuda") -> np.ndarray:
    """[N, L] int16 clips -> [N, 96] mean-pooled embeddings: the mel
    (the kernel on a CUDA device) and the encoder on `device`."""
    encoder = encoder_from_state_dict(
        encoder_state_dict_from_flax(encoder_variables), device)
    audio = torch.from_numpy(np.ascontiguousarray(clips)).to(device)
    mel = mel_frontend_fused(audio)[:, EMB_OFFSET:]
    return encoder(mel).mean(dim=1).cpu().numpy()


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-8)


def centroid_word_accuracy(encoder_variables, words: Sequence[str],
                           n_enroll: int = 3, n_test: int = 3,
                           clip_samples: int = 24000,
                           seed: int = 9001,
                           channel: str = "formant",
                           device="cuda",
                           pool: Optional[Executor] = None) -> float:
    """Transfer metric: identify unseen words by the nearest (cosine)
    centroid of n_enroll speaker-variants each; n_test variants per word
    are classified. A random encoder scores near chance. `pool`
    (`synthesis_pool`) synthesizes the clips."""
    n_var = n_enroll + n_test
    clips = np.concatenate(list(_synthesize_all(
        [(w, n_var, clip_samples, seed + 31 * i, channel)
         for i, w in enumerate(words)], pool)))
    vecs = _unit(embed_pooled(encoder_variables, clips, device))
    vecs = vecs.reshape(len(words), n_var, EMBEDDING_DIM)
    centroids = _unit(vecs[:, :n_enroll].mean(axis=1))
    test = vecs[:, n_enroll:].reshape(-1, EMBEDDING_DIM)
    pred = (test @ centroids.T).argmax(axis=-1)
    truth = np.repeat(np.arange(len(words)), n_test)
    return float((pred == truth).mean())


def make_confusable_pairs(n_pairs: int, seed: int = 9002,
                          exclude: Sequence[str] = ()) -> List[Tuple[str, str]]:
    """Word pairs one acoustically-confusable phone apart (g2p.CONFUSABLE,
    the groups the phoneme-adversarial negatives are built from)."""
    rng = random.Random(seed)
    pairs: List[Tuple[str, str]] = []
    for word in sample_vocab(n_pairs * 3, seed=seed, exclude=exclude):
        if len(pairs) >= n_pairs:
            break
        twin = _confusable_twin(
            word, rng, lambda t, phones: g2p.word_to_phones(t) != phones)
        if twin is not None:
            pairs.append((word, twin))
    return pairs


def confusable_pair_accuracy(encoder_variables,
                             pairs: Sequence[Tuple[str, str]],
                             n_enroll: int = 3, n_test: int = 3,
                             clip_samples: int = 24000,
                             seed: int = 9003,
                             channel: str = "formant",
                             device="cuda",
                             pool: Optional[Executor] = None) -> float:
    """Transfer metric (the hard one): two-way discrimination of unseen
    minimal pairs, each test clip classified between its pair's two
    centroids. Chance is 0.5."""
    n_var = n_enroll + n_test
    words = [w for pair in pairs for w in pair]
    clips = np.concatenate(list(_synthesize_all(
        [(w, n_var, clip_samples, seed + 37 * i, channel)
         for i, w in enumerate(words)], pool)))
    vecs = _unit(embed_pooled(encoder_variables, clips, device))
    vecs = vecs.reshape(len(pairs), 2, n_var, EMBEDDING_DIM)
    centroids = _unit(vecs[:, :, :n_enroll].mean(axis=2))     # [P, 2, E]
    test = vecs[:, :, n_enroll:]                         # [P, 2, n_test, E]
    sims = np.einsum("pwte,pce->pwtc", test, centroids)  # [P, 2, n_test, 2]
    pred = sims.argmax(axis=-1)
    truth = np.broadcast_to(np.arange(2)[None, :, None], pred.shape)
    return float((pred == truth).mean())


def random_encoder_variables(arch: str, seed: int = 10) -> dict:
    """A fresh encoder of `arch` from flax's initializers drawn by a torch
    generator seeded with `seed` (the JAX package draws PRNGKey(10), which
    torch cannot reproduce: a different random encoder)."""
    encoder = build_encoder(arch)
    flax_init_(encoder, torch.Generator().manual_seed(seed))
    return flax_encoder_variables_from_state_dict(encoder.state_dict())


def evaluate_transfer(enc_vars, train_words: Sequence[str],
                      n_words: int = 24, n_pairs: int = 24,
                      with_random_baseline: bool = True,
                      cross_channel: bool = True,
                      verbose: bool = True, device="cuda",
                      workers: int = 1) -> dict:
    """Unseen-word centroid identification and confusable minimal-pair
    discrimination; with `cross_channel` also on the resonator and
    harmonic channels and on the eval-only fx chain (the mean of
    formant_fx and resonator_fx); with `with_random_baseline` both metrics
    of a random encoder of the same architecture. The clips are
    synthesized in `workers` processes."""
    transfer_words = sample_vocab(n_words, seed=424242, exclude=train_words)
    pairs = make_confusable_pairs(n_pairs, seed=515151, exclude=train_words)
    report = {"n_transfer_words": len(transfer_words),
              "n_confusable_pairs": len(pairs)}
    channels = (("formant", "resonator", "harmonic", "formant_fx",
                 "resonator_fx") if cross_channel else ("formant",))
    with synthesis_pool(workers) as pool:
        def metrics(variables, channel):
            return (centroid_word_accuracy(variables, transfer_words,
                                           channel=channel, device=device,
                                           pool=pool),
                    confusable_pair_accuracy(variables, pairs,
                                             channel=channel, device=device,
                                             pool=pool))

        acc = {ch: metrics(enc_vars, ch) for ch in channels}
        if with_random_baseline:
            rand = random_encoder_variables(infer_encoder_arch(enc_vars))
            rand_acc = metrics(rand, "formant")
    report["unseen_word_centroid_acc"], report["confusable_pair_acc"] = \
        acc["formant"]
    if cross_channel:
        for ch in ("resonator", "harmonic"):
            report[f"{ch}_centroid_acc"], report[f"{ch}_pair_acc"] = acc[ch]
        # the fx chain is never trained on: the mean of its two channels
        report["heldout_fx_centroid_acc"] = float(np.mean(
            [acc["formant_fx"][0], acc["resonator_fx"][0]]))
        report["heldout_fx_pair_acc"] = float(np.mean(
            [acc["formant_fx"][1], acc["resonator_fx"][1]]))
    if with_random_baseline:
        (report["random_encoder_centroid_acc"],
         report["random_encoder_pair_acc"]) = rand_acc
    if verbose:
        print_info("Transfer eval: " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in report.items()}))
    return report


def save_encoder_asset(encoder_variables, path: str,
                       meta: Optional[dict] = None) -> str:
    """Write encoder variables as a flax msgpack asset at `path`, with the
    JSON sidecar `path + ".json"`; AudioFeatures and the JAX package's
    reader load it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_serialize(encoder_variables))
    with open(path + ".json", "w") as f:
        json.dump(meta or {}, f, indent=1)
    print_info(f"Saved encoder asset to {path}")
    return path


def recipe_text(config: PretrainConfig) -> str:
    channel_desc = {"formant": "formant-synthesized",
                    "resonator": "resonator-synthesized",
                    "harmonic": "sinusoidal-model synthesized",
                    "union": "formant+resonator (union of two disjoint "
                             "synthesis channels)",
                    "union3": "formant+resonator+harmonic (union of three "
                              "disjoint synthesis channels)"}[config.channels]
    robust = ""
    if config.companding_prob > 0 or config.bandlimit_prob > 0:
        robust = (f", mu-law codec round-trip p={config.companding_prob}, "
                  f"random-cutoff lowpass p={config.bandlimit_prob}")
    if config.contrastive_weight > 0:
        robust += (f", supervised-contrastive aux loss w="
                   f"{config.contrastive_weight} T={config.contrastive_temp}"
                   f" (P x {config.contrastive_group}-variant batches)")
    return (
        f"word-classification proxy on {config.vocab_size} {channel_desc} "
        f"pseudo-words ({config.confusable_fraction:.0%} confusable "
        f"minimal-pair twins) x {config.variants_per_word} speakers; SNR "
        "3-25dB colored+babble noise, synthetic-RIR reverb p=0.25, pitch "
        f"+-1.5st, gain +-6dB, random 3-tap channel EQ p=0.5{robust}; adamw "
        f"warmup-cosine; {config.encoder_arch} encoder; the telephone-EQ/"
        "reverb/clip fx chain is NEVER trained on (held-out eval domain)")


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    defaults = PretrainConfig()
    p = argparse.ArgumentParser(description="Pretrain the speech encoder")
    p.add_argument("--out", required=True,
                   help="path of the encoder asset to write (.msgpack; the "
                        "JSON report goes beside it)")
    p.add_argument("--steps", type=int, default=defaults.steps)
    p.add_argument("--vocab", type=int, default=defaults.vocab_size)
    p.add_argument("--variants", type=int,
                   default=defaults.variants_per_word)
    p.add_argument("--batch", type=int, default=defaults.batch_size)
    p.add_argument("--arch", default=defaults.encoder_arch,
                   help="encoder architecture id (conv4 | wide128 | "
                        "wide256)")
    p.add_argument("--cache", default=None,
                   help="corpus .npz cache path (skips re-synthesis)")
    p.add_argument("--channels", default=defaults.channels,
                   choices=["formant", "resonator", "harmonic", "union",
                            "union3"],
                   help="synthesis channel(s) for the training corpus")
    p.add_argument("--channel-robust", type=float, default=0.0,
                   metavar="P", help="probability for the mu-law codec and "
                   "random-bandlimit augmentations (0 disables)")
    p.add_argument("--contrastive", type=float, default=0.0, metavar="W",
                   help="weight of the supervised-contrastive auxiliary "
                        "loss on the pooled embedding (0 disables; batches "
                        "then sample P words x 4 variants)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="durable checkpoint dir (enables crash-safety)")
    p.add_argument("--checkpoint-every", type=int, default=1000)
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    config = PretrainConfig(vocab_size=args.vocab,
                            variants_per_word=args.variants,
                            batch_size=args.batch, steps=args.steps,
                            encoder_arch=args.arch, channels=args.channels,
                            companding_prob=args.channel_robust,
                            bandlimit_prob=args.channel_robust,
                            contrastive_weight=args.contrastive)
    # one synthesis process per core; the corpus does not depend on it
    workers = os.cpu_count() or 1
    corpus = build_corpus(config, cache_path=args.cache, workers=workers)
    enc_vars, report = pretrain_encoder(
        config, corpus=corpus, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        device=args.device)
    train_words = [str(w) for w in corpus["words"]]
    report.update(evaluate_transfer(enc_vars, train_words,
                                    device=args.device, workers=workers))
    report["encoder_arch"] = config.encoder_arch
    report["channels"] = config.channels
    report["recipe"] = recipe_text(config)
    save_encoder_asset(enc_vars, args.out, meta=report)


if __name__ == "__main__":
    main()
