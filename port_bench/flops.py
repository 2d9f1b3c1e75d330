"""Operations and bytes of the benchmark's work, counted from shapes.

Frozen here, so that a count is the same whatever implements the work.
Model operations count two per multiply-add of every matrix product and
convolution (the convention of model FLOPs): elementwise work, norms and
activations are left out. The mel's count for its roofline adds its
elementwise work (see `mel_work`).

The published dense peaks of one NVIDIA H100 SXM at its 700 W limit
(NVIDIA's data sheet): 67 TFLOP/s in float32 outside the tensor cores,
989 TFLOP/s in bfloat16 on them, 3.35 TB/s of HBM bandwidth.
"""

from __future__ import annotations

from dataclasses import dataclass

FP32_PEAK = 67e12
BF16_PEAK = 989e12
HBM_BYTES_PER_S = 3.35e12

HOP = 160
LEFT_PAD_ROWS = 2          # 320 samples of left context
N_BINS = 128
N_MELS = 32
EMB_OFFSET = 4


def mel_frames(n_samples: int) -> int:
    return -(-n_samples // HOP)


@dataclass(frozen=True)
class MelWork:
    matmul_flops: int      # the hop DFT and the filterbank
    elementwise_flops: int
    bytes: int             # int16 in once, float32 log-mel out once

    def least_seconds(self) -> float:
        """The least time on one H100: the larger of the bytes at the HBM
        bandwidth and the operations at their type's peak (the products'
        operands are bfloat16, the rest float32)."""
        ops = (self.matmul_flops / BF16_PEAK
               + self.elementwise_flops / FP32_PEAK)
        return max(self.bytes / HBM_BYTES_PER_S, ops)


def mel_work(batch: int, n_samples: int) -> MelWork:
    """The log-mel of [batch, n_samples] int16 audio: the hop DFT of every
    160-sample row (left context included) against 128 cosine and 128 sine
    bins, per frame the combine of 3 rows (8 FLOPs per bin and row beyond
    the first, real and imaginary), the 3-tap Hann (6 per bin), the power
    (3 per bin), the 128 x 32 filterbank, and a log per mel."""
    t = mel_frames(n_samples)
    rows = t + LEFT_PAD_ROWS
    dft = 2 * rows * HOP * 2 * N_BINS
    filterbank = 2 * t * N_BINS * N_MELS
    elementwise = t * (N_BINS * (2 * 8 + 6 + 3) + N_MELS)
    return MelWork(batch * (dft + filterbank), batch * elementwise,
                   batch * (2 * n_samples + 4 * t * N_MELS))


def mel_flops(n_samples: int) -> int:
    """Model FLOPs of one clip's log-mel (its two products)."""
    return mel_work(1, n_samples).matmul_flops


def _conv_out(n: int, k: int, s: int) -> int:
    return (n - k) // s + 1


def encoder_flops(n_mel: int, width: int = 128, dim: int = 96) -> int:
    """The wide encoder over n_mel frames: a [10, 32] conv of stride 2 into
    `width` channels, 1-D convs of 8 (stride 2), 8 (stride 2) and 4 taps,
    a Dense to `dim` per output frame."""
    t1 = _conv_out(n_mel, 10, 2)
    t2 = _conv_out(t1, 8, 2)
    t3 = _conv_out(t2, 8, 2)
    t4 = _conv_out(t3, 4, 1)
    macs = (t1 * width * 10 * 32 + t2 * width * width * 8
            + t3 * width * width * 8 + t4 * width * width * 4
            + t4 * width * dim)
    return 2 * macs


def head_flops(embedding_dim: int) -> int:
    return 2 * (embedding_dim * (embedding_dim // 2) + embedding_dim // 2)


def classifier_flops(model: dict) -> int:
    """One [frames, features] window through a classifier described by a
    configuration file's model entry: its family's count
    (reference/families/<model_type>.py::flops) and the shared head."""
    from port_bench.reference.models import family
    return family(model["model_type"]).flops(model) \
        + head_flops(model["embedding_dim"])


def bulk_clip_flops(config: dict, n_samples: int) -> int:
    """One clip scored in bulk: its log-mel, the encoder over its frames
    after the first 4, the configuration's bulk model on the window."""
    n_mel = mel_frames(n_samples) - EMB_OFFSET
    model = config["models"][config["bulk_model"]]
    return (mel_flops(n_samples) + encoder_flops(n_mel)
            + classifier_flops(model))


def stream_chunk_flops(config: dict, chunk: int = 1280) -> int:
    """One 80 ms chunk streamed: the log-mel of the chunk and its 320
    samples of context (8 new frames), the encoder over one 76-frame
    window, and every stream model on its window."""
    return (mel_work(1, chunk).matmul_flops + encoder_flops(76)
            + sum(classifier_flops(config["models"][name])
                  for name in config["stream_models"]))
