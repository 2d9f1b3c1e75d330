"""Speech-embedding encoder: mel frames -> 96-dim acoustic embeddings.

The counterpart of `nanowakeword_tpu/models/embedding.py`. The encoder is
fully convolutional with total time stride 8 and receptive field 76 (VALID
padding), so one pass over a whole mel sequence gives one embedding per
stride-8 window: ``n_frames = (mel_frames - 76) // 8 + 1``.

Time geometry:  k=10/s=2 -> k=8/s=2 -> k=8/s=2 -> k=4/s=1

The public call keeps the reference layout, [B, T, 32] -> [B, T', 96].
Inside, the convolutions use PyTorch's channels-first layout. They run with
TF32 off (utils/precision.py), matching the reference's near-f32 precision.
The input is cast to the parameters' dtype: float32 for serving; called
with bfloat16 parameters (train/e2e.py) every layer computes and rounds in
bfloat16, as the reference's encoder does with `dtype=bfloat16`.
"""

from __future__ import annotations

import torch
from torch import nn

from nanowakeword_tpu_torch.utils.precision import no_tf32_convs

EMBEDDING_DIM = 96
EMB_WINDOW = 76     # mel frames per embedding window
EMB_STRIDE = 8      # mel frames between embedding windows
N_MELS = 32


class SpeechEmbeddingEncoder(nn.Module):
    """"conv4": four 2-D convs over (time, freq), then a per-frame linear.

    Input:  [B, T, 32] transformed log-mel (T >= 76)
    Output: [B, (T-76)//8 + 1, 96]
    """

    def __init__(self, features=(32, 48, 64, EMBEDDING_DIM)):
        super().__init__()
        specs = [((10, 4), (2, 2)), ((8, 4), (2, 2)), ((8, 3), (2, 2)),
                 ((4, 2), (1, 1))]
        chans = (1,) + tuple(features)
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, kernel, stride)
            for cin, cout, (kernel, stride) in zip(chans, chans[1:], specs))
        self.dense = nn.Linear(features[-1], EMBEDDING_DIM)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel[:, None].to(self.dense.weight.dtype)   # [B, 1, T, 32]
        with no_tf32_convs():
            for conv in self.convs:
                x = torch.relu(conv(x))
        x = x.squeeze(3).transpose(1, 2)         # [B, T', C]
        return self.dense(x)


class WideSpeechEmbeddingEncoder(nn.Module):
    """"wide128"/"wide256": the first conv takes the whole 32-bin freq axis
    into `width` channels; the rest are 1-D temporal convs at that width.
    Same time geometry and [B, T, 32] -> [B, (T-76)//8 + 1, 96] contract as
    SpeechEmbeddingEncoder."""

    def __init__(self, width: int = 128):
        super().__init__()
        self.conv0 = nn.Conv2d(1, width, (10, N_MELS), stride=(2, 1))
        self.convs = nn.ModuleList(
            nn.Conv1d(width, width, k, stride=s)
            for k, s in ((8, 2), (8, 2), (4, 1)))
        self.dense = nn.Linear(width, EMBEDDING_DIM)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel[:, None].to(self.dense.weight.dtype)   # [B, 1, T, 32]
        with no_tf32_convs():
            x = torch.relu(self.conv0(x)).squeeze(3)   # [B, W, T1]
            for conv in self.convs:
                x = torch.relu(conv(x))
        return self.dense(x.transpose(1, 2))     # [B, T', 96]


ENCODER_ARCHS = {
    "conv4": SpeechEmbeddingEncoder,
    "wide128": WideSpeechEmbeddingEncoder,
    "wide256": lambda: WideSpeechEmbeddingEncoder(width=256),
}
DEFAULT_ENCODER_ARCH = "conv4"


def build_encoder(arch: str = DEFAULT_ENCODER_ARCH) -> nn.Module:
    """Encoder module for an architecture id ("conv4"|"wide128"|"wide256")."""
    try:
        return ENCODER_ARCHS[arch]()
    except KeyError:
        raise ValueError(f"unknown encoder arch '{arch}'; "
                         f"known: {sorted(ENCODER_ARCHS)}") from None


def infer_encoder_arch(variables) -> str:
    """Architecture id from a flax variables tree of numpy arrays (shape of
    the first conv kernel): (10, 4, 1, 32) -> conv4, (10, 32, 1, 128) ->
    wide128, (10, 32, 1, 256) -> wide256."""
    params = variables.get("params", variables)
    shape = tuple(int(s) for s in params["Conv_0"]["kernel"].shape)
    if shape[:3] == (10, 32, 1):
        return "wide256" if shape[3] == 256 else "wide128"
    return "conv4"


def encoder_from_state_dict(state_dict, device="cuda") -> nn.Module:
    """An eval-mode encoder on `device` holding `state_dict` (the port's
    layout, as convert.encoder_state_dict_from_flax makes it)."""
    conv0 = state_dict.get("conv0.weight")
    if conv0 is None:
        arch = "conv4"
    else:
        arch = "wide256" if conv0.shape[0] == 256 else "wide128"
    enc = build_encoder(arch)
    enc.load_state_dict(state_dict, strict=True)
    return enc.to(device).eval().requires_grad_(False)
