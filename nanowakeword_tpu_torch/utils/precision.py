"""float32 convolutions without TF32.

cuDNN runs float32 convolutions in TF32 by default
(`torch.backends.cudnn.allow_tf32` is True), which keeps about three decimal
digits. The reference encoder asks for near-f32 precision
(nanowakeword_tpu/models/embedding.py, `precision=HIGH`), so the port's
convolutions run inside this context, which turns TF32 off for cuDNN and
restores the caller's flags on exit. Matrix products stay in full float32
under PyTorch's defaults (`torch.backends.cuda.matmul.allow_tf32` is False).
"""

from __future__ import annotations

import torch


def no_tf32_convs():
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)
