"""The port's log-mel (nanowakeword_tpu_torch.ops) against the JAX package.

The port's plain version runs against the JAX frontend and the Pallas
kernel in interpret mode, on the CPU. The CUDA kernel's tests are in
tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanowakeword_tpu.ops import mel as JM
from nanowakeword_tpu.ops.mel_pallas import mel_frontend_pallas
from nanowakeword_tpu_torch.ops import mel as TM
from nanowakeword_tpu_torch.ops import mel_cuda

# kernel and port vs JAX bf16 route: the repo's bar (tests/test_mel_pallas.py)
# -- log-amplified rounding of differently ordered f32 sums near silent bins,
# which can also flip the bf16 rounding of one bin's power
BF16_TOL = 2e-3
SHAPES = [(1, 16000), (3, 32000), (5, 12345)]


def _audio(rng, shape, dtype=np.float32):
    return rng.integers(-20000, 20000, shape).astype(dtype)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_xla_route(rng, shape):
    x = _audio(rng, shape)
    ref = np.asarray(JM.mel_frontend(jnp.asarray(x),
                                     compute_dtype=jnp.bfloat16))
    out = mel_cuda.mel_frontend_plain(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=BF16_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_pallas_kernel(rng, shape):
    x = _audio(rng, shape)
    ref = np.asarray(mel_frontend_pallas(jnp.asarray(x), interpret=True))
    out = mel_cuda.mel_frontend_fused(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=BF16_TOL)


def test_f32_mode_matches_jax(rng):
    """f32 mode: same constants and op order; only f32 sum order differs."""
    x = _audio(rng, (2, 16000))
    ref = np.asarray(JM.mel_frontend(jnp.asarray(x),
                                     compute_dtype=jnp.float32))
    out = TM.mel_frontend(torch.from_numpy(x),
                          compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("compute_dtype,atol", [
    (torch.float32, 2e-4),    # the JAX package's oracle bar (tests/test_mel.py)
    (torch.bfloat16, 2e-2),   # bf16 samples and power: ~3 significant digits
])
def test_matches_float64_oracle(rng, compute_dtype, atol):
    x = _audio(rng, (2, 16000))
    out = TM.mel_frontend(torch.from_numpy(x),
                          compute_dtype=compute_dtype).numpy()
    ref = TM.mel_frontend_reference(x)
    np.testing.assert_allclose(out, ref, atol=atol)
    np.testing.assert_array_equal(ref, JM.mel_frontend_reference(x))


def test_int16_input_matches_float_exactly(rng):
    """int16 -> f32 is exact and the one bf16 rounding happens in the same
    place, so int16 and float32 audio give bit-identical output."""
    x = _audio(rng, (4, 16000), np.int16)
    a = mel_cuda.mel_frontend_fused(torch.from_numpy(x))
    b = mel_cuda.mel_frontend_fused(torch.from_numpy(x.astype(np.float32)))
    assert torch.equal(a, b)


def test_1d_input_keeps_rank(rng):
    x = _audio(rng, 16000)
    out = mel_cuda.mel_frontend_fused(torch.from_numpy(x))
    assert tuple(out.shape) == (100, TM.N_MELS)
    batch = mel_cuda.mel_frontend_fused(torch.from_numpy(x[None]))
    assert torch.equal(out, batch[0])


def test_bf16_output_equals_cast_f32(rng):
    x = torch.from_numpy(_audio(rng, (4, 16000), np.int16))
    f32 = mel_cuda.mel_frontend_fused(x)
    b16 = mel_cuda.mel_frontend_fused(x, out_dtype=torch.bfloat16)
    assert b16.dtype == torch.bfloat16
    assert torch.equal(b16, f32.to(torch.bfloat16))


def test_streaming_equals_batch_exactly(rng):
    """Both streaming forms (mel_streaming_step, and the fused frontend on
    tail + chunk as AudioFeatures runs it) equal the batch frontend."""
    x = torch.from_numpy(_audio(rng, 16000 * 2))
    batch = mel_cuda.mel_frontend_fused(x)
    tail = torch.zeros(TM.LEFT_PAD)
    step, fused = [], []
    for c in range(x.shape[0] // TM.CHUNK):
        chunk = x[c * TM.CHUNK:(c + 1) * TM.CHUNK]
        buf = torch.cat([tail, chunk])
        fused.append(mel_cuda.mel_frontend_fused(buf)[2:])
        tail, frames = TM.mel_streaming_step(tail, chunk)
        step.append(frames)
    n = len(step) * TM.FRAMES_PER_CHUNK
    assert torch.equal(torch.cat(step), batch[:n])
    assert torch.equal(torch.cat(fused), batch[:n])


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
def test_constants_bit_identical_to_jax(dtype_name):
    compute = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    ref = JM._hopdft_constants(dtype_name)
    ours = TM.hopdft_tensors(compute, "cpu")
    for r, o in zip(ref, ours):
        r32 = np.asarray(r, np.float32)       # bf16 -> f32 is exact
        assert o.dtype == torch.float32
        np.testing.assert_array_equal(o.numpy(), r32)


def test_filterbank_reads_bins_2_to_114_only():
    """Bins 115 and above have zero weight, so the top bin's Hann +1 tap
    (repeated here, wrapped in the Pallas kernel) cannot reach the output."""
    fb = TM._mel_filterbank()
    used = np.nonzero(fb.any(axis=1))[0]
    assert used[0] == 2 and used[-1] == 114
    assert not fb[115:].any()
    np.testing.assert_array_equal(fb, JM._mel_filterbank())


def test_silence_hits_floor():
    out = TM.mel_frontend(torch.zeros(16000), compute_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), TM.PAD_VALUE, atol=1e-5)
