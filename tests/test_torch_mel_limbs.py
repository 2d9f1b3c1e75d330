"""The arithmetic of the mel kernel's hop DFT and filterbank, on the CPU.

The CUDA kernel (csrc/mel_frontend.cu) must give the plain version's log-mel
bit for bit on int16 audio. The plain version rounds the power to bf16, so
its hop-DFT sums S have to match to the last bit of float32. These tests
hold the kernel's arithmetic, modelled in plain torch, against
`ops/mel.py::_exact_matmul` on the kernel's inputs:

- the kernel's order: a float64 multiply-add chain over the 160 taps in
  ascending order (what the FP64 tensor cores do, chained over groups of
  taps) equals the plain product bit for bit;
- the int8 limb design the kernel does not use: an exact integer sum of
  int8 limb products, with the basis in 2^-29 units. Its limbs rebuild
  every sample and every basis entry but the float residues, and its sum is
  the exact integer sum; but that sum differs from the plain product on
  random audio, exactly where the residues decide a float32 rounding;
- the sparse filterbank: the nonzero taps of each mel in ascending bin
  order, padded with zero weights, equal the dense float64 product.
"""

import numpy as np
import pytest
import torch

from nanowakeword_tpu_torch.ops import mel as TM
from nanowakeword_tpu_torch.ops import mel_cuda

RESIDUE = 2.0 ** -22      # basis entries below this are float residues
UNIT = 2.0 ** -29         # every other basis entry is a multiple of this
KINDS = mel_cuda.INT16_EDGES


def _audio(rng, kind, shape=(3, 4800)):
    return mel_cuda.int16_edge_audio(rng, shape, kind)


def _rows(x: np.ndarray) -> torch.Tensor:
    """The bf16-rounded hop rows [..., t+2, 160] that the plain version
    multiplies (mel_frontend's padding, then _log_mel_from_rows' rounding)."""
    x = torch.from_numpy(x).float()
    n = x.shape[-1]
    t = -(-n // TM.HOP)
    rows = torch.nn.functional.pad(x, (TM.LEFT_PAD, t * TM.HOP - n))
    rows = rows.reshape(x.shape[:-1] + (t + 2, TM.HOP))
    return TM._round(rows, torch.bfloat16)


def _bases():
    b0c, b0s, *_ = TM.hopdft_tensors(torch.bfloat16, "cpu")
    return {"cos": b0c, "sin": b0s}


def tap_chain(rows: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """The kernel's hop-DFT order: acc = fma(row[t], basis[t], acc) for t =
    0 .. 159 in float64 (every product is exact, so fma equals a multiply
    then an add), rounded once to float32."""
    r, b = rows.double(), basis.double()
    acc = torch.zeros(rows.shape[:-1] + (basis.shape[1],), dtype=torch.float64)
    for t in range(basis.shape[0]):
        acc = acc + r[..., t:t + 1] * b[t]
    return acc.float()


def _split(v: torch.Tensor):
    """Balanced radix-256 split of int64 v into int8 limbs: v = 256 h + l,
    l in [-128, 127]."""
    low = (v + 128) % 256 - 128
    return (v - low) // 256, low


def basis_limbs(basis: torch.Tensor):
    """The basis in 2^-29 units as int8 limbs (high, low), residues as 0."""
    b = basis.double()
    units = torch.where(b.abs() < RESIDUE, 0.0, b / UNIT)
    return _split(units.round().long())


def sample_limbs(rows: torch.Tensor):
    """bf16-rounded int16 samples (integers in [-32768, 32768]) as int8 limbs
    (high, carry, low): v = 256 (high + carry) + low. 32768 (bf16 of 32767)
    and 32640 need a high part of 128, which is outside int8; the carry limb
    (0 or 1) takes the excess."""
    high, low = _split(rows.long())
    carry = (high - 127).clamp(min=0)
    return high - carry, carry, low


def limb_hopdft(rows: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """The int8 limb design: six int8 x int8 products summed in int32 (as
    the int8 tensor cores would), recombined in int64, then float64 and
    x 2^-29, rounded to float32."""
    vh, ve, vl = sample_limbs(rows)
    bh, bl = basis_limbs(basis)
    for limb in (vh, ve, vl, bh, bl):
        assert -128 <= int(limb.min()) and int(limb.max()) <= 127
    parts = {}
    for a_name, a in (("h", vh), ("e", ve), ("l", vl)):
        for b_name, b in (("h", bh), ("l", bl)):
            p = a @ b
            assert int(p.abs().max()) < 2 ** 31      # exact in an s32 sum
            parts[a_name + b_name] = p
    units = (65536 * (parts["hh"] + parts["eh"])
             + 256 * (parts["hl"] + parts["el"] + parts["lh"]) + parts["ll"])
    return (units.double() * UNIT).float()


@pytest.mark.parametrize("kind", KINDS)
def test_tap_chain_matches_plain_product(rng, kind):
    """The kernel's ascending float64 chain gives the plain version's S bit
    for bit, edges included."""
    rows = _rows(_audio(rng, kind))
    for name, basis in _bases().items():
        assert torch.equal(tap_chain(rows, basis),
                           TM._exact_matmul(rows, basis)), name


def test_basis_limbs_rebuild_every_entry_but_the_residues():
    for name, basis in _bases().items():
        b = basis.double()
        high, low = basis_limbs(basis)
        residue = (b.abs() < RESIDUE) & (b != 0)
        rebuilt = (256 * high + low).double() * UNIT
        assert torch.equal(rebuilt[~residue], b[~residue]), name
        assert int(high.abs().max()) <= 64      # |b| <= 2^-15 = 16384 units
        assert float(b[residue].abs().max()) < 2e-18
    counts = {name: int(((basis.abs() < RESIDUE) & (basis != 0)).sum())
              for name, basis in _bases().items()}
    assert counts == {"cos": 540, "sin": 607}
    assert int((_bases()["sin"] == 0).sum()) == 287


def test_sample_limbs_rebuild_every_bf16_sample():
    v = torch.arange(-32768, 32768, dtype=torch.float32)
    rows = TM._round(v, torch.bfloat16)
    assert float(rows.max()) == 32768.0
    high, carry, low = sample_limbs(rows)
    assert torch.equal((256 * (high + carry) + low).double(), rows.double())
    assert set(carry.unique().tolist()) == {0, 1}


@pytest.mark.parametrize("kind", KINDS)
def test_limb_sum_is_the_exact_integer_sum(rng, kind):
    rows = _rows(_audio(rng, kind))
    for name, basis in _bases().items():
        exact = rows.long() @ torch.stack(basis_limbs(basis)).mul(
            torch.tensor([256, 1])[:, None, None]).sum(0)
        assert torch.equal(limb_hopdft(rows, basis),
                           (exact.double() * UNIT).float()), name


def test_limb_sum_misses_the_plain_rounding_on_random_audio(rng):
    """Why the kernel sums in float64 on the FP64 tensor cores and not in
    int8 limbs: the plain S rounds S_exact + (residue products) to float32.
    Where the exact sum sits on a float32 rounding midpoint, or is small
    enough that the residues reach its last bit, the residues decide the
    rounding, and the exact sum misses it. Every difference is there."""
    rows = _rows(_audio(rng, "random", (4, 16000)))
    differ = 0
    for basis in _bases().values():
        limb = limb_hopdft(rows, basis)
        plain = TM._exact_matmul(rows, basis)
        exact = rows.double() @ torch.where(basis.double().abs() < RESIDUE,
                                            0.0, basis.double())
        mant, _ = torch.frexp(exact)
        scaled = mant.abs() * 2.0 ** 24
        midpoint = scaled - scaled.floor() == 0.5
        small = exact.abs() < 2.0 ** -11
        reached = ((rows != 0).double()
                   @ ((basis.abs() < RESIDUE) & (basis != 0)).double()) > 0
        wrong = limb != plain
        assert not (wrong & ~((midpoint | small) & reached)).any()
        differ += int(wrong.sum())
    assert differ > 0


def test_sparse_filterbank_equals_dense(rng):
    """The kernel sums each mel over its nonzero taps in ascending bin order
    (padded with zero weights to MAX_TAPS): the dense float64 product bit for
    bit on bf16 powers from silence to loud."""
    fb = TM.hopdft_tensors(torch.bfloat16, "cpu")[4]
    taps = mel_cuda.filterbank_taps(fb)
    assert sum(len(t) for t in taps) == 216
    assert max(len(t) for t in taps) <= mel_cuda.MAX_TAPS
    for t in taps:
        assert [k for k, _ in t] == sorted(k for k, _ in t)
    power = 10.0 ** rng.uniform(-30, 6, (512, TM.N_BINS))
    power[rng.random(power.shape) < 0.1] = 0.0
    power = TM._round(torch.from_numpy(power).float(), torch.bfloat16)
    dense = TM._exact_matmul(power, fb)
    p = power.double()
    sparse = torch.zeros(power.shape[0], TM.N_MELS, dtype=torch.float64)
    for m, t in enumerate(taps):
        padded = t + [(0, 0.0)] * (mel_cuda.MAX_TAPS - len(t))
        for k, w in padded:
            sparse[:, m] = sparse[:, m] + p[:, k] * w
    assert torch.equal(sparse.float(), dense)
