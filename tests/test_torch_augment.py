"""The port's augmentation (ops/mix.py, ops/augment.py) against the JAX
package, on the CPU.

torch cannot reproduce JAX's threefry draws, so each test takes the JAX
package's own draws from a key, hands them to the port's application
functions, and compares the audio at the bound stated in the test. The
port's own draws are checked by their distributions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanowakeword_tpu.ops import augment as JA
from nanowakeword_tpu.ops.mix_pallas import mix_gain_pallas
from nanowakeword_tpu_torch.ops import augment as TA
from nanowakeword_tpu_torch.ops import mix_cuda
from nanowakeword_tpu_torch.ops.mix import mix_gain_plain

# tests/test_mix_pallas.py's bounds: 2 ulp of the batch peak before
# quantization (the reference may contract bg + shifted * scale into one
# FMA), 1 int16 LSB after it
ULP2 = 2.0 ** -22
PITCH_TOL = 1e-5       # unit-scale audio through bf16-rounded operands
RIR_TOL = 1e-4         # FFT convolution at other transform lengths
T = torch.from_numpy


def _audio(rng, b, n, int16=True):
    fg = rng.integers(-16000, 16000, (b, n)).astype(np.int16)
    if not int16:
        fg = fg.astype(np.float32) / 32768.0
    bg = (rng.integers(-3000, 3000, (b, n)) / 32768.0).astype(np.float32)
    fg_lens = rng.integers(n // 2, n + 1, b).astype(np.int32)
    has_bg = rng.random(b) < 0.6
    has_bg[:2] = (True, False)
    return fg, bg, fg_lens, has_bg


def _within_2ulp(out, ref, ulps=ULP2):
    tol = ulps * max(np.abs(ref).max(), 1.0)
    assert np.abs(out - ref).max() <= tol


def _int16(x):
    return np.clip(x * 32767.0, -32768, 32767).astype(np.int16).astype(
        np.int32)


def jax_draws(key, fg_lens, n, jp) -> TA.AugmentDraws:
    """The JAX package's per-clip draws for `augment_batch(key, ...)`, in
    the port's AugmentDraws layout."""
    b = len(fg_lens)
    keys = jax.random.split(key, b)
    offset, snr, gain_db, gain_gate = jax.vmap(
        JA._pre_draws, in_axes=(0, 0, None, None))(
            keys, jnp.asarray(fg_lens), n, jp)

    def per_key(k):
        s = jax.random.split(k, 9)
        u = jax.random.uniform
        return dict(
            pitch_gate=JA._pitch_gate(k, jp),
            semitones=u(s[3], (), minval=jp.min_pitch, maxval=jp.max_pitch),
            rir_gate=u(s[8], ()) < jp.rir_prob,
            volume=u(s[5], (), minval=jp.min_volume, maxval=jp.max_volume),
            eq_coeffs=u(jax.random.fold_in(k, 101), (2,),
                        minval=jnp.asarray([-0.8, -0.4]),
                        maxval=jnp.asarray([0.8, 0.4])),
            eq_gate=u(jax.random.fold_in(k, 102), ()) < jp.eq_prob,
            bandlimit_fc=u(jax.random.fold_in(k, 103), (), minval=2000.0,
                           maxval=7000.0),
            bandlimit_gate=u(jax.random.fold_in(k, 104), ())
            < jp.bandlimit_prob,
            companding_gate=u(jax.random.fold_in(k, 105), ())
            < jp.companding_prob)

    rest = {k: T(np.array(v)) for k, v in jax.vmap(per_key)(keys).items()}
    perm = jax.random.permutation(jax.random.fold_in(key, 106),
                                  max(jp.pitch_grid, 1))
    return TA.AugmentDraws(
        offset=T(np.array(offset)).long(), snr_db=T(np.array(snr)),
        gain_db=T(np.array(gain_db)), gain_gate=T(np.array(gain_gate)),
        pitch_perm=T(np.array(perm)).long(), **rest)


def _params(settings):
    return (JA.AugmentParams.from_settings(settings),
            TA.AugmentParams.from_settings(settings))


# -- the mix kernel's contract ---------------------------------------------------


@pytest.mark.parametrize("int16", [True, False])
def test_mix_gain_plain_matches_pallas(int16):
    b, n = 8, 1280
    rng = np.random.default_rng(1)
    fg, bg, _, has_bg = _audio(rng, b, n, int16)
    q = rng.integers(0, n // 128, b).astype(np.int32)
    q[:4] = (0, n // 128 - 1, 0, n // 128 - 1)
    scale = rng.uniform(0.1, 3.0, b).astype(np.float32)
    gain = rng.uniform(0.7, 1.4, b).astype(np.float32)
    args = (fg, bg, q, scale, has_bg, gain)
    ref = np.asarray(mix_gain_pallas(*map(jnp.asarray, args),
                                     interpret=True))
    before = mix_cuda.launches
    out = mix_cuda.mix_gain_fused(*map(T, args)).numpy()
    assert mix_cuda.launches == before          # the CPU never launches
    np.testing.assert_array_equal(out[~has_bg], ref[~has_bg])
    _within_2ulp(out, ref)
    assert np.abs(_int16(out) - _int16(ref)).max() <= 1
    np.testing.assert_array_equal(out, mix_gain_plain(*map(T, args)).numpy())


def test_mix_gain_zero_offset_no_background_is_exact():
    b, n = 4, 640
    fg, bg, _, _ = _audio(np.random.default_rng(7), b, n)
    out = mix_gain_plain(T(fg), T(bg), torch.zeros(b, dtype=torch.int32),
                         torch.full((b,), 2.0), torch.zeros(b, dtype=bool),
                         torch.ones(b))
    np.testing.assert_array_equal(out.numpy(),
                                  fg.astype(np.float32) * (1.0 / 32768.0))


def test_mix_gain_rejects_malformed_input():
    fg = torch.zeros(2, 1280, dtype=torch.int16)
    bg = torch.zeros(2, 1280)
    per = [torch.zeros(2, dtype=torch.int32), torch.ones(2),
           torch.ones(2, dtype=bool), torch.ones(2)]
    with pytest.raises(ValueError, match="n % 128"):
        mix_cuda.mix_gain_fused(fg[:, :1000], bg[:, :1000], *per)
    with pytest.raises(ValueError):
        mix_cuda.mix_gain_fused(fg, bg[:1], *per)
    with pytest.raises(TypeError):
        mix_cuda.mix_gain_fused(fg.double(), bg, *per)
    with pytest.raises(ValueError, match="CUDA"):
        mix_cuda.mix_gain_cuda(fg, bg, *per)


# -- stages, fed the JAX draws ------------------------------------------------------


@pytest.mark.parametrize("int16", [True, False])
def test_pre_stage_matches_jax(int16):
    b, n = 8, 1280
    fg, bg, fg_lens, has_bg = _audio(np.random.default_rng(3), b, n, int16)
    jp, tp = _params({"rir_prob": 0.0})
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, b)
    fg_unit = (jnp.asarray(fg).astype(jnp.float32) * (1.0 / 32768.0)
               if int16 else jnp.asarray(fg))
    ref = np.asarray(jax.vmap(JA._augment_pre,
                              in_axes=(0, 0, 0, 0, 0, None))(
        keys, fg_unit, jnp.asarray(bg), jnp.asarray(fg_lens),
        jnp.asarray(has_bg), jp))
    draws = jax_draws(key, fg_lens, n, jp)
    out = TA.augment_pre(T(fg), TA._to_unit(T(fg)), T(bg), T(has_bg),
                         draws, tp).numpy()
    np.testing.assert_array_equal(out[~has_bg], ref[~has_bg])
    _within_2ulp(out, ref)
    assert np.abs(_int16(out) - _int16(ref)).max() <= 1


def test_unaligned_pre_stage_matches_jax():
    """offset_quantum 1: sample-exact placement, the plain mix_snr path."""
    b, n = 6, 1000
    fg, bg, fg_lens, has_bg = _audio(np.random.default_rng(4), b, n, False)
    jp, tp = _params({"offset_quantum": 1})
    key = jax.random.PRNGKey(8)
    ref = np.asarray(jax.vmap(JA._augment_pre,
                              in_axes=(0, 0, 0, 0, 0, None))(
        jax.random.split(key, b), jnp.asarray(fg), jnp.asarray(bg),
        jnp.asarray(fg_lens), jnp.asarray(has_bg), jp))
    draws = jax_draws(key, fg_lens, n, jp)
    assert (draws.offset % 128 != 0).any()
    out = TA.augment_pre(T(fg), T(fg), T(bg), T(has_bg), draws, tp).numpy()
    # the SNR scale comes from two RMS reductions taken in another order
    # than XLA's (about 1e-7 relative each): one more ulp of the peak
    _within_2ulp(out, ref, 2 * ULP2)


def _unit_noise(seed, b, n):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, (b, n)).astype(
        np.float32)


def test_rational_pitch_matches_jax():
    b, n = 16, 1280
    x = _unit_noise(10, b, n)
    apply = np.random.default_rng(11).random(b) < 0.6
    pgrid = JA.pitch_pgrid(-2.0, 2.0, 16)
    assert pgrid == TA.pitch_pgrid(-2.0, 2.0, 16)
    ref = np.asarray(JA.resample_pitch_rational(jnp.asarray(x), pgrid,
                                                jnp.asarray(apply)))
    out = TA.resample_pitch_rational(T(x), pgrid, T(apply)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=PITCH_TOL)


def test_grouped_pitch_matches_jax():
    b, n = 16, 1280
    x = _unit_noise(12, b, n)
    apply = np.random.default_rng(13).random(b) < 0.6
    grid = JA.pitch_grid(-2.0, 2.0, 8)
    perm = np.random.default_rng(14).permutation(8)
    window = JA.pitch_window(2.0)
    ref = np.asarray(JA.resample_pitch_grouped(
        jnp.asarray(x), grid, jnp.asarray(perm), jnp.asarray(apply),
        window=window))
    out = TA.resample_pitch_grouped(T(x), grid, T(perm), T(apply),
                                    window=window).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=PITCH_TOL)


@pytest.mark.parametrize("n", [1280, 1000])   # framed, and direct
def test_continuous_pitch_matches_jax(n):
    b = 6
    x = _unit_noise(15, b, n)
    rng = np.random.default_rng(16)
    semis = rng.uniform(-2.0, 2.0, b).astype(np.float32)
    apply = np.array([True, True, False, True, True, False])
    window = JA.pitch_window(2.0)
    ref = np.asarray(jax.vmap(
        lambda v, s, a: JA.resample_pitch(v, s, a, window=window))(
            jnp.asarray(x), jnp.asarray(semis), jnp.asarray(apply)))
    out = TA.resample_pitch(T(x), T(semis), T(apply), window=window).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=PITCH_TOL)


def test_rir_convolve_matches_jax():
    b, n = 4, 4000
    rng = np.random.default_rng(17)
    x = _unit_noise(18, b, n) * 0.3
    rir = (rng.normal(0, 1, (b, 800))
           * np.exp(-np.arange(800) / 150.0)).astype(np.float32)
    apply = np.array([True, False, True, True])
    ref = np.asarray(jax.vmap(JA.rir_convolve)(
        jnp.asarray(x), jnp.asarray(rir), jnp.asarray(apply)))
    out = TA.rir_convolve(T(x), T(rir), T(apply)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=RIR_TOL)
    np.testing.assert_array_equal(out[1], x[1])


@pytest.mark.parametrize("extra", [
    {},
    {"eq_prob": 0.7, "bandlimit_prob": 0.6, "companding_prob": 0.5},
])
def test_post_stage_matches_jax(extra):
    b, n = 8, 2000
    rng = np.random.default_rng(19)
    x = _unit_noise(20, b, n) * 0.4
    rir = (rng.normal(0, 1, (b, 500))
           * np.exp(-np.arange(500) / 100.0)).astype(np.float32)
    has_rir = rng.random(b) < 0.7
    jp, tp = _params({"rir_prob": 0.5, **extra})
    key = jax.random.PRNGKey(21)
    ref = np.asarray(jax.vmap(JA._augment_post,
                              in_axes=(0, 0, 0, 0, None))(
        jax.random.split(key, b), jnp.asarray(x), jnp.asarray(rir),
        jnp.asarray(has_rir), jp))
    draws = jax_draws(key, np.full(b, n), n, jp)
    out = TA.augment_post(T(x), T(rir), T(has_rir), draws, tp).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=RIR_TOL)


@pytest.mark.parametrize("settings,route", [
    ({"rir_prob": 0.5}, "rational"),
    ({"rir_prob": 0.5, "pitch_rational": False}, "grouped"),
    ({"rir_prob": 0.0, "pitch_grid_rates": 0}, "continuous"),
    ({"rir_prob": 0.0, "pitch_prob": 0.0, "offset_quantum": 1}, "off"),
])
@pytest.mark.parametrize("int16", [True, False])
def test_augment_batch_matches_jax(settings, route, int16):
    """The whole chain with the JAX draws: int16 within 2 LSB."""
    b, n = 16, 1280
    rng = np.random.default_rng(22)
    fg, bg, fg_lens, has_bg = _audio(rng, b, n, int16)
    if not int16:
        fg = fg * 32768.0            # int16-scale float: the runtime test
    rir = (rng.normal(0, 1, (b, 400))
           * np.exp(-np.arange(400) / 80.0)).astype(np.float32)
    has_rir = rng.random(b) < 0.7
    jp, tp = _params(settings)
    assert TA._pitch_route(b, n, tp) == route
    key = jax.random.PRNGKey(23)
    # the reference op by op: its jitted graph rounds the grouped and
    # continuous pitch paths' bf16 operands differently from its own eager
    # run (up to 122 LSB on this input), the port follows the ops as written
    with jax.disable_jit():
        ref = np.asarray(JA.augment_batch(key, fg, bg, rir, fg_lens,
                                          has_bg, has_rir, jp))
    out = TA.augment_batch(T(fg), T(bg), T(rir), fg_lens, T(has_bg),
                           T(has_rir), tp,
                           draws=jax_draws(key, fg_lens, n, jp))
    assert out.dtype == torch.int16 and out.shape == (b, n)
    diff = np.abs(out.numpy().astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 2


def test_spec_augment_matches_jax():
    b, t, f = 4, 16, 96
    mel = np.random.default_rng(24).normal(0, 1, (b, t, f)).astype(
        np.float32)
    key = jax.random.PRNGKey(25)
    ref = np.asarray(JA.spec_augment(key, jnp.asarray(mel)))
    masks = []
    keys = jax.random.split(key, 4)
    for i, (axis, length, width) in enumerate(
            [(1, t, 10), (1, t, 10), (2, f, 6), (2, f, 6)]):
        k1, k2 = jax.random.split(keys[i])
        starts = jax.random.randint(k1, (b,), 0, max(length - width, 1))
        widths = jax.random.randint(k2, (b,), 0, width + 1)
        masks.append((axis, T(np.asarray(starts)), T(np.asarray(widths))))
    out = TA.spec_augment(T(mel), masks).numpy()
    np.testing.assert_array_equal(out, ref)
    drawn = TA.spec_augment(T(mel), generator=torch.Generator().manual_seed(0))
    assert drawn.shape == mel.shape and (drawn.numpy() == mel.min()).any()


# -- the port's own draws ---------------------------------------------------------------


def test_draw_distributions():
    b, n = 4096, 32000
    tp = TA.AugmentParams.from_settings({"gain_prob": 0.7, "eq_prob": 0.2})
    fg_lens = np.random.default_rng(26).integers(8000, 32001, b)
    d = TA.draw_augment(fg_lens, n, tp, torch.Generator().manual_seed(27))
    assert ((d.offset >= 0)
            & (d.offset <= torch.from_numpy(n - fg_lens).clamp(min=0))).all()
    assert (d.offset % 128 == 0).all()
    for v, lo, hi in ((d.snr_db, 5.0, 30.0), (d.gain_db, -3.0, 3.0),
                      (d.semitones, -2.0, 2.0), (d.volume, 0.5, 1.0),
                      (d.bandlimit_fc, 2000.0, 7000.0)):
        assert v.dtype == torch.float32
        assert lo <= v.min() and v.max() < hi
        assert abs(v.mean().item() - (lo + hi) / 2) < 0.05 * (hi - lo)
    assert (d.eq_coeffs.abs() <= torch.tensor([0.8, 0.4])).all()
    for g, p in ((d.gain_gate, 0.7), (d.pitch_gate, 0.5), (d.rir_gate, 0.5),
                 (d.eq_gate, 0.2), (d.bandlimit_gate, 0.0),
                 (d.companding_gate, 0.0)):
        sigma = np.sqrt(p * (1 - p) / b)
        assert abs(g.float().mean().item() - p) <= 3 * sigma + 1e-12
    assert sorted(d.pitch_perm.tolist()) == list(range(16))


def test_augment_batch_draws_from_generator():
    b, n = 16, 1280
    fg, bg, fg_lens, has_bg = _audio(np.random.default_rng(28), b, n)
    tp = TA.AugmentParams.from_settings({"rir_prob": 0.0})

    def run(seed):
        return TA.augment_batch(
            T(fg), T(bg), torch.zeros(b, 10), fg_lens, T(has_bg),
            torch.zeros(b, dtype=bool), tp,
            generator=torch.Generator().manual_seed(seed))

    a, again, other = run(1), run(1), run(2)
    assert torch.equal(a, again) and not torch.equal(a, other)
    assert a.abs().max() <= 32767 and a.abs().max() >= 16000
