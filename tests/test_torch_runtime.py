"""The port's native audio runtime against the JAX package's, on the CPU.

Both libraries are built with g++ from their own sources. WAV decoding,
the ring and the chunker must give the JAX package's results bit for bit,
and each native class must equal its numpy twin.
"""

import io
import os
import struct
import wave

import numpy as np
import pytest

from nanowakeword_tpu import runtime as jax_runtime
from nanowakeword_tpu.utils import audio_io as jax_audio_io
from nanowakeword_tpu_torch import runtime
from nanowakeword_tpu_torch.ops import _build
from nanowakeword_tpu_torch.utils import audio_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCM_GUID = bytes.fromhex("0100000000001000800000aa00389b71")


def _pcm(rng, frames, channels, width=2):
    if width == 1:
        return rng.integers(0, 256, frames * channels).astype(np.uint8)
    info = np.iinfo({2: np.int16, 4: np.int32}[width])
    dtype = {2: np.int16, 4: np.int32}[width]
    return rng.integers(info.min, info.max, frames * channels,
                        endpoint=True).astype(dtype)


def _stdlib_wav(samples, channels, width, rate=16000) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(rate)
        f.writeframes(samples.tobytes())
    return buf.getvalue()


def _chunk(tag: bytes, body: bytes, declared=None) -> bytes:
    size = len(body) if declared is None else declared
    pad = b"\0" if len(body) % 2 and declared is None else b""
    return tag + struct.pack("<I", size) + body + pad


def _riff(*chunks) -> bytes:
    body = b"WAVE" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _fmt(channels, rate=16000, bits=16, extensible=False) -> bytes:
    block = channels * bits // 8
    base = struct.pack("<hhiih", 1, channels, rate, rate * block, block)
    base += struct.pack("<h", bits)
    if not extensible:
        return _chunk(b"fmt ", base)
    ext = (struct.pack("<hhiih", -2, channels, rate, rate * block, block)
           + struct.pack("<hhhI", bits, 22, bits, 0) + PCM_GUID)
    return _chunk(b"fmt ", ext)


def _cases():
    rng = np.random.default_rng(5)
    cases = {
        "mono": _stdlib_wav(_pcm(rng, 4001, 1), 1, 2),
        "stereo": _stdlib_wav(_pcm(rng, 3000, 2), 2, 2, rate=22050),
        "three_channels": _stdlib_wav(_pcm(rng, 2001, 3), 3, 2),
        # a data chunk of an odd byte count (half a frame, then the pad)
        "odd_data": _riff(_fmt(2), _chunk(b"data",
                                          _pcm(rng, 1001, 2).tobytes()[:-1])),
        # a data chunk that declares more bytes than the buffer holds
        "truncated": _riff(_fmt(1), _chunk(b"data",
                                           _pcm(rng, 1500, 1).tobytes(),
                                           declared=6000)),
        # an odd-sized LIST chunk between fmt and data
        "list_chunk": _riff(_fmt(2),
                            _chunk(b"LIST", b"INFOISFT\x05\0\0\0abcde"),
                            _chunk(b"data", _pcm(rng, 800, 2).tobytes())),
        "extensible": _riff(_fmt(2, extensible=True),
                            _chunk(b"data", _pcm(rng, 1200, 2).tobytes())),
        "pcm8": _stdlib_wav(_pcm(rng, 2000, 1, width=1), 1, 1),
        "pcm8_stereo": _stdlib_wav(_pcm(rng, 1000, 2, width=1), 2, 1),
        "pcm32": _stdlib_wav(_pcm(rng, 1000, 1, width=4), 1, 4),
        "pcm32_stereo": _stdlib_wav(_pcm(rng, 700, 2, width=4), 2, 4),
    }
    return cases


CASES = _cases()


def _outcome(fn, *args):
    """fn's result, or the type of what it raised."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001
        return type(e)


def _assert_same(a, b):
    if isinstance(a, type) or isinstance(b, type):
        assert a is b, (a, b)
        return
    (da, ra), (db, rb) = a, b
    assert ra == rb
    assert da.dtype == db.dtype
    np.testing.assert_array_equal(da, db)


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_wav_bytes_matches_jax(name):
    buf = CASES[name]
    ours = _outcome(runtime.decode_wav_bytes, buf)
    _assert_same(ours, _outcome(jax_runtime.decode_wav_bytes, buf))
    _assert_same(ours, _outcome(runtime.plain_decode_wav_bytes, buf))


@pytest.mark.parametrize("name", sorted(CASES))
def test_read_wav_matches_jax(tmp_path, monkeypatch, name):
    path = str(tmp_path / f"{name}.wav")
    with open(path, "wb") as f:
        f.write(CASES[name])
    ours = _outcome(audio_io.read_wav, path)
    _assert_same(ours, _outcome(jax_audio_io.read_wav, path))
    monkeypatch.setattr(audio_io, "WAV_DECODER",
                        runtime.plain_decode_wav_bytes)
    _assert_same(ours, _outcome(audio_io.read_wav, path))
    if not isinstance(ours, type):
        assert ours[0].dtype == np.float32 and ours[0].size > 0


def test_native_decoder_takes_pcm16_and_rejects_the_rest():
    """The codes of the native parse: 0 for 16-bit PCM, -2 for other
    formats (their buffers go through the stdlib path), -1 for no RIFF."""
    codes = {name: runtime._parse_pcm16(buf)[0] for name, buf in CASES.items()}
    assert {n for n, c in codes.items() if c == 0} == {
        "mono", "stereo", "three_channels", "odd_data", "truncated",
        "list_chunk"}
    assert codes["extensible"] == codes["pcm8"] == codes["pcm32"] == -2
    assert runtime._parse_pcm16(b"RIFX" + bytes(60))[0] == -1
    with pytest.raises(Exception):
        runtime.decode_wav_bytes(b"RIFX" + bytes(60))


def _ring_script(capacity, seed):
    rng = np.random.default_rng(seed)
    sizes = [(int(rng.integers(0, capacity // 2 + 2)),
              int(rng.integers(0, capacity // 3 + 2))) for _ in range(12)]
    # overflow: one push past the rounded capacity, one of exactly it
    sizes += [(2 * capacity + 7, 5), (runtime.ring_capacity(capacity), 0),
              (3, 10 * capacity)]
    return [(rng.integers(-32768, 32767, n_push, endpoint=True)
             .astype(np.int16), n_pop) for n_push, n_pop in sizes]


@pytest.mark.parametrize("capacity", [256, 3000, 160000])
def test_ring_matches_jax_and_plain(capacity):
    rings = [runtime.AudioRing(capacity), runtime.PlainAudioRing(capacity),
             jax_runtime.AudioRing(capacity)]
    assert rings[0].capacity == rings[1].capacity == \
        runtime.ring_capacity(capacity)
    for x, n_pop in _ring_script(capacity, capacity):
        wrote = [r.push(x) for r in rings]
        assert wrote[0] == wrote[1] == wrote[2], wrote
        assert len({r.size for r in rings}) == 1
        got = [r.pop(n_pop) for r in rings]
        for g in got[1:]:
            np.testing.assert_array_equal(got[0], g)
        assert len({r.size for r in rings}) == 1


def test_ring_rounds_capacity_up():
    ring = runtime.AudioRing(3000)
    ring.push(np.arange(5000))
    assert ring.capacity == 4096 and ring.size == 4096
    assert ring.pop(1)[0] == 5000 - 4096
    assert runtime.AudioRing(160000).capacity == 262144


@pytest.mark.parametrize("kind", ["int16", "float32"])
def test_chunker_matches_jax_and_plain(kind):
    rng = np.random.default_rng(8)
    chunkers = [runtime.Chunker(1280), runtime.PlainChunker(1280),
                jax_runtime.Chunker(1280)]
    for n in [0, 100, 1279, 1, 1280, 5000, 17, 40000, 3]:
        if kind == "int16":
            x = rng.integers(-32768, 32767, n, endpoint=True).astype(np.int16)
        else:   # fractional samples, which the int16 feed would round
            x = (rng.normal(0, 3000, n) + 0.37).astype(np.float32)
        outs = [c.feed(x) for c in chunkers]
        for o in outs[1:]:
            assert o.dtype == np.float32
            np.testing.assert_array_equal(outs[0], o)
        assert len({c.pending for c in chunkers}) == 1
    for c in chunkers:
        c.reset()
        assert c.pending == 0


def test_library_is_built_under_build():
    lib = runtime.load_native()
    path = runtime.library_path()
    assert os.path.exists(path)
    assert path.startswith(os.path.join(ROOT, "build", "nww_torch_kernels"))
    assert lib._name == path
    assert "native" not in os.path.relpath(path, ROOT).split(os.sep)


def test_failed_build_raises(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "nww_runtime.cc").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(runtime, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        runtime.load_native()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        runtime.AudioRing(256)
    assert not list((tmp_path / "build").glob("*.so"))
