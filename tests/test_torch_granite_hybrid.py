"""The port's Granite-4.0-H hybrid family (`granite_hybrid`) on the CPU at a
tiny size, against the plain reference the benchmark uses
(`port_bench/reference/families/granite_hybrid.py`, float64).

The family has no counterpart in the JAX package, so nothing here imports
JAX. Sizes: d = 64, 4 query heads over 2 key/value heads, 8 Mamba-2 heads
of 16 with a state of 16, chunk 8, T = 24 (three chunks) and T = 20 (the
last chunk short), the pattern mamba, mamba, attention, mamba. Weights are
drawn as the benchmark draws them (port_bench/program.py).
"""

import io
import os

import numpy as np
import pytest
import torch

from nanowakeword_tpu_torch.export.artifact import load_nww, save_nww
from nanowakeword_tpu_torch.interpreter.nanointerpreter import _LocalSession
from nanowakeword_tpu_torch.models import architectures as A
from nanowakeword_tpu_torch.models.model import Model
from nanowakeword_tpu_torch.utils import flax_msgpack, tracing
from port_bench import program
from port_bench.drivers import stream
from port_bench.reference import models as refmodels
from port_bench.reference.families import conformer as refconformer
from port_bench.reference.families import granite_hybrid as refgranite

CPU = torch.device("cpu")
# float32 against float64: the forward's rounding is ~1e-7 relative; TF32
# operands (10 mantissa bits) or bfloat16 ones put it near 1e-3
FORWARD_TOL = 1e-5
TINY = {"embedding_dim": 32, "granite_d_model": 64,
        "granite_layer_types": ["mamba", "mamba", "attention", "mamba"],
        "granite_intermediate_size": 96, "granite_mamba_d_state": 16,
        "granite_mamba_d_conv": 4, "granite_mamba_expand": 2,
        "granite_mamba_n_heads": 8, "granite_mamba_d_head": 16,
        "granite_mamba_n_groups": 1, "granite_mamba_chunk_size": 8,
        "granite_attention_heads": 4, "granite_kv_heads": 2}


def _entry(t: int = 24) -> dict:
    return dict(TINY, model_type="granite_hybrid", input_shape=[t, 96],
                n_blocks=4)


def _variables(seed: int = 3, t: int = 24) -> dict:
    return program.seeded_variables(refgranite.layout(_entry(t)), seed, CPU)


def _model(variables=None, t: int = 24) -> Model:
    m = Model(config=dict(TINY), model_name="granite_tiny",
              input_shape=(t, 96), model_type="granite_hybrid", n_blocks=4,
              dropout_prob=0.0, device="cpu")
    if variables is not None:
        m.load_variables(variables)
    return m


def _features(n: int, t: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, t, 96)).astype(
        np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("t", [24, 20])
def test_forward_matches_the_plain_reference(t):
    variables = _variables(t=t)
    m = _model(variables, t)
    x = _features(5, t)
    got = m.module.backbone(torch.from_numpy(x)).detach().numpy()
    ref = refgranite.backbone(
        torch.from_numpy(x).double(),
        refmodels.to_tensors(variables, refmodels.REFERENCE, CPU),
        refmodels.REFERENCE).numpy()
    assert _rel(got, ref) < FORWARD_TOL
    control = refgranite.backbone(
        torch.from_numpy(x),
        refmodels.to_tensors(variables, refmodels.CONTROL_TF32, CPU),
        refmodels.CONTROL_TF32).numpy()
    assert _rel(control, ref) > 3 * FORWARD_TOL
    probs = refmodels.classifier(
        torch.from_numpy(x).double(),
        refmodels.to_tensors(variables, refmodels.REFERENCE, CPU),
        "granite_hybrid", refmodels.REFERENCE).numpy()
    assert _rel(torch.sigmoid(m(x)).reshape(-1).numpy(), probs) \
        < FORWARD_TOL


def _sequential_scan(x, dt, a, b, c):
    """s_t = exp(dt_t a) s_{t-1} + dt_t x_t b_t^T, y_t = s_t c_t, one step
    at a time."""
    bsz, t, h, p = x.shape
    hg = h // b.shape[2]
    s = x.new_zeros(bsz, h, p, b.shape[3])
    ys = []
    for i in range(t):
        bi = b[:, i].repeat_interleave(hg, 1)
        ci = c[:, i].repeat_interleave(hg, 1)
        s = torch.exp(dt[:, i] * a)[..., None, None] * s \
            + (dt[:, i, :, None] * x[:, i])[..., None] * bi[:, :, None]
        ys.append((s @ ci[..., None])[..., 0])
    return torch.stack(ys, 1)


@pytest.mark.parametrize("t,groups", [(24, 1), (20, 1), (24, 2)])
def test_chunked_scan_matches_the_recurrence_and_the_masked_form(t, groups):
    g = torch.Generator().manual_seed(t + groups)
    h, p, n = 8, 16, 16
    x = torch.randn(3, t, h, p, generator=g, dtype=torch.float64)
    dt = torch.nn.functional.softplus(
        torch.randn(3, t, h, generator=g, dtype=torch.float64))
    a = -torch.exp(torch.rand(h, generator=g, dtype=torch.float64))
    b = torch.randn(3, t, groups, n, generator=g, dtype=torch.float64)
    c = torch.randn(3, t, groups, n, generator=g, dtype=torch.float64)
    y = A.ssd_chunked(x, dt, a, b, c, chunk=8)
    want = _sequential_scan(x, dt, a, b, c)
    assert _rel(y, want) < 1e-12
    assert _rel(refgranite._ssd(x, dt, a, b, c, refmodels.REFERENCE),
                want) < 1e-12
    y32 = A.ssd_chunked(*(v.float() for v in (x, dt, a, b, c)), chunk=8)
    assert _rel(y32, want) < FORWARD_TOL
    # the state passed between chunks carries: a scan cut at each chunk's
    # start and restarted from zero differs
    cut = torch.cat([A.ssd_chunked(x[:, i:i + 8], dt[:, i:i + 8], a,
                                   b[:, i:i + 8], c[:, i:i + 8], chunk=8)
                     for i in range(0, t, 8)], 1)
    assert _rel(cut, want) > 1e-3


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_the_passed_state_carries_at_published_scan_widths(device):
    """One clip's scan at granite-4.0-h-micro's widths (64 heads of 64, a
    state of 128, one group, chunk 256, 512 frames: two chunks) with
    Mamba-2's draws of A and the steps (`Mamba2Mixer.reset_ssm_`), against
    the reference's masked form. With these draws a state lasts hundreds of
    frames, so the last frame, the one the model reads, depends on the state
    passed from the first chunk: a scan that restarts each chunk from zero
    is far outside the tolerance."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device(device)
    h, p, n, t, chunk = 64, 64, 128, 512, 256
    mixer = A.Mamba2Mixer(64, h, p, n, 1, 4, chunk, 1e-5)
    g = torch.Generator().manual_seed(20)
    mixer.reset_ssm_(g)
    a = -torch.exp(mixer.A_log.detach().double())
    assert a.max() <= -1 and a.min() >= -16
    dt = torch.nn.functional.softplus(
        mixer.dt_bias.detach().double()
        + 0.1 * torch.randn(1, t, h, generator=g, dtype=torch.float64))
    x, b, c = (torch.randn(*shape, generator=g, dtype=torch.float64)
               for shape in ((1, t, h, p), (1, t, 1, n), (1, t, 1, n)))
    x, dt, a, b, c = (v.to(dev) for v in (x, dt, a, b, c))
    want = refgranite._ssd(x, dt, a, b, c, refmodels.REFERENCE)
    assert _rel(A.ssd_chunked(x, dt, a, b, c, chunk).cpu(), want.cpu()) \
        < 1e-12
    y32 = A.ssd_chunked(*(v.float() for v in (x, dt, a, b, c)), chunk)
    assert _rel(y32.cpu(), want.cpu()) < FORWARD_TOL
    cut = torch.cat([A.ssd_chunked(x[:, i:i + chunk], dt[:, i:i + chunk], a,
                                   b[:, i:i + chunk], c[:, i:i + chunk],
                                   chunk) for i in (0, chunk)], 1)
    assert _rel(cut[:, -1].cpu(), want[:, -1].cpu()) > 100 * FORWARD_TOL


def test_run_batch_after_an_nww_round_trip_is_bit_exact(tmp_path):
    m = _model(_variables())
    x = _features(7, 24, seed=1)
    before = torch.sigmoid(m(x)).reshape(-1).numpy()
    path = save_nww(str(tmp_path / "g.nww"), model=m, config=dict(TINY),
                    model_name="granite_tiny")
    header, loaded, _ = load_nww(path, device="cpu")
    assert header["arch_config"]["granite_layer_types"] \
        == TINY["granite_layer_types"]
    assert np.array_equal(_LocalSession(loaded, header).run_batch(x), before)
    for name, value in m.module.state_dict().items():
        assert torch.equal(loaded.module.state_dict()[name], value), name


def test_streaming_three_clips_matches_the_reference(tmp_path):
    """NanoInterpreter streams three clips through the one-call step at
    window 16 (two scan chunks of 8); every served score against the
    reference's stream_raw/served, by the benchmark's gap rule (the widest
    reads ~2e-7 here; the bound leaves 500 times that)."""
    config = {"weights": {"kind": "seeded", "model": "g",
                          "encoder_file": "hey_nano_crnn/hey_nano_crnn.nww"},
              "models": {"g": _entry(16)}, "stream_models": ["g"],
              "cascade": None}
    weights = program.Weights(config, 5, CPU, str(tmp_path))
    traffic = {"clip_chunks": [16, 20], "pool_clips": 3,
               "audio": _speech_audio()}
    clips = dict(enumerate(stream.make_clips(traffic, 5, CPU)))
    interp = program.stream_interpreter(config, weights, CPU)
    served = [(i, stream._stream(interp, clips[i], ["g"])[0])
              for i in clips]
    want = stream.reference_served(config, weights, clips, ["g"], CPU,
                                   refmodels.REFERENCE, 1e-3)
    gaps = stream.chunk_gaps(config, ["g"], served, want)
    assert len(gaps) == sum(len(c) // 1280 for c in clips.values())
    assert gaps.max() < 1e-4
    late = np.array([want[i][0][-1, 0] for i in clips])
    assert late.min() > 0 and len(np.unique(np.round(late, 6))) == 3


def _speech_audio() -> dict:
    from port_bench.run import load_json
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return load_json(os.path.join(root, "port_bench", "traffic",
                                  "bulk_42s.json"))["audio"]


def _attention_tree(module) -> dict:
    from nanowakeword_tpu_torch.convert import _attention_flax
    return _attention_flax(module.state_dict(), module)


def _random_(module, seed: int):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)


def test_attention_with_its_defaults_matches_the_conformer_reference():
    att = A.MultiHeadAttention(32, 4, dropout=0.0).eval()
    _random_(att, 1)
    x = torch.from_numpy(_features(3, 16)[..., :32])
    p = refmodels.to_tensors(_attention_tree(att), refmodels.REFERENCE, CPU)
    ref = refconformer._attention(x.double(), p, refmodels.REFERENCE)
    assert _rel(att.double()(x.double()).detach(), ref) < 1e-12
    assert _rel(att.float()(x).detach(), ref) < FORWARD_TOL


def test_grouped_causal_attention_matches_the_granite_reference():
    att = A.MultiHeadAttention(64, 8, dropout=0.0, kv_heads=2, bias=False,
                               causal=True,
                               scale=refgranite.PUBLISHED[
                                   "granite_attention_multiplier"]).eval()
    _random_(att, 2)
    tree = _attention_tree(att)
    assert tree["key"]["kernel"].shape == (64, 2, 8)
    assert all("bias" not in leaf for leaf in tree.values())
    x = torch.from_numpy(_features(3, 12)[..., :64]).double()
    p = refmodels.to_tensors(tree, refmodels.REFERENCE, CPU)
    ref = refgranite._attention(x, p, refmodels.REFERENCE)
    got = att.double()(x).detach()
    assert _rel(got, ref) < 1e-12
    # causal: a later frame changes no earlier output
    x2 = x.clone()
    x2[:, -1] += 1.0
    assert torch.equal(att(x2)[:, :-1], got[:, :-1])


def test_fresh_mixers_draw_mamba2s_initialisation():
    m = _model()
    mixers = [mod for mod in m.module.modules()
              if isinstance(mod, A.Mamba2Mixer)]
    assert len(mixers) == 3
    for mixer in mixers:
        a = torch.exp(mixer.A_log)
        assert a.min() >= 1 and a.max() <= 16
        dt = torch.nn.functional.softplus(mixer.dt_bias)
        assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1 * (1 + 1e-5)
        assert torch.equal(mixer.D, torch.ones_like(mixer.D))
    again = _model()
    assert torch.equal(again.module.state_dict()["backbone.blocks.0.mixer"
                                                 ".A_log"],
                       mixers[0].A_log)


def test_spans_and_counters_of_the_scan_and_the_attention_core():
    m = _model(_variables())
    x = _features(2, 24)
    before = dict(tracing.counters)
    with tracing.recording():
        m(x)
        snap = tracing.snapshot()
    scans = snap.named("nww.ssm.scan")
    assert len(scans) == 3 and len(snap.named("nww.attention.core")) == 1
    assert scans[0].attrs == {"batch": 2, "length": 24, "heads": 8,
                              "head_dim": 16, "state": 16, "groups": 1,
                              "chunk": 8}
    assert tracing.counters["ssm.scans"] == before["ssm.scans"] + 3
    assert tracing.counters["ssm.frames"] == before["ssm.frames"] + 3 * 48
    m(x)
    assert tracing.counters["ssm.scans"] == before["ssm.scans"] + 6


def test_onnx_export_refuses_the_family_and_writes_nothing(tmp_path):
    from nanowakeword_tpu_torch.export.onnx_export import export_onnx
    path = tmp_path / "g.onnx"
    with pytest.raises(ValueError, match="granite_hybrid"):
        export_onnx(_model(), str(path))
    assert not path.exists()


def test_build_rejects_a_stack_longer_than_its_pattern_and_odd_widths():
    with pytest.raises(ValueError, match="n_blocks"):
        Model(config=dict(TINY), model_name="g", input_shape=(24, 96),
              model_type="granite_hybrid", n_blocks=5, device="cpu")
    with pytest.raises(ValueError, match="expand"):
        Model(config=dict(TINY, granite_mamba_expand=3), model_name="g",
              input_shape=(24, 96), model_type="granite_hybrid",
              n_blocks=4, device="cpu")


def test_msgpack_streams_arrays_without_copying_the_payload(tmp_path):
    """msgpack_dump writes the same bytes as msgpack_serialize, each array
    from its own memory; msgpack_load reads each array into memory of its
    own (writable, aligned), bfloat16 leaves and scalars included."""
    rng = np.random.default_rng(0)
    bits = np.arange(12, dtype=np.uint16).reshape(3, 4) << 7
    tree = {"a": rng.normal(size=(300, 70)).astype(np.float32),
            "b": {"c": np.arange(5, dtype=np.int8), "s": np.float32(2.5),
                  "bf": flax_msgpack.Bfloat16Bits(bits)},
            "t": rng.normal(size=(2, 3)).astype(np.float32).T,
            "n": [1, "x", 2.0, None]}
    buf = io.BytesIO()
    flax_msgpack.msgpack_dump(tree, buf)
    assert buf.getvalue() == flax_msgpack.msgpack_serialize(tree)
    path = tmp_path / "t.msgpack"
    path.write_bytes(buf.getvalue())
    back = flax_msgpack.read_msgpack_file(str(path))
    assert np.array_equal(back["a"], tree["a"])
    assert back["a"].flags.writeable and back["a"].flags.aligned
    assert np.array_equal(back["t"], tree["t"])
    assert back["b"]["c"].dtype == np.int8
    assert back["b"]["s"] == np.float32(2.5)
    assert np.array_equal(back["b"]["bf"],
                          (bits.astype(np.uint32) << 16).view(np.float32))
    assert back["n"] == [1, "x", 2.0, None]
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.msgpack_restore(buf.getvalue()[:-3])
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.msgpack_restore(buf.getvalue() + b"\x00")
