"""The port's ConfigGenerator against the JAX package's, on the CPU.

For the same dataset statistics, both packages generate the same config
key by key, and `save_config` writes the same YAML, on three machines
(each package's `_device_info` patched in turn): no card, one 16 GiB card,
and one 80 GiB card, which stands for the JAX package's TPU branch. Without
a card the port counts its CPU as one device, as `jax.devices()` does.
"""

import pytest
import torch
import yaml

from nanowakeword_tpu.config import generator as jax_generator
from nanowakeword_tpu_torch.config import generator

# (the port's _device_info, the JAX package's) for each machine
MACHINES = {
    "no card": ((1, 0.0), (1, False)),
    "16 GiB card": ((1, 16.0), (1, False)),
    "80 GiB card": ((1, 80.0), (1, True)),
}
STATS = [
    {},
    {"H_pos": 0.1, "H_neg": 0.2},
    {"H_pos": 5.0, "H_neg": 15.0, "A_noise": 0.3, "N_rir": 120,
     "H_noise_paths": {"a": 2.0, "b": 0.5, "c": 0.0001}},
]


def _generate(monkeypatch, machine, stats):
    ours, ref = MACHINES[machine]
    monkeypatch.setattr(generator, "_device_info", lambda: ours)
    monkeypatch.setattr(jax_generator, "_device_info", lambda: ref)
    return (generator.ConfigGenerator(dict(stats)),
            jax_generator.ConfigGenerator(dict(stats)))


@pytest.mark.parametrize("stats", range(len(STATS)))
@pytest.mark.parametrize("machine", sorted(MACHINES))
def test_generate_equals_the_jax_packages(monkeypatch, machine, stats):
    port, jax = _generate(monkeypatch, machine, STATS[stats])
    ours, ref = port.generate(), jax.generate()
    assert list(ours) == list(ref)
    for key, value in ref.items():
        assert ours[key] == value, key


@pytest.mark.parametrize("machine", sorted(MACHINES))
def test_save_config_writes_the_same_yaml(monkeypatch, tmp_path, machine):
    base = tmp_path / "base.yaml"
    base.write_text(yaml.safe_dump({"model_name": "m", "steps": 5,
                                    "feature_batch_size": 1}))
    texts = []
    for gen, name in zip(_generate(monkeypatch, machine, STATS[2]),
                         ("port", "jax")):
        gen.generate()
        gen.save_config(str(tmp_path / f"{name}.yaml"), str(base))
        texts.append((tmp_path / f"{name}.yaml").read_text())
    assert texts[0] == texts[1]


def test_no_card_is_one_small_device(monkeypatch):
    """Unpatched: a process that sees no CUDA device counts its CPU as
    one device of unknown memory, and writes the JAX package's 256 / 64."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert generator._device_info() == (1, 0.0)
    monkeypatch.setattr(jax_generator, "_device_info", lambda: (1, False))
    ours = generator.ConfigGenerator().generate()
    assert (ours["feature_batch_size"], ours["tts_batch_size"]) == (256, 64)
    assert ours == jax_generator.ConfigGenerator().generate()


@pytest.mark.parametrize("n_cards", [2, 4])
@pytest.mark.parametrize("gib", [16.0, 80.0])
def test_batch_sizes_scale_with_the_cards(monkeypatch, n_cards, gib):
    monkeypatch.setattr(generator, "_device_info", lambda: (n_cards, gib))
    cfg = generator.ConfigGenerator().generate()
    large = gib >= generator.LARGE_DEVICE_GIB
    assert cfg["feature_batch_size"] == (1024 if large else 256) * n_cards
    assert cfg["tts_batch_size"] == (256 if large else 64)
