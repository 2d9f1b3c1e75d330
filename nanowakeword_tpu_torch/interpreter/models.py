"""Frontend model-asset registry.

The counterpart of `nanowakeword_tpu/interpreter/models.py`: named frontend
assets resolved to local paths, with lazy `<name>_path` attributes. The
speech encoder resolves, in order, to a download from the URL in the
environment variable `NWW_TPU_SPEECH_ENCODER_URL` (only when it is set), the
bundled pretrained asset, or a file already in the cache. The JAX package
materialises its seed-10 random encoder as a last resort; torch cannot
reproduce that draw, so here the last resort raises FileNotFoundError.
Encoder files are flax msgpack, read with utils/flax_msgpack.py.
"""

from __future__ import annotations

import os
from typing import Optional

from nanowakeword_tpu_torch.utils.logger import print_info

DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                             "nanowakeword_tpu", "models")

# name -> optional remote URL override via env NWW_TPU_<NAME>_URL
_ASSETS = ("speech_encoder", "vad")


class ModelRegistry:
    """Resolves named frontend assets to local paths."""

    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir or os.environ.get("NWW_TPU_CACHE",
                                                     DEFAULT_CACHE)

    def _ensure_dir(self, name: str) -> str:
        d = os.path.join(self.cache_dir, name)
        os.makedirs(d, exist_ok=True)
        return d

    def _maybe_download(self, name: str) -> Optional[str]:
        url = os.environ.get(f"NWW_TPU_{name.upper()}_URL")
        if not url:
            return None
        import urllib.parse
        import urllib.request
        filename = os.path.basename(urllib.parse.urlparse(url).path)
        path = os.path.join(self._ensure_dir(name), filename or name)
        if not os.path.exists(path):
            print_info(f"Downloading {url} -> {path}")
            urllib.request.urlretrieve(url, path)
        return path

    @property
    def speech_encoder(self) -> str:
        """Path to the speech-embedding encoder variables (.msgpack)."""
        remote = self._maybe_download("speech_encoder")
        if remote:
            return remote
        from nanowakeword_tpu_torch.assets import speech_encoder_asset_path
        try:
            return speech_encoder_asset_path()
        except FileNotFoundError:
            cached = os.path.join(self.cache_dir, "speech_encoder",
                                  "speech_encoder.msgpack")
            if os.path.exists(cached):
                return cached
            raise

    def load_speech_encoder_variables(self):
        """The registry's encoder variables, as nested dicts of numpy
        arrays."""
        from nanowakeword_tpu_torch.utils.flax_msgpack import \
            read_msgpack_file
        return read_msgpack_file(self.speech_encoder)

    def __getattr__(self, name: str):
        if name.endswith("_path") and name[:-5] in _ASSETS:
            return getattr(self, name[:-5])
        raise AttributeError(name)


models = ModelRegistry()
