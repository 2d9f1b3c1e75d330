"""Build and load the package's native libraries.

Each CUDA kernel is one `csrc/<name>.cu` file with a plain C entry point,
compiled with `nvcc` for Hopper (`sm_90a`). The host runtime is
`csrc/nww_runtime.cc`, compiled with `g++`. At first use a library is built
into `build/nww_torch_kernels/<name>-<hash of the source and flags>.so`
beside the package and loaded with `ctypes`. Nothing is compiled when a
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from nanowakeword_tpu_torch.utils.tracing import counters

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "nww_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
HOST_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under CUDA_HOME)")


def _source(name: str) -> Path:
    """csrc/<name>.cu (a CUDA kernel) or csrc/<name>.cc (host code)."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cc"


def _flags(src: Path) -> list:
    return NVCC_FLAGS if src.suffix == ".cu" else HOST_FLAGS


def library_path(name: str) -> Path:
    """Where the built library of csrc/<name> lives (keyed by the source
    and the flags)."""
    src = _source(name)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(_flags(src)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu with nvcc, or csrc/<name>.cc with g++, unless
    its library already exists. Raises with the compiler's stderr."""
    out = library_path(name)
    if out.exists():
        return out
    src = _source(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        compiler = _nvcc() if src.suffix == ".cu" else "g++"
        cmd = [compiler, *_flags(src), "-o", tmp, str(src)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run {compiler} for {src.name}: "
                               f"{e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed for "
                               f"{src.name} (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)   # atomic: concurrent builds agree
        counters["kernels.built"] += 1
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
