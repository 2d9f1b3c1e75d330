"""Environment investigator: report the port's runtime stack and devices.

The port of `tools/investigate.py`: prints the Python, torch and CUDA
versions, the packages the port may use, whether triton imports and nvcc
is found, each card's name and power limit (`nvidia-smi`), and whether the
port's CUDA kernels and its native runtime build. Useful in a bug report
or when checking a new training host.

Usage: python -m nanowakeword_tpu_torch.tools.investigate
"""

import argparse
import importlib
import os
import platform
import shutil
import subprocess
import sys


def _version(name: str) -> str:
    try:
        return getattr(importlib.import_module(name), "__version__", "?")
    except ImportError:
        return "MISSING"


def _cards() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip() or "none"
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    import torch

    from nanowakeword_tpu_torch.ops import _build

    print(f"python    {sys.version.split()[0]}  ({platform.platform()})")
    print(f"cpus      {os.cpu_count()}")
    print(f"torch     {torch.__version__}  (CUDA {torch.version.cuda})")
    for mod in ("triton", "numpy", "scipy", "yaml", "websockets"):
        print(f"{mod:<9} {_version(mod)}")
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    print(f"nvcc      {nvcc if os.path.exists(nvcc) else 'MISSING'}")
    print(f"cuda      available={torch.cuda.is_available()} "
          f"count={torch.cuda.device_count()}")
    for i in range(torch.cuda.device_count()):
        print(f"card {i}    {torch.cuda.get_device_name(i)}")
    print(f"nvidia-smi {_cards()}")
    for name in ("mel_frontend", "mix_gain", "nww_runtime"):
        try:
            print(f"build     {name}: "
                  f"{os.path.basename(str(_build.build(name)))}")
        except RuntimeError as e:
            print(f"build     {name}: FAILED ({str(e).splitlines()[0]})")
    try:
        import psutil
        print(f"ram       {psutil.virtual_memory().total / 2**30:.1f} GiB")
    except ImportError:
        pass


if __name__ == "__main__":
    main()
