#!/usr/bin/env python3
"""Where the mel kernel's time goes, phase by phase, on a GPU.

    python3 nanowakeword_tpu_torch/tools/profile_mel_phases.py [--n 16000]

It compiles instrumented copies of csrc/mel_frontend.cu into
build/profile_mel_phases/ and runs them on int16 [4096, n]:

- `clock64()` marks around each phase of a team's work item (tile load,
  wait for the tensor-core token, the products, the S tile store, the
  epilogue), summed over all items: cycles per item and phase;
- the kernel's time (CUDA events, mean of 20) as built, without the
  epilogue, and without the products: what each adds.

It prints one JSON object per line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from nanowakeword_tpu_torch.ops import _build, mel_cuda  # noqa: E402

OUT = os.path.join(ROOT, "build", "profile_mel_phases")
LOOP_END = "    team_sync(team);\n  }\n}"
PHASES = ["tile load", "token wait", "products", "S tile store",
          "epilogue"]


def _edit(src: str, anchor: str, text: str, after: bool = True) -> str:
    if src.count(anchor) != 1:
        raise RuntimeError(f"anchor not found once in the kernel: {anchor!r}")
    return src.replace(anchor, anchor + text if after else text + anchor)


def instrumented(src: str) -> str:
    marks = [("    const Item it = item_at(item, tiles, n_frames);\n", True),
             ("    // hop DFT on the FP64 tensor cores", False),
             ("    double acc[2][NI][4];\n", False),
             ("    if (team == 0 ? k < n_other : k + 1 < n_other) "
              "token_pass(team);\n", False),
             ("    // The rest runs per frame", False)]
    for i, (anchor, after) in enumerate(marks):
        src = _edit(src, anchor, f"    long long c{i} = clock64();\n", after)
    adds = " ".join(f"atomicAdd(&g_prof[{i}], c{i + 1} - c{i});"
                    for i in range(4))
    src = src.replace(LOOP_END, (
        "    team_sync(team);\n    long long c5 = clock64();\n"
        f"    if (tt == 0) {{ {adds} atomicAdd(&g_prof[4], c5 - c4); "
        "atomicAdd(&g_prof[5], 1ull); }\n  }\n}"))
    src = _edit(src, "namespace {\n",
                "__device__ unsigned long long g_prof[8];\n", after=False)
    return src + (
        '\nextern "C" int prof_read(void* dst) {\n'
        '  return (int)cudaMemcpyFromSymbol(dst, g_prof, 64);\n}\n'
        'extern "C" int prof_reset() {\n'
        '  unsigned long long z[8] = {0};\n'
        '  return (int)cudaMemcpyToSymbol(g_prof, z, 64);\n}\n')


def without_epilogue(src: str) -> str:
    a, b = src.index("    // The rest runs per frame"), src.index(LOOP_END)
    return src[:a] + src[b:]


def without_products(src: str) -> str:
    anchor = "    for (int k0 = 0; k0 < HOP; k0 += 8) {"
    if src.count(anchor) != 1:
        raise RuntimeError("the product loop was not found once")
    return src.replace(anchor, "    for (int k0 = 0; n < 0 && k0 < HOP; k0 += 8) {")


def build(name: str, src: str) -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nww_mel_frontend.argtypes = [p, i, p, i, p, p, p, p, ll, ll, ll, p]
    lib.nww_mel_frontend.restype = i
    if hasattr(lib, "prof_read"):
        lib.prof_read.argtypes = [p]
        lib.prof_read.restype = i
        lib.prof_reset.argtypes = []
        lib.prof_reset.restype = i
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=16000)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_mel_phases: no CUDA device", file=sys.stderr)
        return 1
    cuda = torch.device("cuda")
    batch, n = 4096, args.n
    frames = -(-n // 160)
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -20000, 20000, (batch, n)).astype(np.int16)).to(cuda)
    ref = mel_cuda.mel_frontend_plain(x)
    consts = [t.data_ptr() for t in mel_cuda._kernel_constants(str(cuda))]
    out = torch.empty_like(ref)
    src = (_build.CSRC / "mel_frontend.cu").read_text()

    def call(lib):
        err = lib.nww_mel_frontend(x.data_ptr(), 0, out.data_ptr(), 0,
                                   *consts, batch, n, frames,
                                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    lib = build("phases", instrumented(src))
    call(lib)
    torch.cuda.synchronize()
    if lib.prof_reset():
        raise RuntimeError("resetting the cycle counters failed")
    call(lib)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 8)()
    if lib.prof_read(ctypes.addressof(buf)):
        raise RuntimeError("reading the cycle counters failed")
    items = buf[5]
    print(json.dumps({"shape": [batch, n], "team_items": items,
                      "cycles_per_item": {
                          p: buf[i] / items for i, p in enumerate(PHASES)}}))

    times = {}
    for name, variant in (("kernel", src), ("no epilogue",
                                            without_epilogue(src)),
                          ("no products", without_products(src))):
        lib = build(name.replace(" ", "_"), variant)
        for _ in range(3):
            call(lib)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call(lib)
        end.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(end) / 20
        if name == "kernel" and not torch.equal(out, ref):
            raise RuntimeError("the kernel differs from its plain version")
    print(json.dumps({"ms": times}))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
