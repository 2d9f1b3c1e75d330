#!/usr/bin/env python3
"""Which summation of the hop DFT reproduces the plain version's float32 S?

    python3 nanowakeword_tpu_torch/tools/probe_hopdft_order.py   # needs a GPU

The plain log-mel (ops/mel.py) computes the hop DFT S = rows @ basis as a
float64 matrix product rounded once to float32, and rounds the power to bf16
after it, so a last-bit change in S can move a log-mel value by ~1e-3. This
probe holds four ways of summing S against a float64 fused multiply-add
chain in ascending tap order (the order of the CPU product), on bf16-rounded
int16 rows and the bf16 cos|sin basis [160, 256]:

- `m8n8k4`, `m16n8k4`, `m16n8k8`, `m16n8k16`: the FP64 tensor cores,
  `mma.sync` of that shape chained over the taps in ascending order;
- `cublas`: `torch.matmul` in float64 on the card;
- `limbs`: the exact integer sum with the basis in 2^-29 units (the int8
  limb design), entries below 2^-22 set to 0, converted to float64;
- `limbs+residues`: the same plus the residue entries' products summed
  separately in float64.

It prints, for each input, the count of exact sums that sit on a float32
rounding midpoint, the count of float64 and of float32 elements that differ
from the chain; then the rate of each float64 mma shape on register
operands with 8, 16 and 32 warps per SM, of m16n8k8 with distinct operands
per product, and of the mel kernel's product loop alone. It builds its CUDA
source with nvcc into build/probe_hopdft_order/.
"""

from __future__ import annotations

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

from nanowakeword_tpu_torch.ops import _build  # noqa: E402
from nanowakeword_tpu_torch.ops import mel as melops  # noqa: E402

SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
// D[M, N] = A[M, K] B[K, N], row-major float64.
__global__ void seq(const double* a, const double* b, double* d, int m, int k, int n) {
  const int i = blockIdx.x, j = threadIdx.x;
  double acc = 0.0;
  for (int t = 0; t < k; ++t) acc = fma(a[i * k + t], b[t * n + j], acc);
  d[i * n + j] = acc;
}
// one warp per 8x8 block of D; M % 8 == 0, N % 8 == 0, K % 4 == 0
__global__ void dmma(const double* a, const double* b, double* d, int m, int k, int n) {
  const int lane = threadIdx.x, g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.x * 8, n0 = blockIdx.y * 8;
  double c0 = 0.0, c1 = 0.0;
  for (int k0 = 0; k0 < k; k0 += 4) {
    const double av = a[(m0 + g) * k + k0 + q];
    const double bv = b[(k0 + q) * n + n0 + g];
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
                 : "+d"(c0), "+d"(c1) : "d"(av), "d"(bv));
  }
  d[(m0 + g) * n + n0 + 2 * q] = c0;
  d[(m0 + g) * n + n0 + 2 * q + 1] = c1;
}
// one warp per 16x8 block of D with mma.m16n8k{4,8,16}.f64; M % 16 == 0
template <int K>
__device__ __forceinline__ void mma16(double (&c)[4], const double* a, const double* b);
template <>
__device__ __forceinline__ void mma16<4>(double (&c)[4], const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
template <>
__device__ __forceinline__ void mma16<8>(double (&c)[4], const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
template <>
__device__ __forceinline__ void mma16<16>(double (&c)[4], const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
                 "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
template <int K>
__global__ void dmma16(const double* a, const double* b, double* d, int m, int k, int n) {
  const int lane = threadIdx.x, g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.x * 16, n0 = blockIdx.y * 8;
  double c[4] = {0.0, 0.0, 0.0, 0.0};
  for (int k0 = 0; k0 < k; k0 += K) {
    double av[K / 2], bv[K / 4];
    for (int i = 0; i < K / 2; ++i) av[i] = a[(m0 + g + 8 * (i % 2)) * k + k0 + q + 4 * (i / 2)];
    for (int i = 0; i < K / 4; ++i) bv[i] = b[(k0 + q + 4 * i) * n + n0 + g];
    mma16<K>(c, av, bv);
  }
  for (int i = 0; i < 4; ++i) d[(m0 + g + 8 * (i / 2)) * n + n0 + 2 * q + (i % 2)] = c[i];
}
// tensor-core rate: each warp runs `iters` rounds of 8 independent products
template <int K>
__global__ void rate16(double* sink, int iters) {
  double c[8][4] = {};
  double av[K / 2], bv[K / 4];
  for (int i = 0; i < K / 2; ++i) av[i] = 1.0 + threadIdx.x * 1e-3 + i;
  for (int i = 0; i < K / 4; ++i) bv[i] = 1e-9 * (i + 1);
  for (int it = 0; it < iters; ++it)
    for (int j = 0; j < 8; ++j) mma16<K>(c[j], av, bv);
  double s = 0.0;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 12345.0) sink[0] = s;
}
__global__ void rate8(double* sink, int iters) {
  double c[8][2] = {};
  const double av = 1.0 + threadIdx.x * 1e-3, bv = 1e-9;
  for (int it = 0; it < iters; ++it)
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
                   : "+d"(c[j][0]), "+d"(c[j][1]) : "d"(av), "d"(bv));
  double s = 0.0;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1];
  if (s == 12345.0) sink[0] = s;
}
// which: 0 chain, 1 m8n8k4, 2/3/4 m16n8k4/k8/k16
extern "C" int run(int which, const void* a, const void* b, void* d, int m, int k, int n) {
  const double* A = static_cast<const double*>(a);
  const double* B = static_cast<const double*>(b);
  double* D = static_cast<double*>(d);
  if (which == 0) seq<<<m, n>>>(A, B, D, m, k, n);
  else if (which == 1) dmma<<<dim3(m / 8, n / 8), 32>>>(A, B, D, m, k, n);
  else if (which == 2) dmma16<4><<<dim3(m / 16, n / 8), 32>>>(A, B, D, m, k, n);
  else if (which == 3) dmma16<8><<<dim3(m / 16, n / 8), 32>>>(A, B, D, m, k, n);
  else dmma16<16><<<dim3(m / 16, n / 8), 32>>>(A, B, D, m, k, n);
  return static_cast<int>(cudaGetLastError());
}
// m16n8k8 with a different A and B for each of the 8 chains
__global__ void rate_distinct(double* sink, int iters) {
  double c[8][4] = {};
  double av[8][4], bv[8][2];
  for (int j = 0; j < 8; ++j) {
    for (int i = 0; i < 4; ++i) av[j][i] = 1.0 + threadIdx.x * 1e-3 + i + j;
    for (int i = 0; i < 2; ++i) bv[j][i] = 1e-9 * (i + j + 1);
  }
  for (int it = 0; it < iters; ++it)
    for (int j = 0; j < 8; ++j) mma16<8>(c[j], av[j], bv[j]);
  double s = 0.0;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 12345.0) sink[0] = s;
}
// the mel kernel's product loop alone: per warp a 32 x 32 block, A as float64
// and B as bf16 in shared memory (the kernel's strides and tap layout), 20
// steps of 8 taps per pass
constexpr int AST = 168, BST = 168;
constexpr size_t RATE_SMEM = sizeof(double) * 32 * AST + 2 * 256 * BST;
__global__ void rate_kernel_loop(double* sink, int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* xs = reinterpret_cast<double*>(smem);
  auto* bs = reinterpret_cast<__nv_bfloat16*>(smem + sizeof(double) * 32 * AST);
  for (int e = threadIdx.x; e < 32 * AST; e += blockDim.x) xs[e] = 1.0 + e % 7;
  for (int e = threadIdx.x; e < 256 * BST; e += blockDim.x) bs[e] = __float2bfloat16_rn(1e-3f * (e % 5));
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int cb = (threadIdx.x >> 5) % 8 * 32;
  double c[2][4][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll 2
    for (int k0 = 0; k0 < 160; k0 += 8) {
      double a[2][4];
      for (int mi = 0; mi < 2; ++mi) {
        const double2 lo = *reinterpret_cast<const double2*>(xs + (16 * mi + g) * AST + k0 + 2 * q);
        const double2 hi = *reinterpret_cast<const double2*>(xs + (16 * mi + g + 8) * AST + k0 + 2 * q);
        a[mi][0] = lo.x; a[mi][1] = hi.x; a[mi][2] = lo.y; a[mi][3] = hi.y;
      }
      for (int ni = 0; ni < 4; ++ni) {
        const float2 w = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bs + (cb + 8 * ni + g) * BST + k0 + 2 * q));
        const double b[2] = {w.x, w.y};
        mma16<8>(c[0][ni], a[0], b);
        mma16<8>(c[1][ni], a[1], b);
      }
    }
  }
  double s = 0.0;
  for (int mi = 0; mi < 2; ++mi)
    for (int ni = 0; ni < 4; ++ni) s += c[mi][ni][0] + c[mi][ni][3];
  if (s == 12345.0) sink[0] = s;
}
// which as above (1-4), 5 distinct operands, 6 the kernel's loop; blocks of
// 256 threads
extern "C" int rate(int which, void* sink, int blocks, int iters) {
  double* s = static_cast<double*>(sink);
  if (which == 5) {
    rate_distinct<<<blocks, 256>>>(s, iters);
    return static_cast<int>(cudaGetLastError());
  }
  if (which == 6) {
    cudaFuncSetAttribute(rate_kernel_loop, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(RATE_SMEM));
    rate_kernel_loop<<<blocks, 256, RATE_SMEM>>>(s, iters);
    return static_cast<int>(cudaGetLastError());
  }
  if (which == 1) rate8<<<blocks, 256>>>(s, iters);
  else if (which == 2) rate16<4><<<blocks, 256>>>(s, iters);
  else if (which == 3) rate16<8><<<blocks, 256>>>(s, iters);
  else rate16<16><<<blocks, 256>>>(s, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def _library() -> ctypes.CDLL:
    out = os.path.join(ROOT, "build", "probe_hopdft_order")
    os.makedirs(out, exist_ok=True)
    src, lib = os.path.join(out, "probe.cu"), os.path.join(out, "probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True)
    so = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    so.run.argtypes = [i, p, p, p, i, i, i]
    so.run.restype = i
    so.rate.argtypes = [i, p, i, i]
    so.rate.restype = i
    return so


SHAPES = {1: ("m8n8k4", 8, 8, 4), 2: ("m16n8k4", 16, 8, 4),
          3: ("m16n8k8", 16, 8, 8), 4: ("m16n8k16", 16, 8, 16)}


def tensor_core_rates(lib) -> dict:
    """TFLOP/s of each float64 mma shape on register operands, 8 independent
    chains per warp, blocks of 8 warps, with 8, 16 and 32 warps per SM, by
    CUDA events."""
    sink = torch.zeros(1, dtype=torch.float64, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, rates = 2000, {}
    for which, (name, m, n, k) in SHAPES.items():
        for per_sm in (1, 2, 4):
            blocks = per_sm * sms
            for _ in range(2):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                assert lib.rate(which, sink.data_ptr(), blocks, iters) == 0
                end.record()
                torch.cuda.synchronize()
            flop = blocks * 8 * iters * 8 * 2 * m * n * k
            rates[f"{name}, {8 * per_sm} warps/SM"] = (
                flop / (start.elapsed_time(end) * 1e-3) / 1e12)
    # m16n8k8 with distinct operands per chain, and the mel kernel's product
    # loop (20 steps x 8 products per pass) on operands in shared memory
    for which, name, steps in ((5, "m16n8k8 distinct operands", 1),
                               (6, "mel kernel product loop", 20)):
        for per_sm in (1, 2):
            blocks, n_iter = per_sm * sms, iters // steps
            for _ in range(2):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                assert lib.rate(which, sink.data_ptr(), blocks, n_iter) == 0
                end.record()
                torch.cuda.synchronize()
            flop = blocks * 8 * n_iter * steps * 8 * 2 * 16 * 8 * 8
            rates[f"{name}, {8 * per_sm} warps/SM"] = (
                flop / (start.elapsed_time(end) * 1e-3) / 1e12)
    return rates


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_hopdft_order: no CUDA device", file=sys.stderr)
        return 1
    cuda = torch.device("cuda")
    lib = _library()
    b0c, b0s, *_ = melops.hopdft_tensors(torch.bfloat16, "cpu")
    basis = torch.cat([b0c, b0s], dim=1).double()            # [160, 256]
    small = basis.abs() < 2.0 ** -22
    units = torch.where(small, 0.0, basis * 2.0 ** 29).long()
    residues = torch.where(small, basis, 0.0)
    basis_d, res_d = basis.to(cuda), residues.to(cuda)
    rng = np.random.default_rng(0)
    inputs = {
        "uniform +-20000": rng.integers(-20000, 20000, (8192, 160)),
        "normal 3000": np.clip(rng.normal(0, 3000, (8192, 160)), -32768,
                               32767),
        "uniform full scale": rng.integers(-32768, 32768, (8192, 160)),
    }
    for name, x in inputs.items():
        rows = torch.from_numpy(x.astype(np.int16)).float().to(
            torch.bfloat16).double().to(cuda)
        m, k = rows.shape
        n = basis.shape[1]

        def launch(which):
            d = torch.empty(m, n, dtype=torch.float64, device=cuda)
            err = lib.run(which, rows.data_ptr(), basis_d.data_ptr(),
                          d.data_ptr(), m, k, n)
            torch.cuda.synchronize()
            assert err == 0, err
            return d

        chain = launch(0)
        # int64 products run on the CPU only
        limbs = ((rows.long().cpu() @ units).double() * 2.0 ** -29).to(cuda)
        ways = {SHAPES[w][0]: launch(w) for w in SHAPES}
        ways.update({"cublas": rows @ basis_d, "limbs": limbs,
                     "limbs+residues": limbs + rows @ res_d})
        # S elements that are exact float64 integers in 2^-29 units sitting on
        # a float32 rounding midpoint: 24-bit significand + exactly one half
        mant, _ = torch.frexp(limbs)
        scaled = mant.abs() * 2.0 ** 24
        midpoint = int((scaled - scaled.floor() == 0.5).sum())
        print(json.dumps({"input": name, "elements": chain.numel(),
                          "limbs_at_f32_midpoint": midpoint, **{
            w: {"f64_differ": int((v != chain).sum()),
                "f32_differ": int((v.float() != chain.float()).sum())}
            for w, v in ways.items()}}), flush=True)
    print(json.dumps({"tflops_f64": tensor_core_rates(lib)}))
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
