// Fused hop-DFT log-mel frontend for Hopper (sm_90a).
//
// Replaces the TPU kernel nanowakeword_tpu/ops/mel_pallas.py
// (mel_frontend_pallas, kernel body _make_kernel). It computes what that
// kernel computes, with the numerics of nanowakeword_tpu_torch/ops/mel.py in
// bf16 mode:
//
//   S(r)  = bf16(row r of 160 samples) . B0           (cos and sin)
//   X[t]  = S[t-2] + ph1 * S[t-1] + ph2 * S[t]          (complex; rows before
//           the clip are the stream's zero left context, rows past n are the
//           right pad)
//   Xw    = 0.5 X(f) - 0.25 (X(f-1) + X(f+1)),  X(-1) = conj X(1), and the top
//           bin's +1 tap repeats the top bin (its filterbank weight is zero)
//   mel   = bf16(|Xw|^2) . filterbank
//   out   = log10(max(mel, 0) + 1e-8) + 2               (f32, or rounded to bf16)
//
// Numerics. The power is rounded to bf16, and a last-bit difference in the
// power can flip that rounding and move an output by up to 3.4e-3. So this
// kernel reproduces the plain version's power bit for bit: the two dot
// products sum in double (exact for int16-scale PCM: every product of two
// bf16 values is exact, and the sum needs at most 37 significant bits) and
// round once to float, as the plain version does; the elementwise steps use
// __fmul_rn/__fadd_rn/__fsub_rn, which the compiler never contracts into an
// FMA, in the plain version's order. Only log10f may differ from PyTorch's
// log10, by an ulp or two. The bases and the filterbank arrive as float
// arrays that hold bf16 values (the wrapper passes the plain version's
// constants).
//
// Design: one block per (clip, tile of FT frames), one thread per bin. The
// block copies its FT + 2 hop rows (a 2-row halo) into shared memory,
// rounded to bf16 and widened to double; each thread accumulates its bin's
// S_re and S_im for every row in registers, reading two samples at a time as
// a broadcast and the bases through the read-only cache. The phase combine
// runs in registers, the Hann taps read the neighbouring bins through shared
// memory, and the filterbank product gives each warp whole frames with one
// mel per lane, so the stores of a frame are one coalesced line.
//
// What bounds it on an H100 SXM (80 GB, 3.35 TB/s; 67 TFLOP/s f32 and
// 34 TFLOP/s f64 on the CUDA cores). At [4096, 16000] int16 the kernel reads
// 131 MB and writes 52 MB of f32: about 55 us at full bandwidth. It does
// about 37 GFLOP (33.5 GFLOP of hop DFT plus 3.4 GFLOP of filterbank): at
// least 0.55 ms in f32 on the CUDA cores, and 1.1 ms in the f64 this kernel
// uses. So it is compute-bound, 10-20x above the memory floor. The later
// lever is the tensor cores: the hop DFT is a [rows, 160] x [160, 256] bf16
// product, which mma or wgmma with f32 accumulation computes at 989 TFLOP/s;
// keeping the power bit-exact then needs the same order-independence, for
// example by splitting the sums so that f32 accumulation is exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HOP = 160;         // samples per hop row
constexpr int NB = 128;          // computed bins = threads per block
constexpr int NM = 32;           // mel bins
constexpr int FT = 16;           // frames per block
constexpr int ROWS = FT + 2;     // hop rows per block (2-row halo)

__device__ __forceinline__ float to_float(int16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(NB)
mel_frontend_kernel(const TIn* __restrict__ x, TOut* __restrict__ out,
                    const float* __restrict__ b0c, const float* __restrict__ b0s,
                    const float* __restrict__ phase, const float* __restrict__ fb,
                    long long n, int n_frames, int tiles) {
  __shared__ __align__(16) double xs[ROWS * HOP];
  __shared__ float fre[FT][NB];
  __shared__ float fim[FT][NB];
  __shared__ float pw[FT][NB];

  const int f = threadIdx.x;
  const long long clip = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * FT;
  const TIn* xc = x + clip * n;

  // rows t0-2 .. t0+FT-1 are the samples [HOP*(t0-2), HOP*(t0+FT))
  const long long s0 = static_cast<long long>(HOP) * (t0 - 2);
  for (int i = f; i < ROWS * HOP; i += NB) {
    const long long s = s0 + i;
    const float v = (s >= 0 && s < n) ? to_float(xc[s]) : 0.f;
    xs[i] = static_cast<double>(round_bf16(v));
  }
  __syncthreads();

  // hop DFT: S(r, f) for the block's rows, summed in double
  double are[ROWS], aim[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    are[r] = 0.0;
    aim[r] = 0.0;
  }
  for (int tau = 0; tau < HOP; tau += 2) {
    const double cos0 = __ldg(b0c + tau * NB + f), cos1 = __ldg(b0c + (tau + 1) * NB + f);
    const double sin0 = __ldg(b0s + tau * NB + f), sin1 = __ldg(b0s + (tau + 1) * NB + f);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const double2 v = *reinterpret_cast<const double2*>(&xs[r * HOP + tau]);
      are[r] = fma(v.x, cos0, are[r]);
      aim[r] = fma(v.x, sin0, aim[r]);
      are[r] = fma(v.y, cos1, are[r]);
      aim[r] = fma(v.y, sin1, aim[r]);
    }
  }
  float sre[ROWS], sim[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    sre[r] = __double2float_rn(are[r]);
    sim[r] = __double2float_rn(aim[r]);
  }

  // frame i (local) reads rows i, i+1, i+2: S[t-2] + ph1 S[t-1] + ph2 S[t],
  // as ops/mel.py: re = (re + pr*s_re) - pi*s_im; im = (im + pr*s_im) + pi*s_re
  const float p1r = phase[0 * NB + f], p1i = phase[1 * NB + f];
  const float p2r = phase[2 * NB + f], p2i = phase[3 * NB + f];
#pragma unroll
  for (int i = 0; i < FT; ++i) {
    float re = sre[i], im = sim[i];
    re = __fsub_rn(__fadd_rn(re, __fmul_rn(p1r, sre[i + 1])), __fmul_rn(p1i, sim[i + 1]));
    im = __fadd_rn(__fadd_rn(im, __fmul_rn(p1r, sim[i + 1])), __fmul_rn(p1i, sre[i + 1]));
    re = __fsub_rn(__fadd_rn(re, __fmul_rn(p2r, sre[i + 2])), __fmul_rn(p2i, sim[i + 2]));
    im = __fadd_rn(__fadd_rn(im, __fmul_rn(p2r, sim[i + 2])), __fmul_rn(p2i, sre[i + 2]));
    fre[i][f] = re;
    fim[i][f] = im;
  }
  __syncthreads();

  // Hann taps and power: w = 0.5*X(f) - 0.25*(X(f-1) + X(f+1)); |w|^2
  const int fm = (f == 0) ? 1 : f - 1;
  const float sm = (f == 0) ? -1.f : 1.f;   // X(-1) = conj X(1)
  const int fp = (f == NB - 1) ? f : f + 1;
  for (int i = 0; i < FT; ++i) {
    const float m_re = fre[i][fm], m_im = sm * fim[i][fm];
    const float w_re = __fsub_rn(__fmul_rn(0.5f, fre[i][f]),
                                 __fmul_rn(0.25f, __fadd_rn(m_re, fre[i][fp])));
    const float w_im = __fsub_rn(__fmul_rn(0.5f, fim[i][f]),
                                 __fmul_rn(0.25f, __fadd_rn(m_im, fim[i][fp])));
    pw[i][f] = round_bf16(__fadd_rn(__fmul_rn(w_re, w_re), __fmul_rn(w_im, w_im)));
  }
  __syncthreads();

  // filterbank, summed in double: warp w takes frames w, w+4, ...; lane = mel
  const int m = f % NM;
  for (int i = f / NM; i < FT; i += NB / NM) {
    const int t = t0 + i;
    if (t >= n_frames) break;
    double acc = 0.0;
#pragma unroll 8
    for (int k = 0; k < NB; ++k) {
      acc = fma(static_cast<double>(pw[i][k]), static_cast<double>(__ldg(fb + k * NM + m)), acc);
    }
    const float mel = fmaxf(__double2float_rn(acc), 0.f);
    store(out + (clip * n_frames + t) * NM + m, __fadd_rn(log10f(__fadd_rn(mel, 1e-8f)), 2.f));
  }
}

template <typename TIn, typename TOut>
void launch(const void* x, void* out, const float* b0c, const float* b0s,
            const float* phase, const float* fb, long long batch, long long n,
            int n_frames, cudaStream_t stream) {
  const int tiles = (n_frames + FT - 1) / FT;
  mel_frontend_kernel<TIn, TOut><<<static_cast<unsigned>(batch * tiles), NB, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<TOut*>(out), b0c, b0s, phase, fb, n,
      n_frames, tiles);
}

template <typename TIn>
int launch_out(const void* x, void* out, int out_dtype, const float* b0c,
               const float* b0s, const float* phase, const float* fb,
               long long batch, long long n, int n_frames, cudaStream_t stream) {
  if (out_dtype == 0) {
    launch<TIn, float>(x, out, b0c, b0s, phase, fb, batch, n, n_frames, stream);
  } else if (out_dtype == 1) {
    launch<TIn, __nv_bfloat16>(x, out, b0c, b0s, phase, fb, batch, n, n_frames, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [batch, n] contiguous samples; in_dtype 0 = int16, 1 = float32,
// 2 = bfloat16. out: [batch, n_frames, 32] contiguous; out_dtype 0 = float32,
// 1 = bfloat16. n_frames = ceil(n / 160). b0c, b0s: [160, 128], phase:
// [4, 128] as (ph1_re, ph1_im, ph2_re, ph2_im), fb: [128, 32], all float32.
// Launches on `stream` and returns the CUDA error code of the launch.
extern "C" int nww_mel_frontend(const void* x, int in_dtype, void* out, int out_dtype,
                                const void* b0c, const void* b0s, const void* phase,
                                const void* fb, long long batch, long long n,
                                long long n_frames, void* stream) {
  const long long tiles = (n_frames + FT - 1) / FT;
  if (n_frames != (n + HOP - 1) / HOP || batch < 0 || batch * tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || n_frames == 0) return 0;
  const auto* c = static_cast<const float*>(b0c);
  const auto* s = static_cast<const float*>(b0s);
  const auto* p = static_cast<const float*>(phase);
  const auto* w = static_cast<const float*>(fb);
  const auto st = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(n_frames);
  switch (in_dtype) {
    case 0: return launch_out<int16_t>(x, out, out_dtype, c, s, p, w, batch, n, t, st);
    case 1: return launch_out<float>(x, out, out_dtype, c, s, p, w, batch, n, t, st);
    case 2: return launch_out<__nv_bfloat16>(x, out, out_dtype, c, s, p, w, batch, n, t, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
