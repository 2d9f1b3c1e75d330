// The augmentation pre-stage's mix + gain in one pass over device memory.
//
// Replaces the TPU kernel nanowakeword_tpu/ops/mix_pallas.py::mix_gain_pallas.
// For clip b of a [B, n] batch:
//
//   out[b] = (has_bg[b] ? bg[b] + shift(fg_unit[b], 128 q[b]) * scale[b]
//                       : shift(fg_unit[b], 128 q[b])) * gain[b]
//
// fg is int16 PCM (scaled by 1/32768 here, which is exact) or unit-scale
// float32; shift moves the row right by q[b] blocks of 128 samples with zero
// fill. The RMS, SNR scale and gain are computed outside (ops/augment.py).
//
// What bounds it: memory. Each output sample reads 2 bytes of int16 fg (or
// 4 of f32), 4 of bg (only for clips with a background) and writes 4, with
// three floating-point operations: at [4096, 32000] int16 that is 1.3 GB,
// about 0.4 ms at the H100's 3.35 TB/s. The design keeps to that: one thread
// per 4 samples, 8- or 16-byte loads and 16-byte stores on neighbouring
// addresses; the shift is a multiple of 128 samples, so a thread's 4 source
// samples stay aligned and are either all inside the row or all in the zero
// fill; no bg read for a clip without background.
//
// Rounding: nvcc would contract bg + shifted * scale into one FMA. The
// non-contracted __fmul_rn / __fadd_rn round the product and the sum each
// once, as the plain PyTorch version (ops/mix.py) does, so the two agree bit
// for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 128;
constexpr int THREADS = 256;
constexpr int VEC = 4;
constexpr float INT16_SCALE = 1.0f / 32768.0f;

__device__ __forceinline__ float4 load4(const int16_t* p) {
  const short4 v = *reinterpret_cast<const short4*>(p);
  return make_float4(__fmul_rn(static_cast<float>(v.x), INT16_SCALE),
                     __fmul_rn(static_cast<float>(v.y), INT16_SCALE),
                     __fmul_rn(static_cast<float>(v.z), INT16_SCALE),
                     __fmul_rn(static_cast<float>(v.w), INT16_SCALE));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mix_gain_kernel(const T* __restrict__ fg, const float* __restrict__ bg,
                const int32_t* __restrict__ q, const float* __restrict__ scale,
                const int32_t* __restrict__ has_bg,
                const float* __restrict__ gain, float* __restrict__ out,
                long long n) {
  const long long clip = blockIdx.x;
  const long long s = (static_cast<long long>(blockIdx.y) * THREADS + threadIdx.x) * VEC;
  if (s >= n) return;
  const long long row = clip * n;
  const long long src = s - static_cast<long long>(q[clip]) * BLOCK;

  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (src >= 0 && src < n) x = load4(fg + row + src);
  if (has_bg[clip] != 0) {
    const float sc = scale[clip];
    const float4 b = load4(bg + row + s);
    x.x = __fadd_rn(b.x, __fmul_rn(x.x, sc));
    x.y = __fadd_rn(b.y, __fmul_rn(x.y, sc));
    x.z = __fadd_rn(b.z, __fmul_rn(x.z, sc));
    x.w = __fadd_rn(b.w, __fmul_rn(x.w, sc));
  }
  const float g = gain[clip];
  x.x = __fmul_rn(x.x, g);
  x.y = __fmul_rn(x.y, g);
  x.z = __fmul_rn(x.z, g);
  x.w = __fmul_rn(x.w, g);
  *reinterpret_cast<float4*>(out + row + s) = x;
}

}  // namespace

// fg: [batch, n] contiguous; fg_dtype 0 = int16, 1 = float32. bg, out:
// [batch, n] float32 contiguous. q, has_bg: [batch] int32; scale, gain:
// [batch] float32. n % 128 == 0. Launches on `stream` and returns the CUDA
// error code of the launch.
extern "C" int nww_mix_gain(const void* fg, int fg_dtype, const void* bg,
                            const void* q, const void* scale, const void* has_bg,
                            const void* gain, void* out, long long batch,
                            long long n, void* stream) {
  if (batch < 0 || n < 0 || n % BLOCK != 0 || batch > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || n == 0) return 0;
  const long long tiles = (n / VEC + THREADS - 1) / THREADS;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(batch), static_cast<unsigned>(tiles));
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const float*>(bg);
  const auto* qq = static_cast<const int32_t*>(q);
  const auto* sc = static_cast<const float*>(scale);
  const auto* hb = static_cast<const int32_t*>(has_bg);
  const auto* g = static_cast<const float*>(gain);
  auto* o = static_cast<float*>(out);
  if (fg_dtype == 0) {
    mix_gain_kernel<int16_t><<<grid, THREADS, 0, st>>>(
        static_cast<const int16_t*>(fg), b, qq, sc, hb, g, o, n);
  } else if (fg_dtype == 1) {
    mix_gain_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(fg), b, qq, sc, hb, g, o, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
