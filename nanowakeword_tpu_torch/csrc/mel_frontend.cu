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
// Numerics. The power is rounded to bf16, so a last-bit difference in S can
// flip that rounding and move an output by up to 3.4e-3. The plain version
// sums each S element in float64 and rounds once to float32. Every product
// of a bf16 sample and a bf16 basis entry is exact in float64, and so is
// every partial sum, except for the 1147 basis entries (540 cos, 607 sin)
// that are float residues of cos/sin at multiples of pi/2, with |b| between
// 1.9e-23 and 1.3e-18 (all others are multiples of 2^-29). Their products
// (at most ~4e-14 each) are kept or rounded away depending on the size of
// the partial sums they meet, so the float64 sum depends on the order of the
// taps. That reaches float32: 15-17% of S elements are integers in 2^-29
// units that sit exactly on a float32 rounding midpoint, where the residue
// part decides the rounding. So the kernel sums in the plain version's
// order, a float64 fused multiply-add chain over the taps in ascending
// order, which the CPU product and cuBLAS both follow. The elementwise steps
// use __fmul_rn/__fadd_rn/__fsub_rn (never contracted into an FMA) in the
// plain version's order. Only log10f may differ from PyTorch's log10, by an
// ulp or two.
//
// Why not int8 limbs. The samples are integers and the basis is an integer
// in 2^-29 units except for the residues, so S could be summed exactly as
// int8 limb products on the int8 tensor cores. But the exact sum is not the
// plain version's S: with the residues set to 0, 5.0-6.2% of float32 S
// elements differ from the chain on int16 audio, and adding the residues'
// products as a separate float64 sum still leaves 0.5%. The FP64 tensor
// cores do reproduce the chain: mma.sync .f64 of every shape (m8n8k4,
// m16n8k4, m16n8k8, m16n8k16) chained over ascending taps gave 0 differing
// float64 elements (nanowakeword_tpu_torch/tools/probe_hopdft_order.py, on an
// H100, for all of these numbers).
//
// Design. The hop DFT is a [rows, 160] x [160, 256] float64 product on the
// FP64 tensor cores, mma.sync.aligned.m16n8k8.row.col.f64 (the probe measured
// m8n8k4 at half the rate of the m16n8 shapes), chained over the 20 groups
// of 8 taps in ascending order. Its operands sit in shared memory: the
// samples rounded to bf16 and stored as float64, the basis as bf16 widened
// to float64 (exactly) as fragments are loaded, both with the taps permuted
// so that each fragment pair is one load. One persistent block of 512
// threads per SM keeps the [160, 256] cos|sin basis in shared memory for its
// lifetime. Its two teams of 8 warps each walk their own (clip, tile of 30
// frames) work items, a tile being 32 hop rows: the 30 frames' rows plus the
// 2-row halo. The teams take turns on the tensor cores (a token passed
// through named barriers), so one team's tile load and epilogue run while
// the other team multiplies; that also hides the load latency, so the
// samples are read with plain loads (clip rows are not 16-byte aligned for a
// general n). In a team each warp owns a 32 x 32 block of the 32 x 256 S tile
// (32 float64 accumulators per thread); the second 16-row slice is skipped
// when the tile's last frames do not need it. Every input dtype takes this
// path (the float64 design needs no fixed-point form of the samples), so
// int16 and float audio agree bit for bit. The epilogue rounds S to float32
// into shared memory; then each warp takes whole frames, lane l bins 4l ..
// 4l+3: phase combine, the Hann taps (neighbouring bins by warp shuffles),
// the power rounded to bf16, and the filterbank summed in float64 over its
// nonzero taps (at most 14 per mel, 216 in all) in ascending bin order,
// padded to 16 with zero weights: equal to the dense ascending sum, since
// adding an exact zero changes nothing. Lane l then stores mel l, so a frame
// is one coalesced 128-byte line.
//
// Shared memory per block: basis 256 x 168 bf16 (86,016 B; [column][tap],
// rows padded against bank conflicts), a 32 x 168 float64 sample tile per
// team (2 x 43,008 B; once the products are done it holds the team's
// 32 x 264 f32 S tile), a float64 power row per warp (16,384 B), phase
// factors and filterbank taps (8,192 B): 196,608 B of the 232,448 a block
// may use, set with cudaFuncSetAttribute.
//
// What bounds it on an H100 SXM (80 GB at 3.35 TB/s; 67 TFLOP/s float64 on
// the tensor cores). At [4096, 16000] int16 the kernel reads 131 MB and
// writes 52 MB of f32, 55 us at full bandwidth; the hop DFT is 34.2 GFLOP of
// float64 (102 rows x 160 x 256 x 2 per clip), 0.51 ms at the FP64 tensor
// peak. So the float64 order that exactness needs makes it compute-bound,
// ~9x above the memory floor; the filterbank (0.18 GFLOP over its nonzero
// taps) and the elementwise steps are small beside it. The tiles compute
// 112 rows per clip for the 102 needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HOP = 160;            // samples per hop row = taps
constexpr int NB = 128;             // computed bins
constexpr int NC = 2 * NB;          // S columns: cos bins, then sin bins
constexpr int NM = 32;              // mel bins
constexpr int ROWS = 32;            // hop rows per tile
constexpr int FT = ROWS - 2;        // frames per tile (2-row halo)
constexpr int TEAMS = 2;            // independent teams of warps per block
constexpr int TEAM_THREADS = 256;
constexpr int THREADS = TEAMS * TEAM_THREADS;
constexpr int TEAM_WARPS = TEAM_THREADS / 32;
constexpr int WN = NC / TEAM_WARPS;         // S columns per warp
constexpr int NI = WN / 8;                  // 8-column mma blocks per warp
constexpr int AST = HOP + 8;        // sample tile row stride (float64)
constexpr int BST = HOP + 8;        // basis row stride (bf16; the basis is stored [column][tap])
constexpr int SST = NC + 8;         // S tile row stride (f32)
constexpr int MAXTAP = 16;          // filterbank taps per mel (the wrapper checks)
constexpr int PER_THREAD = ROWS * HOP / TEAM_THREADS;   // samples each thread loads

constexpr size_t SMEM_BASIS = sizeof(__nv_bfloat16) * NC * BST;
constexpr size_t SMEM_X = sizeof(double) * ROWS * AST;   // per team; later its S tile
constexpr size_t SMEM_PW = sizeof(double) * (THREADS / 32) * NB;   // a power row per warp
constexpr size_t SMEM_CONST = sizeof(float) * 4 * NB       // phase factors
    + (sizeof(double) + sizeof(int)) * MAXTAP * NM;        // filterbank taps
constexpr size_t SMEM = SMEM_BASIS + TEAMS * SMEM_X + SMEM_PW + SMEM_CONST;
static_assert(sizeof(float) * ROWS * SST <= SMEM_X, "the S tile reuses the sample tile");
static_assert(SMEM <= 232448, "shared memory over the per-block limit");
static_assert(ROWS * HOP % TEAM_THREADS == 0, "tile load split");
static_assert(ROWS == 32, "a warp's block of the S tile is 32 rows");

__device__ __forceinline__ float to_float(int16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float at(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// D += A B for a 16x8 A fragment (row-major) and an 8x8 B fragment, float64.
// Thread (g, q) = (lane / 4, lane % 4) holds a[i] = A[g + 8 (i % 2)][q + 4 (i / 2)],
// b[i] = B[q + 4 i][g] and d[i] = D[g + 8 (i / 2)][2 q + i % 2].
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4], double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// Where tap t is stored in shared memory: within each group of 8 taps, t and
// t + 4 sit side by side, so a thread's two taps of a fragment are one
// 32-bit load. The products still run over the taps in ascending order.
__device__ __forceinline__ int tap_slot(int t) {
  return (t & ~7) + 2 * (t & 3) + ((t >> 2) & 1);
}

__device__ __forceinline__ double2 widen2(const __nv_bfloat16* p) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return make_double2(v.x, v.y);
}

// The A fragments of rows 0-15 and 16-31 and the warp's NI B fragments for
// the taps k0 .. k0+7 (see dmma and tap_slot).
__device__ __forceinline__ void load_fragments(double (&a)[2][4], double2 (&b)[NI],
                                               const double* xs, const __nv_bfloat16* bs,
                                               int k0, int cb, int g, int q) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const double2 lo = *reinterpret_cast<const double2*>(xs + (16 * mi + g) * AST + k0 + 2 * q);
    const double2 hi = *reinterpret_cast<const double2*>(xs + (16 * mi + g + 8) * AST + k0 + 2 * q);
    a[mi][0] = lo.x;
    a[mi][1] = hi.x;
    a[mi][2] = lo.y;
    a[mi][3] = hi.y;
  }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) b[ni] = widen2(bs + (cb + 8 * ni + g) * BST + k0 + 2 * q);
}

// a barrier for the TEAM_THREADS threads of one team (named barrier 1 + team)
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "n"(TEAM_THREADS) : "memory");
}

// The two teams take turns on the tensor cores: a team waits for the token
// (named barrier 3 + team) before its products and passes it to the other
// team (bar.arrive) after them, so one team's epilogue runs while the other
// team's products do.
__device__ __forceinline__ void token_wait(int team) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(3 + team), "n"(THREADS) : "memory");
}
__device__ __forceinline__ void token_pass(int team) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(4 - team), "n"(THREADS) : "memory");
}

struct Item {
  long long clip;
  int t0;        // first frame of the tile
  int rows;      // hop rows the tile's valid frames need (<= ROWS)
};

__device__ __forceinline__ Item item_at(int item, int tiles, int n_frames) {
  Item it;
  it.clip = item / tiles;
  it.t0 = (item % tiles) * FT;
  it.rows = min(FT, n_frames - it.t0) + 2;
  return it;
}

// The item's hop rows t0-2 .. t0+29, i.e. the samples [HOP*(t0-2), HOP*(t0+FT)),
// rounded to bf16 and stored as float64 at their tap slots; zeros outside the
// clip and past the rows the tile needs. Team thread tt loads samples
// tt + TEAM_THREADS*j, all loads in flight together.
template <typename TIn>
__device__ __forceinline__ void load_tile(double* xs, const TIn* __restrict__ x, long long n,
                                          const Item& it, int tt) {
  const TIn* xc = x + it.clip * n;
  const long long s0 = static_cast<long long>(HOP) * (it.t0 - 2);
  const int limit = it.rows * HOP;
  float v[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = tt + TEAM_THREADS * j;
    const long long s = s0 + i;
    v[j] = (i < limit && s >= 0 && s < n) ? to_float(xc[s]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = tt + TEAM_THREADS * j;
    xs[(i / HOP) * AST + tap_slot(i % HOP)] = round_bf16(v[j]);
  }
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS, 1)
mel_frontend_kernel(const TIn* __restrict__ x, TOut* __restrict__ out,
                    const float* __restrict__ b0c, const float* __restrict__ b0s,
                    const float* __restrict__ phase, const float* __restrict__ fb,
                    long long n, int n_frames, int tiles, int items) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* bs = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* pw = reinterpret_cast<double*>(smem + SMEM_BASIS + TEAMS * SMEM_X);
  auto* tap_w = reinterpret_cast<double*>(smem + SMEM_BASIS + TEAMS * SMEM_X + SMEM_PW);
  auto* ph = reinterpret_cast<float*>(tap_w + MAXTAP * NM);
  auto* tap_k = reinterpret_cast<int*>(ph + 4 * NB);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;           // mma fragment coordinates
  // Each team works through its own items with its own sample/S tile, so one
  // team's epilogue overlaps the other's tensor-core products.
  const int team = tid / TEAM_THREADS, tt = tid % TEAM_THREADS, tw = tt / 32;
  auto* xs = reinterpret_cast<double*>(smem + SMEM_BASIS + team * SMEM_X);
  auto* ss = reinterpret_cast<float*>(smem + SMEM_BASIS + team * SMEM_X);
  const int stride = TEAMS * gridDim.x;

  static_assert(TEAMS == 2, "the token passing is written for two teams");
  const int first_other = TEAMS * blockIdx.x + 1 - team;
  const int n_other = first_other < items ? (items - 1 - first_other) / stride + 1 : 0;

  int item = TEAMS * blockIdx.x + team;

  // the basis, once per block: values that are bf16 already, so exact
  for (int e = tid; e < HOP * NC; e += THREADS) {
    const int tau = e / NC, c = e % NC;
    const float v = c < NB ? b0c[tau * NB + c] : b0s[tau * NB + c - NB];
    bs[c * BST + tap_slot(tau)] = __float2bfloat16_rn(v);
  }
  for (int e = tid; e < 4 * NB; e += THREADS) ph[e] = phase[e];
  // the filterbank's nonzero taps, ascending within each mel (tap j of mel m
  // at j * NM + m), padded with (bin 0, weight 0): adding an exact zero to
  // the sum changes nothing, so every mel sums MAXTAP taps
  if (tid < NM) {
    int count = 0;
    for (int k = 0; k < NB; ++k) {
      const float w = fb[k * NM + tid];
      if (w != 0.f && count < MAXTAP) {
        tap_k[count * NM + tid] = k;
        tap_w[count * NM + tid] = w;
        ++count;
      }
    }
    for (; count < MAXTAP; ++count) {
      tap_k[count * NM + tid] = 0;
      tap_w[count * NM + tid] = 0.0;
    }
  }

  __syncthreads();

  // the warp's 32 x WN block of the S tile
  const int cb = tw * WN;

  for (int k = 0; item < items; item += stride, ++k) {
    const Item it = item_at(item, tiles, n_frames);
    load_tile(xs, x, n, it, tt);
    team_sync(team);

    // hop DFT on the FP64 tensor cores, taps in ascending order; team 0 goes
    // first, and each wait is matched by one pass of the other team
    if (team == 0 ? (k >= 1 && k <= n_other) : true) token_wait(team);
    double acc[2][NI][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.0;
#pragma unroll 2
    for (int k0 = 0; k0 < HOP; k0 += 8) {
      double a[2][4];
      double2 b[NI];
      load_fragments(a, b, xs, bs, k0, cb, g, q);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        dmma(acc[0][ni], a[0], b[ni].x, b[ni].y);
        if (16 < it.rows) dmma(acc[1][ni], a[1], b[ni].x, b[ni].y);
      }
    }
    if (team == 0 ? k < n_other : k + 1 < n_other) token_pass(team);
    team_sync(team);   // the S tile overwrites the samples
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = make_float2(__double2float_rn(acc[mi][ni][2 * h]),
                                       __double2float_rn(acc[mi][ni][2 * h + 1]));
          *reinterpret_cast<float2*>(
              &ss[(16 * mi + 8 * h + g) * SST + cb + 8 * ni + 2 * q]) = v;
        }
    team_sync(team);

    // The rest runs per frame inside one warp: the team's warp w takes
    // frames w, w+8, ...; lane l takes bins 4l .. 4l+3, then mel l.
    double* pwarp = pw + warp * NB;
    for (int i = tw; i < it.rows - 2; i += TEAM_WARPS) {
      // frame i reads rows i, i+1, i+2: S[t-2] + ph1 S[t-1] + ph2 S[t], as
      // ops/mel.py: re = (re + pr*s_re) - pi*s_im; im = (im + pr*s_im) + pi*s_re
      float xr[4], xi[4];
      {
        const float* s = ss + i * SST + 4 * lane;
        float4 sr[3], si[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          sr[r] = *reinterpret_cast<const float4*>(s + r * SST);
          si[r] = *reinterpret_cast<const float4*>(s + r * SST + NB);
        }
        const float4 q1r = *reinterpret_cast<const float4*>(ph + 0 * NB + 4 * lane);
        const float4 q1i = *reinterpret_cast<const float4*>(ph + 1 * NB + 4 * lane);
        const float4 q2r = *reinterpret_cast<const float4*>(ph + 2 * NB + 4 * lane);
        const float4 q2i = *reinterpret_cast<const float4*>(ph + 3 * NB + 4 * lane);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float r1 = at(sr[1], c), i1 = at(si[1], c), r2 = at(sr[2], c), i2 = at(si[2], c);
          const float p1r = at(q1r, c), p1i = at(q1i, c), p2r = at(q2r, c), p2i = at(q2i, c);
          float re = at(sr[0], c), im = at(si[0], c);
          re = __fsub_rn(__fadd_rn(re, __fmul_rn(p1r, r1)), __fmul_rn(p1i, i1));
          im = __fadd_rn(__fadd_rn(im, __fmul_rn(p1r, i1)), __fmul_rn(p1i, r1));
          re = __fsub_rn(__fadd_rn(re, __fmul_rn(p2r, r2)), __fmul_rn(p2i, i2));
          im = __fadd_rn(__fadd_rn(im, __fmul_rn(p2r, i2)), __fmul_rn(p2i, r2));
          xr[c] = re;
          xi[c] = im;
        }
      }
      // Hann taps and power: w = 0.5*X(f) - 0.25*(X(f-1) + X(f+1)), with
      // X(-1) = conj X(1) and the top bin repeating itself; bf16(|w|^2)
      float left_re = __shfl_up_sync(0xffffffffu, xr[3], 1);
      float left_im = __shfl_up_sync(0xffffffffu, xi[3], 1);
      float right_re = __shfl_down_sync(0xffffffffu, xr[0], 1);
      float right_im = __shfl_down_sync(0xffffffffu, xi[0], 1);
      if (lane == 0) {
        left_re = xr[1];
        left_im = -xi[1];
      }
      if (lane == 31) {
        right_re = xr[3];
        right_im = xi[3];
      }
      double power[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float m_re = c == 0 ? left_re : xr[c - 1], m_im = c == 0 ? left_im : xi[c - 1];
        const float p_re = c == 3 ? right_re : xr[c + 1], p_im = c == 3 ? right_im : xi[c + 1];
        const float w_re = __fsub_rn(__fmul_rn(0.5f, xr[c]), __fmul_rn(0.25f, __fadd_rn(m_re, p_re)));
        const float w_im = __fsub_rn(__fmul_rn(0.5f, xi[c]), __fmul_rn(0.25f, __fadd_rn(m_im, p_im)));
        power[c] = round_bf16(__fadd_rn(__fmul_rn(w_re, w_re), __fmul_rn(w_im, w_im)));
      }
      *reinterpret_cast<double2*>(pwarp + 4 * lane) = make_double2(power[0], power[1]);
      *reinterpret_cast<double2*>(pwarp + 4 * lane + 2) = make_double2(power[2], power[3]);
      __syncwarp();

      // filterbank in float64 over the nonzero taps; lane = mel
      double mel = 0.0;
#pragma unroll
      for (int j = 0; j < MAXTAP; ++j) mel = fma(pwarp[tap_k[j * NM + lane]], tap_w[j * NM + lane], mel);
      const float v = fmaxf(__double2float_rn(mel), 0.f);
      store(out + (it.clip * n_frames + it.t0 + i) * NM + lane,
            __fadd_rn(log10f(__fadd_rn(v, 1e-8f)), 2.f));
      __syncwarp();
    }
    team_sync(team);
  }
}

template <typename TIn, typename TOut>
int launch(const void* x, void* out, const float* b0c, const float* b0s,
           const float* phase, const float* fb, long long batch, long long n,
           int n_frames, cudaStream_t stream) {
  const int tiles = (n_frames + FT - 1) / FT;
  const int items = static_cast<int>(batch * tiles);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(mel_frontend_kernel<TIn, TOut>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (items + TEAMS - 1) / TEAMS;
  const int grid = blocks < sms ? blocks : sms;
  mel_frontend_kernel<TIn, TOut><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const TIn*>(x), static_cast<TOut*>(out), b0c, b0s, phase, fb, n,
      n_frames, tiles, items);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn>
int launch_out(const void* x, void* out, int out_dtype, const float* b0c,
               const float* b0s, const float* phase, const float* fb,
               long long batch, long long n, int n_frames, cudaStream_t stream) {
  if (out_dtype == 0) {
    return launch<TIn, float>(x, out, b0c, b0s, phase, fb, batch, n, n_frames, stream);
  }
  if (out_dtype == 1) {
    return launch<TIn, __nv_bfloat16>(x, out, b0c, b0s, phase, fb, batch, n, n_frames, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: [batch, n] contiguous samples; in_dtype 0 = int16, 1 = float32,
// 2 = bfloat16. out: [batch, n_frames, 32] contiguous; out_dtype 0 = float32,
// 1 = bfloat16. n_frames = ceil(n / 160). b0c, b0s: [160, 128] holding bf16
// values, phase: [4, 128] as (ph1_re, ph1_im, ph2_re, ph2_im), fb: [128, 32]
// holding bf16 values with at most 16 nonzero entries per mel, all float32.
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
