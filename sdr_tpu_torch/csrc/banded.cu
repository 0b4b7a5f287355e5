// The tiled engine's resampling FIR (conv_engine='tiled'), for Hopper
// (sm_90a).
//
// Replaces the reference's tiled banded GEMM, sdr_tpu/ops/banded.py
// `TiledBandedFIR` / `_tiled_apply` (an XLA-level stage, no pallas_call),
// reached through sdr_tpu_torch/ops/banded.py.  For row c, output
// o = u*U + v of a U/D resampler with polyphase bank P (M taps a phase,
// P[j][v] = B[d_v + j, v], d_v = floor(v D / U), B the (L, U) bank of
// ops/resample.py `_build_filter_bank`) and xp = tail ++ x:
//
//   y[c, o] = sum_{j < M} P[j][v] * xp[c, start + floor(o D / U) + j]
//
// with start = S - (M - 1), S the carried tail's length.  These are the
// reference's terms without its band matrix' zeros (span x group*U, 5.4x
// the non-zero work for the mode-0 RDS resampler, 13x for the mode-0
// audio).  The tail and the block come in through two pointers (no
// concat), each float32 or bf16, and are rounded to the store dtype on
// load (bf16 for the bf16 engine: the reference's astype); y leaves in
// float32 and the new tail (the block's last S samples) in the store
// dtype.  The bf16 engine's taps are rounded on the host, so its
// products are exact in float32 and only the order of the float32 sums
// differs from the reference.
//
// What bounds it on the card: a byte bound for the audio (1/5/51: 2 bytes
// in, 0.8 out a sample) and the RDS resampler (19/120/969, M = 51); the
// 151-tap RRC (1/1/151) does 151 multiply-adds an output, 4.7 GFLOP at
// 128 x 121,600, 0.07 ms at the float32 rate against 0.037 ms of bytes:
// operation-bound on the CUDA cores.  Float32 FMAs on the CUDA cores serve
// both engines.  Every kernel stages its block's window in shared memory;
// where the window lies in the block alone (all blocks but a row's first
// and last) a thread keeps 8 loads in flight (the first version loaded
// one checked sample at a time and sat at 2.5-6x its byte bound).  Three
// kernels:
//   - U = 1 (RRC, audio of the integer modes, RF, band-passes;
//     banded_u1_kernel): the taps are a compile-time count in the kernel's
//     parameters, so each FMA takes its tap straight from the constant
//     bank; a thread computes 7 consecutive outputs from one register
//     walk over its staged window ((7-1) D + T shared loads for 7 T FMAs),
//     and the outputs leave through shared memory as coalesced stores.
//     7 outputs a thread keeps the staged window's thread stride (7 D
//     words) odd for odd D: no bank conflict (two-way for even D).
//   - the RDS resampler of mode 0 (19/120/969, the stereo + RDS path's;
//     banded_phase_kernel): a thread takes one super-block and a
//     quarter of its 19 phases, whose taps ride in the kernel's parameters
//     as well; it walks its part of the window once into 5 accumulators
//     (about 240 FMAs with constant operands), where one thread an output
//     loads a tap and a sample for every FMA.  Warp w runs quarter w % 4,
//     so each of the SM's schedulers walks one quarter's taps (1 KB; one
//     group of all 19 phases a thread, 3.9 KB of taps a scheduler, took
//     2x as long), and the window keeps a pad word every D samples, so
//     the threads' loads (D + 1 words apart) hit distinct banks.
//   - any other geometry (the 133/384 RDS resampler and the 147/800 and
//     441/2560 audio of modes 2 and 3, other taps; banded_poly_kernel):
//     one thread an output, 4 outputs a thread 256 apart, the phase's
//     taps read through L1 from the (M, U) bank (mode 3's 51 x 441 floats,
//     90 KB: never staged whole, and never its 4.6 MB dense band matrix).
//     The phase kernel's unrolled walk over these banks (6,783-22,491
//     constant taps) ran 1.4-2.7x slower than this loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kMaxTaps = 151;  // taps the U = 1 kernel takes in its params
constexpr int kU1Threads = 128;
constexpr int kU1Per = 7;      // consecutive outputs a thread (U = 1)
constexpr int kPhaseSB = 64;   // super-blocks a block of the phase kernel
constexpr int kPolyThreads = 256;
constexpr int kPolyPer = 4;    // outputs a thread, kPolyThreads apart
constexpr int kBatch = 8;      // staged loads a thread keeps in flight

struct BandArgs {
  const void* x;     // (rows, n) float32 or bf16
  const void* tail;  // (rows, s) float32 or bf16
  float* y;          // (rows, n_out) float32
  void* new_tail;    // (rows, s) in the store dtype
  long long n;
  long long n_out;   // n / down * up
  int x_bf16;
  int tail_bf16;
  int store_bf16;
  int up;
  int down;
  int m;             // taps a phase
  int s;             // carried tail
  int start;         // s - (m - 1)
};

struct U1Taps {
  float h[kMaxTaps];  // P[j][0], j < m
};

template <int N>
struct PhaseTaps {
  float p[N];  // P[j][v] at p[v * M + j]
};

// a sample as the store dtype holds it, widened to float32
__device__ __forceinline__ float load(const void* p, size_t i, int bf16,
                                      int store_bf16) {
  if (bf16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  const float v = static_cast<const float*>(p)[i];
  return store_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// xp[q] = (tail ++ x)[q] of row `row`
__device__ __forceinline__ float xp_at(const BandArgs& a, size_t row,
                                       long long q) {
  if (q < a.s)
    return load(a.tail, row * a.s + (size_t)q, a.tail_bf16, a.store_bf16);
  return load(a.x, row * a.n + (size_t)(q - a.s), a.x_bf16, a.store_bf16);
}

// the block's last s samples in the store dtype (block 0 of each row)
__device__ void write_tail(const BandArgs& a, size_t row) {
  for (int i = threadIdx.x; i < a.s; i += blockDim.x) {
    const float v =
        load(a.x, row * a.n + (size_t)(a.n - a.s + i), a.x_bf16, a.store_bf16);
    const size_t k = row * a.s + i;
    if (a.store_bf16)
      static_cast<__nv_bfloat16*>(a.new_tail)[k] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(a.new_tail)[k] = v;
  }
}

// w[dst(p)] = x[src(p)] for p < count (x: the window's first sample),
// kBatch loads in flight a thread; MODE 0: bf16 input, 1: float32, 2:
// float32 rounded to bf16
template <int kThreads, int MODE, typename T, typename Src, typename Dst>
__device__ __forceinline__ void stage_body(float* w, const T* x, int count,
                                           Src src, Dst dst) {
  for (int p0 = threadIdx.x; p0 < count; p0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kThreads;
      v[u] = 0.f;
      if (p < count) {
        if constexpr (MODE == 0) {
          v[u] = __bfloat162float(x[src(p)]);
        } else {
          v[u] = x[src(p)];
          if (MODE == 2) v[u] = __bfloat162float(__float2bfloat16_rn(v[u]));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kThreads;
      if (p < count) w[dst(p)] = v[u];
    }
  }
}

// stage `count` samples xp[q0 + src(p)] into w[dst(p)] (src increasing):
// from the block alone, loads batched, where they all lie in it (every
// block but a row's first and last); else one checked sample at a time
// (the tail, and zeros past the block's end)
template <int kThreads, typename Src, typename Dst>
__device__ __forceinline__ void stage(const BandArgs& a, size_t row,
                                      long long q0, int count, Src src,
                                      Dst dst, float* w) {
  const long long qend = (long long)a.s + a.n;
  if (q0 >= a.s && q0 + src(count - 1) < qend) {
    const size_t e0 = row * (size_t)a.n + (size_t)(q0 - a.s);
    if (a.x_bf16)
      stage_body<kThreads, 0>(
          w, static_cast<const __nv_bfloat16*>(a.x) + e0, count, src, dst);
    else if (a.store_bf16)
      stage_body<kThreads, 2>(w, static_cast<const float*>(a.x) + e0, count,
                              src, dst);
    else
      stage_body<kThreads, 1>(w, static_cast<const float*>(a.x) + e0, count,
                              src, dst);
    return;
  }
  for (int p = threadIdx.x; p < count; p += kThreads) {
    const long long q = q0 + src(p);
    w[dst(p)] = q < qend ? xp_at(a, row, q) : 0.f;
  }
}

struct Same {
  __device__ __forceinline__ int operator()(int p) const { return p; }
};

// ---------------------------------------------------------------- U = 1
template <int T, int D>
__global__ void __launch_bounds__(kU1Threads)
    banded_u1_kernel(const __grid_constant__ BandArgs a,
                     const __grid_constant__ U1Taps h) {
  constexpr int kOut = kU1Threads * kU1Per;     // outputs a block
  constexpr int kWin = (kOut - 1) * D + T;      // staged samples (>= kOut)
  constexpr int kWalk = (kU1Per - 1) * D + T;   // samples a thread reads
  extern __shared__ float w[];                  // xp[q0 + p]
  const size_t row = blockIdx.y;
  const long long o0 = (long long)blockIdx.x * kOut;
  stage<kU1Threads>(a, row, a.start + o0 * D, kWin, Same(), Same(), w);
  if (blockIdx.x == 0) write_tail(a, row);
  __syncthreads();
  float acc[kU1Per];
#pragma unroll
  for (int r = 0; r < kU1Per; ++r) acc[r] = 0.f;
  const float* wt = w + threadIdx.x * kU1Per * D;
#pragma unroll
  for (int i = 0; i < kWalk; ++i) {
    const float xv = wt[i];
#pragma unroll
    for (int r = 0; r < kU1Per; ++r) {
      const int k = i - r * D;
      if (k >= 0 && k < T) acc[r] = fmaf(h.h[k], xv, acc[r]);
    }
  }
  __syncthreads();  // the window's slots now hold the block's outputs
#pragma unroll
  for (int r = 0; r < kU1Per; ++r) w[threadIdx.x * kU1Per + r] = acc[r];
  __syncthreads();
  float* y = a.y + row * (size_t)a.n_out;
  for (int p = threadIdx.x; p < kOut; p += kU1Threads) {
    const long long o = o0 + p;
    if (o < a.n_out) y[o] = w[p];
  }
}

// ------------------------------------------------- U > 1, taps in params
// d_v = floor(v D / U): phase v's window starts d_v samples into its
// super-block's
template <int U, int D>
__host__ __device__ constexpr int phase_offset(int v) {
  return (int)(((long long)v * D) / U);
}

// staged samples of a block: kPhaseSB super-blocks' windows, one pad word
// after every D samples
template <int U, int D, int M>
__host__ __device__ constexpr int phase_window() {
  return (kPhaseSB - 1) * D + phase_offset<U, D>(U - 1) + M;
}

template <int U, int D, int M>
__host__ __device__ constexpr int phase_words() {
  return phase_window<U, D, M>() + (phase_window<U, D, M>() - 1) / D;
}

// phase group G of NG (ceil(U / NG) phases) of super-block t: its outputs
// t U + v, v in the group, each taking its M taps straight from the
// kernel's parameters (the constant bank), from one walk over the
// group's samples
template <int U, int D, int M, int NG, int G>
__device__ __forceinline__ void phase_group(const float* w, float* wo,
                                            const PhaseTaps<U * M>& h,
                                            int t) {
  constexpr int kVG = (U + NG - 1) / NG;
  constexpr int kV0 = G * kVG;
  constexpr int kV1 = kV0 + kVG < U ? kV0 + kVG : U;
  constexpr int kLo = phase_offset<U, D>(kV0);
  constexpr int kLen = phase_offset<U, D>(kV1 - 1) - kLo + M;
  const float* wt = w + t * (D + 1);  // a pad word a D: t's stride is odd
  float acc[kVG];
#pragma unroll
  for (int k = 0; k < kVG; ++k) acc[k] = 0.f;
#pragma unroll
  for (int l = 0; l < kLen; ++l) {
    const float xv = wt[kLo + l + (kLo + l) / D];
#pragma unroll
    for (int k = 0; k < kV1 - kV0; ++k) {
      const int j = l - (phase_offset<U, D>(kV0 + k) - kLo);
      if (j >= 0 && j < M) acc[k] = fmaf(h.p[(kV0 + k) * M + j], xv, acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kV1 - kV0; ++k) wo[t * U + kV0 + k] = acc[k];
}

template <int U, int D, int M, int NG, int G = 0>
__device__ __forceinline__ void phase_dispatch(int g, const float* w,
                                               float* wo,
                                               const PhaseTaps<U * M>& h,
                                               int t) {
  if constexpr (G < NG) {
    if (g == G) {
      phase_group<U, D, M, NG, G>(w, wo, h, t);
      return;
    }
    phase_dispatch<U, D, M, NG, G + 1>(g, w, wo, h, t);
  }
}

// kPhaseSB super-blocks a block; warp w runs phase group w % NG (so each
// of the SM's four schedulers walks one group's taps: a smaller constant
// working set) for super-blocks (w / NG) 32 + lane
template <int U, int D, int M, int NG>
__global__ void __launch_bounds__(kPhaseSB * NG)
    banded_phase_kernel(const __grid_constant__ BandArgs a,
                        const __grid_constant__ PhaseTaps<U * M> h) {
  extern __shared__ float w[];
  float* wo = w + phase_words<U, D, M>();  // the block's outputs
  const size_t row = blockIdx.y;
  const long long u0 = (long long)blockIdx.x * kPhaseSB;
  stage<kPhaseSB * NG>(a, row, a.start + u0 * D, phase_window<U, D, M>(),
                       Same(), [](int p) { return p + p / D; }, w);
  if (blockIdx.x == 0) write_tail(a, row);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  phase_dispatch<U, D, M, NG>(warp % NG, w, wo, h,
                              (warp / NG) * 32 + (threadIdx.x & 31));
  __syncthreads();
  float* y = a.y + row * (size_t)a.n_out + u0 * U;
  const long long left = a.n_out - u0 * U;
  for (int p = threadIdx.x; p < kPhaseSB * U && p < left; p += kPhaseSB * NG)
    y[p] = wo[p];
}

// ------------------------------------------------------- any geometry
__global__ void __launch_bounds__(kPolyThreads)
    banded_poly_kernel(const __grid_constant__ BandArgs a,
                       const float* __restrict__ bank) {
  constexpr int kOut = kPolyThreads * kPolyPer;
  extern __shared__ float w[];  // xp[start + p0 + p]
  const size_t row = blockIdx.y;
  const long long o0 = (long long)blockIdx.x * kOut;
  const int count = (int)(o0 + kOut < a.n_out ? kOut : a.n_out - o0);
  const long long p0 = o0 * a.down / a.up;
  // within the block, 32-bit: floor((o0 + i) D / U) - p0 =
  // floor((r0 + i D) / U) and phase (c0 + i) mod U
  const unsigned r0 = (unsigned)(o0 * a.down - p0 * a.up);
  const unsigned c0 = (unsigned)(o0 % a.up);
  const unsigned up = a.up, down = a.down;
  const int width = (int)((r0 + (unsigned)(count - 1) * down) / up) + a.m;
  stage<kPolyThreads>(a, row, a.start + p0, width, Same(), Same(), w);
  if (blockIdx.x == 0) write_tail(a, row);
  __syncthreads();
  float* y = a.y + row * (size_t)a.n_out + o0;
  for (int i = threadIdx.x; i < count; i += kPolyThreads) {
    const float* wo = w + (r0 + (unsigned)i * down) / up;
    const float* bv = bank + (c0 + (unsigned)i) % up;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < a.m; ++j)
      acc = fmaf(__ldg(bv + (size_t)j * up), wo[j], acc);
    y[i] = acc;
  }
}

// ---------------------------------------------------------- launchers
int set_smem(const void* kernel, int smem) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int T, int D>
int launch_u1(const BandArgs& a, const float* taps, long long rows,
              cudaStream_t s) {
  constexpr int kOut = kU1Threads * kU1Per;
  const int smem = ((kOut - 1) * D + T) * (int)sizeof(float);
  const int err = set_smem((const void*)banded_u1_kernel<T, D>, smem);
  if (err) return err;
  U1Taps h;
  memset(&h, 0, sizeof(h));
  memcpy(h.h, taps, sizeof(float) * T);
  const dim3 grid((unsigned)((a.n_out + kOut - 1) / kOut), (unsigned)rows);
  banded_u1_kernel<T, D><<<grid, kU1Threads, smem, s>>>(a, h);
  return (int)cudaGetLastError();
}

// taps: the host's (M, U) bank P, row-major
template <int U, int D, int M, int NG>
int launch_phase(const BandArgs& a, const float* taps, long long rows,
                 cudaStream_t s) {
  static_assert(kPhaseSB % 32 == 0, "whole warps of super-blocks");
  const int smem =
      (phase_words<U, D, M>() + kPhaseSB * U) * (int)sizeof(float);
  const int err = set_smem((const void*)banded_phase_kernel<U, D, M, NG>,
                           smem);
  if (err) return err;
  PhaseTaps<U * M> h;
  for (int v = 0; v < U; ++v)
    for (int j = 0; j < M; ++j) h.p[v * M + j] = taps[j * U + v];
  const long long nsuper = a.n / D;
  const dim3 grid((unsigned)((nsuper + kPhaseSB - 1) / kPhaseSB),
                  (unsigned)rows);
  banded_phase_kernel<U, D, M, NG><<<grid, kPhaseSB * NG, smem, s>>>(a, h);
  return (int)cudaGetLastError();
}

int launch_poly(const BandArgs& a, const float* bank, long long rows,
                cudaStream_t s) {
  constexpr int kOut = kPolyThreads * kPolyPer;
  const long long words =
      ((long long)(kOut - 1) * a.down + a.up - 1) / a.up + 1 + a.m;
  if (words > 227 * 1024 / 4) return (int)cudaErrorInvalidValue;
  const int smem = (int)(words * sizeof(float));
  const int err = set_smem((const void*)banded_poly_kernel, smem);
  if (err) return err;
  const dim3 grid((unsigned)((a.n_out + kOut - 1) / kOut), (unsigned)rows);
  banded_poly_kernel<<<grid, kPolyThreads, smem, s>>>(a, bank);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (rows, n) and tail (rows, s), each float32 or bf16 (x_bf16, tail_bf16);
// store_bf16 rounds both to bf16 on load and writes new_tail (rows, s) at
// bf16 (else float32); y (rows, n / down * up) float32.  taps: the (m, up)
// float32 polyphase bank P on the host (read by the kernels that take it
// in their parameters); bank: the same on the card.  n a multiple of down
// and at least s; s >= m - 1.
int sdr_banded(const void* x, const void* tail, int x_bf16, int tail_bf16,
               int store_bf16, long long rows, long long n, int up, int down,
               int m, int s, const float* taps, const float* bank, void* y,
               void* new_tail, void* stream) {
  if (rows < 1 || rows > 65535 || up < 1 || down < 1 || m < 1 ||
      s < m - 1 || n < s || n % down != 0 ||
      (long long)down * 1024 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  BandArgs a;
  a.x = x;
  a.tail = tail;
  a.y = static_cast<float*>(y);
  a.new_tail = new_tail;
  a.n = n;
  a.n_out = n / down * up;
  a.x_bf16 = x_bf16;
  a.tail_bf16 = tail_bf16;
  a.store_bf16 = store_bf16;
  a.up = up;
  a.down = down;
  a.m = m;
  a.s = s;
  a.start = s - (m - 1);
  if (a.n_out == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (up == 1 && down == 1 && m == 151)
    return launch_u1<151, 1>(a, taps, rows, st);
  if (up == 1 && m == 51) {
    switch (down) {
      case 1: return launch_u1<51, 1>(a, taps, rows, st);
      case 5: return launch_u1<51, 5>(a, taps, rows, st);
      case 6: return launch_u1<51, 6>(a, taps, rows, st);
      case 10: return launch_u1<51, 10>(a, taps, rows, st);
    }
  }
  // the RDS resampler of mode 0 (the stereo + RDS path's)
  if (m == 51 && up == 19 && down == 120)
    return launch_phase<19, 120, 51, 4>(a, taps, rows, st);
  return launch_poly(a, bank, rows, st);
}

}  // extern "C"
