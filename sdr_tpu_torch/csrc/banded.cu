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
// with start = S - (M - 1), S the carried tail's length.  The tail and
// the block come in through two pointers (no concat), each float32 or
// bf16; y leaves in float32 and the new tail (the block's last S samples)
// in the store dtype.  The bf16 engine rounds the samples to bf16 in
// shared memory (the reference's astype) and its taps on the host, so its
// products are exact in float32 and only the order of the float32 sums
// differs from the reference.
//
// What bounds it on the card (H100 80GB HBM3, 700 W; PERF.md): bytes, in
// every geometry the receiver runs: the block read once and y written
// once, 0.027 ms for the mono audio at 128 stations, 0.077 for the RDS
// resampler, 0.037 for the 151-tap RRC, whose 4.7 GFLOP take 0.07 ms at
// the CUDA cores' float32 rate but 0.005 on the tensor cores.  So the bf16
// engine sums on the tensor cores (mma.sync.m16n8k16, bf16 operands,
// float32 accumulators) with its copies in flight under the sums, in two
// bodies; the float32 engine keeps the CUDA-core bodies (TF32 stays off):
//   - bf16, U = 1 at D = 1, 5, 6, 10 and 51 taps, or D = 1 and 151 (the
//     audio of the integer modes, the RRC, RF, the band-passes;
//     banded_u1_mma_kernel): B5's shape (csrc/audio.cu).  A is the
//     Toeplitz tile of the taps for 16 consecutive outputs, in registers
//     for the launch; B is 8 columns of the staged window, 16-output
//     segments 16 D samples apart, 4 samples a lane and k-step straight
//     from the stage (bf16, or float32 rounded to bf16 as it leaves the
//     ring).  Persistent blocks stage the next item's window by 16-byte
//     cp.async while they sum this one (two stages, one barrier an item).
//     At 67-88% of the byte bound; the float32 engine's walk, one FMA a
//     tap on the CUDA cores, is at 30-67%, its sums and copies never
//     overlapping.
//   - bf16, any other geometry (the RDS resamplers 19/120 and 133/384,
//     the audio of modes 2 and 3; banded_mma_kernel): A is the window,
//     row r the adv = group * D samples from xp[qw0 + r adv] on; B is the
//     band of the polyphase bank over group super-blocks
//     (ops/cuda/banded_kernel.py `tile_map`: its non-zero 16 x 8 tiles
//     only, as packed B fragments read through L1; the mode-3 bank is
//     never staged whole).  Workers of 1, 2 or 4 warps (by window size)
//     walk items of 16 rows, each through a ring of up to 3 stages filled
//     by 16-byte cp.async from the 16-byte boundary at or below the
//     window, so one item's copies, window and sums overlap another's.
//     Where the rows fall on distinct bank groups as they are (19/120,
//     bf16 input) ldmatrix reads them from the stage, with the band
//     shifted by the window's offset past that boundary (8 shifts, tiles
//     of their own); else the window is rounded and copied into a bf16
//     window with 8 samples of padding every adv.  A row's ragged ends,
//     the tail and zeros past the block are read sample by sample.  The
//     19/120 RDS resampler runs at 57% of its byte bound (0.136 ms: the
//     probe finds the per-item chain of copies, window and sums, not the
//     bytes, in its way); modes 2 and 3 move 2-17 MB a launch, and their
//     launch and ramp set their time.
//   - float32 engine: banded_u1_kernel (U = 1; the taps a compile-time
//     count in the kernel's parameters, 7 consecutive outputs a thread
//     from one register walk), banded_phase_kernel (19/120: a thread a
//     super-block and a quarter of the phases, taps in the parameters)
//     and banded_poly_kernel (any other geometry, one thread an output,
//     the bank read through L1).  Each stages its block's window in
//     shared memory, 8 loads in flight a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

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
  float* new_tail;   // (rows, s) float32
  long long n;
  long long n_out;   // n / down * up
  int x_bf16;
  int tail_bf16;
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

// a sample widened to float32
__device__ __forceinline__ float load(const void* p, size_t i, int bf16) {
  if (bf16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// xp[q] = (tail ++ x)[q] of row `row`
__device__ __forceinline__ float xp_at(const BandArgs& a, size_t row,
                                       long long q) {
  if (q < a.s)
    return load(a.tail, row * a.s + (size_t)q, a.tail_bf16);
  return load(a.x, row * a.n + (size_t)(q - a.s), a.x_bf16);
}

// the block's last s samples (block 0 of each row)
__device__ void write_tail(const BandArgs& a, size_t row) {
  for (int i = threadIdx.x; i < a.s; i += blockDim.x)
    a.new_tail[row * a.s + i] =
        load(a.x, row * a.n + (size_t)(a.n - a.s + i), a.x_bf16);
}

// w[dst(p)] = x[src(p)] for p < count (x: the window's first sample),
// kBatch loads in flight a thread; T bf16 or float32
template <int kThreads, typename T, typename Src, typename Dst>
__device__ __forceinline__ void stage_body(float* w, const T* x, int count,
                                           Src src, Dst dst) {
  for (int p0 = threadIdx.x; p0 < count; p0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kThreads;
      v[u] = 0.f;
      if (p < count) {
        if constexpr (sizeof(T) == 2)
          v[u] = __bfloat162float(x[src(p)]);
        else
          v[u] = x[src(p)];
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
      stage_body<kThreads>(w, static_cast<const __nv_bfloat16*>(a.x) + e0,
                           count, src, dst);
    else
      stage_body<kThreads>(w, static_cast<const float*>(a.x) + e0, count,
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

// ================================================= bf16 engine, general
// A window row r of an item is the adv = group * D samples from xp[qw0 +
// r adv] on; its product with the band (ops/cuda/banded_kernel.py
// `tile_map`) gives outputs (t0 + r) cols ... + cols - 1 of the row.
constexpr int kMmaThreads = 128;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kChunk = 4;  // n8 tiles a warp sums at once
// A worker is `wk` warps (1, 2 or 4) of a block that take an item
// together, with a barrier of their own; the block's other workers run
// their items at their own pace, so that one worker's copies, conversion
// and sums overlap another's.

struct MmaArgs {
  const void* x;         // (rows, n) float32 or bf16
  const void* tail;      // (rows, s) float32 or bf16
  float* y;              // (rows, n_out) float32
  __nv_bfloat16* new_tail;  // (rows, s) bf16
  const uint2* frags;    // the band's tiles as B fragments, [tile][lane]
  const int4* chunks;    // {klo, khi, first tile, 0}, lo[4], hi[4] a
                         // chunk (8 shifts of them where direct)
  long long n;
  long long n_out;       // n / down * up
  long long items_row;   // items a row: ceil(tiles / (16 mw))
  long long items;
  long long workers;     // gridDim.x * kMmaWarps / wk
  long long cv_lo;       // the 16-byte chunks of x that lie in x whole
  long long cv_hi;
  int x_bf16;
  int tail_bf16;
  int s;
  int start;             // s - (m - 1)
  int adv;               // group * down, a multiple of 8
  int pad;               // samples of padding after every adv staged
  int cols;              // group * up
  int k_tiles;
  int mw;                // 16-row blocks of an item
  int n_chunks;
  int ring;              // stages of input, 0-3 (0: every sample is read
                         // from device memory as the window is converted)
  int wk;                // warps of a worker
  int direct;            // the sums read the window from the ring stage
  int worker_bytes;      // shared memory of a worker: window, then ring
  int win;               // samples of an item's window
  int epc;               // samples of a 16-byte chunk: 8 bf16, 4 float32
  int epc_shift;         // log2(epc)
  float inv_adv;         // 1 / adv
  int x_off;             // samples of x past the 16-byte boundary below it
  int stage_chunks;      // 16-byte chunks of a stage
  int a_elems;           // bf16 samples of the padded window
  int koff_words;        // ints of the k-step offset table
};

// an item's row, first window row and first window sample; the first
// 16-byte chunk of x its stage holds (c0) and the chunks copied there,
// [cl, ch); the window positions [plo, phi) those hold, and the stage
// sample of window position 0 (b0).  One 32-bit division an item: a
// 64-bit one is a subroutine call on the card.
struct ItemSpan {
  long long row, t0, qw0, c0, cl, ch;
  int plo, phi, b0;
};

__device__ __forceinline__ ItemSpan item_span(const MmaArgs& a,
                                              long long it) {
  ItemSpan sp;
  const unsigned row = (unsigned)it / (unsigned)a.items_row;
  sp.row = row;
  sp.t0 = ((long long)it - (long long)row * a.items_row) * (16LL * a.mw);
  sp.qw0 = a.start + sp.t0 * a.adv;
  if (a.direct) {
    // the stage from the 16-byte boundary at or below the window's start
    // (b0 samples below it, the band's shift): the chunks that lie in
    // this row's x whole are copied, the window positions [plo, phi)
    const int e = a.epc_shift;
    const long long xr = sp.row * a.n + a.x_off;
    const long long f0 = xr - a.s + sp.qw0;  // chunk sample of position 0
    sp.c0 = f0 >> e;
    sp.b0 = (int)(f0 - (sp.c0 << e));
    sp.cl = max(max(sp.c0, (xr + a.epc - 1) >> e), a.cv_lo);
    sp.ch = min(min((f0 + a.win + a.epc - 1) >> e, (xr + a.n) >> e),
                a.cv_hi);
    sp.ch = max(sp.ch, sp.cl);
    const long long lo = (sp.cl << e) - f0, hi = (sp.ch << e) - f0;
    sp.plo = (int)min(max(lo, (long long)-sp.b0), (long long)a.win);
    sp.phi = (int)min(max(hi, (long long)sp.plo), (long long)a.win);
    return sp;
  }
  const long long e0 = max(0LL, sp.qw0 - a.s);
  const long long e1 = min(a.n, sp.qw0 + a.win - a.s);
  sp.c0 = sp.cl = sp.ch = 0;
  sp.plo = sp.phi = sp.b0 = 0;
  if (e1 > e0 && a.ring > 0) {
    const long long f = sp.row * a.n + a.x_off;
    sp.c0 = (f + e0) >> a.epc_shift;
    const long long c1 = (f + e1 + a.epc - 1) >> a.epc_shift;
    sp.cl = max(sp.c0, a.cv_lo);
    sp.ch = min(c1, a.cv_hi);
    const long long f0 = f - a.s + sp.qw0;  // chunk sample of position 0
    const long long lo = max(a.s - sp.qw0, sp.cl * a.epc - f0);
    const long long hi = min(a.s + a.n - sp.qw0, sp.ch * a.epc - f0);
    sp.plo = (int)min(max(lo, 0LL), (long long)a.win);
    sp.phi = (int)min(max(hi, 0LL), (long long)a.win);
    sp.b0 = (int)(f0 - sp.c0 * a.epc);
  }
  return sp;
}

// a worker's threads: its index in the block, its first warp, this
// thread's index among its threads and their count
struct Worker {
  int id, warp0, t, threads;
};

__device__ __forceinline__ void worker_sync(const Worker& w) {
  if (w.threads == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(w.id + 1), "r"(w.threads)
                 : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// until at most ahead - 1 groups are pending: the oldest stage has landed
__device__ __forceinline__ void cp_async_wait_ring(int ahead) {
  if (ahead >= 3)
    asm volatile("cp.async.wait_group 2;" ::: "memory");
  else if (ahead == 2)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint4& r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a,
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

// 8 bf16 samples from sample sh (0-7) of two staged 16-byte chunks
template <int K>
__device__ __forceinline__ uint4 shift_bf16(const uint32_t (&w)[8], int odd) {
  const int s = odd ? 16 : 0;
  return make_uint4(__funnelshift_r(w[K], w[K + 1], s),
                    __funnelshift_r(w[K + 1], w[K + 2], s),
                    __funnelshift_r(w[K + 2], w[K + 3], s),
                    __funnelshift_r(w[K + 3], w[K + 4], s));
}

__device__ __forceinline__ uint4 take_bf16(uint4 lo, uint4 hi, int sh) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  switch (sh >> 1) {
    case 0: return shift_bf16<0>(w, sh & 1);
    case 1: return shift_bf16<1>(w, sh & 1);
    case 2: return shift_bf16<2>(w, sh & 1);
    default: return shift_bf16<3>(w, sh & 1);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// 8 float32 samples from sample SH (0-3) of three staged chunks, rounded
// to bf16 as they leave the ring
template <int SH>
__device__ __forceinline__ uint4 round_f32(const float (&v)[12]) {
  return make_uint4(pack2(v[SH], v[SH + 1]), pack2(v[SH + 2], v[SH + 3]),
                    pack2(v[SH + 4], v[SH + 5]), pack2(v[SH + 6], v[SH + 7]));
}

__device__ __forceinline__ uint4 take_f32(float4 a, float4 b, float4 c,
                                          int sh) {
  const float v[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                       c.x, c.y, c.z, c.w};
  switch (sh) {
    case 0: return round_f32<0>(v);
    case 1: return round_f32<1>(v);
    case 2: return round_f32<2>(v);
    default: return round_f32<3>(v);
  }
}

// xp[q] of row `row` as bf16 bits, read from device memory: the carried
// tail, the block, zero past its end (and before xp: the direct window's
// first b0 samples, which meet zero rows of the shifted band)
__device__ __forceinline__ uint32_t xp_bits(const MmaArgs& a, long long row,
                                            long long q) {
  float v = 0.f;
  if (q < 0)
    v = 0.f;
  else if (q < a.s)
    v = load(a.tail, (size_t)(row * a.s + q), a.tail_bf16);
  else if (q - a.s < a.n)
    v = load(a.x, (size_t)(row * a.n + q - a.s), a.x_bf16);
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// xp[q] of row `row` into stage sample i, as the stage holds it: bf16
// bits, or float32 (rounded as it leaves the ring)
__device__ __forceinline__ void put_xp(const MmaArgs& a, long long row,
                                       long long q, uint8_t* st, int i) {
  if (a.x_bf16) {
    reinterpret_cast<uint16_t*>(st)[i] = (uint16_t)xp_bits(a, row, q);
    return;
  }
  float v = 0.f;
  if (q < 0)
    v = 0.f;
  else if (q < a.s)
    v = load(a.tail, (size_t)(row * a.s + q), a.tail_bf16);
  else if (q - a.s < a.n)
    v = load(a.x, (size_t)(row * a.n + q - a.s), 0);
  reinterpret_cast<float*>(st)[i] = v;
}

// the A fragment of k-tile kt: one ldmatrix.x4 of the bf16 window (lanes
// 0-15 give rows 0-15 of k 0-7, 16-31 of k 8-15), or, from a float32
// stage, four 8-byte loads rounded to bf16 (fa: the lane's row gq, k
// 2 tq; adv8: 8 rows on)
__device__ __forceinline__ uint4 a_frag(bool f32, uint32_t arow,
                                        const int* koff, int half,
                                        const float* fa, int adv8, int kt) {
  uint4 r;
  if (!f32) {
    ldmatrix_x4(r, arow + 2u * (uint32_t)koff[2 * kt + half]);
    return r;
  }
  const float* p = fa + 16 * kt;
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + adv8);
  const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(p + adv8 + 8);
  r.x = pack2(v0.x, v0.y);
  r.y = pack2(v1.x, v1.y);
  r.z = pack2(v2.x, v2.y);
  r.w = pack2(v3.x, v3.y);
  return r;
}

// the item's chunks of x that lie in x whole, into a ring stage
__device__ __forceinline__ void fetch(const MmaArgs& a, const Worker& w,
                                      long long it, uint8_t* stage) {
  const ItemSpan sp = item_span(a, it);
  const char* xa = static_cast<const char*>(a.x) -
                   (size_t)a.x_off * (a.x_bf16 ? 2 : 4);
  for (long long c = sp.cl + w.t; c < sp.ch; c += w.threads)
    cp_async16(stage + 16 * (c - sp.c0), xa + 16 * c);
}

// the item's window from its ring stage into the bf16 window (padded
// layout), 8 samples a thread and step; the samples no stage holds (the
// carried tail, a row's ragged ends, zeros past the block) from device
// memory.  The item of a row's first window rows writes the new tail.
__device__ __forceinline__ void convert(const MmaArgs& a, const Worker& wr,
                                        const ItemSpan& sp,
                                        const uint8_t* stage,
                                        __nv_bfloat16* w) {
  if (a.direct) {
    // the window positions no copied chunk holds, in place in the stage
    uint8_t* st = const_cast<uint8_t*>(stage);
    for (int p = wr.t - sp.b0; p < sp.plo; p += wr.threads)
      put_xp(a, sp.row, sp.qw0 + p, st, sp.b0 + p);
    for (int p = sp.phi + wr.t; p < a.win; p += wr.threads)
      put_xp(a, sp.row, sp.qw0 + p, st, sp.b0 + p);
  }
  const int sh = sp.b0 & (a.epc - 1);
  for (int p8 = 8 * wr.t; !a.direct && p8 < a.win; p8 += 8 * wr.threads) {
    uint4 v;
    if (p8 >= sp.plo && p8 + 8 <= sp.phi) {
      const int ci = (sp.b0 + p8) >> a.epc_shift;
      if (a.x_bf16) {
        const uint4* r = reinterpret_cast<const uint4*>(stage) + ci;
        v = take_bf16(r[0], r[1], sh);
      } else {
        const float4* r = reinterpret_cast<const float4*>(stage) + ci;
        v = take_f32(r[0], r[1], r[2], sh);
      }
    } else {
      const long long q = sp.qw0 + p8;
      uint32_t u[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        u[j] = xp_bits(a, sp.row, q + 2 * j) |
               (xp_bits(a, sp.row, q + 2 * j + 1) << 16);
      v = make_uint4(u[0], u[1], u[2], u[3]);
    }
    // the window row of p8, p8 / adv, in float: exact while the window
    // holds fewer than 2^20 samples
    const int r = (int)((p8 + 0.5f) * a.inv_adv);
    *reinterpret_cast<uint4*>(w + p8 + a.pad * r) = v;
  }
  if (sp.t0 == 0)
    for (int i = wr.t; i < a.s; i += wr.threads)
      a.new_tail[sp.row * a.s + i] = __float2bfloat16_rn(
          load(a.x, (size_t)(sp.row * a.n + a.n - a.s + i), a.x_bf16));
}

// the item's outputs: the worker's warp w takes units w, w + wk, ... of
// (16-row block, chunk of 4 n-tiles); a unit walks its chunk's k-tiles,
// one ldmatrix of the window a k-tile (the next one's loaded ahead) and
// one mma a non-zero tile, B fragments read through L1 in tile_map's
// order, a k-tile's loaded before its mma
__device__ __forceinline__ void sums(const MmaArgs& a, const Worker& wr,
                                     const ItemSpan& sp,
                                     const __nv_bfloat16* w,
                                     const int* koff) {
  const int warp = wr.t >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3, half = lane >> 4;
  float* yr = a.y + sp.row * a.n_out;
  const bool f32a = a.direct && !a.x_bf16;  // w: a float32 stage
  for (int u = warp; u < a.mw * a.n_chunks; u += a.wk) {
    const int mg = u % a.mw, cc = u / a.mw;
    const int4* ct = a.chunks + 3 * ((a.direct ? sp.b0 : 0) * a.n_chunks + cc);
    const int4 c0 = __ldg(ct);
    const int4 c1 = __ldg(ct + 1);
    const int4 c2 = __ldg(ct + 2);
    const int klo = c0.x, khi = c0.y;
    const int lo[kChunk] = {c1.x, c1.y, c1.z, c1.w};
    const int hi[kChunk] = {c2.x, c2.y, c2.z, c2.w};
    const uint2* bp = a.frags + (size_t)c0.z * 32 + lane;
    const uint32_t arow =
        smem_u32(w) + 2u * (uint32_t)((mg * 16 + (lane & 15)) *
                                      (a.adv + a.pad));
    float acc[kChunk][4];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const float* fa = reinterpret_cast<const float*>(w) +
                      (mg * 16 + gq) * a.adv + 2 * tq;
    uint4 av = a_frag(f32a, arow, koff, half, fa, 8 * a.adv, klo);
    for (int kt = klo; kt <= khi; ++kt) {
      bool on[kChunk];
      uint2 b[kChunk];
      int nb = 0;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        on[j] = kt >= lo[j] && kt <= hi[j];
        b[j] = on[j] ? __ldg(bp + 32 * nb) : make_uint2(0u, 0u);
        nb += on[j];
      }
      bp += 32 * nb;
      uint4 an = av;
      if (kt < khi) an = a_frag(f32a, arow, koff, half, fa, 8 * a.adv, kt + 1);
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (on[j]) mma_bf16(acc[j], av, b[j]);
      av = an;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long t = sp.t0 + mg * 16 + gq + 8 * h;
        const int col = (cc * kChunk + j) * 8 + 2 * tq;
        const long long o = t * a.cols + col;
        if (col < a.cols && o < a.n_out) {
          yr[o] = acc[j][2 * h];
          if (col + 1 < a.cols && o + 1 < a.n_out)
            yr[o + 1] = acc[j][2 * h + 1];
        }
      }
    }
  }
}

// persistent workers walk the items (row-major): worker i of the grid
// takes items i, i + workers, ...; a ring of `ring` stages keeps its next
// items' input in flight by cp.async while this item's window is converted
// and summed (two worker barriers an item: the stage has landed and the
// last sums are done; the window is ready)
__global__ void __launch_bounds__(kMmaThreads)
    banded_mma_kernel(const __grid_constant__ MmaArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* koff = reinterpret_cast<int*>(smem);
  // window offset of k-tile kt's half h (8 samples), padding included
  for (int i = threadIdx.x; i < 2 * a.k_tiles; i += kMmaThreads) {
    const int k = 16 * (i >> 1) + 8 * (i & 1);
    koff[i] = k + a.pad * (k / a.adv);
  }
  __syncthreads();
  Worker wr;
  wr.id = (threadIdx.x >> 5) / a.wk;
  wr.warp0 = wr.id * a.wk;
  wr.t = threadIdx.x - 32 * wr.warp0;
  wr.threads = 32 * a.wk;
  uint8_t* mine = smem + 4 * a.koff_words + wr.id * a.worker_bytes;
  __nv_bfloat16* w = reinterpret_cast<__nv_bfloat16*>(mine);
  uint8_t* ring = mine + 2 * a.a_elems;
  const int stage_bytes = 16 * a.stage_chunks;
  const long long first = (long long)blockIdx.x * (kMmaWarps / a.wk) + wr.id;
  // items in flight ahead of the one being summed: the whole ring where
  // the window is converted out of its stage, one fewer where the sums
  // read the stage itself
  const int ahead = a.ring - a.direct;
  for (int p = 0; p < ahead; ++p) {
    const long long it = first + (long long)p * a.workers;
    if (it < a.items) fetch(a, wr, it, ring + p * stage_bytes);
    cp_async_commit();
  }
  int k = 0;
  for (long long it = first; it < a.items; it += a.workers, ++k) {
    uint8_t* stage = ring + (a.ring > 0 ? k % a.ring : 0) * stage_bytes;
    const ItemSpan sp = item_span(a, it);
    cp_async_wait_ring(ahead);
    worker_sync(wr);
    convert(a, wr, sp, stage, w);
    if (!a.direct || sp.plo > -sp.b0 || sp.phi < a.win) worker_sync(wr);
    const long long next = it + (long long)ahead * a.workers;
    if (ahead > 0 && next < a.items)
      fetch(a, wr, next, ring + ((k + ahead) % a.ring) * stage_bytes);
    cp_async_commit();
    sums(a, wr, sp, a.direct ? reinterpret_cast<__nv_bfloat16*>(stage) : w,
         koff);
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// ================================================ bf16 engine, U = 1
// The integer-ratio FIRs (audio, RF, the RRC, band-passes) in B5's shape
// (csrc/audio.cu pair_mma_kernel): A is the Toeplitz tile of the taps for
// 16 consecutive outputs, packed on the host and kept in registers for the
// whole launch; B is 8 columns of the staged window, 8 consecutive
// 16-output segments 16 D samples apart, loaded straight from the ring
// (4 samples a lane and k-step, one 8-byte load of bf16 or one 16-byte
// load of float32 rounded to bf16 as it leaves the ring).
template <int D, int T>
struct U1Mma {
  static constexpr int kPhase = 2;  // a column starts T - 1 + 2 before D o
  static constexpr int kLead = (T - 1 + kPhase + 7) / 8 * 8;
  static constexpr int KS = (15 * D + T + kPhase + 15) / 16;
  static constexpr int kTiles = D == 1 ? 32 : 8;  // 128-output tiles an item
  static constexpr int kItem = 128 * kTiles;
  // the last column's reach, from D u0 - kLead
  static constexpr int kLen =
      (16 * D * (8 * kTiles - 1) + kLead - (T - 1) - kPhase + 16 * KS + 7) /
      8 * 8;
};

// samples of padding after every 16 D staged, so that the columns of a
// phase of the B loads fall on distinct banks: 8-byte loads of bf16 (4
// columns a half-warp, 32 D + 2 pad bytes apart: 32 or 96 past a
// multiple of 128), 16-byte loads of float32 (2 columns a quarter-warp,
// 64 D + 4 pad bytes apart: 64 past)
template <int D, bool F32>
__host__ __device__ constexpr int u1_pad() {
  return F32 ? ((64 * D) % 128 == 64 ? 0 : 16)
             : ((32 * D) % 128 == 32 || (32 * D) % 128 == 96 ? 0 : 16);
}

template <int D, bool F32>
__host__ __device__ constexpr int u1_phys(int q) {
  return q + u1_pad<D, F32>() * (q / (16 * D));
}

template <int D, int T, bool F32>
__host__ __device__ constexpr int u1_stage_bytes() {
  return (u1_phys<D, F32>(U1Mma<D, T>::kLen - 1) + 1 + 7) / 8 * 8 *
         (F32 ? 4 : 2);
}

struct U1Args {
  const void* x;         // (rows, n) float32 or bf16
  const void* tail;      // (rows, s) float32 or bf16
  float* y;              // (rows, n_out) float32
  __nv_bfloat16* new_tail;  // (rows, s) bf16
  long long n;
  long long n_out;       // n / D
  long long items_row;   // ceil(n_out / kItem)
  long long items;
  int tail_bf16;
  int s;
};

// 16-byte chunk q (a multiple of 8 / 4 samples) of an item's window, from
// x index e = D u0 - kLead + q: by cp.async where it lies in x whole and
// on a 16-byte boundary, else sample by sample from the tail, x or zero
template <int D, int T, bool F32>
__device__ __forceinline__ void u1_chunk(const U1Args& a, long long row,
                                         long long e, uint8_t* dst) {
  constexpr int kEpc = F32 ? 4 : 8;
  const void* src = static_cast<const char*>(a.x) +
                    (size_t)(row * a.n + e) * (F32 ? 4 : 2);
  if (e >= 0 && e + kEpc <= a.n && ((uintptr_t)src & 15) == 0) {
    cp_async16(dst, src);
    return;
  }
  float v[kEpc];
#pragma unroll
  for (int i = 0; i < kEpc; ++i) {
    const long long q = a.s + e + i;  // xp index
    v[i] = 0.f;
    if (q >= 0 && q < a.s)
      v[i] = load(a.tail, (size_t)(row * a.s + q), a.tail_bf16);
    else if (q >= a.s && e + i < a.n)
      v[i] = load(a.x, (size_t)(row * a.n + e + i), !F32);
  }
  if constexpr (F32) {
    memcpy(dst, v, 16);
  } else {
    const uint4 u = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                               pack2(v[4], v[5]), pack2(v[6], v[7]));
    memcpy(dst, &u, 16);
  }
}

template <int D, int T, bool F32>
__device__ __forceinline__ void u1_fetch(const U1Args& a, long long it,
                                         uint8_t* stage) {
  using G = U1Mma<D, T>;
  constexpr int kEpc = F32 ? 4 : 8;
  constexpr int kChunks = G::kLen / kEpc;
  const long long row = (unsigned)it / (unsigned)a.items_row;
  const long long u0 = ((long long)it - row * a.items_row) * G::kItem;
  const long long e0 = (long long)D * u0 - G::kLead;
  for (int q = threadIdx.x; q < kChunks; q += kMmaThreads)
    u1_chunk<D, T, F32>(a, row, e0 + (long long)kEpc * q,
                        stage + (F32 ? 4 : 2) * u1_phys<D, F32>(kEpc * q));
}

// 128 outputs from a warp's out buffer (8 floats of padding every 32) to
// y + e0, cnt of them: 16-byte stores where aligned and whole
__device__ __forceinline__ void u1_store(float* y, int cnt, const float* ob,
                                         int lane) {
  if (cnt == 128 && ((uintptr_t)y & 15) == 0) {
    const int p = 4 * lane;
    *reinterpret_cast<float4*>(y + p) =
        *reinterpret_cast<const float4*>(ob + p + 8 * (p >> 5));
  } else {
    for (int p = lane; p < cnt; p += 32) y[p] = ob[p + 8 * (p >> 5)];
  }
}

// persistent blocks of 4 warps walk (row, kItem-output) items; each stages
// the next item's window by cp.async while it computes this one (one
// barrier an item, two stages).  A warp owns kTiles / 4 128-output tiles
// of the item, each 8 columns of a k-loop of mma.sync.m16n8k16.
template <int D, int T, bool F32>
__global__ void __launch_bounds__(kMmaThreads, 1)
    banded_u1_mma_kernel(const __grid_constant__ U1Args a,
                         const uint4* __restrict__ taps) {
  using G = U1Mma<D, T>;
  constexpr int KS = G::KS;
  constexpr int kStage = u1_stage_bytes<D, T, F32>();
  constexpr int kPad = u1_pad<D, F32>();
  constexpr int kTileStride = 8 * (16 * D + kPad);   // staged samples
  constexpr int kOutPad = 128 + 8 * 4;
  constexpr int kCol0 = G::kLead - (T - 1) - G::kPhase;
  static_assert(kCol0 >= 0 && kCol0 % 4 == 0, "a lane's 4 samples aligned");
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float* ob = reinterpret_cast<float*>(smem + 2 * kStage) + warp * kOutPad;
  uint4 A[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) A[k] = taps[k * 32 + lane];
  // lane (gq, tq)'s B offsets in a tile: column gq starts 16 D gq + kCol0
  // samples into it, its k-step k 16 k + 4 tq later
  int boff[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k)
    boff[k] = u1_phys<D, F32>(16 * D * gq + kCol0 + 16 * k + 4 * tq);
  // accumulator i holds output off[i] of the tile: rows gq, gq + 8 of
  // columns 2tq, 2tq + 1
  int oslot[4];
  {
    const int off[4] = {32 * tq + gq, 32 * tq + 16 + gq, 32 * tq + 8 + gq,
                        32 * tq + 24 + gq};
#pragma unroll
    for (int i = 0; i < 4; ++i) oslot[i] = off[i] + 8 * (off[i] >> 5);
  }
  if ((long long)blockIdx.x < a.items)
    u1_fetch<D, T, F32>(a, blockIdx.x, smem);
  cp_async_commit();
  int k = 0;
  for (long long it = blockIdx.x; it < a.items; it += gridDim.x, ++k) {
    // past the barrier this item's window has landed for every thread,
    // and every warp is done with the last item's stage
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    const long long next = it + gridDim.x;
    if (next < a.items)
      u1_fetch<D, T, F32>(a, next, smem + ((k + 1) & 1) * kStage);
    cp_async_commit();
    const long long row = (unsigned)it / (unsigned)a.items_row;
    const long long u0 = ((long long)it - row * a.items_row) * G::kItem;
    if (u0 == 0)
      for (int i = threadIdx.x; i < a.s; i += kMmaThreads)
        a.new_tail[row * a.s + i] = __float2bfloat16_rn(
            load(a.x, (size_t)(row * a.n + a.n - a.s + i), !F32));
    const uint8_t* st = smem + (k & 1) * kStage;
#pragma unroll 1
    for (int i = 0; i < G::kTiles / kMmaWarps; ++i) {
      const int tile = warp * (G::kTiles / kMmaWarps) + i;
      const long long ut = u0 + 128LL * tile;
      if (ut >= a.n_out) break;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint2 b;
        if constexpr (F32) {
          const float4 v = *reinterpret_cast<const float4*>(
              st + 4 * (kTileStride * tile + boff[kk]));
          b = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
        } else {
          b = *reinterpret_cast<const uint2*>(
              st + 2 * (kTileStride * tile + boff[kk]));
        }
        mma_bf16(acc, A[kk], b);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) ob[oslot[j]] = acc[j];
      __syncwarp();
      u1_store(a.y + row * a.n_out + ut, (int)min(128LL, a.n_out - ut), ob,
               lane);
      __syncwarp();
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
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

template <int D, int T, bool F32>
int launch_u1_mma(U1Args a, const void* taps, long long rows,
                  cudaStream_t s) {
  using G = U1Mma<D, T>;
  auto kernel = banded_u1_mma_kernel<D, T, F32>;
  constexpr int smem =
      2 * u1_stage_bytes<D, T, F32>() + kMmaWarps * (128 + 32) * 4;
  const int err = set_smem((const void*)kernel, smem);
  if (err) return err;
  a.items_row = (a.n_out + G::kItem - 1) / G::kItem;
  a.items = rows * a.items_row;
  if (a.items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads,
                                                smem);
  const long long grid =
      std::min(a.items, (long long)std::max(1, sms * std::max(1, per_sm)));
  kernel<<<(unsigned)grid, kMmaThreads, smem, s>>>(
      a, static_cast<const uint4*>(taps));
  return (int)cudaGetLastError();
}

template <int D, int T>
int launch_u1_mma(const U1Args& a, int f32, const void* taps, long long rows,
                  cudaStream_t s) {
  return f32 ? launch_u1_mma<D, T, true>(a, taps, rows, s)
             : launch_u1_mma<D, T, false>(a, taps, rows, s);
}

int launch_mma(MmaArgs& a, long long rows, long long tiles, cudaStream_t s) {
  const int esize = a.x_bf16 ? 2 : 4;
  a.epc = 16 / esize;
  a.epc_shift = a.x_bf16 ? 3 : 2;
  a.inv_adv = 1.f / (float)a.adv;
  a.win = (16 * a.mw - 1) * a.adv + 16 * a.k_tiles;
  if (a.win >= (1 << 20)) return (int)cudaErrorInvalidValue;
  a.stage_chunks = (a.win + a.epc - 1) / a.epc + 4;
  const int phys = a.win - 1 + a.pad * ((a.win - 1) / a.adv) + 1;
  a.a_elems = a.direct ? 0 : (phys + 7) / 8 * 8;
  a.koff_words = (2 * a.k_tiles + 3) / 4 * 4;
  const long long worker = 2LL * a.a_elems + 16LL * a.ring * a.stage_chunks;
  const long long smem = 4LL * a.koff_words + kMmaWarps / a.wk * worker;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  a.worker_bytes = (int)worker;
  const int err = set_smem((const void*)banded_mma_kernel, (int)smem);
  if (err) return err;
  a.items_row = (tiles + 16LL * a.mw - 1) / (16LL * a.mw);
  a.items = rows * a.items_row;
  if (a.items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, banded_mma_kernel,
                                                kMmaThreads, (size_t)smem);
  const long long per_block = kMmaWarps / a.wk;
  const long long grid = std::min(
      (a.items + per_block - 1) / per_block,
      (long long)std::max(1, sms * std::max(1, per_sm)));
  a.workers = grid * per_block;
  banded_mma_kernel<<<(unsigned)grid, kMmaThreads, (size_t)smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The float32 engine.  x (rows, n) and tail (rows, s), each float32 or
// bf16 (x_bf16, tail_bf16); y (rows, n / down * up) and new_tail (rows, s)
// float32.  taps: the (m, up) float32 polyphase bank P on the host (read
// by the kernels that take it in their parameters); bank: the same on the
// card.  n a multiple of down and at least s; s >= m - 1.
int sdr_banded(const void* x, const void* tail, int x_bf16, int tail_bf16,
               long long rows, long long n, int up, int down, int m, int s,
               const float* taps, const float* bank, void* y, void* new_tail,
               void* stream) {
  if (rows < 1 || rows > 65535 || up < 1 || down < 1 || m < 1 ||
      s < m - 1 || n < s || n % down != 0 ||
      (long long)down * 1024 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  BandArgs a;
  a.x = x;
  a.tail = tail;
  a.y = static_cast<float*>(y);
  a.new_tail = static_cast<float*>(new_tail);
  a.n = n;
  a.n_out = n / down * up;
  a.x_bf16 = x_bf16;
  a.tail_bf16 = tail_bf16;
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

// The bf16 engine: x, tail and y as above, both rounded to bf16 as they
// are staged; new_tail (rows, s) bf16.  The band's layout comes from the
// host (ops/cuda/banded_kernel.py `tile_map`): group, pad, k_tiles, mw,
// n_chunks, ring, wk, direct, and on the card its tiles' B fragments
// (frags) and the chunks' k-tile runs (chunks, 12 ints a chunk; 8 shifts
// of them one after another where direct).  u1_taps, where not null:
// the packed Toeplitz tile of the taps (ops/cuda/banded_kernel.py
// `u1_tile`) for the U = 1 body, which takes U = 1 with D = 1 and 151
// taps, or D = 1, 5, 6, 10 and 51 taps (the band's layout is then unused).
int sdr_banded_mma(const void* x, const void* tail, int x_bf16,
                   int tail_bf16, long long rows, long long n, int up,
                   int down, int m, int s, int group, int pad, int k_tiles,
                   int mw, int n_chunks, int ring, int wk, int direct,
                   const void* frags, const void* chunks,
                   const void* u1_taps, void* y, void* new_tail,
                   void* stream) {
  const long long adv = (long long)group * down;
  const int esize = x_bf16 ? 2 : 4;
  if (rows < 1 || up < 1 || down < 1 || m < 1 || group < 1 || s < m - 1 ||
      n < s || n % down != 0 || adv % 8 != 0 || adv > (1 << 20) ||
      (pad != 0 && pad != 8) || mw < 1 || mw > 64 || n_chunks < 1 ||
      ring < 0 || ring > 3 || k_tiles < 1 ||
      (wk != 1 && wk != 2 && wk != 4) ||
      (direct && (pad != 0 || ring < 2)) ||
      16LL * k_tiles < (long long)(group - 1) * down +
                           (long long)(up - 1) * down / up + m ||
      (long long)group * up > 8LL * kChunk * n_chunks ||
      ((uintptr_t)x) % esize != 0)
    return (int)cudaErrorInvalidValue;
  MmaArgs a;
  a.x = x;
  a.tail = tail;
  a.y = static_cast<float*>(y);
  a.new_tail = static_cast<__nv_bfloat16*>(new_tail);
  a.frags = static_cast<const uint2*>(frags);
  a.chunks = static_cast<const int4*>(chunks);
  a.n = n;
  a.n_out = n / down * up;
  a.x_bf16 = x_bf16;
  a.tail_bf16 = tail_bf16;
  a.s = s;
  a.start = s - (m - 1);
  a.adv = (int)adv;
  a.pad = pad;
  a.cols = group * up;
  a.k_tiles = k_tiles;
  a.mw = mw;
  a.n_chunks = n_chunks;
  a.ring = ring;
  a.wk = wk;
  a.direct = direct;
  a.x_off = (int)(((uintptr_t)x) % 16 / esize);
  a.cv_lo = a.x_off > 0 ? 1 : 0;
  a.cv_hi = (a.x_off + rows * n) / (16 / esize);
  if (a.n_out == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u1_taps != nullptr) {
    // the integer-ratio FIRs: B5's shape, the taps' tile in registers
    U1Args u;
    u.x = x;
    u.tail = tail;
    u.y = a.y;
    u.new_tail = a.new_tail;
    u.n = n;
    u.n_out = a.n_out;
    u.tail_bf16 = tail_bf16;
    u.s = s;
    const int f32 = !x_bf16;
    if (up == 1 && down == 1 && m == 151)
      return launch_u1_mma<1, 151>(u, f32, u1_taps, rows, st);
    if (up == 1 && m == 51) {
      switch (down) {
        case 1: return launch_u1_mma<1, 51>(u, f32, u1_taps, rows, st);
        case 5: return launch_u1_mma<5, 51>(u, f32, u1_taps, rows, st);
        case 6: return launch_u1_mma<6, 51>(u, f32, u1_taps, rows, st);
        case 10: return launch_u1_mma<10, 51>(u, f32, u1_taps, rows, st);
      }
    }
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = (n / down + group - 1) / group;
  return launch_mma(a, rows, tiles, st);
}

}  // extern "C"
