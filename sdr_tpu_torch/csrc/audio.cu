// The audio pair: two same-filter decimating FIRs in one launch, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel sdr_tpu/ops/pallas/audio_kernel.py
// `_pair_kernel` (reached through PairDecimFIR).  For each of the two
// streams s (fm -> mono, mixed -> stereo) and station c, with the 51-tap
// 16 kHz LPF h and decimation D:
//
//   y_s[c, u] = sum_k h[k] x_s[c, D*u - k]
//
// where x_s[c, j<0] is column 128+j of the stream's carried (C, 128) tail
// of raw input samples.  The output is float32; the bf16 compute engine
// rounds the input samples (here) and the taps (on the host) to bf16 and
// accumulates in float32, as the reference does: products of bf16 values
// are exact in float32, so only the order of the float32 sums differs.
//
// What bounds it on the card: per output it reads D samples (2-4 bytes
// each, both streams) and writes 4 bytes: at 128 stations x 768,000
// samples x 2 streams, 393 MB of bf16 in and 157 MB of float32 out, 0.164
// ms at 3.35 TB/s.  Its 51 multiply-adds an output are 4 G on the CUDA
// cores, and one FMA with one shared load each (the first design, one
// output a thread) held it at 0.63 ms: issue-bound.  So the bf16 engine
// (pair_mma_kernel, D = 5 and 6, the receiver's integer modes) runs the
// FIR as a matrix product on the tensor cores, mma.sync.m16n8k16 bf16 ->
// f32:
//   - A is the Toeplitz tile of the taps for 16 consecutive outputs: row r
//     holds h[D r + 52 - kk] at column kk, over the 15 D + 53 samples they
//     reach from 52 before D u0 (128 at D = 5, 144 at D = 6: the k-step
//     count is a template parameter), built with numpy by the wrapper
//     (ops/cuda/audio_kernel.py `audio_tile_bf16`, packed in the A
//     fragments' order) and kept in registers for the whole launch; one
//     tile serves both streams;
//   - B is 8 columns of the staged window, 8 consecutive 16-output
//     segments 16 D samples apart: a lane's two B registers of a k-step
//     are 4 consecutive samples, one 8-byte shared load (A is packed in
//     that k order).  At D = 5 the columns are 160 bytes apart and a
//     half-warp's four hit 32 distinct banks; at D = 6 (192 bytes) the
//     window takes 16 samples of padding every 96 so that they do too;
//   - persistent blocks of 4 warps walk (station, 1024-output) items and
//     stage the next item's windows of both streams (D x 1024 + 56
//     samples each, the first 56 from the carried tail at t = 0) by
//     cp.async while computing this one: one barrier an item, the 52-
//     sample halo read from the window and not recomputed;
//   - each warp owns two 128-output tiles of the item; the accumulators
//     leave through a per-warp shared buffer as 16-byte stores.
// The float32 compute engine stays on the CUDA cores (pair_kernel): one
// block of 256 threads per (256 outputs, station, stream), one thread per
// output, its input window (D*256 + 50 samples, into the tail for the
// first block) staged in shared memory; at 32 registers 8 blocks share an
// SM and hide each other's load latency.  A stride of D words between
// neighbouring threads has no bank conflict
// for odd D.  blockIdx.z picks the stream, so both run in one launch.  The
// TPU kernel's dense band matmul (most of its FLOPs on zeros) and its
// clamped second BlockSpec do not carry over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 51;      // audio_taps of the integer-ratio modes
constexpr int kCtx = 128;      // carried raw input samples per stream
constexpr int kMaxDown = 16;

struct PairTaps {
  float h[kTaps];
};

struct PairArgs {
  const void* x[2];     // (C, n) float32 or bf16 per stream
  const void* tail[2];  // (C, kCtx), the stream's dtype
  float* y[2];          // (C, n / D) float32
  int bf16[2];          // the stream's dtype is bf16
  long long n;
  long long m;          // n / D
  int down;
};

__device__ __forceinline__ float load(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(kThreads)
    pair_kernel(const __grid_constant__ PairArgs a,
                const __grid_constant__ PairTaps h) {
  extern __shared__ float xs[];  // x[D*u0 - (kTaps-1) + p]
  const int s = blockIdx.z;
  const int c = blockIdx.y;
  const long long u0 = (long long)blockIdx.x * kThreads;
  const int d = a.down;
  const long long base = d * u0 - (kTaps - 1);
  const int span = d * (kThreads - 1) + kTaps;
  const void* x = a.x[s];
  const void* tail = a.tail[s];
  const int bf16 = a.bf16[s];
  const size_t row = (size_t)c * (size_t)a.n;
  for (int p = threadIdx.x; p < span; p += kThreads) {
    const long long pos = base + p;
    float v = 0.f;
    if (pos < 0)
      v = load(tail, (size_t)c * kCtx + (size_t)(kCtx + pos), bf16);
    else if (pos < a.n)
      v = load(x, row + (size_t)pos, bf16);
    xs[p] = v;
  }
  __syncthreads();
  const long long u = u0 + threadIdx.x;
  if (u >= a.m) return;
  const float* w = xs + d * threadIdx.x;  // w[kTaps-1-k] = x[D*u - k]
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) acc = fmaf(w[kTaps - 1 - k], h.h[k], acc);
  a.y[s][(size_t)c * (size_t)a.m + (size_t)u] = acc;
}

// ===================================================== tensor-core engine
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kItemU = 1024;                 // outputs of an item, a station
constexpr int kWarpTiles = kItemU / kMmaWarps / 128;   // 128-output tiles
constexpr int kLead = 56;   // staged before D u0: 52 of reach, a multiple of 8
constexpr int kPhase = 2;   // a column starts 50 + 2 samples before D u0
constexpr int kOutPad = 128 + 8 * 4;         // floats of a warp's out buffer

__host__ __device__ constexpr int mma_steps(int d) {
  return (15 * d + kTaps + kPhase + 15) / 16;
}
// samples of padding after every 16 D staged samples, so that the 16 D
// samples between neighbouring columns are 32 or 96 bytes past a multiple
// of 128 and a half-warp's four columns fall on 32 distinct banks
__host__ __device__ constexpr int window_pad(int d) {
  return (32 * d) % 128 == 32 || (32 * d) % 128 == 96 ? 0
         : (32 * d + 32) % 128 == 96 ? 16 : -1;
}
__host__ __device__ constexpr int window_len(int d) {   // bf16, unpadded
  return d * kItemU + kLead;
}
__host__ __device__ constexpr int window_phys(int d, int p) {
  return p + window_pad(d) * (p / (16 * d));
}
__host__ __device__ constexpr int mma_smem_bytes(int d) {
  // two stages of both streams' windows, then the warps' out buffers
  return 2 * 2 * ((window_phys(d, window_len(d) - 1) + 1 + 7) / 8 * 8) * 2 +
         kMmaWarps * kOutPad * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a,
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

// 8 samples of stream row c at sample p (a multiple of 8; p < 0 is the
// carried tail, p >= n zero) into dst as bf16: one cp.async where the
// stream is bf16 and the source is 16-byte aligned, else loads, rounding
// float32 to bf16
__device__ __forceinline__ void stage8(const PairArgs& a, int s, int c,
                                       long long p, __nv_bfloat16* dst) {
  const int bf16 = a.bf16[s];
  const void* base;
  size_t i;
  int valid = 8;
  if (p < 0) {
    base = a.tail[s];
    i = (size_t)c * kCtx + (size_t)(kCtx + p);
  } else {
    base = a.x[s];
    i = (size_t)c * (size_t)a.n + (size_t)p;
    valid = (int)min(8LL, max(0LL, a.n - p));
  }
  if (valid == 8 && bf16 &&
      (((uintptr_t)(static_cast<const __nv_bfloat16*>(base) + i)) & 15) == 0) {
    cp_async16(dst, static_cast<const __nv_bfloat16*>(base) + i);
    return;
  }
  __nv_bfloat16 v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    v[k] = k < valid ? __float2bfloat16_rn(load(base, i + k, bf16))
                     : __float2bfloat16_rn(0.f);
  memcpy(dst, v, 16);
}

// one item's windows of both streams into a stage, in the padded layout:
// staged sample q (from D u0 - kLead) at window_phys(D, q)
template <int D>
__device__ __forceinline__ void stage_item(const PairArgs& a, long long tiles,
                                           long long it, __nv_bfloat16* st) {
  constexpr int kChunks = window_len(D) / 8;
  constexpr int kStream = (window_phys(D, window_len(D) - 1) + 1 + 7) / 8 * 8;
  const int c = (int)(it / tiles);
  const long long s0 = (long long)D * ((it % tiles) * kItemU) - kLead;
  for (int q = threadIdx.x; q < 2 * kChunks; q += kMmaThreads) {
    const int s = q >= kChunks;
    const int k = q - s * kChunks;
    stage8(a, s, c, s0 + 8 * k, st + s * kStream + window_phys(D, 8 * k));
  }
}

// 128 outputs from a warp's out buffer (8 floats of padding every 32) to
// y[e0 ...], cnt of them: 16-byte stores where aligned and whole
__device__ __forceinline__ void store_tile(float* y, size_t e0, int cnt,
                                           const float* ob, int lane) {
  float* g = y + e0;
  if (cnt == 128 && ((uintptr_t)g & 15) == 0) {
    const int p = 4 * lane;
    *reinterpret_cast<float4*>(g + p) =
        *reinterpret_cast<const float4*>(ob + p + 8 * (p >> 5));
  } else {
    for (int p = lane; p < cnt; p += 32) g[p] = ob[p + 8 * (p >> 5)];
  }
}

// The bf16 engine: persistent blocks of 4 warps walk (station, 1024-output)
// items; each stages the next item's windows of both streams by cp.async
// while it computes this one (one barrier an item).  A warp owns two
// 128-output tiles of the item; a tile is 8 columns of 16 outputs, each
// column a k-loop of mma.sync.m16n8k16 of the Toeplitz tile of the taps
// (in registers for the whole launch, one tile for both streams) against
// B fragments loaded straight from the staged window, one 8-byte shared
// load a lane and k-step.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    pair_mma_kernel(const __grid_constant__ PairArgs a,
                    const uint4* __restrict__ taps, long long tiles,
                    long long items) {
  constexpr int KS = mma_steps(D);
  constexpr int kStream = (window_phys(D, window_len(D) - 1) + 1 + 7) / 8 * 8;
  constexpr int kStage = 2 * kStream;   // bf16 elements
  constexpr int kTileStride = 8 * (16 * D + window_pad(D));   // phys samples
  static_assert(window_pad(D) >= 0, "no conflict-free window padding");
  static_assert(D * (kItemU - 16) + kLead - 52 + 16 * KS <= window_len(D),
                "the last column's reach stays in the window");
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float* ob = reinterpret_cast<float*>(smem + 2 * kStage * 2) +
              warp * kOutPad;
  uint4 A[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) A[k] = taps[k * 32 + lane];
  // lane (gq, tq)'s B offsets in a tile: column gq starts 16 D gq + 4
  // samples into it (kLead - 52), its k-step k 16 k + 4 tq later
  int boff[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k)
    boff[k] = window_phys(D, 16 * D * gq + 4 + 16 * k + 4 * tq);
  // accumulator i holds output off[i] of the tile: rows gq, gq + 8 of
  // columns 2tq, 2tq + 1; its out-buffer slot has 8 floats of padding
  // every 32 (the lanes of a store hit 32 banks)
  int oslot[4];
  {
    const int off[4] = {32 * tq + gq, 32 * tq + 16 + gq, 32 * tq + 8 + gq,
                        32 * tq + 24 + gq};
#pragma unroll
    for (int i = 0; i < 4; ++i) oslot[i] = off[i] + 8 * (off[i] >> 5);
  }
  const long long m = a.m;

  if ((long long)blockIdx.x < items)
    stage_item<D>(a, tiles, blockIdx.x, stages);
  cp_async_commit();
  int k = 0;
  for (long long it = blockIdx.x; it < items; it += gridDim.x, ++k) {
    // one barrier an item: past it this item's windows have landed for
    // every thread, and every warp is done with the last item's stage,
    // which the next item then takes
    cp_async_wait_all();
    __syncthreads();
    const long long next = it + gridDim.x;
    if (next < items)
      stage_item<D>(a, tiles, next, stages + ((k + 1) & 1) * kStage);
    cp_async_commit();

    const int c = (int)(it / tiles);
    const long long u0 = (it % tiles) * kItemU;
    const __nv_bfloat16* w = stages + (k & 1) * kStage;
#pragma unroll 1
    for (int i = 0; i < kWarpTiles; ++i) {
      const int tile = warp * kWarpTiles + i;
      const long long ut = u0 + 128LL * tile;
      if (ut >= m) break;
      const __nv_bfloat16* wa = w + kTileStride * tile;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint2 ba = *reinterpret_cast<const uint2*>(wa + boff[kk]);
        const uint2 bb =
            *reinterpret_cast<const uint2*>(wa + kStream + boff[kk]);
        mma_bf16(acc[0], A[kk], ba);
        mma_bf16(acc[1], A[kk], bb);
      }
      const int cnt = (int)min(128LL, m - ut);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int j = 0; j < 4; ++j) ob[oslot[j]] = acc[s][j];
        __syncwarp();
        store_tile(a.y[s], (size_t)c * (size_t)m + (size_t)ut, cnt, ob, lane);
        __syncwarp();
      }
    }
  }
  cp_async_wait_all();
}

template <int D>
int launch_mma(const PairArgs& a, const void* taps, int channels,
               cudaStream_t s) {
  auto kernel = pair_mma_kernel<D>;
  constexpr int smem = mma_smem_bytes(D);
  if (cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads,
                                                smem);
  const long long tiles = (a.m + kItemU - 1) / kItemU;
  const long long items = tiles * channels;
  const long long grid =
      std::min(items, (long long)std::max(1, sms * std::max(1, per_sm)));
  kernel<<<(unsigned)grid, kMmaThreads, smem, s>>>(
      a, static_cast<const uint4*>(taps), tiles, items);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// taps: float32 [51] on the host for the float32 engine; for the bf16
// engine (D = 5 or 6) the wrapper's device buffer of the packed Toeplitz
// tile ([mma_steps(D)][32] uint4).  n a multiple of down, at least 128.
int sdr_audio_pair(const void* xa, const void* xb, const void* tail_a,
                   const void* tail_b, int a_bf16, int b_bf16, int channels,
                   long long n, int down, const float* taps, int ntaps,
                   int bf16_compute, void* ya, void* yb, void* stream) {
  if (channels < 1 || channels > 65535 || ntaps != kTaps || down < 1 ||
      down > kMaxDown || n < kCtx || n % down != 0)
    return (int)cudaErrorInvalidValue;
  PairArgs a;
  a.x[0] = xa;
  a.x[1] = xb;
  a.tail[0] = tail_a;
  a.tail[1] = tail_b;
  a.y[0] = static_cast<float*>(ya);
  a.y[1] = static_cast<float*>(yb);
  a.bf16[0] = a_bf16;
  a.bf16[1] = b_bf16;
  a.n = n;
  a.m = n / down;
  a.down = down;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_compute && down == 5) return launch_mma<5>(a, taps, channels, s);
  if (bf16_compute && down == 6) return launch_mma<6>(a, taps, channels, s);
  if (bf16_compute) return (int)cudaErrorInvalidValue;
  PairTaps h;
  memcpy(h.h, taps, sizeof(h.h));
  const int smem = (down * (kThreads - 1) + kTaps) * (int)sizeof(float);
  dim3 grid((unsigned)((a.m + kThreads - 1) / kThreads), (unsigned)channels,
            2);
  pair_kernel<<<grid, kThreads, smem, s>>>(a, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
