// Fused IF bank, for Hopper (sm_90a): the four band-pass stages of the
// stereo + RDS chain, with the feedforward estimators' mix sums
// (sdr_ifbank_mix) or with all four streams written (sdr_ifbank).
//
// Replaces two Pallas kernels of sdr_tpu/ops/pallas/ifbank_kernel.py:
// `_ifbank_mix_kernel` (reached through FusedIFBankMix.mix_call) and
// `_ifbank_kernel` (FusedIFBank.__call__, the IF bank of the carrier
// loop engines).  Per station row c of the demodulated IF stream fm
// (C, n) and its carried (C, 128) tail (tail ++ fm is the stream), with
// four 51-tap FIRs:
//
//   chan[p]  = sum_k h_chan[k]  fm[p-k]       stereo channel 22-54 kHz
//   pilot[p] = sum_k h_pilot[k] fm[p-k]       pilot 18.5-19.5 kHz
//   rds[p]   = sum_k h_rds[k]   fm[p-k]       RDS channel 54-60 kHz
//   carr[p]  = sum_k h_carr[k]  rds[p-k]^2    carrier 113.5-114.5 kHz
//
// it writes chan and rds (rounded to the output dtype) and either
//   - (mix) per window w of 256 samples, the coherent sums of the
//     unrounded float32 pilot and carrier against the host's ramp tables:
//       zpr[w] = sum pilot*cos_p,  zpi[w] = sum pilot*(-sin_p),
//       zrr[w] = sum carr*cos_r,   zri[w] = sum carr*(-sin_r);
//     the pilot and carrier streams never reach device memory;
//   - (four streams) pilot and carr too, rounded to the output dtype, for
//     the loop engines that track the carriers sample by sample.
// One kernel template serves both; the four-stream variant drops the
// ramp loads and the window reduction and writes two more streams.
//
// The bf16 compute engine rounds three things to bf16, as the reference
// does: the fm window, the taps (on the host), and rds^2 before the
// carrier FIR.  Products of bf16 values are exact in float32, and every
// sum accumulates in float32.
//
// What bounds it on the card: per output sample it reads 2-4 bytes of fm
// and 16 bytes of ramp table (shared by all stations, so from L2) and
// writes 4-8 bytes (8-16 for the four streams), against ~207 multiply-
// adds.  On the CUDA cores their FMAs alone take 0.69 ms at 128 stations
// x 768,000 samples; on the bf16 tensor cores ~0.01 ms.  The bytes take
// 0.18 ms (0.29 ms with the four bf16 streams): that is the bound to
// approach, and the bf16 engine's design (ifbank_mma_kernel) is:
//   - each FIR is a small matrix product, mma.sync.m16n8k16 bf16 -> f32:
//     A is the Toeplitz tile of a filter's taps for 16 consecutive outputs
//     (row r holds h[r + 52 - kk] at column kk: 16 x 80, five k-steps over
//     the 68 samples they reach from 52 before the first), built once with
//     numpy by the wrapper (ops/cuda/ifbank_kernel.py `toeplitz_tile_bf16`,
//     packed in the A fragments' order) and kept in registers, the four
//     tiles 80 registers; B is 8 columns of the staged window, 8
//     consecutive 16-output segments.  A lane's two B registers of a
//     k-step are 4 consecutive samples, one 8-byte shared load without
//     bank conflicts (A is packed in the k order that this gives).  chan
//     and pilot share their B fragments;
//   - a block is 4 warps, one station each, over a time tile of 1024
//     samples: it stages the 4 stations' fm[t0-192, t0+1040) as bf16
//     (rounded where the input is float32; the first 128 from the tail at
//     t0 = 0) and the tile's four ramp rows once for the 4 stations, by
//     cp.async, one work item ahead of the one computed (persistent blocks
//     walk the items; one barrier an item).  The block takes ~80 KB of
//     shared memory, 2 blocks an SM: 512-sample tiles (~42 KB, 3 blocks,
//     the four Toeplitz tiles' 80 registers keeping out a fourth) ran
//     slower, 0.56 ms against 0.51, the halo's share of the work being
//     twice as large (PERF.md);
//   - each warp computes rds over [t0-128, t0+1024), the block's run and
//     the halo that the carrier FIR reaches back into (the TPU kernel
//     recomputed it too), squares it in float32, rounds the square to
//     bf16 into its shared buffer, and runs the carrier tile on it;
//   - the sums: a lane multiplies its 4 unrounded float32 pilot (carrier)
//     accumulators by the ramps in order j = 0..3, over the window's two
//     128-output tiles in order, then a fixed butterfly of 6
//     __shfl_xor_sync adds the warp's 32 lanes (the four sums split
//     between lane halves, then quarters): no atomics, the same bits every
//     run.  The ramp rows are staged with 8 words of padding every 32, so
//     that the accumulators' scattered reads hit 32 distinct banks;
//   - chan and rds, rounded to the output dtype, leave through a per-warp
//     shared buffer as 16-byte stores.
// The four-stream variant (B6) runs the same body and writes pilot and the
// carrier instead of the sums.  The float32 compute engine stays on the
// CUDA cores (ifbank_kernel below): TF32 would miss its 1e-5 gate.  Its
// design:
//   - one block of 256 threads per (station, 4 windows of 256 samples).
//     The block stages fm[t0-100, t0+1024) in shared memory (the carrier
//     at p needs rds[p-50..p], which needs fm[p-100..p]; for t0 = 0 the
//     first 100 come from the tail), then computes the RDS channel over
//     [t0-50, t0+1024) into shared memory: the TPU kernel carried nothing
//     but the fm tail and recomputed the RDS halo, and so does each block;
//   - each thread computes 4 consecutive outputs of each FIR from a
//     56-sample register window that it loads as 14 float4 shared loads,
//     so the shared-memory traffic is ~11 wavefronts per output instead
//     of one load per tap (a first version, one output per thread, was
//     bound by those loads at 2.74 ms);
//   - every staging load of a block, and the ramp rows, are requested
//     before the block first waits on memory (with 96 registers a thread,
//     2 blocks share an SM, too few to hide load after load: the second
//     version took 1.81 ms);
//   - a window's 64 threads add their sums in a fixed order (each thread
//     its 4 products in order, then a warp tree, then the window's two
//     warps): no atomics, the same bits every run;
//   - the TPU's dense band matmuls, 8-channel padding and DMA double
//     buffering do not carry over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

constexpr int kTaps = 51;              // bp_taps of every mode
constexpr int kWin = 256;              // estimator window
constexpr int kThreads = 256;
constexpr int kR = 4;                  // consecutive outputs per thread
constexpr int kTile = kThreads * kR;   // outputs per block
constexpr int kWinPerBlock = kTile / kWin;
constexpr int kExt = kTaps - 1;        // RDS halo recomputed per block
constexpr int kHalo = 2 * kExt;        // fm samples needed before t0
constexpr int kCtx = 128;              // carried fm tail per station
constexpr int kSpan = 56;              // register window: 14 float4
constexpr int kRdsGroups = (kTile + kExt + kR - 1) / kR;  // 4-sample groups
constexpr int kRdsLen = kRdsGroups * kR;                  // 1076
constexpr int kInLen = kRdsLen + kSpan - kR;              // 1128
// the chan/pilot window starts 52 samples before a thread's first output
// (a float4 boundary): taps reach m = j + 52 - k in [2, 55]
static_assert(kR - 1 + 52 < kSpan && 52 - (kTaps - 1) >= 0, "window");

struct BankTaps {
  float chan[kTaps], pilot[kTaps], rds[kTaps], carr[kTaps];
};

struct BankArgs {
  const void* fm;       // (C, n) float32 or bf16
  const void* tail;     // (C, kCtx), fm's dtype
  const float* cos_p;   // (n,) ramp tables of the pilot engine
  const float* sin_p;
  const float* cos_r;   // (n,) ramp tables of the RDS carrier engine
  const float* sin_r;
  void* chan;           // (C, n) output dtype
  void* rdsch;
  float* zpr;           // (C, n / kWin), mix variant
  float* zpi;
  float* zrr;
  float* zri;
  void* pilot;          // (C, n) output dtype, four-stream variant
  void* carr;
  long long n;
};

template <bool BF16>
__device__ __forceinline__ float load(const void* p, size_t i) {
  if constexpr (BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  else
    return static_cast<const float*>(p)[i];
}

// four consecutive outputs at element offset i (a multiple of 4)
template <bool BF16>
__device__ __forceinline__ void store4(void* p, size_t i, const float* v) {
  if constexpr (BF16) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    memcpy(&u.x, &a, 4);
    memcpy(&u.y, &b, 4);
    reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i)[0] = u;
  } else {
    reinterpret_cast<float4*>(static_cast<float*>(p) + i)[0] =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// kSpan consecutive shared floats from s (16-byte aligned) into r
__device__ __forceinline__ void load_span(const float* s, float* r) {
#pragma unroll
  for (int m = 0; m < kSpan / 4; ++m) {
    const float4 v = reinterpret_cast<const float4*>(s)[m];
    r[4 * m] = v.x;
    r[4 * m + 1] = v.y;
    r[4 * m + 2] = v.z;
    r[4 * m + 3] = v.w;
  }
}

// acc[j] = sum_k h[k] r[j + off - k], k in order (j = 0..kR-1)
template <int OFF>
__device__ __forceinline__ void fir4(const float* r, const float* h,
                                     float* acc) {
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[j] = fmaf(r[j + OFF - k], h[k], acc[j]);
}

template <bool IN_BF16, bool OUT_BF16, bool MIX>
__global__ void __launch_bounds__(kThreads, 2)
    ifbank_kernel(const __grid_constant__ BankArgs a,
                  const __grid_constant__ BankTaps h) {
  __shared__ __align__(16) float xs[kInLen];   // fm[t0 - kHalo + p]
  __shared__ __align__(16) float rs[kRdsLen];  // rds[t0 - kExt + q]
  __shared__ __align__(16) float sq[kRdsLen];  // rds^2
  __shared__ float red[4][kThreads / 32];
  const int c = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * kTile;
  const size_t row = (size_t)c * (size_t)a.n;
  const int i0 = kR * threadIdx.x;  // first of this thread's outputs
  const long long pos = t0 + i0;
  const bool valid = pos < a.n;     // n % kWin == 0: all 4 or none

  // the ramp rows this thread's sums need, requested before anything
  // waits on memory
  float4 cp = {}, sp = {}, cr = {}, sr = {};
  if (MIX && valid) {
    cp = *reinterpret_cast<const float4*>(a.cos_p + pos);
    sp = *reinterpret_cast<const float4*>(a.sin_p + pos);
    cr = *reinterpret_cast<const float4*>(a.cos_r + pos);
    sr = *reinterpret_cast<const float4*>(a.sin_r + pos);
  }
  {
    // every staging load is issued before the first store, so the block
    // waits for one round trip to memory, not one per load
    constexpr int kLoads = (kInLen + kThreads - 1) / kThreads;
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int p = threadIdx.x + u * kThreads;
      const long long q = t0 - kHalo + p;
      v[u] = 0.f;  // past the end of the stream: read by no kept output
      if (p < kInLen && q < 0)
        v[u] = load<IN_BF16>(a.tail, (size_t)c * kCtx + (size_t)(kCtx + q));
      else if (p < kInLen && q < a.n)
        v[u] = load<IN_BF16>(a.fm, row + (size_t)q);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int p = threadIdx.x + u * kThreads;
      if (p < kInLen) xs[p] = v[u];
    }
  }
  __syncthreads();
  // the RDS channel over [t0 - kExt, t0 + kTile): the block's run and the
  // halo the carrier FIR reaches back into; group g is samples 4g..4g+3
  for (int g = threadIdx.x; g < kRdsGroups; g += kThreads) {
    float r[kSpan], acc[kR] = {0.f, 0.f, 0.f, 0.f}, s[kR];
    load_span(xs + kR * g, r);
    fir4<kExt>(r, h.rds, acc);
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      s[j] = __fmul_rn(acc[j], acc[j]);
    }
    reinterpret_cast<float4*>(rs)[g] = make_float4(acc[0], acc[1], acc[2],
                                                   acc[3]);
    reinterpret_cast<float4*>(sq)[g] = make_float4(s[0], s[1], s[2], s[3]);
  }
  __syncthreads();

  float ch[kR] = {0.f, 0.f, 0.f, 0.f}, pi[kR] = {0.f, 0.f, 0.f, 0.f};
  float ca[kR] = {0.f, 0.f, 0.f, 0.f};
  {
    float r[kSpan];  // xs[i0 + 48 + m]: output i0+j, tap k reads m = j+52-k
    load_span(xs + i0 + kHalo - 52, r);
    fir4<52>(r, h.chan, ch);
    fir4<52>(r, h.pilot, pi);
  }
  {
    float r[kSpan];  // sq[i0 + m]: output i0+j, tap k reads m = j+50-k
    load_span(sq + i0, r);
    fir4<kExt>(r, h.carr, ca);
  }
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (valid) {
    float rd[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) rd[j] = rs[i0 + kExt + j];
    store4<OUT_BF16>(a.chan, row + (size_t)pos, ch);
    store4<OUT_BF16>(a.rdsch, row + (size_t)pos, rd);
    if constexpr (!MIX) {
      store4<OUT_BF16>(a.pilot, row + (size_t)pos, pi);
      store4<OUT_BF16>(a.carr, row + (size_t)pos, ca);
    }
  }
  if constexpr (!MIX) return;
  if (valid) {
    const float c4p[4] = {cp.x, cp.y, cp.z, cp.w};
    const float s4p[4] = {sp.x, sp.y, sp.z, sp.w};
    const float c4r[4] = {cr.x, cr.y, cr.z, cr.w};
    const float s4r[4] = {sr.x, sr.y, sr.z, sr.w};
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      v[0] += __fmul_rn(pi[j], c4p[j]);
      v[1] += __fmul_rn(pi[j], -s4p[j]);
      v[2] += __fmul_rn(ca[j], c4r[j]);
      v[3] += __fmul_rn(ca[j], -s4r[j]);
    }
  }
  // a window is 64 threads, two warps: warp sums, then the pair in order
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = warp_sum(v[j]);
    if (lane == 0) red[j][warp] = v[j];
  }
  __syncthreads();
  if (threadIdx.x < 4 * kWinPerBlock) {
    const int j = threadIdx.x / kWinPerBlock;   // which sum
    const int wi = threadIdx.x % kWinPerBlock;  // which window
    if (t0 + (long long)wi * kWin < a.n) {
      const size_t zi = (size_t)c * (size_t)(a.n / kWin) +
                        (size_t)(t0 / kWin) + wi;
      float* z[4] = {a.zpr, a.zpi, a.zrr, a.zri};
      z[j][zi] = red[j][2 * wi] + red[j][2 * wi + 1];
    }
  }
}


// ===================================================== tensor-core engine
constexpr int kMmaWarps = 4;                    // stations of a block
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kTileT = 1024;                    // samples of a time tile
constexpr int kWarpOut = 128;                   // 8 columns x 16 rows
constexpr int kWarpTiles = kTileT / kWarpOut;
constexpr int kKs = 5;                          // k-steps of 16: 66 <= 80
constexpr int kFirs = 4;                        // chan, pilot, rds, carr
constexpr int kRdsLead = 128;                   // rds from t0 - 128
constexpr int kFmLead = 192;                    // fm staged from t0 - 192
constexpr int kOver = 16;                       // staged past the tile
constexpr int kFmLen = kFmLead + kTileT + kOver;   // bf16 a station
constexpr int kSqLen = kRdsLead + kTileT + kOver;  // bf16 a warp
constexpr int kRampLen = kTileT + kTileT / 4;      // floats a row, padded
constexpr int kOutStage = kWarpOut * 4 + 4 * 32;   // bytes a stream
constexpr int kFmStage = kMmaWarps * kFmLen * 2;   // bytes
constexpr int kRampStage = 4 * kRampLen * 4;       // bytes
// a column of the window starts kReach = 52 samples before its first
// output (50 taps of reach and 2 of phase, so that a lane's 4 samples of a
// k-step are one 8-byte load): the staged index of rds tile j's column g
// is 128j + kRdsCol + 16g, of chan/pilot tile j's 128j + kFmCol + 16g, of
// the carrier's (in the rds^2 buffer, which starts at t0 - kRdsLead)
// 128j + kSqCol + 16g
constexpr int kReach = kExt + 2;
constexpr int kRdsCol = kFmLead - kRdsLead - kReach;  // 12
constexpr int kFmCol = kFmLead - kReach;              // 140
constexpr int kSqCol = kRdsLead - kReach;             // 76
static_assert(kRdsCol >= 0 && kRdsCol % 4 == 0 && kSqCol % 4 == 0 &&
                  kFmCol % 4 == 0 && kFmLead % 8 == 0 && kFmLead >= kCtx,
              "window offsets");
static_assert(kFmCol + kTileT - 16 + 16 * kKs <= kFmLen &&
                  kRdsCol + kTileT + kRdsLead - 16 + 16 * kKs <= kFmLen &&
                  kSqCol + kTileT - 16 + 16 * kKs <= kSqLen,
              "the last columns' reach stays in the staged window");

__host__ __device__ constexpr int ramp_at(int p) { return p + 8 * (p >> 5); }

// output streams staged a warp: chan and rds, and pilot and the carrier
// without the sums
__host__ __device__ constexpr int out_streams(bool mix) { return mix ? 2 : 4; }

__host__ __device__ constexpr int mma_smem_bytes(bool mix) {
  return 2 * (kFmStage + (mix ? kRampStage : 0)) + kMmaWarps * kSqLen * 2 +
         kMmaWarps * out_streams(mix) * kOutStage;
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// acc += A x B, lane (gq, tq)'s samples of B's column gq at w[base]
// (base includes 4 tq): samples 4tq..4tq+3 of each k-step, one 8-byte
// load, are the mma's k rows 2tq, 2tq+1 (b0) and 2tq+8, 2tq+9 (b1), the k
// order that A is packed in; NA tiles on one B
template <int F0, int NA>
__device__ __forceinline__ void fir_tiles(float (&acc)[NA][4],
                                          const uint4 (&a)[kFirs][kKs],
                                          const __nv_bfloat16* w, int base) {
#pragma unroll
  for (int k = 0; k < kKs; ++k) {
    const uint2 b = *reinterpret_cast<const uint2*>(w + base + 16 * k);
#pragma unroll
    for (int f = 0; f < NA; ++f) mma_bf16(acc[f], a[F0 + f][k], b.x, b.y);
  }
}

// One work item's window into a stage: the fm of the block's 4 stations
// as bf16 (rounded where the input is float32; zero before the carried
// tail and past the row's end) and, with the sums, the tile's ramp rows.
template <bool IN_BF16, bool MIX>
__device__ __forceinline__ void stage_item(const BankArgs& a, int channels,
                                           long long tiles, long long it,
                                           uint8_t* st) {
  const int c0 = (int)(it / tiles) * kMmaWarps;
  const long long t0 = (it % tiles) * kTileT;
  __nv_bfloat16* fmb = reinterpret_cast<__nv_bfloat16*>(st);
  constexpr int kChunks = kFmLen / 8;  // 8 samples a chunk
  for (int q = threadIdx.x; q < kMmaWarps * kChunks; q += kMmaThreads) {
    const int w = q / kChunks, j = q % kChunks;
    const int c = c0 + w;
    if (c >= channels) continue;
    const long long p = t0 - kFmLead + 8LL * j;
    __nv_bfloat16* dst = fmb + w * kFmLen + 8 * j;
    if (p < -kCtx || p >= a.n) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const size_t src = p < 0 ? (size_t)c * kCtx + (size_t)(kCtx + p)
                             : (size_t)c * (size_t)a.n + (size_t)p;
    const void* base = p < 0 ? a.tail : a.fm;
    if constexpr (IN_BF16) {
      cp_async16(dst, static_cast<const __nv_bfloat16*>(base) + src);
    } else {
      const float4* s4 =
          reinterpret_cast<const float4*>(static_cast<const float*>(base) +
                                          src);
      const float4 u = s4[0], v = s4[1];
      __nv_bfloat162 r[4] = {__floats2bfloat162_rn(u.x, u.y),
                             __floats2bfloat162_rn(u.z, u.w),
                             __floats2bfloat162_rn(v.x, v.y),
                             __floats2bfloat162_rn(v.z, v.w)};
      memcpy(dst, r, 16);
    }
  }
  if constexpr (MIX) {
    float* rb = reinterpret_cast<float*>(st + kFmStage);
    constexpr int kRow = kTileT / 4;  // 4 floats a chunk
    for (int q = threadIdx.x; q < 4 * kRow; q += kMmaThreads) {
      const int r = q / kRow, j = 4 * (q % kRow);
      const float* tab = r == 0 ? a.cos_p : r == 1 ? a.sin_p
                         : r == 2 ? a.cos_r : a.sin_r;
      if (t0 + j < a.n)
        cp_async16(rb + r * kRampLen + ramp_at(j), tab + t0 + j);
    }
  }
}

// a lane's 4 outputs (offsets off[]) into a per-warp staging stream,
// padded 32 bytes every 32 outputs
template <bool BF16>
__device__ __forceinline__ void stage_vals(uint8_t* st, const int (&off)[4],
                                           const float (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = off[i] * (BF16 ? 2 : 4) + 32 * (off[i] >> 5);
    if constexpr (BF16)
      *reinterpret_cast<__nv_bfloat16*>(st + b) = __float2bfloat16_rn(v[i]);
    else
      *reinterpret_cast<float*>(st + b) = v[i];
  }
}

// 128 staged outputs to dst[e0 ...]: 16 bytes a lane where aligned
template <bool BF16>
__device__ __forceinline__ void store_stream(void* dst, size_t e0,
                                             const uint8_t* st, int lane) {
  constexpr int es = BF16 ? 2 : 4;
  constexpr int per16 = 16 / es;
  uint8_t* g = static_cast<uint8_t*>(dst) + e0 * es;
  if (((uintptr_t)g & 15) == 0) {
    if (lane < kWarpOut / per16) {
      const int p = lane * per16;
      *reinterpret_cast<uint4*>(g + p * es) =
          *reinterpret_cast<const uint4*>(st + p * es + 32 * (p >> 5));
    }
  } else {
    for (int p = lane; p < kWarpOut; p += 32)
      memcpy(g + p * es, st + p * es + 32 * (p >> 5), es);
  }
}

template <bool IN_BF16, bool OUT_BF16, bool MIX>
__global__ void __launch_bounds__(kMmaThreads, 3)
    ifbank_mma_kernel(const __grid_constant__ BankArgs a,
                      const uint4* __restrict__ taps, int channels,
                      long long tiles, long long items) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kStage = kFmStage + (MIX ? kRampStage : 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  __nv_bfloat16* sq =
      reinterpret_cast<__nv_bfloat16*>(smem + 2 * kStage) + warp * kSqLen;
  uint8_t* ost = smem + 2 * kStage + kMmaWarps * kSqLen * 2 +
                 warp * out_streams(MIX) * kOutStage;
  // the four Toeplitz tiles in registers, for the whole launch
  uint4 A[kFirs][kKs];
#pragma unroll
  for (int f = 0; f < kFirs; ++f)
#pragma unroll
    for (int k = 0; k < kKs; ++k) A[f][k] = taps[(f * kKs + k) * 32 + lane];
  // rds^2 past the tile: read with zero weight only, never written
  if (lane < kOver) sq[kRdsLead + kTileT + lane] = __float2bfloat16_rn(0.f);
  // accumulator i holds output off[i] of a 128-output tile: rows gq,
  // gq + 8 of columns 2tq, 2tq + 1
  const int off[4] = {32 * tq + gq, 32 * tq + 16 + gq, 32 * tq + 8 + gq,
                      32 * tq + 24 + gq};
  const long long nw = a.n / kWin;

  if ((long long)blockIdx.x < items)
    stage_item<IN_BF16, MIX>(a, channels, tiles, blockIdx.x, smem);
  cp_async_commit();
  int k = 0;
  for (long long it = blockIdx.x; it < items; it += gridDim.x, ++k) {
    // one barrier an item: past it, this item's window has landed for
    // every thread and every warp is done with the last item's stage,
    // which the next item then takes
    cp_async_wait<0>();
    __syncthreads();
    const long long next = it + gridDim.x;
    if (next < items)
      stage_item<IN_BF16, MIX>(a, channels, tiles, next,
                               smem + ((k + 1) & 1) * kStage);
    cp_async_commit();

    const int c = (int)(it / tiles) * kMmaWarps + warp;
    if (c >= channels) continue;
    const long long t0 = (it % tiles) * kTileT;
    const uint8_t* st = smem + (k & 1) * kStage;
    const __nv_bfloat16* fmw =
        reinterpret_cast<const __nv_bfloat16*>(st) + warp * kFmLen;
    const size_t row = (size_t)c * (size_t)a.n;

    // rds over [t0 - kRdsLead, t0 + kTileT): its square (rounded to bf16)
    // for the carrier, and the run itself to rdsch
#pragma unroll 1
    for (int j = 0; j <= kWarpTiles; ++j) {
      float r[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      fir_tiles<2, 1>(r, A, fmw, kWarpOut * j + kRdsCol + 16 * gq + 4 * tq);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sq[kWarpOut * j + off[i]] =
            __float2bfloat16_rn(__fmul_rn(r[0][i], r[0][i]));
      const long long q0 = t0 - kRdsLead + (long long)kWarpOut * j;
      if (j >= 1 && q0 < a.n) {
        stage_vals<OUT_BF16>(ost + kOutStage, off, r[0]);
        __syncwarp();
        store_stream<OUT_BF16>(a.rdsch, row + (size_t)q0, ost + kOutStage,
                               lane);
        __syncwarp();
      }
    }
    __syncwarp();

    // chan, pilot and the carrier over [t0, t0 + kTileT)
    float zs[4];
    const float* rp = reinterpret_cast<const float*>(st + kFmStage);
#pragma unroll 1
    for (int j = 0; j < kWarpTiles; ++j) {
      const long long m0 = t0 + (long long)kWarpOut * j;
      if (m0 >= a.n) break;   // n % 256 == 0: a tile is whole or absent
      float cp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float ca[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      fir_tiles<0, 2>(cp, A, fmw, kWarpOut * j + kFmCol + 16 * gq + 4 * tq);
      fir_tiles<3, 1>(ca, A, sq, kWarpOut * j + kSqCol + 16 * gq + 4 * tq);
      stage_vals<OUT_BF16>(ost, off, cp[0]);
      if constexpr (!MIX) {
        stage_vals<OUT_BF16>(ost + 2 * kOutStage, off, cp[1]);
        stage_vals<OUT_BF16>(ost + 3 * kOutStage, off, ca[0]);
      }
      __syncwarp();
      store_stream<OUT_BF16>(a.chan, row + (size_t)m0, ost, lane);
      if constexpr (!MIX) {
        store_stream<OUT_BF16>(a.pilot, row + (size_t)m0,
                               ost + 2 * kOutStage, lane);
        store_stream<OUT_BF16>(a.carr, row + (size_t)m0,
                               ost + 3 * kOutStage, lane);
      }
      __syncwarp();
      if constexpr (MIX) {
        // the lane's products in order, over the window's two tiles
        if ((j & 1) == 0) zs[0] = zs[1] = zs[2] = zs[3] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = ramp_at(kWarpOut * j + off[i]);
          zs[0] += __fmul_rn(cp[1][i], rp[p]);
          zs[1] += __fmul_rn(cp[1][i], -rp[kRampLen + p]);
          zs[2] += __fmul_rn(ca[0][i], rp[2 * kRampLen + p]);
          zs[3] += __fmul_rn(ca[0][i], -rp[3 * kRampLen + p]);
        }
        if (j & 1) {
          // then the warp's 32 lanes by a fixed butterfly that splits the
          // four sums between lane halves and quarters (6 shuffles):
          // lanes 0, 8, 16 and 24 end with zpr, zpi, zrr and zri
          const bool h16 = lane & 16, h8 = lane & 8;
          float a0 = h16 ? zs[2] : zs[0], a1 = h16 ? zs[3] : zs[1];
          a0 += __shfl_xor_sync(0xffffffffu, h16 ? zs[0] : zs[2], 16);
          a1 += __shfl_xor_sync(0xffffffffu, h16 ? zs[1] : zs[3], 16);
          float v = h8 ? a1 : a0;
          v += __shfl_xor_sync(0xffffffffu, h8 ? a0 : a1, 8);
#pragma unroll
          for (int s = 4; s > 0; s >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, s);
          if ((lane & 7) == 0) {
            float* z = lane == 0 ? a.zpr : lane == 8 ? a.zpi
                       : lane == 16 ? a.zrr : a.zri;
            z[(size_t)c * (size_t)nw + (size_t)((m0 - kWarpOut) / kWin)] = v;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <bool IN_BF16, bool OUT_BF16, bool MIX>
int launch_mma_t(const BankArgs& a, const uint4* taps, int channels,
                 cudaStream_t s) {
  auto kernel = ifbank_mma_kernel<IN_BF16, OUT_BF16, MIX>;
  const int smem = mma_smem_bytes(MIX);
  if (cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads,
                                                smem);
  const long long tiles = (a.n + kTileT - 1) / kTileT;
  const long long items = tiles * ((channels + kMmaWarps - 1) / kMmaWarps);
  const long long grid =
      std::min(items, (long long)std::max(1, sms * std::max(1, per_sm)));
  kernel<<<(unsigned)grid, kMmaThreads, smem, s>>>(a, taps, channels, tiles,
                                                   items);
  return (int)cudaGetLastError();
}

template <bool MIX>
int launch_mma(bool fm_bf16, bool out_bf16, const BankArgs& a,
               const void* taps, int channels, cudaStream_t s) {
  const uint4* t = static_cast<const uint4*>(taps);
  if (fm_bf16) {
    if (out_bf16) return launch_mma_t<true, true, MIX>(a, t, channels, s);
    return launch_mma_t<true, false, MIX>(a, t, channels, s);
  }
  if (out_bf16) return launch_mma_t<false, true, MIX>(a, t, channels, s);
  return launch_mma_t<false, false, MIX>(a, t, channels, s);
}

template <bool IN_BF16, bool MIX>
void launch_out(bool out_bf16, dim3 grid, cudaStream_t s, const BankArgs& a,
                const BankTaps& h) {
  if (out_bf16)
    ifbank_kernel<IN_BF16, true, MIX><<<grid, kThreads, 0, s>>>(a, h);
  else
    ifbank_kernel<IN_BF16, false, MIX><<<grid, kThreads, 0, s>>>(a, h);
}

// the float32 engine on the CUDA cores, or the bf16 engine on the tensor
// cores (taps: the host float taps, or the wrapper's device buffer)
template <bool MIX>
int launch(bool fm_bf16, bool bf16_compute, bool out_bf16, int channels,
           const void* taps, cudaStream_t s, const BankArgs& a) {
  if (bf16_compute) return launch_mma<MIX>(fm_bf16, out_bf16, a, taps,
                                           channels, s);
  BankTaps h;
  memcpy(&h, taps, sizeof(h));
  const dim3 grid((unsigned)((a.n + kTile - 1) / kTile), (unsigned)channels);
  if (fm_bf16) launch_out<true, MIX>(out_bf16, grid, s, a, h);
  else launch_out<false, MIX>(out_bf16, grid, s, a, h);
  return (int)cudaGetLastError();
}

// the arguments both entry points share; false if the kernel refuses them
bool bank_setup(const void* fm, const void* tail, int channels, long long n,
                int ntaps, void* chan, void* rdsch, BankArgs* a) {
  if (channels < 1 || channels > 65535 || ntaps != kTaps || n < kWin ||
      n % kWin != 0)
    return false;
  *a = BankArgs{};
  a->fm = fm;
  a->tail = tail;
  a->chan = chan;
  a->rdsch = rdsch;
  a->n = n;
  return true;
}

}  // namespace

extern "C" {

// taps: for the float32 engine the host's float32 [4][51] (chan, pilot,
// rds, carrier); for the bf16 engine the wrapper's device buffer of the
// four Toeplitz tiles of the bf16-rounded taps in A-fragment order
// ([4][5][32] uint4).  n must be a multiple of 256.
int sdr_ifbank_mix(const void* fm, const void* tail, int fm_bf16,
                   int channels, long long n, const float* taps, int ntaps,
                   int bf16_compute, const void* cos_p, const void* sin_p,
                   const void* cos_r, const void* sin_r, void* chan,
                   void* rdsch, int out_bf16, void* zpr, void* zpi,
                   void* zrr, void* zri, void* stream) {
  BankArgs a;
  if (!bank_setup(fm, tail, channels, n, ntaps, chan, rdsch, &a))
    return (int)cudaErrorInvalidValue;
  a.cos_p = static_cast<const float*>(cos_p);
  a.sin_p = static_cast<const float*>(sin_p);
  a.cos_r = static_cast<const float*>(cos_r);
  a.sin_r = static_cast<const float*>(sin_r);
  a.zpr = static_cast<float*>(zpr);
  a.zpi = static_cast<float*>(zpi);
  a.zrr = static_cast<float*>(zrr);
  a.zri = static_cast<float*>(zri);
  return launch<true>(fm_bf16 != 0, bf16_compute != 0, out_bf16 != 0,
                      channels, taps, static_cast<cudaStream_t>(stream), a);
}

// The four streams chan, pilot, rdsch, carr (C, n) in the output dtype;
// taps and n as for sdr_ifbank_mix.
int sdr_ifbank(const void* fm, const void* tail, int fm_bf16, int channels,
               long long n, const float* taps, int ntaps, int bf16_compute,
               void* chan, void* pilot, void* rdsch, void* carr, int out_bf16,
               void* stream) {
  BankArgs a;
  if (!bank_setup(fm, tail, channels, n, ntaps, chan, rdsch, &a))
    return (int)cudaErrorInvalidValue;
  a.pilot = pilot;
  a.carr = carr;
  return launch<false>(fm_bf16 != 0, bf16_compute != 0, out_bf16 != 0,
                       channels, taps, static_cast<cudaStream_t>(stream), a);
}

}  // extern "C"
