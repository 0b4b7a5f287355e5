// Fused RF front end for Hopper (sm_90a): u8 IQ decode + 51-tap LPF +
// decimation, with or without the FM discriminator.
//
// Replaces the Pallas kernels sdr_tpu/ops/pallas/frontend_kernel.py
// `_frontend_kernel` (decimated I/Q out) and `_frontend_demod_kernel`
// (fm_demod + last I/Q + sum(I^2+Q^2) out).  What each computes, per
// station row c of the (C, n) interleaved u8 block and its carried
// (C, 128) u8 tail (tail ++ block is the stream):
//
//   x = u8 - 128 (int8),  I[m] = sum_k h[k] x[2(mD - k)],
//                         Q[m] = sum_k h[k] x[2(mD - k) + 1]
//   fm[m] = (I*(Q - Q[m-1]) - Q*(I - I[m-1])) / (I^2 + Q^2), 0 where the
//           power is 0; I[-1], Q[-1] come from the carried state.
//
// Coefficient engines (E), all as in the reference:
//   F32    taps h/128 in float32, float32 products and sums;
//   BF16   the same taps rounded to bf16 (the int8 decode is exact in bf16,
//          so every product is exact in float32: only the sum order can
//          differ from the reference);
//   INT8   one int8 limb, int32 accumulation, float(acc) * scale;
//   INT8X2 two int8 limbs of 15-bit fixed point, acc_hi*128 + acc_lo in
//          int32 (exact integers, so bit-identical under any schedule),
//          float(acc) * scale.
//
// What bounds it on the card: per IF sample it reads 2D = 20 bytes of u8
// and writes 2-8 bytes, against 2 x 51 multiply-adds: 0.2152 ms of HBM
// traffic for the int8 demod kernel at 128 stations x 5.12 MB (bf16 fm)
// against ~0.02 ms of int8 tensor-core work, so the bytes.  The earlier
// dp4a design (I/Q planes, one output a thread) took 0.4835 ms.  Kernel-only probes that knock out one phase at a
// time (tools/probe_frontend.py; NVIDIA H100 80GB HBM3, 700 W) put its
// time in two places, neither of which overlapped the other: without the
// FIR (28 LDS.32 an output, 2-way bank conflicts at the 10-byte stride) it
// took 0.3423 ms, without the staging 0.3978 ms; the discriminator
// (0.4858 without it) and the stores (0.4706) cost little.
//
// The integer engines' design (frontend_mma_kernel):
//   - the FIR is a small matrix product on the tensor cores,
//     mma.sync.m16n8k32 s8 x s8 -> s32.  A is the Toeplitz tile of the
//     reversed taps for 16 consecutive outputs: row r holds h[rD + 56 - kk]
//     at column kk, so its depth is K = 15D + 57 rounded up to 32 (224 for
//     D = 10, 192 for D = 9, 128 for D = 4).  The wrapper builds it once
//     with numpy (ops/cuda/frontend_kernel.py `toeplitz_tile`, packed in
//     the A fragments' order) and the kernel keeps it in registers (the
//     k-step count a template parameter); int8x2 runs its high and low
//     limbs as two A tiles against the same B and sums acc_hi*128 + acc_lo
//     in int32.  int8 splits its k-steps into two chains of products
//     (even, odd) summed at the end: integers, so the same bits;
//   - B is 8 columns of the stream, 8 consecutive 16-output segments.  A
//     column starts 56 samples before its first output (50 taps of reach
//     and 6 of phase), a 16-byte boundary of the raw bytes for any D.  A
//     lane's two B registers of a k-step are 8 consecutive samples, 16
//     interleaved raw bytes: one 16-byte shared load without bank
//     conflicts, split by __byte_perm (0x6420 / 0x7531) and ^ 0x80808080
//     into I and Q words (A is packed in the k order that this gives).  I
//     and Q are two products against the same A, so each lane holds
//     matching I and Q of 4 outputs.  There is no de-interleave pass;
//   - persistent blocks of 4 warps walk spans of 16 tiles of a station row;
//     a tile is 512 outputs (128 a warp).  The raw bytes of tile i arrive
//     by cp.async in a ring of 4 slots, 2 tiles ahead of the tile being
//     computed, so HBM reads overlap the products and the epilogue, with
//     one barrier a tile.  The FIR's reach into the past is read from the
//     previous slot (tile i-1 stays in the ring until tile i+3 is requested),
//     and slot 0 has an 80-sample guard in front of it, loaded with the
//     samples before its tile, which also serves the span's first tile (at
//     the row's start: the carried tail);
//   - the discriminator runs on the accumulators: the previous sample of
//     each output comes from a shuffle (lane g-1, or lane (7, t) for the
//     segment's first rows), and each warp's first output's predecessor is
//     one halo output that the warp computes itself from the ring with the
//     combined integer taps (a warp-wide __reduce_add_sync: the same
//     integer as the tensor cores' sum);
//   - the power sum: each thread sums its outputs in order across its
//     span, then a fixed warp tree and the 4 warps in order give one
//     partial a span, and power_sum_kernel adds a station's partials in a
//     fixed order: no atomics, the same bits every run;
//   - outputs leave through a per-warp shared buffer as 16-byte stores
//     where the row allows it (padded so that the accumulators' scattered
//     writes hit 32 distinct banks).
// The same probes on this design (PERF.md section 6): 0.3219 ms in all,
// 0.2086 without the staging, 0.3116 without the FIR, 0.3170 without the
// discriminator, 0.3059 without the stores.  The compute side alone now
// takes about the byte bound, and the HBM reads overlap it only in part.
// B2 (`sdr_frontend_iq`) runs on the same body with I and Q stored.
//
// The float engines (F32, BF16) stay on the CUDA cores (frontend_kernel):
// TF32 would miss their 1e-5 gate.  One block of 256 threads per (station,
// run of outputs) stages its window as I and Q planes and each thread
// computes one output by 51 FMAs, taps from the constant bank.
//
// The discriminator uses the _rn intrinsics so no FMA contraction changes
// its rounding: it matches the plain PyTorch version bit for bit given the
// same I/Q.  Build without --use_fast_math (the division must be IEEE).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

constexpr int kTail = 128;  // carried u8 tail per station (bytes)
constexpr int kTaps = 51;   // rf_taps of every mode (config.py)
constexpr int kVec = 16;    // bytes per staging load

enum Engine { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt8x2 = 3 };
enum Out { kOutIQ = 0, kOutF32 = 1, kOutBF16 = 2 };

struct Geometry {
  const uint8_t* body;  // (C, n) u8
  const uint8_t* tail;  // (C, kTail) u8
  long long n;          // bytes per station in this block
  long long n_out;      // IF samples per station: n / (2 * decim)
  int decim;
  float scale;          // integer engines: float32(fix_scale / 128)
  int aligned;          // body, tail and n allow 16-byte loads
};

struct Outputs {
  float* i;               // (C, n_out)  I/Q kernel
  float* q;
  const float* prev_i;    // (C,)  demod kernel: I[-1], Q[-1]
  const float* prev_q;
  void* fm;               // (C, n_out) float32 or bf16
  float* last_i;          // (C,)
  float* last_q;
  float* partials;        // (C, stride) per-block or per-span sums of I^2+Q^2
  int stride;             // partials per station row
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    if (lane < (int)(blockDim.x >> 5)) v = scratch[lane];
    v = warp_sum(v);
  }
  return v;  // valid in thread 0
}

// The discriminator of one output from its I/Q and its predecessor's.
__device__ __forceinline__ float discriminate(float I, float Q, float ip,
                                              float qp, float& den) {
  const float num = __fsub_rn(__fmul_rn(I, __fsub_rn(Q, qp)),
                              __fmul_rn(Q, __fsub_rn(I, ip)));
  den = __fadd_rn(__fmul_rn(I, I), __fmul_rn(Q, Q));
  return den == 0.f ? 0.f : __fdiv_rn(num, den);
}

// ============================================================ float engines
constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;  // staging loads per thread, all in flight
constexpr int kMaxWindow = kThreads * kVecPerThread * kVec;  // bytes

struct Taps {
  float f[kTaps];  // F32 / BF16 (bf16 values, widened exactly)
};

// Stage stream bytes [ws, we) of station c (negative positions fall in the
// carried tail) into shared memory as two planes, I and Q, decoded to
// int8: x ^ 0x80 == x - 128.  Plane index p holds IF-rate sample ws/2 + p.
// Every load is issued before the first store, so a block waits for one
// round trip to device memory, not one per load.
__device__ __forceinline__ void stage(const Geometry& g, int c, long long ws,
                                      long long we, int8_t* pi, int8_t* pq) {
  const uint8_t* row = g.body + (size_t)c * (size_t)g.n;
  const uint8_t* trow = g.tail + (size_t)c * kTail;
  const int nbytes = (int)(we - ws);
  if (g.aligned) {
    // ws is a multiple of 16 and n % 16 == 0, so no vector straddles the
    // tail/body seam or the end of the row
    const int nvec = (nbytes + kVec - 1) / kVec;
    uint4 v[kVecPerThread];
#pragma unroll
    for (int j = 0; j < kVecPerThread; ++j) {
      const int w = threadIdx.x + j * kThreads;
      const long long pos = ws + (long long)kVec * w;
      if (w < nvec)
        v[j] = pos < 0 ? *reinterpret_cast<const uint4*>(trow + kTail + pos)
                       : __ldg(reinterpret_cast<const uint4*>(row + pos));
    }
#pragma unroll
    for (int j = 0; j < kVecPerThread; ++j) {
      const int w = threadIdx.x + j * kThreads;
      if (w < nvec) {
        // 8 interleaved (I, Q) byte pairs -> 8 I bytes and 8 Q bytes
        const uint4 x = v[j];
        const uint32_t m = 0x80808080u;
        reinterpret_cast<uint2*>(pi)[w] =
            make_uint2(__byte_perm(x.x, x.y, 0x6420) ^ m,
                       __byte_perm(x.z, x.w, 0x6420) ^ m);
        reinterpret_cast<uint2*>(pq)[w] =
            make_uint2(__byte_perm(x.x, x.y, 0x7531) ^ m,
                       __byte_perm(x.z, x.w, 0x7531) ^ m);
      }
    }
  } else {
    for (int i = threadIdx.x; i < nbytes; i += kThreads) {
      const long long pos = ws + i;
      const uint8_t v = pos < 0 ? trow[kTail + pos] : row[pos];
      ((i & 1) ? pq : pi)[i >> 1] = (int8_t)(v ^ 0x80);
    }
  }
}

// Bytes of one shared-memory plane: the samples of kThreads consecutive
// outputs, the FIR's reach and the 16-byte alignment of the window.
__host__ __device__ constexpr int plane_bytes(int decim) {
  return (kThreads * decim + kTaps + 16 + 15) & ~15;
}

// Outputs per block: the demod kernel spends its first thread on the halo.
template <bool DEMOD>
__host__ __device__ constexpr int outputs_per_block() {
  return DEMOD ? kThreads - 1 : kThreads;
}

template <bool DEMOD, bool BF16_OUT>
__global__ void __launch_bounds__(kThreads)
    frontend_kernel(const __grid_constant__ Geometry g,
                    const __grid_constant__ Taps taps,
                    const __grid_constant__ Outputs o) {
  extern __shared__ __align__(16) int8_t win[];
  int8_t* pi = win;
  int8_t* pq = win + plane_bytes(g.decim);
  constexpr int P = outputs_per_block<DEMOD>();
  const int c = blockIdx.y;
  const long long m0 = (long long)blockIdx.x * P;  // first output owned
  const long long m_lo = (DEMOD && m0 > 0) ? m0 - 1 : m0;  // first computed
  const long long m_hi = min(m0 + P, g.n_out);      // one past the last
  long long ws = 2 * (m_lo * g.decim - (kTaps - 1));  // >= -2*(taps-1)
  ws -= ((ws % kVec) + kVec) % kVec;                  // >= -kTail
  const long long we = 2 * (m_hi - 1) * g.decim + 2;
  stage(g, c, ws, we, pi, pq);
  __syncthreads();

  const long long m = (DEMOD ? m0 - 1 : m0) + threadIdx.x;
  const bool valid = m >= m_lo && m < m_hi;
  float I = 0.f, Q = 0.f;
  if (valid) {
    // plane index s + kTaps - 1 - k holds the sample of tap k
    const int s = (int)(m * g.decim - (kTaps - 1) - ws / 2);
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const int p = s + kTaps - 1 - k;
      I = fmaf((float)pi[p], taps.f[k], I);
      Q = fmaf((float)pq[p], taps.f[k], Q);
    }
  }
  const size_t row = (size_t)c * (size_t)g.n_out;
  if constexpr (!DEMOD) {
    if (valid) {
      o.i[row + m] = I;
      o.q[row + m] = Q;
    }
  } else {
    __shared__ float s_i[kThreads], s_q[kThreads], s_red[kThreads / 32];
    if (threadIdx.x == 0 && m0 == 0) {
      I = o.prev_i[c];
      Q = o.prev_q[c];
    }
    s_i[threadIdx.x] = I;
    s_q[threadIdx.x] = Q;
    __syncthreads();
    float den = 0.f;
    if (threadIdx.x > 0 && valid) {
      const float fm = discriminate(I, Q, s_i[threadIdx.x - 1],
                                    s_q[threadIdx.x - 1], den);
      if constexpr (BF16_OUT)
        static_cast<__nv_bfloat16*>(o.fm)[row + m] = __float2bfloat16_rn(fm);
      else
        static_cast<float*>(o.fm)[row + m] = fm;
      if (m == g.n_out - 1) {
        o.last_i[c] = I;
        o.last_q[c] = Q;
      }
    }
    const float s = block_sum(den, s_red);
    if (threadIdx.x == 0)
      o.partials[(size_t)c * o.stride + blockIdx.x] = s;
  }
}

// ===================================================== tensor-core engines
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kWarpOut = 128;                  // 8 columns x 16 rows
constexpr int kTileOut = kMmaWarps * kWarpOut;  // outputs of a tile
constexpr int kSlots = 4;                      // ring slots
constexpr int kAhead = 2;                      // tiles in flight ahead
constexpr int kSpanTiles = 16;                 // tiles of a span
constexpr int kGuard = 80;    // samples in front of slot 0 (>= D + 50)
constexpr int kPhase = 6;     // A's column shift
constexpr int kReach = kTaps - 1 + kPhase;     // a column starts 56 before
constexpr int kMaxMmaDecim = 16;
constexpr int kMaxKs = (15 * kMaxMmaDecim + kReach + 1 + 31) / 32;  // 10
constexpr int kRingPad = 128;  // bytes past the last slot: the last
                               // columns' zero-weighted over-read
constexpr int kHaloWords = 64;  // combined integer taps in the tap buffer
// per-warp output staging: 128 outputs, 32 bytes of padding per 32
constexpr int kStageBytes = 2 * (kWarpOut * 4 + 4 * 32);

__host__ __device__ constexpr int mma_ksteps(int decim) {
  return (15 * decim + kReach + 1 + 31) / 32;
}

struct MmaTaps {
  const int* halo;   // (kHaloWords,) combined integer taps h[0..50]
  const uint4* hi;   // (ks, 32) A fragments: INT8 taps or high limbs
  const uint4* lo;   // (ks, 32) low limbs (INT8X2)
  int ks;
};

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Stream samples [s0 - (guard ? kGuard : 0), s0 + ts) of station c, as raw
// interleaved bytes, into the ring at the slot's place (the guard, when
// asked, lands in front of slot 0).  Samples before the carried tail or
// past the row's end are not loaded: no kept output reads them.
__device__ __forceinline__ void load_tile(const Geometry& g, int c,
                                           long long s0, int ts, int slot,
                                           uint8_t* ring) {
  const uint8_t* row = g.body + (size_t)c * (size_t)g.n;
  const uint8_t* trow = g.tail + (size_t)c * kTail;
  const bool guard = slot == 0;
  const long long b_lo = 2 * (s0 - (guard ? kGuard : 0));
  const long long b_hi = min(2 * (s0 + ts), g.n);
  uint8_t* dst = ring + (guard ? 0 : 2 * (kGuard + slot * ts));
  if (g.aligned) {
    // b_lo is a multiple of 16 (s0 a multiple of 8 samples, kGuard = 80),
    // and so is n: no chunk straddles the seam or the row's end
    for (long long b = b_lo + kVec * threadIdx.x; b < b_hi;
         b += kVec * kMmaThreads)
      if (b >= -kTail)
        cp_async16(dst + (b - b_lo),
                   b < 0 ? trow + kTail + b : row + b);
  } else {
    for (long long b = b_lo + threadIdx.x; b < b_hi; b += kMmaThreads)
      if (b >= -kTail) dst[b - b_lo] = b < 0 ? trow[kTail + b] : row[b];
  }
}

// int8 sample (I: q = 0, Q: q = 1) at ring sample position p
__device__ __forceinline__ int ring_x(const uint8_t* ring, int p, int q) {
  return (int)(int8_t)(ring[2 * p + q] ^ 0x80);
}

// KS: the k-steps the A tile takes in registers (the modes' D = 4, 9, 10
// take 4, 6 and 7; other D up to 16 the general kMaxKs, with the steps past
// taps.ks skipped)
template <int E, int OUT, int KS>
__global__ void __launch_bounds__(kMmaThreads, 4)
    frontend_mma_kernel(const __grid_constant__ Geometry g,
                        const __grid_constant__ MmaTaps taps,
                        const __grid_constant__ Outputs o,
                        long long spans_per_row, long long total_spans) {
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ __align__(16) uint8_t stage_buf[kMmaWarps][kStageBytes];
  __shared__ float s_red[kMmaWarps];
  constexpr bool X2 = E == kInt8x2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;  // the fragments' group, thread
  const int D = g.decim;
  const int ts = kTileOut * D;              // samples of a slot
  const int ks_n = taps.ks;
  const long long n_out = g.n_out;
  const long long n_tiles = (n_out + kTileOut - 1) / kTileOut;

  // A in registers, for the whole launch
  uint4 a_hi[KS], a_lo[X2 ? KS : 1];
#pragma unroll
  for (int k = 0; k < KS; ++k)
    if (k < ks_n) {
      a_hi[k] = taps.hi[k * 32 + lane];
      if constexpr (X2) a_lo[k] = taps.lo[k * 32 + lane];
    }
  // the halo's taps: lane l holds h[l] and h[l + 32]
  const int h0 = taps.halo[lane], h1 = taps.halo[lane + 32];
  uint8_t* stg = stage_buf[warp];

  for (long long sp = blockIdx.x; sp < total_spans; sp += gridDim.x) {
    const int c = (int)(sp / spans_per_row);
    const long long t_lo = (sp % spans_per_row) * kSpanTiles;
    const int nt = (int)min((long long)kSpanTiles, n_tiles - t_lo);
    const size_t orow = (size_t)c * (size_t)n_out;
    float pw = 0.f;
    __syncthreads();  // the last span's readers are done with the ring
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (a < nt)
        load_tile(g, c, (t_lo + a) * kTileOut * D, ts, a, ring);
      cp_async_commit();
    }
    for (int i = 0; i < nt; ++i) {
      // one barrier a tile: past it, tile i has landed for every thread
      // and every warp has computed tile i-1, the last reader of slot i-2,
      // which tile i+2 then takes
      cp_async_wait<kAhead - 1>();
      __syncthreads();
      if (i + kAhead < nt)
        load_tile(g, c, (t_lo + i + kAhead) * kTileOut * D, ts,
                   (i + kAhead) % kSlots, ring);
      cp_async_commit();

      const long long m0w = (t_lo + i) * kTileOut + warp * kWarpOut;
      if (m0w >= n_out) continue;
      const int slot = i % kSlots;
      // ring sample position of this warp's first output's sample
      const int rpw = kGuard + slot * ts + warp * kWarpOut * D;
      // --- the FIR: column gq starts kReach samples before its first
      // output; lane (gq, tq) loads its rows of each k-step, 8 samples in
      // one 16-byte load (the k order that A is packed in)
      const uint8_t* colp = ring + 2 * (rpw + 16 * gq * D - kReach) + 16 * tq;
      int ai[4] = {0, 0, 0, 0}, aq[4] = {0, 0, 0, 0};
      int bi[4] = {0, 0, 0, 0}, bq[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < KS; ++k)
        if (k < ks_n) {
          const uint4 v = *reinterpret_cast<const uint4*>(colp + 64 * k);
          const uint32_t m = 0x80808080u;
          const uint32_t xi0 = __byte_perm(v.x, v.y, 0x6420) ^ m;
          const uint32_t xq0 = __byte_perm(v.x, v.y, 0x7531) ^ m;
          const uint32_t xi1 = __byte_perm(v.z, v.w, 0x6420) ^ m;
          const uint32_t xq1 = __byte_perm(v.z, v.w, 0x7531) ^ m;
          if constexpr (X2) {
            mma_s8(ai, a_hi[k], xi0, xi1);
            mma_s8(aq, a_hi[k], xq0, xq1);
            mma_s8(bi, a_lo[k], xi0, xi1);
            mma_s8(bq, a_lo[k], xq0, xq1);
          } else if (k & 1) {  // two chains of products, summed at the end
            mma_s8(bi, a_hi[k], xi0, xi1);
            mma_s8(bq, a_hi[k], xq0, xq1);
          } else {
            mma_s8(ai, a_hi[k], xi0, xi1);
            mma_s8(aq, a_hi[k], xq0, xq1);
          }
        }
      // accumulator j holds output m0w + off[j]: rows gq, gq + 8 of
      // columns 2tq, 2tq + 1
      const int off[4] = {32 * tq + gq, 32 * tq + 16 + gq, 32 * tq + 8 + gq,
                          32 * tq + 24 + gq};
      float I[4], Q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int vi = X2 ? ai[j] * 128 + bi[j] : ai[j] + bi[j];
        const int vq = X2 ? aq[j] * 128 + bq[j] : aq[j] + bq[j];
        I[j] = __fmul_rn(__int2float_rn(vi), g.scale);
        Q[j] = __fmul_rn(__int2float_rn(vq), g.scale);
      }
      const long long n_valid = min((long long)kWarpOut, n_out - m0w);
      // staged byte offset of output p: p*es + 32*(p/32)
      if constexpr (OUT == kOutIQ) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int b = off[j] * 4 + 32 * (off[j] >> 5);
          *reinterpret_cast<float*>(stg + b) = I[j];
          *reinterpret_cast<float*>(stg + kStageBytes / 2 + b) = Q[j];
        }
      } else {
        // predecessors: lane (gq-1, tq), or for gq = 0 the segment's rows
        // 7 / 15 in lane (7, tq) (and (7, tq-1) for row 0)
        const int src0 = gq ? lane - 4 : ((28 + tq - 1) & 31);
        const int src = gq ? lane - 4 : 28 + tq;
        const bool top = gq == 7;
        float pi[4], pq[4];
        pi[0] = __shfl_sync(0xffffffffu, top ? I[3] : I[0], src0);
        pq[0] = __shfl_sync(0xffffffffu, top ? Q[3] : Q[0], src0);
        pi[1] = __shfl_sync(0xffffffffu, top ? I[2] : I[1], src);
        pq[1] = __shfl_sync(0xffffffffu, top ? Q[2] : Q[1], src);
        pi[2] = __shfl_sync(0xffffffffu, top ? I[0] : I[2], src);
        pq[2] = __shfl_sync(0xffffffffu, top ? Q[0] : Q[2], src);
        pi[3] = __shfl_sync(0xffffffffu, top ? I[1] : I[3], src);
        pq[3] = __shfl_sync(0xffffffffu, top ? Q[1] : Q[3], src);
        // the halo: output m0w - 1, from the ring (the previous slot, or
        // slot 0's guard), or the carried I[-1], Q[-1] at the row's start
        float hi_f, hq_f;
        if (m0w == 0) {
          hi_f = o.prev_i[c];
          hq_f = o.prev_q[c];
        } else {
          const int p = rpw - D;  // sample of output m0w - 1, tap 0
          int vi = h0 * ring_x(ring, p - lane, 0);
          int vq = h0 * ring_x(ring, p - lane, 1);
          if (lane + 32 < kTaps) {
            vi += h1 * ring_x(ring, p - lane - 32, 0);
            vq += h1 * ring_x(ring, p - lane - 32, 1);
          }
          vi = __reduce_add_sync(0xffffffffu, vi);
          vq = __reduce_add_sync(0xffffffffu, vq);
          hi_f = __fmul_rn(__int2float_rn(vi), g.scale);
          hq_f = __fmul_rn(__int2float_rn(vq), g.scale);
        }
        if (lane == 0) {
          pi[0] = hi_f;
          pq[0] = hq_f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float den;
          const float fm = discriminate(I[j], Q[j], pi[j], pq[j], den);
          if (off[j] < n_valid) {
            pw += den;
            if (m0w + off[j] == n_out - 1) {
              o.last_i[c] = I[j];
              o.last_q[c] = Q[j];
            }
          }
          if constexpr (OUT == kOutBF16)
            *reinterpret_cast<__nv_bfloat16*>(
                stg + off[j] * 2 + 32 * (off[j] >> 5)) =
                __float2bfloat16_rn(fm);
          else
            *reinterpret_cast<float*>(stg + off[j] * 4 +
                                      32 * (off[j] >> 5)) = fm;
        }
      }
      __syncwarp();
      // --- the stores: 16 bytes a lane where the row allows it
      constexpr int es = OUT == kOutBF16 ? 2 : 4;
      constexpr int per16 = 16 / es;  // outputs of a 16-byte chunk
      void* dsts[2] = {OUT == kOutIQ ? (void*)o.i : o.fm, (void*)o.q};
#pragma unroll
      for (int a = 0; a < (OUT == kOutIQ ? 2 : 1); ++a) {
        uint8_t* gdst = static_cast<uint8_t*>(dsts[a]) + (orow + m0w) * es;
        const uint8_t* src_b = stg + a * (kStageBytes / 2);
        if (n_valid == kWarpOut && ((uintptr_t)gdst % 16) == 0) {
          if (lane < kWarpOut / per16) {
            const int p = lane * per16;
            *reinterpret_cast<uint4*>(gdst + p * es) =
                *reinterpret_cast<const uint4*>(src_b + p * es +
                                                32 * (p >> 5));
          }
        } else {
          for (int p = lane; p < n_valid; p += 32) {
            if constexpr (es == 2)
              reinterpret_cast<uint16_t*>(gdst)[p] =
                  *reinterpret_cast<const uint16_t*>(src_b + p * 2 +
                                                     32 * (p >> 5));
            else
              reinterpret_cast<float*>(gdst)[p] =
                  *reinterpret_cast<const float*>(src_b + p * 4 +
                                                  32 * (p >> 5));
          }
        }
      }
      __syncwarp();
    }
    cp_async_wait<0>();
    if constexpr (OUT != kOutIQ) {
      // the span's partial: each thread's sum in order, a fixed warp
      // tree, then the warps in order
      pw = warp_sum(pw);
      if (lane == 0) s_red[warp] = pw;
      __syncthreads();
      if (threadIdx.x == 0) {
        float s = 0.f;
        for (int w = 0; w < kMmaWarps; ++w) s += s_red[w];
        o.partials[(size_t)c * o.stride + (size_t)(sp % spans_per_row)] = s;
      }
    }
  }
}

// Second pass of the demod kernel: power[c] = sum of the station's
// `count` partials (row stride `stride`), in a fixed order.
__global__ void __launch_bounds__(kThreads)
    power_sum_kernel(const float* partials, int stride, int count,
                     float* power) {
  __shared__ float s_red[kThreads / 32];
  const float* row = partials + (size_t)blockIdx.x * stride;
  float v = 0.f;
  for (int j = threadIdx.x; j < count; j += blockDim.x) v += row[j];
  v = block_sum(v, s_red);
  if (threadIdx.x == 0) power[blockIdx.x] = v;
}

// ================================================================= host
int smem_bytes(int decim) { return 2 * plane_bytes(decim); }

int mma_smem_bytes(int decim) {
  return 2 * (kGuard + kSlots * kTileOut * decim) + kRingPad;
}

bool is_mma(int engine) { return engine == kInt8 || engine == kInt8x2; }

bool geometry(const void* body, const void* tail, long long n, int decim,
              int engine, float scale, Geometry* g) {
  if (decim < 1 || n < 2LL * decim) return false;
  if (is_mma(engine) ? decim > kMaxMmaDecim : smem_bytes(decim) > kMaxWindow)
    return false;
  g->body = static_cast<const uint8_t*>(body);
  g->tail = static_cast<const uint8_t*>(tail);
  g->n = n;
  g->n_out = n / (2LL * decim);
  g->decim = decim;
  g->scale = scale;
  g->aligned = ((uintptr_t)body % kVec == 0) &&
               ((uintptr_t)tail % kVec == 0) && (n % kVec == 0);
  return true;
}

// Float engines: the host tap array is float32[51] or bf16 bits uint16[51].
int make_taps(int engine, const void* src, int ntaps, Taps* t) {
  if (ntaps != kTaps) return (int)cudaErrorInvalidValue;
  memset(t, 0, sizeof(Taps));
  if (engine == kF32) {
    memcpy(t->f, src, sizeof(t->f));
  } else if (engine == kBF16) {
    for (int k = 0; k < kTaps; ++k) {
      const uint32_t bits =
          (uint32_t) static_cast<const uint16_t*>(src)[k] << 16;
      memcpy(&t->f[k], &bits, sizeof(float));
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Integer engines: src is the wrapper's device buffer of int32 words:
// kHaloWords combined taps, then ks x 32 uint4 A fragments (the INT8 taps
// or the high limbs), then for INT8X2 the low limbs' fragments.
MmaTaps mma_taps(int engine, const void* src, int decim) {
  MmaTaps t;
  const int* w = static_cast<const int*>(src);
  t.ks = mma_ksteps(decim);
  t.halo = w;
  t.hi = reinterpret_cast<const uint4*>(w + kHaloWords);
  t.lo = engine == kInt8x2 ? t.hi + t.ks * 32 : t.hi;
  return t;
}

template <int E, int OUT, int KS>
int launch_mma_ks(const Geometry& g, const MmaTaps& t, const Outputs& o,
                  int channels, cudaStream_t s) {
  auto kernel = frontend_mma_kernel<E, OUT, KS>;
  const int smem = mma_smem_bytes(g.decim);
  if (cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads,
                                                smem);
  const long long n_tiles = (g.n_out + kTileOut - 1) / kTileOut;
  const long long spans = (n_tiles + kSpanTiles - 1) / kSpanTiles;
  const long long total = spans * channels;
  const long long grid =
      std::min(total, (long long)std::max(1, sms * std::max(1, per_sm)));
  kernel<<<(unsigned)grid, kMmaThreads, smem, s>>>(g, t, o, spans, total);
  return (int)cudaGetLastError();
}

template <int E, int OUT>
int launch_mma_t(const Geometry& g, const MmaTaps& t, const Outputs& o,
                 int channels, cudaStream_t s) {
  switch (t.ks) {
    case 4: return launch_mma_ks<E, OUT, 4>(g, t, o, channels, s);
    case 6: return launch_mma_ks<E, OUT, 6>(g, t, o, channels, s);
    case 7: return launch_mma_ks<E, OUT, 7>(g, t, o, channels, s);
    default: return launch_mma_ks<E, OUT, kMaxKs>(g, t, o, channels, s);
  }
}

int launch_mma(int engine, int out, const Geometry& g, const MmaTaps& t,
               const Outputs& o, int channels, cudaStream_t s) {
#define SDR_MMA(E, O) return launch_mma_t<E, O>(g, t, o, channels, s)
  if (engine == kInt8) {
    if (out == kOutIQ) SDR_MMA(kInt8, kOutIQ);
    if (out == kOutF32) SDR_MMA(kInt8, kOutF32);
    SDR_MMA(kInt8, kOutBF16);
  }
  if (out == kOutIQ) SDR_MMA(kInt8x2, kOutIQ);
  if (out == kOutF32) SDR_MMA(kInt8x2, kOutF32);
  SDR_MMA(kInt8x2, kOutBF16);
#undef SDR_MMA
}

}  // namespace

extern "C" {

// Per-station partial power sums the demod kernel may write: the row
// stride of its `partials` scratch (the float engines write one a block,
// the integer engines one a span, fewer).
long long sdr_frontend_demod_blocks(long long n_out) {
  constexpr int P = outputs_per_block<true>();
  return (n_out + P - 1) / P;
}

const char* sdr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Decimated I/Q: i_out, q_out float32 (C, n / (2 decim)).  taps: the host
// float taps (F32, BF16) or the wrapper's device buffer (INT8, INT8X2,
// decim <= 16).
int sdr_frontend_iq(const void* body, const void* tail, int channels,
                    long long n, int decim, int engine, const void* taps,
                    int ntaps, float scale, void* i_out, void* q_out,
                    void* stream) {
  Geometry g;
  if (channels < 1 || channels > 65535 || engine < kF32 ||
      engine > kInt8x2 || ntaps != kTaps ||
      !geometry(body, tail, n, decim, engine, scale, &g))
    return (int)cudaErrorInvalidValue;
  Outputs o = {};
  o.i = static_cast<float*>(i_out);
  o.q = static_cast<float*>(q_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_mma(engine))
    return launch_mma(engine, kOutIQ, g, mma_taps(engine, taps, decim), o,
                      channels, s);
  Taps t;
  if (int err = make_taps(engine, taps, ntaps, &t)) return err;
  constexpr int P = outputs_per_block<false>();
  dim3 grid((unsigned)((g.n_out + P - 1) / P), (unsigned)channels);
  frontend_kernel<false, false><<<grid, kThreads, smem_bytes(decim), s>>>(
      g, t, o);
  return (int)cudaGetLastError();
}

// fm_demod (float32, or bf16 when fm_bf16), last I/Q and the power sum;
// partials is float32 (C, sdr_frontend_demod_blocks(n_out)) scratch.
int sdr_frontend_demod(const void* body, const void* tail, int channels,
                       long long n, int decim, int engine, const void* taps,
                       int ntaps, float scale, const void* prev_i,
                       const void* prev_q, void* fm_out, int fm_bf16,
                       void* last_i, void* last_q, void* partials,
                       void* power, void* stream) {
  Geometry g;
  if (channels < 1 || channels > 65535 || engine < kF32 ||
      engine > kInt8x2 || ntaps != kTaps ||
      !geometry(body, tail, n, decim, engine, scale, &g))
    return (int)cudaErrorInvalidValue;
  Outputs o = {};
  o.prev_i = static_cast<const float*>(prev_i);
  o.prev_q = static_cast<const float*>(prev_q);
  o.fm = fm_out;
  o.last_i = static_cast<float*>(last_i);
  o.last_q = static_cast<float*>(last_q);
  o.partials = static_cast<float*>(partials);
  const long long nblk = sdr_frontend_demod_blocks(g.n_out);
  o.stride = (int)nblk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int count;
  if (is_mma(engine)) {
    const long long n_tiles = (g.n_out + kTileOut - 1) / kTileOut;
    count = (int)((n_tiles + kSpanTiles - 1) / kSpanTiles);
    if (int err = launch_mma(engine, fm_bf16 ? kOutBF16 : kOutF32, g,
                             mma_taps(engine, taps, decim), o, channels, s))
      return err;
  } else {
    Taps t;
    if (int err = make_taps(engine, taps, ntaps, &t)) return err;
    count = (int)nblk;
    dim3 grid((unsigned)nblk, (unsigned)channels);
    if (fm_bf16)
      frontend_kernel<true, true><<<grid, kThreads, smem_bytes(decim), s>>>(
          g, t, o);
    else
      frontend_kernel<true, false><<<grid, kThreads, smem_bytes(decim), s>>>(
          g, t, o);
    if (cudaError_t err = cudaGetLastError()) return (int)err;
  }
  power_sum_kernel<<<channels, kThreads, 0, s>>>(
      o.partials, o.stride, count, static_cast<float*>(power));
  return (int)cudaGetLastError();
}

}  // extern "C"
