// The wideband channelizer's modulated filter bank, for Hopper (sm_90a).
//
// Replaces the Pallas kernel sdr_tpu/ops/pallas/channelizer_kernel.py
// `_mfb_kernel` (reached through PallasMFB.__call__ / call_cols).  For
// output column g, station k and the decoded flat stream f (the carried
// tail, then the block; f[2D*c + d] is lane d of column c):
//
//   acc_r[k, g] = sum_{r < 2D*n_shift} bm[k, r] f[2D*(g - T) + r]
//   acc_i[k, g] = the same with bank row Kp + k
//   (cos_t, sin_t) = (sr*br - si*bi, sr*bi + si*br)
//   I = acc_r*cos_t - acc_i*sin_t,  Q = acc_r*sin_t + acc_i*cos_t
//
// with r = 2D*s + d the reduction index, T = t_cols, a negative column c
// read from column 128 + c of the carried (2D, 128) tail (n_shift <= T + 1,
// so no column past g is read), u8 decoded exactly as (int8)(x ^ 0x80) /
// 128, (sr, si) = (rotc, rots)[k, g / tile] and (br, bi) = base[k, g %
// tile] the reference's factored phasor tables.  The rotation rounds each
// operation (__fmul_rn, __fadd_rn) in the plain version's order.  Column g
// of the product's right operand (the im2col) is the contiguous slice
// f[2D*(g - T) ...]: its columns are windows of one flat stream that
// overlap at a stride of 2D.  Both engines stage that flat window in
// shared memory once per tile and build no im2col.
//
// What bounds it on the card: at K = 64, D = 4, 101 taps (bank 128 x 208,
// of which 2*101 = 202 columns are non-zero taps) each output column
// needs 2*128*202 flops, plus 12 a station for the rotation, against 8
// input bytes (u8) and 2*64*4 output bytes: 13.76 GFLOP and 139 MB for
// 2^20 wideband pairs, 0.205 ms at the 67 TFLOP/s float32 peak, 0.041 ms
// at 3.35 TB/s (chip_smoke.py `mfb_work`).  The float32 engine is compute
// bound on the CUDA cores (TF32 would miss the 2e-5 gate); the bf16 engine
// is bound by its output bytes once it runs on the tensor cores.
//
// Both engines: persistent blocks of 256 threads, grid (walkers, groups of
// 32 stations); a block loads its group's bank into shared memory once and
// walks column tiles of 256.  A tile's window is staged as raw bytes by
// cp.async while the previous tile computes (issue_raw), then decoded from
// shared memory; the outputs leave by streaming stores.
//
// bf16 engine (mfb_tc_kernel): mma.sync.m16n8k16, bf16 operands, float32
// accumulation.  The bank is packed on the host in the A fragments' order
// (one 16-byte load a lane per fragment), with station k's real and
// imaginary rows at rows i and i + 8 of one m16 tile, so a lane's
// accumulators c0/c1 (real) and c2/c3 (imaginary) are the same station and
// columns and the rotation runs in registers.  The window is staged flat,
// f[p*2D + d]; lane (g, t) of a B fragment needs the bf16 pair at element
// (column g)*2D + 16*ks + 2t (+8): one aligned 32-bit shared load for any D
// (2D is even), conflict-free at D = 4, so no im2col tile and no ldmatrix
// alignment (16-byte rows, D a multiple of 4) is needed.  A warp owns 32
// columns and the block's 4 m-tiles (32 stations): per k-step 4 A loads (16
// bytes) and 8 B loads (4 bytes) for 16 mma.  The MMA is the small part:
// what costs is the epilogue (the rotation's phasor tables, 8 bytes per
// output pair, and the 2*K*n_out outputs).  So where kCols divides the
// phasor tile, each block keeps one column offset in it and caches its
// stations' base phasors in shared memory (64 KB, one 16-byte load per
// output pair), and a quad of lanes swaps halves so that each lane stores
// 4 consecutive columns.  wgmma was not tried: the MMA is not the limit.
//
// float32 engine (mfb_f32_kernel): CUDA cores, a register sliding window.
// Lane l of warp w owns 8 consecutive columns (8l..8l+7) and the 4
// stations 4w..4w+3 (real and imaginary): 64 accumulators.  For each d it
// walks s with a 16-register window of the lane's samples x[d, p0 + s + j],
// refilled 8 at a time, so each (s, d) step costs one shared sample load
// (amortised) and two float4 bank broadcasts for 64 FMAs.  The window is
// staged by d as rows of f32 with one word of skew per 32 (lanes 8 words
// apart then hit distinct banks).  ptxas: 119 registers, no spills.  Where
// 32 stations' float32 bank does not fit in shared memory (taps above ~420
// at D = 4), the launcher runs blocks of 16 stations, 2 a warp.  The bf16
// engine then drops its base-phasor cache instead.
//
// The TPU kernel's clamped second BlockSpec and lane-rolls do not carry
// over: each tile computes its offsets from the strides it is given, so
// the flat stream (strides 1, 2D) and the pre-phased layout (strides N/D,
// 1) go through the same kernels with no relayout.  There is no state
// across blocks: the tail and the phase are inputs, and the wrapper
// computes the new ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 32;      // stations of a block
constexpr int kCols = 256;      // output columns of a tile (both engines)
constexpr int kRun = 8;         // f32 engine: a lane's consecutive columns
constexpr int kExt = 128;       // carried tail columns
constexpr int kMaxSmem = 232448;
constexpr int kFlat = 1;        // strides (1, 2D): a tile's window is one run
constexpr int kRows = 2;        // strides (N/D, 1): one run per lane d
constexpr int kBaseStride = 2 * kCols + 16;  // floats of a cached base row

struct MfbArgs {
  const void* x;           // (2D, n_out) at element strides (sd, sc)
  const void* tail;        // (2D, kExt), x's dtype
  const void* bank;        // packed per engine (see sdr_mfb)
  const float* rotc;       // (Kp, a_cols) float32
  const float* rots;
  const float* base_r;     // (Kp, tile) float32
  const float* base_i;
  void* i_out;             // (K, n_out) float32 or bf16
  void* q_out;
  long long sd, sc, n_out, tiles;
  int two_d, k, rows, ksteps, n_shift, t_cols, a_cols, tile;
  int layout;              // kFlat, kRows or 0 (see issue_raw)
  int raw_bytes;           // shared bytes of the raw copy
  int n_off;               // tile / kCols where kCols divides tile, else 0
};

template <bool U8>
__device__ __forceinline__ float decode(const void* p, long long i) {
  if constexpr (U8)
    return (float)(int8_t)(static_cast<const uint8_t*>(p)[i] ^ 0x80u) *
           (1.0f / 128.0f);
  else
    return static_cast<const float*>(p)[i];
}

// Visits every (d, p) of the window of columns c0 - T + p, p < ncols, in
// the order that reads the stream's layout coalesced, and calls
// put(d, p, value): zero past the block's last column.  A thread issues
// kBatch loads before it stores any, so that a tile's staging waits on
// memory about once, not once per element.
constexpr int kBatch = 12;

template <bool U8, typename Put>
__device__ __forceinline__ void stage_window(const MfbArgs& a, long long c0,
                                             int ncols, Put put) {
  const int nx = a.two_d * ncols;
  for (int base = threadIdx.x; base < nx; base += kThreads * kBatch) {
    float v[kBatch];
    int dp[kBatch][2];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads;
      int d, p;
      if (a.sd == 1) {
        d = i % a.two_d;
        p = i / a.two_d;
      } else {
        p = i % ncols;
        d = i / ncols;
      }
      dp[j][0] = d;
      dp[j][1] = p;
      const long long c = c0 - a.t_cols + p;
      v[j] = 0.f;
      if (i < nx) {
        if (c < 0)
          v[j] = decode<U8>(a.tail, (long long)d * kExt + (kExt + c));
        else if (c < a.n_out)
          v[j] = decode<U8>(a.x, d * a.sd + c * a.sc);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (base + j * kThreads < nx) put(dp[j][0], dp[j][1], v[j]);
  }
}

// The asynchronous staging.  Where the stream's layout gives a tile's
// window as one contiguous run (the flat stream) or one run per lane d
// (the pre-phased layout) and the window lies inside the block with 8
// columns to spare, its raw bytes are copied by cp.async (4-byte chunks
// from the aligned address at or below each run's start) into `raw` while
// the previous tile computes, and decoded from shared memory after; the
// first and last tiles of a block, and other layouts, go through
// stage_window.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// bytes of one run of the raw copy: its elements and up to 3 bytes of
// alignment either side, rounded to 4
__host__ __device__ __forceinline__ int raw_run_bytes(int layout, int ncols,
                                                      int two_d, int es) {
  return ((layout == kFlat ? ncols * two_d : ncols) * es + 6) & ~3;
}

__host__ __device__ __forceinline__ int raw_runs(int layout, int two_d) {
  return layout == kFlat ? 1 : two_d;
}

template <bool U8>
__device__ __forceinline__ uintptr_t run_start(const MfbArgs& a, long long c0,
                                               int r) {
  return reinterpret_cast<uintptr_t>(a.x) +
         (uintptr_t)((r * a.sd + (c0 - a.t_cols) * a.sc) * (U8 ? 1 : 4));
}

__device__ __forceinline__ bool async_tile(const MfbArgs& a, long long c0,
                                           int ncols) {
  const long long first = c0 - a.t_cols;
  return a.layout != 0 && first >= 8 && first + ncols + 8 <= a.n_out;
}

template <bool U8>
__device__ __forceinline__ void issue_raw(const MfbArgs& a, long long c0,
                                          int ncols, unsigned char* raw) {
  const int rb = raw_run_bytes(a.layout, ncols, a.two_d, U8 ? 1 : 4);
  const int chunks = rb / 4;
  const int n = raw_runs(a.layout, a.two_d) * chunks;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int r = j / chunks, q = j - r * chunks;
    const uintptr_t src = (run_start<U8>(a, c0, r) & ~(uintptr_t)3) + 4 * q;
    cp_async4(raw + r * rb + 4 * q, reinterpret_cast<const void*>(src));
  }
}

template <bool U8>
__device__ __forceinline__ float raw_value(const unsigned char* p, int i) {
  if constexpr (U8)
    return (float)(int8_t)(p[i] ^ 0x80u) * (1.0f / 128.0f);
  else
    return reinterpret_cast<const float*>(p)[i];
}

template <bool U8, typename Put>
__device__ __forceinline__ void decode_raw(const MfbArgs& a, long long c0,
                                           int ncols, const unsigned char* raw,
                                           Put put) {
  const int rb = raw_run_bytes(a.layout, ncols, a.two_d, U8 ? 1 : 4);
  if (a.layout == kFlat) {
    const unsigned char* r = raw + (run_start<U8>(a, c0, 0) & 3);
    for (int p = threadIdx.x; p < ncols; p += kThreads)
      for (int d = 0; d < a.two_d; ++d)
        put(d, p, raw_value<U8>(r, p * a.two_d + d));
  } else {
    for (int d = 0; d < a.two_d; ++d) {
      const unsigned char* r = raw + d * rb + (run_start<U8>(a, c0, d) & 3);
      for (int p = threadIdx.x; p < ncols; p += kThreads)
        put(d, p, raw_value<U8>(r, p));
    }
  }
}

// The phasor tables of station k at columns g..g+N-1 (within one tile:
// g % tile + N <= tile, N-aligned), read through the read-only path.
template <int N>
struct Phasor {
  float sr, si, br[N], bi[N];
};

// (ta, tb) = (g / tile, g % tile) for g = c0 + o, from those of c0 (a
// tile's columns are < 256 past c0 and tile >= 8): 32-bit steps in place
// of a 64-bit division per output
__device__ __forceinline__ int2 tile_pos(const MfbArgs& a, int2 pos0, int o) {
  int ta = pos0.x, tb = pos0.y + o;
  while (tb >= a.tile) {
    tb -= a.tile;
    ++ta;
  }
  return make_int2(ta, tb);
}

template <int N>
__device__ __forceinline__ Phasor<N> load_phasor(const MfbArgs& a, int k,
                                                 int2 pos) {
  Phasor<N> f;
  f.sr = __ldg(a.rotc + (size_t)k * a.a_cols + pos.x);
  f.si = __ldg(a.rots + (size_t)k * a.a_cols + pos.x);
  const float* br = a.base_r + (size_t)k * a.tile + pos.y;
  const float* bi = a.base_i + (size_t)k * a.tile + pos.y;
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    const float2 r = __ldg(reinterpret_cast<const float2*>(br + j));
    const float2 i = __ldg(reinterpret_cast<const float2*>(bi + j));
    f.br[j] = r.x;
    f.br[j + 1] = r.y;
    f.bi[j] = i.x;
    f.bi[j + 1] = i.y;
  }
  return f;
}

// The rotated outputs, each operation rounded in the plain version's order
template <int N>
__device__ __forceinline__ void rotate(const Phasor<N>& f,
                                       const float (&cr)[N],
                                       const float (&ci)[N], float (&io)[N],
                                       float (&qo)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float cos_t =
        __fsub_rn(__fmul_rn(f.sr, f.br[j]), __fmul_rn(f.si, f.bi[j]));
    const float sin_t =
        __fadd_rn(__fmul_rn(f.sr, f.bi[j]), __fmul_rn(f.si, f.br[j]));
    io[j] = __fsub_rn(__fmul_rn(cr[j], cos_t), __fmul_rn(ci[j], sin_t));
    qo[j] = __fadd_rn(__fmul_rn(cr[j], sin_t), __fmul_rn(ci[j], cos_t));
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// N (2, 4 or 8) consecutive outputs from an N-aligned element offset, by
// streaming stores (st.global.cs): the outputs are read by the next stage,
// not by this kernel, and evict-first keeps them from crowding L2 (the
// bf16 engine's epilogue is bound by these stores)
template <bool BF16, int N>
__device__ __forceinline__ void store_run(void* p, size_t o,
                                          const float (&v)[N]) {
  if constexpr (BF16) {
    uint32_t* dst = static_cast<uint32_t*>(p) + o / 2;
    if constexpr (N == 8) {
      __stcs(reinterpret_cast<uint4*>(dst),
             make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                        bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7])));
    } else if constexpr (N == 4) {
      __stcs(reinterpret_cast<uint2*>(dst),
             make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3])));
    } else {
      __stcs(reinterpret_cast<unsigned int*>(dst), bf16_pair(v[0], v[1]));
    }
  } else {
    float* dst = static_cast<float*>(p) + o;
    if constexpr (N == 8) {
      __stcs(reinterpret_cast<float4*>(dst),
             make_float4(v[0], v[1], v[2], v[3]));
      __stcs(reinterpret_cast<float4*>(dst) + 1,
             make_float4(v[4], v[5], v[6], v[7]));
    } else if constexpr (N == 4) {
      __stcs(reinterpret_cast<float4*>(dst),
             make_float4(v[0], v[1], v[2], v[3]));
    } else {
      __stcs(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// ----------------------------------------------------- bf16, tensor cores
template <bool U8, bool OUT_BF16>
__global__ void __launch_bounds__(kThreads, 2)
    mfb_tc_kernel(const __grid_constant__ MfbArgs a) {
  extern __shared__ uint4 smem[];
  const int ks_n = a.ksteps;
  uint4* bank = smem;    // [4 m-tiles][ks_n][32 lanes] A fragments
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(smem + 4 * ks_n * 32);
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(xs);
  const int two_d = a.two_d, half_d = two_d >> 1;
  const int ncols = kCols - 1 + (16 * ks_n + two_d - 1) / two_d;
  const int grp = blockIdx.y;
  const uint4* src =
      static_cast<const uint4*>(a.bank) + (size_t)grp * 4 * ks_n * 32;
  for (int i = threadIdx.x; i < 4 * ks_n * 32; i += kThreads) bank[i] = src[i];
  unsigned char* raw = reinterpret_cast<unsigned char*>(xs + two_d * ncols);
  // where kCols divides the phasor tile, the walk below keeps one offset
  // in the tile (gridDim.x is a multiple of n_off), so the block caches
  // its stations' base phasors for those kCols columns, (re, im) pairs
  const size_t bs_at = ((size_t)4 * ks_n * 32 * 16 + 2 * two_d * ncols +
                        a.raw_bytes + 15) & ~(size_t)15;
  float* bs = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) + bs_at);
  if (a.n_off) {
    const int off = (int)(blockIdx.x % a.n_off) * kCols;
    for (int i = threadIdx.x; i < kGroup * kCols; i += kThreads) {
      const int st = i / kCols, j = i - st * kCols;
      const int k = grp * kGroup + st;
      float* dst = bs + st * kBaseStride + 2 * j;
      if (k < a.k) {   // in flight with the first tile's staging
        const size_t o = (size_t)k * a.tile + off + j;
        cp_async4(dst, a.base_r + o);
        cp_async4(dst + 1, a.base_i + o);
      } else {
        dst[0] = dst[1] = 0.f;
      }
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // 32-bit word of the window where n-tile 0's B fragment of k-step 0 starts
  const int wbase = (warp * 32 + gq) * half_d + tq;
  auto put = [&](int d, int p, float v) {
    xs[p * two_d + d] = __float2bfloat16_rn(v);
  };
  long long tile = blockIdx.x;
  bool pending = tile < a.tiles && async_tile(a, tile * kCols, ncols);
  if (pending) issue_raw<U8>(a, tile * kCols, ncols, raw);
  for (; tile < a.tiles; tile += gridDim.x) {
    const long long c0 = tile * kCols;
    cp_async_wait_all();
    __syncthreads();   // the bank and the raw bytes are in; xs is free
    if (pending)
      decode_raw<U8>(a, c0, ncols, raw, put);
    else
      stage_window<U8>(a, c0, ncols, put);
    __syncthreads();
    const long long next = tile + gridDim.x;
    pending = next < a.tiles && async_tile(a, next * kCols, ncols);
    if (pending) issue_raw<U8>(a, next * kCols, ncols, raw);
    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
    for (int ks = 0; ks < ks_n; ++ks) {
      uint32_t b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int w = wbase + nt * 8 * half_d + ks * 8;
        b[nt][0] = xw[w];
        b[nt][1] = xw[w + 4];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint4 af = bank[(mt * ks_n + ks) * 32 + lane];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af, b[nt][0], b[nt][1]);
      }
    }
    if (a.n_off) {
      // the rows' start phasors of this tile first, then per output pair
      // one 16-byte shared load of (br, bi) x 2 columns
      const int ta = (int)(tile / a.n_off);
      float sr[4], si[4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int k = min(grp * kGroup + mt * 8 + gq, a.k - 1);
        sr[mt] = __ldg(a.rotc + (size_t)k * a.a_cols + ta);
        si[mt] = __ldg(a.rots + (size_t)k * a.a_cols + ta);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        // every lane rotates (the quad's shuffles need all 32); the stores
        // of stations past K are skipped
        const int k = grp * kGroup + mt * 8 + gq;
        float io[4][2], qo[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = warp * 32 + nt * 8 + 2 * tq;
          const float4 b = *reinterpret_cast<const float4*>(
              bs + (mt * 8 + gq) * kBaseStride + 2 * col);
          Phasor<2> f;
          f.sr = sr[mt];
          f.si = si[mt];
          f.br[0] = b.x;
          f.bi[0] = b.y;
          f.br[1] = b.z;
          f.bi[1] = b.w;
          const float cr[2] = {acc[mt][nt][0], acc[mt][nt][1]};
          const float ci[2] = {acc[mt][nt][2], acc[mt][nt][3]};
          rotate<2>(f, cr, ci, io[nt], qo[nt]);
        }
        // lanes 2h and 2h + 1 of a quad swap halves so that each stores 4
        // consecutive columns: lane 2h n-tiles 0 and 2, lane 2h + 1 n-tiles
        // 1 and 3 (a warp's store covers 16 columns of each of 8 rows)
        const bool odd = tq & 1;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float ov[2][4];
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            const float(&v)[4][2] = w ? qo : io;
            const float s0 = __shfl_xor_sync(
                0xffffffffu, odd ? v[2 * m][0] : v[2 * m + 1][0], 1);
            const float s1 = __shfl_xor_sync(
                0xffffffffu, odd ? v[2 * m][1] : v[2 * m + 1][1], 1);
            const float o0 = odd ? v[2 * m + 1][0] : v[2 * m][0];
            const float o1 = odd ? v[2 * m + 1][1] : v[2 * m][1];
            ov[w][0] = odd ? s0 : o0;
            ov[w][1] = odd ? s1 : o1;
            ov[w][2] = odd ? o0 : s0;
            ov[w][3] = odd ? o1 : s1;
          }
          if (k < a.k) {
            const int col = warp * 32 + (2 * m + odd) * 8 + 4 * (tq >> 1);
            const size_t o =
                (size_t)k * (size_t)a.n_out + (size_t)(c0 + col);
            store_run<OUT_BF16, 4>(a.i_out, o, ov[0]);
            store_run<OUT_BF16, 4>(a.q_out, o, ov[1]);
          }
        }
      }
      continue;
    }
    // per m-tile: the phasors of all four n-tiles first, then the stores
    const int2 pos0 = make_int2((int)(c0 / a.tile), (int)(c0 % a.tile));
    int2 pos[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const long long g = c0 + warp * 32 + nt * 8 + 2 * tq;
      pos[nt] = g < a.n_out ? tile_pos(a, pos0, warp * 32 + nt * 8 + 2 * tq)
                            : make_int2(0, 0);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int k = grp * kGroup + mt * 8 + gq;
      if (k >= a.k) continue;
      Phasor<2> f[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) f[nt] = load_phasor<2>(a, k, pos[nt]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const long long g = c0 + warp * 32 + nt * 8 + 2 * tq;
        if (g >= a.n_out) continue;
        const float cr[2] = {acc[mt][nt][0], acc[mt][nt][1]};
        const float ci[2] = {acc[mt][nt][2], acc[mt][nt][3]};
        float io[2], qo[2];
        rotate<2>(f[nt], cr, ci, io, qo);
        const size_t o = (size_t)k * (size_t)a.n_out + (size_t)g;
        store_run<OUT_BF16, 2>(a.i_out, o, io);
        store_run<OUT_BF16, 2>(a.q_out, o, qo);
      }
    }
  }
}

// ------------------------------------------------- float32, CUDA cores
__device__ __forceinline__ int skew(int p) { return p + (p >> 5); }

// One (s, d) step: the SPW stations' (real, imag) taps (SPW / 2 float4
// broadcasts) times the lane's kRun samples w[ss..ss+kRun-1].
template <int SPW>
__device__ __forceinline__ void f32_step(const float4* b, const float (&w)[2 * kRun],
                                         int ss, float (&ar)[SPW][kRun],
                                         float (&ai)[SPW][kRun]) {
  float4 bb[SPW / 2];
#pragma unroll
  for (int h = 0; h < SPW / 2; ++h) bb[h] = b[h];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const float x = w[ss + j];
#pragma unroll
    for (int h = 0; h < SPW / 2; ++h) {
      ar[2 * h][j] = fmaf(bb[h].x, x, ar[2 * h][j]);
      ai[2 * h][j] = fmaf(bb[h].y, x, ai[2 * h][j]);
      ar[2 * h + 1][j] = fmaf(bb[h].z, x, ar[2 * h + 1][j]);
      ai[2 * h + 1][j] = fmaf(bb[h].w, x, ai[2 * h + 1][j]);
    }
  }
}

// G stations a block (32, or 16 where 32 stations' bank does not fit in
// shared memory), SPW = G / 8 of them a warp.  The bank is packed by 32
// stations; a block of 16 reads its half of each row.
template <bool U8, bool OUT_BF16, int G>
__global__ void __launch_bounds__(kThreads, 2)
    mfb_f32_kernel(const __grid_constant__ MfbArgs a) {
  extern __shared__ float4 smem4[];
  constexpr int SPW = G / 8;
  const float4* bank = smem4;   // [rows][G stations][re, im]
  float* xs = reinterpret_cast<float*>(smem4 + a.rows * (G / 2));
  const int two_d = a.two_d, n_shift = a.n_shift;
  const int ncols = kCols + ((n_shift + kRun - 1) / kRun) * kRun;
  const int ws = skew(ncols) + 1;      // a d-row of the skewed window
  const int grp = blockIdx.y;
  const float4* src = static_cast<const float4*>(a.bank) +
                      (size_t)(grp * G / kGroup) * a.rows * (kGroup / 2) +
                      (grp * G % kGroup) / 2;
  for (int i = threadIdx.x; i < a.rows * (G / 2); i += kThreads) {
    const int r = i / (G / 2);
    smem4[i] = src[r * (kGroup / 2) + (i - r * (G / 2))];
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = lane * kRun;
  unsigned char* raw = reinterpret_cast<unsigned char*>(xs + two_d * ws);
  auto put = [&](int d, int p, float v) { xs[d * ws + skew(p)] = v; };
  long long tile = blockIdx.x;
  bool pending = tile < a.tiles && async_tile(a, tile * kCols, ncols);
  if (pending) issue_raw<U8>(a, tile * kCols, ncols, raw);
  for (; tile < a.tiles; tile += gridDim.x) {
    const long long c0 = tile * kCols;
    cp_async_wait_all();
    __syncthreads();   // the bank and the raw bytes are in; xs is free
    if (pending)
      decode_raw<U8>(a, c0, ncols, raw, put);
    else
      stage_window<U8>(a, c0, ncols, put);
    __syncthreads();
    const long long next = tile + gridDim.x;
    pending = next < a.tiles && async_tile(a, next * kCols, ncols);
    if (pending) issue_raw<U8>(a, next * kCols, ncols, raw);
    float ar[SPW][kRun], ai[SPW][kRun];
#pragma unroll
    for (int st = 0; st < SPW; ++st)
#pragma unroll
      for (int j = 0; j < kRun; ++j) ar[st][j] = ai[st][j] = 0.f;
    for (int d = 0; d < two_d; ++d) {
      const float* xr = xs + d * ws;
      const float4* bd = bank + d * (G / 2) + warp * (SPW / 2);
      float w[2 * kRun];
#pragma unroll
      for (int i = 0; i < kRun; ++i) w[i] = xr[skew(p0 + i)];
      // whole chunks of kRun steps, then the guarded last one
      for (int s0 = 0; s0 < n_shift; s0 += kRun) {
#pragma unroll
        for (int i = 0; i < kRun; ++i)
          w[kRun + i] = xr[skew(p0 + s0 + kRun + i)];
        if (s0 + kRun <= n_shift) {
#pragma unroll
          for (int ss = 0; ss < kRun; ++ss)
            f32_step<SPW>(bd + (size_t)(s0 + ss) * two_d * (G / 2), w, ss,
                     ar, ai);
        } else {
#pragma unroll
          for (int ss = 0; ss < kRun; ++ss)
            if (s0 + ss < n_shift)
              f32_step<SPW>(bd + (size_t)(s0 + ss) * two_d * (G / 2), w, ss,
                       ar, ai);
        }
#pragma unroll
        for (int i = 0; i < kRun; ++i) w[i] = w[kRun + i];
      }
    }
    // two stations at a time: their phasors first, then the stores
    const long long g = c0 + p0;
    if (g < a.n_out) {
#pragma unroll
      for (int st = 0; st < SPW; st += 2) {
        const int k = grp * G + warp * SPW + st;
        if (k >= a.k) break;
        const bool two = k + 1 < a.k;
        const int2 pos = tile_pos(
            a, make_int2((int)(c0 / a.tile), (int)(c0 % a.tile)), p0);
        const Phasor<kRun> f0 = load_phasor<kRun>(a, k, pos);
        const Phasor<kRun> f1 = load_phasor<kRun>(a, two ? k + 1 : k, pos);
        float io[kRun], qo[kRun];
        rotate<kRun>(f0, ar[st], ai[st], io, qo);
        size_t o = (size_t)k * (size_t)a.n_out + (size_t)g;
        store_run<OUT_BF16, kRun>(a.i_out, o, io);
        store_run<OUT_BF16, kRun>(a.q_out, o, qo);
        if (!two) break;
        rotate<kRun>(f1, ar[st + 1], ai[st + 1], io, qo);
        o += (size_t)a.n_out;
        store_run<OUT_BF16, kRun>(a.i_out, o, io);
        store_run<OUT_BF16, kRun>(a.q_out, o, qo);
      }
    }
  }
}

// Persistent launch: as many walkers per station group as fit on the card
template <typename Kernel>
int launch_persistent(Kernel kernel, const MfbArgs& a, int groups,
                      size_t smem, cudaStream_t stream) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long walkers = (long long)per_sm * sms / groups;
  if (a.n_off)   // a multiple of n_off: each block keeps its tile offset
    walkers = walkers < a.n_off ? a.n_off : walkers / a.n_off * a.n_off;
  if (walkers < 1) walkers = 1;
  if (walkers > a.tiles) walkers = a.tiles;
  kernel<<<dim3((unsigned)walkers, (unsigned)groups), kThreads, smem,
           stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bank: for the bf16 engine (bf16_compute = 1) the A fragments of
// mma.m16n8k16, (ceil(Kp/32), 4 m-tiles, ceil(2D*n_shift/16) k-steps, 32
// lanes, 8) bf16: lane (g, t) of m-tile m holds station 8m + g's real and
// imaginary rows at columns 16ks + 2t, +1, +8, +9 as the a0..a3 registers
// want them; for the float32 engine (ceil(Kp/32), 2D*n_shift, 32, 2)
// float32, (real, imaginary) of each station side by side.  Stations past
// Kp are zero.  rotc/rots (Kp, a_cols), base_r/base_i (Kp, tile), a_cols *
// tile == n_out, n_out even; n_shift <= t_cols + 1 <= 129.
int sdr_mfb(const void* x, const void* tail, int u8, long long stride_d,
            long long stride_c, int two_d, long long n_out, const void* bank,
            int kp, int k, int n_shift, int t_cols, const float* rotc,
            const float* rots, int a_cols, const float* base_r,
            const float* base_i, int tile, int bf16_compute, void* i_out,
            void* q_out, int out_bf16, void* stream) {
  if (two_d < 2 || two_d > 256 || two_d % 2 || n_out < 2 || n_out % 2 ||
      k < 1 || k > kp || n_shift < 1 || n_shift > t_cols + 1 ||
      t_cols > kExt || tile < 1 || tile % kRun || a_cols < 1 ||
      (long long)a_cols * tile != n_out || stride_d < 1 || stride_c < 1)
    return (int)cudaErrorInvalidValue;
  MfbArgs a;
  a.x = x;
  a.tail = tail;
  a.bank = bank;
  a.rotc = rotc;
  a.rots = rots;
  a.base_r = base_r;
  a.base_i = base_i;
  a.i_out = i_out;
  a.q_out = q_out;
  a.sd = stride_d;
  a.sc = stride_c;
  a.n_out = n_out;
  a.tiles = (n_out + kCols - 1) / kCols;
  a.two_d = two_d;
  a.k = k;
  a.rows = two_d * n_shift;
  a.ksteps = (a.rows + 15) / 16;
  a.n_shift = n_shift;
  a.t_cols = t_cols;
  a.a_cols = a_cols;
  a.tile = tile;
  a.layout = stride_d == 1 && stride_c == two_d ? kFlat
             : stride_c == 1                     ? kRows
                                                 : 0;
  int groups = (kp + kGroup - 1) / kGroup;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto raw_bytes = [&](int ncols) {
    return a.layout ? (size_t)raw_runs(a.layout, two_d) *
                          raw_run_bytes(a.layout, ncols, two_d, u8 ? 1 : 4)
                    : (size_t)0;
  };
#define SDR_MFB(KERNEL, ...)                                                 \
  (u8 ? (out_bf16 ? launch_persistent(KERNEL<true, true, ##__VA_ARGS__>, a,   \
                                      groups, smem, s)                        \
                  : launch_persistent(KERNEL<true, false, ##__VA_ARGS__>, a,  \
                                      groups, smem, s))                       \
      : (out_bf16 ? launch_persistent(KERNEL<false, true, ##__VA_ARGS__>, a,  \
                                      groups, smem, s)                        \
                  : launch_persistent(KERNEL<false, false, ##__VA_ARGS__>, a, \
                                      groups, smem, s)))
  a.n_off = 0;
  if (bf16_compute) {
    const int ncols = kCols - 1 + (16 * a.ksteps + two_d - 1) / two_d;
    a.raw_bytes = (int)raw_bytes(ncols);
    a.n_off = tile % kCols == 0 ? tile / kCols : 0;
    const size_t core =
        ((size_t)4 * a.ksteps * 32 * 16 +
         sizeof(__nv_bfloat16) * (size_t)two_d * ncols + a.raw_bytes + 15) &
        ~(size_t)15;
    const size_t cache = sizeof(float) * kGroup * kBaseStride;
    // a long filter whose bank leaves no room for the base phasors' cache
    // reads them from global memory instead
    if (core + cache > (size_t)kMaxSmem) a.n_off = 0;
    const size_t smem = core + (a.n_off ? cache : 0);
    return SDR_MFB(mfb_tc_kernel);
  }
  const int ncols = kCols + ((n_shift + kRun - 1) / kRun) * kRun;
  const int ws = ncols + (ncols >> 5) + 1;
  a.raw_bytes = (int)raw_bytes(ncols);
  auto f32_smem = [&](int g) {
    return sizeof(float) * ((size_t)a.rows * g * 2 + (size_t)two_d * ws) +
           a.raw_bytes;
  };
  size_t smem = f32_smem(kGroup);
  if (smem <= (size_t)kMaxSmem) return SDR_MFB(mfb_f32_kernel, kGroup);
  // a long filter: 16 stations a block halve the bank's shared memory
  smem = f32_smem(kGroup / 2);
  groups = (kp + kGroup / 2 - 1) / (kGroup / 2);
  return SDR_MFB(mfb_f32_kernel, kGroup / 2);
#undef SDR_MFB
}

}  // extern "C"
