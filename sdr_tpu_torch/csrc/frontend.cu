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
// Coefficient engines (template parameter E), all as in the reference:
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
// and writes 2-8 bytes, against 2 x 51 multiply-adds.  An H100 moves
// 3.35 TB/s and issues ~33 T float FMA/s or ~17 T int32 IMAD/s, so on
// paper the float engines are bound by memory and the integer engines sit
// near the balance point.  The design reads every input byte from device
// memory once and keeps the decoded I/Q and the discriminator out of it:
//   - one block of 256 threads per (station, run of outputs) stages its
//     input window, decoded to int8, in shared memory, with 16-byte loads
//     that are all in flight at once;
//   - the window is staged as two planes, I and Q, so that a FIR's inputs
//     are consecutive bytes.  Each thread computes one output.  The
//     integer engines multiply 4 int8 samples by 4 int8 taps per dp4a
//     instruction, against a copy of the reversed taps shifted to the
//     word alignment of the output's window (4 copies, in shared memory):
//     a direct form with one multiply-add per tap was bound by its
//     instructions, at 0.60 ms for 128 stations x 5.12 MB on an H100
//     80GB HBM3 (700 W); with dp4a the int8 demod kernel takes 0.48 ms
//     (1.4 TB/s), where the shared-memory loads (2-way bank conflicts at
//     a 10-byte stride) are the likely bound.  The float engines keep one
//     FMA per tap, with taps from the constant bank;
//   - the TPU kernel carried the discriminator's previous sample and the
//     power sum across its sequential grid.  Blocks here run in no order,
//     so each demod block also computes the one output before its run (a
//     halo; 1 extra output in 256), and writes its power sum as a partial
//     that a second, tiny kernel adds up per station;
//   - the dense banded matmul of the TPU (~19x wasted FLOPs), its 8-channel
//     padding and its DMA double-buffering do not carry over.
// The discriminator uses the _rn intrinsics so no FMA contraction changes
// its rounding: it matches the plain PyTorch version bit for bit given the
// same I/Q.  Build without --use_fast_math (the division must be IEEE).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTail = 128;  // carried u8 tail per station (bytes)
constexpr int kTaps = 51;   // rf_taps of every mode (config.py)
constexpr int kVec = 16;    // bytes per staging load
constexpr int kVecPerThread = 4;  // staging loads per thread, all in flight
constexpr int kMaxWindow = kThreads * kVecPerThread * kVec;  // bytes
// the integer engines' taps, reversed, shifted right by r = 0..3 bytes and
// packed 4 int8 to a word, so that a FIR over any run of plane bytes is a
// sum of dp4a over aligned words
constexpr int kTapWords = (kTaps + 3 + 3) / 4;

enum Engine { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt8x2 = 3 };

struct Taps {
  float f[kTaps];            // F32 / BF16 (bf16 values, widened exactly)
  int hi[4][kTapWords];      // INT8 taps, or the high limbs of INT8X2
  int lo[4][kTapWords];      // low limbs of INT8X2
};

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
  float* partials;        // (C, gridDim.x) per-block sums of I^2+Q^2
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

// One decimated output: plane index s + kTaps - 1 - k holds the sample of
// tap k.  The integer engines take the run [s, s + kTaps) as kTapWords
// aligned words from s - (s & 3), against the taps shifted by s & 3
// (t_hi, t_lo: that shift's words, in shared memory), with dp4a: 4
// multiply-adds of int8 into int32 per instruction.
template <int E>
__device__ __forceinline__ void fir(const int8_t* pi, const int8_t* pq,
                                    int s, const Taps& t, const int* t_hi,
                                    const int* t_lo, float scale,
                                    float& i_out, float& q_out) {
  if constexpr (E == kInt8 || E == kInt8x2) {
    const int r = s & 3;
    const int* wi = reinterpret_cast<const int*>(pi + s - r);
    const int* wq = reinterpret_cast<const int*>(pq + s - r);
    t_hi += r * kTapWords;
    t_lo += r * kTapWords;
    int ai = 0, aq = 0, bi = 0, bq = 0;
#pragma unroll
    for (int w = 0; w < kTapWords; ++w) {
      const int xi = wi[w], xq = wq[w], th = t_hi[w];
      ai = __dp4a(xi, th, ai);
      aq = __dp4a(xq, th, aq);
      if constexpr (E == kInt8x2) {
        const int tl = t_lo[w];
        bi = __dp4a(xi, tl, bi);
        bq = __dp4a(xq, tl, bq);
      }
    }
    if constexpr (E == kInt8x2) {
      ai = ai * 128 + bi;
      aq = aq * 128 + bq;
    }
    i_out = __fmul_rn(__int2float_rn(ai), scale);
    q_out = __fmul_rn(__int2float_rn(aq), scale);
  } else {
    float ai = 0.f, aq = 0.f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const int p = s + kTaps - 1 - k;
      ai = fmaf((float)pi[p], t.f[k], ai);
      aq = fmaf((float)pq[p], t.f[k], aq);
    }
    i_out = ai;
    q_out = aq;
  }
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    if (lane < (int)(blockDim.x >> 5)) v = scratch[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;  // valid in thread 0
}

// Bytes of one shared-memory plane: the samples of kThreads consecutive
// outputs, the FIR's reach, the 16-byte alignment of the window and the
// dp4a words' overrun past the newest sample (read against zero taps).
__host__ __device__ constexpr int plane_bytes(int decim) {
  return (kThreads * decim + kTaps + 16 + 15) & ~15;
}

// Outputs per block: the demod kernel spends its first thread on the halo.
template <bool DEMOD>
__host__ __device__ constexpr int outputs_per_block() {
  return DEMOD ? kThreads - 1 : kThreads;
}

template <int E, bool DEMOD, bool BF16_OUT>
__global__ void __launch_bounds__(kThreads)
    frontend_kernel(const __grid_constant__ Geometry g,
                    const __grid_constant__ Taps taps,
                    const __grid_constant__ Outputs o) {
  extern __shared__ __align__(16) int8_t win[];
  __shared__ int s_taps[2][4 * kTapWords];  // integer engines: hi, lo
  int8_t* pi = win;
  int8_t* pq = win + plane_bytes(g.decim);
  if constexpr (E == kInt8 || E == kInt8x2) {
    for (int i = threadIdx.x; i < 4 * kTapWords; i += kThreads) {
      s_taps[0][i] = taps.hi[i / kTapWords][i % kTapWords];
      s_taps[1][i] = taps.lo[i / kTapWords][i % kTapWords];
    }
  }
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
  if (valid)
    fir<E>(pi, pq, (int)(m * g.decim - (kTaps - 1) - ws / 2), taps,
           s_taps[0], s_taps[1], g.scale, I, Q);
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
      const float ip = s_i[threadIdx.x - 1], qp = s_q[threadIdx.x - 1];
      const float num = __fsub_rn(__fmul_rn(I, __fsub_rn(Q, qp)),
                                  __fmul_rn(Q, __fsub_rn(I, ip)));
      den = __fadd_rn(__fmul_rn(I, I), __fmul_rn(Q, Q));
      const float fm = den == 0.f ? 0.f : __fdiv_rn(num, den);
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
      o.partials[(size_t)c * gridDim.x + blockIdx.x] = s;
  }
}

// Second pass of the demod kernel: power[c] = sum of the station's partials.
__global__ void __launch_bounds__(kThreads)
    power_sum_kernel(const float* partials, int nblk, float* power) {
  __shared__ float s_red[kThreads / 32];
  const float* row = partials + (size_t)blockIdx.x * nblk;
  float v = 0.f;
  for (int j = threadIdx.x; j < nblk; j += blockDim.x) v += row[j];
  v = block_sum(v, s_red);
  if (threadIdx.x == 0) power[blockIdx.x] = v;
}

// Pack the reversed taps shifted by r = 0..3 bytes: word w of shift r
// holds bytes 4w..4w+3 of g_r, g_r[j] = h[kTaps-1-(j-r)] (0 outside).
void pack_shifted(const int8_t* h, int (*words)[kTapWords]) {
  for (int r = 0; r < 4; ++r)
    for (int j = 0; j < 4 * kTapWords; ++j) {
      const int i = j - r;
      const int8_t b = (i >= 0 && i < kTaps) ? h[kTaps - 1 - i] : 0;
      words[r][j / 4] |= (int)((uint32_t)(uint8_t)b << (8 * (j % 4)));
    }
}

// Unpack the host tap array (layout per engine: float32[51], bf16 bits
// uint16[51], int8[51], or int8[2*51] = high limbs then low limbs).
int make_taps(int engine, const void* src, int ntaps, Taps* t) {
  if (ntaps != kTaps) return (int)cudaErrorInvalidValue;
  memset(t, 0, sizeof(Taps));
  const int8_t* t8 = static_cast<const int8_t*>(src);
  switch (engine) {
    case kF32:
      memcpy(t->f, src, sizeof(t->f));
      break;
    case kBF16:
      for (int k = 0; k < kTaps; ++k) {
        const uint32_t bits =
            (uint32_t) static_cast<const uint16_t*>(src)[k] << 16;
        memcpy(&t->f[k], &bits, sizeof(float));
      }
      break;
    case kInt8:
      pack_shifted(t8, t->hi);
      break;
    case kInt8x2:
      pack_shifted(t8, t->hi);
      pack_shifted(t8 + kTaps, t->lo);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

int smem_bytes(int decim) { return 2 * plane_bytes(decim); }

bool geometry(const void* body, const void* tail, long long n, int decim,
              float scale, Geometry* g) {
  if (decim < 1 || n < 2LL * decim || smem_bytes(decim) > kMaxWindow)
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

template <bool DEMOD, bool BF16_OUT>
void launch(int engine, dim3 grid, int smem, cudaStream_t s,
            const Geometry& g, const Taps& t, const Outputs& o) {
  switch (engine) {
    case kF32:
      frontend_kernel<kF32, DEMOD, BF16_OUT><<<grid, kThreads, smem, s>>>(g, t, o);
      break;
    case kBF16:
      frontend_kernel<kBF16, DEMOD, BF16_OUT><<<grid, kThreads, smem, s>>>(g, t, o);
      break;
    case kInt8:
      frontend_kernel<kInt8, DEMOD, BF16_OUT><<<grid, kThreads, smem, s>>>(g, t, o);
      break;
    default:
      frontend_kernel<kInt8x2, DEMOD, BF16_OUT><<<grid, kThreads, smem, s>>>(g, t, o);
      break;
  }
}

}  // namespace

extern "C" {

// Per-station blocks of the demod kernel's partial power sums.
long long sdr_frontend_demod_blocks(long long n_out) {
  constexpr int P = outputs_per_block<true>();
  return (n_out + P - 1) / P;
}

const char* sdr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Decimated I/Q: i_out, q_out float32 (C, n / (2 decim)).
int sdr_frontend_iq(const void* body, const void* tail, int channels,
                    long long n, int decim, int engine, const void* taps,
                    int ntaps, float scale, void* i_out, void* q_out,
                    void* stream) {
  Geometry g;
  Taps t;
  if (channels < 1 || channels > 65535 ||
      !geometry(body, tail, n, decim, scale, &g))
    return (int)cudaErrorInvalidValue;
  if (int err = make_taps(engine, taps, ntaps, &t)) return err;
  Outputs o = {};
  o.i = static_cast<float*>(i_out);
  o.q = static_cast<float*>(q_out);
  constexpr int P = outputs_per_block<false>();
  dim3 grid((unsigned)((g.n_out + P - 1) / P), (unsigned)channels);
  launch<false, false>(engine, grid, smem_bytes(decim),
                       static_cast<cudaStream_t>(stream), g, t, o);
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
  Taps t;
  if (channels < 1 || channels > 65535 ||
      !geometry(body, tail, n, decim, scale, &g))
    return (int)cudaErrorInvalidValue;
  if (int err = make_taps(engine, taps, ntaps, &t)) return err;
  Outputs o = {};
  o.prev_i = static_cast<const float*>(prev_i);
  o.prev_q = static_cast<const float*>(prev_q);
  o.fm = fm_out;
  o.last_i = static_cast<float*>(last_i);
  o.last_q = static_cast<float*>(last_q);
  o.partials = static_cast<float*>(partials);
  const long long nblk = sdr_frontend_demod_blocks(g.n_out);
  dim3 grid((unsigned)nblk, (unsigned)channels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fm_bf16)
    launch<true, true>(engine, grid, smem_bytes(decim), s, g, t, o);
  else
    launch<true, false>(engine, grid, smem_bytes(decim), s, g, t, o);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  power_sum_kernel<<<channels, kThreads, 0, s>>>(
      o.partials, (int)nblk, static_cast<float*>(power));
  return (int)cudaGetLastError();
}

}  // extern "C"
