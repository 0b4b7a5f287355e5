// The wideband channelizer's modulated filter bank, for Hopper (sm_90a).
//
// Replaces the Pallas kernel sdr_tpu/ops/pallas/channelizer_kernel.py
// `_mfb_kernel` (reached through PallasMFB.__call__ / call_cols).  For
// output column g, station k and the raw stream's column layout
// x[d, c] = raw[2D*c + d] (d < 2D):
//
//   acc_r[k, g] = sum_{s < n_shift, d < 2D} bm[k, 2D*s + d] x[d, g - T + s]
//   acc_i[k, g] = the same with bank row Kp + k
//   (cos_t, sin_t) = (sr*br - si*bi, sr*bi + si*br)
//   I = acc_r*cos_t - acc_i*sin_t,  Q = acc_r*sin_t + acc_i*cos_t
//
// where T = t_cols, a negative column c reads column 128 + c of the carried
// (2D, 128) tail (n_shift <= T + 1, so no column past g is read), u8
// decodes exactly as (int8)(x ^ 0x80) / 128, (sr, si) = (rotc, rots)[k,
// g / tile] and (br, bi) = base[k, g % tile] are the reference's factored
// phasor tables.  The rotation rounds each operation (__fmul_rn,
// __fadd_rn) in the plain version's order.  The bf16 engine rounds the
// samples (here) and the bank (on the host) to bf16 and accumulates in
// float32 on the CUDA cores, as the plain version does.
//
// What bounds it on the card: at K = 64, D = 4, 101 taps (bank 128 x 208,
// of which 2*101 = 202 columns are non-zero taps) each output column
// needs 2*128*202 flops, plus 12 a station for the rotation, against 8
// input bytes (u8) and 2*64*4 output bytes: 13.76 GFLOP and 139 MB for
// 2^20 wideband pairs, 0.205 ms at the 67 TFLOP/s float32 peak, 0.041 ms
// at 3.35 TB/s (chip_smoke.py `mfb_work`).  The
// float32 engine is compute bound (TF32 would miss the 2e-5 gate); the
// bf16 engine would be bound by the output bytes on the tensor cores,
// which this first kernel does not use.
//
// The design, simple first: one block of 256 threads per (128 output
// columns, 16 stations).  It stages the decoded window (2D, 128 + n_shift
// - 1), about 5 KB at D = 4, and its 32 bank rows, packed on the host as
// (row, station, re/im) so that one float4 broadcast gives two stations'
// real and imaginary taps (27 KB).  Each thread keeps 2 stations x 4
// columns x re/im in registers; lane l owns columns l + 32j, so a warp's
// sample loads are consecutive words (no bank conflict) and its stores
// coalesce.  Per (s, d) a thread does 4 sample loads and one float4 bank
// load for 16 FMAs.  The TPU kernel's clamped second BlockSpec and
// lane-rolls do not carry over: each block computes its own offsets from
// the strides it is given, so the flat stream (strides 1, 2D) and the
// pre-phased layout (strides N/D, 1) go through the same kernel with no
// relayout.  There is no state across blocks: the tail and the phase are
// inputs, and the wrapper computes the new ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 128;     // output columns of a block
constexpr int kStations = 16;  // stations of a block (8 warps x 2)
constexpr int kColsPerThread = kCols / 32;
constexpr int kExt = 128;      // carried tail columns
constexpr int kMaxSmem = 232448;

struct MfbArgs {
  const void* x;           // (2D, n_out) at element strides (sd, sc)
  const void* tail;        // (2D, kExt), x's dtype
  const float* bank;       // (groups, rows, kStations, 2) float32
  const float* rotc;       // (Kp, a_cols) float32
  const float* rots;
  const float* base_r;     // (Kp, tile) float32
  const float* base_i;
  void* i_out;             // (K, n_out) float32 or bf16
  void* q_out;
  long long sd, sc, n_out;
  int u8, two_d, k, rows, n_shift, t_cols, a_cols, tile, bf16_compute,
      out_bf16;
};

__device__ __forceinline__ float decode(const void* p, long long i, int u8) {
  if (u8)
    return (float)(int8_t)(static_cast<const uint8_t*>(p)[i] ^ 0x80u) *
           (1.0f / 128.0f);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, size_t i, float v, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

__global__ void __launch_bounds__(kThreads)
    mfb_kernel(const __grid_constant__ MfbArgs a) {
  extern __shared__ float4 smem4[];
  float* bank = reinterpret_cast<float*>(smem4);   // [rows][kStations][2]
  const int w = kCols + a.n_shift - 1;              // staged columns
  float* xs = bank + a.rows * kStations * 2;        // [2D][w]
  const long long c0 = (long long)blockIdx.x * kCols;
  const int k0 = blockIdx.y * kStations;

  const float4* src =
      reinterpret_cast<const float4*>(a.bank) +
      (size_t)blockIdx.y * a.rows * (kStations / 2);
  for (int i = threadIdx.x; i < a.rows * (kStations / 2); i += kThreads)
    smem4[i] = src[i];
  const int nx = a.two_d * w;
  for (int i = threadIdx.x; i < nx; i += kThreads) {
    // neighbouring threads on neighbouring addresses in either layout
    int d, p;
    if (a.sd == 1) {
      d = i % a.two_d;
      p = i / a.two_d;
    } else {
      p = i % w;
      d = i / w;
    }
    const long long c = c0 - a.t_cols + p;
    float v = 0.f;
    if (c < 0)
      v = decode(a.tail, (long long)d * kExt + (kExt + c), a.u8);
    else if (c < a.n_out)
      v = decode(a.x, d * a.sd + c * a.sc, a.u8);
    if (a.bf16_compute) v = __bfloat162float(__float2bfloat16_rn(v));
    xs[d * w + p] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int pair = threadIdx.x >> 5;                // stations 2p, 2p + 1
  if (k0 + 2 * pair >= a.k) return;
  float ar[2][kColsPerThread] = {}, ai[2][kColsPerThread] = {};
  for (int s = 0; s < a.n_shift; ++s) {
    for (int d = 0; d < a.two_d; ++d) {
      const float4 b = smem4[(s * a.two_d + d) * (kStations / 2) + pair];
      const float* xr = xs + d * w + s + lane;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float x = xr[32 * j];
        ar[0][j] = fmaf(b.x, x, ar[0][j]);
        ai[0][j] = fmaf(b.y, x, ai[0][j]);
        ar[1][j] = fmaf(b.z, x, ar[1][j]);
        ai[1][j] = fmaf(b.w, x, ai[1][j]);
      }
    }
  }

#pragma unroll
  for (int st = 0; st < 2; ++st) {
    const int k = k0 + 2 * pair + st;
    if (k >= a.k) break;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const long long g = c0 + lane + 32 * j;
      if (g >= a.n_out) break;
      const int ta = (int)(g / a.tile);
      const int tb = (int)(g % a.tile);
      const float sr = a.rotc[(size_t)k * a.a_cols + ta];
      const float si = a.rots[(size_t)k * a.a_cols + ta];
      const float br = a.base_r[(size_t)k * a.tile + tb];
      const float bi = a.base_i[(size_t)k * a.tile + tb];
      const float cos_t = __fsub_rn(__fmul_rn(sr, br), __fmul_rn(si, bi));
      const float sin_t = __fadd_rn(__fmul_rn(sr, bi), __fmul_rn(si, br));
      const float cr = ar[st][j], ci = ai[st][j];
      const size_t o = (size_t)k * (size_t)a.n_out + (size_t)g;
      store(a.i_out, o,
            __fsub_rn(__fmul_rn(cr, cos_t), __fmul_rn(ci, sin_t)),
            a.out_bf16);
      store(a.q_out, o,
            __fadd_rn(__fmul_rn(cr, sin_t), __fmul_rn(ci, cos_t)),
            a.out_bf16);
    }
  }
}

}  // namespace

extern "C" {

// bank: the (2Kp, 2D*n_shift) bank packed as (ceil(Kp/16), rows, 16, 2)
// float32 (bf16 values for the bf16 engine); rotc/rots (Kp, a_cols),
// base_r/base_i (Kp, tile), a_cols * tile == n_out; n_shift <= t_cols + 1
// <= 129.
int sdr_mfb(const void* x, const void* tail, int u8, long long stride_d,
            long long stride_c, int two_d, long long n_out, const float* bank,
            int kp, int k, int n_shift, int t_cols, const float* rotc,
            const float* rots, int a_cols, const float* base_r,
            const float* base_i, int tile, int bf16_compute, void* i_out,
            void* q_out, int out_bf16, void* stream) {
  if (two_d < 2 || two_d > 256 || n_out < 1 || k < 1 || k > kp ||
      n_shift < 1 || n_shift > t_cols + 1 || t_cols > kExt || tile < 1 ||
      a_cols < 1 || (long long)a_cols * tile != n_out || stride_d < 1 ||
      stride_c < 1)
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
  a.u8 = u8;
  a.two_d = two_d;
  a.k = k;
  a.rows = two_d * n_shift;
  a.n_shift = n_shift;
  a.t_cols = t_cols;
  a.a_cols = a_cols;
  a.tile = tile;
  a.bf16_compute = bf16_compute;
  a.out_bf16 = out_bf16;
  const size_t smem =
      sizeof(float) * ((size_t)a.rows * kStations * 2 +
                       (size_t)two_d * (kCols + n_shift - 1));
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mfb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (n_out + kCols - 1) / kCols;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)((kp + kStations - 1) / kStations));
  mfb_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
