// Fused IF bank with the feedforward estimators' mix sums, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel sdr_tpu/ops/pallas/ifbank_kernel.py
// `_ifbank_mix_kernel` (reached through FusedIFBankMix.mix_call).  Per
// station row c of the demodulated IF stream fm (C, n) and its carried
// (C, 128) tail (tail ++ fm is the stream), with four 51-tap FIRs:
//
//   chan[p]  = sum_k h_chan[k]  fm[p-k]       stereo channel 22-54 kHz
//   pilot[p] = sum_k h_pilot[k] fm[p-k]       pilot 18.5-19.5 kHz
//   rds[p]   = sum_k h_rds[k]   fm[p-k]       RDS channel 54-60 kHz
//   carr[p]  = sum_k h_carr[k]  rds[p-k]^2    carrier 113.5-114.5 kHz
//
// it writes chan and rds (rounded to the output dtype) and, per window w
// of 256 samples, the coherent sums of the unrounded float32 pilot and
// carrier against the host's ramp tables:
//   zpr[w] = sum pilot*cos_p,  zpi[w] = sum pilot*(-sin_p),
//   zrr[w] = sum carr*cos_r,   zri[w] = sum carr*(-sin_r).
// The pilot and carrier streams never reach device memory.
//
// The bf16 compute engine rounds three things to bf16, as the reference
// does: the fm window, the taps (on the host), and rds^2 before the
// carrier FIR.  Products of bf16 values are exact in float32, and every
// sum accumulates in float32, tap by tap in order k = 0..50.
//
// What bounds it on the card: per output sample it reads 2-4 bytes of fm
// and 16 bytes of ramp table (shared by all stations, so from L2) and
// writes 4-8 bytes, against ~207 FMAs: on paper the FMA issue bounds it
// (0.69 ms at the float32 peak for 128 stations x 768,000 samples), not
// HBM (0.18 ms).  The design:
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
  float* zpr;           // (C, n / kWin)
  float* zpi;
  float* zrr;
  float* zri;
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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

template <bool IN_BF16, bool BF16_COMPUTE, bool OUT_BF16>
__global__ void __launch_bounds__(kThreads, 2)
    ifbank_mix_kernel(const __grid_constant__ BankArgs a,
                      const __grid_constant__ BankTaps h) {
  __shared__ __align__(16) float xs[kInLen];   // fm[t0 - kHalo + p]
  __shared__ __align__(16) float rs[kRdsLen];  // rds[t0 - kExt + q]
  __shared__ __align__(16) float sq[kRdsLen];  // rds^2, rounded as the
                                               // engine rounds
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
  if (valid) {
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
      if (p < kInLen) xs[p] = BF16_COMPUTE ? round_bf16(v[u]) : v[u];
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
      const float v = __fmul_rn(acc[j], acc[j]);
      s[j] = BF16_COMPUTE ? round_bf16(v) : v;
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

template <bool IN_BF16, bool BF16_COMPUTE>
void launch_out(bool out_bf16, dim3 grid, cudaStream_t s, const BankArgs& a,
                const BankTaps& h) {
  if (out_bf16)
    ifbank_mix_kernel<IN_BF16, BF16_COMPUTE, true>
        <<<grid, kThreads, 0, s>>>(a, h);
  else
    ifbank_mix_kernel<IN_BF16, BF16_COMPUTE, false>
        <<<grid, kThreads, 0, s>>>(a, h);
}

template <bool IN_BF16>
void launch_compute(bool bf16_compute, bool out_bf16, dim3 grid,
                    cudaStream_t s, const BankArgs& a, const BankTaps& h) {
  if (bf16_compute)
    launch_out<IN_BF16, true>(out_bf16, grid, s, a, h);
  else
    launch_out<IN_BF16, false>(out_bf16, grid, s, a, h);
}

}  // namespace

extern "C" {

// taps: float32 [4][51] (chan, pilot, rds, carrier), already rounded to
// bf16 values for the bf16 engine; n must be a multiple of 256.
int sdr_ifbank_mix(const void* fm, const void* tail, int fm_bf16,
                   int channels, long long n, const float* taps, int ntaps,
                   int bf16_compute, const void* cos_p, const void* sin_p,
                   const void* cos_r, const void* sin_r, void* chan,
                   void* rdsch, int out_bf16, void* zpr, void* zpi,
                   void* zrr, void* zri, void* stream) {
  if (channels < 1 || channels > 65535 || ntaps != kTaps || n < kWin ||
      n % kWin != 0)
    return (int)cudaErrorInvalidValue;
  BankTaps h;
  memcpy(&h, taps, sizeof(h));
  BankArgs a;
  a.fm = fm;
  a.tail = tail;
  a.cos_p = static_cast<const float*>(cos_p);
  a.sin_p = static_cast<const float*>(sin_p);
  a.cos_r = static_cast<const float*>(cos_r);
  a.sin_r = static_cast<const float*>(sin_r);
  a.chan = chan;
  a.rdsch = rdsch;
  a.zpr = static_cast<float*>(zpr);
  a.zpi = static_cast<float*>(zpi);
  a.zrr = static_cast<float*>(zrr);
  a.zri = static_cast<float*>(zri);
  a.n = n;
  dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)channels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fm_bf16)
    launch_compute<true>(bf16_compute, out_bf16, grid, s, a, h);
  else
    launch_compute<false>(bf16_compute, out_bf16, grid, s, a, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
