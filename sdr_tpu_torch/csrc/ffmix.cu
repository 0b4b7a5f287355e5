// Feedforward carrier synthesis + RDS all-pass delay + both mixers, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel sdr_tpu/ops/pallas/ffmix_kernel.py
// `_ffmix_kernel` (reached through `ffmix`).  Per station c and sample i
// of the block, with w = i / W the window and rel = (i mod W) - (W-1)/2:
//
//   nco_s = cos((ramp_s[i] + off_s[c,w]) + slope_s[c,w] * rel)
//   nco_r = cos((ramp_r[i] + off_r[c,w]) + slope_r[c,w] * rel)
//   mixed_s[c,i] = (2 * chan[c,i]) * nco_s
//   mixed_r[c,i] = (2 * rds[c,i-delay]) * nco_r
//
// where rds[c, j<0] is column 128+j of the carried (C, 128) rds tail.  The
// host has folded each engine's nco_scale and phase_adjust into the ramp
// rows (float64, then float32) and into the per-window (off, slope), as
// the reference does.  The cos argument is evaluated in the reference's
// order with _rn intrinsics, so nvcc contracts nothing into an FMA and the
// kernel matches its plain PyTorch version (which rounds every operation)
// up to cosf's last bit.  Build without --use_fast_math.
//
// What bounds it on the card: per sample it reads 2 x 2-4 bytes of stream
// and 8 bytes of ramp (shared by the stations, so from L2) and writes
// 2 x 2-4 bytes, against two accurate cosf (a few dozen instructions
// each); on paper HBM bounds it (0.79 GB for 128 stations x 768,000
// bf16 samples, ~0.27 ms).  The design: each thread takes 4 consecutive
// samples of one window, so the window's four parameters are loaded once
// per thread and the streams, ramps and outputs move as 8- or 16-byte
// vectors (a first version, one sample per thread and one block per
// window, took 0.66 ms).  The NCO streams, the delayed RDS stream and the
// per-window broadcasts never reach device memory; the TPU kernel's
// 0/1-matrix parameter expansion and lane roll do not carry over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kExtCols = 128;  // carried rds columns per station
constexpr int kThreads = 256;
constexpr int kR = 4;          // consecutive samples per thread

struct MixArgs {
  const void* chan;     // (C, n) float32 or bf16
  const void* rds;      // (C, n), chan's dtype
  const void* rtail;    // (C, kExtCols), chan's dtype
  const float* ramp_s;  // (n,) scaled + adjusted ramp rows
  const float* ramp_r;
  const float* off_s;   // (C, n / W) scaled per-window parameters
  const float* slp_s;
  const float* off_r;
  const float* slp_r;
  void* ms;             // (C, n) output dtype
  void* mr;
  long long n;
  int window;           // W
  int nwin;             // n / W
  int delay;
  float rel0;           // (W - 1) / 2
};

template <bool BF16>
__device__ __forceinline__ float load(const void* p, size_t i) {
  if constexpr (BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  else
    return static_cast<const float*>(p)[i];
}

// four consecutive values at element offset i (a multiple of 4)
template <bool BF16>
__device__ __forceinline__ void load4(const void* p, size_t i, float* v) {
  if constexpr (BF16) {
    const uint2 u =
        *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) +
                                        i);
    __nv_bfloat162 a, b;
    memcpy(&a, &u.x, 4);
    memcpy(&b, &u.y, 4);
    const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    v[0] = fa.x;
    v[1] = fa.y;
    v[2] = fb.x;
    v[3] = fb.y;
  } else {
    const float4 f =
        *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

template <bool BF16>
__device__ __forceinline__ void store4(void* p, size_t i, const float* v) {
  if constexpr (BF16) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    memcpy(&u.x, &a, 4);
    memcpy(&u.y, &b, 4);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) = u;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool IN_BF16, bool OUT_BF16>
__global__ void __launch_bounds__(kThreads)
    ffmix_kernel(const __grid_constant__ MixArgs a) {
  const int c = blockIdx.y;
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kR;
  if (i0 >= a.n) return;
  const size_t row = (size_t)c * (size_t)a.n;
  // n and W are multiples of 4, so the 4 samples share one window
  const int w = (int)(i0 / a.window);
  const int r0 = (int)(i0 - (long long)w * a.window);
  const size_t p = (size_t)c * a.nwin + w;
  const float o_s = a.off_s[p], s_s = a.slp_s[p];
  const float o_r = a.off_r[p], s_r = a.slp_r[p];
  const float4 rs4 = *reinterpret_cast<const float4*>(a.ramp_s + i0);
  const float4 rr4 = *reinterpret_cast<const float4*>(a.ramp_r + i0);
  const float ramp_s[kR] = {rs4.x, rs4.y, rs4.z, rs4.w};
  const float ramp_r[kR] = {rr4.x, rr4.y, rr4.z, rr4.w};
  float ch[kR], rd[kR], ms[kR], mr[kR];
  load4<IN_BF16>(a.chan, row + (size_t)i0, ch);
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const long long k = i0 + j - a.delay;
    rd[j] = k < 0 ? load<IN_BF16>(a.rtail, (size_t)c * kExtCols +
                                               (size_t)(kExtCols + k))
                  : load<IN_BF16>(a.rds, row + (size_t)k);
  }
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const float rel = __fsub_rn((float)(r0 + j), a.rel0);
    const float th_s = __fadd_rn(__fadd_rn(ramp_s[j], o_s),
                                 __fmul_rn(s_s, rel));
    const float th_r = __fadd_rn(__fadd_rn(ramp_r[j], o_r),
                                 __fmul_rn(s_r, rel));
    ms[j] = __fmul_rn(__fmul_rn(2.f, ch[j]), cosf(th_s));
    mr[j] = __fmul_rn(__fmul_rn(2.f, rd[j]), cosf(th_r));
  }
  store4<OUT_BF16>(a.ms, row + (size_t)i0, ms);
  store4<OUT_BF16>(a.mr, row + (size_t)i0, mr);
}

}  // namespace

extern "C" {

// window W a multiple of 4; n a multiple of W; 0 <= delay <= 128; chan
// 16-byte aligned.
int sdr_ffmix(const void* chan, const void* rds, const void* rtail,
              int in_bf16, int channels, long long n, int window, int delay,
              const void* ramp_s, const void* ramp_r, const void* off_s,
              const void* slp_s, const void* off_r, const void* slp_r,
              void* ms, void* mr, int out_bf16, void* stream) {
  if (channels < 1 || channels > 65535 || window < kR ||
      window % kR != 0 || n < window || n % window != 0 || delay < 0 ||
      delay > kExtCols)
    return (int)cudaErrorInvalidValue;
  MixArgs a;
  a.chan = chan;
  a.rds = rds;
  a.rtail = rtail;
  a.ramp_s = static_cast<const float*>(ramp_s);
  a.ramp_r = static_cast<const float*>(ramp_r);
  a.off_s = static_cast<const float*>(off_s);
  a.slp_s = static_cast<const float*>(slp_s);
  a.off_r = static_cast<const float*>(off_r);
  a.slp_r = static_cast<const float*>(slp_r);
  a.ms = ms;
  a.mr = mr;
  a.n = n;
  a.window = window;
  a.nwin = (int)(n / window);
  a.delay = delay;
  a.rel0 = (float)(window - 1) / 2.0f;
  const long long per_block = (long long)kThreads * kR;
  dim3 grid((unsigned)((n + per_block - 1) / per_block), (unsigned)channels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    if (out_bf16) ffmix_kernel<true, true><<<grid, kThreads, 0, s>>>(a);
    else ffmix_kernel<true, false><<<grid, kThreads, 0, s>>>(a);
  } else {
    if (out_bf16) ffmix_kernel<false, true><<<grid, kThreads, 0, s>>>(a);
    else ffmix_kernel<false, false><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
