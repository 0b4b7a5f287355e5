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
// accumulates in float32, as the reference does.
//
// What bounds it on the card: per output it reads D samples (2-4 bytes
// each) and writes 4 bytes, against 51 FMAs and shared-memory loads; with
// D = 5 that is bound by the FMA and shared-memory issue, not HBM.  The
// design, simple first: one block of 256 threads per (256 outputs,
// station, stream), one thread per output.  The block stages its input
// window, D*256 + 50 samples reaching back into the tail for the first
// block, in shared memory.  At 32 registers 8 blocks share an SM and hide
// each other's load latency: issuing all of a thread's staging loads
// before its stores took 49 registers, 5 blocks, and 1.02 ms instead of
// 0.62 ms at 128 stations x 768,000 samples.  The TPU kernel's dense band
// matmul (most of its FLOPs on zeros) and its clamped second BlockSpec do
// not carry over.
// A stride of D words between neighbouring threads has no bank conflict
// for odd D.  blockIdx.z picks the stream, so both run in one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

template <bool BF16_COMPUTE>
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
    xs[p] = BF16_COMPUTE ? __bfloat162float(__float2bfloat16_rn(v)) : v;
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

}  // namespace

extern "C" {

// taps: float32 [51] (bf16 values for the bf16 engine); n a multiple of
// down, at least 128.
int sdr_audio_pair(const void* xa, const void* xb, const void* tail_a,
                   const void* tail_b, int a_bf16, int b_bf16, int channels,
                   long long n, int down, const float* taps, int ntaps,
                   int bf16_compute, void* ya, void* yb, void* stream) {
  if (channels < 1 || channels > 65535 || ntaps != kTaps || down < 1 ||
      down > kMaxDown || n < kCtx || n % down != 0)
    return (int)cudaErrorInvalidValue;
  PairTaps h;
  memcpy(h.h, taps, sizeof(h.h));
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
  const int smem = (down * (kThreads - 1) + kTaps) * (int)sizeof(float);
  dim3 grid((unsigned)((a.m + kThreads - 1) / kThreads), (unsigned)channels,
            2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_compute)
    pair_kernel<true><<<grid, kThreads, smem, s>>>(a, h);
  else
    pair_kernel<false><<<grid, kThreads, smem, s>>>(a, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
