// Carrier-loop PLL kernels for Hopper (sm_90a): the sequential loop and
// the chunked frozen-feedback loop.
//
// Replaces three Pallas kernels of sdr_tpu/ops/pallas/pll_kernel.py:
//   - `_pll_kernel` (via pll_pallas): sdr_pll_multi below, G loops in one
//     launch (G = 1 is the single loop).  With exact=1 (libm
//     atan2f) it also runs the scan engine sdr_tpu/ops/pll.py `pll`, in
//     both of its modes (wrap_phase, and the reference's trigOffset
//     counter that compat_pll selects) and with or without lag correction;
//   - `_pll_chunked_kernel` (via pll_pallas_chunked) and
//     `_pll_chunked_kernel_multi` (via pll_pallas_chunked_multi):
//     sdr_pll_chunked below, one kernel for G instances with their own
//     loop parameters (G = 1 is the single loop).  With exact=1 it also
//     runs sdr_tpu/ops/pll.py `pll_chunked`.
//
// The sequential loop, per channel and sample i:
//   e     = atan2(-x_i fbq, x_i fbi)           phase detector
//   integ = integ + ki e                        PI loop filter
//   wrap:     acc = mod(acc + w0 + kp e + integ, wmod); arg = acc
//   counter:  acc = acc + kp e + integ; trig += 1; arg = w0 trig + acc
//   fbi, fbq = cos(arg), sin(arg)
//   nco_i = cos((arg - w0 [lag correction]) scale + adj)
//
// The chunked loop freezes the feedback over a chunk of K samples: from
// the carried (integ, acc) it predicts pred_j = acc + j (w0 + integ) for
// j = 0..K-1, measures every e_j at once, and applies the K PI updates
// exactly from two inclusive prefix sums, ce = cumsum(e) and cumsum(ce):
//   acc_j = acc + (j+1) w0 + kp ce_j + ((j+1) integ + ki cumsum(ce)_j)
// and carries integ + ki ce_{K-1}, mod(acc_{K-1}, wmod).
//
// Every operation rounds where the reference rounds it: the products and
// sums by __fmul_rn/__fadd_rn (nvcc would contract them into FMAs), the
// floor modulo as fmodf plus the sign fix (jnp.mod, torch.remainder), and
// cosf/sinf/atan2f from libm, never the fast intrinsics: in the counter
// mode `arg` grows without bound and reaches 1e5 rad.  atan2f keeps IEEE
// signed zeros (atan2f(+-0, -1) = +-pi); the polynomial keeps the
// reference's own behaviour there (0 at (0, 0), +pi at (-0, -1)).
//
// What bounds them on the card:
//   - the sequential loop is one dependent chain per channel and sample:
//     atan2 -> PI update -> mod -> sin/cos -> next atan2, a few hundred
//     cycles.  A step has only C x G channels (128-256), each a lane, on
//     132 SMs: the chain's latency bounds it, not memory (4-8 bytes per
//     sample) and not issue.  n x (the chain's cycles a sample) at the
//     card's clock is its real bound; chain_floor_kernel measures those
//     cycles (one thread, its input staged in shared memory, nothing else
//     issued).  The design (pll_loop_kernel): every loop of a receiver
//     step in one launch (G instances, each on its own blocks, so the
//     pilot and RDS loops run side by side), and warp specialisation, so
//     that the chain's warp issues only the recurrence: a producer warp
//     stages x into a shared ring ahead of it, consumer warps take the
//     NCO's cos (half the libm work of a sample) and its stores off it and
//     write nco in coalesced row segments.  32 channels a block: one chain
//     warp's lanes; the block has 4 warps, one per scheduler of the SM, so
//     the chain warp has a scheduler to itself; its loop is unrolled by 2
//     (of 1, 2 and 4 the fastest on the card, at the same bits).  Rings of
//     4 slots of 32 samples: the producer and the consumers have 3 tiles of
//     slack each, ~45,000 cycles of the chain, and the rings take 34 KB.
//     The producer uses plain loads (a bf16 row may start on any element,
//     which cp.async's 4-byte minimum does not take; it moves 4 bytes per
//     channel per ~500 cycles).  The wrap's floor modulo takes an exact
//     shortcut: fmodf every sample took the exact mode from ~262 to ~301
//     ms at 128 x 768,000 (PERF.md).
//   - the chunked loop has a chain per chunk instead of per sample.  One
//     segment of W lanes (W = K rounded up to a power of two, at most 32)
//     owns one (instance, channel); lane j evaluates sample j of the chunk
//     (chunks longer than 32 take sub-blocks of 32 in turn).  With K = 16
//     a warp runs two channels.  At 128 x 768,000 the joint launch has 256
//     such warps, one per scheduler of 64-128 SMs, so only the chain's
//     latency counts.  The carried state needs only two sums a chunk,
//     ce = sum_j e_j and cs = sum_j cumsum(ce)_j = sum_j (K - j) e_j, and
//     nothing in the reference orders them (its cumsums are triangular
//     matmuls); so the design (pll_chunked_kernel) gives the chain only
//     the recurrence: the prediction pred_j = acc + j (w0 + integ), one
//     sincosf (the bits of sinf and cosf, sdr_sincos_check), the detector,
//     a xor butterfly of the pair (e_j, (K - j) e_j) that leaves both sums
//     in every lane (log2 W dependent shuffle levels, where the two
//     inclusive scans and the broadcast took 2 log2 W + 1), the PI update
//     at j = K and the wrap.  The wrap's floor modulo takes an exact
//     quotient shortcut (mod_floor_q).  The per-sample phases and the
//     NCO's cos leave the chain warp with the stores, as in the sequential
//     loop: per block 2 chain warps, one NCO warp each and one producer
//     warp, around shared rings of 8-row slots guarded by mbarriers.  The
//     producer stages x (widened to float32) 3 slots ahead; the chain
//     writes each row's e_j and its chunk's (acc, integ); the NCO warp
//     forms cumsum(e) and cumsum(cumsum(e)) by one pair scan of 5 levels
//     and writes nco in coalesced rows.  chunk_floor_kernel measures the
//     floor: one warp a loop instance over x in shared memory, the chain
//     alone (the same device functions, so its state equals the kernel's
//     bit for bit), timed by clock64 and %globaltimer like
//     chain_floor_kernel.
//   - The TPU's lane padding to 128, its time-major transpose and its
//     lower-triangular matmuls do not carry over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxGroups = 4;       // instances of one chunked launch

// Input samples are loaded ahead of their use as raw bits (Raw1) and
// widened to float32 only where they are used: a conversion right after
// the load would stall the warp on the load and undo the prefetch.
template <bool BF16>
using Raw1 = std::conditional_t<BF16, __nv_bfloat16, float>;

template <bool BF16>
__device__ __forceinline__ Raw1<BF16> load1(const void* p, size_t i) {
  return static_cast<const Raw1<BF16>*>(p)[i];
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// floor modulo: the result takes the divisor's sign (jnp.mod), fmodf plus
// the sign fix.  The sequential loop calls it every sample on a phase
// that has moved by less than a period since the last wrap, so FAST takes
// a shortcut first: for b > 0 and -b < a < 2b, fmodf(a, b) is a, or
// a - b, which is exact (Sterbenz: b <= a <= 2b), so the result is the
// same bits as the general path.  (The chunked loop's phase moves by up to
// K w0 a chunk, past 2b: it takes mod_floor_q.)
template <bool FAST>
__device__ __forceinline__ float mod_floor(float a, float b) {
  if (FAST && b > 0.f && a > -b && a < __fmul_rn(2.f, b)) {
    if (a < 0.f) return __fadd_rn(a, b);   // fmodf = a, then + b
    return a >= b ? __fsub_rn(a, b) : a;
  }
  float r = fmodf(a, b);
  if (r != 0.f && ((r < 0.f) != (b < 0.f))) r = __fadd_rn(r, b);
  return r;
}

// mod_floor by the quotient, the same bits: for b > 0 and |a| < 2^20 b,
// q = trunc(a * (1/b)) is trunc(a / b) or one off it.  With the true q,
// a - q b is fmodf's result, which is representable, so one fma gives it
// exactly; a q one off leaves a value outside fmodf's range (same sign as
// a, below b in magnitude), and that case takes the general path.  A zero
// takes a's sign, as fmodf's does.
__device__ __forceinline__ float mod_floor_q(float a, float b, float inv_b) {
  if (b > 0.f && fabsf(a) < __fmul_rn(1048576.f, b)) {
    const float q = truncf(__fmul_rn(a, inv_b));
    const float r = fmaf(-q, b, a);
    if (a >= 0.f ? (r >= 0.f && r < b) : (r <= 0.f && r > -b)) {
      if (r == 0.f) return copysignf(0.f, a);
      return r < 0.f ? __fadd_rn(r, b) : r;
    }
  }
  return mod_floor<false>(a, b);
}

// sdr_tpu/ops/pallas/pll_kernel.py `_atan2_poly`: octant reduction and a
// degree-9 minimax polynomial, each operation rounded in its order
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ay = fabsf(y), ax = fabsf(x);
  const bool swap = ay > ax;
  const float num = swap ? ax : ay;
  const float den = swap ? ay : ax;
  const float z = __fdiv_rn(num, fmaxf(den, 1e-30f));
  const float a = __fmul_rn(z, z);
  float p = __fadd_rn(0.05265332f, __fmul_rn(a, -0.01172120f));
  p = __fadd_rn(-0.11643287f, __fmul_rn(a, p));
  p = __fadd_rn(0.19354346f, __fmul_rn(a, p));
  p = __fadd_rn(-0.33262347f, __fmul_rn(a, p));
  p = __fadd_rn(0.99997726f, __fmul_rn(a, p));
  p = __fmul_rn(z, p);
  float r = swap ? __fsub_rn(1.57079632679489661923f, p) : p;
  r = x < 0.f ? __fsub_rn(3.14159265358979323846f, r) : r;
  return y < 0.f ? -r : r;
}

template <bool EXACT>
__device__ __forceinline__ float detect(float y, float x) {
  if constexpr (EXACT)
    return atan2f(y, x);
  else
    return atan2_poly(y, x);
}

struct LoopParams {
  float kp, ki, w0, wmod, scale, adj;
};

// ---------------------------------------------------------- sequential loop
// One channel's loop state, kept in registers by the chain warp.
struct Chain {
  float integ, acc, fbi, fbq, trig;
};

// One sample of the recurrence: updates the state and returns `out`, the
// NCO's argument before the scale (the feedback's own sin/cos stay on the
// chain; the NCO's cos does not).
template <bool EXACT, bool WRAP, bool LAG>
__device__ __forceinline__ float chain_step(Chain& s, float xi,
                                            const LoopParams& p) {
  const float e =
      detect<EXACT>(__fmul_rn(xi, -s.fbq), __fmul_rn(xi, s.fbi));
  s.integ = __fadd_rn(s.integ, __fmul_rn(p.ki, e));
  float arg;
  if constexpr (WRAP) {
    s.acc = mod_floor<true>(
        __fadd_rn(__fadd_rn(__fadd_rn(s.acc, p.w0), __fmul_rn(p.kp, e)),
                  s.integ),
        p.wmod);
    arg = s.acc;
  } else {
    s.acc = __fadd_rn(__fadd_rn(s.acc, __fmul_rn(p.kp, e)), s.integ);
    s.trig = __fadd_rn(s.trig, 1.f);
    arg = __fadd_rn(__fmul_rn(p.w0, s.trig), s.acc);
  }
  // the feedback pair by one sincosf (one range reduction): it gives the
  // bits of cosf and sinf for every finite float32 on the card
  // (sdr_sincos_check, chip_smoke.py phase 2c)
  sincosf(arg, &s.fbq, &s.fbi);
  return LAG ? __fsub_rn(arg, p.w0) : arg;
}

__device__ __forceinline__ float nco_of(float out, const LoopParams& p) {
  return cosf(__fadd_rn(__fmul_rn(out, p.scale), p.adj));
}

// mbarriers in shared memory (sm_90): arrive has release and try_wait
// acquire semantics at CTA scope, so the stores to a ring slot made before
// an arrive are seen by the threads that waited on it.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(b))
               : "memory");
}

// waits until the phase of the given parity has completed; on a fresh
// barrier, parity 1 (the phase "before" the first) counts as completed
__device__ __forceinline__ void bar_wait(uint64_t* b, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// The warp-specialised sequential loop.  A block owns kLanes channels of one
// instance and has 2 + kConsumers warps:
//   warp 0, the chain: lane j runs channel j's recurrence with its state in
//     registers; it reads x from the x ring and writes each sample's `out`
//     into the out ring, and does nothing else;
//   warp 1, the producer: stages x tiles (kLanes channels x kTile samples,
//     widened to float32) into the x ring, kSlots tiles ahead of the chain;
//     lane i loads sample i of each channel, so each load is one row's
//     consecutive samples;
//   warps 2.., the consumers: nco = cos(out scale + adj) from the out ring,
//     lane i on sample i of a channel, so the stores of a warp are one row's
//     consecutive samples (coalesced), not one lane per row.
// Each ring slot is a (kTile, kLanes + 1) float32 array: the chain reads and
// writes row i across lanes, the producer and consumers column c across
// lanes, both conflict-free.  One mbarrier per slot and direction signals
// full and empty.
constexpr int kLanes = 32;      // channels of a block: the chain warp's lanes
constexpr int kTile = 32;       // samples of a ring slot
constexpr int kSlots = 4;       // ring depth
constexpr int kConsumers = 2;   // NCO warps
constexpr int kLoopThreads = 32 * (2 + kConsumers);
constexpr int kPad = kLanes + 1;
constexpr int kMaxLoops = 4;    // instances of one launch

struct LoopArgs {
  const void* x[kMaxLoops];      // (C_g, n) float32 or bf16
  const float* st_in[kMaxLoops];  // (5, C_g): integ, acc, fbi, fbq, trig
  float* nco[kMaxLoops];         // (C_g, n) float32
  float* st_out[kMaxLoops];      // (5, C_g)
  int channels[kMaxLoops];
  int first_block[kMaxLoops];    // the instance's first block
  LoopParams p[kMaxLoops];
  int loops;
  long long n;
};

template <bool BF16, bool EXACT, bool WRAP, bool LAG>
__global__ void __launch_bounds__(kLoopThreads, 1)
    pll_loop_kernel(const __grid_constant__ LoopArgs a) {
  __shared__ float xring[kSlots][kTile][kPad];
  __shared__ float oring[kSlots][kTile][kPad];
  // x staged, x slot free, out staged, out slot free
  __shared__ uint64_t bars[4][kSlots];

  int g = 0;
  for (int k = 1; k < a.loops; ++k)
    if ((int)blockIdx.x >= a.first_block[k]) g = k;
  const void* x = nullptr;
  const float* st_in = nullptr;
  float* nco = nullptr;
  float* st_out = nullptr;
  LoopParams p = a.p[0];
  int channels = 0, first = 0;
#pragma unroll
  for (int k = 0; k < kMaxLoops; ++k)
    if (k == g) {
      x = a.x[k];
      st_in = a.st_in[k];
      nco = a.nco[k];
      st_out = a.st_out[k];
      p = a.p[k];
      channels = a.channels[k];
      first = a.first_block[k];
    }
  const int c0 = ((int)blockIdx.x - first) * kLanes;
  const int live = min(kLanes, channels - c0);   // channels of this block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      bar_init(&bars[0][s], 32);
      bar_init(&bars[1][s], 32);
      bar_init(&bars[2][s], 32);
      bar_init(&bars[3][s], 32 * kConsumers);
    }
  }
  __syncthreads();
  const long long n = a.n;
  const long long tiles = (n + kTile - 1) / kTile;

  if (warp == 0) {
    // the chain
    const int c = c0 + lane;
    Chain s{0.f, 0.f, 1.f, 0.f, 0.f};
    if (lane < live)
      s = Chain{st_in[c], st_in[channels + c], st_in[2 * channels + c],
                st_in[3 * channels + c], st_in[4 * channels + c]};
    for (long long t = 0; t < tiles; ++t) {
      const int slot = (int)(t % kSlots);
      const unsigned par = (unsigned)((t / kSlots) & 1);
      const int cnt = (int)min((long long)kTile, n - t * kTile);
      bar_wait(&bars[0][slot], par);
      bar_wait(&bars[3][slot], par ^ 1u);
      const float* xr = &xring[slot][0][lane];
      float* orow = &oring[slot][0][lane];
      float xn = xr[0];
#pragma unroll 2
      for (int i = 0; i < cnt; ++i) {
        const float xi = xn;
        if (i + 1 < cnt) xn = xr[(i + 1) * kPad];   // ahead of the chain
        orow[i * kPad] = chain_step<EXACT, WRAP, LAG>(s, xi, p);
      }
      bar_arrive(&bars[1][slot]);
      bar_arrive(&bars[2][slot]);
    }
    if (lane < live) {
      st_out[c] = s.integ;
      st_out[channels + c] = s.acc;
      st_out[2 * channels + c] = s.fbi;
      st_out[3 * channels + c] = s.fbq;
      st_out[4 * channels + c] = s.trig;
    }
  } else if (warp == 1) {
    // the producer
    for (long long t = 0; t < tiles; ++t) {
      const int slot = (int)(t % kSlots);
      const unsigned par = (unsigned)((t / kSlots) & 1);
      const int cnt = (int)min((long long)kTile, n - t * kTile);
      bar_wait(&bars[1][slot], par ^ 1u);
      const size_t i = (size_t)(t * kTile + lane);
      float v[kLanes];
#pragma unroll
      for (int ch = 0; ch < kLanes; ++ch)
        v[ch] = (ch < live && lane < cnt)
                    ? widen(load1<BF16>(x, (size_t)(c0 + ch) * (size_t)n + i))
                    : 0.f;
#pragma unroll
      for (int ch = 0; ch < kLanes; ++ch) xring[slot][lane][ch] = v[ch];
      bar_arrive(&bars[0][slot]);
    }
  } else {
    // the consumers
    const int cw = warp - 2;
    for (long long t = 0; t < tiles; ++t) {
      const int slot = (int)(t % kSlots);
      const unsigned par = (unsigned)((t / kSlots) & 1);
      const int cnt = (int)min((long long)kTile, n - t * kTile);
      bar_wait(&bars[2][slot], par);
      if (lane < cnt) {
        const size_t i = (size_t)(t * kTile + lane);
#pragma unroll 4
        for (int ch = cw; ch < live; ch += kConsumers)
          nco[(size_t)(c0 + ch) * (size_t)n + i] =
              nco_of(oring[slot][lane][ch], p);
      }
      bar_arrive(&bars[3][slot]);
    }
  }
}

template <bool BF16, bool EXACT>
void launch_loop_flags(bool wrap, bool lag, dim3 grid, cudaStream_t s,
                       const LoopArgs& a) {
#define SDR_LOOP(W, L) \
  pll_loop_kernel<BF16, EXACT, W, L><<<grid, kLoopThreads, 0, s>>>(a)
  if (wrap) {
    if (lag) SDR_LOOP(true, true); else SDR_LOOP(true, false);
  } else {
    if (lag) SDR_LOOP(false, true); else SDR_LOOP(false, false);
  }
#undef SDR_LOOP
}

void launch_loop(bool bf16, bool exact, bool wrap, bool lag, dim3 grid,
                 cudaStream_t s, const LoopArgs& a) {
  if (bf16) {
    if (exact) launch_loop_flags<true, true>(wrap, lag, grid, s, a);
    else launch_loop_flags<true, false>(wrap, lag, grid, s, a);
  } else {
    if (exact) launch_loop_flags<false, true>(wrap, lag, grid, s, a);
    else launch_loop_flags<false, false>(wrap, lag, grid, s, a);
  }
}

// The chain's floor: one thread runs the recurrence alone over x (n <=
// kFloorN samples) staged in shared memory, the loop of the chain warp
// (unrolled by 2, as there) without its barriers and its out-ring stores: the next sample is read
// one step ahead, the outputs are summed off the chain (so that nothing is
// optimised away).  Writes the loop's clock64 cycles and its %globaltimer
// nanoseconds (the time at whatever clock the SM ran), the final state and
// the sum.
constexpr int kFloorN = 8192;

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

template <bool EXACT, bool WRAP, bool LAG>
__global__ void chain_floor_kernel(const float* __restrict__ x, int n,
                                   const float* __restrict__ st_in,
                                   float* __restrict__ st_out,
                                   long long* __restrict__ timing,
                                   LoopParams p) {
  __shared__ float xs[kFloorN];
  for (int i = 0; i < n; ++i) xs[i] = x[i];
  Chain s{st_in[0], st_in[1], st_in[2], st_in[3], st_in[4]};
  float sink = 0.f;
  float xn = xs[0];
  const long long g0 = global_ns();
  const long long t0 = clock64();
#pragma unroll 2
  for (int i = 0; i < n; ++i) {
    const float xi = xn;
    if (i + 1 < n) xn = xs[i + 1];
    sink = __fadd_rn(sink, chain_step<EXACT, WRAP, LAG>(s, xi, p));
  }
  asm volatile("mov.b32 %0, %0;" : "+f"(s.fbi));
  const long long t1 = clock64();
  const long long g1 = global_ns();
  st_out[0] = s.integ;
  st_out[1] = s.acc;
  st_out[2] = s.fbi;
  st_out[3] = s.fbq;
  st_out[4] = s.trig;
  st_out[5] = sink;
  timing[0] = t1 - t0;
  timing[1] = g1 - g0;
}

// Counts the finite float32 arguments where sincosf differs in any bit
// from (sinf, cosf): the check that allows chain_step's sincosf.
__global__ void sincos_check_kernel(unsigned long long* differ) {
  unsigned long long cnt = 0;
  for (uint64_t u = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
       u < (1ull << 32); u += (uint64_t)gridDim.x * blockDim.x) {
    const float v = __uint_as_float((uint32_t)u);
    if (!isfinite(v)) continue;
    float sn, cs;
    sincosf(v, &sn, &cs);
    cnt += __float_as_uint(sn) != __float_as_uint(sinf(v)) ||
           __float_as_uint(cs) != __float_as_uint(cosf(v));
  }
  atomicAdd(differ, cnt);
}

// ------------------------------------------------------------ chunked loop
struct ChunkArgs {
  const void* x[kMaxGroups];     // (C_g, n) float32 or bf16
  const float* st_in[kMaxGroups];  // (5, C_g): rows integ, acc are read
  float* nco[kMaxGroups];        // (C_g, n)
  float* st_out[kMaxGroups];     // (4, C_g): integ, acc, cos acc, sin acc
  int channels[kMaxGroups];
  LoopParams p[kMaxGroups];
  int groups;
  int chunk;   // K, divides n
  int width;   // W: lanes of a segment, a power of two <= 32
  long long n;
};

// The chain of one chunk, shared by pll_chunked_kernel and
// chunk_floor_kernel so that both give the same bits.  Lane j's error at
// sample j of the chunk (0 where the lane has no sample), from the frozen
// feedback: pred_j = acc + j wi, wi = w0 + integ.
template <bool EXACT>
__device__ __forceinline__ float chunk_error(float xv, float acc, float wi,
                                             int j, bool act) {
  const float pred = __fadd_rn(acc, __fmul_rn((float)j, wi));
  float sn, cs;
  sincosf(pred, &sn, &cs);
  const float e = detect<EXACT>(__fmul_rn(xv, -sn), __fmul_rn(xv, cs));
  return act ? e : 0.f;
}

// The chunk's end.  se, sw: the lane's sums of e_j and (K - j) e_j over
// its sub-blocks; a xor butterfly over the segment's W lanes leaves
// ce = sum e and cs = sum (K - j) e = sum_j cumsum(ce)_j in every lane (a
// lane and its partner add the same two values: the same bits); then the
// PI update at j = K, in the order of the per-sample phases, and the wrap.
__device__ __forceinline__ void chunk_update(float se, float sw, int width,
                                             float kf, const LoopParams& p,
                                             float inv_wmod, float& integ,
                                             float& acc) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d < width) {
      se = __fadd_rn(se, __shfl_xor_sync(0xffffffffu, se, d));
      sw = __fadd_rn(sw, __shfl_xor_sync(0xffffffffu, sw, d));
    }
  }
  const float acc_last = __fadd_rn(
      __fadd_rn(__fadd_rn(acc, __fmul_rn(kf, p.w0)), __fmul_rn(p.kp, se)),
      __fadd_rn(__fmul_rn(kf, integ), __fmul_rn(p.ki, sw)));
  integ = __fadd_rn(integ, __fmul_rn(p.ki, se));
  acc = mod_floor_q(acc_last, p.wmod, inv_wmod);
}

// The warp-specialised chunked loop.  A block has kChainWarps chain warps,
// one NCO warp for each and one producer warp (warps 0-1, 2-3 and 4: each
// chain warp and each NCO warp on a scheduler of its own when the block
// has the SM to itself).  A row is one 32-lane step of a chain warp: the
// sub-block sb of one chunk of its channels (W lanes each).  Per chain
// warp three rings of kCSlots slots of kRows rows:
//   x:  the producer stages each lane's sample (widened to float32, 0 for
//       a lane without one), kCSlots - 1 slots ahead;
//   e:  the chain writes each lane's error e_j,
//   st: and its chunk's (acc, integ) at the chunk's start;
// the NCO warp forms per row the segment's inclusive cumsum(e) (plus the
// chunk's earlier sub-blocks) and cumsum(cumsum(e)) by one pair scan,
// then acc_j and nco = cos(arg scale + adj), one row segment's
// consecutive samples per store.  One mbarrier per slot and direction.
constexpr int kChainWarps = 2;
constexpr int kRows = 8;       // rows of a ring slot
constexpr int kCSlots = 4;     // ring depth
constexpr int kChunkThreads = 32 * (2 * kChainWarps + 1);

// segment lane l of a block's chain warp cw -> (instance g, channel c);
// live is false for segments past the last channel, which run on zeros so
// that the warp's shuffles stay converged
struct ChunkLane {
  int g;
  long long c;
  bool live;
};

__device__ __forceinline__ ChunkLane chunk_lane(const ChunkArgs& a, int cw,
                                                int lane) {
  long long c = ((long long)blockIdx.x * kChainWarps + cw) * (32 / a.width) +
                lane / a.width;
  int g = 0;
  while (g < a.groups && c >= a.channels[g]) c -= a.channels[g++];
  return ChunkLane{g, c, g < a.groups};
}

template <bool BF16, bool EXACT, bool LAG>
__global__ void __launch_bounds__(kChunkThreads, 1)
    pll_chunked_kernel(const __grid_constant__ ChunkArgs a) {
  __shared__ float xring[kChainWarps][kCSlots][kRows][32];
  __shared__ float ering[kChainWarps][kCSlots][kRows][32];
  __shared__ float2 sring[kChainWarps][kCSlots][kRows][32];
  // x staged, x slot free, e staged, e slot free
  __shared__ uint64_t bars[kChainWarps][4][kCSlots];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kChainWarps; ++w)
      for (int s = 0; s < kCSlots; ++s)
        for (int k = 0; k < 4; ++k) bar_init(&bars[w][k][s], 32);
  }
  __syncthreads();
  const int K = a.chunk, W = a.width;
  const int rpc = (K + W - 1) / W;               // rows a chunk
  const int seg_lane = lane & (W - 1);
  const long long n = a.n;
  const long long rows = (n / K) * rpc;
  const long long slots = (rows + kRows - 1) / kRows;

  if (warp < kChainWarps) {
    // the chain
    const int cw = warp;
    const ChunkLane L = chunk_lane(a, cw, lane);
    LoopParams p = a.p[0];
    float integ = 0.f, acc = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxGroups; ++k)
      if (L.live && k == L.g) {
        p = a.p[k];
        integ = a.st_in[k][L.c];
        acc = a.st_in[k][a.channels[k] + L.c];
      }
    const float inv_wmod = __frcp_rn(p.wmod);
    const float kf = (float)K;
    float wi = 0.f, se = 0.f, sw = 0.f;
    int sb = 0;
    for (long long t = 0; t < slots; ++t) {
      const int slot = (int)(t % kCSlots);
      const unsigned par = (unsigned)((t / kCSlots) & 1);
      const int cnt = (int)min((long long)kRows, rows - t * kRows);
      bar_wait(&bars[cw][0][slot], par);
      bar_wait(&bars[cw][3][slot], par ^ 1u);
      for (int r = 0; r < cnt; ++r) {
        const float xv = xring[cw][slot][r][lane];
        if (sb == 0) {
          wi = __fadd_rn(p.w0, integ);
          se = sw = 0.f;
        }
        const int j = sb * W + seg_lane;
        const float e = chunk_error<EXACT>(xv, acc, wi, j, L.live && j < K);
        ering[cw][slot][r][lane] = e;
        sring[cw][slot][r][lane] = make_float2(acc, integ);
        se = __fadd_rn(se, e);
        sw = __fadd_rn(sw, __fmul_rn((float)(K - j), e));
        if (++sb == rpc) {
          sb = 0;
          chunk_update(se, sw, W, kf, p, inv_wmod, integ, acc);
        }
      }
      bar_arrive(&bars[cw][1][slot]);
      bar_arrive(&bars[cw][2][slot]);
    }
    if (L.live && seg_lane == 0) {
#pragma unroll
      for (int k = 0; k < kMaxGroups; ++k)
        if (k == L.g) {
          const int ch = a.channels[k];
          a.st_out[k][L.c] = integ;
          a.st_out[k][ch + L.c] = acc;
          a.st_out[k][2 * ch + L.c] = cosf(acc);
          a.st_out[k][3 * ch + L.c] = sinf(acc);
        }
    }
  } else if (warp < 2 * kChainWarps) {
    // the NCO of chain warp cw
    const int cw = warp - kChainWarps;
    const ChunkLane L = chunk_lane(a, cw, lane);
    LoopParams p = a.p[0];
    float* nco = nullptr;
#pragma unroll
    for (int k = 0; k < kMaxGroups; ++k)
      if (L.live && k == L.g) {
        p = a.p[k];
        nco = a.nco[k];
      }
    const size_t row0 = L.live ? (size_t)L.c * (size_t)n : 0;
    long long chunk = 0;
    int sb = 0;
    float ce_c = 0.f, cs_c = 0.f;
    for (long long t = 0; t < slots; ++t) {
      const int slot = (int)(t % kCSlots);
      const unsigned par = (unsigned)((t / kCSlots) & 1);
      const int cnt = (int)min((long long)kRows, rows - t * kRows);
      bar_wait(&bars[cw][2][slot], par);
#pragma unroll 2
      for (int r = 0; r < cnt; ++r) {
        const float e = ering[cw][slot][r][lane];
        const float2 st = sring[cw][slot][r][lane];   // (acc, integ)
        // the pair scan over the segment: (ce, cs) of [i, j] combine with
        // the d samples after them as ce = ce_a + ce_b, cs = cs_a + cs_b +
        // d ce_a
        float ce = e, cs = e;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          if (d < W) {
            const float ca = __shfl_up_sync(0xffffffffu, ce, d, W);
            const float sa = __shfl_up_sync(0xffffffffu, cs, d, W);
            if (seg_lane >= d) {
              cs = __fadd_rn(__fadd_rn(sa, cs), __fmul_rn((float)d, ca));
              ce = __fadd_rn(ca, ce);
            }
          }
        }
        const int j = sb * W + seg_lane;
        if (sb > 0) {   // the chunk's earlier sub-blocks
          cs = __fadd_rn(__fadd_rn(cs_c, __fmul_rn((float)(seg_lane + 1),
                                                   ce_c)), cs);
          ce = __fadd_rn(ce_c, ce);
        }
        const float jf = (float)(j + 1);
        const float acc_j = __fadd_rn(
            __fadd_rn(__fadd_rn(st.x, __fmul_rn(jf, p.w0)),
                      __fmul_rn(p.kp, ce)),
            __fadd_rn(__fmul_rn(jf, st.y), __fmul_rn(p.ki, cs)));
        if (L.live && j < K) {
          const float out = LAG ? __fsub_rn(acc_j, p.w0) : acc_j;
          nco[row0 + (size_t)(chunk * K + j)] =
              cosf(__fadd_rn(__fmul_rn(out, p.scale), p.adj));
        }
        if (++sb == rpc) {
          sb = 0;
          ++chunk;
        } else {
          const int last = W - 1;   // a sub-block before the last is whole
          ce_c = __shfl_sync(0xffffffffu, ce, last, W);
          cs_c = __shfl_sync(0xffffffffu, cs, last, W);
        }
      }
      bar_arrive(&bars[cw][3][slot]);
    }
  } else {
    // the producer: lane l stages lane l's sample of each chain warp
    ChunkLane L[kChainWarps];
    const void* x[kChainWarps];
    size_t row0[kChainWarps];
#pragma unroll
    for (int cw = 0; cw < kChainWarps; ++cw) {
      L[cw] = chunk_lane(a, cw, lane);
      x[cw] = nullptr;
#pragma unroll
      for (int k = 0; k < kMaxGroups; ++k)
        if (L[cw].live && k == L[cw].g) x[cw] = a.x[k];
      row0[cw] = L[cw].live ? (size_t)L[cw].c * (size_t)n : 0;
    }
    long long chunk = 0;
    int sb = 0;
    for (long long t = 0; t < slots; ++t) {
      const int slot = (int)(t % kCSlots);
      const unsigned par = (unsigned)((t / kCSlots) & 1);
      const int cnt = (int)min((long long)kRows, rows - t * kRows);
      // every load of the slot in flight before the first is widened
      Raw1<BF16> v[kChainWarps][kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = sb * W + seg_lane;
#pragma unroll
        for (int cw = 0; cw < kChainWarps; ++cw)
          v[cw][r] = (r < cnt && L[cw].live && j < K)
                         ? load1<BF16>(x[cw], row0[cw] +
                                       (size_t)(chunk * K + j))
                         : Raw1<BF16>(0.f);
        if (++sb == rpc) {
          sb = 0;
          ++chunk;
        }
      }
#pragma unroll
      for (int cw = 0; cw < kChainWarps; ++cw) {
        bar_wait(&bars[cw][1][slot], par ^ 1u);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          xring[cw][slot][r][lane] = widen(v[cw][r]);
        bar_arrive(&bars[cw][0][slot]);
      }
    }
  }
}

// The chunked loop's chain floor: warp g runs instance g's loop alone over
// x_g (n <= kChunkFloorN samples, staged in shared memory), the chain of
// pll_chunked_kernel alone, by the same device functions in the same
// order: the prediction's sincosf, the detector, the butterfly of the
// carried sums, the PI update and the wrap; no rings, no NCO and no
// stores.  Lane 0 of each warp writes its clock64 cycles and %globaltimer
// nanoseconds and its segment's final state (integ, acc, cos acc, sin
// acc), the bits of pll_chunked_kernel's.
constexpr int kChunkFloorN = 4096;
constexpr int kChunkFloorG = 2;

template <bool EXACT>
__global__ void chunk_floor_kernel(const float* __restrict__ x, int n,
                                   int chunk, int width,
                                   const float* __restrict__ st_in,
                                   float* __restrict__ st_out,
                                   long long* __restrict__ timing,
                                   LoopParams p0, LoopParams p1) {
  __shared__ float xs[kChunkFloorG][kChunkFloorN];
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = lane; i < n; i += 32) xs[g][i] = x[(size_t)g * n + i];
  __syncthreads();
  const LoopParams p = g ? p1 : p0;
  const int K = chunk, W = width;
  const int seg_lane = lane & (W - 1);
  const float inv_wmod = __frcp_rn(p.wmod);
  const float kf = (float)K;
  float integ = st_in[2 * g], acc = st_in[2 * g + 1];
  const long long g0 = global_ns();
  const long long t0 = clock64();
  for (int base = 0; base < n; base += K) {
    const float wi = __fadd_rn(p.w0, integ);
    float se = 0.f, sw = 0.f;
    for (int sb = 0; sb < K; sb += W) {
      const int j = sb + seg_lane;
      const bool act = j < K;
      const float xv = act ? xs[g][base + j] : 0.f;
      const float e = chunk_error<EXACT>(xv, acc, wi, j, act);
      se = __fadd_rn(se, e);
      sw = __fadd_rn(sw, __fmul_rn((float)(K - j), e));
    }
    chunk_update(se, sw, W, kf, p, inv_wmod, integ, acc);
  }
  asm volatile("mov.b32 %0, %0;" : "+f"(acc));
  const long long t1 = clock64();
  const long long g1 = global_ns();
  if (lane == 0) {
    st_out[4 * g] = integ;
    st_out[4 * g + 1] = acc;
    st_out[4 * g + 2] = cosf(acc);
    st_out[4 * g + 3] = sinf(acc);
    timing[2 * g] = t1 - t0;
    timing[2 * g + 1] = g1 - g0;
  }
}

template <bool BF16>
void launch_chunked(bool exact, bool lag, dim3 grid, cudaStream_t s,
                    const ChunkArgs& a) {
  if (exact) {
    if (lag) pll_chunked_kernel<BF16, true, true><<<grid, kChunkThreads, 0, s>>>(a);
    else pll_chunked_kernel<BF16, true, false><<<grid, kChunkThreads, 0, s>>>(a);
  } else {
    if (lag) pll_chunked_kernel<BF16, false, true><<<grid, kChunkThreads, 0, s>>>(a);
    else pll_chunked_kernel<BF16, false, false><<<grid, kChunkThreads, 0, s>>>(a);
  }
}

}  // namespace

extern "C" {

// The sequential loop for `loops` instances in one launch, over a common n,
// x float32 or bf16 (x_bf16), the state (5, C_g) float32.  ptrs holds 4 addresses per instance (x (C_g, n), st_in (5, C_g), nco
// (C_g, n), st_out (5, C_g)); params 6 floats per instance (kp, ki, w0,
// wmod, scale, adj).  Each instance gets its own blocks of kLanes channels,
// so the instances run side by side on separate SMs.
int sdr_pll_multi(int loops, const long long* ptrs, const int* channels,
                  const float* params, int x_bf16, long long n, int exact,
                  int wrap, int lag, void* stream) {
  if (loops < 1 || loops > kMaxLoops || n < 1)
    return (int)cudaErrorInvalidValue;
  LoopArgs a = {};
  int blocks = 0;
  for (int g = 0; g < loops; ++g) {
    if (channels[g] < 1) return (int)cudaErrorInvalidValue;
    a.x[g] = reinterpret_cast<const void*>(ptrs[4 * g]);
    a.st_in[g] = reinterpret_cast<const float*>(ptrs[4 * g + 1]);
    a.nco[g] = reinterpret_cast<float*>(ptrs[4 * g + 2]);
    a.st_out[g] = reinterpret_cast<float*>(ptrs[4 * g + 3]);
    a.channels[g] = channels[g];
    a.first_block[g] = blocks;
    const float* q = params + 6 * g;
    a.p[g] = LoopParams{q[0], q[1], q[2], q[3], q[4], q[5]};
    blocks += (channels[g] + kLanes - 1) / kLanes;
  }
  a.loops = loops;
  a.n = n;
  launch_loop(x_bf16 != 0, exact != 0, wrap != 0, lag != 0, dim3(blocks),
              static_cast<cudaStream_t>(stream), a);
  return (int)cudaGetLastError();
}

// The chain-floor microbenchmark: one thread, x (n,) float32 with n <=
// 8192, st_in (5,) -> st_out (6,) (the state and a checksum) and timing
// (2,) int64: clock64 cycles and %globaltimer nanoseconds of the loop.
int sdr_pll_chain_floor(const float* x, int n, const float* st_in,
                        float* st_out, long long* timing, float kp, float ki,
                        float w0, float wmod, float scale, float adj,
                        int exact, int wrap, int lag, void* stream) {
  if (n < 1 || n > kFloorN) return (int)cudaErrorInvalidValue;
  const LoopParams p{kp, ki, w0, wmod, scale, adj};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SDR_FLOOR(E, W, L) \
  chain_floor_kernel<E, W, L><<<1, 1, 0, s>>>(x, n, st_in, st_out, timing, p)
  if (exact && wrap && lag) SDR_FLOOR(true, true, true);
  else if (!exact && wrap && lag) SDR_FLOOR(false, true, true);
  else if (exact && !wrap && !lag) SDR_FLOOR(true, false, false);
  else return (int)cudaErrorInvalidValue;
#undef SDR_FLOOR
  return (int)cudaGetLastError();
}

// The chunked loop's chain-floor microbenchmark: `groups` (1 or 2)
// instances, one warp each, x (groups, n) float32 with n <= 4096 and a
// multiple of chunk, st_in (groups, 2) (integ, acc) -> st_out (groups, 4)
// and timing (groups, 2) int64: clock64 cycles and %globaltimer ns of each
// warp's loop; params 6 floats per instance.
int sdr_pll_chunk_floor(const float* x, int n, int groups, int chunk,
                        const float* st_in, float* st_out, long long* timing,
                        const float* params, int exact, void* stream) {
  if (n < 1 || n > kChunkFloorN || groups < 1 || groups > kChunkFloorG ||
      chunk < 1 || n % chunk != 0)
    return (int)cudaErrorInvalidValue;
  const float* q = params;
  const float* r = params + 6 * (groups - 1);
  const LoopParams p0{q[0], q[1], q[2], q[3], q[4], q[5]};
  const LoopParams p1{r[0], r[1], r[2], r[3], r[4], r[5]};
  int w = 1;
  while (w < chunk && w < 32) w <<= 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exact)
    chunk_floor_kernel<true><<<1, 32 * groups, 0, s>>>(
        x, n, chunk, w, st_in, st_out, timing, p0, p1);
  else
    chunk_floor_kernel<false><<<1, 32 * groups, 0, s>>>(
        x, n, chunk, w, st_in, st_out, timing, p0, p1);
  return (int)cudaGetLastError();
}

// differ (1,) uint64, zeroed by the caller: see sincos_check_kernel.
int sdr_sincos_check(unsigned long long* differ, void* stream) {
  sincos_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      differ);
  return (int)cudaGetLastError();
}

// The chunked loop for `groups` instances over a common n.  ptrs holds 4
// addresses per instance (x, st_in (5, C_g), nco (C_g, n), st_out
// (4, C_g)); params 6 floats per instance (kp, ki, w0, wmod, scale, adj).
int sdr_pll_chunked(int groups, const long long* ptrs, const int* channels,
                    const float* params, int x_bf16, long long n, int chunk,
                    int exact, int lag, void* stream) {
  if (groups < 1 || groups > kMaxGroups || chunk < 1 || n < chunk ||
      n % chunk != 0)
    return (int)cudaErrorInvalidValue;
  ChunkArgs a = {};
  long long total = 0;
  for (int g = 0; g < groups; ++g) {
    if (channels[g] < 1) return (int)cudaErrorInvalidValue;
    a.x[g] = reinterpret_cast<const void*>(ptrs[4 * g]);
    a.st_in[g] = reinterpret_cast<const float*>(ptrs[4 * g + 1]);
    a.nco[g] = reinterpret_cast<float*>(ptrs[4 * g + 2]);
    a.st_out[g] = reinterpret_cast<float*>(ptrs[4 * g + 3]);
    a.channels[g] = channels[g];
    const float* q = params + 6 * g;
    a.p[g] = LoopParams{q[0], q[1], q[2], q[3], q[4], q[5]};
    total += channels[g];
  }
  a.groups = groups;
  a.chunk = chunk;
  int w = 1;
  while (w < chunk && w < 32) w <<= 1;
  a.width = w;
  a.n = n;
  const long long per_block = (long long)kChainWarps * (32 / w);
  dim3 grid((unsigned)((total + per_block - 1) / per_block));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) launch_chunked<true>(exact, lag, grid, s, a);
  else launch_chunked<false>(exact, lag, grid, s, a);
  return (int)cudaGetLastError();
}

}  // extern "C"
