// Instruction-rate probes for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of the JAX package's roofline accounting:
//   * ldpc_tpu/analysis/roofline.py _rate_kernel (bodies :312-347, pallas_call :363)
//     -> rate_chain_<op>: a dependent chain of `trips * UNROLL` bodies of one op
//     class on one f32 value per thread (K4);
//   * ldpc_tpu/analysis/roofline.py measure_mix_rate.build (:525-549, pallas_call
//     :544) -> mix_kernel: MIX_STREAMS independent chains per thread running a
//     census op schedule baked in at compile time, summed at the end (K5).
//
// What bounds them: instruction issue. Each thread reads one value and writes
// one; everything between stays in registers (and, for a roll, in a per-warp
// shared-memory slot). Built with the decode kernels' flags (-fmad=false, no
// fast math), so a body is the instruction sequence K1-K3 run for the same
// source: `x * a + b` is FMUL + FADD, tanhf / logf / cosf are the accurate
// library sequences, `/` and sqrtf are IEEE (the decode kernels call the same
// functions: decode_group.cuh check_update, mc_decoder.cu box_muller2). The
// hot loop's SASS instructions per body, by class, are counted from the built library by
// ops/rate_kernels.py loop_instructions and printed by chip_smoke.py; PERF.md
// keeps them. With nvcc 12.9 on an H100 (static count of the 16-body loop
// over 16, its counter and branch included): fma 2.19 (FMUL, FADD), roll 2.19
// (STS, LDS), where 3.19, tanh 16.31, log 27.25, div 14.31, sqrt 15.19, cos
// 88.31 (its Payne-Hanek reduction for |x| >= 105615 is inlined in the loop and
// never taken here), prng 12.94 per word.
//
// Design:
//   * K4 runs at full occupancy (256-thread blocks, 8 per SM, at most 32
//     registers), so the latency of a dependent chain is hidden by warps, not
//     exposed as on the TPU's VPU: the fma-class chain runs near the issue peak.
//   * roll: the tile is laid out so that a warp holds 32 consecutive rows of one
//     column; a roll is a store to the warp's slot, __syncwarp (no instruction
//     in SASS: the warp runs converged), and a load at (lane + 1) & 31 -- the
//     indexed shared-memory read the decode kernels pay for a roll, with no
//     block barrier. Two slots
//     alternate (their parity is known when the loop body compiles), so a lane
//     never overwrites a slot another lane has yet to read.
//   * prng: Philox4x32-10, the generator K1 draws its noise from, counter
//     (thread, call, 0, 0), key (7, 11); each of its four words is one body:
//     x += (float)(int)(w >> 8) * 2^-24.
//   * K5: a schedule read from device memory would put a branch on every op and
//     measure the branch, so the schedule (MIX_LEN op codes, 4 bits each in the
//     64-bit words MIX_S0..MIX_S7) and MIX_STREAMS are -D defines; one library
//     per (schedule, streams), built at first use. The pass is unrolled at
//     compile time (op and stream of every step are constants); the loop runs
//     two passes per trip so the roll slots' parity is static.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op : int { FMA = 0, ROLL, WHERE, TANH, LOG, DIV, SQRT, COSSIN, PRNG, N_OPS };

__shared__ float s_roll[2 * 1024];  // two 32-float slots per warp, up to 1024 threads

// The global thread's element of the [rows, cols] tile: warp w holds rows
// 32 * (w / cols) .. +31 of column w % cols, lane r row r of that strip.
__device__ __forceinline__ size_t element(int cols) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int w = g >> 5, lane = g & 31;
  return (size_t)((w / cols) * 32 + lane) * cols + (w % cols);
}

// One body of class OP (roofline.py:312-329). `buf` is the warp's two roll
// slots, `par` the slot this roll uses.
template <int OP>
__device__ __forceinline__ float body(float x, float* buf, int lane, int par) {
  if constexpr (OP == FMA) {
    return x * 0.9998779296875f + 0.0001220703125f;
  } else if constexpr (OP == ROLL) {
    buf[par * 32 + lane] = x;
    __syncwarp();
    return buf[par * 32 + ((lane + 1) & 31)];
  } else if constexpr (OP == WHERE) {
    return x < 0.5f ? x + 0.25f : x * 0.5f;
  } else if constexpr (OP == TANH) {
    return tanhf(x) + 0.25f;
  } else if constexpr (OP == LOG) {
    return logf(x * 0.5f + 1.7f);
  } else if constexpr (OP == DIV) {
    return 3.0f / (x + 2.0f);
  } else if constexpr (OP == SQRT) {
    return sqrtf(x + 1.0f);
  } else {
    static_assert(OP == COSSIN, "no chain body for this op class");
    return cosf(x);
  }
}

__device__ __forceinline__ float* warp_slots() { return s_roll + 2 * (threadIdx.x & ~31); }

#ifndef MIX_STREAMS
constexpr int UNROLL = 16;
constexpr float U24 = 0x1p-24f;

// mc_decoder.cu's Philox4x32-10 (Salmon et al., SC'11), as K1 draws its noise.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

template <int OP>
__device__ __forceinline__ void rate_chain(const float* __restrict__ x, float* __restrict__ y,
                                           int cols, int trips) {
  const size_t at = element(cols);
  const int lane = threadIdx.x & 31;
  float v = x[at];
  if constexpr (OP == PRNG) {
    const unsigned g = blockIdx.x * blockDim.x + threadIdx.x;
    unsigned call = 0;
#pragma unroll 1
    for (int t = 0; t < trips; ++t) {
#pragma unroll
      for (int q = 0; q < UNROLL / 4; ++q) {
        const uint4 w = philox4x32_10(make_uint4(g, call++, 0u, 0u), make_uint2(7u, 11u));
        v = v + (float)(int)(w.x >> 8) * U24;
        v = v + (float)(int)(w.y >> 8) * U24;
        v = v + (float)(int)(w.z >> 8) * U24;
        v = v + (float)(int)(w.w >> 8) * U24;
      }
    }
  } else {
    float* buf = nullptr;
    if constexpr (OP == ROLL) buf = warp_slots();
#pragma unroll 1
    for (int t = 0; t < trips; ++t) {
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) v = body<OP>(v, buf, lane, k & 1);
    }
  }
  y[at] = v;
}

#else  // MIX_STREAMS
#ifndef MIX_S1
#define MIX_S1 0ULL
#endif
#ifndef MIX_S2
#define MIX_S2 0ULL
#endif
#ifndef MIX_S3
#define MIX_S3 0ULL
#endif
#ifndef MIX_S4
#define MIX_S4 0ULL
#endif
#ifndef MIX_S5
#define MIX_S5 0ULL
#endif
#ifndef MIX_S6
#define MIX_S6 0ULL
#endif
#ifndef MIX_S7
#define MIX_S7 0ULL
#endif

constexpr int kStreams = MIX_STREAMS;
constexpr int kLen = MIX_LEN;
static_assert(kStreams >= 1 && kStreams <= 32 && kLen >= 1 && kLen <= 128,
              "MIX_STREAMS in 1..32, MIX_LEN in 1..128");

__host__ __device__ constexpr unsigned long long sched_word(int j) {
  return j == 0   ? MIX_S0
         : j == 1 ? MIX_S1
         : j == 2 ? MIX_S2
         : j == 3 ? MIX_S3
         : j == 4 ? MIX_S4
         : j == 5 ? MIX_S5
         : j == 6 ? MIX_S6
                  : MIX_S7;
}
__host__ __device__ constexpr int sched_op(int i) {
  return (int)((sched_word(i >> 4) >> (4 * (i & 15))) & 15ULL);
}
__host__ __device__ constexpr int rolls_before(int i) {
  int r = 0;
  for (int j = 0; j < i; ++j) r += sched_op(j) == ROLL;
  return r;
}
constexpr int kRolls = rolls_before(kLen);

template <int... I>
struct Seq {};
template <int N, int... I>
struct MakeSeq : MakeSeq<N - 1, N - 1, I...> {};
template <int... I>
struct MakeSeq<0, I...> {
  using type = Seq<I...>;
};

// Step I of pass P: op I of the schedule on stream I % kStreams.
template <int P, int I>
__device__ __forceinline__ void mix_step(float (&xs)[kStreams], float* buf, int lane) {
  constexpr int op = sched_op(I);
  static_assert(op < PRNG, "the mix schedule has no body for this op class");
  constexpr int par = (rolls_before(I) + P * kRolls) & 1;
  xs[I % kStreams] = body<op>(xs[I % kStreams], buf, lane, par);
}

template <int P, int... I>
__device__ __forceinline__ void mix_pass(float (&xs)[kStreams], float* buf, int lane, Seq<I...>) {
  (mix_step<P, I>(xs, buf, lane), ...);
}
#endif  // MIX_STREAMS

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

#ifndef MIX_STREAMS

#define RATE_CHAIN_KERNEL(NAME, OP)                                                         \
  extern "C" __global__ void __launch_bounds__(256, 8)                                      \
      rate_chain_##NAME(const float* __restrict__ x, float* __restrict__ y, int cols, int trips) { \
    rate_chain<OP>(x, y, cols, trips);                                                      \
  }
RATE_CHAIN_KERNEL(fma, FMA)
RATE_CHAIN_KERNEL(roll, ROLL)
RATE_CHAIN_KERNEL(where, WHERE)
RATE_CHAIN_KERNEL(tanh, TANH)
RATE_CHAIN_KERNEL(log, LOG)
RATE_CHAIN_KERNEL(div, DIV)
RATE_CHAIN_KERNEL(sqrt, SQRT)
RATE_CHAIN_KERNEL(cossin, COSSIN)
RATE_CHAIN_KERNEL(prng, PRNG)
#undef RATE_CHAIN_KERNEL

// x, y: f32 [rows, cols] on the device; rows a multiple of 32, rows * cols a
// multiple of `threads` (256, the kernels' launch bound); one thread per element.
extern "C" int rate_chain_launch(const float* x, float* y, int rows, int cols, int op, int trips,
                                 int threads, int device, void* stream) {
  const long long elems = (long long)rows * cols;
  if (rows < 32 || rows % 32 || cols < 1 || threads != 256 || elems % threads || trips < 0 ||
      op < 0 || op >= N_OPS || elems / threads > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)(elems / threads)), block(threads);
  switch (op) {
    case FMA: rate_chain_fma<<<grid, block, 0, s>>>(x, y, cols, trips); break;
    case ROLL: rate_chain_roll<<<grid, block, 0, s>>>(x, y, cols, trips); break;
    case WHERE: rate_chain_where<<<grid, block, 0, s>>>(x, y, cols, trips); break;
    case TANH: rate_chain_tanh<<<grid, block, 0, s>>>(x, y, cols, trips); break;
    case LOG: rate_chain_log<<<grid, block, 0, s>>>(x, y, cols, trips); break;
    case DIV: rate_chain_div<<<grid, block, 0, s>>>(x, y, cols, trips); break;
    case SQRT: rate_chain_sqrt<<<grid, block, 0, s>>>(x, y, cols, trips); break;
    case COSSIN: rate_chain_cossin<<<grid, block, 0, s>>>(x, y, cols, trips); break;
    default: rate_chain_prng<<<grid, block, 0, s>>>(x, y, cols, trips); break;
  }
  return cudaGetLastError();
}

#else  // MIX_STREAMS

extern "C" __global__ void __launch_bounds__(1024)
    mix_kernel(const float* __restrict__ x, float* __restrict__ y, int cols, int n_iters) {
  const size_t at = element(cols);
  const int lane = threadIdx.x & 31;
  float* buf = warp_slots();
  const float x0 = x[at];
  float xs[kStreams];
#pragma unroll
  for (int s = 0; s < kStreams; ++s) xs[s] = x0 * (float)(1.0 + 0.001 * s);
#pragma unroll 1
  for (int t = 0; t < n_iters; t += 2) {
    mix_pass<0>(xs, buf, lane, typename MakeSeq<kLen>::type{});
    mix_pass<1>(xs, buf, lane, typename MakeSeq<kLen>::type{});
  }
  float acc = xs[0];
#pragma unroll
  for (int s = 1; s < kStreams; ++s) acc = acc + xs[s];
  y[at] = acc;
}

// x, y: f32 [rows, cols]; rows a multiple of 32, rows * cols a multiple of
// `threads` (a multiple of 32, at most 1024); n_iters (passes) even.
extern "C" int mix_launch(const float* x, float* y, int rows, int cols, int n_iters, int threads,
                          int device, void* stream) {
  const long long elems = (long long)rows * cols;
  if (rows < 32 || rows % 32 || cols < 1 || threads < 32 || threads > 1024 || threads % 32 ||
      elems % threads || n_iters < 0 || n_iters % 2 || elems / threads > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  mix_kernel<<<(unsigned)(elems / threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, cols, n_iters);
  return cudaGetLastError();
}

// Resident blocks of `threads` threads per SM for mix_kernel.
extern "C" int mix_blocks_per_sm(int threads, int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, mix_kernel, threads, 0);
}

#endif  // MIX_STREAMS
