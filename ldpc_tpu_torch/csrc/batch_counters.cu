// K7: a batch's counters in one pass, and their add into a run's float64
// totals, for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX package leaves the masked reduction of a
// batch's per-frame stats (ldpc_tpu/ops/metrics.py reduce_block_stats and
// pack_counters) to XLA, which fuses it into the batch's step. The port ran it
// as about 45 PyTorch launches a batch (a mask, seven masked sums, a max, a
// stack, a cat and four adds into the totals), and on the fused path the host's
// time to enqueue them, not the card, set the pace.
//
// What bounds it on the card: bytes, and below some 100,000 frames the launch
// itself. Per frame it reads the bit errors, the converging sweep, the flip
// metric and the trips (4 B each) and the decode's verdict (1 B): 17 B a frame,
// about 70 KB at 4096 frames and 2.2 MB at 131,072. It writes int32[8].
//
// Design: where the batch has at most 8192 frames, one block of 1024 threads;
// above that a grid of one block per 8192 frames (at most MAX_BLOCKS, then a
// grid-stride loop). A thread reads 4 frames at a time with 16-byte loads
// (4-byte for the verdicts) where every array is aligned for them, and keeps
// its sums in registers: the integer slots as 32-bit unsigned sums (the same
// bits as PyTorch's int64 sum cast to int32), the flip metric in float64. A
// block reduces by warp shuffles, then across its warps in shared memory, both
// in a fixed tree. With more than one block, each block writes its partial to
// a static device array and takes a ticket; the block that takes the last
// ticket (atomicInc wraps it back to 0, so no memset is needed between
// launches) reduces the partials, each thread a fixed stride of them and then
// the same tree, and writes the result. The order of every addition is fixed
// by the batch size alone, so a batch's int32[8] is bit-equal from launch to
// launch. Launches on one device must follow each other (one stream), as they
// share the partials and the ticket.
//
// The layout of the result (ops/metrics.py SLOTS): blocks, ok_blocks,
// error_bits, fer_frames, conv_iters_sum, conv_count, iters, and the f32 bit
// pattern of the flip metric's sum. The first ``valid`` frames count; the
// iterations are the largest of all ``n_iters`` entries of ``iters``.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int FRAMES_PER_BLOCK = 8192;
constexpr int MAX_BLOCKS = 1024;
constexpr int SLOTS = 8;
constexpr int NORM_SLOT = 7;

struct Acc {
  unsigned ok, err, conv_sum, conv_count;
  int iters;
  double norm;
};

__device__ __forceinline__ Acc identity() { return {0u, 0u, 0u, 0u, INT_MIN, 0.0}; }

__device__ __forceinline__ void combine(Acc& a, const Acc& b) {
  a.ok += b.ok;
  a.err += b.err;
  a.conv_sum += b.conv_sum;
  a.conv_count += b.conv_count;
  a.iters = max(a.iters, b.iters);
  a.norm += b.norm;
}

__device__ __forceinline__ Acc shfl_down(const Acc& a, int offset) {
  Acc b;
  b.ok = __shfl_down_sync(0xffffffffu, a.ok, offset);
  b.err = __shfl_down_sync(0xffffffffu, a.err, offset);
  b.conv_sum = __shfl_down_sync(0xffffffffu, a.conv_sum, offset);
  b.conv_count = __shfl_down_sync(0xffffffffu, a.conv_count, offset);
  b.iters = __shfl_down_sync(0xffffffffu, a.iters, offset);
  b.norm = __shfl_down_sync(0xffffffffu, a.norm, offset);
  return b;
}

__device__ __forceinline__ void warp_reduce(Acc& a) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) combine(a, shfl_down(a, offset));
}

// The block's total in thread 0 (a fixed tree: within warps, then warp 0 over
// the warps' totals in order).
__device__ Acc block_reduce(Acc a) {
  __shared__ Acc warps[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_reduce(a);
  if (lane == 0) warps[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < WARPS ? warps[lane] : identity();
    warp_reduce(a);
  }
  return a;
}

// One frame's share, where it counts.
__device__ __forceinline__ void add_frame(Acc& a, bool counts, int err, unsigned char ok,
                                          int conv, float norm) {
  if (!counts) return;
  a.ok += ok != 0;
  a.err += (unsigned)err;
  if (conv >= 0) {
    a.conv_sum += (unsigned)conv;
    a.conv_count += 1u;
  }
  a.norm += (double)norm;
}

__device__ int4 load4(const int* p) { return *reinterpret_cast<const int4*>(p); }
__device__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ uchar4 load4(const unsigned char* p) { return *reinterpret_cast<const uchar4*>(p); }

__device__ unsigned ticket = 0;
__device__ Acc partials[MAX_BLOCKS];

__global__ void __launch_bounds__(THREADS)
batch_counters_kernel(const int* __restrict__ err, const unsigned char* __restrict__ ok,
                      const int* __restrict__ conv, const float* __restrict__ norm,
                      const int* __restrict__ iters, int frames, int valid, int n_iters,
                      int vector, int* __restrict__ out) {
  Acc a = identity();
  const int chunks = (frames + 3) / 4;
  const int stride = gridDim.x * blockDim.x;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < chunks; c += stride) {
    const int i = 4 * c;
    if (vector && i + 4 <= frames) {
      if (i < valid) {
        const int4 e = load4(err + i), v = load4(conv + i);
        const uchar4 o = load4(ok + i);
        const float4 x = load4(norm + i);
        add_frame(a, i < valid, e.x, o.x, v.x, x.x);
        add_frame(a, i + 1 < valid, e.y, o.y, v.y, x.y);
        add_frame(a, i + 2 < valid, e.z, o.z, v.z, x.z);
        add_frame(a, i + 3 < valid, e.w, o.w, v.w, x.w);
      }
      if (n_iters == frames) {
        const int4 t = load4(iters + i);
        a.iters = max(a.iters, max(max(t.x, t.y), max(t.z, t.w)));
      }
    } else {
      for (int j = i; j < min(i + 4, frames); ++j) {
        if (j < valid) add_frame(a, true, err[j], ok[j], conv[j], norm[j]);
        if (n_iters == frames) a.iters = max(a.iters, iters[j]);
      }
    }
  }
  if (n_iters == 1 && blockIdx.x == 0 && threadIdx.x == 0) a.iters = iters[0];

  a = block_reduce(a);
  if (gridDim.x > 1) {
    __shared__ bool last;
    if (threadIdx.x == 0) {
      partials[blockIdx.x] = a;
      __threadfence();
      last = atomicInc(&ticket, gridDim.x - 1) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    a = identity();
    for (int b = threadIdx.x; b < gridDim.x; b += blockDim.x) {
      const volatile Acc* p = partials + b;
      combine(a, Acc{p->ok, p->err, p->conv_sum, p->conv_count, p->iters, p->norm});
    }
    a = block_reduce(a);
  }
  if (threadIdx.x == 0) {
    out[0] = valid;
    out[1] = (int)a.ok;
    out[2] = (int)a.err;
    out[3] = valid - (int)a.ok;
    out[4] = (int)a.conv_sum;
    out[5] = (int)a.conv_count;
    out[6] = a.iters;
    out[NORM_SLOT] = __float_as_int(__double2float_rn(a.norm));
  }
}

// totals[r, s] += packed[r, s] for ``rows`` rows of SLOTS, the norm slot read
// as the f32 its bits hold; ``width``: a total row's length (>= SLOTS).
__global__ void add_counters_kernel(double* __restrict__ totals, const int* __restrict__ packed,
                                    int rows, int width) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= rows * SLOTS) return;
  const int r = k / SLOTS, s = k - r * SLOTS;
  const int v = packed[k];
  totals[(size_t)r * width + s] += s == NORM_SLOT ? (double)__int_as_float(v) : (double)v;
}

// Run on ``device`` and put the caller's device back.
struct OnDevice {
  int prev = -1;
  cudaError_t err;
  explicit OnDevice(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~OnDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// ``err``, ``conv``, ``norm`` [frames]; ``ok`` [frames] bools (one byte each);
// ``iters`` [n_iters], n_iters = frames or 1; ``out`` int32[8].
extern "C" int batch_counters_launch(const int* err, const unsigned char* ok, const int* conv,
                                     const float* norm, const int* iters, int* out, int frames,
                                     int valid, int n_iters, int device, void* stream) {
  if (frames < 1 || valid < 0 || valid > frames || (n_iters != frames && n_iters != 1))
    return cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return on.err;
  const int vector = aligned(err, 16) && aligned(conv, 16) && aligned(norm, 16) &&
                     aligned(iters, 16) && aligned(ok, 4);
  const int blocks = frames <= FRAMES_PER_BLOCK
                         ? 1
                         : std::min((frames + FRAMES_PER_BLOCK - 1) / FRAMES_PER_BLOCK,
                                    MAX_BLOCKS);
  batch_counters_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      err, ok, conv, norm, iters, frames, valid, n_iters, vector, out);
  return cudaGetLastError();
}

// ``totals`` [rows, width] float64, ``packed`` [rows, 8] int32.
extern "C" int add_counters_launch(double* totals, const int* packed, int rows, int width,
                                   int device, void* stream) {
  if (rows < 1 || width < SLOTS) return cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return on.err;
  const int n = rows * SLOTS;
  add_counters_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      totals, packed, rows, width);
  return cudaGetLastError();
}
