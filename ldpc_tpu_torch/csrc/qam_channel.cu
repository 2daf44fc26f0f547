// K6: the unfused path's Gray-QAM channel in one pass, for Hopper (sm_90a),
// plain C interface.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA
// (ldpc_tpu/ops/interleave.py, ops/modem.py, ops/channel.py), and the port ran
// it as about 60 PyTorch operators a batch. It exists because those operators
// wrote and read back every intermediate through device memory ([B, n/bps, m]
// distance tables, masked copies, minima, stacks, the interleaved codewords and
// the LLRs before deinterleaving), and together took more device time a batch
// than the decode that follows.
//
// What bounds it on the card: bytes. A symbol needs a few dozen float
// operations; per code bit the kernel reads the codeword (4 B), the
// permutation (8 B, a row per frame under the random interleaver; one row for
// every frame under a fixed one) and its share of the symbol's draws (the
// normals of I and Q and, under mode 2, the jam uniform: 3 x 4 B a symbol),
// and writes one LLR (4 B): about 19 bytes a bit for 16-QAM under mode 2.
//
// Design: a block takes one frame, or several where a frame has few symbols.
// It reads its codeword rows into shared memory with coalesced loads. Each
// thread then takes one symbol at a time: it reads the symbol's bps
// permutation entries, gathers its bits from shared memory, maps the I and Q
// halves to their Gray levels, computes the noise variance (per symbol under
// mode 2's jammer), adds the noise, demaps each bit by max-log in registers and
// scatters the LLRs to their deinterleaved places in an output row in shared
// memory. After one barrier the rows are stored with coalesced stores. Nothing
// intermediate goes to device memory.
//
// Arithmetic: op for op as the plain chain (ops/qam_channel.py), built with
// -fmad=false and no fast math, so the LLRs equal the plain version's on the
// card bit for bit: nv = (s1*s1 + jam*(s2*s2)) * (1/bps) (PyTorch's CUDA
// division by a host scalar multiplies by its float reciprocal), std =
// sqrtf(nv), y = level + std*z, d2 = (y - level)^2, the minima over each
// bit's label sets from the demap's 1e30 sentinel (NaN propagating, as
// torch.amin), and (d0 - d1) / (2*nv) in IEEE division.

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 1e30f;  // the demap's sentinel for a masked label
constexpr int MAX_THREADS = 1024;

// consts f32 [8] in ops/channel.py CONSTS_ORDER
constexpr int C_SIGMA1 = 2, C_SIGMA2 = 3, C_P = 7;

// torch.amin's combine: a NaN wins
__device__ __forceinline__ float nan_min(float v, float acc) {
  return (v != v || v < acc) ? v : acc;
}

// One axis of a symbol: the per-bit max-log LLRs of y (MSB first) against the
// axis's Gray levels, indexed by label.
template <int AXIS>
__device__ __forceinline__ void axis_llr(float y, const float (&lv)[1 << AXIS], float den,
                                         float* llr) {
  constexpr int M = 1 << AXIS;
  float d2[M];
#pragma unroll
  for (int l = 0; l < M; ++l) {
    const float d = y - lv[l];
    d2[l] = d * d;
  }
#pragma unroll
  for (int b = 0; b < AXIS; ++b) {
    float d0 = BIG, d1 = BIG;
#pragma unroll
    for (int l = 0; l < M; ++l) {
      if ((l >> (AXIS - 1 - b)) & 1)
        d1 = nan_min(d2[l], d1);
      else
        d0 = nan_min(d2[l], d0);
    }
    llr[b] = (d0 - d1) / den;
  }
}

// ``w`` [B, n] code bits in {0, 1}; ``pi`` the permutation (row b at
// pi + b * pi_stride; null: the identity), interleave out[i] = w[pi[i]] and
// deinterleave out[pi[i]] = llr[i]; ``jam_u`` [B, n/BPS] (mode 2 only),
// ``z_i`` / ``z_q`` [B, n/BPS] the draws; ``levels`` [2^(BPS/2)] the scaled
// Gray levels by label. ``out`` [B, n]: the deinterleaved channel LLRs
// (LLR > 0 <=> bit 1). A block takes ``frames`` adjacent rows.
template <int BPS>
__global__ void __launch_bounds__(MAX_THREADS)
qam_channel_kernel(const float* __restrict__ w, const long long* __restrict__ pi,
                   long long pi_stride, const float* __restrict__ jam_u,
                   const float* __restrict__ z_i, const float* __restrict__ z_q,
                   const float* __restrict__ consts, const float* __restrict__ levels,
                   int mode, int n, int B, int frames, float* __restrict__ out) {
  constexpr int AXIS = BPS / 2, M = 1 << AXIS;
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;               // codeword rows
  float* so = smem + frames * n;  // LLR rows, deinterleaved
  const int tid = threadIdx.x, b0 = blockIdx.x * frames;
  const int nv = min(frames, B - b0), n_sym = n / BPS;
  const size_t base = (size_t)b0 * n;
  for (int i = tid; i < nv * n; i += blockDim.x) sw[i] = w[base + i];
  float lv[M];
#pragma unroll
  for (int l = 0; l < M; ++l) lv[l] = levels[l];
  const float s1 = consts[C_SIGMA1], s2 = consts[C_SIGMA2], p = consts[C_P];
  const float v1 = s1 * s1, v2 = s2 * s2, vp = (p * p) * v2;
  const float inv_bps = 1.0f / (float)BPS;
  __syncthreads();
  for (int q = tid; q < nv * n_sym; q += blockDim.x) {
    const int f = q / n_sym, s = q - f * n_sym;
    const size_t row = (size_t)(b0 + f), sym = row * n_sym + s;
    int pos[BPS];
#pragma unroll
    for (int t = 0; t < BPS; ++t)
      pos[t] = pi ? (int)pi[row * pi_stride + s * BPS + t] : s * BPS + t;
    const float* bits = sw + f * n;
    int lab_i = 0, lab_q = 0;
#pragma unroll
    for (int t = 0; t < AXIS; ++t) {
      lab_i = 2 * lab_i + (int)bits[pos[t]];
      lab_q = 2 * lab_q + (int)bits[pos[AXIS + t]];
    }
    float nvar;
    if (mode == 1) {
      nvar = v1 * inv_bps;
    } else if (mode == 2) {
      const float jam = jam_u[sym] < p ? 1.0f : 0.0f;
      nvar = (v1 + jam * v2) * inv_bps;
    } else {
      nvar = (v1 + vp) * inv_bps;
    }
    const float sd = sqrtf(nvar);
    float yi = 0.0f, yq = 0.0f;  // the labels' levels, from registers
#pragma unroll
    for (int l = 0; l < M; ++l) {
      yi = l == lab_i ? lv[l] : yi;
      yq = l == lab_q ? lv[l] : yq;
    }
    yi = yi + sd * z_i[sym];
    yq = yq + sd * z_q[sym];
    const float den = 2.0f * nvar;
    float llr[BPS];
    axis_llr<AXIS>(yi, lv, den, llr);
    axis_llr<AXIS>(yq, lv, den, llr + AXIS);
    float* o = so + f * n;
#pragma unroll
    for (int t = 0; t < BPS; ++t) o[pos[t]] = llr[t];
  }
  __syncthreads();
  for (int i = tid; i < nv * n; i += blockDim.x) out[base + i] = so[i];
}

const void* kernel_of(int bps) {
  switch (bps) {
    case 2: return (const void*)qam_channel_kernel<2>;
    case 4: return (const void*)qam_channel_kernel<4>;
    case 6: return (const void*)qam_channel_kernel<6>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

extern "C" int qam_channel_launch(const float* w, const long long* pi, long long pi_stride,
                                  const float* jam_u, const float* z_i, const float* z_q,
                                  const float* consts, const float* levels, float* out, int bps,
                                  int mode, int n, int B, int frames, int threads, int device,
                                  void* stream) {
  const void* kernel = kernel_of(bps);
  if (kernel == nullptr || n <= 0 || n % bps || mode < 1 || mode > 3 ||
      (mode == 2) != (jam_u != nullptr) || frames < 1 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 || B < 0)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const long long smem = 2LL * frames * n * (long long)sizeof(float);  // sw, so
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&w, &pi, &pi_stride, &jam_u, &z_i, &z_q, &consts, &levels,
                  &mode, &n, &B, &frames, &out};
  const dim3 grid((B + frames - 1) / frames), block(threads);
  e = cudaLaunchKernel(kernel, grid, block, args, (size_t)smem,
                       static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? e : cudaGetLastError();
}
