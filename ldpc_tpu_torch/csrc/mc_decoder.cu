// K1: the fused Monte-Carlo decode kernel for Hopper (sm_90a), plain C
// interface.
//
// Replaces ldpc_tpu/ops/mc_pallas.py make_mc_decoder (body :295-376,
// pallas_call :378) -> mc_decoder_kernel: modulation, noise (injected words
// or Philox), Box-Muller with a 48-bit radial uniform, channel LLRs, the QC
// decode loop (decode_group.cuh: layered or flooding, scalar or scheduled
// alpha, f32 or int8 E, with or without the flip metric), info-bit error
// counts, optionally the channel LLRs out for phase 2. The design note is in
// decode_group.cuh.
//
// The channel fill writes each codeword's LLRs into L (the layered
// schedule's posteriors start from them in place); then, under flooding, X in
// the channel sign convention goes from L into the internal [B][n] row
// `xbuf`, and with the flip metric the info positions' LLRs into the
// previous-posterior row `prior` (stage_x).
//
// The refill (REFILL). Where codewords share a warp (R*Z <= 16), K1 runs
// one pass of the layered schedule (no LLRs out, no flip metric, no skip)
// and the batch outnumbers the resident blocks' lane groups (mc_kernels.py
// MCDecoder.refills), a warp no longer runs until the later of its
// codewords stops: the launch is a persistent grid of the resident
// blocks, and each lane group, at the end of the check window in
// which its codeword stopped, writes that codeword's outputs and loads the
// next one from a ticket word (K1Refill). `iters` is then a codeword's own
// trips, and the launch adds to `idle` the sweeps its lane groups spent
// holding no codeword while their warp ran, the tail of the grid. Every
// other output, per codeword and keyed by its index, is as the
// block-per-group launch gives it.

#include "decode_group.cuh"

namespace {

constexpr float TWO_PI_F = 6.283185307179586f;
constexpr float U24 = 0x1p-24f;
constexpr float HALF_U24 = 0x1p-25f;
constexpr float U48 = 0x1p-48f;
constexpr float HALF_U48 = 0x1p-49f;
constexpr float ONE_MINUS_U24 = 0x1.fffffep-1f;

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

__device__ __forceinline__ float uniform01(unsigned w) {
  return (float)(int)(w >> 8) * U24 + HALF_U24;
}

// mc_pallas.py:82-120: 48-bit radial uniform, cos to the first normal and
// sin to the second.
__device__ __forceinline__ void box_muller2(unsigned hi, unsigned lo, unsigned ang_w,
                                            float& z0, float& z1) {
  const float h = (float)(int)(hi >> 8), l = (float)(int)(lo >> 8);
  const float u1 = fminf(h * U24 + (l * U48 + HALF_U48), ONE_MINUS_U24);
  const float u2 = uniform01(ang_w);
  const float rad = sqrtf(-2.0f * logf(u1));
  const float ang = TWO_PI_F * u2;
  z0 = rad * cosf(ang);
  z1 = rad * sinf(ang);
}

// K1's channel inputs: the sent bits, the noise (injected words or Philox),
// the channel constants, and where the channel LLRs go out (phase 1).
struct Channel {
  const float* w;
  const unsigned* raw;
  const float* consts;
  float* llr_out;
  int mode;
  float amp;
  int noise_input;
  unsigned key0, key1, cw0;
};

// The channel constants, in ops/channel.py CONSTS_ORDER.
struct Consts {
  float noise1, scale, s1, s2, lc1, lc2, lc3, p;
};

__device__ __forceinline__ Consts channel_consts(const float* c) {
  return {c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7]};
}

// channel_fill (mc_pallas.py:253-293) of codeword b (of the launch) into its
// L row Ll, items item0, item0 + nitems, ...: base columns 2p and 2p+1 share
// one draw triple per normal, from column 2p's planes
__device__ __forceinline__ void channel_fill(const Loop& P, const Channel& C, const Consts& K,
                                             float* Ll, int b, int item0, int nitems) {
  const int Z = P.Z, n = P.n, B = P.B;
  const float c_noise1 = K.noise1, c_scale = K.scale, c_s1 = K.s1, c_s2 = K.s2;
  const float c_lc1 = K.lc1, c_lc2 = K.lc2, c_lc3 = K.lc3, c_p = K.p;
  const int mode = C.mode;
  auto channel = [&](int col, int zz, float za, float zb, unsigned jam_w) {
    const size_t pos = (size_t)col * Z + zz;
    const float sym = (2.0f * C.w[pos * B + b] - 1.0f) * C.amp;
    float llr;
    if (mode == 1) {
      llr = -(c_scale * (sym + c_noise1 * za));
    } else {
      const float n1 = c_s1 * za, n2 = c_s2 * zb;
      if (mode == 2) {
        llr = -(uniform01(jam_w) < c_p ? (sym + n1 + n2) * c_lc2 : (sym + n1) * c_lc1);
      } else {
        llr = -(((sym + n1 + n2) * c_p + (sym + n1) * (1.0f - c_p)) * c_lc3);
      }
    }
    Ll[pos] = llr;
    if (C.llr_out) C.llr_out[pos * B + b] = llr;
  };
  const int npairs = (P.nb + 1) / 2;
  const size_t nB = (size_t)n * B;
  const unsigned* raw = C.raw;
  for (int item = item0; item < npairs * Z; item += nitems) {
    const int p = item / Z, zz = item - p * Z, c0 = 2 * p, c1 = c0 + 1;
    const bool has1 = c1 < P.nb;
    unsigned a0, a1, a2, b0 = 0, b1 = 0, b2 = 0, j0 = 0, j1 = 0;
    if (C.noise_input) {
      const size_t at = ((size_t)c0 * Z + zz) * B + b;
      a0 = raw[at];
      a1 = raw[nB + at];
      a2 = raw[2 * nB + at];
      if (mode != 1) {
        b0 = raw[3 * nB + at];
        b1 = raw[4 * nB + at];
        b2 = raw[5 * nB + at];
      }
      if (mode == 2) {
        j0 = raw[6 * nB + at];
        if (has1) j1 = raw[6 * nB + ((size_t)c1 * Z + zz) * B + b];
      }
    } else {
      // Philox words laid out as ldpc_tpu_torch/ops/mc_kernels.py philox_raw;
      // the counter's codeword word is cw0 + b, so a launch over a shard
      // [cw0, cw0 + B) of a batch draws the words the whole batch draws there
      const uint2 key = make_uint2(C.key0, C.key1);
      const unsigned cw = C.cw0 + (unsigned)b;
      const uint4 x = philox4x32_10(make_uint4(cw, (unsigned)item, 0u, 0u), key);
      a0 = x.x;
      a1 = x.y;
      a2 = x.z;
      j0 = x.w;
      if (mode != 1) {
        const uint4 y = philox4x32_10(make_uint4(cw, (unsigned)item, 1u, 0u), key);
        b0 = y.x;
        b1 = y.y;
        b2 = y.z;
        j1 = y.w;
      }
    }
    float za0, za1, zb0 = 0.0f, zb1 = 0.0f;
    box_muller2(a0, a1, a2, za0, za1);
    if (mode != 1) box_muller2(b0, b1, b2, zb0, zb1);
    channel(c0, zz, za0, zb0, j0);
    if (has1) channel(c1, zz, za1, zb1, j1);
  }
}

// K1's refill (decode_group's hook where codewords share the warp, layered,
// one pass: no LLRs out, no flip metric). Each lane group holds codeword b
// of the launch, loaded by its own lanes; at each check window's end the
// groups whose codeword stopped count its info-bit errors and write its
// outputs (`iters`: its own trips; `norm` 0), take the next codeword from the
// launch's ticket word (the first grid x cpg go to the blocks in order, so
// the ticket counts from 0) and load it, or hold none. A group's leader
// counts the sweeps it spent holding none while the warp ran (`idle`).
template <bool Q8>
struct K1Refill {
  using ET = typename EStore<Q8>::T;
  static constexpr bool REFILL = true;
  static constexpr unsigned ALL = 0xffffffffu;
  Channel C;
  int* err;
  unsigned char* ok;
  int* conv;
  float* norm;
  int* iters;
  int* ticket;
  int b;
  int idle;

  // the codeword b into the group's L row, its E row zeroed
  __device__ __forceinline__ void load(const Loop& P, const Lanes& T, float* Lc, ET* Ec) {
    const int RZ = P.R * P.Z;
    channel_fill(P, C, channel_consts(C.consts), Lc, b, T.rz, RZ);
    for (int i = T.rz; i < P.e_slots * P.Z; i += RZ) Ec[i] = 0;
  }

  // Called by every thread of the warp after the window's vote; `stop`:
  // this thread's group held a codeword (`live`) that converged (`okv`, at
  // check iteration `cv`) or spent its budget, after `it` sweeps. Returns
  // whether the group holds a codeword for the next window.
  __device__ __forceinline__ bool window_end(const Loop& P, const Lanes& T, float* Lc, ET* Ec,
                                             bool live, bool stop, bool okv, int cv, int it) {
    if (!live && T.on && T.rz == 0) idle += P.check_every;
    if (!__any_sync(ALL, stop)) return live;
    const int RZ = P.R * P.Z;
    int cnt = 0;
    if (stop) {
      for (int pos = T.rz; pos < P.n; pos += RZ) {
        if (P.info_mask[pos])
          cnt += (Lc[pos] < 0.0f) != (C.w[(size_t)pos * P.B + b] != 0.0f);
      }
    }
    int errs = 0;
    for (int q = 0; q < P.cpg; ++q) {
      const int s = __reduce_add_sync(ALL, T.k == q ? cnt : 0);
      if (T.k == q) errs = s;
    }
    int nb = 0;
    if (stop && T.rz == 0) {
      err[b] = errs;
      ok[b] = okv ? 1 : 0;
      conv[b] = cv;
      norm[b] = 0.0f;
      iters[b] = it;
      nb = gridDim.x * P.cpg + atomicAdd(ticket, 1);
    }
    nb = __shfl_sync(ALL, nb, (T.k * RZ) & 31);
    // every read of the stopped codewords' L before their lanes load
    __syncthreads();
    bool holds = live;
    if (stop) {
      b = nb;
      holds = b < P.B;
      if (holds) load(P, T, Lc, Ec);
    }
    // the loads before the next window's reads
    __syncthreads();
    return holds;
  }
};

template <int DMAX, bool FLOOD, bool NORM, bool Q8, bool REFILL = false>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
mc_decoder_kernel(Loop P, const int* tab, const float* w, const unsigned* raw, const float* consts,
                  int* err, unsigned char* ok, int* conv, float* norm, int* iters,
                  float* llr_out, float* xbuf, int mode, float amp, int noise_input,
                  unsigned key0, unsigned key1, unsigned cw0, int skip, int* ticket,
                  double* idle) {
  extern __shared__ __align__(16) float smem[];
  const Smem<Q8> S = block_smem<DMAX, Q8>(P, smem);
  stage_tables(P, tab, S.tables);
  const int cpg = P.cpg;
  const Channel C = {w, raw, consts, llr_out, mode, amp, noise_input, key0, key1, cw0};
  if constexpr (REFILL) {
    // a persistent grid: lane group k of block j starts on codeword
    // j * cpg + k, then takes tickets (K1Refill)
    const Lanes T = lanes_of(P);
    const int B = P.B, b = blockIdx.x * cpg + T.k;
    K1Refill<Q8> rf{C, err, ok, conv, norm, iters, ticket, b, 0};
    if (threadIdx.x < cpg) s_done[threadIdx.x] = blockIdx.x * cpg + threadIdx.x < B ? 0 : 1;
    if (T.on && b < B) rf.load(P, T, S.L + T.k * P.Ls, S.E + T.k * P.e_slots * P.Z);
    __syncthreads();
    decode_group<DMAX, false, false, Q8, false>(P, S.L, S.E, S.D, nullptr, blockIdx.x * cpg,
                                                &rf);
    const int sum = __reduce_add_sync(0xffffffffu, rf.idle);
    if (threadIdx.x == 0 && idle != nullptr && sum) atomicAdd(idle, (double)sum);
    return;
  }
  const LaneMap M = lane_map(P);
  const int tid = threadIdx.x, lane = M.lane, item0 = M.item0, nitems = M.nitems, b = M.b;
  const bool valid = M.valid;
  if (tid < cpg) {
    s_done[tid] = (skip || !valid) ? 1 : 0;
    s_pre[tid] = 0;
    s_conv[tid] = -1;
    s_err[tid] = 0;
    s_norm[tid] = 0.0f;
  }
  if (tid == 0) s_iters = 0;
  zero_e<Q8>(P, S.E);
  const Consts K = channel_consts(consts);
  if (valid) channel_fill(P, C, K, S.L + lane * P.Ls, b, item0, nitems);
  // flooding's channel LLRs (channel sign): the block's rows of xbuf
  float* X = FLOOD ? xbuf + (size_t)blockIdx.x * cpg * P.n : nullptr;
  __syncthreads();
  if (FLOOD || NORM) {
    stage_x<FLOOD, NORM>(P, S.L, X, blockIdx.x * cpg);
    __syncthreads();
  }
  decode_group<DMAX, FLOOD, NORM, Q8, false>(P, S.L, S.E, S.D, X, blockIdx.x * cpg);
  __syncthreads();
  finish(P, smem, w, err, ok, conv, norm, iters);
}

struct MC {
  template <int D, bool F, bool N, bool Q>
  static const void* get() {
    return (const void*)mc_decoder_kernel<D, F, N, Q>;
  }
};

// the refill instantiations: layered, no flip metric
struct MCRefill {
  template <int D, bool F, bool N, bool Q>
  static const void* get() {
    return (const void*)mc_decoder_kernel<D, false, false, Q, true>;
  }
};

}  // namespace

extern "C" int mc_decoder_launch(const float* w, const unsigned* raw, const float* consts,
                                 int* err, unsigned char* ok, int* conv, float* norm, int* iters,
                                 float* llr_out, float* xbuf, float* prior, const int* tab, int n,
                                 int Z, int nb, int mb, int e_slots, int ngroups, int R, int B,
                                 int max_it, int check_every, int variant, float alpha,
                                 float beta, const float* atab, const int* acls, int aT, int aD,
                                 int track_norm, int k, int flood, int int8,
                                 int dmax, int has_dup, int cpg, int tpg, int Ls, int smem,
                                 int mode, float amp, int noise_input, unsigned key0,
                                 unsigned key1, unsigned cw0, int skip, int grid, int* ticket,
                                 double* idle, int device, void* stream) {
  Loop P = make_loop(tab, n, Z, nb, mb, e_slots, ngroups, R, B, max_it, check_every, variant,
                     alpha, beta, atab, acls, aT, aD, track_norm, k, flood, int8,
                     has_dup, cpg, tpg, Ls);
  P.prior = prior;
  if (bad_plan(P, dmax, smem) || (noise_input && raw == nullptr) ||
      (flood && xbuf == nullptr) ||
      (grid && (grid < 0 || cpg < 2 || flood || track_norm || llr_out || skip || !ticket)))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  void* args[] = {&P,      &tab,  &w,    &raw, &consts,      &err, &ok,  &conv, &norm,
                  &iters,  &llr_out, &xbuf, &mode, &amp, &noise_input, &key0, &key1, &cw0,
                  &skip,   &ticket, &idle};
  if (grid == 0)
    return launch(kernel_of<MC>(dmax, flood, track_norm, int8), P, dmax, device, stream, args);
  // the refill: `grid` persistent blocks, the ticket word zeroed on the stream
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(ticket, 0, sizeof(int), static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return launch(kernel_of<MCRefill>(dmax, false, false, int8), P, dmax, device, stream, args,
                grid);
}

// Resident blocks per SM of K1 at these flags, a block of `threads` threads
// and `smem` bytes of dynamic shared memory.
extern "C" int decoder_occupancy(int dmax, int flood, int norm, int int8, int threads, int smem,
                                 int* blocks) {
  return occupancy(kernel_of<MC>(dmax, flood, norm, int8), threads, smem, blocks);
}

// The same for K1's refill instantiation (layered, no flip metric).
extern "C" int refill_occupancy(int dmax, int int8, int threads, int smem, int* blocks) {
  return occupancy(kernel_of<MCRefill>(dmax, false, false, int8), threads, smem, blocks);
}
