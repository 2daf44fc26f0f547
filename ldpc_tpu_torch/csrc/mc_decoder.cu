// QC LDPC decode kernels for Hopper (sm_90a), plain C interface.
//
// Replaces three Pallas TPU kernels of the JAX package and their shared body:
//   * ldpc_tpu/ops/mc_pallas.py  make_mc_decoder  (body :295-376) -> mc_decoder_kernel
//     modulation, noise (injected words or Philox), Box-Muller with a 48-bit
//     radial uniform, channel LLRs, the QC decode loop, info-bit error counts,
//     optionally the channel LLRs out for phase 2;
//   * ldpc_tpu/ops/mc_pallas.py  make_llr_decoder (body :561-601) -> llr_decoder_kernel
//     the same decode and counts from given LLRs with a per-lane pre-done mask;
//   * ldpc_tpu/ops/spa_pallas.py make_qc_decoder  (body :686-708) -> qc_decoder_kernel
//     the standalone decode of given channel LLRs (the unfused path): layered
//     or flooding, hard decisions, ok, conv, the normalized-LLR flip metric;
//   * ldpc_tpu/ops/spa_pallas.py make_decode_loop / make_check_update
//     (:126-574) -> decode_block / flood_sweep / check_update, one __device__
//     loop for all three.
//
// What bounds them: a codeword's decode is a chain of dependent steps (a
// layer of the layered schedule, or the check then the posterior phase of a
// flooding sweep), each a gather along Z, a leave-one-out combine (tanh/log
// or min/sign) and a scatter, with a block barrier between steps. Device-
// memory traffic is small (code bits or LLRs in; counters, decisions or
// LLRs out), so of the two bounds operations bind; in practice the latency
// of the step chain does, and the kernels run far above their operations
// bound (PERF.md has both times).
//
// Design: a block holds `lpb` codewords. The posteriors L [n][lpb] and the
// extrinsics E [edge slots * Z][lpb] of its codewords live in shared memory
// for the whole decode, so an iteration touches no device memory (flooding
// also keeps the channel LLRs X there: every sweep restarts its posteriors
// from them; the flip metric's previous posteriors, read once per check,
// stay in device memory). Thread (r, z, lane) owns check row z of the r-th
// row of every layer group (flooding: of base rows r, r+R, ...) for one
// codeword: a roll along Z is an indexed shared-memory read, and in a
// single-diagonal layer every posterior is read and written by exactly one
// thread, so a layer needs no atomics; the rows of a paired group run in the
// same step. Multi-diagonal layers stage their extrinsic deltas and apply
// them per position after a barrier (the additive update of the reference).
// A flooding sweep writes only E in its check phase and only L in its
// posterior phase, with a barrier between. The block loops until all its
// codewords are done or the budget is spent; `iters` is that trip count.
// Every op is per codeword, so the other outputs do not depend on lpb. Built
// with -fmad=false so each op rounds as the plain PyTorch version
// (ldpc_tpu_torch/ops/decode_loop.py, mc_kernels.py, qc_kernels.py) does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LPB = 8;
constexpr float TANH_IN_CLIP = 17.5f;
constexpr float PROD_CLIP = 0x1.fffffep-1f;  // largest float below 1
constexpr float TWO_PI_F = 6.283185307179586f;
constexpr float U24 = 0x1p-24f;
constexpr float HALF_U24 = 0x1p-25f;
constexpr float U48 = 0x1p-48f;
constexpr float HALF_U48 = 0x1p-49f;
constexpr float ONE_MINUS_U24 = 0x1.fffffep-1f;
constexpr float LLR_WINDOW = 7.0f;  // normalized-LLR confidence window

struct Loop {
  const int* row_off;     // [mb + 1] first flattened slot of each base row
  const int* slot_col;    // [e_slots] base column of each slot
  const int* slot_shift;  // [e_slots] circulant shift of each slot
  const int* groups;      // [ngroups * R] rows of each layer step, -1 = none
  const int* grp_dup;     // [ngroups] the step holds a multi-diagonal row
  const int* row_dup;     // [mb] multi-diagonal row
  const int* col_off;     // flooding: [nb + 1] first column slot of each base column
  const int* col_slot;    // flooding: [e_slots] flattened E slot, column order
  const int* col_shift;   // flooding: [e_slots] circulant shift, column order
  const int* info_mask;   // [n] 1 at info-bit positions (device memory)
  float* prior;           // track_norm: [n, B] previous posteriors (device memory)
  int n, Z, nb, mb, e_slots, ngroups, R, lpb, B;
  int max_it, check_every, variant;  // variant: 0 spa, 1 minsum, 2 nms, 3 oms
  float alpha, beta;
  int has_dup, flood, track_norm;
  float kf;  // info positions the flip metric divides by (at least 1)
};

__host__ __device__ inline int table_len(const Loop& P) {
  return (P.mb + 1) + 2 * P.e_slots + P.ngroups * P.R + P.ngroups + P.mb +
         (P.flood ? (P.nb + 1) + 2 * P.e_slots : 0);
}

__shared__ int s_done[MAX_LPB];
__shared__ int s_unsat[MAX_LPB];
__shared__ int s_conv[MAX_LPB];
__shared__ int s_err[MAX_LPB];
__shared__ int s_pre[MAX_LPB];  // lane pre-marked done: no load, no count
__shared__ int s_flips[MAX_LPB];
__shared__ float s_norm[MAX_LPB];

// Copy the schedule tables into shared memory and point P at the copies.
__device__ void stage_tables(Loop& P, const int* tab, int* stab) {
  const int len = table_len(P);
  for (int i = threadIdx.x; i < len; i += blockDim.x) stab[i] = tab[i];
  P.row_off = stab;
  P.slot_col = P.row_off + P.mb + 1;
  P.slot_shift = P.slot_col + P.e_slots;
  P.groups = P.slot_shift + P.e_slots;
  P.grp_dup = P.groups + P.ngroups * P.R;
  P.row_dup = P.grp_dup + P.ngroups;
  P.col_off = P.row_dup + P.mb;
  P.col_slot = P.col_off + P.nb + 1;
  P.col_shift = P.col_slot + P.e_slots;
  P.info_mask = tab + len;
}

struct MulOp {
  __device__ float operator()(float a, float b) const { return a * b; }
};
struct MinOp {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};

// Leave-one-out combine in the order of ldpc_tpu/ops/spa.py exclusive_combine:
// prefix[i] folds v[0..i-1] left to right, suffix[i] folds v[d-1..i+1] right
// to left, out[j] = op(prefix[j], suffix[j]); `none` stands for an empty fold.
template <int DMAX, class Op>
__device__ __forceinline__ void exclusive_combine(const float (&v)[DMAX], float (&out)[DMAX],
                                                  int d, float none, Op op) {
  float pre[DMAX], suf[DMAX];
#pragma unroll
  for (int i = 1; i < DMAX; ++i)
    if (i < d) pre[i] = (i == 1) ? v[0] : op(pre[i - 1], v[i - 1]);
#pragma unroll
  for (int i = DMAX - 2; i >= 0; --i)
    if (i <= d - 2) suf[i] = (i == d - 2) ? v[i + 1] : op(suf[i + 1], v[i + 1]);
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    if (j < d) {
      const bool hp = j > 0, hs = j < d - 1;
      out[j] = hp ? (hs ? op(pre[j], suf[j]) : pre[j]) : (hs ? suf[j] : none);
    }
  }
}

// make_check_update (spa_pallas.py:126-173): messages m -> extrinsics e.
template <int DMAX>
__device__ __forceinline__ void check_update(const float (&m)[DMAX], float (&e)[DMAX], int d,
                                             int variant, float alpha, float beta) {
  if (variant == 0) {
    float t[DMAX], pr[DMAX];
#pragma unroll
    for (int j = 0; j < DMAX; ++j) {
      if (j < d) {
        const float x = fminf(fmaxf(m[j] * 0.5f, -TANH_IN_CLIP), TANH_IN_CLIP);
        t[j] = fminf(fmaxf(tanhf(x), -PROD_CLIP), PROD_CLIP);
      }
    }
    exclusive_combine<DMAX>(t, pr, d, 1.0f, MulOp());
#pragma unroll
    for (int j = 0; j < DMAX; ++j) {
      if (j < d) {
        const float p = fminf(fmaxf(pr[j], -PROD_CLIP), PROD_CLIP);
        e[j] = logf((1.0f + p) / (1.0f - p));
      }
    }
    return;
  }
  float sg[DMAX], mg[DMAX], so[DMAX], mo[DMAX];
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    if (j < d) {
      sg[j] = m[j] < 0.0f ? -1.0f : 1.0f;
      mg[j] = fabsf(m[j]);
    }
  }
  exclusive_combine<DMAX>(sg, so, d, 1.0f, MulOp());
  exclusive_combine<DMAX>(mg, mo, d, 1e30f, MinOp());
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    if (j < d) {
      float mag = mo[j];
      if (variant == 2) {
        mag = alpha * mag;
      } else if (variant == 3) {
        mag = fmaxf(mag - beta, 0.0f);
      }
      e[j] = so[j] * mag;
    }
  }
}

__device__ __forceinline__ int wrap(int x, int Z) {
  return x >= Z ? x - Z : (x < 0 ? x + Z : x);
}

// One flooding sweep (spa_pallas.py:453-471): every base row's check update
// from roll(L) - E, written to E where the lane is active; after a barrier,
// every posterior L[bj] = X[bj] + sum of roll(E[slot], -s) in column-slot
// (edge) order.
template <int DMAX>
__device__ void flood_sweep(const Loop& P, float* L, float* E, const float* X, int lane,
                            int r, int z, bool active) {
  const int lpb = P.lpb, Z = P.Z;
  if (active) {
    for (int bi = r; bi < P.mb; bi += P.R) {
      const int off = P.row_off[bi], d = P.row_off[bi + 1] - off;
      float m[DMAX], e[DMAX];
#pragma unroll
      for (int j = 0; j < DMAX; ++j) {
        if (j < d) {
          const int li = (P.slot_col[off + j] * Z + wrap(z + P.slot_shift[off + j], Z)) * lpb + lane;
          m[j] = L[li] - E[((off + j) * Z + z) * lpb + lane];
        }
      }
      check_update<DMAX>(m, e, d, P.variant, P.alpha, P.beta);
#pragma unroll
      for (int j = 0; j < DMAX; ++j) {
        if (j < d) E[((off + j) * Z + z) * lpb + lane] = e[j];
      }
    }
  }
  __syncthreads();
  if (active) {
    for (int pos = r * Z + z; pos < P.n; pos += P.R * Z) {
      const int col = pos / Z;
      float acc = X[pos * lpb + lane];
      for (int t = P.col_off[col]; t < P.col_off[col + 1]; ++t)
        acc = acc + E[(P.col_slot[t] * Z + wrap(z - P.col_shift[t], Z)) * lpb + lane];
      L[pos * lpb + lane] = acc;
    }
  }
  __syncthreads();
}

// make_decode_loop (spa_pallas.py:176-574), layered or (FLOOD) flooding
// schedule. L holds the channel LLRs (log(p0/p1)) on entry and the final
// posteriors on exit (flooding reads the channel LLRs from X on every sweep);
// s_done / s_conv (and s_norm when NORM and P.track_norm) hold each lane's
// state. NORM compiles the flip metric in (the standalone decoder only, so
// the fused kernels keep their registers). Returns the block's trip count.
template <int DMAX, bool FLOOD, bool NORM>
__device__ int decode_block(const Loop& P, float* L, float* E, float* D, const float* X,
                            int lane, int r, int z, bool valid) {
  const int lpb = P.lpb, Z = P.Z;
  for (int i = threadIdx.x; i < P.e_slots * Z * lpb; i += blockDim.x) E[i] = 0.0f;
  __syncthreads();
  int it = 0;
  for (;;) {
    bool live = false;
    for (int l = 0; l < lpb; ++l) live |= (s_done[l] == 0);
    if (!(it < P.max_it && live)) break;
    // `active` is fixed for the whole check window (spa_pallas.py:527-529)
    const bool active = valid && s_done[lane] == 0;
    for (int step = 0; step < P.check_every; ++step) {
      if (FLOOD) {
        flood_sweep<DMAX>(P, L, E, X, lane, r, z, active);
        continue;
      }
      for (int g = 0; g < P.ngroups; ++g) {
        const int bi = P.groups[g * P.R + r];
        const bool row_on = active && bi >= 0;
        int off = 0, d = 0;
        bool dup = false;
        if (row_on) {
          off = P.row_off[bi];
          d = P.row_off[bi + 1] - off;
          dup = P.row_dup[bi] != 0;
          float m[DMAX], e[DMAX];
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < d) {
              const int li = (P.slot_col[off + j] * Z + wrap(z + P.slot_shift[off + j], Z)) * lpb + lane;
              m[j] = L[li] - E[((off + j) * Z + z) * lpb + lane];
            }
          }
          check_update<DMAX>(m, e, d, P.variant, P.alpha, P.beta);
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j < d) {
              const int ei = ((off + j) * Z + z) * lpb + lane;
              if (dup) {
                D[((r * DMAX + j) * Z + z) * lpb + lane] = e[j] - E[ei];
              } else {
                const int li = (P.slot_col[off + j] * Z + wrap(z + P.slot_shift[off + j], Z)) * lpb + lane;
                L[li] = m[j] + e[j];
              }
              E[ei] = e[j];
            }
          }
        }
        if (P.grp_dup[g]) {
          // multi-diagonal row: after every read of L, add each base column's
          // deltas (summed in slot order) at this thread's position z
          __syncthreads();
          if (row_on && dup) {
            for (int j = 0; j < d; ++j) {
              const int col = P.slot_col[off + j];
              bool first = true;
              for (int jj = 0; jj < j; ++jj) first &= P.slot_col[off + jj] != col;
              if (!first) continue;
              float acc = 0.0f;
              for (int jj = j; jj < d; ++jj) {
                if (P.slot_col[off + jj] != col) continue;
                const float dv = D[((r * DMAX + jj) * Z + wrap(z - P.slot_shift[off + jj], Z)) * lpb + lane];
                acc = (jj == j) ? dv : acc + dv;
              }
              const int li = (col * Z + z) * lpb + lane;
              L[li] = L[li] + acc;
            }
          }
        }
        __syncthreads();
      }
    }
    // syndrome of the window's last sweep (exact rule: bit = L < 0)
    if (threadIdx.x < lpb) {
      s_unsat[threadIdx.x] = 0;
      if (NORM) s_flips[threadIdx.x] = 0;
    }
    __syncthreads();
    bool unsat = false;
    if (active) {
      for (int bi = r; bi < P.mb; bi += P.R) {
        const int off = P.row_off[bi], d = P.row_off[bi + 1] - off;
        int par = 0;
        for (int j = 0; j < d; ++j)
          par ^= L[(P.slot_col[off + j] * Z + wrap(z + P.slot_shift[off + j], Z)) * lpb + lane] < 0.0f;
        unsat |= par != 0;
      }
    }
    if (unsat) s_unsat[lane] = 1;
    if (NORM && P.track_norm && active) {
      // flips = sum over info bits of (|L| <= 7) & (prior * L < 0), counted
      // as an integer; then prior = L (spa_pallas.py:437-446)
      const size_t b = (size_t)blockIdx.x * lpb + lane;
      int cnt = 0;
      for (int pos = r * Z + z; pos < P.n; pos += P.R * Z) {
        if (P.info_mask[pos]) {
          const float l = L[pos * lpb + lane];
          float* pr = P.prior + (size_t)pos * P.B + b;
          cnt += (fabsf(l) <= LLR_WINDOW && *pr * l < 0.0f) ? 1 : 0;
          *pr = l;
        }
      }
      if (cnt) atomicAdd(&s_flips[lane], cnt);
    }
    __syncthreads();
    if (threadIdx.x < lpb) {
      const int l = threadIdx.x;
      if (s_done[l] == 0) {
        if (NORM && P.track_norm) s_norm[l] = (float)s_flips[l] / P.kf;
        if (s_unsat[l] == 0) {
          s_conv[l] = it + P.check_every - 1;  // the check iteration
          s_done[l] = 1;
        }
      }
    }
    it += P.check_every;
    __syncthreads();
  }
  return it;
}

// Count info-bit mismatches of the decisions against the sent word and
// write the block's per-lane outputs (a pre-done lane counts 0 errors).
__device__ void finish(const Loop& P, const float* L, const float* w, int lane, int rz, int b,
                       bool valid, int it, int* err, unsigned char* ok, int* conv, float* norm,
                       int* iters) {
  const int lpb = P.lpb;
  int cnt = 0;
  if (valid && !s_pre[lane]) {
    for (int pos = rz; pos < P.n; pos += P.R * P.Z) {
      if (P.info_mask[pos]) {
        const bool est = L[pos * lpb + lane] < 0.0f;
        const bool x = w[(size_t)pos * P.B + b] != 0.0f;
        cnt += est != x;
      }
    }
  }
  if (cnt) atomicAdd(&s_err[lane], cnt);
  __syncthreads();
  if (threadIdx.x < lpb && valid) {
    err[b] = s_err[lane];
    ok[b] = s_done[lane] ? 1 : 0;
    conv[b] = s_conv[lane];
    norm[b] = 0.0f;  // the normalized-LLR metric is not ported
    iters[b] = it;
  }
}

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

template <int DMAX>
__global__ void __launch_bounds__(1024)
mc_decoder_kernel(Loop P, const int* tab, const float* w, const unsigned* raw, const float* consts,
                  int* err, unsigned char* ok, int* conv, float* norm, int* iters,
                  float* llr_out, int mode, float amp, int noise_input, unsigned key0,
                  unsigned key1, int skip) {
  extern __shared__ float smem[];
  const int lpb = P.lpb, Z = P.Z, n = P.n, B = P.B;
  float* L = smem;
  float* E = L + n * lpb;
  float* D = E + P.e_slots * Z * lpb;
  stage_tables(P, tab, reinterpret_cast<int*>(D + (P.has_dup ? P.R * DMAX * Z * lpb : 0)));
  const int tid = threadIdx.x, lane = tid % lpb, rz = tid / lpb, r = rz / Z, z = rz % Z;
  const int b = blockIdx.x * lpb + lane;
  const bool valid = b < B;
  if (tid < lpb) {
    s_done[tid] = (skip || !valid) ? 1 : 0;
    s_pre[tid] = 0;
    s_conv[tid] = -1;
    s_err[tid] = 0;
  }
  const float c_noise1 = consts[0], c_scale = consts[1], c_s1 = consts[2], c_s2 = consts[3];
  const float c_lc1 = consts[4], c_lc2 = consts[5], c_lc3 = consts[6], c_p = consts[7];

  // channel_fill (mc_pallas.py:253-293): base columns 2p and 2p+1 share one
  // draw triple per normal, from column 2p's planes
  auto channel = [&](int col, int zz, float za, float zb, unsigned jam_w) {
    const size_t pos = (size_t)col * Z + zz;
    const float sym = (2.0f * w[pos * B + b] - 1.0f) * amp;
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
    L[pos * lpb + lane] = llr;
    if (llr_out) llr_out[pos * B + b] = llr;
  };
  if (valid) {
    const int npairs = (P.nb + 1) / 2;
    const size_t nB = (size_t)n * B;
    for (int item = rz; item < npairs * Z; item += P.R * Z) {
      const int p = item / Z, zz = item - p * Z, c0 = 2 * p, c1 = c0 + 1;
      const bool has1 = c1 < P.nb;
      unsigned a0, a1, a2, b0 = 0, b1 = 0, b2 = 0, j0 = 0, j1 = 0;
      if (noise_input) {
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
        // Philox words laid out as ldpc_tpu_torch/ops/mc_kernels.py philox_raw
        const uint2 key = make_uint2(key0, key1);
        const uint4 x = philox4x32_10(make_uint4((unsigned)b, (unsigned)item, 0u, 0u), key);
        a0 = x.x;
        a1 = x.y;
        a2 = x.z;
        j0 = x.w;
        if (mode != 1) {
          const uint4 y = philox4x32_10(make_uint4((unsigned)b, (unsigned)item, 1u, 0u), key);
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
  __syncthreads();
  const int it = decode_block<DMAX, false, false>(P, L, E, D, nullptr, lane, r, z, valid);
  finish(P, L, w, lane, rz, b, valid, it, err, ok, conv, norm, iters);
}

template <int DMAX>
__global__ void __launch_bounds__(1024)
llr_decoder_kernel(Loop P, const int* tab, const float* llr, const float* w, const float* done0,
                   int* err, unsigned char* ok, int* conv, float* norm, int* iters) {
  extern __shared__ float smem[];
  const int lpb = P.lpb, Z = P.Z, n = P.n, B = P.B;
  float* L = smem;
  float* E = L + n * lpb;
  float* D = E + P.e_slots * Z * lpb;
  stage_tables(P, tab, reinterpret_cast<int*>(D + (P.has_dup ? P.R * DMAX * Z * lpb : 0)));
  const int tid = threadIdx.x, lane = tid % lpb, rz = tid / lpb, r = rz / Z, z = rz % Z;
  const int b = blockIdx.x * lpb + lane;
  const bool valid = b < B;
  if (tid < lpb) {
    s_done[tid] = (!valid || done0[b] > 0.5f) ? 1 : 0;
    s_pre[tid] = s_done[tid];
    s_conv[tid] = -1;
    s_err[tid] = 0;
  }
  __syncthreads();
  // pre-done lanes are placeholders: their LLRs are never read
  if (valid && !s_pre[lane]) {
    for (int pos = rz; pos < n; pos += P.R * Z) L[pos * lpb + lane] = llr[(size_t)pos * B + b];
  }
  __syncthreads();
  const int it = decode_block<DMAX, false, false>(P, L, E, D, nullptr, lane, r, z, valid);
  finish(P, L, w, lane, rz, b, valid, it, err, ok, conv, norm, iters);
}

// spa_pallas.py:686-708: decode the channel LLRs ``llr`` [B, n] (LLR > 0 <=>
// bit 1, negated on load into log(p0/p1)), then write the hard decisions
// est [B, n] (1 <=> L < 0, frozen per lane at its convergence) and the
// per-lane ok / conv / norm / iters. ``skip`` pre-marks every lane done.
template <int DMAX, bool FLOOD>
__global__ void __launch_bounds__(1024)
qc_decoder_kernel(Loop P, const int* tab, const float* llr, int skip, unsigned char* est,
                  unsigned char* ok, int* conv, float* norm, int* iters) {
  extern __shared__ float smem[];
  const int lpb = P.lpb, Z = P.Z, n = P.n;
  float* L = smem;
  float* E = L + n * lpb;
  float* D = E + P.e_slots * Z * lpb;
  float* X = D + (P.has_dup ? P.R * DMAX * Z * lpb : 0);
  stage_tables(P, tab, reinterpret_cast<int*>(X + (FLOOD ? n * lpb : 0)));
  const int tid = threadIdx.x, lane = tid % lpb, rz = tid / lpb, r = rz / Z, z = rz % Z;
  const int b = blockIdx.x * lpb + lane;
  const bool valid = b < P.B;
  if (tid < lpb) {
    s_done[tid] = (skip || !valid) ? 1 : 0;
    s_conv[tid] = -1;
    s_norm[tid] = 0.0f;
  }
  if (valid) {
    for (int pos = rz; pos < n; pos += P.R * Z) {
      const float v = -llr[(size_t)b * n + pos];
      L[pos * lpb + lane] = v;
      if (FLOOD) X[pos * lpb + lane] = v;
      if (P.track_norm && P.info_mask[pos]) P.prior[(size_t)pos * P.B + b] = v;
    }
  }
  __syncthreads();
  const int it = decode_block<DMAX, FLOOD, true>(P, L, E, D, X, lane, r, z, valid);
  if (valid) {
    for (int pos = rz; pos < n; pos += P.R * Z)
      est[(size_t)b * n + pos] = L[pos * lpb + lane] < 0.0f ? 1 : 0;
  }
  if (tid < lpb && valid) {
    ok[b] = s_done[lane] ? 1 : 0;
    conv[b] = s_conv[lane];
    norm[b] = s_norm[lane];
    iters[b] = it;
  }
}

Loop make_loop(const int* tab, int n, int Z, int nb, int mb, int e_slots, int ngroups, int R,
               int lpb, int B, int max_it, int check_every, int variant, float alpha, float beta,
               int has_dup) {
  Loop P = {};
  P.row_off = tab;  // replaced by the shared-memory copies in-kernel
  P.n = n;
  P.Z = Z;
  P.nb = nb;
  P.mb = mb;
  P.e_slots = e_slots;
  P.ngroups = ngroups;
  P.R = R;
  P.lpb = lpb;
  P.B = B;
  P.max_it = max_it;
  P.check_every = check_every;
  P.variant = variant;
  P.alpha = alpha;
  P.beta = beta;
  P.has_dup = has_dup;
  P.kf = 1.0f;
  return P;
}

size_t smem_bytes(const Loop& P, int dmax) {
  size_t floats = (size_t)P.lpb * (P.n + (size_t)P.e_slots * P.Z +
                                   (P.has_dup ? (size_t)P.R * dmax * P.Z : 0) +
                                   (P.flood ? P.n : 0));
  return 4 * (floats + table_len(P));
}

template <int DMAX>
cudaError_t launch_mc(const Loop& P, const int* tab, const float* w, const unsigned* raw,
                      const float* consts, int* err, unsigned char* ok, int* conv, float* norm,
                      int* iters, float* llr_out, int mode, float amp, int noise_input,
                      unsigned key0, unsigned key1, int skip, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, DMAX);
  cudaError_t e = cudaFuncSetAttribute(mc_decoder_kernel<DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((P.B + P.lpb - 1) / P.lpb), block(P.lpb * P.R * P.Z);
  mc_decoder_kernel<DMAX><<<grid, block, smem, stream>>>(P, tab, w, raw, consts, err, ok, conv,
                                                         norm, iters, llr_out, mode, amp,
                                                         noise_input, key0, key1, skip);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_llr(const Loop& P, const int* tab, const float* llr, const float* w,
                       const float* done0, int* err, unsigned char* ok, int* conv, float* norm,
                       int* iters, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, DMAX);
  cudaError_t e = cudaFuncSetAttribute(llr_decoder_kernel<DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((P.B + P.lpb - 1) / P.lpb), block(P.lpb * P.R * P.Z);
  llr_decoder_kernel<DMAX><<<grid, block, smem, stream>>>(P, tab, llr, w, done0, err, ok, conv,
                                                          norm, iters);
  return cudaGetLastError();
}

template <int DMAX, bool FLOOD>
cudaError_t launch_qc(const Loop& P, const int* tab, const float* llr, int skip,
                      unsigned char* est, unsigned char* ok, int* conv, float* norm, int* iters,
                      cudaStream_t stream) {
  const size_t smem = smem_bytes(P, DMAX);
  cudaError_t e = cudaFuncSetAttribute(qc_decoder_kernel<DMAX, FLOOD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((P.B + P.lpb - 1) / P.lpb), block(P.lpb * P.R * P.Z);
  qc_decoder_kernel<DMAX, FLOOD><<<grid, block, smem, stream>>>(P, tab, llr, skip, est, ok, conv,
                                                                norm, iters);
  return cudaGetLastError();
}

bool bad_shape(int lpb, int R, int Z, int B) {
  return lpb < 1 || lpb > MAX_LPB || R < 1 || R > 2 || lpb * R * Z > 1024 || B < 0;
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

extern "C" int mc_decoder_launch(const float* w, const unsigned* raw, const float* consts,
                                 int* err, unsigned char* ok, int* conv, float* norm, int* iters,
                                 float* llr_out, const int* tab, int n, int Z, int nb, int mb,
                                 int e_slots, int ngroups, int R, int lpb, int B, int max_it,
                                 int check_every, int variant, float alpha, float beta, int dmax,
                                 int has_dup, int mode, float amp, int noise_input, unsigned key0,
                                 unsigned key1, int skip, int device, void* stream) {
  if (bad_shape(lpb, R, Z, B) || (noise_input && raw == nullptr)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const Loop P = make_loop(tab, n, Z, nb, mb, e_slots, ngroups, R, lpb, B, max_it, check_every,
                           variant, alpha, beta, has_dup);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dmax) {
    case 8:
      return launch_mc<8>(P, tab, w, raw, consts, err, ok, conv, norm, iters, llr_out, mode, amp,
                          noise_input, key0, key1, skip, s);
    case 16:
      return launch_mc<16>(P, tab, w, raw, consts, err, ok, conv, norm, iters, llr_out, mode,
                           amp, noise_input, key0, key1, skip, s);
    case 32:
      return launch_mc<32>(P, tab, w, raw, consts, err, ok, conv, norm, iters, llr_out, mode,
                           amp, noise_input, key0, key1, skip, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int llr_decoder_launch(const float* llr, const float* w, const float* done0,
                                  int* err, unsigned char* ok, int* conv, float* norm,
                                  int* iters, const int* tab, int n, int Z, int nb, int mb,
                                  int e_slots, int ngroups, int R, int lpb, int B, int max_it,
                                  int check_every, int variant, float alpha, float beta,
                                  int dmax, int has_dup, int device, void* stream) {
  if (bad_shape(lpb, R, Z, B)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const Loop P = make_loop(tab, n, Z, nb, mb, e_slots, ngroups, R, lpb, B, max_it, check_every,
                           variant, alpha, beta, has_dup);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dmax) {
    case 8:
      return launch_llr<8>(P, tab, llr, w, done0, err, ok, conv, norm, iters, s);
    case 16:
      return launch_llr<16>(P, tab, llr, w, done0, err, ok, conv, norm, iters, s);
    case 32:
      return launch_llr<32>(P, tab, llr, w, done0, err, ok, conv, norm, iters, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int qc_decoder_launch(const float* llr, float* prior, unsigned char* est,
                                 unsigned char* ok, int* conv, float* norm, int* iters,
                                 const int* tab, int n, int Z, int nb, int mb, int e_slots,
                                 int ngroups, int R, int lpb, int B, int max_it, int check_every,
                                 int variant, float alpha, float beta, int dmax, int has_dup,
                                 int flood, int track_norm, int k, int skip, int device,
                                 void* stream) {
  if (bad_shape(lpb, R, Z, B) || (track_norm && prior == nullptr) ||
      (flood && (has_dup || ngroups))) {
    return cudaErrorInvalidValue;
  }
  if (B == 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  Loop P = make_loop(tab, n, Z, nb, mb, e_slots, ngroups, R, lpb, B, max_it, check_every, variant,
                     alpha, beta, has_dup);
  P.flood = flood;
  P.track_norm = track_norm;
  P.prior = prior;
  P.kf = (float)(k > 1 ? k : 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QC_CASE(D)                                                                    \
  case D:                                                                             \
    return flood ? launch_qc<D, true>(P, tab, llr, skip, est, ok, conv, norm, iters, s) \
                 : launch_qc<D, false>(P, tab, llr, skip, est, ok, conv, norm, iters, s);
  switch (dmax) {
    QC_CASE(8)
    QC_CASE(16)
    QC_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef QC_CASE
}
